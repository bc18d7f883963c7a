"""Multi-robot / multi-chip scale-out over a ``jax.sharding.Mesh``.

The reference is a single-robot, single-process library; its only
parallelism is a CPU thread pool and in-device SYCL work groups
(SURVEY §2.8). The scale-out axes here are new components:

1. **Fleet data-parallel** (`make_fleet_solver`): a batch of independent
   robot scenarios (one packed solver input each) vmapped over the sample
   axis and sharded across the devices of a mesh — each robot's solve
   stays device-local, no cross-device communication in steady state.
   This is the BASELINE.json "100+ concurrent robot scenarios sharded across hosts"
   configuration.

2. **Sample-parallel** (`make_sample_parallel_solver`): one robot's sample
   axis S split across devices with a cross-device argmin combine
   (``jax.lax.pmin`` + deterministic lowest-rank tie-break) — the
   distributed analog of the reference GPU backend's ``LowestCost``
   reduction object (``datatypes/trajectory.h:621-644``). Only needed for
   extreme sample counts; at 2k-64k samples a single chip wins.

Several processes: build the mesh over ``jax.devices()`` after
``parallel.multihost.initialize_multihost``; solves stay device-local.
"""

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.solver import (
    SolverSpec,
    _unpack_and_solve,
    pack_solver_input,
    packed_input_size,
)


def make_fleet_solver(
    spec: SolverSpec,
    mesh: Optional[Mesh] = None,
    axis_name: str = "robots",
    custom_costs: Sequence = (),
    chunk_size: Optional[int] = 64,
):
    """Batched solver: f32[N, packed_input_size] -> f32[N, out_size].

    With a mesh, the batch axis is sharded over ``axis_name`` and each
    chip solves its local robots; without one, it is a plain vmap on the
    default device, dispatched in pipelined chunks of ``chunk_size``
    robots. The default of 64 was tuned on the accelerator this code was
    first written for and has not been measured on a GPU (ROADMAP Speed
    item 3). Pass ``chunk_size=None`` for one monolithic dispatch.
    """
    if spec.dynamic_box:
        # same contract as make_packed_dwa_solver: the packed buffer has
        # no per-robot half-extents, so the solve would silently fall back
        # to the circle model with the radius double-counted
        raise ValueError(
            "dynamic_box specs are not supported by the packed fleet"
            " solver; use the fleet tick (ops/fleet_solver) instead"
        )
    solve_one = partial(_unpack_and_solve, spec, custom_costs=custom_costs)
    batched = jax.vmap(solve_one)
    if mesh is not None:
        # Each device runs its local shard as a lax.map over
        # chunk_size-row blocks INSIDE the compiled program, the same
        # tiling as the unsharded solver. Global N must divide the mesh
        # (shard_map contract); ragged per-chip tails are zero-padded
        # in-program (static shapes) and sliced off — pad rows solve to
        # found=False.
        def per_chip(local):
            n_loc = local.shape[0]
            # honor the documented chunk_size=None monolithic escape
            # hatch under a mesh too (it was silently coerced to 64)
            csz = chunk_size
            if not csz or n_loc <= csz:
                return batched(local)
            pad = (-n_loc) % csz
            padded = (
                jnp.concatenate(
                    [local, jnp.zeros((pad, local.shape[1]), local.dtype)]
                )
                if pad
                else local
            )
            outs = jax.lax.map(
                batched, padded.reshape(-1, csz, local.shape[1])
            )
            return outs.reshape(n_loc + pad, -1)[:n_loc]

        fn = jax.shard_map(
            per_chip,
            mesh=mesh,
            in_specs=P(axis_name, None),
            out_specs=P(axis_name, None),
        )
        return jax.jit(fn)
    jitted = jax.jit(batched)
    if not chunk_size:
        return jitted

    def chunked(bufs):
        n = bufs.shape[0]
        # ONE upload for the whole fleet buffer: slicing a host numpy
        # array per chunk would pay one transfer per chunk
        bufs = jnp.asarray(bufs)
        if n <= chunk_size:
            return jitted(bufs)
        # pad the tail to a full chunk: an uneven tail shape would compile
        # a SECOND program; zero pad rows
        # solve to found=False and are sliced off
        pad = (-n) % chunk_size
        if pad:
            bufs = jnp.concatenate(
                [bufs, jnp.zeros((pad, bufs.shape[1]), bufs.dtype)], axis=0
            )
        outs = [
            jitted(bufs[i : i + chunk_size])
            for i in range(0, n + pad, chunk_size)
        ]
        return jnp.concatenate(outs, axis=0)[:n]

    return chunked


def make_sample_parallel_solver(
    spec: SolverSpec,
    mesh: Mesh,
    axis_name: str = "sp",
):
    """Single-scenario solve with the *sample* axis sharded across chips.

    Each chip receives its own packed input whose velocity-window block
    covers a disjoint slice of the global sample grid (the caller builds
    per-chip windows); the local argmin results are combined with a
    deterministic lowest-cost / lowest-rank reduction.

    Returns a function f32[n_chips, packed_input_size] -> packed output of
    the globally winning chip.
    """
    if spec.dynamic_box:
        raise ValueError(
            "dynamic_box specs are not supported by the packed"
            " sample-parallel solver; use the fleet tick instead"
        )

    def _local_then_combine(bufs):
        def per_chip(buf):
            out = _unpack_and_solve(spec, buf[0])
            # out[1] is the local winning cost (inf if no admissible sample)
            local_cost = out[1]
            global_min = jax.lax.pmin(local_cost, axis_name)
            rank = jax.lax.axis_index(axis_name)
            n = jax.lax.axis_size(axis_name)
            has_min = local_cost == global_min
            winner_rank = jax.lax.pmin(
                jnp.where(has_min, rank, n), axis_name
            )
            is_winner = rank == winner_rank
            # broadcast the winner's packed output to all chips via psum
            contrib = jnp.where(is_winner, out, 0.0)
            return jax.lax.psum(contrib, axis_name)[None]

        return jax.shard_map(
            per_chip,
            mesh=mesh,
            in_specs=P(axis_name, None),
            out_specs=P(axis_name, None),
        )(bufs)

    return jax.jit(_local_then_combine)


class FleetPlanner:
    """Convenience wrapper managing N robot scenarios on a device mesh.

    Host keeps a [N, L] packed input matrix; ``step`` uploads it once and
    returns the [N, out] result matrix. For sustained operation, callers
    mutate only the rows that changed (scan/state updates) and re-upload.
    """

    def __init__(
        self,
        spec: SolverSpec,
        num_robots: int,
        mesh: Optional[Mesh] = None,
        axis_name: str = "robots",
    ):
        self.spec = spec
        self.num_robots = num_robots
        self.mesh = mesh
        self.solver = make_fleet_solver(spec, mesh, axis_name)
        # pad rows to the mesh size (shard_map divisibility contract,
        # like FleetRuntime._ensure_solver): a 100-robot fleet on 8
        # chips would otherwise fail at the first step() with an opaque
        # sharding error. Pad rows are all-zero -> found=False.
        n_dev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
        self._n_rows = ((num_robots + n_dev - 1) // n_dev) * n_dev
        self.inputs = np.zeros(
            (self._n_rows, packed_input_size(spec)), dtype=np.float32
        )

    def set_scenario(self, robot_index: int, **kwargs):
        """Fill one robot's packed input row (same args as
        ``pack_solver_input`` minus spec/buf)."""
        # the input matrix carries mesh pad rows beyond num_robots whose
        # results step() discards — writing one must be an error, not a
        # silently dropped scenario
        if not 0 <= robot_index < self.num_robots:
            raise IndexError(
                f"robot_index {robot_index} out of range for a "
                f"{self.num_robots}-robot fleet"
            )
        pack_solver_input(self.spec, self.inputs[robot_index], **kwargs)

    def step(self) -> np.ndarray:
        return np.asarray(self.solver(self.inputs))[: self.num_robots]
