"""Multi-process runtime helpers + the fleet control runtime.

The reference is single-robot/single-process; this is the new distributed
component SURVEY §2.8 calls for: many robot scenarios served by several
GPUs, on one host or many. Topology:

  * every robot's solve is device-local (no cross-device traffic in the
    hot loop); the robot axis is sharded over the mesh,
  * hosts own the per-robot follower state (target determination, horizon
    adaptation) and pack one solver-input row per robot per tick,
  * collectives run only when a single solve's sample axis is sharded
    (``make_sample_parallel_solver``) or for fleet-level reductions.

``initialize_multihost`` wraps ``jax.distributed.initialize`` for runs
with several processes; tests exercise the same code on a virtual CPU
mesh.
"""

import time
from typing import List, Optional, Sequence

import numpy as np

from ..control.dwa import DWA
from ..models import Robot, RobotCtrlLimits, RobotState
from ..ops.solver import pack_solver_input, unpack_solver_output
from .fleet import make_fleet_solver


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize the JAX distributed runtime (no-op for one process).

    Call once per process before creating meshes; afterwards
    ``jax.devices()`` spans every device of every process while
    ``jax.local_devices()`` are this process's. ``local_device_ids`` names
    the GPUs this process opens: with one process per card, pass that
    card's index — without it every process opens every card of its host
    and reserves most of each card's memory.
    """
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def build_fleet_mesh(axis_name: str = "robots", devices=None):
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=(axis_name,))


class FleetRuntime:
    """Closed-loop control of N robots with one batched device solve/tick.

    Each robot gets its own DWA controller instance for host-side state
    (path, follower stickiness, adaptive horizon); the device work of all
    robots is fused into a single sharded fleet dispatch. All controllers
    must share one solver spec (same sample counts / horizons / buckets).
    """

    def __init__(
        self,
        robots: Sequence[Robot],
        ctrl_limits,  # RobotCtrlLimits, or one per robot
        config,
        mesh=None,
        host_workers: int = 0,
    ):
        if isinstance(ctrl_limits, RobotCtrlLimits):
            limits_list = [ctrl_limits] * len(robots)
        else:
            limits_list = list(ctrl_limits)
            if len(limits_list) != len(robots):
                raise ValueError(
                    f"ctrl_limits has {len(limits_list)} entries for "
                    f"{len(robots)} robots"
                )
        self.controllers: List[DWA] = [
            DWA(robot=r, ctrl_limits=lim, config=config)
            for r, lim in zip(robots, limits_list)
        ]
        # every robot must compile to ONE shared solver program (this
        # host-follower runtime dispatches the whole fleet through robot
        # 0's spec): identical sample grid, kinematics class and collision
        # shape — only seg_size (lookahead capacity) may differ, it is
        # maxed below. Mixed-shape/kinematics fleets belong in DeviceFleet
        # (parallel/fleet_v2), which is per-robot-configured.
        protos = [
            {k: v for k, v in c._spec_proto.items() if k != "seg_size"}
            for c in self.controllers
        ]
        if any(pr != protos[0] for pr in protos[1:]):
            raise ValueError(
                "FleetRuntime requires all robots to share one solver spec"
                " (kinematic class, sample counts, collision shape);"
                " per-robot shapes are supported by DeviceFleet instead"
            )
        self.num_robots = len(robots)
        self.mesh = mesh
        self._solver = None
        self._spec = None
        self._inputs = None
        self._solvers_by_bucket = {}
        self._pool = None
        self.host_workers = int(host_workers)
        self.solver_failures = 0  # cumulative device-dispatch failures
        self.last_tick_seconds = 0.0

    def set_paths(self, paths: Sequence[np.ndarray]):
        if len(paths) != self.num_robots:
            raise ValueError(
                f"{len(paths)} paths for {self.num_robots} robots"
            )
        for ctrl, path in zip(self.controllers, paths):
            ctrl.set_path(path)

    def _ensure_solver(self, scan_bucket: int):
        # keyed per scan bucket like DWA._solver_for: freezing the first
        # tick's bucket would silently TRUNCATE longer later scans (and
        # their obstacle points) to the stale scan_size
        if scan_bucket not in self._solvers_by_bucket:
            import dataclasses

            spec, _, _ = self.controllers[0]._solver_for(scan_bucket)
            # fleet mode computes the dynamic window on device — the host
            # never walks the per-robot velocity grid. The tracked-segment
            # capacity must cover the FASTEST robot's lookahead, not robot
            # 0's (per-robot limits are allowed).
            seg = max(c._spec_proto["seg_size"] for c in self.controllers)
            spec = dataclasses.replace(
                spec, device_window=True, seg_size=seg
            )
            from ..ops.solver import packed_input_size

            # pad the robot axis to a multiple of the mesh size (sharding
            # requires even division; pad rows are solved and ignored)
            n_dev = int(np.prod(self.mesh.devices.shape)) if self.mesh else 1
            padded = ((self.num_robots + n_dev - 1) // n_dev) * n_dev
            self._solvers_by_bucket[scan_bucket] = (
                spec,
                make_fleet_solver(spec, mesh=self.mesh),
                np.zeros((padded, packed_input_size(spec)), np.float32),
            )
            # pad rows need valid-ish content; leave zeros (no admissible
            # samples -> found=False, ignored)
        spec, solver, inputs = self._solvers_by_bucket[scan_bucket]
        if self._spec is not spec:  # rebind only on bucket change
            self._spec, self._solver, self._inputs = spec, solver, inputs

    def _host_stage(self, i, state, scan):
        """Per-robot host work: follower bookkeeping + pack the input row.

        Returns a result dict for short-circuited robots (goal reached,
        rotate-in-place), or None when row i was packed for the device
        solve. Touches only controller i and input row i — safe to run
        for different i on different threads (the native closest-segment
        / scan-block / segment-block calls release the GIL).
        """
        ctrl = self.controllers[i]
        spec = self._spec
        ctrl.set_current_state(state.x, state.y, state.yaw, state.speed)
        if ctrl.reached_end():
            return dict(found=False, reason="goal_reached")
        target = ctrl.determine_target()
        if (
            ctrl.rotate_in_place
            and abs(target.heading_error)
            > ctrl._config.goal_orientation_tolerance * 10.0
        ):
            r = ctrl._rotate_in_place_result(target.heading_error)
            return dict(
                found=True,
                vx=float(r.trajectory.vx[0]),
                vy=0.0,
                omega=float(r.trajectory.omega[0]),
                cost=0.0,
            )
        ctrl._adapt_prediction_horizon()

        obs = ctrl._obstacle_points_world(scan, None)
        # same non-finite-row filter as the single-robot path
        # (dwa._gather_obstacles): one NaN point (e.g. a NaN scan ANGLE —
        # ranges are sanitized upstream, angles are not) would defeat
        # every collision comparison and poison the obstacle cost
        obs = obs[np.isfinite(obs).all(axis=1)]
        obs_padded = np.full((spec.scan_size, 2), 1e8, np.float32)
        obs_padded[: len(obs)] = obs[: spec.scan_size]
        start, end = ctrl._tracked_segment_window()
        from ..native import segment_block

        seg_x, seg_y, seg_arc, seg_total = segment_block(
            ctrl._path.xs, ctrl._path.ys, ctrl._path.arc_lengths,
            start, end, 1e8, spec.seg_size,
        )
        pack_solver_input(
            spec,
            self._inputs[i],
            ctrl._params_vec(),
            (state.x, state.y, state.yaw),
            None,  # device-window mode
            obs_padded,
            min(len(obs), spec.scan_size),
            seg_x,
            seg_y,
            seg_arc,
            end - start + 1,
            seg_total,
            ctrl._path.total_path_length(),
            ctrl._active_points,
            current_vel=(state.vx, state.vy, state.omega),
            limits_vec=ctrl._limits_array,
        )
        return None

    def tick(
        self,
        states: Sequence[RobotState],
        scans: Sequence,
    ) -> List[dict]:
        """One fleet control tick.

        Returns per-robot dicts: {found, vx, vy, omega, cost}. Robots whose
        host stage short-circuits (goal reached, rotate-in-place) are
        handled without a device slot (their row is reused but ignored).

        The host stage can fan out over a thread pool (``host_workers`` in
        the constructor; the reference parallelizes its host loops the
        same way, threadpool.h:18-93). Default is serial: measured on a
        4-core host, 100 robots take 16.5 ms serial vs 44.6 ms threaded —
        the per-robot stage (~165 us) is too fine-grained for Python
        thread handoff to pay off below ~16 cores.
        """
        if len(states) != self.num_robots or len(scans) != self.num_robots:
            # zip/Executor.map would silently truncate to the shortest
            # input — the last robots would get no command and no error
            raise ValueError(
                f"tick needs {self.num_robots} states and scans, got "
                f"{len(states)} states / {len(scans)} scans"
            )
        t0 = time.perf_counter()
        from ..control.dwa import _round_up

        bucket = max(
            256,
            _round_up(max(len(s.ranges) for s in scans), 256),
        )
        self._ensure_solver(bucket)
        spec = self._spec

        if self._pool is None and self.host_workers > 1:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(self.host_workers, self.num_robots)
            )
        if self._pool is not None:
            results = list(
                self._pool.map(
                    self._host_stage,
                    range(self.num_robots),
                    states,
                    scans,
                )
            )
        else:
            results = [
                self._host_stage(i, s, sc)
                for i, (s, sc) in enumerate(zip(states, scans))
            ]
        needs_solve = [i for i, r in enumerate(results) if r is None]

        if needs_solve:
            out = self._dispatch_with_retry()
            if out is None:
                # fleet-level failsafe: both attempts failed — emit safe
                # stop commands rather than crashing the control loop
                for i in needs_solve:
                    results[i] = dict(
                        found=False, vx=0.0, vy=0.0, omega=0.0,
                        cost=float("inf"), reason="solver_error",
                    )
            else:
                for i in needs_solve:
                    found, cost, _b, _n, vx, vy, om, _px, _py = (
                        unpack_solver_output(spec, out[i])
                    )
                    results[i] = dict(
                        found=found,
                        vx=float(vx[0]) if found else 0.0,
                        vy=float(vy[0]) if found else 0.0,
                        omega=float(om[0]) if found else 0.0,
                        cost=cost,
                    )
        self.last_tick_seconds = time.perf_counter() - t0
        return results

    def _dispatch_with_retry(self) -> Optional[np.ndarray]:
        """Device dispatch with one re-dispatch on failure.

        The runtime failure story SURVEY §5 calls for (the single-process
        reference has none): a transient device/runtime error (a lost
        device, OOM from a concurrent tenant) is retried once;
        a second failure degrades this tick to safe-stop commands and
        increments ``solver_failures`` for the operator to alarm on.
        """
        for attempt in (0, 1):
            try:
                return np.asarray(self._solver(self._inputs))
            except Exception:  # noqa: BLE001 - any device error
                self.solver_failures += 1
                if attempt == 1:
                    import logging

                    logging.getLogger(__name__).exception(
                        "fleet solve failed twice; emitting safe-stop"
                    )
        return None
