"""AOT artifact export / load for production serving.

A deployment wants to ship a *compiled program*, not a Python tracing
path: pinned semantics, fast cold start, and no dependency on the
planner construction code inside the serving process. ``jax.export``
gives exactly that — it serializes the traced + lowered
StableHLO of a jitted function together with its calling convention;
the serving side deserializes and calls, skipping tracing entirely
(and, with the persistent compilation cache, usually skipping XLA
compilation too).

The reference has no analog — its closest move is re-JITing the SYCL
kernels at construction time every process start
(``controllers/dwa.cpp:75-91``). Here the artifact is hermetic,
versioned, and checked at load time.

Artifact container format (one file)::

    8 bytes   magic  b"KTPUART1"
    4 bytes   little-endian u32 header length H
    H bytes   JSON header {kind, jax_version, created_unix, meta, ...}
    rest      jax.export serialized payload (StableHLO + conventions)

The header is readable without jax (``read_artifact_header``), so a
fleet orchestrator can inventory artifacts cheaply.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import numpy as np

__all__ = [
    "export_callable",
    "export_packed_solver",
    "export_fleet_tick",
    "load_artifact",
    "load_packed_solver",
    "read_artifact_header",
    "LoadedArtifact",
]

_MAGIC = b"KTPUART1"


def _shape_specs(tree):
    """Example pytree -> ShapeDtypeStruct pytree (values are not baked
    into the artifact, only shapes/dtypes)."""

    def spec(x):
        if isinstance(x, jax.ShapeDtypeStruct):
            return x
        # metadata-only: jax.Arrays expose shape/dtype without a device
        # fetch — np.asarray here would copy whole device-resident fleet
        # tables to the host just to discard them
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return jax.ShapeDtypeStruct(tuple(x.shape), np.dtype(x.dtype))
        a = np.asarray(x)
        return jax.ShapeDtypeStruct(a.shape, a.dtype)

    return jax.tree_util.tree_map(spec, tree)


def export_callable(
    fn: Callable,
    example_args: Tuple,
    path: str,
    *,
    kind: str = "callable",
    meta: Optional[Dict[str, Any]] = None,
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export ``jax.jit(fn)(*example_args)`` as a serving artifact.

    ``example_args``: concrete arrays or ShapeDtypeStructs — any pytree
    prefix accepted by the function; only shapes/dtypes are recorded.
    ``platforms``: lowering platforms (e.g. ``("cpu", "cuda")``) for a
    multi-platform artifact; default = the current backend only.
    Returns the written header dict.
    """
    from jax import export as jax_export

    jitted = fn if isinstance(fn, jax.stages.Wrapped) else jax.jit(fn)
    specs = tuple(_shape_specs(a) for a in example_args)
    exported = jax_export.export(
        jitted, platforms=tuple(platforms) if platforms else None
    )(*specs)
    payload = exported.serialize()

    header = {
        "kind": kind,
        "jax_version": jax.__version__,
        "created_unix": time.time(),
        "platforms": list(exported.platforms),
        "meta": meta or {},
    }
    blob = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        f.write(payload)
    return header


def _read_header_from(f, path: str) -> Dict[str, Any]:
    """Parse the container prefix (magic + u32 length + JSON header),
    leaving ``f`` positioned at the payload — the ONE place that knows
    the on-disk format (shared by the cheap header read and the full
    load)."""
    magic = f.read(8)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a kompass_core_tpu artifact")
    (hlen,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(hlen).decode("utf-8"))


def read_artifact_header(path: str) -> Dict[str, Any]:
    """Read the JSON header only (no jax deserialization)."""
    with open(path, "rb") as f:
        return _read_header_from(f, path)


@dataclasses.dataclass
class LoadedArtifact:
    """A deserialized serving artifact. ``call`` runs the compiled
    program (compiling on first use per device, served from the
    persistent cache when enabled)."""

    header: Dict[str, Any]
    call: Callable

    @property
    def kind(self) -> str:
        return self.header["kind"]

    @property
    def meta(self) -> Dict[str, Any]:
        return self.header["meta"]


def load_artifact(path: str) -> LoadedArtifact:
    from jax import export as jax_export

    _register_fleet_pytrees()
    with open(path, "rb") as f:
        header = _read_header_from(f, path)
        payload = f.read()
    exported = jax_export.deserialize(payload)
    return LoadedArtifact(header=header, call=jax.jit(exported.call))


# ---------------------------------------------------------------------------
# Framework-specific entry points
# ---------------------------------------------------------------------------


def export_packed_solver(
    spec,
    path: str,
    *,
    custom_costs: Sequence = (),
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export the packed single-buffer DWA solver for ``spec``.

    The artifact's calling convention is one f32 ``[packed_input_size]``
    buffer in, one packed output vector out — the same single-transfer
    contract the live solver uses (``ops/solver.py`` packed interface).
    The full ``SolverSpec`` is recorded in the header so the loader can
    rebuild ``pack_solver_input`` / ``unpack_solver_output`` helpers.
    """
    from ..ops.solver import make_packed_dwa_solver, packed_input_size

    fn = make_packed_dwa_solver(spec, custom_costs=custom_costs)
    buf = jax.ShapeDtypeStruct((packed_input_size(spec),), np.float32)
    meta = {"solver_spec": dataclasses.asdict(spec)}
    return export_callable(
        fn, (buf,), path, kind="packed_dwa_solver", meta=meta,
        platforms=platforms,
    )


def load_packed_solver(path: str):
    """Load a ``packed_dwa_solver`` artifact.

    Returns ``(artifact, spec)`` — ``artifact.call(buf)`` runs the
    solve; ``spec`` is the reconstructed ``SolverSpec`` for use with
    ``pack_solver_input`` / ``unpack_solver_output``.
    """
    from ..ops.solver import SolverSpec

    art = load_artifact(path)
    if art.kind != "packed_dwa_solver":
        raise ValueError(f"{path}: artifact kind {art.kind!r}, expected "
                         "'packed_dwa_solver'")
    d = dict(art.meta["solver_spec"])
    if d.get("collision_box") is not None:
        d["collision_box"] = tuple(d["collision_box"])
    return art, SolverSpec(**d)


_FLEET_PYTREES_REGISTERED = False


def _register_fleet_pytrees():
    """Register the fleet NamedTuple pytrees with jax.export so the tick
    program's calling convention serializes. Stable names — they are part
    of the artifact format; renaming breaks old artifacts."""
    global _FLEET_PYTREES_REGISTERED
    if _FLEET_PYTREES_REGISTERED:
        return
    from jax import export as jax_export

    from ..ops import fleet_solver as fs

    for cls in (fs.FleetPaths, fs.FleetCarry, fs.FleetConfig,
                fs.FleetSafety):
        jax_export.register_namedtuple_serialization(
            cls, serialized_name=f"kompass_core_tpu.{cls.__name__}"
        )
    _FLEET_PYTREES_REGISTERED = True


def export_fleet_tick(
    fleet,
    path: str,
    *,
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export a ``DeviceFleet``'s compiled tick program.

    The artifact takes the fleet's carry pytree, the device-resident
    scan-angle matrix and the packed per-tick input matrix
    ``[N, 4+3+R (+ 4*tracked_obstacles)]`` (plus the safety pytree when
    the fleet was built with one) and returns
    ``(carry', outputs[N, len(OUT_FIELDS)])`` — exactly the live
    ``DeviceFleet.tick`` device program, minus the host-side pack/unpack.
    The header meta records ``tracked_obstacles`` so a consumer sizing
    its input matrix from the header alone gets the right width.
    """
    _register_fleet_pytrees()
    _check_exportable_fleet(fleet)
    args = fleet.tick_example_args()
    meta = _fleet_meta(fleet)
    return export_callable(
        fleet._tick_fn, args, path, kind="fleet_tick", meta=meta,
        platforms=platforms,
    )


def _fleet_meta(fleet) -> Dict[str, Any]:
    return {
        "n_robots": int(fleet._n),
        "scan_rays": int(fleet._scan_rays),
        "safety": fleet._safety is not None,
        "tracked_obstacles": int(getattr(fleet, "_tracked", 0)),
        # rows interact in a peer-avoidance program — recorded so
        # sharded_fleet_call can refuse to row-chunk it (shard-local
        # avoidance would silently drive cross-shard robots through
        # each other)
        "peer_avoidance": getattr(fleet, "_peer_cfg", None) is not None,
    }


def export_fleet_ticks_on_device(
    fleet,
    k: int,
    path: str,
    *,
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export the K-tick RTT-amortized serving program
    (``DeviceFleet.run_ticks_on_device``): the same calling convention as
    the tick artifact, returning ``(carry', outputs[N, k, F],
    final_states[N, 4])`` — K carry-chained control ticks per dispatch."""
    from ..ops.fleet_solver import make_fleet_ticks_on_device

    _register_fleet_pytrees()
    _check_exportable_fleet(fleet)
    fn = make_fleet_ticks_on_device(
        fleet.spec, k, mesh=None, chunk=fleet._chunk or None,
        peer_cfg=fleet._peer_cfg, safety=fleet._safety_cfgs is not None,
    )
    args = fleet.tick_example_args()
    meta = dict(_fleet_meta(fleet), k_ticks=int(k))
    return export_callable(
        fn, args, path, kind="fleet_ticks_on_device", meta=meta,
        platforms=platforms,
    )


def _check_exportable_fleet(fleet) -> None:
    """Mesh-sharded fleets embed device shardings in their programs;
    jax.export of sharded computations targets a fixed device assignment,
    which is the wrong contract for a shippable artifact. Export the
    single-device program and shard at the serving site with
    ``sharded_fleet_call`` (demonstrated end-to-end in
    ``tests/test_serving_export.py::test_artifact_shards_at_serving_site``
    and ``examples/serving_mesh_shard_demo.py``)."""
    if getattr(fleet, "mesh", None) is not None:
        raise NotImplementedError(
            "export of mesh-sharded fleet programs is not supported — "
            "build the fleet without a mesh for export, and shard at the "
            "serving site with serving.sharded_fleet_call"
        )


def sharded_fleet_call(art: LoadedArtifact, args, devices, shards=None):
    """Serve a single-device fleet artifact across ``devices`` — the
    shard-at-serving-site contract behind ``_check_exportable_fleet``.

    The fleet tick is row-local per robot (zero cross-device collectives
    in the compiled steady state, tests/test_scaling_hlo.py), so multi-device
    serving needs no sharded program at all: row-chunk every [N, ...]
    leaf of ``args`` into ``len(devices)`` shards of the artifact's
    exported row count, commit shard d to ``devices[d]``, and dispatch
    the SAME loaded executable once per device (dispatches are async, so
    shards run concurrently). Outputs are re-concatenated on host in
    fleet row order — bit-identical to the monolithic single-device
    call.

    ``args``: the full-fleet argument tree in the artifact's calling
    convention (``DeviceFleet.tick_example_args`` of a fleet built with
    ``n_shards * art.meta['n_robots']`` robots and the same construction
    parameters). Peer-avoidance programs are NOT shardable this way
    (rows interact — shard-local avoidance would silently drive
    cross-shard robots through each other), so peer artifacts are
    refused; use ``DeviceFleet(mesh=...)`` live for those.

    Slicing + committing the tree costs one host->device upload of the
    large static tables (paths/config/angles) per device per call — fine
    for a one-shot, wrong for a serving loop. Loops should call
    ``shard_fleet_args`` ONCE and pass the result as ``shards``; then
    only the outputs move per call (update the per-shard carry/input
    leaves in place on device or re-commit just those rows)."""
    # absence of the marker must NOT read as "no peers": artifacts
    # exported before the peer_avoidance header field existed would
    # silently get exactly the shard-local avoidance this guard is for
    peer = art.meta.get("peer_avoidance")
    if peer is None:
        raise ValueError(
            "artifact header has no 'peer_avoidance' field (exported by "
            "an older build) — cannot prove its rows don't interact, so "
            "row-chunked serving is refused; re-export with the current "
            "build, or serve the artifact whole on one device"
        )
    if peer:
        raise ValueError(
            "this artifact was exported from a peer-avoidance fleet — "
            "its rows interact, so row-chunked serving would give "
            "shard-local-only avoidance; serve it whole, or run "
            "DeviceFleet(mesh=...) live for multi-chip mutual avoidance"
        )
    if shards is None:
        shards = shard_fleet_args(art, args, devices)
    shard_outs = [art.call(*shard) for shard in shards]  # async per dev
    return jax.tree_util.tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0),
        *shard_outs,
    )


def shard_fleet_args(art: LoadedArtifact, args, devices):
    """Row-chunk the full-fleet argument tree into per-device committed
    shards (one [n_exp, ...] tree per device, each resident on its
    device). The static tables upload once here; a serving loop reuses
    the shards across calls and only refreshes the small mutable leaves
    (carry rows, the input matrix) between ticks."""
    n_exp = int(art.meta["n_robots"])
    leaves = jax.tree_util.tree_leaves(args)
    n_tot = int(leaves[0].shape[0])
    if n_tot != n_exp * len(devices):
        raise ValueError(
            f"args carry {n_tot} fleet rows; the artifact serves "
            f"{n_exp} rows per call, so {len(devices)} devices need "
            f"exactly {n_exp * len(devices)}"
        )
    host = jax.tree_util.tree_map(np.asarray, args)
    return [
        jax.tree_util.tree_map(
            lambda a, _d=d, _dev=dev: jax.device_put(
                a[_d * n_exp : (_d + 1) * n_exp], _dev
            ),
            host,
        )
        for d, dev in enumerate(devices)
    ]
