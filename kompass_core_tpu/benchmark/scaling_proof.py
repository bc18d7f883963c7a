"""Compiled-HLO evidence for the multi-device scaling claims.

The steady-state per-tick fleet program is embarrassingly parallel over
the robot axis: with inputs and outputs both sharded ``P("robots")``,
XLA partitions the batch and inserts **no cross-device collectives** —
each device runs its local robots with no traffic between devices.

This module turns the claim into checkable artifacts: it lowers the
actual fleet programs over an 8-device mesh, compiles them, and counts
collective ops in the optimized HLO.

* ``make_fleet_solver`` (packed fleet) — must contain ZERO collectives.
* ``make_fleet_tick`` (device-resident fleet v2 steady state) — ZERO.
* ``make_sample_parallel_solver`` — the one deliberately-communicating
  program; its pmin/psum combine must compile to ``all-reduce`` ops and
  nothing else (no all-gather / all-to-all / permute / reduce-scatter).

Run as a module to print the counts as JSON; the same checks are pinned
by ``tests/test_scaling_hlo.py``.

Reference context: the SYCL reduction being replaced is the in-device
``LowestCost`` combine (``cost_evaluator_gpu.cpp:374-385``); the
reference has no cross-device axis at all (SURVEY.md §2.8).
"""

from __future__ import annotations

import json
import re
from typing import Dict, Sequence

import numpy as np

# Base names of every HLO collective that moves data across devices.
# Async forms appear as `<op>-start` / `<op>-done`; counting the base
# name catches both (start/done pairs count once via `-start`).
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
    "reduce-scatter",
    "ragged-all-to-all",
)

# The shape slot between "=" and the op name may be a plain shape
# (f32[8]{0:T(128)}) or a TUPLE shape containing spaces and parens
# ((f32[8]{0}, u32[], u32[])) — async collective starts on accelerator
# HLO have tuple shapes, so the matcher must not assume `\S+` there.
# Match everything after "=" lazily up to ` <op>(` / ` <op>-start(`.
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*.*?\s("
    + "|".join(re.escape(op) for op in COLLECTIVE_OPS)
    + r")(?:-start)?\(",
    re.MULTILINE,
)


def count_collectives(hlo_text: str) -> Dict[str, int]:
    """Count cross-device collective ops by kind in optimized HLO text.

    Matches op names at the instruction position only (after ``=``), so
    computation names or comments mentioning a collective don't count.
    Handles tuple-shaped async forms (``(f32[...], u32[]) all-gather-
    start(...)``); ``-done`` ops are not matched (their ``-start``
    already counted).
    """
    counts: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def compiled_hlo(jitted, *args) -> str:
    """Optimized (post-SPMD-partitioning) HLO for ``jitted(*args)``."""
    return jitted.lower(*args).compile().as_text()


# --- tiny-but-real program builders (shapes small enough to compile in
# seconds on the CPU mesh; the partitioning decision is shape-independent
# for a batch-sharded program) -----------------------------------------

def _tiny_spec():
    from ..ops.solver import SolverSpec

    return SolverSpec(
        is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=10,
        num_ctrl_points=2, scan_size=64, seg_size=64, drop_samples=True,
    )


def fleet_solver_hlo(mesh, n_robots: int = 16) -> str:
    from ..ops.solver import packed_input_size
    from ..parallel.fleet import make_fleet_solver

    spec = _tiny_spec()
    solver = make_fleet_solver(spec, mesh=mesh)
    args = np.zeros((n_robots, packed_input_size(spec)), np.float32)
    return compiled_hlo(solver, args)


def sample_parallel_hlo(mesh) -> str:
    from jax.sharding import Mesh

    from ..ops.solver import packed_input_size
    from ..parallel.fleet import make_sample_parallel_solver

    spec = _tiny_spec()
    # same devices, but the sample-parallel solver names its axis "sp"
    sp_mesh = Mesh(mesh.devices, axis_names=("sp",))
    n_chips = int(np.prod(sp_mesh.devices.shape))
    solver = make_sample_parallel_solver(spec, mesh=sp_mesh)
    args = np.zeros((n_chips, packed_input_size(spec)), np.float32)
    return compiled_hlo(solver, args)


def fleet_tick_hlo(mesh, n_robots: int = 8, safety: bool = False,
                   tracked: int = 0, peers: bool = False,
                   split: bool = False) -> str:
    """Lower the device-resident fleet v2 steady-state tick program with
    its real argument trees (paths/config/carry/angles/inputs).
    ``safety=True`` compiles the safety-fused variant (the critical-zone
    gate is row-local masked-min work and must stay collective-free);
    ``tracked=M`` the moving-obstacle variant (per-robot movers in the
    sharded input matrix — also row-local)."""
    from ..control import DWAConfig, TrajectoryCostsWeights
    from ..models import (
        AngularCtrlLimits,
        LinearCtrlLimits,
        Robot,
        RobotCtrlLimits,
        RobotGeometry,
        RobotType,
    )
    from ..parallel.fleet_v2 import DeviceFleet

    n_rays = 72
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=4,
        max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    from ..parallel.fleet_v2 import FleetSafetyConfig

    fleet = DeviceFleet(
        robots, limits, config, scan_rays=n_rays, path_capacity=512,
        max_segments=16, mesh=mesh,
        safety_config=FleetSafetyConfig() if safety else None,
        tracked_obstacles=tracked,
        peer_avoidance=peers,
        split_mover_sweep=split,
    )
    fleet.set_paths(
        [np.array([[1.0 * i, 0.0], [1.0 * i, 2.5]]) for i in range(n_robots)]
    )
    fleet.set_scan_angles(
        np.linspace(0, 2 * np.pi, n_rays, endpoint=False)
    )
    inputs = np.zeros(
        (fleet._n, 4 + 3 + n_rays + 4 * tracked), np.float32
    )
    safety_extra = (fleet._safety,) if safety else ()
    return compiled_hlo(
        fleet._tick_fn, fleet._paths, fleet._cfg, fleet._carry,
        fleet._angles, inputs, *safety_extra,
    )


def build_proof(mesh) -> dict:
    """Compile all three programs over ``mesh`` and return the artifact
    dict (also asserting the claims — a failed claim raises)."""
    n_dev = int(np.prod(mesh.devices.shape))
    programs = {
        "fleet_solver_packed": fleet_solver_hlo(mesh),
        "fleet_v2_tick": fleet_tick_hlo(mesh),
        "fleet_v2_tick_safety": fleet_tick_hlo(mesh, safety=True),
        "fleet_v2_tick_tracked": fleet_tick_hlo(mesh, tracked=2),
        "fleet_v2_tick_tracked_split": fleet_tick_hlo(
            mesh, tracked=2, split=True
        ),
        "fleet_v2_tick_peers_mesh": fleet_tick_hlo(mesh, peers=True),
        "sample_parallel_solver": sample_parallel_hlo(mesh),
    }
    entries = {}
    for name, hlo in programs.items():
        counts = count_collectives(hlo)
        entries[name] = {
            "collective_counts": counts,
            "total_collectives": sum(counts.values()),
            "hlo_instructions": hlo.count("\n"),
        }
    for name in (
        "fleet_solver_packed", "fleet_v2_tick", "fleet_v2_tick_safety",
        "fleet_v2_tick_tracked", "fleet_v2_tick_tracked_split",
    ):
        assert entries[name]["total_collectives"] == 0, (
            f"{name}: steady-state fleet program must contain zero "
            f"cross-device collectives, found {entries[name]}"
        )
    sp = entries["sample_parallel_solver"]["collective_counts"]
    assert set(sp) == {"all-reduce"} and sp["all-reduce"] >= 1, (
        "sample-parallel combine must compile to all-reduce ops only, "
        f"found {sp}"
    )
    # mesh-sharded mutual avoidance: the peer state is
    # the ONLY thing crossing devices — exactly one bounded all-gather of
    # the [N, 7] state+velocity block per tick, nothing else
    pm = entries["fleet_v2_tick_peers_mesh"]["collective_counts"]
    assert pm == {"all-gather": 1}, (
        "mesh peer tick must contain exactly one all-gather and no "
        f"other collectives, found {pm}"
    )
    return {
        "mesh_devices": n_dev,
        "platform": mesh.devices.flat[0].platform,
        "claim": (
            "steady-state fleet tick is embarrassingly parallel over the"
            " robot axis: zero cross-device collectives in the optimized"
            " HLO => cross-device scaling adds no communication"
        ),
        "programs": entries,
    }


def main():
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    mesh = Mesh(np.array(devices), axis_names=("robots",))
    proof = build_proof(mesh)
    print(json.dumps(proof, indent=1))
    return proof


if __name__ == "__main__":
    main()
