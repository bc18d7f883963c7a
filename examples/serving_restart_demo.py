"""Serving restart: AOT artifact + fleet snapshot, resumed bit-for-bit.

Process A (the long-lived server) exports its compiled fleet-tick
program and snapshots mid-mission state to disk. Process B (the restart
— simulated here with fresh objects) loads both and continues the
mission exactly where A stopped: no tracing, no path re-interpolation,
and the first post-restart tick is bit-identical to what A would have
produced.

Run: python examples/serving_restart_demo.py
"""

import os as _os
import sys as _sys
import tempfile

import numpy as np

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

from kompass_core_tpu.utils.runtime import (  # noqa: E402
    enable_persistent_compilation_cache,
)

enable_persistent_compilation_cache()

from kompass_core_tpu.control import (  # noqa: E402
    DWAConfig, TrajectoryCostsWeights,
)
from kompass_core_tpu.models import (  # noqa: E402
    AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
    RobotGeometry, RobotType,
)
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet  # noqa: E402
from kompass_core_tpu.serving import (  # noqa: E402
    export_fleet_tick, load_artifact, read_artifact_header,
)

N, RAYS = 4, 64


def build_fleet():
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.2, 0.4]),
        )
        for _ in range(N)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0,
                                       max_decel=6.0, max_steer=np.pi),
    )
    config = DWAConfig(
        max_linear_samples=6, max_angular_samples=6,
        prediction_horizon=12, control_horizon=2, control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
        ),
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=RAYS, path_capacity=512,
        max_segments=16,
    )
    fleet.set_paths(
        [np.array([[0.0, 1.5 * i], [5.0, 1.5 * i]]) for i in range(N)]
    )
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, RAYS, endpoint=False))
    return fleet


def inputs(step):
    states = np.zeros((N, 4), np.float32)
    states[:, 0] = 0.05 * step
    states[:, 1] = 1.5 * np.arange(N)
    vels = np.full((N, 3), 0.0, np.float32)
    vels[:, 0] = 0.4
    ranges = np.full((N, RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, RAYS, endpoint=False)
    return states, vels, ranges, angles


def main():
    tmp = tempfile.mkdtemp(prefix="kompass_serving_")
    art_path = _os.path.join(tmp, "fleet_tick.ktpuart")
    snap_path = _os.path.join(tmp, "mission_state.npz")

    # ---- process A: serve 6 ticks, then export + snapshot ----
    fleet_a = build_fleet()
    for step in range(6):
        out = fleet_a.tick(*inputs(step))
    export_fleet_tick(fleet_a, art_path)
    np.savez(snap_path, **fleet_a.state_dict())
    next_a = fleet_a.tick(*inputs(6))  # what A WOULD do next
    print(f"A served 6 ticks, exported artifact "
          f"({_os.path.getsize(art_path) // 1024} KiB) + snapshot")

    # ---- process B: load artifact + snapshot, continue ----
    hdr = read_artifact_header(art_path)
    print(f"B inventory: kind={hdr['kind']} robots="
          f"{hdr['meta']['n_robots']} platforms={hdr['platforms']}")
    art = load_artifact(art_path)
    fleet_b = build_fleet()  # config only; mission state from the snapshot
    fleet_b.load_state_dict(dict(np.load(snap_path)))
    # drive B's next tick through the ARTIFACT program
    fleet_b._write_tracked(None)
    s, v, r, a = inputs(6)
    fleet_b._inputs[:N, :4] = s
    fleet_b._inputs[:N, 4:7] = v
    fleet_b._inputs[:N, 7 : 7 + RAYS] = r
    carry_b, out_mat = art.call(*fleet_b.tick_example_args())
    vx_b = np.asarray(out_mat)[:N, 2]

    same = np.array_equal(vx_b, next_a["vx"])
    print(f"B's first post-restart commands: {np.round(vx_b, 4)}")
    print(f"bit-identical to A's next tick: {same}")
    assert same
    print("serving restart OK")


if __name__ == "__main__":
    main()
