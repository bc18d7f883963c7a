"""Amortized serving: one robot, K control ticks per host round trip.

A blocking single solve pays one host<->device round trip per tick.
``DeviceFleet.run_ticks_on_device(k)`` freezes the scan to world
obstacles at the tick-0 pose, runs K solve->apply->integrate ticks
inside ONE dispatch, and returns K commands per round trip — per-tick
cost ~= round trip / k + compute.

Run: PYTHONPATH=. python examples/rtt_amortized_serving_demo.py [k]
"""

import sys
import time

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet
from kompass_core_tpu.utils.runtime import (
    enable_persistent_compilation_cache,
)

enable_persistent_compilation_cache()


def main(k: int = 8):
    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.1, 0.4]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0
        ),
    )
    n_rays = 128
    fleet = DeviceFleet([robot], limits, config, scan_rays=n_rays,
                        path_capacity=512, max_segments=16)
    fleet.set_paths([np.array([[0.0, 0.0], [0.0, 3.0]])])
    angles = np.linspace(0, 2 * np.pi, n_rays, endpoint=False)

    state = np.array([[0.0, 0.0, np.pi / 2, 0.0]])
    vel = np.zeros((1, 3))
    ranges = np.full((1, n_rays), 10.0)

    # warm both programs (the first call compiles)
    fleet.run_ticks_on_device(k, state, vel, ranges, angles)
    fleet.tick(state, vel, ranges, angles)

    # --- single-tick serving: one round trip per command ---
    t0 = time.perf_counter()
    n_single = 5
    s = state.copy()
    for i in range(n_single):
        s[0, 0] += 1e-4  # distinct inputs (measurement-integrity rule)
        fleet.tick(s, vel, ranges, angles)
    per_tick_single = (time.perf_counter() - t0) / n_single * 1e3

    # --- K-tick serving: one round trip per K commands ---
    t0 = time.perf_counter()
    n_batches = 5
    for i in range(n_batches):
        s[0, 0] += 1e-4
        out = fleet.run_ticks_on_device(k, s, vel, ranges, angles)
    per_tick_k = (time.perf_counter() - t0) / (n_batches * k) * 1e3

    print(f"single-tick serving : {per_tick_single:7.2f} ms/tick e2e")
    print(f"k={k:<3d} tick serving : {per_tick_k:7.2f} ms/tick e2e "
          f"({per_tick_single / max(per_tick_k, 1e-9):.1f}x)")
    print(f"commands per round trip: vx={np.round(out['vx'][0], 3)}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
