"""Full-stack demo: global planning -> DWA following -> mapping -> e-stop.

A robot in a room with a wall must reach a goal behind it:

1. `GlobalPlanner` (PRM) plans a path around the wall from a point-cloud
   map of the room.
2. `DWA` follows the planned path in closed loop, with the wall visible in
   the simulated laser scan.
3. `LocalMapper` builds the egocentric occupancy grid each tick.
4. `EmergencyChecker` monitors the critical zone.

Run: PYTHONPATH=. python examples/full_stack_demo.py
"""

import math
import sys
import time

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

from kompass_core_tpu.control import DWA, DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.datatypes import LaserScanData
from kompass_core_tpu.datatypes.pose import PoseData
from kompass_core_tpu.datatypes.scan_model import ScanModelConfig
from kompass_core_tpu.mapping import LocalMapper, MapConfig, OCCUPANCY_TYPE
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.planning import GlobalPlanner, GlobalPlannerConfig
from kompass_core_tpu.utils.emergency_stop import EmergencyChecker
from kompass_core_tpu.utils.runtime import (
    enable_persistent_compilation_cache,
)

enable_persistent_compilation_cache()

# --- world: 10x10 room with a wall at y=5 (gap at x in [7, 9]) -------------

WALL_SEGMENTS = []  # list of (x0, y0, x1, y1)
for x0, y0, x1, y1 in [
    (0, 0, 10, 0), (0, 10, 10, 10), (0, 0, 0, 10), (10, 0, 10, 10),  # walls
    (0, 5, 7, 5),  # interior wall with a gap at x in (7, 10)
]:
    WALL_SEGMENTS.append((x0, y0, x1, y1))


def raycast(x, y, yaw, angles, max_range=12.0):
    """Exact 2D raycast of the world's segments."""
    ranges = np.full(len(angles), max_range)
    for i, a in enumerate(angles):
        dx, dy = math.cos(yaw + a), math.sin(yaw + a)
        best = max_range
        for x0, y0, x1, y1 in WALL_SEGMENTS:
            ex, ey = x1 - x0, y1 - y0
            denom = dx * ey - dy * ex  # d x e
            if abs(denom) < 1e-12:
                continue
            sx, sy = x0 - x, y0 - y
            t = (sx * ey - sy * ex) / denom  # (s0-p) x e / (d x e)
            u = (sx * dy - sy * dx) / denom  # (s0-p) x d / (d x e)
            if t > 1e-6 and 0.0 <= u <= 1.0:
                best = min(best, t)
        ranges[i] = best
    return ranges


def wall_cloud():
    pts = []
    for x0, y0, x1, y1 in WALL_SEGMENTS:
        n = int(math.hypot(x1 - x0, y1 - y0) / 0.05) + 1
        t = np.linspace(0, 1, n)
        pts.append(
            np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0), np.zeros(n)], 1)
        )
    return np.concatenate(pts)


def main():
    t_start = time.time()
    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.2, 0.5]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.5, max_acc=5.0, max_decel=5.0),
    )

    # 1. global plan around the wall
    planner = GlobalPlanner(
        robot,
        config=GlobalPlannerConfig(
            planner_id="PRM", num_samples=512, seed=2, connection_radius=4.0,
            # margin must exceed the e-stop's critical reach beyond the
            # robot radius (emergency_distance 0.25 + radius 0.2 = 0.45 m
            # from obstacle points): shortcut paths hug the inflated
            # boundary, and a 0.1 m margin let the route graze a wall-gap
            # corner inside the critical cone — the e-stop then (correctly)
            # froze forward motion for good
            margin=0.5,
        ),
    )
    meta = {"resolution": 0.1, "width": 100, "height": 100,
            "origin_x": 0.0, "origin_y": 0.0}
    start = (2.0, 2.0)
    goal = (2.0, 8.0)
    planner.setup_problem(meta, *start, 0.0, *goal, 0.0, wall_cloud())
    path = planner.solve()
    assert path is not None, "global planner found no path"
    print(f"[plan] {len(path)} waypoints, cost {planner.path_cost:.2f} m "
          f"(straight-line would be 6.0 m, blocked)", flush=True)
    assert planner.path_cost > 7.0  # must detour through the gap

    # 2-4. follow with DWA + map + estop
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
        max_point_interpolation_distance=0.05,
    )
    dwa = DWA(robot=robot, ctrl_limits=limits, config=config)
    dwa.set_path(path)

    mapper = LocalMapper(
        MapConfig(width=6.0, height=6.0, resolution=0.1),
        ScanModelConfig(p_prior=0.5),
    )
    estop = EmergencyChecker(
        robot, emergency_distance=0.25, slowdown_distance=0.5,
        emergency_angle=120.0,
    )

    robot.state.x, robot.state.y, robot.state.yaw = start[0], start[1], math.pi / 2
    angles = np.linspace(-np.pi, np.pi, 180, endpoint=False)
    min_slowdown = 1.0
    steps = 0
    max_steps = 600
    while steps < max_steps and not dwa.reached_end():
        ranges = raycast(robot.state.x, robot.state.y, robot.state.yaw, angles)
        scan = LaserScanData(ranges=ranges, angles=angles)

        factor = estop.run(scan=scan, forward=True)
        min_slowdown = min(min_slowdown, factor)

        pose = PoseData()
        pose.set_position(robot.state.x, robot.state.y)
        pose.set_yaw(robot.state.yaw)
        mapper.update_from_scan(pose, scan)

        if not dwa.loop_step(current_state=robot.state, laser_scan=scan):
            break
        for vx, vy, om in zip(
            dwa.linear_x_control, dwa.linear_y_control, dwa.angular_control
        ):
            robot.set_control(velocity_x=vx * factor, velocity_y=vy * factor,
                              omega=om)
            robot.get_state(dt=0.1)
            steps += 1
            if dwa.reached_end():
                break

    occ = mapper.occupancy
    n_occ = int(np.sum(occ == OCCUPANCY_TYPE.OCCUPIED.value))
    print(
        f"[follow] reached={dwa.reached_end()} steps={steps} "
        f"final=({robot.state.x:.2f},{robot.state.y:.2f}) goal={goal}",
        flush=True,
    )
    print(f"[map] occupied cells in last egocentric grid: {n_occ}", flush=True)
    print(f"[estop] min slowdown factor seen: {min_slowdown:.2f}", flush=True)
    print(f"[demo] wall clock {time.time() - t_start:.1f} s", flush=True)

    assert dwa.reached_end(), "robot did not reach the goal"
    assert n_occ > 20, "mapper saw no walls"
    ok_dist = math.hypot(robot.state.x - goal[0], robot.state.y - goal[1])
    assert ok_dist < 0.5
    print("FULL STACK DEMO PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
