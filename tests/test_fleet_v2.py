"""Device-resident fleet (v2) tests: closed loop + parity with the host
runtime."""

import numpy as np
import pytest

import jax

from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.parallel import build_fleet_mesh
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

N_RAYS = 72


def _make(n_robots, robot_type=RobotType.DIFFERENTIAL_DRIVE, mesh=None):
    robots = [
        Robot(
            robot_type=robot_type,
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
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16, mesh=mesh,
    )
    return robots, fleet


def _run_closed_loop(robots, fleet, paths, max_ticks=80):
    fleet.set_paths(paths)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((len(robots), N_RAYS), 10.0)
    dt = 0.1
    for _ in range(max_ticks):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, r.state.speed] for r in robots]
        )
        vels = np.array(
            [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        if out["reached"].all():
            return True, out
        for r, vx, vy, om, found in zip(
            robots, out["vx"], out["vy"], out["omega"], out["found"]
        ):
            if found:
                r.set_control(velocity_x=vx, velocity_y=vy, omega=om)
                r.get_state(dt=dt)
    return bool(out["reached"].all()), out


def test_device_fleet_reaches_goals():
    robots, fleet = _make(12, mesh=build_fleet_mesh())
    paths = []
    for i, r in enumerate(robots):
        x0 = 1.0 * i
        r.state.x, r.state.y, r.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 2.5]]))
    done, out = _run_closed_loop(robots, fleet, paths)
    assert done, f"not all reached: {out['reached']}"
    for r, p in zip(robots, paths):
        assert np.hypot(r.state.x - p[-1, 0], r.state.y - p[-1, 1]) < 0.3


def test_device_fleet_rotate_in_place_first():
    """Diff-drive robots facing away must rotate toward the path before
    driving (on-device rotate-in-place branch)."""
    robots, fleet = _make(4)
    paths = []
    for i, r in enumerate(robots):
        x0 = 2.0 * i
        r.state.x, r.state.y, r.state.yaw = x0, 0.0, np.pi  # facing -x
        paths.append(np.array([[x0, 0.0], [x0 + 2.0, 0.0]]))  # path +x
    fleet.set_paths(paths)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((4, N_RAYS), 10.0)
    states = np.array(
        [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots]
    )
    out = fleet.tick(states, np.zeros((4, 3)), ranges, angles)
    assert out["found"].all()
    # pure rotation: no translation, |omega| > 0
    np.testing.assert_allclose(out["vx"], 0.0, atol=1e-6)
    assert np.all(np.abs(out["omega"]) > 0.1)
    done, _ = _run_closed_loop(robots, fleet, paths)
    assert done


def test_device_fleet_matches_host_runtime_commands():
    """First-tick commands must match the host FleetRuntime (same follower
    semantics on both sides)."""
    from kompass_core_tpu.parallel import FleetRuntime
    from kompass_core_tpu.datatypes import LaserScanData

    n = 6
    robots, fleet = _make(n, robot_type=RobotType.ACKERMANN)
    host_robots = [
        Robot(
            robot_type=RobotType.ACKERMANN,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n)
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
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    host = FleetRuntime(host_robots, limits, config)
    paths = []
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    for i, (r, hr) in enumerate(zip(robots, host_robots)):
        x0 = 1.5 * i
        for rr in (r, hr):
            rr.state.x, rr.state.y, rr.state.yaw = x0 + 0.1, 0.05, np.pi / 2 + 0.2
        paths.append(np.array([[x0, 0.0], [x0 + 0.3, 2.5]]))
    fleet.set_paths(paths)
    host.set_paths(paths)

    ranges = np.full((n, N_RAYS), 10.0)
    states = np.array(
        [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots]
    )
    out_dev = fleet.tick(states, np.zeros((n, 3)), ranges, angles)
    scan = LaserScanData(ranges=np.full(N_RAYS, 10.0), angles=angles)
    out_host = host.tick([r.state for r in host_robots], [scan] * n)
    for i in range(n):
        assert out_dev["found"][i] == out_host[i]["found"]
        assert out_dev["vx"][i] == pytest.approx(out_host[i]["vx"], abs=1e-4)
        assert out_dev["omega"][i] == pytest.approx(
            out_host[i]["omega"], abs=1e-4
        )


# --- heterogeneous fleets ----------------------------------------------------


def _hetero_config():
    return DWAConfig(
        max_linear_samples=4,
        max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )


def _limits(vx=1.0, vy=0.0):
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=vx, max_acc=5.0, max_decel=10.0),
        vy_limits=LinearCtrlLimits(max_vel=vy or 0.5, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )


def test_mixed_kinematics_fleet_reaches_goals():
    """Diff-drive + omni robots in ONE fleet dispatch (per-robot is_omni
    via zeroed vy limits on the non-omni rows)."""
    robots = []
    for i in range(4):
        rt = RobotType.OMNI if i % 2 else RobotType.DIFFERENTIAL_DRIVE
        robots.append(
            Robot(
                robot_type=rt,
                geometry_type=RobotGeometry.Type.CYLINDER,
                geometry_params=np.array([0.1, 0.4]),
            )
        )
    fleet = DeviceFleet(
        robots, [_limits() for _ in robots], _hetero_config(),
        scan_rays=N_RAYS, path_capacity=512, max_segments=16,
    )
    paths = []
    for i, r in enumerate(robots):
        x0 = 2.0 * i
        r.state.x, r.state.y, r.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 2.5]]))
    done, out = _run_closed_loop(robots, fleet, paths)
    assert done, f"not all reached: {out['reached']}"


def test_mixed_shapes_match_homogeneous_fleets():
    """circle + BOX in one fleet must give the same first-tick commands as
    the per-shape homogeneous fleets (the (0,0)-extent box degenerates to
    the exact circle model; dynamic box == static box)."""
    cfg = _hetero_config()
    cfg.costs_weights.obstacles_distance_weight = 1.0
    circle = Robot(
        robot_type=RobotType.ACKERMANN,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.1, 0.4]),
    )
    box = Robot(
        robot_type=RobotType.ACKERMANN,
        geometry_type=RobotGeometry.Type.BOX,
        geometry_params=np.array([1.2, 0.2, 0.3]),
    )
    lim = _limits()
    angles = np.linspace(-np.pi, np.pi, N_RAYS, endpoint=False)
    # wall AHEAD at 0.5 m in the body frame: the 1.2 m-long box (half
    # length 0.6) is already into the wall -> every pose collides, no
    # admissible sample; the r=0.1 circle still advances
    ranges = np.full(N_RAYS, 10.0)
    wall_pts = [
        (0.5, lat) for lat in np.arange(-1.0, 1.0, 0.02)
    ]  # body x = forward, y = lateral
    for bx, by in wall_pts:
        ang = np.arctan2(by, bx)
        r = np.hypot(bx, by)
        k = int(np.argmin(np.abs(np.angle(np.exp(1j * (angles - ang))))))
        ranges[k] = min(ranges[k], r)

    def first_tick(fleet, robots):
        paths = []
        for r in robots:
            r.state.x, r.state.y, r.state.yaw = 0.1, 0.05, np.pi / 2
            paths.append(np.array([[0.0, 0.0], [0.3, 2.5]]))
        fleet.set_paths(paths)
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots]
        )
        rr = np.tile(ranges, (len(robots), 1))
        return fleet.tick(states, np.zeros((len(robots), 3)), rr, angles)

    mixed = DeviceFleet(
        [circle, box], lim, cfg, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16,
    )
    homo_c = DeviceFleet(
        [circle], lim, cfg, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16,
    )
    homo_b = DeviceFleet(
        [box], lim, cfg, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16,
    )
    out_m = first_tick(mixed, [circle, box])
    out_c = first_tick(homo_c, [circle])
    out_b = first_tick(homo_b, [box])
    assert out_m["found"][0] == out_c["found"][0]
    assert out_m["found"][1] == out_b["found"][0]
    np.testing.assert_allclose(out_m["vx"][0], out_c["vx"][0], atol=1e-5)
    np.testing.assert_allclose(out_m["omega"][0], out_c["omega"][0], atol=1e-5)
    np.testing.assert_allclose(out_m["vx"][1], out_b["vx"][0], atol=1e-5)
    np.testing.assert_allclose(out_m["omega"][1], out_b["omega"][0], atol=1e-5)
    # and the two shapes must actually behave differently in this scene
    # (otherwise the test proves nothing): the long box is wedged against
    # the wall, the small circle still moves
    assert out_m["found"][0] and not out_m["found"][1]


def test_per_robot_limits_respected():
    """Per-robot ctrl limits: the slow robot's command must honor ITS
    vx ceiling while the fast robot exceeds it."""
    robots = [
        Robot(
            robot_type=RobotType.ACKERMANN,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(2)
    ]
    fleet = DeviceFleet(
        robots, [_limits(vx=1.0), _limits(vx=0.25)], _hetero_config(),
        scan_rays=N_RAYS, path_capacity=512, max_segments=16,
    )
    paths = []
    for r in robots:
        r.state.x, r.state.y, r.state.yaw = 0.0, 0.0, 0.0
        paths.append(np.array([[0.0, 0.0], [3.0, 0.0]]))
    fleet.set_paths(paths)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((2, N_RAYS), 10.0)
    # run a few ticks so the window accelerates to the per-robot ceiling
    vels = np.zeros((2, 3))
    for _ in range(6):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        vels = np.stack([out["vx"], out["vy"], out["omega"]], axis=1)
        for r, vx, om in zip(robots, out["vx"], out["omega"]):
            r.set_control(velocity_x=vx, velocity_y=0.0, omega=om)
            r.get_state(dt=0.1)
    assert out["vx"][1] <= 0.25 + 1e-5
    assert out["vx"][0] > 0.3


def test_per_robot_sensor_pose():
    """A robot with a backward-mounted sensor must interpret the same scan
    as obstacles BEHIND it (free to advance); the forward-mounted one sees
    the wall ahead."""
    cfg = _hetero_config()
    cfg.costs_weights.obstacles_distance_weight = 1.0
    robots = [
        Robot(
            robot_type=RobotType.ACKERMANN,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(2)
    ]
    fleet = DeviceFleet(
        robots, _limits(), cfg, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16,
        sensor_poses=np.array(
            [[0.0, 0.0, 0.0], [0.0, 0.0, np.pi]], np.float32
        ),
    )
    paths = []
    for r in robots:
        r.state.x, r.state.y, r.state.yaw = 0.0, 0.0, 0.0
        paths.append(np.array([[0.0, 0.0], [3.0, 0.0]]))
    fleet.set_paths(paths)
    angles = np.linspace(-np.pi, np.pi, N_RAYS, endpoint=False)
    # wall straight ahead in SENSOR frame at 0.35 m
    ranges = np.full(N_RAYS, 10.0)
    ranges[np.abs(angles) < np.radians(40)] = 0.35
    states = np.array(
        [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots]
    )
    out = fleet.tick(
        states, np.zeros((2, 3)), np.tile(ranges, (2, 1)), angles
    )
    # robot 1 (sensor yaw=pi): the wall is behind -> full speed ahead;
    # robot 0: wall ahead -> blocked or crawling
    assert out["found"][1]
    assert out["vx"][1] > 0.15
    assert (not out["found"][0]) or out["vx"][0] < out["vx"][1] - 0.1


def test_device_fleet_multi_tick_lockstep_with_host_runtime():
    """10-tick closed-loop lockstep: the device-resident runtime must track
    the host runtime's commands through follower-state evolution (sticky
    segments, adaptive horizon), not just on the first tick."""
    from kompass_core_tpu.parallel import FleetRuntime
    from kompass_core_tpu.datatypes import LaserScanData

    n = 3
    robots, fleet = _make(n, robot_type=RobotType.ACKERMANN)
    host_robots = [
        Robot(
            robot_type=RobotType.ACKERMANN,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n)
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
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    host = FleetRuntime(host_robots, limits, config)
    paths = []
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    for i, (r, hr) in enumerate(zip(robots, host_robots)):
        x0 = 2.0 * i
        for rr in (r, hr):
            rr.state.x, rr.state.y, rr.state.yaw = x0 + 0.1, 0.05, np.pi / 2 + 0.2
        # gently curving path so the tracked segment and horizon evolve
        t = np.linspace(0.0, 1.0, 8)
        paths.append(
            np.stack([x0 + 0.6 * t**2, 2.8 * t], axis=1)
        )
    fleet.set_paths(paths)
    host.set_paths(paths)
    scan = LaserScanData(ranges=np.full(N_RAYS, 10.0), angles=angles)
    ranges = np.full((n, N_RAYS), 10.0)

    vels = np.zeros((n, 3))
    for tick in range(10):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots]
        )
        out_dev = fleet.tick(states, vels, ranges, angles)
        out_host = host.tick([r.state for r in host_robots], [scan] * n)
        for i in range(n):
            assert out_dev["found"][i] == out_host[i]["found"], (
                f"tick {tick} robot {i}"
            )
            assert out_dev["vx"][i] == pytest.approx(
                out_host[i]["vx"], abs=2e-4
            ), f"tick {tick} robot {i}"
            assert out_dev["omega"][i] == pytest.approx(
                out_host[i]["omega"], abs=2e-4
            ), f"tick {tick} robot {i}"
        # advance BOTH sims with the device commands (identical inputs)
        vels = np.stack(
            [out_dev["vx"], out_dev["vy"], out_dev["omega"]], axis=1
        )
        for rr_pair, vx, vy, om in zip(
            zip(robots, host_robots), out_dev["vx"], out_dev["vy"],
            out_dev["omega"],
        ):
            for rr in rr_pair:
                rr.set_control(velocity_x=vx, velocity_y=vy, omega=om)
                rr.get_state(dt=0.1)
        if out_dev["reached"].all():
            break


def test_chunked_dispatch_matches_single_dispatch():
    """Fleets above the dispatch-chunk size are served as pipelined chunks;
    results must match the monolithic dispatch exactly."""
    n = 20
    robots_a, fleet_a = _make(n)  # chunked: 3 chunks of 8 (chunk=8)
    robots_b, fleet_b = _make(n)
    # force chunking on fleet_a with a small chunk size
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    fleet_a = DeviceFleet(
        robots_a, limits, fleet_a.config, scan_rays=N_RAYS,
        path_capacity=512, max_segments=16, dispatch_chunk=8,
    )
    assert fleet_a._chunk == 8 and fleet_a._n == 24
    fleet_b = DeviceFleet(
        robots_b, limits, fleet_b.config, scan_rays=N_RAYS,
        path_capacity=512, max_segments=16, dispatch_chunk=0,
    )
    assert fleet_b._chunk == 0

    paths = []
    for i, (ra, rb) in enumerate(zip(robots_a, robots_b)):
        x0 = 1.0 * i
        for r in (ra, rb):
            r.state.x, r.state.y, r.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 2.5]]))
    fleet_a.set_paths(paths)
    fleet_b.set_paths(paths)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((n, N_RAYS), 10.0)
    vels = np.zeros((n, 3))
    for tick in range(5):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots_a]
        )
        out_a = fleet_a.tick(states, vels, ranges, angles)
        out_b = fleet_b.tick(states, vels, ranges, angles)
        for key in ("found", "reached"):
            np.testing.assert_array_equal(out_a[key], out_b[key])
        for key in ("vx", "vy", "omega", "cost"):
            np.testing.assert_allclose(
                out_a[key], out_b[key], rtol=1e-6, atol=1e-7,
                err_msg=f"tick {tick} field {key}",
            )
        vels = np.stack([out_a["vx"], out_a["vy"], out_a["omega"]], axis=1)
        for r, vx, om in zip(robots_a, out_a["vx"], out_a["omega"]):
            r.set_control(velocity_x=vx, velocity_y=0.0, omega=om)
            r.get_state(dt=0.1)


def test_lockstep_with_obstacles_randomized():
    """Randomized-obstacle lockstep: v1 (host follower + device solve) and
    v2 (whole pipeline on device) must issue the same commands through 8
    closed-loop ticks with the obstacle cost ACTIVE and some samples
    dropped by collisions — covering scan->world transform, admissibility
    and obstacle-cost parity between the two runtimes (round-1 review
    called the single coarse cross-check out as a gap)."""
    from kompass_core_tpu.parallel import FleetRuntime
    from kompass_core_tpu.datatypes import LaserScanData

    n = 4
    robots, _ = _make(n)
    host_robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=5,
        max_angular_samples=5,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0,
            goal_distance_weight=1.0,
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=1.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16,
    )
    host = FleetRuntime(host_robots, limits, config)

    rng = np.random.default_rng(7)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    # per-robot random clutter: most rays far, a frontal band at
    # 0.8-2.5 m so some rollouts collide (drop) and the obstacle cost
    # shapes the winner
    ranges = rng.uniform(4.0, 9.0, (n, N_RAYS))
    frontal = (angles < 0.9) | (angles > 2 * np.pi - 0.9)
    ranges[:, frontal] = rng.uniform(0.8, 2.5, (n, frontal.sum()))

    paths = []
    for i, (r, hr) in enumerate(zip(robots, host_robots)):
        x0 = 3.0 * i
        yaw = rng.uniform(-0.4, 0.4)
        for rr in (r, hr):
            rr.state.x, rr.state.y, rr.state.yaw = x0, 0.0, yaw
        t = np.linspace(0.0, 1.0, 6)
        paths.append(
            np.stack(
                [x0 + 2.5 * t, 0.8 * t * rng.uniform(-1.0, 1.0)], axis=1
            )
        )
    fleet.set_paths(paths)
    host.set_paths(paths)

    vels = np.zeros((n, 3))
    any_dropped = False
    for tick in range(8):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, 0.0] for r in robots]
        )
        out_dev = fleet.tick(states, vels, ranges, angles)
        scans = [
            LaserScanData(ranges=ranges[i], angles=angles) for i in range(n)
        ]
        out_host = host.tick([r.state for r in host_robots], scans)
        for i in range(n):
            assert out_dev["found"][i] == out_host[i]["found"], (
                f"tick {tick} robot {i}"
            )
            if not out_dev["found"][i]:
                continue
            assert out_dev["vx"][i] == pytest.approx(
                out_host[i].get("vx", 0.0), abs=2e-4
            ), f"tick {tick} robot {i}"
            assert out_dev["omega"][i] == pytest.approx(
                out_host[i].get("omega", 0.0), abs=2e-4
            ), f"tick {tick} robot {i}"
        vels = np.stack(
            [out_dev["vx"], out_dev["vy"], out_dev["omega"]], axis=1
        )
        for rr_pair, vx, om in zip(
            zip(robots, host_robots), out_dev["vx"], out_dev["omega"]
        ):
            for rr in rr_pair:
                rr.set_control(velocity_x=vx, velocity_y=0.0, omega=om)
                rr.get_state(dt=0.1)
        # confirm the clutter actually bit: at least one tick where some
        # sample was inadmissible for some robot
        if "num_admissible" in out_dev:
            any_dropped |= bool(
                (np.asarray(out_dev["num_admissible"]) < 25).any()
            )
    if "num_admissible" in out_dev:
        assert any_dropped, "clutter never dropped a sample — weak scenario"


def test_sensor_max_range_flows_into_obstacle_cost_params():
    """DeviceFleet exposes the sensor range; max_obstacles_dist = range/3
    (the single-robot set_sensor_max_range rule; review-fix regression:
    previously hardcoded 10/3)."""
    robots, fleet_default = _make(2)
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    fleet = DeviceFleet(
        robots,
        _limits(),
        fleet_default.config,
        scan_rays=N_RAYS,
        path_capacity=512,
        max_segments=16,
        sensor_max_range=30.0,
    )
    params = np.asarray(fleet._cfg.params12)
    np.testing.assert_allclose(params[:, 11], 30.0 / 3.0, rtol=1e-6)
    params_d = np.asarray(fleet_default._cfg.params12)
    np.testing.assert_allclose(params_d[:, 11], 10.0 / 3.0, rtol=1e-6)


def test_monolithic_escape_hatch_above_default_chunk():
    """dispatch_chunk=0 must run ONE unchunked vmap even when the fleet
    is larger than the default chunk of 64 (regression: the tick program
    once received a fallback chunk=64 and asserted on the unpadded 65)."""
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    n = 65
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_steer=np.pi, max_decel=3.0
        ),
    )
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        prediction_horizon=5, control_horizon=2, control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=256,
        max_segments=8, dispatch_chunk=0,
    )
    assert fleet._chunk == 0 and fleet._n == 65
    fleet.set_paths([np.array([[0.1 * i, 0.0], [0.1 * i, 1.5]])
                     for i in range(n)])
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    states = np.array([[0.1 * i, 0.0, np.pi / 2, 0.0] for i in range(n)])
    out = fleet.tick(states, np.zeros((n, 3)),
                     np.full((n, N_RAYS), 10.0), angles)
    assert out["found"].all()


# --- fleet mutual avoidance (peer_avoidance) -------------------------------


def _make_peer(n, peer, radius=0.3, obstacles_weight=0.0, mesh=None):
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([radius, 0.4]),
        )
        for _ in range(n)
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
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=obstacles_weight,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16, peer_avoidance=peer, mesh=mesh,
    )
    return robots, fleet


def _head_on_min_distance(peer, mesh=None):
    """Two robots driving toward each other on the same line; returns the
    minimum center distance reached over the episode."""
    robots, fleet = _make_peer(2, peer, mesh=mesh)
    robots[0].state.x, robots[0].state.yaw = 0.0, 0.0
    robots[1].state.x, robots[1].state.yaw = 4.0, np.pi
    for r in robots:
        r.state.y = 0.0
    fleet.set_paths([
        np.array([[0.0, 0.0], [4.0, 0.0]]),
        np.array([[4.0, 0.0], [0.0, 0.0]]),
    ])
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((2, N_RAYS), 10.0)
    min_d = np.inf
    for _ in range(70):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
             for r in robots]
        )
        vels = np.array(
            [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        for r, vx, vy, om, found in zip(
            robots, out["vx"], out["vy"], out["omega"], out["found"]
        ):
            if found:
                r.set_control(velocity_x=vx, velocity_y=vy, omega=om)
                r.get_state(dt=0.1)
        d = np.hypot(
            robots[0].state.x - robots[1].state.x,
            robots[0].state.y - robots[1].state.y,
        )
        min_d = min(min_d, d)
    return min_d


def test_peer_avoidance_head_on_no_collision():
    """Two r=0.3 robots sent head-on along the same line: with
    peer_avoidance the fleet must keep the center distance above the
    contact distance (2r = 0.6); without it they drive through each
    other (the reference has no fleet concept at all — this capability
    is beyond-reference, see PARITY.md)."""
    d_without = _head_on_min_distance(peer=False)
    d_with = _head_on_min_distance(peer=True)
    assert d_without < 0.4, f"control scenario too easy: {d_without}"
    assert d_with > 0.55, f"peers collided: min distance {d_with}"


def test_peer_avoidance_single_robot_identity():
    """A lone robot's commands must be bit-identical with peer_avoidance
    on (its own peer block is masked to the pad sentinel; pad rows are
    masked by n_real)."""
    outs = []
    for peer in (False, True):
        robots, fleet = _make_peer(1, peer)
        robots[0].state.x = 0.0
        robots[0].state.yaw = np.pi / 2
        fleet.set_paths([np.array([[0.0, 0.0], [0.0, 2.0]])])
        angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
        ranges = np.full((1, N_RAYS), 10.0)
        cmds = []
        for _ in range(6):
            states = np.array(
                [[robots[0].state.x, robots[0].state.y,
                  robots[0].state.yaw, robots[0].state.speed]]
            )
            vels = np.array(
                [[robots[0].state.vx, robots[0].state.vy,
                  robots[0].state.omega]]
            )
            out = fleet.tick(states, vels, ranges, angles)
            cmds.append([out["vx"][0], out["vy"][0], out["omega"][0]])
            if out["found"][0]:
                robots[0].set_control(
                    velocity_x=out["vx"][0], velocity_y=out["vy"][0],
                    omega=out["omega"][0],
                )
                robots[0].get_state(dt=0.1)
        outs.append(np.asarray(cmds))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_peer_avoidance_head_on_no_collision_on_mesh():
    """Mutual avoidance COMPOSES with multi-device sharding. The same head-on scenario runs
    with the two robots on different shards of the 8-device mesh — the
    peer state crosses chips as one bounded all-gather per tick
    (tests/test_scaling_hlo.py) — and must keep the
    same safe separation the single-device fleet does."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    d_with = _head_on_min_distance(peer=True, mesh=build_fleet_mesh())
    assert d_with > 0.55, f"peers collided on the mesh: min dist {d_with}"


def test_peer_avoidance_k_ticks_on_device():
    """Fleet-synchronous k-tick loop: two head-on robots run k=50 ticks
    in ONE dispatch with peers re-derived from the live on-device states
    each tick — the device-integrated trajectories must never come
    closer than the contact distance (2r = 0.6)."""
    robots, fleet = _make_peer(2, peer=True)
    robots[0].state.x, robots[0].state.yaw = 0.0, 0.0
    robots[1].state.x, robots[1].state.yaw = 4.0, np.pi
    fleet.set_paths([
        np.array([[0.0, 0.0], [4.0, 0.0]]),
        np.array([[4.0, 0.0], [0.0, 0.0]]),
    ])
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    states = np.array([[0.0, 0.0, 0.0, 0.0], [4.0, 0.0, np.pi, 0.0]])
    out = fleet.run_ticks_on_device(
        50, states, np.zeros((2, 3)), np.full((2, N_RAYS), 10.0), angles
    )
    # reconstruct the on-device trajectories with the same kinematic
    # update the program applies (unicycle, dt = control_time_step)
    dt = 0.1
    s = states.copy()
    min_d = np.hypot(s[0, 0] - s[1, 0], s[0, 1] - s[1, 1])
    for t in range(50):
        for i in range(2):
            vx, vy, om = out["vx"][i, t], out["vy"][i, t], out["omega"][i, t]
            cy, sy = np.cos(s[i, 2]), np.sin(s[i, 2])
            s[i, 0] += dt * (vx * cy - vy * sy)
            s[i, 1] += dt * (vx * sy + vy * cy)
            s[i, 2] += dt * om
        min_d = min(min_d, np.hypot(s[0, 0] - s[1, 0], s[0, 1] - s[1, 1]))
    np.testing.assert_allclose(s[:, :3], out["final_states"][:, :3],
                               rtol=1e-4, atol=1e-4)
    assert min_d > 0.55, f"peers collided inside the k-loop: {min_d}"


def test_peer_avoidance_box_fleet():
    """peer_avoidance composes with the dynamic-box collision path: a BOX
    robot in the fleet switches every robot to oriented-box collision
    while peers remain obstacle discs at each peer's circumscribed
    radius. Head-on box robots must still keep clear."""
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.BOX,
            geometry_params=np.array([0.5, 0.4, 0.3]),  # l, w, h
        )
        for _ in range(2)
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
            smoothness_weight=0.0,
            jerk_weight=0.0,
            obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10,
        control_horizon=2,
        control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16, peer_avoidance=True,
    )
    assert fleet.spec.solver.dynamic_box
    robots[0].state.x, robots[0].state.yaw = 0.0, 0.0
    robots[1].state.x, robots[1].state.yaw = 4.0, np.pi
    fleet.set_paths([
        np.array([[0.0, 0.0], [4.0, 0.0]]),
        np.array([[4.0, 0.0], [0.0, 0.0]]),
    ])
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((2, N_RAYS), 10.0)
    min_d = np.inf
    for _ in range(60):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
             for r in robots]
        )
        vels = np.array(
            [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        for r, vx, vy, om, found in zip(
            robots, out["vx"], out["vy"], out["omega"], out["found"]
        ):
            if found:
                r.set_control(velocity_x=vx, velocity_y=vy, omega=om)
                r.get_state(dt=0.1)
        d = np.hypot(
            robots[0].state.x - robots[1].state.x,
            robots[0].state.y - robots[1].state.y,
        )
        min_d = min(min_d, d)
    # contact when the boxes' front faces meet: half-length 0.25 each
    assert min_d > 0.45, f"box peers collided: min distance {min_d}"


def test_update_path_reroutes_one_robot_only():
    """update_path re-routes a single robot mid-mission: its new path is
    followed from the current pose, while the OTHER robots' follower
    carries (closest index, reached state) are untouched — set_paths
    would have reset the whole fleet."""
    robots, fleet = _make(3)
    paths = []
    for i, r in enumerate(robots):
        x0 = 3.0 * i
        r.state.x, r.state.y, r.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 2.5]]))
    fleet.set_paths(paths)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((3, N_RAYS), 10.0)

    def tick_once():
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
             for r in robots]
        )
        vels = np.array(
            [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        for r, vx, vy, om, found in zip(
            robots, out["vx"], out["vy"], out["omega"], out["found"]
        ):
            if found:
                r.set_control(velocity_x=vx, velocity_y=vy, omega=om)
                r.get_state(dt=0.1)
        return out

    for _ in range(10):
        tick_once()
    carry_before = jax.tree_util.tree_map(np.asarray, fleet._carry)

    # robot 1 gets a NEW mission: branch off to the right
    new_goal = (robots[1].state.x + 2.0, robots[1].state.y + 0.5)
    fleet.update_path(1, np.array([
        [robots[1].state.x, robots[1].state.y],
        [new_goal[0], new_goal[1]],
    ]))
    carry_after = jax.tree_util.tree_map(np.asarray, fleet._carry)
    for f_b, f_a in zip(carry_before, carry_after):
        np.testing.assert_array_equal(f_b[0], f_a[0])  # robot 0 untouched
        np.testing.assert_array_equal(f_b[2], f_a[2])  # robot 2 untouched
    assert carry_after[0][1] == 0  # robot 1 closest idx reset
    assert not carry_after[4][1]  # robot 1 un-reached

    out = None
    for _ in range(70):
        out = tick_once()
        if out["reached"].all():
            break
    assert out["reached"].all(), out["reached"]
    # robot 1 ended near its NEW goal, not the original one
    assert np.hypot(
        robots[1].state.x - new_goal[0], robots[1].state.y - new_goal[1]
    ) < 0.4
    assert np.hypot(robots[1].state.x - 3.0, robots[1].state.y - 2.5) > 0.6
    # errors surface loudly
    import pytest as _pytest

    with _pytest.raises(IndexError):
        fleet.update_path(7, np.array([[0.0, 0.0], [1.0, 1.0]]))


def test_update_path_on_sharded_fleet():
    """update_path works on a mesh-sharded fleet too: the row update is a
    host-triggered op outside the steady-state tick (its one-off cost may
    include cross-chip traffic; the tick program stays zero-collective)."""
    robots, fleet = _make(8, mesh=build_fleet_mesh())
    paths = []
    for i, r in enumerate(robots):
        x0 = 2.0 * i
        r.state.x, r.state.y, r.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 2.0]]))
    fleet.set_paths(paths)
    new_goal = (4.0 + 1.5, 1.0)
    fleet.update_path(2, np.array([[4.0, 0.0], [new_goal[0], new_goal[1]]]))
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((8, N_RAYS), 10.0)
    for _ in range(70):
        states = np.array(
            [[r.state.x, r.state.y, r.state.yaw, r.state.speed]
             for r in robots]
        )
        vels = np.array(
            [[r.state.vx, r.state.vy, r.state.omega] for r in robots]
        )
        out = fleet.tick(states, vels, ranges, angles)
        if out["reached"].all():
            break
        for r, vx, vy, om, found in zip(
            robots, out["vx"], out["vy"], out["omega"], out["found"]
        ):
            if found:
                r.set_control(velocity_x=vx, velocity_y=vy, omega=om)
                r.get_state(dt=0.1)
    assert out["reached"].all()
    assert np.hypot(
        robots[2].state.x - new_goal[0], robots[2].state.y - new_goal[1]
    ) < 0.4


def test_dispatch_chunk_one_matches_default():
    """Regression (round-5 review): with dispatch_chunk=1 the in-program
    block map produces [N, 1, ...] leaves whose leading dim EQUALS N, so
    a shape-sniffing un-chunk heuristic silently skipped the reshape and
    fed a malformed carry back into the next tick. _mapped_over_chunks
    now always un-chunks; chunk=1 must be exactly equivalent to the
    monolithic default."""
    outs = []
    for chunk in (64, 1, 0):
        robots, fleet = _make(3, mesh=None)
        if chunk != 64:
            robots2, fleet = _make_with_chunk(3, chunk)
        fleet.set_paths([
            np.array([[0.0, 2.0 * i], [4.0, 2.0 * i]]) for i in range(3)
        ])
        angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
        states = np.array(
            [[0.0, 2.0 * i, 0.0, 0.0] for i in range(3)], np.float32
        )
        res = []
        for t in range(3):  # multiple ticks: the carry must round-trip
            out = fleet.tick(
                states, np.zeros((3, 3), np.float32),
                np.full((3, N_RAYS), 10.0, np.float32), angles,
            )
            res.append(out)
        outs.append(res)
    for res in outs[1:]:
        for a, b in zip(outs[0], res):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def _make_with_chunk(n, chunk):
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.1, 0.4]),
        )
        for _ in range(n)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=16, dispatch_chunk=chunk,
    )
    return robots, fleet


def test_tick_before_set_paths_raises_clearly():
    """Ticking an un-set-up fleet must fail with a clear RuntimeError,
    not a trace-time TypeError after minutes of remote warmup."""
    _, fleet = _make(2)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    with pytest.raises(RuntimeError, match="set_paths"):
        fleet.tick(
            np.zeros((2, 4), np.float32), np.zeros((2, 3), np.float32),
            np.full((2, N_RAYS), 10.0, np.float32), angles,
        )
    with pytest.raises(RuntimeError, match="set_paths"):
        fleet.run_ticks_on_device(
            3, np.zeros((2, 4), np.float32), np.zeros((2, 3), np.float32),
            np.full((2, N_RAYS), 10.0, np.float32), angles,
        )


def test_set_paths_requires_one_path_per_robot():
    """round-5 review: a short path list used to leave tail robots on
    the default PAD path, driving on garbage with found=True."""
    import pytest

    _, fleet = _make(2)
    with pytest.raises(ValueError, match="2-robot"):
        fleet.set_paths([np.array([[0.0, 0.0], [1.0, 0.0]])])
