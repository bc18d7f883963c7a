"""run_ticks_on_device: K carry-chained control ticks per dispatch.

The round-trip-amortizing serving API. Semantics under test:
tick 0 of the K-loop is the same program as a single tick; the state
integrates on device through the solver's own kinematics; the follower
carry persists across calls; goals are reached closed-loop entirely on
device.
"""

import numpy as np

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

N_RAYS = 72


def _fleet(n_robots=2):
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
        max_segments=16,
    )
    fleet.set_paths(
        [np.array([[1.0 * i, 0.0], [1.0 * i, 2.5]]) for i in range(n_robots)]
    )
    return fleet


def _inputs(n_robots):
    states = np.array(
        [[1.0 * i, 0.0, np.pi / 2, 0.0] for i in range(n_robots)]
    )
    vels = np.zeros((n_robots, 3))
    ranges = np.full((n_robots, N_RAYS), 10.0)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    return states, vels, ranges, angles


def test_first_tick_matches_single_tick():
    n = 2
    fleet_k = _fleet(n)
    fleet_1 = _fleet(n)
    states, vels, ranges, angles = _inputs(n)
    out_k = fleet_k.run_ticks_on_device(4, states, vels, ranges, angles)
    out_1 = fleet_1.tick(states, vels, ranges, angles)
    for f in ("found", "reached", "vx", "vy", "omega", "cost"):
        np.testing.assert_allclose(
            out_k[f][:, 0].astype(np.float64),
            out_1[f].astype(np.float64),
            rtol=1e-5, atol=1e-6,
            err_msg=f"tick 0 of the K-loop diverges from tick() on {f}",
        )


def test_k_ticks_reach_goal_on_device():
    fleet = _fleet(1)
    states, vels, ranges, angles = _inputs(1)
    out = fleet.run_ticks_on_device(60, states, vels, ranges, angles)
    assert out["reached"].shape == (1, 60)
    assert out["reached"][0, -1], "robot did not reach goal within 60 ticks"
    # final on-device state is at the path end (1.0*0, 2.5 target)
    fx, fy = out["final_states"][0, :2]
    assert abs(fx - 0.0) < 0.3 and abs(fy - 2.5) < 0.3, (fx, fy)
    # once reached, commands zero out
    assert abs(out["vx"][0, -1]) < 1e-6
    # carry persisted: a follow-up call starts already-reached
    out2 = fleet.run_ticks_on_device(
        4, out["final_states"], vels, ranges, angles
    )
    assert out2["reached"].all()


def test_per_tick_axis_evolves():
    """Commands differ across the k axis (the state actually integrates:
    identical commands every tick would mean a frozen carry)."""
    fleet = _fleet(1)
    states, vels, ranges, angles = _inputs(1)
    out = fleet.run_ticks_on_device(20, states, vels, ranges, angles)
    # the robot starts at rest: the accel-limited window makes early
    # ticks ramp vx up and the goal approach ramps it down — a frozen
    # carry would repeat the same command every tick
    vx = out["vx"][0]
    assert np.std(vx) > 1e-3, vx


def test_boxed_in_robot_holds_instead_of_marching():
    """round-5 review: when no sample is admissible (found=False), the
    emitted command must be ZERO — the k-tick loop integrates cmd
    directly, so a boxed-in robot would otherwise march on the
    inadmissible argmin sample (max-reverse, max-spin) and broadcast
    that garbage to peers."""
    fleet = _fleet(1)
    states, vels, ranges, angles = _inputs(1)
    # wall of obstacles 0.15 m away in EVERY direction: every rollout's
    # first step collides, drop mode drops all samples
    ranges = np.full((1, N_RAYS), 0.15)
    out = fleet.run_ticks_on_device(5, states, vels, ranges, angles)
    assert not out["found"].any(), "no sample should be admissible"
    np.testing.assert_array_equal(out["vx"], np.zeros((1, 5)))
    np.testing.assert_array_equal(out["omega"], np.zeros((1, 5)))
    # the on-device state must HOLD at the initial pose
    np.testing.assert_allclose(
        out["final_states"][0, :3], states[0, :3], atol=1e-6
    )
    # single-tick path agrees
    out1 = fleet.tick(states, vels, ranges, angles)
    assert not out1["found"].any()
    assert abs(float(out1["vx"][0])) < 1e-9
    assert abs(float(out1["omega"][0])) < 1e-9
