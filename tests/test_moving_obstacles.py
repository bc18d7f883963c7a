"""Moving-obstacle mode (beyond-reference): collision + obstacle cost
evaluate each obstacle at its constant-velocity predicted position
``obs + v * t * dt`` along the rollout.

The reference's rollout assumes a static world
(``trajectory_sampler.cpp:118-179``); this mode is the natural
tensor-program extension — two extra FMAs per (pose, obstacle) pair in the same fused
sweep. Contracts pinned here:

1. zero velocity == static, bit-for-bit (adding 0.0 is exact);
2. the sweep math matches a serial numpy evaluation;
3. a crossing obstacle that the static model ignores is avoided.
"""

import dataclasses

import numpy as np
import pytest

from kompass_core_tpu.control import DWA, DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.ops.solver import (
    SolverSpec,
    _min_obstacle_dist_sq_moving,
    get_packed_dwa_solver,
    make_packed_dwa_solver,
    pack_solver_input,
    packed_input_size,
)
from kompass_core_tpu.ops.window import sample_velocity_window

SPEC_STATIC = SolverSpec(
    is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=10,
    num_ctrl_points=2, scan_size=32, seg_size=64,
)
SPEC_MOVING = dataclasses.replace(SPEC_STATIC, moving_obstacles=True)


def test_moving_sweep_matches_serial_numpy():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    S, T, O = 4, 6, 5
    px = rng.uniform(-2, 2, (S, T)).astype(np.float32)
    py = rng.uniform(-2, 2, (S, T)).astype(np.float32)
    obs = rng.uniform(-3, 3, (O, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (O, 2)).astype(np.float32)
    dt = 0.1
    d2 = np.asarray(
        _min_obstacle_dist_sq_moving(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(obs),
            jnp.asarray(vel), jnp.float32(dt),
            jnp.ones(T, bool),
        )
    )
    for s in range(S):
        for t in range(T):
            ox = obs[:, 0] + vel[:, 0] * t * dt
            oy = obs[:, 1] + vel[:, 1] * t * dt
            want = np.min((px[s, t] - ox) ** 2 + (py[s, t] - oy) ** 2)
            assert d2[s, t] == pytest.approx(want, rel=1e-6)


def _packed_case(spec, obs_vel=None, drop=True):
    limits = np.zeros(9, np.float32)
    limits[0:3] = (1.0, 5.0, 10.0)
    limits[6:9] = (2.0, 3.0, 3.0)
    window = sample_velocity_window((0.5, 0.0, 0.0), limits, 0.1, 5, 1, 5,
                                    False)
    n_seg = 40
    seg_x = np.full(64, 1e8, np.float32)
    seg_x[:n_seg] = np.linspace(0, 3.9, n_seg)
    seg_y = np.full(64, 1e8, np.float32)
    seg_y[:n_seg] = 0.0
    seg_arc = np.zeros(64, np.float32)
    seg_arc[:n_seg] = np.linspace(0, 3.9, n_seg)
    obs = np.full((32, 2), 1e8, np.float32)
    obs[0] = [0.6, 0.05]  # near-path obstacle: some samples collide
    obs[1] = [1.5, -0.4]
    params = np.array(
        [0.1, 0.2, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    kw = {}
    if spec.moving_obstacles:
        kw["obs_vel_xy"] = obs_vel
    pack_solver_input(
        spec, buf, params_vec=params, state=(0.0, 0.0, 0.0), window=window,
        obs_xy=obs, obs_count=2, seg_x=seg_x, seg_y=seg_y, seg_arc=seg_arc,
        seg_count=n_seg, seg_total_len=3.9, ref_total_len=3.9,
        active_points=10, **kw,
    )
    return buf


@pytest.mark.parametrize("drop", [True, False])
def test_zero_velocity_is_static_bit_for_bit(drop):
    """obs + 0*t == obs exactly, so the moving program with zero
    velocities must reproduce the static program's packed output
    bit-for-bit — in drop mode AND in truncate mode (which re-sweeps
    the frozen points instead of using the static freeze-patch)."""
    s_spec = dataclasses.replace(SPEC_STATIC, drop_samples=drop)
    m_spec = dataclasses.replace(SPEC_MOVING, drop_samples=drop)
    out_s = np.asarray(get_packed_dwa_solver(s_spec)(_packed_case(s_spec)))
    out_m = np.asarray(
        make_packed_dwa_solver(m_spec)(_packed_case(m_spec, obs_vel=None))
    )
    np.testing.assert_array_equal(out_s, out_m)


def test_zero_velocity_box_robot_parity():
    s_spec = dataclasses.replace(SPEC_STATIC, collision_box=(0.3, 0.15))
    m_spec = dataclasses.replace(s_spec, moving_obstacles=True)
    out_s = np.asarray(make_packed_dwa_solver(s_spec)(_packed_case(s_spec)))
    out_m = np.asarray(make_packed_dwa_solver(m_spec)(_packed_case(m_spec)))
    np.testing.assert_array_equal(out_s, out_m)


# ---------------------------------------------------------------------------
# behavior: a crossing obstacle
# ---------------------------------------------------------------------------


def _make_dwa(moving: bool):
    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.2, 0.5]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        prediction_horizon=20,
        control_horizon=2,
        control_time_step=0.1,
        moving_obstacles=moving,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
            smoothness_weight=0.0,
            jerk_weight=0.0,
        ),
    )
    dwa = DWA(robot=robot, ctrl_limits=limits, config=config)
    dwa.set_path(np.array([[0.0, 0.0], [6.0, 0.0]]))
    dwa.set_current_state(0.0, 0.0, 0.0)
    return dwa


def _min_dist_to_moving_obstacle(px, py, obs, vel, dt):
    t = np.arange(len(px)) * dt
    return np.min(
        np.hypot(px - (obs[0] + vel[0] * t), py - (obs[1] + vel[1] * t))
    )


def test_crossing_obstacle_avoided_only_with_prediction():
    """An obstacle 1.2 m left of the path, crossing it at ~1 m/s: its
    CURRENT position blocks nothing, so the static model keeps driving
    at the collision course; the moving model prunes exactly those
    samples whose predicted positions intersect the obstacle track."""
    obs = np.array([1.0, 1.2], np.float32)  # current position: off-path
    vel = np.array([0.0, -1.2], np.float32)  # crossing toward the path
    dt = 0.1
    cur = (0.9, 0.0, 0.0)  # rolling at max_vel

    static = _make_dwa(moving=False)
    res_s = static.compute_velocity_commands(
        cur, map_points_world=obs[None, :]
    )
    assert res_s.is_found
    d_static = _min_dist_to_moving_obstacle(
        res_s.trajectory.path_x, res_s.trajectory.path_y, obs, vel, dt
    )
    # the static plan drives through the obstacle's future track
    assert d_static < 0.25  # robot radius 0.2 + margin

    moving = _make_dwa(moving=True)
    res_m = moving.compute_velocity_commands(
        cur, map_points_world=obs[None, :],
        obstacle_velocities_world=vel[None, :],
    )
    assert res_m.is_found
    d_moving = _min_dist_to_moving_obstacle(
        res_m.trajectory.path_x, res_m.trajectory.path_y, obs, vel, dt
    )
    # the predictive plan clears the track by at least the safety radius
    assert d_moving > 0.25
    assert d_moving > d_static


def test_nan_velocity_rows_are_dropped():
    """Trackers emit NaN velocities at track birth; such rows must be
    filtered like NaN positions — a NaN entering the moving sweep makes
    every distance NaN, defeats every collision comparison, and returns
    found=True with cost=nan."""
    dwa = _make_dwa(moving=True)
    res = dwa.compute_velocity_commands(
        (0.5, 0.0, 0.0),
        map_points_world=np.array([[0.6, 0.0], [2.0, 2.0]]),
        obstacle_velocities_world=np.array([[np.nan, 0.0], [0.0, -1.0]]),
    )
    assert res.is_found
    assert np.isfinite(res.cost)
    # the NaN-velocity obstacle at (0.6, 0) was dropped, so the fast
    # straight samples survive; the finite-velocity mover remains active
    clean = _make_dwa(moving=True)
    res_clean = clean.compute_velocity_commands(
        (0.5, 0.0, 0.0),
        map_points_world=np.array([[2.0, 2.0]]),
        obstacle_velocities_world=np.array([[0.0, -1.0]]),
    )
    np.testing.assert_array_equal(
        res.trajectory.path_x, res_clean.trajectory.path_x
    )


def test_debug_velocity_search_sees_the_moving_world():
    """Debug rankings must agree with the executed command in moving
    mode: the winning cost from compute_velocity_commands equals the
    best admissible cost debug reports for the same scene."""
    obs = np.array([[1.0, 1.2]], np.float32)
    vel = np.array([[0.0, -1.2]], np.float32)
    dwa = _make_dwa(moving=True)
    res = dwa.compute_velocity_commands(
        (0.9, 0.0, 0.0), map_points_world=obs,
        obstacle_velocities_world=vel,
    )
    _, _, costs, adm = dwa.debug_velocity_search(
        (0.9, 0.0, 0.0), map_points_world=obs,
        obstacle_velocities_world=vel,
    )
    assert res.cost == pytest.approx(float(np.min(costs[adm])), rel=1e-6)

    # without the velocities, debug must NOT match (the static ranking
    # is a different scene) — guards against silently dropping them
    _, _, costs_s, adm_s = dwa.debug_velocity_search(
        (0.9, 0.0, 0.0), map_points_world=obs
    )
    assert float(np.min(costs_s[adm_s])) != pytest.approx(
        float(np.min(costs[adm])), rel=1e-6
    )


def test_velocities_without_flag_raise():
    dwa = _make_dwa(moving=False)
    with pytest.raises(ValueError, match="moving_obstacles"):
        dwa.compute_velocity_commands(
            (0.5, 0.0, 0.0),
            map_points_world=np.array([[2.0, 2.0]]),
            obstacle_velocities_world=np.array([[0.0, -1.0]]),
        )


def test_misaligned_velocities_raise():
    dwa = _make_dwa(moving=True)
    with pytest.raises(ValueError, match="align"):
        dwa.compute_velocity_commands(
            (0.5, 0.0, 0.0),
            map_points_world=np.array([[2.0, 2.0], [3.0, 1.0]]),
            obstacle_velocities_world=np.array([[0.0, -1.0]]),
        )


def test_batched_fleet_solver_handles_moving_specs():
    """The v1 batched packed path (parallel/fleet.make_fleet_solver —
    what the multihost runtime dispatches) must accept a moving spec:
    each row solves exactly as the single packed program does."""
    from kompass_core_tpu.parallel.fleet import make_fleet_solver

    m_spec = SPEC_MOVING
    solver_one = make_packed_dwa_solver(m_spec)
    bufs = np.stack([
        _packed_case(m_spec),
        _packed_case(m_spec),
    ])
    bufs[1, 0] += 0.01  # distinct robot states
    batched = np.asarray(make_fleet_solver(m_spec)(bufs))
    for i in range(2):
        np.testing.assert_array_equal(
            batched[i], np.asarray(solver_one(bufs[i]))
        )


def test_tracked_obstacle_disc_geometry():
    pts, vels = DWA.tracked_obstacle_disc((2.0, 1.0), 0.4, (0.3, -0.5),
                                          ring=6)
    assert pts.shape == (7, 2) and vels.shape == (7, 2)
    np.testing.assert_allclose(pts[0], [2.0, 1.0])
    np.testing.assert_allclose(
        np.hypot(pts[1:, 0] - 2.0, pts[1:, 1] - 1.0), 0.4, rtol=1e-6
    )
    assert (vels == np.float32([0.3, -0.5])).all()

    # composes with the moving solver end-to-end
    dwa = _make_dwa(moving=True)
    res = dwa.compute_velocity_commands(
        (0.5, 0.0, 0.0), map_points_world=pts,
        obstacle_velocities_world=vels,
    )
    assert res.is_found


def test_moving_flag_with_static_world_matches_static_dwa():
    """End-to-end: a moving-enabled controller given no velocities must
    agree exactly with the static controller on the same scene."""
    obs = np.array([[2.0, 0.3], [1.0, -0.5]], np.float32)
    cur = (0.4, 0.0, 0.1)
    r_s = _make_dwa(moving=False).compute_velocity_commands(
        cur, map_points_world=obs
    )
    r_m = _make_dwa(moving=True).compute_velocity_commands(
        cur, map_points_world=obs
    )
    assert r_s.is_found == r_m.is_found
    np.testing.assert_array_equal(
        r_s.trajectory.path_x, r_m.trajectory.path_x
    )
    np.testing.assert_array_equal(
        r_s.trajectory.omega, r_m.trajectory.omega
    )


def test_pack_rejects_velocities_on_static_spec():
    """Silently dropping obs_vel_xy would plan through a crossing
    obstacle's predicted path — build-time guard (round-5 review)."""
    import numpy as np

    from kompass_core_tpu.ops.solver import pack_solver_input

    spec = SPEC_STATIC
    limits = np.zeros(9, np.float32)
    limits[0:3] = (1.0, 5.0, 10.0)
    limits[6:9] = (2.0, 3.0, 3.0)
    window = sample_velocity_window(
        (0.5, 0.0, 0.0), limits, 0.1, 5, 1, 5, False
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    with pytest.raises(ValueError, match="moving_obstacles=False"):
        pack_solver_input(
            spec, buf,
            params_vec=np.zeros(12, np.float32),
            state=(0, 0, 0),
            window=window,
            obs_xy=np.full((spec.scan_size, 2), 1e8, np.float32),
            obs_count=0,
            seg_x=np.full(spec.seg_size, 1e8, np.float32),
            seg_y=np.full(spec.seg_size, 1e8, np.float32),
            seg_arc=np.zeros(spec.seg_size, np.float32),
            seg_count=1,
            seg_total_len=1.0,
            ref_total_len=1.0,
            active_points=spec.max_points,
            obs_vel_xy=np.zeros((spec.scan_size, 2), np.float32),
        )


def test_peer_predict_requires_moving_sweep_build_guard():
    """Direct composers: peer_cfg['predict'] without the moving sweep
    would silently sweep peers at frozen positions — same guard class
    as _check_tracked_spec (round-5 review)."""
    from kompass_core_tpu.ops.fleet_solver import (
        FleetSpec,
        make_fleet_tick,
        make_fleet_ticks_on_device,
    )
    from kompass_core_tpu.ops.solver import SolverSpec

    spec = FleetSpec(
        solver=SolverSpec(
            is_omni=False, n_vx=3, n_vy=1, n_omega=3, max_points=8,
            num_ctrl_points=2, scan_size=64, seg_size=64,
            device_window=True, moving_obstacles=False,
        ),
        path_capacity=128, max_segments=4,
    )
    peer = {"radii": np.full(2, 0.2, np.float32), "n_real": 2,
            "ring": 4, "predict": True}
    with pytest.raises(ValueError, match="predict"):
        make_fleet_tick(spec, peer_cfg=peer)
    with pytest.raises(ValueError, match="predict"):
        make_fleet_ticks_on_device(spec, 3, peer_cfg=peer)


def test_scan_ray_overflow_raises_instead_of_truncating():
    """More beams than the scan bucket would silently blind the robot
    to part of its scan — trace-time guard (round-5 review)."""
    import jax.numpy as jnp

    from kompass_core_tpu.ops.fleet_solver import _scan_to_world_obs
    from kompass_core_tpu.ops.solver import SolverSpec

    spec = SolverSpec(
        is_omni=False, n_vx=3, n_vy=1, n_omega=3, max_points=8,
        num_ctrl_points=2, scan_size=64, seg_size=64,
    )
    with pytest.raises(ValueError, match="scan rays"):
        _scan_to_world_obs(
            spec, jnp.full(100, 5.0), jnp.zeros(100),
            jnp.zeros(3), 0.0, 0.0, 0.0,
        )
