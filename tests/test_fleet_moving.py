"""Fleet-level tracked moving obstacles (`DeviceFleet(tracked_obstacles=M)`).

Contracts: empty tracked input reproduces the plain fleet exactly; a
static tracked object blocks like a wall; a crossing mover is avoided
only when its velocity is given; the k-tick serving loop advects movers
between ticks (the scan world stays frozen, the movers do not).
"""

import numpy as np
import pytest

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

N_RAYS = 64


def _make(n_robots=1, tracked=0, horizon=20):
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.2, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=8,
        max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
            smoothness_weight=0.0,
            jerk_weight=0.0,
        ),
        prediction_horizon=horizon,
        control_horizon=2,
        control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=1024,
        max_segments=16, tracked_obstacles=tracked,
    )
    fleet.set_paths(
        [np.array([[0.0, 2.0 * i], [6.0, 2.0 * i]]) for i in range(n_robots)]
    )
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False))
    return fleet


def _free_inputs(n=1, x=0.0, vx=0.5):
    states = np.zeros((n, 4), np.float32)
    states[:, 0] = x
    states[:, 1] = 2.0 * np.arange(n)
    vels = np.zeros((n, 3), np.float32)
    vels[:, 0] = vx
    ranges = np.full((n, N_RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    return states, vels, ranges, angles


def test_empty_tracked_matches_plain_fleet_exactly():
    """M pad slots (sentinel position, zero velocity) must not change a
    single output value vs a fleet built without the feature."""
    base = _make(n_robots=2, tracked=0)
    trk = _make(n_robots=2, tracked=3)
    s, v, r, a = _free_inputs(2)
    out_base = base.tick(s, v, r, a)
    out_trk = trk.tick(s, v, r, a, tracked=None)
    for key in out_base:
        np.testing.assert_array_equal(out_base[key], out_trk[key])


def test_static_tracked_object_blocks_like_a_wall():
    fleet = _make(tracked=2)
    s, v, r, a = _free_inputs()
    # fully free: drives forward
    free = fleet.tick(s, v, r, a)
    assert free["found"][0] and free["vx"][0] > 0.1
    # a zero-velocity tracked object dead ahead: the admissible fast
    # stra'ight samples vanish
    blocked = fleet.tick(
        s, v, r, a, tracked=[np.array([[0.6, 0.0, 0.0, 0.0]])]
    )
    assert blocked["num_admissible"][0] < free["num_admissible"][0]


def _closed_loop_clearance(fleet, mover_xy, mover_v, ticks=80):
    """Drive the single-robot fleet closed-loop; return (reached, min
    distance robot<->mover over the run)."""
    x = y = yaw = 0.0
    vx = 0.5
    m = np.array(mover_xy, np.float64)
    dt = 0.1
    min_d = np.inf
    for _ in range(ticks):
        s = np.array([[x, y, yaw, vx]], np.float32)
        v = np.array([[vx, 0.0, 0.0]], np.float32)
        _, _, r, a = _free_inputs()
        out = fleet.tick(
            s, v, r, a,
            tracked=[np.array([[m[0], m[1], mover_v[0], mover_v[1]]],
                              np.float32)],
        )
        if out["reached"][0]:
            return True, min_d
        if out["found"][0]:
            vx = float(out["vx"][0])
            om = float(out["omega"][0])
            yaw += om * dt
            x += vx * np.cos(yaw) * dt
            y += vx * np.sin(yaw) * dt
        m = m + np.asarray(mover_v, np.float64) * dt
        min_d = min(min_d, float(np.hypot(x - m[0], y - m[1])))
    return False, min_d


def test_fleet_crossing_mover_avoided_with_velocity():
    """A mover crossing the aisle: with its velocity in the tracked
    input the robot keeps clearance; with the velocity zeroed (static
    model of a moving world) it runs much closer."""
    fleet = _make(tracked=1)
    reached, d_pred = _closed_loop_clearance(
        fleet, mover_xy=(3.0, 1.5), mover_v=(0.0, -0.45), ticks=200
    )
    assert reached
    # the mover is a single point obstacle; the solver holds the rollout
    # outside robot_radius + margin (0.27) at its check times, so the
    # closed-loop floor sits just under it
    assert d_pred > 0.25, f"predictive fleet came within {d_pred:.3f} m"

    # the same geometry driven with the mover treated as static: the
    # robot plans through the spot the mover will actually occupy
    # (we re-simulate the true mover motion outside the solver). Fresh
    # fleet: the follower carry latched `reached` on the run above.
    fleet = _make(tracked=1)
    x = y = yaw = 0.0
    vx = 0.5
    m = np.array([3.0, 1.5])
    dt = 0.1
    min_d = np.inf
    for _ in range(80):
        s = np.array([[x, y, yaw, vx]], np.float32)
        v = np.array([[vx, 0.0, 0.0]], np.float32)
        _, _, r, a = _free_inputs()
        out = fleet.tick(
            s, v, r, a,
            tracked=[np.array([[m[0], m[1], 0.0, 0.0]], np.float32)],
        )
        if out["reached"][0]:
            break
        if out["found"][0]:
            vx = float(out["vx"][0])
            om = float(out["omega"][0])
            yaw += om * dt
            x += vx * np.cos(yaw) * dt
            y += vx * np.sin(yaw) * dt
        m = m + np.array([0.0, -0.45]) * dt  # the world still moves
        min_d = min(min_d, float(np.hypot(x - m[0], y - m[1])))
    assert d_pred > min_d, (
        f"prediction must beat the static model: {d_pred:.3f} vs "
        f"{min_d:.3f}"
    )


def test_k_tick_loop_advects_movers():
    """run_ticks_on_device: the mover crosses DURING the k-span; the
    executed open-loop commands must keep clearance from the true mover
    track, which only works if the program advects it between ticks."""
    fleet = _make(tracked=1)
    k = 30
    mover0 = np.array([2.2, 1.2])
    mover_v = np.array([0.0, -0.6])
    dt = 0.1

    def run(vel_seen):
        s, v, r, a = _free_inputs(vx=0.8)
        out = fleet.run_ticks_on_device(
            k, s, v, r, a,
            tracked=[np.array(
                [[mover0[0], mover0[1], vel_seen[0], vel_seen[1]]],
                np.float32,
            )],
        )
        # integrate the executed commands open-loop against the TRUE track
        x = y = yaw = 0.0
        min_d = np.inf
        for i in range(k):
            vx = float(out["vx"][0, i])
            om = float(out["omega"][0, i])
            # device integration order: position from the PRE-update yaw
            # (ops/fleet_solver body()), then the heading update
            x += vx * np.cos(yaw) * dt
            y += vx * np.sin(yaw) * dt
            yaw += om * dt
            m = mover0 + mover_v * (i + 1) * dt
            min_d = min(min_d, float(np.hypot(x - m[0], y - m[1])))
        return min_d, (x, y), out

    d_pred, xy_pred, out_pred = run(mover_v)
    d_frozen, _, _ = run((0.0, 0.0))
    # predictive k-span must not collide (robot radius 0.2 + margin)
    assert d_pred > 0.26, f"k-tick span came within {d_pred:.3f} m"
    # and must beat the frozen-mover program on the same true track
    assert d_pred > d_frozen, (
        f"advection must improve clearance: {d_pred:.3f} vs {d_frozen:.3f}"
    )
    np.testing.assert_allclose(
        out_pred["final_states"][0, 0:2], xy_pred, atol=1e-4
    )


def test_tracked_input_validation():
    plain = _make(tracked=0)
    s, v, r, a = _free_inputs()
    with pytest.raises(ValueError, match="tracked_obstacles=0"):
        plain.tick(s, v, r, a, tracked=[np.zeros((1, 4), np.float32)])
    fleet = _make(tracked=1)
    with pytest.raises(ValueError, match="capacity"):
        fleet.tick(s, v, r, a, tracked=[np.zeros((2, 4), np.float32)])
    with pytest.raises(ValueError, match=r"\[m, 4\]"):
        fleet.tick(s, v, r, a, tracked=[np.zeros((1, 3), np.float32)])


def _make_peer_fleet(predict, n_robots=2, mesh=None):
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.2, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.5, max_acc=10.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=8, max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
            smoothness_weight=0.0, jerk_weight=0.0,
        ),
        prediction_horizon=20, control_horizon=2, control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=1024,
        max_segments=16, peer_avoidance=True, peer_prediction=predict,
        mesh=mesh,
    )
    # robot 0 drives +x along y=0; robot 1 drives -y, crossing 0's path
    fleet.set_paths([
        np.array([[0.0, 0.0], [6.0, 0.0]]),
        np.array([[2.5, 2.0], [2.5, -4.0]]),
    ][:n_robots])
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, N_RAYS,
                                      endpoint=False))
    return fleet


def test_peer_prediction_prunes_a_crossing_peer():
    """Robot 1 is 2 m off robot 0's path but closing at 1.4 m/s: the
    live-position model sees nothing to prune; the predictive model
    prunes the fast-straight samples that meet robot 1's track."""
    states = np.array(
        [[0.0, 0.0, 0.0, 0.9], [2.5, 2.0, -np.pi / 2, 1.4]], np.float32
    )
    vels = np.array([[0.9, 0.0, 0.0], [1.4, 0.0, 0.0]], np.float32)
    ranges = np.full((2, N_RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)

    out_live = _make_peer_fleet(False).tick(states, vels, ranges, angles)
    out_pred = _make_peer_fleet(True).tick(states, vels, ranges, angles)
    assert out_pred["found"][0] and out_live["found"][0]
    assert (
        out_pred["num_admissible"][0] < out_live["num_admissible"][0]
    ), "prediction must prune the samples crossing the peer's track"


def test_peer_prediction_zero_velocity_matches_live_model():
    """Stationary peers: the predicted track equals the live position,
    so both programs must agree exactly."""
    states = np.array(
        [[0.0, 0.0, 0.0, 0.0], [2.5, 2.0, -np.pi / 2, 0.0]], np.float32
    )
    vels = np.zeros((2, 3), np.float32)
    ranges = np.full((2, N_RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    out_live = _make_peer_fleet(False).tick(states, vels, ranges, angles)
    out_pred = _make_peer_fleet(True).tick(states, vels, ranges, angles)
    for key in out_live:
        np.testing.assert_array_equal(out_live[key], out_pred[key])


def test_peer_prediction_requires_avoidance():
    robots = [Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.2, 0.4]),
    )]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )
    with pytest.raises(ValueError, match="peer_avoidance"):
        DeviceFleet(
            robots, limits, DWAConfig(), scan_rays=N_RAYS,
            peer_prediction=True,
        )


def test_peer_prediction_k_ticks_keep_crossing_robots_apart():
    """The fleet-synchronous k-scan with prediction: two crossing robots
    solve k=25 ticks in ONE dispatch; their integrated tracks must keep
    a safe separation."""
    fleet = _make_peer_fleet(True)
    states = np.array(
        [[0.0, 0.0, 0.0, 0.9], [2.5, 2.0, -np.pi / 2, 1.2]], np.float32
    )
    vels = np.array([[0.9, 0.0, 0.0], [1.2, 0.0, 0.0]], np.float32)
    ranges = np.full((2, N_RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    out = fleet.run_ticks_on_device(25, states, vels, ranges, angles)
    fin = out["final_states"]
    # integrate both robots' executed commands and track separation
    xy = states[:, 0:2].astype(np.float64)
    yaw = states[:, 2].astype(np.float64).copy()
    dt = 0.1
    min_sep = np.inf
    for i in range(25):
        for r in range(2):
            vx = float(out["vx"][r, i])
            om = float(out["omega"][r, i])
            # device integration order: position from the PRE-update yaw
            xy[r, 0] += vx * np.cos(yaw[r]) * dt
            xy[r, 1] += vx * np.sin(yaw[r]) * dt
            yaw[r] += om * dt
        min_sep = min(min_sep, float(np.hypot(*(xy[0] - xy[1]))))
    np.testing.assert_allclose(fin[:, 0:2], xy, atol=1e-3)
    assert min_sep > 2 * 0.2, f"robots came within {min_sep:.3f} m"


def test_peer_prediction_k_ticks_mesh_keeps_crossing_robots_apart():
    """Mesh form of the crossing test: the two crossing
    robots land on DIFFERENT shards of the 8-device mesh (rows 0 and 1,
    one robot per device after padding), the k-tick program all-gathers
    the live peer state once per tick, and the integrated tracks must
    keep the same safe separation — with every command bit-identical to
    the single-device program."""
    import jax
    from kompass_core_tpu.parallel import build_fleet_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    states = np.array(
        [[0.0, 0.0, 0.0, 0.9], [2.5, 2.0, -np.pi / 2, 1.2]], np.float32
    )
    vels = np.array([[0.9, 0.0, 0.0], [1.2, 0.0, 0.0]], np.float32)
    ranges = np.full((2, N_RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)

    mesh_fleet = _make_peer_fleet(True, mesh=build_fleet_mesh())
    assert mesh_fleet._n == 8, "2 robots must pad to one row per device"
    out = mesh_fleet.run_ticks_on_device(25, states, vels, ranges, angles)
    out_single = _make_peer_fleet(True).run_ticks_on_device(
        25, states, vels, ranges, angles
    )
    for key in out_single:
        np.testing.assert_array_equal(out[key], out_single[key])

    xy = states[:, 0:2].astype(np.float64)
    yaw = states[:, 2].astype(np.float64).copy()
    dt = 0.1
    min_sep = np.inf
    for i in range(25):
        for r in range(2):
            vx = float(out["vx"][r, i])
            om = float(out["omega"][r, i])
            xy[r, 0] += vx * np.cos(yaw[r]) * dt
            xy[r, 1] += vx * np.sin(yaw[r]) * dt
            yaw[r] += om * dt
        min_sep = min(min_sep, float(np.hypot(*(xy[0] - xy[1]))))
    assert min_sep > 2 * 0.2, f"robots came within {min_sep:.3f} m"


def test_peer_avoidance_single_tick_mesh_matches_single_device():
    """The mesh single-tick peer program (one all-gather, then the
    row-local pipeline) must agree bit-for-bit with the single-device
    peer program on the same crossing scenario."""
    import jax
    from kompass_core_tpu.parallel import build_fleet_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    states = np.array(
        [[0.0, 0.0, 0.0, 0.9], [2.5, 2.0, -np.pi / 2, 1.4]], np.float32
    )
    vels = np.array([[0.9, 0.0, 0.0], [1.4, 0.0, 0.0]], np.float32)
    ranges = np.full((2, N_RAYS), 10.0, np.float32)
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    out_mesh = _make_peer_fleet(True, mesh=build_fleet_mesh()).tick(
        states, vels, ranges, angles
    )
    out_single = _make_peer_fleet(True).tick(states, vels, ranges, angles)
    for key in out_single:
        np.testing.assert_array_equal(out_mesh[key], out_single[key])


def test_nan_tracked_rows_are_empty_slots():
    """Rows with any non-finite value are the documented way to pad a
    fixed-shape tracked array — they must behave exactly like absent
    objects, not poison the sweep or plant phantom obstacles."""
    fleet = _make(tracked=2)
    s, v, r, a = _free_inputs()
    free = fleet.tick(s, v, r, a)
    nan_row = np.full((1, 2, 4), np.nan, np.float32)
    padded = fleet.tick(s, v, r, a, tracked=nan_row)
    for key in free:
        np.testing.assert_array_equal(free[key], padded[key])


def test_snapshot_rejects_different_num_robots():
    fleet = _make(tracked=0)
    s, v, r, a = _free_inputs()
    fleet.tick(s, v, r, a)
    sd = fleet.state_dict()
    sd["num_robots"] = np.int32(2)  # same padded n, different real count
    fleet2 = _make(tracked=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        fleet2.load_state_dict(sd)


def test_2d_tracked_array_rejected_as_ambiguous():
    """[M', 4] could mean 'M' movers, one robot' or 'one mover per
    robot' — must raise instead of silently picking a reading."""
    fleet = _make(tracked=2)
    s, v, r, a = _free_inputs()
    with pytest.raises(ValueError, match="ambiguous"):
        fleet.tick(
            s, v, r, a,
            tracked=np.array([[3, 1, 0, -0.5], [4, 2, 0, -0.5]],
                             np.float32),
        )


def test_fleet_spec_guard_tracked_requires_moving():
    """Direct composers: tracked slots without the moving sweep would
    silently drop the velocities — build-time guard."""
    import dataclasses

    from kompass_core_tpu.ops.fleet_solver import make_fleet_tick

    fleet = _make(tracked=1)
    bad = dataclasses.replace(
        fleet.spec,
        solver=dataclasses.replace(
            fleet.spec.solver, moving_obstacles=False
        ),
    )
    with pytest.raises(ValueError, match="moving_obstacles"):
        make_fleet_tick(bad)


def test_stale_tracked_rows_cleared_between_ticks():
    """A tick without `tracked` must not reuse the previous tick's
    objects."""
    fleet = _make(tracked=1)
    s, v, r, a = _free_inputs()
    free = fleet.tick(s, v, r, a)
    blocked = fleet.tick(
        s, v, r, a, tracked=[np.array([[0.6, 0.0, 0.0, 0.0]])]
    )
    assert blocked["num_admissible"][0] < free["num_admissible"][0]
    again = fleet.tick(s, v, r, a)  # no tracked arg: slots must clear
    np.testing.assert_array_equal(
        again["num_admissible"], free["num_admissible"]
    )


def test_tracked_fleet_runs_on_a_mesh():
    """Tracked movers shard with the robot axis: an 8-device mesh fleet
    with per-robot movers must run and prune like the single-device
    fleet (zero-collective property pinned in test_scaling_hlo.py)."""
    import jax
    from kompass_core_tpu.parallel import build_fleet_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    mesh = build_fleet_mesh()

    def make(mesh_):
        robots = [
            Robot(
                robot_type=RobotType.DIFFERENTIAL_DRIVE,
                geometry_type=RobotGeometry.Type.CYLINDER,
                geometry_params=np.array([0.2, 0.4]),
            )
            for _ in range(8)
        ]
        limits = RobotCtrlLimits(
            vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0,
                                       max_decel=10.0),
            omega_limits=AngularCtrlLimits(
                max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
            ),
        )
        config = DWAConfig(
            max_linear_samples=4, max_angular_samples=4,
            costs_weights=TrajectoryCostsWeights(
                reference_path_distance_weight=2.0,
                goal_distance_weight=1.0,
                obstacles_distance_weight=0.5,
            ),
            prediction_horizon=10, control_horizon=2,
            control_time_step=0.1,
        )
        fleet = DeviceFleet(
            robots, limits, config, scan_rays=N_RAYS, path_capacity=1024,
            max_segments=16, tracked_obstacles=1, mesh=mesh_,
        )
        fleet.set_paths(
            [np.array([[0.0, 2.0 * i], [6.0, 2.0 * i]]) for i in range(8)]
        )
        fleet.set_scan_angles(
            np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
        )
        return fleet

    s, v, r, a = _free_inputs(8)
    # robot 0 gets a mover dead ahead; the rest none
    tracked = [np.array([[0.6, 0.0, 0.0, 0.0]], np.float32)] + [
        np.zeros((0, 4), np.float32)
    ] * 7
    out_mesh = make(mesh).tick(s, v, r, a, tracked=tracked)
    out_single = make(None).tick(s, v, r, a, tracked=tracked)
    for key in out_single:
        np.testing.assert_array_equal(out_mesh[key], out_single[key])
    assert out_mesh["num_admissible"][0] < out_mesh["num_admissible"][1]


def _make_split(split, n_robots=1, tracked=2, horizon=20):
    """Same fleet, movers routed tail-slot (split=False) or through the
    narrow split sweep (split=True)."""
    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.2, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
        ),
    )
    config = DWAConfig(
        max_linear_samples=8, max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
            smoothness_weight=0.0, jerk_weight=0.0,
        ),
        prediction_horizon=horizon, control_horizon=2,
        control_time_step=0.1,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=1024,
        max_segments=16, tracked_obstacles=tracked,
        split_mover_sweep=split,
    )
    fleet.set_paths([
        np.array([[0.0, 2.0 * i], [6.0, 2.0 * i]])
        for i in range(n_robots)
    ])
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, N_RAYS,
                                      endpoint=False))
    return fleet


def test_split_mover_sweep_bit_identical_to_tail_slot():
    """The split narrow sweep is a pure program-shape change: min over
    the same point union, zero-velocity rows bit-equal static — so both
    forms must produce BIT-IDENTICAL commands on identical inputs,
    including crossing movers, empty slots, and NaN pads. (This is the
    claim that lets a benchmark keep whichever form is faster.)"""
    s, v, r, a = _free_inputs()
    tracked_cases = [
        None,
        [np.array([[1.2, 0.0, 0.0, 0.0]], np.float32)],  # static wall
        [np.array([[3.0, 2.0, 0.0, -0.8],
                   [1.5, -1.0, 0.3, 0.4]], np.float32)],  # crossing
        np.array([[[2.0, 1.0, -0.5, 0.0],
                   [np.nan, np.nan, np.nan, np.nan]]], np.float32),
    ]
    tail = _make_split(False)
    split = _make_split(True)
    for trk in tracked_cases:
        out_t = tail.tick(s, v, r, a, tracked=trk)
        out_s = split.tick(s, v, r, a, tracked=trk)
        for key in out_t:
            np.testing.assert_array_equal(
                out_t[key], out_s[key],
                err_msg=f"split != tail-slot for case {trk!r}, {key}",
            )


def test_split_mover_sweep_k_ticks_bit_identical():
    """The k-tick serving loop advects split movers exactly like
    tail-slot movers (base position + v*i*dt per tick): k=12 one-dispatch
    runs must match bit-for-bit."""
    s, v, r, a = _free_inputs()
    trk = [np.array([[3.0, 2.0, 0.0, -0.8]], np.float32)]
    out_t = _make_split(False, tracked=1).run_ticks_on_device(
        12, s, v, r, a, tracked=trk
    )
    out_s = _make_split(True, tracked=1).run_ticks_on_device(
        12, s, v, r, a, tracked=trk
    )
    for key in out_t:
        np.testing.assert_array_equal(out_t[key], out_s[key])


def test_split_mover_scan_bucket_stays_at_rays():
    """The whole point of the split form: the scan bucket must NOT grow
    by the mover slots."""
    tail = _make_split(False, tracked=8)
    split = _make_split(True, tracked=8)
    assert tail.spec.solver.scan_size == 256  # 64 rays + 8 -> round 256
    assert split.spec.solver.scan_size == 256
    # at a pow2-full bucket the difference appears
    assert tail.spec.solver.moving_obstacles
    assert not split.spec.solver.moving_obstacles  # velocities ride mover4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tail_parity_random_configs(seed):
    """Randomized config sweep: the split/tail bit-parity must hold
    across sampling grids, horizons, ray counts, slot counts, fleet
    sizes, and drop vs truncate — not just the hand-picked shapes the
    targeted tests use."""
    rng = np.random.default_rng(seed)
    n_robots = int(rng.integers(1, 4))
    tracked = int(rng.integers(1, 4))
    rays = int(rng.choice([32, 64, 96]))
    horizon = int(rng.integers(8, 25))
    n_lin = int(rng.integers(3, 9))
    n_ang = int(rng.integers(3, 9))
    drop = bool(rng.integers(0, 2))

    def build(split):
        robots = [
            Robot(
                robot_type=RobotType.DIFFERENTIAL_DRIVE,
                geometry_type=RobotGeometry.Type.CYLINDER,
                geometry_params=np.array([0.2, 0.4]),
            )
            for _ in range(n_robots)
        ]
        limits = RobotCtrlLimits(
            vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=10.0,
                                       max_decel=10.0),
            omega_limits=AngularCtrlLimits(
                max_vel=2.0, max_acc=6.0, max_decel=6.0, max_steer=np.pi
            ),
        )
        config = DWAConfig(
            max_linear_samples=n_lin, max_angular_samples=n_ang,
            costs_weights=TrajectoryCostsWeights(
                reference_path_distance_weight=2.0,
                goal_distance_weight=1.0,
                obstacles_distance_weight=0.5,
            ),
            prediction_horizon=horizon, control_horizon=2,
            control_time_step=0.1, drop_samples=drop,
        )
        fleet = DeviceFleet(
            robots, limits, config, scan_rays=rays, path_capacity=1024,
            max_segments=16, tracked_obstacles=tracked,
            split_mover_sweep=split,
        )
        fleet.set_paths([
            np.array([[0.0, 2.0 * i], [6.0, 2.0 * i]])
            for i in range(n_robots)
        ])
        fleet.set_scan_angles(
            np.linspace(0, 2 * np.pi, rays, endpoint=False)
        )
        return fleet

    states = np.zeros((n_robots, 4), np.float32)
    states[:, 1] = 2.0 * np.arange(n_robots)
    vels = np.zeros((n_robots, 3), np.float32)
    vels[:, 0] = 0.5
    ranges = rng.uniform(1.5, 10.0, (n_robots, rays)).astype(np.float32)
    angles = np.linspace(0, 2 * np.pi, rays, endpoint=False)
    # random movers, some rows NaN-padded empty
    trk = rng.uniform(-1.0, 5.0, (n_robots, tracked, 4)).astype(np.float32)
    trk[:, :, 2:4] = rng.uniform(-0.8, 0.8, (n_robots, tracked, 2))
    for i in range(n_robots):
        if rng.integers(0, 2):
            trk[i, rng.integers(0, tracked)] = np.nan

    out_t = build(False).tick(states, vels, ranges, angles, tracked=trk)
    out_s = build(True).tick(states, vels, ranges, angles, tracked=trk)
    for key in out_t:
        np.testing.assert_array_equal(
            out_t[key], out_s[key],
            err_msg=(
                f"split != tail at seed={seed} cfg=(n={n_robots}, "
                f"M={tracked}, rays={rays}, T={horizon}, "
                f"{n_lin}x{n_ang}, drop={drop}) field={key}"
            ),
        )
