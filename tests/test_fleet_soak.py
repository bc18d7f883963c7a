"""Integration soak: every fleet feature composed over a long horizon.

Each fleet feature is proven in isolation on short scenarios elsewhere;
this test proves they COMPOSE. One 64-robot heterogeneous
fleet (mixed kinematics, limits, and a box-shaped robot) on the 8-device
virtual mesh with safety + tracked movers + peer avoidance + peer
prediction, driven 500 ticks through the k-tick serving API
(`run_ticks_on_device`, 20 dispatches of k=25), asserting:

  * zero robot-robot collisions (every pair keeps d > 2r every tick,
    including the 32 deliberately-crossing pairs),
  * zero robot-mover collisions against the true mover tracks,
  * every robot reaches its goal,
  * a mid-mission ``state_dict()`` snapshot restored into a FRESH fleet
    replays the final 100 ticks bit-identically.

Scale bar from the reference's e2e test (``dwa_test.cpp:113-155``:
one robot, <=150 steps) — scaled to fleet size and feature product.
"""

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
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet, FleetSafetyConfig

N_LANES = 32
N_ROBOTS = 2 * N_LANES
N_RAYS = 64
R_ROBOT = 0.2
DT = 0.1
K = 25
DISPATCHES = 20  # 500 ticks total
LANE_DY = 4.0


def _build_fleet(mesh):
    robots = []
    limits = []
    for i in range(N_ROBOTS):
        if i % 16 == 5:
            # a box-shaped robot: flips the whole fleet onto the exact
            # oriented-box collision path (heterogeneous shapes)
            robots.append(Robot(
                robot_type=RobotType.DIFFERENTIAL_DRIVE,
                geometry_type=RobotGeometry.Type.BOX,
                geometry_params=np.array([2 * R_ROBOT, 2 * R_ROBOT, 0.4]),
            ))
        else:
            robots.append(Robot(
                robot_type=(
                    RobotType.OMNI if i % 8 == 3
                    else RobotType.DIFFERENTIAL_DRIVE
                ),
                geometry_type=RobotGeometry.Type.CYLINDER,
                geometry_params=np.array([R_ROBOT, 0.4]),
            ))
        vmax = 0.8 + 0.2 * ((i // 2) % 2)  # per-robot limits
        limits.append(RobotCtrlLimits(
            vx_limits=LinearCtrlLimits(max_vel=vmax, max_acc=10.0,
                                       max_decel=10.0),
            vy_limits=LinearCtrlLimits(max_vel=0.4, max_acc=10.0,
                                       max_decel=10.0),
            omega_limits=AngularCtrlLimits(
                max_vel=2.5, max_acc=8.0, max_decel=8.0, max_steer=np.pi
            ),
        ))
    config = DWAConfig(
        max_linear_samples=8, max_angular_samples=8,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=0.5,
            smoothness_weight=0.0, jerk_weight=0.0,
        ),
        prediction_horizon=15, control_horizon=2, control_time_step=DT,
        goal_dist_tolerance=0.3,
        # collision margin = octree_resolution * 0.7 = 0.14: the
        # discrete rollout checks poses every DT, so two crossing robots
        # closing at ~1.4 m/s relative can shave ~0.07 m between checks,
        # plus ~0.015 m ring-chord sagitta — the margin must cover both
        # for the surface-contact assertion below to be meaningful
        # (without it the pairs bottom out at 0.372 m center distance —
        # 2.8 cm of disc overlap; measured while calibrating this test)
        octree_resolution=0.2,
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=N_RAYS, path_capacity=512,
        max_segments=8, mesh=mesh,
        peer_avoidance=True, peer_prediction=True, peer_ring_points=12,
        tracked_obstacles=1,
        safety_config=FleetSafetyConfig(),
    )
    paths = []
    for j in range(N_LANES):
        y = LANE_DY * j
        # robot 2j drives +x along its lane; robot 2j+1 crosses it
        paths.append(np.array([[0.0, y], [5.0, y]]))
        paths.append(np.array([[2.5, y + 2.0], [2.5, y - 2.0]]))
    fleet.set_paths(paths)
    return fleet


def _initial_states():
    states = np.zeros((N_ROBOTS, 4), np.float32)
    for j in range(N_LANES):
        y = LANE_DY * j
        states[2 * j] = (0.0, y, 0.0, 0.0)
        states[2 * j + 1] = (2.5, y + 2.0, -np.pi / 2, 0.0)
    return states


def _movers_at(tick):
    """True world mover tracks: one per even robot, crossing its lane
    ahead of it; odd robots track nothing (NaN = empty slot)."""
    m = np.full((N_ROBOTS, 1, 4), np.nan, np.float32)
    for j in range(N_LANES):
        m[2 * j, 0] = (4.2, LANE_DY * j + 1.8 - 0.3 * DT * tick, 0.0, -0.3)
    return m


def _run(fleet, states, vels, start_tick, n_dispatches, angles, ranges):
    """Drive the fleet n_dispatches x K ticks; returns (outputs list,
    final states, final vels, per-tick integrated positions)."""
    outs = []
    track = []
    for d in range(n_dispatches):
        tick0 = start_tick + d * K
        out = fleet.run_ticks_on_device(
            K, states, vels, ranges, angles, tracked=_movers_at(tick0)
        )
        outs.append(out)
        # integrate the executed commands against the device order
        xy = states[:, 0:2].astype(np.float64).copy()
        yaw = states[:, 2].astype(np.float64).copy()
        for i in range(K):
            vx = out["vx"][:, i].astype(np.float64)
            vy = out["vy"][:, i].astype(np.float64)
            om = out["omega"][:, i].astype(np.float64)
            c, s = np.cos(yaw), np.sin(yaw)
            xy[:, 0] += DT * (vx * c - vy * s)
            xy[:, 1] += DT * (vx * s + vy * c)
            yaw += DT * om
            track.append((tick0 + i + 1, xy.copy()))
        states = out["final_states"].copy()
        vels = np.stack(
            [out["vx"][:, -1], out["vy"][:, -1], out["omega"][:, -1]],
            axis=1,
        ).astype(np.float32)
    return outs, states, vels, track


@pytest.mark.slow
def test_fleet_soak_500_ticks_all_features_compose():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    mesh = build_fleet_mesh()
    angles = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
    ranges = np.full((N_ROBOTS, N_RAYS), 10.0, np.float32)

    fleet_a = _build_fleet(mesh)
    states0 = _initial_states()
    vels0 = np.zeros((N_ROBOTS, 3), np.float32)

    # ---- full 500-tick run, snapshotting in place at dispatch 16 -----
    split_at = DISPATCHES - 4
    outs_a1, states_mid, vels_mid, track1 = _run(
        fleet_a, states0, vels0, 0, split_at, angles, ranges
    )
    sd = fleet_a.state_dict()
    outs_a2, fin_a, _, track2 = _run(
        fleet_a, states_mid, vels_mid, split_at * K,
        DISPATCHES - split_at, angles, ranges,
    )
    outs_a = outs_a1 + outs_a2
    track = track1 + track2

    # every robot reached its goal
    reached = outs_a[-1]["reached"][:, -1]
    assert reached.all(), (
        f"robots {np.nonzero(~reached)[0].tolist()} never reached goals"
    )

    # zero robot-robot collisions, every tick (the crossing pairs are the
    # hard case; the box robot's circumscribed disc uses the same radius)
    min_pair = np.inf
    for _t, xy in track:
        d = np.linalg.norm(xy[:, None, :] - xy[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        min_pair = min(min_pair, float(d.min()))
    assert min_pair > 2 * R_ROBOT, (
        f"robot-robot contact: min pairwise distance {min_pair:.3f}"
    )

    # zero robot-mover collisions against the TRUE advected tracks
    min_mover = np.inf
    for t, xy in track:
        m = _movers_at(t)[:, 0, 0:2]
        ok = np.isfinite(m[:, 0])
        d = np.linalg.norm(xy[ok] - m[ok], axis=1)
        min_mover = min(min_mover, float(d.min()))
    assert min_mover > R_ROBOT, (
        f"robot-mover contact: min distance {min_mover:.3f}"
    )

    # ---- bit-identical replay from the mid-mission snapshot ----------
    # a FRESH fleet (new jitted programs, new device buffers) restores
    # the dispatch-16 snapshot and must reproduce fleet A's final 100
    # ticks bit-for-bit
    fleet_c = _build_fleet(mesh)
    fleet_c.load_state_dict(sd)
    outs_c, fin_c, _, _ = _run(
        fleet_c, states_mid, vels_mid, split_at * K,
        DISPATCHES - split_at, angles, ranges,
    )
    for d in range(DISPATCHES - split_at):
        for key in outs_a2[0]:
            np.testing.assert_array_equal(
                outs_c[d][key], outs_a2[d][key],
                err_msg=f"replay diverged at dispatch {d}, field {key}",
            )
    np.testing.assert_array_equal(fin_c, fin_a)
