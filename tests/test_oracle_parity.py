"""Independent reference-parity: device solver vs the serial NumPy oracle.

The oracle (``tests/oracle/reference_impl.py``) is a loop-for-loop
transcription of the reference C++ semantics (sampler window walk + grid
order, per-step rollout with first-hit drop/truncate, the five cost
kernels, the strict-``<`` winner scan). Here the full jitted tensor program
(``ops/solver.dwa_solve``) is diffed against it on randomized scenarios
across robot types × drop/truncate × adaptive horizons at rel-tol 1e-4 —
the reference's own cross-build parity tolerance
(``/root/reference/tests/test_cost_parity.py:32``).

A sample whose admissibility disagrees is only tolerated when the oracle
shows its closest approach within a float32 rounding band of the collision
boundary (the device solves in f32, the oracle in f64).

Scenario count: 30 per configuration × 5 configurations = 150 full ticks
(raise with KOMPASS_ORACLE_SCENARIOS for a deeper sweep).
"""

import math
import os

import numpy as np
import pytest

import jax.numpy as jnp

from kompass_core_tpu.ops.solver import (
    SolverParams,
    SolverSpec,
    make_dwa_solver,
)
from kompass_core_tpu.ops.window import (
    compute_linear_sample_split,
    num_angular_slots,
    sample_velocity_window,
)

from oracle import reference_impl as oracle
from oracle.parity import compare_tick, run_oracle

N_SCENARIOS = int(os.environ.get("KOMPASS_ORACLE_SCENARIOS", "30"))

SEG_SIZE = 128
SCAN_SIZE = 64
MAX_POINTS = 12


def _make_path(rng, n_pts=90, step=0.06):
    """Random smooth path starting near the origin: heading random walk."""
    heading = rng.uniform(-math.pi, math.pi)
    xs = [rng.uniform(-0.3, 0.3)]
    ys = [rng.uniform(-0.3, 0.3)]
    for _ in range(n_pts - 1):
        heading += rng.uniform(-0.15, 0.15)
        xs.append(xs[-1] + step * math.cos(heading))
        ys.append(ys[-1] + step * math.sin(heading))
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    arc = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(xs), np.diff(ys)))])
    return xs, ys, arc


def _scenario_inputs(rng, is_omni, active_points):
    """Random tick inputs shared by oracle and solver."""
    limits = np.array(
        [
            rng.uniform(0.6, 2.0),  # vx max
            rng.uniform(2.0, 8.0),  # vx acc
            rng.uniform(2.0, 8.0),  # vx dec
            rng.uniform(0.4, 1.5),  # vy max
            rng.uniform(2.0, 6.0),  # vy acc
            rng.uniform(2.0, 6.0),  # vy dec
            rng.uniform(1.0, 4.0),  # w max
            rng.uniform(2.0, 8.0),  # w acc
            rng.uniform(2.0, 8.0),  # w dec
        ]
    )
    current_vel = (
        rng.uniform(0.0, limits[0]),
        rng.uniform(-limits[3], limits[3]) if is_omni else 0.0,
        rng.uniform(-limits[6] / 2, limits[6] / 2),
    )
    xs, ys, arc = _make_path(rng)
    # robot near the path start, roughly aligned with it
    heading0 = math.atan2(ys[1] - ys[0], xs[1] - xs[0])
    start_pose = (
        float(xs[0] + rng.uniform(-0.1, 0.1)),
        float(ys[0] + rng.uniform(-0.1, 0.1)),
        heading0 + rng.uniform(-0.4, 0.4),
    )
    # obstacles scattered in front of the robot so some rollouts collide
    n_obs = 24
    ang = rng.uniform(-math.pi, math.pi, n_obs)
    rad = rng.uniform(0.25, 2.5, n_obs)
    obs = np.stack(
        [
            start_pose[0] + rad * np.cos(start_pose[2] + ang),
            start_pose[1] + rad * np.sin(start_pose[2] + ang),
        ],
        axis=1,
    )
    seg_len = min(len(xs), rng.integers(40, 80))
    seg_x = xs[:seg_len]
    seg_y = ys[:seg_len]
    seg_arc = arc[:seg_len]
    seg_total = float(
        np.sum(np.hypot(np.diff(seg_x), np.diff(seg_y)))
    )
    ref_total = float(arc[-1])
    weights = {
        "reference_path_distance_weight": rng.uniform(0.5, 3.0),
        "goal_distance_weight": rng.uniform(0.5, 2.0),
        "obstacles_distance_weight": rng.uniform(0.2, 1.5),
        "smoothness_weight": rng.uniform(0.0, 0.4),
        "jerk_weight": rng.uniform(0.0, 0.2),
    }
    return dict(
        limits=limits,
        current_vel=current_vel,
        start_pose=start_pose,
        obs=obs,
        seg_x=seg_x,
        seg_y=seg_y,
        seg_arc=seg_arc,
        seg_total=seg_total,
        ref_total=ref_total,
        weights=weights,
        radius=rng.uniform(0.1, 0.3),
        margin=rng.uniform(0.02, 0.1),
        max_obs_dist=rng.uniform(2.0, 5.0),
        active_points=active_points,
    )


_SOLVERS = {}


def _solver(spec):
    if spec not in _SOLVERS:
        _SOLVERS[spec] = make_dwa_solver(spec)
    return _SOLVERS[spec]


def _run_solver(spec, sc):
    limits = sc["limits"].copy()
    if not spec.is_omni:
        limits[3:6] = 0.0
    window = sample_velocity_window(
        sc["current_vel"], limits, 0.1, spec.n_vx, spec.n_vy, spec.n_omega,
        spec.is_omni,
    )
    obs_padded = np.full((spec.scan_size, 2), 1e8, np.float32)
    obs_padded[: len(sc["obs"])] = sc["obs"]
    seg_x = np.full(spec.seg_size, 1e8, np.float32)
    seg_y = np.full(spec.seg_size, 1e8, np.float32)
    seg_arc = np.zeros(spec.seg_size, np.float32)
    n_seg = len(sc["seg_x"])
    seg_x[:n_seg] = sc["seg_x"]
    seg_y[:n_seg] = sc["seg_y"]
    seg_arc[:n_seg] = sc["seg_arc"]
    params = SolverParams.create(
        time_step=0.1,
        robot_radius=sc["radius"],
        collision_margin=sc["margin"],
        weights=sc["weights"],
        acc_limits=(sc["limits"][1], sc["limits"][4], sc["limits"][7]),
        max_obstacles_dist=sc["max_obs_dist"],
    )
    res = _solver(spec)(
        params,
        jnp.asarray(np.asarray(sc["start_pose"], np.float32)),
        window,
        jnp.asarray(obs_padded),
        jnp.int32(len(sc["obs"])),
        jnp.asarray(seg_x),
        jnp.asarray(seg_y),
        jnp.asarray(seg_arc),
        jnp.int32(n_seg),
        jnp.float32(sc["seg_total"]),
        jnp.float32(sc["ref_total"]),
        jnp.int32(sc["active_points"]),
    )
    return res, window


def _compare_tick(spec, sc, n_lin, n_ang, collision_box=None):
    res, _window = _run_solver(spec, sc)
    tick = run_oracle(
        sc, n_lin, n_ang, spec.is_omni, spec.num_ctrl_points,
        spec.drop_samples, collision_box=collision_box,
    )
    compare_tick(spec, sc, res, tick, collision_box=collision_box)


def _spec(is_omni, n_lin, n_ang, drop, collision_box=None):
    n_vx, n_vy = compute_linear_sample_split(is_omni, n_lin)
    return SolverSpec(
        is_omni=is_omni,
        n_vx=n_vx,
        n_vy=n_vy,
        n_omega=num_angular_slots(n_ang),
        max_points=MAX_POINTS,
        num_ctrl_points=2,
        scan_size=SCAN_SIZE,
        seg_size=SEG_SIZE,
        drop_samples=drop,
        collision_box=collision_box,
    )


N_LIN, N_ANG = 5, 4


CONFIGS = [
    ("diff_drive_drop", 101, False, True, None),
    ("diff_drive_truncate", 202, False, False, None),
    ("omni_drop", 303, True, True, None),
    ("omni_truncate", 404, True, False, None),
    ("box_robot_drop", 505, False, True, (0.25, 0.15)),
]


@pytest.mark.parametrize("name,seed,is_omni,drop,box", CONFIGS)
def test_randomized_tick_parity(name, seed, is_omni, drop, box):
    spec = _spec(is_omni, N_LIN, N_ANG, drop, collision_box=box)
    rng = np.random.default_rng(seed)
    for i in range(N_SCENARIOS):
        # adaptive horizon sweep: the masked active_points path must match
        # the reference's resized-buffer semantics at every horizon
        active = int(rng.integers(4, MAX_POINTS + 1))
        sc = _scenario_inputs(rng, is_omni, active)
        try:
            _compare_tick(spec, sc, N_LIN, N_ANG, collision_box=box)
        except AssertionError as e:
            raise AssertionError(f"[{name} scenario {i}] {e}") from e


def test_window_walk_matches_oracle():
    """ops/window.sample_velocity_window must reproduce the oracle's exact
    ``for (v=min; v<=max; v+=res)`` walk (values and count)."""
    rng = np.random.default_rng(7)
    for _ in range(200):
        limits = rng.uniform(0.5, 6.0, 9)
        vel = (
            rng.uniform(-limits[0], limits[0]),
            rng.uniform(-limits[3], limits[3]),
            rng.uniform(-limits[6], limits[6]),
        )
        is_omni = bool(rng.integers(0, 2))
        lim = limits.copy()
        if not is_omni:
            lim[3:6] = 0.0
        n_vx, n_vy = compute_linear_sample_split(is_omni, 7)
        n_w = num_angular_slots(6)
        win = sample_velocity_window(vel, lim, 0.1, n_vx, n_vy, n_w, is_omni)
        ow = oracle.build_window(vel, lim, 0.1, n_vx, n_vy, n_w, is_omni)
        for vals, mask, lo, hi, res in [
            (win.vx_vals, win.vx_mask, ow.min_vx, ow.max_vx, ow.res_x),
            (win.omega_vals, win.omega_mask, ow.min_omega, ow.max_omega,
             ow.res_w),
        ] + (
            [(win.vy_vals, win.vy_mask, ow.min_vy, ow.max_vy, ow.res_y)]
            if is_omni
            else []
        ):
            expect = oracle.walk(lo, hi, res)
            got = np.asarray(vals)[np.asarray(mask)]
            assert len(got) == len(expect), (len(got), len(expect))
            np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-7)


def test_sample_split_matches_oracle():
    for n in range(1, 40):
        assert compute_linear_sample_split(True, n) == (
            oracle.compute_linear_sample_split(True, n)
        )
        assert compute_linear_sample_split(False, n) == (
            oracle.compute_linear_sample_split(False, n)
        )
        assert num_angular_slots(n) == oracle.angular_slots(n)
