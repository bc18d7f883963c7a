"""The solver's distance sweeps and rollout against float64 NumPy.

The obstacle sweep (static and constant-velocity) and the closed-form
rollout are the solve's arithmetic core; on a GPU they compile to fused
f32 elementwise+reduce kernels and an f32 matmul. These tests pin them
to brute-force float64 references at widths that are not powers of two,
with masked points, sentinel pads and degenerate geometry, and guard
that every matrix product in the solve and the fleet tick is either
bf16-exact or pinned to full f32 precision (a default-precision f32 dot
runs in TF32 on a GPU).
"""

import math
from functools import partial

import numpy as np
import pytest

import jax
import jax.extend
import jax.numpy as jnp

from kompass_core_tpu.ops.solver import (
    SolverParams,
    SolverSpec,
    _min_obstacle_dist_sq,
    _min_obstacle_dist_sq_moving,
    _pad_sweep_pow2,
    _rollout,
    _unpack_and_solve,
    packed_input_size,
)

DT = 0.1


def _points(rng, S, T):
    return (rng.uniform(-5, 5, (S, T)).astype(np.float32),
            rng.uniform(-5, 5, (S, T)).astype(np.float32))


def _obstacles(rng, n_real, width):
    obs = np.full((width, 2), 1e8, np.float32)
    obs[:n_real] = rng.uniform(-6, 6, (n_real, 2))
    return obs


def _brute(px, py, obs, vel=None, mask=None):
    px, py = px.astype(np.float64), py.astype(np.float64)
    o = obs.astype(np.float64)
    T = px.shape[1]
    t = np.arange(T)[None, :, None] * DT
    ox, oy = o[None, None, :, 0], o[None, None, :, 1]
    if vel is not None:
        ox = ox + vel[None, None, :, 0] * t
        oy = oy + vel[None, None, :, 1] * t
    d2 = ((px[:, :, None] - ox) ** 2 + (py[:, :, None] - oy) ** 2).min(-1)
    if mask is not None:
        d2 = np.where(mask[None, :], d2, np.inf)
    return d2


@pytest.mark.parametrize("n_real,width", [(5, 7), (100, 100), (300, 384),
                                          (513, 600)])
def test_static_sweep_matches_brute_force(n_real, width):
    rng = np.random.default_rng(width)
    px, py = _points(rng, 23, 9)
    obs = _obstacles(rng, n_real, width)
    mask = np.arange(9) < 7
    got = np.asarray(_min_obstacle_dist_sq(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(obs), jnp.asarray(mask)
    ))
    ref = _brute(px, py, obs, mask=mask)
    assert np.isinf(got[:, 7:]).all()
    np.testing.assert_allclose(got[:, :7], ref[:, :7], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_real,width", [(3, 5), (200, 300), (512, 512)])
def test_moving_sweep_matches_brute_force(n_real, width):
    rng = np.random.default_rng(width + 1)
    px, py = _points(rng, 17, 11)
    obs = _obstacles(rng, n_real, width)
    vel = np.zeros((width, 2), np.float32)
    vel[:n_real] = rng.uniform(-1.5, 1.5, (n_real, 2))
    mask = np.ones(11, bool)
    got = np.asarray(_min_obstacle_dist_sq_moving(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(obs), jnp.asarray(vel),
        jnp.float32(DT), jnp.asarray(mask),
    ))
    ref = _brute(px, py, obs, vel=vel.astype(np.float64), mask=mask)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_point_on_an_obstacle_has_zero_distance():
    """d2 is a sum of squares: exactly 0 on an obstacle, never negative
    (a negative d2 would NaN the sqrt of the obstacle cost)."""
    rng = np.random.default_rng(3)
    px, py = _points(rng, 8, 6)
    obs = _obstacles(rng, 10, 16)
    obs[4] = (px[2, 3], py[2, 3])
    got = np.asarray(_min_obstacle_dist_sq(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(obs),
        jnp.ones(6, bool),
    ))
    assert got[2, 3] == 0.0
    assert (got >= 0.0).all()


def test_zero_velocity_moving_sweep_equals_static_bitwise():
    rng = np.random.default_rng(4)
    px, py = _points(rng, 12, 10)
    obs = _obstacles(rng, 40, 48)
    mask = jnp.arange(10) < 8
    args = (jnp.asarray(px), jnp.asarray(py), jnp.asarray(obs))
    static = np.asarray(_min_obstacle_dist_sq(*args, mask))
    moving = np.asarray(_min_obstacle_dist_sq_moving(
        *args, jnp.zeros((48, 2), jnp.float32), jnp.float32(DT), mask
    ))
    np.testing.assert_array_equal(static, moving)


def test_sentinel_pads_never_win():
    """All-sentinel obstacles give a d2 of ~1e16, never a near hit; one
    real obstacle among pads wins everywhere."""
    rng = np.random.default_rng(5)
    px, py = _points(rng, 6, 5)
    pads = np.full((20, 2), 1e8, np.float32)
    got = np.asarray(_min_obstacle_dist_sq(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(pads),
        jnp.ones(5, bool),
    ))
    assert (got > 1e15).all()
    pads[13] = (0.5, -0.5)
    got = np.asarray(_min_obstacle_dist_sq(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(pads),
        jnp.ones(5, bool),
    ))
    ref = (px.astype(np.float64) - 0.5) ** 2 + (py + 0.5) ** 2
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("n,target", [(7, 128), (128, 128), (384, 512),
                                      (513, 1024)])
def test_pad_sweep_pow2_widths(n, target):
    x = jnp.arange(n, dtype=jnp.float32)
    y = np.asarray(_pad_sweep_pow2(x))
    assert y.shape == (target,)
    np.testing.assert_array_equal(y[:n], np.arange(n))
    assert (y[n:] == 1e8).all()


def _params():
    return SolverParams.create(
        time_step=DT, robot_radius=0.3, collision_margin=0.05,
        weights={
            "reference_path_distance_weight": 1.0,
            "goal_distance_weight": 1.0,
            "obstacles_distance_weight": 1.0,
            "smoothness_weight": 0.0,
            "jerk_weight": 0.0,
        },
        acc_limits=(5.0, 5.0, 3.0), max_obstacles_dist=3.0,
    )


@pytest.mark.parametrize("omni", [False, True])
def test_rollout_matches_float64_prefix_sum(omni):
    """30 steps at up to 2 m/s: the f32 triangular-matmul prefix sum stays
    within 1e-5 m of a float64 loop (a TF32 or bf16 product would be off
    by millimetres)."""
    T = 30
    spec = SolverSpec(is_omni=omni, n_vx=3, n_vy=3 if omni else 1,
                      n_omega=3, max_points=T, num_ctrl_points=2,
                      scan_size=8, seg_size=8)
    rng = np.random.default_rng(6)
    S = 40
    vels = np.stack([
        rng.uniform(-2, 2, S),
        rng.uniform(-1, 1, S) if omni else np.zeros(S),
        rng.uniform(-3, 3, S),
    ], axis=1).astype(np.float32)
    state = np.array([1.25, -3.5, 0.7], np.float32)
    px, py = _rollout(spec, _params(), jnp.asarray(state), jnp.asarray(vels))
    px, py = np.asarray(px), np.asarray(py)
    v = vels.astype(np.float64)
    for s in range(S):
        x, y, yaw = (float(c) for c in state)
        assert px[s, 0] == np.float32(x) and py[s, 0] == np.float32(y)
        for t in range(T - 1):
            yaw_t = float(state[2]) + v[s, 2] * t * DT
            x += (v[s, 0] * math.cos(yaw_t) - v[s, 1] * math.sin(yaw_t)) * DT
            y += (v[s, 0] * math.sin(yaw_t) + v[s, 1] * math.cos(yaw_t)) * DT
            assert abs(px[s, t + 1] - x) < 1e-5, (s, t)
            assert abs(py[s, t + 1] - y) < 1e-5, (s, t)


def _dot_generals(jaxpr):
    """Every dot_general in a closed jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _dot_generals(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _dot_generals(sub)


def _assert_dots_exact(closed):
    dots = list(_dot_generals(closed.jaxpr))
    assert dots, "expected the rollout's prefix-sum matmul"
    for eqn in dots:
        prec = eqn.params.get("precision")
        pinned = prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        )
        bf16 = all(v.aval.dtype == jnp.bfloat16 for v in eqn.invars)
        assert pinned or bf16, (
            f"dot_general with precision {prec} on "
            f"{[v.aval for v in eqn.invars]}: pin Precision.HIGHEST or "
            f"feed bf16-exact operands"
        )


def _small_fleet():
    from kompass_core_tpu.control import DWAConfig
    from kompass_core_tpu.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    robot = Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.2, 0.4]))
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0,
                                       max_decel=3.0),
    )
    cfg = DWAConfig(max_linear_samples=4, max_angular_samples=4,
                    prediction_horizon=8, control_horizon=2)
    fleet = DeviceFleet([robot] * 2, limits, cfg, scan_rays=16,
                        path_capacity=128, max_segments=4)
    fleet.set_paths([np.array([[0.0, 0.0], [1.0, 0.0]])] * 2)
    fleet.set_scan_angles(np.linspace(-np.pi, np.pi, 16, endpoint=False))
    return fleet


@pytest.mark.parametrize("program", ["packed_solve", "fleet_tick"])
def test_every_dot_is_bf16_or_pinned_highest(program):
    if program == "packed_solve":
        spec = SolverSpec(is_omni=False, n_vx=5, n_vy=1, n_omega=5,
                          max_points=12, num_ctrl_points=2, scan_size=64,
                          seg_size=64)
        closed = jax.make_jaxpr(partial(_unpack_and_solve, spec))(
            jnp.zeros(packed_input_size(spec), jnp.float32)
        )
    else:
        fleet = _small_fleet()
        closed = jax.make_jaxpr(fleet._tick_fn)(*fleet.tick_example_args())
    _assert_dots_exact(closed)
