"""Cross-backend cost parity harness.

Role of the reference's ``tests/test_cost_parity.py`` (CPU vs GPU builds
diffed at rel-tol 1e-4 via COST_PARITY_JSON dumps): run the identical
packed solve on the CPU and, on a machine with a card (``pytest -m gpu``
with ``JAX_PLATFORMS=cuda,cpu``), on the GPU, and require per-sample cost
agreement at rel-tol 1e-4.

A committed golden dump (``tests/resources/cost_parity_golden.json``) pins
the absolute values so regressions in the cost formulas are caught even
single-backend. NOTE: the golden dump is a regression pin only; the parity
AUTHORITY is the independent serial oracle in
``tests/test_oracle_parity.py`` (a NumPy transcription of the reference
C++ semantics sharing no code with the engine).
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    RobotCtrlLimits,
)
from kompass_core_tpu.ops.solver import (
    SolverParams,
    SolverSpec,
    dwa_solve,
)
from kompass_core_tpu.ops.window import sample_velocity_window

GOLDEN_PATH = os.path.join(
    os.path.dirname(__file__), "resources", "cost_parity_golden.json"
)
REL_TOL = 1e-4


def _scenario():
    spec = SolverSpec(
        is_omni=False,
        n_vx=5,
        n_vy=1,
        n_omega=5,
        max_points=15,
        num_ctrl_points=2,
        scan_size=64,
        seg_size=128,
        drop_samples=True,
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
    ).to_array()
    limits[3:6] = 0.0
    window = sample_velocity_window((0.5, 0.0, 0.1), limits, 0.1, 5, 1, 5, False)
    rng = np.random.default_rng(42)
    n_obs = 40
    obs = np.full((64, 2), 1e8, np.float32)
    ang = rng.uniform(0, 2 * np.pi, n_obs)
    r = rng.uniform(0.8, 5.0, n_obs)
    obs[:n_obs, 0] = r * np.cos(ang)
    obs[:n_obs, 1] = r * np.sin(ang)
    n_seg = 100
    s = np.linspace(0, 4.0, n_seg).astype(np.float32)
    seg_x = np.full(128, 1e8, np.float32)
    seg_y = np.full(128, 1e8, np.float32)
    seg_arc = np.zeros(128, np.float32)
    seg_x[:n_seg] = s
    seg_y[:n_seg] = 0.1 * np.sin(s)
    seg_arc[:n_seg] = s
    params = SolverParams.create(
        time_step=0.1,
        robot_radius=0.2,
        collision_margin=0.05,
        weights={
            "reference_path_distance_weight": 2.0,
            "goal_distance_weight": 1.0,
            "obstacles_distance_weight": 1.0,
            "smoothness_weight": 0.1,
            "jerk_weight": 0.05,
        },
        acc_limits=(5.0, 0.0, 3.0),
        max_obstacles_dist=10 / 3,
    )
    res = dwa_solve(
        spec,
        params,
        jnp.array([0.0, 0.05, 0.05], jnp.float32),
        window,
        jnp.asarray(obs),
        jnp.int32(n_obs),
        jnp.asarray(seg_x),
        jnp.asarray(seg_y),
        jnp.asarray(seg_arc),
        jnp.int32(n_seg),
        jnp.float32(s[-1]),
        jnp.float32(s[-1]),
        jnp.int32(15),
    )
    return res


def _finite_costs(res):
    costs = np.asarray(res.costs)
    return costs[np.isfinite(costs)]


def test_parity_against_golden_dump():
    """Per-sample total costs must match the committed golden dump at
    rel-tol 1e-4 (the reference harness's tolerance,
    ``test_cost_parity.py:32``)."""
    res = _scenario()
    costs = _finite_costs(res)
    payload = {
        "schema_version": 1,
        "backend": "xla",
        "tests": {
            "dwa_mixed_costs": {
                "costs": [float(c) for c in costs],
                "best_index": int(res.best_index),
            }
        },
    }
    if not os.path.exists(GOLDEN_PATH):
        os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
        with open(GOLDEN_PATH, "w") as f:
            json.dump(payload, f, indent=2)
        pytest.skip("golden dump generated; rerun to compare")
    golden = json.load(open(GOLDEN_PATH))
    expected = np.asarray(golden["tests"]["dwa_mixed_costs"]["costs"])
    assert len(costs) == len(expected)
    np.testing.assert_allclose(costs, expected, rtol=REL_TOL, atol=1e-6)
    assert int(res.best_index) == golden["tests"]["dwa_mixed_costs"]["best_index"]


@pytest.mark.gpu
def test_parity_cpu_vs_gpu(gpu):
    """The same packed solve on the card and on the CPU: per-sample costs
    at rel-tol 1e-4, the same winner."""
    import jax

    with jax.default_device(gpu):
        res_g = _scenario()
    with jax.default_device(jax.devices("cpu")[0]):
        res_c = _scenario()
    np.testing.assert_allclose(
        _finite_costs(res_g), _finite_costs(res_c), rtol=REL_TOL, atol=1e-5
    )
    assert int(res_g.best_index) == int(res_c.best_index)
