"""Multi-chip fleet tests on the virtual 8-device CPU mesh.

Exercises the two scale-out modes of ``parallel/fleet.py``: scenario
data-parallel sharding and cross-chip sample-parallel argmin. These are the
CPU-simulated stand-ins for the multi-host configurations in BASELINE.json.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as P

from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    RobotCtrlLimits,
)
from kompass_core_tpu.ops.solver import SolverSpec, packed_input_size, unpack_solver_output
from kompass_core_tpu.ops.window import VelocityWindow, sample_velocity_window
from kompass_core_tpu.parallel.fleet import (
    FleetPlanner,
    make_fleet_solver,
    make_sample_parallel_solver,
)


SPEC = SolverSpec(
    is_omni=False,
    n_vx=5,
    n_vy=1,
    n_omega=5,
    max_points=10,
    num_ctrl_points=2,
    scan_size=64,
    seg_size=64,
    drop_samples=True,
)

LIMITS = RobotCtrlLimits(
    vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
    omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
).to_array()
LIMITS[3:6] = 0.0  # non-holonomic


def _scenario_kwargs(x0=0.0, y0=0.0, yaw0=0.0, vel=(0.3, 0.0, 0.0)):
    """A simple straight-path scenario for one robot."""
    n_seg = 40
    seg_x = np.full(SPEC.seg_size, 1e8, np.float32)
    seg_y = np.full(SPEC.seg_size, 1e8, np.float32)
    seg_arc = np.zeros(SPEC.seg_size, np.float32)
    xs = x0 + 0.1 * np.arange(n_seg, dtype=np.float32)
    seg_x[:n_seg] = xs
    seg_y[:n_seg] = y0
    seg_arc[:n_seg] = 0.1 * np.arange(n_seg, dtype=np.float32)
    window = sample_velocity_window(
        vel, LIMITS, 0.1, SPEC.n_vx, SPEC.n_vy, SPEC.n_omega, SPEC.is_omni
    )
    params = np.array(
        [0.1, 0.2, 0.05, 1.0, 1.0, 1.0, 0.0, 0.0, 5.0, 0.0, 3.0, 10.0 / 3],
        np.float32,
    )
    return dict(
        params_vec=params,
        state=(x0, y0, yaw0),
        window=window,
        obs_xy=np.full((SPEC.scan_size, 2), 1e8, np.float32),
        obs_count=0,
        seg_x=seg_x,
        seg_y=seg_y,
        seg_arc=seg_arc,
        seg_count=n_seg,
        seg_total_len=float(seg_arc[n_seg - 1]),
        ref_total_len=4.0,
        active_points=SPEC.max_points,
    )


def test_fleet_sharded_matches_single_device():
    devices = jax.devices()
    assert len(devices) == 8, "conftest must provide 8 virtual devices"
    mesh = Mesh(np.array(devices), axis_names=("robots",))

    n = 16
    fleet = FleetPlanner(SPEC, n, mesh=mesh)
    for i in range(n):
        fleet.set_scenario(i, **_scenario_kwargs(x0=0.05 * i, y0=0.01 * i))
    out_sharded = fleet.step()

    fleet_local = FleetPlanner(SPEC, n, mesh=None)
    fleet_local.inputs[:] = fleet.inputs
    out_local = fleet_local.step()

    np.testing.assert_allclose(out_sharded, out_local, rtol=1e-6, atol=1e-6)
    for i in range(n):
        found, cost, *_ = unpack_solver_output(SPEC, out_sharded[i])
        assert found
        assert np.isfinite(cost)


def test_sample_parallel_argmin_matches_global():
    """Splitting the omega axis across devices + cross-device argmin
    combine must give the same winner as the single-device solve over the
    full window."""
    devices = jax.devices()[:4]
    mesh = Mesh(np.array(devices), axis_names=("sp",))

    kw = _scenario_kwargs(vel=(0.5, 0.0, 0.0))
    full_window = kw["window"]

    # single-chip reference
    from kompass_core_tpu.ops.solver import get_packed_dwa_solver, pack_solver_input

    buf = np.zeros(packed_input_size(SPEC), np.float32)
    pack_solver_input(SPEC, buf, **kw)
    ref_out = np.asarray(get_packed_dwa_solver(SPEC)(buf))
    ref = unpack_solver_output(SPEC, ref_out)

    # shard omega axis: each chip gets a window whose omega mask covers a
    # disjoint slice; grids are identical so sample indices align per chip
    n_chips = 4
    bufs = np.zeros((n_chips, packed_input_size(SPEC)), np.float32)
    for c in range(n_chips):
        mask = np.zeros_like(full_window.omega_mask)
        for j in range(c, SPEC.n_omega, n_chips):
            mask[j] = full_window.omega_mask[j]
        w = VelocityWindow(
            full_window.vx_vals,
            full_window.vx_mask,
            full_window.vy_vals,
            full_window.vy_mask,
            full_window.omega_vals,
            mask,
        )
        kw_c = dict(kw)
        kw_c["window"] = w
        pack_solver_input(SPEC, bufs[c], **kw_c)

    sp_solver = make_sample_parallel_solver(SPEC, mesh)
    sp_out = np.asarray(sp_solver(bufs))
    # all chips hold the broadcast winner; compare chip 0 to the reference
    got = unpack_solver_output(SPEC, sp_out[0])
    assert got[0] == ref[0]  # found
    assert got[1] == pytest.approx(ref[1], rel=1e-5)  # cost
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-5)  # vx sequence


def test_mesh_chunked_map_matches_plain():
    """The sharded solver runs each chip's shard as a lax.map over
    chunk_size-row blocks inside the program (64 is the production
    chunk). Tiny chunk here to force the map path AND a
    ragged in-program pad (6 local rows, chunk 4 -> pad 2)."""
    devices = jax.devices()
    mesh = Mesh(np.array(devices), axis_names=("robots",))
    n = 48  # 6 rows/device
    solver_chunked = make_fleet_solver(SPEC, mesh=mesh, chunk_size=4)
    solver_plain = make_fleet_solver(SPEC, mesh=None, chunk_size=None)
    L = packed_input_size(SPEC)
    full = np.zeros((n, L), np.float32)
    from kompass_core_tpu.ops.solver import pack_solver_input

    base = np.zeros(L, np.float32)
    pack_solver_input(SPEC, base, **_scenario_kwargs())
    for i in range(n):
        full[i] = base
        full[i, 0] += 1e-3 * i
    out_c = np.asarray(solver_chunked(full))
    out_p = np.asarray(solver_plain(full))
    np.testing.assert_allclose(out_c, out_p, rtol=1e-6, atol=1e-6)
    for i in range(n):
        found, cost, *_ = unpack_solver_output(SPEC, out_c[i])
        assert found and np.isfinite(cost)


def test_fleet_planner_rejects_pad_row_indices():
    """Mesh padding rows beyond num_robots exist only to satisfy the
    shard_map divisibility contract; set_scenario writing one must raise
    (the result would be silently discarded by step()) — round-5 review."""
    import jax
    from jax.sharding import Mesh

    from kompass_core_tpu.ops.solver import SolverSpec
    from kompass_core_tpu.parallel.fleet import FleetPlanner

    spec = SolverSpec(
        is_omni=False, n_vx=3, n_vy=1, n_omega=3, max_points=6,
        num_ctrl_points=3, scan_size=16, seg_size=8, drop_samples=True,
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("robots",))
    fp = FleetPlanner(spec, num_robots=5, mesh=mesh)
    assert fp.inputs.shape[0] == 8  # padded to the mesh
    with pytest.raises(IndexError, match="out of range"):
        fp.set_scenario(5)
    with pytest.raises(IndexError, match="out of range"):
        fp.set_scenario(-1)
