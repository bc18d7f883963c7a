#!/usr/bin/env python
"""Run the planner, fleet, mapper and safety path once on an NVIDIA GPU
and hold every result to the CPU backend and the serial oracles.

    python chip_smoke.py               # one card: phases 0-4
    python chip_smoke.py --four-cards  # the multi-card paths, four cards

Phases (one card):

0. the default device is a GPU, else exit non-zero;
1. DWA: the ``DWA`` controller at the BASELINE spec (2025 samples x 30
   steps, 512 rays, 384 segment points) for a few ``loop_step`` ticks;
   the packed batch-64 solve through ``make_fleet_solver``, two robots
   against the serial oracle and the whole batch against the CPU;
2. fleet: ``DeviceFleet`` with 1024 robots, a few ``tick`` calls and one
   ``run_ticks_on_device(8)``, a 64-robot slice against the CPU;
3. mapper and safety: 400x400 grids from 3600 rays (plain and Bayesian),
   100k-point cloud -> scan -> grid, and the critical zone on a 100k
   cloud, against the CPU and the critical-zone oracle;
4. cost evaluator: 5001 trajectories x 1000 points against the CPU.

Each phase prints one line with its wall time, the steady time per call
of its programs (after ``block_until_ready``) and the device's peak bytes
in use. The last line of stdout is one JSON object naming the device,
printed only when every phase passed; any failure raises.
"""

import argparse
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

# the CPU backend is the in-process reference: keep it next to the GPU
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REL = 1e-4  # the repo's parity bar (tests/oracle/parity.py)

FULL = dict(
    n_lin=45, n_ang=44, horizon=30, ctrl=6, rays=512, seg_len=3.5,
    batch=64, oracle_robots=2, fleet=1024, fleet_slice=64, peer_fleet=256,
    grid=400, bins=3600, cloud=100_000, traj=5001, traj_pts=1000,
    loop_ticks=4, fleet_ticks=3, device_ticks=8, reps=10,
)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def steady_ms(fn, reps):
    """Median ms per call of ``fn`` after one warm call; every call ends
    in ``block_until_ready``."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


class Phase:
    """Prints one line per phase: wall time, steady ms per call of each
    timed program, peak device bytes in use (max over ``devices``)."""

    def __init__(self, name, devices):
        self.name = name
        self.devices = devices
        self.steady = {}
        self.notes = []

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            peak = max(
                (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                for d in self.devices
            )
            steady = ", ".join(
                f"{k} {v:.3f} ms" for k, v in self.steady.items()
            )
            notes = "; ".join(self.notes)
            print(
                f"phase {self.name}: wall {time.perf_counter() - self.t0:.1f}"
                f" s | steady {steady} | peak {peak / 2**20:.0f} MiB"
                + (f" | {notes}" if notes else ""),
                flush=True,
            )
        return False


def card_line():
    from kompass_core_tpu.benchmark.device import query_gpus

    return query_gpus().strip().replace("\n", " | ")


def assert_close(name, got, ref, rtol=REL, atol=1e-5):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
        err_msg=f"{name}: device vs CPU",
    )


def on(device):
    return jax.default_device(device)


# ---------------------------------------------------------------------------
# phase 1: DWA
# ---------------------------------------------------------------------------


def _robot_and_limits():
    from kompass_core_tpu.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )

    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array([0.3, 0.4]),
    )
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(
            max_vel=2.0, max_acc=3.0, max_decel=3.0
        ),
    )
    return robot, limits


def _dwa_config(sz):
    from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights

    return DWAConfig(
        max_linear_samples=sz["n_lin"],
        max_angular_samples=sz["n_ang"],
        prediction_horizon=sz["horizon"],
        control_horizon=sz["ctrl"],
        control_time_step=0.1,
        path_segment_length=sz["seg_len"],
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=1.0,
            smoothness_weight=0.1,
            jerk_weight=0.05,
        ),
    )


def run_dwa_controller(sz, ph):
    """The single-robot controller through its own entry points; returns
    the solver spec it compiled."""
    from kompass_core_tpu.control import DWA
    from kompass_core_tpu.datatypes.laserscan import LaserScanData

    robot, limits = _robot_and_limits()
    dwa = DWA(robot=robot, ctrl_limits=limits, config=_dwa_config(sz))
    xs = np.linspace(0.0, 8.0, 81)
    dwa.set_path(np.stack([xs, 0.3 * np.sin(xs / 3.0)], axis=1))
    rng = np.random.default_rng(7)
    angles = np.linspace(-np.pi, np.pi, sz["rays"], endpoint=False)
    robot.state.x, robot.state.y, robot.state.yaw = 0.0, 0.0, 0.0
    ticks = []
    for _ in range(sz["loop_ticks"]):
        scan = LaserScanData(
            angles=angles, ranges=rng.uniform(2.5, 9.0, sz["rays"])
        )
        t0 = time.perf_counter()
        ok = dwa.loop_step(current_state=robot.state, laser_scan=scan)
        ticks.append(time.perf_counter() - t0)
        assert ok and dwa.has_result(), "DWA loop_step found no command"
        assert np.isfinite(dwa.result_cost)
        robot.set_control(
            velocity_x=float(dwa.linear_x_control[0]),
            velocity_y=0.0,
            omega=float(dwa.angular_control[0]),
        )
        robot.get_state(dt=0.1)
    ph.steady["DWA.loop_step"] = 1e3 * float(np.median(ticks[1:] or ticks))
    assert robot.state.x > 0.0, "the robot did not move forward"
    (spec, _solver, _buf), = dwa._solvers.values()
    return spec


def make_scenario(rng, sz):
    """One robot's tick inputs in the oracle's format (as in
    tests/test_oracle_parity.py, at the spec's sizes): random limits,
    a smooth path, obstacles all around, some close enough to collide."""
    limits = np.array([
        rng.uniform(0.6, 2.0), rng.uniform(2.0, 8.0), rng.uniform(2.0, 8.0),
        rng.uniform(0.4, 1.5), rng.uniform(2.0, 6.0), rng.uniform(2.0, 6.0),
        rng.uniform(1.0, 4.0), rng.uniform(2.0, 8.0), rng.uniform(2.0, 8.0),
    ])
    current_vel = (
        rng.uniform(0.0, limits[0]), 0.0,
        rng.uniform(-limits[6] / 2, limits[6] / 2),
    )
    n_seg = sz["seg"]
    heading = rng.uniform(-math.pi, math.pi)
    steps = heading + np.cumsum(rng.uniform(-0.01, 0.01, n_seg))
    xs = np.concatenate([[0.0], np.cumsum(0.01 * np.cos(steps[:-1]))])
    ys = np.concatenate([[0.0], np.cumsum(0.01 * np.sin(steps[:-1]))])
    arc = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(xs), np.diff(ys)))])
    start = (
        float(rng.uniform(-0.1, 0.1)), float(rng.uniform(-0.1, 0.1)),
        heading + rng.uniform(-0.4, 0.4),
    )
    n_obs = sz["rays"]
    ang = rng.uniform(-math.pi, math.pi, n_obs)
    rad = rng.uniform(0.5, 9.0, n_obs)
    obs = np.stack([start[0] + rad * np.cos(ang),
                    start[1] + rad * np.sin(ang)], axis=1)
    return dict(
        limits=limits, current_vel=current_vel, start_pose=start, obs=obs,
        seg_x=xs, seg_y=ys, seg_arc=arc,
        seg_total=float(arc[-1]), ref_total=float(arc[-1]) + 5.0,
        weights={
            "reference_path_distance_weight": rng.uniform(0.5, 3.0),
            "goal_distance_weight": rng.uniform(0.5, 2.0),
            "obstacles_distance_weight": rng.uniform(0.2, 1.5),
            "smoothness_weight": rng.uniform(0.0, 0.4),
            "jerk_weight": rng.uniform(0.0, 0.2),
        },
        radius=rng.uniform(0.1, 0.3), margin=rng.uniform(0.02, 0.1),
        max_obs_dist=rng.uniform(2.0, 5.0), active_points=sz["horizon"],
    )


def pack_scenario(spec, sc):
    from kompass_core_tpu.ops.solver import (
        pack_solver_input, packed_input_size,
    )
    from kompass_core_tpu.ops.window import sample_velocity_window

    limits = sc["limits"].copy()
    limits[3:6] = 0.0  # diff drive: the window has no vy axis
    window = sample_velocity_window(
        sc["current_vel"], limits, 0.1, spec.n_vx, spec.n_vy, spec.n_omega,
        spec.is_omni,
    )
    w = sc["weights"]
    params = np.array([
        0.1, sc["radius"], sc["margin"],
        w["reference_path_distance_weight"], w["goal_distance_weight"],
        w["obstacles_distance_weight"], w["smoothness_weight"],
        w["jerk_weight"],
        sc["limits"][1], sc["limits"][4], sc["limits"][7],
        sc["max_obs_dist"],
    ], np.float32)
    obs = np.full((spec.scan_size, 2), 1e8, np.float32)
    obs[: len(sc["obs"])] = sc["obs"]
    seg = np.full((3, spec.seg_size), 1e8, np.float32)
    n = len(sc["seg_x"])
    seg[0, :n], seg[1, :n] = sc["seg_x"], sc["seg_y"]
    seg[2] = 0.0
    seg[2, :n] = sc["seg_arc"]
    buf = np.zeros(packed_input_size(spec), np.float32)
    pack_solver_input(
        spec, buf, params, sc["start_pose"], window, obs, len(sc["obs"]),
        seg[0], seg[1], seg[2], n, sc["seg_total"], sc["ref_total"],
        sc["active_points"],
    )
    return buf


def _same_winner_or_tie(name, out, ref, cost_col=1, index_col=2):
    """Rows must agree on found and cost; where the winning index agrees
    the whole row agrees too. A differing index with an equal cost is a
    tie broken by another summation order: counted, not failed."""
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_array_equal(out[:, 0] > 0.5, ref[:, 0] > 0.5,
                                  err_msg=f"{name}: found")
    found = ref[:, 0] > 0.5
    assert_close(f"{name} cost", out[found, cost_col], ref[found, cost_col])
    same = out[:, index_col] == ref[:, index_col]
    assert_close(f"{name} rows", out[same], ref[same])
    return int((~same & found).sum())


def phase_dwa(sz, dev, cpu, ph):
    from oracle.parity import compare_tick, run_oracle
    from kompass_core_tpu.ops.solver import (
        get_debug_dwa_solver, unpack_solver_output,
    )
    from kompass_core_tpu.parallel.fleet import make_fleet_solver

    with on(dev):
        spec = run_dwa_controller(sz, ph)
    rng = np.random.default_rng(11)
    scenarios = [make_scenario(rng, dict(sz, seg=spec.seg_size))
                 for _ in range(sz["batch"])]
    bufs = np.stack([pack_scenario(spec, sc) for sc in scenarios])
    with on(dev):
        fleet = make_fleet_solver(spec)
        dbufs = jax.device_put(bufs)
        out = np.asarray(fleet(dbufs))
        ph.steady[f"fleet solve b{sz['batch']}"] = steady_ms(
            lambda: fleet(dbufs), sz["reps"]
        )
        debug = get_debug_dwa_solver(spec)
        per_sample = [np.asarray(debug(bufs[i])[2])
                      for i in range(sz["oracle_robots"])]
    assert np.isfinite(out[:, 1][out[:, 0] > 0.5]).all()
    assert (out[:, 0] > 0.5).sum() >= sz["batch"] // 2, "few robots found"
    with on(cpu):
        ref = np.asarray(make_fleet_solver(spec)(bufs))
    ties = _same_winner_or_tie("fleet solve", out, ref)

    edges = 0
    for i in range(sz["oracle_robots"]):
        found, cost, best, _n, vx, vy, w, px, py = unpack_solver_output(
            spec, out[i]
        )
        res = SimpleNamespace(
            costs=per_sample[i], found=found, cost=cost, best_index=best,
            velocities=np.stack([vx, vy, w], axis=1),
            path=np.stack([px, py], axis=1),
        )
        tick = run_oracle(
            scenarios[i], sz["n_lin"], sz["n_ang"], spec.is_omni,
            spec.num_ctrl_points, spec.drop_samples,
        )
        edges += compare_tick(spec, scenarios[i], res, tick)
    ph.notes.append(
        f"{sz['oracle_robots']} robots = oracle ({edges} knife-edge slots),"
        f" {sz['batch']} = CPU ({ties} ties)"
    )
    return spec


# ---------------------------------------------------------------------------
# phase 2: DeviceFleet
# ---------------------------------------------------------------------------


def build_fleet(sz, n, mesh=None, peers=False):
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    robot, limits = _robot_and_limits()
    fleet = DeviceFleet(
        [robot] * n, limits, _dwa_config(sz), scan_rays=sz["rays"],
        path_capacity=1024, max_segments=16, mesh=mesh,
        peer_avoidance=peers, peer_prediction=peers,
    )
    fleet.set_paths([
        np.array([[1.0 * (i % 32), 2.0 * (i // 32)],
                  [1.0 * (i % 32) + 0.5, 2.0 * (i // 32) + 4.0]])
        for i in range(n)
    ])
    return fleet


def fleet_inputs(sz, n, seed=3):
    rng = np.random.default_rng(seed)
    states = np.zeros((n, 4), np.float32)
    states[:, 0] = 1.0 * (np.arange(n) % 32)
    states[:, 1] = 2.0 * (np.arange(n) // 32)
    states[:, 2] = np.pi / 2 + rng.uniform(-0.2, 0.2, n)
    vels = np.zeros((n, 3), np.float32)
    vels[:, 0] = rng.uniform(0.0, 0.8, n)
    ranges = rng.uniform(0.8, 9.0, (n, sz["rays"])).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, sz["rays"], endpoint=False)
    return states, vels, ranges, angles


def _fleet_rows(out):
    return np.stack(
        [out["found"].astype(np.float32), out["cost"], out["vx"],
         out["vy"], out["omega"]], axis=1,
    )


def compare_fleet(name, out, ref):
    """found equal, cost at rel 1e-4; commands equal at rel 1e-4 except
    on ties (equal cost, another sample won). Returns the tie count."""
    a, b = _fleet_rows(out), _fleet_rows(ref)
    np.testing.assert_array_equal(a[:, 0], b[:, 0], err_msg=f"{name}: found")
    f = b[:, 0] > 0.5
    assert_close(f"{name} cost", a[f, 1], b[f, 1])
    same = np.isclose(a[:, 2:], b[:, 2:], rtol=REL, atol=1e-5).all(axis=1)
    return int((~same & f).sum())


def phase_fleet(sz, dev, cpu, ph):
    n = sz["fleet"]
    states, vels, ranges, angles = fleet_inputs(sz, n)
    with on(dev):
        fleet = build_fleet(sz, n)
        first = fleet.tick(states, vels, ranges, angles)
        for _ in range(sz["fleet_ticks"] - 1):
            fleet.tick(states, vels, ranges, angles)
        args = fleet.tick_example_args()
        ph.steady[f"DeviceFleet.tick n={n}"] = steady_ms(
            lambda: fleet._tick_fn(*args), sz["reps"]
        )
        k = sz["device_ticks"]
        multi = fleet.run_ticks_on_device(k, states, vels, ranges, angles)
    assert first["found"].mean() > 0.5, "most robots found no command"
    assert multi["vx"].shape == (n, k)
    assert np.isfinite(multi["final_states"]).all()
    m = sz["fleet_slice"]
    with on(cpu):
        ref = build_fleet(sz, m).tick(states[:m], vels[:m], ranges[:m],
                                      angles)
    ties = compare_fleet(
        "fleet tick", {f: v[:m] for f, v in first.items()}, ref
    )
    ph.notes.append(f"{m}-robot slice = CPU ({ties} ties)")


# ---------------------------------------------------------------------------
# phase 3: mapper and safety
# ---------------------------------------------------------------------------


def _flips(a, b):
    return np.asarray(a) != np.asarray(b)


def _drifts(a, b):
    return ~np.isclose(np.asarray(a), np.asarray(b), rtol=REL, atol=1e-5)


def _nudge(r, toward, steps=4):
    for _ in range(steps):
        r = np.nextafter(r, np.float32(toward))
    return r


def tolerated_cells(cpu_fn, ranges, base, differ=_flips):
    """Cells whose CPU result changes when the inputs move by a few
    float32 ulp: every range up or down by four ulp, or the angle offset
    by +-5e-7 rad. Those are the cells that sit on a decision boundary
    (a range against a cell distance, a bearing against a bin edge),
    where sqrt, division and atan2 rounding — which differ between the
    backends by an ulp or two — may fall either way. A device/CPU
    difference is tolerated only there."""
    r = np.asarray(ranges, np.float32)
    out = np.zeros(np.shape(base), bool)
    for rr, off in ((_nudge(r, np.inf), 0.0), (_nudge(r, -np.inf), 0.0),
                    (r, 5e-7), (r, -5e-7)):
        out |= differ(cpu_fn(rr, off), base)
    return out


def phase_mapper(sz, dev, cpu, ph):
    from oracle.safety_impl import CriticalZoneOracle, cloud_to_scan
    from kompass_core_tpu.benchmark.device_loop import BAYES_BENCH_SCALARS
    from kompass_core_tpu.ops.critical_zone import (
        build_critical_zone, get_critical_zone_checker_cloud,
    )
    from kompass_core_tpu.ops.mapping import (
        MapperSpec, get_pointcloud_to_scan, get_scan_to_grid,
        get_scan_to_grid_bayesian,
    )

    G, B = sz["grid"], sz["bins"]
    spec = MapperSpec(grid_height=G, grid_width=G, num_bins=B,
                      resolution=0.05)
    rng = np.random.default_rng(5)
    ranges = rng.uniform(0.5, 9.9, B).astype(np.float32)
    to_grid = get_scan_to_grid(spec)
    bayes = get_scan_to_grid_bayesian(spec)
    scal = tuple(np.float32(v) for v in BAYES_BENCH_SCALARS)
    prev = np.full((G, G), 0.5, np.float32)

    def cpu_grid(r, off):
        with on(cpu):
            return np.asarray(to_grid(r, off))

    def cpu_bayes(r, off):
        with on(cpu):
            return [np.asarray(a) for a in bayes(r, prev, *scal, off)]

    # -- 400x400 grid from 3600 rays, plain and Bayesian
    with on(dev):
        dr = jax.device_put(ranges)
        grid = np.asarray(to_grid(dr, 0.0))
        occ_b, prob_b = (np.asarray(a) for a in bayes(dr, prev, *scal, 0.0))
        ph.steady["scan_to_grid"] = steady_ms(
            lambda: to_grid(dr, 0.0), sz["reps"])
        ph.steady["bayesian"] = steady_ms(
            lambda: bayes(dr, prev, *scal, 0.0), sz["reps"])
    ref = cpu_grid(ranges, 0.0)
    occ_c, prob_c = cpu_bayes(ranges, 0.0)
    checks = (
        ("scan_to_grid", grid, ref, cpu_grid, _flips),
        ("bayesian occupancy", occ_b, occ_c,
         lambda r, o: cpu_bayes(r, o)[0], _flips),
        ("bayesian probability", prob_b, prob_c,
         lambda r, o: cpu_bayes(r, o)[1], _drifts),
    )
    counts = []
    for name, got, want, cpu_fn, differ in checks:
        ok_cells = tolerated_cells(cpu_fn, ranges, want, differ)
        diff = differ(got, want)
        bad = diff & ~ok_cells
        assert not bad.any(), (
            f"{name}: {int(bad.sum())} cells differ from the CPU away from"
            f" a cell boundary (e.g. {np.argwhere(bad)[:3].tolist()})"
        )
        counts.append(f"{name} {int(diff.sum())}/{int(ok_cells.sum())}")
    ph.notes.append("cells differing/boundary: " + ", ".join(counts))

    # -- 100k-point cloud -> scan -> grid
    n = sz["cloud"]
    r = rng.uniform(0.5, 9.9, n)
    a = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-0.5, 0.5, n)],
                   axis=1).astype(np.float32)
    cloud_args = (np.float32(10.0), np.float32(-1.0), np.float32(1.0))
    to_scan = get_pointcloud_to_scan(B)
    cloud_grid = jax.jit(lambda p: to_grid(to_scan(p, *cloud_args)))
    with on(dev):
        dp = jax.device_put(pts)
        scan_d = np.asarray(to_scan(dp, *cloud_args))
        grid_d = np.asarray(cloud_grid(dp))
        ph.steady["cloud->scan"] = steady_ms(
            lambda: to_scan(dp, *cloud_args), sz["reps"])
        ph.steady["cloud->grid"] = steady_ms(
            lambda: cloud_grid(dp), sz["reps"])
    with on(cpu):
        scan_c = np.asarray(to_scan(pts, *cloud_args))
        grid_c = np.asarray(cloud_grid(pts))
    # a point within a few ulp of a bin edge may fall either side of it
    _, u = cloud_to_scan(pts, B, 10.0, -1.0, 1.0)
    ulp_u = np.spacing(np.float32(2 * np.pi) * u.astype(np.float32) / B)
    edge = np.abs(u - np.round(u)) < 8 * ulp_u * B / (2 * np.pi)
    amb = np.zeros(B, bool)
    amb[np.round(u[edge]).astype(int) % B] = True
    amb[(np.round(u[edge]).astype(int) - 1) % B] = True
    assert_close("cloud scan", scan_d[~amb], scan_c[~amb], rtol=1e-6,
                 atol=0.0)
    ok_cells = tolerated_cells(cpu_grid, scan_c, grid_c)
    ok_cells |= _flips(cpu_grid(scan_d, 0.0), grid_c)  # edge bins
    bad = _flips(grid_d, grid_c) & ~ok_cells
    assert not bad.any(), f"cloud grid: {int(bad.sum())} cells differ"
    ph.notes.append(
        f"cloud bins on an edge {int(amb.sum())}, cloud grid flips"
        f" {int(_flips(grid_d, grid_c).sum())}"
    )

    # -- critical zone on a 100k-point cloud, against the oracle
    angles = np.arange(0.0, 2 * np.pi, 2 * np.pi / B)
    cz = build_critical_zone("CYLINDER", [0.51, 1.0], (0, 0, 0),
                             (0, 0, 0, 1), 160.0, 0.3, 0.6, angles)
    check = get_critical_zone_checker_cloud(cz)
    r = rng.uniform(0.9, 9.9, n)
    a = rng.uniform(0, 2 * np.pi, n)
    cloud = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-0.4, 0.4, n)],
                     axis=1).astype(np.float32)
    cz_args = (np.float32(20.0), np.float32(-1.0), np.float32(1.0))
    zone = CriticalZoneOracle(cz.robot_radius, 0.0, 0.0, 0.0, 160.0, 0.3,
                              0.6, angles)
    host_ranges, _ = cloud_to_scan(cloud, B, 20.0, -1.0, 1.0)
    factors = []
    for forward in (True, False):
        with on(dev):
            dc = jax.device_put(cloud)
            f_d = float(check(dc, forward, *cz_args))
            if forward:
                ph.steady["critical zone"] = steady_ms(
                    lambda: check(dc, True, *cz_args), sz["reps"])
        with on(cpu):
            f_c = float(check(cloud, forward, *cz_args))
        f_o = zone.check(host_ranges, forward)
        assert abs(f_d - f_c) <= 1e-6, (forward, f_d, f_c)
        # float32 device vs float64 oracle on one distance ratio
        assert abs(f_d - f_o) <= 1e-4, (forward, f_d, f_o)
        factors.append(f_d)
    assert 0.0 < min(factors) < 1.0, f"trivial slowdown factors {factors}"
    ph.notes.append(f"critical zone factors {factors} = CPU = oracle")


# ---------------------------------------------------------------------------
# phase 4: standalone cost evaluator
# ---------------------------------------------------------------------------


def heavy_samples(S, T, dt=0.01, v1=1.0, max_fluct=0.5):
    """The reference's CostEvaluator_5k_Trajs samples (center path plus
    sinusoidal linear/angular fluctuation pairs), built where the call
    runs."""
    amp = max_fluct / max((S - 1) // 2, 1)
    i = jnp.arange(T, dtype=jnp.float32)
    fl = jnp.sin(2.0 * jnp.pi * i / T)
    k = jnp.arange(S)
    a = ((k + 1) // 2).astype(jnp.float32) * amp
    odd = (k % 2) == 1
    ang = (k % 2 == 0) & (k > 0)
    px = jnp.broadcast_to(dt * v1 * i, (S, T))
    py = jnp.where(odd[:, None], dt * (a[:, None] * fl[None, :]) * i[None, :],
                   0.0)
    vx = jnp.full((S, T - 1), v1, jnp.float32)
    vy = jnp.where(odd[:, None], a[:, None] * fl[None, :-1], 0.0)
    w = jnp.where(ang[:, None], a[:, None] * fl[None, :-1], 0.0)
    return px, py, jnp.stack([vx, vy, w], axis=-1)


def phase_costs(sz, dev, cpu, ph):
    from kompass_core_tpu.ops.solver import SolverParams, get_cost_evaluator

    S, T = sz["traj"], sz["traj_pts"]
    n_path = min(1001, T + 1)
    G = 1 << (n_path - 1).bit_length()
    s = 0.01 * np.arange(n_path, dtype=np.float32)
    seg = np.full((3, G), 1e8, np.float32)
    seg[0, :n_path], seg[1, :n_path] = s, 0.0
    seg[2] = 0.0
    seg[2, :n_path] = s
    params = SolverParams.create(
        time_step=0.01, robot_radius=0.3, collision_margin=0.05,
        weights={
            "reference_path_distance_weight": 1.0,
            "goal_distance_weight": 1.0,
            "obstacles_distance_weight": 0.0,
            "smoothness_weight": 1.0,
            "jerk_weight": 1.0,
        },
        acc_limits=(3.0, 3.0, 3.0), max_obstacles_dist=10.0 / 3,
    )
    obs = np.full((128, 2), 1e8, np.float32)
    ev = get_cost_evaluator(with_obstacles=False)
    build = jax.jit(heavy_samples, static_argnums=(0, 1))

    def run():
        px, py, vels = build(S, T)
        return ev(params, px, py, vels, obs, np.int32(0), seg[0], seg[1],
                  seg[2], np.int32(n_path), np.float32(s[-1]),
                  np.float32(s[-1]), np.int32(T))

    with on(dev):
        res = run()
        costs = np.asarray(res.costs)
        best = int(res.best_index)
        px, py, vels = build(S, T)
        ph.steady[f"evaluate_trajectory_costs {S}x{T}"] = steady_ms(
            lambda: ev(params, px, py, vels, obs, np.int32(0), seg[0],
                       seg[1], seg[2], np.int32(n_path), np.float32(s[-1]),
                       np.float32(s[-1]), np.int32(T)),
            sz["reps"],
        )
    with on(cpu):
        ref = run()
    assert costs.shape == (S,) and np.isfinite(costs).all()
    assert_close("trajectory costs", costs, ref.costs)
    assert best == int(ref.best_index) or np.isclose(
        costs[best], costs[int(ref.best_index)], rtol=REL
    )
    ph.notes.append(f"{S} costs = CPU, winner {best}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four_cards(sz, devs, ph):
    """The multi-card paths on ``devs`` (a 1-D mesh), each against the
    same program on ``devs[0]`` alone."""
    from jax.sharding import Mesh

    from __graft_entry__ import _scenario_buffer
    from kompass_core_tpu.ops.solver import _HDR, get_packed_dwa_solver
    from kompass_core_tpu.parallel.fleet import make_sample_parallel_solver
    from kompass_core_tpu.serving import LoadedArtifact, sharded_fleet_call
    from kompass_core_tpu.serving.export import _fleet_meta, _shape_specs

    nd = len(devs)
    mesh = Mesh(np.array(devs), axis_names=("robots",))
    one = devs[0]

    for n, peers in ((sz["fleet"], False), (sz["peer_fleet"], True)):
        states, vels, ranges, angles = fleet_inputs(sz, n)
        with on(one):
            ref = build_fleet(sz, n, peers=peers)
            ref_out = ref.tick(states, vels, ranges, angles)
        sharded = build_fleet(sz, n, mesh=mesh, peers=peers)
        out = sharded.tick(states, vels, ranges, angles)
        args = sharded.tick_example_args()
        ph.steady[f"mesh tick n={n}{' peers' if peers else ''}"] = (
            steady_ms(lambda: sharded._tick_fn(*args), sz["reps"])
        )
        ties = compare_fleet(f"mesh fleet n={n}", out, ref_out)
        assert out["found"].mean() > 0.5
        ph.notes.append(f"n={n}{' peers' if peers else ''} = 1 card"
                        f" ({ties} ties)")

    # sample-parallel: the omega axis striped across cards, cross-card
    # argmin, against the whole grid solved on one card
    from kompass_core_tpu.benchmark.baseline import baseline_solver_spec

    spec = baseline_solver_spec()
    base = _scenario_buffer(spec, 0)
    bufs = np.stack([base.copy() for _ in range(nd)])
    o = _HDR + 2 * spec.n_vx + 2 * spec.n_vy + spec.n_omega
    mask = base[o: o + spec.n_omega].copy()
    bufs[:, o: o + spec.n_omega] = 0.0
    for c in range(nd):
        bufs[c, o + c: o + spec.n_omega: nd] = mask[c::nd]
    sp = make_sample_parallel_solver(
        spec, Mesh(np.array(devs), axis_names=("sp",)), axis_name="sp"
    )
    sp_out = np.asarray(sp(bufs))
    with on(one):
        whole = np.asarray(get_packed_dwa_solver(spec)(base))
    # column 3 counts the admissible samples of the winning card's slice
    cols = np.r_[0:3, 4:whole.shape[0]]
    for c in range(nd):
        assert_close("sample-parallel", sp_out[c, cols], whole[cols])
    ph.notes.append("sample-parallel = 1 card")

    # a single-card fleet-tick artifact row-chunked across the cards. The
    # exported program is served from memory: writing it to a file needs
    # the optional `flatbuffers` package (the file round trip is
    # tests/test_serving_export.py's job)
    from jax import export as jax_export

    with on(one):
        shard = build_fleet(sz, 64)
        shard.set_scan_angles(fleet_inputs(sz, 1)[3])
        exported = jax_export.export(jax.jit(shard._tick_fn))(
            *(_shape_specs(a) for a in shard.tick_example_args())
        )
        art = LoadedArtifact(
            header={"kind": "fleet_tick", "meta": _fleet_meta(shard)},
            call=jax.jit(exported.call),
        )
        full = build_fleet(sz, 64 * nd)
        states, vels, ranges, angles = fleet_inputs(sz, 64 * nd)
        full._prepare_tick_inputs(states, vels, ranges, angles, None)
        args = full.tick_example_args()
        _carry, live = full._tick_fn(*args)
        live = np.asarray(live)
    _carry2, served = sharded_fleet_call(art, args, devs)
    assert_close("sharded_fleet_call", served, live)
    ph.notes.append(f"sharded_fleet_call {64 * nd} rows = 1 card")


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four GPUs")
    args = ap.parse_args(argv)

    card = card_line() if jax.devices()[0].platform == "gpu" else "no GPU"
    print(f"jax {jax.__version__} | {card}", flush=True)

    # phase 0: the default device must be a GPU
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"phase 0: default device is {dev.platform!r}, not a GPU")
    cpu = jax.devices("cpu")[0]
    sz = FULL

    if args.four_cards:
        devs = jax.devices()
        if len(devs) < 4:
            sys.exit(f"--four-cards needs 4 GPUs, found {len(devs)}")
        devs = devs[:4]
        with Phase("four cards", devs) as ph:
            phase_four_cards(sz, devs, ph)
    else:
        from kompass_core_tpu.benchmark.baseline import baseline_solver_spec

        with Phase("1 DWA", [dev]) as ph:
            spec = phase_dwa(sz, dev, cpu, ph)
            assert spec == baseline_solver_spec(), spec
        with Phase("2 fleet", [dev]) as ph:
            phase_fleet(sz, dev, cpu, ph)
        with Phase("3 mapper+safety", [dev]) as ph:
            phase_mapper(sz, dev, cpu, ph)
        with Phase("4 cost evaluator", [dev]) as ph:
            phase_costs(sz, dev, cpu, ph)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
