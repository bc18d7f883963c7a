#!/usr/bin/env python
"""Benchmark: DWA control solves/s per chip at the BASELINE workload.

Workload (BASELINE.json): DWA with ~2000 velocity samples, 30-step horizon,
full cost-weight set, 512-ray laserscan. Measures:

  * sustained throughput in the fleet configuration (batch of independent
    robot scenarios resident on device, one dispatch per fleet tick) —
    the production serving mode and the headline metric;
  * the fully-device-resident DeviceFleet (v2) runtime: per-robot cost at
    N in {64, 256, 1024} (whole follower pipeline on device);
  * steady-state closed-loop compute latency (n=1 DeviceFleet, carry
    chained on device) vs the 10 ms / 100 Hz control budget;
  * single-solve round-trip latency through the packed one-buffer
    interface (includes host<->device transfer);
  * the dominant sweep computation's share of the card's f32 peak
    (``benchmark/device.PEAKS`` by device kind).

Every result names the device and, on a GPU, the card's name and power
limit as nvidia-smi reports them. Outside smoke mode it runs only on a
GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "solves/s", "vs_baseline": N/100}
(vs_baseline: BASELINE.json north-star is >100 solves/s/chip.)

Optional: KOMPASS_BENCH_TRACE=1 captures a jax.profiler trace of the
fleet solve into ./profile_trace/.
"""

import json
import os
import sys
import time

import numpy as np

from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    RobotCtrlLimits,
)
from kompass_core_tpu.ops.solver import (
    get_packed_dwa_solver,
    pack_solver_input,
    packed_input_size,
    unpack_solver_output,
)
from kompass_core_tpu.ops.window import sample_velocity_window
from kompass_core_tpu.parallel.fleet import make_fleet_solver
from kompass_core_tpu.utils.runtime import enable_persistent_compilation_cache


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# KOMPASS_BENCH_SMOKE=1 shrinks every workload so the bench harness can
# run end-to-end on a CPU-only CI runner in ~a minute. The numbers are
# meaningless as throughput; the point is exercising the exact dispatch /
# measurement / JSON-emit code paths that run on real hardware.
SMOKE = bool(os.environ.get("KOMPASS_BENCH_SMOKE"))


def build_spec():
    # single source of truth: kompass_core_tpu/benchmark/baseline.py
    from kompass_core_tpu.benchmark.baseline import baseline_solver_spec

    if SMOKE:
        from kompass_core_tpu.ops.solver import SolverSpec

        return SolverSpec(
            is_omni=False, n_vx=5, n_vy=1, n_omega=5, max_points=10,
            num_ctrl_points=2, scan_size=64, seg_size=64,
            drop_samples=True,
        )
    return baseline_solver_spec()


def build_scenario(spec, rng, robot_index=0):
    """One realistic robot scenario: curved tracked segment, cluttered scan."""
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
    ).to_array()
    limits[3:6] = 0.0

    dt = 0.1
    x0 = 0.1 * robot_index
    yaw0 = 0.05 * robot_index

    # tracked segment: gentle arc ahead of the robot, up to 3 m @ 1 cm
    n_seg = min(301, spec.seg_size)
    s = 0.01 * np.arange(n_seg, dtype=np.float32)
    curv = 0.2
    seg_x = np.full(spec.seg_size, 1e8, np.float32)
    seg_y = np.full(spec.seg_size, 1e8, np.float32)
    seg_arc = np.zeros(spec.seg_size, np.float32)
    seg_x[:n_seg] = x0 + s * np.cos(yaw0)
    seg_y[:n_seg] = s * np.sin(yaw0) + 0.5 * curv * s**2
    seg_arc[:n_seg] = s

    # 512-ray scan: obstacles scattered at 2.5-9 m
    n_rays = spec.scan_size
    ranges = rng.uniform(2.5, 9.0, n_rays)
    angles = np.linspace(-np.pi, np.pi, n_rays, endpoint=False)
    ox = ranges * np.cos(angles + yaw0) + x0
    oy = ranges * np.sin(angles + yaw0)
    obs = np.stack([ox, oy], axis=1).astype(np.float32)

    vel = (0.5, 0.0, 0.1)
    window = sample_velocity_window(
        vel, limits, dt, spec.n_vx, spec.n_vy, spec.n_omega, spec.is_omni
    )
    params = np.array(
        [dt, 0.3, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10.0 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    pack_solver_input(
        spec,
        buf,
        params_vec=params,
        state=(x0, 0.0, yaw0),
        window=window,
        obs_xy=obs,
        obs_count=n_rays,
        seg_x=seg_x,
        seg_y=seg_y,
        seg_arc=seg_arc,
        seg_count=n_seg,
        seg_total_len=float(s[-1]),
        ref_total_len=10.0,
        active_points=spec.max_points,
    )
    return buf


def _fleet_v2_setup(n_robots, scan_rays=None):
    """BASELINE-workload DeviceFleet: 45x45 grid, 30-step horizon."""
    if scan_rays is None:
        scan_rays = 64 if SMOKE else 512
    from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu.models import (
        Robot,
        RobotGeometry,
        RobotType,
    )
    from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet

    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.3, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0),
    )
    config = DWAConfig(
        max_linear_samples=5 if SMOKE else 45,
        max_angular_samples=4 if SMOKE else 44,  # bumped odd -> 45x45 = 2025
        prediction_horizon=10 if SMOKE else 30,
        control_horizon=2 if SMOKE else 6,
        control_time_step=0.1,
        max_point_interpolation_distance=0.05 if SMOKE else 0.01,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=2.0,
            goal_distance_weight=1.0,
            obstacles_distance_weight=1.0,
            smoothness_weight=0.1,
            jerk_weight=0.05,
        ),
    )
    fleet = DeviceFleet(
        robots, limits, config, scan_rays=scan_rays, path_capacity=1024,
        max_segments=16,
    )
    paths = []
    for i in range(n_robots):
        x0 = 0.1 * i
        paths.append(np.array([[x0, 0.0], [x0 + 4.0, 0.5]]))
    fleet.set_paths(paths)
    angles = np.linspace(-np.pi, np.pi, scan_rays, endpoint=False)
    fleet.set_scan_angles(angles)
    return fleet


def bench_device_fleet_v2(log, sizes=(64, 256, 1024)):
    """Slope-timed per-robot cost of the fully device-resident runtime."""
    import jax

    out = {}
    rng = np.random.default_rng(1)
    for n in sizes:
        fleet = _fleet_v2_setup(n)
        R = fleet._scan_rays
        # one distinct input per dispatch across warmup + both timed
        # chains (4 + 8 + 24)
        n_variants = 1 + 4 + 8 + 24  # compile + warm + lo + hi chains
        variants = []
        for k in range(n_variants):
            inp = np.zeros((fleet._n, 4 + 3 + R), np.float32)
            inp[:, 0] = 0.1 * np.arange(fleet._n) + 1e-4 * k
            inp[:, 2] = 0.05
            inp[:, 4] = 0.5
            inp[:, 7:] = rng.uniform(2.5, 9.0, (fleet._n, R))
            variants.append(jax.device_put(inp))
        for v in variants:
            float(np.asarray(v[0, 0]))
        next_variant = iter(range(n_variants))
        t0 = time.time()
        # the compile dispatch consumes the iterator's first variant
        fleet._tick_fn(fleet._paths, fleet._cfg, fleet._carry,
                       fleet._angles, variants[next(next_variant)])
        log(
            f"fleet_v2 n={n} (in-program chunks of "
            f"{fleet._chunk or fleet._n}): compile {time.time()-t0:.1f}s"
        )

        def chain(m):
            t0 = time.time()
            o = None
            for _ in range(m):
                v = variants[next(next_variant)]
                _, o = fleet._tick_fn(
                    fleet._paths, fleet._cfg, fleet._carry, fleet._angles,
                    v,
                )
            float(np.asarray(o[0, 2]))
            return time.time() - t0

        chain(4)
        t_lo, t_hi = chain(8), chain(24)
        per_tick = max((t_hi - t_lo) / 16, 1e-9)
        us_robot = per_tick / n * 1e6
        out[str(n)] = round(us_robot, 1)
        log(
            f"fleet_v2 n={n}: {per_tick*1e3:.2f} ms/tick, "
            f"{us_robot:.1f} us/robot, {n/per_tick:,.0f} solves/s"
        )
    return out


def bench_closed_loop_latency(log, ticks_per_chain=50, chains=20):
    """Steady-state closed-loop COMPUTE latency: n=1 DeviceFleet, the
    follower carry chained tick-to-tick on device (the deployment shape
    where state stays device-resident). Answers the 100 Hz question with
    data: p50/p99 per-tick compute time vs the 10 ms budget. The separate
    single-solve round-trip number adds the host<->device transfers."""
    import jax

    fleet = _fleet_v2_setup(1)
    R = fleet._scan_rays
    rng = np.random.default_rng(2)
    variants = []
    for k in range(65):  # 64 chain variants + a dedicated compile variant
        inp = np.zeros((1, 4 + 3 + R), np.float32)
        inp[:, 0] = 1e-4 * k
        inp[:, 4] = 0.5
        inp[:, 7:] = rng.uniform(2.5, 9.0, (1, R))
        variants.append(jax.device_put(inp))
    for v in variants:
        float(np.asarray(v[0, 0]))
    paths, cfg, ang = fleet._paths, fleet._cfg, fleet._angles
    carry0 = fleet._carry
    t0 = time.time()
    # dedicated compile variant, never reused by a timed chain
    fleet._tick_fn(paths, cfg, carry0, ang, variants[64])
    log(f"closed-loop: compile {time.time()-t0:.1f}s")

    def chain(m, salt):
        # each chain gets its own input rotation, so every (input,
        # carry) pair is distinct across chains
        carry = carry0
        t0 = time.time()
        o = None
        for k in range(m):
            carry, o = fleet._tick_fn(
                paths, cfg, carry, ang,
                variants[(salt * 13 + k) % 64],
            )
        float(np.asarray(o[0, 2]))
        return time.time() - t0

    chain(10, 61)  # warm
    base = chain(5, 62)  # dispatch+fetch floor of a short chain
    times = np.array(
        [chain(ticks_per_chain + 5, c) for c in range(chains)]
    )
    per_tick_ms = (times - base) / ticks_per_chain * 1e3
    p50, p99 = np.percentile(per_tick_ms, [50, 99])
    log(
        f"closed-loop compute latency (n=1, device-resident carry): "
        f"p50={p50:.3f} ms p99={p99:.3f} ms per tick "
        f"(100 Hz budget: 10 ms)"
    )
    return {"p50_ms": round(float(p50), 3), "p99_ms": round(float(p99), 3)}


def main():
    import jax

    from kompass_core_tpu.benchmark.device import (
        parse_gpu_query,
        peaks_for,
        query_gpus,
    )

    enable_persistent_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not SMOKE:
        sys.exit(f"bench.py measures a GPU; the default device is {dev}")
    card = parse_gpu_query(query_gpus())[0] if dev.platform == "gpu" else {}
    log(f"device: {dev} {card}")
    spec = build_spec()
    rng = np.random.default_rng(0)

    # ---- single-solve latency (packed round trip) ----
    solver = get_packed_dwa_solver(spec)
    buf = build_scenario(spec, rng)
    t0 = time.time()
    out = np.asarray(solver(buf))
    log(f"first solve (compile): {time.time() - t0:.1f} s")
    found, cost, _b, n_adm, *_ = unpack_solver_output(spec, out)
    log(f"sanity: found={found} cost={cost:.4f} admissible={n_adm}")
    lat = []
    for k in range(5 if SMOKE else 30):
        v = buf.copy()
        v[0] += 1e-4 * (k + 1)  # distinct input per dispatch
        t0 = time.time()
        np.asarray(solver(v))
        lat.append(time.time() - t0)
    lat = np.array(lat) * 1000
    p50, p99 = np.percentile(lat, [50, 99])
    log(f"single-solve round-trip: p50={p50:.2f} ms p99={p99:.2f} ms")

    # ---- fleet throughput (device-resident batch) ----
    # the marginal time per batch over growing chains of distinct
    # device-resident inputs, completion forced by a value fetch from
    # the final output
    B = 8 if SMOKE else 64
    fleet_solver = make_fleet_solver(spec)
    base = np.stack([build_scenario(spec, rng, i) for i in range(B)])
    # one distinct input per dispatch across compile + warm + both timed
    # chains (1 + 5 + 10 + 40)
    n_variants = 1 + 5 + 10 + 40
    variants = []
    for k in range(n_variants):
        v = base.copy()
        v[:, 0] += 1e-4 * k  # distinct robot states per dispatch
        variants.append(jax.device_put(v))
    for v in variants:  # force resident so transfers don't land in the chain
        float(np.asarray(v[0, 0]))
    vit = iter(variants)
    t0 = time.time()
    fleet_out = fleet_solver(next(vit))
    rows = np.asarray(fleet_out[:4])
    log(f"fleet first call (compile): {time.time() - t0:.1f} s")
    for i, row in enumerate(rows):
        f, c, _b, n_adm, *_ = unpack_solver_output(spec, row)
        log(f"  robot {i}: found={f} cost={c:.4f} admissible={n_adm}")

    def chain(n):
        vs = [next(vit) for _ in range(n)]
        t0 = time.time()
        outs = [fleet_solver(v) for v in vs]
        float(np.asarray(outs[-1][0, 1]))  # force completion of the chain
        return time.time() - t0

    chain(5)  # warm queue
    t10, t40 = chain(10), chain(40)
    per_batch = max((t40 - t10) / 30, 1e-9)
    solves_per_s = B / per_batch
    per_solve_us = per_batch / B * 1e6
    log(
        f"fleet throughput: {solves_per_s:,.0f} solves/s "
        f"({per_solve_us:.1f} us/solve, batch={B}, slope of 10->40 chained "
        f"distinct batches)"
    )

    # ---- the two min-distance sweeps against the card's f32 peak:
    # ~6 f32 ops per (point, obstacle) pair after XLA's fusion; sweep
    # minor axes are pow2-padded by the solver
    def _pow2(n):
        return max(128, 1 << (n - 1).bit_length())

    pairs_per_batch = (
        B * spec.num_samples * spec.max_points
        * (_pow2(spec.scan_size) + _pow2(spec.seg_size))
    )
    sweep_ops_per_s = 6.0 * pairs_per_batch / per_batch
    f32_share = (
        None if SMOKE
        else sweep_ops_per_s / peaks_for(dev.device_kind)["f32_flops"]
    )
    log(
        f"sweeps: {pairs_per_batch/per_batch/1e9:.1f} Gpairs/s, "
        f"~{sweep_ops_per_s/1e12:.2f} Tops/s"
        + ("" if f32_share is None else
           f", {100*f32_share:.1f}% of the f32 peak")
    )

    if os.environ.get("KOMPASS_BENCH_TRACE"):
        trace_dir = os.path.join(os.getcwd(), "profile_trace")
        log(f"capturing jax.profiler trace -> {trace_dir}")
        try:
            with jax.profiler.trace(trace_dir):
                for k in range(4):
                    out = fleet_solver(variants[k])
                float(np.asarray(out[0, 1]))
            log("trace captured")
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            log(f"trace capture failed: {e}")

    # ---- DeviceFleet v2 (whole follower pipeline on device) ----
    v2 = bench_device_fleet_v2(log, sizes=(8,) if SMOKE else (64, 256, 1024))

    # ---- steady-state closed-loop compute latency (100 Hz question) ----
    loop = bench_closed_loop_latency(
        log, **({"ticks_per_chain": 10, "chains": 3} if SMOKE else {})
    )

    # headline: best sustained solves/s across serving configurations —
    # the device-resident DeviceFleet (v2) at its best size when it beats
    # the v1 packed path
    configs = {"v1_batch64": solves_per_s}
    for n, us in v2.items():
        configs[f"v2_n{n}"] = 1e6 / us if us > 0 else 0.0
    best_cfg = max(configs, key=configs.get)
    best_sps = configs[best_cfg]
    log(f"headline: {best_cfg} at {best_sps:,.0f} solves/s")

    print(
        json.dumps(
            {
                "metric": (
                    "dwa_solves_per_s_SMOKE_5x5x10"
                    if SMOKE
                    else "dwa_solves_per_s_per_chip_2025x30"
                ),
                "value": round(best_sps, 1),
                "unit": "solves/s",
                "vs_baseline": None if SMOKE else round(best_sps / 100.0, 2),
                "config": best_cfg,
                "extra": {
                    "single_solve_p50_ms": round(float(p50), 2),
                    "single_solve_p99_ms": round(float(p99), 2),
                    "batch": B,
                    "samples": spec.num_samples,
                    "horizon_steps": spec.max_points,
                    "scan_rays": spec.scan_size,
                    "v1_batch64_solves_per_s": round(solves_per_s, 1),
                    "sweep_gpairs_per_s": round(
                        pairs_per_batch / per_batch / 1e9, 1
                    ),
                    "sweep_f32_peak_share": f32_share,
                    "fleet_v2_us_per_robot": v2,
                    "closed_loop_compute_ms": loop,
                    "device": {
                        "platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices()),
                    },
                    "card": card,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
