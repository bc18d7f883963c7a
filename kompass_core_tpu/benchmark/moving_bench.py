"""Device cost of moving-obstacle prediction.

Slope-times the batch-64 packed solver at BASELINE shapes (2025 samples
x 30 steps, 512-ray scan) with ``moving_obstacles`` off and on
(distinct device-resident input per dispatch, slope of 10->40 chained
batches, static control re-measured last to catch drift within the run).

Expectation from the op count: the moving sweep adds 2 FMAs to the ~6
f32 ops per (pose, obstacle) pair on the obstacle axis only (512 of the
1024 padded sweep columns). The segment sweep and everything else is
unchanged.

Run on the GPU: python -m kompass_core_tpu.benchmark.moving_bench
"""

import dataclasses
import json
import time

import numpy as np


def _scenario_buffer(spec, robot_index=0, rng=None):
    """BASELINE-shaped packed scenario. Sibling builders exist in
    ``bench.build_scenario``, ``__graft_entry__._scenario_buffer`` and
    ``runner._dwa_workload`` with deliberately different segment/scan
    content: each harness publishes DELTAS against its own control
    measured in the same session, so only the spec SHAPES must agree
    (asserted against packed_input_size below) — not the buffer bytes.
    Do not 'unify' them into one builder: that would change every
    compiled workload and orphan the committed artifacts."""
    from ..models import (
        AngularCtrlLimits, LinearCtrlLimits, RobotCtrlLimits,
    )
    from ..ops.solver import pack_solver_input, packed_input_size
    from ..ops.window import sample_velocity_window

    rng = rng or np.random.default_rng(robot_index)
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0,
                                       max_decel=3.0),
    ).to_array()
    limits[3:6] = 0.0
    dt = 0.1
    n_seg = min(301, spec.seg_size)
    s = 0.01 * np.arange(n_seg, dtype=np.float32)
    seg_x = np.full(spec.seg_size, 1e8, np.float32)
    seg_y = np.full(spec.seg_size, 1e8, np.float32)
    seg_arc = np.zeros(spec.seg_size, np.float32)
    seg_x[:n_seg] = s
    seg_y[:n_seg] = 0.0
    seg_arc[:n_seg] = s
    n_rays = spec.scan_size
    ranges = rng.uniform(2.0, 9.0, n_rays)
    angles = np.linspace(-np.pi, np.pi, n_rays, endpoint=False)
    obs = np.stack(
        [ranges * np.cos(angles), ranges * np.sin(angles)], axis=1
    ).astype(np.float32)
    window = sample_velocity_window(
        (0.5, 0.0, 0.0), limits, dt, spec.n_vx, spec.n_vy, spec.n_omega,
        spec.is_omni,
    )
    params = np.array(
        [dt, 0.3, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10.0 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec), np.float32)
    kw = {}
    if spec.moving_obstacles:
        # pedestrian-speed tracks on every obstacle point (cost is
        # data-independent; realistic magnitudes keep the run honest)
        kw["obs_vel_xy"] = rng.uniform(-1.5, 1.5, (n_rays, 2)).astype(
            np.float32
        )
    pack_solver_input(
        spec, buf,
        params_vec=params,
        state=(0.1 * robot_index, 0.0, 0.0),
        window=window, obs_xy=obs, obs_count=n_rays,
        seg_x=seg_x, seg_y=seg_y, seg_arc=seg_arc, seg_count=n_seg,
        seg_total_len=float(s[-1]), ref_total_len=10.0,
        active_points=spec.max_points, **kw,
    )
    return buf


def _measure(spec, label, B=64, value_shift=0.0):
    """``value_shift`` offsets every variant's robot x-state so a control
    re-measure never replays byte-identical (executable, input) pairs —
    the cache-deflation mode the strict protocol forbids."""
    import jax

    from ..parallel.fleet import make_fleet_solver

    rng = np.random.default_rng(7)
    solver = make_fleet_solver(spec)
    base = np.stack(
        [_scenario_buffer(spec, i, rng) for i in range(B)]
    )
    n_variants = 1 + 5 + 10 + 40
    variants = []
    for k in range(n_variants):
        v = base.copy()
        v[:, 0] += np.float32(value_shift) + 1e-4 * k  # distinct states
        variants.append(jax.device_put(v))
    for v in variants:
        float(np.asarray(v[0, 0]))  # force resident
    vit = iter(variants)
    t0 = time.time()
    out = solver(next(vit))
    float(np.asarray(out[0, 1]))
    compile_s = time.time() - t0
    print(f"{label}: first call {compile_s:.1f} s", flush=True)

    def chain(n):
        vs = [next(vit) for _ in range(n)]
        t0 = time.time()
        outs = [solver(v) for v in vs]
        float(np.asarray(outs[-1][0, 1]))
        return time.time() - t0

    chain(5)
    t10, t40 = chain(10), chain(40)
    per_batch_ms = max((t40 - t10) / 30, 1e-9) * 1e3
    print(
        f"{label}: {per_batch_ms:.2f} ms/batch64 "
        f"({per_batch_ms / B * 1e3:.1f} us/solve)",
        flush=True,
    )
    return {"ms_per_batch64": per_batch_ms,
            "us_per_solve": per_batch_ms / B * 1e3,
            "compile_s": compile_s}


def fleet_main(n: int = 64, rays: int = 512, tracked: int = 8):
    """Measured cost of the TRACKED fleet tick at BASELINE shapes.

    At 512 rays the scan bucket grows 512 -> 768 (rays + M rounded to
    256) and the sweep's pow2 pad goes 512 -> 1024, so unlike the
    packed path (velocities ride existing rows) the fleet form pays
    sweep-width growth. This measures it instead of guessing.
    """
    from ..control import DWAConfig, TrajectoryCostsWeights
    from ..models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from ..parallel.fleet_v2 import DeviceFleet
    from ..utils.runtime import enable_persistent_compilation_cache
    from .runner import measure_throughput_slope, slope_variants_needed

    enable_persistent_compilation_cache()
    out = {}
    # (slots, split): plain control, tail-slot form (scan bucket grows
    # rays -> rays+M, crossing a pow2 boundary at 512), and the split
    # form (bucket stays at rays; movers in a narrow separate moving
    # sweep — bit-identical outputs, see tests/test_fleet_moving.py
    # split cases).
    for m_slots, split in ((0, False), (tracked, False), (tracked, True)):
        robots = [
            Robot(
                robot_type=RobotType.DIFFERENTIAL_DRIVE,
                geometry_type=RobotGeometry.Type.CYLINDER,
                geometry_params=np.array([0.3, 0.4]),
            )
            for _ in range(n)
        ]
        limits = RobotCtrlLimits(
            vx_limits=LinearCtrlLimits(
                max_vel=1.0, max_acc=5.0, max_decel=10.0
            ),
            omega_limits=AngularCtrlLimits(
                max_vel=4.0, max_acc=3.0, max_decel=3.0, max_steer=np.pi
            ),
        )
        config = DWAConfig(
            max_linear_samples=45,
            max_angular_samples=45,
            costs_weights=TrajectoryCostsWeights(
                reference_path_distance_weight=3.0,
                goal_distance_weight=1.0,
                smoothness_weight=1.0,
                jerk_weight=1.0,
                obstacles_distance_weight=2.0,
            ),
            prediction_horizon=30,
            control_horizon=2,
            control_time_step=0.1,
        )
        fleet = DeviceFleet(
            robots, limits, config, scan_rays=rays, path_capacity=512,
            max_segments=16, tracked_obstacles=m_slots,
            split_mover_sweep=split,
        )
        paths, states = [], []
        for i in range(n):
            x0 = 2.0 * i
            paths.append(np.array([[x0, 0.0], [x0, 5.0]]))
            states.append([x0, 0.0, np.pi / 2, 0.0])
        fleet.set_paths(paths)
        states = np.array(states, np.float32)
        angles = np.linspace(0, 2 * np.pi, rays, endpoint=False)
        rng = np.random.default_rng(0)
        variants = [
            states
            + np.float32(1e-4)
            * rng.standard_normal(states.shape).astype(np.float32)
            for _ in range(slope_variants_needed())
        ]
        vels = np.zeros((n, 3), np.float32)
        ranges = np.full((n, rays), 10.0, np.float32)
        if m_slots:
            trk = [
                np.array(
                    [[2.0 * i + 1.0, 2.0, 0.0, -0.5]], np.float32
                )
                for i in range(n)
            ]
            dispatch = lambda s: fleet.tick(  # noqa: E731
                s, vels, ranges, angles, tracked=trk
            )
        else:
            dispatch = lambda s: fleet.tick(s, vels, ranges, angles)  # noqa: E731
        name = f"fleet{n}_tracked_{m_slots}" + ("_split" if split else "")
        r = measure_throughput_slope(
            name, dispatch, variants, lambda o: float(o["cost"][0]),
        )
        out[name] = {
            "ms_per_tick": r["mean_ms"],
            "us_per_robot": 1e3 * r["mean_ms"] / n,
        }
        print(name, round(r["mean_ms"], 3), "ms/tick", flush=True)
    print(json.dumps(out))
    return out


def main():
    from ..utils.runtime import enable_persistent_compilation_cache
    from .baseline import baseline_solver_spec

    enable_persistent_compilation_cache()
    spec = baseline_solver_spec()
    m_spec = dataclasses.replace(spec, moving_obstacles=True)
    out = {
        "workload": "BASELINE 2025x30, 512-ray scan, batch 64, slope 10->40",
        "static": _measure(spec, "static"),
        "moving": _measure(m_spec, "moving"),
        # same-session drift control: static again, last, with shifted
        # input values (never byte-identical to the first static run)
        "static_control": _measure(spec, "static_control",
                                   value_shift=0.05),
    }
    # conservative ratio: divide by the SMALLER static estimate — the
    # control detects drift, it must not shrink the reported overhead
    out["moving_over_static"] = (
        out["moving"]["us_per_solve"]
        / min(out["static"]["us_per_solve"],
              out["static_control"]["us_per_solve"])
    )
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import sys

    if "--fleet" in sys.argv:
        fleet_main()
    else:
        main()
