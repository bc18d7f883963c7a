"""Does unrolling the fleet tick's in-program 64-row block loop pay?

The fleet-v2 tick runs its robot axis as a ``lax.map`` over 64-row
blocks. ``lax.map`` lowers to a sequential XLA while-loop; each
iteration pays loop bookkeeping around the block body.
``lax.scan(unroll=u)`` amortizes that bookkeeping over u bodies at the
cost of an u-times-larger program — this measures whether it moves the
n=1024 flagship tick (16 blocks).

Same-session protocol: slope over distinct device-resident input
variants per unroll factor, unroll=1 re-measured last as the drift
control.

Run on the GPU: python -m kompass_core_tpu.benchmark.chunk_unroll_bench
"""

import json

import numpy as np


def _setup_fleet(n_robots=1024, scan_rays=512):
    from ..control import DWAConfig, TrajectoryCostsWeights
    from ..models import (
        AngularCtrlLimits,
        LinearCtrlLimits,
        Robot,
        RobotCtrlLimits,
        RobotGeometry,
        RobotType,
    )
    from ..parallel.fleet_v2 import DeviceFleet

    robots = [
        Robot(
            robot_type=RobotType.DIFFERENTIAL_DRIVE,
            geometry_type=RobotGeometry.Type.CYLINDER,
            geometry_params=np.array([0.3, 0.4]),
        )
        for _ in range(n_robots)
    ]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0,
                                   max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0,
                                       max_decel=3.0),
    )
    config = DWAConfig(
        max_linear_samples=45,
        max_angular_samples=44,
        prediction_horizon=30,
        control_horizon=6,
        control_time_step=0.1,
        max_point_interpolation_distance=0.01,
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
    fleet.set_paths([
        np.array([[0.1 * i, 0.0], [0.1 * i + 4.0, 0.5]])
        for i in range(n_robots)
    ])
    fleet.set_scan_angles(
        np.linspace(-np.pi, np.pi, scan_rays, endpoint=False)
    )
    return fleet


def main(n: int = 1024, rays: int = 512, unrolls=(1, 2, 4, 16)):
    import time

    import jax

    from ..ops import fleet_solver
    from ..utils.runtime import enable_persistent_compilation_cache
    from .runner import measure_throughput_slope, slope_variants_needed

    enable_persistent_compilation_cache()
    out = {}
    # unroll=1 re-measured LAST as the same-session drift control
    for tag, unroll in [
        (f"unroll_{u}", u) for u in unrolls
    ] + [("unroll_1_control", 1)]:
        fleet_solver._CHUNK_UNROLL = unroll
        try:
            t0 = time.time()
            fleet = _setup_fleet(n, rays)
            R = fleet._scan_rays
            rng = np.random.default_rng(7)
            variants = []
            for k in range(slope_variants_needed()):
                inp = np.zeros((fleet._n, 4 + 3 + R), np.float32)
                inp[:, 0] = 0.1 * np.arange(fleet._n) + 1e-4 * k
                inp[:, 7:] = rng.uniform(2.5, 9.0, (fleet._n, R))
                variants.append(jax.device_put(inp))
            for v in variants:
                # device-side scalar slice: np.asarray(v)[0, 0] would
                # copy each full ~2 MB buffer to the host
                float(np.asarray(v[0, 0]))  # force resident
            fleet._tick_fn(
                fleet._paths, fleet._cfg, fleet._carry, fleet._angles,
                variants[0],
            )
            compile_s = time.time() - t0

            def dispatch(v, _f=fleet):
                _, o = _f._tick_fn(
                    _f._paths, _f._cfg, _f._carry, _f._angles, v
                )
                return o

            r = measure_throughput_slope(
                tag, dispatch, variants,
                lambda o: float(np.asarray(o)[0, 5]),
            )
            out[tag] = {
                "ms_per_tick": r["mean_ms"],
                "us_per_robot": 1e3 * r["mean_ms"] / n,
                "compile_s": round(compile_s, 1),
            }
            print(tag, round(r["mean_ms"], 2), "ms/tick",
                  round(1e3 * r["mean_ms"] / n, 1), "us/robot", flush=True)
        finally:
            fleet_solver._CHUNK_UNROLL = 1
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
