"""Roofline floors for the named reference workloads.

Each function turns a measured time into ``pct_of_roofline``: the least
time the card could take for the work the implementation must do (the
larger of its compute floor and its memory floor, from array shapes)
over the measured time. Peak rates come from ``device.peaks_for`` by
``jax.Device.device_kind``; a kind with no entry is an error.

Operation counts:

* sweeps (cost evaluator, DWA): 6 f32 ops per (point, obstacle) pair —
  sub, sub, mul, mul, add, min — on the CUDA cores;
* mapper lookup: the one-hot x tables dot, 2*N*B*35 bf16 FLOP on the
  tensor cores, plus one compare per (cell, bin) to build the one-hot;
* bin-min: 3 f32 ops per (point, bin) pair for the dense form.
"""

from __future__ import annotations

from .device import peaks_for


def cost_evaluator_5k(measured_ms: float, peaks: dict) -> dict:
    """CostEvaluator_5k_Trajs (benchmark_runner.cpp:150-185): 5001 GIVEN
    trajectories x 1000 points, 4 costs, straight 10 m path @ 1 cm
    (segment padded to 1024). The path-cost sweep dominates; every other
    term is O(S*T)."""
    S, T, G = 5001, 1000, 1024
    sweep_ops = 6.0 * S * T * G
    compute_floor_s = sweep_ops / peaks["f32_flops"]
    # px, py [S, T] f32 read once; [S] costs out
    bytes_moved = 2 * S * T * 4 + S * 4
    memory_floor_s = bytes_moved / peaks["hbm_bytes"]
    floor_s = max(compute_floor_s, memory_floor_s)
    return {
        "name": "CostEvaluator_5k_Trajs",
        "measured_ms": measured_ms,
        "bound": "f32 (path-cost sweep, 5.12e9 point-segment pairs)",
        "sweep_ops": sweep_ops,
        "compute_floor_ms": compute_floor_s * 1e3,
        "memory_floor_ms": memory_floor_s * 1e3,
        "pct_of_roofline": 100 * floor_s / (measured_ms * 1e-3),
    }


def _mapper_floors(peaks: dict) -> dict:
    N, B, COLS = 400 * 400, 3600, 35  # 7 split tables x 5 candidates
    matmul_flops = 2.0 * N * B * COLS
    bytes_moved = (B * COLS * 4) + (N * 4) + (N * 5 * 4 * 4) + (N * 4)
    return {
        "matmul_flops": matmul_flops,
        "compute_floor_ms": 1e3 * matmul_flops / peaks["bf16_flops"],
        "onehot_floor_ms": 1e3 * (N * B) / peaks["f32_flops"],
        "memory_floor_ms": 1e3 * bytes_moved / peaks["hbm_bytes"],
    }


def _floor_ms(f: dict) -> float:
    return max(f["compute_floor_ms"], f["onehot_floor_ms"],
               f["memory_floor_ms"])


def mapper_dense(measured_ms: float, peaks: dict) -> dict:
    """Mapper_Dense_400x400 (benchmark_runner.cpp:187-218): 3600-ray scan
    -> 400x400 grid @ 0.05 m, floored by the one-hot lookup forms of
    ``ops/mapping._candidate_lookup``."""
    f = _mapper_floors(peaks)
    return {
        "name": "Mapper_Dense_400x400",
        "measured_ms": measured_ms,
        "bound": "one-hot lookup: N*B compares + 4e10 bf16 FLOP",
        **f,
        "pct_of_roofline": 100 * _floor_ms(f) / measured_ms,
    }


def mapper_bayesian(measured_ms: float, peaks: dict) -> dict:
    """Mapper_Bayesian_400x400: the Dense lookup plus an elementwise
    inverse-sensor-model update (~20 f32 ops per cell, negligible)."""
    f = _mapper_floors(peaks)
    return {
        "name": "Mapper_Bayesian_400x400",
        "measured_ms": measured_ms,
        "bound": "as Mapper_Dense_400x400",
        **f,
        "pct_of_roofline": 100 * _floor_ms(f) / measured_ms,
    }


def _bin_min_floor_ms(n_points: int, num_bins: int, peaks: dict) -> float:
    """Dense per-bin min: eq-compare + select + min per (point, bin)."""
    return 1e3 * (3.0 * n_points * num_bins) / peaks["f32_flops"]


def critical_zone_100k(measured_ms: float, peaks: dict) -> dict:
    """CriticalZone_100k_Cloud (benchmark_runner.cpp:267-311): 100k-point
    cloud -> 3600-bin min ranges -> masked slowdown-factor min."""
    N, B = 100_000, 3600
    binning_floor_ms = _bin_min_floor_ms(N, B, peaks)
    memory_floor_ms = 1e3 * (N * 3 * 4 + B * 4) / peaks["hbm_bytes"]
    return {
        "name": "CriticalZone_100k_Cloud",
        "measured_ms": measured_ms,
        "bound": "f32 (dense per-bin min, 3.6e8 point-bin pairs)",
        "binning_floor_ms": binning_floor_ms,
        "memory_floor_ms": memory_floor_ms,
        "pct_of_roofline": (
            100 * max(binning_floor_ms, memory_floor_ms) / measured_ms
        ),
    }


def mapper_pointcloud(measured_ms: float, peaks: dict) -> dict:
    """Mapper_PointCloud_100k (benchmark_runner.cpp:227-265): 100k cloud
    -> 3600-bin scan -> Mapper_Dense grid update; the stages are
    sequential, so their floors add."""
    binning_floor_ms = _bin_min_floor_ms(100_000, 3600, peaks)
    grid_floor_ms = _floor_ms(_mapper_floors(peaks))
    return {
        "name": "Mapper_PointCloud_100k",
        "measured_ms": measured_ms,
        "bound": "bin-min + Mapper_Dense lookup, sequential stages",
        "binning_floor_ms": binning_floor_ms,
        "grid_stage_floor_ms": grid_floor_ms,
        "pct_of_roofline": (
            100 * (binning_floor_ms + grid_floor_ms) / measured_ms
        ),
    }


def critical_zone_dense(measured_device_us: float, peaks: dict) -> dict:
    """CriticalZone_Dense_Scan (benchmark_runner.cpp:313-376): 3600 rays
    in the slowdown band — about 3.6e4 f32 ops, far below what one kernel
    launch costs, so the share says "launch bound"."""
    compute_floor_us = 1e6 * (10.0 * 3600) / peaks["f32_flops"]
    memory_floor_us = 1e6 * (3600 * 4 * 3) / peaks["hbm_bytes"]
    return {
        "name": "CriticalZone_Dense_Scan",
        "measured_device_us": measured_device_us,
        "bound": "kernel launch, not compute",
        "compute_floor_us": compute_floor_us,
        "memory_floor_us": memory_floor_us,
        "pct_of_roofline": (
            100 * max(compute_floor_us, memory_floor_us) / measured_device_us
        ),
    }


def dwa_sweep(measured_ms_per_batch: float, peaks: dict) -> dict:
    """The flagship batch-64 solve's two min-distance sweeps (obstacles
    512, segment 384 padded to 512)."""
    B, S, T = 64, 2025, 30
    ops = 6.0 * B * S * T * (512 + 512)
    floor_s = ops / peaks["f32_flops"]
    return {
        "name": "DWA_sweep_batch64",
        "measured_ms": measured_ms_per_batch,
        "bound": "f32 (obstacle + segment min-distance sweeps)",
        "sweep_ops": ops,
        "compute_floor_ms": floor_s * 1e3,
        "pct_of_roofline": 100 * floor_s / (measured_ms_per_batch * 1e-3),
    }


def build(measured: dict, device_kind: str) -> dict:
    """Roofline shares of ``measured`` times taken on ``device_kind``."""
    peaks = peaks_for(device_kind)
    return {
        "device_kind": device_kind,
        "peaks": peaks,
        "workloads": [
            cost_evaluator_5k(measured["CostEvaluator_5k_Trajs"], peaks),
            mapper_dense(measured["Mapper_Dense_400x400"], peaks),
            mapper_bayesian(measured["Mapper_Bayesian_400x400"], peaks),
            mapper_pointcloud(measured["Mapper_PointCloud_100k"], peaks),
            critical_zone_100k(measured["CriticalZone_100k_Cloud"], peaks),
            critical_zone_dense(
                measured["CriticalZone_Dense_device_us"], peaks
            ),
            dwa_sweep(measured["DWA_sweep_batch64"], peaks),
        ],
    }
