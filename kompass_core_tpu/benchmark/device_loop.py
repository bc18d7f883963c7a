"""Device-loop timing: per-iteration device time without the host.

ONE jitted program runs the workload K times in a ``lax.scan`` whose
carry feeds each iteration's input from the previous iteration's output
(a data dependency, so iterations execute serially and XLA cannot CSE or
hoist them). Wall time for a K-iteration dispatch is

    T(K) = dispatch + transfer + K * t_workload

so ``t = (T(K2) - T(K1)) / (K2 - K1)`` cancels the dispatch, the
transfers and the output fetch. Each timed dispatch gets a DISTINCT
resident input buffer. Useful for workloads far shorter than one
dispatch (e.g. CriticalZone_Dense_Scan).
"""

from __future__ import annotations

import statistics
import time
from functools import partial
from typing import Callable, List, Sequence

import numpy as np


def make_dwa_device_loop(spec, k: int):
    """One jitted program: K carry-chained DWA solves on a packed buffer.

    The carry perturbs the robot x-state by 1e-6 + 1e-9*cost each
    iteration — a data dependency on the previous solve (forces serial
    execution, defeats CSE) that keeps the scenario physically valid.
    Returns the final cost scalar (forces the whole chain).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ..ops.solver import _unpack_and_solve

    solve = partial(_unpack_and_solve, spec)

    def loop(buf):
        def body(b, _):
            out = solve(b)
            b = b.at[0].add(1e-6 + 1e-9 * out[1])
            return b, out[1]

        _, costs = lax.scan(body, buf, None, length=k)
        return costs[-1]

    return jax.jit(loop)


def measure_device_loop(
    name: str,
    make_loop: Callable[[int], Callable],
    variants: Sequence,
    ks: Sequence[int] = (8, 40),
    repeats: int = 3,
) -> dict:
    """Per-iteration device time from the K-delta of single dispatches.

    ``variants`` must hold >= ``2 * repeats + 2`` DISTINCT
    device-resident inputs: two warmup dispatches (one per compiled K)
    plus two per timed repeat. Returns the median across repeats plus
    every raw estimate and the spread (max - min).
    """
    k1, k2 = ks
    assert len(variants) >= 2 * repeats + 2, (
        f"need >= {2 * repeats + 2} distinct variants "
        f"(2 warmup + 2 per repeat), got {len(variants)}"
    )
    f1, f2 = make_loop(k1), make_loop(k2)
    it = iter(variants)
    # compile + warm both programs (distinct inputs, untimed)
    float(np.asarray(f1(next(it))))
    float(np.asarray(f2(next(it))))
    ests: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(np.asarray(f1(next(it))))
        t1 = time.perf_counter()
        float(np.asarray(f2(next(it))))
        t2 = time.perf_counter()
        ests.append(((t2 - t1) - (t1 - t0)) / (k2 - k1) * 1e3)
    med = statistics.median(ests)
    return {
        "name": name,
        "method": f"device_loop_k{k1}_k{k2}",
        "p50_ms": med,
        "mean_ms": med,
        "estimates_ms": ests,
        "spread_ms": max(ests) - min(ests),
        "repeats": repeats,
    }


def make_critical_zone_device_loop(spec, k: int):
    """K carry-chained critical-zone checks in one dispatch. The carry
    perturbs each range by 1e-6 * previous factor (factor in [0, 1], so
    the ranges stay inside the slowdown band)."""
    import jax
    from jax import lax

    from ..ops.critical_zone import get_critical_zone_checker

    check = get_critical_zone_checker(spec)

    def loop(ranges):
        def body(r, _):
            f = check(r, True)
            return r + (1e-6 * f + 1e-7), f

        _, fs = lax.scan(body, ranges, None, length=k)
        return fs[-1]

    return jax.jit(loop)


def make_mapper_device_loop(spec, k: int):
    """K carry-chained dense scan->grid updates in one dispatch. The
    carry perturbs the ranges by a value derived from the occupancy
    count (data dependency on the previous grid)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ..ops.mapping import get_scan_to_grid

    to_grid = get_scan_to_grid(spec)

    def loop(ranges):
        def body(r, _):
            g = to_grid(r)
            occ = jnp.sum(g).astype(jnp.float32)
            return r + (1e-9 * occ + 1e-7), occ

        _, occs = lax.scan(body, ranges, None, length=k)
        return occs[-1]

    return jax.jit(loop)


def make_critical_zone_cloud_device_loop(spec, k: int):
    """K carry-chained 100k-point cloud safety checks in one dispatch.
    The carry perturbs the whole cloud by 1e-6 * previous factor."""
    import jax
    from jax import lax

    from ..ops.critical_zone import get_critical_zone_checker_cloud

    check = get_critical_zone_checker_cloud(spec)

    def loop(pts):
        def body(p, _):
            f = check(
                p, True, np.float32(20.0), np.float32(-1.0),
                np.float32(1.0),
            )
            return p + (1e-6 * f + 1e-7), f

        _, fs = lax.scan(body, pts, None, length=k)
        return fs[-1]

    return jax.jit(loop)


# Reference benchmark_runner.cpp:187-218 constructs the Bayesian mapper
# with these exact sensor-model values (p_prior, p_empty, p_occupied,
# range_sure, range_max, wall_size).
BAYES_BENCH_SCALARS = (0.6, 0.1, 0.9, 0.1, 20.0, 0.2)


def make_mapper_bayesian_device_loop(spec, k: int):
    """K carry-chained Bayesian grid updates in one dispatch. The carry
    is (ranges, prob_grid): each iteration fuses into the PREVIOUS
    iteration's posterior — the real temporal-fusion recurrence, which
    is also the data dependency that forces serial execution."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ..ops.mapping import get_scan_to_grid_bayesian

    fn = get_scan_to_grid_bayesian(spec)
    scalars = tuple(np.float32(v) for v in BAYES_BENCH_SCALARS)

    def loop(carry):
        ranges, prev = carry

        def body(c, _):
            r, p = c
            occ, prob = fn(r, p, *scalars)
            out = jnp.sum(occ).astype(jnp.float32)
            return (r + (1e-9 * out + 1e-7), prob), out

        _, outs = lax.scan(body, (ranges, prev), None, length=k)
        return outs[-1]

    return jax.jit(loop)


def make_mapper_pointcloud_device_loop(spec, k: int):
    """K carry-chained (100k cloud -> laserscan -> grid) updates in one
    dispatch; carry perturbs the cloud by a value derived from the
    occupancy count."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ..ops.mapping import get_pointcloud_to_scan, get_scan_to_grid

    to_scan = get_pointcloud_to_scan(spec.num_bins)
    to_grid = get_scan_to_grid(spec)

    def loop(pts):
        def body(p, _):
            g = to_grid(
                to_scan(
                    p, jnp.float32(10.0), jnp.float32(-1.0),
                    jnp.float32(1.0),
                )
            )
            occ = jnp.sum(g).astype(jnp.float32)
            return p + (1e-9 * occ + 1e-7), occ

        _, occs = lax.scan(body, pts, None, length=k)
        return occs[-1]

    return jax.jit(loop)
