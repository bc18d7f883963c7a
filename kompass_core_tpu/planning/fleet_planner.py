"""Fleet global planning: N start→goal queries over ONE shared roadmap,
solved in a single device dispatch.

Beyond-reference capability (the reference plans one robot per
``OMPL2DGeometricPlanner`` instance, ``planning/ompl.cpp:22-67``): a
warehouse fleet shares one static map, so the expensive part of a
PRM-style solve — the M x M edge-validity tensor (segment collision
checks) — is identical for every robot. This module builds the roadmap
once over [starts | goals | samples] and runs a BATCHED min-plus
Bellman-Ford relaxation ``d[i,j] = min_k d[i,k] + W[k,j]`` with the
robot axis as a leading tensor dimension: one compiled program returns
every robot's distance field and predecessor tree.

The edge tensor and the relaxation are the single-robot roadmap
kernel's own helpers (``planner.build_edge_weights`` /
``planner.minplus_relax``) — one implementation serves both paths.

Device notes: the relaxation is a [N, M, M] broadcast-min, fused by
XLA; the edge tensor amortizes across the fleet exactly like
the fleet mapper amortizes the beam lookup (``ops/mapping.py``).
"""

import time
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["solve_fleet_prm", "fleet_shortest_paths"]


@partial(
    jax.jit,
    static_argnames=("n_robots", "edge_check_points", "num_relax_iters",
                     "knn_cap"),
)
def fleet_shortest_paths(
    blocked,
    origin_xy,
    resolution,
    starts,  # [N, 2]
    goals,  # [N, 2]
    samples,  # [K, 2] shared roadmap samples
    connection_radius,
    n_robots: int,
    edge_check_points: int,
    num_relax_iters: int,
    knn_cap: int = 0,
):
    """One shared roadmap, N-source batched Bellman-Ford.

    Node layout: [starts (N) | goals (N) | samples (K)], M = 2N + K.
    Returns (nodes [M,2], dists [N, M], preds [N, M]); robot i's
    solution cost is ``dists[i, N + i]``.
    """
    from .planner import build_edge_weights, minplus_relax

    N = n_robots
    nodes = jnp.concatenate([starts, goals, samples], axis=0)
    M = nodes.shape[0]
    W = build_edge_weights(
        blocked, origin_xy, resolution, nodes, connection_radius,
        edge_check_points, knn_cap,
    )
    INF = jnp.float32(jnp.inf)
    # d[i, j]: cost from start node i to node j
    d0 = jnp.full((N, M), INF)
    d0 = d0.at[jnp.arange(N), jnp.arange(N)].set(0.0)
    p0 = jnp.full((N, M), -1, jnp.int32)
    dists, preds = minplus_relax(W, d0, p0, num_relax_iters)
    return nodes, dists, preds


def _trace_fleet_path(nodes, pred_row, start_idx, goal_idx):
    from .planner import _walk_predecessors

    path = _walk_predecessors(pred_row, int(goal_idx), int(start_idx))
    return None if path is None else np.asarray(nodes)[path]


def solve_fleet_prm(
    planner,
    starts: np.ndarray,
    goals: np.ndarray,
    seed: Optional[int] = None,
) -> List[Optional[np.ndarray]]:
    """Plan all N robots of a fleet over the map configured by
    ``planner.setup_problem`` (bounds/inflation reused; the per-robot
    start/goal there is ignored). Returns one path (or None) per robot;
    each path is simplified with the planner's shortcut pass.

    Retry policy mirrors ``GlobalPlanner.solve``: ``optimize_rounds``
    deliberate rounds always run, then rounds with fresh roadmap samples
    keep going for still-unsolved robots until ``planning_timeout``
    expires. Robots already at their goal get the trivial path without
    touching the roadmap (the roadmap's ``dist > 0`` edge rule would
    otherwise force an out-and-back detour through a sample node).
    """
    from .planner import logger

    if planner._problem is None:
        raise RuntimeError("Call setup_problem first")
    starts = np.asarray(starts, np.float32).reshape(-1, 2)
    goals = np.asarray(goals, np.float32).reshape(-1, 2)
    if starts.shape != goals.shape:
        raise ValueError("starts and goals must both be [N, 2]")
    N = starts.shape[0]
    cfg = planner._config
    prob = planner._problem
    K = cfg.num_samples
    relax_iters = min(2 * N + K, 128)
    base_seed = cfg.seed if seed is None else seed
    deadline = time.monotonic() + max(cfg.planning_timeout, 0.0)

    paths: List[Optional[np.ndarray]] = [None] * N
    trivial = [False] * N
    for i in range(N):
        if float(np.hypot(*(goals[i] - starts[i]))) < 1e-6:
            paths[i] = np.stack([starts[i], goals[i]])
            trivial[i] = True

    # path COSTS (polyline length) so later deliberate rounds can refine:
    # each round samples a fresh roadmap, and a robot first solved through
    # a bad detour should adopt a cheaper later solution (mirrors
    # GlobalPlanner.solve's keep-the-cheapest rule)
    costs = [0.0 if trivial[i] else np.inf for i in range(N)]
    round_i = 0
    while True:
        all_solved = all(p is not None for p in paths)
        deliberate = round_i < max(1, cfg.optimize_rounds)
        if all_solved and not deliberate:
            break
        # planning_timeout strictly bounds wall time, INCLUDING the
        # deliberate optimize rounds (GlobalPlanner.solve's rule; a
        # first solve must still get one round) — round-5 review
        if time.monotonic() >= deadline and (all_solved or round_i > 0):
            break
        key = jax.random.PRNGKey(base_seed + round_i)
        samples = jax.random.uniform(
            key, (K, 2), minval=prob["lo"], maxval=prob["hi"],
            dtype=jnp.float32,
        )
        nodes, dists, preds = fleet_shortest_paths(
            planner._blocked,
            prob["origin"],
            prob["resolution"],
            jnp.asarray(starts),
            jnp.asarray(goals),
            samples,
            jnp.float32(cfg.connection_radius),
            n_robots=N,
            edge_check_points=cfg.edge_check_points,
            num_relax_iters=relax_iters,
            knn_cap=int(planner._param("max_nearest_neighbors", 0) or 0),
        )
        nodes = np.asarray(nodes)
        dists = np.asarray(dists)
        preds = np.asarray(preds)
        for i in range(N):
            if not np.isfinite(dists[i, N + i]):
                continue
            if dists[i, N + i] >= costs[i]:
                continue  # no improvement over the kept solution
            raw = _trace_fleet_path(nodes, preds[i], i, N + i)
            if raw is None:
                continue
            if len(raw) >= relax_iters:
                logger.warning(
                    "fleet PRM relaxation cap (%d iters) binds: robot %d's "
                    "solution uses %d hops; consider fewer samples or a "
                    "larger connection radius",
                    relax_iters, i, len(raw),
                )
            paths[i] = planner._shortcut(raw) if cfg.simplify else raw
            costs[i] = float(dists[i, N + i])
        round_i += 1
    return paths
