"""Extended planner family: EST, KPIECE1, SST, FMT*, BIT*.

Widens the registry toward the reference's ~28 bound OMPL geometric
planners (``ompl_bindings/bindings.cpp:63-444``) with genuine tensor-program
re-implementations of the major algorithm families the first seven
planners did not cover:

  * **EST** (Hsu, Latombe, Motwani 1997): tree growth biased toward
    low-density regions — node picked with probability ∝ 1/(1+density),
    then a random bounded extension.
  * **KPIECE1** (Sucan & Kavraki 2008): projection-grid-driven
    exploration — a fixed 32x32 projection of the workspace tracks visit
    counts; expansion prefers border/less-visited cells.
  * **SST** (Li, Littlefield, Bekris 2014): sparse stable tree — a witness
    set with ``pruning_radius`` keeps only the locally-best-cost node, and
    selection picks the best-cost node within ``selection_radius`` of the
    sample (BestNear).
  * **FMT*** (Janson & Pavone 2013): batch wavefront dynamic programming
    over an r-disc graph on K samples — open-set argmin expansion with
    single-parent connection, as a ``lax.scan`` over dense [K, K]
    neighborhood tensors. (The reference implementation checks edges
    lazily; here the whole edge matrix is one fused kernel up front, so
    the lazy aspect collapses while the wavefront search dynamics remain.)
  * **BIT*** (Gammell, Srinivasa, Barfoot 2015): repeated batches of
    samples, each restricted to the informed ellipse once a solution
    exists, solved over the accumulated roadmap; the batch loop runs on
    host, each batch's graph solve is the same dense device kernel PRM
    uses.

All sequential planners are fixed-capacity ``lax.scan`` programs (static
shapes, masked growth) and draw categorical choices with the Gumbel-argmax
trick — no host round-trips inside the loop.
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import point_free, segment_free

_PROJ = 32  # KPIECE projection-grid resolution per axis


def _proj_cell_of(bounds_lo, span):
    """Flattened projection-grid cell index fn (shared by the
    discretization-guided kernels: KPIECE, bidir EST/SBL, PDST —
    round-5 review consolidated three copies)."""

    def cell_of(p):
        c = jnp.floor((p - bounds_lo) / span * _PROJ).astype(jnp.int32)
        c = jnp.clip(c, 0, _PROJ - 1)
        return c[..., 1] * _PROJ + c[..., 0]

    return cell_of


def _proj_border(occupied_flat):
    """Border mask on the flattened projection grid: occupied cells with
    at least one unoccupied 4-neighbor."""
    occ2d = occupied_flat.reshape(_PROJ, _PROJ)
    pad = jnp.pad(occ2d, 1, constant_values=False)
    nbr_all = (
        pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    )
    return (occ2d & ~nbr_all).reshape(-1)


def _gumbel_pick(key, log_weights):
    """Categorical sample via Gumbel-argmax. -inf weights are never
    picked (unless all are)."""
    g = jax.random.gumbel(key, log_weights.shape)
    return jnp.argmax(log_weights + g)


def _mu_free(blocked, res: float) -> float:
    """Free-space area of the inflated grid. ONE device fetch — hoist out
    of batch loops (each fetch is a device round trip)."""
    return max(float((~np.asarray(blocked)).sum()) * res * res, 1e-6)


def _edge_checks_for_radius(cfg, res: float, radius: float) -> int:
    """Edge-check count covering a given connection radius at map
    resolution: the RGG radius of the batch planners can exceed
    cfg.connection_radius (which sizes the default count), letting long
    edges sample wider than a wall. Pow2-quantized to bound the number
    of distinct compiled kernels; capped at the validator max (512)."""
    import math as _math

    needed = int(_math.ceil(radius / max(res, 1e-9))) + 1
    n = max(int(cfg.edge_check_points), needed)
    n = 1 << (n - 1).bit_length()
    return min(n, 512)


def _rgg_radius(mu_free: float, res: float, n: int, rewire: float) -> float:
    """PRM*/BIT* shrinking RGG connection radius for n samples."""
    gamma = rewire * 2.0 * np.sqrt(1.5) * np.sqrt(mu_free / np.pi)
    return max(gamma * np.sqrt(np.log(max(n, 2)) / n), 2.0 * res)


def _fmt_radius(mu_free: float, res: float, K: int, mult: float) -> float:
    """FMT* connection radius r_n = mult * sqrt((2/pi) mu_free log n / n)
    (Janson & Pavone 2013, d=2)."""
    r = mult * 2.0 * np.sqrt((mu_free / np.pi) * np.log(max(K, 2)) / max(K, 2))
    return max(r, 2.0 * res)


def _informed_batch(rng, start, goal, best_cost, m, lo, hi):
    """m samples for one BIT*-family batch: uniform before an incumbent
    solution exists, else direct samples of the prolate hyperspheroid with
    foci start/goal and transverse diameter ``best_cost`` (Gammell 2014)."""
    if not np.isfinite(best_cost):
        return rng.uniform(lo, hi, (m, 2))
    c_min = float(np.linalg.norm(goal - start))
    r1 = best_cost / 2.0
    r2 = np.sqrt(max(best_cost**2 - c_min**2, 1e-12)) / 2.0
    theta = np.arctan2(goal[1] - start[1], goal[0] - start[0])
    rr = np.sqrt(rng.uniform(size=m))
    aa = rng.uniform(0, 2 * np.pi, m)
    ex = r1 * rr * np.cos(aa)
    ey = r2 * rr * np.sin(aa)
    ct, st = np.cos(theta), np.sin(theta)
    centre = (start + goal) / 2.0
    batch = np.stack(
        [ct * ex - st * ey + centre[0], st * ex + ct * ey + centre[1]],
        axis=1,
    )
    return np.clip(batch, lo, hi)


def _connect_goal(blocked, origin_xy, resolution, nodes, costs, alive, goal,
                  tolerance, edge_check_points):
    """Best tree node that can reach the goal within ``tolerance``."""
    N = nodes.shape[0]
    dgoal = jnp.where(alive, jnp.linalg.norm(nodes - goal, axis=1), jnp.inf)
    seg_ok = segment_free(
        blocked, origin_xy, resolution, nodes,
        jnp.broadcast_to(goal, nodes.shape), edge_check_points,
    )
    reach = jnp.where(
        alive & seg_ok & (dgoal <= tolerance), costs + dgoal, jnp.inf
    )
    best = jnp.argmin(reach)
    return best.astype(jnp.int32), reach[best]


# ---------------------------------------------------------------------------
# EST
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("max_iterations", "edge_check_points"),
)
def est_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, density_radius, goal_tolerance, key,
    max_iterations: int, edge_check_points: int,
):
    N = max_iterations + 2
    nodes = jnp.zeros((N, 2), jnp.float32).at[0].set(start)
    costs = jnp.full((N,), jnp.inf).at[0].set(0.0)
    count = jnp.int32(1)
    # incremental density: density[i] = alive neighbors within
    # density_radius of node i (updated in O(N) per accepted node instead
    # of an O(N^2) rebuild per iteration)
    density = jnp.zeros((N,), jnp.float32).at[0].set(1.0)

    parents = jnp.full((N,), -1, jnp.int32)

    def body(carry, key_i):
        nodes, parents, costs, density, count = carry
        k1, k2, k3, k4 = jax.random.split(key_i, 4)
        alive = jnp.arange(N) < count
        logw = jnp.where(alive, -jnp.log1p(density), -jnp.inf)
        pick = _gumbel_pick(k1, logw)

        # bounded random extension; goal_bias steers toward the goal
        ang = jax.random.uniform(k2) * 2.0 * jnp.pi
        length = jax.random.uniform(k3) * step_size
        rand_dir = jnp.array([jnp.cos(ang), jnp.sin(ang)]) * length
        to_goal = goal - nodes[pick]
        gd = jnp.maximum(jnp.linalg.norm(to_goal), 1e-9)
        goal_dir = to_goal / gd * jnp.minimum(gd, step_size)
        direction = jnp.where(
            jax.random.uniform(k4) < goal_bias, goal_dir, rand_dir
        )
        new_pt = jnp.clip(nodes[pick] + direction, bounds_lo, bounds_hi)
        ok = (
            segment_free(
                blocked, origin_xy, resolution, nodes[pick], new_pt,
                edge_check_points,
            )
            & point_free(blocked, origin_xy, resolution, new_pt)
            & (count < N)
        )
        idx = jnp.minimum(count, N - 1)
        nodes = jnp.where(ok, nodes.at[idx].set(new_pt), nodes)
        parents = jnp.where(
            ok, parents.at[idx].set(pick.astype(jnp.int32)), parents
        )
        costs = jnp.where(
            ok,
            costs.at[idx].set(
                costs[pick] + jnp.linalg.norm(new_pt - nodes[pick])
            ),
            costs,
        )
        # O(N) density maintenance: the new node raises every alive
        # neighbor's count and inherits theirs (+1 for itself)
        near_new = alive & (
            jnp.linalg.norm(nodes - new_pt, axis=1) <= density_radius
        )
        density = jnp.where(
            ok,
            jnp.where(near_new, density + 1.0, density)
            .at[idx]
            .set(jnp.sum(near_new.astype(jnp.float32)) + 1.0),
            density,
        )
        count = count + ok.astype(jnp.int32)
        return (nodes, parents, costs, density, count), None

    keys = jax.random.split(key, max_iterations)
    (nodes, parents, costs, density, count), _ = jax.lax.scan(
        body, (nodes, parents, costs, density, count), keys
    )
    alive = jnp.arange(N) < count
    best, best_cost = _connect_goal(
        blocked, origin_xy, resolution, nodes, costs, alive, goal,
        goal_tolerance, edge_check_points,
    )
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# KPIECE1
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("max_iterations", "edge_check_points"),
)
def kpiece_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, border_fraction, goal_tolerance, key,
    max_iterations: int, edge_check_points: int,
):
    N = max_iterations + 2
    span = jnp.maximum(bounds_hi - bounds_lo, 1e-6)

    cell_of = _proj_cell_of(bounds_lo, span)

    nodes = jnp.zeros((N, 2), jnp.float32).at[0].set(start)
    parents = jnp.full((N,), -1, jnp.int32)
    costs = jnp.full((N,), jnp.inf).at[0].set(0.0)
    cells = jnp.zeros((N,), jnp.int32).at[0].set(cell_of(start))
    visits = jnp.zeros((_PROJ * _PROJ,), jnp.float32).at[cell_of(start)].add(1.0)
    count = jnp.int32(1)

    def body(carry, key_i):
        nodes, parents, costs, cells, visits, count = carry
        k1, k2, k3, k4, k5 = jax.random.split(key_i, 5)
        alive = jnp.arange(N) < count

        occupied = visits > 0
        border = _proj_border(occupied)
        # KPIECE cell selection: border cells with prob border_fraction,
        # scored down by visit count
        pref = jnp.where(border, border_fraction, 1.0 - border_fraction)
        logw = jnp.where(
            occupied, jnp.log(pref + 1e-9) - jnp.log1p(visits), -jnp.inf
        )
        cell_pick = _gumbel_pick(k1, logw)

        # pick a node inside the chosen cell uniformly
        in_cell = alive & (cells == cell_pick)
        logn = jnp.where(in_cell, 0.0, -jnp.inf)
        pick = _gumbel_pick(k2, logn)

        ang = jax.random.uniform(k3) * 2.0 * jnp.pi
        rand_dir = jnp.array([jnp.cos(ang), jnp.sin(ang)]) * step_size
        to_goal = goal - nodes[pick]
        gd = jnp.maximum(jnp.linalg.norm(to_goal), 1e-9)
        goal_dir = to_goal / gd * jnp.minimum(gd, step_size)
        direction = jnp.where(
            jax.random.uniform(k4) < goal_bias, goal_dir, rand_dir
        )
        new_pt = jnp.clip(nodes[pick] + direction, bounds_lo, bounds_hi)
        ok = (
            segment_free(
                blocked, origin_xy, resolution, nodes[pick], new_pt,
                edge_check_points,
            )
            & point_free(blocked, origin_xy, resolution, new_pt)
            & (count < N)
        )
        idx = jnp.minimum(count, N - 1)
        new_cell = cell_of(new_pt)
        nodes = jnp.where(ok, nodes.at[idx].set(new_pt), nodes)
        parents = jnp.where(
            ok, parents.at[idx].set(pick.astype(jnp.int32)), parents
        )
        costs = jnp.where(
            ok,
            costs.at[idx].set(
                costs[pick] + jnp.linalg.norm(new_pt - nodes[pick])
            ),
            costs,
        )
        cells = jnp.where(ok, cells.at[idx].set(new_cell), cells)
        visits = jnp.where(ok, visits.at[new_cell].add(1.0), visits)
        count = count + ok.astype(jnp.int32)
        return (nodes, parents, costs, cells, visits, count), None

    keys = jax.random.split(key, max_iterations)
    (nodes, parents, costs, cells, visits, count), _ = jax.lax.scan(
        body, (nodes, parents, costs, cells, visits, count), keys
    )
    alive = jnp.arange(N) < count
    best, best_cost = _connect_goal(
        blocked, origin_xy, resolution, nodes, costs, alive, goal,
        goal_tolerance, edge_check_points,
    )
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# SST
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("max_iterations", "edge_check_points"),
)
def sst_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, selection_radius, pruning_radius, goal_tolerance,
    key, max_iterations: int, edge_check_points: int,
):
    N = max_iterations + 2
    nodes = jnp.zeros((N, 2), jnp.float32).at[0].set(start)
    parents = jnp.full((N,), -1, jnp.int32)
    costs = jnp.full((N,), jnp.inf).at[0].set(0.0)
    active = jnp.zeros((N,), bool).at[0].set(True)
    # witness set: wit_pt, wit_rep (node index of the local best)
    wit_pts = jnp.full((N, 2), 1e9, jnp.float32).at[0].set(start)
    wit_rep = jnp.full((N,), -1, jnp.int32).at[0].set(0)
    wit_count = jnp.int32(1)
    count = jnp.int32(1)

    def body(carry, key_i):
        nodes, parents, costs, active, wit_pts, wit_rep, wit_count, count = (
            carry
        )
        k1, k2, k3 = jax.random.split(key_i, 3)
        sample = jnp.where(
            jax.random.uniform(k1) < goal_bias,
            goal,
            jax.random.uniform(
                k2, (2,), minval=bounds_lo, maxval=bounds_hi,
                dtype=jnp.float32,
            ),
        )
        # BestNear selection: best-cost ACTIVE node within selection_radius
        # of the sample; fall back to nearest active node
        d = jnp.where(
            active, jnp.linalg.norm(nodes - sample, axis=1), jnp.inf
        )
        near = d <= selection_radius
        sel_cost = jnp.where(near, costs, jnp.inf)
        pick = jnp.where(
            jnp.any(near), jnp.argmin(sel_cost), jnp.argmin(d)
        )
        direction = sample - nodes[pick]
        dn = jnp.maximum(jnp.linalg.norm(direction), 1e-9)
        new_pt = nodes[pick] + direction / dn * jnp.minimum(dn, step_size)
        new_cost = costs[pick] + jnp.minimum(dn, step_size)
        ok = (
            segment_free(
                blocked, origin_xy, resolution, nodes[pick], new_pt,
                edge_check_points,
            )
            & point_free(blocked, origin_xy, resolution, new_pt)
            & (count < N)
        )

        # witness check: closest witness within pruning_radius
        wd = jnp.linalg.norm(wit_pts - new_pt, axis=1)
        wnear = jnp.argmin(wd)
        has_witness = wd[wnear] <= pruning_radius
        rep = wit_rep[wnear]
        rep_cost = jnp.where(rep >= 0, costs[jnp.maximum(rep, 0)], jnp.inf)
        accept = ok & (~has_witness | (new_cost < rep_cost))

        idx = jnp.minimum(count, N - 1)
        nodes = jnp.where(accept, nodes.at[idx].set(new_pt), nodes)
        parents = jnp.where(
            accept, parents.at[idx].set(pick.astype(jnp.int32)), parents
        )
        costs = jnp.where(accept, costs.at[idx].set(new_cost), costs)
        active = jnp.where(accept, active.at[idx].set(True), active)
        # deactivate the dominated representative (sparsity pruning)
        dominated = accept & has_witness & (rep >= 0)
        active = jnp.where(
            dominated, active.at[jnp.maximum(rep, 0)].set(False), active
        )
        # update / create witness
        wit_rep = jnp.where(
            accept & has_witness, wit_rep.at[wnear].set(idx), wit_rep
        )
        new_wit = accept & ~has_witness & (wit_count < N)
        widx = jnp.minimum(wit_count, N - 1)
        wit_pts = jnp.where(new_wit, wit_pts.at[widx].set(new_pt), wit_pts)
        wit_rep = jnp.where(new_wit, wit_rep.at[widx].set(idx), wit_rep)
        wit_count = wit_count + new_wit.astype(jnp.int32)
        count = count + accept.astype(jnp.int32)
        return (
            nodes, parents, costs, active, wit_pts, wit_rep, wit_count, count
        ), None

    keys = jax.random.split(key, max_iterations)
    (nodes, parents, costs, active, *_rest, count), _ = jax.lax.scan(
        body,
        (nodes, parents, costs, active, wit_pts, wit_rep, wit_count, count),
        keys,
    )
    alive = (jnp.arange(N) < count) & active
    best, best_cost = _connect_goal(
        blocked, origin_xy, resolution, nodes, costs, alive, goal,
        goal_tolerance, edge_check_points,
    )
    return nodes, parents, best, best_cost


# ---------------------------------------------------------------------------
# FMT*
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("num_samples", "edge_check_points"),
)
def fmt_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    radius, key, num_samples: int, edge_check_points: int,
):
    """FMT* wavefront over an r-disc graph on K uniform samples.

    Node 0 = start, node 1 = goal. Returns (pts, parent, cost_to_goal)."""
    K = num_samples
    pts = jax.random.uniform(
        key, (K, 2), minval=bounds_lo, maxval=bounds_hi, dtype=jnp.float32
    )
    pts = pts.at[0].set(start).at[1].set(goal)
    node_free = point_free(blocked, origin_xy, resolution, pts)

    diff = pts[:, None, :] - pts[None, :, :]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    seg_ok = segment_free(
        blocked, origin_xy, resolution, pts[:, None, :], pts[None, :, :],
        edge_check_points,
    )
    nbr = (
        (dist <= radius) & (dist > 0)
        & node_free[:, None] & node_free[None, :]
    )
    edge_ok = nbr & seg_ok

    INF = jnp.float32(jnp.inf)
    cost = jnp.full((K,), INF).at[0].set(0.0)
    parent = jnp.full((K,), -1, jnp.int32)
    open_ = jnp.zeros((K,), bool).at[0].set(node_free[0])
    closed = jnp.zeros((K,), bool)

    def body(carry, _):
        cost, parent, open_, closed, done = carry
        oc = jnp.where(open_, cost, INF)
        z = jnp.argmin(oc)
        z_ok = jnp.isfinite(oc[z]) & ~done
        # frontier: unvisited neighbors of z
        unv = ~open_ & ~closed & node_free & nbr[z]
        # single-parent connection: best OPEN y within radius of each x
        c_through = jnp.where(
            open_[:, None] & nbr, cost[:, None] + dist, INF
        )  # [K(y), K(x)]
        y_best = jnp.argmin(c_through, axis=0)
        c_best = jnp.min(c_through, axis=0)
        ok_edge = jnp.take_along_axis(edge_ok, y_best[None, :], axis=0)[0]
        newly = unv & jnp.isfinite(c_best) & ok_edge & z_ok
        cost = jnp.where(newly, c_best, cost)
        parent = jnp.where(newly, y_best.astype(jnp.int32), parent)
        open_ = (open_ | newly) & ~((jnp.arange(K) == z) & z_ok)
        closed = closed | ((jnp.arange(K) == z) & z_ok)
        done = done | ~z_ok | ((z == 1) & z_ok)
        return (cost, parent, open_, closed, done), None

    (cost, parent, open_, closed, _), _ = jax.lax.scan(
        body, (cost, parent, open_, closed, jnp.bool_(False)), None, length=K
    )
    return pts, parent, cost[1]


# ---------------------------------------------------------------------------
# host wrappers (registry signature: (planner, prob, seed) -> path | None)
# ---------------------------------------------------------------------------


def _trace_tree(nodes, parents, best, goal) -> Optional[np.ndarray]:
    from .planner import _walk_predecessors

    nodes = np.asarray(nodes)
    path = _walk_predecessors(np.asarray(parents), int(best), 0)
    if path is None:
        return None
    return np.vstack([nodes[path], np.asarray(goal)[None, :]])


def _tree_args(planner, prob):
    return (
        planner._blocked,
        prob["origin"],
        prob["lo"],
        prob["hi"],
        prob["resolution"],
        jnp.asarray(prob["start"]),
        jnp.asarray(prob["goal"]),
    )


def solve_est(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    nodes, parents, best, cost = est_solve(
        *_tree_args(planner, prob),
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.05)),
        jnp.float32(planner._param("density_radius", 1.0)),
        jnp.float32(step),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
    )
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def solve_kpiece(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    nodes, parents, best, cost = kpiece_solve(
        *_tree_args(planner, prob),
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.05)),
        jnp.float32(planner._param("border_fraction", 0.9)),
        jnp.float32(step),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
    )
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def solve_sst(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    nodes, parents, best, cost = sst_solve(
        *_tree_args(planner, prob),
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.05)),
        jnp.float32(planner._param("selection_radius", 1.0)),
        jnp.float32(planner._param("pruning_radius", 0.3)),
        jnp.float32(step),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
    )
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def solve_fmt(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    K = int(planner._param("num_samples", cfg.num_samples))
    res = float(prob["resolution"])
    r = _fmt_radius(
        _mu_free(planner._blocked, res), res, K,
        float(planner._param("radius_multiplier", 1.1)),
    )
    pts, parent, goal_cost = fmt_solve(
        *_tree_args(planner, prob),
        jnp.float32(r),
        jax.random.PRNGKey(seed),
        num_samples=K,
        # density must follow the RGG radius actually used, not the
        # (smaller) config connection_radius — an undersampled long
        # edge can tunnel through a thin inflated wall
        edge_check_points=_edge_checks_for_radius(cfg, res, r),
    )
    if not np.isfinite(float(goal_cost)):
        return None
    from .planner import _walk_predecessors

    path = _walk_predecessors(np.asarray(parent))
    return None if path is None else np.asarray(pts)[path]


def solve_bitstar(planner, prob, seed=0) -> Optional[np.ndarray]:
    """Batches of informed samples over an accumulating roadmap.

    Each batch: sample ``samples_per_batch`` points (uniform before a
    solution exists, from the informed prolate hyperspheroid after),
    append to the point set, re-solve the whole roadmap with the dense
    graph kernel, keep the best solution. Unfilled slots are parked at
    +1e9 (out of bounds -> not free -> no edges), so every batch reuses
    ONE compiled kernel.
    """
    from .planner import _graph_shortest_path, _trace_prm_path

    cfg = planner._config
    m = int(planner._param("samples_per_batch", 128))
    B = int(planner._param("batches", 4))
    rewire = float(planner._param("rewire_factor", 1.1))
    K_total = 2 + m * B

    rng = np.random.default_rng(seed)
    start = np.asarray(prob["start"], np.float64)
    goal = np.asarray(prob["goal"], np.float64)
    lo = np.asarray(prob["lo"], np.float64)
    hi = np.asarray(prob["hi"], np.float64)
    pts = np.full((K_total, 2), 1e9, np.float32)
    pts[0] = start
    pts[1] = goal

    res = float(prob["resolution"])
    mu_free = _mu_free(planner._blocked, res)

    best_path, best_cost = None, np.inf
    for b in range(B):
        n_cur = 2 + (b + 1) * m
        batch = _informed_batch(rng, start, goal, best_cost, m, lo, hi)
        pts[2 + b * m : 2 + (b + 1) * m] = batch
        r_n = _rgg_radius(mu_free, res, n_cur, rewire)
        dist, pred = _graph_shortest_path(
            planner._blocked,
            prob["origin"],
            prob["resolution"],
            jnp.asarray(pts),
            jnp.float32(r_n),
            edge_check_points=_edge_checks_for_radius(cfg, res, r_n),
            num_relax_iters=min(K_total, 128),
            knn_cap=0,
        )
        path = _trace_prm_path(np.asarray(pts), np.asarray(dist),
                               np.asarray(pred))
        if path is not None:
            cost = float(
                np.hypot(*np.diff(np.asarray(path), axis=0).T).sum()
            )
            if cost < best_cost:
                best_cost = cost
                best_path = path
    return best_path
