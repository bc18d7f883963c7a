"""Second extended planner family: TRRT, the bidirectional / projection
tree planners, and the batch bidirectional wavefront.

Completes the registry toward the reference's 29 bound OMPL geometric
planners (``ompl_bindings/bindings.cpp:63-444``) with tensor-program
re-implementations of the remaining algorithm families:

  * **TRRT** (Jaillet, Cortes, Simeon 2010) — the reference front-end's
    DEFAULT planner (``third_party/ompl/planner.py:34``): RRT growth
    gated by a Metropolis transition test over a state-cost field with
    an adaptive temperature. The cost field here is obstacle clearance
    (1/(eps + distance-to-obstacle)), the planning analog of OMPL's
    MaximizeMinClearance objective, from an exact Euclidean distance
    transform of the inflated grid.
  * **BiEST** (Hsu et al. 1997, bidirectional form): two EST trees with
    density-biased selection, joined by a connect attempt per iteration.
  * **SBL** (Sanchez & Latombe 2002): bidirectional, projection-grid
    density selection, LAZY edges — motions are not checked during
    growth; the traced solution is validated on host with a
    checked-repair fallback.
  * **BKPIECE1 / LBKPIECE1** (Sucan & Kavraki 2008): bidirectional
    KPIECE — projection-grid border/visit-count cell selection — in
    checked and lazy forms.
  * **ProjEST**: EST with projection-grid density estimation (OMPL's
    grid-based EST variant) instead of radius-based density.
  * **PDST** (Ladd & Kavraki 2004): deterministic lowest-priority
    selection; on selection a node's priority doubles (the device analog of
    PDST's cell subdivision pushing the split sample down the queue) and
    the new node inherits the doubled priority.
  * **STRIDE** (Gipson, Moll, Kavraki 2013): EST-style growth where the
    density estimate comes from a nearest-neighbor structure (GNAT in
    OMPL) — here the incrementally-maintained 1-NN distance: nodes far
    from their nearest neighbor (sparse regions) are preferred.
  * **BFMT*** (Starek et al. 2015): two FMT* wavefronts marching from
    start and goal over one shared r-disc graph, terminating when they
    meet.

All kernels follow the module family's conventions: fixed-capacity
``lax.scan`` programs, masked growth, Gumbel-argmax categorical picks,
no host round-trips inside the loop.
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import point_free, segment_free
from .planners_ext import (
    _fmt_radius,
    _gumbel_pick,
    _informed_batch,
    _mu_free,
    _edge_checks_for_radius,
    _proj_border,
    _proj_cell_of,
    _rgg_radius,
    _trace_tree,
    _tree_args,
)

_PROJ = 32  # projection-grid resolution per axis (OMPL default order)


# ---------------------------------------------------------------------------
# TRRT
# ---------------------------------------------------------------------------


def _edt_numpy(free: np.ndarray, resolution: float) -> np.ndarray:
    """Exact Euclidean distance transform without scipy: per-column
    nearest-obstacle |dy| via two cumulative passes, then an exact row
    sweep ``d²(y,x) = min_x' (x-x')² + g(y,x')²`` chunked over rows
    (O(W²·H), vectorized — a one-time per-map cost)."""
    H, W = free.shape
    BIG = H + W + 1.0
    # pass 1: per-column vertical distance to the nearest obstacle cell
    g = np.where(free, BIG, 0.0)
    for y in range(1, H):
        g[y] = np.minimum(g[y], g[y - 1] + 1.0)
    for y in range(H - 2, -1, -1):
        g[y] = np.minimum(g[y], g[y + 1] + 1.0)
    # pass 2: exact horizontal sweep over candidate columns
    dx2 = (np.arange(W)[:, None] - np.arange(W)[None, :]) ** 2  # [x, x']
    d = np.empty((H, W), np.float64)
    chunk = max(1, int(4e6) // (W * W))
    for y0 in range(0, H, chunk):
        gs = g[y0:y0 + chunk] ** 2  # [h, x']
        d[y0:y0 + chunk] = np.sqrt(
            np.min(gs[:, None, :] + dx2[None, :, :], axis=2)
        )
    return d * resolution


def clearance_edt(blocked: np.ndarray, resolution: float) -> np.ndarray:
    """Exact Euclidean clearance [m] to the nearest occupied cell of the
    (already robot-inflated) occupancy grid, for every cell."""
    free = ~np.asarray(blocked)
    try:
        from scipy.ndimage import distance_transform_edt

        return distance_transform_edt(free, sampling=resolution)
    except ImportError:  # scipy is optional: exact numpy fallback
        return _edt_numpy(free, resolution)


def clearance_cost_field(blocked: np.ndarray, resolution: float) -> np.ndarray:
    """State-cost field for TRRT: inverse obstacle clearance.

    cost = 1 / (resolution + clearance) so the field is finite everywhere,
    highest at obstacle boundaries."""
    clearance = clearance_edt(blocked, resolution)
    return (1.0 / (resolution + clearance)).astype(np.float32)


def _cost_at(cost_field, origin_xy, resolution, xy):
    """Nearest-cell state-cost lookup (clipped to the border)."""
    H, W = cost_field.shape
    gx = jnp.clip(
        jnp.floor((xy[..., 0] - origin_xy[0]) / resolution).astype(jnp.int32),
        0, W - 1,
    )
    gy = jnp.clip(
        jnp.floor((xy[..., 1] - origin_xy[1]) / resolution).astype(jnp.int32),
        0, H - 1,
    )
    return cost_field[gy, gx]


@partial(
    jax.jit,
    static_argnames=("max_iterations", "edge_check_points"),
)
def trrt_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    cost_field, step_size, goal_bias, goal_tolerance, init_temperature,
    frontier_threshold, key, max_iterations: int, edge_check_points: int,
):
    """Transition-based RRT under ``lax.scan``.

    Standard RRT extension plus the TRRT transition test: downhill moves
    (new state cost <= parent cost) always pass; uphill moves pass with
    probability ``exp(-dCost / (K * T))`` where K is the cost scale
    (mean of the field). The temperature T adapts per Jaillet et al.:
    rejection heats (T *= 2), uphill acceptance cools (T /= 2), clamped
    to [1e-6, 1e6]. ``frontier_threshold`` implements the min-expand
    control: extensions shorter than it are counted as refinement and
    rejected when the frontier/refinement balance drops."""
    N = max_iterations + 2
    nodes = jnp.zeros((N, 2), jnp.float32).at[0].set(start)
    parents = jnp.full((N,), -1, jnp.int32)
    costs = jnp.full((N,), jnp.inf).at[0].set(0.0)
    scost = jnp.zeros((N,), jnp.float32).at[0].set(
        _cost_at(cost_field, origin_xy, resolution, start)
    )
    count = jnp.int32(1)
    temp = jnp.float32(init_temperature)
    K = jnp.maximum(jnp.mean(cost_field), 1e-6)
    # frontier-node / refinement-node balance (nonFrontierNodeRatio)
    n_frontier = jnp.float32(1.0)
    n_refine = jnp.float32(0.0)

    def body(carry, key_i):
        nodes, parents, costs, scost, count, temp, n_frontier, n_refine = carry
        k1, k2, k3, k4 = jax.random.split(key_i, 4)
        sample = jnp.where(
            jax.random.uniform(k1) < goal_bias,
            goal,
            jax.random.uniform(
                k2, (2,), minval=bounds_lo, maxval=bounds_hi,
                dtype=jnp.float32,
            ),
        )
        alive = jnp.arange(N) < count
        d = jnp.where(alive, jnp.linalg.norm(nodes - sample, axis=1), jnp.inf)
        nearest = jnp.argmin(d)
        direction = sample - nodes[nearest]
        dn = jnp.maximum(jnp.linalg.norm(direction), 1e-9)
        ext = jnp.minimum(dn, step_size)
        new_pt = nodes[nearest] + direction / dn * ext
        geo_ok = (
            point_free(blocked, origin_xy, resolution, new_pt)
            & segment_free(
                blocked, origin_xy, resolution, nodes[nearest], new_pt,
                edge_check_points,
            )
            & (count < N)
        )
        # transition test
        c_new = _cost_at(cost_field, origin_xy, resolution, new_pt)
        d_cost = c_new - scost[nearest]
        p_accept = jnp.exp(-d_cost / (K * temp))
        uphill = d_cost > 0
        trans_ok = ~uphill | (jax.random.uniform(k3) < p_accept)
        # min-expand control: suppress refinement moves (shorter than the
        # frontier threshold) once refinement dominates 10:1
        refinement = ext < frontier_threshold
        ratio_ok = ~refinement | (n_refine < 10.0 * n_frontier)
        ok = geo_ok & trans_ok & ratio_ok

        # adaptive temperature: reject-heats / uphill-accept-cools
        temp = jnp.where(
            geo_ok & uphill & ~trans_ok, jnp.minimum(temp * 2.0, 1e6), temp
        )
        temp = jnp.where(
            ok & uphill, jnp.maximum(temp * 0.5, 1e-6), temp
        )
        n_frontier = n_frontier + jnp.where(ok & ~refinement, 1.0, 0.0)
        n_refine = n_refine + jnp.where(ok & refinement, 1.0, 0.0)

        idx = jnp.minimum(count, N - 1)
        nodes = jnp.where(ok, nodes.at[idx].set(new_pt), nodes)
        parents = jnp.where(
            ok, parents.at[idx].set(nearest.astype(jnp.int32)), parents
        )
        costs = jnp.where(ok, costs.at[idx].set(costs[nearest] + ext), costs)
        scost = jnp.where(ok, scost.at[idx].set(c_new), scost)
        count = count + ok.astype(jnp.int32)
        return (
            nodes, parents, costs, scost, count, temp, n_frontier, n_refine
        ), None

    keys = jax.random.split(key, max_iterations)
    (nodes, parents, costs, scost, count, *_), _ = jax.lax.scan(
        body,
        (nodes, parents, costs, scost, count, temp, n_frontier, n_refine),
        keys,
    )
    alive = jnp.arange(N) < count
    dgoal = jnp.where(alive, jnp.linalg.norm(nodes - goal, axis=1), jnp.inf)
    seg_ok = segment_free(
        blocked, origin_xy, resolution, nodes,
        jnp.broadcast_to(goal, nodes.shape), edge_check_points,
    )
    reach = jnp.where(
        alive & seg_ok & (dgoal <= goal_tolerance), costs + dgoal, jnp.inf
    )
    best = jnp.argmin(reach)
    return nodes, parents, best.astype(jnp.int32), reach[best]


# ---------------------------------------------------------------------------
# generic bidirectional grown-tree kernel (BiEST / SBL / [L]BKPIECE1)
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "max_iterations", "edge_check_points", "selection", "check_edges"
    ),
)
def bidir_tree_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, density_radius, border_fraction, key,
    max_iterations: int, edge_check_points: int,
    selection: str = "est",  # "est" | "grid" | "border"
    check_edges: bool = True,
):
    """Two grown trees (start / goal) with pluggable node selection and a
    connect attempt per iteration.

    ``selection``:
      * ``est``    — radius-density-biased node pick (BiEST),
      * ``grid``   — projection-grid visit-count cell pick (SBL),
      * ``border`` — KPIECE border/visit-count cell pick (BKPIECE1).

    ``check_edges=False`` = lazy growth (SBL / LBKPIECE1): motions are
    not collision-checked; the host wrapper validates + repairs.

    Returns (nodes [2,N,2], parents [2,N], found, bridge [2])."""
    N = max_iterations + 2
    span = jnp.maximum(bounds_hi - bounds_lo, 1e-6)

    cell_of = _proj_cell_of(bounds_lo, span)

    nodes = (
        jnp.zeros((2, N, 2), jnp.float32).at[0, 0].set(start).at[1, 0].set(goal)
    )
    parents = jnp.full((2, N), -1, jnp.int32)
    density = jnp.zeros((2, N), jnp.float32).at[:, 0].set(1.0)
    cells = jnp.zeros((2, N), jnp.int32)
    cells = cells.at[0, 0].set(cell_of(start)).at[1, 0].set(cell_of(goal))
    visits = jnp.zeros((2, _PROJ * _PROJ), jnp.float32)
    visits = visits.at[0, cell_of(start)].add(1.0)
    visits = visits.at[1, cell_of(goal)].add(1.0)
    counts = jnp.array([1, 1], jnp.int32)
    found = jnp.bool_(False)
    bridge = jnp.array([-1, -1], jnp.int32)

    def pick_node(tree, nodes, density, cells, visits, counts, k1, k2):
        alive = jnp.arange(N) < counts[tree]
        if selection == "est":
            logw = jnp.where(alive, -jnp.log1p(density[tree]), -jnp.inf)
            return _gumbel_pick(k1, logw)
        occupied = visits[tree] > 0
        if selection == "border":
            border = _proj_border(occupied)
            pref = jnp.where(border, border_fraction, 1.0 - border_fraction)
            logc = jnp.where(
                occupied,
                jnp.log(pref + 1e-9) - jnp.log1p(visits[tree]),
                -jnp.inf,
            )
        else:  # "grid": SBL picks cells inversely to visit count
            logc = jnp.where(occupied, -jnp.log1p(visits[tree]), -jnp.inf)
        cell_pick = _gumbel_pick(k1, logc)
        in_cell = alive & (cells[tree] == cell_pick)
        return _gumbel_pick(k2, jnp.where(in_cell, 0.0, -jnp.inf))

    def body(carry, inp):
        (nodes, parents, density, cells, visits, counts, found, bridge) = carry
        key_i, a = inp
        b = 1 - a
        k1, k2, k3, k4 = jax.random.split(key_i, 4)
        pick = pick_node(a, nodes, density, cells, visits, counts, k1, k2)

        ang = jax.random.uniform(k3) * 2.0 * jnp.pi
        length = jax.random.uniform(k4) * step_size
        new_pt = jnp.clip(
            nodes[a, pick]
            + jnp.array([jnp.cos(ang), jnp.sin(ang)]) * length,
            bounds_lo, bounds_hi,
        )
        ok = (
            point_free(blocked, origin_xy, resolution, new_pt)
            & (counts[a] < N)
            & ~found
        )
        if check_edges:
            ok = ok & segment_free(
                blocked, origin_xy, resolution, nodes[a, pick], new_pt,
                edge_check_points,
            )
        idx = jnp.minimum(counts[a], N - 1)
        new_cell = cell_of(new_pt)
        nodes = jnp.where(ok, nodes.at[a, idx].set(new_pt), nodes)
        parents = jnp.where(
            ok, parents.at[a, idx].set(pick.astype(jnp.int32)), parents
        )
        cells = jnp.where(ok, cells.at[a, idx].set(new_cell), cells)
        visits = jnp.where(ok, visits.at[a, new_cell].add(1.0), visits)
        alive_a = jnp.arange(N) < counts[a]
        near_new = alive_a & (
            jnp.linalg.norm(nodes[a] - new_pt, axis=1) <= density_radius
        )
        density = jnp.where(
            ok,
            density.at[a]
            .set(jnp.where(near_new, density[a] + 1.0, density[a]))
            .at[a, idx]
            .set(jnp.sum(near_new.astype(jnp.float32)) + 1.0),
            density,
        )
        counts = jnp.where(ok, counts.at[a].add(1), counts)

        # connect attempt: nearest node of the other tree within step_size
        alive_b = jnp.arange(N) < counts[b]
        db = jnp.where(
            alive_b, jnp.linalg.norm(nodes[b] - new_pt, axis=1), jnp.inf
        )
        nb = jnp.argmin(db)
        link_ok = ok & (db[nb] <= step_size)
        if check_edges:
            link_ok = link_ok & segment_free(
                blocked, origin_xy, resolution, new_pt, nodes[b, nb],
                edge_check_points,
            )
        new_bridge = jnp.where(
            a == 0,
            jnp.stack([idx, nb.astype(jnp.int32)]),
            jnp.stack([nb.astype(jnp.int32), idx]),
        ).astype(jnp.int32)
        bridge = jnp.where(link_ok & ~found, new_bridge, bridge)
        found = found | link_ok
        return (
            nodes, parents, density, cells, visits, counts, found, bridge
        ), None

    keys = jax.random.split(key, max_iterations)
    alternate = jnp.arange(max_iterations, dtype=jnp.int32) % 2
    (nodes, parents, density, cells, visits, counts, found, bridge), _ = (
        jax.lax.scan(
            body,
            (nodes, parents, density, cells, visits, counts, found, bridge),
            (keys, alternate),
        )
    )
    return nodes, parents, found, bridge


# ---------------------------------------------------------------------------
# PDST / STRIDE (unidirectional, non-uniform selection)
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("max_iterations", "edge_check_points", "stride"),
)
def pdst_stride_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    step_size, goal_bias, goal_tolerance, key,
    max_iterations: int, edge_check_points: int, stride: bool = False,
):
    """PDST (stride=False) / STRIDE (stride=True) growth.

    PDST: deterministic lowest-priority selection at PROJECTION-CELL
    granularity — the cell with the lowest priority wins, a random node
    inside it is extended, and the cell's priority doubles (+1). Newly
    reached cells enter the queue with priority = the iteration index,
    so fresh frontier cells are far ahead of repeatedly-selected
    interior cells — the fixed-capacity analog of PDST's cell
    subdivision, whose ever-larger unexplored cells win the
    priority/volume ordering (Ladd & Kavraki 2004).

    STRIDE: the density estimate is the incrementally-maintained 1-NN
    distance (the GNAT-sampler analog): selection weight ∝ nn_dist⁴,
    strongly preferring nodes in sparse regions; failed extensions decay
    the picked node's estimate so blocked frontier nodes lose weight."""
    N = max_iterations + 2
    span = jnp.maximum(bounds_hi - bounds_lo, 1e-6)

    cell_of = _proj_cell_of(bounds_lo, span)

    nodes = jnp.zeros((N, 2), jnp.float32).at[0].set(start)
    parents = jnp.full((N,), -1, jnp.int32)
    costs = jnp.full((N,), jnp.inf).at[0].set(0.0)
    cells = jnp.zeros((N,), jnp.int32).at[0].set(cell_of(start))
    cell_prio = jnp.full((_PROJ * _PROJ,), jnp.inf)
    cell_prio = cell_prio.at[cell_of(start)].set(0.0)
    nn_d = jnp.full((N,), jnp.inf).at[0].set(1e3)  # STRIDE 1-NN distances
    count = jnp.int32(1)

    def body(carry, inp):
        nodes, parents, costs, cells, cell_prio, nn_d, count = carry
        key_i, it = inp
        k1, k2, k3, k4, k5 = jax.random.split(key_i, 5)
        alive = jnp.arange(N) < count
        if stride:
            logw = jnp.where(alive, 4.0 * jnp.log(nn_d + 1e-6), -jnp.inf)
            pick = _gumbel_pick(k1, logw)
        else:
            cmin = jnp.argmin(cell_prio)
            in_cell = alive & (cells == cmin)
            pick = _gumbel_pick(k5, jnp.where(in_cell, 0.0, -jnp.inf))
            # demote on SELECTION, not on propagation success — otherwise
            # a cell trapped against an obstacle is re-picked forever
            # (deterministic argmin livelock)
            cell_prio = cell_prio.at[cmin].set(cell_prio[cmin] * 2.0 + 1.0)

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
            point_free(blocked, origin_xy, resolution, new_pt)
            & segment_free(
                blocked, origin_xy, resolution, nodes[pick], new_pt,
                edge_check_points,
            )
            & (count < N)
        )
        idx = jnp.minimum(count, N - 1)
        new_cell = cell_of(new_pt)
        cells = jnp.where(ok, cells.at[idx].set(new_cell), cells)
        # unseen cell enters the queue at priority = iteration index:
        # far ahead of interior cells whose priorities have doubled away
        cell_prio = jnp.where(
            ok & jnp.isinf(cell_prio[new_cell]),
            cell_prio.at[new_cell].set(it.astype(jnp.float32)),
            cell_prio,
        )
        d_new = jnp.linalg.norm(nodes - new_pt, axis=1)
        nn_new = jnp.min(jnp.where(alive, d_new, jnp.inf))
        nn_d = jnp.where(
            ok,
            jnp.where(alive & (d_new < nn_d), d_new, nn_d).at[idx].set(nn_new),
            nn_d,
        )
        # STRIDE stagnation guard: failed extensions shrink the picked
        # node's sparsity estimate so blocked frontier nodes lose weight
        nn_d = jnp.where(ok, nn_d, nn_d.at[pick].multiply(0.7))
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
        count = count + ok.astype(jnp.int32)
        return (nodes, parents, costs, cells, cell_prio, nn_d, count), None

    keys = jax.random.split(key, max_iterations)
    iters = jnp.arange(max_iterations, dtype=jnp.int32)
    (nodes, parents, costs, cells, cell_prio, nn_d, count), _ = jax.lax.scan(
        body, (nodes, parents, costs, cells, cell_prio, nn_d, count),
        (keys, iters),
    )
    alive = jnp.arange(N) < count
    dgoal = jnp.where(alive, jnp.linalg.norm(nodes - goal, axis=1), jnp.inf)
    seg_ok = segment_free(
        blocked, origin_xy, resolution, nodes,
        jnp.broadcast_to(goal, nodes.shape), edge_check_points,
    )
    reach = jnp.where(
        alive & seg_ok & (dgoal <= goal_tolerance), costs + dgoal, jnp.inf
    )
    best = jnp.argmin(reach)
    return nodes, parents, best.astype(jnp.int32), reach[best]


# ---------------------------------------------------------------------------
# BFMT*
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("num_samples", "edge_check_points"),
)
def bfmt_solve(
    blocked, origin_xy, bounds_lo, bounds_hi, resolution, start, goal,
    radius, key, num_samples: int, edge_check_points: int,
):
    """Bidirectional FMT*: two wavefronts (from start=node 0 and
    goal=node 1) alternate lowest-cost-first expansion over ONE shared
    r-disc graph; terminate when a side expands a node the other side
    has already closed (the BFMT* meet criterion).

    Returns (pts, parent_fwd, parent_rev, meet, total_cost): the path is
    start →(parent_fwd)→ meet →(parent_rev)→ goal."""
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

    def init_side(root):
        cost = jnp.full((K,), INF).at[root].set(0.0)
        parent = jnp.full((K,), -1, jnp.int32)
        open_ = jnp.zeros((K,), bool).at[root].set(node_free[root])
        closed = jnp.zeros((K,), bool)
        return cost, parent, open_, closed

    # both sides stacked on a leading [2] axis; each scan step expands
    # ONLY the active side (one dynamic-index slice + write-back), not a
    # masked no-op over both — halves the O(K^2) per-iteration work
    c0, p0, o0, cl0 = init_side(0)
    c1, p1, o1, cl1 = init_side(1)
    cost = jnp.stack([c0, c1])
    parent = jnp.stack([p0, p1])
    open_ = jnp.stack([o0, o1])
    closed = jnp.stack([cl0, cl1])

    def expand(state, gate):
        """One FMT* expansion step for a side; returns new state and the
        expanded node index z (or -1)."""
        cost, parent, open_, closed = state
        oc = jnp.where(open_, cost, INF)
        z = jnp.argmin(oc)
        z_ok = jnp.isfinite(oc[z]) & gate
        unv = ~open_ & ~closed & node_free & nbr[z]
        c_through = jnp.where(open_[:, None] & nbr, cost[:, None] + dist, INF)
        y_best = jnp.argmin(c_through, axis=0)
        c_best = jnp.min(c_through, axis=0)
        ok_edge = jnp.take_along_axis(edge_ok, y_best[None, :], axis=0)[0]
        newly = unv & jnp.isfinite(c_best) & ok_edge & z_ok
        cost = jnp.where(newly, c_best, cost)
        parent = jnp.where(newly, y_best.astype(jnp.int32), parent)
        open_ = (open_ | newly) & ~((jnp.arange(K) == z) & z_ok)
        closed = closed | ((jnp.arange(K) == z) & z_ok)
        return (cost, parent, open_, closed), jnp.where(z_ok, z, -1)

    def body(carry, i):
        cost, parent, open_, closed, meet, done = carry
        a = i % 2
        (ca, pa, oa, cla), z = expand(
            (cost[a], parent[a], open_[a], closed[a]), ~done
        )
        cost = cost.at[a].set(ca)
        parent = parent.at[a].set(pa)
        open_ = open_.at[a].set(oa)
        closed = closed.at[a].set(cla)
        # meet test: the node just expanded is closed by BOTH sides
        zs = jnp.maximum(z, 0)
        hit = (z >= 0) & closed[0, zs] & closed[1, zs]
        meet = jnp.where(hit & (meet < 0), z, meet)
        done = done | hit | (z < 0)
        return (cost, parent, open_, closed, meet, done), None

    (cost, parent, open_, closed, meet, _), _ = jax.lax.scan(
        body,
        (cost, parent, open_, closed, jnp.int32(-1), jnp.bool_(False)),
        jnp.arange(2 * K),
    )
    cost0, parent0, closed0 = cost[0], parent[0], closed[0]
    cost1, parent1, closed1 = cost[1], parent[1], closed[1]
    # fallback meet: cheapest node closed/reached by both sides
    both = jnp.isfinite(cost0) & jnp.isfinite(cost1)
    total = jnp.where(both, cost0 + cost1, INF)
    meet = jnp.where(meet >= 0, meet, jnp.argmin(total))
    return pts, parent0, parent1, meet.astype(jnp.int32), total[meet]


# ---------------------------------------------------------------------------
# host wrappers
# ---------------------------------------------------------------------------


def solve_trrt(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    # key the cache on the array OBJECT (identity via `is`, holding the
    # reference): an id() key could be recycled by a new allocation after
    # setup_problem rebinds _blocked, silently serving a stale field
    if getattr(planner, "_cost_field_src", None) is not planner._blocked:
        planner._cost_field = jnp.asarray(
            clearance_cost_field(
                np.asarray(planner._blocked), float(prob["resolution"])
            )
        )
        planner._cost_field_src = planner._blocked
    nodes, parents, best, cost = trrt_solve(
        *_tree_args(planner, prob),
        planner._cost_field,
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.05)),
        jnp.float32(step),
        jnp.float32(planner._param("init_temperature", 100.0)),
        jnp.float32(planner._param("frontier_threshold", 0.0) or 0.25 * step),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
    )
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def _trace_bidir(nodes, parents, bridge) -> Optional[np.ndarray]:
    nodes = np.asarray(nodes)
    parents = np.asarray(parents)
    bridge = np.asarray(bridge)

    from .planner import _walk_predecessors

    c0 = _walk_predecessors(parents[0], int(bridge[0]), 0)
    c1 = _walk_predecessors(parents[1], int(bridge[1]), 0)
    if c0 is None or c1 is None:
        return None
    return np.concatenate([nodes[0][c0], nodes[1][c1[::-1]]])


def _solve_bidir(planner, prob, seed=0, selection="est", check_edges=True):
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    nodes, parents, found, bridge = bidir_tree_solve(
        *_tree_args(planner, prob),
        jnp.float32(step),
        jnp.float32(planner._param("density_radius", 0.0) or step),
        jnp.float32(planner._param("border_fraction", 0.9)),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        selection=selection,
        check_edges=check_edges,
    )
    if not bool(found):
        return None
    pts = _trace_bidir(nodes, parents, bridge)
    if pts is None:
        return None
    if not check_edges:
        # lazy growth: validate the traced solution; on failure repair by
        # re-solving the same seed with motion checks on (same policy as
        # the lazy RRT family)
        for a, b in zip(pts[:-1], pts[1:]):
            if not planner._segment_free_host(a, b):
                return _solve_bidir(
                    planner, prob, seed=seed, selection=selection,
                    check_edges=True,
                )
    return pts


solve_biest = partial(_solve_bidir, selection="est")
solve_sbl = partial(_solve_bidir, selection="grid", check_edges=False)
solve_bkpiece = partial(_solve_bidir, selection="border")
solve_lbkpiece = partial(_solve_bidir, selection="border", check_edges=False)


def solve_proj_est(planner, prob, seed=0) -> Optional[np.ndarray]:
    """ProjEST: EST with projection-grid density — the unidirectional
    'grid' selection of the bidirectional kernel, tree 1 disabled by
    using the same growth kernel with the goal tree never selected is
    not expressible; instead reuse kpiece_solve's grid machinery with
    border preference OFF (pure visit-count density), which IS ProjEST's
    selection rule."""
    from .planners_ext import kpiece_solve

    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    nodes, parents, best, cost = kpiece_solve(
        *_tree_args(planner, prob),
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.05)),
        jnp.float32(0.5),  # no border preference: pure density selection
        jnp.float32(step),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
    )
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def solve_pdst(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    nodes, parents, best, cost = pdst_stride_solve(
        *_tree_args(planner, prob),
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.05)),
        jnp.float32(step),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        stride=False,
    )
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def solve_stride(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    step = planner._param("range", 0.0) or cfg.step_size
    nodes, parents, best, cost = pdst_stride_solve(
        *_tree_args(planner, prob),
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.05)),
        jnp.float32(step),
        jax.random.PRNGKey(seed),
        max_iterations=cfg.max_iterations,
        edge_check_points=cfg.edge_check_points,
        stride=True,
    )
    if not np.isfinite(float(cost)):
        return None
    return _trace_tree(nodes, parents, best, prob["goal"])


def solve_bfmt(planner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    K = int(planner._param("num_samples", cfg.num_samples))
    res = float(prob["resolution"])
    r = _fmt_radius(
        _mu_free(planner._blocked, res), res, K,
        float(planner._param("radius_multiplier", 1.1)),
    )
    pts, parent_f, parent_r, meet, total = bfmt_solve(
        *_tree_args(planner, prob),
        jnp.float32(r),
        jax.random.PRNGKey(seed),
        num_samples=K,
        # same rule as FMT*: sample density follows the RGG radius
        edge_check_points=_edge_checks_for_radius(cfg, res, r),
    )
    if not np.isfinite(float(total)):
        return None
    pts = np.asarray(pts)
    parent_f = np.asarray(parent_f)
    parent_r = np.asarray(parent_r)
    meet = int(meet)

    from .planner import _walk_predecessors

    fwd = _walk_predecessors(parent_f, meet, 0)  # start -> meet
    rev = _walk_predecessors(parent_r, meet, 1)  # goal -> meet
    if fwd is None or rev is None:
        return None
    return pts[fwd + rev[::-1][1:]]


# ---------------------------------------------------------------------------
# ABIT* / AIT* (batch roadmap planners on the dense graph kernel)
# ---------------------------------------------------------------------------


def solve_abitstar(planner, prob, seed=0) -> Optional[np.ndarray]:
    """ABIT* (Strub & Gammell 2020): BIT* batches with the two ABIT*
    additions — (1) an INFLATED search radius schedule (the sparse
    approximation is searched aggressively first, then tightened:
    inflation decays 2.0 -> 1.0 across batches), and (2) informed
    PRUNING between batches: accumulated samples whose heuristic total
    ``|x - start| + |x - goal|`` exceeds the incumbent solution cost are
    removed from the roadmap (parked out of bounds)."""
    from .planner import _graph_shortest_path, _trace_prm_path

    cfg = planner._config
    m = int(planner._param("samples_per_batch", 128))
    B = int(planner._param("batches", 4))
    rewire = float(planner._param("rewire_factor", 1.1))
    infl0 = float(planner._param("initial_inflation", 2.0))
    K_total = 2 + m * B

    rng = np.random.default_rng(seed)
    start = np.asarray(prob["start"], np.float64)
    goal = np.asarray(prob["goal"], np.float64)
    lo = np.asarray(prob["lo"], np.float64)
    hi = np.asarray(prob["hi"], np.float64)
    res = float(prob["resolution"])
    pts = np.full((K_total, 2), 1e9, np.float32)
    pts[0] = start
    pts[1] = goal
    mu_free = _mu_free(planner._blocked, res)  # one fetch, not per batch

    best_path, best_cost = None, np.inf
    for b in range(B):
        batch = _informed_batch(rng, start, goal, best_cost, m, lo, hi)
        pts[2 + b * m : 2 + (b + 1) * m] = batch
        # informed pruning of ALL accumulated samples (keep start/goal)
        if np.isfinite(best_cost):
            live = pts[2:, 0] < 1e8
            f_hat = np.linalg.norm(pts[2:] - start, axis=1) + np.linalg.norm(
                pts[2:] - goal, axis=1
            )
            pts[2:][live & (f_hat > best_cost)] = 1e9
        n_cur = 2 + int((pts[2:, 0] < 1e8).sum())
        # inflation schedule: aggressive-then-tight
        infl = infl0 + (1.0 - infl0) * (b / max(B - 1, 1))
        r_n = _rgg_radius(mu_free, res, n_cur, rewire) * infl
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
            cost = float(np.hypot(*np.diff(np.asarray(path), axis=0).T).sum())
            if cost < best_cost:
                best_cost = cost
                best_path = path
    return best_path


def solve_aitstar(planner, prob, seed=0) -> Optional[np.ndarray]:
    """AIT* (Strub & Gammell 2020): asymmetric bidirectional search —
    per batch, a cheap REVERSE search from the goal over the current
    roadmap yields an adaptive admissible heuristic h(v); the forward
    search then only considers vertices whose total g_hat(v) + h(v)
    can beat the incumbent (the rest are parked out of the roadmap for
    that batch). The reverse pass is the same dense Bellman-Ford kernel
    with the goal as source."""
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
    res = float(prob["resolution"])
    pts = np.full((K_total, 2), 1e9, np.float32)
    pts[0] = start
    pts[1] = goal
    mu_free = _mu_free(planner._blocked, res)  # one fetch, not per batch

    best_path, best_cost = None, np.inf
    h = None  # adaptive heuristic from the previous reverse search
    for b in range(B):
        batch = rng.uniform(lo, hi, (m, 2))
        pts[2 + b * m : 2 + (b + 1) * m] = batch
        n_cur = 2 + (b + 1) * m
        r_n = _rgg_radius(mu_free, res, n_cur, rewire)

        # reverse search: goal as node 0 (swap roles) -> h(v)
        pts_rev = pts.copy()
        pts_rev[0], pts_rev[1] = pts[1], pts[0]
        h_dist, _ = _graph_shortest_path(
            planner._blocked, prob["origin"], prob["resolution"],
            jnp.asarray(pts_rev), jnp.float32(r_n),
            edge_check_points=_edge_checks_for_radius(cfg, res, r_n),
            num_relax_iters=min(K_total, 128), knn_cap=0,
        )
        h = np.asarray(h_dist).copy()
        h[0], h[1] = h[1], h[0]  # back to original indexing

        # forward search with heuristic vertex pruning
        pts_fwd = pts.copy()
        if np.isfinite(best_cost):
            g_hat = np.linalg.norm(pts - start, axis=1)
            prune = (g_hat + h > best_cost) & (pts[:, 0] < 1e8)
            prune[:2] = False
            pts_fwd[prune] = 1e9
        dist, pred = _graph_shortest_path(
            planner._blocked, prob["origin"], prob["resolution"],
            jnp.asarray(pts_fwd), jnp.float32(r_n),
            edge_check_points=_edge_checks_for_radius(cfg, res, r_n),
            num_relax_iters=min(K_total, 128), knn_cap=0,
        )
        path = _trace_prm_path(np.asarray(pts_fwd), np.asarray(dist),
                               np.asarray(pred))
        if path is not None:
            cost = float(np.hypot(*np.diff(np.asarray(path), axis=0).T).sum())
            if cost < best_cost:
                best_cost = cost
                best_path = path
    return best_path
