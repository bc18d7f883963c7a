"""Global path planning: batched sampling-based planners in JAX.

Covers the role of the reference's OMPL integration
(``planning/ompl.cpp`` + ``ompl_bindings/bindings.cpp`` +
``third_party/ompl/planner.py``) with a tensor-program design instead of a
third-party C++ dependency: the entire planning problem — sampling, edge
validity, graph search — is expressed as dense tensor programs.

Planner registry (13 ids; reference binds ~28 OMPL planners,
``ompl_bindings/bindings.cpp:63-444``):

  * roadmap family: ``PRM``, ``PRMstar``, ``LazyPRM``, ``LazyPRMstar``
    (dense K x K edge kernel + Bellman-Ford relaxation on device; the
    lazy variants collapse onto the dense kernel — when the whole edge
    matrix is one fused kernel, deferring edge checks buys nothing),
  * tree family: ``RRT``, ``RRTstar``, ``InformedRRTstar``,
    ``RRTConnect`` (fixed-capacity ``lax.scan`` growth with masking),
  * extended families (``planners_ext.py``): ``EST``, ``KPIECE1``,
    ``SST``, ``FMTstar``, ``BITstar``.

Every planner has an auto-generated attrs config class with validated,
HONORED parameters (``params.py``, mirroring the reference's OMPL param
introspection, ``third_party/ompl/config.py``); ``planning_timeout``
drives retry rounds with fresh seeds until a solution is found (plus
``optimize_rounds`` deliberate multi-round refinement keeping the best),
and ``use_fcl=False`` disables geometric collision checking (bounds-only
validity), the reference's FCL toggle semantics.

Collision model: obstacle points are rasterized into an occupancy grid
inflated by the robot's circumscribed radius (``geometry.py``) — the
planning analog of the engine's point-robot + margin model, replacing the
reference's per-state FCL callback (``ompl.cpp:87-100``).

The ``OMPLGeometric``-compatible wrapper keeps the reference front-end
surface: ``setup_problem(map_meta, start..., goal..., map_3d)``,
``solve()``, ``path_cost``, ``planner_params`` get/set,
``available_planners`` param-map introspection.
"""

import logging
import time
from functools import partial
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from attrs import define, field

from ..models import Robot, RobotGeometry
from ..utils.config import BaseAttrs, base_validators
from ..utils.runtime import enable_persistent_compilation_cache
from .geometry import build_inflated_grid, point_free, segment_free
from .params import PLANNER_PARAMS, create_config_class, default_planner_params

logger = logging.getLogger("kompass_core_tpu")

# back-compat aliases (pre-refactor names)
_point_free = point_free
_segment_free = segment_free


@define
class GlobalPlannerConfig(BaseAttrs):
    """Planner configuration (role of ``OMPLGeometricConfig``)."""

    # the reference front-end's default planner is TRRT
    # (third_party/ompl/planner.py:34)
    planner_id: str = field(default="TRRT")
    # retry budget: rounds with fresh seeds run until a solution is found
    # or the timeout expires (the reference hands this to OMPL's solve())
    planning_timeout: float = field(
        default=5.0, validator=base_validators.in_range(0.0, 1e6)
    )
    # deliberate multi-round refinement: solve this many rounds (seeds
    # seed, seed+1, ...) and keep the cheapest solution. Deterministic.
    optimize_rounds: int = field(
        default=1, validator=base_validators.in_range(1, 64)
    )
    map_resolution: float = field(
        default=0.05, validator=base_validators.in_range(1e-4, 10.0)
    )
    num_samples: int = field(
        default=512, validator=base_validators.in_range(16, 8192)
    )
    connection_radius: float = field(default=3.0)
    edge_check_points: int = field(
        default=32, validator=base_validators.in_range(2, 512)
    )
    margin: float = field(default=0.0)
    seed: int = field(default=0)
    simplify: bool = field(default=True)
    max_iterations: int = field(default=2048)  # RRT-family expansions
    step_size: float = field(default=0.5)  # extension step fallback
    # reference-surface knobs (third_party/ompl/planner.py:19-41), honored:
    # final waypoint must land within goal_tolerance of the goal (our
    # planners connect to the exact goal, so any solution satisfies it —
    # validated anyway so a drifting planner cannot silently pass)
    goal_tolerance: float = field(
        default=1e-3, validator=base_validators.in_range(1e-9, 1e3)
    )
    # wall-time budget for the shortcut simplification pass
    simplification_timeout: float = field(
        default=1.0, validator=base_validators.in_range(1e-6, 1e6)
    )
    # round-selection objective: "length" (PathLengthOptimizationObjective),
    # "max_min_clearance" (MaximizeMinClearanceObjective, scored on the
    # inflated-grid EDT), "mechanical_work" (MechanicalWorkOptimization-
    # Objective — no elevation term in SE2, reduces to path length)
    optimization_objective: str = field(
        default="length",
        validator=base_validators.in_(
            [
                "length",
                "PathLengthOptimizationObjective",
                "max_min_clearance",
                "MaximizeMinClearanceObjective",
                "mechanical_work",
                "MechanicalWorkOptimizationObjective",
            ]
        ),
    )
    # stop refinement rounds once the objective is at least this good
    # (OMPL's ProblemDefinition objective threshold). Default None =
    # never satisfied: the reference front-end declares this knob with
    # default 1.0 but never passes it to OMPL (planner.py:36 reads it,
    # nothing consumes it), so binding a 1.0 threshold by default would
    # cancel requested optimize_rounds on sub-metre paths where the
    # reference refines for the full budget.
    optimization_objective_threshold: Optional[float] = field(
        default=None, validator=base_validators.in_range(1e-9, 1e3)
    )


# ---------------------------------------------------------------------------
# roadmap kernel (PRM family + BIT* batches)
# ---------------------------------------------------------------------------


def build_edge_weights(
    blocked, origin_xy, resolution, pts, connection_radius,
    edge_check_points: int, knn_cap: int = 0,
):
    """[M, M] roadmap edge-weight tensor: euclidean length where the
    straight segment is collision-free, within ``connection_radius``, and
    both endpoints are free; +inf elsewhere. ``knn_cap`` > 0 keeps an
    edge only if it is within either endpoint's ``knn_cap`` nearest
    connections (OMPL PRM's max_nearest_neighbors). Shared by the
    single-source roadmap kernel and the fleet planner (trace inside
    jit)."""
    M = pts.shape[0]
    node_free = point_free(blocked, origin_xy, resolution, pts)
    diff = pts[:, None, :] - pts[None, :, :]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))  # [M, M]
    seg_ok = segment_free(
        blocked, origin_xy, resolution, pts[:, None, :], pts[None, :, :],
        edge_check_points,
    )
    connected = (
        seg_ok
        & (dist <= connection_radius)
        & node_free[:, None]
        & node_free[None, :]
        & (dist > 0)
    )
    if knn_cap > 0:
        k = min(knn_cap, M - 1)
        cand = jnp.where(connected, dist, jnp.inf)
        kth = jnp.sort(cand, axis=1)[:, k - 1]  # k-th nearest per row
        in_knn = cand <= kth[:, None]
        connected = connected & (in_knn | in_knn.T)
    return jnp.where(connected, dist, jnp.inf)


def minplus_relax(W, d0, p0, num_iters: int):
    """Batched min-plus Bellman-Ford: ``d[i,k] = min_j d[i,j] + W[j,k]``
    for ``num_iters`` rounds. ``d0``/``p0`` are [N, M] initial distance /
    predecessor tables (N = source count)."""

    def relax(carry, _):
        d, p = carry
        cand = d[:, :, None] + W[None, :, :]  # [N, M(j), M(k)]
        best_j = jnp.argmin(cand, axis=1)  # [N, M]
        best_d = jnp.min(cand, axis=1)
        improved = best_d < d
        d = jnp.where(improved, best_d, d)
        p = jnp.where(improved, best_j.astype(jnp.int32), p)
        return (d, p), None

    (d, p), _ = jax.lax.scan(relax, (d0, p0), None, length=num_iters)
    return d, p


@partial(
    jax.jit,
    static_argnames=("edge_check_points", "num_relax_iters", "knn_cap"),
)
def _graph_shortest_path(
    blocked,
    origin_xy,
    resolution,
    pts,  # [K, 2] node positions (invalid slots parked out of bounds)
    connection_radius,
    edge_check_points: int,
    num_relax_iters: int,
    knn_cap: int = 0,
):
    """Dense roadmap solve: K x K edges -> Bellman-Ford from node 0."""
    K = pts.shape[0]
    W = build_edge_weights(
        blocked, origin_xy, resolution, pts, connection_radius,
        edge_check_points, knn_cap,
    )
    INF = jnp.float32(jnp.inf)
    dist0 = jnp.full((1, K), INF).at[0, 0].set(0.0)
    pred0 = jnp.full((1, K), -1, jnp.int32)
    dist_final, pred = minplus_relax(W, dist0, pred0, num_relax_iters)
    return dist_final[0], pred[0]


def _walk_predecessors(pred, goal_idx=1, start_idx=0):
    """Node-index chain goal -> start through a predecessor array, with
    cycle/-1 guards; returns start -> goal order or None on a broken
    chain. THE parent-walk for every planner (roadmap, tree, bidir,
    fleet) — round-5 review consolidated six copies onto it."""
    path = [goal_idx]
    while path[-1] != start_idx:
        nxt = int(pred[path[-1]])
        if nxt < 0 or nxt in path:
            return None
        path.append(nxt)
    return path[::-1]


def _trace_prm_path(pts, dist, pred) -> Optional[np.ndarray]:
    """Walk predecessors goal (node 1) -> start (node 0)."""
    if not np.isfinite(dist[1]):
        return None
    path = _walk_predecessors(pred)
    return None if path is None else pts[path]


# ---------------------------------------------------------------------------
# RRT / RRT*
# ---------------------------------------------------------------------------


def _informed_sample(key, start, goal, c_best, bounds_lo, bounds_hi):
    """Uniform sample from the prolate hyperspheroid with foci start/goal
    and transverse diameter c_best (Informed RRT*, Gammell et al. 2014):
    unit-disc sample -> scale by (c_best/2, sqrt(c_best^2 - c_min^2)/2) ->
    rotate onto the start-goal axis -> translate to the midpoint."""
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(jax.random.uniform(k1))
    ang = jax.random.uniform(k2) * 2.0 * jnp.pi
    ball = jnp.array([r * jnp.cos(ang), r * jnp.sin(ang)])
    c_min = jnp.linalg.norm(goal - start)
    r1 = c_best / 2.0
    r2 = jnp.sqrt(jnp.maximum(c_best * c_best - c_min * c_min, 1e-12)) / 2.0
    theta = jnp.arctan2(goal[1] - start[1], goal[0] - start[0])
    ct, st = jnp.cos(theta), jnp.sin(theta)
    ex = r1 * ball[0]
    ey = r2 * ball[1]
    pt = jnp.array([ct * ex - st * ey, st * ex + ct * ey]) + (start + goal) / 2.0
    return jnp.clip(pt, bounds_lo, bounds_hi)


@partial(
    jax.jit,
    static_argnames=("max_iterations", "edge_check_points", "rewire",
                     "informed", "cascade", "check_edges"),
)
def _rrt_solve(
    blocked,
    origin_xy,
    bounds_lo,
    bounds_hi,
    resolution,
    start,
    goal,
    step_size,
    goal_tolerance,
    goal_bias,
    rewire_factor,
    epsilon,
    eps_consistency,
    key,
    max_iterations: int,
    edge_check_points: int,
    rewire: bool = False,
    informed: bool = False,
    cascade: bool = False,
    check_edges: bool = True,
):
    """RRT(*) under lax.scan: fixed-capacity tree arrays, masked growth.

    ``informed``: once any node can reach the goal, draw samples from the
    prolate hyperspheroid bounded by the best known solution cost instead
    of the full workspace (Informed RRT*). ``goal_bias`` and
    ``rewire_factor`` honor the per-planner OMPL params.

    Optimizing-family extensions (all masked tensor ops, zero-cost when
    their flags are off):

      * ``epsilon`` — LBT-RRT's approximation factor (Salzman & Halperin
        2016): the choose-parent step only switches to a cheaper parent
        when it beats the nearest-node cost by more than a (1 + eps)
        factor, bounding the tree cost at (1 + eps) x the lower bound
        while skipping most rewiring work. 0.0 recovers exact RRT*.
      * ``cascade`` — RRT# / RRTX-style rewiring cascade (Arslan &
        Tsiotras 2013; Otte & Frazzoli 2015): after each insertion the
        new node also REVERSE-rewires its neighborhood (existing nodes
        adopt it as parent when cheaper), and one vectorized
        cost-propagation pass re-derives every node's cost through its
        parent edge — improvements percolate one tree level per
        iteration, keeping the tree cost-consistent.
      * ``eps_consistency`` — RRTXstatic's epsilon-consistency threshold:
        cascade updates smaller than this are suppressed.
      * ``check_edges=False`` — LazyRRT semantics: motions are NOT
        collision-checked during growth (only states); the host wrapper
        validates the traced solution path and rejects on failure."""
    if cascade and not rewire:
        raise ValueError("cascade requires rewire=True (RRT#/RRTX extend RRT*)")
    N = max_iterations + 2
    nodes = jnp.zeros((N, 2), jnp.float32).at[0].set(start)
    parents = jnp.full((N,), -1, jnp.int32)
    costs = jnp.full((N,), jnp.inf).at[0].set(0.0)
    count = jnp.int32(1)
    c_best = jnp.float32(jnp.inf)

    def body(carry, key_i):
        nodes, parents, costs, count, c_best = carry
        k1, k2, k3 = jax.random.split(key_i, 3)
        uniform = jax.random.uniform(
            k2, (2,), minval=bounds_lo, maxval=bounds_hi, dtype=jnp.float32
        )
        if informed:
            uniform = jnp.where(
                jnp.isfinite(c_best),
                _informed_sample(k3, start, goal, c_best, bounds_lo, bounds_hi),
                uniform,
            )
        sample = jnp.where(
            jax.random.uniform(k1) < goal_bias,
            goal,
            uniform,
        )
        alive = jnp.arange(N) < count
        d = jnp.where(
            alive, jnp.linalg.norm(nodes - sample, axis=1), jnp.inf
        )
        nearest = jnp.argmin(d)
        direction = sample - nodes[nearest]
        dn = jnp.maximum(jnp.linalg.norm(direction), 1e-9)
        new_pt = nodes[nearest] + direction / dn * jnp.minimum(dn, step_size)
        ok = point_free(blocked, origin_xy, resolution, new_pt)
        if check_edges:
            ok = ok & segment_free(
                blocked, origin_xy, resolution, nodes[nearest], new_pt,
                edge_check_points,
            )

        parent = nearest.astype(jnp.int32)
        new_cost = costs[nearest] + jnp.linalg.norm(new_pt - nodes[nearest])
        if rewire:
            radius = rewire_factor * 2.0 * step_size
            d_new = jnp.linalg.norm(nodes - new_pt, axis=1)
            near = alive & (d_new <= radius)
            if check_edges:
                seg_ok = segment_free(
                    blocked, origin_xy, resolution, nodes,
                    jnp.broadcast_to(new_pt, nodes.shape), edge_check_points,
                )
            else:
                seg_ok = jnp.ones((N,), bool)
            through = jnp.where(near & seg_ok, costs + d_new, jnp.inf)
            best = jnp.argmin(through)
            # LBT-RRT gate: only adopt the cheaper parent when it wins by
            # more than the (1 + eps) approximation factor (eps=0 = RRT*)
            better = through[best] * (1.0 + epsilon) < new_cost
            parent = jnp.where(better, best.astype(jnp.int32), parent)
            new_cost = jnp.where(better, through[best], new_cost)

        idx = count
        nodes = jnp.where(ok, nodes.at[idx].set(new_pt), nodes)
        parents = jnp.where(ok, parents.at[idx].set(parent), parents)
        costs = jnp.where(ok, costs.at[idx].set(new_cost), costs)
        count = count + ok.astype(jnp.int32)
        if cascade:
            # RRT# / RRTX: reverse-rewire the neighborhood through the new
            # node, then one vectorized cost-consistency propagation pass
            # (improvements percolate one tree level per iteration).
            via_new = new_cost + d_new
            adopt = (
                ok & alive & near & seg_ok
                & (via_new < costs - eps_consistency)
            )
            parents = jnp.where(adopt, idx.astype(jnp.int32), parents)
            costs = jnp.where(adopt, via_new, costs)
            psafe = jnp.maximum(parents, 0)
            pc = costs[psafe] + jnp.linalg.norm(nodes - nodes[psafe], axis=1)
            costs = jnp.where(
                (parents >= 0) & (pc < costs - eps_consistency), pc, costs
            )
        if informed:
            dg = jnp.linalg.norm(new_pt - goal)
            goal_ok = ok & (dg <= goal_tolerance)
            if check_edges:
                goal_ok = goal_ok & segment_free(
                    blocked, origin_xy, resolution, new_pt, goal,
                    edge_check_points,
                )
            c_best = jnp.where(
                goal_ok, jnp.minimum(c_best, new_cost + dg), c_best
            )
        return (nodes, parents, costs, count, c_best), None

    keys = jax.random.split(key, max_iterations)
    (nodes, parents, costs, count, c_best), _ = jax.lax.scan(
        body, (nodes, parents, costs, count, c_best), keys
    )
    # connect to goal: nearest tree node within tolerance with a free segment
    alive = jnp.arange(N) < count
    dgoal = jnp.where(alive, jnp.linalg.norm(nodes - goal, axis=1), jnp.inf)
    if check_edges:
        seg_ok = segment_free(
            blocked, origin_xy, resolution, nodes,
            jnp.broadcast_to(goal, nodes.shape), edge_check_points,
        )
    else:
        seg_ok = jnp.ones((N,), bool)
    reach = jnp.where(
        alive & seg_ok & (dgoal <= goal_tolerance), costs + dgoal, jnp.inf
    )
    best = jnp.argmin(reach)
    return nodes, parents, best.astype(jnp.int32), reach[best]


# ---------------------------------------------------------------------------
# RRT-Connect
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("max_iterations", "edge_check_points", "connect_steps"),
)
def _rrt_connect_solve(
    blocked,
    origin_xy,
    bounds_lo,
    bounds_hi,
    resolution,
    start,
    goal,
    step_size,
    key,
    max_iterations: int,
    edge_check_points: int,
    connect_steps: int = 8,
):
    """Bidirectional RRT-Connect (Kuffner & LaValle 2000) under lax.scan.

    Two fixed-capacity trees rooted at start and goal. Each iteration
    EXTENDs the active tree one step toward a uniform sample, then the
    other tree runs a bounded CONNECT (up to ``connect_steps`` greedy
    steps) toward the new node; if it arrives, the bridge joining the
    trees is recorded and all further growth is masked out.

    Returns (nodes [2,N,2], parents [2,N], found, bridge [2] node indices
    into tree 0 / tree 1 at the junction).
    """
    N = max_iterations * (connect_steps + 1) // 2 + 2
    nodes = (
        jnp.zeros((2, N, 2), jnp.float32).at[0, 0].set(start).at[1, 0].set(goal)
    )
    parents = jnp.full((2, N), -1, jnp.int32)
    counts = jnp.array([1, 1], jnp.int32)
    found = jnp.bool_(False)
    bridge = jnp.array([-1, -1], jnp.int32)

    def extend(tree, nodes, parents, counts, target, gate):
        """One EXTEND of `tree` toward target. gate masks the whole op."""
        tn = nodes[tree]
        cnt = counts[tree]
        alive = jnp.arange(N) < cnt
        d = jnp.where(alive, jnp.linalg.norm(tn - target, axis=1), jnp.inf)
        nearest = jnp.argmin(d)
        direction = target - tn[nearest]
        dn = jnp.maximum(jnp.linalg.norm(direction), 1e-9)
        new_pt = tn[nearest] + direction / dn * jnp.minimum(dn, step_size)
        ok = (
            gate
            & (cnt < N)
            & segment_free(
                blocked, origin_xy, resolution, tn[nearest], new_pt,
                edge_check_points,
            )
            & point_free(blocked, origin_xy, resolution, new_pt)
        )
        idx = jnp.minimum(cnt, N - 1)
        nodes = jnp.where(ok, nodes.at[tree, idx].set(new_pt), nodes)
        parents = jnp.where(
            ok, parents.at[tree, idx].set(nearest.astype(jnp.int32)), parents
        )
        counts = jnp.where(ok, counts.at[tree].add(1), counts)
        reached = ok & (dn <= step_size + 1e-6)
        return ok, reached, idx, new_pt, nodes, parents, counts

    def body(carry, inp):
        nodes, parents, counts, found, bridge = carry
        key_i, a = inp  # a: tree extended this iteration (alternates)
        b = 1 - a
        sample = jax.random.uniform(
            key_i, (2,), minval=bounds_lo, maxval=bounds_hi, dtype=jnp.float32
        )
        ok_a, _, idx_a, q_a, nodes, parents, counts = extend(
            a, nodes, parents, counts, sample, ~found
        )

        def connect_step(j, st):
            nodes, parents, counts, going, arrived, idx_b = st
            ok_b, reached, idx, _, nodes, parents, counts = extend(
                b, nodes, parents, counts, q_a, going
            )
            arrived = arrived | reached
            idx_b = jnp.where(reached & (idx_b < 0), idx, idx_b)
            going = going & ok_b & ~reached
            return (nodes, parents, counts, going, arrived, idx_b)

        nodes, parents, counts, _, arrived, idx_b = jax.lax.fori_loop(
            0,
            connect_steps,
            connect_step,
            (nodes, parents, counts, ok_a & ~found, jnp.bool_(False),
             jnp.int32(-1)),
        )
        hit = arrived & ~found
        new_bridge = jnp.where(
            a == 0, jnp.stack([idx_a, idx_b]), jnp.stack([idx_b, idx_a])
        ).astype(jnp.int32)
        bridge = jnp.where(hit, new_bridge, bridge)
        found = found | arrived
        return (nodes, parents, counts, found, bridge), None

    keys = jax.random.split(key, max_iterations)
    alternate = jnp.arange(max_iterations, dtype=jnp.int32) % 2
    (nodes, parents, counts, found, bridge), _ = jax.lax.scan(
        body, (nodes, parents, counts, found, bridge), (keys, alternate)
    )
    return nodes, parents, found, bridge


# ---------------------------------------------------------------------------
# front-end
# ---------------------------------------------------------------------------


class GlobalPlanner:
    """Reference-front-end-compatible global planner
    (role of ``OMPLGeometric``, ``third_party/ompl/planner.py:45-``)."""

    def __init__(
        self,
        robot: Robot,
        log_level: str = "ERROR",
        use_fcl: bool = True,
        config: Optional[GlobalPlannerConfig] = None,
        config_file: Optional[str] = None,
        **_,
    ):
        enable_persistent_compilation_cache()
        self._robot = robot
        self._config = config or GlobalPlannerConfig()
        self._defer_config_file = None
        if config_file:
            # accept BOTH file schemas: flat keys at the top level, and
            # the configure() format with the config under an 'ompl' root
            # (+ per-planner param sections) — a configure-format file
            # passed here previously no-op'd silently (its only top-level
            # key, 'ompl', is unknown to update_from_dict)
            import json as _json

            if config_file.endswith((".yaml", ".yml")):
                import yaml as _yaml

                with open(config_file) as f:
                    data = _yaml.safe_load(f) or {}
            elif config_file.endswith(".toml"):
                import tomllib as _toml

                with open(config_file, "rb") as f:
                    data = _toml.load(f)
            else:
                with open(config_file) as f:
                    data = _json.load(f)
            if isinstance(data, dict) and "ompl" in data:
                self._defer_config_file = config_file  # configure() format
            else:
                self._config.from_file(config_file)
        # accept reference-style "ompl.geometric.X" ids (planner.py:34)
        self._config.planner_id = normalize_planner_id(
            self._config.planner_id
        )
        if self._config.planner_id not in planner_registry:
            raise ValueError(
                f"Unknown planner '{self._config.planner_id}'. Available: "
                f"{sorted(planner_registry)}"
            )
        # use_fcl=False disables geometric collision checking entirely
        # (bounds-only state validity) — the reference's FCL toggle
        # (third_party/ompl/planner.py:52,81)
        self._use_fcl = bool(use_fcl)
        self._planner_params = default_planner_params(self._config.planner_id)
        self.solution: Optional[np.ndarray] = None
        self._blocked = None
        self._problem = None
        self._clearance_field = None  # lazy EDT for clearance objective
        if self._defer_config_file:
            # configure() needs _planner_params in place first
            self.configure(self._defer_config_file)

    def configure(
        self,
        config_file: str,
        root_name: Optional[str] = None,
        planner_id: Optional[str] = None,
    ) -> None:
        """Load config from a yaml/json/toml file (role of
        ``OMPLGeometric.configure``, ``third_party/ompl/planner.py:117-155``):
        the planner config lives under ``[root_name.]ompl`` and the
        per-planner params under ``[root_name.]ompl.<PlannerName>``.
        ``planner_id`` switches the active planner."""
        nested = (root_name + ".ompl") if root_name else "ompl"
        # validate BEFORE mutating self._config (the reference checks
        # membership before assignment, planner.py:139-145) so a rejected
        # configure() leaves the planner usable
        staged = GlobalPlannerConfig(**self._config.to_dict())
        staged.from_file(config_file, nested_root_name=nested)
        staged.planner_id = normalize_planner_id(
            planner_id or staged.planner_id
        )
        if staged.planner_id not in planner_registry:
            raise ValueError(
                f"Selected planner is invalid. Available supported planners "
                f"are: {sorted(self.available_planners)}"
            )
        self._config = staged
        name = self._config.planner_id
        self._planner_params = default_planner_params(name)
        if self._planner_params is not None:
            try:
                self._planner_params.from_file(
                    config_file, nested + "." + name
                )
            except KeyError:
                pass  # no per-planner section in the file: keep defaults

    @property
    def available_planners(self) -> Dict[str, Dict[str, tuple]]:
        """Planner-id -> parameter map, in the reference's introspection
        tuple shape (``config.py:30-85``)."""
        return {
            f"kompass.geometric.{name}": dict(PLANNER_PARAMS.get(name, {}))
            for name in planner_registry
        }

    @property
    def planner_id(self) -> str:
        return self._config.planner_id

    # --- per-planner params (reference planner.py:210-237) ---

    @property
    def planner_params(self):
        """The per-planner attrs config instance (auto-generated from the
        param map; see ``params.create_config_class``)."""
        return self._planner_params

    @planner_params.setter
    def planner_params(self, config) -> None:
        expected = None
        if self._config.planner_id in PLANNER_PARAMS:
            expected = create_config_class(
                self._config.planner_id, PLANNER_PARAMS[self._config.planner_id]
            )
        if expected is not None and not isinstance(config, expected):
            raise ValueError(
                f"planner_params for '{self._config.planner_id}' must be a "
                f"{expected.__name__}"
            )
        self._planner_params = config

    def _param(self, name: str, fallback):
        """Read an honored per-planner parameter with fallback."""
        if self._planner_params is not None and hasattr(
            self._planner_params, name
        ):
            return getattr(self._planner_params, name)
        return fallback

    def setup_problem(
        self,
        map_meta_data: Dict,
        start_x: float,
        start_y: float,
        start_yaw: float,
        goal_x: float,
        goal_y: float,
        goal_yaw: float,
        map_3d: Optional[np.ndarray] = None,
    ):
        """Set bounds from the map and rasterize + inflate obstacles
        (role of ``ompl.cpp:22-54``)."""
        meta = dict(map_meta_data)
        if "origin" in meta:  # nested ROS-style meta
            meta["origin_x"] = meta["origin"]["position"]["x"]
            meta["origin_y"] = meta["origin"]["position"]["y"]
        res = float(meta["resolution"])
        width = int(meta["width"])
        height = int(meta["height"])
        ox, oy = float(meta["origin_x"]), float(meta["origin_y"])

        radius = RobotGeometry.get_radius(
            self._robot.geometry_type, self._robot.geometry_params
        )
        # edge-check density must cover the LONGEST edge any planner can
        # create (connection_radius / step_size) at map resolution — a
        # fixed count sized for short edges lets long edges sample wider
        # than a wall and tunnel through it. Raised in place (the config
        # field is a minimum); validator cap 512 bounds kernel cost.
        needed = int(
            np.ceil(
                max(self._config.connection_radius, self._config.step_size)
                / max(res, 1e-9)
            )
        ) + 1
        if needed > self._config.edge_check_points:
            self._config.edge_check_points = min(needed, 512)
            if needed > 512:
                logger.warning(
                    "edge_check_points clipped to 512 (%d needed for"
                    " connection_radius %.2f at resolution %.3f); long"
                    " edges may under-sample thin obstacles",
                    needed, self._config.connection_radius, res,
                )
        obstacles = (
            np.asarray(map_3d, np.float64)
            if (map_3d is not None and self._use_fcl)
            else np.zeros((0, 3))
        )
        self._blocked = build_inflated_grid(
            obstacles, (ox, oy), width, height, res,
            radius + self._config.margin,
        )
        self._problem = dict(
            origin=np.array([ox, oy], np.float32),
            lo=np.array([ox, oy], np.float32),
            hi=np.array([ox + width * res, oy + height * res], np.float32),
            resolution=np.float32(res),
            start=np.array([start_x, start_y], np.float32),
            goal=np.array([goal_x, goal_y], np.float32),
            start_yaw=float(start_yaw),
            goal_yaw=float(goal_yaw),
        )
        self.solution = None
        self._clearance_field = None  # grid changed — EDT stale

    def solve(self) -> Optional[np.ndarray]:
        """Plan. Returns the path as an [N, 2] array (world frame) or None.

        Rounds: ``optimize_rounds`` deliberate rounds (seed, seed+1, ...)
        keeping the cheapest solution; if no round succeeds, keep retrying
        with fresh seeds until ``planning_timeout`` expires — the role the
        timeout plays in OMPL's anytime solve loop."""
        if self._problem is None:
            raise RuntimeError("Call setup_problem first")
        cfg = self._config
        solver = planner_registry[cfg.planner_id]
        deadline = time.monotonic() + max(cfg.planning_timeout, 0.0)

        best, best_cost = None, float("inf")
        round_i = 0
        while True:
            path = solver(self, self._problem, seed=cfg.seed + round_i)
            if path is not None and cfg.simplify:
                path = self._shortcut(path)
            if path is not None and not self._goal_tolerance_ok(path):
                # our planners connect to the exact goal, so this only
                # fires if a planner drifts — treat as a failed round
                logger.warning(
                    "solution endpoint misses the goal by more than "
                    "goal_tolerance=%g; round discarded", cfg.goal_tolerance,
                )
                path = None
            if path is not None:
                cost = self._objective_cost(path)
                if cost < best_cost:
                    best, best_cost = path, cost
            round_i += 1
            if time.monotonic() >= deadline:
                break  # planning_timeout strictly bounds wall time, even
                # mid-optimize_rounds (OMPL's solve(timeout) semantics)
            if best is not None and best_cost <= self._objective_stop_cost():
                break  # objective threshold met — stop refining (OMPL's
                # ProblemDefinition objective-threshold semantics)
            if round_i < cfg.optimize_rounds:
                continue  # deliberate refinement rounds run within budget
            if best is not None:
                break
        self.solution = best
        return best

    def _goal_tolerance_ok(self, path) -> bool:
        end = np.asarray(path)[-1]
        goal = np.asarray(self._problem["goal"], np.float64)
        return float(np.hypot(*(end - goal))) <= self._config.goal_tolerance

    def _objective_cost(self, path) -> float:
        """Round-selection score (lower = better) under the configured
        optimization objective."""
        obj = self._config.optimization_objective
        if obj in ("max_min_clearance", "MaximizeMinClearanceObjective"):
            return -self._min_clearance(path)
        # length + mechanical_work (no elevation term in SE2) -> arc length
        return float(np.hypot(*np.diff(np.asarray(path), axis=0).T).sum())

    def _objective_stop_cost(self) -> float:
        """Internal-cost value at which the objective threshold is met
        (-inf when no threshold is set: never satisfied)."""
        thr = self._config.optimization_objective_threshold
        if thr is None:
            return float("-inf")
        obj = self._config.optimization_objective
        if obj in ("max_min_clearance", "MaximizeMinClearanceObjective"):
            return -thr  # cost = -clearance; met when clearance >= thr
        return thr

    def _min_clearance(self, path) -> float:
        """Minimum obstacle clearance along the path, from the EDT of the
        inflated occupancy grid (clearance to the INFLATED obstacle set —
        add the robot radius + margin back for the physical distance)."""
        from .planners_trees import clearance_edt

        if self._clearance_field is None:
            self._clearance_field = clearance_edt(
                self._blocked, float(self._problem["resolution"])
            )
        res = float(self._problem["resolution"])
        origin = np.asarray(self._problem["origin"], np.float64)
        pts = np.asarray(path, np.float64)
        # sample each segment at grid pitch so a wall-grazing segment
        # cannot be missed between waypoints
        dense = [pts[0]]
        for a, b in zip(pts[:-1], pts[1:]):
            n = max(int(np.ceil(np.hypot(*(b - a)) / max(res, 1e-9))), 1)
            for t in range(1, n + 1):
                dense.append(a + (b - a) * (t / n))
        dense = np.asarray(dense)
        ij = np.clip(
            ((dense - origin) / res).astype(int),
            0,
            np.array(self._clearance_field.shape[::-1]) - 1,
        )
        return float(self._clearance_field[ij[:, 1], ij[:, 0]].min())

    def get_solution(self) -> Optional[np.ndarray]:
        return self.solution

    def solve_fleet(self, starts, goals, seed=None):
        """Plan N robots over this map in ONE device dispatch (shared
        roadmap, batched multi-source shortest paths). Beyond-reference;
        see ``planning/fleet_planner.py``. Returns a list of N paths
        (``None`` where unsolved)."""
        from .fleet_planner import solve_fleet_prm

        return solve_fleet_prm(self, starts, goals, seed=seed)

    @property
    def path_cost(self) -> float:
        """Solution arc length (role of ``ompl.cpp:77-85``)."""
        if self.solution is None or len(self.solution) < 2:
            return float("inf")
        return float(
            np.hypot(*np.diff(np.asarray(self.solution), axis=0).T).sum()
        )

    # --- helpers ---

    def _segment_free_host(self, a, b) -> bool:
        # sample count scales with segment length: shortcut candidates can
        # join vertices tens of metres apart, and the configured fixed
        # count (sized for step-length planner edges) would space samples
        # wider than a wall — declaring a through-the-wall segment free
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        res = float(self._problem["resolution"])
        length = float(np.hypot(*(b - a)))
        n = max(
            int(self._config.edge_check_points),
            int(np.ceil(length / max(res, 1e-9))) + 1,
        )
        # quantize to the next power of two: bounds the number of distinct
        # eager-op shapes this host-side check produces
        n = 1 << (n - 1).bit_length()
        return bool(
            segment_free(
                self._blocked,
                self._problem["origin"],
                self._problem["resolution"],
                jnp.asarray(a, jnp.float32),
                jnp.asarray(b, jnp.float32),
                n,
            )
        )

    def _shortcut(self, path: np.ndarray) -> np.ndarray:
        """Greedy path simplification: connect the farthest visible vertex
        (role of OMPL's simplifySolution, ``ompl.cpp:56-67``), bounded by
        ``simplification_timeout`` wall time (OMPL hands that budget to
        simplifySolution); on expiry the remaining tail is kept verbatim."""
        path = np.asarray(path)
        deadline = time.monotonic() + max(
            self._config.simplification_timeout, 0.0
        )
        out = [path[0]]
        i = 0
        while i < len(path) - 1:
            if time.monotonic() >= deadline:
                out.extend(path[i + 1 :])
                logger.warning(
                    "simplification_timeout=%gs expired with %d vertices "
                    "unsimplified",
                    self._config.simplification_timeout, len(path) - 1 - i,
                )
                return np.asarray(out)
            j = len(path) - 1
            while j > i + 1 and not self._segment_free_host(path[i], path[j]):
                j -= 1
            out.append(path[j])
            i = j
        return np.asarray(out)


# --- planner implementations (registry) -----------------------------------


def _solve_prm(planner: GlobalPlanner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    key = jax.random.PRNGKey(seed)
    K = cfg.num_samples
    relax_iters = min(K, 128)
    pts = jax.random.uniform(
        key, (K, 2), minval=prob["lo"], maxval=prob["hi"], dtype=jnp.float32
    )
    pts = pts.at[0].set(jnp.asarray(prob["start"])).at[1].set(
        jnp.asarray(prob["goal"])
    )
    # LazyPRM's `range` param (OMPL: max edge length) overrides the
    # connection radius; 0.0 = inherit the config radius
    radius = planner._param("range", 0.0) or cfg.connection_radius
    # the check density must cover the radius ACTUALLY used: PRM* swaps
    # in r_star and LazyPRM's `range` param can exceed
    # connection_radius, which is what sized cfg.edge_check_points —
    # undersampled long edges can tunnel through thin inflated walls
    from .planners_ext import _edge_checks_for_radius

    dist, pred = _graph_shortest_path(
        planner._blocked,
        prob["origin"],
        prob["resolution"],
        pts,
        jnp.float32(radius),
        edge_check_points=_edge_checks_for_radius(
            cfg, float(prob["resolution"]), float(radius)
        ),
        num_relax_iters=relax_iters,
        knn_cap=int(planner._param("max_nearest_neighbors", 0) or 0),
    )
    path = _trace_prm_path(np.asarray(pts), np.asarray(dist), np.asarray(pred))
    if path is not None and len(path) >= relax_iters:
        # Bellman-Ford ran relax_iters rounds; a solution using that many
        # hops may be truncated/suboptimal
        logger.warning(
            "PRM relaxation cap (%d iters) binds: solution uses %d hops; "
            "consider fewer samples or a larger connection radius",
            relax_iters,
            len(path),
        )
    return path


def _solve_rrt(planner: GlobalPlanner, prob, seed=0, rewire=False,
               informed=False, cascade=False, check_edges=True,
               use_epsilon=False):
    cfg = planner._config
    key = jax.random.PRNGKey(seed)
    step = planner._param("range", 0.0) or cfg.step_size
    # check density covers the LONGEST edge actually checked: the
    # steering extension is <= step (the `range` param can exceed the
    # step_size that sized the default), but with rewiring the
    # choose-parent/rewire edges span up to rewire_factor * 2 * step —
    # sizing for step alone spaces those checks up to ~2x the map
    # resolution and a one-cell inflated wall can slip between them
    from .planners_ext import _edge_checks_for_radius

    checked_span = float(step)
    if rewire:
        checked_span *= 2.0 * max(
            float(planner._param("rewire_factor", 1.0)), 0.5
        )
    checks = _edge_checks_for_radius(
        cfg, float(prob["resolution"]), checked_span
    )
    epsilon = float(planner._param("epsilon", 0.4)) if use_epsilon else 0.0
    nodes, parents, best, cost = _rrt_solve(
        planner._blocked,
        prob["origin"],
        prob["lo"],
        prob["hi"],
        prob["resolution"],
        jnp.asarray(prob["start"]),
        jnp.asarray(prob["goal"]),
        jnp.float32(step),
        jnp.float32(step),
        jnp.float32(planner._param("goal_bias", 0.1)),
        jnp.float32(planner._param("rewire_factor", 1.0)),
        jnp.float32(epsilon),
        jnp.float32(planner._param("epsilon_consistency", 0.0)
                    if cascade else 0.0),
        key,
        max_iterations=cfg.max_iterations,
        edge_check_points=checks,
        rewire=rewire,
        informed=informed,
        cascade=cascade,
        check_edges=check_edges,
    )
    if not np.isfinite(float(cost)):
        return None
    nodes = np.asarray(nodes)
    parents = np.asarray(parents)
    path = _walk_predecessors(parents, int(best), 0)
    if path is None:
        return None
    pts = np.vstack([nodes[path], prob["goal"][None, :]])
    if not check_edges:
        # lazy semantics: growth skipped motion checks; validate the traced
        # solution now (OMPL's lazy path-validation step). On failure,
        # repair by re-solving the same seed with motion checks on — the
        # device analog of OMPL's check-on-demand edge removal loop (the
        # optimistic pass costs ~nothing; the checked pass is the repair).
        for a, b in zip(pts[:-1], pts[1:]):
            if not planner._segment_free_host(a, b):
                return _solve_rrt(
                    planner, prob, seed=seed, rewire=rewire,
                    informed=informed, cascade=cascade, check_edges=True,
                    use_epsilon=use_epsilon,
                )
    return pts


def _solve_prm_star(planner: GlobalPlanner, prob, seed=0) -> Optional[np.ndarray]:
    """PRM*: the connection radius shrinks with sample count as
    gamma * sqrt(log n / n) (Karaman & Frazzoli 2011, d=2), with gamma
    derived from the measured free-space area of the inflated grid and
    scaled by the honored ``rewire_factor`` param."""
    cfg = planner._config
    n = cfg.num_samples
    blocked = np.asarray(planner._blocked)
    res = float(prob["resolution"])
    mu_free = max(float((~blocked).sum()) * res * res, 1e-6)
    rewire = float(planner._param("rewire_factor", 1.1))
    gamma = rewire * 2.0 * np.sqrt(1.5) * np.sqrt(mu_free / np.pi)
    r_star = float(gamma * np.sqrt(np.log(max(n, 2)) / n))
    saved = cfg.connection_radius
    try:
        cfg.connection_radius = max(r_star, 2.0 * res)
        return _solve_prm(planner, prob, seed=seed)
    finally:
        cfg.connection_radius = saved


def _solve_rrt_connect(planner: GlobalPlanner, prob, seed=0) -> Optional[np.ndarray]:
    cfg = planner._config
    key = jax.random.PRNGKey(seed)
    step = planner._param("range", 0.0) or cfg.step_size
    from .planners_ext import _edge_checks_for_radius

    checks = _edge_checks_for_radius(
        cfg, float(prob["resolution"]), float(step)
    )
    nodes, parents, found, bridge = _rrt_connect_solve(
        planner._blocked,
        prob["origin"],
        prob["lo"],
        prob["hi"],
        prob["resolution"],
        jnp.asarray(prob["start"]),
        jnp.asarray(prob["goal"]),
        jnp.float32(step),
        key,
        max_iterations=cfg.max_iterations,
        edge_check_points=checks,
        connect_steps=int(planner._param("connect_steps", 8)),
    )
    if not bool(found):
        return None
    nodes = np.asarray(nodes)
    parents = np.asarray(parents)
    bridge = np.asarray(bridge)

    c0 = _walk_predecessors(parents[0], int(bridge[0]), 0)  # start->junction
    c1 = _walk_predecessors(parents[1], int(bridge[1]), 0)  # goal->junction
    if c0 is None or c1 is None:
        return None
    pts = np.concatenate([nodes[0][c0], nodes[1][c1[::-1]]])
    return pts


from .planners_ext import (  # noqa: E402 — solvers need _graph_shortest_path
    solve_bitstar,
    solve_est,
    solve_fmt,
    solve_kpiece,
    solve_sst,
)
from .planners_trees import (  # noqa: E402
    solve_abitstar,
    solve_aitstar,
    solve_bfmt,
    solve_biest,
    solve_bkpiece,
    solve_lbkpiece,
    solve_pdst,
    solve_proj_est,
    solve_sbl,
    solve_stride,
    solve_trrt,
)

planner_registry: Dict[str, Callable] = {
    "PRM": _solve_prm,
    "PRMstar": _solve_prm_star,
    "LazyPRM": _solve_prm,  # the device batch-checks all edges up front; laziness
    # buys nothing when the whole edge matrix is one fused kernel
    "LazyPRMstar": _solve_prm_star,  # same collapse at the PRM* radius
    "RRT": partial(_solve_rrt, rewire=False),
    "RRTConnect": _solve_rrt_connect,
    "RRTstar": partial(_solve_rrt, rewire=True),
    "InformedRRTstar": partial(_solve_rrt, rewire=True, informed=True),
    # optimizing-family variants, all static-flag modes of the one RRT
    # kernel (see _rrt_solve's docstring for the algorithm mapping)
    "LazyRRT": partial(_solve_rrt, check_edges=False),
    "LBTRRT": partial(_solve_rrt, rewire=True, use_epsilon=True),
    "LazyLBTRRT": partial(
        _solve_rrt, rewire=True, use_epsilon=True, check_edges=False
    ),
    "RRTsharp": partial(_solve_rrt, rewire=True, informed=True, cascade=True),
    "RRTXstatic": partial(
        _solve_rrt, rewire=True, informed=True, cascade=True
    ),
    "EST": solve_est,
    "KPIECE1": solve_kpiece,
    "SST": solve_sst,
    "FMTstar": solve_fmt,
    "FMT": solve_fmt,  # OMPL class name (the reference binds "FMT")
    "BITstar": solve_bitstar,
    "TRRT": solve_trrt,  # the reference front-end's default planner
    "BiEST": solve_biest,
    "SBL": solve_sbl,
    "BKPIECE1": solve_bkpiece,
    "LBKPIECE1": solve_lbkpiece,
    "ProjEST": solve_proj_est,
    "PDST": solve_pdst,
    "STRIDE": solve_stride,
    "BFMT": solve_bfmt,
    "ABITstar": solve_abitstar,
    "AITstar": solve_aitstar,
}


def normalize_planner_id(planner_id: str) -> str:
    """Accept reference-style ids (``ompl.geometric.TRRT``,
    ``kompass.geometric.TRRT``) alongside bare OMPL class names."""
    return planner_id.rsplit(".", 1)[-1]


# reference-compatible aliases
OMPLGeometric = GlobalPlanner
OMPLGeometricConfig = GlobalPlannerConfig
