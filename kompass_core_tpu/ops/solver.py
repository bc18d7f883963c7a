"""The DWA control tick as a single jitted tensor program.

This is the redesign of the reference's hot path — the three
components that dominate its benchmarks (``trajectory_sampler.cpp``
rollout+collision loops, ``cost_evaluator[_gpu].cpp`` cost kernels, and the
argmin reduction) — fused into one XLA program over SoA arrays:

    grid [S] -> rollout [S, T] (closed-form cumsum, no sequential loop)
             -> masked point-robot collision vs obstacle points [S, T]
             -> drop / truncate semantics as masks (no ragged shapes)
             -> five cost kernels + custom costs -> weighted sum [S]
             -> argmin (first-minimum-wins, matching the reference's
                serial scan in ``cost_evaluator.cpp:102-106``)

Design notes:
  * All shapes are static (`SolverSpec`); the adaptive prediction horizon is
    a dynamic ``active_points`` scalar masking the trailing steps — changing
    the horizon never recompiles (the reference resizes buffers instead,
    ``trajectory_sampler.cpp:316-326``).
  * Colliding samples are masked with +inf cost instead of being dropped
    (the reference compacts them out, ``trajectory_sampler.cpp:157-177``);
    ordering is preserved so the argmin picks the same winner.
  * Collision model: circumscribed robot radius + voxel-inflation margin vs
    raw obstacle points, replacing FCL-vs-octree
    (``collision_check.cpp:149-163``); see SURVEY §7 for the rationale.
  * Everything is float32; the velocity grid itself is produced on host in
    float64 (`ops/window.py`) for exact grid-placement parity.

Cost formula contracts are copied exactly from ``cost_evaluator.cpp:111-233``
(the golden-value unit tests in ``tests/test_costs.py`` pin them down).
"""

import dataclasses
import functools as _functools
from functools import partial
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .window import MIN_VEL

# plain Python floats: creating jnp arrays at import time would initialize
# the XLA backend and break jax.distributed.initialize in multi-host runs
_BIG = 1e8
_INF = float("inf")

# Default voxel-inflation margin as a multiple of the map/octree resolution.
# Empirically calibrated against an exact circle-vs-voxel-box model
# (tests/test_collision_model.py): 0.7*res maximizes keep/drop agreement
# with the reference's octree collision (>96%) while keeping unsafe
# disagreements (missed contacts) ~1%.
COLLISION_MARGIN_FACTOR = 0.7


@dataclasses.dataclass(frozen=True, eq=True)
class SolverSpec:
    """Static compile-time geometry of the solver."""

    is_omni: bool
    n_vx: int
    n_vy: int
    n_omega: int
    max_points: int  # T: points per trajectory (>= 2)
    num_ctrl_points: int  # control horizon in steps
    scan_size: int  # padded obstacle-point capacity
    seg_size: int  # padded tracked-segment capacity
    drop_samples: bool = True
    # True: the packed window block carries (current_vel[3], limits[9]) and
    # the dynamic window is computed ON DEVICE (fleet mode — removes the
    # per-robot host grid walk). False: host-built float64-exact window
    # arrays (single-robot parity mode).
    device_window: bool = False
    # Exact oriented-rectangle collision for BOX robots: (half_length_x,
    # half_width_y) body half-extents. None = point-robot + calibrated
    # circle (radius + margin), the default for CYLINDER/SPHERE. The
    # reference FCL-checks the true body shape (collision_check.h:91-136);
    # a circumscribed circle blocks corridors a box robot can pass
    # lengthwise, so box robots get the exact check.
    collision_box: Optional[Tuple[float, float]] = None
    # Heterogeneous-fleet mode: the box half-extents arrive as a TRACED
    # [2] argument (``collision_box_dyn``) instead of the static spec
    # field, so one compiled program serves mixed per-robot shapes. A
    # circle robot passes half-extents (0, 0) with its radius folded into
    # ``collision_margin`` — the box surface distance then degenerates to
    # the exact point distance, reproducing the circle model bit-for-bit.
    dynamic_box: bool = False
    # Moving-obstacle mode (beyond-reference; the reference's rollout
    # assumes a static world, trajectory_sampler.cpp:118-179): each
    # obstacle point carries a world-frame velocity and the collision /
    # obstacle-cost sweeps evaluate it at its PREDICTED position
    # obs + v * t * dt for rollout step t. Costs two extra FMAs per
    # (pose, obstacle) pair in the hot sweep when enabled; with the flag
    # off the compiled program is unchanged.
    moving_obstacles: bool = False

    @property
    def num_samples(self) -> int:
        if self.is_omni:
            return self.n_vx * (self.n_vy + self.n_omega)
        return self.n_vx * self.n_omega


class SolverParams(NamedTuple):
    """Dynamic (non-recompiling) solver parameters, all jnp/np scalars."""

    time_step: jnp.ndarray
    robot_radius: jnp.ndarray
    collision_margin: jnp.ndarray  # voxel inflation added to the radius
    weight_path: jnp.ndarray
    weight_goal: jnp.ndarray
    weight_obstacles: jnp.ndarray
    weight_smoothness: jnp.ndarray
    weight_jerk: jnp.ndarray
    acc_limit_vx: jnp.ndarray
    acc_limit_vy: jnp.ndarray
    acc_limit_omega: jnp.ndarray
    max_obstacles_dist: jnp.ndarray  # range at which obstacle cost hits 0

    @classmethod
    def create(
        cls,
        time_step,
        robot_radius,
        collision_margin,
        weights,  # dict-like with the 5 cost weights
        acc_limits,  # (vx_acc, vy_acc, omega_acc)
        max_obstacles_dist,
    ) -> "SolverParams":
        f = jnp.float32
        return cls(
            time_step=f(time_step),
            robot_radius=f(robot_radius),
            collision_margin=f(collision_margin),
            weight_path=f(weights["reference_path_distance_weight"]),
            weight_goal=f(weights["goal_distance_weight"]),
            weight_obstacles=f(weights["obstacles_distance_weight"]),
            weight_smoothness=f(weights["smoothness_weight"]),
            weight_jerk=f(weights["jerk_weight"]),
            acc_limit_vx=f(acc_limits[0]),
            acc_limit_vy=f(acc_limits[1]),
            acc_limit_omega=f(acc_limits[2]),
            max_obstacles_dist=f(max_obstacles_dist),
        )


class SolveResult(NamedTuple):
    found: jnp.ndarray  # bool scalar
    cost: jnp.ndarray  # f32 scalar (winning total cost)
    best_index: jnp.ndarray  # int32 scalar
    velocities: jnp.ndarray  # [T-1, 3] winning velocity sequence
    path: jnp.ndarray  # [T, 2] winning rollout
    costs: jnp.ndarray  # [S] total masked costs (inf = inadmissible)
    num_admissible: jnp.ndarray  # int32 scalar


# ---------------------------------------------------------------------------
# grid construction
# ---------------------------------------------------------------------------


def _device_window(spec: SolverSpec, current_vel, limits, time_step):
    """On-device dynamic window (fleet mode): jnp replication of the host
    grid walk in ``ops/window.py`` (reference
    ``UpdateReachableVelocityRange``, ``trajectory_sampler.cpp:328-372``).

    Values are ``min + k*res`` instead of the sequential accumulation —
    identical within float rounding; the inclusion mask carries a small
    tolerance for the boundary point.
    """
    vx0, vy0, w0 = current_vel[0], current_vel[1], current_vel[2]
    (vx_max_l, vx_acc, vx_dec, vy_max_l, vy_acc, vy_dec,
     w_max_l, w_acc, w_dec) = [limits[i] for i in range(9)]
    dt = time_step

    def axis(v0, vmax, acc, dec, n):
        # clamp the reported velocity into the limit band first: in a
        # mixed fleet a non-omni robot carries zeroed vy limits, and an
        # odometry-noise vy0 of +1e-6 would otherwise give lo > hi and an
        # ALL-invalid axis (losing its vy=0 straight samples entirely —
        # the host walk never does, ops/window.py non-omni branch)
        v0 = jnp.clip(v0, -vmax, vmax)
        hi = jnp.minimum(vmax, v0 + acc * dt)
        lo = jnp.maximum(-vmax, v0 - dec * dt)
        res = jnp.maximum((hi - lo) / jnp.maximum(n - 1, 1), 0.001)
        vals = lo + jnp.arange(n, dtype=jnp.float32) * res
        mask = vals <= hi + 1e-5 * jnp.abs(hi) + 1e-7
        return vals.astype(jnp.float32), mask

    vx_vals, vx_mask = axis(vx0, vx_max_l, vx_acc, vx_dec, spec.n_vx)
    if spec.is_omni:
        vy_vals, vy_mask = axis(vy0, vy_max_l, vy_acc, vy_dec, spec.n_vy)
    else:
        vy_vals = jnp.zeros(spec.n_vy, jnp.float32)
        vy_mask = jnp.zeros(spec.n_vy, bool).at[0].set(True)
    w_vals, w_mask = axis(w0, w_max_l, w_acc, w_dec, spec.n_omega)
    from .window import VelocityWindow

    return VelocityWindow(vx_vals, vx_mask, vy_vals, vy_mask, w_vals, w_mask)


def _build_velocity_grid(spec: SolverSpec, window) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Expand the (vx, vy, omega) axis grids into per-sample velocities
    [S, 3] + validity [S], matching the reference's single-thread sampling
    order exactly (vx outer loop ascending; for omni: the vy block precedes
    the omega block per vx — ``trajectory_sampler.cpp:254-273``)."""
    vx_vals, vx_mask, vy_vals, vy_mask, w_vals, w_mask = window
    vx_vals = jnp.asarray(vx_vals)
    vx_mask = jnp.asarray(vx_mask)
    vy_vals = jnp.asarray(vy_vals)
    vy_mask = jnp.asarray(vy_mask)
    w_vals = jnp.asarray(w_vals)
    w_mask = jnp.asarray(w_mask)

    min_vel = jnp.float32(MIN_VEL)

    if not spec.is_omni:
        # S = n_vx * n_omega, sample s = (i_vx, j_omega)
        vx = jnp.repeat(vx_vals, spec.n_omega)
        w = jnp.tile(w_vals, spec.n_vx)
        vy = jnp.zeros_like(vx)
        valid = (
            jnp.repeat(vx_mask, spec.n_omega)
            & jnp.tile(w_mask, spec.n_vx)
            & (jnp.abs(vx) >= min_vel)
        )
        vels = jnp.stack([vx, vy, w], axis=-1)
        return vels, valid

    # omni: per vx, first the (vx, vy, 0) block then the (vx, 0, omega) block
    blk = spec.n_vy + spec.n_omega
    vx = jnp.repeat(vx_vals, blk)
    vx_m = jnp.repeat(vx_mask, blk)
    vy_blk = jnp.concatenate([vy_vals, jnp.zeros(spec.n_omega, jnp.float32)])
    w_blk = jnp.concatenate([jnp.zeros(spec.n_vy, jnp.float32), w_vals])
    vy_m_blk = jnp.concatenate([vy_mask, jnp.ones(spec.n_omega, bool)])
    w_m_blk = jnp.concatenate([jnp.ones(spec.n_vy, bool), w_mask])
    is_omega_blk = jnp.concatenate(
        [jnp.zeros(spec.n_vy, bool), jnp.ones(spec.n_omega, bool)]
    )
    vy = jnp.tile(vy_blk, spec.n_vx)
    w = jnp.tile(w_blk, spec.n_vx)
    blk_valid = jnp.tile(vy_m_blk & w_m_blk, spec.n_vx)
    is_omega = jnp.tile(is_omega_blk, spec.n_vx)

    # omega sub-block requires |vx| >= MIN_VEL (trajectory_sampler.cpp:263);
    # any sample with all velocity components ~0 is skipped
    # (trajectory_sampler.cpp:122-125)
    nonzero = (
        (jnp.abs(vx) >= min_vel)
        | (jnp.abs(vy) >= min_vel)
        | (jnp.abs(w) >= min_vel)
    )
    valid = (
        vx_m
        & blk_valid
        & nonzero
        & (~is_omega | (jnp.abs(vx) >= min_vel))
    )
    vels = jnp.stack([vx, vy, w], axis=-1)
    return vels, valid


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------


def _rollout(spec: SolverSpec, params: SolverParams, state, vels):
    """Constant-velocity unicycle rollout, closed form.

    Kinematics per reference ``datatypes/path.h:24-30``: position update at
    step t uses the pre-update heading yaw_t = yaw0 + omega * t * dt, so the
    whole [S, T] rollout is a cumulative sum of rotated displacements — no
    sequential dependency for XLA to serialize.
    """
    T = spec.max_points
    dt = params.time_step
    x0, y0, yaw0 = state[0], state[1], state[2]
    t = jnp.arange(T - 1, dtype=jnp.float32)  # step index
    vx = vels[:, 0:1]
    vy = vels[:, 1:2]
    w = vels[:, 2:3]
    yaw_t = yaw0 + w * t[None, :] * dt  # [S, T-1] heading before each step
    c = jnp.cos(yaw_t)
    s = jnp.sin(yaw_t)
    dx = (vx * c - vy * s) * dt
    dy = (vx * s + vy * c) * dt
    # prefix sums as a triangular matmul instead of a sequential scan
    # (T is tiny, the matmul is ~free).
    # precision=HIGHEST is REQUIRED: preferred_element_type only sets the
    # accumulator — at default precision a GPU runs an f32 dot in TF32,
    # which truncates the dx/dy INPUTS (~2^-11 relative, mm-scale
    # position error over 30 steps) where CPU-based parity tests cannot
    # see it (XLA CPU is true f32).
    tril = jnp.tril(jnp.ones((T - 1, T - 1), jnp.float32)).T
    px = jnp.concatenate(
        [
            jnp.full((vels.shape[0], 1), x0),
            x0 + jnp.dot(
                dx, tril, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            ),
        ],
        axis=1,
    )
    py = jnp.concatenate(
        [
            jnp.full((vels.shape[0], 1), y0),
            y0 + jnp.dot(
                dy, tril, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            ),
        ],
        axis=1,
    )
    return px, py  # each [S, T]


# ---------------------------------------------------------------------------
# collision + admissibility
# ---------------------------------------------------------------------------


def _pad_sweep_pow2(x):
    """Pad a 1-D sweep operand to the next power-of-two length (>=128)
    with +1e8 sentinels.

    The sentinel never wins a min, so padding changes no result. The
    rule was tuned on the accelerator this code was first written for
    and has not been measured on a GPU (ROADMAP Speed item 3).
    """
    n = x.shape[-1]
    target = max(128, 1 << (n - 1).bit_length())
    if target == n:
        return x
    return jnp.pad(x, (0, target - n), constant_values=_BIG)


def _min_obstacle_dist_sq(px, py, obs_xy, pt_mask):
    """[S, T] -> per-point min squared distance to any obstacle point.

    Padded obstacle slots sit at +1e8 so they never win the min. Masked
    trajectory points get +inf.
    """
    ox = _pad_sweep_pow2(obs_xy[:, 0])
    oy = _pad_sweep_pow2(obs_xy[:, 1])
    # [S, T, O] fused reduce — XLA fuses the subtract/square into the min
    # reduction, so the cube never materializes in HBM.
    d2 = jnp.min(
        (px[:, :, None] - ox[None, None, :]) ** 2
        + (py[:, :, None] - oy[None, None, :]) ** 2,
        axis=-1,
    )
    return jnp.where(pt_mask[None, :], d2, _INF)


def _min_obstacle_dist_sq_moving(px, py, obs_xy, obs_vel, time_step, pt_mask):
    """[S, T] -> per-point min squared distance to any obstacle point at
    its PREDICTED position ``obs + v * t * dt`` (constant-velocity
    obstacle model). With ``obs_vel == 0`` this is arithmetically
    identical to ``_min_obstacle_dist_sq`` (adding 0.0 is exact), so the
    static model is the zero-velocity special case bit-for-bit.

    Padded obstacle slots sit at +1e8 with zero velocity, so they never
    win the min.
    """
    T = px.shape[1]
    ox = _pad_sweep_pow2(obs_xy[:, 0])
    oy = _pad_sweep_pow2(obs_xy[:, 1])
    # velocity pads are ZERO (a +1e8 velocity would march a pad slot
    # through the workspace)
    vx = jnp.pad(obs_vel[:, 0], (0, ox.shape[0] - obs_vel.shape[0]))
    vy = jnp.pad(obs_vel[:, 1], (0, oy.shape[0] - obs_vel.shape[0]))
    t = (jnp.arange(T, dtype=jnp.float32) * time_step)[None, :, None]
    # [S, T, O] fused reduce; the obstacle track ox + vx*t adds two FMAs
    # per pair on top of the static sweep, still fused.
    d2 = jnp.min(
        (px[:, :, None] - (ox[None, None, :] + vx[None, None, :] * t)) ** 2
        + (py[:, :, None] - (oy[None, None, :] + vy[None, None, :] * t)) ** 2,
        axis=-1,
    )
    return jnp.where(pt_mask[None, :], d2, _INF)


def _min_box_dist_sq(spec, params, state, vels, px, py, obs_xy, pt_mask,
                     box_hl=None, box_hw=None, obs_vel=None):
    """Exact oriented-rectangle surface distance: [S, T] min squared
    distance from the robot BOX body (half extents spec.collision_box or
    the traced ``box_hl``/``box_hw`` in dynamic-box mode, heading
    yaw0 + omega*t*dt at pose t) to any obstacle point.

    Zero inside the footprint. Role of the reference's FCL box collision
    object (``collision_check.cpp:118-163``) without the broadphase: the
    rotate-into-body-frame + axis clamp is ~4 extra f32 ops per
    (pose, obstacle) pair on top of the point sweep.
    """
    if box_hl is None:
        hl, hw = spec.collision_box
    else:
        hl, hw = box_hl, box_hw
    T = px.shape[1]
    yaw = state[2] + vels[:, 2:3] * jnp.arange(T, dtype=jnp.float32)[None, :] * params.time_step
    c = jnp.cos(yaw)[:, :, None]
    s = jnp.sin(yaw)[:, :, None]
    ox = _pad_sweep_pow2(obs_xy[:, 0])
    oy = _pad_sweep_pow2(obs_xy[:, 1])
    obx = ox[None, None, :]
    oby = oy[None, None, :]
    if obs_vel is not None:
        # moving-obstacle mode: obstacle position at rollout step t
        # (see _min_obstacle_dist_sq_moving; zero velocity == static)
        vxo = jnp.pad(obs_vel[:, 0], (0, ox.shape[0] - obs_vel.shape[0]))
        vyo = jnp.pad(obs_vel[:, 1], (0, oy.shape[0] - obs_vel.shape[0]))
        t = (jnp.arange(T, dtype=jnp.float32) * params.time_step)[
            None, :, None
        ]
        obx = obx + vxo[None, None, :] * t
        oby = oby + vyo[None, None, :] * t
    dxw = obx - px[:, :, None]
    dyw = oby - py[:, :, None]
    bx = c * dxw + s * dyw  # body-frame obstacle coords
    by = -s * dxw + c * dyw
    ex = jnp.maximum(jnp.abs(bx) - hl, 0.0)
    ey = jnp.maximum(jnp.abs(by) - hw, 0.0)
    d2 = jnp.min(ex * ex + ey * ey, axis=-1)
    return jnp.where(pt_mask[None, :], d2, _INF)


def _admissibility(spec, params, d2_obs, active_points, valid,
                   surface_distance=False):
    """Drop / truncate semantics from ``trajectory_sampler.cpp:118-178``
    expressed as masks.

    The reference rolls each sample forward, checks collision at every
    updated pose (poses 1 .. active-1), and on first collision either drops
    the sample or zero-pads it from the last free point.

    ``d2_obs``: shared per-point min squared obstacle distance [S, T]
    (masked to t < active_points); also consumed by the obstacle cost — one
    obstacle sweep serves both, like the reference GPU backend's single
    upload + two kernels. With ``surface_distance`` (box collision mode)
    the distance is already measured from the body surface, so only the
    margin is compared.
    """
    S, T = d2_obs.shape
    t_idx = jnp.arange(T)
    # poses checked by the reference loop: t in [1, active_points - 1]
    check_mask = (t_idx >= 1) & (t_idx <= active_points - 1)
    if surface_distance:
        # distance is from the body surface; d2 == 0 means inside the
        # footprint, which must collide even with a zero margin
        r = jnp.maximum(params.collision_margin, 1e-6)
    else:
        r = params.robot_radius + params.collision_margin
    collide = (d2_obs < r * r) & check_mask[None, :]

    any_col = jnp.any(collide, axis=1)
    first_bad_pose = jnp.where(any_col, jnp.argmax(collide, axis=1), T + 1)
    i_col = first_bad_pose - 1  # step index at which the loop broke
    last_free = jnp.where(i_col > 0, i_col - 1, active_points - 1)

    truncate_ok = (
        (not spec.drop_samples)
        & any_col
        & (last_free > spec.num_ctrl_points)
        & (last_free < active_points - 1)
    )
    admissible = valid & (~any_col | truncate_ok)
    return admissible, truncate_ok, i_col, last_free


def _apply_truncation(px, py, vels, truncate_ok, i_col, last_free, T):
    """Zero velocities from the collision step onward and freeze the path at
    the last free point (``trajectory_sampler.cpp:157-168`` semantics,
    including the reference's exact fill point path[last_free])."""
    S = px.shape[0]
    t_idx = jnp.arange(T)[None, :]
    j_idx = jnp.arange(T - 1)[None, :]

    # per-row pick as a one-hot masked sum instead of take_along_axis (a
    # per-row gather under the fleet vmap); at T<=~64 the [S, T]
    # multiply-add is effectively free
    lf_sel = t_idx == last_free[:, None]
    lf_x = jnp.sum(jnp.where(lf_sel, px, 0.0), axis=1, keepdims=True)
    lf_y = jnp.sum(jnp.where(lf_sel, py, 0.0), axis=1, keepdims=True)
    freeze = truncate_ok[:, None] & (t_idx > i_col[:, None])
    px = jnp.where(freeze, lf_x, px)
    py = jnp.where(freeze, lf_y, py)

    zero_vel = truncate_ok[:, None] & (j_idx >= i_col[:, None])  # [S, T-1]
    vel_traj = jnp.where(
        zero_vel[:, :, None], 0.0, vels[:, None, :]
    )  # [S, T-1, 3]
    return px, py, vel_traj


# ---------------------------------------------------------------------------
# cost kernels (contracts: cost_evaluator.cpp:111-233)
# ---------------------------------------------------------------------------


def _trajectory_end_points(px, py, active_points):
    """[S] endpoint coordinates at index active_points - 1.

    Uses dynamic_slice (uniform index across samples) instead of
    take_along_axis, which lowers to a per-row gather under vmap.
    """
    idx = jnp.clip(active_points - 1, 0, px.shape[1] - 1)
    end_x = jax.lax.dynamic_slice_in_dim(px, idx, 1, axis=1)[:, 0]
    end_y = jax.lax.dynamic_slice_in_dim(py, idx, 1, axis=1)[:, 0]
    return end_x, end_y


def _path_cost(px, py, seg_x, seg_y, seg_last_xy, seg_total_len,
               active_points):
    """Average min-distance of every rollout point to the tracked segment,
    plus normalized endpoint distance, halved
    (``cost_evaluator.cpp:111-141``)."""
    S, T = px.shape
    t_idx = jnp.arange(T)
    pt_mask = t_idx < active_points
    # [S, T, SEG] fused min reduce; padded segment slots at +1e8,
    # sweep axis pow2-padded (see _pad_sweep_pow2)
    sx = _pad_sweep_pow2(seg_x)
    sy = _pad_sweep_pow2(seg_y)
    d2_seg = jnp.min(
        (px[:, :, None] - sx[None, None, :]) ** 2
        + (py[:, :, None] - sy[None, None, :]) ** 2,
        axis=-1,
    )
    d = jnp.sqrt(d2_seg)
    avg = jnp.sum(jnp.where(pt_mask[None, :], d, 0.0), axis=1) / active_points.astype(
        jnp.float32
    )
    end_x, end_y = _trajectory_end_points(px, py, active_points)
    # a degenerate single-point segment (robot at the path end, goal not
    # yet within tolerance) has zero length: dividing by it would turn
    # every sample's cost inf/NaN and argmin would return an arbitrary
    # index-0 (full-reverse) winner — skip the normalized term instead
    end_dist = jnp.where(
        seg_total_len > 0.0,
        jnp.sqrt(
            (end_x - seg_last_xy[0]) ** 2 + (end_y - seg_last_xy[1]) ** 2
        ) / jnp.maximum(seg_total_len, 1e-9),
        0.0,
    )
    return (avg + end_dist) / 2.0


def _goal_cost(px, py, seg_x, seg_y, seg_arc, ref_total_len, active_points):
    """Remaining-arc-length goal cost + normalized euclidean tie-breaker
    (``cost_evaluator.cpp:150-177``). First minimum wins on ties, like the
    reference's strict `<` scan."""
    S, T = px.shape
    end_x, end_y = _trajectory_end_points(px, py, active_points)
    sx = _pad_sweep_pow2(seg_x)
    sy = _pad_sweep_pow2(seg_y)
    d2 = (end_x[:, None] - sx[None, :]) ** 2 + (
        end_y[:, None] - sy[None, :]
    ) ** 2  # [S, SEGp]; padded slots huge
    j_star = jnp.argmin(d2, axis=1)
    min_d2 = jnp.min(d2, axis=1)
    # arc length at the closest index via a one-hot masked sum instead of
    # a per-row gather (seg_arc[j_star]): one more [S, SEG]
    # elementwise+reduce pass
    arcp = jnp.pad(seg_arc, (0, sx.shape[0] - seg_arc.shape[0]))
    onehot = jnp.arange(arcp.shape[0])[None, :] == j_star[:, None]
    arc_at = jnp.sum(jnp.where(onehot, arcp[None, :], 0.0), axis=1)
    return (ref_total_len - arc_at) / ref_total_len + jnp.sqrt(min_d2) / ref_total_len


def _obstacles_cost(d2_obs, max_obstacles_dist):
    """Linear decay 1 -> 0 over [0, max_obstacles_dist] of the min
    rollout-to-obstacle distance (``cost_evaluator.cpp:179-184`` +
    ``trajectory.h:217-235`` minDist2D over all points incl. start).

    ``d2_obs``: shared per-point min squared obstacle distance [S, T],
    already truncation-adjusted and masked to active points."""
    d = jnp.sqrt(jnp.min(d2_obs, axis=1))
    return jnp.maximum(max_obstacles_dist - d, 0.0) / max_obstacles_dist


def _smoothness_cost(vel_traj, active_points, acc_limits):
    """Sum of squared velocity first-differences per component, normalized by
    the acceleration limit, averaged over 3 * num_vel_entries
    (``cost_evaluator.cpp:187-206``)."""
    S, Tm1, _ = vel_traj.shape
    j = jnp.arange(Tm1)
    diff_mask = (j >= 1) & (j <= active_points - 2)  # valid diffs
    dv = vel_traj[:, 1:, :] - vel_traj[:, :-1, :]  # [S, T-2, 3]
    dm = diff_mask[1:]  # mask aligned with dv's j index (j from 1)
    cost = jnp.zeros(S, jnp.float32)
    for c, acc in enumerate(acc_limits):
        term = jnp.sum(jnp.where(dm[None, :], dv[:, :, c] ** 2, 0.0), axis=1) / acc
        cost = cost + jnp.where(acc > 0, term, 0.0)
    return cost / (3.0 * (active_points - 1).astype(jnp.float32))


def _jerk_cost(vel_traj, active_points, acc_limits):
    """Sum of squared velocity second-differences (``cost_evaluator.cpp:
    209-233``)."""
    S, Tm1, _ = vel_traj.shape
    j = jnp.arange(Tm1)
    ddv = vel_traj[:, 2:, :] - 2.0 * vel_traj[:, 1:-1, :] + vel_traj[:, :-2, :]
    dm = (j >= 2) & (j <= active_points - 2)
    dm = dm[2:]
    cost = jnp.zeros(S, jnp.float32)
    for c, acc in enumerate(acc_limits):
        term = jnp.sum(jnp.where(dm[None, :], ddv[:, :, c] ** 2, 0.0), axis=1) / acc
        cost = cost + jnp.where(acc > 0, term, 0.0)
    return cost / (3.0 * (active_points - 1).astype(jnp.float32))


# ---------------------------------------------------------------------------
# full solve
# ---------------------------------------------------------------------------


def dwa_solve(
    spec: SolverSpec,
    params: SolverParams,
    state,  # [3] x, y, yaw (world)
    window,  # VelocityWindow arrays (host-built, padded)
    obs_xy,  # [R, 2] obstacle points, world frame, padded with +1e8
    obs_count,  # int32 scalar: number of real obstacle points
    seg_x,  # [SEG] tracked segment x, padded with +1e8
    seg_y,  # [SEG]
    seg_arc,  # [SEG] absolute prefix arc length on the full path
    seg_count,  # int32 scalar
    seg_total_len,  # f32 scalar (View.totalSegmentLength)
    ref_total_len,  # f32 scalar (full interpolated path length)
    active_points,  # int32 scalar <= spec.max_points (adaptive horizon)
    custom_costs: Sequence = (),
    collision_box_dyn=None,  # [2] traced half-extents (spec.dynamic_box)
    obs_vel=None,  # [R, 2] obstacle velocities (spec.moving_obstacles)
    mover4=None,  # [M, 4] (x, y, vx, vy) split moving-obstacle sweep
    return_all_paths: bool = False,  # also return per-sample (px, py)
) -> SolveResult:
    """One DWA tick: returns the argmin trajectory over the dynamic window.

    Orchestration mirror of ``DWA::findBestPath`` (``dwa.h:183-230``) minus
    the host-side target determination, which the caller does (see
    ``control/dwa.py``).

    ``custom_costs`` is a sequence of ``(weight, fn)`` where
    ``fn(vel_traj [S,T-1,3], px [S,T], py [S,T], active_points) -> [S]`` —
    the user-defined cost hook (reference ``DWA::addCustomCost``,
    ``dwa.h:103``).

    ``mover4``: SPLIT moving-obstacle sweep — a narrow [M, 4]
    (x, y, vx, vy) set swept with the constant-velocity time term and
    min-combined with the main (static) obstacle field before
    admissibility and the obstacle cost. Mathematically identical to
    concatenating the movers into the main bucket with
    ``moving_obstacles`` (min over a union; zero-velocity scan rows are
    bit-equal static), but the main sweep stays at its static width and
    op count — the fleet uses this to keep a pow2-full scan bucket from
    growing to the next power of two when mover slots are added
    (``DeviceFleet(split_mover_sweep=True)``;
    ``benchmark/moving_bench.py`` times both forms). Pad rows: position
    +1e8, velocity 0.
    """
    active_points = jnp.asarray(active_points, jnp.int32)
    vels, valid = _build_velocity_grid(spec, window)
    px, py = _rollout(spec, params, state, vels)

    moving = spec.moving_obstacles and obs_vel is not None

    # single obstacle sweep shared by collision + obstacle cost
    t_idx = jnp.arange(spec.max_points)
    pt_mask = t_idx < active_points
    if moving:
        d2_obs = _min_obstacle_dist_sq_moving(
            px, py, obs_xy, obs_vel, params.time_step, pt_mask
        )
    else:
        d2_obs = _min_obstacle_dist_sq(px, py, obs_xy, pt_mask)

    # split mover sweep: narrow moving set min-combined with the main
    # field (see the docstring). In drop mode it folds in immediately;
    # in truncate mode it stays separate so the static freeze-patch
    # below applies only to the static part (movers re-sweep from the
    # truncated positions — time keeps advancing past a frozen pose).
    d2_mov = None
    if mover4 is not None:
        d2_mov = _min_obstacle_dist_sq_moving(
            px, py, mover4[:, 0:2], mover4[:, 2:4], params.time_step,
            pt_mask,
        )
        if spec.drop_samples:
            d2_obs = jnp.minimum(d2_obs, d2_mov)
            d2_mov = None  # fully folded in
    d2_adm = d2_obs if d2_mov is None else jnp.minimum(d2_obs, d2_mov)

    if spec.collision_box is not None or (
        spec.dynamic_box and collision_box_dyn is not None
    ):
        # exact oriented-box surface distance drives admissibility; the
        # obstacle COST keeps the reference's point min-distance decay.
        # Dynamic mode (heterogeneous fleets): half-extents are traced
        # per-robot values; (0, 0) + radius-in-margin degenerates to the
        # exact circle model.
        if spec.collision_box is not None:
            bhl = bhw = None
        else:
            bhl, bhw = collision_box_dyn[0], collision_box_dyn[1]
        d2_col = _min_box_dist_sq(
            spec, params, state, vels, px, py, obs_xy, pt_mask,
            box_hl=bhl, box_hw=bhw, obs_vel=obs_vel if moving else None,
        )
        if mover4 is not None:
            # movers meet the exact box model too (their point d2 field
            # above only drives the obstacle cost)
            d2_col = jnp.minimum(d2_col, _min_box_dist_sq(
                spec, params, state, vels, px, py, mover4[:, 0:2],
                pt_mask, box_hl=bhl, box_hw=bhw, obs_vel=mover4[:, 2:4],
            ))
        admissible, truncate_ok, i_col, last_free = _admissibility(
            spec, params, d2_col, active_points, valid,
            surface_distance=True,
        )
    else:
        admissible, truncate_ok, i_col, last_free = _admissibility(
            spec, params, d2_adm, active_points, valid
        )
    if spec.drop_samples:
        # drop mode never truncates: skip the per-row gathers entirely
        vel_traj = jnp.broadcast_to(
            vels[:, None, :], (spec.num_samples, spec.max_points - 1, 3)
        )
    else:
        px, py, vel_traj = _apply_truncation(
            px, py, vels, truncate_ok, i_col, last_free, spec.max_points
        )
        # truncation freezes path points at path[last_free]; their obstacle
        # distance equals d2_obs[:, last_free] — adjust without re-sweeping.
        # one-hot masked sums instead of take_along_axis (a per-row
        # gather under the fleet vmap)
        lf_sel = t_idx[None, :] == last_free[:, None]
        frozen = truncate_ok[:, None] & (t_idx[None, :] > i_col[:, None])
        if moving:
            # a frozen path point keeps its position but time still
            # advances, so the obstacle track keeps moving relative to
            # it — the static freeze-patch below would pin the distance
            # at its last_free value. Re-sweep from the truncated
            # (frozen) positions instead; only this mode pays the
            # second sweep
            d2_obs = _min_obstacle_dist_sq_moving(
                px, py, obs_xy, obs_vel, params.time_step, pt_mask
            )
        else:
            # where-select before the sum: a bare multiply would turn
            # any inf in unselected slots into NaN (inf * 0)
            d2_lf = jnp.sum(
                jnp.where(lf_sel, d2_obs, 0.0), axis=1, keepdims=True
            )
            d2_obs = jnp.where(frozen, d2_lf, d2_obs)
        if d2_mov is not None:
            # split movers: like the moving branch above, a frozen point
            # keeps its position while the mover track advances — re-sweep
            # the narrow set from the truncated positions and combine
            d2_mov = _min_obstacle_dist_sq_moving(
                px, py, mover4[:, 0:2], mover4[:, 2:4],
                params.time_step, pt_mask,
            )
            d2_obs = jnp.minimum(d2_obs, d2_mov)

    acc_limits = (params.acc_limit_vx, params.acc_limit_vy, params.acc_limit_omega)
    f32 = jnp.float32
    total = jnp.zeros(spec.num_samples, f32)

    has_path = ref_total_len > 0.0
    last_i = jnp.maximum(seg_count - 1, 0)
    seg_last_x = jax.lax.dynamic_slice_in_dim(seg_x, last_i, 1)[0]
    seg_last_y = jax.lax.dynamic_slice_in_dim(seg_y, last_i, 1)[0]

    goal = _goal_cost(px, py, seg_x, seg_y, seg_arc, ref_total_len, active_points)
    total += jnp.where(
        has_path & (params.weight_goal > 0), params.weight_goal * goal, 0.0
    )

    pathc = _path_cost(
        px, py, seg_x, seg_y, (seg_last_x, seg_last_y), seg_total_len,
        active_points,
    )
    total += jnp.where(
        has_path & (params.weight_path > 0), params.weight_path * pathc, 0.0
    )

    obst = _obstacles_cost(d2_obs, params.max_obstacles_dist)
    total += jnp.where(
        (obs_count > 0) & (params.weight_obstacles > 0),
        params.weight_obstacles * obst,
        0.0,
    )

    if not spec.drop_samples:
        # only truncated samples have velocity discontinuities; constant
        # velocity rows have exactly zero smoothness/jerk, so in drop mode
        # (reference constant-velocity samples) both costs vanish
        smooth = _smoothness_cost(vel_traj, active_points, acc_limits)
        total += jnp.where(
            params.weight_smoothness > 0, params.weight_smoothness * smooth, 0.0
        )
        jerk = _jerk_cost(vel_traj, active_points, acc_limits)
        total += jnp.where(
            params.weight_jerk > 0, params.weight_jerk * jerk, 0.0
        )

    for weight, fn in custom_costs:
        total += jnp.float32(weight) * fn(vel_traj, px, py, active_points)

    costs = jnp.where(admissible, total, _INF)
    best = jnp.argmin(costs).astype(jnp.int32)
    found = jnp.any(admissible)

    # row extraction via dynamic_slice (int-indexing would lower to a
    # batched gather under vmap)
    take_row = lambda a: jax.lax.dynamic_index_in_dim(  # noqa: E731
        a, best, axis=0, keepdims=False
    )
    res = SolveResult(
        found=found,
        cost=take_row(costs),
        best_index=best,
        velocities=take_row(vel_traj),
        path=jnp.stack([take_row(px), take_row(py)], axis=-1),
        costs=costs,
        num_admissible=jnp.sum(admissible).astype(jnp.int32),
    )
    if return_all_paths:
        # px/py here are POST-truncation in truncate mode, so a debug
        # consumer shows the same paths the costs were computed on
        return res, (px, py)
    return res


def evaluate_trajectory_costs(
    params: SolverParams,
    px,  # [S, T] given rollout x (the reference's TrajectoryPath SoA)
    py,  # [S, T]
    vel_traj,  # [S, T-1, 3] given velocity profiles
    obs_xy,  # [O, 2] padded obstacle points (+1e8 sentinels)
    obs_count,  # i32 scalar
    seg_x,  # [G] tracked segment, padded +1e8
    seg_y,
    seg_arc,  # [G] absolute prefix arc lengths
    seg_count,
    seg_total_len,
    ref_total_len,
    active_points,
    custom_costs: Sequence = (),
    with_obstacles: bool = True,
) -> SolveResult:
    """Standalone cost evaluation of GIVEN trajectories — the reference's
    ``CostEvaluator::getMinTrajectoryCost`` API (``cost_evaluator.cpp:
    49-108``) decoupled from the sampler: callers hand in arbitrary
    trajectory batches (e.g. externally generated velocity profiles) and
    get per-sample weighted costs + the strict-first-min winner.

    ``with_obstacles=False`` statically elides the obstacle sweep for
    workloads with no scan (the reference skips the kernel when
    ``obstaclePointsX`` is empty, ``cost_evaluator.cpp:76-81``).

    Unlike ``dwa_solve`` (whose constant-velocity samples make smoothness
    and jerk structurally zero in drop mode), this path always evaluates
    all five cost kernels — matching the reference's
    ``CostEvaluator_5k_Trajs`` benchmark workload
    (``benchmark_runner.cpp:150-185``) exactly.
    """
    active_points = jnp.asarray(active_points, jnp.int32)
    S, T = px.shape
    t_idx = jnp.arange(T)
    pt_mask = t_idx < active_points
    acc_limits = (
        params.acc_limit_vx, params.acc_limit_vy, params.acc_limit_omega
    )
    total = jnp.zeros(S, jnp.float32)

    has_path = ref_total_len > 0.0
    last_i = jnp.maximum(seg_count - 1, 0)
    seg_last_x = jax.lax.dynamic_slice_in_dim(seg_x, last_i, 1)[0]
    seg_last_y = jax.lax.dynamic_slice_in_dim(seg_y, last_i, 1)[0]

    goal = _goal_cost(px, py, seg_x, seg_y, seg_arc, ref_total_len,
                      active_points)
    total += jnp.where(
        has_path & (params.weight_goal > 0), params.weight_goal * goal, 0.0
    )
    pathc = _path_cost(
        px, py, seg_x, seg_y, (seg_last_x, seg_last_y), seg_total_len,
        active_points,
    )
    total += jnp.where(
        has_path & (params.weight_path > 0), params.weight_path * pathc, 0.0
    )
    if with_obstacles:
        d2_obs = _min_obstacle_dist_sq(px, py, obs_xy, pt_mask)
        obst = _obstacles_cost(d2_obs, params.max_obstacles_dist)
        total += jnp.where(
            (obs_count > 0) & (params.weight_obstacles > 0),
            params.weight_obstacles * obst,
            0.0,
        )
    smooth = _smoothness_cost(vel_traj, active_points, acc_limits)
    total += jnp.where(
        params.weight_smoothness > 0, params.weight_smoothness * smooth, 0.0
    )
    jerk = _jerk_cost(vel_traj, active_points, acc_limits)
    total += jnp.where(params.weight_jerk > 0, params.weight_jerk * jerk, 0.0)
    for weight, fn in custom_costs:
        total += jnp.float32(weight) * fn(vel_traj, px, py, active_points)

    best = jnp.argmin(total).astype(jnp.int32)
    take_row = lambda a: jax.lax.dynamic_index_in_dim(  # noqa: E731
        a, best, axis=0, keepdims=False
    )
    return SolveResult(
        found=jnp.bool_(S > 0),
        cost=take_row(total),
        best_index=best,
        velocities=take_row(vel_traj),
        path=jnp.stack([take_row(px), take_row(py)], axis=-1),
        costs=total,
        num_admissible=jnp.int32(S),
    )


@_functools.lru_cache(maxsize=16)
def get_cost_evaluator(with_obstacles: bool = True):
    """Process-wide jitted standalone cost evaluator."""
    return jax.jit(
        partial(evaluate_trajectory_costs, with_obstacles=with_obstacles)
    )


def make_dwa_solver(spec: SolverSpec, custom_costs: Sequence = ()):
    """Build a jit-compiled solver for a fixed `SolverSpec`.

    The returned callable takes only dynamic arguments; repeated calls with
    the same spec reuse the compiled executable. Plays the role of the
    reference's construction-time GPU JIT warmup (``dwa.cpp:75-91``) — call
    once with representative shapes to pay compilation up front.
    """
    solve = partial(dwa_solve, spec, custom_costs=custom_costs)
    return jax.jit(solve)


# ---------------------------------------------------------------------------
# single-buffer (packed) interface
# ---------------------------------------------------------------------------
#
# Host <-> device transfers weigh on small-batch control-loop latency (each
# separate array is a separate transfer). The packed interface moves ONE
# f32 buffer per tick in each direction — the analog of the reference GPU
# backend's persistent device buffers + one memcpy batch per call
# (``cost_evaluator_gpu.cpp:220-235``).

_HDR = 20  # header scalars, see layout below


def _window_block_size(spec: SolverSpec) -> int:
    """Floats reserved for the window block. Device-window mode stores
    (current_vel[3] | limits[9]) there, so the block must hold at least
    12 floats even when the sample grid is tiny — otherwise the limits
    would spill into (and be read back from) the obstacle region."""
    n = 2 * (spec.n_vx + spec.n_vy + spec.n_omega)
    return max(n, 12) if spec.device_window else n


def packed_input_size(spec: SolverSpec) -> int:
    return (
        _HDR
        + _window_block_size(spec)
        + 2 * spec.scan_size
        + 3 * spec.seg_size
        # trailing [vx | vy] obstacle-velocity block (moving-obstacle
        # mode only — appended so every static-spec offset is unchanged)
        + (2 * spec.scan_size if spec.moving_obstacles else 0)
    )


def pack_solver_input(
    spec: SolverSpec,
    buf,  # np.ndarray [packed_input_size] float32, written in place
    params_vec,  # [12] float32: dt, radius, margin, 5 weights, 3 acc, maxObsDist
    state,  # (x, y, yaw)
    window,
    obs_xy,  # [R, 2] padded
    obs_count: int,
    seg_x,
    seg_y,
    seg_arc,
    seg_count: int,
    seg_total_len: float,
    ref_total_len: float,
    active_points: int,
    current_vel=None,
    limits_vec=None,
    obs_vel_xy=None,  # [R, 2] world-frame obstacle velocities
):
    """Serialize one tick's dynamic inputs into the packed buffer (host).

    Pass ``window=None`` with ``current_vel``/``limits_vec`` when the spec
    uses device-window mode. ``obs_vel_xy`` fills the trailing velocity
    block of a ``moving_obstacles`` spec (omitted -> zeros == static)."""
    # the window argument must match the spec's window mode — the wrong
    # combination writes a misaligned buffer that _unpack_inputs parses
    # as a nonsense velocity grid with no error (round-5 review; same
    # guard style as the obs_vel_xy/moving_obstacles check below)
    if spec.device_window and window is not None:
        raise ValueError(
            "spec.device_window=True: pass window=None with "
            "current_vel/limits_vec, not a host-sampled window"
        )
    if not spec.device_window and window is None:
        raise ValueError(
            "spec.device_window=False: pass a host-sampled window "
            "(window=None is only valid for device-window specs)"
        )
    buf[0:3] = state
    buf[3] = obs_count
    buf[4] = seg_count
    buf[5] = seg_total_len
    buf[6] = ref_total_len
    buf[7] = active_points
    buf[8:20] = params_vec
    o = _HDR
    if window is None:
        # device-window mode (spec.device_window): the window block carries
        # (current_vel[3], limits[9]); the grid is built on device
        buf[o : o + 3] = current_vel
        buf[o + 3 : o + 12] = limits_vec
        o += _window_block_size(spec)
    else:
        for arr in (
            window.vx_vals,
            window.vx_mask,
            window.vy_vals,
            window.vy_mask,
            window.omega_vals,
            window.omega_mask,
        ):
            n = arr.shape[0]
            buf[o : o + n] = arr
            o += n
    r = spec.scan_size
    buf[o : o + r] = obs_xy[:, 0]
    buf[o + r : o + 2 * r] = obs_xy[:, 1]
    o += 2 * r
    g = spec.seg_size
    buf[o : o + g] = seg_x
    buf[o + g : o + 2 * g] = seg_y
    buf[o + 2 * g : o + 3 * g] = seg_arc
    o += 3 * g
    if spec.moving_obstacles:
        if obs_vel_xy is None:
            buf[o : o + 2 * r] = 0.0
        else:
            buf[o : o + r] = obs_vel_xy[:, 0]
            buf[o + r : o + 2 * r] = obs_vel_xy[:, 1]
    elif obs_vel_xy is not None:
        # silently dropping velocities would plan through a crossing
        # obstacle's predicted path with no error — the same hazard
        # _check_tracked_spec guards on the fleet side
        raise ValueError(
            "obs_vel_xy given but the spec has moving_obstacles=False — "
            "the static buffer has no velocity block; build the spec "
            "with moving_obstacles=True"
        )
    return buf


def _unpack_inputs(spec: SolverSpec, buf):
    """Parse the packed single-buffer layout — the ONE place that knows
    it (shared by the production solver and the debug sampler, which
    once drifted on the device-window block). Returns
    (params, state, window, obs_xy, obs_count, seg_x, seg_y, seg_arc,
    seg_count, seg_total_len, ref_total_len, active_points, obs_vel)."""
    from .window import VelocityWindow

    state = buf[0:3]
    obs_count = buf[3].astype(jnp.int32)
    seg_count = buf[4].astype(jnp.int32)
    seg_total_len = buf[5]
    ref_total_len = buf[6]
    active_points = buf[7].astype(jnp.int32)
    p = buf[8:20]
    params = SolverParams(
        time_step=p[0],
        robot_radius=p[1],
        collision_margin=p[2],
        weight_path=p[3],
        weight_goal=p[4],
        weight_obstacles=p[5],
        weight_smoothness=p[6],
        weight_jerk=p[7],
        acc_limit_vx=p[8],
        acc_limit_vy=p[9],
        acc_limit_omega=p[10],
        max_obstacles_dist=p[11],
    )
    o = _HDR
    nx, ny, nw = spec.n_vx, spec.n_vy, spec.n_omega
    if spec.device_window:
        window = _device_window(
            spec, buf[o : o + 3], buf[o + 3 : o + 12], params.time_step
        )
        o += _window_block_size(spec)
    else:
        vx_vals = buf[o : o + nx]
        vx_mask = buf[o + nx : o + 2 * nx] > 0.5
        o += 2 * nx
        vy_vals = buf[o : o + ny]
        vy_mask = buf[o + ny : o + 2 * ny] > 0.5
        o += 2 * ny
        w_vals = buf[o : o + nw]
        w_mask = buf[o + nw : o + 2 * nw] > 0.5
        o += 2 * nw
        window = VelocityWindow(
            vx_vals, vx_mask, vy_vals, vy_mask, w_vals, w_mask
        )
    r = spec.scan_size
    obs_xy = jnp.stack([buf[o : o + r], buf[o + r : o + 2 * r]], axis=1)
    o += 2 * r
    g = spec.seg_size
    seg_x = buf[o : o + g]
    seg_y = buf[o + g : o + 2 * g]
    seg_arc = buf[o + 2 * g : o + 3 * g]
    o += 3 * g
    obs_vel = None
    if spec.moving_obstacles:
        obs_vel = jnp.stack(
            [buf[o : o + r], buf[o + r : o + 2 * r]], axis=1
        )
    return (params, state, window, obs_xy, obs_count, seg_x, seg_y,
            seg_arc, seg_count, seg_total_len, ref_total_len,
            active_points, obs_vel)


def _unpack_and_solve(spec: SolverSpec, buf, custom_costs=()):
    """Device-side unpack of the single input buffer + solve + packed output.

    Output layout: [found, cost, best_index, num_admissible,
                    vx[T-1], vy[T-1], omega[T-1], px[T], py[T]].
    """
    (params, state, window, obs_xy, obs_count, seg_x, seg_y, seg_arc,
     seg_count, seg_total_len, ref_total_len, active_points,
     obs_vel) = _unpack_inputs(spec, buf)

    res = dwa_solve(
        spec,
        params,
        state,
        window,
        obs_xy,
        obs_count,
        seg_x,
        seg_y,
        seg_arc,
        seg_count,
        seg_total_len,
        ref_total_len,
        active_points,
        custom_costs=custom_costs,
        obs_vel=obs_vel,
    )
    out = jnp.concatenate(
        [
            res.found.astype(jnp.float32)[None],
            res.cost[None],
            res.best_index.astype(jnp.float32)[None],
            res.num_admissible.astype(jnp.float32)[None],
            res.velocities[:, 0],
            res.velocities[:, 1],
            res.velocities[:, 2],
            res.path[:, 0],
            res.path[:, 1],
        ]
    )
    return out


def unpack_solver_output(spec: SolverSpec, out):
    """Host-side split of the packed output vector (numpy array)."""
    T = spec.max_points
    found = bool(out[0] > 0.5)
    cost = float(out[1])
    best_index = int(out[2])
    num_admissible = int(out[3])
    o = 4
    vx = out[o : o + T - 1]
    vy = out[o + T - 1 : o + 2 * (T - 1)]
    omega = out[o + 2 * (T - 1) : o + 3 * (T - 1)]
    o += 3 * (T - 1)
    px = out[o : o + T]
    py = out[o + T : o + 2 * T]
    return found, cost, best_index, num_admissible, vx, vy, omega, px, py


def make_packed_dwa_solver(spec: SolverSpec, custom_costs: Sequence = ()):
    """Jit-compiled single-buffer solver: f32[packed_input_size] ->
    f32[4 + 3*(T-1) + 2*T]. One transfer each way per control tick."""
    if spec.dynamic_box:
        # the packed buffer carries no per-robot half-extents; silently
        # solving with the circle fallback would double-count a radius
        # folded into collision_margin (fleet_v2 convention). Mixed-shape
        # fleets go through ops/fleet_solver, which threads
        # collision_box_dyn explicitly.
        raise ValueError(
            "dynamic_box specs are not supported by the packed"
            " single-buffer interface; use the fleet tick"
            " (ops/fleet_solver) or a static spec.collision_box"
        )
    solve = partial(_unpack_and_solve, spec, custom_costs=custom_costs)
    return jax.jit(solve)


@_functools.lru_cache(maxsize=64)
def get_packed_dwa_solver(spec: SolverSpec):
    """Process-wide shared packed solver (no custom costs): controllers with
    identical specs reuse one compiled executable."""
    return make_packed_dwa_solver(spec)


def dwa_sample_debug(spec: SolverSpec, buf, custom_costs=()):
    """Debug variant: return every rollout and its admissibility/cost
    (role of ``DWA::debugVelocitySearch`` + ``getDebuggingSamples``,
    ``dwa.h:141-163``). Returns (px [S,T], py [S,T], costs [S],
    admissible [S]). ``custom_costs`` must match the production solver's
    so debug rankings agree with the executed command. In truncate mode
    the returned paths are the TRUNCATED rollouts (frozen past the
    collision index) — the ones the costs were computed on."""
    if spec.dynamic_box:
        # same contract as make_packed_dwa_solver: the packed buffer has
        # no per-robot half-extents, and the circle fallback would
        # double-count a radius folded into collision_margin
        raise ValueError(
            "dynamic_box specs are not supported by the packed debug"
            " interface; use the fleet tick (ops/fleet_solver) or a"
            " static spec.collision_box"
        )
    (params, state, window, obs_xy, obs_count, seg_x, seg_y, seg_arc,
     seg_count, seg_total_len, ref_total_len, active_points,
     obs_vel) = _unpack_inputs(spec, buf)

    res, (px, py) = dwa_solve(
        spec, params, state, window, obs_xy, obs_count, seg_x, seg_y,
        seg_arc, seg_count, seg_total_len, ref_total_len, active_points,
        custom_costs=custom_costs, obs_vel=obs_vel,
        return_all_paths=True,
    )
    return px, py, res.costs, jnp.isfinite(res.costs)


@_functools.lru_cache(maxsize=16)
def get_debug_dwa_solver(spec: SolverSpec, custom_costs=()):
    return jax.jit(partial(dwa_sample_debug, spec, custom_costs=custom_costs))


def check_states_feasibility(states_xy, obs_xy, radius, margin):
    """True if any of the given positions collides with the obstacle points
    — point-robot analog of ``TrajectorySampler::checkStatesFeasibility``
    (``trajectory_sampler.cpp:378-407``)."""
    states_xy = jnp.asarray(states_xy, jnp.float32)
    obs_xy = jnp.asarray(obs_xy, jnp.float32)
    d2 = jnp.min(
        (states_xy[:, 0:1] - obs_xy[None, :, 0]) ** 2
        + (states_xy[:, 1:2] - obs_xy[None, :, 1]) ** 2,
        axis=-1,
    )
    r = radius + margin
    return jnp.any(d2 < r * r)
