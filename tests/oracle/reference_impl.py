"""Serial NumPy transcription of the reference C++ DWA hot-path semantics.

This module is the INDEPENDENT parity oracle: a deliberately "dumb",
loop-for-loop transcription of the reference implementation —

  * dynamic-window computation + grid walk
    (``trajectory_sampler.cpp:181-275,328-372``, split rules
    ``datatypes/trajectory.h:19-51``),
  * per-step rollout with first-hit drop/truncate
    (``trajectory_sampler.cpp:118-178``, kinematics ``datatypes/path.h:24-30``),
  * the five cost kernels (``cost_evaluator.cpp:111-233``),
  * the serial strict-``<`` winner scan (``cost_evaluator.cpp:49-108``),
  * follower closest-point machinery + sticky target determination
    (``follower.cpp:149-304``) and the speed-regulation factor
    (``follower.cpp:319-353``).

It must NOT import anything from ``kompass_core_tpu`` — its value is that it
shares no code with the system under test. The only intentional divergence
from the C++ is the collision model: the reference checks the robot shape
against an octree of the scan via FCL (``collision_check.cpp:118-163``,
not buildable here); this oracle uses the same circle (radius + margin) /
oriented-box surface models the engine calibrated against FCL
(``tests/test_collision_model.py``), implemented independently as scalar
loops. Everything downstream of the collision decision — drop/truncate,
costs, winner — is transcribed from the C++ verbatim.

All math in float64 (the reference simulates poses in double); the parity
tests compare against the float32 device program at rel-tol 1e-4, the
reference's own cross-build tolerance (``tests/test_cost_parity.py:32``).
"""

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# utils/trajectory_sampler.h:14
MIN_VEL = 0.01


# ---------------------------------------------------------------------------
# sampling grid (trajectory_sampler.cpp + trajectory.h helpers)
# ---------------------------------------------------------------------------


def compute_linear_sample_split(is_omni: bool, max_linear_samples: int):
    """trajectory.h:19-29: 75/25 vx/vy split for omni, bumped odd."""

    def make_odd(n):
        return n + 1 if n % 2 == 0 else n

    if is_omni:
        return (
            make_odd(max(3, max_linear_samples * 3 // 4)),
            make_odd(max(3, max_linear_samples * 1 // 4)),
        )
    return make_odd(max(3, max_linear_samples)), 1


def angular_slots(max_angular_samples: int) -> int:
    """trajectory_sampler.cpp:48: bump even counts odd."""
    return max_angular_samples + 1 - (max_angular_samples % 2)


@dataclass
class Window:
    """Reachable window bounds + resolutions
    (UpdateReachableVelocityRange, trajectory_sampler.cpp:328-372)."""

    min_vx: float
    max_vx: float
    res_x: float
    min_vy: float
    max_vy: float
    res_y: float
    min_omega: float
    max_omega: float
    res_w: float


def reachable_velocity_range(
    current_vel, limits, time_step, n_vx, n_vy, is_omni
) -> Window:
    """trajectory_sampler.cpp:328-372. ``limits`` is the 9-float layout
    (vx_max, vx_acc, vx_dec, vy_max, vy_acc, vy_dec, w_max, w_acc, w_dec);
    for non-omni the caller must already have zeroed the vy entries
    (trajectory_sampler.cpp:51-54)."""
    vx0, vy0, w0 = (float(v) for v in current_vel)
    (vx_max, vx_acc, vx_dec, vy_max, vy_acc, vy_dec, w_max, w_acc, w_dec) = (
        float(v) for v in limits
    )
    # NOTE: each axis is returned in (max, min, res) order — mirroring the
    # C++ out-parameter order, NOT the Window field order build_window
    # re-packs into
    dt = float(time_step)
    max_vx_ = min(vx_max, vx0 + vx_acc * dt)
    min_vx_ = max(-vx_max, vx0 - vx_dec * dt)
    if is_omni:
        max_vy_ = min(vy_max, vy0 + vy_acc * dt)
        min_vy_ = max(-vy_max, vy0 - vy_dec * dt)
    else:
        max_vy_ = 0.0
        min_vy_ = 0.0
    res_x = max((max_vx_ - min_vx_) / (n_vx - 1), 0.001)
    res_y = max((max_vy_ - min_vy_) / (n_vy - 1), 0.001) if n_vy > 1 else 0.001
    # angular resolution is computed by the caller with the bumped count
    return (
        max_vx_,
        min_vx_,
        res_x,
        max_vy_,
        min_vy_,
        res_y,
    )


def build_window(current_vel, limits, time_step, n_vx, n_vy, n_omega, is_omni):
    """Full window: ranges + resolutions for all three axes."""
    vx0, vy0, w0 = (float(v) for v in current_vel)
    (vx_max, _, _, _, _, _, w_max, w_acc, w_dec) = (float(v) for v in limits)
    max_vx_, min_vx_, res_x, max_vy_, min_vy_, res_y = reachable_velocity_range(
        current_vel, limits, time_step, n_vx, n_vy, is_omni
    )
    dt = float(time_step)
    max_w_ = min(w_max, w0 + w_acc * dt)
    min_w_ = max(-w_max, w0 - w_dec * dt)
    res_w = max((max_w_ - min_w_) / (n_omega - 1), 0.001)
    return Window(
        min_vx_, max_vx_, res_x, min_vy_, max_vy_, res_y, min_w_, max_w_, res_w
    )


def walk(vmin: float, vmax: float, res: float) -> List[float]:
    """The exact ``for (v = min; v <= max; v += res)`` accumulation."""
    vals = []
    v = float(vmin)
    while v <= vmax:
        vals.append(v)
        v += res
    return vals


def sample_grid(window: Window, is_omni: bool):
    """Enumerate the velocity grid in the reference's single-threaded order.

    Non-holonomic (trajectory_sampler.cpp:207-217): vx outer ascending,
    omega inner; vx values with |vx| < MIN_VEL produce no samples.

    Omni single-thread (trajectory_sampler.cpp:256-272): per vx, FIRST the
    (vx, vy, 0) block (for every vx), THEN the (vx, 0, omega) block only if
    |vx| >= MIN_VEL.

    Returns a list of (i_vx, j_in_block, vx, vy, omega, is_omega_block)
    where j_in_block indexes within that vx's sub-block in walk order.
    """
    out = []
    vx_vals = walk(window.min_vx, window.max_vx, window.res_x)
    w_vals = walk(window.min_omega, window.max_omega, window.res_w)
    if not is_omni:
        for i, vx in enumerate(vx_vals):
            if abs(vx) >= MIN_VEL:
                for j, w in enumerate(w_vals):
                    out.append((i, j, vx, 0.0, w, True))
        return out
    vy_vals = walk(window.min_vy, window.max_vy, window.res_y)
    for i, vx in enumerate(vx_vals):
        for j, vy in enumerate(vy_vals):
            out.append((i, j, vx, vy, 0.0, False))
        if abs(vx) >= MIN_VEL:
            for j, w in enumerate(w_vals):
                out.append((i, j, vx, 0.0, w, True))
    return out


# ---------------------------------------------------------------------------
# collision models (stand-ins for FCL, see module docstring)
# ---------------------------------------------------------------------------


def circle_collides(x, y, obs_xy, radius, margin) -> bool:
    """Point-robot circle: any obstacle point within radius + margin."""
    r = radius + margin
    r2 = r * r
    for k in range(obs_xy.shape[0]):
        dx = obs_xy[k, 0] - x
        dy = obs_xy[k, 1] - y
        if dx * dx + dy * dy < r2:
            return True
    return False


def box_collides(x, y, yaw, obs_xy, half_l, half_w, margin) -> bool:
    """Oriented-rectangle surface distance < max(margin, 1e-6)."""
    m = max(margin, 1e-6)
    m2 = m * m
    c, s = math.cos(yaw), math.sin(yaw)
    for k in range(obs_xy.shape[0]):
        dxw = obs_xy[k, 0] - x
        dyw = obs_xy[k, 1] - y
        bx = c * dxw + s * dyw
        by = -s * dxw + c * dyw
        ex = max(abs(bx) - half_l, 0.0)
        ey = max(abs(by) - half_w, 0.0)
        if ex * ex + ey * ey < m2:
            return True
    return False


# ---------------------------------------------------------------------------
# rollout + drop/truncate (trajectory_sampler.cpp:118-178)
# ---------------------------------------------------------------------------


@dataclass
class SampleTraj:
    """One rolled sample, in the reference's SoA shape."""

    admissible: bool
    path_x: Optional[np.ndarray] = None  # [T_active]
    path_y: Optional[np.ndarray] = None
    vx: Optional[np.ndarray] = None  # [T_active - 1]
    vy: Optional[np.ndarray] = None
    omega: Optional[np.ndarray] = None
    truncated: bool = False
    last_free_index: int = -1


def state_update(x, y, yaw, vx, vy, omega, dt):
    """Path::State::update (datatypes/path.h:24-30): position uses the
    pre-update heading, then yaw integrates."""
    x = x + (vx * math.cos(yaw) - vy * math.sin(yaw)) * dt
    y = y + (vx * math.sin(yaw) + vy * math.cos(yaw)) * dt
    yaw = yaw + omega * dt
    return x, y, yaw


def admissible_traj_from_vel(
    vel,  # (vx, vy, omega)
    start_pose,  # (x, y, yaw)
    n_points,  # numPointsPerTrajectory (== active horizon points)
    dt,
    collide_fn,  # (x, y, yaw) -> bool, checked at every updated pose
    drop_samples: bool,
    num_ctrl_points: int,
) -> SampleTraj:
    """getAdmissibleTrajsFromVel (trajectory_sampler.cpp:118-178),
    transcribed loop-for-loop including the last_free_index quirks."""
    vx_c, vy_c, w_c = vel
    if abs(vx_c) < MIN_VEL and abs(vy_c) < MIN_VEL and abs(w_c) < MIN_VEL:
        return SampleTraj(admissible=False)

    x, y, yaw = start_pose
    path_x = np.zeros(n_points)
    path_y = np.zeros(n_points)
    vxs = np.zeros(n_points - 1)
    vys = np.zeros(n_points - 1)
    ws = np.zeros(n_points - 1)
    path_x[0], path_y[0] = x, y
    is_collision = False
    last_free_index = n_points - 1

    i_break = -1
    for i in range(n_points - 1):
        x, y, yaw = state_update(x, y, yaw, vx_c, vy_c, w_c, dt)
        if collide_fn(x, y, yaw):
            is_collision = True
            if i > 0:
                last_free_index = i - 1
            i_break = i
            break
        vxs[i], vys[i], ws[i] = vx_c, vy_c, w_c
        path_x[i + 1], path_y[i + 1] = x, y

    truncated = False
    if (
        not drop_samples
        and is_collision
        and last_free_index > num_ctrl_points
        and last_free_index < n_points - 1
    ):
        # zero-velocity padding from the break step; path frozen at the
        # LAST FREE point (index i_break - 1, NOT the last filled point
        # i_break — the reference quirk at trajectory_sampler.cpp:159-166)
        lf_x = path_x[last_free_index]
        lf_y = path_y[last_free_index]
        for j in range(last_free_index + 1, n_points - 1):
            vxs[j], vys[j], ws[j] = 0.0, 0.0, 0.0
            path_x[j + 1], path_y[j + 1] = lf_x, lf_y
        is_collision = False
        truncated = True

    if is_collision:
        return SampleTraj(admissible=False)
    return SampleTraj(
        admissible=True,
        path_x=path_x,
        path_y=path_y,
        vx=vxs,
        vy=vys,
        omega=ws,
        truncated=truncated,
        last_free_index=last_free_index,
    )


# ---------------------------------------------------------------------------
# cost kernels (cost_evaluator.cpp:111-233)
# ---------------------------------------------------------------------------


def path_cost(
    path_x, path_y, seg_x, seg_y, seg_total_length
) -> float:
    """cost_evaluator.cpp:111-141."""
    total = 0.0
    n = len(path_x)
    for i in range(n):
        min_dist = float("inf")
        for j in range(len(seg_x)):
            d = math.hypot(seg_x[j] - path_x[i], seg_y[j] - path_y[i])
            if d < min_dist:
                min_dist = d
        total += min_dist
    end_dist_error = (
        math.hypot(path_x[n - 1] - seg_x[-1], path_y[n - 1] - seg_y[-1])
        / seg_total_length
    )
    return (total / n + end_dist_error) / 2.0


def goal_cost(
    path_x, path_y, seg_x, seg_y, seg_arc, ref_path_length
) -> float:
    """cost_evaluator.cpp:150-177. ``seg_arc`` carries ABSOLUTE prefix arc
    lengths on the full reference path (Path::View::AccumulatedLengths)."""
    end_x, end_y = path_x[-1], path_y[-1]
    min_d2 = float("inf")
    closest = 0
    for i in range(len(seg_x)):
        d2 = (end_x - seg_x[i]) ** 2 + (end_y - seg_y[i]) ** 2
        if d2 < min_d2:
            min_d2 = d2
            closest = i
    arc_remaining = (ref_path_length - seg_arc[closest]) / ref_path_length
    return arc_remaining + math.sqrt(min_d2) / ref_path_length


def obstacles_cost(path_x, path_y, obs_xy, max_obstacles_dist) -> float:
    """cost_evaluator.cpp:179-184 + trajectory.h:218-235 minDist2D (min over
    ALL path points incl. the start). FUNCTION-level fidelity: an empty
    obstacle set yields the MAXIMAL cost 1.0 — minDist2D returns 0.0f for
    size <= 0 (trajectory.h:221-222), so the C++ formula evaluates to
    max(maxDist - 0, 0)/maxDist = 1.0. The composition never reaches this
    (both the reference and evaluate_tick gate the term on a non-empty
    scan, cost_evaluator.cpp:76-81)."""
    if obs_xy.shape[0] <= 0:
        return 1.0
    min_d2 = float("inf")
    for k in range(obs_xy.shape[0]):
        for j in range(len(path_x)):
            d2 = (obs_xy[k, 0] - path_x[j]) ** 2 + (obs_xy[k, 1] - path_y[j]) ** 2
            if d2 < min_d2:
                min_d2 = d2
    dist = math.sqrt(min_d2)
    return max(max_obstacles_dist - dist, 0.0) / max_obstacles_dist


def smoothness_cost(vxs, vys, ws, acc_limits) -> float:
    """cost_evaluator.cpp:187-206."""
    cost = 0.0
    n = len(vxs)
    for i in range(1, n):
        if acc_limits[0] > 0:
            cost += (vxs[i] - vxs[i - 1]) ** 2 / acc_limits[0]
        if acc_limits[1] > 0:
            cost += (vys[i] - vys[i - 1]) ** 2 / acc_limits[1]
        if acc_limits[2] > 0:
            cost += (ws[i] - ws[i - 1]) ** 2 / acc_limits[2]
    return cost / (3.0 * n)


def jerk_cost(vxs, vys, ws, acc_limits) -> float:
    """cost_evaluator.cpp:209-233."""
    cost = 0.0
    n = len(vxs)
    for i in range(2, n):
        if acc_limits[0] > 0:
            cost += (vxs[i] - 2 * vxs[i - 1] + vxs[i - 2]) ** 2 / acc_limits[0]
        if acc_limits[1] > 0:
            cost += (vys[i] - 2 * vys[i - 1] + vys[i - 2]) ** 2 / acc_limits[1]
        if acc_limits[2] > 0:
            cost += (ws[i] - 2 * ws[i - 1] + ws[i - 2]) ** 2 / acc_limits[2]
    return cost / (3.0 * n)


# ---------------------------------------------------------------------------
# full tick (DWA::findBestPath inner: sample -> rollout -> costs -> scan)
# ---------------------------------------------------------------------------


@dataclass
class TickResult:
    samples: list  # [(grid_record, SampleTraj, total_cost or None)]
    found: bool
    min_cost: float
    winner: Optional[int]  # index into samples of the strict-< winner
    winner_vel: Optional[tuple]  # first velocity command of the winner


def evaluate_tick(
    *,
    current_vel,
    start_pose,
    limits,
    time_step,
    n_lin_samples,
    n_ang_samples,
    is_omni,
    n_points,
    num_ctrl_points,
    drop_samples,
    obs_xy,  # [O, 2] real obstacle points (unpadded)
    seg_x,
    seg_y,
    seg_arc,
    seg_total_length,
    ref_path_length,
    weights,  # dict with the 5 weight keys
    acc_limits,  # (ax, ay, aw)
    max_obstacles_dist,
    robot_radius,
    collision_margin,
    collision_box=None,  # (half_l, half_w) for BOX robots
) -> TickResult:
    """One full reference tick over the sampled grid: the serial semantics
    of generateTrajectories + getMinTrajectoryCost."""
    limits = list(limits)
    if not is_omni:
        limits[3:6] = [0.0, 0.0, 0.0]  # trajectory_sampler.cpp:51-54
    n_vx, n_vy = compute_linear_sample_split(is_omni, n_lin_samples)
    n_w = angular_slots(n_ang_samples)
    window = build_window(
        current_vel, limits, time_step, n_vx, n_vy, n_w, is_omni
    )
    grid = sample_grid(window, is_omni)

    if collision_box is not None:
        half_l, half_w = collision_box

        def collide(x, y, yaw):
            return box_collides(
                x, y, yaw, obs_xy, half_l, half_w, collision_margin
            )

    else:

        def collide(x, y, yaw):
            return circle_collides(x, y, obs_xy, robot_radius, collision_margin)

    w_goal = weights["goal_distance_weight"]
    w_path = weights["reference_path_distance_weight"]
    w_obs = weights["obstacles_distance_weight"]
    w_smooth = weights["smoothness_weight"]
    w_jerk = weights["jerk_weight"]

    samples = []
    min_cost = float("inf")  # DEFAULT_MIN_DIST
    winner = None
    winner_vel = None
    found = False
    for rec in grid:
        _, _, vx, vy, w, _ = rec
        traj = admissible_traj_from_vel(
            (vx, vy, w),
            start_pose,
            n_points,
            time_step,
            collide,
            drop_samples,
            num_ctrl_points,
        )
        if not traj.admissible:
            samples.append((rec, traj, None))
            continue
        total = 0.0
        if ref_path_length > 0.0:
            if w_goal > 0.0:
                total += w_goal * goal_cost(
                    traj.path_x, traj.path_y, seg_x, seg_y, seg_arc,
                    ref_path_length,
                )
            if w_path > 0.0:
                total += w_path * path_cost(
                    traj.path_x, traj.path_y, seg_x, seg_y, seg_total_length
                )
        if obs_xy.shape[0] > 0 and w_obs > 0.0:
            total += w_obs * obstacles_cost(
                traj.path_x, traj.path_y, obs_xy, max_obstacles_dist
            )
        if w_smooth > 0.0:
            total += w_smooth * smoothness_cost(
                traj.vx, traj.vy, traj.omega, acc_limits
            )
        if w_jerk > 0.0:
            total += w_jerk * jerk_cost(
                traj.vx, traj.vy, traj.omega, acc_limits
            )
        samples.append((rec, traj, total))
        if total < min_cost:  # strict <: first minimum wins
            min_cost = total
            winner = len(samples) - 1
            winner_vel = (vx, vy, w)
            found = True
    return TickResult(
        samples=samples,
        found=found,
        min_cost=min_cost,
        winner=winner,
        winner_vel=winner_vel,
    )


# ---------------------------------------------------------------------------
# DWA host orchestration oracle (dwa.cpp:157-233)
# ---------------------------------------------------------------------------


def adaptive_horizon(
    base_horizon, v_max, interp_dist, curvature, closest_index, tol,
    time_step=0.0,
):
    """adaptPredictionHorizonToCurvature (dwa.cpp:157-206): sagitta bound
    T <= sqrt(8*tol/kappa_max)/v_max over the peek window. When
    ``time_step`` > 0 the result is floored at ``2 * time_step`` — the
    clamp setPredictionHorizon applies when the new horizon lands
    (trajectory_sampler.cpp:316-326, invoked from dwa.cpp:204)."""
    if v_max < 1e-3 or interp_dist <= 0.0:
        return base_horizon
    n = len(curvature)
    start = min(closest_index, n - 1)
    peek = int(math.ceil(base_horizon * v_max / interp_dist))
    end = min(start + peek, n - 1)
    kappa_max = 0.0
    for i in range(start, end + 1):
        kappa_max = max(kappa_max, abs(float(curvature[i])))
    horizon = base_horizon
    if kappa_max > tol:
        horizon = min(base_horizon, math.sqrt(8.0 * tol / kappa_max) / v_max)
    if time_step > 0.0:
        horizon = max(horizon, 2.0 * time_step)
    return horizon


def tracked_segment_window(
    closest_index, path_size, max_segment_size, max_forward_distance,
    interp_dist,
):
    """findTrackedPathSegment (dwa.cpp:208-233): [start, end] inclusive."""
    start = min(closest_index, path_size - 1)
    lookahead = max_segment_size
    if interp_dist > 0.0:
        lookahead = max(
            max_segment_size,
            int(math.ceil(max_forward_distance / interp_dist)) + 1,
        )
    end = min(start + lookahead, path_size - 1)
    return start, end


# ---------------------------------------------------------------------------
# follower oracle (follower.cpp:149-353)
# ---------------------------------------------------------------------------


@dataclass
class OraclePathPosition:
    index: int = 0
    segment_index: int = 0
    segment_length: float = -1.0
    normal_distance: float = 0.0
    parallel_distance: float = 0.0
    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0


def normalize_to_minus_pi_pi(a: float) -> float:
    a = math.fmod(a + math.pi, 2.0 * math.pi)
    if a < 0:
        a += 2.0 * math.pi
    return a - math.pi


class OracleFollower:
    """Serial transcription of Follower's closest-point machinery.

    The path is given pre-interpolated as (xs, ys, curvature, seg_starts)
    where seg_starts[i] is the global index of segment i's first point and
    segment i spans [seg_starts[i], seg_starts[i+1] - 1] (path.cpp:383-396),
    matching the reference's Path::segment views.
    """

    def __init__(self, xs, ys, seg_starts, curvature=None):
        self.xs = np.asarray(xs, float)
        self.ys = np.asarray(ys, float)
        self.seg_starts = list(seg_starts)
        self.curvature = (
            np.asarray(curvature, float)
            if curvature is not None
            else np.zeros(len(xs))
        )
        self.max_segment_index = len(self.seg_starts) - 1
        self.closest = OraclePathPosition()
        self.current_segment_index = 0

    def segment_start_index(self, i):
        return self.seg_starts[i]

    def segment_end_index(self, i):
        """path.cpp:383-396: end = next segment's start - 1 (or path end)."""
        if i + 1 <= self.max_segment_index:
            return self.seg_starts[i + 1] - 1
        return len(self.xs) - 1

    def _d2(self, state, idx):
        dx = state[0] - self.xs[idx]
        dy = state[1] - self.ys[idx]
        return dx * dx + dy * dy

    def find_closest_segment_index(self, state, left, right):
        """follower.cpp:155-183, recursive binary descent."""
        if left == right:
            return left
        mid = (left + right) // 2
        left_d = self._d2(state, self.segment_start_index(left))
        right_d = self._d2(state, self.segment_start_index(right))
        if mid == right or mid == left:
            return left if left_d <= right_d else right
        if left_d <= right_d:
            return self.find_closest_segment_index(state, left, mid)
        return self.find_closest_segment_index(state, mid, right)

    def find_closest_point_on_segment(self, state, segment_index):
        """follower.cpp:199-264 (the `<=` keeps the LAST tied point)."""
        start_index = self.segment_start_index(segment_index)
        end_index = self.segment_end_index(segment_index)
        n = end_index - start_index + 1
        sx, sy = self.xs[start_index], self.ys[start_index]
        ex, ey = self.xs[end_index], self.ys[end_index]
        segment_heading = math.atan2(ey - sy, ex - sx)

        min_d2 = float("inf")
        closest_local = 0
        segment_position = 0.0
        for local in range(n):
            d2 = self._d2(state, start_index + local)
            if d2 <= min_d2:
                min_d2 = d2
                closest_local = local
                segment_position = local / (n - 1) if n > 1 else 1.0

        pos = OraclePathPosition()
        pos.index = closest_local + start_index
        pos.segment_index = segment_index
        pos.segment_length = segment_position
        pos.x = float(self.xs[pos.index])
        pos.y = float(self.ys[pos.index])
        pos.yaw = segment_heading
        pos.normal_distance = math.sqrt(min_d2)
        vec_x = state[0] - pos.x
        vec_y = state[1] - pos.y
        cross = math.cos(pos.yaw) * vec_y - math.sin(pos.yaw) * vec_x
        pos.parallel_distance = (
            pos.normal_distance if cross > 0 else -pos.normal_distance
        )
        return pos

    def find_closest_path_point(self, state):
        self.current_segment_index = self.find_closest_segment_index(
            state, 0, self.max_segment_index
        )
        return self.find_closest_point_on_segment(
            state, self.current_segment_index
        )

    def determine_target(self, state):
        """follower.cpp:266-304 sticky re-search rule. Returns
        (closest, heading_error)."""
        if (
            self.closest.segment_length <= 0.0
            or self.closest.index
            >= self.segment_end_index(self.current_segment_index)
            or self.closest.segment_length >= 0.9
        ):
            self.closest = self.find_closest_path_point(state)
        else:
            self.closest = self.find_closest_point_on_segment(
                state, self.closest.segment_index
            )
        heading_error = normalize_to_minus_pi_pi(self.closest.yaw - state[2])
        return self.closest, heading_error

    def speed_factor(
        self, omega, lookahead_distance, k_curv, k_rot, min_factor
    ):
        """follower.cpp:319-353."""
        curvature_sum = 0.0
        dist = 0.0
        idx = self.closest.index
        n = len(self.xs)
        while idx < n - 1:
            curvature_sum += abs(float(self.curvature[idx]))
            dist += math.hypot(
                self.xs[idx + 1] - self.xs[idx], self.ys[idx + 1] - self.ys[idx]
            )
            if dist >= lookahead_distance:
                break
            idx += 1
        exponent = k_curv * curvature_sum + k_rot * abs(omega)
        return max(math.exp(-exponent), min_factor)
