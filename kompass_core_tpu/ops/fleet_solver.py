"""Fully on-device fleet control: follower + solver for N robots per tick.

The host FleetRuntime (`parallel/multihost.py`) keeps the reference's
follower machinery per robot in Python — exact parity, but ~0.4 ms of host
work per robot per tick, which caps a 100-robot fleet near 25 Hz. This
module moves the ENTIRE per-tick pipeline onto the device:

    goal / losing-goal detection  (follower.cpp:109-142)
    sticky target determination   (follower.cpp:266-304, binary descent
                                   per follower.cpp:155-183, last-min tie)
    curvature-adaptive horizon    (dwa.cpp:157-206)
    scan -> world obstacle points
    tracked-segment windowing     (dwa.cpp:208-233)
    dynamic window + rollout + costs + argmin   (ops/solver.dwa_solve)
    rotate-in-place shortcut      (corrected sign, see PARITY.md #7)

as ONE jitted, vmapped program with a small per-robot carry (closest index,
segment index, goal distance, reached flag). Host work per tick collapses
to stacking state/scan arrays.

Path data (padded [N, P] SoA + segment tables) is uploaded once per
`set_paths`; only states and scans move per tick.
"""

import dataclasses
from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .solver import SolverSpec, _device_window, dwa_solve

_PAD = 1e8


@dataclasses.dataclass(frozen=True, eq=True)
class FleetSpec:
    solver: SolverSpec
    path_capacity: int  # P: padded interpolated path points per robot
    max_segments: int  # NS: padded segment count per robot
    # M tracked moving objects per robot (beyond-reference; pairs with
    # SolverSpec.moving_obstacles): the tick input matrix gains a
    # trailing [M, 4] (x, y, vx, vy) world-frame block per robot, each
    # object enters the fused sweep at its constant-velocity predicted
    # position, and the k-tick loop advects it between ticks. 0 = the
    # input layout and compiled program are unchanged.
    tracked_obstacles: int = 0
    # Route tracked movers through a SEPARATE narrow moving sweep
    # min-combined with the (static-width) scan sweep instead of the
    # scan bucket's tail slots — bit-identical outputs (min over the
    # same union; zero-velocity rows are bit-equal static), and the
    # scan bucket stays at its rays-only size. Tail-slot is the
    # default; this bit-identical alternative awaits a GPU race
    # (benchmark/moving_bench.py, ROADMAP Design item 2).
    split_mover_sweep: bool = False


class FleetPaths(NamedTuple):
    """Device-resident per-robot path data (uploaded once per set_paths)."""

    x: jnp.ndarray  # [N, P] f32, padded with +1e8
    y: jnp.ndarray  # [N, P]
    arc: jnp.ndarray  # [N, P] prefix arc length
    curvature: jnp.ndarray  # [N, P]
    n_points: jnp.ndarray  # [N] i32
    seg_starts: jnp.ndarray  # [N, NS] i32 (padded with n_points)
    n_segs: jnp.ndarray  # [N] i32
    total_len: jnp.ndarray  # [N] f32


class FleetCarry(NamedTuple):
    """Follower state carried across ticks (reference Follower members)."""

    closest_idx: jnp.ndarray  # [N] i32
    seg_idx: jnp.ndarray  # [N] i32
    pos_in_seg: jnp.ndarray  # [N] f32 (reference segment_length, [0, 1])
    goal_dist: jnp.ndarray  # [N] f32
    reached: jnp.ndarray  # [N] bool


class FleetConfig(NamedTuple):
    """Per-robot dynamic configuration arrays."""

    params12: jnp.ndarray  # [N, 12] SolverParams block (packed layout)
    limits9: jnp.ndarray  # [N, 9] control limits
    sensor_pose: jnp.ndarray  # [N, 3] sensor (x, y, yaw) in body
    rotate_in_place: jnp.ndarray  # [N] bool
    goal_dist_tol: jnp.ndarray  # [N]
    goal_ori_tol: jnp.ndarray  # [N]
    losing_goal_dist: jnp.ndarray  # [N]
    interp_dist: jnp.ndarray  # [N]
    base_horizon_s: jnp.ndarray  # [N] seconds
    curvature_tol: jnp.ndarray  # [N]
    vx_max: jnp.ndarray  # [N]
    max_segment_size: jnp.ndarray  # [N] i32 (lookahead floor, points)
    # per-robot collision half-extents (heterogeneous fleets with
    # spec.dynamic_box): (0, 0) for circle robots whose radius is folded
    # into params12[2] (collision margin); (hl, hw) for BOX robots
    collision_box2: jnp.ndarray = None  # [N, 2] f32


class FleetSafety(NamedTuple):
    """Per-robot critical-zone data for the SAFETY-FUSED fleet tick.

    The reference stack runs its ``CriticalZoneChecker`` as a separate
    per-tick call beside the controller (``critical_zone_check.cpp:87-119``
    driven by the Kompass ROS stack); here that would be a second
    dispatch per robot per tick, and the k-tick on-device
    serving loop would fly blind between host safety checks. Fusing the
    masked-min factor into the tick program makes every command —
    including every tick INSIDE ``run_ticks_on_device(k)`` — safety-gated
    at zero extra dispatches.

    Beam trig / cone masks are host-precomputed from the same
    ``CriticalZoneSpec`` the standalone checker uses (bit-parity on the
    single-tick path); ``half_cone`` drives the world-point cone test the
    k-tick loop uses once the robot has moved off the tick-0 scan pose.
    """

    cos_a: jnp.ndarray  # [N, R] f32 — sensor-frame beam trig (host f64 cos)
    sin_a: jnp.ndarray  # [N, R]
    fwd_mask: jnp.ndarray  # [N, R] bool — forward critical cone
    bwd_mask: jnp.ndarray  # [N, R] bool
    sensor_c: jnp.ndarray  # [N] f32 — cos/sin of sensor yaw (host f64)
    sensor_s: jnp.ndarray  # [N]
    radius: jnp.ndarray  # [N] f32 — robot surface radius
    crit: jnp.ndarray  # [N] f32 — critical (stop) distance
    slow: jnp.ndarray  # [N] f32 — slowdown distance
    half_cone: jnp.ndarray  # [N] f32 — wrapped half-cone angle (rad)


def build_fleet_safety(zone_specs, n_rows: int, scan_rays: int) -> FleetSafety:
    """Stack per-robot ``CriticalZoneSpec``s into padded fleet arrays.

    Rows past ``len(zone_specs)`` (fleet pads) get all-False masks — their
    factor is identically 1.0."""
    R = scan_rays
    cos_a = np.zeros((n_rows, R), np.float32)
    sin_a = np.zeros((n_rows, R), np.float32)
    fwd = np.zeros((n_rows, R), bool)
    bwd = np.zeros((n_rows, R), bool)
    sc = np.ones(n_rows, np.float32)
    ss = np.zeros(n_rows, np.float32)
    rad = np.zeros(n_rows, np.float32)
    crit = np.zeros(n_rows, np.float32)
    slow = np.ones(n_rows, np.float32)
    half = np.zeros(n_rows, np.float32)
    for i, z in enumerate(zone_specs):
        if len(z.cos_angles) != R:
            raise ValueError(
                f"zone spec {i} has {len(z.cos_angles)} beams; fleet scan "
                f"grid has {R} — build the zone with the fleet's angle grid"
            )
        cos_a[i] = z.cos_angles
        sin_a[i] = z.sin_angles
        fwd[i] = z.forward_mask
        bwd[i] = z.backward_mask
        sc[i] = np.cos(z.sensor_yaw)
        ss[i] = np.sin(z.sensor_yaw)
        rad[i] = z.robot_radius
        crit[i] = z.critical_distance
        slow[i] = z.slowdown_distance
        half[i] = z.half_cone
    return FleetSafety(
        cos_a=jnp.asarray(cos_a),
        sin_a=jnp.asarray(sin_a),
        fwd_mask=jnp.asarray(fwd),
        bwd_mask=jnp.asarray(bwd),
        sensor_c=jnp.asarray(sc),
        sensor_s=jnp.asarray(ss),
        radius=jnp.asarray(rad),
        crit=jnp.asarray(crit),
        slow=jnp.asarray(slow),
        half_cone=jnp.asarray(half),
    )


def _safety_factor_scan(safety_row: FleetSafety, ranges, sensor_xy, forward):
    """Beam-mask slowdown factor — arithmetic-identical to
    ``ops/critical_zone.critical_zone_check`` (same host-precomputed trig,
    same f32 op order), so the fused tick and the standalone
    ``EmergencyChecker`` agree bit-for-bit on the same scan."""
    x = ranges * safety_row.cos_a
    y = ranges * safety_row.sin_a
    bx = safety_row.sensor_c * x - safety_row.sensor_s * y + sensor_xy[0]
    by = safety_row.sensor_s * x + safety_row.sensor_c * y + sensor_xy[1]
    dist = jnp.sqrt(bx * bx + by * by) - safety_row.radius
    denom = safety_row.slow - safety_row.crit
    factor = jnp.clip((dist - safety_row.crit) / denom, 0.0, 1.0)
    mask = jnp.where(forward, safety_row.fwd_mask, safety_row.bwd_mask)
    factor = jnp.where(mask & jnp.isfinite(ranges), factor, 1.0)
    return jnp.min(factor)


def _safety_factor_world(safety_row: FleetSafety, obs_world, x, y, yaw,
                         forward):
    """World-point slowdown factor for the k-tick on-device loop: the
    robot has moved off the tick-0 scan pose, so the cone test runs on
    each frozen world obstacle point's bearing in the CURRENT body frame
    (pad points at 1e8 are trivially clear). Equals the beam form at the
    tick-0 pose for a centered sensor; with a translated sensor the beam
    preset evaluates the cone on translated UNIT beam directions
    (reference preset quirk, ``critical_zone_check.cpp:62-85``) while
    this form uses the true point bearings."""
    dx = obs_world[:, 0] - x
    dy = obs_world[:, 1] - y
    bearing = jnp.abs(
        jnp.mod(jnp.arctan2(dy, dx) - yaw + jnp.pi, 2.0 * jnp.pi) - jnp.pi
    )
    in_cone = jnp.where(
        forward,
        bearing <= safety_row.half_cone,
        bearing >= jnp.pi - safety_row.half_cone,
    )
    dist = jnp.sqrt(dx * dx + dy * dy) - safety_row.radius
    denom = safety_row.slow - safety_row.crit
    factor = jnp.clip((dist - safety_row.crit) / denom, 0.0, 1.0)
    return jnp.min(jnp.where(in_cone, factor, 1.0))


# ---------------------------------------------------------------------------
# per-robot device follower (all functions operate on ONE robot; vmapped)
# ---------------------------------------------------------------------------


def _seg_end_index(paths_row, seg_idx):
    """End index of a segment (reference path.cpp:383-398)."""
    ns = paths_row.n_segs
    nxt = jax.lax.dynamic_index_in_dim(
        paths_row.seg_starts, jnp.minimum(seg_idx + 1, ns - 1), keepdims=False
    )
    return jnp.where(seg_idx + 1 < ns, nxt - 1, paths_row.n_points - 1)


def _binary_descent(paths_row, px, py):
    """Closest-segment binary descent (follower.cpp:155-183) as a
    statically-unrolled bounded loop.

    NOT a ``lax.while_loop``: under vmap with the robot axis sharded
    across chips, a data-dependent loop condition compiles to a scalar
    all-reduce PER ITERATION (every device must agree to keep looping),
    which both serializes the fleet on collective round trips and breaks
    the zero-collective steady-state guarantee pinned by
    ``tests/test_scaling_hlo.py``. The descent halves [left, right] each
    step, so ``ceil(log2(max_segments)) + 2`` masked iterations settle
    every robot; the ``done`` mask makes extra iterations no-ops.
    """

    def d2_of(seg):
        i = jax.lax.dynamic_index_in_dim(
            paths_row.seg_starts, seg, keepdims=False
        )
        sx = jax.lax.dynamic_index_in_dim(paths_row.x, i, keepdims=False)
        sy = jax.lax.dynamic_index_in_dim(paths_row.y, i, keepdims=False)
        return (px - sx) ** 2 + (py - sy) ** 2

    left = jnp.int32(0)
    right = jnp.maximum(paths_row.n_segs - 1, 0)
    result = jnp.int32(0)
    done = right == left
    max_segments = int(paths_row.seg_starts.shape[0])
    for _ in range(max(1, max_segments - 1).bit_length() + 2):
        mid = (left + right) // 2
        dl = d2_of(left)
        dr = d2_of(right)
        at_edge = (mid == right) | (mid == left)
        chosen = jnp.where(dl <= dr, left, right)
        result = jnp.where(~done & at_edge, chosen, result)
        result = jnp.where(~done & (left == right), left, result)
        done = done | at_edge | (left == right)
        new_right = jnp.where(dl <= dr, mid, right)
        new_left = jnp.where(dl <= dr, left, mid)
        left = jnp.where(done, left, new_left)
        right = jnp.where(done, right, new_right)
    return result


def _closest_on_segment(paths_row, seg_idx, px, py):
    """Last-min closest point inside a segment (follower.cpp:199-264)."""
    start_i = jax.lax.dynamic_index_in_dim(
        paths_row.seg_starts, seg_idx, keepdims=False
    )
    end_i = _seg_end_index(paths_row, seg_idx)
    j = jnp.arange(paths_row.x.shape[0])
    in_seg = (j >= start_i) & (j <= end_i)
    d2 = jnp.where(
        in_seg, (px - paths_row.x) ** 2 + (py - paths_row.y) ** 2, jnp.inf
    )
    m = jnp.min(d2)
    # last index achieving the minimum (reference `<=` tie rule)
    cidx = jnp.max(jnp.where(d2 <= m, j, -1)).astype(jnp.int32)
    seg_size = end_i - start_i + 1
    pos = jnp.where(
        seg_size > 1,
        (cidx - start_i).astype(jnp.float32) / jnp.maximum(seg_size - 1, 1),
        1.0,
    )
    return cidx, pos, m, start_i, end_i


def _device_determine_target(paths_row, carry_i, px, py):
    """Sticky target determination (follower.cpp:266-304)."""
    closest_idx, seg_idx, pos_in_seg = carry_i
    seg_end = _seg_end_index(paths_row, seg_idx)
    research = (
        (pos_in_seg <= 0.0) | (closest_idx >= seg_end) | (pos_in_seg >= 0.9)
    )
    new_seg = jnp.where(
        research, _binary_descent(paths_row, px, py), seg_idx
    ).astype(jnp.int32)
    cidx, pos, min_d2, start_i, end_i = _closest_on_segment(
        paths_row, new_seg, px, py
    )
    # segment heading from segment start/end points
    sx = jax.lax.dynamic_index_in_dim(paths_row.x, start_i, keepdims=False)
    sy = jax.lax.dynamic_index_in_dim(paths_row.y, start_i, keepdims=False)
    ex = jax.lax.dynamic_index_in_dim(paths_row.x, end_i, keepdims=False)
    ey = jax.lax.dynamic_index_in_dim(paths_row.y, end_i, keepdims=False)
    heading = jnp.arctan2(ey - sy, ex - sx)
    return cidx, new_seg, pos, heading, jnp.sqrt(min_d2)


def _scan_to_world_obs(spec, ranges, angles, sensor_pose, x, y, yaw):
    """Egocentric scan -> padded [scan_size, 2] world-frame obstacle
    points (collision_check.h:98-117 chain: sensor -> body -> world)."""
    r = jnp.where(jnp.isfinite(ranges), ranges, _PAD)
    pxs = r * jnp.cos(angles)
    pys = r * jnp.sin(angles)
    cs, ss = jnp.cos(sensor_pose[2]), jnp.sin(sensor_pose[2])
    bx = cs * pxs - ss * pys + sensor_pose[0]
    by = ss * pxs + cs * pys + sensor_pose[1]
    cy, sy2 = jnp.cos(yaw), jnp.sin(yaw)
    obs = jnp.stack(
        [cy * bx - sy2 * by + x, sy2 * bx + cy * by + y], axis=1
    )
    R = obs.shape[0]
    if R > spec.scan_size:
        # silently dropping beams would blind the robot to obstacles
        # only those beams see — the same hazard the tracked-slot
        # overflow below raises for
        raise ValueError(
            f"{R} scan rays > spec.scan_size {spec.scan_size} — size the "
            "scan bucket to hold every beam (DeviceFleet does this; "
            "direct composers must too)"
        )
    if R < spec.scan_size:
        obs = jnp.concatenate(
            [obs, jnp.full((spec.scan_size - R, 2), _PAD)], axis=0
        )
    return obs, R


def _fleet_robot_step(
    spec: SolverSpec,
    paths_row: FleetPaths,
    cfg_row,
    carry_row,
    state4,  # x, y, yaw, speed
    vel3,
    ranges,  # [R]
    angles,  # [R]
    seg_capacity: int,
    obs_world=None,  # [scan_size, 2] world-frame obstacles (overrides scan)
    peer_pts=None,  # [N*peer_block, 2] world-frame peer points (shared)
    peer_block: int = 0,  # points per peer (1 center + ring samples)
    peer_count: int = 0,  # real peer points (static, for the count gate)
    row_id=None,  # this robot's fleet row (masks its own peer block)
    safety_row: FleetSafety = None,  # fused critical-zone check (one row)
    tracked4=None,  # [M, 4] (x, y, vx, vy) tracked moving objects, world
    peer_vel=None,  # [N*peer_block, 2] world peer velocities (prediction)
    split_movers: bool = False,  # movers via the narrow split sweep
):
    """One robot's full control tick on device.

    ``peer_pts``: fleet mutual avoidance (no upstream analog — the
    reference is single-robot). Every robot's disc is sampled as a
    center point + a ring of circumference points in world frame; each
    robot masks its OWN block to the pad sentinel and treats the rest
    as extra obstacle points in the same fused sweep that serves the
    scan (collision pruning + obstacle cost both see peers).

    ``safety_row``: fused emergency-stop gate (see ``FleetSafety``). The
    slowdown factor scales the linear command; factor 0 zeroes the whole
    twist (the Kompass stack's emergency-stop policy). The cone
    direction follows the sign of the commanded vx (vx == 0 — e.g.
    rotate-in-place — checks the forward cone). Peers are NOT in the
    safety sweep: mutual avoidance owns robot-robot spacing through the
    obstacle cost; an emergency-stop against peers would deadlock
    co-located fleets."""
    (params12, limits9, sensor_pose, rot_in_place, goal_tol, ori_tol,
     losing_tol, interp_dist, base_h, curv_tol, vx_max, max_seg_size,
     collision_box2) = cfg_row
    closest_idx, seg_idx, pos_in_seg, goal_dist, reached = carry_row
    x, y, yaw = state4[0], state4[1], state4[2]
    P = paths_row.x.shape[0]

    # --- goal / losing-goal (follower.cpp:109-142) ---
    goal_i = paths_row.n_points - 1
    gx = jax.lax.dynamic_index_in_dim(paths_row.x, goal_i, keepdims=False)
    gy = jax.lax.dynamic_index_in_dim(paths_row.y, goal_i, keepdims=False)
    d_goal = jnp.sqrt((x - gx) ** 2 + (y - gy) ** 2)
    at_end = (seg_idx + 1) >= (paths_row.n_segs - 1)
    improving = d_goal < goal_dist
    new_goal_dist = jnp.where(at_end & improving, d_goal, goal_dist)
    losing = at_end & ~improving & (jnp.abs(d_goal - goal_dist) > losing_tol)
    now_reached = reached | (d_goal <= goal_tol) | losing

    # --- target determination ---
    cidx, new_seg, pos, seg_heading, _nd = _device_determine_target(
        paths_row, (closest_idx, seg_idx, pos_in_seg), x, y
    )
    heading_error = jnp.mod(seg_heading - yaw + jnp.pi, 2 * jnp.pi) - jnp.pi

    # --- adaptive horizon (dwa.cpp:157-206) ---
    dt = params12[0]
    peek = jnp.ceil(base_h * vx_max / interp_dist).astype(jnp.int32)
    j = jnp.arange(P)
    start = jnp.minimum(cidx, paths_row.n_points - 1)
    in_peek = (j >= start) & (j <= jnp.minimum(start + peek, paths_row.n_points - 1))
    kappa_max = jnp.max(jnp.where(in_peek, jnp.abs(paths_row.curvature), 0.0))
    cap = jnp.sqrt(8.0 * curv_tol / jnp.maximum(kappa_max, 1e-9)) / jnp.maximum(
        vx_max, 1e-3
    )
    adaptive = jnp.where(kappa_max > curv_tol, jnp.minimum(base_h, cap), base_h)
    horizon = jnp.clip(adaptive, 2.0 * dt, base_h)
    active_points = jnp.clip(
        (horizon / dt).astype(jnp.int32), 2, spec.max_points
    )
    max_forward = adaptive * vx_max

    # --- obstacles: scan -> world (collision_check.h:98-117 chain) ---
    if obs_world is None:
        obs, R = _scan_to_world_obs(
            spec, ranges, angles, sensor_pose, x, y, yaw
        )
    else:
        # caller supplies world-frame obstacles directly (the k-tick
        # on-device loop: the scan is converted ONCE with the tick-0
        # pose, then the world stays static while the state evolves)
        obs = obs_world
        R = obs.shape[0]
    obs_count = jnp.int32(jnp.minimum(R, spec.scan_size))
    scan_len = obs.shape[0]
    mover4 = None
    if tracked4 is not None and split_movers:
        # split form (FleetSpec.split_mover_sweep): the movers never
        # touch the scan bucket — they run as a narrow separate moving
        # sweep inside dwa_solve, min-combined with the static field.
        # obs_count still counts them so the obstacle-cost gate matches
        # the tail-slot form exactly.
        mover4 = tracked4
        obs_count = obs_count + jnp.sum(tracked4[:, 0] < 1e7).astype(
            jnp.int32
        )
        tracked4 = None
    if tracked4 is not None:
        # tracked moving objects (x, y, vx, vy): positions enter the
        # sweep here; velocities ride the per-point obs_vel field below
        # so the solver's moving sweep predicts obs + v*t*dt within the
        # rollout. Pad slots sit at x >= 1e7 with zero velocity. NOT in
        # the safety sweep (like peers: avoidance owns spacing — an
        # emergency stop against a tracked mover would freeze the robot
        # in the mover's path instead of steering off it).
        #
        # The movers ride the scan bucket's guaranteed-pad TAIL slots
        # (the fleet sizes scan_size >= rays + M) instead of being
        # concatenated: growing a pow2-full bucket by even one point
        # pushes _pad_sweep_pow2 to the next power of two and ~doubles
        # the dominant sweep's width.
        m_rows = tracked4.shape[0]
        n_rays = ranges.shape[0]
        if n_rays + m_rows > scan_len:
            raise ValueError(
                f"scan bucket {scan_len} cannot hold {n_rays} rays + "
                f"{m_rows} tracked slots — size scan_size >= rays + M"
            )
        obs = jnp.concatenate(
            [obs[: scan_len - m_rows], tracked4[:, 0:2]], axis=0
        )
        obs_count = obs_count + jnp.sum(tracked4[:, 0] < 1e7).astype(
            jnp.int32
        )
    if peer_pts is not None:
        slots = jnp.arange(peer_pts.shape[0]) // peer_block
        pts = jnp.where((slots == row_id)[:, None], _PAD, peer_pts)
        obs = jnp.concatenate([obs, pts], axis=0)
        obs_count = obs_count + jnp.int32(peer_count)
    obs_vel = None
    if spec.moving_obstacles and (
        tracked4 is not None or peer_vel is not None
    ):
        if tracked4 is not None:
            vel_parts = [
                jnp.zeros((scan_len - tracked4.shape[0], 2), jnp.float32),
                tracked4[:, 2:4],
            ]
        else:
            vel_parts = [jnp.zeros((scan_len, 2), jnp.float32)]
        if peer_pts is not None:
            if peer_vel is not None:
                # peer prediction: each peer disc point advects along
                # its robot's live world velocity within the rollout —
                # same own-block mask the position concat used above
                vel_parts.append(
                    jnp.where(
                        (slots == row_id)[:, None], 0.0, peer_vel
                    )
                )
            else:
                vel_parts.append(
                    jnp.zeros((peer_pts.shape[0], 2), jnp.float32)
                )
        obs_vel = jnp.concatenate(vel_parts, axis=0)

    # --- tracked segment window (dwa.cpp:208-233) ---
    # NOTE: path arrays are allocated seg_capacity wider than the path
    # capacity (host pads), so the dynamic slice at `start` is always
    # in-bounds and window data begins at slot 0 (the dwa_solve contract).
    lookahead = jnp.maximum(
        max_seg_size,
        jnp.ceil(max_forward / interp_dist).astype(jnp.int32) + 1,
    )
    end = jnp.minimum(start + lookahead, paths_row.n_points - 1)
    seg_count = jnp.minimum(end - start + 1, seg_capacity)
    seg_x_raw = jax.lax.dynamic_slice_in_dim(paths_row.x, start, seg_capacity)
    seg_y_raw = jax.lax.dynamic_slice_in_dim(paths_row.y, start, seg_capacity)
    seg_arc = jax.lax.dynamic_slice_in_dim(paths_row.arc, start, seg_capacity)
    k = jnp.arange(seg_capacity)
    in_window = k < seg_count
    seg_x = jnp.where(in_window, seg_x_raw, _PAD)
    seg_y = jnp.where(in_window, seg_y_raw, _PAD)
    chords = jnp.sqrt(
        jnp.diff(seg_x_raw) ** 2 + jnp.diff(seg_y_raw) ** 2
    )
    seg_total_len = jnp.sum(jnp.where(in_window[1:], chords, 0.0))

    # --- solve ---
    from .solver import SolverParams

    params = SolverParams(*[params12[i] for i in range(12)])
    window = _device_window(spec, vel3, limits9, params.time_step)
    res = dwa_solve(
        spec,
        params,
        state4[0:3],
        window,
        obs,
        obs_count,
        seg_x,
        seg_y,
        seg_arc,
        seg_count,
        seg_total_len,
        paths_row.total_len,
        active_points,
        collision_box_dyn=collision_box2 if spec.dynamic_box else None,
        obs_vel=obs_vel,
        mover4=mover4,
    )

    # --- rotate-in-place / reached overrides ---
    rotate = rot_in_place & (jnp.abs(heading_error) > ori_tol * 10.0)
    w_max = limits9[6]
    rot_omega = heading_error * w_max / jnp.pi
    cmd_vx = jnp.where(rotate, 0.0, res.velocities[0, 0])
    cmd_vy = jnp.where(rotate, 0.0, res.velocities[0, 1])
    cmd_w = jnp.where(rotate, rot_omega, res.velocities[0, 2])
    found = rotate | res.found
    # a not-found tick must emit a ZERO command, not the inadmissible
    # argmin sample (all costs +inf -> argmin=0 = max-reverse, max-spin):
    # the host stack discards found=False commands and holds, but the
    # on-device k-tick loops integrate cmd directly — a boxed-in robot
    # would otherwise march on garbage and broadcast it to peers
    # (round-5 review)
    cmd_vx = jnp.where(found & ~now_reached, cmd_vx, 0.0)
    cmd_vy = jnp.where(found & ~now_reached, cmd_vy, 0.0)
    cmd_w = jnp.where(found & ~now_reached, cmd_w, 0.0)

    # --- fused critical-zone gate (critical_zone_check.cpp:87-119) ---
    if safety_row is None:
        safety_factor = jnp.float32(1.0)
    else:
        fwd_motion = cmd_vx >= 0.0
        if obs_world is None:
            # single tick: scan is current — bit-parity beam form
            safety_factor = _safety_factor_scan(
                safety_row, ranges, sensor_pose, fwd_motion
            )
        else:
            # k-tick loop: robot moved off the scan pose — check the
            # frozen world points against the CURRENT pose every tick
            safety_factor = _safety_factor_world(
                safety_row, obs_world, x, y, yaw, fwd_motion
            )
        cmd_vx = cmd_vx * safety_factor
        cmd_vy = cmd_vy * safety_factor
        cmd_w = jnp.where(safety_factor <= 0.0, 0.0, cmd_w)

    new_carry = (
        cidx,
        new_seg,
        pos,
        new_goal_dist,
        now_reached,
    )
    # ONE packed output vector per robot: a dict of arrays would cost one
    # device->host fetch per field (see OUT_FIELDS for the layout)
    out = jnp.stack(
        [
            (found & ~now_reached).astype(jnp.float32),
            now_reached.astype(jnp.float32),
            cmd_vx,
            cmd_vy,
            cmd_w,
            # host parity: _rotate_in_place_result reports cost 0.0
            # (dwa.py), not the discarded solve's cost
            jnp.where(rotate, 0.0, res.cost),
            heading_error,
            active_points.astype(jnp.float32),
            res.num_admissible.astype(jnp.float32),
            # 1.0 when no safety is configured (shape-stable output)
            safety_factor,
        ]
    )
    return new_carry, out


OUT_FIELDS = (
    "found",
    "reached",
    "vx",
    "vy",
    "omega",
    "cost",
    "heading_error",
    "active_points",
    "num_admissible",
    "safety_factor",
)


# block-loop unroll factor for _mapped_over_chunks (trace-time knob;
# see its docstring). 1 = lax.map (measured default); set >1 only via
# benchmark/chunk_unroll_bench.py experiments.
_CHUNK_UNROLL = 1


def _chunk_leaves(tree, chunk):
    """Reshape every [N, ...] leaf to [N // chunk, chunk, ...]."""
    return jax.tree_util.tree_map(
        lambda a: a.reshape((a.shape[0] // chunk, chunk) + a.shape[1:]),
        tree,
    )


def _mapped_over_chunks(vmapped, chunk):
    """Run a vmapped per-robot function as a lax.map over ``chunk``-row
    blocks inside the program, so every fleet size runs the same
    ``chunk``-row tiling of the fused sweeps in ONE dispatch. The
    default of 64 rows was tuned on the accelerator this code was first
    written for and has not been measured on a GPU (ROADMAP Speed
    item 3).

    Ragged row counts are zero-padded to a full chunk IN-PROGRAM (static
    shapes) and the pad rows sliced off the outputs — pad rows compute
    garbage in their own rows only (every per-robot op is row-local).
    Outputs are ALWAYS un-chunked back to [n, ...] here — callers never
    see a chunk axis (a caller-side ``shape[0] != n`` heuristic broke
    exactly when n // chunk == n, i.e. chunk=1).

    ``_CHUNK_UNROLL`` > 1 runs the block loop as ``lax.scan(unroll=u)``
    instead of ``lax.map`` (same semantics; trades program size for
    per-iteration loop overhead) — an experiment knob read at trace
    time, measured by ``benchmark/chunk_unroll_bench.py``."""

    def run(*args):
        # inputs-derived leading dim (last arg may be a pytree, e.g. the
        # FleetSafety rows of the safety-fused tick)
        n = jax.tree_util.tree_leaves(args[-1])[0].shape[0]
        if not chunk or n <= chunk:
            return vmapped(*args)
        pad = (-n) % chunk

        def pad_leaf(a):
            if not pad:
                return a
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths)

        padded = tuple(jax.tree_util.tree_map(pad_leaf, a) for a in args)
        chunked = tuple(_chunk_leaves(a, chunk) for a in padded)
        if _CHUNK_UNROLL > 1:
            _, out = jax.lax.scan(
                lambda c, cs: (c, vmapped(*cs)), (), chunked,
                unroll=_CHUNK_UNROLL,
            )
        else:
            out = jax.lax.map(lambda cs: vmapped(*cs), chunked)
        # un-chunk (+ slice off pads) so callers see [n, ...] directly
        out = jax.tree_util.tree_map(
            lambda a: a.reshape((n + pad,) + a.shape[2:])[:n], out
        )
        return out

    return run


def make_fleet_tick(
    fleet_spec: FleetSpec, mesh=None, axis_name: str = "robots",
    chunk: int = 64, peer_cfg=None, safety: bool = False,
):
    """Jit-compiled fleet tick:
    (paths, cfg, carry, angles [N,R] (device-resident),
     inputs [N, 4+3+R] (state | vel | ranges — ONE transfer per tick)
     [, safety: FleetSafety — when built with safety=True])
    -> (carry', outputs [N, len(OUT_FIELDS)]).

    ``chunk``: run the robot axis as a lax.map over chunk-row blocks
    inside the program (see ``_mapped_over_chunks``). Under a mesh the
    chunking applies to each chip's LOCAL shard (DeviceFleet passes
    chunk=None there and relies on per-chip sizing instead).

    ``peer_cfg``: fleet mutual avoidance (beyond-reference; see
    ``_fleet_robot_step``). Dict with ``radii`` (host [N] f32 —
    circumscribed radius per fleet row, pads included), ``n_real``
    (real robot count) and ``ring`` (circumference samples per peer).
    Each robot sees every other robot as a center point + ``ring``
    points at its circumference radius, recomputed from the live states
    each tick — the per-robot sweep grows by N*(ring+1) points, so the
    cost is O(N^2) across the fleet; intended for co-located fleets up
    to a few hundred robots. Under a ``mesh`` the peer state is
    gathered with exactly ONE bounded ``all_gather`` per tick — the
    [N, 7] state+velocity block, N*28 bytes — and everything
    downstream stays row-local, so the steady state is "one collective
    per tick" instead of zero (pinned by tests/test_scaling_hlo.py).

    ``safety``: build the tick with the fused critical-zone gate — the
    returned function takes a trailing ``FleetSafety`` pytree and every
    command is emergency-stop-gated on device (see ``FleetSafety``).
    Row-local masked min only: the compiled steady state stays
    collective-free under a mesh."""
    spec = fleet_spec.solver
    _check_tracked_spec(fleet_spec)
    _check_peer_cfg(fleet_spec, peer_cfg)

    def tick(paths, cfg, carry, angles, inputs, safety_arg=None):
        states, vels, ranges, tracked = _split_tick_inputs(
            fleet_spec, cfg, inputs, safety, safety_arg
        )
        M = fleet_spec.tracked_obstacles
        if M:
            trk_extra = (tracked,)
        else:
            trk_extra = ()
        safety_extra = (safety_arg,) if safety else ()

        if peer_cfg is None:

            def one(paths_row_tuple, cfg_row, carry_row, s, v, r, a, *ex):
                paths_row = FleetPaths(*paths_row_tuple)
                return _fleet_robot_step(
                    spec, paths_row, cfg_row, carry_row, s, v, r, a,
                    fleet_spec.solver.seg_size,
                    tracked4=ex[0] if M else None,
                    safety_row=ex[1 if M else 0] if safety else None,
                    split_movers=fleet_spec.split_mover_sweep,
                )

            extra = trk_extra + safety_extra
        else:
            # mesh-sharded mutual avoidance: each chip holds its local
            # robot rows, so the peer disc inputs — the whole fleet's
            # states + commanded velocities — are gathered with ONE
            # bounded all_gather per tick ([N, 7] f32;
            # tests/test_scaling_hlo.py pins "exactly one all-gather").
            # Everything after the gather is row-local, exactly the
            # single-device program.
            states_g, vels_g, n_glob, row_ids = _gather_peer_state(
                mesh, axis_name, inputs[:, 0:7]
            )
            build_peers, build_peer_vel, peer_block, peer_count = (
                _peer_points_builder(peer_cfg, n_glob)
            )
            peer_pts = build_peers(states_g)  # live positions, this tick
            peer_vel = (
                build_peer_vel(states_g, vels_g)
                if peer_cfg.get("predict") and spec.moving_obstacles
                else None
            )

            def one(paths_row_tuple, cfg_row, carry_row, s, v, r, a, rid,
                    *ex):
                paths_row = FleetPaths(*paths_row_tuple)
                return _fleet_robot_step(
                    spec, paths_row, cfg_row, carry_row, s, v, r, a,
                    fleet_spec.solver.seg_size,
                    peer_pts=peer_pts,  # closed over: shared, not chunked
                    peer_block=peer_block,
                    peer_count=peer_count,
                    row_id=rid,
                    tracked4=ex[0] if M else None,
                    safety_row=ex[1 if M else 0] if safety else None,
                    split_movers=fleet_spec.split_mover_sweep,
                    peer_vel=peer_vel,  # closed over, like peer_pts
                )

            extra = (row_ids,) + trk_extra + safety_extra

        runner = _mapped_over_chunks(jax.vmap(one), chunk)
        carry2, out = runner(
            tuple(paths), tuple(cfg), tuple(carry), states, vels, ranges,
            angles, *extra,
        )
        # _mapped_over_chunks always returns [N, ...] leaves.
        # keep the FleetCarry treedef: a plain-tuple carry fed back on the
        # next tick would change the jit cache key and force a retrace
        return FleetCarry(*carry2), out

    if mesh is None:
        return jax.jit(tick)
    from jax.sharding import PartitionSpec as P

    # shard_map (not jit+in_shardings): each chip's LOCAL shard runs the
    # tick body, so the in-program 64-chunk map applies per chip — and
    # the compiled steady state stays collective-free
    # (tests/test_scaling_hlo.py)
    sp = P(axis_name)
    n_in = 6 if safety else 5
    return jax.jit(jax.shard_map(
        tick, mesh=mesh, in_specs=(sp,) * n_in,
        out_specs=(sp, sp),
    ))


def _check_peer_cfg(fleet_spec: FleetSpec, peer_cfg) -> None:
    """peer_cfg['predict'] without the moving sweep would silently fall
    back to frozen live-position peers (prediction off, no error) — the
    same hazard class _check_tracked_spec guards for movers. DeviceFleet
    couples the flags; direct composers get the build-time guard."""
    if (
        peer_cfg is not None
        and peer_cfg.get("predict")
        and not fleet_spec.solver.moving_obstacles
    ):
        raise ValueError(
            "peer_cfg['predict']=True requires "
            "solver.moving_obstacles=True — without the moving sweep "
            "the peer discs would be swept at frozen positions and "
            "prediction silently dropped"
        )


def _check_tracked_spec(fleet_spec: FleetSpec) -> None:
    """Tracked-mover slots without the moving sweep would silently
    DROP the supplied velocities (movers frozen at current positions —
    the planner drives through a crossing pedestrian's predicted path
    with no error). DeviceFleet couples the flags; direct composers get
    the same build-time guard the dynamic_box/safety paths have."""
    if (
        fleet_spec.tracked_obstacles
        and not fleet_spec.solver.moving_obstacles
        and not fleet_spec.split_mover_sweep
    ):
        raise ValueError(
            "FleetSpec.tracked_obstacles > 0 requires "
            "solver.moving_obstacles=True (tail-slot form) or "
            "split_mover_sweep=True — without either moving sweep "
            "the tracked velocities would be silently ignored"
        )


def _gather_peer_state(mesh, axis_name, sv_loc):
    """The one peer-state layout both peer programs share: a local
    [n_loc, 7] state+velocity block -> ([N_glob, 4] states, [N_glob, 3]
    vels, n_glob, this shard's global row ids). On a mesh this is ONE
    bounded tiled ``all_gather`` — THE steady-state collective
    tests/test_scaling_hlo.py counts; off-mesh it is a pure split. Used by
    the single-tick program (gathering ``inputs[:, 0:7]`` once per tick)
    and the k-tick loop body (gathering the live carried state each
    tick), so a layout change cannot desynchronize the two."""
    n_loc = sv_loc.shape[0]
    if mesh is None:
        return (
            sv_loc[:, 0:4], sv_loc[:, 4:7], n_loc,
            jnp.arange(n_loc, dtype=jnp.int32),
        )
    sv = jax.lax.all_gather(sv_loc, axis_name, axis=0, tiled=True)
    row_ids = (
        jax.lax.axis_index(axis_name) * n_loc
        + jnp.arange(n_loc, dtype=jnp.int32)
    )
    return sv[:, 0:4], sv[:, 4:7], n_loc * mesh.shape[axis_name], row_ids


def _split_tick_inputs(fleet_spec, cfg, inputs, safety, safety_arg):
    """Shared validation + packed-input split for the three tick
    programs (single tick, k-tick, k-tick-with-peers):
    ``[N, 7 + R (+ 4M)]`` -> ``(states, vels, ranges, tracked_or_None)``.
    ONE copy of the column layout so a future packed-layout change
    cannot silently desynchronize the programs (round-5 review — the
    same hazard class _gather_peer_state closed for the peer block)."""
    spec = fleet_spec.solver
    if spec.dynamic_box and cfg.collision_box2 is None:
        # None is an empty pytree — vmap would pass it through and the
        # solver would silently fall back to the circle model with the
        # radius double-counted (it is folded into collision_margin
        # under the dynamic-box convention)
        raise ValueError(
            "dynamic_box fleet spec requires FleetConfig.collision_box2"
        )
    if safety and safety_arg is None:
        raise ValueError(
            "tick program built with safety=True requires a FleetSafety arg"
        )
    states = inputs[:, 0:4]
    vels = inputs[:, 4:7]
    M = fleet_spec.tracked_obstacles
    if M:
        ranges = inputs[:, 7 : inputs.shape[1] - 4 * M]
        tracked = inputs[:, inputs.shape[1] - 4 * M :].reshape(
            inputs.shape[0], M, 4
        )
    else:
        ranges = inputs[:, 7:]
        tracked = None
    return states, vels, ranges, tracked


def _peer_points_builder(peer_cfg, n_rows):
    """Closure pieces for the peer-avoidance point set (shared by the
    single-tick and k-tick programs): returns (fn(states)->[N*block, 2],
    fn(states, vels)->[N*block, 2], block, count). Row ids are the
    CALLER's job — under a mesh they are global (axis_index * n_local +
    arange), which an arange here could not express."""
    ring = int(peer_cfg["ring"])
    n_real = int(peer_cfg["n_real"])
    radii = jnp.asarray(np.asarray(peer_cfg["radii"], np.float32)[:n_rows])
    ang = np.linspace(0.0, 2.0 * np.pi, ring, endpoint=False)
    ring_dirs = jnp.asarray(
        np.stack([np.cos(ang), np.sin(ang)], axis=1), jnp.float32
    )
    valid = (jnp.arange(n_rows) < n_real)[:, None, None]

    def build(states):
        centers = states[:, 0:2]
        pts = jnp.concatenate(
            [
                centers[:, None, :],
                centers[:, None, :]
                + radii[:, None, None] * ring_dirs[None, :, :],
            ],
            axis=1,
        )
        return jnp.where(valid, pts, _PAD).reshape(-1, 2)

    def build_vel(states, vels):
        """Per-point WORLD velocity for peer prediction: every point of
        robot j's disc carries j's commanded velocity rotated into the
        world frame (pad rows get zero — a pad must not march)."""
        cy, sy = jnp.cos(states[:, 2]), jnp.sin(states[:, 2])
        vw = jnp.stack(
            [
                vels[:, 0] * cy - vels[:, 1] * sy,
                vels[:, 0] * sy + vels[:, 1] * cy,
            ],
            axis=1,
        )
        per_pt = jnp.broadcast_to(
            vw[:, None, :], (n_rows, 1 + ring, 2)
        )
        return jnp.where(valid, per_pt, 0.0).reshape(-1, 2)

    block = 1 + ring
    count = max(n_real - 1, 0) * block
    return build, build_vel, block, count


def make_fleet_ticks_on_device(
    fleet_spec: FleetSpec, k: int, mesh=None, axis_name: str = "robots",
    chunk: int = 64, peer_cfg=None, safety: bool = False,
):
    """K carry-chained control ticks in ONE dispatch.

    A robot pays the host<->device round trip once per K ticks instead
    of once per tick.

    Semantics: the scan is converted to WORLD-frame obstacles once with
    the tick-0 pose (static-world assumption — the same assumption a
    single solve's rollout makes over its prediction horizon), then each
    tick solves against that world, applies its first command through
    the unicycle/omni kinematic update (``Path::State::update``,
    ``datatypes/path.h:24-30``), and feeds the next tick. Between sensor
    syncs the robot executes the K returned commands open-loop.

    ``peer_cfg`` (see ``make_fleet_tick``) switches the program from a
    per-robot k-scan to a FLEET-SYNCHRONOUS k-scan: every tick, each
    robot re-derives its peers' obstacle discs from the whole fleet's
    CURRENT on-device states — the static-world assumption then applies
    only to the scan obstacles, while peers stay live inside the k-tick
    loop (a multi-robot closed-loop rollout with mutual avoidance in one
    dispatch).

    ``safety``: fuse the critical-zone emergency-stop gate into EVERY
    tick of the loop (trailing ``FleetSafety`` arg). Without it the
    k-tick span executes open-loop with no safety check at all — the
    exact window the reference stack's per-tick ``CriticalZoneChecker``
    exists to cover. Inside the loop the factor is computed from the
    frozen world points against the robot's CURRENT pose
    (``_safety_factor_world``), so a robot integrating toward an
    obstacle slows and hard-stops mid-loop, on device.

    Returns a jitted ``(paths, cfg, carry, angles, inputs[N, 4+3+R]
    [, safety]) ->
    (carry', outs [N, k, len(OUT_FIELDS)], final_states [N, 4])``.
    """
    spec = fleet_spec.solver
    _check_tracked_spec(fleet_spec)
    _check_peer_cfg(fleet_spec, peer_cfg)

    def ticks_peer(paths: FleetPaths, cfg: FleetConfig, carry: FleetCarry,
                   angles, inputs, safety_arg=None):
        states, vels, ranges, tracked_all = _split_tick_inputs(
            fleet_spec, cfg, inputs, safety, safety_arg
        )
        M = fleet_spec.tracked_obstacles
        n = inputs.shape[0]
        safety_extra = (safety_arg,) if safety else ()
        # n_glob sizes the peer point set; the gather itself happens
        # per tick inside the k-loop body (k bounded collectives per
        # dispatch) via the same _gather_peer_state layout as the
        # single-tick program
        n_glob = n * (mesh.shape[axis_name] if mesh is not None else 1)
        build_peers, build_peer_vel, block, count = (
            _peer_points_builder(peer_cfg, n_glob)
        )
        predict_peers = bool(
            peer_cfg.get("predict") and spec.moving_obstacles
        )

        # world scan obstacles frozen at the tick-0 pose (per robot)
        obs_all = jax.vmap(
            lambda sp, s, r, a: _scan_to_world_obs(
                spec, r, a, sp, s[0], s[1], s[2]
            )[0]
        )(cfg.sensor_pose, states, ranges, angles)

        dt_col = cfg.params12[:, 0]  # [N]

        def body(c, i):
            carry_c, s_c, v_c = c
            # mesh form: ONE all_gather of the live [N, 7] state+velocity
            # block per tick keeps the fleet-synchronous peer model exact
            # across shards — peers on other chips stay live, not frozen.
            # row_ids is loop-invariant; XLA hoists it out of the scan.
            s_g, v_g, _, row_ids = _gather_peer_state(
                mesh, axis_name, jnp.concatenate([s_c, v_c], axis=1)
            )
            peer_pts = build_peers(s_g)  # live positions, this tick
            # peer prediction: inside the k-loop the peers' velocities
            # are the LIVE commanded ones from the previous tick
            peer_vel = build_peer_vel(s_g, v_g) if predict_peers else None
            if M:
                # tracked movers advect between ticks (see the non-peer
                # k-tick body)
                shift = tracked_all[:, :, 2:4] * (
                    i.astype(jnp.float32) * dt_col[:, None, None]
                )
                pos = jnp.where(
                    tracked_all[:, :, 0:1] < 1e7,
                    tracked_all[:, :, 0:2] + shift,
                    tracked_all[:, :, 0:2],
                )
                trk_i = jnp.concatenate(
                    [pos, tracked_all[:, :, 2:4]], axis=2
                )
                trk_extra = (trk_i,)
            else:
                trk_extra = ()

            def one(paths_row_tuple, cfg_row, carry_row, s, v, r, a, rid,
                    obs_row, *ex):
                paths_row = FleetPaths(*paths_row_tuple)
                return _fleet_robot_step(
                    spec, paths_row, cfg_row, carry_row, s, v, r, a,
                    fleet_spec.solver.seg_size, obs_world=obs_row,
                    peer_pts=peer_pts, peer_block=block,
                    peer_count=count, row_id=rid,
                    tracked4=ex[0] if M else None,
                    safety_row=ex[1 if M else 0] if safety else None,
                    split_movers=fleet_spec.split_mover_sweep,
                    peer_vel=peer_vel,  # closed over, like peer_pts
                )

            runner = _mapped_over_chunks(jax.vmap(one), chunk)
            new_carry, out = runner(
                tuple(paths), tuple(cfg), tuple(carry_c), s_c, v_c,
                ranges, angles, row_ids, obs_all, *trk_extra,
                *safety_extra,
            )
            vx, vy, om = out[:, 2], out[:, 3], out[:, 4]
            cy, sy = jnp.cos(s_c[:, 2]), jnp.sin(s_c[:, 2])
            ns = jnp.stack(
                [
                    s_c[:, 0] + dt_col * (vx * cy - vy * sy),
                    s_c[:, 1] + dt_col * (vx * sy + vy * cy),
                    s_c[:, 2] + dt_col * om,
                    jnp.sqrt(vx * vx + vy * vy),
                ],
                axis=1,
            )
            nv = jnp.stack([vx, vy, om], axis=1)
            return (FleetCarry(*new_carry), ns, nv), out

        (carry_f, s_f, _v_f), outs = jax.lax.scan(
            body, (FleetCarry(*tuple(carry)), states, vels),
            jnp.arange(k), length=k,
        )
        # [k, N, F] -> [N, k, F]
        return carry_f, jnp.transpose(outs, (1, 0, 2)), s_f

    def ticks(paths: FleetPaths, cfg: FleetConfig, carry: FleetCarry,
              angles, inputs, safety_arg=None):
        states, vels, ranges, tracked_all = _split_tick_inputs(
            fleet_spec, cfg, inputs, safety, safety_arg
        )
        M = fleet_spec.tracked_obstacles
        trk_extra = (tracked_all,) if M else ()
        safety_extra = (safety_arg,) if safety else ()

        def one(paths_row_tuple, cfg_row, carry_row, s, v, r, a, *ex):
            paths_row = FleetPaths(*paths_row_tuple)
            sensor_pose = cfg_row[2]
            dt = cfg_row[0][0]  # params12[0]
            obs, _n = _scan_to_world_obs(
                spec, r, a, sensor_pose, s[0], s[1], s[2]
            )
            trk0 = ex[0] if M else None
            safety_row = ex[1 if M else 0] if safety else None

            def body(c, i):
                carry_c, s_c, v_c = c
                if M:
                    # tracked movers advect between ticks (base position
                    # at tick i) AND within each tick's rollout (the
                    # moving sweep) — one consistent constant-velocity
                    # model across the whole k-span, while the scan
                    # world stays frozen at its tick-0 conversion
                    shift = trk0[:, 2:4] * (
                        i.astype(jnp.float32) * dt
                    )
                    pos = jnp.where(
                        trk0[:, 0:1] < 1e7, trk0[:, 0:2] + shift,
                        trk0[:, 0:2],
                    )
                    trk_i = jnp.concatenate([pos, trk0[:, 2:4]], axis=1)
                else:
                    trk_i = None
                new_carry, out = _fleet_robot_step(
                    spec, paths_row, cfg_row, carry_c, s_c, v_c, r, a,
                    fleet_spec.solver.seg_size, obs_world=obs,
                    tracked4=trk_i, safety_row=safety_row,
                    split_movers=fleet_spec.split_mover_sweep,
                )
                vx, vy, om = out[2], out[3], out[4]
                cy, sy = jnp.cos(s_c[2]), jnp.sin(s_c[2])
                ns = jnp.stack([
                    s_c[0] + dt * (vx * cy - vy * sy),
                    s_c[1] + dt * (vx * sy + vy * cy),
                    s_c[2] + dt * om,
                    jnp.sqrt(vx * vx + vy * vy),
                ])
                nv = jnp.stack([vx, vy, om])
                return (new_carry, ns, nv), out

            (carry_f, s_f, _v_f), outs = jax.lax.scan(
                body, (carry_row, s, v), jnp.arange(k), length=k
            )
            return carry_f, outs, s_f

        runner = _mapped_over_chunks(jax.vmap(one), chunk)
        carry2, outs, states_f = runner(
            tuple(paths), tuple(cfg), tuple(carry), states, vels, ranges,
            angles, *trk_extra, *safety_extra,
        )
        return FleetCarry(*carry2), outs, states_f

    fn = ticks_peer if peer_cfg is not None else ticks
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import PartitionSpec as P

    sp = P(axis_name)
    n_in = 6 if safety else 5
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(sp,) * n_in,
        out_specs=(sp, sp, sp),
    ))
