"""Device-resident fleet runtime (v2): whole-pipeline-on-device control.

Wraps ``ops/fleet_solver.py``: paths are interpolated/segmented on host
once (`set_paths`), padded, and uploaded; every tick afterwards is one
jitted dispatch taking only states, velocities and scans. Host cost per
tick is O(robots) numpy stacking — microseconds per robot — enabling
100 Hz fleets of hundreds of robots per host.

Use `parallel.multihost.FleetRuntime` instead when exact host-follower
parity is required per robot (it runs the reference's Python/native
follower machinery).
"""

import dataclasses
import logging
import math
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..control.dwa import DWAConfig, _round_up, segment_capacity
from ..datatypes.path import ReferencePath
from ..models import Robot, RobotCtrlLimits, RobotGeometry, RobotType
from ..ops.fleet_solver import (
    FleetCarry,
    FleetConfig,
    FleetPaths,
    FleetSpec,
    make_fleet_tick,
)
from ..ops.solver import COLLISION_MARGIN_FACTOR, SolverSpec
from ..ops.window import compute_linear_sample_split, num_angular_slots
from ..utils.runtime import enable_persistent_compilation_cache

_PAD = 1e8


@dataclasses.dataclass(frozen=True)
class FleetSafetyConfig:
    """Critical-zone emergency-stop parameters for the safety-fused fleet
    tick (the fleet form of ``EmergencyChecker``'s constructor surface;
    reference ``CriticalZoneChecker`` preset,
    ``critical_zone_check.cpp:13-85``). Defaults match the reference's
    benchmark configuration (``benchmark_runner.cpp:267-311``)."""

    critical_angle_deg: float = 160.0
    critical_distance: float = 0.3
    slowdown_distance: float = 0.6


class DeviceFleet:
    """N robots, one on-device control pipeline."""

    def __init__(
        self,
        robots: Sequence[Robot],
        ctrl_limits,  # RobotCtrlLimits, or one per robot
        config: DWAConfig,
        scan_rays: int,
        path_capacity: int = 2048,
        max_segments: int = 64,
        mesh=None,
        sensor_poses=None,  # [num_robots, 3] (x, y, yaw) in body, or None
        dispatch_chunk: int = 64,
        sensor_max_range: float = 10.0,
        peer_avoidance: bool = False,
        peer_ring_points: int = 8,
        safety_config=None,  # FleetSafetyConfig, or one per robot
        tracked_obstacles: int = 0,  # M moving-object slots per robot
        peer_prediction: bool = False,  # peers advect within the rollout
        split_mover_sweep: bool = False,  # movers via a narrow split sweep
    ):
        enable_persistent_compilation_cache()
        self.num_robots = len(robots)
        self.config = config
        self.mesh = mesh
        n_dev = (
            int(np.prod(mesh.devices.shape)) if mesh is not None else 1
        )
        self._n = ((self.num_robots + n_dev - 1) // n_dev) * n_dev  # padded
        # Big fleets run the robot axis as a lax.map over
        # ``dispatch_chunk``-row blocks INSIDE the compiled tick (one
        # dispatch per tick, the same tiling at any fleet size). The
        # default of 64 was tuned on the accelerator this code was first
        # written for and has not been measured on a GPU (ROADMAP Speed
        # item 3). Disabled under a mesh (the robot axis is sharded
        # instead; per-chip chunking via parallel/fleet.py applies there).
        self._chunk = 0
        if mesh is None and dispatch_chunk and self._n > dispatch_chunk:
            self._chunk = int(dispatch_chunk)
            self._n = (
                (self._n + self._chunk - 1) // self._chunk * self._chunk
            )

        # --- heterogeneity: per-robot limits / kinematics / shapes -------
        # (the reference is per-robot-configured by construction)
        if isinstance(ctrl_limits, RobotCtrlLimits):
            limits_list = [ctrl_limits] * self.num_robots
        else:
            limits_list = list(ctrl_limits)
            if len(limits_list) != self.num_robots:
                raise ValueError(
                    "ctrl_limits must be one RobotCtrlLimits or one per robot"
                )
        # any omni robot -> omni-shaped sample grid; non-omni robots keep
        # diff-drive sampling semantics through zeroed vy limits (their vy
        # axis collapses to the single vy=0 slot on device)
        is_omni = any(r.robot_type == RobotType.OMNI for r in robots)
        n_vx, n_vy = compute_linear_sample_split(
            is_omni, config.max_linear_samples
        )
        n_omega = num_angular_slots(config.max_angular_samples)
        dt = config.control_time_step
        base_h = config.prediction_horizon * dt
        interp = config.max_point_interpolation_distance
        fleet_vx_max = max(lim.vx_limits.max_vel for lim in limits_list)
        seg_size = segment_capacity(
            config.path_segment_length, interp, base_h, fleet_vx_max
        )

        # collision shapes: all-circle fleets use the cheap point sweep;
        # any BOX robot switches the whole fleet to the dynamic
        # oriented-box path, where circles are (0, 0)-extent boxes with
        # the radius folded into the margin (exact same circle model)
        has_box = any(
            r.geometry_type == RobotGeometry.Type.BOX for r in robots
        )
        margin = config.octree_resolution * COLLISION_MARGIN_FACTOR
        box2 = np.zeros((self._n, 2), np.float32)
        eff_margin = np.full(self._n, margin, np.float32)
        radius = np.zeros(self._n, np.float32)
        for i, r in enumerate(robots):
            radius[i] = r.radius
            if has_box:
                if r.geometry_type == RobotGeometry.Type.BOX:
                    gp = np.asarray(r.geometry_params, np.float64)
                    box2[i] = (gp[0] / 2.0, gp[1] / 2.0)
                    eff_margin[i] = margin
                else:
                    box2[i] = (0.0, 0.0)
                    eff_margin[i] = r.radius + margin

        solver_spec = SolverSpec(
            is_omni=is_omni,
            n_vx=n_vx,
            n_vy=n_vy,
            n_omega=n_omega,
            max_points=int(config.prediction_horizon),
            num_ctrl_points=int(config.control_horizon),
            # tracked-mover slots share the scan bucket (they overwrite
            # its guaranteed-pad tail — ops/fleet_solver), so the bucket
            # must hold rays + M; when rays alone already fill a pow2
            # bucket, any M widens the sweep to the next power of two
            # (ops/solver._pad_sweep_pow2). split_mover_sweep=True keeps
            # the bucket at rays only and runs the movers through a
            # separate narrow moving sweep — bit-identical commands;
            # benchmark/moving_bench.py times both forms
            scan_size=max(256, _round_up(
                scan_rays
                + (0 if split_mover_sweep else tracked_obstacles), 256
            )),
            seg_size=seg_size,
            drop_samples=bool(config.drop_samples),
            device_window=True,
            dynamic_box=has_box,
            # tracked movers / predicted peers ride the sweep at their
            # constant-velocity positions (ops/solver.py moving sweep);
            # split movers carry
            # their velocities in the narrow sweep instead, so only
            # peer prediction still needs the per-point velocity block
            moving_obstacles=(
                (tracked_obstacles > 0 and not split_mover_sweep)
                or peer_prediction
            ),
        )
        self._tracked = int(tracked_obstacles)
        self.spec = FleetSpec(
            solver=solver_spec,
            path_capacity=path_capacity,
            max_segments=max_segments,
            tracked_obstacles=self._tracked,
            split_mover_sweep=bool(split_mover_sweep),
        )
        # dispatch_chunk=0/None is the documented monolithic escape hatch
        # (one unchunked vmap over the whole fleet); only an ACTIVE chunk
        # reaches the tick program — `or 64` here would either assert on
        # unpadded fleets or silently re-chunk a monolithic request
        # fleet mutual avoidance (beyond-reference): every robot sees the
        # others as live obstacle discs (center + circumference ring) in
        # the same fused sweep the scan rides — collision pruning AND the
        # obstacle cost both respect peers, zero host involvement. The
        # per-robot sweep grows by N*(ring+1) points (O(N^2) fleet-wide).
        # Under a mesh the peer state crosses devices as ONE bounded
        # all_gather ([N, 7] f32) per tick — the only collective in the
        # steady state (tests/test_scaling_hlo.py).
        self._peer_cfg = None
        if peer_prediction and not peer_avoidance:
            raise ValueError(
                "peer_prediction requires peer_avoidance=True (it "
                "advects the peer discs the avoidance path creates)"
            )
        if peer_avoidance:
            self._peer_cfg = {
                "radii": radius,  # [padded N], pads masked by n_real
                "n_real": self.num_robots,
                "ring": int(peer_ring_points),
                # peers advect along their live commanded velocities
                # within each tick's rollout (moving sweep) — beyond the
                # live-position re-derivation both modes share
                "predict": bool(peer_prediction),
            }
        # fused emergency stop (ops/fleet_solver.FleetSafety): every
        # command — including every tick inside run_ticks_on_device —
        # is critical-zone-gated on device, replacing the reference
        # stack's separate per-robot EmergencyChecker dispatch
        self._safety_cfgs = None
        self._safety = None
        if safety_config is not None:
            if isinstance(safety_config, FleetSafetyConfig):
                self._safety_cfgs = [safety_config] * self.num_robots
            else:
                self._safety_cfgs = list(safety_config)
                if len(self._safety_cfgs) != self.num_robots:
                    raise ValueError(
                        "safety_config must be one FleetSafetyConfig or "
                        "one per robot"
                    )
            # zone presets need shape/dims per robot; masks are built
            # lazily in set_scan_angles (they depend on the angle grid)
            self._safety_geoms = [
                (r.geometry_type.value,
                 np.asarray(r.geometry_params, np.float64))
                for r in robots
            ]
        self._tick_fn = make_fleet_tick(
            self.spec, mesh=mesh, chunk=self._chunk or None,
            peer_cfg=self._peer_cfg, safety=self._safety_cfgs is not None,
        )
        self._scan_rays = scan_rays

        # per-robot config arrays
        N = self._n
        w = config.costs_weights
        limits_rows = np.zeros((N, 9), np.float32)
        params = np.zeros((N, 12), np.float32)
        vx_max_rows = np.zeros(N, np.float32)
        for i in range(N):
            lim = limits_list[min(i, self.num_robots - 1)]
            row = lim.to_array().astype(np.float32).copy()
            robot_i = robots[min(i, self.num_robots - 1)]
            if robot_i.robot_type != RobotType.OMNI:
                # non-holonomic: vy limits discarded
                # (trajectory_sampler.cpp:51-54)
                row[3:6] = 0.0
            limits_rows[i] = row
            vx_max_rows[i] = lim.vx_limits.max_vel
            params[i] = (
                dt,
                radius[i],
                eff_margin[i],
                w.reference_path_distance_weight,
                w.goal_distance_weight,
                w.obstacles_distance_weight,
                w.smoothness_weight,
                w.jerk_weight,
                row[1],
                row[4],
                row[7],
                # maxObstaclesDist = sensor range / 3 — the same rule the
                # single-robot controller applies via set_sensor_max_range
                # (control/dwa.py, cost_evaluator.h:174-193)
                float(sensor_max_range) / 3.0,
            )
        rotate = np.array(
            [r.robot_type != RobotType.ACKERMANN for r in robots]
            + [False] * (N - self.num_robots)
        )
        sensor = np.zeros((N, 3), np.float32)
        if sensor_poses is not None:
            sp = np.asarray(sensor_poses, np.float32)
            sensor[: len(sp)] = sp
        self._sensor_host = sensor.copy()  # zone presets reuse (x, y, yaw)
        self._cfg = FleetConfig(
            params12=jnp.asarray(params),
            limits9=jnp.asarray(limits_rows),
            sensor_pose=jnp.asarray(sensor),
            rotate_in_place=jnp.asarray(rotate),
            goal_dist_tol=jnp.full(N, config.goal_dist_tolerance, jnp.float32),
            goal_ori_tol=jnp.full(
                N, config.goal_orientation_tolerance, jnp.float32
            ),
            losing_goal_dist=jnp.full(
                N, config.loosing_goal_distance, jnp.float32
            ),
            interp_dist=jnp.full(N, interp, jnp.float32),
            base_horizon_s=jnp.full(N, base_h, jnp.float32),
            curvature_tol=jnp.full(
                N, config.curvature_horizon_tolerance, jnp.float32
            ),
            vx_max=jnp.asarray(vx_max_rows),
            max_segment_size=jnp.full(
                N, int(config.path_segment_length / interp) + 1, jnp.int32
            ),
            collision_box2=jnp.asarray(box2),
        )
        self._cfg = self._put(self._cfg)
        self._paths: Optional[FleetPaths] = None
        self._carry: Optional[FleetCarry] = None
        self._angles = None  # device-resident per-robot scan angles
        self._angles_src = None  # host copy for change detection
        self._inputs = np.zeros(
            (self._n, 4 + 3 + scan_rays + 4 * self._tracked), np.float32
        )
        if self._tracked:
            self._reset_tracked_block()
        self.last_tick_seconds = 0.0

    def _put(self, tree):
        """Upload a per-robot pytree ONCE with the tick function's
        sharding. Without this, jit reshards the (large, static) path and
        config tables from single-device placement on EVERY dispatch."""
        if self.mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec

        sh = NamedSharding(self.mesh, PartitionSpec("robots"))
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sh), tree
        )

    def set_scan_angles(self, angles: np.ndarray):
        """Upload the (usually static) scan angle grid once. With a
        ``safety_config``, also (re)build the per-robot critical-zone
        presets — the cone masks are per-beam, so they live and die with
        the angle grid."""
        ang = np.asarray(angles, np.float32)
        self._angles_src = ang.copy()
        if ang.ndim == 1:
            ang = np.tile(ang, (self._n, 1))
        else:
            a2 = np.zeros((self._n, self._scan_rays), np.float32)
            a2[: len(ang)] = ang
            ang = a2
        self._angles = self._put(jnp.asarray(ang))
        if self._safety_cfgs is not None:
            from ..ops.critical_zone import build_critical_zone
            from ..ops.fleet_solver import build_fleet_safety

            specs = []
            for i, (shape, dims) in enumerate(self._safety_geoms):
                c = self._safety_cfgs[i]
                sx, sy, syaw = (float(v) for v in self._sensor_host[i])
                specs.append(build_critical_zone(
                    robot_shape_type=shape,
                    robot_dimensions=dims,
                    sensor_position_body=(sx, sy, 0.0),
                    sensor_rotation_body=(
                        0.0, 0.0, math.sin(syaw / 2.0), math.cos(syaw / 2.0)
                    ),
                    critical_angle_deg=c.critical_angle_deg,
                    critical_distance=c.critical_distance,
                    slowdown_distance=c.slowdown_distance,
                    angles=np.asarray(ang[i], np.float64),
                ))
            self._safety = self._put(
                build_fleet_safety(specs, self._n, self._scan_rays)
            )

    # ------------------------------------------------------------------

    def _path_row(self, pts, i):
        """Interpolate + segment ONE path on host -> padded row arrays
        (x, y, arc, curv, n_points, seg_starts, n_segs, total_len)."""
        P = self.spec.path_capacity
        cap = P + self.spec.solver.seg_size  # extra tail for window slices
        NS = self.spec.max_segments
        interp = self.config.max_point_interpolation_distance
        max_seg_pts = int(self.config.path_segment_length / interp) + 1
        x = np.full(cap, _PAD, np.float32)
        y = np.full(cap, _PAD, np.float32)
        arc = np.zeros(cap, np.float32)
        curv = np.zeros(cap, np.float32)
        seg_starts = np.zeros(NS, np.int32)
        ref = ReferencePath(np.asarray(pts))
        ref.interpolate(interp)
        ref.segment(self.config.path_segment_length, max_seg_pts)
        n = min(ref.size(), P)
        x[:n] = ref.xs[:n]
        y[:n] = ref.ys[:n]
        arc[:n] = ref.arc_lengths[:n]
        curv[:n] = ref.curvature[:n]
        starts = np.asarray(ref.segment_starts[: ref.num_segments])
        if ref.size() > P:
            # keep only segments that survive the truncation; phantom
            # starts past the kept points would make the losing-goal
            # failsafe unreachable (at_end could never fire)
            logging.getLogger("kompass_core_tpu").warning(
                "fleet path %d truncated: %d interpolated points > "
                "path_capacity %d; increase FleetSpec.path_capacity",
                i, ref.size(), P,
            )
            starts = starts[starts < n]
        if len(starts) > NS:
            # silent segment merging would arm the device follower's
            # at_end / losing-goal failsafe segments early (the robot
            # could stop mid-path reporting reached) — warn like the
            # point-capacity overflow above
            logging.getLogger("kompass_core_tpu").warning(
                "fleet path %d has %d segments > max_segments %d; the "
                "tail merges into the last device segment and the "
                "losing-goal failsafe arms early — increase "
                "FleetSpec.max_segments or path_segment_length",
                i, len(starts), NS,
            )
        ns = max(min(len(starts), NS), 1)
        seg_starts[:ns] = starts[:ns]
        seg_starts[ns:] = n  # padded starts point past the end
        # total length of the path AS LOADED (goal = last kept point)
        total = (
            ref.total_path_length()
            if ref.size() <= P
            else float(ref.arc_lengths[n - 1])
        )
        return x, y, arc, curv, n, seg_starts, ns, np.float32(total)

    def set_paths(self, paths: Sequence[np.ndarray]):
        """Interpolate + segment each path on host, pad, upload once.

        Resets the WHOLE fleet's follower carry. To re-route a single
        robot mid-mission without touching the others, use
        ``update_path``."""
        if len(paths) != self.num_robots:
            # a short list would silently leave the tail robots on the
            # default 1-point PAD path (no goal, no path cost — they
            # drive on garbage with found=True); extra rows would write
            # into mesh pad slots
            raise ValueError(
                f"set_paths got {len(paths)} paths for a "
                f"{self.num_robots}-robot fleet"
            )
        N = self._n
        P = self.spec.path_capacity
        cap = P + self.spec.solver.seg_size
        NS = self.spec.max_segments
        x = np.full((N, cap), _PAD, np.float32)
        y = np.full((N, cap), _PAD, np.float32)
        arc = np.zeros((N, cap), np.float32)
        curv = np.zeros((N, cap), np.float32)
        n_points = np.ones(N, np.int32)
        seg_starts = np.zeros((N, NS), np.int32)
        n_segs = np.ones(N, np.int32)
        total = np.zeros(N, np.float32)
        for i, pts in enumerate(paths):
            (x[i], y[i], arc[i], curv[i], n_points[i], seg_starts[i],
             n_segs[i], total[i]) = self._path_row(pts, i)
        self._paths = self._put(FleetPaths(
            x=jnp.asarray(x),
            y=jnp.asarray(y),
            arc=jnp.asarray(arc),
            curvature=jnp.asarray(curv),
            n_points=jnp.asarray(n_points),
            seg_starts=jnp.asarray(seg_starts),
            n_segs=jnp.asarray(n_segs),
            total_len=jnp.asarray(total),
        ))
        self._carry = FleetCarry(
            closest_idx=jnp.zeros(N, jnp.int32),
            seg_idx=jnp.zeros(N, jnp.int32),
            pos_in_seg=jnp.full(N, -1.0, jnp.float32),
            goal_dist=jnp.full(N, np.inf, jnp.float32),
            reached=jnp.asarray(
                [False] * self.num_robots + [True] * (N - self.num_robots)
            ),
        )

    def update_path(self, i: int, pts):
        """Re-route ONE robot mid-mission: upload its new path row and
        reset ONLY its follower carry — every other robot's tracking
        state (closest index, segment, reached flag) is untouched, and
        only the single row moves host->device (set_paths re-uploads the
        whole fleet and resets everyone). Production serving: robots
        finish and receive missions at different times."""
        if self._paths is None:
            raise ValueError("update_path before set_paths")
        if not 0 <= i < self.num_robots:
            raise IndexError(f"robot index {i} out of range")
        x, y, arc, curv, n, starts, ns, total = self._path_row(pts, i)
        if not hasattr(self, "_row_update_fn"):
            def _apply(paths, carry, idx, xr, yr, ar, cr, n_, st, ns_, tot):
                paths2 = FleetPaths(
                    x=paths.x.at[idx].set(xr),
                    y=paths.y.at[idx].set(yr),
                    arc=paths.arc.at[idx].set(ar),
                    curvature=paths.curvature.at[idx].set(cr),
                    n_points=paths.n_points.at[idx].set(n_),
                    seg_starts=paths.seg_starts.at[idx].set(st),
                    n_segs=paths.n_segs.at[idx].set(ns_),
                    total_len=paths.total_len.at[idx].set(tot),
                )
                carry2 = FleetCarry(
                    closest_idx=carry.closest_idx.at[idx].set(0),
                    seg_idx=carry.seg_idx.at[idx].set(0),
                    pos_in_seg=carry.pos_in_seg.at[idx].set(-1.0),
                    goal_dist=carry.goal_dist.at[idx].set(np.inf),
                    reached=carry.reached.at[idx].set(False),
                )
                return paths2, carry2

            # idx traced (no recompile per robot); buffers donated (the
            # old fleet arrays are dead after the update)
            self._row_update_fn = jax.jit(_apply, donate_argnums=(0, 1))
        self._paths, self._carry = self._row_update_fn(
            self._paths, self._carry, jnp.int32(i), jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(arc), jnp.asarray(curv),
            jnp.int32(n), jnp.asarray(starts), jnp.int32(ns),
            jnp.float32(total),
        )

    def tick_example_args(self):
        """Example-args tuple matching the compiled tick program's calling
        convention ``(paths, cfg, carry, angles, inputs[, safety])`` —
        consumed by ``serving.export.export_fleet_tick`` (only shapes and
        dtypes are recorded in the artifact). Requires ``set_paths`` and
        ``set_scan_angles`` to have been called: the path tables and the
        angle grid pin the artifact's static shapes."""
        if self._paths is None or self._carry is None:
            raise RuntimeError(
                "call set_paths() first — the path tables define the "
                "artifact's shapes"
            )
        if self._angles is None:
            raise RuntimeError("call set_scan_angles() first")
        extra = (self._safety,) if self._safety is not None else ()
        return (
            self._paths, self._cfg, self._carry, self._angles,
            self._inputs, *extra,
        )

    def _reset_tracked_block(self):
        """Pad every tracked-object slot: position at the sentinel,
        velocity zero (a pad must not march through the workspace)."""
        M = self._tracked
        blk = self._inputs[:, -4 * M :].reshape(self._n, M, 4)
        blk[:, :, 0:2] = _PAD
        blk[:, :, 2:4] = 0.0

    def _write_tracked(self, tracked):
        """Fill the per-robot tracked-object block of the input matrix.

        ``tracked``: None (all slots empty this tick), a [num_robots, M',
        4] array, or a sequence of per-robot [m_i, 4] arrays of world
        (x, y, vx, vy) rows with m_i <= M. Rows containing any
        non-finite value are treated as EMPTY slots — so a fixed-shape
        array padded with np.nan is the supported way to express "robot
        i tracks fewer than M' objects" (zero-padding would plant a
        phantom static obstacle at the world origin), and a tracker's
        NaN-velocity newborn tracks are dropped instead of poisoning the
        sweep."""
        if self._tracked == 0:
            if tracked is not None:
                raise ValueError(
                    "this fleet was built with tracked_obstacles=0 — "
                    "pass tracked_obstacles=M to the DeviceFleet "
                    "constructor to enable moving-object input"
                )
            return
        self._reset_tracked_block()
        if tracked is None:
            return
        M = self._tracked
        blk = self._inputs[:, -4 * M :].reshape(self._n, M, 4)
        arr = np.asarray(tracked, np.float32) if not isinstance(
            tracked, (list, tuple)
        ) else None
        if arr is not None and arr.ndim == 2:
            # ambiguous: [M', 4] could mean "M' movers for one robot" or
            # "one mover per robot" — silently picking one produces a
            # wrong world model for the other reading
            raise ValueError(
                "2-D tracked arrays are ambiguous — pass a 3-D "
                "[num_robots, M', 4] array or a sequence of per-robot "
                "[m_i, 4] arrays"
            )
        if arr is not None and arr.ndim == 3:
            # fixed-shape [num_robots, M', 4] fast path: one vectorized
            # mask instead of a per-robot Python loop — this sits on the
            # per-tick serving hot path (n=1024 fleets)
            nr, mp, w = arr.shape
            if w != 4:
                raise ValueError(
                    f"tracked rows must be [m, 4] (x, y, vx, vy); got "
                    f"trailing dim {w}"
                )
            if nr > self.num_robots:
                raise ValueError(
                    f"{nr} tracked rows for {self.num_robots} robots"
                )
            if mp > M:
                raise ValueError(
                    f"{mp} tracked objects > capacity {M} "
                    "(raise tracked_obstacles)"
                )
            ok = np.isfinite(arr).all(axis=2)  # non-finite row == empty
            dst = blk[:nr, :mp]
            np.copyto(dst, arr, where=ok[:, :, None])
            return
        rows = list(tracked)
        if len(rows) > self.num_robots:
            raise ValueError(
                f"{len(rows)} tracked rows for {self.num_robots} robots"
            )
        for i, row in enumerate(rows):
            r = np.atleast_2d(np.asarray(row, np.float32))
            if r.size == 0:
                continue
            if r.shape[1] != 4:
                raise ValueError(
                    "tracked rows must be [m, 4] (x, y, vx, vy); got "
                    f"shape {r.shape} for robot {i}"
                )
            if r.shape[0] > M:
                raise ValueError(
                    f"robot {i}: {r.shape[0]} tracked objects > capacity "
                    f"{M} (raise tracked_obstacles)"
                )
            r = r[np.isfinite(r).all(axis=1)]  # non-finite row == empty slot
            blk[i, : r.shape[0]] = r

    def state_dict(self) -> dict:
        """Host snapshot of the fleet's mutable state — path tables,
        follower carry, scan-angle grid — as a flat dict of numpy arrays
        (``np.savez``-compatible). With the AOT artifacts
        (``serving.export``) this completes the serving-restart story: a
        new process loads the artifact + ``load_state_dict`` and resumes
        the mission bit-for-bit, paying neither tracing nor host-side
        path re-interpolation. (The reference is stateless per tick by
        design, SURVEY §5 checkpoint/resume; a device-resident fleet is
        not, so it owns its checkpoint format.)"""
        if self._paths is None or self._carry is None:
            raise RuntimeError("nothing to snapshot: call set_paths() first")
        sd = {
            "version": np.int32(1),
            "n": np.int32(self._n),
            "num_robots": np.int32(self.num_robots),
            "scan_rays": np.int32(self._scan_rays),
        }
        for name, tree in (("paths", self._paths), ("carry", self._carry)):
            for field, val in zip(type(tree)._fields, tree):
                sd[f"{name}/{field}"] = np.asarray(val)
        if self._angles_src is not None:
            sd["angles_src"] = self._angles_src.copy()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` snapshot into a fleet built with the
        same construction parameters. The angle grid goes through
        ``set_scan_angles`` so safety-zone presets are rebuilt; the path
        tables and carry upload with the fleet's sharding."""
        from ..ops.fleet_solver import FleetCarry, FleetPaths

        if int(sd["version"]) != 1:
            raise ValueError(f"unknown fleet state version {sd['version']}")
        if (
            int(sd["n"]) != self._n
            or int(sd["scan_rays"]) != self._scan_rays
            # same padded n does NOT imply same fleet: a 60-robot fleet
            # padded to 64 snapshots pad rows with reached=True, which a
            # 64-robot fleet would inherit as four robots stuck "done"
            or int(sd["num_robots"]) != self.num_robots
        ):
            raise ValueError(
                "snapshot shape mismatch: snapshot "
                f"(robots={int(sd['num_robots'])}, n={int(sd['n'])}, "
                f"rays={int(sd['scan_rays'])}) vs fleet "
                f"(robots={self.num_robots}, n={self._n}, "
                f"rays={self._scan_rays}) — rebuild the fleet with the "
                "snapshot's construction parameters"
            )
        if "angles_src" in sd:
            self.set_scan_angles(np.asarray(sd["angles_src"]))
        self._paths = self._put(FleetPaths(*(
            jnp.asarray(sd[f"paths/{f}"]) for f in FleetPaths._fields
        )))
        self._carry = FleetCarry(*(
            jnp.asarray(sd[f"carry/{f}"]) for f in FleetCarry._fields
        ))

    def _prepare_tick_inputs(self, states, vels, ranges, angles, tracked):
        """Shared per-tick host assembly for ``tick`` and
        ``run_ticks_on_device``: (re)upload the angle grid when it
        actually changes (a silently-ignored new grid would place every
        obstacle at the wrong bearing; the host compare is tiny next to
        the device tick), fill the packed input matrix in place, and
        return the trailing safety args. Guards the ticked-before-set-up
        misuse with a clear error instead of a trace-time TypeError."""
        if self._paths is None or self._carry is None:
            raise RuntimeError(
                "call set_paths() before ticking — the fleet has no "
                "path tables or follower carry yet"
            )
        ang_in = np.asarray(angles, np.float32)
        if self._angles is None or not np.array_equal(
            ang_in, self._angles_src
        ):
            self.set_scan_angles(ang_in)
        n = self.num_robots
        R = self._scan_rays
        st = np.asarray(states, np.float32)
        self._inputs[:n, : min(4, st.shape[1])] = st[:, :4]
        self._inputs[:n, 4:7] = np.asarray(vels, np.float32)
        self._inputs[:n, 7 : 7 + R] = np.asarray(ranges, np.float32)
        self._inputs[n:, 7 : 7 + R] = _PAD
        self._write_tracked(tracked)
        return (self._safety,) if self._safety is not None else ()

    def run_ticks_on_device(self, k: int, states, vels, ranges, angles,
                            tracked=None):
        """K carry-chained control ticks in ONE dispatch per chunk.

        A robot gets k commands per host round trip — per-tick cost
        drops from one round trip to a k-th of one plus compute. The scan
        is frozen to world-frame obstacles at the tick-0 pose
        (static-world assumption over the k-tick span); the robot state
        is integrated on device through the same kinematic update the
        rollout uses, assuming the commands execute faithfully. With
        ``peer_avoidance=True`` the k-scan is FLEET-synchronous: peers'
        obstacle discs are re-derived from the live on-device states
        every tick, so only the scan world is frozen — a multi-robot
        closed-loop rollout with mutual avoidance in one dispatch.

        Same inputs as ``tick``. Returns the usual output dict with a
        trailing per-tick axis ([num_robots, k] per field) plus
        ``final_states`` [num_robots, 4].
        """
        import time

        from ..ops.fleet_solver import (
            OUT_FIELDS,
            make_fleet_ticks_on_device,
        )

        t0 = time.perf_counter()
        if not hasattr(self, "_ticks_fns"):
            self._ticks_fns = {}
        if k not in self._ticks_fns:
            self._ticks_fns[k] = make_fleet_ticks_on_device(
                self.spec, k, mesh=self.mesh, chunk=self._chunk or None,
                peer_cfg=self._peer_cfg,
                safety=self._safety_cfgs is not None,
            )
        fn = self._ticks_fns[k]
        # ONE dispatch for the whole fleet: the robot axis runs as an
        # in-program lax.map over 64-row blocks (make_fleet_ticks_on_device)
        safety_extra = self._prepare_tick_inputs(
            states, vels, ranges, angles, tracked
        )
        self._carry, out_mat, fin = fn(
            self._paths, self._cfg, self._carry, self._angles,
            self._inputs, *safety_extra,
        )
        out_np = np.asarray(out_mat)[: self.num_robots]
        fin_np = np.asarray(fin)[: self.num_robots]
        out = {
            f: out_np[:, :, i] for i, f in enumerate(OUT_FIELDS)
        }  # [num_robots, k]
        out["found"] = out["found"] > 0.5
        out["reached"] = out["reached"] > 0.5
        out["final_states"] = fin_np
        self.last_tick_seconds = time.perf_counter() - t0
        return out

    def tick(self, states, vels, ranges, angles, tracked=None):
        """One fleet tick.

        states [num_robots, >=3], vels [num_robots, 3],
        ranges [num_robots, R], angles [R] or [num_robots, R].
        ``tracked`` (fleets built with ``tracked_obstacles=M``): per-robot
        moving objects as a [num_robots, M', 4] array or a sequence of
        [m_i, 4] world (x, y, vx, vy) rows — each enters the robot's
        sweep at its constant-velocity predicted position.
        Returns dict of numpy arrays per robot (found, reached, vx, vy,
        omega, cost)."""
        import time

        t0 = time.perf_counter()
        from ..ops.fleet_solver import OUT_FIELDS

        # ONE dispatch, ONE packed upload, ONE fetch per tick: the robot
        # axis runs as an in-program lax.map over 64-row blocks
        # (make_fleet_tick chunk param), with no per-chunk dispatches
        safety_extra = self._prepare_tick_inputs(
            states, vels, ranges, angles, tracked
        )
        self._carry, out_mat = self._tick_fn(
            self._paths, self._cfg, self._carry, self._angles,
            self._inputs, *safety_extra,
        )
        out_np = np.asarray(out_mat)[: self.num_robots]  # one fetch
        out = {k: out_np[:, i] for i, k in enumerate(OUT_FIELDS)}
        out["found"] = out["found"] > 0.5
        out["reached"] = out["reached"] > 0.5
        self.last_tick_seconds = time.perf_counter() - t0
        return out
