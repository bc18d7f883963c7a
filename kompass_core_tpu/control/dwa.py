"""DWA local planner: host orchestration around the jitted device solver.

Equivalent of the reference's ``DWA`` controller
(``controllers/dwa.cpp`` + Python wrapper ``control/dwa.py:22-424``):
target determination, rotate-in-place shortcut, curvature-adaptive
prediction horizon, tracked-segment windowing — all host side — and the
sampling/rollout/cost/argmin hot loop as one device program
(``ops/solver.py``).

Horizon conventions match the reference Python wrapper: DWAConfig horizons
are *steps* and multiplied by control_time_step before use
(reference ``control/dwa.py:233-234``).
"""

import dataclasses
import logging
import math
from typing import List, Optional, Union

import numpy as np
from attrs import Factory, define, field

from ..datatypes.laserscan import LaserScanData
from ..datatypes.path import ReferencePath
from ..models import (
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotState,
    RobotType,
)
from ..ops.solver import (
    COLLISION_MARGIN_FACTOR,
    SolverSpec,
    get_packed_dwa_solver,
    make_packed_dwa_solver,
    pack_solver_input,
    packed_input_size,
    unpack_solver_output,
)
from ..utils.runtime import enable_persistent_compilation_cache
from ..ops.window import (
    compute_linear_sample_split,
    num_angular_slots,
    sample_velocity_window,
)
from ..utils.config import base_validators
from .follower import Follower, FollowerConfig
from .trajectory_costs import TrajectoryCostsWeights

logger = logging.getLogger("kompass_core_tpu")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def segment_capacity(
    path_segment_length: float, interp_dist: float,
    base_horizon_s: float, vx_max: float,
) -> int:
    """Padded tracked-segment capacity shared by the single-robot DWA
    and DeviceFleet: the dynamic lookahead can reach
    ``ceil(base_horizon * v_max / interp) + 1`` points (dwa.cpp:208-233),
    floored by the configured segment point count (follower.cpp:54-59),
    +1 start slot, rounded to the 64-lane grid. ONE copy so the two
    entry points cannot size the shared dwa_solve segment-window
    contract differently (round-5 review)."""
    lookahead_pts = max(
        int(path_segment_length / interp_dist) + 1,
        int(math.ceil(base_horizon_s * vx_max / interp_dist)) + 1,
    )
    return _round_up(lookahead_pts + 1, 64)


@define
class DWAConfig(FollowerConfig):
    """DWA parameters (defaults per reference ``control/dwa.py:22-143``)."""

    control_time_step: float = field(
        default=0.1, validator=base_validators.in_range(1e-4, 1e6)
    )
    control_horizon: int = field(
        default=2, validator=base_validators.in_range(1, 1000)
    )
    prediction_horizon: int = field(
        default=10, validator=base_validators.in_range(1, 1000)
    )
    max_linear_samples: int = field(
        default=20, validator=base_validators.in_range(1, 1e3)
    )
    max_angular_samples: int = field(
        default=20, validator=base_validators.in_range(1, 1e3)
    )
    proximity_sensor_position_to_robot: np.ndarray = field(
        default=Factory(lambda: np.zeros(3, dtype=np.float32))
    )
    proximity_sensor_rotation_to_robot: np.ndarray = field(
        default=Factory(lambda: np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32))
    )
    octree_resolution: float = field(
        default=0.1, validator=base_validators.in_range(1e-9, 1e3)
    )
    costs_weights: TrajectoryCostsWeights = field(
        default=Factory(TrajectoryCostsWeights)
    )
    max_num_threads: int = field(default=1)  # accepted for API parity; unused
    drop_samples: bool = field(default=True)
    # Beyond-reference: constant-velocity obstacle prediction — collision
    # and obstacle cost evaluate each obstacle at obs + v*t*dt along the
    # rollout (see ops/solver.py SolverSpec.moving_obstacles). Off by
    # default: the compiled program and packed layout then match the
    # reference's static-world semantics exactly.
    moving_obstacles: bool = field(default=False)

    def __attrs_post_init__(self):
        if self.control_horizon > self.prediction_horizon:
            logger.error(
                "Control horizon cannot exceed prediction horizon; clamping"
            )
            self.control_horizon = self.prediction_horizon


@define
class TrajectoryResult:
    """Winning trajectory (velocities + rolled path), host-side."""

    vx: np.ndarray = field(default=np.zeros(0))
    vy: np.ndarray = field(default=np.zeros(0))
    omega: np.ndarray = field(default=np.zeros(0))
    path_x: np.ndarray = field(default=np.zeros(0))
    path_y: np.ndarray = field(default=np.zeros(0))


@define
class SamplingControlResult:
    """Mirror of the reference's ``SamplingControlResult`` binding."""

    is_found: bool = field(default=False)
    cost: float = field(default=0.0)
    trajectory: TrajectoryResult = field(default=Factory(TrajectoryResult))


class DWA(Follower):
    """Dynamic Window Approach local planner, device-accelerated."""

    def __init__(
        self,
        robot: Robot,
        ctrl_limits: RobotCtrlLimits,
        config: Optional[DWAConfig] = None,
        config_file: Optional[str] = None,
        config_root_name: Optional[str] = None,
        control_time_step: Optional[float] = None,
        **_,
    ):
        enable_persistent_compilation_cache()
        self._config = config = config or DWAConfig()
        if config_file:
            config.from_file(config_file, config_root_name)
            # from_file assigns via setattr — re-apply the post-init
            # clamp, otherwise a file could set control_horizon beyond
            # prediction_horizon and slice past the command arrays
            config.control_horizon = min(
                config.control_horizon, config.prediction_horizon
            )
        if control_time_step:
            config.control_time_step = control_time_step
        if config.prediction_horizon < 2:
            raise ValueError(
                "prediction_horizon must be >= 2 steps (a rollout needs at "
                "least one velocity command)"
            )

        is_ackermann = robot.robot_type == RobotType.ACKERMANN
        super().__init__(config=config, is_ackermann=is_ackermann)

        self.robot = robot
        self.ctrl_limits = ctrl_limits
        self._limits_array = ctrl_limits.to_array()
        self._is_omni = robot.robot_type == RobotType.OMNI
        if not self._is_omni:
            # non-holonomic: vy limits are discarded
            # (trajectory_sampler.cpp:51-54)
            self._limits_array[3:6] = 0.0

        n_vx, n_vy = compute_linear_sample_split(
            self._is_omni, config.max_linear_samples
        )
        n_omega = num_angular_slots(config.max_angular_samples)

        self._dt = config.control_time_step
        self._base_horizon = config.prediction_horizon * self._dt
        self._max_points = self._num_points_for(self._base_horizon)
        self._active_points = self._max_points
        self._max_forward_distance = (
            self.ctrl_limits.vx_limits.max_vel * self._base_horizon
        )
        self._max_local_range = 10.0  # dwa.h:236 default sensor range

        # static tracked-segment capacity: the dynamic lookahead can reach
        # ceil(base_horizon * v_max / interp_dist) + 1 points (dwa.cpp:208-233)
        interp = config.max_point_interpolation_distance
        seg_size = segment_capacity(
            config.path_segment_length, interp, self._base_horizon,
            self.ctrl_limits.vx_limits.max_vel,
        )

        # BOX robots get the exact oriented-rectangle collision check;
        # the circumscribed circle would block corridors the box passes
        # lengthwise (reference FCL uses the true shape,
        # collision_check.h:91-136)
        collision_box = None
        if robot.geometry_type == RobotGeometry.Type.BOX:
            gp = np.asarray(robot.geometry_params, np.float64)
            collision_box = (float(gp[0]) / 2.0, float(gp[1]) / 2.0)

        self._spec_proto = dict(
            is_omni=self._is_omni,
            n_vx=n_vx,
            n_vy=n_vy,
            n_omega=n_omega,
            max_points=self._max_points,
            num_ctrl_points=int(config.control_horizon),
            seg_size=seg_size,
            drop_samples=bool(config.drop_samples),
            collision_box=collision_box,
            moving_obstacles=bool(config.moving_obstacles),
        )
        self._solvers = {}  # scan_size bucket -> jitted solver
        self._custom_costs: List = []

        # sensor-to-body 2D transform (position + quaternion yaw)
        from ..utils.geometry import yaw_from_quaternion

        self._sensor_yaw = yaw_from_quaternion(
            config.proximity_sensor_rotation_to_robot
        )
        self._sensor_pos = np.asarray(
            config.proximity_sensor_position_to_robot, dtype=np.float64
        )[:2]

        self._result = SamplingControlResult()
        self._end_of_ctrl_horizon = max(int(config.control_horizon), 1)
        self._got_path = False
        logger.info("DWA controller ready")

    # ------------------------------------------------------------------
    # configuration helpers
    # ------------------------------------------------------------------

    def _num_points_for(self, horizon_s: float) -> int:
        """size_t(horizon / dt) truncation semantics
        (``datatypes/trajectory.h:48-51``)."""
        return int(horizon_s / self._dt)

    def set_sensor_max_range(self, max_range: float):
        self._max_local_range = float(max_range)

    def set_resolution(self, resolution: float):
        self._config.octree_resolution = float(resolution)

    def add_custom_cost(self, weight: float, cost_fn):
        """Register a custom JAX cost
        ``fn(vel_traj [S,T-1,3], px [S,T], py [S,T], active_points) -> [S]``
        (reference ``DWA::addCustomCost``, ``dwa.h:103``)."""
        self._custom_costs.append((float(weight), cost_fn))
        self._solvers.clear()

    def _solver_for(self, scan_bucket: int):
        key = scan_bucket
        if key not in self._solvers:
            spec = SolverSpec(scan_size=scan_bucket, **self._spec_proto)
            if self._custom_costs:
                solver = make_packed_dwa_solver(spec, tuple(self._custom_costs))
            else:
                solver = get_packed_dwa_solver(spec)
            self._solvers[key] = (
                spec,
                solver,
                np.zeros(packed_input_size(spec), dtype=np.float32),
            )
        return self._solvers[key]

    def _params_vec(self) -> np.ndarray:
        """12-float dynamic parameter block for the packed solver input."""
        w = self._config.costs_weights
        return np.array(
            [
                self._dt,
                self.robot.radius,
                self._config.octree_resolution * COLLISION_MARGIN_FACTOR,
                w.reference_path_distance_weight,
                w.goal_distance_weight,
                w.obstacles_distance_weight,
                w.smoothness_weight,
                w.jerk_weight,
                self._limits_array[1],
                self._limits_array[4],
                self._limits_array[7],
                self._max_local_range / 3.0,
            ],
            dtype=np.float32,
        )

    # ------------------------------------------------------------------
    # per-tick host logic
    # ------------------------------------------------------------------

    def _adapt_prediction_horizon(self):
        """Curvature-adaptive horizon (``dwa.cpp:157-206``): sagitta bound
        T <= sqrt(8 * tol / kappa_max) / v_max."""
        base = self._base_horizon
        v_max = self.ctrl_limits.vx_limits.max_vel
        interp = self._config.max_point_interpolation_distance
        if self._path is None or v_max < 1e-3 or interp <= 0.0:
            self._set_prediction_horizon(base)
            self._max_forward_distance = base * v_max
            return
        start = min(self._closest.index, self._path.size() - 1)
        peek = int(math.ceil(base * v_max / interp))
        end = min(start + peek, self._path.size() - 1)
        kappa_max = float(np.max(np.abs(self._path.curvature[start : end + 1])))
        adaptive = base
        tol = self._config.curvature_horizon_tolerance
        if kappa_max > tol:
            adaptive = min(base, math.sqrt(8.0 * tol / kappa_max) / v_max)
        self._set_prediction_horizon(adaptive)
        self._max_forward_distance = adaptive * v_max

    def _set_prediction_horizon(self, horizon_s: float):
        """Clamp to [2*dt, base] (``trajectory_sampler.cpp:316-326``)."""
        horizon_s = min(max(horizon_s, 2.0 * self._dt), self._base_horizon)
        self._active_points = max(2, self._num_points_for(horizon_s))

    def _tracked_segment_window(self):
        """Segment window covering the rollout reach (``dwa.cpp:208-233``)."""
        path = self._path
        start = min(self._closest.index, path.size() - 1)
        interp = self._config.max_point_interpolation_distance
        lookahead = self.max_segment_size
        if interp > 0.0:
            lookahead = max(
                lookahead,
                int(math.ceil(self._max_forward_distance / interp)) + 1,
            )
        end = min(start + lookahead, path.size() - 1)
        return start, end

    def _obstacle_points_world(self, laser_scan=None, point_cloud=None):
        """Sensor data -> world-frame 2D obstacle points.

        LaserScan: polar -> sensor frame -> body (sensor tf) -> world (robot
        pose at the tick), same chain as ``collision_check.h:98-117`` +
        ``cost_evaluator.h:174-193``. Non-finite ranges are pushed to 1e8
        (never the nearest point; the reference skips them for collision).
        """
        if laser_scan is not None:
            from ..native import scan_to_obstacle_block

            r = np.asarray(laser_scan.ranges, dtype=np.float64)
            a = np.asarray(laser_scan.angles, dtype=np.float64)
            block, n = scan_to_obstacle_block(
                r,
                a,
                (self._sensor_pos[0], self._sensor_pos[1], self._sensor_yaw),
                (
                    self.current_state.x,
                    self.current_state.y,
                    self.current_state.yaw,
                ),
                1e8,
                len(r),
            )
            return block.reshape(2, -1).T
        elif point_cloud is not None:
            pts = (
                point_cloud.points
                if hasattr(point_cloud, "points")
                else np.asarray(point_cloud)
            )
            if pts.ndim == 2 and pts.shape[1] >= 2:
                px = pts[:, 0].astype(np.float64)
                py = pts[:, 1].astype(np.float64)
            else:
                return np.zeros((0, 2), dtype=np.float32)
        else:
            return np.zeros((0, 2), dtype=np.float32)

        # sensor -> body
        cs, ss = math.cos(self._sensor_yaw), math.sin(self._sensor_yaw)
        bx = cs * px - ss * py + self._sensor_pos[0]
        by = ss * px + cs * py + self._sensor_pos[1]
        # body -> world
        cy, sy = math.cos(self.current_state.yaw), math.sin(self.current_state.yaw)
        wx = cy * bx - sy * by + self.current_state.x
        wy = sy * bx + cy * by + self.current_state.y
        return np.stack([wx, wy], axis=1).astype(np.float32)

    def _gather_obstacles(
        self, laser_scan, point_cloud, map_points_world, velocities=None
    ):
        """World-frame [N, 2] obstacle points from whichever input was
        given, with non-finite points DROPPED: one NaN point would
        otherwise defeat every collision comparison (NaN < r^2 is false —
        nothing ever drops) and poison the obstacle cost, so the solver
        would return found=True with cost=nan and an arbitrary winner.

        ``velocities`` [N, 2] (moving-obstacle mode) must align row-wise
        with the given points and gets the same finite-row filter.
        Returns ``(obs, vels_or_None)``."""
        if map_points_world is not None:
            obs = np.atleast_2d(np.asarray(map_points_world, np.float32))
            # an empty local map means obstacle-free planning, not a crash
            obs = (
                np.zeros((0, 2), np.float32) if obs.size == 0 else obs[:, :2]
            )
        else:
            obs = self._obstacle_points_world(laser_scan, point_cloud)
        vels = None
        if velocities is not None:
            vels = np.atleast_2d(np.asarray(velocities, np.float32))[:, :2]
            if len(vels) != len(obs):
                raise ValueError(
                    f"obstacle velocities ({len(vels)} rows) must align "
                    f"with the obstacle points ({len(obs)} rows)"
                )
        finite = np.isfinite(obs).all(axis=1)
        if vels is not None:
            # a NaN velocity poisons the moving sweep exactly like a NaN
            # position poisons the static one (obs + NaN*t is NaN at
            # every t, NaN < r^2 is false, nothing ever collides) — and
            # trackers do emit NaN velocities at track birth
            finite &= np.isfinite(vels).all(axis=1)
        if not finite.all():
            obs = obs[finite]
            if vels is not None:
                vels = vels[finite]
        return obs, vels

    def _rotate_in_place_result(self, heading_error: float) -> SamplingControlResult:
        """Pure-rotation shortcut for large heading error
        (``dwa.h:195-205`` + ``trajectory_sampler.cpp:409-445`` with vx=0).

        Runs BEFORE the adaptive-horizon update, so the trajectory is
        sized with the PREVIOUS tick's active_points — same ordering as
        the reference's findBestPath (rotate check precedes
        adaptPredictionHorizonToCurvature, ``dwa.h:195-206``).

        Deliberate divergence: the reference uses ``-heading_error * w_max /
        pi`` (``dwa.h:202``), which rotates AWAY from the target heading and
        limit-cycles at +-pi (unexercised upstream — their DWA test robot is
        Ackermann, which never rotates in place). The sign here is
        corrected: positive heading error (target left of robot) rotates
        counter-clockwise."""
        omega = (
            heading_error
            * self.ctrl_limits.omega_limits.max_vel
            / math.pi
        )
        n = self._active_points
        traj = TrajectoryResult(
            vx=np.zeros(n - 1, dtype=np.float32),
            vy=np.zeros(n - 1, dtype=np.float32),
            omega=np.full(n - 1, omega, dtype=np.float32),
            path_x=np.full(n, self.current_state.x, dtype=np.float32),
            path_y=np.full(n, self.current_state.y, dtype=np.float32),
        )
        return SamplingControlResult(is_found=True, cost=0.0, trajectory=traj)

    # ------------------------------------------------------------------
    # main entry: one control tick
    # ------------------------------------------------------------------

    def _obstacle_blocks(
        self, laser_scan, point_cloud, map_points_world,
        obstacle_velocities_world,
    ):
        """Shared obstacle assembly for the production solve AND the
        debug path (one implementation so debug rankings can't drift
        from the executed command): returns
        (obs_padded [bucket, 2], obs_count, vel_padded_or_None, bucket).
        Pads sit at 1e8 position with ZERO velocity — a pad point must
        not march through the workspace."""
        if (
            obstacle_velocities_world is not None
            and not self._config.moving_obstacles
        ):
            raise ValueError(
                "obstacle_velocities_world requires "
                "DWAConfig(moving_obstacles=True) — the static-world "
                "solver program has no velocity inputs"
            )
        obs, obs_vels = self._gather_obstacles(
            laser_scan, point_cloud, map_points_world,
            velocities=obstacle_velocities_world,
        )
        obs_count = len(obs)
        bucket = max(256, _round_up(obs_count, 256))
        obs_padded = np.full((bucket, 2), 1e8, dtype=np.float32)
        obs_padded[:obs_count] = obs
        vel_padded = None
        if self._config.moving_obstacles:
            vel_padded = np.zeros((bucket, 2), dtype=np.float32)
            if obs_vels is not None:
                vel_padded[:obs_count] = obs_vels
        return obs_padded, obs_count, vel_padded, bucket

    @staticmethod
    def tracked_obstacle_disc(center_xy, radius, velocity_xy, ring: int = 8):
        """(points [ring+1, 2], velocities [ring+1, 2]) world-frame
        obstacle disc for one tracked moving object: its center plus
        ``ring`` circumference points, every point carrying the object's
        velocity — the same disc decomposition the fleet peer-avoidance
        path uses (``ops/fleet_solver.py`` peer discs).

        Glue between the vision tracker and the moving-obstacle solver:
        ``FeatureBasedBboxTracker.get_raw_tracking()`` yields center +
        size + Kalman-filtered velocity; stack one disc per tracked
        object and pass to ``compute_velocity_commands(
        map_points_world=pts, obstacle_velocities_world=vels)`` with
        ``DWAConfig(moving_obstacles=True)``."""
        cx, cy = float(center_xy[0]), float(center_xy[1])
        ang = np.linspace(0.0, 2.0 * np.pi, int(ring), endpoint=False)
        pts = np.concatenate(
            [
                np.array([[cx, cy]], np.float32),
                np.stack(
                    [cx + radius * np.cos(ang), cy + radius * np.sin(ang)],
                    axis=1,
                ).astype(np.float32),
            ]
        )
        vels = np.broadcast_to(
            np.asarray(velocity_xy, np.float32)[:2], pts.shape
        ).copy()
        return pts, vels

    def compute_velocity_commands(
        self, current_vel, laser_scan=None, point_cloud=None,
        map_points_world=None, obstacle_velocities_world=None,
    ) -> SamplingControlResult:
        """Full DWA tick (``DWA::findBestPath``, ``dwa.h:183-230``).

        ``map_points_world``: [N, >=2] obstacle points already in the world
        frame (the reference's local-map input path — its cloud overload
        with global_frame=true, ``collision_check.h:119-125``).

        ``obstacle_velocities_world``: [N, 2] world-frame velocity per
        obstacle point (row-aligned with whichever obstacle input was
        given — typically tracked-object discs from the vision tracker's
        Kalman velocity state). Requires
        ``DWAConfig(moving_obstacles=True)``; the solver then evaluates
        collision + obstacle cost against each obstacle's predicted
        position ``obs + v * t * dt`` along the rollout. Omitted points
        default to static (zero velocity)."""
        if self._path is None:
            raise ValueError(
                "Global path not set; cannot run the DWA local planner"
            )

        target = self.determine_target()

        if (
            self.rotate_in_place
            and abs(target.heading_error)
            > self._config.goal_orientation_tolerance * 10.0
        ):
            self._result = self._rotate_in_place_result(target.heading_error)
            return self._result

        self._adapt_prediction_horizon()

        obs_padded, obs_count, vel_padded, bucket = self._obstacle_blocks(
            laser_scan, point_cloud, map_points_world,
            obstacle_velocities_world,
        )
        spec, solver, buf = self._solver_for(bucket)
        self._assemble_solver_buffer(
            spec, buf, current_vel, obs_padded, obs_count, vel_padded
        )

        out = np.asarray(solver(buf))
        found, cost, _best, _n_adm, vx, vy, omega, px, py = unpack_solver_output(
            spec, out
        )

        n = self._active_points
        if found:
            traj = TrajectoryResult(
                vx=vx[: n - 1],
                vy=vy[: n - 1],
                omega=omega[: n - 1],
                path_x=px[:n],
                path_y=py[:n],
            )
            self._result = SamplingControlResult(
                is_found=True, cost=cost, trajectory=traj
            )
        else:
            self._result = SamplingControlResult(is_found=False)
        return self._result

    # ------------------------------------------------------------------
    # FollowerTemplate-style API (reference control/dwa.py:255-424)
    # ------------------------------------------------------------------

    def _assemble_solver_buffer(self, spec, buf, current_vel, obs_padded,
                                obs_count, vel_padded):
        """Shared tracked-segment + velocity-window + pack sequence for
        the production solve AND the debug sampler — one assembly so the
        two can never drift again (they did once, on the device-window
        block; round-5 review consolidated the remainder)."""
        start, end = self._tracked_segment_window()
        from ..native import segment_block

        seg_x, seg_y, seg_arc, seg_total_len = segment_block(
            self._path.xs, self._path.ys, self._path.arc_lengths,
            start, end, 1e8, spec.seg_size,
        )
        window = sample_velocity_window(
            current_vel, self._limits_array, self._dt,
            spec.n_vx, spec.n_vy, spec.n_omega, spec.is_omni,
        )
        pack_solver_input(
            spec, buf, self._params_vec(),
            (self.current_state.x, self.current_state.y,
             self.current_state.yaw),
            window, obs_padded, obs_count, seg_x, seg_y, seg_arc,
            end - start + 1, seg_total_len,
            self._path.total_path_length(), self._active_points,
            obs_vel_xy=vel_padded,
        )

    def set_path(self, global_path, **_) -> None:
        """Accepts a ROS-like Path message (poses[].pose.position),
        an [N, >=2] array, or a ReferencePath."""
        if isinstance(global_path, ReferencePath):
            path = global_path
        elif hasattr(global_path, "poses"):
            if len(global_path.poses) < 2:
                # reject the degenerate route AND drop the got-path flag:
                # leaving it set would let the next loop_step report
                # 'End is reached' for a mission that was never loaded
                # (history-dependent behavior, round-5 review)
                self.clear_current_path()
                self._got_path = False
                return
            pts = [
                (p.pose.position.x, p.pose.position.y, 0.0)
                for p in global_path.poses
            ]
            path = ReferencePath(pts)
        else:
            path = ReferencePath(np.asarray(global_path))
        self.set_current_path(path, interpolate=True)
        self._got_path = True

    @property
    def path(self) -> bool:
        return self.has_path()

    def interpolated_path(self) -> Optional[ReferencePath]:
        return self._path

    def reached_end(self) -> bool:
        return self.is_goal_reached()

    def loop_step(
        self,
        *,
        current_state: RobotState,
        laser_scan: Optional[LaserScanData] = None,
        point_cloud=None,
        local_map: Optional[np.ndarray] = None,
        local_map_resolution: Optional[float] = None,
        **_,
    ) -> bool:
        """One planner iteration (reference ``control/dwa.py:255-330``)."""
        if not self._got_path:
            logger.error("Path is not available to DWA controller")
            return False
        self.set_current_state(
            current_state.x, current_state.y, current_state.yaw, current_state.speed
        )
        if local_map_resolution:
            self.set_resolution(local_map_resolution)
        if self.reached_end():
            logger.info("End is reached")
            self._result = SamplingControlResult(is_found=False)
            return False
        current_vel = (current_state.vx, current_state.vy, current_state.omega)
        try:
            self._result = self.compute_velocity_commands(
                current_vel,
                laser_scan=laser_scan,
                point_cloud=point_cloud,
                map_points_world=local_map,
            )
        except Exception as e:  # noqa: BLE001 — parity with reference wrapper
            logger.error(f"Could not find velocity command: {e}")
            return False
        return True

    def has_result(self) -> bool:
        return self._result.is_found

    def debug_velocity_search(
        self, current_vel, laser_scan=None, point_cloud=None,
        drop_samples=None, map_points_world=None,
        obstacle_velocities_world=None,
    ):
        """Return every rollout + its cost/admissibility for visualization
        (role of ``DWA::debugVelocitySearch``/``getDebuggingSamples``,
        ``dwa.h:141-163``). Accepts the same obstacle inputs as
        ``compute_velocity_commands`` (incl. ``map_points_world``) so the
        debug view ranks against the same scene the executed command saw.

        Returns (paths_x [S, T], paths_y [S, T], costs [S], admissible [S]).
        """
        from ..ops.solver import get_debug_dwa_solver

        if self._path is None:
            raise ValueError("Global path not set")
        self.determine_target()
        self._adapt_prediction_horizon()
        # same obstacle/velocity assembly as the production solve
        # (_obstacle_blocks), so debug rankings match the executed
        # command in static AND moving mode
        obs_padded, obs_count, vel_padded, bucket = self._obstacle_blocks(
            laser_scan, point_cloud, map_points_world,
            obstacle_velocities_world,
        )
        spec, _solver, buf = self._solver_for(bucket)
        if drop_samples is not None and bool(drop_samples) != spec.drop_samples:
            # honor the override: debug the requested admissibility mode
            spec = dataclasses.replace(spec, drop_samples=bool(drop_samples))
            buf = np.zeros(packed_input_size(spec), dtype=np.float32)
        self._assemble_solver_buffer(
            spec, buf, current_vel, obs_padded, obs_count, vel_padded
        )
        # same custom costs as the production solver, so debug rankings
        # agree with the executed command
        px, py, costs, adm = get_debug_dwa_solver(
            spec, tuple(self._custom_costs)
        )(buf)
        self._debugging_samples = (
            np.asarray(px), np.asarray(py), np.asarray(costs), np.asarray(adm)
        )
        return self._debugging_samples

    def get_debugging_samples(self):
        """Latest debug sample set (raises if debug_velocity_search was not
        called — reference ``dwa.cpp:235-243`` semantics)."""
        if not hasattr(self, "_debugging_samples"):
            raise ValueError("No debugging samples are available")
        return self._debugging_samples

    def check_states_feasibility(self, states, laser_scan=None, point_cloud=None) -> bool:
        """True if any given state COLLIDES with the sensor data — the
        reference's (misleadingly named) boolean convention, kept for
        parity (``trajectory_sampler.cpp:378-407`` returns true at the
        first collision)."""
        from ..ops.solver import check_states_feasibility

        obs = self._obstacle_points_world(laser_scan, point_cloud)
        if len(obs) == 0:
            return False
        xy = np.asarray(
            [[s.x, s.y] if hasattr(s, "x") else s[:2] for s in states],
            np.float32,
        )
        return bool(
            check_states_feasibility(
                xy, obs, self.robot.radius,
                self._config.octree_resolution * COLLISION_MARGIN_FACTOR,
            )
        )

    def logging_info(self) -> str:
        if self._result.is_found:
            return f"DWA found trajectory with cost: {self._result.cost}"
        return "DWA failed to find a valid trajectory"

    def optimal_path(self) -> Optional[TrajectoryResult]:
        return self._result.trajectory if self._result.is_found else None

    @property
    def result_cost(self) -> Optional[float]:
        return self._result.cost if self._result.is_found else None

    @property
    def tracked_state(self) -> Optional[RobotState]:
        if self._target is None:
            return None
        return self._target.movement

    @property
    def control_till_horizon(self) -> Optional[TrajectoryResult]:
        return self._result.trajectory if self._result.is_found else None

    @property
    def linear_x_control(self) -> Union[List[float], np.ndarray]:
        if self._result.is_found:
            return self._result.trajectory.vx[: self._end_of_ctrl_horizon]
        return [0.0]

    @property
    def linear_y_control(self) -> Union[List[float], np.ndarray]:
        if self._result.is_found:
            return self._result.trajectory.vy[: self._end_of_ctrl_horizon]
        return [0.0]

    @property
    def angular_control(self) -> Union[List[float], np.ndarray]:
        if self._result.is_found:
            return self._result.trajectory.omega[: self._end_of_ctrl_horizon]
        return [0.0]

    @property
    def distance_error(self) -> float:
        return self._target.crosstrack_error if self._target else 0.0

    @property
    def orientation_error(self) -> float:
        return self._target.heading_error if self._target else 0.0
