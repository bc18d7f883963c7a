"""Egocentric local occupancy mapper (Python front-end).

API-equivalent of the reference's ``mapping/local_mapper.py:107-347``:
grid sizing and pose bookkeeping, laserscan/pointcloud dispatch into the
device kernels, Bayesian temporal fusion with previous-grid re-projection,
and thresholding of the probability layer into occupancy codes.

Device work is the gather-based kernels in ``ops/mapping.py``; the mapper
keeps the probability grid resident across ticks.
"""

import math
from typing import Optional, Union

import numpy as np
from attrs import define, field

from ..datatypes.laserscan import LaserScanData
from ..datatypes.pointcloud import PointCloudData
from ..datatypes.pose import (
    PoseData,
    get_relative_pose,
    transform_point_from_local_to_global,
)
from ..datatypes.scan_model import ScanModelConfig
from ..ops.mapping import (
    EMPTY,
    OCCUPIED,
    UNEXPLORED,
    MapperSpec,
    get_pointcloud_to_scan,
    pad_cloud_to_bucket,
    get_scan_to_grid,
    get_scan_to_grid_bayesian_warped,
    get_warp_previous_grid,
    resample_scan_uniform,
)
from ..utils.config import BaseAttrs, base_validators
from ..utils.runtime import enable_persistent_compilation_cache


@define
class GridData(BaseAttrs):
    """Occupancy + probabilistic occupancy layers
    (reference ``mapping/local_mapper.py:19-59``)."""

    width: int = field()
    height: int = field()
    p_prior: float = field(default=0.5)
    occupancy: np.ndarray = field(init=False)
    occupancy_prob: np.ndarray = field(init=False)

    def __attrs_post_init__(self):
        self.occupancy = self.get_initial_grid_data()
        self.occupancy_prob = self.get_initial_grid_data()

    def get_initial_grid_data(self) -> np.ndarray:
        # [height, width] — the orientation the device kernels emit
        # ([grid_height, grid_width], ops/mapping.py), so the array shape
        # is stable before and after the first scan for non-square maps
        return np.full((self.height, self.width), UNEXPLORED, dtype=np.int32)


@define(kw_only=True)
class MapConfig(BaseAttrs):
    """Local mapper configuration (reference
    ``mapping/local_mapper.py:62-104``)."""

    width: float = field(
        default=3.0, validator=base_validators.in_range(0.1, 1e2)
    )
    height: float = field(
        default=3.0, validator=base_validators.in_range(0.1, 1e2)
    )
    resolution: float = field(
        default=0.1, validator=base_validators.in_range(1e-9, 1e2)
    )
    padding: float = field(
        default=0.0, validator=base_validators.in_range(0.0, 10.0)
    )
    baysian_update: bool = field(default=False)
    max_num_threads: int = field(default=1)  # API parity; unused
    filter_limit: float = field(
        validator=base_validators.in_range(0.1, 1e2)
    )
    max_points_per_line: int = field(
        validator=base_validators.in_range(1, 1e3)
    )

    @filter_limit.default
    def _set_filter_limit(self) -> float:
        return (
            self.width * math.sqrt(2)
            if self.width >= self.height
            else self.height * math.sqrt(2)
        )

    @max_points_per_line.default
    def _set_max_points_per_line(self) -> int:
        return round((self.filter_limit / self.resolution) * 1.5)


class LocalMapper:
    """Produces an egocentric occupancy grid from laserscan/pointcloud."""

    def __init__(
        self,
        config: MapConfig,
        scan_model_config: ScanModelConfig,
        pose_laser_scanner_in_robot: Optional[PoseData] = None,
    ):
        enable_persistent_compilation_cache()
        self.config = config
        self.grid_width = int(config.width / config.resolution)
        self.grid_height = int(config.height / config.resolution)
        self.scan_model = scan_model_config

        self._local_lower_right_corner_point = PoseData()
        self._local_lower_right_corner_point.set_position(
            x=-config.width / 2, y=-config.height / 2, z=0
        )
        self._pose_robot_in_world = PoseData()
        self.lower_right_corner_pose = PoseData()

        self.pose_laserscanner_in_robot = (
            pose_laser_scanner_in_robot or PoseData()
        )
        self.laserscan_orientation_in_robot = 2 * np.arctan2(
            self.pose_laserscanner_in_robot.qz, self.pose_laserscanner_in_robot.qw
        )

        self.grid_data = GridData(
            width=self.grid_width,
            height=self.grid_height,
            p_prior=self.scan_model.p_prior,
        )
        self._spec: Optional[MapperSpec] = None
        self._prev_prob: Optional[np.ndarray] = None
        self.previous_grid_prob_transformed: Optional[np.ndarray] = None
        self.is_pointcloud = False
        self.processed = False

    # --- properties (reference :171-187) ---

    @property
    def occupancy(self) -> np.ndarray:
        return self.grid_data.occupancy

    @property
    def probabilistic_occupancy(self) -> np.ndarray:
        return self.grid_data.occupancy_prob

    # --- internals ---

    def _initialize(self, scan_size: int):
        pos = self.pose_laserscanner_in_robot
        self._spec = MapperSpec(
            grid_height=self.grid_height,
            grid_width=self.grid_width,
            num_bins=scan_size,
            resolution=self.config.resolution,
            laserscan_position_x=float(pos.x),
            laserscan_position_y=float(pos.y),
            laserscan_orientation=float(self.laserscan_orientation_in_robot),
        )
        self._prev_prob = np.full(
            (self.grid_height, self.grid_width),
            self.scan_model.p_prior,
            np.float32,
        )

    @staticmethod
    def fill_grid_around_point(
        grid_data: np.ndarray,
        grid_point,
        grid_padding: int,
        indicator: int,
    ) -> None:
        """Stamp a clipped square patch of ``indicator`` around a grid cell,
        in place (reference ``fillGridAroundPoint``,
        ``local_mapper.cpp:80-105``). A host-side numpy edit — patch
        stamping is pointer-sized work, not a device kernel."""
        h, w = grid_data.shape
        i, j = int(grid_point[0]), int(grid_point[1])
        i0, i1 = max(0, i - grid_padding), min(h - 1, i + grid_padding)
        j0, j1 = max(0, j - grid_padding), min(w - 1, j + grid_padding)
        if i0 <= i1 and j0 <= j1:
            grid_data[i0 : i1 + 1, j0 : j1 + 1] = indicator
        if 0 <= i < h and 0 <= j < w:
            grid_data[i, j] = indicator

    def get_previous_grid_in_current_pose(
        self,
        current_position_in_previous_pose,
        current_orientation_in_previous_pose: float,
        unknown_value: Optional[float] = None,
    ) -> np.ndarray:
        """Public re-projection entry (reference binding
        ``get_previous_grid_in_current_pose``)."""
        if self._spec is None:
            raise RuntimeError("Mapper not initialized (no scan processed)")
        warped = get_warp_previous_grid(self._spec)(
            self._prev_prob,
            np.asarray(current_position_in_previous_pose[:2], np.float32),
            np.float32(current_orientation_in_previous_pose),
            np.float32(
                unknown_value
                if unknown_value is not None
                else self.scan_model.p_prior
            ),
        )
        return np.asarray(warped)

    def _uniform_ranges(self, scan: LaserScanData):
        """Clip (reference :296-306) + resample to the uniform bin grid."""
        filtered = np.minimum(
            self.config.filter_limit, np.maximum(0.0, scan.ranges)
        )
        return resample_scan_uniform(
            scan.angles,
            filtered,
            self._spec.num_bins,
            self.config.filter_limit,
        )

    # --- main update (reference :249-341) ---

    def update_from_scan(
        self,
        robot_pose: PoseData,
        scan: Union[LaserScanData, PointCloudData],
    ):
        if self.processed and self.is_pointcloud != isinstance(
            scan, PointCloudData
        ):
            # the grid programs are modality-specific; switching sensor
            # type mid-run re-initializes (EmergencyChecker does the
            # same) instead of crashing on the wrong attribute set
            self.processed = False
        if not self.processed:
            self.is_pointcloud = isinstance(scan, PointCloudData)
            if self.is_pointcloud:
                self._initialize(
                    math.ceil(2 * np.pi / self.scan_model.angle_step)
                )
            else:
                self._initialize(scan.ranges.size)

        # capture the PREVIOUS pose before rebinding: the Bayesian grid
        # shift is the relative motion previous -> current
        previous_pose = self._pose_robot_in_world
        # COPY the pose: a caller mutating one PoseData in place each
        # tick would otherwise alias previous == current, zeroing the
        # Bayesian re-projection shift while the robot moves
        self._pose_robot_in_world = PoseData(
            x=robot_pose.x, y=robot_pose.y, z=robot_pose.z,
            qx=robot_pose.qx, qy=robot_pose.qy, qz=robot_pose.qz,
            qw=robot_pose.qw,
        )
        self.lower_right_corner_pose = transform_point_from_local_to_global(
            self._local_lower_right_corner_point, robot_pose
        )

        if self.is_pointcloud:
            ranges = np.asarray(
                get_pointcloud_to_scan(self._spec.num_bins)(
                    # bucket-pad: per-frame point counts vary and a raw
                    # shape would recompile the kernel per distinct N
                    pad_cloud_to_bucket(scan.points),
                    np.float32(self.scan_model.range_max),
                    np.float32(self.scan_model.min_height),
                    np.float32(self.scan_model.max_height),
                )
            )
        else:
            ranges = self._uniform_ranges(scan)

        if self.config.baysian_update:
            if self.processed:
                rel = get_relative_pose(
                    pose_1_in_ref=previous_pose, pose_2_in_ref=robot_pose
                )
                shift_xy = np.array([rel.x, rel.y], np.float32)
                shift_yaw = np.float32(rel.get_yaw())
            else:
                shift_xy = np.zeros(2, np.float32)
                shift_yaw = np.float32(0.0)
            # warp + Bayes fused in one dispatch: the re-projected grid
            # never bounces through the host (reference :224-247 + :161)
            occ, prob, warped = get_scan_to_grid_bayesian_warped(self._spec)(
                ranges,
                self._prev_prob,
                shift_xy,
                shift_yaw,
                np.float32(self.scan_model.p_prior),
                np.float32(self.scan_model.p_empty),
                np.float32(self.scan_model.p_occupied),
                np.float32(self.scan_model.range_sure),
                np.float32(self.scan_model.range_max),
                np.float32(self.scan_model.wall_size),
            )
            occ = np.asarray(occ)
            prob = np.asarray(prob)
            self.previous_grid_prob_transformed = np.asarray(warped)
            self._prev_prob = prob
            self.grid_data.occupancy = occ.copy()
            thresholded = np.full_like(occ, UNEXPLORED)
            thresholded[prob > self.scan_model.p_prior] = OCCUPIED
            thresholded[prob < self.scan_model.p_prior] = EMPTY
            self.grid_data.occupancy_prob = thresholded
        else:
            occ = np.asarray(get_scan_to_grid(self._spec)(ranges))
            self.grid_data.occupancy = occ.copy()

        self.processed = True
