"""Serial NumPy transcription of the reference CriticalZoneChecker.

Transcribed from ``critical_zone_check.cpp:13-119`` (ctor/preset/check):
the ctor wraps the half-cone with the reference's normalize-to-[-pi, pi)
angle helper, preset classifies beam directions through the sensor
transform into forward/backward cones, and check walks the in-cone
indices with the early-return-0.0 / running-min-slowdown loop.

``cloud_to_scan`` is the float64 cloud -> scan binning
(``pointcloud.h:116-176``) that feeds it from a point cloud.
"""

import math
from typing import List

import numpy as np

__all__ = ["CriticalZoneOracle", "cloud_to_scan"]


def cloud_to_scan(points, num_bins, range_max, min_z, max_z):
    """Per-bin min range of an [N, 3] cloud in float64: z filter (a
    negative ``max_z`` disables the ceiling, ``pointcloud.h:159``),
    origin filter, atan2 bins of width 2*pi/num_bins, clipped to
    ``range_max``. NaN points fall out at the filters. Returns
    ``(ranges [num_bins], u [N])`` where ``u`` is each point's bearing in
    bin widths."""
    p = np.asarray(points, np.float64)
    r2 = p[:, 0] ** 2 + p[:, 1] ** 2
    with np.errstate(invalid="ignore"):
        ok = (r2 >= 1e-6) & (p[:, 2] >= min_z)
        if max_z >= 0:
            ok &= p[:, 2] <= max_z
    u = np.mod(np.arctan2(p[:, 1], p[:, 0]), 2 * np.pi) / (
        2 * np.pi / num_bins)
    bins = np.minimum(u[ok].astype(int), num_bins - 1)
    out = np.full(num_bins, np.inf)
    np.minimum.at(out, bins, np.sqrt(r2[ok]))
    return np.minimum(out, range_max), u


def _normalize_to_minus_pi_pi(a: float) -> float:
    a = math.fmod(a + math.pi, 2.0 * math.pi)
    if a < 0:
        a += 2.0 * math.pi
    return a - math.pi


class CriticalZoneOracle:
    def __init__(
        self,
        robot_radius: float,
        sensor_x: float,
        sensor_y: float,
        sensor_yaw: float,
        critical_angle_deg: float,
        critical_distance: float,
        slowdown_distance: float,
        angles,
    ):
        if slowdown_distance <= critical_distance:
            raise ValueError(
                "SlowDown distance must be greater than the Critical distance!"
            )
        self.robot_radius = robot_radius
        self.sx, self.sy, self.syaw = sensor_x, sensor_y, sensor_yaw
        self.critical_distance = critical_distance
        self.slowdown_distance = slowdown_distance
        self.critical_angle = _normalize_to_minus_pi_pi(
            critical_angle_deg * math.pi / 180.0 / 2.0
        )
        self.cos_angles: List[float] = []
        self.sin_angles: List[float] = []
        self.indices_forward: List[int] = []
        self.indices_backward: List[int] = []
        self.preset(angles)

    def _tf(self, x: float, y: float):
        c, s = math.cos(self.syaw), math.sin(self.syaw)
        return c * x - s * y + self.sx, s * x + c * y + self.sy

    def preset(self, angles) -> None:
        self.cos_angles = [math.cos(a) for a in angles]
        self.sin_angles = [math.sin(a) for a in angles]
        self.indices_forward = []
        self.indices_backward = []
        for i in range(len(self.cos_angles)):
            bx, by = self._tf(self.cos_angles[i], self.sin_angles[i])
            abs_theta = abs(math.atan2(by, bx))
            if abs_theta <= self.critical_angle:
                self.indices_forward.append(i)
            if abs_theta >= math.pi - self.critical_angle:
                self.indices_backward.append(i)

    def check(self, ranges, forward: bool) -> float:
        indices = self.indices_forward if forward else self.indices_backward
        slowdown_factor = 1.0
        for index in indices:
            x = ranges[index] * self.cos_angles[index]
            y = ranges[index] * self.sin_angles[index]
            bx, by = self._tf(x, y)
            converted_range = math.sqrt(bx * bx + by * by)
            distance = converted_range - self.robot_radius
            if distance <= self.critical_distance:
                return 0.0
            if distance <= self.slowdown_distance:
                slowdown_factor = min(
                    slowdown_factor,
                    (distance - self.critical_distance)
                    / (self.slowdown_distance - self.critical_distance),
                )
        return slowdown_factor
