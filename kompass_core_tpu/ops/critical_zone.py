"""Critical-zone emergency-stop check.

Port of the reference ``CriticalZoneChecker``
(``utils/critical_zone_check.cpp`` CPU and ``critical_zone_check_gpu.cpp``
SYCL): precompute the in-cone beam masks at setup, then per scan compute the
robot-surface distance of every in-cone return and reduce to a slowdown
factor in [0, 1] (0 = emergency stop).

The reference CPU loop early-returns 0.0 at the first critical hit; the
masked-min formulation here is numerically identical (min of the per-beam
factors, where any critical hit forces 0), matching the GPU backend's
``sycl::reduction(minimum)`` structure.
"""

import dataclasses
import math
from functools import lru_cache, partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.angles import normalize_to_minus_pi_pi
from .mapping import pointcloud_to_scan


@dataclasses.dataclass(frozen=True)
class CriticalZoneSpec:
    """Static data of a configured checker (host-precomputed masks)."""

    robot_radius: float
    critical_distance: float
    slowdown_distance: float
    # per-beam sensor-frame trig + body-frame cone membership
    cos_angles: tuple
    sin_angles: tuple
    forward_mask: tuple
    backward_mask: tuple
    # planar sensor->body transform
    sensor_x: float
    sensor_y: float
    sensor_yaw: float
    # wrapped half-cone angle (rad) — consumed by the fleet tick's
    # world-point cone test (ops/fleet_solver.FleetSafety); the per-beam
    # masks above already encode it for the scan path
    half_cone: float = 0.0


def build_critical_zone(
    robot_shape_type: str,
    robot_dimensions: Sequence[float],
    sensor_position_body: Sequence[float],
    sensor_rotation_body: Sequence[float],  # quaternion (x, y, z, w)
    critical_angle_deg: float,
    critical_distance: float,
    slowdown_distance: float,
    angles: Sequence[float],
) -> CriticalZoneSpec:
    """Host-side preset (reference ``critical_zone_check.cpp:13-85``)."""
    if slowdown_distance <= critical_distance:
        raise ValueError(
            "SlowDown distance must be greater than the Critical distance!"
        )
    from ..models.robot import RobotGeometry

    # one radius model shared with the planner's collision checks
    radius = float(
        RobotGeometry.get_radius(
            RobotGeometry.Type[robot_shape_type.upper()],
            np.asarray(robot_dimensions, np.float64),
        )
    )

    qx, qy, qz, qw = (float(v) for v in sensor_rotation_body)
    syaw = math.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    sx, sy = float(sensor_position_body[0]), float(sensor_position_body[1])

    # reference quirk kept verbatim (critical_zone_check.cpp:47-48 +
    # angles.h:21-29): the half-cone is wrapped to [-pi, pi), so a
    # 360-degree critical_angle maps to -pi and empties BOTH cones
    # (checker always returns 1.0) upstream too
    half_cone = normalize_to_minus_pi_pi(
        critical_angle_deg * math.pi / 180.0 / 2.0
    )

    ang = np.asarray(angles, np.float64)
    ca, sa = np.cos(ang), np.sin(ang)
    # unit beam direction through the sensor transform (reference preset
    # transforms the unit point, translation included)
    bx = math.cos(syaw) * ca - math.sin(syaw) * sa + sx
    by = math.sin(syaw) * ca + math.cos(syaw) * sa + sy
    abs_theta = np.abs(np.arctan2(by, bx))
    forward = abs_theta <= half_cone
    backward = abs_theta >= math.pi - half_cone

    return CriticalZoneSpec(
        robot_radius=radius,
        critical_distance=float(critical_distance),
        slowdown_distance=float(slowdown_distance),
        cos_angles=tuple(ca.tolist()),
        sin_angles=tuple(sa.tolist()),
        forward_mask=tuple(bool(v) for v in forward),
        backward_mask=tuple(bool(v) for v in backward),
        sensor_x=sx,
        sensor_y=sy,
        sensor_yaw=syaw,
        half_cone=float(half_cone),
    )


def critical_zone_check(spec: CriticalZoneSpec, ranges, forward):
    """Slowdown factor in [0, 1] (reference ``check``,
    ``critical_zone_check.cpp:87-119``). ``forward`` is a traced bool."""
    ranges = jnp.asarray(ranges, jnp.float32)
    ca = jnp.asarray(spec.cos_angles, jnp.float32)
    sa = jnp.asarray(spec.sin_angles, jnp.float32)
    fwd = jnp.asarray(spec.forward_mask)
    bwd = jnp.asarray(spec.backward_mask)
    mask = jnp.where(forward, fwd, bwd)

    x = ranges * ca
    y = ranges * sa
    c, s = math.cos(spec.sensor_yaw), math.sin(spec.sensor_yaw)
    bx2 = c * x - s * y + spec.sensor_x
    by2 = s * x + c * y + spec.sensor_y
    dist = jnp.sqrt(bx2 * bx2 + by2 * by2) - spec.robot_radius

    crit = spec.critical_distance
    slow = spec.slowdown_distance
    factor = jnp.clip((dist - crit) / (slow - crit), 0.0, 1.0)
    # non-finite returns (NaN dropouts, inf no-echo) are skipped exactly
    # like the reference loop, whose NaN comparisons are all false
    # (critical_zone_check.cpp:98-116); a masked min would propagate NaN
    factor = jnp.where(mask & jnp.isfinite(ranges), factor, 1.0)
    return jnp.min(factor)


@lru_cache(maxsize=32)
def get_critical_zone_checker(spec: CriticalZoneSpec):
    return jax.jit(partial(critical_zone_check, spec))


def _require_uniform_zero_start(spec: CriticalZoneSpec) -> None:
    """The cloud path bins points onto a uniform [0, 2pi) grid
    (``pointcloud_to_scan``); the spec's per-beam trig/cone masks index by
    that bin id, so the spec MUST have been preset with angles k*2pi/N
    starting at 0. A spec built from e.g. a [-pi, pi) scan grid would
    evaluate the forward cone against beams rotated by pi — an obstacle
    dead ahead checked against the backward mask."""
    n = len(spec.cos_angles)
    bin_width = 2.0 * np.pi / n
    got = np.mod(
        np.arctan2(np.asarray(spec.sin_angles), np.asarray(spec.cos_angles)),
        2.0 * np.pi,
    )
    expected = np.arange(n) * bin_width
    # each preset beam must sit within half a bin of the uniform grid the
    # cloud is binned onto (arange(0, 2pi, step) grids with a step that
    # does not divide 2pi exactly drift by < one bin — acceptable; a
    # [-pi, pi) grid is off by pi — rejected)
    err = np.abs(normalize_to_minus_pi_pi(got - expected))
    if np.max(err) > 0.51 * bin_width:
        raise ValueError(
            "critical_zone_check_cloud requires a spec preset with uniform"
            " angles arange(0, 2*pi, 2*pi/N) — rebuild the zone with that"
            " grid for pointcloud mode (utils/emergency_stop.py does)"
        )


def critical_zone_check_cloud(
    spec: CriticalZoneSpec, points, forward, range_max, min_z, max_z
):
    """Point-cloud variant: bin the cloud into the preset angular grid, then
    run the scan check (reference ``critical_zone_check.cpp:121-131``)."""
    num_bins = len(spec.cos_angles)
    ranges = pointcloud_to_scan(points, num_bins, range_max, min_z, max_z)
    return critical_zone_check(spec, ranges, forward)


@lru_cache(maxsize=32)
def get_critical_zone_checker_cloud(spec: CriticalZoneSpec):
    _require_uniform_zero_start(spec)
    return jax.jit(partial(critical_zone_check_cloud, spec))
