"""Datatype + config-system tests (LaserScanData zones, BaseAttrs files,
config clamps)."""

import json

import numpy as np
import pytest

from kompass_core_tpu.control import DWAConfig, StanleyConfig
from kompass_core_tpu.datatypes import LaserScanData, PointCloudData


def test_laserscan_default_ring():
    scan = LaserScanData()
    assert scan.angles.size == scan.ranges.size
    assert np.all(scan.ranges == scan.range_max)


def test_laserscan_zone_queries():
    """Angular zone extraction (reference datatypes/laserscan.py:103-157)."""
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    ranges = np.arange(8, dtype=float)
    scan = LaserScanData(ranges=ranges, angles=angles)
    # zone wrapping through 0: right=-pi/4 .. left=+pi/4
    vals = scan.get_ranges(right_angle=-np.pi / 4, left_angle=np.pi / 4)
    assert set(vals) == {0.0, 1.0, 7.0}
    # non-wrapping zone
    vals2 = scan.get_ranges(right_angle=np.pi / 4, left_angle=3 * np.pi / 4)
    assert set(vals2) == {1.0, 2.0, 3.0}
    assert len(scan.get_angles(-np.pi / 4, np.pi / 4)) == 3


def test_pointcloud_byte_decode():
    """Raw PointCloud2-style decode (reference utils/pointcloud.h:49-88)."""
    pts = np.array(
        [[1.0, 2.0, 3.0], [-1.5, 0.5, 0.25]], dtype=np.float32
    )
    raw = pts.tobytes()
    pc = PointCloudData.from_bytes(raw, point_step=12)
    np.testing.assert_allclose(pc.points, pts)
    # strided layout with extra channel
    pts4 = np.zeros((2, 4), np.float32)
    pts4[:, :3] = pts
    pc2 = PointCloudData.from_bytes(pts4.tobytes(), point_step=16)
    np.testing.assert_allclose(pc2.points, pts)


def test_config_file_round_trip(tmp_path):
    cfg = DWAConfig(max_linear_samples=7, prediction_horizon=15)
    f = str(tmp_path / "dwa.json")
    cfg.to_json_file(f)
    cfg2 = DWAConfig()
    cfg2.from_file(f)
    assert cfg2.max_linear_samples == 7
    assert cfg2.prediction_horizon == 15
    # nested cost weights survive
    assert (
        cfg2.costs_weights.goal_distance_weight
        == cfg.costs_weights.goal_distance_weight
    )


def test_config_nested_root(tmp_path):
    data = {"planner": {"dwa": {"max_angular_samples": 9}}}
    f = tmp_path / "nested.json"
    f.write_text(json.dumps(data))
    cfg = DWAConfig()
    cfg.from_file(str(f), nested_root_name="planner.dwa")
    assert cfg.max_angular_samples == 9


def test_dwa_config_clamps_control_horizon():
    """control_horizon > prediction_horizon clamps (reference
    control/dwa.py:137-143)."""
    cfg = DWAConfig(prediction_horizon=5, control_horizon=9)
    assert cfg.control_horizon == 5


def test_config_validators_reject_out_of_range():
    with pytest.raises(ValueError):
        StanleyConfig(heading_gain=-1.0)


def test_pointcloud_bytes_nonzero_offsets_and_dtype():
    """Strided field reads with non-trivial offsets and int16 fields
    (reference test_pointcloud_data.py:140-268 semantics)."""
    import struct

    n = 5
    point_step = 16
    raw = bytearray(n * point_step)
    for i in range(n):
        base = i * point_step
        # layout: [pad 2][x i16][y i16][z i16][pad...]
        struct.pack_into("<hhh", raw, base + 2, 10 * i, -3 * i, i)
    pc = PointCloudData.from_bytes(
        bytes(raw), point_step=point_step,
        x_offset=2, y_offset=4, z_offset=6, dtype_code=3,
    )
    np.testing.assert_array_equal(pc.points[:, 0], [0, 10, 20, 30, 40])
    np.testing.assert_array_equal(pc.points[:, 1], [0, -3, -6, -9, -12])
    np.testing.assert_array_equal(pc.points[:, 2], [0, 1, 2, 3, 4])


def test_pointcloud_bytes_multirow_row_step_padding():
    """height>1 organized cloud, ROS convention: row_step is the ROW
    STRIDE including padding. Points after the first row must stay
    aligned. Mirrors the reference walk (pointcloud.h:135-146), which
    also decodes a pad-overlapping partial point per row when
    k*point_step < row_step and the read fits in the buffer."""
    h, w = 3, 4
    point_step = 12
    pad = 8
    row_step = w * point_step + pad  # stride includes the padding
    rows = []
    for r in range(h):
        pts = np.arange(w * 3, dtype=np.float32).reshape(w, 3) + 100 * r
        rows.append(pts.tobytes() + b"\xff" * pad)
    raw = b"".join(rows)
    pc = PointCloudData.from_bytes(
        raw, point_step=point_step, row_step=row_step, height=h
    )
    # 5 column slots per row (col 48 < row_step); the last row's partial
    # slot fails the buffer-bounds guard -> 3*5 - 1 = 14 decoded points
    assert pc.points.shape == (14, 3)
    np.testing.assert_allclose(pc.points[0], [0.0, 1.0, 2.0])
    np.testing.assert_allclose(pc.points[5], [100.0, 101.0, 102.0])  # row 1
    np.testing.assert_allclose(pc.points[13], [209.0, 210.0, 211.0])


def test_utils_common_yaml_and_logging(tmp_path):
    """set_params_from_yaml patches attributes from a YAML section;
    setup_logging creates the logs/ file sink (reference utils/common.py)."""
    import logging

    from kompass_core_tpu.utils.common import (
        set_params_from_yaml,
        setup_logging,
    )

    cfg = tmp_path / "params.yaml"
    cfg.write_text("robot:\n  speed: 2.5\n  name: alpha\n")

    class Holder:
        speed = 1.0
        name = "default"
        missing = "kept"

    h = Holder()
    set_params_from_yaml(h, str(cfg), ["speed", "name", "missing"], "robot",
                         yaml_key_equal_attribute_name=True)
    assert h.speed == 2.5 and h.name == "alpha" and h.missing == "kept"

    h2 = Holder()
    set_params_from_yaml(h2, str(cfg), [("speed", "name")], "robot")
    assert h2.name == 2.5  # mapped key -> attribute

    h3 = Holder()
    set_params_from_yaml(h3, str(cfg), [], "nope")  # bad root: logged, no raise
    assert h3.speed == 1.0

    setup_logging(str(tmp_path), "run", logging.INFO)
    logging.getLogger().info("hello file sink")
    for hd in logging.getLogger().handlers[:]:
        if isinstance(hd, logging.FileHandler):
            hd.flush(); logging.getLogger().removeHandler(hd); hd.close()
    assert (tmp_path / "logs" / "run.log").exists()


def test_footprints(tmp_path):
    """Circular/rectangular footprints: radius, YAML load, plotting
    (reference models.py:439-656)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from kompass_core_tpu.models import (
        CircularFootprint,
        OmniDirectionalControl,
        RectangleFootprint,
    )

    c = CircularFootprint(rad=0.5)
    assert c.get_radius() == 0.5
    r = RectangleFootprint(width=0.4, length=1.0)
    assert r.get_radius() == pytest.approx(np.hypot(0.5, 0.2))

    cfg = tmp_path / "robot.yaml"
    cfg.write_text("robot:\n  robot_radius: 0.9\n  robot_width: 0.6\n"
                   "  robot_length: 1.4\n")
    c.set_from_yaml(str(cfg)); r.set_from_yaml(str(cfg))
    assert c.radius == 0.9 and (r.width, r.length) == (0.6, 1.4)

    fig, ax = plt.subplots()
    c.plt_robot(0.0, 0.0, 0.3, ax=ax)
    r.plt_robot(1.0, 1.0, -0.5, ax=ax)
    assert len(ax.patches) >= 4
    plt.close(fig)
    assert OmniDirectionalControl is not None


def test_setup_logging_reconfigure_replaces_file_handler(tmp_path):
    """Calling setup_logging twice must leave exactly ONE file sink on
    the root logger (the reference appends a second handler and logs
    every record twice — round-5 review, divergence annotated)."""
    import logging

    from kompass_core_tpu.utils.common import setup_logging

    root = logging.getLogger()
    before = list(root.handlers)
    try:
        setup_logging(str(tmp_path), "first", logging.INFO)
        setup_logging(str(tmp_path), "second", logging.INFO)
        file_handlers = [
            h for h in root.handlers if isinstance(h, logging.FileHandler)
        ]
        assert len(file_handlers) == 1
        assert file_handlers[0].baseFilename.endswith("second.log")
    finally:
        for h in list(root.handlers):
            if h not in before:
                root.removeHandler(h)
                h.close()
