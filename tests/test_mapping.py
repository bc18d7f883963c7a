"""Local mapper tests.

Modeled on the reference's mapper test strategy
(``tests/test_local_mapper_pytest.py``: circle scans, occupancy-count
assertions, synthetic pointcloud rings, z-filtering) plus a direct
rasterization comparison against an independent super-cover line walker.
"""

import math

import numpy as np
import pytest

from kompass_core_tpu.datatypes import LaserScanData, PointCloudData
from kompass_core_tpu.datatypes.pose import PoseData
from kompass_core_tpu.datatypes.scan_model import ScanModelConfig
from kompass_core_tpu.mapping import LocalMapper, MapConfig
from kompass_core_tpu.ops.mapping import (
    EMPTY,
    OCCUPIED,
    UNEXPLORED,
    MapperSpec,
    get_pointcloud_to_scan,
    get_scan_to_grid,
    get_scan_to_grid_bayesian,
    get_warp_previous_grid,
)


def supercover_line(x0, y0, x1, y1):
    """Independent reference implementation: all integer cells crossed by
    the segment between cell centers (for comparing against the gather
    kernel's diamond test)."""
    cells = set()
    dx, dy = x1 - x0, y1 - y0
    n = 2 * max(abs(dx), abs(dy)) + 1
    for k in range(n + 1):
        t = k / n
        x = x0 + t * dx
        y = y0 + t * dy
        cells.add((round(x), round(y)))
    return cells


SPEC = MapperSpec(
    grid_height=61, grid_width=61, num_bins=72, resolution=0.1
)


def test_ring_scan_structure():
    """Uniform ring at 2 m: OCCUPIED ring, EMPTY interior, UNEXPLORED
    beyond."""
    ranges = np.full(SPEC.num_bins, 2.0, np.float32)
    grid = np.asarray(get_scan_to_grid(SPEC)(ranges))
    si, sj = SPEC.start_cell
    assert grid[si, sj] == EMPTY  # sensor cell is on every line
    # straight +x beam: endpoint at 2.0m -> cell si+20
    assert grid[si + 20, sj] == OCCUPIED
    assert np.all(grid[si + 1 : si + 19, sj] == EMPTY)
    # beyond the ring stays unexplored
    assert grid[si + 25, sj] == UNEXPLORED
    n_occ = np.sum(grid == OCCUPIED)
    # ring of radius 20 cells: ~60-130 boundary cells hit by 72 beams
    assert 40 <= n_occ <= 130


def test_single_short_beam_matches_supercover():
    """All cells the gather kernel marks EMPTY/OCCUPIED for one beam must
    lie on (or adjacent to) the independent super-cover walk."""
    # keep all other beams short (2 cells) so the long test beam's line is
    # isolated beyond radius 4
    ranges = np.full(SPEC.num_bins, 0.25, np.float32)
    beam = 5  # angle 5 * 2pi/72 = 25 deg
    ranges[beam] = 1.7
    grid = np.asarray(get_scan_to_grid(SPEC)(ranges))
    si, sj = SPEC.start_cell
    ang = beam * 2 * np.pi / SPEC.num_bins
    ex = si + int(1.7 * math.cos(ang) / SPEC.resolution)
    ey = sj + int(1.7 * math.sin(ang) / SPEC.resolution)
    assert grid[ex, ey] == OCCUPIED
    ref_cells = supercover_line(si, sj, ex, ey)
    far = lambda i, j: (i - si) ** 2 + (j - sj) ** 2 > 16  # noqa: E731
    marked = {
        (int(i), int(j))
        for i, j in zip(*np.nonzero(grid >= EMPTY))
        if far(i, j)
    }
    # every reference line cell must be marked
    missing = {c for c in ref_cells if far(*c)} - marked
    assert not missing, f"kernel missed line cells: {missing}"
    # no marked cell further than 1 cell from the reference line
    for i, j in marked:
        assert any(
            abs(i - ri) <= 1 and abs(j - rj) <= 1 for ri, rj in ref_cells
        ), f"spurious cell {(i, j)}"


def test_bayesian_probabilities():
    ranges = np.full(SPEC.num_bins, 2.0, np.float32)
    prior = 0.5
    prev = np.full((SPEC.grid_height, SPEC.grid_width), prior, np.float32)
    occ, prob = get_scan_to_grid_bayesian(SPEC)(
        ranges,
        prev,
        np.float32(prior),
        np.float32(0.4),
        np.float32(0.6),
        np.float32(1.0),
        np.float32(20.0),
        np.float32(0.2),
    )
    occ = np.asarray(occ)
    prob = np.asarray(prob)
    si, sj = SPEC.start_cell
    # along the +x beam: cells well before the hit get p < prior
    assert prob[si + 5, sj] < prior
    # at the obstacle cell: p > prior
    assert prob[si + 20, sj] > prior
    # far beyond any beam: exactly prior
    assert prob[si + 28, sj + 1] == pytest.approx(prior)
    # occupancy layer agrees with the non-bayesian kernel
    ref = np.asarray(get_scan_to_grid(SPEC)(ranges))
    np.testing.assert_array_equal(occ, ref)


def test_warp_identity_preserves_grid():
    rng = np.random.default_rng(1)
    g = rng.uniform(0.2, 0.8, (SPEC.grid_height, SPEC.grid_width)).astype(
        np.float32
    )
    out = np.asarray(
        get_warp_previous_grid(SPEC)(
            g, np.zeros(2, np.float32), np.float32(0.0), np.float32(0.5)
        )
    )
    # interior preserved under identity warp
    np.testing.assert_allclose(out[5:-5, 5:-5], g[5:-5, 5:-5], atol=1e-4)


def test_warp_translation_shifts_feature():
    g = np.full((SPEC.grid_height, SPEC.grid_width), 0.5, np.float32)
    g[40, 30] = 1.0  # bright feature
    # robot moved +0.5 m in x (5 cells): the feature must move to lower i
    out = np.asarray(
        get_warp_previous_grid(SPEC)(
            g,
            np.array([0.5, 0.0], np.float32),
            np.float32(0.0),
            np.float32(0.5),
        )
    )
    peak = np.unravel_index(np.argmax(out), out.shape)
    assert abs(peak[0] - 35) <= 1 and abs(peak[1] - 30) <= 1


def test_pointcloud_binning():
    """Hand-built points -> bin-min semantics (modeled on the reference's
    ``test_pointcloud_data.py`` unit tests)."""
    pts = np.array(
        [
            [1.0, 0.0, 0.0],  # angle 0, r=1
            [2.0, 0.01, 0.0],  # angle ~0, r=2 (same bin; min keeps 1)
            [0.0, 3.0, 0.2],  # angle 90deg, r=3
            [-1.5, 0.0, 0.0],  # angle 180deg
            [0.5, 0.5, 9.0],  # filtered by z
            [0.0, 0.0, 0.0],  # origin filtered
        ],
        np.float32,
    )
    fn = get_pointcloud_to_scan(8)  # 45-degree bins
    ranges = np.asarray(fn(pts, np.float32(10.0), np.float32(-1.0), np.float32(1.0)))
    assert ranges[0] == pytest.approx(1.0, abs=1e-5)
    assert ranges[2] == pytest.approx(3.0, abs=1e-5)
    assert ranges[4] == pytest.approx(1.5, abs=1e-5)
    # empty bins clip to range_max
    assert ranges[3] == pytest.approx(10.0)
    # z-filtered point must not shrink bin 1 (45 deg)
    assert ranges[1] == pytest.approx(10.0)


def test_local_mapper_end_to_end_laserscan():
    config = MapConfig(width=6.0, height=6.0, resolution=0.1)
    mapper = LocalMapper(config, ScanModelConfig(p_prior=0.5))
    angles = np.linspace(0, 2 * np.pi, 72, endpoint=False)
    scan = LaserScanData(ranges=np.full(72, 2.0), angles=angles)
    pose = PoseData()
    mapper.update_from_scan(pose, scan)
    occ = mapper.occupancy
    assert np.sum(occ == OCCUPIED) > 30
    assert np.sum(occ == EMPTY) > 500
    assert np.sum(occ == UNEXPLORED) > 500


def test_local_mapper_bayesian_accumulates():
    config = MapConfig(width=6.0, height=6.0, resolution=0.1, baysian_update=True)
    mapper = LocalMapper(config, ScanModelConfig(p_prior=0.5))
    angles = np.linspace(0, 2 * np.pi, 72, endpoint=False)
    scan = LaserScanData(ranges=np.full(72, 2.0), angles=angles)
    pose = PoseData()
    mapper.update_from_scan(pose, scan)
    first = mapper._prev_prob.copy()
    mapper.update_from_scan(pose, scan)  # same pose, same scan
    second = mapper._prev_prob
    si, sj = mapper._spec.start_cell
    # repeated occupied evidence strengthens the obstacle belief
    assert second[si + 20, sj] > first[si + 20, sj] > 0.5
    # repeated free evidence strengthens emptiness
    assert second[si + 5, sj] < first[si + 5, sj] < 0.5
    # thresholded layers exposed
    assert np.any(mapper.probabilistic_occupancy == OCCUPIED)
    assert np.any(mapper.probabilistic_occupancy == EMPTY)


def test_local_mapper_pointcloud_ring():
    """Synthetic ring cloud -> occupied ring (reference's synthetic-ring
    pointcloud test shape)."""
    config = MapConfig(width=6.0, height=6.0, resolution=0.1)
    mapper = LocalMapper(
        config, ScanModelConfig(p_prior=0.5, angle_step=2 * np.pi / 72)
    )
    theta = np.linspace(0, 2 * np.pi, 500, endpoint=False)
    pts = np.stack(
        [2.0 * np.cos(theta), 2.0 * np.sin(theta), np.zeros_like(theta)],
        axis=1,
    ).astype(np.float32)
    mapper.update_from_scan(PoseData(), PointCloudData(points=pts))
    occ = mapper.occupancy
    assert np.sum(occ == OCCUPIED) > 30
    si, sj = mapper._spec.start_cell
    # float truncation puts the 2.0 m hit at cell 19 or 20
    assert OCCUPIED in (occ[si + 19, sj], occ[si + 20, sj])
    assert occ[si + 10, sj] == EMPTY


def test_fill_grid_around_point():
    """Square patch stamp with boundary clipping
    (reference fillGridAroundPoint, local_mapper.cpp:80-105)."""
    from kompass_core_tpu.mapping import LocalMapper

    grid = np.full((10, 10), -1, np.int32)
    LocalMapper.fill_grid_around_point(grid, (5, 5), 1, 100)
    assert (grid[4:7, 4:7] == 100).all()
    assert (grid == 100).sum() == 9
    # clipped at the corner
    grid2 = np.full((10, 10), -1, np.int32)
    LocalMapper.fill_grid_around_point(grid2, (0, 0), 2, 100)
    assert (grid2[:3, :3] == 100).all()
    assert (grid2 == 100).sum() == 9
    # fully out of bounds: no write, no crash
    grid3 = np.full((10, 10), -1, np.int32)
    LocalMapper.fill_grid_around_point(grid3, (50, 50), 1, 100)
    assert (grid3 == -1).all()


def test_fleet_mapper_matches_per_robot():
    """Batched (vmapped) mapper == per-robot mapper, both layers."""
    from kompass_core_tpu.ops.mapping import (
        MapperSpec,
        get_scan_to_grid,
        get_scan_to_grid_bayesian,
        get_scan_to_grid_bayesian_fleet,
        get_scan_to_grid_fleet,
    )

    spec = MapperSpec(
        grid_height=40, grid_width=40, num_bins=360, resolution=0.1
    )
    rng = np.random.default_rng(5)
    N = 6
    ranges = rng.uniform(0.5, 3.5, (N, 360)).astype(np.float32)
    batched = np.asarray(get_scan_to_grid_fleet(spec)(ranges))
    single = get_scan_to_grid(spec)
    for i in range(N):
        np.testing.assert_array_equal(batched[i], np.asarray(single(ranges[i])))

    prev = np.full((N, 40, 40), 0.5, np.float32)
    occ_b, prob_b = get_scan_to_grid_bayesian_fleet(spec)(
        ranges, prev, np.float32(0.5), np.float32(0.3), np.float32(0.9),
        np.float32(1.0), np.float32(10.0), np.float32(0.075),
    )
    occ_b = np.asarray(occ_b); prob_b = np.asarray(prob_b)
    bay = get_scan_to_grid_bayesian(spec)
    for i in range(N):
        o, p = bay(ranges[i], prev[i], np.float32(0.5), np.float32(0.3),
                   np.float32(0.9), np.float32(1.0), np.float32(10.0),
                   np.float32(0.075))
        np.testing.assert_array_equal(occ_b[i], np.asarray(o))
        np.testing.assert_allclose(prob_b[i], np.asarray(p), rtol=1e-6)


def test_fine_resolution_short_range_endpoint_occupied():
    """A short-range hit on a fine-angular-resolution scan must stamp its
    endpoint cell OCCUPIED: the beam that ends in a near cell can sit
    tens of bins away from the CELL's angularly-nearest bin (outside any
    candidate window), and a longer beam crossing the same cell would
    otherwise mark it EMPTY — a safety-critical false-free."""
    from kompass_core_tpu.ops.mapping import MapperSpec, get_scan_to_grid

    spec = MapperSpec(
        grid_height=100, grid_width=100, num_bins=720, resolution=0.05,
    )
    ranges = np.full(720, 5.0, np.float32)
    beam = 40  # 20.0 deg, hit at 0.15 m -> endpoint cell ~(2, 1)
    ranges[beam] = 0.15
    occ = np.asarray(get_scan_to_grid(spec)(ranges))
    si, sj = spec.start_cell
    ang = beam * 2 * np.pi / 720
    ei = si + int(np.trunc(0.15 * np.cos(ang) / 0.05))
    ej = sj + int(np.trunc(0.15 * np.sin(ang) / 0.05))
    assert occ[ei, ej] == OCCUPIED


def test_bayesian_grid_shift_follows_robot_motion():
    """A static world obstacle must stay put in the NEW egocentric frame
    when the robot moves between Bayesian updates (the previous grid is
    warped by the relative motion, reference :224-247)."""
    config = MapConfig(
        width=6.0, height=6.0, resolution=0.1, baysian_update=True
    )
    mapper = LocalMapper(config, ScanModelConfig(p_prior=0.5))
    angles = np.linspace(0, 2 * np.pi, 72, endpoint=False)
    # world: obstacle wall 2 m ahead (+x); robot at origin
    scan1 = LaserScanData(ranges=np.full(72, 2.0), angles=angles)
    pose1 = PoseData()
    mapper.update_from_scan(pose1, scan1)
    si, sj = mapper._spec.start_cell
    assert mapper._prev_prob[si + 20, sj] > 0.5  # obstacle belief at 2.0 m

    # robot advances 0.5 m toward the wall; new scan sees it at 1.5 m
    pose2 = PoseData()
    pose2.set_position(x=0.5, y=0.0)
    scan2 = LaserScanData(ranges=np.full(72, 1.5), angles=angles)
    mapper.update_from_scan(pose2, scan2)
    warped = mapper.previous_grid_prob_transformed
    # the warped PREVIOUS belief must show the old obstacle at 1.5 m in
    # the new frame (cells si+14/15 after float truncation), not still
    # at 2.0 m (cell si+20)
    assert warped[si + 14 : si + 16, sj].max() > 0.5
    assert warped[si + 20, sj] <= 0.5
    # and the fused posterior reinforces the obstacle around 1.5 m
    assert (
        mapper._prev_prob[si + 14 : si + 16, sj].max()
        >= warped[si + 14 : si + 16, sj].max()
    )


def test_local_mapper_pointcloud_z_filter_above_ceiling():
    """Points above the scan model's height ceiling leave the grid
    unexplored at their cells (mirrors reference
    ``test_local_mapper_pytest.py:327-360``)."""
    config = MapConfig(width=6.0, height=6.0, resolution=0.1)
    mapper = LocalMapper(
        config,
        ScanModelConfig(
            p_prior=0.5,
            angle_step=2 * np.pi / 72,
            max_height=1.0,
            min_height=-1.0,
        ),
    )
    theta = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    pts = np.stack(
        [
            2.0 * np.cos(theta),
            2.0 * np.sin(theta),
            np.full_like(theta, 5.0),  # all above max_height
        ],
        axis=1,
    ).astype(np.float32)
    mapper.update_from_scan(PoseData(), PointCloudData(points=pts))
    assert np.sum(mapper.occupancy == OCCUPIED) == 0


def test_local_mapper_pointcloud_origin_only_points_filtered():
    """Near-origin points carry no direction information and must be
    dropped (mirrors reference ``test_local_mapper_pytest.py:362-395``)."""
    config = MapConfig(width=6.0, height=6.0, resolution=0.1)
    mapper = LocalMapper(
        config, ScanModelConfig(p_prior=0.5, angle_step=2 * np.pi / 72)
    )
    pts = np.zeros((300, 3), np.float32)
    mapper.update_from_scan(PoseData(), PointCloudData(points=pts))
    assert np.sum(mapper.occupancy == OCCUPIED) == 0


def test_local_mapper_pointcloud_empty_cloud():
    """An empty cloud must not crash and leaves no occupied cells."""
    config = MapConfig(width=6.0, height=6.0, resolution=0.1)
    mapper = LocalMapper(
        config, ScanModelConfig(p_prior=0.5, angle_step=2 * np.pi / 72)
    )
    mapper.update_from_scan(
        PoseData(), PointCloudData(points=np.zeros((0, 3), np.float32))
    )
    assert np.sum(mapper.occupancy == OCCUPIED) == 0


def test_scan_to_grid_nonfinite_ranges_do_not_poison_grid():
    """A single inf/NaN range in the raw kernels must not poison the
    one-hot lookup (0*inf=NaN) — invalid beams contribute nothing
    (review-fix regression, reproduced grid-wide NaN before)."""
    from kompass_core_tpu.ops.mapping import (
        MapperSpec,
        scan_to_grid,
        scan_to_grid_bayesian,
    )

    spec = MapperSpec(
        grid_height=40, grid_width=40, num_bins=64, resolution=0.1
    )
    clean = np.full(64, 1.5, np.float32)
    dirty = clean.copy()
    dirty[10] = np.inf
    dirty[20] = np.nan

    g_clean = np.asarray(scan_to_grid(spec, clean))
    g_dirty = np.asarray(scan_to_grid(spec, dirty))
    # away from the two dropped beams the grids agree
    agree = (g_clean == g_dirty).mean()
    assert agree > 0.9
    # and the dirty grid still has occupied + empty structure
    assert (g_dirty == OCCUPIED).sum() > 0 and (g_dirty == EMPTY).sum() > 0

    prev = np.full((40, 40), 0.5, np.float32)
    _occ, prob = scan_to_grid_bayesian(
        spec, dirty, prev, 0.5, 0.3, 0.9, 1.0, 5.0, 0.1
    )
    prob = np.asarray(prob)
    assert np.all(np.isfinite(prob)), "Bayesian probs must stay finite"


def test_partial_fov_blind_sector_stays_unexplored():
    """A 270-degree lidar's uncovered quadrant must stay UNEXPLORED —
    resampling previously invented max-range beams there and stamped the
    blind sector EMPTY (review-fix regression, reproduced)."""
    config = MapConfig(width=6.0, height=6.0, resolution=0.1)
    mapper = LocalMapper(config, ScanModelConfig(p_prior=0.5))
    n = 270
    angles = np.linspace(0, 1.5 * np.pi, n, endpoint=False)  # 270 deg
    scan = LaserScanData(
        ranges=np.full(n, 2.0), angles=angles,
        angle_min=0.0, angle_max=1.5 * np.pi,
    )
    mapper.update_from_scan(PoseData(), scan)
    occ = mapper.occupancy
    si, sj = mapper._spec.start_cell
    # covered direction (+x) is swept EMPTY with an occupied ring hit
    assert occ[si + 10, sj] == EMPTY
    # blind sector: bearing ~ -45 deg (i.e. +x, -y quadrant center)
    bi = si + int(10 * np.cos(-np.pi / 4))
    bj = sj + int(10 * np.sin(-np.pi / 4))
    assert occ[bi, bj] == UNEXPLORED, (
        "blind sector must not be stamped EMPTY"
    )


def _cloud(case):
    rng = np.random.default_rng(11)
    # bin centres, so float32 and float64 binning agree
    a = (np.arange(12) + 0.5) * (2 * np.pi / 36)
    r = rng.uniform(0.5, 9.0, 12)
    pts = np.stack([r * np.cos(a), r * np.sin(a), np.zeros(12)], axis=1)
    if case == "all_filtered":
        pts[:, 2] = 5.0  # every point above max_z: every bin empty
    elif case == "nan_points":
        pts[3] = np.nan
        pts[7, 2] = np.nan
    elif case == "origin_and_duplicates":
        pts[0] = 0.0  # origin point, filtered
        pts[5] = pts[4]  # duplicate minimum in one bin
    return pts.astype(np.float32)


@pytest.mark.parametrize(
    "case", ["empty_bins", "all_filtered", "nan_points",
             "origin_and_duplicates"])
def test_pointcloud_bin_min_matches_numpy(case):
    """segment_min binning equals a float64 NumPy bin-min at the edges:
    empty bins clip to range_max, a cloud with every point filtered is
    range_max everywhere, NaN points contribute nothing."""
    from oracle.safety_impl import cloud_to_scan

    from kompass_core_tpu.ops.mapping import pointcloud_to_scan

    pts = _cloud(case)
    got = np.asarray(pointcloud_to_scan(pts, 36, 10.0, -1.0, 1.0))
    ref, _ = cloud_to_scan(pts, 36, 10.0, -1.0, 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    if case == "all_filtered":
        assert (got == 10.0).all()


@pytest.mark.parametrize("case", ["invalid_beams", "all_invalid",
                                  "non_finite"])
def test_lookup_gather_equals_banded_at_edges(case):
    """The default gather lookup and the banded one-hot dot agree bit for
    bit on invalid, all-invalid and non-finite beams."""
    import os

    from kompass_core_tpu.ops.mapping import (
        MapperSpec, scan_to_grid, scan_to_grid_bayesian,
    )

    spec = MapperSpec(grid_height=64, grid_width=64, num_bins=720,
                      resolution=0.05)
    rng = np.random.default_rng(12)
    ranges = rng.uniform(0.1, 3.0, 720).astype(np.float32)
    if case == "invalid_beams":
        ranges[::7] = 0.0
    elif case == "all_invalid":
        ranges[:] = 0.0
    else:
        ranges[::5] = np.nan
        ranges[1::5] = np.inf
    prev = np.full((64, 64), 0.5, np.float32)
    out = {}
    old = {k: os.environ.get(k) for k in
           ("KOMPASS_TPU_LOOKUP", "KOMPASS_TPU_BAND_WIN")}
    try:
        os.environ["KOMPASS_TPU_BAND_WIN"] = "128"
        for form in ("gather", "banded"):
            os.environ["KOMPASS_TPU_LOOKUP"] = form
            occ, prob = scan_to_grid_bayesian(
                spec, ranges, prev, 0.6, 0.1, 0.9, 0.1, 20.0, 0.2)
            out[form] = (np.asarray(scan_to_grid(spec, ranges)),
                         np.asarray(occ), np.asarray(prob))
    finally:
        for k, v in old.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    for a, b in zip(out["gather"], out["banded"]):
        np.testing.assert_array_equal(a, b)
    if case == "all_invalid":
        assert (out["gather"][0] == -1).all()  # nothing observed


def test_lookup_form_rejects_unknown_names(monkeypatch):
    from kompass_core_tpu.ops.mapping import MapperSpec, scan_to_grid

    monkeypatch.setenv("KOMPASS_TPU_LOOKUP", "full")
    spec = MapperSpec(grid_height=16, grid_width=16, num_bins=64,
                      resolution=0.05)
    with pytest.raises(ValueError, match="KOMPASS_TPU_LOOKUP"):
        scan_to_grid(spec, np.ones(64, np.float32))


def test_banded_lookup_bit_equals_full():
    """The banded candidate lookup (static per-tile bin windows,
    ops/mapping._banded_plan) must reproduce the default gather lookup
    BIT-exactly: each one-hot row has exactly one nonzero, so the
    banded dot accumulates the same single product a full-width dot
    would, and every index column is bf16-exact. Covers the plain
    and Bayesian kernels, invalid beams, and the near-sensor
    full-width-rectangle paste."""
    import os

    from kompass_core_tpu.ops.mapping import (
        MapperSpec,
        _banded_plan,
        scan_to_grid,
        scan_to_grid_bayesian,
    )

    spec = MapperSpec(
        grid_height=64, grid_width=64, num_bins=720, resolution=0.05
    )
    plan = _banded_plan(spec, 0.0, 16, 128)
    assert plan is not None and plan["center"] is not None

    rng = np.random.default_rng(3)
    old = {
        k: os.environ.get(k)
        for k in ("KOMPASS_TPU_LOOKUP", "KOMPASS_TPU_BAND_TILE",
                  "KOMPASS_TPU_BAND_WIN")
    }
    try:
        os.environ["KOMPASS_TPU_BAND_TILE"] = "16"
        os.environ["KOMPASS_TPU_BAND_WIN"] = "128"
        for _ in range(3):
            ranges = rng.uniform(0.1, 3.0, 720).astype(np.float32)
            ranges[rng.integers(0, 720, 40)] = 0.0  # invalid beams
            prev = rng.uniform(0.2, 0.8, (64, 64)).astype(np.float32)
            os.environ["KOMPASS_TPU_LOOKUP"] = "gather"
            g_f = np.asarray(scan_to_grid(spec, ranges))
            occ_f, p_f = scan_to_grid_bayesian(
                spec, ranges, prev, 0.6, 0.1, 0.9, 0.1, 20.0, 0.2
            )
            os.environ["KOMPASS_TPU_LOOKUP"] = "banded"
            g_b = np.asarray(scan_to_grid(spec, ranges))
            occ_b, p_b = scan_to_grid_bayesian(
                spec, ranges, prev, 0.6, 0.1, 0.9, 0.1, 20.0, 0.2
            )
            np.testing.assert_array_equal(g_f, g_b)
            np.testing.assert_array_equal(np.asarray(occ_f), np.asarray(occ_b))
            np.testing.assert_array_equal(np.asarray(p_f), np.asarray(p_b))
    finally:
        for k, v in old.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def test_banded_plan_eligibility_gates():
    """Plans must refuse geometries they cannot tile or cannot win on."""
    from kompass_core_tpu.ops.mapping import MapperSpec, _banded_plan

    # grid not a multiple of the tile
    assert _banded_plan(
        MapperSpec(grid_height=60, grid_width=64, num_bins=720,
                   resolution=0.05), 0.0, 16, 128
    ) is None
    # window not meaningfully narrower than the bin count
    assert _banded_plan(
        MapperSpec(grid_height=64, grid_width=64, num_bins=180,
                   resolution=0.05), 0.0, 16, 128
    ) is None


def test_resample_nan_dropout_is_invalid_not_max_range():
    """A NaN dropout beam must contribute NOTHING (bin stays 0.0 =
    invalid) — converting it into a valid max-range beam would stamp
    EMPTY through terrain the sensor never observed. +inf no-echo beams
    DO clip to range_max (reference semantics). Round-5 review."""
    from kompass_core_tpu.ops.mapping import resample_scan_uniform

    num_bins = 8
    angles = np.arange(num_bins) * (2 * np.pi / num_bins)
    ranges = np.full(num_bins, 5.0)
    ranges[2] = np.nan  # dropout
    ranges[5] = np.inf  # no echo
    out = resample_scan_uniform(angles, ranges, num_bins, 10.0)
    assert out[2] == 0.0, "NaN dropout must stay invalid"
    assert out[5] == 10.0, "+inf no-echo clips to range_max"
    np.testing.assert_allclose(out[[0, 1, 3, 4, 6, 7]], 5.0)
