"""Occupancy-grid mapping kernels: laserscan/pointcloud -> egocentric grid.

Redesign of the reference's ray-cast mappers
(``mapping/local_mapper.cpp:127-241`` CPU Bresenham, and the SYCL DDA kernel
``mapping/local_mapper_gpu.cpp:207-327``). Scatter-style line stamping is
hostile to XLA; instead every kernel here is **pure per-cell**:

  for each cell: compute its polar coordinates about the sensor cell, look
  up the 5 angularly-nearest beams, and test membership in each beam's
  rasterized line segment (diamond / super-cover criterion) and endpoint
  cell. OCCUPIED > EMPTY > UNEXPLORED combine via max, exactly like the
  reference's ``fetch_max`` stamping.

The per-cell beam lookup is a gather of the per-beam tables
(`_candidate_lookup`), exact in every column.

This matches the reference CPU output up to the same order of divergence
the reference's own GPU backend exhibits vs its CPU backend (both
approximate the super-cover walk; see the DDA + neighbor-stamp + distance
field gating in the SYCL kernel).

The Bayesian layer implements the identical inverse sensor model
(``local_mapper.cpp:106-125``) and the previous-grid egocentric
re-projection (``local_mapper.cpp:17-78``) as a bilinear gather warp.

All kernels assume a uniform angular grid of beams: bin b covers angle
``angle_offset + b * angle_step`` (the ``scanToGrid`` consistency contract,
``local_mapper.h:40-55``). Arbitrary scans are bin-min resampled on host
(`resample_scan_uniform`), mirroring the pointcloud->laserscan path
(``utils/pointcloud.h:116-176``).
"""

import dataclasses
import os
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

UNEXPLORED = -1
EMPTY = 0
OCCUPIED = 100


@dataclasses.dataclass(frozen=True, eq=True)
class MapperSpec:
    """Static geometry of the compiled mapping program."""

    grid_height: int
    grid_width: int
    num_bins: int  # uniform angular bins in the scan
    resolution: float
    # sensor mounting (static per mapper, baked into the program)
    laserscan_position_x: float = 0.0
    laserscan_position_y: float = 0.0
    laserscan_orientation: float = 0.0

    @property
    def central_point(self):
        # round(H/2) - 1 per local_mapper.h:26-27
        return (
            int(round(self.grid_height / 2)) - 1,
            int(round(self.grid_width / 2)) - 1,
        )

    @property
    def start_cell(self):
        # localToGrid(laserscan position): central + trunc(pos/res)
        ci, cj = self.central_point
        return (
            ci + int(self.laserscan_position_x / self.resolution),
            cj + int(self.laserscan_position_y / self.resolution),
        )


def _cell_geometry(spec: MapperSpec):
    """Per-cell polar coordinates about the sensor start cell."""
    si, sj = spec.start_cell
    ii = jnp.arange(spec.grid_height, dtype=jnp.float32)[:, None]
    jj = jnp.arange(spec.grid_width, dtype=jnp.float32)[None, :]
    di = ii - si
    dj = jj - sj
    d = jnp.sqrt(di * di + dj * dj)
    theta = jnp.arctan2(dj, di)  # angle of the cell in the grid frame
    return di, dj, d, theta


def _beam_endpoint_cells(spec: MapperSpec, ranges, angle_offset):
    """Endpoint grid cell per beam — CPU localToGrid semantics
    (``local_mapper.cpp:127-134`` + ``local_mapper.h:210-222``:
    truncation toward zero)."""
    b = jnp.arange(spec.num_bins, dtype=jnp.float32)
    ang = spec.laserscan_orientation + angle_offset + b * (
        2.0 * jnp.pi / spec.num_bins
    )
    ex = spec.laserscan_position_x + ranges * jnp.cos(ang)
    ey = spec.laserscan_position_y + ranges * jnp.sin(ang)
    ci, cj = spec.central_point
    e_i = ci + jnp.trunc(ex / spec.resolution).astype(jnp.int32)
    e_j = cj + jnp.trunc(ey / spec.resolution).astype(jnp.int32)
    return e_i, e_j


def _sanitize_beams(ranges):
    """Beam validity convention for the ops-level kernels: a beam is real
    when its range is finite and > 0. Invalid beams (NaN dropouts, inf
    passed unclipped, resample-filled blind-sector bins) contribute NOTHING
    — without this, one inf range poisons the banded one-hot lookup
    (0 * inf = NaN) grid-wide, and an invented max-range beam would stamp
    EMPTY through terrain the sensor never observed. The front-end clips
    real no-echo returns to the filter limit BEFORE this (reference
    semantics, ``local_mapper.py:296-306``); this guard covers raw users
    of the public kernels."""
    ranges = jnp.asarray(ranges, jnp.float32)
    valid = jnp.isfinite(ranges) & (ranges > 0.0)
    return jnp.where(valid, ranges, 0.0), valid


@lru_cache(maxsize=64)
def _banded_plan(spec: MapperSpec, angle_offset: float, tile: int, win: int):
    """Static banded-lookup plan: because each cell's nearest bin (`base`)
    depends only on grid geometry (+ a static ``angle_offset``), every
    ``tile`` x ``tile`` cell block needs only a narrow, *statically known*
    circular window of bins — ~``B * tile_diag / (2 pi r)`` wide at
    distance r from the sensor. Restricting the one-hot contraction to
    that window cuts both the dot's FLOPs and the one-hot-generation
    work ~6x at the 400x400x3600 shape.

    Returns None when the geometry doesn't qualify (grid not tileable,
    bins too few for a banded win, or window margins can't fit), else a
    dict of host numpy arrays:
      lo [G] int32      — window start bin per tile (row-major tile order)
      center (i0, i1, j0, j1) — CELL-coordinate rectangle of near-sensor
                          tiles whose window exceeds ``win``; these rows
                          are computed with the full-width dot and pasted
                          over the banded output (their banded rows are
                          garbage by construction).

    Exactness: a one-hot row has exactly ONE nonzero, so the banded dot
    accumulates the same single product as the full dot — bit-identical
    wherever the traced base bin lies inside the window. The window is
    built from a host float32 mirror of `_base_bin` with a +-2-bin margin,
    absorbing any f32 rounding disagreement between numpy and XLA at
    half-bin boundaries.
    """
    H, W, B = spec.grid_height, spec.grid_width, spec.num_bins
    if H % tile or W % tile or B <= 2 * win or win >= B:
        return None
    # host float32 mirror of _cell_geometry + _base_bin
    si, sj = spec.start_cell
    ii = (np.arange(H, dtype=np.float32) - np.float32(si))[:, None]
    jj = (np.arange(W, dtype=np.float32) - np.float32(sj))[None, :]
    theta = np.arctan2(jj, ii).astype(np.float32)
    step = np.float32(2.0 * np.pi / B)
    rel = (theta - np.float32(spec.laserscan_orientation)
           - np.float32(angle_offset))
    base = np.round(rel / step).astype(np.int64) % B  # [H, W]

    th, tw = H // tile, W // tile
    tiled = base.reshape(th, tile, tw, tile).transpose(0, 2, 1, 3)
    tiled = tiled.reshape(th * tw, tile * tile)
    margin = 2  # host/traced f32 rounding disagreement bound
    lo = np.zeros(th * tw, np.int64)
    wide = np.zeros(th * tw, bool)
    for g in range(th * tw):
        u = np.unique(tiled[g])
        if len(u) == 1:
            # window starts are multiples of 16 (see below); same
            # slack guard as the general branch
            if 1 + 2 * margin + 15 > win:
                wide[g] = True
            else:
                lo[g] = ((u[0] - margin) % B) // 16 * 16
            continue
        gaps = np.diff(u)
        wrap_gap = u[0] + B - u[-1]
        k = int(np.argmax(gaps))
        if wrap_gap >= gaps[k]:
            start, span = u[0], u[-1] - u[0] + 1
        else:
            start = u[k + 1]
            span = B - (u[k + 1] - u[k]) + 1
        # window starts are quantized DOWN to multiples of 16, costing
        # up to 15 extra bins of slack
        if span + 2 * margin + 15 > win:
            wide[g] = True
        else:
            lo[g] = (((start - margin) % B) // 16) * 16
    if not wide.any():
        center = None
    else:
        gi, gj = np.nonzero(wide.reshape(th, tw))
        # bounding RECTANGLE of wide tiles (conservative), in cell coords
        center = (
            int(gi.min()) * tile, (int(gi.max()) + 1) * tile,
            int(gj.min()) * tile, (int(gj.max()) + 1) * tile,
        )
        n_wide_cells = (center[1] - center[0]) * (center[3] - center[2])
        if n_wide_cells > (H * W) // 4:
            return None  # banded win too small to bother
    return {"lo": lo.astype(np.int32), "center": center, "tile": tile,
            "win": win, "th": th, "tw": tw}


def _banded_lookup_dot(plan, base, tabs, n_cols):
    """The banded one-hot x windowed-tables dot (see `_banded_plan`).
    ``base`` [H, W] traced int32, ``tabs`` [B, n_cols] bf16.
    Returns [H, W, n_cols] f32, with garbage rows in the plan's center
    rectangle (caller pastes the full-width dot result there)."""
    tile, win = plan["tile"], plan["win"]
    th, tw = plan["th"], plan["tw"]
    B = tabs.shape[0]
    H, W = th * tile, tw * tile
    lo = jnp.asarray(plan["lo"])  # [G]
    bt = base.reshape(th, tile, tw, tile).transpose(0, 2, 1, 3)
    bt = bt.reshape(th * tw, tile * tile)  # [G, R]
    # out-of-window local indices (only possible in wide/center tiles, or
    # at a >2-bin host/traced disagreement, which margin rules out) land
    # outside [0, win) and one_hot maps them to an all-zero row
    local = (bt - lo[:, None]) % B
    oh = jax.nn.one_hot(local, win, dtype=jnp.bfloat16)  # [G, R, win]
    tabs_ext = jnp.concatenate([tabs, tabs[:win]], axis=0)
    rhs = jnp.stack([
        jax.lax.slice(tabs_ext, (int(l), 0), (int(l) + win, n_cols))
        for l in plan["lo"]
    ])  # [G, win, n_cols] — static slices: pure copies, no gather
    g = jax.lax.dot_general(
        oh, rhs, (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )  # [G, R, n_cols]
    g = g.reshape(th, tw, tile, tile, n_cols).transpose(0, 2, 1, 3, 4)
    return g.reshape(H, W, n_cols)


def _candidate_lookup(spec: MapperSpec, base, ranges, angle_offset, n_side=2,
                      valid=None):
    """Per-cell lookup of the candidate beams' endpoint cells, ranges and
    validity: ``base`` [H,W] is each cell's angularly-nearest bin, and
    candidate k's bin is ``(base + k - n_side) mod num_bins``. A gather,
    exact in every column.

    ``KOMPASS_TPU_LOOKUP=banded`` selects the banded one-hot dot instead
    (`_banded_lookup`), for a static ``angle_offset``.

    Returns (e_i_c, e_j_c, r_c, v_c), each [H,W,C].
    """
    C = 2 * n_side + 1
    B = spec.num_bins
    e_i, e_j = _beam_endpoint_cells(spec, ranges, angle_offset)
    # 15-bit biased cell indices: the range the banded form's bf16 byte
    # split can carry exactly, kept here so both forms agree
    bias = 1 << 14
    e_i = jnp.clip(e_i + bias, 0, (1 << 15) - 1)
    e_j = jnp.clip(e_j + bias, 0, (1 << 15) - 1)
    rf = jnp.asarray(ranges, jnp.float32)
    vb = jnp.ones(rf.shape, bool) if valid is None else jnp.asarray(valid)

    form = os.environ.get("KOMPASS_TPU_LOOKUP", "gather")
    if form not in ("gather", "banded"):
        raise ValueError(
            f"KOMPASS_TPU_LOOKUP={form!r}: expected 'gather' or 'banded'"
        )
    if form == "banded" and not isinstance(angle_offset, jax.core.Tracer):
        plan = _banded_plan(
            spec,
            float(angle_offset),
            tile=int(os.environ.get("KOMPASS_TPU_BAND_TILE", 16)),
            win=int(os.environ.get("KOMPASS_TPU_BAND_WIN", 512)),
        )
        if plan is not None:
            return _banded_lookup(plan, base, e_i, e_j, rf, vb, n_side, bias)

    bins = (base[:, :, None] + (jnp.arange(C) - n_side)[None, None, :]) % B
    return e_i[bins] - bias, e_j[bins] - bias, rf[bins], vb[bins]


def _banded_lookup(plan, base, e_i, e_j, rf, vb, n_side, bias):
    """The lookup as a one-hot x shifted-tables single-pass bf16 dot
    restricted to each tile's static bin window (`_banded_plan`).

    Each per-bin table is rolled once per candidate offset and all 7C
    columns come from one dot. The 15-bit cell indices are split into
    bf16-exact hi/lo bytes, so the index columns are exact; ranges take a
    bf16 round/residual split, exact to 2^-17 relative (~1.5e-7 m at
    20 m)."""
    C = 2 * n_side + 1
    B = rf.shape[0]
    e_if = e_i.astype(jnp.float32)
    e_jf = e_j.astype(jnp.float32)
    ei_hi = jnp.floor(e_if / 256.0)
    ej_hi = jnp.floor(e_jf / 256.0)
    r_hi = rf.astype(jnp.bfloat16).astype(jnp.float32)
    cols = [ei_hi, e_if - 256.0 * ei_hi, ej_hi, e_jf - 256.0 * ej_hi,
            r_hi, rf - r_hi, vb.astype(jnp.float32)]
    tabs = jnp.stack(
        [jnp.roll(c, n_side - k) for c in cols for k in range(C)], axis=1
    ).astype(jnp.bfloat16)  # [B, 7C], every entry bf16-exact (see above)

    g = _banded_lookup_dot(plan, base, tabs, 7 * C)
    if plan["center"] is not None:
        # near-sensor cells subtend too many bins for the window —
        # full-width dot on that (small) rectangle, pasted over
        i0, i1, j0, j1 = plan["center"]
        oh = jax.nn.one_hot(base[i0:i1, j0:j1].reshape(-1), B,
                            dtype=jnp.bfloat16)
        gc = jax.lax.dot_general(
            oh, tabs, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32,
        ).reshape(i1 - i0, j1 - j0, 7 * C)
        mid = jnp.concatenate([g[i0:i1, :j0], gc, g[i0:i1, j1:]], axis=1)
        g = jnp.concatenate([g[:i0], mid, g[i1:]], axis=0)

    def _col(k):
        return g[..., k * C : (k + 1) * C]

    e_i_c = jnp.round(256.0 * _col(0) + _col(1)).astype(jnp.int32) - bias
    e_j_c = jnp.round(256.0 * _col(2) + _col(3)).astype(jnp.int32) - bias
    r_c = _col(4) + _col(5)
    v_c = _col(6) > 0.5
    return e_i_c, e_j_c, r_c, v_c


def _endpoint_occupancy(spec: MapperSpec, ranges, angle_offset, valid=None):
    """Exact OCCUPIED layer: scatter each beam's endpoint cell into the
    grid (reference ``scanToGrid`` stamps the endpoint per beam,
    ``local_mapper.cpp:127-159``).

    This is beam-side (B elements, ~30 us scatter) and therefore exact at
    ANY angular resolution — the per-cell candidate window can miss an
    endpoint whose beam is angularly far from the CELL CENTER's nearest
    bin (a near cell subtends many bins: at 0.5 deg/bin a hit 3 cells
    away can sit ~35 bins off-center, outside any practical window).
    A missed endpoint whose cell is crossed by a longer beam would be
    marked EMPTY — a safety-critical false-free this layer prevents."""
    e_i, e_j = _beam_endpoint_cells(spec, ranges, angle_offset)
    H, W = spec.grid_height, spec.grid_width
    in_grid = (e_i >= 0) & (e_i < H) & (e_j >= 0) & (e_j < W)
    if valid is not None:
        in_grid = in_grid & valid
    flat = jnp.where(in_grid, e_i * W + e_j, H * W)  # slot H*W = dump
    hist = jnp.zeros(H * W + 1, jnp.int32).at[flat].add(1)
    return (hist[: H * W] > 0).reshape(H, W)


def _line_membership(spec: MapperSpec, di, dj, e_i_c, e_j_c):
    """Diamond (super-cover) membership test of each cell against the line
    from the start cell to candidate beams' endpoint cells ([H,W,C] from
    `_candidate_lookup`).

    Returns (on_line [H,W,C], is_endpoint [H,W,C], t [H,W,C]) where t is the
    distance along the line in cells.
    """
    si, sj = spec.start_cell
    vx = (e_i_c - si).astype(jnp.float32)  # [H,W,C]
    vy = (e_j_c - sj).astype(jnp.float32)
    L = jnp.sqrt(vx * vx + vy * vy)
    L_safe = jnp.maximum(L, 1e-6)
    t = (di[:, :, None] * vx + dj[:, :, None] * vy) / L_safe
    perp = jnp.abs(di[:, :, None] * vy - dj[:, :, None] * vx) / L_safe
    halfwidth = (jnp.abs(vx) + jnp.abs(vy)) / (2.0 * L_safe) + 1e-4
    # the endpoint cell itself sits at t == L exactly; the 1e-4-cell
    # slack (like halfwidth's) keeps sqrt/division rounding, which differs
    # between backends, from dropping it off its own beam
    on_line = (t >= -0.5) & (t <= L + 1e-4) & (perp <= halfwidth) & (L > 0)
    ii = jnp.arange(spec.grid_height, dtype=jnp.int32)[:, None, None]
    jj = jnp.arange(spec.grid_width, dtype=jnp.int32)[None, :, None]
    is_endpoint = (ii == e_i_c) & (jj == e_j_c)
    return on_line, is_endpoint, t


def _base_bin(spec: MapperSpec, theta, angle_offset):
    """Each cell's angularly-nearest bin, mod num_bins."""
    step = 2.0 * jnp.pi / spec.num_bins
    rel = theta - spec.laserscan_orientation - angle_offset
    base = jnp.round(rel / step).astype(jnp.int32)
    return base % spec.num_bins


def scan_to_grid(spec: MapperSpec, ranges, angle_offset=0.0):
    """Non-Bayesian occupancy grid from a uniform scan.

    ``ranges``: [num_bins] f32. Returns int32 grid [H, W] of
    {UNEXPLORED, EMPTY, OCCUPIED} (reference ``scanToGrid``,
    ``local_mapper.cpp:204-220``).
    """
    ranges, beam_valid = _sanitize_beams(ranges)
    di, dj, d, theta = _cell_geometry(spec)
    base = _base_bin(spec, theta, angle_offset)
    e_i_c, e_j_c, _r_c, v_c = _candidate_lookup(
        spec, base, ranges, angle_offset, valid=beam_valid
    )
    on_line, _is_endpoint, _t = _line_membership(spec, di, dj, e_i_c, e_j_c)
    on_line = on_line & v_c

    occupied = _endpoint_occupancy(spec, ranges, angle_offset, beam_valid)
    empty = jnp.any(on_line, axis=-1)
    grid = jnp.where(
        occupied, OCCUPIED, jnp.where(empty, EMPTY, UNEXPLORED)
    ).astype(jnp.int32)
    return grid


def bayes_cell_update(spec: MapperSpec, dist_m, current_range, previous_prob,
                      p_prior, p_empty, p_occupied, range_sure, range_max,
                      wall_size):
    """Inverse sensor model + Bayes odds update, exact formula port of
    ``updateGridCellProbability`` (``local_mapper.cpp:106-125``)."""
    rng = current_range - wall_size
    p_f = jnp.where(dist_m < rng, p_empty, p_occupied)
    delta = jnp.where(dist_m < range_sure, 0.0, 1.0)
    p_sensor = p_f + delta * ((dist_m - range_sure) / range_max) * (
        p_prior - p_f
    )
    odds = (
        (previous_prob / (1.0 - previous_prob))
        * (p_sensor / (1.0 - p_sensor))
        * ((1.0 - p_prior) / p_prior)
    )
    return 1.0 - 1.0 / (1.0 + odds)


def scan_to_grid_bayesian(
    spec: MapperSpec,
    ranges,
    previous_prob_grid,
    p_prior,
    p_empty,
    p_occupied,
    range_sure,
    range_max,
    wall_size,
    angle_offset=0.0,
):
    """Bayesian occupancy update (reference ``scanToGridBaysian``,
    ``local_mapper.cpp:161-241``): returns (occupancy int32 [H,W],
    probability f32 [H,W]).

    Cells on a beam's line get the inverse-sensor-model Bayes update with
    the *previous* probability grid (already re-projected to the current
    pose); uncovered cells hold p_prior. Where the reference lets the last
    beam win on multi-covered cells, this kernel deterministically uses the
    angularly nearest covering beam.
    """
    ranges, beam_valid = _sanitize_beams(ranges)
    previous_prob_grid = jnp.asarray(previous_prob_grid, jnp.float32)
    di, dj, d, theta = _cell_geometry(spec)
    base = _base_bin(spec, theta, angle_offset)
    e_i_c, e_j_c, r_c, v_c = _candidate_lookup(
        spec, base, ranges, angle_offset, valid=beam_valid
    )
    on_line, _is_endpoint, _t = _line_membership(spec, di, dj, e_i_c, e_j_c)
    on_line = on_line & v_c

    occupied = _endpoint_occupancy(spec, ranges, angle_offset, beam_valid)
    empty = jnp.any(on_line, axis=-1)
    occ_grid = jnp.where(
        occupied, OCCUPIED, jnp.where(empty, EMPTY, UNEXPLORED)
    ).astype(jnp.int32)

    # nearest covering candidate: order candidates by |offset| — index
    # ordering [-n..n] means distance from center is |k - n|
    n_c = r_c.shape[-1]
    center = n_c // 2
    pref = -jnp.abs(jnp.arange(n_c) - center).astype(jnp.float32)  # prefer 0
    score = jnp.where(on_line, pref[None, None, :], -jnp.inf)
    best_c = jnp.argmax(score, axis=-1)  # [H,W]
    covered = jnp.any(on_line, axis=-1)
    # candidate ranges came with the same lookup; select over the tiny
    # C axis with a one-hot sum instead of take_along_axis + ranges gather
    sel = best_c[:, :, None] == jnp.arange(n_c)[None, None, :]
    beam_range = jnp.sum(jnp.where(sel, r_c, 0.0), axis=-1)

    dist_m = d * spec.resolution
    new_prob = bayes_cell_update(
        spec, dist_m, beam_range, previous_prob_grid,
        p_prior, p_empty, p_occupied, range_sure, range_max, wall_size,
    )
    prob_grid = jnp.where(covered, new_prob, p_prior)
    return occ_grid, prob_grid


def warp_previous_grid(spec: MapperSpec, prob_grid, shift_xy, shift_yaw,
                       p_prior):
    """Re-project the previous probability grid into the current egocentric
    pose with bilinear interpolation.

    Implements the *documented intent* of ``getPreviousGridInCurrentPose``
    (``local_mapper.cpp:17-78``: "Transform a grid to be centered in
    egocentric view of the current position given its previous position").
    The reference's own transformation matrix is internally inconsistent
    (an identity shift translates the grid by ~half its size) and that code
    path — Bayesian fusion, default-off — is untested upstream, so this is
    a deliberate corrected divergence: a new-grid cell at local offset p
    samples the previous grid at R(dyaw)·p + shift (the new pose expressed
    in the previous egocentric frame), bilinear, prior outside.
    """
    prob_grid = jnp.asarray(prob_grid, jnp.float32)
    H, W = spec.grid_height, spec.grid_width
    ci, cj = spec.central_point
    dx = shift_xy[0] / spec.resolution
    dy = shift_xy[1] / spec.resolution
    c = jnp.cos(shift_yaw)
    s = jnp.sin(shift_yaw)

    pi = jnp.arange(H, dtype=jnp.float32)[:, None] - ci  # new-frame i offset
    pj = jnp.arange(W, dtype=jnp.float32)[None, :] - cj
    src_i = ci + (c * pi - s * pj + dx)
    src_j = cj + (s * pi + c * pj + dy)

    valid = (
        (src_i >= 0) & (src_i < H - 1) & (src_j >= 0) & (src_j < W - 1)
    )
    i0 = jnp.clip(jnp.floor(src_i).astype(jnp.int32), 0, H - 2)
    j0 = jnp.clip(jnp.floor(src_j).astype(jnp.int32), 0, W - 2)
    wi = src_i - i0
    wj = src_j - j0
    g = prob_grid
    val = (1 - wi) * ((1 - wj) * g[i0, j0] + wj * g[i0, j0 + 1]) + wi * (
        (1 - wj) * g[i0 + 1, j0] + wj * g[i0 + 1, j0 + 1]
    )
    return jnp.where(valid, val, p_prior)


def scan_to_grid_bayesian_warped(
    spec: MapperSpec,
    ranges,
    previous_prob_grid,
    shift_xy,
    shift_yaw,
    p_prior,
    p_empty,
    p_occupied,
    range_sure,
    range_max,
    wall_size,
    angle_offset=0.0,
):
    """Warp-then-Bayes as ONE jitted program: re-project the previous
    probability grid by the robot's relative motion and fuse the new scan,
    without the intermediate grid bouncing through the host (two extra
    transfers per tick).

    Returns (occ [H,W] int32, prob [H,W] f32, warped [H,W] f32)."""
    warped = warp_previous_grid(spec, previous_prob_grid, shift_xy,
                                shift_yaw, p_prior)
    occ, prob = scan_to_grid_bayesian(
        spec, ranges, warped, p_prior, p_empty, p_occupied, range_sure,
        range_max, wall_size, angle_offset,
    )
    return occ, prob, warped


def pointcloud_to_scan(points, num_bins, range_max, min_z, max_z):
    """Bin a [N, 3] cloud into a uniform laserscan: per-bin min range.

    Port of ``pointCloudToLaserScanFromRaw`` (``utils/pointcloud.h:116-176``):
    z filter, origin filter, atan2 binning with bin width 2*pi/num_bins,
    bin-min combine. Pure JAX (segment_min over static bins).

    Reference quirk kept verbatim (``pointcloud.h:159``): a NEGATIVE
    ``max_z`` disables the upper-z filter entirely (``max_z >= 0 &&
    z > max_z``) — it is a sentinel, not a usable negative ceiling.
    """
    pts = jnp.asarray(points, jnp.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r2 = x * x + y * y
    ok = (r2 >= 1e-6) & (z >= min_z) & jnp.where(
        max_z >= 0.0, z <= max_z, True
    )
    ang = jnp.arctan2(y, x)
    ang = jnp.where(ang < 0, ang + 2 * jnp.pi, ang)
    step = 2.0 * jnp.pi / num_bins
    bins = jnp.minimum((ang / step).astype(jnp.int32), num_bins - 1)
    dist = jnp.where(ok, jnp.sqrt(r2), jnp.inf)
    # segment_min is a scatter-min (atomic min on a GPU): exact in any
    # order; empty bins stay +inf
    ranges = jax.ops.segment_min(
        dist, bins, num_segments=num_bins, indices_are_sorted=False
    )
    return jnp.minimum(ranges, range_max)


def resample_scan_uniform(angles, ranges, num_bins, range_max):
    """Host: bin-min resample an arbitrary scan onto the uniform grid the
    gather kernels assume. Uniform input scans map 1:1."""
    angles = np.mod(np.asarray(angles, np.float64), 2 * np.pi)
    ranges = np.asarray(ranges, np.float64)
    step = 2 * np.pi / num_bins
    bins = np.minimum((angles / step).astype(np.int64), num_bins - 1)
    # real no-echo beams (+inf) clip to range_max (reference semantics);
    # NaN DROPOUT beams contribute nothing — converting a dropout into a
    # valid max-range beam would stamp EMPTY along terrain the sensor
    # never observed (round-5 review; upstream clips propagate NaN
    # through min/max, so dropouts reach this resampler). Bins NO real
    # beam maps into (a partial-FOV lidar's blind sector, or all-dropout
    # bins) stay 0.0 = invalid under the kernels' beam-validity
    # convention.
    valid = ~np.isnan(ranges)
    out = np.full(num_bins, np.inf)
    np.minimum.at(
        out, bins[valid],
        np.where(np.isinf(ranges[valid]), range_max, ranges[valid]),
    )
    out = np.where(np.isfinite(out), out, 0.0)
    return out.astype(np.float32)


@lru_cache(maxsize=32)
def get_scan_to_grid(spec: MapperSpec):
    return jax.jit(partial(scan_to_grid, spec))


@lru_cache(maxsize=32)
def get_scan_to_grid_bayesian(spec: MapperSpec):
    return jax.jit(partial(scan_to_grid_bayesian, spec))


@lru_cache(maxsize=32)
def get_warp_previous_grid(spec: MapperSpec):
    return jax.jit(partial(warp_previous_grid, spec))


@lru_cache(maxsize=32)
def get_scan_to_grid_bayesian_warped(spec: MapperSpec):
    return jax.jit(partial(scan_to_grid_bayesian_warped, spec))


def pad_cloud_to_bucket(points, bucket: int = 4096):
    """Pad an [N, 3] cloud with zero rows to the next multiple of
    ``bucket`` (host side). Real sensor clouds vary N per frame; jitting
    directly over the raw shape recompiles per distinct N. Zero rows are
    origin points, which every cloud consumer filters (r^2 < 1e-6)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    pad = (-points.shape[0]) % bucket
    if pad == 0 and points.shape[0] > 0:
        return points
    return np.concatenate(
        [points, np.zeros((max(pad, bucket if points.shape[0] == 0 else pad), 3), np.float32)],
        axis=0,
    )


@lru_cache(maxsize=32)
def get_pointcloud_to_scan(num_bins: int):
    return jax.jit(
        lambda pts, range_max, min_z, max_z: pointcloud_to_scan(
            pts, num_bins, range_max, min_z, max_z
        )
    )


@lru_cache(maxsize=32)
def get_scan_to_grid_fleet(spec: MapperSpec):
    """Batched occupancy mapping: ranges [N, num_bins] -> grids [N, H, W]
    in ONE dispatch (vmapped `scan_to_grid`).

    A fleet-scale capability the single-robot reference has no analog
    for: N robots' egocentric maps ride one tensor program.
    """
    return jax.jit(jax.vmap(partial(scan_to_grid, spec)))


@lru_cache(maxsize=32)
def get_scan_to_grid_bayesian_fleet(spec: MapperSpec):
    """Batched Bayesian mapping: (ranges [N, B], prev_prob [N, H, W],
    scalar model params) -> (occ [N, H, W], prob [N, H, W]) in one
    dispatch."""
    return jax.jit(
        jax.vmap(
            partial(scan_to_grid_bayesian, spec),
            in_axes=(0, 0, None, None, None, None, None, None),
        )
    )
