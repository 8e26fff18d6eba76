"""The launch planning of K1, K2, K3 (with K5 and K3v1), K6 and K7 in pure
Python (no kernel runs here).

- K3 (``interp_kernel``): the per-block row ranges cover every row once,
  in order, each inside one row pair of ``PackSpec.rp_of_r``, and the
  unit-major column tables hold the plan's values;
- K5 (the same kernel on a band at ``row0``): the ranges of the sharded
  step's bands, of a band at a ``row0`` inside a row pair and of a band
  that runs past the frame cover the band's live rows once, in order, each
  inside one row pair; a band cut from a position's slab takes the 16-byte
  path where 16 divides the width;
- K2 (``build_luts_kernel``): a numpy model of its warp (8 bins a lane, a
  butterfly sum of the excess, a lane prefix plus a warp scan of the
  lanes' totals) equals ``build_luts_ref`` on the residual edge cases, a
  clip tensor and random histograms;
- K7 (``interp_hist_kernel``): its blocks (row ranges cut at row pairs and
  tile rows, times the tile columns) cover every (row, tile column) of a
  frame once, each inside one row pair, one tile row and one tile column,
  whose columns lie in two column groups;
- K6 (``interp_cells_kernel``): each cell column's head bytes, 16-byte
  units and tail bytes cover its columns once, the units 16-aligned, and
  its unit-major ``xa`` holds the plan's values;
- the choice between the 16-byte and the byte paths of K1, K3, K6 and K7
  on aligned NV12 views, ``y[..., 1:]``, 1919x1079 and tile widths that 16
  does not divide;
- K1's interior tiles, which it reads without reflect-101 index math:
  exactly the tiles whose rows and columns all lie inside the frame;
- K1's flattened (row, 16-byte unit) walk with R loads a round (R = 2, 4,
  8: ``tile_hist_kernel<R>``) visits every (row, unit) of every slice
  once, at 4K (30 units a tile row), 1080p (15) and past 256 units;
- K10 (``tile_histograms_batched``): K1's launch on the extended frame,
  every tile interior, ``batch_rows`` loads in flight, the 16-byte path
  where 16 divides the base, the strides and the tile width; K6r
  (``clahe_interpolate_cells(radix=True)``): K6's launch, counted apart;
  K8 (``lut.tile_histograms_extended``): K1's launch as K10 plans it with
  4 loads, counted apart.
  The routing tests run the wrappers' card branch against a recording
  stand-in for the kernel library.

At 4K, 1080p, 1919x1079, 6x6 and 3x3 on an 8x8 grid, and 97x131 on a 3x5
grid (K7: the tile-divisible ones, and more).  The card runs the same
geometries in ``tests/test_torch_cuda.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from opencv_opencl_tpu_torch.core.golden import reflect101_indices
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops.cuda import _build, lut, natural
from opencv_opencl_tpu_torch.parallel import sharded

GEOMETRIES = [
    # (height, width, tile grid (x, y))
    (2160, 3840, (8, 8)),
    (1080, 1920, (8, 8)),
    (1079, 1919, (8, 8)),
    (6, 6, (8, 8)),
    (3, 3, (8, 8)),
    (97, 131, (3, 5)),
]
IDS = [f"{h}x{w}_grid{g[0]}x{g[1]}" for h, w, g in GEOMETRIES]


def _spec(h, w, grid):
    return natural.make_pack_spec(h, w, 2.0, grid)


@pytest.mark.parametrize("h,w,grid", GEOMETRIES, ids=IDS)
def test_k3_row_ranges_cover_every_row_once_inside_one_row_pair(h, w, grid):
    spec = _spec(h, w, grid)
    for frames in (1, 4):
        rows = natural.interp_rows_per_block(frames, h)
        for per_block in sorted({1, 3, rows}):
            ranges = spec.row_ranges(per_block)
            assert ranges.dtype == np.int32 and ranges.shape[1] == 2
            assert ranges[0, 0] == 0 and ranges[-1, 1] == h
            assert np.array_equal(ranges[1:, 0], ranges[:-1, 1])   # in order
            assert np.all(ranges[:, 1] > ranges[:, 0])
            assert np.all(ranges[:, 1] - ranges[:, 0] <= per_block)
            for lo, hi in ranges:
                assert len(set(spec.rp_of_r[lo:hi].tolist())) == 1
    # the ranges of a row pair differ in length by at most one row
    ranges = spec.row_ranges(natural.interp_rows_per_block(4, h))
    pair = spec.rp_of_r[ranges[:, 0]]
    for rp in np.unique(pair):
        lengths = np.diff(ranges[pair == rp], axis=1)
        assert lengths.max() - lengths.min() <= 1


def test_k3_rows_per_block_keep_the_grid_at_four_waves():
    # 4K b4: 4 rows a block; 4K rows are two half row pairs of 135 rows (34
    # ranges each) and seven of 270 (68): 544 blocks a frame, 2176 in all
    assert natural.interp_rows_per_block(4, 2160) == 4
    assert len(_spec(2160, 3840, (8, 8)).row_ranges(4)) == 2 * 34 + 7 * 68
    assert natural.interp_rows_per_block(16, 2160) == 16
    assert natural.interp_rows_per_block(4, 1080) == 4
    assert natural.interp_rows_per_block(1, 6) == 4
    assert natural.interp_rows_per_block(64, 2160) == 32


def _clahe_bands(h, w, space):
    """The sharded CLAHE step's bands for ``space`` positions: (row0, rows)."""
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    bands = sharded._ClaheBands(plan, space, "natural")
    return [(r0, r1 - r0) for r0, r1 in map(bands.rows, range(space))]


# (height, width, frames, bands (row0, rows)): the sharded step's bands, a
# band at a row0 inside a row pair, and bands that run past the frame
BAND_CASES = [
    (2160, 3840, 2, _clahe_bands(2160, 3840, 2)),   # row0 1080: inside [945, 1215)
    (2160, 3840, 1, _clahe_bands(2160, 3840, 4)),
    (1080, 1920, 2, _clahe_bands(1080, 1920, 2)),
    (1080, 1920, 4, _clahe_bands(1080, 1920, 3)),
    (1079, 1919, 1, _clahe_bands(1079, 1919, 3)),   # the last band short
    (1080, 1920, 1, [(13, 700), (0, 1080), (1079, 1)]),
    (97, 131, 2, [(90, 16), (96, 8), (97, 8), (40, 0)]),
]
BAND_IDS = [f"{h}x{w}_n{n}_{len(b)}bands" for h, w, n, b in BAND_CASES]


@pytest.mark.parametrize("h,w,frames,bands", BAND_CASES, ids=BAND_IDS)
def test_k5_band_ranges_cover_the_live_rows_once_inside_one_row_pair(
        h, w, frames, bands):
    spec = _spec(h, w, (8, 8))
    for row0, rows in bands:
        live = natural.live_rows(rows, h, row0)
        per_block = natural.interp_rows_per_block(frames, live)
        ranges = spec.row_ranges(per_block, span=(row0, row0 + live))
        assert ranges.dtype == np.int32 and ranges.shape[1] == 2
        if not live:
            assert ranges.shape == (0, 2)
            continue
        assert ranges[0, 0] == row0 and ranges[-1, 1] == row0 + live
        assert np.array_equal(ranges[1:, 0], ranges[:-1, 1])      # in order
        assert np.all(ranges[:, 1] > ranges[:, 0])
        assert np.all(ranges[:, 1] - ranges[:, 0] <= per_block)
        for lo, hi in ranges:
            assert len(set(spec.rp_of_r[lo:hi].tolist())) == 1
    assert np.array_equal(spec.row_ranges(4, span=(0, h)), spec.row_ranges(4))
    with pytest.raises(ValueError, match="span"):
        spec.row_ranges(4, span=(0, h + 1))


def test_k5_band_ranges_at_4k_on_a_2x2_mesh():
    spec = _spec(2160, 3840, (8, 8))
    (row0, rows), = [b for b in _clahe_bands(2160, 3840, 2) if b[0]]
    assert (row0, rows) == (1080, 1080)
    ranges = spec.row_ranges(natural.interp_rows_per_block(2, rows),
                             span=(row0, row0 + rows))
    # 4 rows a block: [1080, 1215) is the second half of the row pair
    # [945, 1215) (34 ranges), then three whole pairs of 270 rows (68 each)
    # and the last pair, [2025, 2160), of 135 rows (34): 272 ranges, 544
    # blocks over two frames
    assert natural.interp_rows_per_block(2, rows) == 4
    assert len(ranges) == 34 + 3 * 68 + 34
    assert spec.rp_of_r[1079] == spec.rp_of_r[1080] == spec.rp_of_r[1214]
    cached = spec.device_row_ranges("cpu", 4, span=(row0, row0 + rows))
    assert np.array_equal(cached.numpy(), ranges)
    assert spec.device_row_ranges("cpu", 4, span=(row0, row0 + rows)) is cached


@pytest.mark.parametrize("h,w,space", [(1080, 1920, 2), (2160, 3840, 2),
                                       (2160, 3840, 4), (1079, 1919, 3)])
def test_k5_band_of_a_slab_takes_the_16_byte_path_where_16_divides_the_width(
        h, w, space):
    """The sharded step writes each position's band in place, a row slice
    of the slab it uploaded (``sharded._upload``)."""
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    bands = sharded._ClaheBands(plan, space, "natural")
    frames = torch.zeros((2, h, w), dtype=torch.uint8)
    for s in range(space):
        part = sharded._part(bands, 0, s, 1)
        slab = sharded._upload(frames, part, torch.device("cpu"))
        band = slab[:, part.rows[0] - part.slab[0]:part.rows[1] - part.slab[0]]
        assert band.shape[1] == part.rows[1] - part.rows[0] > 0
        assert natural.interp_vec(band, band) == (w % 16 == 0), s


@pytest.mark.parametrize("h,w,grid", GEOMETRIES, ids=IDS)
def test_k3_unit_tables_hold_the_plan_values_by_unit(h, w, grid):
    spec = _spec(h, w, grid)
    g_units, xa_units = spec.unit_tables("cpu")
    units = w // 16
    assert tuple(g_units.shape) == tuple(xa_units.shape) == (4, units, 4)
    assert g_units.dtype == torch.int32 and xa_units.dtype == torch.float32
    for j in range(4):
        for k in range(4):
            cols = 16 * np.arange(units) + 4 * j + k
            assert np.array_equal(g_units[j, :, k].numpy(), spec.g_of_c[cols])
            assert np.array_equal(xa_units[j, :, k].numpy().view(np.uint32),
                                  spec.xa[cols].view(np.uint32))
    assert spec.unit_tables("cpu")[0] is g_units         # cached


@pytest.mark.parametrize("h,w,grid", GEOMETRIES, ids=IDS)
def test_vector_path_choice(h, w, grid):
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    nv12 = torch.zeros((2, h + h // 2, w), dtype=torch.uint8)
    assert nv12.data_ptr() % 16 == 0
    y = nv12[:, :h]
    rows_aligned = w % 16 == 0
    assert natural.interp_vec(y, y) == rows_aligned
    assert natural.tile_hist_vec(y, plan) == (rows_aligned and plan.tile_w % 16 == 0)
    # a view from column 1 lies off 16 bytes: the byte paths throughout
    view = nv12[:, :h, 1:]
    assert not natural.interp_vec(view, view)
    assert not natural.interp_vec(y, view) and not natural.interp_vec(view, y)
    assert not natural.tile_hist_vec(
        view, torch_clahe.make_clahe_plan(h, w - 1, 2.0, grid))
    # aligned base and rows, any width: K3 maps 16-byte units and a byte tail
    padded = torch.zeros((2, h, 16 * (w // 16 + 1)), dtype=torch.uint8)
    assert natural.interp_vec(padded[:, :, :w], padded[:, :, :w])


def test_vector_path_choice_on_the_named_cases():
    def choose(h, w, grid, view):
        plan = torch_clahe.make_clahe_plan(h, view.shape[2], 2.0, grid)
        return natural.tile_hist_vec(view, plan), natural.interp_vec(view, view)

    four_k = torch.zeros((4, 3240, 3840), dtype=torch.uint8)
    assert choose(2160, 3840, (8, 8), four_k[:, :2160]) == (True, True)
    assert choose(2160, 3839, (8, 8), four_k[:, :2160, 1:]) == (False, False)
    hd = torch.zeros((4, 1620, 1920), dtype=torch.uint8)
    assert choose(1080, 1920, (8, 8), hd[:, :1080]) == (True, True)
    # 1920 / 7 tiles of 275: K1 reads bytes, K3 still 16-byte units
    assert choose(1080, 1920, (7, 8), hd[:, :1080]) == (False, True)
    odd = torch.zeros((2, 1079, 1919), dtype=torch.uint8)
    assert choose(1079, 1919, (8, 8), odd) == (False, False)


@pytest.mark.parametrize("h,w,grid", GEOMETRIES, ids=IDS)
def test_k1_interior_tiles_are_those_without_reflection(h, w, grid):
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    rows = reflect101_indices(plan.height + plan.pad_bottom, plan.height)
    cols = reflect101_indices(plan.width + plan.pad_right, plan.width)
    inner_rows, inner_cols = natural.interior_tiles(plan)
    for ty in range(plan.tiles_y):
        r = np.arange(ty * plan.tile_h, (ty + 1) * plan.tile_h)
        assert np.array_equal(rows[r], r) == (ty < inner_rows)
    for tx in range(plan.tiles_x):
        c = np.arange(tx * plan.tile_w, (tx + 1) * plan.tile_w)
        assert np.array_equal(cols[c], c) == (tx < inner_cols)
    if not (plan.pad_bottom or plan.pad_right):
        assert (inner_rows, inner_cols) == (plan.tiles_y, plan.tiles_x)


# tile-divisible geometries, K7's contract: (height, width, tile grid (x, y))
FUSED_GEOMETRIES = [
    (2160, 3840, (8, 8)),    # tile 270x480: row pairs cut at 135 + 270k
    (1080, 1920, (8, 8)),    # tile 135x240: group boundaries inside units
    (96, 128, (8, 8)),
    (80, 120, (5, 4)),       # tile width 24: the byte path
    (64, 64, (16, 16)),
    (68, 120, (8, 4)),       # odd tile sizes, 17x15
]
FUSED_IDS = [f"{h}x{w}_grid{g[0]}x{g[1]}" for h, w, g in FUSED_GEOMETRIES]


@pytest.mark.parametrize("h,w,grid", FUSED_GEOMETRIES, ids=FUSED_IDS)
def test_k7_blocks_cover_every_row_and_tile_column_once(h, w, grid):
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    assert natural.fused_interp_hist_fits(plan)
    spec = _spec(h, w, grid)
    tile_rows = np.arange(h) // plan.tile_h
    for frames in (1, 4):
        rows = natural.fused_rows_per_block(frames, plan)
        ranges = spec.row_ranges(rows, plan.tile_h)
        covered = np.zeros((h, plan.tiles_x), np.int32)
        for lo, hi in ranges:
            assert 0 < hi - lo <= rows
            assert len(set(spec.rp_of_r[lo:hi].tolist())) == 1
            assert len(set(tile_rows[lo:hi].tolist())) == 1
            for tx in range(plan.tiles_x):      # the grid's second axis
                covered[lo:hi, tx] += 1
        assert np.all(covered == 1)
        assert np.array_equal(ranges[1:, 0], ranges[:-1, 1])   # in order
    # a block stages the two column groups tx and tx + 1 of its tile column
    for tx in range(plan.tiles_x):
        groups = spec.g_of_c[tx * plan.tile_w:(tx + 1) * plan.tile_w]
        assert set(groups.tolist()) <= {tx, tx + 1}


def test_k7_rows_per_block_fill_the_card_with_one_frame():
    def blocks(h, w, frames):
        plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
        rows = natural.fused_rows_per_block(frames, plan)
        return rows, len(_spec(h, w, (8, 8)).row_ranges(rows, plan.tile_h)) * 8

    # 4K: three passes of 256 threads map 24 pairs of rows of 30 units; 16
    # stretches of 135 rows, 3 ranges of 45 rows each, times 8 tile columns
    assert blocks(2160, 3840, 1) == (48, 384)
    assert blocks(2160, 3840, 4) == (48, 384)
    # 1080p: 32 rows a block keep one frame at 384 blocks
    assert blocks(1080, 1920, 1) == (32, 384)
    assert blocks(96, 128, 1) == (2, 384)


CELL_GEOMETRIES = GEOMETRIES + [(1080, 1919, (8, 8)), (64, 64, (16, 16))]
CELL_IDS = [f"{h}x{w}_grid{g[0]}x{g[1]}" for h, w, g in CELL_GEOMETRIES]


@pytest.mark.parametrize("h,w,grid", CELL_GEOMETRIES, ids=CELL_IDS)
def test_k6_column_parts_cover_each_cell_once(h, w, grid):
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    assert spec is not None
    parts = spec.column_parts()
    assert parts.dtype == np.int32 and parts.shape == (spec.cx, 4)
    covered = np.zeros(w, np.int32)
    cell_of = (np.arange(w) + spec.pad_left) // spec.tile_w
    for cx, (c0, a, b, c1) in enumerate(parts):
        assert c0 <= a <= b <= c1
        assert a % 16 == 0 or a == c1           # the units start 16-aligned
        assert b % 16 == 0 or b == a            # ... and end so
        assert a - c0 < 16 and c1 - b < 16      # at most 15 head, 15 tail
        assert np.all(cell_of[c0:c1] == cx)
        covered[c0:c1] += 1
    assert np.all(covered == 1)
    assert lut.cells_rows_per_block(spec) <= spec.tile_h


def test_k6_column_parts_at_4k_and_1080p():
    four_k = lut.make_interp_spec(2160, 3840, 2.0, (8, 8)).column_parts()
    # cell columns start at 240 + 480k: no head or tail bytes
    assert np.all(four_k[:, 0] == four_k[:, 1]) and np.all(four_k[:, 2] == four_k[:, 3])
    hd = lut.make_interp_spec(1080, 1920, 2.0, (8, 8)).column_parts()
    # at 120 + 240k: 8 head and 8 tail bytes in every cell but the edges
    assert np.all(hd[1:, 1] - hd[1:, 0] == 8) and np.all(hd[:-1, 3] - hd[:-1, 2] == 8)
    assert lut.cells_rows_per_block(lut.make_interp_spec(2160, 3840, 2.0, (8, 8))) == 32
    assert lut.cells_rows_per_block(lut.make_interp_spec(1080, 1920, 2.0, (8, 8))) == 68


@pytest.mark.parametrize("h,w,grid", CELL_GEOMETRIES, ids=CELL_IDS)
def test_k6_unit_xa_holds_the_plan_values_by_unit(h, w, grid):
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    col_parts, xa_units = spec.unit_tables("cpu")
    assert np.array_equal(col_parts.numpy(), spec.column_parts())
    units = w // 16
    assert tuple(xa_units.shape) == (4, units, 4) and xa_units.dtype == torch.float32
    for j in range(4):
        for k in range(4):
            cols = 16 * np.arange(units) + 4 * j + k
            assert np.array_equal(xa_units[j, :, k].numpy().view(np.uint32),
                                  spec.xa[cols].view(np.uint32))
    # the same values as K3's table
    assert torch.equal(xa_units, _spec(h, w, grid).unit_tables("cpu")[1])
    assert spec.unit_tables("cpu")[1] is xa_units       # cached


def test_k7_k6_path_choice_on_the_named_cases():
    """K7 maps 16-byte units when the bases, the strides and the tile width
    are multiples of 16; K6 (interp_vec, as K3) when the bases and strides
    are, whatever the width."""
    four_k = torch.zeros((4, 3240, 3840), dtype=torch.uint8)
    plan = torch_clahe.make_clahe_plan(2160, 3840, 2.0, (8, 8))
    y = four_k[:, :2160]
    assert natural.fused_vec(y, y, plan) and natural.interp_vec(y, y)
    view = four_k[:, :2160, 1:]
    view_plan = torch_clahe.make_clahe_plan(2160, 3839, 2.0, (8, 8))
    assert not natural.fused_vec(view, view, view_plan)
    assert not natural.interp_vec(view, view)
    hd = torch.zeros((4, 1620, 1920), dtype=torch.uint8)[:, :1080]
    assert natural.fused_vec(hd, hd, torch_clahe.make_clahe_plan(1080, 1920, 2.0, (8, 8)))
    # tile width 24 (120 / 5): K7 reads bytes, K6 still 16-byte units
    small = torch.zeros((2, 120, 128), dtype=torch.uint8)[:, :80, :120]
    small_plan = torch_clahe.make_clahe_plan(80, 120, 2.0, (5, 4))
    assert not natural.fused_vec(small, small, small_plan)
    assert natural.interp_vec(small, small)
    odd = torch.zeros((2, 1079, 1919), dtype=torch.uint8)
    assert not natural.interp_vec(odd, odd)
    # an aligned input with an output off 16 bytes: both take bytes
    assert not natural.fused_vec(y, view[:, :, :3824], plan)


# ------------------------------------------------------------------ K2 ----


def _k2_warp_model(hists: np.ndarray, clips: np.ndarray,
                   lut_scale: float) -> np.ndarray:
    """K2's arithmetic laid out as its warp computes it, one row per warp:
    lane l holds bins [8l, 8l + 8); the excess summed in the lane, then a
    butterfly over the lanes (__shfl_xor_sync 16, 8, 4, 2, 1); each bin's
    share and bump from its index; a lane-local inclusive prefix plus a
    warp inclusive scan (__shfl_up_sync 1, 2, 4, 8, 16) of the lanes'
    totals; one rounded f32 product, round half to even, clamp."""
    rows = hists.shape[0]
    h = hists.reshape(rows, 32, 8).astype(np.int32)
    clip = clips.astype(np.int32)[:, None, None]
    lane = np.arange(32)
    excess = np.where(h > clip, h - clip, 0).sum(axis=2, dtype=np.int32)
    for s in (16, 8, 4, 2, 1):
        excess = excess + excess[:, lane ^ s]
    total = excess[:, :, None]               # every lane holds the sum
    redist = total // 256
    residual = total - 256 * redist
    step = np.maximum(256 // np.maximum(residual, 1), 1)
    bins = (8 * lane[:, None] + np.arange(8)[None, :])[None]
    bump = ((bins % step == 0) & (bins // step < residual)).astype(np.int32)
    h = np.where(clip > 0, np.minimum(h, clip) + redist + bump, h)
    prefix = np.cumsum(h, axis=2, dtype=np.int32)
    scan = prefix[:, :, -1].copy()
    for s in (1, 2, 4, 8, 16):
        shifted = np.zeros_like(scan)
        shifted[:, s:] = scan[:, :-s]
        scan = scan + shifted
    cdf = (scan - prefix[:, :, -1])[:, :, None] + prefix
    v = np.rint(cdf.astype(np.float32) * np.float32(lut_scale))
    return np.clip(v, 0, 255).astype(np.uint8).reshape(rows, 256)


def _residual_edge_hists(clip: int, area: int) -> np.ndarray:
    """Rows whose redistribution residual is 0, 1, 255 and the
    non-divisors 3, 100 and 129 of 256 (steps 85, 2 and 1), one bin holding
    everything, a uniform row, and an excess of 7 * 256 + 5."""
    rows = [[area], None]
    rows += [[clip + e, area - clip - e] for e in (255, 256, 1, 3, 100, 129)]
    rows += [[clip + 7 * 256 + 5, area - clip - 7 * 256 - 5]]
    out = np.zeros((len(rows), 256), np.int32)
    for i, r in enumerate(rows):
        if r is None:
            out[i] = area // 256
            out[i, 0] += area - out[i].sum()
        else:
            out[i, :len(r)] = r
    return out


@pytest.mark.parametrize("h,w,grid", [(2160, 3840, (8, 8)), (96, 128, (8, 8)),
                                      (97, 131, (3, 5))])
def test_k2_warp_layout_equals_the_plain_lut_build(h, w, grid):
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    edge = _residual_edge_hists(plan.clip, plan.tile_area)
    assert (edge.sum(axis=1) == plan.tile_area).all()
    rng = np.random.default_rng(7)
    random = rng.multinomial(plan.tile_area, np.full(256, 1 / 256), size=6)
    skewed = rng.multinomial(plan.tile_area, rng.dirichlet(np.full(256, 0.05)), size=6)
    for hists in (edge, random.astype(np.int32), skewed.astype(np.int32)):
        got = _k2_warp_model(hists, np.full(len(hists), plan.clip), plan.lut_scale)
        want = natural.build_luts_ref(torch.from_numpy(hists[None]), plan.clip,
                                      plan.lut_scale)[0].numpy()
        assert np.array_equal(got, want)
    # one clip per frame (auto-CLAHE): 0 (no clipping), 1, the plan's, huge
    hists = np.concatenate([edge, random.astype(np.int32)])[:8]
    frames = hists.reshape(4, 2, 256)
    clips = np.array([0, 1, plan.clip, 1 << 30], np.int32)
    got = _k2_warp_model(hists, np.repeat(clips, 2), plan.lut_scale)
    want = natural.build_luts_ref(torch.from_numpy(frames), torch.from_numpy(clips),
                                  plan.lut_scale).numpy().reshape(8, 256)
    assert np.array_equal(got, want)


# ------------------------------------------------------------ K1 and K10 ----


def _k1_walk(nk: int, units: int, loads: int) -> tuple[np.ndarray, np.ndarray]:
    """K1's 16-byte path over one slice of ``nk`` rows of ``units`` units,
    as its 256 threads run it: thread t starts at (t // units, t % units)
    and steps by 256 positions with a running counter; each round it loads
    up to ``loads`` units (while k < nk) and then counts those it loaded.
    Returns how often each (row, unit) was loaded and counted."""
    threads = 256
    t = np.arange(threads)
    k, u = t // units, t % units
    step_k, step_u = threads // units, threads % units
    loaded = np.zeros((nk, units), np.int64)
    counted = np.zeros((nk, units), np.int64)
    while np.any(k < nk):
        got = []
        for _ in range(loads):
            live = k < nk
            np.add.at(loaded, (k[live], u[live]), 1)
            got.append((k[live], u[live]))
            k, u = k + step_k, u + step_u
            wrap = u >= units
            u, k = np.where(wrap, u - units, u), np.where(wrap, k + 1, k)
        for kk, uu in got:              # j < loaded: the loads of this round
            np.add.at(counted, (kk, uu), 1)
    return loaded, counted


# (frames, tile rows, tiles, tile width): 4K b4 8x8 (30 units a row), 1080p
# b4 8x8 (15), 4K b4 1x1 (240), 7680 wide on 1x1 (480 units: step_k 0)
WALK_CASES = [(4, 270, 64, 480), (4, 135, 64, 240), (4, 2160, 1, 3840),
              (1, 64, 1, 7680)]


@pytest.mark.parametrize("loads", [2, 4, 8])
@pytest.mark.parametrize("frames,tile_h,tiles,tile_w", WALK_CASES,
                         ids=[f"{c[3] // 16}units" for c in WALK_CASES])
def test_k1_walk_visits_every_row_and_unit_of_every_slice_once(
        frames, tile_h, tiles, tile_w, loads):
    units = tile_w // 16
    slices = natural.hist_slices(frames, tiles, tile_h)
    bounds = [tile_h * s // slices for s in range(slices + 1)]
    assert bounds[0] == 0 and bounds[-1] == tile_h     # the slices cover the tile
    for nk in sorted({hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])}):
        loaded, counted = _k1_walk(nk, units, loads)
        assert np.all(loaded == 1) and np.all(counted == 1), (nk, units)


def _extended(h, w, grid, frames=2):
    """Frames extended to the plan's tile multiple, and their tile args."""
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    y = torch.zeros((frames, h + h // 2, w), dtype=torch.uint8)[:, :h]
    ext = natural.extend(y, plan)
    return ext, (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)


@pytest.mark.parametrize("h,w,grid,vec", [
    (2160, 3840, (8, 8), True),      # tiles 270x480, NV12 Y rows
    (1080, 1920, (8, 8), True),      # tiles 135x240
    (1079, 1919, (8, 8), True),      # extended to 1080x1920 (a copy)
    (2160, 3840, (1, 1), True),      # one tile, 240 units a row
    (48, 120, (4, 4), False),        # tile width 30: the byte path
])
def test_k10_launch_is_k1s_on_the_extended_frame(h, w, grid, vec):
    ext, tiles = _extended(h, w, grid)
    tiles_y, tiles_x, tile_h, tile_w = tiles
    ext_plan = torch_clahe.make_clahe_plan(tiles_y * tile_h, tiles_x * tile_w,
                                           2.0, grid)
    k1 = natural.tile_hist_args(ext, ext_plan)
    assert k1["loads"] == 4
    for batch_rows in (2, 4, 8):
        args = natural.batched_hist_args(ext, *tiles, batch_rows)
        assert list(args) == list(natural._TILE_HIST_ARGS)
        assert args == dict(k1, loads=batch_rows)
        # every tile interior, the whole frame, no rowstep, no band
        assert (args["inner_rows"], args["inner_cols"]) == (tiles_y, tiles_x)
        assert (args["height"], args["width"]) == tuple(ext.shape[1:])
        assert (args["rowstep"], args["ty0"], args["slab_row0"]) == (1, 0, 0)
        assert args["tile_rows"] == tiles_y and args["vec"] == int(vec)
    # a view from column 1 lies off 16 bytes: the byte path
    wide = torch.zeros((2, ext.shape[1], ext.shape[2] + 16), dtype=torch.uint8)
    view = wide[:, :, 1:1 + ext.shape[2]]
    assert natural.batched_hist_args(view, *tiles, 4)["vec"] == 0
    assert natural.batched_hist_args(ext[0][None], *tiles, 8)["vec"] == int(vec)


def test_k10_batch_rows_outside_2_4_8_raise():
    ext, tiles = _extended(96, 128, (8, 8))
    for batch_rows in (0, 1, 3, 16):
        with pytest.raises(ValueError, match="batch_rows must be one of"):
            natural.batched_hist_args(ext, *tiles, batch_rows)
        with pytest.raises(ValueError, match="batch_rows must be one of"):
            natural.tile_histograms_batched(ext, *tiles, batch_rows=batch_rows)


class _Recorder:
    """Stands in for the kernel library: records each launch's arguments
    and returns success, so the wrappers' card branch runs on the CPU."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "load", lambda: lib)
    for module in (natural, lut):
        monkeypatch.setattr(module, "_on_card", lambda t: True)
        monkeypatch.setattr(module, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    natural.reset_launch_counts()
    lut.reset_launch_counts()
    yield lib
    natural.reset_launch_counts()
    lut.reset_launch_counts()


@pytest.mark.parametrize("h,w,grid", [(2160, 3840, (8, 8)), (1079, 1919, (8, 8)),
                                      (48, 120, (4, 4))])
def test_k10_launches_k1s_kernel_with_batch_rows_loads(recorder, h, w, grid):
    ext, tiles = _extended(h, w, grid)
    ext_plan = torch_clahe.make_clahe_plan(ext.shape[1], ext.shape[2], 2.0, grid)
    natural.tile_histograms(ext, ext_plan)
    for batch_rows in (2, 4, 8):
        natural.tile_histograms_batched(ext, *tiles, batch_rows=batch_rows)
    names = [name for name, _ in recorder.calls]
    assert names == ["tile_hist_launch"] * 4
    # (y, frames, *the named args, out, stream): all but `out` and the loads
    # equal K1's launch
    k1 = recorder.calls[0][1]
    loads = 2 + natural._TILE_HIST_ARGS.index("loads")
    assert k1[loads] == 4
    for batch_rows, (_, args) in zip((2, 4, 8), recorder.calls[1:]):
        assert args[loads] == batch_rows
        assert args[:loads] == k1[:loads] and args[-1] == k1[-1]
    counts = natural.launch_counts()
    assert counts["tile_histograms"] == 1 and counts["tile_histograms_batched"] == 3


@pytest.mark.parametrize("h,w,grid", [(2160, 3840, (8, 8)), (2160, 3840, (1, 1)),
                                      (1079, 1919, (8, 8)), (48, 120, (4, 4))])
def test_k8_launches_k1s_kernel_as_k10_plans_it(recorder, h, w, grid):
    """K8 (``lut.tile_histograms_extended``) makes K1's launch with
    ``batched_hist_args(..., 4)``: every tile interior, one rowstep, no
    band, K1's 4 loads in flight, the 16-byte path where it holds; counted
    under its own wrapper, apart from K1 and K10."""
    ext, tiles = _extended(h, w, grid)
    lut.tile_histograms_extended(ext, *tiles)
    natural.tile_histograms_batched(ext, *tiles, batch_rows=4)
    (name, k8), (name10, k10) = recorder.calls
    assert name == name10 == "tile_hist_launch"
    plan = natural.batched_hist_args(ext, *tiles, 4)
    # (y, frames, *the named args, out, stream)
    assert k8[0] == ext.data_ptr() and k8[1] == ext.shape[0]
    assert list(k8[2:-2]) == [plan[k] for k in natural._TILE_HIST_ARGS]
    assert k8[:-2] == k10[:-2] and k8[-1] == k10[-1]
    assert plan["loads"] == natural._HIST_LOADS == 4
    assert lut.launch_counts()["tile_histograms_extended"] == 1
    assert natural.launch_counts()["tile_histograms_batched"] == 1
    assert natural.launch_counts()["tile_histograms"] == 0


@pytest.mark.parametrize("h,w,grid", [(2160, 3840, (8, 8)), (1080, 1920, (8, 8)),
                                      (1079, 1919, (8, 8)), (64, 64, (16, 16))])
def test_k6r_takes_k6s_launch(recorder, h, w, grid):
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    y = torch.zeros((2, h, w), dtype=torch.uint8)
    out = torch.empty_like(y)
    luts = torch.zeros((2, spec.num_tiles, 256), dtype=torch.uint8)
    lut.clahe_interpolate_cells(y, luts, spec, out=out, radix=True)
    lut.clahe_interpolate_cells(y, luts, spec, out=out)
    (name_r, radix), (name_k6, k6) = recorder.calls
    assert name_r == name_k6 == "interp_cells_launch"
    # the same rows per block, column parts, unit tables and pointers
    assert radix == k6
    col_parts, xa_units = spec.unit_tables("cpu")
    assert lut.cells_rows_per_block(spec) in radix
    assert col_parts.data_ptr() in radix and xa_units.data_ptr() in radix
    counts = lut.launch_counts()
    assert counts["clahe_interpolate_cells_radix"] == 1
    assert counts["clahe_interpolate_cells"] == 1
    # K6's refusal holds on the radix route: LUTs off 4 bytes
    odd = torch.zeros(2 * spec.num_tiles * 256 + 1, dtype=torch.uint8)[1:]
    with pytest.raises(ValueError, match="4-byte aligned"):
        lut.clahe_interpolate_cells(y, odd.view(2, spec.num_tiles, 256), spec,
                                    radix=True)
