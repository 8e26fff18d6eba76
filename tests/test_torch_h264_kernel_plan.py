"""The launch planning of H4 ``motion_search_kernel`` and H5
``deblock_kernel`` in pure Python (no kernel runs here).

- H5 (``ops/cuda/h264_deblock.deblock_plan``): a band of MB rows (4 at
  4K, at most 16) a block, the bands cover the picture's rows once, a warp
  a row and the two io warps within the kernel's bounds, every block
  resident at once (the launch is cooperative; one block an SM), the
  shared bytes the kernel's layout gives and within 227 KB, the seam a band
  boundary;
- H4 (``ops/cuda/h264_inter.search_plan_of``): MBs a block within 1..8 and
  the row, the blocks cover the row, the shared bytes within 227 KB (and
  half of it where more than one MB a block), ``search_tiles`` holding
  every candidate of ``search_candidates`` of every reference exactly once
  with at most 8 dy a tile, each tile's rows and words inside its slot's
  window (a row: the stack's 16-byte units that hold it), the slots on the
  planes ``search_plan`` stacks; fastsub's ``refine_tiles`` holding its 49
  offsets once inside the 17 x 48 window;
  the index tables inverting the candidate lists;
- a numpy model of a tile's packed SADs (5 aligned little-endian words a
  window row, shifted into 4 by a funnel shift, per-byte absolute
  differences summed) equals the direct SADs at every byte alignment.

At 4K, 1920x1088, 640x368, one MB row, one MB column and 48x32; the card
runs the kernels at the same geometries in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

from opencv_opencl_tpu_torch.ops import h264_levels as levels
from opencv_opencl_tpu_torch.ops.cuda import h264_deblock as kd
from opencv_opencl_tpu_torch.ops.cuda import h264_inter as ki

GEOMETRIES = [(2160, 3840), (1088, 1920), (368, 640), (16, 640), (368, 16), (32, 48)]
SEARCHES = [(8, 3, 1), (8, 3, 2), (8, 0, 1), (8, 1, 1), (4, 2, 1), (3, 2, 2), (2, 2, 2),
            (2, 0, 1), (11, 2, 2), (15, 0, 2)]
SHARED_LIMIT = 232448


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_deblock_plan(h, w):
    mb_h, mb_w = h // 16, w // 16
    plan = kd.deblock_plan(mb_h, mb_w)
    rows, blocks = plan["rows"], plan["blocks"]
    assert 1 <= rows <= kd.DEBLOCK_ROWS <= kd.DEBLOCK_MAX_ROWS
    assert (blocks - 1) * rows < mb_h <= blocks * rows
    assert plan["threads"] == 32 * (rows + 2) <= 32 * (kd.DEBLOCK_MAX_ROWS + 2)
    assert blocks <= 132
    assert plan["shared"] == (-(-8 * (rows + 1) // 16) * 16 + (rows + 1) * 8 * 96
                              + rows * (20 * 36 + 2 * 10 * 20))
    assert plan["shared"] <= SHARED_LIMIT and plan["shared"] % 16 == 0
    assert plan["seam_bytes"] == (blocks - 1) * (4 * w + 2 * 2 * w // 2)
    assert plan["bs_bytes"] == 16 * mb_h * mb_w
    if mb_h >= kd.DEBLOCK_ROWS:
        assert rows == kd.DEBLOCK_ROWS


def _tile_candidates(slots, tiles, P):
    """(reference, qy, qx) of every candidate the tiles hold."""
    out = []
    for slot, frac, a0, axc in tiles.tolist():
        cnt = axc & 15
        ax, fy, fx = (axc - cnt) // 16, frac >> 2, frac & 3
        r, plane = divmod(int(slots[slot]), P)
        assert plane == levels._plane_of(fy, fx, P)
        assert 1 <= cnt <= ki.TILE_ROWS
        out += [(r, 4 * (a0 + d) + fy, 4 * ax + fx) for d in range(cnt)]
    return out


@pytest.mark.parametrize("search,subpel,nrefs", SEARCHES)
def test_search_tiles_hold_every_candidate_once(search, subpel, nrefs):
    P, _ = levels.search_plan(search, subpel)
    slots, tiles = ki.search_tiles(search, subpel, nrefs)
    got = _tile_candidates(slots, tiles, P)
    cands = [tuple(c) for c in levels.search_candidates(search, subpel).tolist()]
    assert sorted(got) == sorted((r, qy, qx) for r in range(nrefs) for qy, qx in cands)
    inv = ki.candidate_index(search, subpel)
    side = 8 * search + 1
    for i, (qy, qx) in enumerate(cands):
        assert inv[(qy + 4 * search) * side + qx + 4 * search] == i
    assert (inv >= 0).sum() == len(cands)
    # every tile's rows lie in the window's 2 search + 16, its dx in
    # -search..search
    for slot, frac, a0, axc in tiles.tolist():
        cnt = axc & 15
        ax = (axc - cnt) // 16
        assert 0 <= a0 + search and a0 + search + cnt - 1 + 16 <= 2 * search + 16
        assert -search <= ax <= search


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("search,subpel,nrefs", SEARCHES)
def test_search_plan(h, w, search, subpel, nrefs):
    mb_w = w // 16
    plan = ki.search_plan_of(mb_w, search, subpel, nrefs)
    mbs = plan["mbs"]
    assert 1 <= mbs <= min(ki.SEARCH_MBS, mb_w)
    assert (plan["blocks_x"] - 1) * mbs < mb_w <= plan["blocks_x"] * mbs
    assert plan["threads"] == ki.SEARCH_THREADS
    assert plan["shared"] == ki.search_shared_bytes(mbs, search, plan["slots"], subpel == 3)
    assert plan["shared"] <= SHARED_LIMIT
    assert mbs == 1 or plan["shared"] <= ki.SEARCH_SHARED_BUDGET
    # a tile's words stay inside its window row: the last MB's column at
    # dx = search, past a lead of up to 15 bytes into the row's first
    # 16-byte unit, plus 5 words; the units hold the row
    pitch = (16 * mbs + 2 * search + 34 + 15) // 16 * 16
    last = 16 * (mbs - 1) + 2 * search
    assert last + 15 + 19 < pitch and 15 + 16 * mbs + 2 * search <= pitch
    if (search, subpel) == (8, 3) and mb_w == 240:
        assert mbs == 5                    # 51 tiles a MB fill 255 of 256 threads


def test_refine_tiles_hold_the_49_offsets_once():
    tiles = ki.refine_tiles()
    got = []
    for plane, frac, a0, axc in tiles.tolist():
        cnt = axc & 15
        ax, fy, fx = (axc - cnt) // 16, frac >> 2, frac & 3
        assert plane == fy * 4 + fx and a0 in (-1, 0) and ax in (-1, 0)
        # rows a0 + 1 .. a0 + cnt + 15 of 17; the words of column ax + 1 past
        # a lead of up to 15 in a row of 48 bytes
        assert a0 + 1 + cnt + 14 <= 16 and (ax + 1) + 15 + 19 < 48
        got += [(4 * (a0 + d) + fy, 4 * ax + fx) for d in range(cnt)]
    offs = [tuple(o) for o in levels.fastsub_offsets().tolist()]
    assert sorted(got) == sorted(offs) and len(got) == 49
    inv = ki.refine_index()
    assert [inv[(oy + 3) * 7 + ox + 3] for oy, ox in offs] == list(range(49))


def _words(rows: np.ndarray) -> np.ndarray:
    """Rows of bytes as little-endian 32-bit words."""
    return rows.view("<u4").astype(np.uint64)


def _sad4(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.zeros(a.shape, np.int64)
    for k in range(4):
        d += np.abs(((a >> (8 * k)) & 255).astype(np.int64)
                    - ((b >> (8 * k)) & 255).astype(np.int64))
    return d


@pytest.mark.parametrize("col", [0, 1, 2, 3, 13])
def test_packed_tile_sads_equal_direct_sads(col):
    rng = np.random.default_rng(col)
    win = rng.integers(0, 256, (23, 40), dtype=np.uint8)
    cur = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    cw = _words(cur)                                   # (16, 4)
    ww = _words(win)                                   # (23, 10)
    sh = (col & 3) * 8
    sads = np.zeros(8, np.int64)
    for R in range(23):
        a = ww[R, col >> 2:(col >> 2) + 5]
        b = ((a[:4] | (a[1:] << 32)) >> sh) & 0xFFFFFFFF   # __funnelshift_r
        for d in range(8):
            if 0 <= R - d < 16:
                sads[d] += _sad4(cw[R - d], b).sum()
    want = [np.abs(cur.astype(np.int64) - win[d:d + 16, col:col + 16]).sum() for d in range(8)]
    assert sads.tolist() == want
