"""The launch planning of H3 ``subpel_planes_kernel``, H4
``motion_search_kernel``, H5 ``deblock_kernel`` and H6
``parts_search_kernel`` in pure Python (no kernel runs here).

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
  differences summed) equals the direct SADs at every byte alignment, and
  its quadrant variant (H6: four sums a candidate) the direct 8x8 SADs;
- H6 (``ops/cuda/h264_inter.parts_plan_of``): tiles of up to 8 dy holding
  every candidate of every reference once at full- and half-pel search 8
  and quarter-pel search 4 with one and two references, the key packing
  below 2^31, MBs a block within the row, the shared bytes the kernel's
  layout gives and within budget;
- H3 (``planes_plan``): a numpy model of the kernel block by block (the
  clamped reference tile, the vertical sums once, runs of 16 positions,
  a warp a plane row storing the 16-byte units of the flat plane that lie
  wholly in the row and start in its columns, head and tail bytes singly,
  the plane table read from the ``.cu``) writes every byte of every plane
  once and equals ``subpel_planes_plain`` at 1, 4 and 16 planes, at plane
  rows of no multiple of 4, one MB row and column, one-row and one-column
  pictures and two byte alignments of the stack, and JAX's planes.

At 4K, 1920x1088, 640x368, one MB row, one MB column and 48x32; the card
runs the kernels at the same geometries in ``tests/test_torch_cuda.py``.

H1 and H2's split design (``csrc/h264_levels.cu``): its scratch record's
size and the offsets of its fields against the wrapper's
``LEVEL_RECORD_WORDS`` and ``levels_plan``'s grids at the same six
geometries; and a numpy model of its phases (A: what the left edge cannot
change, per MB; B: the chain along each MB row, the changed coefficients
as T(src) - T(pred) requantized, the costs of the unchanged levels
precomputed, the next edge from the right blocks' column-3 inverse only;
C: the intra MBs from their stored edges) equal to the JAX package's
``encode_p_levels`` and ``encode_levels`` (mode, levels, reconstruction;
tolerance 0) at 48x32 and 64x48, QPs 0, 30 and 51, on random, constant and
mixed content (runs of noise and of horizontal stripes between runs of the
moved reference), with and without a GDR band.  The JAX functions are compiled once a
shape (QP and band traced).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opencv_opencl_tpu.ops import h264_levels as jax_levels
from opencv_opencl_tpu_torch.ops import h264_levels as levels
from opencv_opencl_tpu_torch.ops.cuda import h264_deblock as kd
from opencv_opencl_tpu_torch.ops.cuda import h264_inter as ki
from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kl
from tests.test_torch_cuda import mixed_nv12

GEOMETRIES = [(2160, 3840), (1088, 1920), (368, 640), (16, 640), (368, 16), (32, 48)]
SEARCHES = [(8, 3, 1), (8, 3, 2), (8, 0, 1), (8, 1, 1), (4, 2, 1), (3, 2, 2), (2, 2, 2),
            (2, 0, 1), (11, 2, 2), (15, 0, 2)]
SHARED_LIMIT = 232448
INTER_CU = Path(ki.__file__).resolve().parents[2] / "csrc" / "h264_inter.cu"


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


@pytest.mark.parametrize("col", [0, 1, 2, 3, 13])
def test_packed_tile_quadrant_sads_equal_direct_sads(col):
    """H6's tile_sads<8, true>: each window row read once as 5 words
    shifted into 4, its per-byte differences summed into four quadrant sums
    a candidate (rows 0-7 / 8-15 x words 0-1 / 2-3), equals the four direct
    8x8 quadrant SADs of every candidate."""
    rng = np.random.default_rng(100 + col)
    win = rng.integers(0, 256, (23, 40), dtype=np.uint8)
    cur = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    cw = _words(cur)                                   # (16, 4)
    ww = _words(win)                                   # (23, 10)
    sh = (col & 3) * 8
    sads = np.zeros((8, 4), np.int64)
    for R in range(23):
        a = ww[R, col >> 2:(col >> 2) + 5]
        b = ((a[:4] | (a[1:] << 32)) >> sh) & 0xFFFFFFFF   # __funnelshift_r
        for d in range(8):
            r = R - d
            if 0 <= r < 16:
                sads[d, 2 * (r >> 3)] += _sad4(cw[r, :2], b[:2]).sum()
                sads[d, 2 * (r >> 3) + 1] += _sad4(cw[r, 2:], b[2:]).sum()
    for d in range(8):
        diff = np.abs(cur.astype(np.int64) - win[d:d + 16, col:col + 16])
        want = [diff[:8, :8].sum(), diff[:8, 8:].sum(), diff[8:, :8].sum(), diff[8:, 8:].sum()]
        assert sads[d].tolist() == want


# H6's searches: (search, sub-pel mode, references)
PARTS_SEARCHES = [(8, 0, 1), (8, 1, 1), (4, 2, 1), (8, 0, 2), (8, 1, 2), (4, 2, 2)]


@pytest.mark.parametrize("search,subpel,nrefs", PARTS_SEARCHES)
def test_parts_tiles_hold_every_candidate_once(search, subpel, nrefs):
    P, _ = levels.search_plan(search, subpel)
    slots, tiles = ki.search_tiles(search, subpel, nrefs)
    got = []
    for slot, frac, a0, axc in tiles.tolist():
        cnt = axc & 15
        ax, fy, fx = (axc - cnt) // 16, frac >> 2, frac & 3
        r, plane = divmod(int(slots[slot]), P)
        assert plane == levels._plane_of(fy, fx, P) and 1 <= cnt <= ki.TILE_ROWS
        assert 0 <= a0 + search and a0 + search + cnt - 1 + 16 <= 2 * search + 16
        got += [(r, 4 * (a0 + d) + fy, 4 * ax + fx) for d in range(cnt)]
    cands = [tuple(c) for c in levels.search_candidates(search, subpel).tolist()]
    assert sorted(got) == sorted((r, qy, qx) for r in range(nrefs) for qy, qx in cands)
    # the key sad * 8192 + r * n + idx stays below 2^31
    assert nrefs * len(cands) <= 8192
    assert 65280 * 8192 + nrefs * len(cands) - 1 < 2 ** 31


@pytest.mark.parametrize("h,w", GEOMETRIES)
@pytest.mark.parametrize("search,subpel,nrefs", PARTS_SEARCHES)
def test_parts_plan(h, w, search, subpel, nrefs):
    mb_w = w // 16
    plan = ki.parts_plan_of(mb_w, search, subpel, nrefs)
    mbs = plan["mbs"]
    assert 1 <= mbs <= min(ki.SEARCH_MBS, mb_w)
    assert (plan["blocks_x"] - 1) * mbs < mb_w <= plan["blocks_x"] * mbs
    assert plan["threads"] == ki.SEARCH_THREADS
    # the kernel's layout: each MB's samples, nine keys and four winners
    # (24 ints), then every slot's window as H4 stages it
    pitch = (16 * mbs + 2 * search + 34 + 15) // 16 * 16
    assert plan["shared"] == ki.parts_shared_bytes(mbs, search, plan["slots"]) == \
        (256 + 96) * mbs + plan["slots"] * (2 * search + 16) * pitch
    assert plan["shared"] % 16 == 0 and (256 + 96) * mbs % 16 == 0
    assert plan["shared"] <= SHARED_LIMIT
    assert mbs == 1 or plan["shared"] <= ki.SEARCH_SHARED_BUDGET
    assert plan["slots"] == nrefs * len(ki._fractions(subpel)) ** 2
    # a tile's words stay inside its window row
    assert 16 * (mbs - 1) + 2 * search + 15 + 19 < pitch
    if (search, subpel, nrefs) == (8, 0, 1) and mb_w == 240:
        assert mbs == 5                    # 51 tiles a MB fill 255 of 256 threads


def test_parts_shared_layout_is_the_kernels():
    """The wrapper's byte count of a MB's keys and winners is the .cu's."""
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", INTER_CU.read_text())}
    assert 256 + 4 * consts["kPartsInfo"] == ki.parts_shared_bytes(1, 0, 0)
    assert consts["kPartsInfo"] >= 9 + 3 * 4


# ------------------------------------------------------- H3 sub-pel planes --

TAPS = np.array([1, -5, 20, 20, -5, 1], np.int64)


def _kernel_plane_ops() -> np.ndarray:
    """kPlaneOps of csrc/h264_inter.cu: plane e = the rounding average of
    operands (a, b)."""
    body = re.search(r"kPlaneOps\[16\]\[2\] = \{(.*?)\};", INTER_CU.read_text(), re.S)
    pairs = re.findall(r"\{(\d+), (\d+)\}", body.group(1))
    return np.array(pairs, np.int64).reshape(16, 2)


def model_planes(ry: np.ndarray, margin: int, nplanes: int, addr0: int = 0):
    """A numpy model of subpel_planes_kernel, block by block: the clamped
    reference tile of 13 x 517 samples, the vertical sums once a sample,
    b, h and j by runs of 16 positions from 21 samples and 21 sums, then a
    warp a (plane, row): lane u the u-th 16-byte unit of the flat plane
    (planes laid out from byte address ``addr0``) that lies wholly in the
    row and starts in the block's 496 columns, the head and tail bytes
    singly.  Returns the planes and how often each byte was written."""
    H, W = ry.shape
    plan = ki.planes_plan(H, W, margin, nplanes)
    rows, cols = plan["rows"], plan["cols"]
    BR, BC, run = ki.PLANE_BASE_ROWS, ki.PLANE_BASE_COLS, 16
    oh, ow = H + 2 * margin, W + 2 * margin
    plane_bytes = oh * ow
    ops = _kernel_plane_ops()
    entry = {1: [0], 4: [0, 2, 8, 10], 16: list(range(16))}[nplanes]
    out = np.zeros((nplanes, oh, ow), np.uint8)
    writes = np.zeros((nplanes, oh, ow), np.int64)
    lanes = np.arange(32)
    for by in range(plan["blocks_y"]):
        for bx in range(plan["blocks_x"]):
            r0, c0 = by * rows, bx * cols
            ty = np.clip(r0 - margin - 2 + np.arange(BR + 5), 0, H - 1)
            tx = np.clip(c0 - margin - 2 + np.arange(BC + 5), 0, W - 1)
            stage = ry[ty][:, tx].astype(np.int64)                 # (13, 517)
            vsum = sum(TAPS[k] * stage[k:k + BR] for k in range(6))  # (8, 517), once
            # runs: x0 = 16 k, 21 samples and 21 sums each
            idx = run * np.arange(BC // run)[:, None] + np.arange(run + 5)[None]
            g = stage[2:2 + BR][:, idx]                            # (8, 32, 21)
            v = vsum[:, idx]
            bb = np.clip((sum(TAPS[k] * g[..., k:k + run] for k in range(6)) + 16) >> 5, 0, 255)
            hh = np.clip((v[..., 2:2 + run] + 16) >> 5, 0, 255)
            jj = np.clip((sum(TAPS[k] * v[..., k:k + run] for k in range(6)) + 512) >> 10,
                         0, 255)
            b, h, j = (x.reshape(BR, BC) for x in (bb, hh, jj))
            # the operands at block position (y, x): G, b, h, j, Gr, m, Gd, s
            operand = [lambda y, x: stage[y + 2, x + 2], lambda y, x: b[y, x],
                       lambda y, x: h[y, x], lambda y, x: j[y, x],
                       lambda y, x: stage[y + 2, x + 3], lambda y, x: h[y, x + 1],
                       lambda y, x: stage[y + 3, x + 2], lambda y, x: b[y + 1, x]]

            def value(p, y, x):
                a, c = ops[entry[p]]
                return ((operand[a](y, x) + operand[c](y, x) + 1) >> 1).astype(np.uint8)

            for p in range(nplanes):
                for y in range(rows):
                    r = r0 + y
                    if r >= oh:
                        continue
                    hb = min(-(addr0 + p * plane_bytes + r * ow) % 16, ow)
                    nu = (ow - hb) // 16
                    tail = hb + 16 * nu
                    u = ((c0 - hb + 15) // 16 if c0 > hb else 0) + lanes
                    c = hb + 16 * u
                    ok = (lanes < cols // 16) & (u < nu) & (c < c0 + cols)
                    cc = c[ok][:, None] + np.arange(16)[None]
                    out[p, r, cc] = value(p, y, cc - c0)
                    np.add.at(writes[p, r], cc.ravel(), 1)
                    single = []
                    if c0 == 0:
                        single += list(range(hb))
                    if c0 <= tail < c0 + cols:
                        single += list(range(tail, ow))
                    if single:
                        cs = np.array(single)
                        out[p, r, cs] = value(p, y, cs - c0)
                        np.add.at(writes[p, r], cs, 1)
    return out, writes


# (H, W): a width whose plane rows are no multiple of 4 (and of the 496
# columns a block), one MB row, one MB column, a one-row and a one-column
# picture; (margin, planes): relay (k)'s full-pel stack, half-pel, quarter-pel
PLANE_SHAPES = [(40, 1919), (16, 640), (64, 16), (1, 37), (29, 1)]
PLANE_MODES = [(8, 1), (5, 4), (9, 16)]


@pytest.mark.parametrize("addr0", [0, 5])
@pytest.mark.parametrize("margin,nplanes", PLANE_MODES)
@pytest.mark.parametrize("h,w", PLANE_SHAPES)
def test_planes_model_writes_every_byte_once_and_equals_plain(h, w, margin, nplanes, addr0):
    import torch

    rng = np.random.default_rng(h * 7919 + w + nplanes)
    ry = rng.integers(0, 256, (h, w), dtype=np.uint8)
    got, writes = model_planes(ry, margin, nplanes, addr0)
    assert (writes == 1).all()
    want = levels.subpel_planes_plain(torch.from_numpy(ry), margin, nplanes).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("margin,nplanes", PLANE_MODES)
def test_planes_model_equals_jax(margin, nplanes):
    rng = np.random.default_rng(nplanes)
    ry = rng.integers(0, 256, (24, 531), dtype=np.uint8)
    got, _ = model_planes(ry, margin, nplanes, 11)
    if nplanes == 1:
        want = jnp.pad(jnp.asarray(ry), margin, mode="edge")[None]
    else:
        want = (jax_levels.halfpel_planes_jax if nplanes == 4
                else jax_levels.quarterpel_planes_jax)(jnp.asarray(ry), margin)
    assert np.array_equal(got, np.asarray(want))


def test_planes_plan_is_the_kernels():
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+)[,;]", INTER_CU.read_text())}
    assert consts["kBaseRows"] == ki.PLANE_BASE_ROWS
    assert consts["kPlaneThreads"] == ki.PLANE_THREADS
    assert ki.PLANE_BASE_COLS == 32 * 16 and ki.PLANE_COLS == ki.PLANE_BASE_COLS - 16
    # a warp a row of 32 runs, a lane a unit
    assert ki.PLANE_THREADS == 32 * ki.PLANE_BASE_ROWS
    for n in (1, 4, 16):
        plan = ki.planes_plan(2160, 3840, 9, n)
        assert plan["rows"] == ki.PLANE_BASE_ROWS - (n == 16)
        assert plan["blocks_x"] == 8 and plan["blocks_y"] == -(-2178 // plan["rows"])


# ---------------------------------------------------- H1 / H2 split design --

# the record's fields (csrc/h264_levels.cu) and their int32 words
RECORD_FIELDS = {"kQ": 64, "kQc": 32, "kE": 64, "kU": 8, "kP": 2, "kEdgeP": 8, "kUsed": 8}
LEVELS_CU = Path(kl.__file__).resolve().parents[2] / "csrc" / "h264_levels.cu"


def test_split_record_fields_fit_the_wrappers_scratch():
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", LEVELS_CU.read_text())}
    assert consts["kRecWords"] == kl.LEVEL_RECORD_WORDS
    assert consts["kSplitWarps"] == kl.SPLIT_WARPS
    spans = sorted((consts[name], consts[name] + n) for name, n in RECORD_FIELDS.items())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))      # disjoint
    assert spans[-1][1] <= kl.LEVEL_RECORD_WORDS
    # every field is read with 16-byte loads (the edges as words) from
    # records that start 16-byte aligned
    assert all(consts[name] % 4 == 0 for name in RECORD_FIELDS)
    assert (4 * kl.LEVEL_RECORD_WORDS) % 16 == 0


def test_i4_record_extends_the_split_record():
    """With i4 the record adds each luma block's T(src) as 8 words of int16
    pairs and its cost: the wrapper's I4_RECORD_WORDS, 16-byte aligned."""
    text = LEVELS_CU.read_text()
    expr = dict(re.findall(r"constexpr int (kI4\w+|kRecWordsI4) = ([^;]+);", text))
    assert expr == {"kI4T": "kRecWords", "kI4Cost": "kI4T + 128",
                    "kRecWordsI4": "kI4Cost + 16"}
    assert kl.I4_RECORD_WORDS == kl.LEVEL_RECORD_WORDS + 16 * 8 + 16
    assert (4 * kl.I4_RECORD_WORDS) % 16 == 0 and (4 * kl.LEVEL_RECORD_WORDS) % 16 == 0


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_levels_plan(h, w):
    check_levels_plan(h, w, False)


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_levels_plan_i4(h, w):
    check_levels_plan(h, w, True)


def check_levels_plan(h, w, i4):
    mb_h, mb_w = h // 16, w // 16
    n = mb_h * mb_w
    plan = kl.levels_plan(mb_h, mb_w, i4)
    words = kl.I4_RECORD_WORDS if i4 else kl.LEVEL_RECORD_WORDS
    assert plan["record_words"] == words
    assert plan["scratch_words"] == words * n
    assert plan["scratch_bytes"] == 4 * plan["scratch_words"]
    for phase in ("split", "intra"):
        blocks, threads = plan[phase]
        assert threads == 32 * kl.SPLIT_WARPS <= 1024
        assert (blocks - 1) * kl.SPLIT_WARPS < n <= blocks * kl.SPLIT_WARPS
    assert plan["chain"] == (mb_h, 32)


CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], np.int64)
H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
H2 = np.array([[1, 1], [1, -1]], np.int64)
AC = np.ones((4, 4), bool)
AC[0, 0] = False
SGN = np.array([1, -1], np.int64)


def fwd(b):
    """The forward core transform of (..., 4, 4) rasters [y][x] -> [u][v]."""
    return np.einsum("uy,...yx,vx->...uv", CF, b, CF)


def quant(w, mf, f, qbits):
    q = (np.abs(w) * mf + f) >> qbits
    return np.clip(np.sign(w) * q, -levels._LEVEL_CLAMP, levels._LEVEL_CLAMP)


def cost(lv):
    a = np.abs(lv)
    return 2 * a + (a != 0)


def inv1d(d, axis):
    d0, d1, d2, d3 = np.moveaxis(d, axis, 0)
    e0, e1, e2, e3 = d0 + d2, d0 - d2, (d1 >> 1) - d3, d1 + (d3 >> 1)
    return np.moveaxis(np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3]), 0, axis)


def inv(d):
    return (inv1d(inv1d(d, -1), -2) + 32) >> 6


def had4(x):
    return np.einsum("ir,jc,...rc->...ij", H4, H4, x)


def had2(x):
    return np.einsum("ir,jc,...rc->...ij", H2, H2, x)


def blocks(plane, n):
    """(mh*n, mw*n) -> (mh, mw, n/4, n/4, 4, 4): MB, block row, column, y, x."""
    H, W = plane.shape
    k = n // 4
    return (plane.reshape(H // n, k, 4, W // n, k, 4).transpose(0, 3, 1, 4, 2, 5)
            .astype(np.int64))


def unblocks(b):
    mh, mw, k = b.shape[:3]
    return b.transpose(0, 2, 4, 1, 3, 5).reshape(mh * k * 4, mw * k * 4)


class Quant:
    """level_plan(qp) as numpy tables by coefficient position."""

    def __init__(self, qp):
        p = levels.level_plan(qp)
        pos = np.asarray(levels._POS_CLASS)
        self.qp, self.qpc, self.qb, self.qbc = p["qp"], p["qpc"], p["qbits"], p["qbits_c"]
        self.fy, self.fc = p["f_y"], p["f_c"]
        self.fyp, self.fcp = (1 << self.qb) // 6, (1 << self.qbc) // 6
        self.mfy, self.mfc = np.array(p["mf_y"])[pos], np.array(p["mf_c"])[pos]
        self.vy = np.array(p["v_y"])[pos] * (1 << (self.qp // 6))
        self.vc = np.array(p["v_c"])[pos] * (1 << (self.qpc // 6))

    def zdc(self, s):
        return quant(s, self.mfy[0, 0], 2 * self.fy, self.qb + 1)

    def czdc(self, s, f=None):
        return quant(s, self.mfc[0, 0], 2 * (self.fc if f is None else f), self.qbc + 1)

    def luma_dc(self, c):
        ls, k = 16 * self.vy[0, 0] // (1 << (self.qp // 6)), self.qp // 6
        if self.qp >= 36:
            return (c * ls) * (1 << (k - 6))
        return (c * ls + (1 << (5 - k))) >> (6 - k)

    def chroma_dc(self, c):
        return (c * (16 * self.vc[0, 0])) >> 5


def phase_a(q, y, cb, cr, pred=None):
    """The record: every number of an MB that its left edge cannot change."""
    Ys = blocks(y, 16)
    C = np.stack([blocks(cb, 8), blocks(cr, 8)], 2)     # (mh, mw, comp, by, bx, 4, 4)
    Ts = fwd(Ys)
    qs = quant(Ts, q.mfy, q.fy, q.qb)
    HT = had4(Ts[..., 0, 0])
    Zs = q.zdc(HT >> 1)
    cs, cz = cost(qs), cost(Zs)
    r = {"fixed_d": (cs * AC).sum((2, 3, 4, 5)) + cz.sum((2, 3)) - cz[..., 0, 0],
         "fixed_h": cs[..., 1:].sum((2, 3, 4, 5)) + cz[..., 1:].sum((2, 3)),
         "Zd": Zs[..., :, 0], "T0": Ts[..., 1:, 0], "HT0": HT[..., :, 0]}
    d3 = (qs * q.vy)[:, :, :, 3]                          # the right blocks: (.., by, u, v)
    r["K"] = d3[..., 2] - d3[..., 1] - (d3[..., 3] >> 1)
    r["Dd"] = d3[..., 1:, 0]
    r["IH"] = np.einsum("br,...r->...b", H4, np.einsum("c,...rc->...r", H4[3, 1:], Zs[..., 1:]))
    Tc = fwd(C)
    qc = quant(Tc, q.mfc, q.fc, q.qbc)
    HTc = had2(Tc[..., 0, 0])
    r["czfix"] = q.czdc(HTc[..., 1])
    cc, cf = cost(qc), cost(r["czfix"]).sum((2, 3))
    r["fixed_cdc"] = (cc * AC).sum((2, 3, 4, 5, 6)) + cf
    r["fixed_chh"] = cc[..., 1:].sum((2, 3, 4, 5, 6)) + cf
    d1 = (qc * q.vc)[:, :, :, :, 1]
    r["Kc"] = d1[..., 2] - d1[..., 1] - (d1[..., 3] >> 1)
    r["Ddc"] = d1[..., 1:, 0]
    r["Tc0"], r["HTc0"] = Tc[..., 1:, 0], HTc[..., 0]
    if pred is not None:
        Ps = blocks(pred[0], 16)
        Pc = np.stack([blocks(pred[1], 8), blocks(pred[2], 8)], 2)
        lz = quant(fwd(Ys - Ps), q.mfy, q.fyp, q.qb)
        Tpc = fwd(C - Pc)
        lzc = quant(Tpc, q.mfc, q.fcp, q.qbc) * AC
        czp = q.czdc(had2(Tpc[..., 0, 0]), q.fcp)
        r["cost_p"] = (cost(lz).sum((2, 3, 4, 5)) + cost(lzc).sum((2, 3, 4, 5, 6))
                       + cost(czp).sum((2, 3, 4)))
        ry = np.clip(inv(lz * q.vy) + Ps, 0, 255)
        dc = lzc * q.vc
        dc[..., 0, 0] = q.chroma_dc(had2(czp))
        rc = np.clip(inv(dc) + Pc, 0, 255)
        r["inter"] = (lz, czp, lzc, ry, rc)
        r["edge_y"] = ry[:, :, :, 3, :, 3].reshape(*ry.shape[:2], 16)
        r["edge_c"] = rc[:, :, :, :, 1, :, 3].reshape(*rc.shape[:3], 8)
    return r


def phase_b(q, r, mh, mw, chromah=False, mvz=None, inband=None, i4=None):
    """The chain along every row: the decisions and the left edge each MB
    was decided with; an intra MB's next edge from its right blocks' column
    3 alone.  With ``i4`` (an :class:`I4Chain`) each MB's Intra_4x4 trial
    after its I_16x16 step, and its luma edge where Intra_4x4 wins."""
    p_frame = mvz is not None
    e, c = np.zeros((mh, 16), np.int64), np.zeros((mh, 2, 8), np.int64)
    out = {k: np.zeros((mh, mw), bool) for k in ("use_h", "use_ch", "intra", "skip", "use_i4")}
    edges = np.zeros((mh, mw, 32), np.int64)
    for x in range(mw):
        left = x > 0
        edges[:, x, :16], edges[:, x, 16:] = e, c.reshape(mh, 16)
        eg, cg = e.reshape(mh, 4, 4), c.reshape(mh, 2, 2, 4)
        a, ac = eg @ CF.T, cg @ CF.T                      # CF of each block row's edge
        pd = (e.sum(1) + 8) >> 4 if left else np.full(mh, 128)
        vh = (cg.sum(-1) + 2) >> 2 if left else np.full((mh, 2, 2), 128)
        # the changed coefficients: T(src) - T(pred), requantized
        qh = quant(r["T0"][:, x] - 4 * a[:, :, None, 1:], q.mfy[1:, 0], q.fy, q.qb)
        zh = q.zdc((r["HT0"][:, x] - 16 * (a[:, :, 0] @ H4.T)) >> 1)
        zd0 = q.zdc((r["HT0"][:, x, 0] - 256 * pd) >> 1)
        cost_h = r["fixed_h"][:, x] + cost(qh).sum((1, 2, 3)) + cost(zh).sum(1)
        cost_d = r["fixed_d"][:, x] + cost(zd0)
        czd = q.czdc(r["HTc0"][:, x] - 32 * (vh[..., :1] + SGN * vh[..., 1:]))
        cost_cdc = r["fixed_cdc"][:, x] + cost(czd).sum((1, 2))
        qch = quant(r["Tc0"][:, x] - 4 * ac[:, :, :, None, 1:], q.mfc[1:, 0], q.fc, q.qbc)
        czh = q.czdc(r["HTc0"][:, x] - 8 * (ac[:, :, 0, :1] + SGN * ac[:, :, 1, :1]))
        cost_chh = r["fixed_chh"][:, x] + cost(qch).sum((1, 2, 3, 4)) + cost(czh).sum((1, 2))
        use_h = left & (cost_h < cost_d)
        use_ch = left & (cost_chh + 2 < cost_cdc) & chromah
        skip, intra = np.zeros(mh, bool), np.ones(mh, bool)
        if p_frame:
            cost_i = np.where(use_h, cost_h, cost_d) + cost_cdc + levels.INTRA_BIAS
            skip = (r["cost_p"][:, x] == 0) & mvz[:, x] & ~inband
            intra = (~skip & (cost_i < r["cost_p"][:, x])) | inband
        # the next edge of an intra MB
        zc = np.where(use_h[:, None], zh, np.concatenate([zd0[:, None], r["Zd"][:, x, 1:]], 1))
        hy = r["K"][:, x].copy()
        hy[..., 0] += q.luma_dc(r["IH"][:, x] + zc @ H4.T)
        hy[..., 1:] += np.where(use_h[:, None, None], qh[:, :, 3] * q.vy[1:, 0], r["Dd"][:, x])
        ey = np.clip(((inv1d(hy, -1) + 32) >> 6)
                     + np.where(use_h[:, None, None], eg, pd[:, None, None]), 0, 255)
        z0 = np.where(use_ch[:, None, None], czh, czd) - r["czfix"][:, x]
        hc = r["Kc"][:, x].copy()
        hc[..., 0] += q.chroma_dc(np.stack([z0[..., 0] + z0[..., 1], z0[..., 0] - z0[..., 1]], -1))
        hc[..., 1:] += np.where(use_ch[:, None, None, None], qch[:, :, :, 1] * q.vc[1:, 0],
                                r["Ddc"][:, x])
        ec = np.clip(((inv1d(hc, -1) + 32) >> 6)
                     + np.where(use_ch[:, None, None, None], cg, vh[..., None]), 0, 255)
        use_i4 = np.zeros(mh, bool)
        if i4 is not None:
            use_i4, e_i4 = i4.mb(x, e, left, np.where(use_h, cost_h, cost_d))
            ey = np.where(use_i4[:, None, None], e_i4.reshape(mh, 4, 4), ey)
        e, c = ey.reshape(mh, 16), ec.reshape(mh, 2, 8)
        if p_frame:
            e = np.where(intra[:, None], e, r["edge_y"][:, x])
            c = np.where(intra[:, None, None], c, r["edge_c"][:, x])
        for k, v in (("use_h", use_h), ("use_ch", use_ch), ("intra", intra), ("skip", skip),
                     ("use_i4", use_i4)):
            out[k][:, x] = v
    return out, edges


def phase_c(q, y, cb, cr, use_h, use_ch, edges):
    """Every MB's intra levels and reconstruction from its stored edge."""
    mh, mw = use_h.shape
    left = (np.arange(mw) > 0)[None, :]
    e, c = edges[..., :16], edges[..., 16:].reshape(mh, mw, 2, 8)
    pd = np.where(left, (e.sum(-1) + 8) >> 4, 128)
    py = np.where(use_h[..., None], e, pd[..., None]).reshape(mh, mw, 4, 1, 4, 1)
    t = fwd(blocks(y, 16) - py)
    acz = quant(t, q.mfy, q.fy, q.qb) * AC
    zdc = q.zdc(had4(t[..., 0, 0]) >> 1)
    d = acz * q.vy
    d[..., 0, 0] = q.luma_dc(had4(zdc))
    ry = np.clip(inv(d) + py, 0, 255)
    vh = np.where(left[..., None, None], (c.reshape(mh, mw, 2, 2, 4).sum(-1) + 2) >> 2, 128)
    pc = np.where(use_ch[..., None, None], c, np.repeat(vh, 4, -1)).reshape(mh, mw, 2, 2, 1, 4, 1)
    tc = fwd(np.stack([blocks(cb, 8), blocks(cr, 8)], 2) - pc)
    cacz = quant(tc, q.mfc, q.fc, q.qbc) * AC
    czdc = q.czdc(had2(tc[..., 0, 0]))
    dc = cacz * q.vc
    dc[..., 0, 0] = q.chroma_dc(had2(czdc))
    return zdc, acz, czdc, cacz, ry, np.clip(inv(dc) + pc, 0, 255)


def kernel_layout(zdc, acz, czdc, cacz, ry, rc):
    """The outputs in the wrappers' layouts: levels (mb_h, mb_w, ...), planes."""
    mh, mw = zdc.shape[:2]
    return (zdc.reshape(mh, mw, 16), acz.reshape(mh, mw, 16, 16), czdc.reshape(mh, mw, 2, 4),
            cacz.reshape(mh, mw, 2, 4, 16), unblocks(ry), unblocks(rc[:, :, 0]),
            unblocks(rc[:, :, 1]))


def split_model_levels(y, cb, cr, qp, chromah=False):
    """encode_levels(full_recon=True[, chromah]) by the three phases."""
    q, (mh, mw) = Quant(qp), (y.shape[0] // 16, y.shape[1] // 16)
    dec, edges = phase_b(q, phase_a(q, y, cb, cr), mh, mw, chromah)
    return (kernel_layout(*phase_c(q, y, cb, cr, dec["use_h"], dec["use_ch"], edges)),
            np.where(dec["use_h"], 1, 2), dec["use_ch"].astype(np.int64))


def kernel_i4_tables():
    """The ``.cu``'s Intra_4x4 lane tables: the groups' modes (kI4Modes) and
    the predictors (kI4Pred) as (neighbour, weight) taps, rounding, shift."""
    text = LEVELS_CU.read_text()
    modes = [int(v) for v in re.search(r"kI4Modes\[8\] = \{([^}]*)\}", text).group(1).split(",")]
    body = re.search(r"kI4Pred\[9\]\[16\] = \{(.*?)\};", text, re.S).group(1)
    words = np.array([int(v, 0) for v in re.findall(r"0x[0-9a-f]+|\b\d+\b", body)],
                     np.int64).reshape(9, 16)
    taps = np.stack([(words >> (6 * k)) & 15 for k in range(3)], -1)
    wgt = np.stack([(words >> (6 * k + 4)) & 3 for k in range(3)], -1)
    return modes, taps, wgt, (words >> 18) & 3, (words >> 20) & 3


def test_kernel_i4_tables_are_the_plain_predictors():
    modes, taps, wgt, rnd, shf = kernel_i4_tables()
    idx, w, r, sh = levels._I4_TABLES
    assert modes == [0, 1, 3, 4, 5, 6, 7, 8]
    assert np.array_equal(wgt, w) and np.array_equal(rnd, r) and np.array_equal(shf, sh)
    assert np.array_equal(np.where(wgt > 0, taps, 0), np.where(w > 0, idx, 0))


BUF_S = 17          # the chain's per-warp copy of the MB: (y + 1) * 17 + x + 1
Z_SCAN = [((z & 1) | ((z >> 1) & 2), ((z >> 1) & 1) | ((z >> 2) & 2)) for z in range(16)]
# the trial's wavefront steps (bx + 2 by), their sub-blocks in z indices
WAVE = [[0], [1], [4, 2], [5, 3], [6, 8], [7, 9], [12, 10], [13, 11], [14], [15]]


def test_i4_wave_is_the_kernels_and_decodes_each_block_after_its_neighbours():
    """The ``.cu``'s packed wave order equals WAVE; every sub-block comes
    after its left, top, top-left and (where available) top-right
    neighbours, and the two of a step are not neighbours."""
    text = LEVELS_CU.read_text()
    packed = int(re.search(r"\((0x[0-9a-f]+)ull >> \(4 \* \(\(t < 2", text).group(1), 16)
    seq = [(packed >> (4 * k)) & 15 for k in range(16)]
    assert seq == [z for step in WAVE for z in step]
    step_of = {z: t for t, step in enumerate(WAVE) for z in step}
    for z, (bx, by) in enumerate(Z_SCAN):
        tr = not (bx == 3 or (bx == 1 and by in (1, 3)))
        for nx, ny, need in ((bx - 1, by, True), (bx, by - 1, True), (bx - 1, by - 1, True),
                             (bx + 1, by - 1, tr)):
            if 0 <= nx < 4 and 0 <= ny < 4 and need:
                assert step_of[z_of(nx, ny)] < step_of[z], (z, nx, ny)


def z_of(bx, by):
    return (bx & 1) | ((by & 1) << 1) | ((bx & 2) << 1) | ((by & 2) << 2)


class I4Chain:
    """B's Intra_4x4 trial as the kernel runs it, every MB row at once, the
    sub-blocks in the wavefront's order (WAVE): 32 lanes, lane (g, u) of group g = lane // 4 holding mode kI4Modes[g] and
    pixel and coefficient row u; the prediction of its row from taps into
    the copy of the MB's reconstruction (row 0 zeros, column 0 the left
    edge), the row's CF, the column CF over the group, T(src) - T(pred)
    requantized, the group's cost; the DC mode every group's second
    candidate from A's T(src)[0][0] and cost of the rest; the warp's least
    key cost * 16 + mode; the winner's group reconstructing the block."""

    def __init__(self, q, Ts, mh, mw):
        modes, taps, wgt, rnd, shf = kernel_i4_tables()
        self.q, self.Ts, self.mh = q, Ts, mh
        self.pm = np.repeat(np.array(modes), 4).reshape(8, 4)          # [g][u]
        nb = taps[modes]                                                # (8, 16, 3)
        off = np.where(nb == 0, -BUF_S - 1, np.where(nb <= 8, -BUF_S + nb - 1,
                                                     (nb - 9) * BUF_S - 1))
        self.off = off.reshape(8, 4, 4, 3)
        self.offn = np.where((nb >= 5) & (nb <= 8), -BUF_S + 3, off).reshape(8, 4, 4, 3)
        self.w = wgt[modes].reshape(8, 4, 4, 3)
        self.rnd, self.shf = rnd[modes].reshape(8, 4, 4), shf[modes].reshape(8, 4, 4)
        qs = quant(Ts, q.mfy, q.fy, q.qb)
        self.cost_ac = (cost(qs) * AC).sum((-1, -2))                   # A's, (mh, mw, 4, 4)
        self.qs = qs
        self.buf = np.zeros((mh, 17 * BUF_S), np.int64)
        self.lm4 = np.full((mh, 4), 2, np.int64)
        self.acz = np.zeros((mh, mw, 4, 4, 4, 4), np.int64)             # by, bx, u, v
        self.modes = np.full((mh, mw, 16), 2, np.int64)
        self.recon = np.zeros((mh, mw, 16, 16), np.int64)

    def mb(self, x, e, left, cost16):
        q, mh, rows = self.q, self.mh, np.arange(self.mh)
        buf = self.buf
        buf[:, BUF_S::BUF_S][:, :16] = e                 # column 0: the left edge
        zm = np.zeros((mh, 16), np.int64)
        cost_i4 = np.zeros(mh, np.int64)
        levels_mb = np.zeros((mh, 4, 4, 4, 4), np.int64)
        for z in (z for step in WAVE for z in step):
            bx, by = Z_SCAN[z]
            base = (by * 4 + 1) * BUF_S + bx * 4 + 1
            tr = not (bx == 3 or (bx == 1 and by in (1, 3)))
            noleft = bx == 0 and not left
            ls = sum(buf[:, base + i * BUF_S - 1] for i in range(4))
            ts = sum(buf[:, base - BUF_S + i] for i in range(4))
            if by == 0:
                dc = np.full(mh, 128) if noleft else (ls + 2) >> 2
            else:
                dc = (ts + 2) >> 2 if noleft else (ts + ls + 4) >> 3
            off = self.off if tr else self.offn
            pr = ((buf[:, base + off] * self.w).sum(-1) + self.rnd) >> self.shf   # (mh, g, u, x)
            rowcf = pr @ CF.T                                   # the row's CF: [.., u=y][v]
            tp = np.einsum("uy,mgyv->mguv", CF, rowcf)          # the column CF over the group
            ts4 = self.Ts[:, x, by, bx]                         # (mh, u, v)
            mf = q.mfy
            lev = quant(ts4[:, None] - tp, mf, q.fy, q.qb)      # (mh, g, u, v)
            lc = cost(lev).sum((2, 3))                          # the group's cost
            if by == 0:
                predm = np.full(mh, 2)
            else:
                mB = zm[:, z_of(bx, by - 1)]
                predm = (np.minimum(zm[:, z_of(bx - 1, by)], mB) if bx > 0
                         else np.minimum(self.lm4[:, by], mB) if left else np.full(mh, 2))
            pm = self.pm[:, 0]
            valid = ((by > 0) | (pm == 1) | (pm == 8)) & ~(noleft & np.isin(pm, (1, 8, 4, 5, 6)))
            key_p = np.where(valid, (lc + np.where(predm[:, None] == pm, 1, 4)) * 16 + pm,
                             2 ** 31 - 1)
            qd = quant(ts4[:, 0, 0] - 16 * dc, q.mfy[0, 0], q.fy, q.qb)
            key_d = (self.cost_ac[:, x, by, bx] + cost(qd) + np.where(predm == 2, 1, 4)) * 16 + 2
            best = np.minimum(key_p.min(1), key_d)
            bm = best & 15
            cost_i4 += best >> 4
            zm[:, z] = bm
            dcw = bm == 2
            gs = np.where(dcw, 0, np.where(bm < 2, bm, bm - 1))
            qdc = self.qs[:, x, by, bx].copy()
            qdc[:, 0, 0] = qd
            sel = np.where(dcw[:, None, None], qdc, lev[rows, gs])
            pred = np.where(dcw[:, None, None], dc[:, None, None], pr[rows, gs])
            rec = np.clip(inv(sel * q.vy) + pred, 0, 255)
            for u in range(4):
                buf[:, base + u * BUF_S: base + u * BUF_S + 4] = rec[:, u]
            levels_mb[:, by, bx] = sel
        use_i4 = cost_i4 < cost16
        self.acz[:, x] = levels_mb
        self.modes[:, x] = np.where(use_i4[:, None], zm, 2)
        self.recon[:, x] = buf.reshape(mh, 17, BUF_S)[:, 1:, 1:]
        self.lm4 = np.where(use_i4[:, None], zm[:, [z_of(3, b) for b in range(4)]], 2)
        return use_i4, buf.reshape(mh, 17, BUF_S)[:, 1:, 16]


def i4_model_levels(y, cb, cr, qp, chromah=False):
    """encode_levels(i4=True, full_recon=True[, chromah]) by the three
    phases, B with the Intra_4x4 trial: (zdc, acz, czdc, cacz, ry, rcb, rcr),
    imode, i4modes (z-order), cmode."""
    q, (mh, mw) = Quant(qp), (y.shape[0] // 16, y.shape[1] // 16)
    r = phase_a(q, y, cb, cr)
    chain = I4Chain(q, fwd(blocks(y, 16)), mh, mw)
    dec, edges = phase_b(q, r, mh, mw, chromah, i4=chain)
    zdc, acz, czdc, cacz, ry, rc = phase_c(q, y, cb, cr, dec["use_h"], dec["use_ch"], edges)
    out = list(kernel_layout(zdc, acz, czdc, cacz, ry, rc))
    i4 = dec["use_i4"]
    out[0] = np.where(i4[..., None], 0, out[0])
    out[1] = np.where(i4[..., None, None], chain.acz.reshape(mh, mw, 16, 16), out[1])
    ry4 = chain.recon.transpose(0, 2, 1, 3).reshape(mh * 16, mw * 16)
    out[4] = np.where(np.repeat(np.repeat(i4, 16, 0), 16, 1), ry4, out[4])
    imode = np.where(i4, 0, np.where(dec["use_h"], 1, 2))
    return out, imode, chain.modes, dec["use_ch"].astype(np.int64)


def split_model_p_levels(y, cb, cr, ref, qp, band):
    """encode_p_levels at zero motion (every MB's (mv, ref) zero) by the
    three phases: mode, the levels and the reconstruction."""
    q, (mh, mw) = Quant(qp), (y.shape[0] // 16, y.shape[1] // 16)
    rows = np.arange(mh)
    r = phase_a(q, y, cb, cr, ref)
    dec, edges = phase_b(q, r, mh, mw, mvz=np.ones((mh, mw), bool),
                         inband=(rows >= band[0]) & (rows < band[1]))
    intra = kernel_layout(*phase_c(q, y, cb, cr, dec["use_h"], dec["use_ch"], edges))
    lz, czp, lzc, ryp, rcp = r["inter"]
    inter = kernel_layout(np.zeros_like(lz[..., 0, 0]), lz, czp, lzc, ryp, rcp)
    I = dec["intra"]
    mode = np.where(dec["skip"], 0, np.where(I, np.where(dec["use_h"], 3, 2), 1))
    lv = [np.where(I.reshape(mh, mw, *[1] * (a.ndim - 2)), a, b)
          for a, b in zip(intra[:4], inter[:4])]
    grid = lambda m, n: np.repeat(np.repeat(m, n, 0), n, 1)  # noqa: E731
    planes = [np.where(grid(I, n), a, b) for a, b, n in zip(intra[4:], inter[4:], (16, 8, 8))]
    return mode, *lv, *planes


def model_content(kind, h, w, seed):
    """An NV12 frame and the reference it is predicted from at zero motion:
    random, constant, or mixed (:func:`tests.test_torch_cuda.mixed_nv12` at
    runs of 2-3 MBs, predicted from its reference moved as its inter MBs
    are)."""
    rng = np.random.default_rng(seed)
    rows = h * 3 // 2
    if kind == "constant":
        f = np.full((rows, w), 77, np.uint8)
        return f, f.copy()
    if kind == "random":
        ref = rng.integers(0, 256, (rows, w), dtype=np.uint8)
        return rng.integers(0, 256, (rows, w), dtype=np.uint8), ref
    ref, cur = mixed_nv12(rng, h, w, runs=(2, 3))
    moved = np.roll(ref, (1, 2), (0, 1))
    moved[h:] = ref[h:]
    return cur, moved


def nv12_planes(frame, h):
    uv = frame[h:].reshape(h // 2, -1, 2)
    return frame[:h], np.ascontiguousarray(uv[..., 0]), np.ascontiguousarray(uv[..., 1])


MODEL_SHAPES = [(32, 48), (48, 64)]
MODEL_CONTENTS = ["random", "constant", "mixed"]


@pytest.fixture(scope="module")
def jax_programs():
    """encode_p_levels (the GDR band traced) and encode_levels with the full
    reconstruction (chromah static), compiled at first use a shape."""
    cache = {}

    def get(kind, shape):
        if (kind, shape) not in cache:
            if kind == "p":
                fn = (lambda y, cb, cr, ref, qp, band:
                      jax_levels.encode_p_levels(y, cb, cr, *ref, qp, gdr_band=band))
            else:
                fn = (lambda y, cb, cr, qp, ch=kind == "chromah":
                      jax_levels.encode_levels(y, cb, cr, qp, full_recon=True, chromah=ch))
            cache[(kind, shape)] = jax.jit(fn)
        return cache[(kind, shape)]

    return get


@pytest.mark.parametrize("content", MODEL_CONTENTS)
@pytest.mark.parametrize("h,w", MODEL_SHAPES)
def test_split_model_equals_jax_encode_p_levels(jax_programs, h, w, content):
    cur, ref = model_content(content, h, w, seed=h + w)
    y, cb, cr = nv12_planes(cur, h)
    refp = nv12_planes(ref, h)
    modes = set()
    for qp in (0, 30, 51):
        for band in ((0, 0), (1, 2)):
            got = split_model_p_levels(y, cb, cr, refp, qp, band)
            want = jax_programs("p", (h, w))(*map(jnp.asarray, (y, cb, cr)),
                                              tuple(map(jnp.asarray, refp)), jnp.int32(qp),
                                              tuple(jnp.int32(b) for b in band))
            names = ("mode", "zdc", "acz", "czdc", "cacz", "recon_y", "recon_cb", "recon_cr")
            for name, a in zip(names, got):
                b = np.asarray(getattr(want, name)).astype(np.int64)
                assert a.shape == b.shape and np.array_equal(a, b), (name, qp, band)
            modes |= set(got[0].ravel().tolist())
    if content == "mixed":
        assert modes == {0, 1, 2, 3}
    if content == "constant":
        assert 0 in modes


@pytest.mark.parametrize("content", MODEL_CONTENTS)
@pytest.mark.parametrize("h,w", MODEL_SHAPES)
def test_split_model_equals_jax_encode_levels(jax_programs, h, w, content):
    cur, _ = model_content(content, h, w, seed=h * w)
    y, cb, cr = nv12_planes(cur, h)
    for qp in (0, 30, 51):
        # chromah at the smaller shape: one more compile
        for chromah in (False, True) if (h, w) == MODEL_SHAPES[0] else (False,):
            got, imode, cmode = split_model_levels(y, cb, cr, qp, chromah)
            want = jax_programs("chromah" if chromah else "intra", (h, w))(
                *map(jnp.asarray, (y, cb, cr)), jnp.int32(qp))
            lv, ry, rcb, rcr, jimode = want[:5]
            for a, b in zip(got, (*lv, ry, rcb, rcr)):
                assert np.array_equal(a, np.asarray(b).astype(np.int64)), (qp, chromah)
            assert np.array_equal(imode, np.asarray(jimode))
            if chromah:
                assert np.array_equal(cmode, np.asarray(want[5]))


def test_level_wrappers_launch_only_on_the_card():
    """intra_levels and p_levels_into refuse CPU planes; encode_levels and
    encode_p_levels take the plain version for them: no launch is
    counted."""
    import torch

    kl.reset_launch_counts()
    y = torch.zeros((32, 48), dtype=torch.uint8)
    c = torch.zeros((16, 24), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        kl.intra_levels(y, c, c, 30, torch.zeros(kl.level_words(2, 3), dtype=torch.int16))
    with pytest.raises(ValueError, match="CUDA"):
        kl.p_levels_into(y, c, c, y, c, c, 30,
                         torch.zeros(kl.p_level_words(2, 3), dtype=torch.int16))
    kl.encode_levels(y, c, c, 30)
    kl.encode_levels(y, c, c, 30, i4=True, chromah=True)
    kl.encode_p_levels(y, c, c, y, c, c, 30)
    assert kl.launch_counts() == {"encode_levels": 0, "encode_p_levels": 0,
                                  "encode_levels_i4": 0}


def test_inter_wrappers_launch_only_on_the_card():
    """planes_into, planes_floor_into and parts_stack_into refuse CPU
    planes; subpel_planes and motion_search_parts take the plain version
    for them: no launch is counted."""
    import torch

    ki.reset_launch_counts()
    y = torch.zeros((32, 48), dtype=torch.uint8)
    c = torch.zeros((16, 24), dtype=torch.uint8)
    for fn in (ki.planes_into, ki.planes_floor_into):
        with pytest.raises(ValueError, match="CUDA"):
            fn(y, 3, 16, torch.empty((16, 38, 54), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        ki.parts_stack_into(y, torch.empty((1, 36, 52), dtype=torch.uint8), [(y, c, c)], 2, 0,
                            30, torch.empty((2, 3), dtype=torch.int16),
                            torch.empty((2, 3, 4, 2), dtype=torch.int16), None,
                            torch.empty_like(y), torch.empty_like(c), torch.empty_like(c))
    assert torch.equal(ki.subpel_planes(y, 3, 16), levels.subpel_planes_plain(y, 3, 16))
    got = ki.motion_search_parts(y, [(y, c, c)], 2, 1, 30)
    want = levels.motion_search_parts_plain(y, [(y, c, c)], 2, 1, 30)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))
    assert ki.launch_counts() == {"subpel_planes": 0, "motion_search": 0,
                                  "motion_search_parts": 0}


# ------------------------------------------------ H1 with i4: the chain --

I4_SHAPES = [(32, 48), (16, 64), (48, 16)]
I4_CONTENTS = ["structured", "random", "constant", "mixed"]


def i4_content(kind, h, w, seed):
    """An NV12 frame: a gradient with noise, noise, a constant, or mixed
    (:func:`tests.test_torch_cuda.mixed_nv12`)."""
    rng = np.random.default_rng(seed)
    if kind in ("random", "constant", "mixed"):
        return model_content(kind, h, w, seed)[0]
    yy, xx = np.mgrid[0:h * 3 // 2, 0:w]
    return ((xx * 2 + yy * 3 + rng.integers(0, 24, xx.shape)) % 256).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_i4():
    """encode_levels(i4=True, chromah=True, full_recon=True), QP traced:
    one compile (~30 s on the CPU)."""
    return jax.jit(lambda y, cb, cr, qp: jax_levels.encode_levels(
        y, cb, cr, qp, full_recon=True, i4=True, chromah=True))


@pytest.mark.parametrize("content", I4_CONTENTS)
def test_i4_model_equals_jax_encode_levels(jax_i4, content):
    h, w = I4_SHAPES[0]
    y, cb, cr = nv12_planes(i4_content(content, h, w, seed=7 + len(content)), h)
    for qp in (0, 26, 51):
        got, imode, i4modes, cmode = i4_model_levels(y, cb, cr, qp, chromah=True)
        want = jax_i4(*map(jnp.asarray, (y, cb, cr)), jnp.int32(qp))
        lv, ry, rcb, rcr, jimode, ji4, jcm = want
        for a, b in zip(got, (*lv, ry, rcb, rcr)):
            assert np.array_equal(a, np.asarray(b).astype(np.int64)), qp
        assert np.array_equal(imode, np.asarray(jimode))
        assert np.array_equal(i4modes, np.asarray(ji4))
        assert np.array_equal(cmode, np.asarray(jcm))


@pytest.mark.parametrize("content", I4_CONTENTS)
@pytest.mark.parametrize("h,w", I4_SHAPES)
def test_i4_model_equals_plain(h, w, content):
    """The model against ``encode_levels_plain(i4=True)`` with and without
    ``chromah`` and ``full_recon`` at QP 0, 26 and 51, at 48x32, one MB row
    and one MB column; mixed and structured content reach Intra_4x4 MBs and
    I_16x16 ones in one frame."""
    import torch

    y, cb, cr = nv12_planes(i4_content(content, h, w, seed=h * w + len(content)), h)
    kinds = set()
    for qp in (0, 26, 51):
        for chromah in (False, True):
            got, imode, i4modes, cmode = i4_model_levels(y, cb, cr, qp, chromah)
            for full_recon in (False, True):
                want = levels.encode_levels_plain(*map(torch.from_numpy, (y, cb, cr)), qp,
                                                  full_recon=full_recon, i4=True,
                                                  chromah=chromah)
                lv, rest = want[0], want[1:]
                model = list(got[:4]) + (list(got[4:]) if full_recon else [])
                plain = [t.numpy().astype(np.int64) for t in (*lv, *rest[:3 * full_recon])]
                rest = rest[3 * full_recon:]
                for a, b in zip(model, plain):
                    assert np.array_equal(a, b), (qp, chromah, full_recon)
                assert np.array_equal(imode, rest[0].numpy())
                assert np.array_equal(i4modes, rest[1].numpy())
                if chromah:
                    assert np.array_equal(cmode, rest[2].numpy())
            kinds |= set(imode.ravel().tolist())
    if content in ("mixed", "structured") and h * w > 16 * 16:
        assert 0 in kinds and kinds - {0}
