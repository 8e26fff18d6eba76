"""H.264 in-loop deblocking filter (spec 8.7) — the Python oracle.

The reference's VCU streams are deblocked (omxh264enc defaults,
``OpenCVequalHist.cpp:313-315,325-327``); until round 4
every in-repo encoder forced ``disable_deblocking_filter_idc=1`` so the
decoded picture equalled the unfiltered reconstruction.  This module
closes that quality gap: it computes, bit-exactly, the picture every
conformant decoder displays when the filter is ON — so the encoders can
emit ``disable_deblocking_filter_idc=0`` and keep the repo's
byte-/bit-exactness contract (decoder output == ``deblock_picture`` of
the encoder reconstruction, proven through libavcodec in
tests/test_h264_deblock.py).

Scope matches the in-repo encoders' stream shapes: progressive 4:2:0
baseline, 16x16-partition-only MBs (Intra_16x16 / P_Skip / P_L0_16x16 /
intra-in-P), one QP per picture, filter offsets 0, idc=0 (filter across
the MB-row slice boundaries).  The spec tables below (alpha, beta, tC0
— Tables 8-16/8-17) were cross-checked byte-for-byte against the
ground-truth decoder binary this repo's conformance tests decode
through (libavcodec's alpha_table/beta_table/tc0_table), and every
entry that any QP can reach is exercised by the QP-sweep conformance
tests.

Ordering note (the part that fights TPU parallelism): MBs are filtered
in raster order; within an MB all vertical edges left-to-right, then
all horizontal edges top-to-bottom, each reading samples already
modified by earlier edges — including the left neighbor's horizontal
filtering and the top-RIGHT neighbor's vertical filtering.  That makes
the exact filter a 2D wavefront (full(i,j) needs full(i,j-1),
full(i-1,j) and V(i-1,j+1)); the device formulation lives in
ops/h264_levels.py, this module is the arbiter of correctness.

The port's own copy of ``opencv_opencl_tpu/io/h264_deblock.py``: the
same filter.
"""

from __future__ import annotations

import numpy as np

from opencv_opencl_tpu_torch.io.h264_cavlc import _QPC

__all__ = ["deblock_picture", "DeblockInfo", "ALPHA", "BETA", "TC0"]

# Table 8-16: alpha/beta thresholds as a function of indexA/indexB
# (== QP here: both filter offsets are emitted as 0).
ALPHA = np.array(
    [0] * 16 +
    [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
     40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
     226, 255, 255], dtype=np.int64)
BETA = np.array(
    [0] * 16 +
    [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
     11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int64)
# Table 8-17: tC0[bS-1][indexA] for bS in 1..3.
_TC0_ROWS = [
    (17, (0, 0, 1)), (21, (0, 1, 1)), (23, (1, 1, 1)), (27, (1, 1, 2)),
    (31, (1, 2, 3)), (33, (2, 2, 3)), (34, (2, 2, 4)), (35, (2, 3, 4)),
    (37, (3, 3, 5)), (38, (3, 4, 6)), (40, (4, 5, 7)), (41, (4, 5, 8)),
    (42, (4, 6, 9)), (43, (5, 7, 10)), (44, (6, 8, 11)), (45, (6, 8, 13)),
    (46, (7, 10, 14)), (47, (8, 11, 16)), (48, (9, 12, 18)),
    (49, (10, 13, 20)), (50, (11, 15, 23)), (51, (13, 17, 25)),
]
TC0 = np.zeros((3, 52), dtype=np.int64)
for _start, _vals in _TC0_ROWS:
    TC0[:, _start:] = np.array(_vals)[:, None]


class DeblockInfo:
    """Per-picture macroblock metadata the boundary-strength derivation
    (spec 8.7.2.1) needs, restricted to this repo's 16x16-only streams.

    ``intra``: (mb_h, mb_w) bool — MB coded as intra (IDR pictures are
    all-True; ``for_idr`` builds that).  ``nnz4``: (mb_h*4, mb_w*4)
    bool — the 4x4 luma block has nonzero coded transform levels (only
    consulted for inter MBs; P_Skip rows stay False).  ``mv``: (mb_h,
    mb_w, 2) int, the CODED motion vector field in quarter-pel units,
    (vertical, horizontal) — skips carry their predictor, intra rows
    are ignored.  ``ref``: (mb_h, mb_w) int ref_idx_l0 (one list, so
    index equality == picture equality)."""

    def __init__(self, mb_h: int, mb_w: int,
                 parts: bool = False) -> None:
        self.intra = np.zeros((mb_h, mb_w), dtype=bool)
        self.nnz4 = np.zeros((mb_h * 4, mb_w * 4), dtype=bool)
        # with ``parts``, mv/ref are QUADRANT-granular (2mb_h, 2mb_w
        # [, 2]) — sub-16x16 partitions carry per-8x8 motion, and the
        # bS derivation detects the granularity by shape
        g = 2 if parts else 1
        self.mv = np.zeros((mb_h * g, mb_w * g, 2), dtype=np.int64)
        self.ref = np.zeros((mb_h * g, mb_w * g), dtype=np.int64)

    @classmethod
    def for_idr(cls, mb_h: int, mb_w: int) -> "DeblockInfo":
        info = cls(mb_h, mb_w)
        info.intra[:] = True
        return info


def _bs_edges(info: DeblockInfo, vertical: bool) -> np.ndarray:
    """Boundary strengths for every 4-sample edge segment on the 4x4
    grid.  Returns (mb_h*4, mb_w*4) int; entry [b, a] is the bS of the
    edge on the LEFT of block column a (vertical=True) or ABOVE block
    row b (vertical=False) at block row/col b.  Column/row 0 is the
    picture edge (never filtered) and stays 0."""
    intra4 = np.repeat(np.repeat(info.intra, 4, axis=0), 4, axis=1)
    # mv/ref may be per-MB (repeat 4) or quadrant-granular (repeat 2
    # — the partition modes' per-8x8 motion)
    g = 4 if info.mv.shape[0] == info.intra.shape[0] else 2
    mv4 = np.repeat(np.repeat(info.mv, g, axis=0), g, axis=1)
    ref4 = np.repeat(np.repeat(info.ref, g, axis=0), g, axis=1)
    ax = 1 if vertical else 0
    p = {"intra": np.roll(intra4, 1, axis=ax),
         "nnz": np.roll(info.nnz4, 1, axis=ax),
         "mv": np.roll(mv4, 1, axis=ax),
         "ref": np.roll(ref4, 1, axis=ax)}
    q = {"intra": intra4, "nnz": info.nnz4, "mv": mv4, "ref": ref4}
    n4 = intra4.shape[ax]
    idx = np.arange(n4)
    mb_edge = (idx % 4 == 0)
    mb_edge_g = (mb_edge[None, :] if vertical else mb_edge[:, None])
    either_intra = p["intra"] | q["intra"]
    bs = np.zeros(intra4.shape, dtype=np.int64)
    mv_far = (np.abs(p["mv"] - q["mv"]) >= 4).any(axis=2)
    cond1 = (p["ref"] != q["ref"]) | mv_far
    bs[cond1] = 1
    bs[p["nnz"] | q["nnz"]] = 2
    bs[either_intra] = 3
    bs[either_intra & mb_edge_g] = 4
    # picture boundary: no edge
    if vertical:
        bs[:, 0] = 0
    else:
        bs[0, :] = 0
    return bs


def _filter_luma_edge(A: np.ndarray, B: np.ndarray, bs: np.ndarray,
                      alpha: int, beta: int,
                      tc0_col: np.ndarray) -> None:
    """Filter one luma edge in place.  ``A`` is the p side, columns
    [p3 p2 p1 p0]; ``B`` the q side, [q0 q1 q2 q3]; both (n, 4) views
    into the picture.  ``bs`` is the per-sample boundary strength (n,)
    and ``tc0_col`` maps bS (1..3) -> tC0 at this picture's indexA.
    All reads happen before any write (spec: the filtered outputs are
    computed from the input sample values)."""
    p3, p2, p1, p0 = (A[:, 0].copy(), A[:, 1].copy(), A[:, 2].copy(),
                      A[:, 3].copy())
    q0, q1, q2, q3 = (B[:, 0].copy(), B[:, 1].copy(), B[:, 2].copy(),
                      B[:, 3].copy())
    act = ((bs > 0) & (np.abs(p0 - q0) < alpha)
           & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    if not act.any():
        return
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta
    # ---- bS < 4 (8.7.2.3)
    norm = act & (bs < 4)
    tc0 = tc0_col[np.clip(bs, 1, 3) - 1]
    tc = tc0 + ap.astype(np.int64) + aq.astype(np.int64)
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = np.clip(p0 + delta, 0, 255)
    nq0 = np.clip(q0 - delta, 0, 255)
    np1 = p1 + np.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1,
                       -tc0, tc0)
    nq1 = q1 + np.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1,
                       -tc0, tc0)
    A[norm, 3] = np0[norm]
    B[norm, 0] = nq0[norm]
    m = norm & ap
    A[m, 2] = np1[m]
    m = norm & aq
    B[m, 1] = nq1[m]
    # ---- bS == 4 (8.7.2.4)
    strong = act & (bs == 4)
    if strong.any():
        small = np.abs(p0 - q0) < ((alpha >> 2) + 2)
        sp = strong & ap & small
        wp = strong & ~(ap & small)
        A[sp, 3] = ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)[sp]
        A[sp, 2] = ((p2 + p1 + p0 + q0 + 2) >> 2)[sp]
        A[sp, 1] = ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)[sp]
        A[wp, 3] = ((2 * p1 + p0 + q1 + 2) >> 2)[wp]
        sq = strong & aq & small
        wq = strong & ~(aq & small)
        B[sq, 0] = ((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)[sq]
        B[sq, 1] = ((q2 + q1 + q0 + p0 + 2) >> 2)[sq]
        B[sq, 2] = ((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)[sq]
        B[wq, 0] = ((2 * q1 + q0 + p1 + 2) >> 2)[wq]


def _filter_chroma_edge(A: np.ndarray, B: np.ndarray, bs: np.ndarray,
                        alpha: int, beta: int,
                        tc0_col: np.ndarray) -> None:
    """Chroma edge (8.7.2.3/2.4 with chromaStyleFilteringFlag): ``A``
    columns [p1 p0], ``B`` [q0 q1]; only p0/q0 are written, tc = tc0+1,
    bS=4 uses the short strong form unconditionally."""
    p1, p0 = A[:, 0].copy(), A[:, 1].copy()
    q0, q1 = B[:, 0].copy(), B[:, 1].copy()
    act = ((bs > 0) & (np.abs(p0 - q0) < alpha)
           & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    if not act.any():
        return
    norm = act & (bs < 4)
    tc = tc0_col[np.clip(bs, 1, 3) - 1] + 1
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    A[norm, 1] = np.clip(p0 + delta, 0, 255)[norm]
    B[norm, 0] = np.clip(q0 - delta, 0, 255)[norm]
    strong = act & (bs == 4)
    A[strong, 1] = ((2 * p1 + p0 + q1 + 2) >> 2)[strong]
    B[strong, 0] = ((2 * q1 + q0 + p1 + 2) >> 2)[strong]


def deblock_picture(ry: np.ndarray, rcb: np.ndarray, rcr: np.ndarray,
                    qp: int, info: DeblockInfo | None = None,
                    slice_local_rows: bool = False
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply the in-loop filter to one reconstructed picture and return
    the filtered (Y, Cb, Cr) — the picture a conformant decoder
    displays AND the one P frames must reference.  ``info=None`` means
    an all-intra (IDR) picture.  Planes must be 16-aligned (the padded
    encode geometry); inputs are not modified.

    ``slice_local_rows=True`` is ``disable_deblocking_filter_idc=2``
    for this repo's one-slice-per-MB-row pictures (the GDR stream
    shape): edges that coincide with slice boundaries — every
    horizontal MB-row edge — are not filtered (spec 8.7,
    filterTopMbEdgeFlag), so no sample ever crosses an MB-row boundary
    and the GDR refresh wave cannot bleed unrefreshed pixels into the
    clean region."""
    h, w = ry.shape
    if h % 16 or w % 16:
        raise ValueError("deblock_picture requires 16-aligned planes")
    mb_h, mb_w = h // 16, w // 16
    if info is None:
        info = DeblockInfo.for_idr(mb_h, mb_w)
    qp = int(qp)
    qpc = _QPC[min(max(qp, 0), 51)]
    al, bl, tl = int(ALPHA[qp]), int(BETA[qp]), TC0[:, qp]
    ac, bc, tc = int(ALPHA[qpc]), int(BETA[qpc]), TC0[:, qpc]
    bs_v = _bs_edges(info, vertical=True)
    bs_h = _bs_edges(info, vertical=False)
    if slice_local_rows:
        # every MB-row boundary is a slice boundary: kill the
        # horizontal MB edges (block rows 0 mod 4); the co-located
        # chroma edges read the same zeroed rows
        bs_h[::4, :] = 0
    y = ry.astype(np.int64, copy=True)
    cb = rcb.astype(np.int64, copy=True)
    cr = rcr.astype(np.int64, copy=True)
    for mby in range(mb_h):
        for mbx in range(mb_w):
            y0, x0 = mby * 16, mbx * 16
            # luma vertical edges, left to right
            for e in range(4):
                if e == 0 and mbx == 0:
                    continue
                x = x0 + e * 4
                bs = np.repeat(bs_v[mby * 4:mby * 4 + 4, x // 4], 4)
                if bs.any():
                    _filter_luma_edge(y[y0:y0 + 16, x - 4:x],
                                      y[y0:y0 + 16, x:x + 4],
                                      bs, al, bl, tl)
            # luma horizontal edges, top to bottom (transposed views)
            for e in range(4):
                if e == 0 and mby == 0:
                    continue
                yy = y0 + e * 4
                bs = np.repeat(bs_h[yy // 4, mbx * 4:mbx * 4 + 4], 4)
                if bs.any():
                    _filter_luma_edge(y[yy - 4:yy, x0:x0 + 16].T,
                                      y[yy:yy + 4, x0:x0 + 16].T,
                                      bs, al, bl, tl)
            # chroma edges: two per direction, bS from the co-located
            # luma segments (chroma x -> luma 2x)
            cy0, cx0 = mby * 8, mbx * 8
            for plane in (cb, cr):
                for e in (0, 1):
                    if e == 0 and mbx == 0:
                        continue
                    xc = cx0 + e * 4
                    seg = bs_v[mby * 4:mby * 4 + 4, (2 * xc) // 4]
                    bs = np.repeat(seg, 2)
                    if bs.any():
                        _filter_chroma_edge(
                            plane[cy0:cy0 + 8, xc - 2:xc],
                            plane[cy0:cy0 + 8, xc:xc + 2],
                            bs, ac, bc, tc)
                for e in (0, 1):
                    if e == 0 and mby == 0:
                        continue
                    yc = cy0 + e * 4
                    seg = bs_h[(2 * yc) // 4, mbx * 4:mbx * 4 + 4]
                    bs = np.repeat(seg, 2)
                    if bs.any():
                        _filter_chroma_edge(
                            plane[yc - 2:yc, cx0:cx0 + 8].T,
                            plane[yc:yc + 2, cx0:cx0 + 8].T,
                            bs, ac, bc, tc)
    return y, cb, cr
