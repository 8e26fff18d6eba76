"""Frozen copy of the port's plain H.264 in-loop filter, the benchmark's
reference for H5.

Copied from ``opencv_opencl_tpu_torch/ops/h264_deblock.py`` (the plain
version and its helpers) with Tables 8-16 and 8-17 from
``opencv_opencl_tpu_torch/io/h264_deblock.py``; the entry point that
launches the kernel, the partitions' quadrant motion fields and the
slice-local filter are left out (no cell reaches them).  It imports nothing
of the port.  The source module's docstring follows.

H.264 in-loop deblocking (spec 8.7) on the card: the recon chain of the
device GOP encoder (counterpart of ``opencv_opencl_tpu/ops/h264_deblock.py``).

The oracle (``io/h264_deblock.py``) defines correctness; this module makes
the filtered reference picture computable on the card, so that the GOP
encoder's reconstruction chain never leaves device memory when the filter
is on.

The spec's per-MB raster order is a 2D wavefront: with V(i,j)/H(i,j) the
vertical/horizontal edge filtering of macroblock (i, j),

    full(i,j)  needs  full(i,j-1)   (left MB completely filtered),
                      full(i-1,j)   (top row completely filtered),
                      V(i-1,j+1)    (top-right V writes the top-left
                                     halo this MB's top edges read).

Scheduling MB (i, j) at step ``t = 2*i + j`` meets every constraint and
runs the picture in ``2*(mb_h-1) + mb_w`` steps with each anti-diagonal's
MBs filtered together.

:func:`deblock_planes` is the entry point.  On CUDA tensors it launches
``deblock_kernel`` (``csrc/h264_deblock.cu``: the boundary strengths first,
:func:`bs_words`, then a band of MB rows a block, two rows a warp; wrapper
``ops/cuda/h264_deblock.py``);
on CPU tensors it runs :func:`deblock_planes_plain`, the JAX function's
scan over the anti-diagonals as a Python loop, each step gathering one
20x20 luma and two 10x10 chroma patches a MB row, filtering the MB's four
vertical then four horizontal edges, and scattering them back.  All
arithmetic is int32 and exact: the planes equal the JAX function's and
``io.h264_deblock.deblock_picture``'s.
"""

from __future__ import annotations

import numpy as np
import torch

# Tables 8-16 and 8-17, copied from the port's io/h264_deblock.py
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


_QPC_TAB = np.array(
    list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                       37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
    dtype=np.int32)


def filter_params(qp: int) -> tuple[int, ...]:
    """The filter thresholds of one picture QP: (alpha, beta, tc0[bS 1..3])
    for luma at ``qp``, then for chroma at its table QP (spec Table 8-15,
    8-16, 8-17; filter offsets 0): 10 ints."""
    qp = min(max(int(qp), 0), 51)
    qpc = int(_QPC_TAB[qp])
    return (int(ALPHA[qp]), int(BETA[qp]), *(int(t) for t in TC0[:, qp]),
            int(ALPHA[qpc]), int(BETA[qpc]), *(int(t) for t in TC0[:, qpc]))


def nnz4_grid(acz: torch.Tensor) -> torch.Tensor:
    """The (mb_h*4, mb_w*4) grid of 4x4 luma blocks with a nonzero level,
    from a frame's chosen luma levels ``acz`` (mb_h, mb_w, 16 blocks
    by*4+bx, 16): the ``nnz4`` of a P frame's own metadata."""
    mb_h, mb_w = acz.shape[:2]
    return ((acz != 0).any(-1).reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3)
            .reshape(4 * mb_h, 4 * mb_w))


def bs_grids(intra: torch.Tensor, nnz4: torch.Tensor, mv: torch.Tensor,
             ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Boundary strengths on the 4x4 block grid (the JAX ``bs_grids``, the
    oracle's ``_bs_edges``): ``intra`` (mb_h, mb_w), ``nnz4`` (mb_h*4,
    mb_w*4), ``mv`` (mb_h, mb_w, 2) quarter-pel, ``ref`` (mb_h, mb_w).
    Returns (bs_v, bs_h), each (mb_h*4, mb_w*4) int32;
    entry [b, a] is the edge left of block column a / above block row b.
    Column / row 0 (the picture border) is 0."""
    intra4 = intra.to(torch.bool).repeat_interleave(4, 0).repeat_interleave(4, 1)
    mv4 = mv.to(torch.int32).repeat_interleave(4, 0).repeat_interleave(4, 1)
    ref4 = ref.to(torch.int32).repeat_interleave(4, 0).repeat_interleave(4, 1)
    nnz = nnz4.to(torch.bool)
    out = []
    for ax in (1, 0):
        p_intra = torch.roll(intra4, 1, ax)
        p_nnz = torch.roll(nnz, 1, ax)
        p_mv = torch.roll(mv4, 1, ax)
        p_ref = torch.roll(ref4, 1, ax)
        either = p_intra | intra4
        n4 = intra4.shape[ax]
        mb_edge = torch.arange(n4, device=intra.device) % 4 == 0
        mb_edge = mb_edge[None, :] if ax == 1 else mb_edge[:, None]
        mv_far = ((p_mv - mv4).abs() >= 4).any(2)
        bs = torch.where((p_ref != ref4) | mv_far, 1, 0)
        bs = torch.where(p_nnz | nnz, 2, bs)
        bs = torch.where(either, 3, bs)
        bs = torch.where(either & mb_edge, 4, bs).to(torch.int32)
        if ax == 1:
            bs[:, 0] = 0
        else:
            bs[0, :] = 0
        out.append(bs)
    return out[0], out[1]


def _edge_filter(slab: torch.Tensor, bs: torch.Tensor, alpha: int, beta: int,
                 tc0_vec: torch.Tensor, chroma: bool, mb_edge: bool) -> torch.Tensor:
    """Filter one edge: ``slab`` (n, 8) int32 [p3..p0 q0..q3] for luma or
    (n, 4) [p1 p0 q0 q1] for chroma, ``bs`` (n,).  Spec 8.7.2.3 / 8.7.2.4;
    ``(q0 - p0) << 2`` is written as a product.  Inside an MB (``mb_edge``
    false) bS is at most 3, so the strong filter is not evaluated."""
    if chroma:
        p1, p0, q0, q1 = slab.unbind(1)
    else:
        p3, p2, p1, p0, q0, q1, q2, q3 = slab.unbind(1)
    act = ((bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
           & ((q1 - q0).abs() < beta))
    tc0 = tc0_vec[torch.clamp(bs, 1, 3) - 1]
    strong = bs == 4
    if chroma:
        tc = tc0 + 1
        delta = torch.maximum(torch.minimum(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, tc), -tc)
        np0 = torch.clamp(p0 + delta, 0, 255)
        nq0 = torch.clamp(q0 - delta, 0, 255)
        if mb_edge:
            np0 = torch.where(strong, (2 * p1 + p0 + q1 + 2) >> 2, np0)
            nq0 = torch.where(strong, (2 * q1 + q0 + p1 + 2) >> 2, nq0)
        return torch.stack([p1, torch.where(act, np0, p0),
                            torch.where(act, nq0, q0), q1], 1)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.maximum(torch.minimum(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, tc), -tc)
    np0 = torch.clamp(p0 + delta, 0, 255)
    nq0 = torch.clamp(q0 - delta, 0, 255)
    avg = (p0 + q0 + 1) >> 1
    np1 = torch.where(ap, p1 + torch.maximum(torch.minimum(
        (p2 + avg - p1 * 2) >> 1, tc0), -tc0), p1)
    nq1 = torch.where(aq, q1 + torch.maximum(torch.minimum(
        (q2 + avg - q1 * 2) >> 1, tc0), -tc0), q1)
    new = [p2, np1, np0, nq0, nq1, q2]
    if mb_edge:
        small = (p0 - q0).abs() < ((alpha >> 2) + 2)
        sp, sq = ap & small, aq & small
        sp0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                          (2 * p1 + p0 + q1 + 2) >> 2)
        sp1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
        sp2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
        sq0 = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                          (2 * q1 + q0 + p1 + 2) >> 2)
        sq1 = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
        sq2 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
        new = [torch.where(strong, a, b) for a, b in
               zip((sp2, sp1, sp0, sq0, sq1, sq2), new)]
    old = [p2, p1, p0, q0, q1, q2]
    return torch.stack([p3] + [torch.where(act, n, o) for n, o in zip(new, old)]
                       + [q3], 1)


def _filter_mb(patch: torch.Tensor, bsv: torch.Tensor, bsh: torch.Tensor,
               alpha: int, beta: int, tc0_vec: torch.Tensor,
               chroma: bool) -> torch.Tensor:
    """The MB's edges over (L, 20, 20) luma patches (MB origin at (4, 4)) or
    (L, 10, 10) chroma patches (origin (2, 2)), lanes batched: vertical
    edges left to right, then horizontal ones top to bottom.  ``bsv`` /
    ``bsh`` are (L, segment, edge) / (L, edge, segment) (4, 4) grids;
    chroma edge e takes luma edge 2e, a segment two chroma lines."""
    L = patch.shape[0]
    o, n, reach = (2, 8, 2) if chroma else (4, 16, 4)
    rep = n // 4
    edges = (0, 2) if chroma else (0, 1, 2, 3)
    patch = patch.clone()
    for k, e in enumerate(edges):
        c = o + 4 * k
        bs = bsv[:, :, e].repeat_interleave(rep, 1).reshape(-1)
        slab = patch[:, o:o + n, c - reach:c + reach].reshape(-1, 2 * reach)
        out = _edge_filter(slab, bs, alpha, beta, tc0_vec, chroma, k == 0)
        patch[:, o:o + n, c - reach:c + reach] = out.reshape(L, n, 2 * reach)
    for k, e in enumerate(edges):
        r = o + 4 * k
        bs = bsh[:, e, :].repeat_interleave(rep, 1).reshape(-1)
        slab = patch[:, r - reach:r + reach, o:o + n].transpose(1, 2).reshape(-1, 2 * reach)
        out = _edge_filter(slab, bs, alpha, beta, tc0_vec, chroma, k == 0)
        patch[:, r - reach:r + reach, o:o + n] = out.reshape(L, n, 2 * reach).transpose(1, 2)
    return patch


def _check_deblock(y, cb, cr, intra, nnz4, mv, ref) -> tuple[int, int]:
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D uint8 tensor")
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
    H, W = y.shape
    if H % 16 or W % 16:
        raise ValueError("deblock_planes requires 16-aligned planes")
    mb_h, mb_w = H // 16, W // 16
    for name, t in (("cb", cb), ("cr", cr)):
        if tuple(t.shape) != (H // 2, W // 2):
            raise ValueError(f"{name} must be ({H // 2}, {W // 2})")
    for name, t, shape in (("intra", intra, (mb_h, mb_w)),
                           ("nnz4", nnz4, (4 * mb_h, 4 * mb_w)),
                           ("mv", mv, (mb_h, mb_w, 2)),
                           ("ref", ref, (mb_h, mb_w))):
        if tuple(t.shape) != shape or t.device != y.device:
            raise ValueError(f"{name} must be {shape} on {y.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return mb_h, mb_w


def deblock_planes_plain(y, cb, cr, qp: int, intra, nnz4, mv, ref):
    """Plain version of :func:`deblock_planes`, on the planes' device."""
    mb_h, mb_w = _check_deblock(y, cb, cr, intra, nnz4, mv, ref)
    H, W = y.shape
    dev = y.device
    al, bl, tl0, tl1, tl2, ac, bc, tc0, tc1, tc2 = filter_params(qp)
    tl = torch.tensor([tl0, tl1, tl2], dtype=torch.int32, device=dev)
    tc = torch.tensor([tc0, tc1, tc2], dtype=torch.int32, device=dev)
    bs_v, bs_h = bs_grids(intra, nnz4, mv, ref)
    # a halo of 4 (chroma 2) on every side, so that patches never leave
    # the padded planes; the halo is never filtered (bS 0 at the border)
    ypad = torch.nn.functional.pad(y.to(torch.int32), (4, 4, 4, 4))
    cpad = torch.nn.functional.pad(torch.stack([cb, cr]).to(torch.int32),
                                   (2, 2, 2, 2))
    lanes = torch.arange(mb_h, device=dev)
    r4, r10, r20 = (torch.arange(n, device=dev) for n in (4, 10, 20))
    for t in range(2 * (mb_h - 1) + mb_w):
        # the MBs (i, t - 2i) of the anti-diagonal: their patches never
        # overlap (row-disjoint two rows apart, column-disjoint one apart)
        i = lanes[(t - 2 * lanes >= 0) & (t - 2 * lanes < mb_w)]
        j = t - 2 * i
        brow = (4 * i[:, None] + r4)[:, :, None]
        bcol = (4 * j[:, None] + r4)[:, None, :]
        bsv, bsh = bs_v[brow, bcol], bs_h[brow, bcol]
        rows = (16 * i[:, None] + r20)[:, :, None]
        cols = (16 * j[:, None] + r20)[:, None, :]
        ypad[rows, cols] = _filter_mb(ypad[rows, cols], bsv, bsh, al, bl, tl, False)
        crows = (8 * i[:, None] + r10)[:, :, None]
        ccols = (8 * j[:, None] + r10)[:, None, :]
        n = len(i)
        cp = torch.cat([cpad[0][crows, ccols], cpad[1][crows, ccols]])
        cp = _filter_mb(cp, bsv.repeat(2, 1, 1), bsh.repeat(2, 1, 1), ac, bc, tc, True)
        cpad[0][crows, ccols] = cp[:n]
        cpad[1][crows, ccols] = cp[n:]
    return (ypad[4:4 + H, 4:4 + W].to(torch.uint8),
            cpad[0, 2:2 + H // 2, 2:2 + W // 2].to(torch.uint8),
            cpad[1, 2:2 + H // 2, 2:2 + W // 2].to(torch.uint8))


