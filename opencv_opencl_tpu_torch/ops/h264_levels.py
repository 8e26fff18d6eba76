"""H.264 CAVLC quantized levels on the card (counterpart of
``opencv_opencl_tpu/ops/h264_levels.py``).

The arithmetic of the CAVLC intra encoder: prediction (I_16x16 DC and
HORIZONTAL, optionally Intra_4x4 and chroma HORIZONTAL), the 4x4 integer
transforms, the DC Hadamards, quantization and reconstruction, with one
slice per MB row, so that the top neighbour is never available and the
only dependency left is the reconstructed right edge of the macroblock to
the left.  The host keeps the entropy coding
(``native.cavlc_entropy_rows`` or ``io.h264_cavlc.encode_frame_from_levels``).

:func:`encode_levels` is the intra entry point.  On a CUDA tensor it launches
H1's three grids (``csrc/h264_levels.cu``: ``levels_split_kernel``, a warp
an MB for what the left edge cannot change; ``levels_chain_kernel``, a warp
an MB row walking its columns along the left edges; ``levels_intra_kernel``,
a warp an MB; with ``i4`` the one grid ``intra_levels_kernel``, a block an
MB row; wrapper ``ops/cuda/h264_levels.py``) or raises; on
a CPU tensor it runs :func:`encode_levels_plain`, a port of the JAX
function's ``lax.scan`` step as a Python loop over the MB columns,
vectorised over the MB rows, line by line but for the Intra_4x4 trial,
which evaluates the nine candidate modes of a sub-block at once from a
table of the spec's predictor formulas (a loop over the modes launches
thousands of small ops a column on the card).  All arithmetic is int32 and exact: the
levels, modes and reconstructions equal the JAX function's, and a stream
entropy-coded from them equals ``CavlcH264Encoder(slices=mb_h)``'s byte
for byte.

The P part (the device GOP encoder's frames between IDRs):
:func:`subpel_planes` (the spec 8.4.2.2.1 sub-sample planes,
``subpel_planes_kernel``), :func:`motion_search` (per-MB SAD search and
motion compensation, ``motion_search_kernel`` after the planes; with
partitions :func:`motion_search_parts`, ``parts_search_kernel``) and
:func:`encode_p_levels` (the per-MB skip / inter / intra decision, the
chosen levels and the reconstruction, H2: H1's three grids with the inter
candidate, after the search), each beside its plain version (``*_plain``),
which the wrappers
of ``ops/cuda/h264_inter.py`` and ``ops/cuda/h264_levels.py`` run for CPU
tensors only.  Their streams equal ``GopCavlcEncoder(slices=mb_h)``'s.

The tables are the port's own copies of the JAX module's (and of
``io/h264_cavlc.py``'s, the oracle's).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the search's contract with the host oracle: the candidate order, the
# selection key sad * SEARCH_KEY_RADIX + index, the key of a candidate the
# GDR clean-region rule excludes, and the rows an MC block reads below its
# bottom sample by vertical quarter fraction
from opencv_opencl_tpu_torch.io.h264_inter import (
    _BAD_KEY, _MC_ROW_EXT, FASTSUB_OFFSETS, PART_LAMBDA, SEARCH_KEY_RADIX,
    search_candidates_qpel)

__all__ = ["LevelArrays", "encode_levels", "encode_levels_plain",
           "encode_levels_nv12", "level_plan", "PACKED_LANES", "pack_levels",
           "unpack_levels_host", "INTRA_BIAS", "PLevelArrays",
           "subpel_planes", "subpel_planes_plain", "halfpel_planes",
           "quarterpel_planes", "motion_search", "motion_search_plain",
           "search_stack_plain", "motion_search_parts",
           "motion_search_parts_plain", "parts_stack_plain",
           "encode_p_levels", "encode_p_levels_plain", "p_levels_plain"]

# _MF/_V per qp%6 by coefficient-position class; position-class matrix;
# chroma QP mapping (spec Table 8-15); level clamp for the 12-bit CAVLC
# escape
_MF_TAB = np.array([(13107, 5243, 8066), (11916, 4660, 7490),
                    (10082, 4194, 6554), (9362, 3647, 5825),
                    (8192, 3355, 5243), (7282, 2893, 4559)], np.int32)
_V_TAB = np.array([(10, 16, 13), (11, 18, 14), (13, 20, 16),
                   (14, 23, 18), (16, 25, 20), (18, 29, 23)], np.int32)
_POS_CLASS = np.full((4, 4), 2, np.int32)
_POS_CLASS[::2, ::2] = 0
_POS_CLASS[1::2, 1::2] = 1
_QPC_TAB = np.array(list(range(30)) +
                    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                     36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
                    np.int32)
_LEVEL_CLAMP = 2063

# z-scan of 4x4 luma blocks within a MB (oracle _BLOCK_SCAN): (bx, by)
_I4_SCAN = ((0, 0), (1, 0), (0, 1), (1, 1),
            (2, 0), (3, 0), (2, 1), (3, 1),
            (0, 2), (1, 2), (0, 3), (1, 3),
            (2, 2), (3, 2), (2, 3), (3, 3))
_I4_Z_OF = {bxby: z for z, bxby in enumerate(_I4_SCAN)}
# oracle _I4_MODE_BITS: flag-only vs flag+rem signaling cost proxy
_I4_MODE_BITS = (1, 4)


class LevelArrays(NamedTuple):
    """Quantized coefficients for every MB of a frame, raster layouts
    matching the native entropy coder's expectations (pre-zigzag), int16.

    Shapes (mb_h = rows of 16x16 macroblocks, mb_w = columns):
      zdc:  (mb_h, mb_w, 16)        luma DC, 4x4 raster [by*4+bx]
      acz:  (mb_h, mb_w, 16, 16)    luma AC per block [by*4+bx], 4x4
                                    raster coeffs, DC slot zeroed
      czdc: (mb_h, mb_w, 2, 4)      chroma DC per comp (cb, cr), 2x2
      cacz: (mb_h, mb_w, 2, 4, 16)  chroma AC per comp/block [by*2+bx]
    """

    zdc: torch.Tensor
    acz: torch.Tensor
    czdc: torch.Tensor
    cacz: torch.Tensor


def level_plan(qp: int) -> dict:
    """The quantizer constants of one QP, from the tables, as the JAX
    function computes them: per-position multipliers ``mf`` and dequant
    scales ``v`` by position class (luma ``_y``, chroma ``_c``), the
    rounding offsets ``f`` (intra: a third), ``qbits`` and the chroma QP."""
    qp = int(qp)
    if not 0 <= qp <= 51:
        raise ValueError(f"qp must be 0..51, got {qp}")
    qpc = int(_QPC_TAB[qp])
    qbits, qbits_c = 15 + qp // 6, 15 + qpc // 6
    return {"qp": qp, "qpc": qpc, "qbits": qbits, "qbits_c": qbits_c,
            "f_y": (1 << qbits) // 3, "f_c": (1 << qbits_c) // 3,
            "mf_y": [int(x) for x in _MF_TAB[qp % 6]],
            "mf_c": [int(x) for x in _MF_TAB[qpc % 6]],
            "v_y": [int(x) for x in _V_TAB[qp % 6]],
            "v_c": [int(x) for x in _V_TAB[qpc % 6]]}


# ------------------------------------------------- the plain version ----


def _cf1d(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward core transform matrix CF applied along ``axis`` (len 4):
    rows (1,1,1,1),(2,1,-1,-2),(1,-1,-1,1),(1,-2,2,-1)."""
    x0, x1, x2, x3 = x.unbind(axis)
    s0, s1 = x0 + x3, x1 + x2
    s2, s3 = x1 - x2, x0 - x3
    return torch.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], axis)


def _h1d(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Hadamard H4 along ``axis``: rows (1,1,1,1),(1,1,-1,-1),
    (1,-1,-1,1),(1,-1,1,-1)."""
    x0, x1, x2, x3 = x.unbind(axis)
    return torch.stack([x0 + x1 + x2 + x3, x0 + x1 - x2 - x3,
                        x0 - x1 - x2 + x3, x0 - x1 + x2 - x3], axis)


def _h2_2d(x: torch.Tensor) -> torch.Tensor:
    """H2 @ x @ H2 for trailing (2, 2) axes (chroma DC Hadamard)."""
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    return torch.stack([a + b + c + d, a - b + c - d,
                        a + b - c - d, a - b - c + d],
                       -1).reshape(*x.shape[:-2], 2, 2)


def _clip_sign(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sign(w) * q, -_LEVEL_CLAMP, _LEVEL_CLAMP)


def _quant(w: torch.Tensor, mf: torch.Tensor, f: int,
           qbits: int) -> torch.Tensor:
    """sign(w) * ((|w| * mf + f) >> qbits), clamped to the CAVLC escape
    range; ``w`` has block axes (..., by, r, bx, c), ``mf`` is (4, 4)."""
    q = (torch.abs(w) * mf[None, None, :, None, :] + f) >> qbits
    return _clip_sign(w, q)


def _inv4_2d(d: torch.Tensor) -> torch.Tensor:
    """Spec 8.5.12.3 inverse core transform on trailing (4, 4) axes, rows
    then columns (output residual << 6)."""

    def pass1(x, axis):
        d0, d1, d2, d3 = x.unbind(axis)
        e0, e1 = d0 + d2, d0 - d2
        e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
        return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis)

    return pass1(pass1(d, -1), -2)


def _inv_blocks(d: torch.Tensor) -> torch.Tensor:
    """Inverse-transform every 4x4 block of a (mb_h, by, r, bx, c) tensor;
    the rounded residual ((x + 32) >> 6)."""
    r = (_inv4_2d(d.permute(0, 1, 3, 2, 4)) + 32) >> 6
    return r.permute(0, 1, 3, 2, 4)


def _shl(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x << k`` for signed ``x``, written as a product."""
    return x * (1 << k)


def _luma_dc_dequant(f: torch.Tensor, qp: int) -> torch.Tensor:
    """Spec 8.5.10 (oracle _luma_dc_dequant)."""
    ls = 16 * int(_V_TAB[qp % 6, 0])
    k = qp // 6
    if qp >= 36:
        return _shl(f * ls, k - 6)
    return (f * ls + (1 << (5 - k))) >> (6 - k)


def _chroma_dc_dequant(f: torch.Tensor, qpc: int) -> torch.Tensor:
    """Spec 8.5.11.2: ((f * 16*V0) << qpc//6) >> 5."""
    ls = 16 * int(_V_TAB[qpc % 6, 0])
    return _shl(f * ls, qpc // 6) >> 5


def _cost_of(*arrays: torch.Tensor) -> torch.Tensor:
    """CAVLC bit-cost proxy: sum of 2|l| + (l != 0) over every coefficient,
    reduced over all but the leading MB-row axis (the oracle's
    io.h264_inter._cost; the mode decisions are part of the stream)."""
    total = 0
    for a in arrays:
        aa = torch.abs(a)
        total = total + (2 * aa + (aa != 0).to(torch.int32)).sum(
            dim=tuple(range(1, a.ndim)), dtype=torch.int32)
    return total


def _i4_terms(mode: int, yy: int, xx: int) -> tuple[list, int, int]:
    """The spec 8.3.1.2 Intra_4x4 predictor of mode ``mode`` (not 2) at
    (yy, xx) as ``(terms, round, shift)``: the prediction is
    ``(sum(weight * p[index]) + round) >> shift`` over the neighbours
    ``p = [corner, t8[0..7], l4[0..3]]`` (``t8`` the top row with the
    top-right substituted, ``l4`` the left column)."""

    def T(i):
        return 0 if i == -1 else 1 + i

    def L(i):
        return 0 if i == -1 else 9 + i

    c = 0
    if mode == 0:
        return [(T(xx), 1)], 0, 0
    if mode == 1:
        return [(L(yy), 1)], 0, 0
    if mode == 3:
        if xx == 3 and yy == 3:
            return [(T(6), 1), (T(7), 3)], 2, 2
        return [(T(xx + yy), 1), (T(xx + yy + 1), 2), (T(xx + yy + 2), 1)], 2, 2
    if mode == 4:
        if xx > yy:
            return [(T(xx - yy - 2), 1), (T(xx - yy - 1), 2), (T(xx - yy), 1)], 2, 2
        if xx < yy:
            return [(L(yy - xx - 2), 1), (L(yy - xx - 1), 2), (L(yy - xx), 1)], 2, 2
        return [(T(0), 1), (c, 2), (L(0), 1)], 2, 2
    if mode == 5:
        z, i = 2 * xx - yy, xx - (yy >> 1)
        if z >= 0 and z % 2 == 0:
            return [(T(i - 1), 1), (T(i), 1)], 1, 1
        if z >= 0:
            return [(T(i - 2), 1), (T(i - 1), 2), (T(i), 1)], 2, 2
        if z == -1:
            return [(L(0), 1), (c, 2), (T(0), 1)], 2, 2
        return [(L(yy - 2 * xx - 1), 1), (L(yy - 2 * xx - 2), 2),
                (L(yy - 2 * xx - 3), 1)], 2, 2
    if mode == 6:
        z, i = 2 * yy - xx, yy - (xx >> 1)
        if z >= 0 and z % 2 == 0:
            return [(L(i - 1), 1), (L(i), 1)], 1, 1
        if z >= 0:
            return [(L(i - 2), 1), (L(i - 1), 2), (L(i), 1)], 2, 2
        if z == -1:
            return [(L(0), 1), (c, 2), (T(0), 1)], 2, 2
        return [(T(xx - 2 * yy - 1), 1), (T(xx - 2 * yy - 2), 2),
                (T(xx - 2 * yy - 3), 1)], 2, 2
    if mode == 7:
        i = xx + (yy >> 1)
        if yy % 2 == 0:
            return [(T(i), 1), (T(i + 1), 1)], 1, 1
        return [(T(i), 1), (T(i + 1), 2), (T(i + 2), 1)], 2, 2
    if mode == 8:
        z, i = xx + 2 * yy, yy + (xx >> 1)
        if z < 5 and z % 2 == 0:
            return [(L(i), 1), (L(i + 1), 1)], 1, 1
        if z < 5:
            return [(L(i), 1), (L(i + 1), 2), (L(i + 2), 1)], 2, 2
        if z == 5:
            return [(L(2), 1), (L(3), 3)], 2, 2
        return [(L(3), 1)], 0, 0
    raise ValueError(f"bad intra4x4 mode {mode}")


def _i4_tables() -> tuple[np.ndarray, ...]:
    """The predictors of the nine modes as tables over (mode, pixel y*4+x):
    three neighbour indices and weights, the rounding and the shift (mode 2,
    DC, is left empty: its value depends on what is available)."""
    idx = np.zeros((9, 16, 3), np.int64)
    wgt = np.zeros((9, 16, 3), np.int32)
    rnd = np.zeros((9, 16), np.int32)
    shf = np.zeros((9, 16), np.int32)
    for m in range(9):
        if m == 2:
            continue
        for p in range(16):
            terms, rnd[m, p], shf[m, p] = _i4_terms(m, p // 4, p % 4)
            for k, (i, w) in enumerate(terms):
                idx[m, p, k], wgt[m, p, k] = i, w
    return idx, wgt, rnd, shf


_I4_TABLES = _i4_tables()


def _check_planes(y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> tuple[int, int]:
    """(mb_h, mb_w) of 16-aligned uint8 planes on one device, or raise."""
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D uint8 plane, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
    H, W = y.shape
    if H % 16 or W % 16:
        raise ValueError("encode_levels requires 16-aligned frames")
    for name, t in (("cb", cb), ("cr", cr)):
        if tuple(t.shape) != (H // 2, W // 2):
            raise ValueError(f"{name} must be ({H // 2}, {W // 2}), got "
                             f"{tuple(t.shape)}")
    return H // 16, W // 16


def encode_levels_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                        qp: int, full_recon: bool = False, i4: bool = False,
                        chromah: bool = False):
    """Plain PyTorch version of :func:`encode_levels`: the JAX function's
    scan step as a Python loop over MB columns vectorised over MB rows (and,
    in the Intra_4x4 trial, over the candidate modes), on the planes'
    device."""
    mb_h, mb_w = _check_planes(y, cb, cr)
    H, W = y.shape
    plan = level_plan(int(qp))
    qp, qpc = plan["qp"], plan["qpc"]
    dev = y.device
    pos = torch.as_tensor(_POS_CLASS, dtype=torch.long, device=dev)

    def per_pos(vals):
        return torch.as_tensor(vals, dtype=torch.int32, device=dev)[pos]

    mf_y, mf_c = per_pos(plan["mf_y"]), per_pos(plan["mf_c"])
    v_y, v_c = per_pos(plan["v_y"]), per_pos(plan["v_c"])
    qbits, qbits_c = plan["qbits"], plan["qbits_c"]
    f_y, f_c = plan["f_y"], plan["f_c"]
    mf0_y, mf0_c = plan["mf_y"][0], plan["mf_c"][0]

    # MB-column-major layout: (mb_w, mb_h, 16|8, 16|8)
    ycols = y.reshape(mb_h, 16, mb_w, 16).permute(2, 0, 1, 3).to(torch.int32)
    cbcols = cb.reshape(mb_h, 8, mb_w, 8).permute(2, 0, 1, 3).to(torch.int32)
    crcols = cr.reshape(mb_h, 8, mb_w, 8).permute(2, 0, 1, 3).to(torch.int32)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    def chroma_from_pred(src, pred):
        """(czdc raster (mb_h,2,2), cacz (mb_h,2,2,4,4) [by,bx])."""
        res = src - pred
        blk = res.reshape(mb_h, 2, 4, 2, 4)      # (row, by, r, bx, c)
        t = _cf1d(_cf1d(blk, 2), 4)
        cwdc = t[:, :, 0, :, 0]                  # (mb_h, 2, 2) [by, bx]
        acz = _quant(t, mf_c, f_c, qbits_c)
        acz[:, :, 0, :, 0] = 0
        fdc = _h2_2d(cwdc)
        zq = (torch.abs(fdc) * mf0_c + 2 * f_c) >> (qbits_c + 1)
        return _clip_sign(fdc, zq), acz

    def chroma_mb(src, edge, left_ok):
        """DC prediction of one 8x8 chroma component for all rows: with
        the top never available, each half takes the mean of its 4 left
        pixels."""
        v0 = (edge[:, 0:4].sum(1) + 2) >> 2
        v1 = (edge[:, 4:8].sum(1) + 2) >> 2
        if not left_ok:
            v0, v1 = torch.full_like(v0, 128), torch.full_like(v1, 128)
        pred = torch.cat([v0[:, None, None].expand(mb_h, 4, 8),
                          v1[:, None, None].expand(mb_h, 4, 8)], 1)
        czdc, acz = chroma_from_pred(src, pred)
        return czdc, acz, pred

    def chroma_full(czdc, acz, pred):
        """Full 8x8 recon (mb_h, 8, 8) of one chroma component."""
        cdcd = _chroma_dc_dequant(_h2_2d(czdc), qpc)
        d = _shl(acz * v_c[None, None, :, None, :], qpc // 6)
        d[:, :, 0, :, 0] = cdcd
        r = _inv_blocks(d)
        return torch.clamp(r + pred.reshape(mb_h, 2, 4, 2, 4),
                           0, 255).reshape(mb_h, 8, 8)

    i4_idx, i4_wgt, i4_rnd, i4_shf = (torch.as_tensor(a, device=dev)
                                      for a in _I4_TABLES)
    modes9 = torch.arange(9, dtype=torch.int32, device=dev)
    # the candidate modes (top row: [1, 2, 8]; else 0..8) that are
    # available, by (top row, left column without a left MB)
    i4_usable = {(top, no_left): torch.tensor(
        [(not top or m in (1, 2, 8)) and not (no_left and m in (1, 8, 4, 5, 6))
         for m in range(9)], device=dev)
        for top in (False, True) for no_left in (False, True)}

    def i4_mb(ysrc, y_edge, left_ok, lm4, lis4):
        """The Intra_4x4 MB trial with the top never available: 16
        sub-blocks in z-scan order, per block the best available mode by
        ``level_cost + _I4_MODE_BITS``, sequential within-MB
        reconstruction.  Returns (cost (mb_h,), levels (mb_h, 16, 16)
        raster [by*4+bx] full 16-coeff blocks, modes z-order (mb_h, 16),
        recon (mb_h, 16, 16))."""
        big = 1 << 30
        mbrec = full((mb_h, 16, 16), 0)
        modes: dict = {}
        zqs: dict = {}
        cost_i4 = full((mb_h,), 0)
        for z, (bx, by) in enumerate(_I4_SCAN):
            blk = ysrc[:, by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            l4 = (mbrec[:, by * 4:by * 4 + 4, bx * 4 - 1] if bx > 0
                  else y_edge[:, by * 4:by * 4 + 4])
            if by > 0:
                t4 = mbrec[:, by * 4 - 1, bx * 4:bx * 4 + 4]
                if not (bx == 3 or (bx == 1 and by in (1, 3))):
                    t8 = torch.cat(
                        [t4, mbrec[:, by * 4 - 1, bx * 4 + 4:bx * 4 + 8]], 1)
                else:       # above-right not yet decoded: p[3, -1]
                    t8 = torch.cat([t4, t4[:, 3:4].expand(mb_h, 4)], 1)
                c_ = (mbrec[:, by * 4 - 1, bx * 4 - 1] if bx > 0
                      else y_edge[:, by * 4 - 1])
            else:
                t8 = full((mb_h, 8), 0)
                c_ = full((mb_h,), 0)
            # predicted mode (spec 8.3.1.1; top MB row: other slice)
            if by == 0:
                predm = full((mb_h,), 2)
            else:
                mB = modes[(bx, by - 1)]
                if bx > 0:
                    predm = torch.minimum(modes[(bx - 1, by)], mB)
                else:
                    mA = torch.where(lis4, lm4[:, by], 2)
                    predm = (torch.minimum(mA, mB) if left_ok
                             else full((mb_h,), 2))
            # every mode at once from the table of predictors; DC apart
            nb = torch.cat([c_[:, None], t8, l4], 1)      # (mb_h, 13)
            pred = ((nb[:, i4_idx] * i4_wgt).sum(-1, dtype=torch.int32)
                    + i4_rnd) >> i4_shf                    # (mb_h, 9, 16)
            if by == 0:
                dc = (l4.sum(1) + 2) >> 2
                if bx == 0 and not left_ok:
                    dc = full((mb_h,), 128)
            elif bx == 0 and not left_ok:
                dc = (t8[:, :4].sum(1) + 2) >> 2
            else:
                dc = (t8[:, :4].sum(1) + l4.sum(1) + 4) >> 3
            pred[:, 2] = dc[:, None]
            pred = pred.reshape(mb_h, 9, 4, 4)
            t = _cf1d(_cf1d(blk[:, None] - pred, 2), 3)
            q = (torch.abs(t) * mf_y + f_y) >> qbits
            zq = _clip_sign(t, q)                          # (mb_h, 9, 4, 4)
            aq = torch.abs(zq)
            lc = (2 * aq + (aq != 0).to(torch.int32)).sum((2, 3), dtype=torch.int32)
            cm = lc + torch.where(predm[:, None] == modes9, _I4_MODE_BITS[0],
                                  _I4_MODE_BITS[1]).to(torch.int32)
            # the first minimum in candidate order wins (the strict < of a
            # loop over the candidates); modes that need the left column
            # are not available at bx == 0 without a left MB
            cm = torch.where(i4_usable[(by == 0, bx == 0 and not left_ok)], cm, big)
            best_cost = cm.amin(1)
            best_mode = (cm == best_cost[:, None]).to(torch.int32).argmax(1)
            pick = best_mode[:, None, None, None].expand(mb_h, 1, 4, 4)
            best_zq = zq.gather(1, pick)[:, 0]
            best_pred = pred.gather(1, pick)[:, 0]
            modes[(bx, by)] = best_mode.to(torch.int32)
            zqs[z] = best_zq
            cost_i4 = cost_i4 + best_cost
            d = _shl(best_zq * v_y[None], qp // 6)  # full block incl DC
            r = (_inv4_2d(d) + 32) >> 6
            mbrec[:, by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = torch.clamp(
                r + best_pred, 0, 255)
        flat = torch.stack(
            [zqs[_I4_Z_OF[(bxx, byy)]].reshape(mb_h, 16)
             for byy in range(4) for bxx in range(4)], 1)
        zmodes = torch.stack([modes[_I4_SCAN[z]] for z in range(16)], 1)
        return cost_i4, flat, zmodes, mbrec

    def luma_levels(ysrc, pred_rows):
        res = ysrc - pred_rows[:, :, None]
        blk = res.reshape(mb_h, 4, 4, 4, 4)     # (row, by, r, bx, c)
        t = _cf1d(_cf1d(blk, 2), 4)
        wdc = t[:, :, 0, :, 0]                  # (mb_h, 4, 4)
        acz = _quant(t, mf_y, f_y, qbits)
        acz[:, :, 0, :, 0] = 0
        ydc = _h1d(_h1d(wdc, 1), 2) >> 1
        zq = (torch.abs(ydc) * mf0_y + 2 * f_y) >> (qbits + 1)
        return _clip_sign(ydc, zq), acz

    y_edge = full((mb_h, 16), 0)
    cb_edge = full((mb_h, 8), 0)
    cr_edge = full((mb_h, 8), 0)
    lm4 = full((mb_h, 4), 2)
    lis4 = torch.zeros((mb_h,), dtype=torch.bool, device=dev)
    outs = []
    for mbx in range(mb_w):
        ysrc, cbsrc, crsrc = ycols[mbx], cbcols[mbx], crcols[mbx]
        left_ok = mbx > 0

        # luma: DC and HORIZONTAL 16x16 candidates from the left edge;
        # imode 2 = DC, 1 = HORIZONTAL
        pred_dc = ((y_edge.sum(1) + 8) >> 4 if left_ok
                   else full((mb_h,), 128))
        pred_dc_rows = pred_dc[:, None].expand(mb_h, 16)
        zdc_d, acz_d = luma_levels(ysrc, pred_dc_rows)
        zdc_h, acz_h = luma_levels(ysrc, y_edge)
        cost_d = _cost_of(zdc_d, acz_d)
        cost_h = _cost_of(zdc_h, acz_h)
        use_h = (cost_h < cost_d) & left_ok
        zdc = torch.where(use_h[:, None, None], zdc_h, zdc_d)
        acz = torch.where(use_h[:, None, None, None, None], acz_h, acz_d)
        pred_rows = torch.where(use_h[:, None], y_edge, pred_dc_rows)
        imode = torch.where(use_h, 1, 2).to(torch.int16)

        # Intra_4x4: strictly cheaper than the chosen I_16x16 wins
        if i4:
            cost_i4, i4flat, i4zmodes, i4rec = i4_mb(
                ysrc, y_edge, left_ok, lm4, lis4)
            cost16 = torch.where(use_h, cost_h, cost_d)
            use_i4 = cost_i4 < cost16
            imode = torch.where(use_i4, 0, imode).to(torch.int16)
            lm4 = torch.where(
                use_i4[:, None],
                torch.stack([i4zmodes[:, _I4_Z_OF[(3, byy)]]
                             for byy in range(4)], 1), 2)
            lis4 = use_i4

        # chroma
        czdc_cb, acz_cb, pred_cb = chroma_mb(cbsrc, cb_edge, left_ok)
        czdc_cr, acz_cr, pred_cr = chroma_mb(crsrc, cr_edge, left_ok)
        if chromah:
            # HORIZONTAL candidate (spec 8.3.4.2), one mode for both
            # components, +2 for the ue() bit difference, strict
            # less-than keeps DC
            pred_cb_h = cb_edge[:, :, None].expand(mb_h, 8, 8)
            pred_cr_h = cr_edge[:, :, None].expand(mb_h, 8, 8)
            czdc_cb_h, acz_cb_h = chroma_from_pred(cbsrc, pred_cb_h)
            czdc_cr_h, acz_cr_h = chroma_from_pred(crsrc, pred_cr_h)
            cost_dc = _cost_of(czdc_cb, acz_cb) + _cost_of(czdc_cr, acz_cr)
            cost_hh = (_cost_of(czdc_cb_h, acz_cb_h)
                       + _cost_of(czdc_cr_h, acz_cr_h))
            use_ch = (cost_hh + 2 < cost_dc) & left_ok
            s1 = use_ch[:, None, None]
            s2 = use_ch[:, None, None, None, None]
            czdc_cb = torch.where(s1, czdc_cb_h, czdc_cb)
            czdc_cr = torch.where(s1, czdc_cr_h, czdc_cr)
            acz_cb = torch.where(s2, acz_cb_h, acz_cb)
            acz_cr = torch.where(s2, acz_cr_h, acz_cr)
            pred_cb = torch.where(s1, pred_cb_h, pred_cb)
            pred_cr = torch.where(s1, pred_cr_h, pred_cr)
            cmode = use_ch.to(torch.int16)

        # reconstruction: the whole MB, whose right column is the next
        # column's edge (the JAX function reconstructs only that column
        # unless asked for full_recon; the values are the same)
        dcd = _luma_dc_dequant(_h1d(_h1d(zdc, 1), 2), qp)
        pred_blk = pred_rows.reshape(mb_h, 4, 4)  # (row, by, r)
        d = _shl(acz * v_y[None, None, :, None, :], qp // 6)
        d[:, :, 0, :, 0] = dcd
        ry_mb = torch.clamp(_inv_blocks(d) + pred_blk[:, :, :, None, None],
                            0, 255).reshape(mb_h, 16, 16)
        if i4:
            ry_mb = torch.where(use_i4[:, None, None], i4rec, ry_mb)
        rcb_mb = chroma_full(czdc_cb, acz_cb, pred_cb)
        rcr_mb = chroma_full(czdc_cr, acz_cr, pred_cr)
        y_edge = ry_mb[:, :, 15]
        cb_edge = rcb_mb[:, :, 7]
        cr_edge = rcr_mb[:, :, 7]

        zdc_flat = zdc.reshape(mb_h, 16)
        acz_flat = acz.permute(0, 1, 3, 2, 4).reshape(mb_h, 16, 16)
        if i4:
            # I_4x4 MBs have no luma DC block; their acz slots carry the
            # full 16-coeff blocks (DC in the raster slot)
            zdc_flat = torch.where(use_i4[:, None], 0, zdc_flat)
            acz_flat = torch.where(use_i4[:, None, None], i4flat, acz_flat)
        out = [zdc_flat.to(torch.int16), acz_flat.to(torch.int16),
               torch.stack([czdc_cb, czdc_cr], 1).reshape(mb_h, 2, 4)
               .to(torch.int16),
               torch.stack([acz_cb.permute(0, 1, 3, 2, 4),
                            acz_cr.permute(0, 1, 3, 2, 4)], 1)
               .reshape(mb_h, 2, 4, 16).to(torch.int16),
               imode]
        if i4:
            out.append(torch.where(use_i4[:, None], i4zmodes, 2)
                       .to(torch.int16))
        if chromah:
            out.append(cmode)
        if full_recon:
            out += [ry_mb.to(torch.uint8), rcb_mb.to(torch.uint8),
                    rcr_mb.to(torch.uint8)]
        outs.append(out)

    # stack the columns on axis 1: (mb_h, mb_w, ...)
    cols = [torch.stack(parts, 1) for parts in zip(*outs)]
    lv = LevelArrays(*cols[:4])
    imode = cols[4]
    extra = tuple(cols[5:5 + int(i4) + int(chromah)])
    if not full_recon:
        return (lv, imode) + extra
    ry, rcb, rcr = cols[5 + len(extra):]
    return (lv, ry.permute(0, 2, 1, 3).reshape(H, W),
            rcb.permute(0, 2, 1, 3).reshape(H // 2, W // 2),
            rcr.permute(0, 2, 1, 3).reshape(H // 2, W // 2),
            imode) + extra


# ------------------------------------------------------ the entry points ----


def encode_levels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  qp: int, full_recon: bool = False, i4: bool = False,
                  chromah: bool = False):
    """The quantized CAVLC levels of one 16-aligned frame with
    one-slice-per-MB-row semantics (top neighbour never available).

    y: (H, W) uint8 with H, W % 16 == 0; cb, cr: (H/2, W/2) uint8 (any
    strides); qp: int in [0, 51].  Returns ``(LevelArrays, imode)``, then
    ``i4modes`` (mb_h, mb_w, 16) z-order with ``i4`` and ``cmode``
    (mb_h, mb_w) with ``chromah``, all int16; with ``full_recon``
    ``(LevelArrays, ry, rcb, rcr, imode, ...)`` with the reconstructed
    uint8 planes (the reference picture of a GOP encoder's P frames).

    On a CUDA tensor the kernel runs (``ops.cuda.h264_levels``); on a CPU
    tensor the plain version."""
    from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kernel

    return kernel.encode_levels(y, cb, cr, qp, full_recon=full_recon,
                                i4=i4, chromah=chromah)


def encode_levels_nv12(nv12: np.ndarray, width: int, height: int, qp: int,
                       device: str | torch.device = "cuda"):
    """Host-NV12 entry (16-aligned): upload the planes to ``device``, split
    them, and return ``(LevelArrays, imode)`` there."""
    frame = torch.from_numpy(np.ascontiguousarray(nv12)).to(device)
    uv = frame[height:].reshape(height // 2, width // 2, 2)
    return encode_levels(frame[:height], uv[:, :, 0], uv[:, :, 1], qp)


# One packed int16 lane vector per macroblock: 16 luma DC + 256 luma AC
# + 8 chroma DC + 128 chroma AC = 408 levels, plus the QP the levels
# were quantized with in lane 408 (the slice header must encode the
# same qp when rate control moves it between dispatch and entropy coding)
PACKED_LANES = 409


def pack_levels(lv: LevelArrays, qp: int | torch.Tensor) -> torch.Tensor:
    """Flatten LevelArrays (+ qp) into one (mb_h, mb_w, 409) int16 tensor,
    one buffer to copy to the host."""
    mbh, mbw = lv.zdc.shape[:2]
    qp_lane = torch.as_tensor(qp, device=lv.zdc.device).to(
        torch.int16).expand(mbh, mbw, 1)
    return torch.cat([lv.zdc.reshape(mbh, mbw, 16),
                      lv.acz.reshape(mbh, mbw, 256),
                      lv.czdc.reshape(mbh, mbw, 8),
                      lv.cacz.reshape(mbh, mbw, 128),
                      qp_lane], -1)


def unpack_levels_host(packed: np.ndarray) -> tuple[LevelArrays, int]:
    """Host-side inverse of :func:`pack_levels`: (LevelArrays of numpy
    views, qp)."""
    packed = np.asarray(packed)
    mbh, mbw, lanes = packed.shape
    if lanes != PACKED_LANES:
        raise ValueError(f"packed levels have {lanes} lanes, "
                         f"expected {PACKED_LANES}")
    return LevelArrays(
        packed[:, :, :16],
        packed[:, :, 16:272].reshape(mbh, mbw, 16, 16),
        packed[:, :, 272:280].reshape(mbh, mbw, 2, 4),
        packed[:, :, 280:408].reshape(mbh, mbw, 2, 4, 16),
    ), int(packed[0, 0, 408])


# ------------------------------------------------------ the P frames ----

INTRA_BIAS = 8  # intra syntax overhead in cost-proxy units (the oracle's
#                 io.h264_inter._INTRA_BIAS: the two must stay equal)



class PLevelArrays(NamedTuple):
    """Per-MB chosen-mode levels of one P frame (raster layouts like
    LevelArrays) plus the mode plane and the full reconstruction.

    mode: (mb_h, mb_w) int16 — 0 P_Skip, 1 P_L0_16x16, 2 I_16x16 DC,
          3 I_16x16 HORIZONTAL.
    zdc:  (mb_h, mb_w, 16)      intra luma DC (zeros for inter/skip)
    acz:  (mb_h, mb_w, 16, 16)  intra: AC with DC slot zeroed;
                                inter: full 4x4 levels; skip: zeros
    czdc: (mb_h, mb_w, 2, 4)
    cacz: (mb_h, mb_w, 2, 4, 16)
    recon_y/cb/cr: the reconstructed planes (uint8), the next frame's
        reference.
    mv:   (mb_h, mb_w, 2) int16 (dy, dx) quarter-pel MVs of the search
          (None with search=0).
    ref:  (mb_h, mb_w) int16 reference index (None with one reference).
    pmode: (mb_h, mb_w) int16 partition modes of the ``parts``
          configuration (0 16x16, 1 16x8, 2 8x16, 3 8x8), else None; with
          ``parts`` ``mv`` is the quadrant-major field (mb_h, mb_w, 4, 2)
          and ``ref`` (mb_h, mb_w, 4).
    """

    mode: torch.Tensor
    zdc: torch.Tensor
    acz: torch.Tensor
    czdc: torch.Tensor
    cacz: torch.Tensor
    recon_y: torch.Tensor
    recon_cb: torch.Tensor
    recon_cr: torch.Tensor
    mv: torch.Tensor | None = None
    ref: torch.Tensor | None = None
    pmode: torch.Tensor | None = None


def search_plan(search: int, subpel: int) -> tuple[int, int]:
    """(planes, margin) of the reference stack a search reads: the full-pel
    grid reads the edge-padded picture (1 plane, margin ``search``), the
    half-pel lattice the [G, b, h, j] planes (4), the quarter-pel lattice
    and ``fastsub`` (``subpel=3``) all 16 (margin ``search + 1``)."""
    if subpel not in (0, 1, 2, 3):
        raise ValueError(f"subpel must be 0, 1, 2 or 3, got {subpel}")
    if not subpel:
        return 1, search
    return (4 if subpel == 1 else 16), search + 1


def search_candidates(search: int, subpel: int) -> np.ndarray:
    """The candidates of the search's first stage in quarter-pel units,
    (n, 2) int32 (dy, dx), in the oracle's order
    (``io.h264_inter.search_candidates_qpel``; ``fastsub`` sweeps the
    full-pel grid)."""
    return np.asarray(search_candidates_qpel(search, 0 if subpel == 3 else subpel),
                      np.int32)


def fastsub_offsets() -> np.ndarray:
    """The 49 refinement offsets of ``fastsub`` (49, 2) int32, in the
    oracle's order (``io.h264_inter.FASTSUB_OFFSETS``)."""
    return np.asarray(FASTSUB_OFFSETS, np.int32)


def _edge_pad(p: torch.Tensor, pad: int) -> torch.Tensor:
    """``p`` extended by ``pad`` replicated samples on every side (the
    decoder's clamping of every sample coordinate), int32."""
    H, W = p.shape
    r = torch.arange(-pad, H + pad, device=p.device).clamp(0, H - 1)
    c = torch.arange(-pad, W + pad, device=p.device).clamp(0, W - 1)
    return p[r][:, c].to(torch.int32)


def _base_planes_plain(ry: torch.Tensor, margin: int,
                       extra: int = 0) -> list[torch.Tensor]:
    """[G, b, h, j] of spec 8.4.2.2.1 over the edge-extended reference,
    each (H+2m+extra, W+2m+extra) int32 (the JAX ``_base_planes_jax``)."""
    t = (1, -5, 20, 20, -5, 1)
    ext = _edge_pad(ry, margin + 3 + extra)
    eh = ext.shape[0]
    H, W = ry.shape
    oh, ow = H + 2 * margin + extra, W + 2 * margin + extra
    o = 3 + extra
    g = ext[o:o + oh, o:o + ow]
    b1 = sum(c * ext[o:o + oh, o - 2 + k:o - 2 + k + ow] for k, c in enumerate(t))
    b = torch.clamp((b1 + 16) >> 5, 0, 255)
    h1f = sum(c * ext[k:eh - 5 + k, :] for k, c in enumerate(t))
    h = torch.clamp((h1f[o - 2:o - 2 + oh, o:o + ow] + 16) >> 5, 0, 255)
    j1 = sum(c * h1f[o - 2:o - 2 + oh, o - 2 + k:o - 2 + k + ow]
             for k, c in enumerate(t))
    j = torch.clamp((j1 + 512) >> 10, 0, 255)
    return [g, b, h, j]


def subpel_planes_plain(ry: torch.Tensor, margin: int,
                        nplanes: int) -> torch.Tensor:
    """Plain version of :func:`subpel_planes`, on ``ry``'s device."""
    if nplanes == 1:
        return _edge_pad(ry, margin).to(torch.uint8)[None]
    if nplanes == 4:
        return torch.stack(_base_planes_plain(ry, margin)).to(torch.uint8)
    if nplanes != 16:
        raise ValueError(f"nplanes must be 1, 4 or 16, got {nplanes}")
    g2, b2, h2, j2 = _base_planes_plain(ry, margin, extra=1)
    G, B = g2[:-1, :-1], b2[:-1, :-1]
    Hh, J = h2[:-1, :-1], j2[:-1, :-1]
    Gr, Gd = g2[:-1, 1:], g2[1:, :-1]
    m_, s_ = h2[:-1, 1:], b2[1:, :-1]
    return torch.stack([
        G, (G + B + 1) >> 1, B, (Gr + B + 1) >> 1,
        (G + Hh + 1) >> 1, (B + Hh + 1) >> 1, (B + J + 1) >> 1,
        (B + m_ + 1) >> 1,
        Hh, (Hh + J + 1) >> 1, J, (J + m_ + 1) >> 1,
        (Gd + Hh + 1) >> 1, (Hh + s_ + 1) >> 1, (J + s_ + 1) >> 1,
        (m_ + s_ + 1) >> 1,
    ]).to(torch.uint8)


def subpel_planes(ry: torch.Tensor, margin: int, nplanes: int) -> torch.Tensor:
    """The stacked sub-sample planes of a reference luma plane ``ry``
    (uint8 (H, W)), ``(nplanes, H + 2*margin, W + 2*margin)`` uint8, each
    over the edge-extended picture: 1 is G alone (the padded picture), 4
    the half-sample [G, b, h, j], 16 every quarter position in (fy, fx)
    raster order (the JAX ``halfpel_planes_jax`` / ``quarterpel_planes_jax``
    order).  On a CUDA tensor it launches ``subpel_planes_kernel``; on a
    CPU tensor it runs :func:`subpel_planes_plain`."""
    from opencv_opencl_tpu_torch.ops.cuda import h264_inter as kernel

    return kernel.subpel_planes(ry, margin, nplanes)


def halfpel_planes(ry: torch.Tensor, margin: int) -> torch.Tensor:
    """The stacked [G, b, h, j] half-sample planes (4, H+2m, W+2m)."""
    return subpel_planes(ry, margin, 4)


def quarterpel_planes(ry: torch.Tensor, margin: int) -> torch.Tensor:
    """All 16 sub-sample planes in (fy, fx) raster order (16, H+2m, W+2m)."""
    return subpel_planes(ry, margin, 16)


def _plane_of(fy, fx, nplanes: int):
    """Plane index of fraction (fy, fx) in a stack of 1, 4 or 16 planes
    (the oracle's ``_plane_index``)."""
    if nplanes == 16:
        return fy * 4 + fx
    if nplanes == 4:
        return fy // 2 * 2 + fx // 2
    return fy * 0


def _check_search(y: torch.Tensor, refs, search: int, subpel: int,
                  clean_rows) -> None:
    if not 1 <= len(refs) <= 2:
        raise ValueError(f"motion_search takes 1 or 2 references, got {len(refs)}")
    H, W = y.shape
    for r in refs:
        _check_planes(r[0], r[1], r[2])
        if tuple(r[0].shape) != (H, W) or r[0].device != y.device:
            raise ValueError(f"references must be ({H}, {W}) planes on {y.device}")
    if search < 1:
        raise ValueError(f"motion_search needs search >= 1, got {search}")
    search_plan(search, subpel)
    if clean_rows is not None and len(refs) > 1:
        raise ValueError("clean_rows (GDR) does not compose with two references")


def _mc_chroma(refs, mv: torch.Tensor, refsel: torch.Tensor | None,
               block: int = 8):
    """The spec 8.4.2.2.2 chroma prediction at a quarter-pel field of one
    vector a ``block`` x ``block`` chroma block (8: per MB, 4: per MB
    quadrant): mvC = mv in 1/8 chroma samples, integer part ``mv >> 3``,
    fraction ``mv & 7``, clamped coordinates (= the edge extension), uint8."""
    H, W = refs[0][0].shape
    ch, cw = H // 2, W // 2
    dev = mv.device
    mvg = mv.to(torch.int32).repeat_interleave(block, 0).repeat_interleave(block, 1)
    cdy, cdx = mvg[..., 0] >> 3, mvg[..., 1] >> 3
    fy, fx = mvg[..., 0] & 7, mvg[..., 1] & 7
    rbase = torch.arange(ch, device=dev)[:, None] + cdy
    cbase = torch.arange(cw, device=dev)[None, :] + cdx
    r0, r1 = rbase.clamp(0, ch - 1), (rbase + 1).clamp(0, ch - 1)
    c0, c1 = cbase.clamp(0, cw - 1), (cbase + 1).clamp(0, cw - 1)
    wa, wb = (8 - fx) * (8 - fy), fx * (8 - fy)
    wc, wd = (8 - fx) * fy, fx * fy
    rg = (torch.zeros_like(r0) if refsel is None else
          refsel.to(torch.long).repeat_interleave(block, 0)
          .repeat_interleave(block, 1))
    out = []
    for comp in (1, 2):
        p = torch.stack([r[comp] for r in refs]).to(torch.int32)
        out.append(((wa * p[rg, r0, c0] + wb * p[rg, r0, c1] + wc * p[rg, r1, c0]
                     + wd * p[rg, r1, c1] + 32) >> 6).to(torch.uint8))
    return out


def motion_search_plain(y: torch.Tensor, refs, search: int, subpel: int = 0,
                        clean_rows: int | None = None):
    """Plain version of :func:`motion_search`: the references' plane stack
    (:func:`subpel_planes_plain`), then :func:`search_stack_plain`."""
    _check_search(y, refs, search, subpel, clean_rows)
    P, margin = search_plan(search, subpel)
    stack = torch.cat([subpel_planes_plain(r[0], margin, P) for r in refs])
    return search_stack_plain(y, stack, refs, search, subpel, clean_rows)


def search_stack_plain(y: torch.Tensor, stack: torch.Tensor, refs, search: int,
                       subpel: int = 0, clean_rows: int | None = None):
    """Plain version of ``motion_search_kernel`` over the references' stacked
    planes ``stack`` ((len(refs) * P, H + 2m, W + 2m), :func:`search_plan`'s
    P and m): a loop over the candidates, each a full-frame SAD field summed
    in int32, with the strict ``<`` of the JAX loops; ``fastsub`` refines
    with per-MB gathers.  Returns :func:`motion_search`'s tuple."""
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    dev = y.device
    P, margin = search_plan(search, subpel)
    cur = y.to(torch.int32).reshape(mb_h, 16, mb_w, 16)
    cands = search_candidates(search, subpel)
    rows = torch.arange(mb_h, device=dev)
    big = torch.iinfo(torch.int32).max
    best_key = torch.full((mb_h, mb_w), big, dtype=torch.int64, device=dev)
    best_idx = torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev)
    best_ref = torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev)

    def restrict(key, maxrow):
        """The GDR rule: an MB row above the wave must not read at or below
        it (``maxrow``, (mb_h, 1) or (mb_h, mb_w): the last reference row a
        candidate's block reads, its interpolation included)."""
        if clean_rows is None:
            return key
        bad = (rows < clean_rows)[:, None] & (maxrow > 16 * clean_rows - 1)
        return torch.where(bad, _BAD_KEY, key)

    for r in range(len(refs)):
        for idx, (qy, qx) in enumerate(cands.tolist()):
            p = r * P + _plane_of(qy & 3, qx & 3, P)
            iy, ix = margin + (qy >> 2), margin + (qx >> 2)
            ref = stack[p, iy:iy + H, ix:ix + W].to(torch.int32)
            sad = (cur - ref.reshape(mb_h, 16, mb_w, 16)).abs().sum(
                (1, 3), dtype=torch.int32).to(torch.int64)
            key = restrict(sad * SEARCH_KEY_RADIX + idx,
                           (16 * rows + 15 + (qy >> 2) + _MC_ROW_EXT[qy & 3])[:, None])
            take = key < best_key
            best_key = torch.where(take, key, best_key)
            best_idx = torch.where(take, idx, best_idx)
            best_ref = torch.where(take, r, best_ref)
    mv = torch.as_tensor(cands, device=dev).to(torch.int64)[best_idx]

    ri = (16 * rows[:, None, None] + torch.arange(16, device=dev)[None, None, :])
    ci = (16 * torch.arange(mb_w, device=dev)[None, :, None]
          + torch.arange(16, device=dev)[None, None, :])
    if subpel == 3:
        # the 49 quarter-pel offsets around each MB's full-pel winner, on
        # its reference
        curb = cur.permute(0, 2, 1, 3)                     # (mb_h, mb_w, 16, 16)
        v = mv >> 2
        rows0 = margin + ri + v[:, :, 0:1]                 # (mb_h, mb_w, 16)
        cols0 = margin + ci + v[:, :, 1:2]
        best_key = torch.full((mb_h, mb_w), big, dtype=torch.int64, device=dev)
        best_j = torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev)
        offs = fastsub_offsets()
        for j, (qy, qx) in enumerate(offs.tolist()):
            pg = best_ref * 16 + (qy & 3) * 4 + (qx & 3)
            ref = stack[pg[:, :, None, None], (rows0 + (qy >> 2))[:, :, :, None],
                        (cols0 + (qx >> 2))[:, :, None, :]].to(torch.int32)
            sad = (curb - ref).abs().sum((2, 3), dtype=torch.int32).to(torch.int64)
            ty = mv[:, :, 0] + qy
            key = restrict(sad * SEARCH_KEY_RADIX + j,
                           16 * rows[:, None] + 15 + (ty >> 2) + _MC_ROW_EXT[qy & 3])
            take = key < best_key
            best_key = torch.where(take, key, best_key)
            best_j = torch.where(take, j, best_j)
        mv = mv + torch.as_tensor(offs, device=dev).to(torch.int64)[best_j]

    # luma MC: the winner's plane at the winner's integer offset
    pg = best_ref * P + _plane_of(mv[:, :, 0] & 3, mv[:, :, 1] & 3, P)
    pred_y = stack[pg[:, :, None, None],
                   (margin + ri + (mv[:, :, 0:1] >> 2))[:, :, :, None],
                   (margin + ci + (mv[:, :, 1:2] >> 2))[:, :, None, :]]
    pred_y = pred_y.permute(0, 2, 1, 3).reshape(H, W)
    two = len(refs) > 1
    pred_cb, pred_cr = _mc_chroma(refs, mv, best_ref if two else None)
    mv16 = mv.to(torch.int16)
    if two:
        return mv16, best_ref.to(torch.int16), pred_y, pred_cb, pred_cr
    return mv16, pred_y, pred_cb, pred_cr


def motion_search(y: torch.Tensor, refs, search: int, subpel: int = 0,
                  clean_rows: int | None = None):
    """Per-MB motion search and motion compensation of the luma plane ``y``
    against one or two references, ``refs`` a list of ``(ry, rcb, rcr)``
    uint8 planes (the most recent first), radius ``search`` in pixels
    over the full-pel grid (``subpel=0``), the exhaustive half-pel (1) or
    quarter-pel (2) lattice, or ``fastsub`` (3: the full-pel grid, then
    the 49 quarter-pel offsets around each MB's winner).  Each MB keeps
    the least key ``sad * 8192 + candidate index`` in the oracle's
    candidate order (``io.h264_inter.search_candidates_qpel``), with two
    references the earlier on equal keys; ``clean_rows`` is the GDR
    clean-region rule (one reference only).

    Returns the JAX functions' tuples: ``(mv, pred_y, pred_cb, pred_cr)``,
    or ``(mv, ref, pred_y, pred_cb, pred_cr)`` with two references; ``mv``
    (mb_h, mb_w, 2) int16 (dy, dx) in quarter-pel units, ``ref`` int16,
    the predictions uint8 planes.  On CUDA tensors it launches
    ``subpel_planes_kernel`` for each reference, then
    ``motion_search_kernel``; on CPU tensors it runs
    :func:`motion_search_plain`."""
    from opencv_opencl_tpu_torch.ops.cuda import h264_inter as kernel

    return kernel.motion_search(y, refs, search, subpel, clean_rows=clean_rows)


def _check_parts(y: torch.Tensor, refs, search: int, subpel: int) -> int:
    """The parts search's refusals (the JAX ``motion_search_mc_parts``'s and
    ``encode_p_levels(parts=1)``'s); returns the candidate count."""
    _check_search(y, refs, search, subpel, None)
    if subpel == 3:
        raise ValueError("parts does not compose with fastsub")
    n = len(search_candidates(search, subpel))
    if len(refs) * n > SEARCH_KEY_RADIX:
        raise ValueError(
            f"parts refs={len(refs)} at this sub-pel radius exceeds the "
            f"key packing ({len(refs)}*{n} > {SEARCH_KEY_RADIX}); "
            "quarter-pel parts with 2 references needs R <= 7")
    return n


def motion_search_parts_plain(y: torch.Tensor, refs, search: int, subpel: int,
                              qp: int):
    """Plain version of :func:`motion_search_parts`: the references' plane
    stack (:func:`subpel_planes_plain`), then :func:`parts_stack_plain`."""
    _check_parts(y, refs, search, subpel)
    P, margin = search_plan(search, subpel)
    stack = torch.cat([subpel_planes_plain(r[0], margin, P) for r in refs])
    return parts_stack_plain(y, stack, refs, search, subpel, qp)


def parts_stack_plain(y: torch.Tensor, stack: torch.Tensor, refs, search: int,
                      subpel: int, qp: int):
    """Plain version of ``parts_search_kernel`` over the references' stacked
    planes ``stack`` (as :func:`search_stack_plain` takes them): a loop over
    the candidates in ref-major order (flat index ``r * n + idx``), each
    giving the four quadrant SADs of every MB summed in int32, the halves
    and the whole MB their sums, and nine running least keys ``sad * 8192 +
    i``; then the partition decision and the quadrant-granular motion
    compensation.  Returns :func:`motion_search_parts`'s tuple."""
    n = _check_parts(y, refs, search, subpel)
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    dev = y.device
    P, margin = search_plan(search, subpel)
    R = SEARCH_KEY_RADIX
    cur = y.to(torch.int32).reshape(mb_h, 2, 8, mb_w, 2, 8)
    cands = search_candidates(search, subpel)
    big = torch.iinfo(torch.int32).max
    # kq (mb_h, 2, mb_w, 2), kh (mb_h, 2, mb_w), kv (mb_h, mb_w, 2), kf
    kq = torch.full((mb_h, 2, mb_w, 2), big, dtype=torch.int64, device=dev)
    kh = torch.full((mb_h, 2, mb_w), big, dtype=torch.int64, device=dev)
    kv = torch.full((mb_h, mb_w, 2), big, dtype=torch.int64, device=dev)
    kf = torch.full((mb_h, mb_w), big, dtype=torch.int64, device=dev)
    for r in range(len(refs)):
        for idx, (qy, qx) in enumerate(cands.tolist()):
            i = r * n + idx
            p = r * P + _plane_of(qy & 3, qx & 3, P)
            iy, ix = margin + (qy >> 2), margin + (qx >> 2)
            ref = stack[p, iy:iy + H, ix:ix + W].to(torch.int32)
            q = (cur - ref.reshape(mb_h, 2, 8, mb_w, 2, 8)).abs().sum(
                (2, 5), dtype=torch.int32).to(torch.int64)
            h = q.sum(3)
            v = q.sum(1)
            kq = torch.minimum(kq, q * R + i)
            kh = torch.minimum(kh, h * R + i)
            kv = torch.minimum(kv, v * R + i)
            kf = torch.minimum(kf, h.sum(1) * R + i)
    lam = PART_LAMBDA[min(max(int(qp), 0), 51)]
    cost_f = kf // R
    cost_h = (kh // R).sum(1) + lam
    cost_v = (kv // R).sum(2) + lam
    cost_q = (kq // R).sum((1, 3)) + 3 * lam
    pmode = torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev)
    best = cost_f
    for m, c in ((1, cost_h), (2, cost_v), (3, cost_q)):
        take = c < best                 # strict: ties keep the coarser mode
        pmode = torch.where(take, m, pmode)
        best = torch.where(take, c, best)
    # each quadrant's flat index on the (mb_h, 2, mb_w, 2) grid: a 16x8 MB's
    # quadrants take their row's half, an 8x16 MB's their column's
    pm4 = pmode[:, None, :, None]
    iq = torch.where(pm4 == 0, (kf % R)[:, None, :, None],
                     torch.where(pm4 == 1, (kh % R)[:, :, :, None],
                                 torch.where(pm4 == 2, (kv % R)[:, None, :, :],
                                             kq % R)))
    iq = iq.expand(mb_h, 2, mb_w, 2)
    carr = torch.as_tensor(cands, device=dev).to(torch.int64)
    mv8 = carr[iq % n]                                  # (mb_h, 2, mb_w, 2, 2)
    ref8 = iq // n
    # luma: each 8x8 quadrant from its winner's plane at its integer offset
    ri = (16 * torch.arange(mb_h, device=dev)[:, None, None]
          + 8 * torch.arange(2, device=dev)[None, :, None]
          + torch.arange(8, device=dev)[None, None, :])          # (mb_h, 2, 8)
    ci = (16 * torch.arange(mb_w, device=dev)[:, None, None]
          + 8 * torch.arange(2, device=dev)[None, :, None]
          + torch.arange(8, device=dev)[None, None, :])          # (mb_w, 2, 8)
    pg = ref8 * P + _plane_of(mv8[..., 0] & 3, mv8[..., 1] & 3, P)
    rows = margin + ri[:, :, None, None, :] + (mv8[..., 0] >> 2)[..., None]
    cols = margin + ci[None, None, :, :, :] + (mv8[..., 1] >> 2)[..., None]
    pred_y = stack[pg[..., None, None], rows[..., :, None], cols[..., None, :]]
    pred_y = pred_y.permute(0, 1, 4, 2, 3, 5).reshape(H, W)
    two = len(refs) > 1
    grid = (2 * mb_h, 2 * mb_w)
    pred_cb, pred_cr = _mc_chroma(refs, mv8.reshape(*grid, 2),
                                  ref8.reshape(grid) if two else None, block=4)
    mv4 = mv8.permute(0, 2, 1, 3, 4).reshape(mb_h, mb_w, 4, 2).to(torch.int16)
    ref4 = (ref8.permute(0, 2, 1, 3).reshape(mb_h, mb_w, 4).to(torch.int16)
            if two else None)
    return pmode.to(torch.int16), mv4, ref4, pred_y, pred_cb, pred_cr


def motion_search_parts(y: torch.Tensor, refs, search: int, subpel: int,
                        qp: int):
    """The sub-16x16 partition search with motion compensation (the JAX
    ``motion_search_mc_parts``; its oracle ``io.h264_inter.
    motion_search_parts`` / ``motion_search_parts_multi`` with the block-8
    ``mc_planes``): one sweep over every reference's candidates
    (``refs`` a list of one or two ``(ry, rcb, rcr)``; radius ``search`` on
    the full-pel grid (``subpel=0``), the half-pel (1) or the quarter-pel
    (2) lattice; flat index ``i = r * n + idx``) keeps nine least keys ``sad
    * 8192 + i``: the four quadrants, the two 16x8 halves, the two 8x16
    halves and the whole MB.  The partition mode minimizes the SAD plus
    ``PART_LAMBDA[qp]`` a vector more than one (16x8 and 8x16 one, 8x8
    three), ties keeping the coarser mode; each quadrant takes its
    partition's winner, luma predicted 8x8 from its plane and chroma 4x4
    with the bilinear.

    Returns ``(pmode (mb_h, mb_w), mv4 (mb_h, mb_w, 4, 2) quarter-pel (dy,
    dx) quadrant-major (q0 top-left, q1 top-right, q2 bottom-left, q3
    bottom-right), ref4 (mb_h, mb_w, 4) or None with one reference, pred_y,
    pred_cb, pred_cr)``, the fields int16, the predictions uint8.  It
    refuses ``fastsub`` and a key packing that would overflow (``nrefs * n
    > 8192``: quarter-pel with two references needs ``search <= 7``).  On
    CUDA tensors it launches ``subpel_planes_kernel`` for each reference
    (with ``subpel``), then ``parts_search_kernel``; on CPU tensors it runs
    :func:`motion_search_parts_plain`."""
    from opencv_opencl_tpu_torch.ops.cuda import h264_inter as kernel

    return kernel.motion_search_parts(y, refs, search, subpel, qp)


def p_levels_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                   pred_y: torch.Tensor, pred_cb: torch.Tensor,
                   pred_cr: torch.Tensor, mv_zero: torch.Tensor, qp: int,
                   band: tuple[int, int] | None = None) -> tuple:
    """Plain version of H2 (the split grids of ``csrc/h264_levels.cu``
    for a P frame): the JAX ``encode_p_levels``
    scan step as a Python loop over MB columns, vectorised over MB rows.
    ``pred_*`` are the motion-compensated planes (the reference itself at
    zero motion), ``mv_zero`` (mb_h, mb_w) bool marks the MBs whose
    (mv, ref) is ((0, 0), 0), ``band`` the GDR rows [lo, hi) that are
    intra regardless of cost.  Returns (mode, zdc, acz, czdc, cacz,
    recon_y, recon_cb, recon_cr)."""
    mb_h, mb_w = _check_planes(y, cb, cr)
    H, W = y.shape
    plan = level_plan(int(qp))
    qp, qpc = plan["qp"], plan["qpc"]
    dev = y.device
    pos = torch.as_tensor(_POS_CLASS, dtype=torch.long, device=dev)

    def per_pos(vals):
        return torch.as_tensor(vals, dtype=torch.int32, device=dev)[pos]

    mf_y, mf_c = per_pos(plan["mf_y"]), per_pos(plan["mf_c"])
    v_y, v_c = per_pos(plan["v_y"]), per_pos(plan["v_c"])
    qbits, qbits_c = plan["qbits"], plan["qbits_c"]
    f_y_i, f_c_i = plan["f_y"], plan["f_c"]
    f_y_p, f_c_p = (1 << qbits) // 6, (1 << qbits_c) // 6
    mf0_y, mf0_c = plan["mf_y"][0], plan["mf_c"][0]
    inband = torch.zeros(mb_h, dtype=torch.bool, device=dev)
    if band is not None:
        rows = torch.arange(mb_h, device=dev)
        inband = (rows >= int(band[0])) & (rows < int(band[1]))

    def cols(a, n):
        return a.reshape(mb_h, n, mb_w, n).permute(2, 0, 1, 3).to(torch.int32)

    ycols, cbcols, crcols = cols(y, 16), cols(cb, 8), cols(cr, 8)
    rycols, rcbcols, rcrcols = cols(pred_y, 16), cols(pred_cb, 8), cols(pred_cr, 8)
    mvzcols = mv_zero.permute(1, 0)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    def intra_luma(res):
        t = _cf1d(_cf1d(res.reshape(mb_h, 4, 4, 4, 4), 2), 4)
        wdc = t[:, :, 0, :, 0]
        acz = _quant(t, mf_y, f_y_i, qbits)
        acz[:, :, 0, :, 0] = 0
        ydc = _h1d(_h1d(wdc, 1), 2) >> 1
        zq = (torch.abs(ydc) * mf0_y + 2 * f_y_i) >> (qbits + 1)
        return _clip_sign(ydc, zq), acz

    def chroma_levels(res, f):
        t = _cf1d(_cf1d(res.reshape(mb_h, 2, 4, 2, 4), 2), 4)
        cwdc = t[:, :, 0, :, 0]
        acz = _quant(t, mf_c, f, qbits_c)
        acz[:, :, 0, :, 0] = 0
        fdc = _h2_2d(cwdc)
        zq = (torch.abs(fdc) * mf0_c + 2 * f) >> (qbits_c + 1)
        return _clip_sign(fdc, zq), acz

    def chroma_intra_pred(edge, left_ok):
        v0 = (edge[:, 0:4].sum(1) + 2) >> 2
        v1 = (edge[:, 4:8].sum(1) + 2) >> 2
        if not left_ok:
            v0, v1 = torch.full_like(v0, 128), torch.full_like(v1, 128)
        return torch.cat([v0[:, None, None].expand(mb_h, 4, 8),
                          v1[:, None, None].expand(mb_h, 4, 8)], 1)

    def chroma_recon(czdc, acz, pred):
        cdcd = _chroma_dc_dequant(_h2_2d(czdc), qpc)
        d = _shl(acz * v_c[None, None, :, None, :], qpc // 6)
        d[:, :, 0, :, 0] = cdcd
        return torch.clamp(_inv_blocks(d) + pred.reshape(mb_h, 2, 4, 2, 4),
                           0, 255).reshape(mb_h, 8, 8)

    y_edge = full((mb_h, 16), 0)
    cb_edge = full((mb_h, 8), 0)
    cr_edge = full((mb_h, 8), 0)
    outs = []
    for mbx in range(mb_w):
        ysrc, cbsrc, crsrc = ycols[mbx], cbcols[mbx], crcols[mbx]
        yref, cbref, crref = rycols[mbx], rcbcols[mbx], rcrcols[mbx]
        left_ok = mbx > 0

        # intra candidates: I_16x16 DC, and HORIZONTAL with a left MB;
        # chroma DC
        ipred_dc = ((y_edge.sum(1) + 8) >> 4 if left_ok else full((mb_h,), 128))
        pred_dc_full = ipred_dc[:, None, None].expand(mb_h, 16, 16)
        zdc_d, acz_d = intra_luma(ysrc - pred_dc_full)
        pred_h_full = y_edge[:, :, None].expand(mb_h, 16, 16)
        zdc_h, acz_h = intra_luma(ysrc - pred_h_full)
        cost_d, cost_h = _cost_of(zdc_d, acz_d), _cost_of(zdc_h, acz_h)
        use_h = (cost_h < cost_d) & left_ok
        zdc_i = torch.where(use_h[:, None, None], zdc_h, zdc_d)
        acz_i = torch.where(use_h[:, None, None, None, None], acz_h, acz_d)
        ipred_full = torch.where(use_h[:, None, None], pred_h_full, pred_dc_full)
        pred_cb_i = chroma_intra_pred(cb_edge, left_ok)
        pred_cr_i = chroma_intra_pred(cr_edge, left_ok)
        czdc_cb_i, cacz_cb_i = chroma_levels(cbsrc - pred_cb_i, f_c_i)
        czdc_cr_i, cacz_cr_i = chroma_levels(crsrc - pred_cr_i, f_c_i)

        # inter candidate: full 4x4 luma levels (DC included), inter offset
        t_p = _cf1d(_cf1d((ysrc - yref).reshape(mb_h, 4, 4, 4, 4), 2), 4)
        lz = _quant(t_p, mf_y, f_y_p, qbits)
        czdc_cb_p, cacz_cb_p = chroma_levels(cbsrc - cbref, f_c_p)
        czdc_cr_p, cacz_cr_p = chroma_levels(crsrc - crref, f_c_p)

        # the decision: skip first (zero cost at (mv, ref) = ((0, 0), 0)),
        # then intra on cost_i + INTRA_BIAS < cost_p; GDR rows are intra
        cost_p = _cost_of(lz, czdc_cb_p, czdc_cr_p, cacz_cb_p, cacz_cr_p)
        cost_i = _cost_of(zdc_i, acz_i, czdc_cb_i, czdc_cr_i, cacz_cb_i,
                          cacz_cr_i) + INTRA_BIAS
        skip = (cost_p == 0) & mvzcols[mbx] & ~inband
        use_intra = (~skip & (cost_i < cost_p)) | inband
        mode = torch.where(skip, 0, torch.where(use_intra, torch.where(use_h, 3, 2), 1))

        # reconstructions of both candidates, then the chosen one
        dcd = _luma_dc_dequant(_h1d(_h1d(zdc_i, 1), 2), qp)
        d_i = _shl(acz_i * v_y[None, None, :, None, :], qp // 6)
        d_i[:, :, 0, :, 0] = dcd
        yref_blk = yref.reshape(mb_h, 4, 4, 4, 4)
        recon_y_i = torch.clamp(_inv_blocks(d_i) + ipred_full.reshape(mb_h, 4, 4, 4, 4),
                                0, 255)
        d_p = _shl(lz * v_y[None, None, :, None, :], qp // 6)
        recon_y_p = torch.clamp(_inv_blocks(d_p) + yref_blk, 0, 255)
        m4 = mode[:, None, None, None, None]
        recon_y = torch.where(m4 >= 2, recon_y_i,
                              torch.where(m4 == 1, recon_y_p, yref_blk)
                              ).reshape(mb_h, 16, 16)
        m3 = mode[:, None, None]
        recon_c = []
        for czdc_i, cacz_i, pred_i, czdc_p, cacz_p, cref in (
                (czdc_cb_i, cacz_cb_i, pred_cb_i, czdc_cb_p, cacz_cb_p, cbref),
                (czdc_cr_i, cacz_cr_i, pred_cr_i, czdc_cr_p, cacz_cr_p, crref)):
            recon_c.append(torch.where(
                m3 >= 2, chroma_recon(czdc_i, cacz_i, pred_i),
                torch.where(m3 == 1, chroma_recon(czdc_p, cacz_p, cref), cref)))

        # the chosen mode's levels
        acz_sel = torch.where(m4 >= 2, acz_i, torch.where(m4 == 1, lz, 0))
        czdc = [torch.where(m3 >= 2, a, torch.where(m3 == 1, b, 0))
                for a, b in ((czdc_cb_i, czdc_cb_p), (czdc_cr_i, czdc_cr_p))]
        cacz = [torch.where(m4 >= 2, a, torch.where(m4 == 1, b, 0))
                for a, b in ((cacz_cb_i, cacz_cb_p), (cacz_cr_i, cacz_cr_p))]
        zdc_flat = torch.where((mode >= 2)[:, None], zdc_i.reshape(mb_h, 16), 0)
        outs.append([
            mode.to(torch.int16), zdc_flat.to(torch.int16),
            acz_sel.permute(0, 1, 3, 2, 4).reshape(mb_h, 16, 16).to(torch.int16),
            torch.stack(czdc, 1).reshape(mb_h, 2, 4).to(torch.int16),
            torch.stack([c.permute(0, 1, 3, 2, 4) for c in cacz], 1)
            .reshape(mb_h, 2, 4, 16).to(torch.int16),
            recon_y.to(torch.uint8), recon_c[0].to(torch.uint8),
            recon_c[1].to(torch.uint8)])
        y_edge = recon_y[:, :, 15]
        cb_edge = recon_c[0][:, :, 7]
        cr_edge = recon_c[1][:, :, 7]

    mode, zdc, acz, czdc, cacz, ry, rcb, rcr = (torch.stack(p, 1) for p in zip(*outs))
    return (mode, zdc, acz, czdc, cacz,
            ry.permute(0, 2, 1, 3).reshape(H, W),
            rcb.permute(0, 2, 1, 3).reshape(H // 2, W // 2),
            rcr.permute(0, 2, 1, 3).reshape(H // 2, W // 2))


def _check_p_call(y, cb, cr, ry, rcb, rcr, ry2, gdr_band, parts, search,
                  subpel) -> tuple[int, int]:
    mb = _check_planes(y, cb, cr)
    _check_planes(ry, rcb, rcr)
    if tuple(ry.shape) != tuple(y.shape) or ry.device != y.device:
        raise ValueError(f"the reference must be {tuple(y.shape)} planes on {y.device}")
    if gdr_band is not None and ry2 is not None:
        raise ValueError("gdr_band does not compose with two references")
    if parts:
        # the oracle's composition limits (encode_frame_p_slices parts=True)
        if not search:
            raise ValueError("parts requires search=R > 0")
        if subpel == 3:
            raise ValueError("parts does not compose with fastsub")
        if gdr_band is not None:
            raise ValueError("parts requires no gdr")
    return mb


def _search_refs(ry, rcb, rcr, ry2, rcb2, rcr2) -> list:
    return [(ry, rcb, rcr)] + ([] if ry2 is None else [(ry2, rcb2, rcr2)])


def _mv_zero(mv: torch.Tensor, ref: torch.Tensor | None) -> torch.Tensor:
    z = (mv[..., 0] == 0) & (mv[..., 1] == 0)
    return z if ref is None else z & (ref == 0)


def encode_p_levels_plain(y, cb, cr, ry, rcb, rcr, qp: int, search: int = 0,
                          subpel: int = 0, ry2=None, rcb2=None, rcr2=None,
                          gdr_band: tuple | None = None,
                          parts: int = 0) -> PLevelArrays:
    """Plain version of :func:`encode_p_levels`: :func:`motion_search_plain`
    (with ``search``; :func:`motion_search_parts_plain` with ``parts``), then
    :func:`p_levels_plain`, on the planes' device."""
    mb_h, mb_w = _check_p_call(y, cb, cr, ry, rcb, rcr, ry2, gdr_band, parts,
                               search, subpel)
    mv = refsel = pmode = None
    if parts:
        refs = _search_refs(ry, rcb, rcr, ry2, rcb2, rcr2)
        pmode, mv, refsel, pred_y, pred_cb, pred_cr = motion_search_parts_plain(
            y, refs, search, subpel, qp)
        # P_Skip needs the whole-MB hypothesis at (0, 0) on reference 0
        mv_zero = (pmode == 0) & _mv_zero(mv[:, :, 0],
                                          None if refsel is None else refsel[:, :, 0])
    elif search:
        refs = _search_refs(ry, rcb, rcr, ry2, rcb2, rcr2)
        out = motion_search_plain(y, refs, search, subpel, clean_rows=(
            None if gdr_band is None else int(gdr_band[0])))
        if len(refs) > 1:
            mv, refsel, pred_y, pred_cb, pred_cr = out
        else:
            mv, pred_y, pred_cb, pred_cr = out
        mv_zero = _mv_zero(mv, refsel)
    else:
        pred_y, pred_cb, pred_cr = ry, rcb, rcr
        mv_zero = torch.ones((mb_h, mb_w), dtype=torch.bool, device=y.device)
    out = p_levels_plain(y, cb, cr, pred_y, pred_cb, pred_cr, mv_zero, qp,
                         band=gdr_band)
    return PLevelArrays(*out, mv, refsel, pmode)


def encode_p_levels(y, cb, cr, ry, rcb, rcr, qp: int, search: int = 0,
                    subpel: int = 0, ry2=None, rcb2=None, rcr2=None,
                    gdr_band: tuple | None = None, parts: int = 0) -> PLevelArrays:
    """Levels, mode decisions and reconstruction of one P frame with one
    slice per MB row (the JAX ``encode_p_levels``; its oracle
    ``io.h264_inter.encode_frame_p_slices`` at ``slices=mb_h``).

    y: (H, W) uint8 16-aligned source; cb, cr: (H/2, W/2) uint8 (any
    strides); ry, rcb, rcr: the reconstructed previous picture (uint8,
    contiguous), and ry2, rcb2, rcr2 the one before it for two references;
    qp: int; search: radius in pixels (0 = zero motion); subpel: 0
    full-pel, 1 half-pel, 2 quarter-pel, 3 ``fastsub``; gdr_band: the GDR
    intra rows ``(lo, hi)`` (one reference only); ``parts`` (1) the
    sub-16x16 partitions (:func:`motion_search_parts`; with ``search``, not
    with ``fastsub`` or a GDR band): ``mv`` is then the quadrant field
    (mb_h, mb_w, 4, 2), ``ref`` (two references) (mb_h, mb_w, 4) and
    ``pmode`` the partition modes.  The references are read, never written.

    On CUDA tensors: ``subpel_planes_kernel`` and ``motion_search_kernel``
    (``parts_search_kernel`` with ``parts``) with ``search``, then H2's
    three grids (``levels_split_kernel``, ``levels_chain_kernel``,
    ``levels_intra_kernel``); on CPU tensors :func:`encode_p_levels_plain`."""
    from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kernel

    return kernel.encode_p_levels(y, cb, cr, ry, rcb, rcr, qp, search, subpel,
                                  ry2, rcb2, rcr2, gdr_band, parts)
