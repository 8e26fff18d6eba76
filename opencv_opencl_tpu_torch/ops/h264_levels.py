"""H.264 intra CAVLC quantized levels on the card (counterpart of
``opencv_opencl_tpu/ops/h264_levels.py``, its intra part).

The arithmetic of the CAVLC intra encoder: prediction (I_16x16 DC and
HORIZONTAL, optionally Intra_4x4 and chroma HORIZONTAL), the 4x4 integer
transforms, the DC Hadamards, quantization and reconstruction, with one
slice per MB row, so that the top neighbour is never available and the
only dependency left is the reconstructed right edge of the macroblock to
the left.  The host keeps the entropy coding
(``native.cavlc_entropy_rows`` or ``io.h264_cavlc.encode_frame_from_levels``).

:func:`encode_levels` is the entry point.  On a CUDA tensor it launches
``intra_levels_kernel`` (``csrc/h264_levels.cu``, one thread block per MB
row walking its columns; wrapper ``ops/cuda/h264_levels.py``) or raises; on
a CPU tensor it runs :func:`encode_levels_plain`, a port of the JAX
function's ``lax.scan`` step as a Python loop over the MB columns,
vectorised over the MB rows, line by line but for the Intra_4x4 trial,
which evaluates the nine candidate modes of a sub-block at once from a
table of the spec's predictor formulas (a loop over the modes launches
thousands of small ops a column on the card).  All arithmetic is int32 and exact: the
levels, modes and reconstructions equal the JAX function's, and a stream
entropy-coded from them equals ``CavlcH264Encoder(slices=mb_h)``'s byte
for byte.

The tables are the port's own copies of the JAX module's (and of
``io/h264_cavlc.py``'s, the oracle's).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["LevelArrays", "encode_levels", "encode_levels_plain",
           "encode_levels_nv12", "level_plan", "PACKED_LANES", "pack_levels",
           "unpack_levels_host"]

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
