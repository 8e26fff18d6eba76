"""Frozen copy of the port's plain H.264 level arithmetic, the benchmark's
reference for the fused GOP step.

Copied from ``opencv_opencl_tpu_torch/ops/h264_levels.py`` (the ``*_plain``
functions and their helpers) with the constants it imported from
``opencv_opencl_tpu_torch/io/h264_inter.py``, cut down to what
:mod:`.gop` calls: the entry points that launch the CUDA kernels, Intra_4x4,
the chroma HORIZONTAL candidate, partitions, a second reference picture and
the GDR refresh band are left out (a cell that needs one brings its own
reference).  It imports nothing of the port, so later edits there cannot
move the yardstick.  The source module's docstring follows.

H.264 CAVLC quantized levels on the card (counterpart of
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

# the search's contract with the host oracle (copied from the port's
# io/h264_inter.py)
def _full_pel_candidates(search: int) -> list[tuple[int, int]]:
    """Deterministic candidate order of the full-pel motion search:
    every (dy, dx) in [-search, search]^2, sorted by
    (|dy| + |dx|, dy, dx) so (0, 0) is index 0 and smaller motion wins
    SAD ties.  ``search`` must be in [1, 15] (sub-pel lattices bound
    the count against SEARCH_KEY_RADIX — see search_candidates_qpel).

    Full-pel luma MVs keep luma MC a pure block copy; chroma moves by
    mv/2 chroma samples, so odd MVs land on half-sample positions —
    handled by the spec's 1/8-pel bilinear (8.4.2.2.2) with fractions
    in {0, 4}, still exact integer arithmetic (:func:`mc_planes`).
    The order is part of the TPU/oracle byte-exactness contract: both
    sides MUST pick the same MV for the same SAD field.
    """
    if not 1 <= search <= 15:
        raise ValueError(f"search must be an int in [1, 15], "
                         f"got {search}")
    cands = [(dy, dx) for dy in range(-search, search + 1)
             for dx in range(-search, search + 1)]
    cands.sort(key=lambda d: (abs(d[0]) + abs(d[1]), d[0], d[1]))
    return cands


# the tie-break packing radix of the shared selection key
# sad * RADIX + candidate_index: must exceed the largest candidate
# count ((8*11+1)^2 = 7921 at quarter-pel R=11) while keeping
# sad * RADIX + idx < 2^31 exact in int32 (65280 * 8192 ~= 5.3e8 OK)
SEARCH_KEY_RADIX = 8192


def search_candidates_qpel(search: int,
                           subpel: int = 0) -> list[tuple[int, int]]:
    """The motion search candidate set in QUARTER-pel wire units, in
    the shared deterministic order (sorted by (|qy| + |qx|, qy, qx),
    (0, 0) first).  ``subpel=0``: the full-pel grid of
    :func:`_full_pel_candidates` scaled by 4 (same relative order — the
    sort key is scale-invariant).  ``subpel=1``: the half-pel lattice
    {(2a, 2b): |a|, |b| <= 2*search}.  ``subpel=2``: the full
    quarter-pel lattice {(a, b): |a|, |b| <= 4*search} (R <= 11 keeps
    (8R+1)^2 inside the SEARCH_KEY_RADIX tie-break packing)."""
    if subpel == 0:
        return [(4 * dy, 4 * dx) for dy, dx in _full_pel_candidates(search)]
    if not 1 <= search <= 15:
        raise ValueError(f"search must be an int in [1, 15], "
                         f"got {search}")
    if subpel == 2:
        if search > 11:
            raise ValueError("quarter-pel search radius must be <= 11 "
                             f"(candidate-count bound), got {search}")
        r = 4 * search
        cands = [(a, b) for a in range(-r, r + 1)
                 for b in range(-r, r + 1)]
    else:
        r = 2 * search
        cands = [(2 * a, 2 * b) for a in range(-r, r + 1)
                 for b in range(-r, r + 1)]
    cands.sort(key=lambda d: (abs(d[0]) + abs(d[1]), d[0], d[1]))
    return cands


# Hierarchical refinement neighborhood: every quarter-pel offset
# within (-1, 1) pel of the full-pel winner, in the shared
# deterministic order (sorted by (|qy| + |qx|, qy, qx), (0, 0) first —
# index 0 IS the full-pel winner, so an all-tie field keeps it).
# 49 < SEARCH_KEY_RADIX, so the same key packing applies.
FASTSUB_OFFSETS: list[tuple[int, int]] = sorted(
    ((a, b) for a in range(-3, 4) for b in range(-3, 4)),
    key=lambda d: (abs(d[0]) + abs(d[1]), d[0], d[1]))



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
                        qp: int):
    """Plain PyTorch version of :func:`encode_levels` with ``full_recon``:
    the JAX function's scan step as a Python loop over MB columns
    vectorised over MB rows, on the planes' device.  Returns (levels,
    recon_y, recon_cb, recon_cr, imode)."""
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

        # chroma
        czdc_cb, acz_cb, pred_cb = chroma_mb(cbsrc, cb_edge, left_ok)
        czdc_cr, acz_cr, pred_cr = chroma_mb(crsrc, cr_edge, left_ok)
        # reconstruction: the whole MB, whose right column is the next
        # column's edge
        dcd = _luma_dc_dequant(_h1d(_h1d(zdc, 1), 2), qp)
        pred_blk = pred_rows.reshape(mb_h, 4, 4)  # (row, by, r)
        d = _shl(acz * v_y[None, None, :, None, :], qp // 6)
        d[:, :, 0, :, 0] = dcd
        ry_mb = torch.clamp(_inv_blocks(d) + pred_blk[:, :, :, None, None],
                            0, 255).reshape(mb_h, 16, 16)
        rcb_mb = chroma_full(czdc_cb, acz_cb, pred_cb)
        rcr_mb = chroma_full(czdc_cr, acz_cr, pred_cr)
        y_edge = ry_mb[:, :, 15]
        cb_edge = rcb_mb[:, :, 7]
        cr_edge = rcr_mb[:, :, 7]

        zdc_flat = zdc.reshape(mb_h, 16)
        acz_flat = acz.permute(0, 1, 3, 2, 4).reshape(mb_h, 16, 16)
        out = [zdc_flat.to(torch.int16), acz_flat.to(torch.int16),
               torch.stack([czdc_cb, czdc_cr], 1).reshape(mb_h, 2, 4)
               .to(torch.int16),
               torch.stack([acz_cb.permute(0, 1, 3, 2, 4),
                            acz_cr.permute(0, 1, 3, 2, 4)], 1)
               .reshape(mb_h, 2, 4, 16).to(torch.int16),
               imode, ry_mb.to(torch.uint8), rcb_mb.to(torch.uint8),
               rcr_mb.to(torch.uint8)]
        outs.append(out)

    # stack the columns on axis 1: (mb_h, mb_w, ...)
    cols = [torch.stack(parts, 1) for parts in zip(*outs)]
    lv = LevelArrays(*cols[:4])
    imode = cols[4]
    ry, rcb, rcr = cols[5:]
    return (lv, ry.permute(0, 2, 1, 3).reshape(H, W),
            rcb.permute(0, 2, 1, 3).reshape(H // 2, W // 2),
            rcr.permute(0, 2, 1, 3).reshape(H // 2, W // 2),
            imode)


# ------------------------------------------------------- the packed lanes ----


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


def _plane_of(fy, fx, nplanes: int):
    """Plane index of fraction (fy, fx) in a stack of 1, 4 or 16 planes
    (the oracle's ``_plane_index``)."""
    if nplanes == 16:
        return fy * 4 + fx
    if nplanes == 4:
        return fy // 2 * 2 + fx // 2
    return fy * 0


def _check_search(y: torch.Tensor, ref, search: int, subpel: int) -> None:
    H, W = y.shape
    _check_planes(*ref)
    if tuple(ref[0].shape) != (H, W) or ref[0].device != y.device:
        raise ValueError(f"the reference must be ({H}, {W}) planes on {y.device}")
    if search < 1:
        raise ValueError(f"motion_search needs search >= 1, got {search}")
    search_plan(search, subpel)


def _mc_chroma(ref, mv: torch.Tensor):
    """The spec 8.4.2.2.2 chroma prediction at a quarter-pel field of one
    vector an 8 x 8 chroma block (an MB): mvC = mv in 1/8 chroma samples,
    integer part ``mv >> 3``, fraction ``mv & 7``, clamped coordinates (=
    the edge extension), uint8."""
    H, W = ref[0].shape
    ch, cw = H // 2, W // 2
    dev = mv.device
    mvg = mv.to(torch.int32).repeat_interleave(8, 0).repeat_interleave(8, 1)
    cdy, cdx = mvg[..., 0] >> 3, mvg[..., 1] >> 3
    fy, fx = mvg[..., 0] & 7, mvg[..., 1] & 7
    rbase = torch.arange(ch, device=dev)[:, None] + cdy
    cbase = torch.arange(cw, device=dev)[None, :] + cdx
    r0, r1 = rbase.clamp(0, ch - 1), (rbase + 1).clamp(0, ch - 1)
    c0, c1 = cbase.clamp(0, cw - 1), (cbase + 1).clamp(0, cw - 1)
    wa, wb = (8 - fx) * (8 - fy), fx * (8 - fy)
    wc, wd = (8 - fx) * fy, fx * fy
    out = []
    for comp in (1, 2):
        p = ref[comp].to(torch.int32)
        out.append(((wa * p[r0, c0] + wb * p[r0, c1] + wc * p[r1, c0]
                     + wd * p[r1, c1] + 32) >> 6).to(torch.uint8))
    return out


def motion_search_plain(y: torch.Tensor, ref, search: int, subpel: int = 0):
    """Plain version of :func:`motion_search` on one reference ``ref`` (its
    y, cb, cr): the reference's plane stack (:func:`subpel_planes_plain`),
    then :func:`search_stack_plain`."""
    _check_search(y, ref, search, subpel)
    P, margin = search_plan(search, subpel)
    return search_stack_plain(y, subpel_planes_plain(ref[0], margin, P), ref,
                              search, subpel)


def search_stack_plain(y: torch.Tensor, stack: torch.Tensor, ref, search: int,
                       subpel: int = 0):
    """Plain version of ``motion_search_kernel`` over the reference's planes
    ``stack`` ((P, H + 2m, W + 2m), :func:`search_plan`'s P and m): a loop
    over the candidates, each a full-frame SAD field summed in int32, with
    the strict ``<`` of the JAX loops; ``fastsub`` refines with per-MB
    gathers.  Returns (mv, pred_y, pred_cb, pred_cr)."""
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

    for idx, (qy, qx) in enumerate(cands.tolist()):
        p = _plane_of(qy & 3, qx & 3, P)
        iy, ix = margin + (qy >> 2), margin + (qx >> 2)
        refp = stack[p, iy:iy + H, ix:ix + W].to(torch.int32)
        sad = (cur - refp.reshape(mb_h, 16, mb_w, 16)).abs().sum(
            (1, 3), dtype=torch.int32).to(torch.int64)
        key = sad * SEARCH_KEY_RADIX + idx
        take = key < best_key
        best_key = torch.where(take, key, best_key)
        best_idx = torch.where(take, idx, best_idx)
    mv = torch.as_tensor(cands, device=dev).to(torch.int64)[best_idx]

    ri = (16 * rows[:, None, None] + torch.arange(16, device=dev)[None, None, :])
    ci = (16 * torch.arange(mb_w, device=dev)[None, :, None]
          + torch.arange(16, device=dev)[None, None, :])
    if subpel == 3:
        # the 49 quarter-pel offsets around each MB's full-pel winner
        curb = cur.permute(0, 2, 1, 3)                     # (mb_h, mb_w, 16, 16)
        v = mv >> 2
        rows0 = margin + ri + v[:, :, 0:1]                 # (mb_h, mb_w, 16)
        cols0 = margin + ci + v[:, :, 1:2]
        best_key = torch.full((mb_h, mb_w), big, dtype=torch.int64, device=dev)
        best_j = torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev)
        offs = fastsub_offsets()
        for j, (qy, qx) in enumerate(offs.tolist()):
            refp = stack[(qy & 3) * 4 + (qx & 3), (rows0 + (qy >> 2))[:, :, :, None],
                         (cols0 + (qx >> 2))[:, :, None, :]].to(torch.int32)
            sad = (curb - refp).abs().sum((2, 3), dtype=torch.int32).to(torch.int64)
            key = sad * SEARCH_KEY_RADIX + j
            take = key < best_key
            best_key = torch.where(take, key, best_key)
            best_j = torch.where(take, j, best_j)
        mv = mv + torch.as_tensor(offs, device=dev).to(torch.int64)[best_j]

    # luma MC: the winner's plane at the winner's integer offset
    pg = _plane_of(mv[:, :, 0] & 3, mv[:, :, 1] & 3, P)
    pred_y = stack[pg[:, :, None, None],
                   (margin + ri + (mv[:, :, 0:1] >> 2))[:, :, :, None],
                   (margin + ci + (mv[:, :, 1:2] >> 2))[:, :, None, :]]
    pred_y = pred_y.permute(0, 2, 1, 3).reshape(H, W)
    pred_cb, pred_cr = _mc_chroma(ref, mv)
    return mv.to(torch.int16), pred_y, pred_cb, pred_cr


def p_levels_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                   pred_y: torch.Tensor, pred_cb: torch.Tensor,
                   pred_cr: torch.Tensor, mv_zero: torch.Tensor, qp: int) -> tuple:
    """Plain version of H2 (the split grids of ``csrc/h264_levels.cu``
    for a P frame): the JAX ``encode_p_levels``
    scan step as a Python loop over MB columns, vectorised over MB rows.
    ``pred_*`` are the motion-compensated planes (the reference itself at
    zero motion), ``mv_zero`` (mb_h, mb_w) bool marks the MBs whose mv
    is (0, 0).  Returns (mode, zdc, acz, czdc, cacz, recon_y, recon_cb,
    recon_cr)."""
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
        # then intra on cost_i + INTRA_BIAS < cost_p
        cost_p = _cost_of(lz, czdc_cb_p, czdc_cr_p, cacz_cb_p, cacz_cr_p)
        cost_i = _cost_of(zdc_i, acz_i, czdc_cb_i, czdc_cr_i, cacz_cb_i,
                          cacz_cr_i) + INTRA_BIAS
        skip = (cost_p == 0) & mvzcols[mbx]
        use_intra = ~skip & (cost_i < cost_p)
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


def encode_p_levels_plain(y, cb, cr, ry, rcb, rcr, qp: int, search: int = 0,
                          subpel: int = 0) -> PLevelArrays:
    """Plain version of :func:`encode_p_levels` on one reference picture
    (``ry``, ``rcb``, ``rcr``): :func:`motion_search_plain` with ``search``,
    then :func:`p_levels_plain`, on the planes' device."""
    mb_h, mb_w = _check_planes(y, cb, cr)
    _check_planes(ry, rcb, rcr)
    if tuple(ry.shape) != tuple(y.shape) or ry.device != y.device:
        raise ValueError(f"the reference must be {tuple(y.shape)} planes on {y.device}")
    mv = None
    if search:
        mv, pred_y, pred_cb, pred_cr = motion_search_plain(y, (ry, rcb, rcr), search, subpel)
        mv_zero = (mv[..., 0] == 0) & (mv[..., 1] == 0)
    else:
        pred_y, pred_cb, pred_cr = ry, rcb, rcr
        mv_zero = torch.ones((mb_h, mb_w), dtype=torch.bool, device=y.device)
    out = p_levels_plain(y, cb, cr, pred_y, pred_cb, pred_cr, mv_zero, qp)
    return PLevelArrays(*out, mv)
