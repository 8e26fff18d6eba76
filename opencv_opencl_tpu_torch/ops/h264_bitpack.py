"""CAVLC bit packing on the card: the entropy stage's bit-level work beside
the level kernels (counterpart of ``opencv_opencl_tpu/ops/h264_bitpack.py``).

``total_coeff`` of every 4x4 block is a pure function of the quantized
levels, so every nC context is a shifted lookup (one slice per MB row: the
only neighbours are the left MB and the blocks above within the MB), and
the only sequential state (the level ``suffixLength``, the ``run_before``
countdown) lives inside a block.  :func:`pack_i_mbs` and :func:`pack_p_mbs`
write every MB of a frame as its CAVLC bit string (spec 7.3.5 and 9.2:
the MB header, then the residual blocks in bitstream order), MSB-first in
uint32 words, capped at ``nw_mb`` words an MB: an MB over the cap reports
its true bit count with truncated words, and the caller codes such a frame
on the host entropy path instead (byte-identical by construction), so the
cap is a transfer size, not a correctness bound.  The host keeps the slice
headers, the concatenation, the trailing bits and emulation prevention
(:func:`assemble_slices_from_bits`, numpy bit moves, no VLC work).

On CUDA tensors the packers launch ``pack_i_kernel`` / ``pack_p_kernel``
(``csrc/h264_bitpack.cu``, a warp per run of MBs of a row; wrappers in
``ops/cuda/h264_bitpack.py``) or raise; on CPU tensors they run
:func:`pack_i_mbs_plain` / :func:`pack_p_mbs_plain`, twins of the JAX
functions' vectorised programs (the token slots of :func:`block_tokens`,
:func:`pack_tokens`, :func:`concat_pieces`) in int64 torch.  The words and
bit counts equal the JAX functions' on the same levels.

The VLC tables are built from the port's ``io/h264_cavlc.py`` dicts (spec
tables 9-5 to 9-10) and ``io/h264_inter.py``'s ``_CBP_INTER_CODENUM``, as the
JAX module builds them; :func:`vlc_table` lays them out for the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.io.h264_cavlc import (_CBP_INTRA_CODE, _CT_NC0, _CT_NC2,
                                                   _CT_NC4, _CT_NCM1, _RUN_BEFORE, _TZ,
                                                   _TZ_CDC, _ZIGZAG)
from opencv_opencl_tpu_torch.io.h264_inter import _CBP_INTER_CODENUM

__all__ = ["NT_BLOCK", "NW_BLOCK", "block_tokens", "pack_tokens", "concat_pieces",
           "pack_i_mbs", "pack_i_mbs_plain", "pack_p_mbs", "pack_p_mbs_plain",
           "synthetic_p_fields", "assemble_slices_from_bits", "vlc_table", "VLC_OFFSETS"]

# ---------------------------------------------------------------- tables ----

# coeff_token (spec 9-5), [nC class][total][trailing ones] -> length / code
_CT_LEN = np.zeros((3, 17, 4), np.int32)
_CT_CODE = np.zeros((3, 17, 4), np.int32)
for _k, _tab in enumerate((_CT_NC0, _CT_NC2, _CT_NC4)):
    for (_t, _t1), (_ln, _cd) in _tab.items():
        _CT_LEN[_k, _t, _t1] = _ln
        _CT_CODE[_k, _t, _t1] = _cd
_CDC_LEN = np.zeros((5, 4), np.int32)
_CDC_CODE = np.zeros((5, 4), np.int32)
for (_t, _t1), (_ln, _cd) in _CT_NCM1.items():
    _CDC_LEN[_t, _t1] = _ln
    _CDC_CODE[_t, _t1] = _cd
# total_zeros (9-7, 9-8), [total][zeros], total 1..15
_TZ_LEN = np.zeros((16, 16), np.int32)
_TZ_CODE = np.zeros((16, 16), np.int32)
for _t, _rows in _TZ.items():
    for _z, (_ln, _cd) in enumerate(_rows):
        _TZ_LEN[_t, _z] = _ln
        _TZ_CODE[_t, _z] = _cd
# chroma DC total_zeros (9-9a), total 1..3
_TZC_LEN = np.zeros((4, 4), np.int32)
_TZC_CODE = np.zeros((4, 4), np.int32)
for _t, _rows in _TZ_CDC.items():
    for _z, (_ln, _cd) in enumerate(_rows):
        _TZC_LEN[_t, _z] = _ln
        _TZC_CODE[_t, _z] = _cd
# run_before (9-10), [min(zeros_left, 7)][run]
_RB_LEN = np.zeros((8, 15), np.int32)
_RB_CODE = np.zeros((8, 15), np.int32)
for _zl, _rows in _RUN_BEFORE.items():
    for _r, (_ln, _cd) in enumerate(_rows):
        _RB_LEN[_zl, _r] = _ln
        _RB_CODE[_zl, _r] = _cd

_ZZ = np.asarray(_ZIGZAG, np.int64)
# luma AC piece order: the bitstream's (bx, by) block order as by*4+bx
_LUMA_SCAN = np.asarray(
    [by * 4 + bx for bx, by in
     [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
      (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]],
    np.int64)
# z-scan index of the raster 4x4 block [by * 4 + bx] (an involution: it
# also maps z to raster), and the (bx, by) of z-scan position z
_Z_OF_RASTER = np.asarray([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15],
                          np.int64)
_I4_SCAN_BXBY = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
                 (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3))
# each raster 4x4 block's 8x8 quadrant (bx >= 2) + 2 (by >= 2)
_BLOCK_QUAD = np.asarray([(bx >= 2) + 2 * (by >= 2) for by in range(4) for bx in range(4)],
                         np.int64)

# token slots per residual block: coeff_token, trailing-one signs, 16
# levels, total_zeros, 14 run_before
NT_BLOCK = 33
# a block's bit bound: 16 + 3 + 16*28 + 9 + 14*11 = 630, 20 words
NW_BLOCK = 20

# the kernels' table: every table above as int32, in this order
_VLC_PARTS = (("ct_len", _CT_LEN), ("ct_code", _CT_CODE), ("cdc_len", _CDC_LEN),
              ("cdc_code", _CDC_CODE), ("tz_len", _TZ_LEN), ("tz_code", _TZ_CODE),
              ("tzc_len", _TZC_LEN), ("tzc_code", _TZC_CODE), ("rb_len", _RB_LEN),
              ("rb_code", _RB_CODE), ("cbp_inter", _CBP_INTER_CODENUM),
              ("cbp_intra", _CBP_INTRA_CODE))
VLC_OFFSETS: dict[str, int] = {}
_off = 0
for _name, _a in _VLC_PARTS:
    VLC_OFFSETS[_name] = _off
    _off += _a.size


def vlc_table() -> np.ndarray:
    """Every VLC table the packers read, flattened into one int32 array at
    :data:`VLC_OFFSETS` (the order ``csrc/h264_bitpack.cu``'s ``Vlc``
    expects)."""
    return np.concatenate([np.asarray(a, np.int64).reshape(-1) for _, a in _VLC_PARTS]
                          ).astype(np.int32)


_TENSORS: dict = {}


def _t(name: str, a: np.ndarray, dev: torch.device) -> torch.Tensor:
    key = (name, str(dev))
    if key not in _TENSORS:
        _TENSORS[key] = torch.as_tensor(np.asarray(a, np.int64), device=dev)
    return _TENSORS[key]


# --------------------------------------------------------------- tokens ----

def _ue_token(v: torch.Tensor):
    """Exp-Golomb ue(v) as one (value, length) token (v < 2^15)."""
    code = v + 1
    nbits = torch.zeros_like(v)
    for k in range(16):
        nbits = nbits + (code > ((1 << k) - 1)).to(v.dtype)
    return code, 2 * nbits - 1


def _se_token(v: torch.Tensor):
    return _ue_token(torch.where(v > 0, 2 * v - 1, -2 * v))


def block_tokens(lv: torch.Tensor, nc: torch.Tensor, max_coeffs: int, cdc: bool):
    """Tokenise residual blocks (spec 9.2): ``lv`` (..., C) scanned
    coefficients (low to high frequency), ``nc`` the (...)-shaped nC
    context (ignored with ``cdc``, the chroma DC blocks).  Returns (vals,
    lens), each (..., NT_BLOCK) int64; slots of length 0 are no-ops.  The
    JAX ``block_tokens``, slot for slot."""
    C = lv.shape[-1]
    dev = lv.device
    lv = lv.to(torch.int64)
    nzm = (lv != 0).to(torch.int64)
    total = nzm.sum(-1)
    # rank from the high-frequency end (rank 0: the highest nonzero)
    rank = nzm.flip(-1).cumsum(-1).flip(-1) - nzm
    R = torch.where(nzm > 0, rank, C)
    ar = torch.arange(C, device=dev)
    onehot = (R[..., None, :] == ar[:, None]).to(torch.int64)
    vr = (onehot * lv[..., None, :]).sum(-1)              # value at each rank
    pr = (onehot * ar).sum(-1)                            # its position
    av = vr.abs()
    a0 = (av[..., 0] == 1) & (total >= 1)
    a1 = a0 & (av[..., 1] == 1) & (total >= 2) if C > 1 else a0 & False
    a2 = a1 & (av[..., 2] == 1) & (total >= 3) if C > 2 else a1 & False
    t1s = a0.to(torch.int64) + a1.to(torch.int64) + a2.to(torch.int64)

    vals, lens = [], []
    # slot 0: coeff_token
    if cdc:
        ct_len = _t("cdc_len", _CDC_LEN, dev)[total, t1s]
        ct_code = _t("cdc_code", _CDC_CODE, dev)[total, t1s]
    else:
        nc = nc.to(torch.int64)
        tab = torch.where(nc < 2, 0, torch.where(nc < 4, 1, 2))
        flc = nc >= 8
        ct_len = torch.where(flc, 6, _t("ct_len", _CT_LEN, dev)[tab, total, t1s])
        ct_code = torch.where(
            flc, torch.where(total == 0, 0b000011, ((total - 1) << 2) | t1s),
            _t("ct_code", _CT_CODE, dev)[tab, total, t1s])
    vals.append(ct_code)
    lens.append(ct_len)
    # slot 1: the trailing-one signs (high frequency first, 1 negative)
    signs = torch.zeros_like(total)
    for j in range(min(3, C)):
        signs = torch.where(j < t1s, (signs << 1) | (vr[..., j] < 0).to(torch.int64), signs)
    vals.append(signs)
    lens.append(t1s)
    # slots 2 .. 2 + C - 1: the other levels, high frequency first
    suffix_len = torch.where((total > 10) & (t1s < 3), 1, 0)
    for r in range(C):
        emit = (r >= t1s) & (r < total)
        c = vr[..., r]
        lc = torch.where(c > 0, 2 * c - 2, -2 * c - 1)
        lc = lc - 2 * ((r == t1s) & (t1s < 3)).to(torch.int64)
        sl = suffix_len
        # the prefix and the suffix merged into one token a case
        prefix = lc >> sl.clamp(0, 6)
        esc = torch.where(sl == 0, lc >= 30, prefix >= 15)
        mid0 = (sl == 0) & (lc >= 14) & (lc < 30)         # the prefix-14 escape
        v_pl = torch.where(sl == 0, torch.where(mid0, (1 << 4) | (lc - 14), 1),
                           (1 << sl) | (lc & ((1 << sl) - 1)))
        l_pl = torch.where(sl == 0, torch.where(mid0, 19, lc + 1), prefix + 1 + sl)
        v_esc = (1 << 12) | (lc - torch.where(sl == 0, 30, 15 << sl))
        vals.append(torch.where(emit, torch.where(esc, v_esc, v_pl), 0))
        lens.append(torch.where(emit, torch.where(esc, 28, l_pl), 0))
        # the state update, in the oracle's order
        sl2 = torch.where(sl == 0, 1, sl)
        sl2 = sl2 + ((c.abs() > (3 << (sl2 - 1).clamp(0, 5))) & (sl2 < 6)).to(torch.int64)
        suffix_len = torch.where(emit, sl2, sl)
    for _ in range(C, 16):
        vals.append(torch.zeros_like(total))
        lens.append(torch.zeros_like(total))
    # slot 18: total_zeros
    tz = pr[..., 0] + 1 - total
    emit_tz = (total > 0) & (total < max_coeffs)
    if cdc:
        ti, zi = total.clamp(0, 3), tz.clamp(0, 3)
        tz_len, tz_code = _t("tzc_len", _TZC_LEN, dev)[ti, zi], _t("tzc_code", _TZC_CODE, dev)[ti, zi]
    else:
        ti, zi = total.clamp(0, 15), tz.clamp(0, 15)
        tz_len, tz_code = _t("tz_len", _TZ_LEN, dev)[ti, zi], _t("tz_code", _TZ_CODE, dev)[ti, zi]
    vals.append(torch.where(emit_tz, tz_code, 0))
    lens.append(torch.where(emit_tz, tz_len, 0))
    # slots 19 ..: run_before (high frequency first; the lowest coefficient
    # carries no run); tz is garbage when total == 0, but then every slot
    # is gated off
    zl = tz
    rb_len, rb_code = _t("rb_len", _RB_LEN, dev), _t("rb_code", _RB_CODE, dev)
    for r in range(min(C - 1, 14)):
        emit = (r <= total - 2) & (zl > 0)
        run = pr[..., r] - (pr[..., r + 1] if r + 1 < C else torch.zeros_like(total)) - 1
        runc = run.clamp(0, 14)
        zlc = zl.clamp(0, 7)
        vals.append(torch.where(emit, rb_code[zlc, runc], 0))
        lens.append(torch.where(emit, rb_len[zlc, runc], 0))
        zl = zl - torch.where(emit, runc, 0)
    while len(vals) < NT_BLOCK:
        vals.append(torch.zeros_like(total))
        lens.append(torch.zeros_like(total))
    return torch.stack(vals, -1), torch.stack(lens, -1)


def pack_tokens(vals: torch.Tensor, lens: torch.Tensor, nw: int):
    """Pack (..., NT) (value, length) tokens into (..., nw) MSB-first words
    (int64 holding uint32) and the bit count; bits beyond the count are 0."""
    nt = vals.shape[-1]
    words = torch.zeros(vals.shape[:-1] + (nw,), dtype=torch.int64, device=vals.device)
    pos = torch.zeros(vals.shape[:-1], dtype=torch.int64, device=vals.device)
    widx = torch.arange(nw, device=vals.device)
    mask = 0xFFFFFFFF
    for k in range(nt):
        v = vals[..., k] & mask
        ln = lens[..., k]
        wi = pos >> 5
        rem = 32 - (pos & 31)
        spill = ln > rem
        hi = torch.where(spill, v >> (ln - rem).clamp(0, 31),
                         (v << (rem - ln).clamp(0, 31)) & mask)
        lo = torch.where(spill, (v << (32 - (ln - rem)).clamp(1, 31)) & mask, 0)
        words = (words
                 | torch.where(widx == wi[..., None], hi[..., None], 0)
                 | torch.where(widx == wi[..., None] + 1, lo[..., None], 0))
        pos = pos + ln
    return words, pos


def concat_pieces(piece_words: torch.Tensor, piece_bits: torch.Tensor, nw_out: int):
    """Concatenate P bit strings a lane: ``piece_words`` (..., P, NWp) int64
    words, ``piece_bits`` (..., P).  Returns ((..., nw_out) words, the total
    bit count); bits beyond each piece's count must be 0, bits beyond the
    ``nw_out`` words are dropped."""
    P, nwp = piece_words.shape[-2], piece_words.shape[-1]
    dev = piece_words.device
    out = torch.zeros(piece_words.shape[:-2] + (nw_out,), dtype=torch.int64, device=dev)
    pos = torch.zeros(piece_words.shape[:-2], dtype=torch.int64, device=dev)
    oidx = torch.arange(nw_out, device=dev)
    mask = 0xFFFFFFFF
    zero = torch.zeros(piece_words.shape[:-2] + (1,), dtype=torch.int64, device=dev)
    for p in range(P):
        w = piece_words[..., p, :]
        off = (pos & 31)[..., None]
        # the piece shifted right by off, carried across words (+1 word)
        wl = torch.cat([zero, w], -1)
        wr = torch.cat([w, zero], -1)
        carry = torch.where(off > 0, (wl << (32 - off).clamp(0, 31)) & mask, 0)
        shifted = (wr >> off) | carry
        rel = oidx - (pos >> 5)[..., None]
        ok = (rel >= 0) & (rel <= nwp)
        gathered = torch.gather(shifted, -1, rel.clamp(0, nwp))
        out = out | torch.where(ok, gathered, 0)
        pos = pos + piece_bits[..., p]
    return out, pos


def _as_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding uint32 values as a uint32 tensor (through an
    exact int32 bit pattern)."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32).view(
        torch.uint32)


# ------------------------------------------------------------ contexts ----

def _luma_nc(lnnz: torch.Tensor):
    """nC of the 16 luma blocks of every MB (left across MBs, top within the
    MB) from ``lnnz`` (mb_h, mb_w, 16) total_coeff: (nc (mb_h, mb_w, 16),
    the luma DC block's nc (mb_h, mb_w))."""
    mb_h, mb_w = lnnz.shape[:2]
    grid = lnnz.reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3).reshape(mb_h, 4, mb_w * 4)
    left = torch.nn.functional.pad(grid, (1, 0))[:, :, :-1]
    top = torch.nn.functional.pad(grid, (0, 0, 1, 0))[:, :-1, :]
    x = torch.arange(mb_w * 4, device=lnnz.device)
    nc0 = left[:, 0:1]
    ncn = torch.where(x > 0, (left[:, 1:] + top[:, 1:] + 1) >> 1, top[:, 1:])
    nc = torch.cat([nc0, ncn], 1)
    nc = nc.reshape(mb_h, 4, mb_w, 4).permute(0, 2, 1, 3).reshape(mb_h, mb_w, 16)
    return nc, left[:, 0].reshape(mb_h, mb_w, 4)[:, :, 0]


def _chroma_nc(cnnz: torch.Tensor) -> torch.Tensor:
    """nC of one component's 4 chroma AC blocks from ``cnnz`` (mb_h, mb_w, 4)."""
    mb_h, mb_w = cnnz.shape[:2]
    grid = cnnz.reshape(mb_h, mb_w, 2, 2).permute(0, 2, 1, 3).reshape(mb_h, 2, mb_w * 2)
    left = torch.nn.functional.pad(grid, (1, 0))[:, :, :-1]
    top = torch.nn.functional.pad(grid, (0, 0, 1, 0))[:, :-1, :]
    x = torch.arange(mb_w * 2, device=cnnz.device)
    ncn = torch.where(x > 0, (left[:, 1:] + top[:, 1:] + 1) >> 1, top[:, 1:])
    nc = torch.cat([left[:, 0:1], ncn], 1)
    return nc.reshape(mb_h, 2, mb_w, 2).permute(0, 2, 1, 3).reshape(mb_h, mb_w, 4)


def _gate(w: torch.Tensor, n: torch.Tensor, g: torch.Tensor):
    """Pieces (words (..., NW), bits (...)) kept where ``g`` (...) is 1."""
    g = g.to(torch.int64)
    return w * g[..., None], n * g


def _residual_pieces(zdc, acz, czdc, cacz, nc_l, nc_dc, nc_c, dc_gate, ac16_gate,
                     ac15_gate, c_gate_dc, c_gate_ac):
    """The 27 residual pieces of every MB in bitstream order (luma DC, 16
    luma blocks, 2 chroma DC, 8 chroma AC), gated: the luma blocks as 15
    coefficients plus DC where ``ac15_gate`` is 1 and as 16 where
    ``ac16_gate`` is 1 (each (mb_h, mb_w, 16) in raster block order)."""
    mb_h, mb_w = zdc.shape[:2]
    dev = zdc.device
    zz = torch.as_tensor(_ZZ, device=dev)
    dc_w, dc_n = pack_tokens(*block_tokens(zdc[..., zz], nc_dc, 16, False), NW_BLOCK)
    dc_w, dc_n = _gate(dc_w, dc_n, dc_gate)
    ac_w = torch.zeros((mb_h, mb_w, 16, NW_BLOCK), dtype=torch.int64, device=dev)
    ac_n = torch.zeros((mb_h, mb_w, 16), dtype=torch.int64, device=dev)
    if ac15_gate is not None:
        w, n = pack_tokens(*block_tokens(acz[..., zz[1:]], nc_l, 15, False), NW_BLOCK)
        w, n = _gate(w, n, ac15_gate)
        ac_w, ac_n = ac_w + w, ac_n + n
    if ac16_gate is not None:
        w, n = pack_tokens(*block_tokens(acz[..., zz], nc_l, 16, False), NW_BLOCK)
        w, n = _gate(w, n, ac16_gate)
        ac_w, ac_n = ac_w + w, ac_n + n
    scan = torch.as_tensor(_LUMA_SCAN, device=dev)
    ac_w, ac_n = ac_w[:, :, scan], ac_n[:, :, scan]
    cdc_w, cdc_n = pack_tokens(*block_tokens(czdc, torch.zeros_like(czdc[..., 0]), 4, True),
                               NW_BLOCK)
    cdc_w, cdc_n = _gate(cdc_w, cdc_n, c_gate_dc[..., None].expand(mb_h, mb_w, 2))
    cac_w, cac_n = pack_tokens(*block_tokens(cacz[..., zz[1:]], nc_c, 15, False), NW_BLOCK)
    cac_w, cac_n = _gate(cac_w, cac_n, c_gate_ac[..., None, None].expand(mb_h, mb_w, 2, 4))
    return (torch.cat([dc_w[:, :, None], ac_w, cdc_w, cac_w.reshape(mb_h, mb_w, 8, NW_BLOCK)],
                      2),
            torch.cat([dc_n[:, :, None], ac_n, cdc_n, cac_n.reshape(mb_h, mb_w, 8)], 2))


def _pad_words(w: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(w, (0, NW_BLOCK - w.shape[-1]))


# ------------------------------------------------------------- I frames ----

def pack_i_mbs_plain(zdc, acz, czdc, cacz, imode, nw_mb: int = 64, i4modes=None,
                     cmode=None):
    """Plain version of :func:`pack_i_mbs`, on the levels' device."""
    mb_h, mb_w = zdc.shape[:2]
    dev = zdc.device
    zdc, acz, czdc, cacz = (a.to(torch.int64) for a in (zdc, acz, czdc, cacz))
    lnnz = (acz != 0).to(torch.int64).sum(-1)
    cnnz = (cacz != 0).to(torch.int64).sum(-1)            # (mb_h, mb_w, 2, 4)
    cbp_luma = (lnnz.sum(-1) > 0).to(torch.int64)
    cbp_chroma = torch.where((cacz != 0).flatten(2).any(-1), 2,
                             torch.where((czdc != 0).flatten(2).any(-1), 1, 0))
    nc_l, nc_dc = _luma_nc(lnnz)
    nc_c = torch.stack([_chroma_nc(cnnz[:, :, 0]), _chroma_nc(cnnz[:, :, 1])], 2)

    pm = (torch.full((mb_h, mb_w), 2, dtype=torch.int64, device=dev) if imode is None
          else imode.to(torch.int64))
    i4sel = (pm == 0) if i4modes is not None else None
    cmv = (torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev) if cmode is None
           else cmode.to(torch.int64))
    cm_v, cm_l = _ue_token(cmv)
    uev, uel = _ue_token(1 + pm + 4 * cbp_chroma + 12 * cbp_luma)
    ones = torch.ones((mb_h, mb_w), dtype=torch.int64, device=dev)
    # which 8x8 quadrants hold levels (the cbp's luma bits)
    blk = (lnnz > 0).reshape(mb_h, mb_w, 4, 4)
    quad = torch.stack([blk[:, :, :2, :2].flatten(2).any(-1), blk[:, :, :2, 2:].flatten(2).any(-1),
                        blk[:, :, 2:, :2].flatten(2).any(-1), blk[:, :, 2:, 2:].flatten(2).any(-1)],
                       -1).to(torch.int64)
    if i4sel is None:
        # mb_type ue, intra_chroma_pred_mode ue, mb_qp_delta se(0)
        hdr_w, hdr_n = pack_tokens(torch.stack([uev, cm_v, ones], -1),
                                   torch.stack([uel, cm_l, ones], -1), 2)
    else:
        zm = i4modes.to(torch.int64)                      # (mb_h, mb_w, 16) z-scan
        cbp4 = (quad[..., 0] | (quad[..., 1] << 1) | (quad[..., 2] << 2)
                | (quad[..., 3] << 3) | (cbp_chroma << 4))
        cbp4_v, cbp4_l = _ue_token(_t("cbp_intra", _CBP_INTRA_CODE, dev)[cbp4])
        l_is_i4 = torch.cat([torch.zeros((mb_h, 1), dtype=torch.bool, device=dev),
                             i4sel[:, :-1]], 1)
        lzm = torch.cat([torch.full((mb_h, 1, 16), 2, dtype=torch.int64, device=dev),
                         zm[:, :-1]], 1)
        avail = torch.arange(mb_w, device=dev)[None, :].expand(mb_h, mb_w) > 0
        zof = _Z_OF_RASTER.reshape(4, 4)                  # [by][bx] -> z
        mode_v, mode_l = [], []
        for z in range(16):
            bx, by = _I4_SCAN_BXBY[z]
            if by == 0:
                predm = torch.full((mb_h, mb_w), 2, dtype=torch.int64, device=dev)
            else:
                top = zm[:, :, int(zof[by - 1][bx])]
                if bx > 0:
                    predm = torch.minimum(zm[:, :, int(zof[by][bx - 1])], top)
                else:
                    la = torch.where(l_is_i4, lzm[:, :, int(zof[by][3])], 2)
                    predm = torch.where(avail, torch.minimum(la, top), 2)
            m = zm[:, :, z]
            match = m == predm
            mode_v.append(torch.where(match, 1, torch.where(m < predm, m, m - 1)))
            mode_l.append(torch.where(match, 1, 4))
        zero = torch.zeros_like(ones)
        hdr_v = torch.stack([torch.where(i4sel, 1, uev),
                             *[torch.where(i4sel, v, 0) for v in mode_v], cm_v,
                             torch.where(i4sel, cbp4_v, ones), torch.where(i4sel, ones, 0)], -1)
        hdr_l = torch.stack([torch.where(i4sel, 1, uel),
                             *[torch.where(i4sel, ln, 0) for ln in mode_l], cm_l,
                             torch.where(i4sel, cbp4_l, ones),
                             torch.where(i4sel, (cbp4 != 0).to(torch.int64), zero)], -1)
        hdr_w, hdr_n = pack_tokens(hdr_v, hdr_l, 4)
    hdr_w = _pad_words(hdr_w)

    bq = torch.as_tensor(_BLOCK_QUAD, device=dev)
    if i4sel is None:
        dc_gate, g15, g16 = ones, cbp_luma[..., None].expand(mb_h, mb_w, 16), None
    else:
        i16 = (~i4sel).to(torch.int64)
        dc_gate = i16
        g15 = (i16 * cbp_luma)[..., None].expand(mb_h, mb_w, 16)
        g16 = i4sel.to(torch.int64)[..., None] * quad[:, :, bq]
    res_w, res_n = _residual_pieces(zdc, acz, czdc, cacz, nc_l, nc_dc, nc_c, dc_gate,
                                    g16, g15, cbp_chroma >= 1, cbp_chroma == 2)
    words, nbits = concat_pieces(torch.cat([hdr_w[:, :, None], res_w], 2),
                                 torch.cat([hdr_n[:, :, None], res_n], 2), nw_mb)
    return _as_uint32(words), nbits.to(torch.int32)


def pack_i_mbs(zdc, acz, czdc, cacz, imode, nw_mb: int = 64, i4modes=None, cmode=None):
    """Pack every MB of one intra frame (one I slice per MB row) into its
    CAVLC bit string: the I slice's MB syntax (mb_type; with Intra_4x4 MBs
    the 16 prediction modes against the one-row-slice predicted mode;
    ``intra_chroma_pred_mode``; ``mb_qp_delta``) and the residual blocks
    gated by the cbp, in the spec's order.  The levels are
    :class:`ops.h264_levels.LevelArrays`'s (``imode`` 0 marks Intra_4x4
    MBs, whose ``acz`` blocks carry 16 coefficients and ``i4modes`` their
    z-scan modes; ``cmode`` the chroma modes).  Returns (words (mb_h, mb_w,
    nw_mb) uint32 MSB-first, nbits (mb_h, mb_w) int32); an MB over the cap
    reports its true nbits with truncated words.  The JAX ``pack_i_mbs``;
    its oracle ``io.h264_cavlc.encode_frame_from_levels``.

    On CUDA tensors it launches ``pack_i_kernel``; on CPU tensors it runs
    :func:`pack_i_mbs_plain`."""
    from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as kernel

    return kernel.pack_i_mbs(zdc, acz, czdc, cacz, imode, nw_mb, i4modes, cmode)


# ------------------------------------------------------------- P frames ----

def _median3(a, b, c):
    return torch.maximum(torch.minimum(a, b), torch.minimum(torch.maximum(a, b), c))


def _mvp_general_vec(amv, aref, aav, bmv, bref, bav, cmv, cref, cav, myref):
    """Spec 8.4.1.3.1's general process, vectorised (the JAX
    ``_mvp_general_vec``): the copy rule, the exactly-one-refIdx-match rule,
    else the component median.  mv (..., 2), ref (...), av (...) bool."""
    eamv = torch.where(aav[..., None], amv, 0)
    ebmv = torch.where(bav[..., None], bmv, 0)
    ecmv = torch.where(cav[..., None], cmv, 0)
    ear = torch.where(aav, aref, -1)
    ebr = torch.where(bav, bref, -1)
    ecr = torch.where(cav, cref, -1)
    copy = ~bav & ~cav & aav
    ma, mb_, mc = ear == myref, ebr == myref, ecr == myref
    nm = ma.to(torch.int64) + mb_.to(torch.int64) + mc.to(torch.int64)
    sel = torch.where(ma[..., None], eamv, torch.where(mb_[..., None], ebmv, ecmv))
    out = torch.where((nm == 1)[..., None], sel, _median3(eamv, ebmv, ecmv))
    return torch.where(copy[..., None], eamv, out)


def pack_p_mbs_plain(mode, zdc, acz, czdc, cacz, mv, ref, active_refs: int,
                     nw_mb: int = 64, pmode=None, mv4=None, ref4=None):
    """Plain version of :func:`pack_p_mbs`, on the levels' device."""
    mb_h, mb_w = mode.shape
    dev = mode.device
    mode = mode.to(torch.int64)
    zdc, acz, czdc, cacz = (a.to(torch.int64) for a in (zdc, acz, czdc, cacz))
    active_refs = int(active_refs)
    mv = (torch.zeros((mb_h, mb_w, 2), dtype=torch.int64, device=dev) if mv is None
          else mv.to(torch.int64))
    refsel = (torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev) if ref is None
              else ref.to(torch.int64))
    coded = mode != 0
    intra = mode >= 2
    ci = coded.to(torch.int64)

    # nC: nnz is a pure function of the levels, zeroed at skips
    lnnz = (acz != 0).to(torch.int64).sum(-1) * ci[..., None]
    cnnz = (cacz != 0).to(torch.int64).sum(-1) * ci[..., None, None]
    nc_l, nc_dc = _luma_nc(lnnz)
    nc_c = torch.stack([_chroma_nc(cnnz[:, :, 0]), _chroma_nc(cnnz[:, :, 1])], 2)
    cbp_chroma = torch.where((cacz != 0).flatten(2).any(-1), 2,
                             torch.where((czdc != 0).flatten(2).any(-1), 1, 0)) * ci
    cbp_luma_i = (lnnz.sum(-1) > 0).to(torch.int64)
    blk = (lnnz > 0).reshape(mb_h, mb_w, 4, 4)
    quad = torch.stack([blk[:, :, :2, :2].flatten(2).any(-1), blk[:, :, :2, 2:].flatten(2).any(-1),
                        blk[:, :, 2:, :2].flatten(2).any(-1), blk[:, :, 2:, 2:].flatten(2).any(-1)],
                       -1).to(torch.int64)
    cbp = quad[..., 0] | (quad[..., 1] << 1) | (quad[..., 2] << 2) | (quad[..., 3] << 3) | (
        cbp_chroma << 4)

    # the skip run before each coded MB
    xs = torch.arange(mb_w, device=dev)
    prev = torch.cummax(torch.where(coded, xs, -1), 1).values
    prev = torch.cat([torch.full((mb_h, 1), -1, dtype=torch.int64, device=dev), prev[:, :-1]], 1)
    sr_v, sr_l = _ue_token(xs - prev - 1)

    one = torch.ones((mb_h, mb_w), dtype=torch.int64, device=dev)
    zero = torch.zeros_like(one)
    pm = torch.where(mode == 3, 1, 2)
    mbt_i_v, mbt_i_l = _ue_token(5 + 1 + pm + 4 * cbp_chroma + 12 * cbp_luma_i)
    cbp_v, cbp_l = _ue_token(_t("cbp_inter", _CBP_INTER_CODENUM, dev)[cbp])
    dqp_l = (cbp != 0).to(torch.int64)
    ii = intra.to(torch.int64)
    left_inter = torch.cat([torch.zeros((mb_h, 1), dtype=torch.bool, device=dev),
                            (mode == 1)[:, :-1]], 1)
    if pmode is None:
        # the predictor: the left MB's vector when it is inter (skip
        # carries (0, 0), intra resets to (0, 0))
        left_mv = torch.cat([torch.zeros((mb_h, 1, 2), dtype=torch.int64, device=dev),
                             mv[:, :-1]], 1)
        mvd = mv - torch.where(left_inter[..., None], left_mv, 0)
        ref_l = torch.where(~intra & (active_refs == 2), 1, 0)
        ref_v = torch.where(ref_l > 0, 1 - refsel, 0)
        mvdx_v, mvdx_l = _se_token(mvd[..., 1])
        mvdy_v, mvdy_l = _se_token(mvd[..., 0])
        hdr_v = torch.stack([sr_v, torch.where(intra, mbt_i_v, 1),
                             torch.where(intra, one, ref_v), torch.where(intra, one, mvdx_v),
                             torch.where(intra, 0, mvdy_v), torch.where(intra, 0, cbp_v),
                             torch.where(intra, 0, one), zero], -1)
        hdr_l = torch.stack([sr_l, torch.where(intra, mbt_i_l, 1),
                             torch.where(intra, one, ref_l), torch.where(intra, one, mvdx_l),
                             torch.where(intra, 0, mvdy_l), torch.where(intra, 0, cbp_l),
                             torch.where(intra, 0, dqp_l), zero], -1)
        hdr_w, hdr_n = pack_tokens(hdr_v, hdr_l, 3)
    else:
        # the partitioned header: mb_type = pmode, four sub_mb_type 0 with
        # P_8x8, te(v) refs and the mvds against the reference-aware
        # predictor of each partition
        pmode = pmode.to(torch.int64)
        mv4 = mv4.to(torch.int64)
        r4 = (torch.zeros((mb_h, mb_w, 4), dtype=torch.int64, device=dev) if ref4 is None
              else ref4.to(torch.int64))
        left_avail = (xs[None, :] > 0).expand(mb_h, mb_w)
        lmv = torch.cat([torch.zeros((mb_h, 1, 4, 2), dtype=torch.int64, device=dev),
                         mv4[:, :-1]], 1)
        lrf = torch.cat([torch.zeros((mb_h, 1, 4), dtype=torch.int64, device=dev),
                         r4[:, :-1]], 1)
        lskip = torch.cat([torch.zeros((mb_h, 1), dtype=torch.bool, device=dev),
                           (mode == 0)[:, :-1]], 1)
        lmv = torch.where(lskip[..., None, None], 0, lmv)
        lrf = torch.where(lskip[..., None], 0, lrf)
        li = left_inter | lskip
        a1mv = torch.where(li[..., None], lmv[:, :, 1], 0)
        a3mv = torch.where(li[..., None], lmv[:, :, 3], 0)
        a1r = torch.where(li, lrf[:, :, 1], -1)
        a3r = torch.where(li, lrf[:, :, 3], -1)
        false = torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
        true = ~false
        z2 = torch.zeros((mb_h, mb_w, 2), dtype=torch.int64, device=dev)
        zr = torch.full((mb_h, mb_w), -1, dtype=torch.int64, device=dev)
        own = [mv4[:, :, q] for q in range(4)]
        ownr = [r4[:, :, q] for q in range(4)]
        reps = torch.as_tensor([[0, 0, 0, 0], [0, 2, 0, 0], [0, 1, 0, 0], [0, 1, 2, 3]],
                               device=dev)[pmode]
        nparts = torch.as_tensor([1, 2, 2, 4], device=dev)[pmode]
        mvd_v, mvd_l, ref_vs, ref_ls = [], [], [], []
        for p in range(4):
            rep = reps[:, :, p]
            myref = torch.gather(r4, 2, rep[..., None])[..., 0]
            pmv = torch.gather(mv4, 2, rep[..., None, None].expand(mb_h, mb_w, 1, 2))[:, :, 0]
            if p == 0:
                mvp = _mvp_general_vec(a1mv, a1r, left_avail, z2, zr, false, z2, zr, false,
                                       myref)
            elif p == 1:
                # 16x8 bottom: the directional rule (left q3 on a refIdx
                # match), else general(A left q3, B own top, C -> D left
                # q1); 8x16 right and 8x8 q1: the copy rule, own q0
                dirm = left_avail & (a3r == myref)
                gen = _mvp_general_vec(a3mv, a3r, left_avail, own[0], ownr[0], true,
                                       a1mv, a1r, left_avail, myref)
                c1 = torch.where(dirm[..., None], a3mv, gen)
                mvp = torch.where((pmode == 1)[..., None], c1, own[0])
            elif p == 2:
                mvp = _mvp_general_vec(a3mv, a3r, left_avail, own[0], ownr[0], true,
                                       own[1], ownr[1], true, myref)
            else:
                mvp = _mvp_general_vec(own[2], ownr[2], true, own[1], ownr[1], true,
                                       own[0], ownr[0], true, myref)
            active = ~intra & (p < nparts)
            d = pmv - mvp
            vx, lx = _se_token(d[..., 1])
            vy, ly = _se_token(d[..., 0])
            mvd_v += [torch.where(active, vx, 0), torch.where(active, vy, 0)]
            mvd_l += [torch.where(active, lx, 0), torch.where(active, ly, 0)]
            ract = active & (active_refs == 2)
            ref_vs.append(torch.where(ract, 1 - myref, 0))
            ref_ls.append(torch.where(ract, 1, 0))
        mbt_p_v, mbt_p_l = _ue_token(pmode)
        subl = torch.where(~intra & (pmode == 3), 1, 0)
        hdr_v = torch.stack([sr_v, torch.where(intra, mbt_i_v, mbt_p_v),
                             torch.where(intra, one, subl), torch.where(intra, one, subl),
                             torch.where(intra, 0, subl), torch.where(intra, 0, subl),
                             *ref_vs, *mvd_v, torch.where(intra, 0, cbp_v),
                             torch.where(intra, 0, one)], -1)
        hdr_l = torch.stack([sr_l, torch.where(intra, mbt_i_l, mbt_p_l),
                             torch.where(intra, one, subl), torch.where(intra, one, subl),
                             torch.where(intra, 0, subl), torch.where(intra, 0, subl),
                             *ref_ls, *mvd_l, torch.where(intra, 0, cbp_l),
                             torch.where(intra, 0, dqp_l)], -1)
        hdr_w, hdr_n = pack_tokens(hdr_v, hdr_l, 8)
    hdr_w = _pad_words(hdr_w)

    bq = torch.as_tensor(_BLOCK_QUAD, device=dev)
    g15 = (ii * cbp_luma_i)[..., None].expand(mb_h, mb_w, 16)
    g16 = ((1 - ii) * ci)[..., None] * quad[:, :, bq]
    res_w, res_n = _residual_pieces(zdc, acz, czdc, cacz, nc_l, nc_dc, nc_c, ii, g16, g15,
                                    cbp_chroma >= 1, cbp_chroma == 2)
    pieces_w = torch.cat([hdr_w[:, :, None], res_w], 2) * ci[..., None, None]
    pieces_n = torch.cat([hdr_n[:, :, None], res_n], 2) * ci[..., None]
    words, nbits = concat_pieces(pieces_w, pieces_n, nw_mb)
    return _as_uint32(words), (nbits * ci).to(torch.int32)


def pack_p_mbs(mode, zdc, acz, czdc, cacz, mv, ref, active_refs: int, nw_mb: int = 64,
               pmode=None, mv4=None, ref4=None):
    """Pack every MB of one P frame (one P slice per MB row) into its CAVLC
    bit string: ``mb_skip_run`` (the skipped MBs since the last coded MB in
    the row), mb_type (P_L0_16x16, or with ``pmode`` 16x8 / 8x16 / P_8x8
    with four sub_mb_type 0; intra-in-P I_16x16 at offset 5), ``ref_idx``
    te(v) when ``active_refs == 2``, the mvds against the left-MB predictor
    (with ``pmode`` the reference-aware predictor of each partition), the
    cbp and the residual (inter luma blocks 16 coefficients gated a
    quadrant, intra-in-P 15 plus DC).  ``mode`` (mb_h, mb_w): 0 skip, 1
    inter, 2 intra DC, 3 intra HORIZONTAL; ``mv`` the (mb_h, mb_w, 2)
    quarter-pel field (None: zero motion), ``ref`` (None: 0); with the
    partition modes ``pmode``, ``mv4`` (mb_h, mb_w, 4, 2) and ``ref4``
    (mb_h, mb_w, 4; None: 0) instead.  Skipped MBs report 0 bits (the
    slice's trailing skip run is the host's).  Returns :func:`pack_i_mbs`'s
    pair.  The JAX ``pack_p_mbs``; its oracle
    ``io.h264_inter.encode_frame_p_from_levels``.

    On CUDA tensors it launches ``pack_p_kernel``; on CPU tensors it runs
    :func:`pack_p_mbs_plain`."""
    from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as kernel

    return kernel.pack_p_mbs(mode, zdc, acz, czdc, cacz, mv, ref, active_refs, nw_mb,
                             pmode, mv4, ref4)


def synthetic_p_fields(rng: np.random.Generator, mb_h: int, mb_w: int, mode=None,
                       max_skip: int = 60) -> dict:
    """A P frame's fields for checking a P packer, made to reach its every
    path rather than by an encoder (numpy int16, both layouts' fields).
    Random levels up to the 12-bit escape, whole blocks empty, nonzero
    under skipped MBs too; an intra MB's luma AC blocks and every chroma AC
    block hold nothing at their DC position, as H2 leaves them.  ``mode``
    (mb_h, mb_w) where given, else rows of coded MBs (inter, intra DC,
    intra HORIZONTAL) between skip runs of 0 to ``max_skip`` MBs (most 0, a
    twentieth 9 or more), about every tenth row skipped whole.  Vectors
    within +-512 quarter pels, references 0 and 1, every partition mode."""
    def draw(shape, p_zero: float):
        mag = rng.choice(np.array([1, 2, 3, 40, 2063], np.int16), size=shape,
                         p=[0.5, 0.2, 0.15, 0.1, 0.05])
        a = np.where(rng.random(shape) < 0.5, mag, -mag).astype(np.int16)
        a[rng.random(shape) < p_zero] = 0
        a[rng.random(shape[:3]) < 0.3] = 0
        return a

    def skip_run() -> int:
        r = rng.random()
        return (0 if r < 0.7 else int(rng.integers(1, 9)) if r < 0.95
                else int(rng.integers(9, max(10, max_skip + 1))))

    if mode is None:
        mode = np.zeros((mb_h, mb_w), np.int16)
        for y in range(mb_h):
            if rng.random() < 0.1:
                continue
            x = skip_run()
            while x < mb_w:
                mode[y, x] = rng.choice([1, 1, 1, 2, 3])
                x += 1 + skip_run()
    mode = np.asarray(mode, np.int16)
    acz, cacz = draw((mb_h, mb_w, 16, 16), 0.7), draw((mb_h, mb_w, 2, 4, 16), 0.8)
    acz[mode >= 2] *= (np.arange(16) > 0).astype(np.int16)
    cacz[..., 0] = 0
    return dict(mode=mode, zdc=draw((mb_h, mb_w, 16), 0.7), acz=acz,
                czdc=draw((mb_h, mb_w, 2, 4), 0.7), cacz=cacz,
                mv=rng.integers(-512, 513, (mb_h, mb_w, 2)).astype(np.int16),
                ref=rng.integers(0, 2, (mb_h, mb_w)).astype(np.int16),
                mv4=rng.integers(-512, 513, (mb_h, mb_w, 4, 2)).astype(np.int16),
                ref4=rng.integers(0, 2, (mb_h, mb_w, 4)).astype(np.int16),
                pmode=rng.integers(0, 4, (mb_h, mb_w)).astype(np.int16))


# --------------------------------------------------------- host assembly ----

def assemble_slices_from_bits(words: np.ndarray, nbits: np.ndarray, header_fn,
                              tail_fn=None) -> list[bytes]:
    """Host: one NAL per MB row from the packed MB bit strings.
    ``header_fn(mby) -> _BitWriter`` writes the slice header; ``tail_fn(mby)
    -> _BitWriter | None`` appends end-of-slice syntax (the P slice's
    trailing skip run).  Numpy bit moves, no VLC work."""
    from opencv_opencl_tpu_torch.io.h264_pcm import _escape

    mb_h, mb_w, nw = words.shape
    nals = []
    for mby in range(mb_h):
        w = header_fn(mby)
        head = np.asarray(w._bits, np.uint8)
        nb = np.asarray(nbits[mby])
        # unpack only the words this row uses; MSB-first uint32 words as
        # big-endian bytes unpack in order, and row[mask] flattens in C
        # order, the concatenation of every MB's first nbits bits
        mw = (int(nb.max(initial=0)) + 31) >> 5
        rowbits = np.unpackbits(
            np.ascontiguousarray(words[mby, :, :mw]).astype(">u4")
            .view(np.uint8).reshape(mb_w, mw * 4), axis=-1)
        mask = np.arange(mw * 32)[None, :] < nb[:, None]
        segs = [head, rowbits[mask]]
        if tail_fn is not None:
            tw = tail_fn(mby)
            if tw is not None:
                segs.append(np.asarray(tw._bits, np.uint8))
        bits = np.concatenate(segs)
        # rbsp trailing bits: the stop bit and zeros to a byte
        pad = (-(bits.size + 1)) % 8
        bits = np.concatenate([bits, np.ones(1, np.uint8), np.zeros(pad, np.uint8)])
        nals.append(bytes(_escape(np.packbits(bits))))
    return nals
