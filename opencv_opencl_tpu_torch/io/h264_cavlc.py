"""Compressed intra H.264 encoder (I_16x16 + CAVLC) with rate control.

The reference's emit side is a REAL rate-controlled encoder
(``omxh264enc target-bitrate=... control-rate=low-latency``,
``OpenCVequalHist.cpp:308-332``): ``--bitrate`` shapes
the stream.  The in-repo I_PCM backend (io.h264_pcm) is lossless but
cannot honor a bitrate at all — every frame is raw-size.  This module
closes that gap with a from-scratch baseline-profile encoder:

- every macroblock is **Intra_16x16** (per-MB best of DC and
  HORIZONTAL luma prediction by the shared level-cost proxy
  ``level_cost``; DC chroma prediction), 4x4 integer core transforms +
  DC Hadamards, QP-scaled quantization, **CAVLC** entropy coding
  (coeff_token / trailing ones / level prefix-suffix adaptation /
  total_zeros / run_before);
- all-IDR stream (SPS+PPS ride ahead of every frame), the low-latency
  analogue of the reference's ``periodicity-idr`` tuning — any receiver
  joins mid-stream and no frame references another;
- the in-loop deblocking filter is DISABLED per slice
  (``disable_deblocking_filter_idc=1``) so the decoded picture equals
  this encoder's reconstruction EXACTLY — tests decode through
  libavcodec and require bit-identical luma (tests/test_cavlc.py);
- closed-loop rate control: per-frame QP adaptation toward
  ``bitrate_kbps`` (AIMD on the frame-bit error, like the relay's
  RateGovernor but in the QP domain).

Python here is the tested oracle; the C++ port in native/framepipe.cpp
(``fp_cavlc_encode``) is the production path, diffed bit-for-bit
against this module.

Layout/infrastructure (bit writer, SPS, escaping, start codes) is
shared with io.h264_pcm.

The port's own copy of ``opencv_opencl_tpu/io/h264_cavlc.py`` up to
``CavlcH264Encoder``: the same bytes.  ``CudaCavlcEncoder`` is the port's
counterpart of ``TpuCavlcEncoder``: the level stage on the card
(ops/h264_levels.py) and, with ``bitpack``, the bit packer too
(ops/h264_bitpack.py), with ``encode_from_packed`` for the fused enhance +
encode step (models/fused_encode.py); the GOP encoder that builds on it is
``io.h264_inter.CudaGopEncoder``.
"""

from __future__ import annotations

import numpy as np

from opencv_opencl_tpu_torch.io.h264_pcm import (
    _START4,
    _BitWriter,
    _escape,
    build_sps,
)

__all__ = ["CavlcH264Encoder", "CudaCavlcEncoder", "encode_frame_cavlc",
           "encode_frame_cavlc_slices", "encode_frame_from_levels",
           "build_pps_cavlc", "intra_bits_nals"]

# ------------------------------------------------------------ transforms ----

_CF = np.array([[1, 1, 1, 1],
                [2, 1, -1, -2],
                [1, -1, -1, 1],
                [1, -2, 2, -1]], dtype=np.int64)
_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], dtype=np.int64)
_H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)

# MF (forward) and V (dequant) per QP%6, by coefficient-position class:
# class 0 = (0,0),(0,2),(2,0),(2,2); class 1 = (1,1),(1,3),(3,1),(3,3);
# class 2 = the rest (Richardson, "H.264 transform & quantization").
_MF = [(13107, 5243, 8066), (11916, 4660, 7490), (10082, 4194, 6554),
       (9362, 3647, 5825), (8192, 3355, 5243), (7282, 2893, 4559)]
_V = [(10, 16, 13), (11, 18, 14), (13, 20, 16),
      (14, 23, 18), (16, 25, 20), (18, 29, 23)]

# class 0 at even-even positions, class 1 at odd-odd, class 2 elsewhere
_POS_CLASS = np.full((4, 4), 2, dtype=np.int64)
for _i in (0, 2):
    for _j in (0, 2):
        _POS_CLASS[_i, _j] = 0
for _i in (1, 3):
    for _j in (1, 3):
        _POS_CLASS[_i, _j] = 1

# chroma QP mapping (spec Table 8-15), chroma_qp_index_offset = 0
_QPC = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                          37, 37, 37, 38, 38, 38, 39, 39, 39, 39]

# zigzag scan of a 4x4 block: raster indices in scan order (spec 8.5.6)
_ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
# 4x4-luma-block coding order inside a MB: Z within each 8x8 quadrant,
# quadrants themselves in Z order (spec 6.4.3) — (bx, by) units of 4 px
_BLOCK_SCAN = [(0, 0), (1, 0), (0, 1), (1, 1),
               (2, 0), (3, 0), (2, 1), (3, 1),
               (0, 2), (1, 2), (0, 3), (1, 3),
               (2, 2), (3, 2), (2, 3), (3, 3)]


def _mf_mat(qp: int) -> np.ndarray:
    m = _MF[qp % 6]
    return np.array(m, dtype=np.int64)[_POS_CLASS]


def _v_mat(qp: int) -> np.ndarray:
    v = _V[qp % 6]
    return np.array(v, dtype=np.int64)[_POS_CLASS]


# Largest |level| codable by the level_prefix<=15 escape with
# suffix_len 0 (the first-coefficient worst case): level_code 2|c|-1
# must fit 30 + 12 bits of escape -> |c| <= 2063.  Quantized levels
# beyond that only arise from pathological content at very low QP; a
# real encoder clamps (the alternative — emitting a level the 12-bit
# escape cannot represent — would silently corrupt the stream).
_LEVEL_CLAMP = 2063


def level_cost(*arrays) -> int:
    """THE shared CAVLC bit-cost proxy: sum of 2|l| + (l != 0) over
    every coefficient.  The mode decisions of the oracle encoders, the
    native C++ encoder and the TPU level programs all use exactly this
    formula (CLAUDE.md: never let them drift) — Python callers must
    use this single definition."""
    c = 0
    for a in arrays:
        aa = np.abs(np.asarray(a))
        c += int((2 * aa + (aa != 0)).sum())
    return c


def _quant4x4(w: np.ndarray, qp: int, skip_dc: bool) -> np.ndarray:
    """Forward quant of a transformed 4x4 (intra rounding f = 2^qbits/3)."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    z = np.sign(w) * ((np.abs(w) * _mf_mat(qp) + f) >> qbits)
    np.clip(z, -_LEVEL_CLAMP, _LEVEL_CLAMP, out=z)
    if skip_dc:
        z[0, 0] = 0
    return z


def _dequant4x4(z: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.5.12.2 with flat weight scale: d = z * V(qp%6) << qp//6."""
    return (z * _v_mat(qp)) << (qp // 6)


def _inv4x4(d: np.ndarray) -> np.ndarray:
    """Spec 8.5.12.3 core inverse transform; output is residual << 6."""
    e = np.empty((4, 4), dtype=np.int64)
    # horizontal (rows of d are i, columns j) — first on columns index j
    f = np.empty((4, 4), dtype=np.int64)
    for i in range(4):
        d0, d1, d2, d3 = d[i]
        e0 = d0 + d2
        e1 = d0 - d2
        e2 = (d1 >> 1) - d3
        e3 = d1 + (d3 >> 1)
        f[i] = (e0 + e3, e1 + e2, e1 - e2, e0 - e3)
    g = np.empty((4, 4), dtype=np.int64)
    for j in range(4):
        d0, d1, d2, d3 = f[:, j]
        e0 = d0 + d2
        e1 = d0 - d2
        e2 = (d1 >> 1) - d3
        e3 = d1 + (d3 >> 1)
        g[:, j] = (e0 + e3, e1 + e2, e1 - e2, e0 - e3)
    e[:] = g
    return e


def _luma_dc_dequant(f: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.5.10: inverse-Hadamarded luma DC -> per-block d(0,0)."""
    ls = 16 * _V[qp % 6][0]
    k = qp // 6
    if qp >= 36:
        return (f * ls) << (k - 6)
    return (f * ls + (1 << (5 - k))) >> (6 - k)


def _chroma_dc_dequant(f: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.5.11.2: dcC = ((f * LS) << qp//6) >> 5, LS = 16*V0."""
    ls = 16 * _V[qp % 6][0]
    return ((f * ls) << (qp // 6)) >> 5


# ---------------------------------------------------------- CAVLC tables ----
# All codes as (length_bits, value).  Sources: ITU-T H.264 Tables 9-5,
# 9-7, 9-8, 9-9(a), 9-10.  Every sub-table is machine-checked prefix-free
# in tests/test_cavlc.py; standard conformance is checked by decoding
# through libavcodec and requiring bit-exact luma reconstruction.

# coeff_token, indexed [(total_coeff, trailing_ones)] per nC range.
# Column 0: 0 <= nC < 2
_CT_NC0 = {
    (0, 0): (1, 0b1),
    (1, 0): (6, 0b000101), (1, 1): (2, 0b01),
    (2, 0): (8, 0b00000111), (2, 1): (6, 0b000100), (2, 2): (3, 0b001),
    (3, 0): (9, 0b000000111), (3, 1): (8, 0b00000110),
    (3, 2): (7, 0b0000101), (3, 3): (5, 0b00011),
    (4, 0): (10, 0b0000000111), (4, 1): (9, 0b000000110),
    (4, 2): (8, 0b00000101), (4, 3): (6, 0b000011),
    (5, 0): (11, 0b00000000111), (5, 1): (10, 0b0000000110),
    (5, 2): (9, 0b000000101), (5, 3): (7, 0b0000100),
    (6, 0): (13, 0b0000000001111), (6, 1): (11, 0b00000000110),
    (6, 2): (10, 0b0000000101), (6, 3): (8, 0b00000100),
    (7, 0): (13, 0b0000000001011), (7, 1): (13, 0b0000000001110),
    (7, 2): (11, 0b00000000101), (7, 3): (9, 0b000000100),
    (8, 0): (13, 0b0000000001000), (8, 1): (13, 0b0000000001010),
    (8, 2): (13, 0b0000000001101), (8, 3): (10, 0b0000000100),
    (9, 0): (14, 0b00000000001111), (9, 1): (14, 0b00000000001110),
    (9, 2): (13, 0b0000000001001), (9, 3): (11, 0b00000000100),
    (10, 0): (14, 0b00000000001011), (10, 1): (14, 0b00000000001010),
    (10, 2): (14, 0b00000000001101), (10, 3): (13, 0b0000000001100),
    (11, 0): (15, 0b000000000001111), (11, 1): (15, 0b000000000001110),
    (11, 2): (14, 0b00000000001001), (11, 3): (14, 0b00000000001100),
    (12, 0): (15, 0b000000000001011), (12, 1): (15, 0b000000000001010),
    (12, 2): (15, 0b000000000001101), (12, 3): (14, 0b00000000001000),
    (13, 0): (16, 0b0000000000001111), (13, 1): (15, 0b000000000000001),
    (13, 2): (15, 0b000000000001001), (13, 3): (15, 0b000000000001100),
    (14, 0): (16, 0b0000000000001011), (14, 1): (16, 0b0000000000001110),
    (14, 2): (16, 0b0000000000001101), (14, 3): (15, 0b000000000001000),
    (15, 0): (16, 0b0000000000000111), (15, 1): (16, 0b0000000000001010),
    (15, 2): (16, 0b0000000000001001), (15, 3): (16, 0b0000000000001100),
    (16, 0): (16, 0b0000000000000100), (16, 1): (16, 0b0000000000000110),
    (16, 2): (16, 0b0000000000000101), (16, 3): (16, 0b0000000000001000),
}

# Column 1: 2 <= nC < 4
_CT_NC2 = {
    (0, 0): (2, 0b11),
    (1, 0): (6, 0b001011), (1, 1): (2, 0b10),
    (2, 0): (6, 0b000111), (2, 1): (5, 0b00111), (2, 2): (3, 0b011),
    (3, 0): (7, 0b0000111), (3, 1): (6, 0b001010),
    (3, 2): (6, 0b001001), (3, 3): (4, 0b0101),
    (4, 0): (8, 0b00000111), (4, 1): (6, 0b000110),
    (4, 2): (6, 0b000101), (4, 3): (4, 0b0100),
    (5, 0): (8, 0b00000100), (5, 1): (7, 0b0000110),
    (5, 2): (7, 0b0000101), (5, 3): (5, 0b00110),
    (6, 0): (9, 0b000000111), (6, 1): (8, 0b00000110),
    (6, 2): (8, 0b00000101), (6, 3): (6, 0b001000),
    (7, 0): (11, 0b00000001111), (7, 1): (9, 0b000000110),
    (7, 2): (9, 0b000000101), (7, 3): (6, 0b000100),
    (8, 0): (11, 0b00000001011), (8, 1): (11, 0b00000001110),
    (8, 2): (11, 0b00000001101), (8, 3): (7, 0b0000100),
    (9, 0): (12, 0b000000001111), (9, 1): (11, 0b00000001010),
    (9, 2): (11, 0b00000001001), (9, 3): (9, 0b000000100),
    (10, 0): (12, 0b000000001011), (10, 1): (12, 0b000000001110),
    (10, 2): (12, 0b000000001101), (10, 3): (11, 0b00000001100),
    (11, 0): (12, 0b000000001000), (11, 1): (12, 0b000000001010),
    (11, 2): (12, 0b000000001001), (11, 3): (11, 0b00000001000),
    (12, 0): (13, 0b0000000001111), (12, 1): (13, 0b0000000001110),
    (12, 2): (13, 0b0000000001101), (12, 3): (12, 0b000000001100),
    (13, 0): (13, 0b0000000001011), (13, 1): (13, 0b0000000001010),
    (13, 2): (13, 0b0000000001001), (13, 3): (13, 0b0000000001100),
    (14, 0): (13, 0b0000000000111), (14, 1): (14, 0b00000000001011),
    (14, 2): (13, 0b0000000000110), (14, 3): (13, 0b0000000001000),
    (15, 0): (14, 0b00000000001001), (15, 1): (14, 0b00000000001000),
    (15, 2): (14, 0b00000000001010), (15, 3): (13, 0b0000000000001),
    (16, 0): (14, 0b00000000000111), (16, 1): (14, 0b00000000000110),
    (16, 2): (14, 0b00000000000101), (16, 3): (14, 0b00000000000100),
}

# Column 2: 4 <= nC < 8
_CT_NC4 = {
    (0, 0): (4, 0b1111),
    (1, 0): (6, 0b001111), (1, 1): (4, 0b1110),
    (2, 0): (6, 0b001011), (2, 1): (5, 0b01111), (2, 2): (4, 0b1101),
    (3, 0): (6, 0b001000), (3, 1): (5, 0b01100),
    (3, 2): (5, 0b01110), (3, 3): (4, 0b1100),
    (4, 0): (7, 0b0001111), (4, 1): (5, 0b01010),
    (4, 2): (5, 0b01011), (4, 3): (4, 0b1011),
    (5, 0): (7, 0b0001011), (5, 1): (5, 0b01000),
    (5, 2): (5, 0b01001), (5, 3): (4, 0b1010),
    (6, 0): (7, 0b0001001), (6, 1): (6, 0b001110),
    (6, 2): (6, 0b001101), (6, 3): (4, 0b1001),
    (7, 0): (7, 0b0001000), (7, 1): (6, 0b001010),
    (7, 2): (6, 0b001001), (7, 3): (4, 0b1000),
    (8, 0): (8, 0b00001111), (8, 1): (7, 0b0001110),
    (8, 2): (7, 0b0001101), (8, 3): (5, 0b01101),
    (9, 0): (8, 0b00001011), (9, 1): (8, 0b00001110),
    (9, 2): (7, 0b0001010), (9, 3): (6, 0b001100),
    (10, 0): (9, 0b000001111), (10, 1): (8, 0b00001010),
    (10, 2): (8, 0b00001101), (10, 3): (7, 0b0001100),
    (11, 0): (9, 0b000001011), (11, 1): (9, 0b000001110),
    (11, 2): (8, 0b00001001), (11, 3): (8, 0b00001100),
    (12, 0): (9, 0b000001000), (12, 1): (9, 0b000001010),
    (12, 2): (9, 0b000001101), (12, 3): (8, 0b00001000),
    (13, 0): (10, 0b0000001101), (13, 1): (9, 0b000000111),
    (13, 2): (9, 0b000001001), (13, 3): (9, 0b000001100),
    (14, 0): (10, 0b0000001001), (14, 1): (10, 0b0000001100),
    (14, 2): (10, 0b0000001011), (14, 3): (10, 0b0000001010),
    (15, 0): (10, 0b0000000101), (15, 1): (10, 0b0000001000),
    (15, 2): (10, 0b0000000111), (15, 3): (10, 0b0000000110),
    (16, 0): (10, 0b0000000001), (16, 1): (10, 0b0000000100),
    (16, 2): (10, 0b0000000011), (16, 3): (10, 0b0000000010),
}

# nC == -1 (chroma DC, 4:2:0)
_CT_NCM1 = {
    (0, 0): (2, 0b01),
    (1, 0): (6, 0b000111), (1, 1): (1, 0b1),
    (2, 0): (6, 0b000100), (2, 1): (6, 0b000110), (2, 2): (3, 0b001),
    (3, 0): (6, 0b000011), (3, 1): (7, 0b0000011),
    (3, 2): (7, 0b0000010), (3, 3): (6, 0b000101),
    (4, 0): (6, 0b000010), (4, 1): (8, 0b00000011),
    (4, 2): (8, 0b00000010), (4, 3): (7, 0b0000000),
}


def _coeff_token(nc: int, total: int, t1s: int) -> tuple[int, int]:
    if nc == -1:
        return _CT_NCM1[(total, t1s)]
    if nc < 2:
        return _CT_NC0[(total, t1s)]
    if nc < 4:
        return _CT_NC2[(total, t1s)]
    if nc < 8:
        return _CT_NC4[(total, t1s)]
    # nC >= 8: 6-bit FLC, (total-1)<<2 | t1s; total==0 is 000011
    if total == 0:
        return (6, 0b000011)
    return (6, ((total - 1) << 2) | t1s)


# total_zeros for 4x4 blocks (Tables 9-7 and 9-8), [total_coeff][zeros]
_TZ = {
    1: [(1, 1), (3, 0b011), (3, 0b010), (4, 0b0011), (4, 0b0010),
        (5, 0b00011), (5, 0b00010), (6, 0b000011), (6, 0b000010),
        (7, 0b0000011), (7, 0b0000010), (8, 0b00000011), (8, 0b00000010),
        (9, 0b000000011), (9, 0b000000010), (9, 0b000000001)],
    2: [(3, 0b111), (3, 0b110), (3, 0b101), (3, 0b100), (3, 0b011),
        (4, 0b0101), (4, 0b0100), (4, 0b0011), (4, 0b0010), (5, 0b00011),
        (5, 0b00010), (6, 0b000011), (6, 0b000010), (6, 0b000001),
        (6, 0b000000)],
    3: [(4, 0b0101), (3, 0b111), (3, 0b110), (3, 0b101), (4, 0b0100),
        (4, 0b0011), (3, 0b100), (3, 0b011), (4, 0b0010), (5, 0b00011),
        (5, 0b00010), (6, 0b000001), (5, 0b00001), (6, 0b000000)],
    4: [(5, 0b00011), (3, 0b111), (4, 0b0101), (4, 0b0100), (3, 0b110),
        (3, 0b101), (3, 0b100), (4, 0b0011), (3, 0b011), (4, 0b0010),
        (5, 0b00010), (5, 0b00001), (5, 0b00000)],
    5: [(4, 0b0101), (4, 0b0100), (4, 0b0011), (3, 0b111), (3, 0b110),
        (3, 0b101), (3, 0b100), (3, 0b011), (4, 0b0010), (5, 0b00001),
        (4, 0b0001), (5, 0b00000)],
    6: [(6, 0b000001), (5, 0b00001), (3, 0b111), (3, 0b110), (3, 0b101),
        (3, 0b100), (3, 0b011), (3, 0b010), (4, 0b0001), (3, 0b001),
        (6, 0b000000)],
    7: [(6, 0b000001), (5, 0b00001), (3, 0b101), (3, 0b100), (3, 0b011),
        (2, 0b11), (3, 0b010), (4, 0b0001), (3, 0b001), (6, 0b000000)],
    8: [(6, 0b000001), (4, 0b0001), (5, 0b00001), (3, 0b011), (2, 0b11),
        (2, 0b10), (3, 0b010), (3, 0b001), (6, 0b000000)],
    9: [(6, 0b000001), (6, 0b000000), (4, 0b0001), (2, 0b11), (2, 0b10),
        (3, 0b001), (2, 0b01), (5, 0b00001)],
    10: [(5, 0b00001), (5, 0b00000), (3, 0b001), (2, 0b11), (2, 0b10),
         (2, 0b01), (4, 0b0001)],
    11: [(4, 0b0000), (4, 0b0001), (3, 0b001), (3, 0b010), (1, 0b1),
         (3, 0b011)],
    12: [(4, 0b0000), (4, 0b0001), (2, 0b01), (1, 0b1), (3, 0b001)],
    13: [(3, 0b000), (3, 0b001), (1, 0b1), (2, 0b01)],
    14: [(2, 0b00), (2, 0b01), (1, 0b1)],
    15: [(1, 0b0), (1, 0b1)],
}

# total_zeros for chroma DC 2x2 blocks (Table 9-9a, 4:2:0)
_TZ_CDC = {
    1: [(1, 1), (2, 0b01), (3, 0b001), (3, 0b000)],
    2: [(1, 1), (2, 0b01), (2, 0b00)],
    3: [(1, 1), (1, 0b0)],
}

# run_before (Table 9-10), [min(zeros_left, 7)][run]
_RUN_BEFORE = {
    1: [(1, 1), (1, 0)],
    2: [(1, 1), (2, 0b01), (2, 0b00)],
    3: [(2, 0b11), (2, 0b10), (2, 0b01), (2, 0b00)],
    4: [(2, 0b11), (2, 0b10), (2, 0b01), (3, 0b001), (3, 0b000)],
    5: [(2, 0b11), (2, 0b10), (3, 0b011), (3, 0b010), (3, 0b001),
        (3, 0b000)],
    6: [(2, 0b11), (3, 0b000), (3, 0b001), (3, 0b011), (3, 0b010),
        (3, 0b101), (3, 0b100)],
    7: [(3, 0b111), (3, 0b110), (3, 0b101), (3, 0b100), (3, 0b011),
        (3, 0b010), (3, 0b001)] + [(4 + i, 1) for i in range(8)],
}


def _write_residual_block(w: _BitWriter, coeffs: list[int],
                          nc: int) -> int:
    """CAVLC residual_block (spec 7.3.5.3.2 / 9.2) for one scanned
    coefficient list (low->high frequency).  Returns total_coeff (the
    value neighbors need for their nC context)."""
    max_coeffs = len(coeffs)
    nz = [(i, c) for i, c in enumerate(coeffs) if c != 0]
    total = len(nz)
    # trailing ones: up to 3 |1| coefficients at the high-frequency end
    t1s = 0
    for _, c in reversed(nz):
        if abs(c) == 1 and t1s < 3:
            t1s += 1
        else:
            break
    ln, code = _coeff_token(nc, total, t1s)
    w.u(code, ln)
    if total == 0:
        return 0
    # trailing one signs, high frequency first (1 = negative)
    for _, c in reversed(nz[total - t1s:]):
        w.u(1 if c < 0 else 0, 1)
    # remaining levels, high frequency first
    suffix_len = 1 if (total > 10 and t1s < 3) else 0
    first = True
    for _, c in reversed(nz[: total - t1s]):
        level_code = 2 * c - 2 if c > 0 else -2 * c - 1
        if first and t1s < 3:
            level_code -= 2
        first = False
        if suffix_len == 0:
            if level_code < 14:
                w.u(1, level_code + 1)  # level_prefix zeros + stop 1
            elif level_code < 30:
                w.u(1, 15)              # prefix 14
                w.u(level_code - 14, 4)
            else:
                w.u(1, 16)              # prefix 15
                w.u(level_code - 30, 12)
        else:
            prefix = level_code >> suffix_len
            if prefix < 15:
                w.u(1, prefix + 1)
                w.u(level_code & ((1 << suffix_len) - 1), suffix_len)
            else:
                w.u(1, 16)
                w.u(level_code - (15 << suffix_len), 12)
        if suffix_len == 0:
            suffix_len = 1
        if abs(c) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    # total_zeros
    total_zeros = nz[-1][0] + 1 - total
    if total < max_coeffs:
        if nc == -1:
            ln, code = _TZ_CDC[total][total_zeros]
        else:
            ln, code = _TZ[total][total_zeros]
        w.u(code, ln)
    # run_before, high frequency first; last (lowest) coeff has no run
    zeros_left = total_zeros
    for k in range(total - 1, 0, -1):
        if zeros_left == 0:
            break
        run = nz[k][0] - nz[k - 1][0] - 1
        ln, code = _RUN_BEFORE[min(zeros_left, 7)][run]
        w.u(code, ln)
        zeros_left -= run
    return total


# ---------------------------------------------------------- MB encoding ----


def _zigzag_list(block: np.ndarray, skip_dc: bool) -> list[int]:
    flat = block.reshape(16)
    order = _ZIGZAG[1:] if skip_dc else _ZIGZAG
    return [int(flat[i]) for i in order]


def _pred_dc16(recon: np.ndarray, y0: int, x0: int, top_ok: bool,
               left_ok: bool) -> int:
    if top_ok and left_ok:
        s = int(recon[y0 - 1, x0:x0 + 16].sum()) + \
            int(recon[y0:y0 + 16, x0 - 1].sum())
        return (s + 16) >> 5
    if top_ok:
        return (int(recon[y0 - 1, x0:x0 + 16].sum()) + 8) >> 4
    if left_ok:
        return (int(recon[y0:y0 + 16, x0 - 1].sum()) + 8) >> 4
    return 128


def _pred_dc_chroma(recon: np.ndarray, y0: int, x0: int, top_ok: bool,
                    left_ok: bool) -> np.ndarray:
    """8x8 chroma DC prediction (spec 8.3.4.1): per-4x4 quadrant."""
    pred = np.empty((8, 8), dtype=np.int64)
    top = recon[y0 - 1, x0:x0 + 8].astype(np.int64) if top_ok else None
    left = recon[y0:y0 + 8, x0 - 1].astype(np.int64) if left_ok else None

    def fill(qy, qx, use_top, use_left):
        if use_top and use_left:
            v = (int(top[qx:qx + 4].sum()) +
                 int(left[qy:qy + 4].sum()) + 4) >> 3
        elif use_top:
            v = (int(top[qx:qx + 4].sum()) + 2) >> 2
        elif use_left:
            v = (int(left[qy:qy + 4].sum()) + 2) >> 2
        else:
            v = 128
        pred[qy:qy + 4, qx:qx + 4] = v

    # corners use both; (4,0) prefers top, (0,4) prefers left
    fill(0, 0, top_ok, left_ok)
    fill(0, 4, top_ok, False) if top_ok else fill(0, 4, False, left_ok)
    fill(4, 0, False, left_ok) if left_ok else fill(4, 0, top_ok, False)
    fill(4, 4, top_ok, left_ok)
    return pred


# ---------------------------------------------------------------- I_4x4 ----

# coded_block_pattern me(v) mapping for Intra_4x4 (spec Table 9-4,
# ChromaArrayType = 1): codeNum -> cbp.  Validated by being a
# permutation of 0..47 at import and, decisively, by libavcodec
# decoding I_4x4 streams to bit-identical reconstruction
# (tests/test_h264_i4.py) — a wrong entry would misparse every
# residual that follows.
_CBP_INTRA_TAB = np.array([
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41],
    dtype=np.int64)
assert sorted(_CBP_INTRA_TAB.tolist()) == list(range(48))
# inverse: cbp -> codeNum (what the encoder writes as ue)
_CBP_INTRA_CODE = np.empty(48, dtype=np.int64)
_CBP_INTRA_CODE[_CBP_INTRA_TAB] = np.arange(48)

# per-block trial bit-cost proxy for the Intra_4x4 mode signaling:
# prev_intra4x4_pred_mode_flag alone (1 bit) when the chosen mode IS
# the predicted one, flag + rem_intra4x4_pred_mode (4 bits) otherwise
_I4_MODE_BITS = (1, 4)

# test hooks (tests/test_h264_i4.py): restrict the trial to one mode
# and/or force the MB decision to Intra_4x4, so every spec 8.3.1.2
# predictor is individually conformance-proven through libavcodec on
# MBs that actually code it.  None/False in production.
_I4_FORCE_MODE: int | None = None
_I4_FORCE_MB = False


def _pred_i4(mode: int, t8, l4, c: int) -> np.ndarray:
    """One Intra_4x4 luma prediction (spec 8.3.1.2.1-9).  ``t8`` is
    p[0..7, -1] (top + top-right, already substituted per 8.3.1 when
    the above-right block is unavailable), ``l4`` is p[-1, 0..3],
    ``c`` is p[-1, -1].  Only called with the samples the mode needs
    available (the encoder's availability filter in _i4_trial).
    Returns the (4, 4) int64 prediction indexed [y, x]."""
    p = np.empty((4, 4), dtype=np.int64)

    def T(i):
        return c if i == -1 else int(t8[i])

    def L(i):
        return c if i == -1 else int(l4[i])

    if mode == 0:                                   # VERTICAL
        p[:] = np.asarray(t8[:4], dtype=np.int64)[None, :]
    elif mode == 1:                                 # HORIZONTAL
        p[:] = np.asarray(l4, dtype=np.int64)[:, None]
    elif mode == 2:                                 # DC (all-available)
        p[:] = (int(np.sum(t8[:4])) + int(np.sum(l4)) + 4) >> 3
    elif mode == 3:                                 # DIAG_DOWN_LEFT
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (T(6) + 3 * T(7) + 2) >> 2
                else:
                    p[y, x] = (T(x + y) + 2 * T(x + y + 1)
                               + T(x + y + 2) + 2) >> 2
    elif mode == 4:                                 # DIAG_DOWN_RIGHT
        for y in range(4):
            for x in range(4):
                if x > y:
                    p[y, x] = (T(x - y - 2) + 2 * T(x - y - 1)
                               + T(x - y) + 2) >> 2
                elif x < y:
                    p[y, x] = (L(y - x - 2) + 2 * L(y - x - 1)
                               + L(y - x) + 2) >> 2
                else:
                    p[y, x] = (T(0) + 2 * c + L(0) + 2) >> 2
    elif mode == 5:                                 # VERTICAL_RIGHT
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    i = x - (y >> 1)
                    p[y, x] = (T(i - 1) + T(i) + 1) >> 1
                elif z >= 0:
                    i = x - (y >> 1)
                    p[y, x] = (T(i - 2) + 2 * T(i - 1) + T(i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (L(0) + 2 * c + T(0) + 2) >> 2
                else:
                    p[y, x] = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2)
                               + L(y - 2 * x - 3) + 2) >> 2
    elif mode == 6:                                 # HORIZONTAL_DOWN
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    i = y - (x >> 1)
                    p[y, x] = (L(i - 1) + L(i) + 1) >> 1
                elif z >= 0:
                    i = y - (x >> 1)
                    p[y, x] = (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (L(0) + 2 * c + T(0) + 2) >> 2
                else:
                    p[y, x] = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2)
                               + T(x - 2 * y - 3) + 2) >> 2
    elif mode == 7:                                 # VERTICAL_LEFT
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (T(i) + T(i + 1) + 1) >> 1
                else:
                    p[y, x] = (T(i) + 2 * T(i + 1) + T(i + 2) + 2) >> 2
    elif mode == 8:                                 # HORIZONTAL_UP
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z < 5 and z % 2 == 0:
                    i = y + (x >> 1)
                    p[y, x] = (L(i) + L(i + 1) + 1) >> 1
                elif z < 5:
                    i = y + (x >> 1)
                    p[y, x] = (L(i) + 2 * L(i + 1) + L(i + 2) + 2) >> 2
                elif z == 5:
                    p[y, x] = (L(2) + 3 * L(3) + 2) >> 2
                else:
                    p[y, x] = L(3)
    else:
        raise ValueError(f"bad intra4x4 mode {mode}")
    return p


def _pred_i4_dc_partial(t8, l4, t_ok: bool, l_ok: bool) -> np.ndarray:
    """DC prediction when not all neighbors exist (spec 8.3.1.2.3)."""
    p = np.empty((4, 4), dtype=np.int64)
    if t_ok and l_ok:
        p[:] = (int(np.sum(t8[:4])) + int(np.sum(l4)) + 4) >> 3
    elif t_ok:
        p[:] = (int(np.sum(t8[:4])) + 2) >> 2
    elif l_ok:
        p[:] = (int(np.sum(l4)) + 2) >> 2
    else:
        p[:] = 128
    return p


# within-MB above-right 4x4 availability for by > 0 (z-scan decoding
# order): unavailable for (bx, by) where the block above-right has a
# LARGER z index or sits in the not-yet-decoded MB to the right
def _i4_tr_ok(bx: int, by: int) -> bool:
    return not (bx == 3 or (bx == 1 and by in (1, 3)))


def _nc_context(nnz: np.ndarray, by: int, bx: int, top_ok: bool,
                left_ok: bool) -> int:
    """nC from neighboring 4x4 blocks' total_coeff (spec 9.2.1)."""
    na = int(nnz[by, bx - 1]) if left_ok else None
    nb = int(nnz[by - 1, bx]) if top_ok else None
    if na is not None and nb is not None:
        return (na + nb + 1) >> 1
    if na is not None:
        return na
    if nb is not None:
        return nb
    return 0


class _MbEncoder:
    """Per-frame state: reconstruction planes + nnz context arrays."""

    def __init__(self, width: int, height: int, qp: int,
                 i4: bool = False, chromah: bool = False) -> None:
        self.mb_w = width // 16
        self.mb_h = height // 16
        self.qp = qp
        self.qpc = _QPC[min(max(qp, 0), 51)]
        self.i4 = i4
        self.chromah = chromah
        # recon planes padded by 1 px top/left for neighbor reads
        self.ry = np.zeros((self.mb_h * 16 + 1, self.mb_w * 16 + 1),
                           dtype=np.int64)
        self.rcb = np.zeros((self.mb_h * 8 + 1, self.mb_w * 8 + 1),
                            dtype=np.int64)
        self.rcr = np.zeros_like(self.rcb)
        self.luma_nnz = np.zeros((self.mb_h * 4 + 1, self.mb_w * 4 + 1),
                                 dtype=np.int64)
        self.cb_nnz = np.zeros((self.mb_h * 2 + 1, self.mb_w * 2 + 1),
                               dtype=np.int64)
        self.cr_nnz = np.zeros_like(self.cb_nnz)
        # Intra_4x4 entropy context: per-MB coded-as-I4x4 flag and the
        # per-4x4-block chosen modes (spec 8.3.1.1 neighbor rule: a
        # neighbor in a non-I4x4 MB contributes mode 2/DC)
        self.is_i4 = np.zeros((self.mb_h, self.mb_w), dtype=bool)
        self.i4modes = np.full((self.mb_h * 4, self.mb_w * 4), 2,
                               dtype=np.int64)

    def _i4_trial(self, mby: int, mbx: int, src_y: np.ndarray,
                  top_ok: bool, left_ok: bool):
        """Trial-encode one MB as Intra_4x4: sequential 4x4 blocks in
        z-scan order, per-block best of the AVAILABLE spec modes by
        ``level_cost(levels) + _I4_MODE_BITS`` (strict less-than: the
        lower mode index wins ties — the device twin's rule).  WRITES
        the MB's luma reconstruction into self.ry (caller restores it
        if I_16x16 wins).  Returns (modes z-order (16,), levels
        z-order (16, 4, 4), cost, predicted modes z-order (16,))."""
        qp = self.qp
        y0, x0 = mby * 16 + 1, mbx * 16 + 1
        ry = self.ry
        src = src_y[mby * 16:mby * 16 + 16,
                    mbx * 16:mbx * 16 + 16].astype(np.int64)
        modes = np.empty(16, dtype=np.int64)
        levels = np.empty((16, 4, 4), dtype=np.int64)
        predms = np.empty(16, dtype=np.int64)
        cost = 0
        left_is_i4 = left_ok and bool(self.is_i4[mby, mbx - 1])
        top_is_i4 = top_ok and bool(self.is_i4[mby - 1, mbx])
        zof = {(bx, by): z for z, (bx, by) in enumerate(_BLOCK_SCAN)}
        for z, (bx, by) in enumerate(_BLOCK_SCAN):
            gx0, gy0 = x0 + bx * 4, y0 + by * 4
            t_ok = (by > 0) or top_ok
            l_ok = (bx > 0) or left_ok
            t8 = np.zeros(8, dtype=np.int64)
            l4 = np.zeros(4, dtype=np.int64)
            c = 0
            if t_ok:
                t8[:4] = ry[gy0 - 1, gx0:gx0 + 4]
                if by > 0:
                    tr_ok = _i4_tr_ok(bx, by)
                else:
                    # above-right lives in the already-decoded MB row
                    # above; at bx=3 that is the above-RIGHT MB
                    tr_ok = bx < 3 or mbx < self.mb_w - 1
                if tr_ok:
                    t8[4:] = ry[gy0 - 1, gx0 + 4:gx0 + 8]
                else:               # spec 8.3.1: substitute p[3, -1]
                    t8[4:] = t8[3]
            if l_ok:
                l4[:] = ry[gy0:gy0 + 4, gx0 - 1]
            if t_ok and l_ok:
                c = int(ry[gy0 - 1, gx0 - 1])
            # entropy-predicted mode (spec 8.3.1.1)
            if bx > 0:
                ma = int(modes[zof[(bx - 1, by)]])
                a_ok = True
            else:
                ma = (int(self.i4modes[mby * 4 + by, mbx * 4 - 1])
                      if left_is_i4 else 2)
                a_ok = left_ok
            if by > 0:
                mb_ = int(modes[zof[(bx, by - 1)]])
                b_ok = True
            else:
                mb_ = (int(self.i4modes[mby * 4 - 1, mbx * 4 + bx])
                       if top_is_i4 else 2)
                b_ok = top_ok
            predm = min(ma, mb_) if (a_ok and b_ok) else 2
            predms[z] = predm
            avail = [m for m in range(9)
                     if (m == 2
                         or (m in (0, 3, 7) and t_ok)
                         or (m in (1, 8) and l_ok)
                         or (m in (4, 5, 6) and t_ok and l_ok))]
            if _I4_FORCE_MODE is not None and _I4_FORCE_MODE in avail:
                avail = [_I4_FORCE_MODE]
            blk = src[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            best = None
            for m in avail:
                if m == 2 and not (t_ok and l_ok):
                    pr = _pred_i4_dc_partial(t8, l4, t_ok, l_ok)
                else:
                    pr = _pred_i4(m, t8, l4, c)
                zq = _quant4x4(_CF @ (blk - pr) @ _CF.T, qp,
                               skip_dc=False)
                cm = level_cost(zq) + _I4_MODE_BITS[m != predm]
                if best is None or cm < best[0]:
                    best = (cm, m, zq, pr)
            cm, m, zq, pr = best
            cost += cm
            modes[z] = m
            levels[z] = zq
            d = _dequant4x4(zq, qp)
            r = (_inv4x4(d) + 32) >> 6
            ry[gy0:gy0 + 4, gx0:gx0 + 4] = np.clip(r + pr, 0, 255)
        return modes, levels, cost, predms

    def encode_mb(self, w: _BitWriter, mby: int, mbx: int,
                  src_y: np.ndarray, src_cb: np.ndarray,
                  src_cr: np.ndarray, first_mb_row: int) -> None:
        qp, qpc = self.qp, self.qpc
        top_ok = mby > first_mb_row
        left_ok = mbx > 0
        y0, x0 = mby * 16 + 1, mbx * 16 + 1  # +1: recon pad offset

        # ---- luma: DC and (when the left column exists) HORIZONTAL
        # 16x16 candidates; the cheaper by the level-cost proxy wins
        def luma_levels(pred_):
            resid = src_y[mby * 16:mby * 16 + 16,
                          mbx * 16:mbx * 16 + 16].astype(np.int64) \
                - pred_
            wdc = np.empty((4, 4), dtype=np.int64)
            acz_ = {}
            for by in range(4):
                for bx in range(4):
                    blk = resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
                    t = _CF @ blk @ _CF.T
                    wdc[by, bx] = t[0, 0]
                    acz_[(bx, by)] = _quant4x4(t, qp, skip_dc=True)
            # luma DC Hadamard + quant (JM forward convention)
            ydc = (_H4 @ wdc @ _H4) >> 1
            qbits = 15 + qp // 6
            f2 = 2 * ((1 << qbits) // 3)
            zdc_ = np.sign(ydc) * ((np.abs(ydc) * _MF[qp % 6][0] + f2)
                                   >> (qbits + 1))
            np.clip(zdc_, -_LEVEL_CLAMP, _LEVEL_CLAMP, out=zdc_)
            return zdc_, acz_

        def lcost(zdc_, acz_):
            return level_cost(zdc_, *acz_.values())

        pred = _pred_dc16(self.ry, y0, x0, top_ok, left_ok)
        zdc, acz = luma_levels(pred)
        predmode = 2                    # Intra_16x16_DC
        if left_ok:
            pred_h = self.ry[y0:y0 + 16, x0 - 1:x0]   # (16, 1) column
            zdc_h, acz_h = luma_levels(pred_h)
            if lcost(zdc_h, acz_h) < lcost(zdc, acz):
                pred, zdc, acz, predmode = pred_h, zdc_h, acz_h, 1
        cbp_luma = any(np.any(acz[k]) for k in acz)

        # ---- Intra_4x4 candidate (``i4``): the trial writes its own
        # luma recon; strict less-than keeps I_16x16 on ties
        use_i4 = False
        if self.i4:
            saved = self.ry[y0:y0 + 16, x0:x0 + 16].copy()
            i4m, i4lv, i4cost, i4pred = self._i4_trial(
                mby, mbx, src_y, top_ok, left_ok)
            if _I4_FORCE_MB or i4cost < lcost(zdc, acz):
                use_i4 = True
            else:
                self.ry[y0:y0 + 16, x0:x0 + 16] = saved

        # ---- chroma: DC always; HORIZONTAL (spec 8.3.4.2) when
        # ``chromah`` and the left column exists.  One mode covers
        # both components (intra_chroma_pred_mode); the cheaper by the
        # shared cost proxy + the ue() bit difference wins, strict
        # less-than keeping DC.
        cy0, cx0 = mby * 8 + 1, mbx * 8 + 1

        def chroma_cand(cmode: int):
            cd = {}
            dc_nz = ac_nz = False
            cost = 0
            for name, plane in (("cb", src_cb), ("cr", src_cr)):
                rp = self.rcb if name == "cb" else self.rcr
                if cmode == 0:
                    cpred = _pred_dc_chroma(rp, cy0, cx0, top_ok,
                                            left_ok)
                else:       # HORIZONTAL: pred[y][x] = p[-1, y]
                    cpred = np.broadcast_to(
                        rp[cy0:cy0 + 8, cx0 - 1:cx0], (8, 8))
                cres = plane[mby * 8:mby * 8 + 8,
                             mbx * 8:mbx * 8 + 8].astype(np.int64) \
                    - cpred
                cwdc = np.empty((2, 2), dtype=np.int64)
                cacz = {}
                for by in range(2):
                    for bx in range(2):
                        blk = cres[by * 4:by * 4 + 4,
                                   bx * 4:bx * 4 + 4]
                        t = _CF @ blk @ _CF.T
                        cwdc[by, bx] = t[0, 0]
                        cacz[(bx, by)] = _quant4x4(t, qpc,
                                                   skip_dc=True)
                fdc = _H2 @ cwdc @ _H2
                cqbits = 15 + qpc // 6
                cf2 = 2 * ((1 << cqbits) // 3)
                czdc = np.sign(fdc) * (
                    (np.abs(fdc) * _MF[qpc % 6][0] + cf2)
                    >> (cqbits + 1))
                np.clip(czdc, -_LEVEL_CLAMP, _LEVEL_CLAMP, out=czdc)
                if np.any(czdc):
                    dc_nz = True
                if any(np.any(cacz[k]) for k in cacz):
                    ac_nz = True
                cost += level_cost(czdc, *cacz.values())
                cd[name] = (cpred, cwdc, cacz, czdc)
            return cost, cd, dc_nz, ac_nz

        ccost, cdata, chroma_dc_nz, chroma_ac_nz = chroma_cand(0)
        cmode_sel = 0
        if self.chromah and left_ok:
            ch = chroma_cand(1)
            # ue(1) costs 3 bits vs ue(0)'s 1: +2 penalty
            if ch[0] + 2 < ccost:
                ccost, cdata, chroma_dc_nz, chroma_ac_nz = ch
                cmode_sel = 1
        cbp_chroma = 2 if chroma_ac_nz else (1 if chroma_dc_nz else 0)

        # ---- syntax + luma residual
        nnz = self.luma_nnz
        nby0, nbx0 = mby * 4 + 1, mbx * 4 + 1
        if use_i4:
            self.is_i4[mby, mbx] = True
            for z, (bx, by) in enumerate(_BLOCK_SCAN):
                self.i4modes[mby * 4 + by, mbx * 4 + bx] = i4m[z]
            cbpl = 0
            for q in range(4):
                if np.any(i4lv[4 * q:4 * q + 4]):
                    cbpl |= 1 << q
            cbp = cbpl | (cbp_chroma << 4)
            w.ue(0)                 # mb_type: I_4x4
            for z in range(16):     # mb_pred(): per-block mode bits
                m, pm = int(i4m[z]), int(i4pred[z])
                if m == pm:
                    w.u(1, 1)       # prev_intra4x4_pred_mode_flag
                else:
                    w.u(0, 1)
                    w.u(m if m < pm else m - 1, 3)
            w.ue(cmode_sel)         # intra_chroma_pred_mode
            w.ue(int(_CBP_INTRA_CODE[cbp]))     # cbp, me(v) intra
            if cbp:
                w.se(0)             # mb_qp_delta
            for z, (bx, by) in enumerate(_BLOCK_SCAN):
                if not (cbpl >> (z >> 2)) & 1:
                    nnz[nby0 + by, nbx0 + bx] = 0
                    continue
                t_ok = top_ok if by == 0 else True
                l_ok = left_ok if bx == 0 else True
                nc = _nc_context(nnz, nby0 + by, nbx0 + bx, t_ok, l_ok)
                tc = _write_residual_block(
                    w, _zigzag_list(i4lv[z], skip_dc=False), nc)
                nnz[nby0 + by, nbx0 + bx] = tc
        else:
            self.is_i4[mby, mbx] = False
            # mb_type (I_16x16 with the chosen pred mode), chroma mode,
            # qp_delta (0: constant QP), residuals
            mb_type = (1 + predmode + 4 * cbp_chroma
                       + 12 * (1 if cbp_luma else 0))
            w.ue(mb_type)
            w.ue(cmode_sel)  # intra_chroma_pred_mode
            w.se(0)  # mb_qp_delta (always present for Intra_16x16)

            # luma DC: nC as for 4x4 block 0
            nc = _nc_context(nnz, nby0, nbx0, top_ok, left_ok)
            _write_residual_block(w, _zigzag_list(zdc, skip_dc=False),
                                  nc)
            # luma AC blocks in coding order (only if cbp_luma)
            if cbp_luma:
                for bx, by in _BLOCK_SCAN:
                    t_ok = top_ok if by == 0 else True
                    l_ok = left_ok if bx == 0 else True
                    nc = _nc_context(nnz, nby0 + by, nbx0 + bx, t_ok,
                                     l_ok)
                    tc = _write_residual_block(
                        w, _zigzag_list(acz[(bx, by)], skip_dc=True),
                        nc)
                    nnz[nby0 + by, nbx0 + bx] = tc
            else:
                nnz[nby0:nby0 + 4, nbx0:nbx0 + 4] = 0
        # chroma DC (both components) if cbp_chroma
        if cbp_chroma:
            for name in ("cb", "cr"):
                _, _, _, czdc = cdata[name]
                lst = [int(czdc[0, 0]), int(czdc[0, 1]),
                       int(czdc[1, 0]), int(czdc[1, 1])]
                _write_residual_block(w, lst, -1)
        # chroma AC if cbp_chroma == 2
        for name in ("cb", "cr"):
            cnnz = self.cb_nnz if name == "cb" else self.cr_nnz
            cny0, cnx0 = mby * 2 + 1, mbx * 2 + 1
            _, _, cacz, _ = cdata[name]
            if cbp_chroma == 2:
                for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
                    t_ok = top_ok if by == 0 else True
                    l_ok = left_ok if bx == 0 else True
                    nc = _nc_context(cnnz, cny0 + by, cnx0 + bx, t_ok,
                                     l_ok)
                    tc = _write_residual_block(
                        w, _zigzag_list(cacz[(bx, by)], skip_dc=True), nc)
                    cnnz[cny0 + by, cnx0 + bx] = tc
            else:
                cnnz[cny0:cny0 + 2, cnx0:cnx0 + 2] = 0

        # ---- reconstruction (must equal any conformant decoder);
        # pred is a scalar (DC) or a (16, 1) column (HORIZONTAL).
        # The Intra_4x4 trial already wrote its luma recon.
        if not use_i4:
            dcd = _luma_dc_dequant(_H4 @ zdc @ _H4, qp)
            for by in range(4):
                for bx in range(4):
                    d = _dequant4x4(acz[(bx, by)], qp)
                    d[0, 0] = dcd[by, bx]
                    r = (_inv4x4(d) + 32) >> 6
                    p_blk = (pred if np.isscalar(pred)
                             else pred[by * 4:by * 4 + 4])
                    blk = np.clip(r + p_blk, 0, 255)
                    self.ry[y0 + by * 4:y0 + by * 4 + 4,
                            x0 + bx * 4:x0 + bx * 4 + 4] = blk
        for name in ("cb", "cr"):
            rp = self.rcb if name == "cb" else self.rcr
            cpred, _, cacz, czdc = cdata[name]
            cdcd = _chroma_dc_dequant(_H2 @ czdc @ _H2, qpc)
            for by in range(2):
                for bx in range(2):
                    d = _dequant4x4(cacz[(bx, by)], qpc)
                    d[0, 0] = cdcd[by, bx]
                    r = (_inv4x4(d) + 32) >> 6
                    blk = np.clip(
                        r + cpred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4],
                        0, 255)
                    rp[cy0 + by * 4:cy0 + by * 4 + 4,
                       cx0 + bx * 4:cx0 + bx * 4 + 4] = blk


# -------------------------------------------------------- frame encoding ----


def build_pps_cavlc() -> bytes:
    """PPS with deblocking control enabled (the slice header turns the
    in-loop filter OFF so decoder output == encoder reconstruction)."""
    w = _BitWriter()
    w.u(0, 1).u(3, 2).u(8, 5)  # nal header: PPS
    w.ue(0)                    # pic_parameter_set_id
    w.ue(0)                    # seq_parameter_set_id
    w.u(0, 1)                  # entropy_coding_mode_flag: CAVLC
    w.u(0, 1)                  # bottom_field_pic_order_in_frame_present
    w.ue(0)                    # num_slice_groups_minus1
    w.ue(0).ue(0)              # num_ref_idx defaults
    w.u(0, 1)                  # weighted_pred_flag
    w.u(0, 2)                  # weighted_bipred_idc
    w.se(0).se(0)              # pic_init_qp/qs_minus26 (26)
    w.se(0)                    # chroma_qp_index_offset
    w.u(1, 1)                  # deblocking_filter_control_present_flag
    w.u(0, 1)                  # constrained_intra_pred_flag
    w.u(0, 1)                  # redundant_pic_cnt_present_flag
    w.trailing()
    return _escape(w.bytes())


def _slice_head_cavlc(w: _BitWriter, idr_pic_id: int, qp: int,
                      first_mb: int = 0, deblock: bool = False,
                      slice_local: bool = False) -> None:
    w.u(0, 1).u(3, 2).u(5, 5)  # nal header: IDR slice
    w.ue(first_mb)             # first_mb_in_slice
    w.ue(7)                    # slice_type: I (all slices of picture)
    w.ue(0)                    # pic_parameter_set_id
    w.u(0, 4)                  # frame_num
    w.ue(idr_pic_id)
    w.u(0, 1)                  # no_output_of_prior_pics_flag
    w.u(0, 1)                  # long_term_reference_flag
    w.se(qp - 26)              # slice_qp_delta
    if deblock:
        # disable_deblocking_filter_idc: 0 = filter everywhere,
        # 2 = filter but not across slice boundaries (GDR+deblock)
        w.ue(2 if slice_local else 0)
        w.se(0)                # slice_alpha_c0_offset_div2
        w.se(0)                # slice_beta_offset_div2
    else:
        w.ue(1)                # disable_deblocking_filter_idc: OFF


def encode_frame_cavlc_slices(nv12: np.ndarray, width: int, height: int,
                              qp: int, idr_pic_id: int = 0,
                              slices: int = 1,
                              return_recon: bool = False,
                              deblock: bool = False,
                              i4: bool = False,
                              chromah: bool = False):
    """Encode one NV12 frame as ``slices`` independent CAVLC IDR slice
    NALs (MB-row bands, like the reference's ``num-slices=8`` OMX tuning
    and the PCM encoder's ``slices``).  H.264 slices share no contexts:
    DC prediction and nC neighbor state treat the band's first MB row as
    frame-top (``first_mb_row``), so each band is independently
    decodable AND independently computable — the native port runs bands
    on threads.  Reconstruction planes are shared (bands only ever read
    their own rows)."""
    if width % 16 or height % 16:
        raise ValueError("CAVLC path requires 16-aligned padded frames")
    y = nv12[:height].astype(np.int64)
    uv = nv12[height:].reshape(height // 2, width // 2, 2)
    cb = uv[:, :, 0].astype(np.int64)
    cr = uv[:, :, 1].astype(np.int64)
    st = _MbEncoder(width, height, qp, i4=i4, chromah=chromah)
    slices = max(1, min(int(slices), st.mb_h))
    bounds = [round(i * st.mb_h / slices) for i in range(slices + 1)]
    nals = []
    for i in range(slices):
        w = _BitWriter()
        _slice_head_cavlc(w, idr_pic_id, qp,
                          first_mb=bounds[i] * st.mb_w, deblock=deblock)
        for mby in range(bounds[i], bounds[i + 1]):
            for mbx in range(st.mb_w):
                st.encode_mb(w, mby, mbx, y, cb, cr,
                             first_mb_row=bounds[i])
        w.trailing()
        nals.append(_escape(np.frombuffer(w.bytes(), dtype=np.uint8)))
    if return_recon:
        return nals, (st.ry[1:, 1:].copy(), st.rcb[1:, 1:].copy(),
                      st.rcr[1:, 1:].copy())
    return nals


def encode_frame_from_levels(zdc: np.ndarray, acz: np.ndarray,
                             czdc: np.ndarray, cacz: np.ndarray,
                             qp: int, idr_pic_id: int = 0,
                             imode: np.ndarray | None = None,
                             deblock: bool = False,
                             i4modes: np.ndarray | None = None,
                             cmode: np.ndarray | None = None
                             ) -> list[bytes]:
    """Entropy-code precomputed quantized levels into one IDR slice NAL
    **per MB row** (the slice granularity the TPU level computation in
    ops/h264_levels.py assumes: top neighbor never available).

    Layouts are LevelArrays' (ops/h264_levels.py): ``zdc`` (mb_h, mb_w,
    16) luma DC raster; ``acz`` (mb_h, mb_w, 16, 16) per-block
    [by*4+bx] raster coeffs with the DC slot zeroed; ``czdc`` (mb_h,
    mb_w, 2, 4); ``cacz`` (mb_h, mb_w, 2, 4, 16).  Produces streams
    byte-identical to ``encode_frame_cavlc_slices(..., slices=mb_h)``
    (tests/test_h264_levels.py); the native fast path is
    ``fp_cavlc_entropy_slices``.  This is the pure-Python fallback and
    the oracle the native port is diffed against.
    """
    mb_h, mb_w = zdc.shape[:2]
    zof = {bxby: z for z, bxby in enumerate(_BLOCK_SCAN)}
    nals = []
    for mby in range(mb_h):
        w = _BitWriter()
        _slice_head_cavlc(w, idr_pic_id, qp, first_mb=mby * mb_w,
                          deblock=deblock)
        # per-slice nC context: rows of 4x4 blocks within this MB row
        # (+1 left pad), reset every slice
        lnnz = np.zeros((4, mb_w * 4 + 1), dtype=np.int64)
        cbnnz = np.zeros((2, mb_w * 2 + 1), dtype=np.int64)
        crnnz = np.zeros_like(cbnnz)
        prev_is_i4 = False      # left MB's I_4x4 mode context
        prev_m3 = [2, 2, 2, 2]  # its bx=3 block modes per by
        for mbx in range(mb_w):
            left_ok = mbx > 0
            a = acz[mby, mbx]
            ca = cacz[mby, mbx]
            cd = czdc[mby, mbx]
            cbp_chroma = 2 if np.any(ca) else (1 if np.any(cd) else 0)
            pm = 2 if imode is None else int(imode[mby, mbx])
            cm = 0 if cmode is None else int(cmode[mby, mbx])
            nbx0 = mbx * 4 + 1
            if pm == 0:
                # ---- I_4x4 (device twin of the oracle's use_i4
                # branch in _MbEncoder.encode_mb): acz slots carry the
                # FULL 16-coeff blocks, no luma DC block
                zm = i4modes[mby, mbx]          # (16,) z-order
                cbpl = 0
                for q in range(4):
                    if any(np.any(a[by * 4 + bx])
                           for bx, by in _BLOCK_SCAN[4 * q:4 * q + 4]):
                        cbpl |= 1 << q
                cbp = cbpl | (cbp_chroma << 4)
                w.ue(0)                         # mb_type: I_4x4
                for z, (bx, by) in enumerate(_BLOCK_SCAN):
                    # predicted mode, spec 8.3.1.1 at top_ok=False
                    if by == 0:
                        predm = 2
                    else:
                        mb_ = int(zm[zof[(bx, by - 1)]])
                        if bx > 0:
                            predm = min(int(zm[zof[(bx - 1, by)]]),
                                        mb_)
                        elif left_ok:
                            predm = min(prev_m3[by] if prev_is_i4
                                        else 2, mb_)
                        else:
                            predm = 2
                    m = int(zm[z])
                    if m == predm:
                        w.u(1, 1)
                    else:
                        w.u(0, 1)
                        w.u(m if m < predm else m - 1, 3)
                w.ue(cm)                        # intra_chroma mode
                w.ue(int(_CBP_INTRA_CODE[cbp]))
                if cbp:
                    w.se(0)                     # mb_qp_delta
                for z, (bx, by) in enumerate(_BLOCK_SCAN):
                    if not (cbpl >> (z >> 2)) & 1:
                        lnnz[by, nbx0 + bx] = 0
                        continue
                    l_ok = left_ok if bx == 0 else True
                    if by == 0:
                        nc = int(lnnz[0, nbx0 + bx - 1]) if l_ok else 0
                    else:
                        na = (int(lnnz[by, nbx0 + bx - 1])
                              if l_ok else None)
                        nb = int(lnnz[by - 1, nbx0 + bx])
                        nc = ((na + nb + 1) >> 1
                              if na is not None else nb)
                    flat = a[by * 4 + bx]
                    tc = _write_residual_block(
                        w, [int(flat[i]) for i in _ZIGZAG], nc)
                    lnnz[by, nbx0 + bx] = tc
                prev_is_i4 = True
                prev_m3 = [int(zm[zof[(3, byy)]]) for byy in range(4)]
                # chroma residual below is shared with I_16x16
            else:
                cbp_luma = bool(np.any(a))
                w.ue(1 + pm + 4 * cbp_chroma
                     + 12 * (1 if cbp_luma else 0))
                w.ue(cm)  # intra_chroma_pred_mode
                w.se(0)  # mb_qp_delta
                nc = int(lnnz[0, nbx0 - 1]) if left_ok else 0
                dcflat = zdc[mby, mbx]
                _write_residual_block(
                    w, [int(dcflat[i]) for i in _ZIGZAG], nc)
                if cbp_luma:
                    for bx, by in _BLOCK_SCAN:
                        l_ok = left_ok if bx == 0 else True
                        if by == 0:
                            nc = (int(lnnz[0, nbx0 + bx - 1])
                                  if l_ok else 0)
                        else:
                            na = (int(lnnz[by, nbx0 + bx - 1])
                                  if l_ok else None)
                            nb = int(lnnz[by - 1, nbx0 + bx])
                            nc = ((na + nb + 1) >> 1
                                  if na is not None else nb)
                        flat = a[by * 4 + bx]
                        tc = _write_residual_block(
                            w, [int(flat[i]) for i in _ZIGZAG[1:]], nc)
                        lnnz[by, nbx0 + bx] = tc
                else:
                    lnnz[:, nbx0:nbx0 + 4] = 0
                prev_is_i4 = False
                prev_m3 = [2, 2, 2, 2]
            if cbp_chroma:
                for comp in range(2):
                    _write_residual_block(
                        w, [int(v) for v in cd[comp]], -1)
            cnx0 = mbx * 2 + 1
            for comp in range(2):
                cnnz = cbnnz if comp == 0 else crnnz
                if cbp_chroma == 2:
                    for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
                        l_ok = left_ok if bx == 0 else True
                        if by == 0:
                            nc = int(cnnz[0, cnx0 + bx - 1]) if l_ok else 0
                        else:
                            na = (int(cnnz[by, cnx0 + bx - 1])
                                  if l_ok else None)
                            nb = int(cnnz[by - 1, cnx0 + bx])
                            nc = ((na + nb + 1) >> 1
                                  if na is not None else nb)
                        flat = ca[comp, by * 2 + bx]
                        tc = _write_residual_block(
                            w, [int(flat[i]) for i in _ZIGZAG[1:]], nc)
                        cnnz[by, cnx0 + bx] = tc
                else:
                    cnnz[:, cnx0:cnx0 + 2] = 0
        w.trailing()
        nals.append(bytes(
            _escape(np.frombuffer(w.bytes(), dtype=np.uint8))))
    return nals


def encode_frame_cavlc(nv12: np.ndarray, width: int, height: int, qp: int,
                       idr_pic_id: int = 0,
                       return_recon: bool = False):
    """Encode one NV12 frame as a single-slice CAVLC IDR NAL (no start
    code).  Requires 16-aligned dimensions (callers pad/crop via the SPS
    cropping window the same way the PCM encoder does — here we require
    alignment and let the encoder class handle padding).  With
    ``return_recon``, also returns the (Y, Cb, Cr) int arrays a
    conformant decoder must reproduce exactly."""
    if width % 16 or height % 16:
        raise ValueError("CAVLC path requires 16-aligned padded frames")
    y = nv12[:height].astype(np.int64)
    uv = nv12[height:].reshape(height // 2, width // 2, 2)
    cb = uv[:, :, 0].astype(np.int64)
    cr = uv[:, :, 1].astype(np.int64)
    w = _BitWriter()
    _slice_head_cavlc(w, idr_pic_id, qp)
    st = _MbEncoder(width, height, qp)
    for mby in range(st.mb_h):
        for mbx in range(st.mb_w):
            st.encode_mb(w, mby, mbx, y, cb, cr, first_mb_row=0)
    w.trailing()
    nal = _escape(np.frombuffer(w.bytes(), dtype=np.uint8))
    if return_recon:
        return nal, (st.ry[1:, 1:].copy(), st.rcb[1:, 1:].copy(),
                     st.rcr[1:, 1:].copy())
    return nal


class CavlcH264Encoder:
    """Frame-in/AU-out compressed intra H.264 encoder (io.encoder
    protocol), with closed-loop bitrate control in the QP domain.

    ``qp`` fixes the quantizer; ``bitrate_kbps`` (with ``fps``) instead
    adapts QP each frame toward the target frame budget — the in-repo
    analogue of the reference encoder's ``target-bitrate``
    (``OpenCVequalHist.cpp:313-315``).  Frames are edge-padded to the
    16-px grid; the SPS cropping window restores the true geometry.
    """

    codec = "h264"

    def __init__(self, width: int, height: int, qp: int = 30,
                 bitrate_kbps: int | None = None, fps: float = 30.0,
                 native: str = "auto", slices: int = 1,
                 threads: int = 0, deblock: bool = False,
                 cpb_ms: int | None = None,
                 initial_delay_ms: int | None = None,
                 i4: bool = False, chromah: bool = False) -> None:
        """``slices`` > 1 splits each frame into that many independent
        IDR slices (MB-row bands — the reference's ``num-slices=8``
        analogue): smaller NALs on the wire and, with ``threads`` > 0 on
        the native path, parallel per-band encoding.  ``deblock``
        signals the in-loop filter ON (idc=0): for this all-IDR stream
        the encode is unchanged — only the decoder's displayed picture
        gains the spec 8.7 filtering (io.h264_deblock is the oracle of
        what it displays)."""
        if width % 2 or height % 2:
            raise ValueError("NV12 requires even dimensions")
        if slices < 1:
            raise ValueError(f"slices must be >= 1, got {slices}")
        self.width = width
        self.height = height
        self.qp = int(qp)
        self.deblock = bool(deblock)
        self.i4 = bool(i4)
        self.chromah = bool(chromah)
        self.slices = int(slices)
        self._threads = max(0, int(threads))
        self.bitrate_kbps = bitrate_kbps
        self.fps = fps
        # CPB/HRD hard constraint (control-rate=low-latency cpb-size=N
        # initial-delay=M, OpenCVequalHist.cpp:313-314): the windowed/
        # proportional control shapes the average; the leaky bucket is
        # the per-frame ceiling, enforced by re-encoding at higher QP
        self._cpb = None
        if cpb_ms is None and initial_delay_ms is not None:
            raise ValueError("initdelay requires cpb")
        if cpb_ms is not None:
            from opencv_opencl_tpu_torch.io.h264_hrd import CpbModel

            if not bitrate_kbps:
                raise ValueError(
                    "cpb needs bitrate control (bitrate_kbps), not a "
                    "fixed qp")
            self._cpb = CpbModel(
                bitrate_kbps, cpb_ms,
                cpb_ms // 2 if initial_delay_ms is None
                else initial_delay_ms, fps)
        self._sps = build_sps(
            width, height,
            hrd=None if self._cpb is None else self._cpb.params)
        self._pps = build_pps_cavlc()
        self._idr_pic_id = 0
        self.frames = 0
        self._native = False
        if native != "never":
            from opencv_opencl_tpu_torch import native as _nm

            if native == "require" and not (_nm.available()
                                            and _nm.has_cavlc()):
                raise RuntimeError(
                    f"native cavlc unavailable: {_nm.build_error()}")
            self._native = _nm.available() and _nm.has_cavlc()
        self._workspace: dict = {}

    def _pad(self, nv12: np.ndarray) -> tuple[np.ndarray, int, int]:
        w16 = -(-self.width // 16) * 16
        h16 = -(-self.height // 16) * 16
        if w16 == self.width and h16 == self.height:
            return np.ascontiguousarray(nv12), w16, h16
        y = nv12[:self.height]
        uv = nv12[self.height:]
        y = np.pad(y, ((0, h16 - self.height), (0, w16 - self.width)),
                   mode="edge")
        uvp = np.pad(
            uv.reshape(self.height // 2, self.width // 2, 2),
            ((0, (h16 - self.height) // 2), (0, (w16 - self.width) // 2),
             (0, 0)), mode="edge")
        out = np.concatenate(
            [y, uvp.reshape(h16 // 2, w16)], axis=0)
        return np.ascontiguousarray(out), w16, h16

    def _encode_nals(self, padded: np.ndarray, w16: int, h16: int,
                     idr: int, qp: int) -> list[bytes]:
        """Produce the slice NALs of one padded frame (the overridable
        compute stage — CudaCavlcEncoder replaces it with the level
        computation on the card)."""
        if self._native and not self.i4 and not self.chromah:
            # the native C++ rows do not speak Intra_4x4 / chroma
            # HORIZONTAL yet — those flags take the tested Python
            # oracle path (the parts entropy-stage fallback contract)
            from opencv_opencl_tpu_torch import native

            return native.cavlc_encode_slices(
                padded, w16, h16, qp, idr, slices=self.slices,
                threads=self._threads, workspace=self._workspace,
                deblock=self.deblock)
        return encode_frame_cavlc_slices(padded, w16, h16, qp, idr,
                                         slices=self.slices,
                                         deblock=self.deblock,
                                         i4=self.i4,
                                         chromah=self.chromah)

    def _rate_control(self, used: int) -> None:
        """Proportional control in the QP domain: intra bits halve
        roughly every 6 QP, so the corrective step is
        ~6*log2(used/target).  Upward (cheaper) steps are allowed
        bigger than downward ones — overshoot risks bursts/drops
        (the reference's low-latency control-rate bias), while
        undershoot only costs quality for a frame or two."""
        target = self.bitrate_kbps * 1000 / 8 / self.fps
        if used > 1.15 * target or used < 0.85 * target:
            import math

            delta = round(6 * math.log2(used / target))
            self.qp = min(51, max(10, self.qp + min(6, max(-3, delta))))

    def _cpb_bump(self, qp: int, bits: int, budget: int) -> int:
        """QP step that should bring ``bits`` under ``budget`` (intra
        bits roughly halve per +6 QP)."""
        import math

        step = round(6 * math.log2(bits / max(budget, 1)))
        return min(51, qp + max(1, min(6, step)))

    def encode(self, nv12: np.ndarray) -> list[bytes]:
        rows = self.height * 3 // 2
        arr = np.asarray(nv12, dtype=np.uint8).reshape(rows, self.width)
        padded, w16, h16 = self._pad(arr)
        idr = self._idr_pic_id
        self._idr_pic_id ^= 1
        self.frames += 1
        qp = self.qp
        while True:
            nals = self._encode_nals(padded, w16, h16, idr, qp)
            au = (_START4 + self._sps + _START4 + self._pps +
                  b"".join(_START4 + bytes(n) for n in nals))
            if self._cpb is None or qp >= 51:
                break
            budget = self._cpb.budget_bits()
            if 8 * len(au) <= budget:
                break
            qp = self._cpb_bump(qp, 8 * len(au), budget)
        if self._cpb is not None:
            self._cpb.add_frame(8 * len(au))
            self.qp = qp  # the forced QP carries forward
        if self.bitrate_kbps:
            self._rate_control(len(au))
        return [au]

    def flush(self) -> list[bytes]:
        return []

    def close(self) -> None:
        pass



def intra_bits_nals(words: np.ndarray, nbits: np.ndarray, idr: int, qp: int,
                    nw_mb: int, deblock: bool = False) -> list[bytes] | None:
    """One IDR slice NAL per MB row from the device-packed MB bit strings
    (``ops/h264_bitpack.pack_i_mbs``): the host writes the slice headers,
    concatenates and escapes.  None when an MB overflowed the ``nw_mb``
    words (its true bit count is larger): the caller codes the frame on
    the host entropy path instead."""
    from opencv_opencl_tpu_torch.ops.h264_bitpack import assemble_slices_from_bits

    if int(nbits.max(initial=0)) > 32 * nw_mb:
        return None
    mb_w = nbits.shape[1]

    def header_fn(mby):
        w = _BitWriter()
        _slice_head_cavlc(w, idr, qp, first_mb=mby * mb_w, deblock=deblock)
        return w

    return assemble_slices_from_bits(words, nbits, header_fn)


class CudaCavlcEncoder(CavlcH264Encoder):
    """CAVLC intra encoder with the arithmetic on the card (the JAX
    package's ``TpuCavlcEncoder``).

    The compute stage (prediction, 4x4 transforms, DC Hadamards,
    quantization, edge reconstruction) is one launch of H1
    (ops/h264_levels.py: the grids ``levels_split_kernel``, a warp an MB,
    ``levels_chain_kernel``, a warp an MB row along the left edges, and
    ``levels_intra_kernel``; with ``i4`` ``intra_levels_kernel``, a block an
    MB row); the host does entropy coding only (native
    ``fp_cavlc_entropy_rows`` on every host thread, or the Python fallback
    where the library does not build).  Streams are byte-identical to
    ``CavlcH264Encoder(slices=mb_h)``: one IDR slice per MB row, the
    granularity that makes rows independent on the card.

    It runs on the card unless ``device="cpu"`` (the plain PyTorch version
    of the kernel, for the tests); with no device and no card it raises.
    ``encode`` takes host NV12 as every encoder does: the frame goes up
    through a pinned buffer, the levels of the frame (one int16 buffer,
    ~0.8 KB a MB) come back into another.

    ``overlap=True`` adds a depth-1 software pipeline: ``encode`` launches
    the frame's kernel and its levels' copy to the host, records an event,
    and returns the access unit of the PREVIOUS frame, whose event it waits
    on, so the card computes frame N while the host entropy-codes frame N-1.
    The stream gains exactly one frame of latency (``flush`` drains the
    tail) and the closed-loop rate control reacts one frame later; the
    emitted bytes per frame are unchanged.

    ``bitpack=True`` moves the entropy stage's bit-level work onto the card
    too (ops/h264_bitpack.py): ``pack_i_kernel`` packs every MB's CAVLC bit
    string from the level buffer, which stays on the card, and the host
    fetches the words and bit counts (``nw_mb`` words a MB) and writes only
    the slice headers, the concatenation, the trailing bits and emulation
    prevention.  Streams stay byte-identical: a frame where an MB overflows
    the ``nw_mb`` words goes through the host entropy path from its levels,
    fetched then (counted in ``_bits_overflows``).
    """

    def __init__(self, width: int, height: int, qp: int = 30,
                 bitrate_kbps: int | None = None, fps: float = 30.0,
                 native: str = "auto", threads: int = 0,
                 overlap: bool = False, deblock: bool = False,
                 bitpack: bool = False, nw_mb: int = 64,
                 cpb_ms: int | None = None,
                 initial_delay_ms: int | None = None,
                 i4: bool = False, chromah: bool = False,
                 device=None) -> None:
        h16 = -(-height // 16) * 16
        if threads == 0:
            import os

            threads = os.cpu_count() or 1
        if overlap and cpb_ms is not None:
            raise ValueError(
                "cpb does not compose with overlap (the CPB re-encode "
                "loop is synchronous per frame)")
        super().__init__(width, height, qp=qp, bitrate_kbps=bitrate_kbps,
                         fps=fps, native=native, slices=h16 // 16,
                         threads=threads, deblock=deblock,
                         cpb_ms=cpb_ms,
                         initial_delay_ms=initial_delay_ms, i4=i4,
                         chromah=chromah)
        import torch

        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaCavlcEncoder runs on the card and torch.cuda.is_available() "
                "is false; device='cpu' runs the kernel's plain version")
        self._overlap = bool(overlap)
        self._pending = None  # (levels handle, idr, qp)
        self._bitpack = bool(bitpack)
        self._nw_mb = int(nw_mb)
        # frames whose packed bits overflowed the cap (coded on the host)
        self._bits_overflows = 0
        # on the card: two slots (pinned upload, pinned levels or words and
        # bit counts, event; with bitpack the frame's device buffers too),
        # so that frame N+1 goes up while frame N is entropy-coded
        self._slots: list[dict] = []
        self._flip = 0

    def _card_buffers(self, rows: int, w16: int, words: int, mb_h: int,
                      mb_w: int) -> None:
        import torch

        dev = self.device
        self._dev_frame = torch.empty((rows, w16), dtype=torch.uint8, device=dev)
        self._dev_levels = torch.empty(words, dtype=torch.int16, device=dev)
        self._slots = []
        for _ in range(2):
            slot = {"frame": torch.empty((rows, w16), dtype=torch.uint8, pin_memory=True),
                    "levels": torch.empty(words, dtype=torch.int16, pin_memory=True),
                    "event": None}
            if self._bitpack:
                # the levels stay on the card until the frame is coded
                slot.update(
                    levels_dev=torch.empty(words, dtype=torch.int16, device=dev),
                    words_dev=torch.empty((mb_h, mb_w, self._nw_mb), dtype=torch.uint32,
                                          device=dev),
                    nbits_dev=torch.empty((mb_h, mb_w), dtype=torch.int32, device=dev),
                    words=torch.empty((mb_h, mb_w, self._nw_mb), dtype=torch.uint32,
                                      pin_memory=True),
                    nbits=torch.empty((mb_h, mb_w), dtype=torch.int32, pin_memory=True))
            self._slots.append(slot)

    def _dispatch_levels(self, padded: np.ndarray, w16: int, h16: int,
                         qp: int):
        """Start the level computation of one padded frame: (event or
        None, the levels by name as host arrays, valid once the event has
        completed; with bitpack the packed ``words`` and ``nbits`` and a
        function ``levels`` that fetches the levels)."""
        import torch

        from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as packer
        from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kernel

        mb_h, mb_w = h16 // 16, w16 // 16
        if self.device.type != "cuda":
            frame = torch.from_numpy(np.array(padded, copy=True)).to(self.device)
            uv = frame[h16:].reshape(h16 // 2, w16 // 2, 2)
            lv, *rest = kernel.encode_levels(frame[:h16], uv[:, :, 0],
                                             uv[:, :, 1], qp, i4=self.i4,
                                             chromah=self.chromah)
            names = ["imode"] + ["i4modes"] * self.i4 + ["cmode"] * self.chromah
            parts = dict(zip([*lv._fields, *names], [*lv, *rest]))
            host = {name: a.numpy() for name, a in parts.items()}
            if not self._bitpack:
                return None, host
            words, nbits = packer.pack_i_mbs(
                *(parts[k] for k in ("zdc", "acz", "czdc", "cacz", "imode")),
                self._nw_mb, parts.get("i4modes"), parts.get("cmode"))
            return None, {"words": words.numpy(), "nbits": nbits.numpy(),
                          "levels": lambda: host}
        words = kernel.level_words(mb_h, mb_w, self.i4, self.chromah)
        if not self._slots or self._dev_levels.numel() != words:
            self._card_buffers(padded.shape[0], w16, words, mb_h, mb_w)
        slot = self._slots[self._flip]
        self._flip ^= 1
        if slot["event"] is not None:
            slot["event"].synchronize()   # its upload and copy are done
        np.copyto(slot["frame"].numpy(), padded)
        frame = self._dev_frame
        frame.copy_(slot["frame"], non_blocking=True)
        uv = frame[h16:].view(h16 // 2, w16 // 2, 2)
        levels = slot["levels_dev"] if self._bitpack else self._dev_levels
        kernel.intra_levels(frame[:h16], uv[:, :, 0], uv[:, :, 1], qp,
                            levels, i4=self.i4, chromah=self.chromah)
        if self._bitpack:
            v = kernel.split_levels(levels, mb_h, mb_w, self.i4, self.chromah)
            packer.pack_i_into(v["zdc"], v["acz"], v["czdc"], v["cacz"], v["imode"],
                               slot["words_dev"], slot["nbits_dev"], v.get("i4modes"),
                               v.get("cmode"))
            slot["words"].copy_(slot["words_dev"], non_blocking=True)
            slot["nbits"].copy_(slot["nbits_dev"], non_blocking=True)
        else:
            slot["levels"].copy_(levels, non_blocking=True)
        slot["event"] = torch.cuda.Event()
        slot["event"].record(torch.cuda.current_stream(self.device))

        def fetch():
            # an MB overflowed the cap: the levels come down after all
            slot["levels"].copy_(levels)
            return kernel.split_levels(slot["levels"].numpy(), mb_h, mb_w, self.i4,
                                       self.chromah)

        if self._bitpack:
            return slot["event"], {"words": slot["words"].numpy(),
                                   "nbits": slot["nbits"].numpy(), "levels": fetch}
        return slot["event"], kernel.split_levels(
            slot["levels"].numpy(), mb_h, mb_w, self.i4, self.chromah)

    def _entropy_nals(self, lv, idr: int, qp: int) -> list[bytes]:
        """Entropy-code the levels of one :meth:`_dispatch_levels` once
        they are on the host (with bitpack: assemble the packed bits, or
        code the levels where an MB overflowed the cap)."""
        event, parts = lv
        if event is not None:
            event.synchronize()
        if "words" in parts:
            nals = intra_bits_nals(parts["words"], parts["nbits"], idr, qp, self._nw_mb,
                                   deblock=self.deblock)
            if nals is not None:
                return nals
            self._bits_overflows += 1
            parts = parts["levels"]()
        zdc, acz, czdc, cacz = (parts[k] for k in ("zdc", "acz", "czdc", "cacz"))
        imode, i4modes, cmode = (parts.get(k) for k in ("imode", "i4modes", "cmode"))
        if self._native:
            from opencv_opencl_tpu_torch import native

            return native.cavlc_entropy_rows(
                zdc, acz, czdc, cacz, qp, idr, threads=self._threads,
                workspace=self._workspace, imode=imode,
                deblock=self.deblock, i4modes=i4modes, cmode=cmode)
        return encode_frame_from_levels(zdc, acz, czdc, cacz, qp, idr,
                                        imode=imode,
                                        deblock=self.deblock,
                                        i4modes=i4modes,
                                        cmode=cmode)

    def _encode_nals(self, padded: np.ndarray, w16: int, h16: int,
                     idr: int, qp: int) -> list[bytes]:
        return self._entropy_nals(
            self._dispatch_levels(padded, w16, h16, qp), idr, qp)

    def _assemble_au(self, lv, idr: int, qp: int) -> bytes:
        nals = self._entropy_nals(lv, idr, qp)
        au = (_START4 + self._sps + _START4 + self._pps +
              b"".join(_START4 + bytes(n) for n in nals))
        if self.bitrate_kbps:
            self._rate_control(len(au))
        return au

    def encode(self, nv12: np.ndarray) -> list[bytes]:
        if not self._overlap:
            return super().encode(nv12)
        rows = self.height * 3 // 2
        arr = np.asarray(nv12, dtype=np.uint8).reshape(rows, self.width)
        padded, w16, h16 = self._pad(arr)
        idr = self._idr_pic_id
        self._idr_pic_id ^= 1
        self.frames += 1
        prev, self._pending = self._pending, (
            self._dispatch_levels(padded, w16, h16, self.qp), idr, self.qp)
        if prev is None:
            return []
        return [self._assemble_au(*prev)]

    def flush(self) -> list[bytes]:
        prev, self._pending = self._pending, None
        if prev is None:
            return []
        return [self._assemble_au(*prev)]

    def encode_from_packed(self, packed: np.ndarray) -> list[bytes]:
        """Assemble one access unit from the packed level tensor of one
        frame of the fused enhance + encode step
        (models/fused_encode.build_enhance_levels_fn): the packed bits
        where they came down and no MB overflowed, else the host entropy
        path from the levels; SPS/PPS; rate control.  The slice-header qp
        is the in-band qp the levels were quantized with (rate control may
        have moved ``self.qp`` since that batch was dispatched).  The
        levels are I_16x16 whatever ``i4`` and ``chromah`` say, and
        ``overlap`` and ``cpb`` do not apply, as in the JAX package."""
        from opencv_opencl_tpu_torch.io.h264_inter import _split_bits_lanes
        from opencv_opencl_tpu_torch.ops.h264_levels import unpack_levels_host

        packed = np.asarray(packed)
        # bitpack: the packed MB bit strings ride as lanes after the
        # 410-lane base (fused_encode._bits_lanes)
        bits = None
        if (self._bitpack
                and packed.shape[-1] == 410 + 1 + 2 * self._nw_mb):
            bits = _split_bits_lanes(packed[:, :, 410:])
            packed = packed[:, :, :410]
        imode = None
        if packed.shape[-1] == 410:      # + per-MB intra pred mode lane
            imode = packed[:, :, 409]
            packed = packed[:, :, :409]
        idr = self._idr_pic_id
        self._idr_pic_id ^= 1
        self.frames += 1
        if bits is not None:
            qp = int(packed[0, 0, 408])  # in-band qp lane
            nals = intra_bits_nals(bits[0], bits[1], idr, qp, self._nw_mb,
                                   deblock=self.deblock)
            if nals is not None:
                au = (_START4 + self._sps + _START4 + self._pps +
                      b"".join(_START4 + bytes(n) for n in nals))
                if self.bitrate_kbps:
                    self._rate_control(len(au))
                return [au]
            # an MB overflowed the cap: the host entropy path
            self._bits_overflows += 1
        lv, qp = unpack_levels_host(packed)
        return [self._assemble_au((None, {**lv._asdict(), "imode": imode}),
                                  idr, qp)]
