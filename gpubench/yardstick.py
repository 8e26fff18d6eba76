"""The benchmark's fixed arithmetic: the card's peaks, the bound of a kernel,
the bytes and operations each kernel of the measured layers needs, counted
from the shapes and the algorithm (not from any kernel's design), and the
percentile.

Provenance (copied so that later edits of the sources cannot move the
yardstick): ``PEAK_BYTES_PER_S``, ``PEAK_OPS_PER_S`` and :func:`bound` from
``chip_smoke.py`` (``PEAK_*`` at its line 371, ``bound`` at 3742); the K1-K3
counts from ``chip_smoke.py`` ``phase_timings`` (the ``fx`` table, 3817-3831);
:func:`intra_ops`, :func:`p_ops`, :func:`planes_ops`, :func:`deblock_ops`
from ``chip_smoke.py`` ``intra_ops`` (4014), ``p_ops`` (4155), ``planes_ops``
(4169), ``deblock_ops_count`` (4179); the H1-H5 byte counts from
``chip_smoke.py`` ``intra_timings`` (4072) and ``gop_timings`` (4212-4310);
:func:`nearest_rank` from ``opencv_opencl_tpu_torch/metrics/timing.py``
``_nearest_rank``.
"""

from __future__ import annotations

import math

# NVIDIA's H100 SXM data sheet: HBM3 bytes/s, and the float32 rate outside
# the tensor cores.  The integer arithmetic of the SAD searches, transforms
# and filters is held to the float32 rate: an assumption (no integer rate
# for the CUDA cores is published), stated in PERF.md.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# fastsub's 49 quarter-pel offsets around the full-pel winner
FASTSUB_REFINE = 49
# the int16 levels of one MB (luma DC and AC, chroma DC and AC)
MB_LEVELS = 16 + 256 + 8 + 128
# an IDR's level buffer a MB (the levels and the intra mode), a P frame's
# (the levels, mode, mv (2), ref)
IDR_WORDS_MB = MB_LEVELS + 1
P_WORDS_MB = MB_LEVELS + 4


def bound(bytes_moved: float, ops: float) -> float:
    """The least time the card could take, in seconds: each input read once
    and each output written once at the HBM rate, or the operations at the
    float32 rate, whichever is longer."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def nearest_rank(values, pct: float) -> float:
    """The ``pct`` percentile of ``values`` by nearest rank."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(1, math.ceil(len(xs) * pct / 100.0))
    return xs[min(k, len(xs)) - 1]


# ------------------------------------------------------------ K1-K3 ----


def clahe_frame_bound(h: int, w: int, tiles: int) -> float:
    """Seconds K1, K2 and K3 need at least for one (h, w) frame with
    ``tiles`` tiles, each kernel bounded alone and the bounds summed.
    K1 reads the frame and writes int32 histograms; K2 reads them and
    writes uint8 LUTs, 4 operations a bin; K3 reads the frame, the LUTs and
    its per-row and per-column tables and writes the frame, 10 float32
    operations a pixel."""
    px, hist, luts = h * w, tiles * 256 * 4, tiles * 256
    k1 = bound(px + hist, px)
    k2 = bound(hist + luts, 4 * tiles * 256)
    k3 = bound(2 * px + luts + 12 * (h + w), 10 * px)
    return k1 + k2 + k3


# ------------------------------------------------------------ H1-H5 ----


def intra_ops(mb_h: int, mb_w: int) -> int:
    """Integer operations H1's arithmetic needs for one frame (I_16x16 DC
    and HORIZONTAL, chroma DC, one reconstruction): a 2-D 4x4 transform is 8
    one-dimensional ones of 10 operations; a quantization 6, a cost term 3,
    a dequantization 2, a reconstructed pixel 3; every candidate is
    evaluated whatever the data."""
    block = 80
    luma = 2 * (16 * block + 256 * 6 + 256 * 3 + 16 * 6)
    chroma = 8 * block + 128 * 6 + 128 * 3 + 8 * 6
    recon = 24 * block + 384 * 2 + 384 * 3
    return mb_h * mb_w * (luma + chroma + recon)


def p_ops(mb_h: int, mb_w: int) -> int:
    """Integer operations H2's arithmetic needs for one P frame, counted as
    :func:`intra_ops` counts H1's, with the inter candidate and the
    decision."""
    block = 80
    intra = 2 * (256 + 16 * block + 256 * 6 + 256 * 3 + 16 * 6)
    inter = 256 + 16 * block + 256 * 6 + 256 * 3
    chroma = 2 * (128 + 8 * block + 128 * 6 + 128 * 3 + 8 * 6)
    recon = 24 * block + 384 * 2 + 384 * 3
    return mb_h * mb_w * (intra + inter + chroma + 16 + recon)


def planes_ops(oh: int, ow: int, nplanes: int) -> int:
    """H3's operations for ``nplanes`` planes of (oh, ow): two 6-taps and
    their rounding per position, j's 6-tap, 3 for each quarter average."""
    if nplanes == 1:
        return 0
    return oh * ow * (15 * 2 + 15 + (12 * 3 if nplanes == 16 else 0))


def deblock_ops(mb_h: int, mb_w: int) -> int:
    """H5's operations: every line across every edge tested and filtered,
    about 30 each, and 32 bS of about 10 each, a MB."""
    return mb_h * mb_w * ((16 * 8 + 8 * 4 * 2) * 30 + 32 * 10)


def search_plan(search: int, subpel: int) -> tuple[int, int]:
    """(planes, margin) of the reference stack a search reads: one padded
    plane at full-pel, the four half-sample planes at half-pel, all 16 at
    quarter-pel and fastsub (subpel 3), with a margin of ``search + 1``."""
    if not subpel:
        return 1, search
    return (4 if subpel == 1 else 16), search + 1


def search_candidates(search: int, subpel: int) -> int:
    """Candidates a MB's search evaluates: the full-pel grid, the half-pel
    or the quarter-pel lattice; fastsub the full-pel grid and its 49
    refinement offsets."""
    if subpel in (0, 3):
        return (2 * search + 1) ** 2 + (FASTSUB_REFINE if subpel == 3 else 0)
    r = (2 if subpel == 1 else 4) * search
    return (2 * r + 1) ** 2


def _deblock_bound(h: int, w: int, mb_h: int, mb_w: int) -> float:
    # the picture read and written; the metadata (intra, the 4x4 nonzero
    # grid, the mv and ref fields) read
    meta = mb_h * mb_w * (1 + 16 + 4 + 2)
    return bound(2 * (3 * h * w // 2) + meta, deblock_ops(mb_h, mb_w))


def idr_frame_bound(h: int, w: int, deblock: bool) -> float:
    """Seconds H1 (with the full reconstruction) and H5 need at least for
    one 16-aligned (h, w) IDR frame."""
    mb_h, mb_w = h // 16, w // 16
    frame = 3 * h * w // 2
    h1 = bound(frame + 2 * IDR_WORDS_MB * mb_h * mb_w + frame,
               intra_ops(mb_h, mb_w))
    return h1 + (_deblock_bound(h, w, mb_h, mb_w) if deblock else 0.0)


def p_frame_bound(h: int, w: int, search: int, subpel: int,
                  deblock: bool) -> float:
    """Seconds H3, H4, H2 and H5 need at least for one 16-aligned (h, w) P
    frame with one reference: H3 reads the reference luma and writes its
    stack of planes; H4 reads the source luma, the stack and the reference
    chroma and writes the vectors and the three predicted planes, 3
    operations a pixel a candidate; H2 reads the source and the prediction
    and writes its level buffer and the reconstruction; H5 as on an IDR."""
    mb_h, mb_w = h // 16, w // 16
    frame = 3 * h * w // 2
    nplanes, margin = search_plan(search, subpel)
    stack = nplanes * (h + 2 * margin) * (w + 2 * margin)
    h3 = bound(h * w + stack, planes_ops(h + 2 * margin, w + 2 * margin,
                                         nplanes)) if search else 0.0
    h4 = bound(h * w + stack + h * w // 2 + 4 * mb_h * mb_w + frame,
               3 * search_candidates(search, subpel) * h * w) if search else 0.0
    h2 = bound(frame + frame + 2 * P_WORDS_MB * mb_h * mb_w + frame,
               p_ops(mb_h, mb_w))
    return h3 + h4 + h2 + (_deblock_bound(h, w, mb_h, mb_w) if deblock else 0.0)
