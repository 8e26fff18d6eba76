"""Bit-exact numpy golden models of the OpenCV operators used by the reference.

The port's own copy of ``opencv_opencl_tpu/core/golden.py`` (the port
imports nothing of the JAX package): on a machine with the card it is the
oracle of ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

These are the parity oracles for the whole framework: every kernel
is tested against these models, and these models are themselves tested
bit-exactly against OpenCV (``tests/test_golden_*.py``), reproducing the
reference's accuracy harness (``1frameMeasure.cpp:90-100``: absdiff with a
+/-1 LSB threshold and 0% exceedance — our golden models hit *0* LSB).

Everything here is pure numpy (no cv2 import) so the oracles are available
even where OpenCV is not installed; the cross-check against cv2 lives in the
tests.

OpenCV semantics reproduced
---------------------------
- ``equalize_hist``: OpenCV ``cv::equalizeHist`` — 256-bin histogram, first
  non-zero bin maps to 0, scale ``255/(total - hist[first])``, LUT entries
  ``saturate_cast<uchar>(cvRound(cumsum * scale))`` with round-half-to-even,
  constant image returns a copy.  (Reference use: ``OpenCVequalHist.cpp:145``,
  FPGA equivalent ``accel.cpp:36-61``.)
- ``clahe``: OpenCV ``cv::CLAHE::apply`` — pad to a tile-divisible size with
  BORDER_REFLECT_101, per-tile 256-bin histograms, integer clip limit
  ``max(int(clipLimit*tileArea/256), 1)``, single-pass clip with
  floor-redistribution plus stepped residual distribution, per-tile CDF LUTs
  scaled by float32 ``255/tileArea``, and bilinear interpolation of the four
  neighbouring tile LUTs using float32 reciprocal-multiply coordinates.
  (Reference use: ``CLAHECompare.cpp:143-150``, ``clahe1frame.cpp:88-95``.)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hist256",
    "equalize_lut",
    "equalize_hist",
    "clahe_luts",
    "clahe_apply_luts",
    "clahe",
    "copy_make_border_reflect101",
]


def hist256(y: np.ndarray) -> np.ndarray:
    """256-bin histogram of a uint8 array. Returns int64[256]."""
    if y.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {y.dtype}")
    return np.bincount(y.ravel(), minlength=256).astype(np.int64)


def equalize_lut(hist: np.ndarray, total: int | None = None) -> np.ndarray:
    """OpenCV-exact equalizeHist LUT from a 256-bin histogram.

    Matches cv::equalizeHist's LUT construction: the first non-zero bin maps
    to 0 and is excluded from the normalisation mass; subsequent entries are
    ``round_half_even(cumsum * 255/(total - hist[first]))``.  A histogram
    whose mass sits entirely in one bin yields the identity LUT (OpenCV
    returns an unmodified copy in that case).
    """
    hist = np.asarray(hist, dtype=np.int64)
    if hist.shape != (256,):
        raise ValueError(f"expected shape (256,), got {hist.shape}")
    if total is None:
        total = int(hist.sum())
    nz = np.nonzero(hist)[0]
    if len(nz) == 0:
        return np.arange(256, dtype=np.uint8)
    first = int(nz[0])
    if hist[first] == total:
        # constant image: OpenCV copies the source through unchanged
        return np.arange(256, dtype=np.uint8)
    # OpenCV: float scale = 255.f/(total - hist[i]) — float32, and the
    # product sum*scale is a float32 multiply; f64 here flips ~1%% of
    # histograms by 1 LSB on exact rounding ties
    scale = np.float32(255.0) / np.float32(total - hist[first])
    cum = np.cumsum(hist)
    # cumsum *excluding* the first non-zero bin's mass
    cum_excl = cum - cum[first]
    prod = (cum_excl.astype(np.float32) * scale).astype(np.float32)
    lut = np.clip(np.rint(prod), 0, 255).astype(np.uint8)
    lut[: first + 1] = 0
    lut[first] = 0
    return lut


def equalize_hist(y: np.ndarray, ref: np.ndarray | None = None) -> np.ndarray:
    """OpenCV-exact global histogram equalization of a uint8 image.

    ``ref`` optionally supplies the image from which the histogram/CDF is
    computed while ``y`` is the image being mapped — the two-input signature
    of the reference FPGA kernel (``accel.cpp:36-40``), whose host passes the
    same frame twice (``OpenCLequalHist.cpp:356-357``) but which permits
    previous-frame CDFs for latency hiding.
    """
    if ref is None:
        ref = y
    lut = equalize_lut(hist256(ref), total=ref.size)
    return lut[y]


def reflect101_indices(n_out: int, n: int) -> np.ndarray:
    """Source indices for BORDER_REFLECT_101 extension to length n_out.

    Reflect-101 mirrors *without* repeating the edge pixel (..., n-2, n-1,
    n-2, ...), and wraps periodically when the pad exceeds the source size
    (period 2n-2) — matching cv::borderInterpolate multi-reflection.
    """
    if n == 1:
        return np.zeros(n_out, dtype=np.int64)
    period = 2 * (n - 1)
    j = np.arange(n_out, dtype=np.int64) % period
    return np.where(j < n, j, period - j)


def copy_make_border_reflect101(
    src: np.ndarray, bottom: int, right: int
) -> np.ndarray:
    """cv::copyMakeBorder(..., BORDER_REFLECT_101) for bottom/right only."""
    if bottom == 0 and right == 0:
        return src
    h, w = src.shape
    rows = reflect101_indices(h + bottom, h)
    cols = reflect101_indices(w + right, w)
    return src[rows][:, cols]


def _clip_histogram(hist: np.ndarray, clip: int) -> np.ndarray:
    """OpenCV CLAHE single-pass clip + redistribution.

    Excess above ``clip`` is removed, redistributed as ``excess // 256`` to
    every bin, and the residual handed out one count at a time with stride
    ``max(256 // residual, 1)`` starting at bin 0.  Bins may exceed the clip
    limit after redistribution; OpenCV does not re-clip.
    """
    clipped = int(np.maximum(hist - clip, 0).sum())
    if clipped == 0:
        return hist
    hist = np.minimum(hist, clip)
    redist = clipped // 256
    residual = clipped - redist * 256
    hist = hist + redist
    if residual > 0:
        step = max(256 // residual, 1)
        idx = np.arange(residual) * step
        hist[idx] += 1
    return hist


def clahe_luts(
    y: np.ndarray,
    clip_limit: float = 40.0,
    tile_grid: tuple[int, int] = (8, 8),
) -> tuple[np.ndarray, int, int]:
    """Per-tile CLAHE LUTs, OpenCV-exact.

    Returns ``(luts, tile_h, tile_w)`` with ``luts`` of shape
    ``(tiles_y, tiles_x, 256)`` uint8.  ``tile_grid`` is (tilesX, tilesY) in
    OpenCV argument order (cv::Size(width, height)).
    """
    tiles_x, tiles_y = tile_grid
    rows, cols = y.shape
    if rows % tiles_y == 0 and cols % tiles_x == 0:
        pb = pr = 0
    else:
        # OpenCV pads with NO modulo wrap once either dim is non-divisible:
        # a divisible dim still gets a full extra tile (tiles - 0), which
        # changes the tile size globally — found by randomized fuzzing
        pb = tiles_y - rows % tiles_y
        pr = tiles_x - cols % tiles_x
    ext = copy_make_border_reflect101(y, pb, pr)
    tile_h = ext.shape[0] // tiles_y
    tile_w = ext.shape[1] // tiles_x
    tile_area = tile_h * tile_w
    # float32 scale, exactly as OpenCV's lutScale_
    lut_scale = np.float32(255.0) / np.float32(tile_area)
    clip = max(int(clip_limit * tile_area / 256.0), 1) if clip_limit > 0 else 0

    luts = np.empty((tiles_y, tiles_x, 256), dtype=np.uint8)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            tile = ext[ty * tile_h : (ty + 1) * tile_h, tx * tile_w : (tx + 1) * tile_w]
            hist = hist256(tile)
            if clip > 0:
                hist = _clip_histogram(hist, clip)
            cdf = np.cumsum(hist).astype(np.float32)
            luts[ty, tx] = np.clip(np.rint(cdf * lut_scale), 0, 255).astype(np.uint8)
    return luts, tile_h, tile_w


def _interp_coords(
    n: int, tile: int, tiles: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pixel (lo_index, hi_index, frac) along one axis, float32-exact.

    OpenCV computes ``p * (1.0f/tile) - 0.5f`` in float32 (reciprocal
    multiply, not division) — reproducing that exactly is what makes the
    interpolation bit-exact.
    """
    inv = np.float32(1.0) / np.float32(tile)
    f = (np.arange(n, dtype=np.float32) * inv - np.float32(0.5)).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    frac = (f - lo).astype(np.float32)
    lo_c = np.clip(lo, 0, tiles - 1)
    hi_c = np.clip(lo + 1, 0, tiles - 1)
    return lo_c, hi_c, frac


def clahe_apply_luts(
    y: np.ndarray,
    luts: np.ndarray,
    tile_h: int,
    tile_w: int,
) -> np.ndarray:
    """Bilinear interpolation of the four neighbouring tile LUTs, OpenCV-exact."""
    tiles_y, tiles_x, _ = luts.shape
    rows, cols = y.shape
    ty1, ty2, ya = _interp_coords(rows, tile_h, tiles_y)
    tx1, tx2, xa = _interp_coords(cols, tile_w, tiles_x)
    l11 = luts[ty1[:, None], tx1[None, :], y].astype(np.float32)
    l12 = luts[ty1[:, None], tx2[None, :], y].astype(np.float32)
    l21 = luts[ty2[:, None], tx1[None, :], y].astype(np.float32)
    l22 = luts[ty2[:, None], tx2[None, :], y].astype(np.float32)
    xa = xa[None, :]
    xa1 = np.float32(1.0) - xa
    ya_ = ya[:, None]
    ya1 = np.float32(1.0) - ya_
    r1 = (l11 * xa1 + l12 * xa).astype(np.float32)
    r2 = (l21 * xa1 + l22 * xa).astype(np.float32)
    res = (r1 * ya1 + r2 * ya_).astype(np.float32)
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def clahe(
    y: np.ndarray,
    clip_limit: float = 40.0,
    tile_grid: tuple[int, int] = (8, 8),
) -> np.ndarray:
    """OpenCV-exact CLAHE (cv::createCLAHE(clipLimit, tileGridSize).apply).

    Default parameters match OpenCV's (clipLimit=40, 8x8 tiles); the
    reference video path uses (2.0, 8x8) (``CLAHECompare.cpp:296-297``) and
    the single-frame tool (3.0, 4x4) (``clahe1frame.cpp:55-56``).
    """
    if y.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {y.dtype}")
    if y.ndim != 2:
        raise ValueError(f"expected 2-D Y plane, got shape {y.shape}")
    luts, th, tw = clahe_luts(y, clip_limit, tile_grid)
    return clahe_apply_luts(y, luts, th, tw)
