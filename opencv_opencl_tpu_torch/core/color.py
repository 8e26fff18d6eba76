"""OpenCV-exact color conversions (numpy golden implementations).

The port's own copy of ``opencv_opencl_tpu/core/color.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_color.py`` holds
it to the original.

The reference converts with ``cv::cvtColor`` in its single-frame tools
(``singlecolor.cpp:37-66``: BGR2YUV / YUV2BGR; ``1frameMeasure.cpp``:
BGR2YUV_I420) and receives/emits NV12 from GStreamer in the relays.  OpenCV
uses two distinct fixed-point coefficient sets:

- ``COLOR_BGR2YUV`` / ``COLOR_YUV2BGR`` (full-range, 14-bit fixed point,
  CV_DESCALE rounding);
- the planar/semi-planar family (``*_I420`` / ``*_NV12``), which is ITU-R
  BT.601 *studio swing* (Y in [16,235]) with 20-bit fixed point.

All functions here are bit-exact against cv2 (see
``tests/test_golden_color.py``, on the original) and are the oracles for
the tensor versions in ``opencv_opencl_tpu_torch.ops.color``.

Images follow OpenCV conventions: uint8, HxWx3 channel order BGR (or YUV),
NV12 as an (H*3/2, W) buffer (Y plane then interleaved UV), I420 as an
(H*3/2, W) buffer (Y, then U, then V quarter planes).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bgr2yuv",
    "yuv2bgr",
    "bgr2yuv_i420",
    "bgr2nv12",
    "nv12_to_bgr",
    "i420_to_nv12",
    "nv12_to_i420",
]

# --- full-range YUV (COLOR_BGR2YUV / COLOR_YUV2BGR), 14-bit fixed point ----
_SHIFT14 = 14
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868  # 0.299, 0.587, 0.114
_B2U = 8061   # 0.492
_R2V = 14369  # 0.877
_U2B, _U2G = 33292, -6472
_V2G, _V2R = -9519, 18678

# --- ITU-R BT.601 studio swing (I420/NV12 family), 20-bit fixed point ------
_SHIFT20 = 20
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CRV, _CGV, _CBV = 460324, -385875, -74448
_CY = 1220542
_CVR, _CVG, _CUG, _CUB = 1673527, -852492, -409993, 2116026


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    """OpenCV CV_DESCALE: add half, arithmetic shift right."""
    return (x + (1 << (n - 1))) >> n


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


def bgr2yuv(img: np.ndarray) -> np.ndarray:
    """cv::cvtColor(img, COLOR_BGR2YUV), bit-exact."""
    b = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    r = img[..., 2].astype(np.int64)
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y, _SHIFT14)
    delta = 128 << _SHIFT14
    u = _descale((b - y) * _B2U + delta, _SHIFT14)
    v = _descale((r - y) * _R2V + delta, _SHIFT14)
    return np.stack([_u8(y), _u8(u), _u8(v)], axis=-1)


def yuv2bgr(img: np.ndarray) -> np.ndarray:
    """cv::cvtColor(img, COLOR_YUV2BGR), bit-exact."""
    y = img[..., 0].astype(np.int64)
    u = img[..., 1].astype(np.int64) - 128
    v = img[..., 2].astype(np.int64) - 128
    y14 = y << _SHIFT14
    b = _descale(y14 + u * _U2B, _SHIFT14)
    g = _descale(y14 + u * _U2G + v * _V2G, _SHIFT14)
    r = _descale(y14 + v * _V2R, _SHIFT14)
    return np.stack([_u8(b), _u8(g), _u8(r)], axis=-1)


def _bgr_to_y_studio(img: np.ndarray) -> np.ndarray:
    b = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    r = img[..., 2].astype(np.int64)
    half = 1 << (_SHIFT20 - 1)
    return _u8((r * _CRY + g * _CGY + b * _CBY + half + (16 << _SHIFT20)) >> _SHIFT20)


def _bgr_to_uv_studio(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """U/V at quarter resolution, sampled at the even-row/even-col pixel
    of each 2x2 block (OpenCV's I420/NV12 downsampling)."""
    b = img[0::2, 0::2, 0].astype(np.int64)
    g = img[0::2, 0::2, 1].astype(np.int64)
    r = img[0::2, 0::2, 2].astype(np.int64)
    half = (1 << (_SHIFT20 - 1)) + (128 << _SHIFT20)
    u = _u8((r * _CRU + g * _CGU + b * _CBU + half) >> _SHIFT20)
    v = _u8((r * _CRV + g * _CGV + b * _CBV + half) >> _SHIFT20)
    return u, v


def bgr2yuv_i420(img: np.ndarray) -> np.ndarray:
    """cv::cvtColor(img, COLOR_BGR2YUV_I420), bit-exact.

    Returns the (H*3/2, W) planar buffer: Y plane, then the U and V quarter
    planes packed row-major into the bottom H/2 rows.
    """
    h, w, _ = img.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 requires even dimensions, got {h}x{w}")
    y = _bgr_to_y_studio(img)
    u, v = _bgr_to_uv_studio(img)
    out = np.empty((h * 3 // 2, w), dtype=np.uint8)
    out[:h] = y
    out[h:].reshape(-1)[: h * w // 4] = u.reshape(-1)
    out[h:].reshape(-1)[h * w // 4 :] = v.reshape(-1)
    return out


def bgr2nv12(img: np.ndarray) -> np.ndarray:
    """BGR -> NV12 (Y plane + interleaved UV), BT.601 studio swing.

    OpenCV has no COLOR_BGR2YUV_NV12 in older releases; this matches
    I420 conversion then I420->NV12 repacking.
    """
    h, w, _ = img.shape
    if h % 2 or w % 2:
        raise ValueError(f"NV12 requires even dimensions, got {h}x{w}")
    y = _bgr_to_y_studio(img)
    u, v = _bgr_to_uv_studio(img)
    out = np.empty((h * 3 // 2, w), dtype=np.uint8)
    out[:h] = y
    uv = out[h:]
    uv[:, 0::2] = u
    uv[:, 1::2] = v
    return out


def nv12_to_bgr(nv12: np.ndarray, height: int | None = None) -> np.ndarray:
    """cv::cvtColor(nv12, COLOR_YUV2BGR_NV12), bit-exact."""
    total, w = nv12.shape
    h = height if height is not None else total * 2 // 3
    y = nv12[:h].astype(np.int64)
    uv = nv12[h:]
    u = uv[:, 0::2].astype(np.int64)
    v = uv[:, 1::2].astype(np.int64)
    u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)[:h, :w]
    v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)[:h, :w]
    half = 1 << (_SHIFT20 - 1)
    yy = np.maximum(y - 16, 0) * _CY
    r = (yy + (v - 128) * _CVR + half) >> _SHIFT20
    g = (yy + (v - 128) * _CVG + (u - 128) * _CUG + half) >> _SHIFT20
    b = (yy + (u - 128) * _CUB + half) >> _SHIFT20
    return np.stack([_u8(b), _u8(g), _u8(r)], axis=-1)


def i420_to_nv12(i420: np.ndarray, height: int | None = None) -> np.ndarray:
    """Repack planar I420 into semi-planar NV12 (no color math)."""
    total, w = i420.shape
    h = height if height is not None else total * 2 // 3
    out = np.empty_like(i420)
    out[:h] = i420[:h]
    q = h * w // 4
    flat = i420[h:].reshape(-1)
    u = flat[:q].reshape(h // 2, w // 2)
    v = flat[q:].reshape(h // 2, w // 2)
    uv = out[h:]
    uv[:, 0::2] = u
    uv[:, 1::2] = v
    return out


def nv12_to_i420(nv12: np.ndarray, height: int | None = None) -> np.ndarray:
    """Repack semi-planar NV12 into planar I420 (no color math)."""
    total, w = nv12.shape
    h = height if height is not None else total * 2 // 3
    out = np.empty_like(nv12)
    out[:h] = nv12[:h]
    uv = nv12[h:]
    q = h * w // 4
    flat = out[h:].reshape(-1)
    flat[:q] = uv[:, 0::2].reshape(-1)
    flat[q:] = uv[:, 1::2].reshape(-1)
    return out
