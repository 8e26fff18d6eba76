"""OpenCV-exact color conversions on tensors, single frame or batched.

Counterpart of ``opencv_opencl_tpu/ops/color.py`` over the port's copy of
the numpy oracles, ``core/color.py``.  The JAX module has no kernel, so
this one is plain PyTorch.  All arithmetic is int32 fixed point, then a
clamp, then the cast to uint8 (uint8 arithmetic in torch wraps); ``>>`` on
int32 tensors is an arithmetic shift, as on ``jnp.int32``.  int32 is
enough throughout: the largest intermediate (the BT.601 Y dot product and
its rounding bias) stays below 2^29.

Shapes: channel-last images (..., H, W, 3); NV12 buffers (..., H*3/2, W).
Every function moves its input to ``device`` first (the card unless the
caller names another) and returns a tensor there.
"""

from __future__ import annotations

import torch

from opencv_opencl_tpu_torch.core import color as _c

__all__ = [
    "bgr2yuv",
    "yuv2bgr",
    "bgr2nv12",
    "nv12_to_bgr",
    "nv12_gray_chroma",
    "nv12_set_y",
]


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


def _planes(img: torch.Tensor) -> tuple[torch.Tensor, ...]:
    i = img.to(torch.int32)
    return i[..., 0], i[..., 1], i[..., 2]


def bgr2yuv(img, device: str | torch.device = "cuda") -> torch.Tensor:
    """cv::cvtColor COLOR_BGR2YUV (full range, 14-bit fixed point)."""
    b, g, r = _planes(_tensor(img, device))
    y = _descale(r * _c._R2Y + g * _c._G2Y + b * _c._B2Y, _c._SHIFT14)
    delta = 128 << _c._SHIFT14
    u = _descale((b - y) * _c._B2U + delta, _c._SHIFT14)
    v = _descale((r - y) * _c._R2V + delta, _c._SHIFT14)
    return torch.stack([_u8(y), _u8(u), _u8(v)], dim=-1)


def yuv2bgr(img, device: str | torch.device = "cuda") -> torch.Tensor:
    """cv::cvtColor COLOR_YUV2BGR (full range, 14-bit fixed point)."""
    y, u, v = _planes(_tensor(img, device))
    u, v = u - 128, v - 128
    y14 = y << _c._SHIFT14
    b = _descale(y14 + u * _c._U2B, _c._SHIFT14)
    g = _descale(y14 + u * _c._U2G + v * _c._V2G, _c._SHIFT14)
    r = _descale(y14 + v * _c._V2R, _c._SHIFT14)
    return torch.stack([_u8(b), _u8(g), _u8(r)], dim=-1)


def bgr2nv12(img, device: str | torch.device = "cuda") -> torch.Tensor:
    """BGR -> NV12, BT.601 studio swing (bit-exact vs the I420 family)."""
    b, g, r = _planes(_tensor(img, device))
    half = 1 << (_c._SHIFT20 - 1)
    y = _u8((r * _c._CRY + g * _c._CGY + b * _c._CBY + half + (16 << _c._SHIFT20))
            >> _c._SHIFT20)
    b2, g2, r2 = b[..., 0::2, 0::2], g[..., 0::2, 0::2], r[..., 0::2, 0::2]
    chalf = half + (128 << _c._SHIFT20)
    u = _u8((r2 * _c._CRU + g2 * _c._CGU + b2 * _c._CBU + chalf) >> _c._SHIFT20)
    v = _u8((r2 * _c._CRV + g2 * _c._CGV + b2 * _c._CBV + chalf) >> _c._SHIFT20)
    # interleave U/V into the chroma rows: (..., H/2, W/2, 2) -> (..., H/2, W)
    uv = torch.stack([u, v], dim=-1).reshape(*u.shape[:-1], u.shape[-1] * 2)
    return torch.cat([y, uv], dim=-2)


def _split(nv12: torch.Tensor, height: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    h = height if height is not None else nv12.shape[-2] * 2 // 3
    return nv12[..., :h, :], nv12[..., h:, :]


def nv12_to_bgr(nv12, height: int | None = None,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """cv::cvtColor COLOR_YUV2BGR_NV12 (BT.601 studio swing)."""
    y, uv = _split(_tensor(nv12, device), height)
    y, uv = y.to(torch.int32), uv.to(torch.int32)
    # 2x2 upsample (nearest)
    u = uv[..., 0::2].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v = uv[..., 1::2].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    half = 1 << (_c._SHIFT20 - 1)
    yy = (y - 16).clamp_min(0) * _c._CY
    r = (yy + (v - 128) * _c._CVR + half) >> _c._SHIFT20
    g = (yy + (v - 128) * _c._CVG + (u - 128) * _c._CUG + half) >> _c._SHIFT20
    b = (yy + (u - 128) * _c._CUB + half) >> _c._SHIFT20
    return torch.stack([_u8(b), _u8(g), _u8(r)], dim=-1)


def nv12_gray_chroma(nv12, height: int | None = None,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """UV := 128, the reference's gray chroma policy
    (``OpenCVequalHist.cpp:162`` memset)."""
    y, uv = _split(_tensor(nv12, device), height)
    return torch.cat([y, torch.full_like(uv, 128)], dim=-2)


def nv12_set_y(nv12, y, device: str | torch.device = "cuda") -> torch.Tensor:
    """Replace the Y plane of an NV12 buffer (chroma passthrough,
    ``improvement.cpp:162-163``)."""
    nv12, y = _tensor(nv12, device), _tensor(y, device)
    return torch.cat([y, nv12[..., y.shape[-2]:, :]], dim=-2)
