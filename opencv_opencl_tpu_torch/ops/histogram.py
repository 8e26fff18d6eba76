"""256-bin histograms and OpenCV-exact equalization LUTs on tensors.

Counterpart of ``opencv_opencl_tpu/ops/histogram.py``.  ``hist256`` is the
tile-histogram kernel (K1, ``ops/cuda/natural.tile_histograms``) run on a
1x1 tile grid that covers the whole frame: no padding, strided rows
accepted, so ``y[:, ::ds]`` goes in without a copy.  On a CPU tensor the
same wrapper takes its plain ``bincount`` version.  ``equalize_lut`` is
plain PyTorch, as the JAX package computes it in plain jnp outside any
kernel.
"""

from __future__ import annotations

import torch

from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
from opencv_opencl_tpu_torch.ops.cuda import natural

__all__ = ["hist256", "equalize_lut"]


def hist256(y: torch.Tensor, method: str = "onehot") -> torch.Tensor:
    """uint8 frames (N, H, W), or one frame (H, W) -> int32 (N, 256), or
    (256,), histograms of each whole frame.  ``method`` is the JAX
    package's ("onehot" or "scatter"; one kernel here); any other raises
    ``ValueError``."""
    clahe_ops._check_method(method)
    if y.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (N, H, W), got {tuple(y.shape)}")
    frames = y if y.ndim == 3 else y.unsqueeze(0)
    plan = clahe_ops.make_clahe_plan(frames.shape[1], frames.shape[2], 0.0,
                                     (1, 1))
    hists = natural.tile_histograms(frames, plan)[:, 0]
    return hists if y.ndim == 3 else hists[0]


def equalize_lut(hist: torch.Tensor, total: int) -> torch.Tensor:
    """cv::equalizeHist LUTs from int histograms (..., 256) -> uint8
    (..., 256), OpenCV-exact: the first non-zero bin maps to 0, the rest to
    ``rint(f32(cum - cum[first]) * f32(255) / f32(max(total - hist[first],
    1)))`` (int32 cumsum; round half to even), and a histogram whose mass
    is all in one bin (a constant frame) to the identity."""
    hist = hist.to(torch.int32)
    # the first non-zero bin: argmax of an int mask (argmax of a bool
    # tensor is not supported on every build) returns the first maximum
    first = torch.argmax((hist > 0).to(torch.int32), dim=-1, keepdim=True)
    hfirst = hist.gather(-1, first)
    cum = torch.cumsum(hist, dim=-1, dtype=torch.int32)
    cum_excl = (cum - cum.gather(-1, first)).to(torch.float32)
    denom = (total - hfirst).clamp_min(1).to(torch.float32)
    # a true f32 division (a Python scalar over a tensor would multiply by
    # the reciprocal), and no host-to-device copy, which would wait for
    # the stream
    scale = torch.full_like(denom, 255.0) / denom
    lut = torch.round(cum_excl * scale).clamp(0, 255).to(torch.uint8)
    identity = torch.arange(256, dtype=torch.uint8, device=hist.device)
    return torch.where(hfirst == total, identity, lut)
