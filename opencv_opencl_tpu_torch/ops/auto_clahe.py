"""Image-adaptive CLAHE: a clip limit chosen per frame from its entropy.

Counterpart of ``opencv_opencl_tpu/ops/auto_clahe.py``:

    clip(y) = clip_min + (clip_max - clip_min) * H(y) / 8

where H(y) is the Shannon entropy (bits) of the frame's 256-bin luma
histogram.  The CLAHE then runs with that clip, which never leaves the
device: the step makes no host sync.  On a CUDA tensor the step is the
whole-frame histogram (K1 on a 1x1 grid, ``ops/histogram.hist256``), the
entropy in plain torch on (N, 256) f32, the tile histograms (K1), the LUT
build with one clip per frame read on the device (K2) and the cell-grid
interpolation (K6) where the geometry has a cell-grid spec, else K3 (the
JAX package falls back to its XLA gather there; K3 has the same contract).
On a CPU tensor every wrapper takes its plain version.

The entropy is a float sum of 256 ``p * log2 p`` terms, whose order and
``log2`` are not bit-specified across XLA, torch on the CPU and CUDA, so
the f32 clip may differ from the JAX package's in the last bits; the
integer clip that the LUTs use, and hence the output, is what the tests
hold equal.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
from opencv_opencl_tpu_torch.ops import histogram
from opencv_opencl_tpu_torch.ops.cuda import lut, natural

__all__ = ["clip_from_hists", "estimate_clip_limit", "int_clips",
           "luts_with_clip", "clahe_auto"]


def clip_from_hists(hists: torch.Tensor, size: int, clip_min: float = 1.0,
                    clip_max: float = 4.0) -> torch.Tensor:
    """(N, 256) whole-frame histograms of frames of ``size`` pixels -> (N,)
    f32 clip limits in [clip_min, clip_max], in the JAX estimator's order
    of operations."""
    hist = hists.to(torch.float32)
    # a true f32 division by a device tensor: over a host scalar the card
    # would multiply by its reciprocal, and a host tensor would be a copy
    p = hist / torch.full((), size, dtype=torch.float32, device=hist.device)
    h = -torch.where(p > 0, p * torch.log2(p.clamp_min(1e-12)), 0.0).sum(dim=-1)
    t = (h / 8.0).clamp(0.0, 1.0)
    lo = np.float32(clip_min)
    return float(lo) + float(np.float32(clip_max) - lo) * t


def estimate_clip_limit(y: torch.Tensor, clip_min: float = 1.0,
                        clip_max: float = 4.0) -> torch.Tensor:
    """Entropy-scaled clip limit in [clip_min, clip_max]: an f32 scalar for
    one frame (H, W), or (N,) for a batch (N, H, W), one per frame (the JAX
    package's ``clahe_auto`` maps its estimator over the frames in the same
    way)."""
    frames = y if y.ndim == 3 else y.unsqueeze(0)
    clip = clip_from_hists(histogram.hist256(frames),
                           frames.shape[1] * frames.shape[2], clip_min, clip_max)
    return clip if y.ndim == 3 else clip[0]


def int_clips(clip_limit: torch.Tensor, tile_area: int) -> torch.Tensor:
    """OpenCV's integer clip from f32 clip limits, reckoned in f32 as the
    JAX package does: ``max(int32(clip * tile_area / 256), 1)``."""
    return (clip_limit * tile_area / 256.0).to(torch.int32).clamp_min(1)


def luts_with_clip(hists: torch.Tensor, plan: clahe_ops.ClahePlan,
                   clip_limit: torch.Tensor) -> torch.Tensor:
    """Per-tile LUTs of (N, T, 256) int32 histograms with one f32 clip
    limit per frame (N,), on the device (``_luts_with_traced_clip``): K2
    with the integer clips as a device tensor.  Always clips."""
    return natural.build_luts(hists, int_clips(clip_limit, plan.tile_area),
                              plan.lut_scale)


def clahe_auto(y, tile_grid: tuple[int, int] = (8, 8), clip_min: float = 1.0,
               clip_max: float = 4.0, method: str = "onehot",
               device: str | torch.device = "cuda"):
    """CLAHE with a per-frame adaptive clip limit of a uint8 frame (H, W)
    or batch (N, H, W), moved to ``device`` first.

    Returns ``(enhanced, clip_used)``: ``clip_used`` is the f32 clip limit,
    a scalar for one frame and (N,) for a batch.  ``method`` as in
    ``ops/clahe.clahe_apply``."""
    clahe_ops._check_method(method)
    y = torch.as_tensor(y).to(device)
    if y.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (N, H, W), got {tuple(y.shape)}")
    frames = y if y.ndim == 3 else y.unsqueeze(0)
    h, w = frames.shape[1], frames.shape[2]
    tile_grid = tuple(tile_grid)
    plan = clahe_ops.make_clahe_plan(h, w, 40.0, tile_grid)
    clip = estimate_clip_limit(frames, clip_min, clip_max)
    luts = luts_with_clip(natural.tile_histograms(frames, plan), plan, clip)
    spec = lut.make_interp_spec(h, w, 40.0, tile_grid)
    if spec is not None:
        out = lut.clahe_interpolate_cells(frames, luts, spec)
    else:
        out = natural.clahe_interpolate(frames, luts, plan)
    return (out, clip) if y.ndim == 3 else (out[0], clip[0])
