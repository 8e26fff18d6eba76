"""Global histogram equalization on tensors (one frame and batched).

Counterpart of ``opencv_opencl_tpu/ops/histeq.py``: ``cv::equalizeHist``,
and the two-input form of the reference's FPGA kernel (``accel.cpp:36-40``)
whose histogram may come from another frame.  On a CUDA tensor the
histogram is K1 (``ops/histogram.hist256``) and the map is K4
(``ops/cuda/lut.apply_lut``); on a CPU tensor both take their plain
versions.  Every entry point has the JAX package's signature, with
``device`` last and by keyword: it moves its input to ``device`` first and
returns a tensor there.  ``method`` is the JAX package's histogram method
("onehot" or "scatter", one kernel here); any other raises ``ValueError``.
"""

from __future__ import annotations

import torch

from opencv_opencl_tpu_torch.ops import histogram
from opencv_opencl_tpu_torch.ops.cuda import lut as lut_ops

__all__ = [
    "apply_lut",
    "equalize_frames",
    "equalize_hist",
    "equalize_hist_ref",
    "equalize_hist_batch",
]


def equalize_frames(y: torch.Tensor, hists: torch.Tensor, total: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Map uint8 frames (N, H, W) through the equalization LUTs of
    ``hists`` (N, 256), whose frames held ``total`` pixels each; ``out``
    may be ``y``."""
    return lut_ops.apply_lut(y, histogram.equalize_lut(hists, total), out=out)


def _frames(y, device) -> torch.Tensor:
    return torch.as_tensor(y).to(device)


def apply_lut(y, lut, backend: str = "auto", *,
              device: str | torch.device = "cuda") -> torch.Tensor:
    """Map a uint8 image (H, W) through a 256-entry uint8 LUT, or a batch
    (N, H, W) through one LUT per frame (N, 256).

    backend, as the JAX package maps it: "auto" and "pallas" run K4 (its
    plain version on a CPU tensor); any other backend ("xla") runs the
    plain version, wherever the frames are."""
    y, lut = _frames(y, device), _frames(lut, device)
    frames = y if y.ndim == 3 else y[None]
    luts = lut.reshape(frames.shape[0], 256)
    if backend in ("auto", "pallas"):
        out = lut_ops.apply_lut(frames, luts)
    else:
        out = lut_ops.apply_lut_ref(frames, luts)
    return out if y.ndim == 3 else out[0]


def equalize_hist(y, method: str = "onehot", *,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """OpenCV-exact global equalization of one uint8 Y plane (H, W)."""
    return equalize_hist_ref(y, y, method, device=device)


def equalize_hist_ref(y, ref, method: str = "onehot", *,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Two-input form: histogram from ``ref``, mapping applied to ``y``
    (both (H, W) uint8)."""
    y, ref = _frames(y, device), _frames(ref, device)
    hist = histogram.hist256(ref[None], method)
    return equalize_frames(y[None], hist, ref.numel())[0]


def equalize_hist_batch(y, method: str = "onehot", *,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-frame equalization of a uint8 batch (N, H, W)."""
    y = _frames(y, device)
    return equalize_frames(y, histogram.hist256(y, method),
                           y.shape[-2] * y.shape[-1])
