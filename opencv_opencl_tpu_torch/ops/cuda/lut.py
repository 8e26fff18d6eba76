"""The equalizeHist map (K4) beside its plain PyTorch version.

Counterpart of ``opencv_opencl_tpu/ops/pallas/lut_kernels.py``
``apply_lut_pallas`` (K4).  The kernel is CUDA C++ for Hopper,
``apply_lut_kernel`` in ``opencv_opencl_tpu_torch/csrc/lut.cu``.

As in ``ops/cuda/natural.py``: the wrapper takes its plain version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel on the
current stream or raises, and counts its launches in ``apply_lut.launches``.
"""

from __future__ import annotations

import torch

from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import (
    _check,
    _on_card,
    _raise_on,
    _stream,
)

__all__ = ["apply_lut", "apply_lut_ref", "launch_counts", "reset_launch_counts"]

# rows per block: one row per warp of the 8-warp block, so a 4K batch of 4
# gives 1080 blocks, about 8 per SM of an H100's 132
_ROWS_PER_BLOCK = 8


def apply_lut_ref(y: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`apply_lut`: ``gather`` along each frame's
    LUT."""
    n = y.shape[0]
    return torch.gather(luts, 1, y.reshape(n, -1).long()).reshape(y.shape)


def _check_frames(t: torch.Tensor, name: str) -> None:
    _check(t, name, torch.uint8, 3)
    if t.stride(2) != 1 and t.shape[2] > 1:
        raise ValueError(f"{name} must have unit column stride, got "
                         f"strides {t.stride()}")


def apply_lut(y: torch.Tensor, luts: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Map (N, H, W) uint8 frames through one 256-entry uint8 LUT per frame,
    ``luts`` (N, 256).  Rows and frames may be strided (the Y rows of an
    NV12 batch); ``out`` (same shape) may be ``y`` itself."""
    _check_frames(y, "y")
    _check(luts, "luts", torch.uint8, 2)
    if tuple(luts.shape) != (y.shape[0], 256):
        raise ValueError(f"luts must be ({y.shape[0]}, 256), got "
                         f"{tuple(luts.shape)}")
    if out is not None:
        _check_frames(out, "out")
        if out.shape != y.shape or out.device != y.device:
            raise ValueError("out must match y in shape and device")
    if luts.device != y.device:
        raise ValueError(f"luts on {luts.device}, frames on {y.device}")
    if not _on_card(y):
        res = apply_lut_ref(y, luts)
        return res if out is None else out.copy_(res)
    if not luts.is_contiguous():
        raise ValueError("luts must be contiguous")
    lib = _build.load()
    if out is None:
        out = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
    n, h, w = y.shape
    if n and h and w:
        with torch.cuda.device(y.device):
            err = lib.apply_lut_launch(
                y.data_ptr(), y.stride(0), y.stride(1), luts.data_ptr(), n, h,
                w, out.data_ptr(), out.stride(0), out.stride(1),
                _ROWS_PER_BLOCK, _stream(y.device))
        _raise_on(err, "apply_lut_kernel")
        apply_lut.launches += 1
    return out


def reset_launch_counts() -> None:
    apply_lut.launches = 0


def launch_counts() -> dict[str, int]:
    return {"apply_lut": apply_lut.launches}


reset_launch_counts()
