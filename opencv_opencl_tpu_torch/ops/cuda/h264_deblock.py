"""The in-loop deblocking kernel of the H.264 device GOP encoder, beside its
plain PyTorch version.

Counterpart of ``opencv_opencl_tpu/ops/h264_deblock.py:226 deblock_planes``
(with ``:59 bs_grids``), an XLA ``lax.scan`` over the anti-diagonals of the
MB grid: no Pallas kernel.  The kernel is CUDA C++ for Hopper in
``opencv_opencl_tpu_torch/csrc/h264_deblock.cu``:

==============  ===========================================  ==================
wrapper         plain version                                replaces
==============  ===========================================  ==================
deblock_planes  ``ops.h264_deblock.deblock_planes_plain``    h264_deblock.py:226
                (``deblock_kernel``, H5)                     (H5)
==============  ===========================================  ==================

As in ``ops/cuda/natural.py``: the wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel on the current
stream or raises, and counts its launches in ``deblock_planes.launches``.
:func:`deblock_into` filters planes in place (the GOP encoder's fresh
reconstruction); :func:`deblock_planes` filters copies.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops import h264_deblock as deblock
from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import _on_card, _raise_on, _stream

__all__ = ["deblock_planes", "deblock_into", "launch_counts",
           "reset_launch_counts"]


def _flag(t: torch.Tensor) -> torch.Tensor:
    """A bool or integer 0/1 grid as contiguous uint8."""
    return (t.view(torch.uint8) if t.dtype == torch.bool else
            (t != 0).view(torch.uint8)).contiguous()


def deblock_into(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, qp: int,
                 intra: torch.Tensor, nnz4: torch.Tensor, mv: torch.Tensor | None,
                 ref: torch.Tensor | None, slice_local: bool = False) -> None:
    """Launch ``deblock_kernel`` over contiguous CUDA planes, filtering them
    in place.  ``mv`` int16 (mb_h, mb_w, 2) and ``ref`` int16 (mb_h, mb_w),
    each MB's values contiguous (views of a level buffer will do), or None
    for zero motion / one reference; or both one an 8x8 block, (2*mb_h,
    2*mb_w, ...) contiguous (the partition modes' quadrant fields)."""
    H, W = y.shape
    g = (2 if mv is not None and mv.ndim == 3
         and tuple(mv.shape[:2]) == (H // 8, W // 8) else 1)
    mb_h, mb_w = deblock._check_deblock(
        y, cb, cr, intra, nnz4,
        torch.empty((H // 16, W // 16, 2), device=y.device) if mv is None else mv,
        torch.empty((g * (H // 16), g * (W // 16)), device=y.device)
        if ref is None else ref)
    if not _on_card(y):
        raise ValueError(f"deblock_into launches on a CUDA device, got {y.device}")
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    if mv is not None and (mv.dtype != torch.int16 or mv.stride(2) != 1
                           or mv.stride(1) != 2 or mv.stride(0) != 2 * g * mb_w):
        raise ValueError("mv must be int16 with contiguous rows")
    if ref is not None and (ref.dtype != torch.int16 or not ref.is_contiguous()):
        raise ValueError("ref must be a contiguous int16 grid")
    intra_u8, nnz_u8 = _flag(intra), _flag(nnz4)
    params = np.asarray(deblock.filter_params(qp), np.int32)
    progress = torch.zeros(mb_h, dtype=torch.int32, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.deblock_launch(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), mb_h, mb_w,
            intra_u8.data_ptr(), nnz_u8.data_ptr(),
            None if mv is None else mv.data_ptr(),
            None if ref is None else ref.data_ptr(), int(g == 2), params.ctypes.data,
            int(slice_local), progress.data_ptr(), _stream(y.device))
    _raise_on(err, "deblock_kernel")
    deblock_planes.launches += 1


def deblock_planes(y, cb, cr, qp: int, intra, nnz4, mv, ref,
                   slice_local: bool = False):
    """:func:`ops.h264_deblock.deblock_planes`: the kernel for CUDA planes
    (on copies), the plain version for CPU ones."""
    deblock._check_deblock(y, cb, cr, intra, nnz4, mv, ref)
    if not _on_card(y):
        return deblock.deblock_planes_plain(y, cb, cr, qp, intra, nnz4, mv, ref,
                                            slice_local=slice_local)
    out = tuple(t.contiguous().clone() for t in (y, cb, cr))
    deblock_into(*out, qp, intra, nnz4, mv.to(torch.int16).contiguous(),
                 ref.to(torch.int16).contiguous(), slice_local=slice_local)
    return out


_WRAPPERS = (deblock_planes,)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
