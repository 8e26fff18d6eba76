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
reconstruction); :func:`deblock_planes` filters copies.  One launch is
``deblock_bs_kernel`` (every MB's boundary strengths as nibbles,
``ops.h264_deblock.bs_words``) and then the wavefront ``deblock_kernel``,
laid out by :func:`deblock_plan`: a band of MB rows a block, a warp a row
(lanes 0-15 its luma lines, 16-31 its chroma lines), and two warps a block
that hand the band's last rows to the next band through a seam in device
memory.  :func:`deblock_floor_into` is the same launch without the edge
arithmetic (the wavefront's floor), counted apart in
``deblock_floor_into.launches`` (not in :func:`launch_counts`).
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops import h264_deblock as deblock
from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import _on_card, _raise_on, _stream

__all__ = ["deblock_planes", "deblock_into", "deblock_floor_into", "deblock_plan",
           "deblock_rows_per_block", "launch_counts", "reset_launch_counts"]

# the kernel's layout (csrc/h264_deblock.cu): MB rows a block at 4K (a warp
# a row; fewer rows a block spread the wavefront over more SMs) and at most
# (its __launch_bounds__: the rows' warps and two io warps), the MB slots
# of a ring, a slot's bytes (4 luma rows of 16, 2 x 2 chroma rows of 8) and
# a row's patch (20 x 36 luma, 2 x 10 x 20 chroma)
DEBLOCK_ROWS, DEBLOCK_MAX_ROWS = 4, 16
_RING, _SLOT, _PATCH = 8, 96, 20 * 36 + 2 * 10 * 20


def deblock_rows_per_block(mb_h: int, mb_w: int) -> int:
    """MB rows a block of ``deblock_kernel`` owns: ``DEBLOCK_ROWS``, or the
    picture's rows when it has fewer.  The bands hand off through device
    memory, the rows inside one through shared memory."""
    return min(DEBLOCK_ROWS, mb_h)


def deblock_plan(mb_h: int, mb_w: int) -> dict:
    """The launch of ``deblock_kernel`` for an (mb_h, mb_w) MB grid: rows a
    block (1..16), blocks (all resident: the launch is cooperative), threads
    (a warp a row and the two io warps), the dynamic shared bytes (the
    launcher refuses any other count), the seam's bytes (4 luma and 2 x 2
    chroma rows a band boundary) and the bS words' bytes."""
    rows = deblock_rows_per_block(mb_h, mb_w)
    blocks = -(-mb_h // rows)
    shared = (-(-8 * (rows + 1) // 16) * 16 + (rows + 1) * _RING * _SLOT
              + rows * _PATCH)
    return {"rows": rows, "blocks": blocks, "threads": 32 * (rows + 2),
            "shared": shared, "seam_bytes": (blocks - 1) * 6 * 16 * mb_w,
            "bs_bytes": 16 * mb_h * mb_w}


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
    g = _checked(y, cb, cr, intra, nnz4, mv, ref, "deblock_into")
    _launch(y, cb, cr, qp, intra, nnz4, mv, ref, g, slice_local, True)
    deblock_planes.launches += 1


def deblock_floor_into(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, qp: int,
                       intra: torch.Tensor, nnz4: torch.Tensor, mv: torch.Tensor | None,
                       ref: torch.Tensor | None, slice_local: bool = False) -> None:
    """:func:`deblock_into`'s launch with the edge arithmetic taken out: the
    bS pass, every wait, load, handoff and store of the wavefront, and the
    planes left as they were.  Its time is the schedule's floor."""
    g = _checked(y, cb, cr, intra, nnz4, mv, ref, "deblock_floor_into")
    _launch(y, cb, cr, qp, intra, nnz4, mv, ref, g, slice_local, False)
    deblock_floor_into.launches += 1


def _checked(y, cb, cr, intra, nnz4, mv, ref, name: str) -> int:
    """Check :func:`deblock_into`'s arguments; the motion fields' grid step g
    (2: one an 8x8 block, else 1)."""
    H, W = y.shape
    g = (2 if mv is not None and mv.ndim == 3
         and tuple(mv.shape[:2]) == (H // 8, W // 8) else 1)
    mb_h, mb_w = deblock._check_deblock(
        y, cb, cr, intra, nnz4,
        torch.empty((H // 16, W // 16, 2), device=y.device) if mv is None else mv,
        torch.empty((g * (H // 16), g * (W // 16)), device=y.device)
        if ref is None else ref)
    if not _on_card(y):
        raise ValueError(f"{name} launches on a CUDA device, got {y.device}")
    for plane, t in (("y", y), ("cb", cb), ("cr", cr)):
        if not t.is_contiguous():
            raise ValueError(f"{plane} must be contiguous, got strides {t.stride()}")
    if mv is not None and (mv.dtype != torch.int16 or mv.stride(2) != 1
                           or mv.stride(1) != 2 or mv.stride(0) != 2 * g * mb_w):
        raise ValueError("mv must be int16 with contiguous rows")
    if ref is not None and (ref.dtype != torch.int16 or not ref.is_contiguous()):
        raise ValueError("ref must be a contiguous int16 grid")
    return g


def _launch(y, cb, cr, qp, intra, nnz4, mv, ref, g, slice_local, filtered) -> None:
    for name, t, unit in (("y", y, 16), ("cb", cb, 8), ("cr", cr, 8)):
        if t.data_ptr() % unit:
            raise ValueError(f"{name} must start on a {unit}-byte boundary")
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    plan = deblock_plan(mb_h, mb_w)
    intra_u8, nnz_u8 = _flag(intra), _flag(nnz4)
    params = np.asarray(deblock.filter_params(qp), np.int32)
    dev = y.device
    bs = torch.empty(plan["bs_bytes"] // 4, dtype=torch.int32, device=dev)
    seam = torch.empty(max(plan["seam_bytes"], 16), dtype=torch.uint8, device=dev)
    flags = torch.zeros(plan["blocks"], dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.deblock_launch(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), mb_h, mb_w,
            intra_u8.data_ptr(), nnz_u8.data_ptr(),
            None if mv is None else mv.data_ptr(),
            None if ref is None else ref.data_ptr(), int(g == 2), params.ctypes.data,
            int(slice_local), plan["rows"], plan["shared"], bs.data_ptr(),
            seam.data_ptr(), flags.data_ptr(), int(filtered), _stream(dev))
    _raise_on(err, "deblock_kernel")


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
    for fn in _WRAPPERS + (deblock_floor_into,):
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
