"""The intra level kernel of the H.264 device encoder, beside its plain
PyTorch version.

Counterpart of ``opencv_opencl_tpu/ops/h264_levels.py:279 encode_levels``,
which is no Pallas kernel but an XLA ``lax.scan`` over the MB columns.
The kernel is CUDA C++ for Hopper in
``opencv_opencl_tpu_torch/csrc/h264_levels.cu``:

=============  ==========================================  ===================
wrapper        plain version                               replaces
=============  ==========================================  ===================
encode_levels  ``ops.h264_levels.encode_levels_plain``     h264_levels.py:279
               (``intra_levels_kernel``)                   (H1)
=============  ==========================================  ===================

As in ``ops/cuda/natural.py``: the wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel on the current
stream or raises, and counts its launches in ``encode_levels.launches``.
The kernel writes every output of a frame into one int16 buffer,
:func:`level_layout`'s segments, so that the host can fetch them in one
copy (:func:`split_levels` cuts a tensor or a numpy array of that layout).
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import _on_card, _raise_on, _stream
from opencv_opencl_tpu_torch.ops.h264_levels import (
    LevelArrays, _check_planes, encode_levels_plain, level_plan)

__all__ = ["encode_levels", "intra_levels", "level_layout", "level_words",
           "split_levels", "plan_words", "launch_counts",
           "reset_launch_counts"]

# the kernel's int32 plan: the order of csrc/h264_levels.cu's Plan
_PLAN_KEYS = ("qp", "qpc", "qbits", "qbits_c", "f_y", "f_c", "mf_y", "mf_c",
              "v_y", "v_c")


def plan_words(qp: int) -> np.ndarray:
    """:func:`ops.h264_levels.level_plan` as the kernel's 18 int32 words."""
    plan = level_plan(qp)
    words = []
    for key in _PLAN_KEYS:
        val = plan[key]
        words += val if isinstance(val, list) else [val]
    return np.asarray(words, np.int32)


def level_layout(mb_h: int, mb_w: int, i4: bool = False,
                 chromah: bool = False) -> list[tuple[str, tuple, int]]:
    """The segments of a frame's int16 level buffer, in order: (name,
    shape, offset in elements).  ``i4modes`` is there with ``i4`` and
    ``cmode`` with ``chromah``."""
    segs = [("zdc", (16,)), ("acz", (16, 16)), ("czdc", (2, 4)),
            ("cacz", (2, 4, 16)), ("imode", ())]
    if i4:
        segs.append(("i4modes", (16,)))
    if chromah:
        segs.append(("cmode", ()))
    out, off = [], 0
    for name, shape in segs:
        out.append((name, (mb_h, mb_w) + shape, off))
        off += mb_h * mb_w * int(np.prod(shape, dtype=np.int64))
    return out


def level_words(mb_h: int, mb_w: int, i4: bool = False,
                chromah: bool = False) -> int:
    """int16 elements of a frame's level buffer."""
    name, shape, off = level_layout(mb_h, mb_w, i4, chromah)[-1]
    return off + int(np.prod(shape, dtype=np.int64))


def split_levels(flat, mb_h: int, mb_w: int, i4: bool = False,
                 chromah: bool = False) -> dict:
    """Views of a level buffer (a tensor or a numpy array), by name."""
    out = {}
    for name, shape, off in level_layout(mb_h, mb_w, i4, chromah):
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[off:off + n].reshape(shape)
    return out


def _as_outputs(parts: dict, i4: bool, chromah: bool, recon=None):
    """The JAX function's tuple from the named parts."""
    lv = LevelArrays(parts["zdc"], parts["acz"], parts["czdc"], parts["cacz"])
    extra = ((parts["i4modes"],) if i4 else ()) + (
        (parts["cmode"],) if chromah else ())
    if recon is None:
        return (lv, parts["imode"]) + extra
    return (lv, *recon, parts["imode"]) + extra


def _check_strides(t: torch.Tensor, name: str) -> None:
    if t.stride(1) not in (1, 2) or t.stride(0) < t.shape[1] * t.stride(1):
        raise ValueError(f"{name} must have rows of unit or 2-byte pixel "
                         f"stride, got strides {t.stride()}")


def intra_levels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 qp: int, out: torch.Tensor, full_recon: bool = False,
                 i4: bool = False, chromah: bool = False):
    """Launch ``intra_levels_kernel`` over CUDA planes into ``out``, a
    contiguous int16 buffer of :func:`level_words` elements.  Returns the
    reconstructed planes ``(ry, rcb, rcr)`` with ``full_recon``, else None.
    ``y`` has unit pixel stride; ``cb``/``cr`` may be the interleaved
    views of an NV12 chroma plane (pixel stride 2)."""
    mb_h, mb_w = _check_planes(y, cb, cr)
    if not _on_card(y):
        raise ValueError(f"intra_levels launches on a CUDA device, got {y.device}")
    if y.stride(1) != 1:
        raise ValueError(f"y must have unit pixel stride, got {y.stride()}")
    _check_strides(cb, "cb")
    _check_strides(cr, "cr")
    need = level_words(mb_h, mb_w, i4, chromah)
    if (out.dtype != torch.int16 or out.device != y.device
            or not out.is_contiguous() or out.numel() != need):
        raise ValueError(f"out must be a contiguous int16 buffer of {need} "
                         f"elements on {y.device}")
    recon = None
    if full_recon:
        H, W = y.shape
        recon = (torch.empty((H, W), dtype=torch.uint8, device=y.device),
                 torch.empty((H // 2, W // 2), dtype=torch.uint8, device=y.device),
                 torch.empty((H // 2, W // 2), dtype=torch.uint8, device=y.device))
    plan = plan_words(qp)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.intra_levels_launch(
            y.data_ptr(), y.stride(0), cb.data_ptr(), cb.stride(0), cb.stride(1),
            cr.data_ptr(), cr.stride(0), cr.stride(1), mb_h, mb_w,
            plan.ctypes.data, int(i4), int(chromah), out.data_ptr(),
            *((t.data_ptr() for t in recon) if recon else (None, None, None)),
            _stream(y.device))
    _raise_on(err, "intra_levels_kernel")
    encode_levels.launches += 1
    return recon


def encode_levels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  qp: int, full_recon: bool = False, i4: bool = False,
                  chromah: bool = False):
    """:func:`ops.h264_levels.encode_levels`: the kernel for CUDA planes,
    the plain version for CPU ones."""
    mb_h, mb_w = _check_planes(y, cb, cr)
    if not _on_card(y):
        return encode_levels_plain(y, cb, cr, qp, full_recon=full_recon, i4=i4,
                                   chromah=chromah)
    out = torch.empty(level_words(mb_h, mb_w, i4, chromah), dtype=torch.int16,
                      device=y.device)
    recon = intra_levels(y, cb, cr, qp, out, full_recon=full_recon, i4=i4,
                         chromah=chromah)
    return _as_outputs(split_levels(out, mb_h, mb_w, i4, chromah), i4, chromah,
                       recon)


_WRAPPERS = (encode_levels,)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
