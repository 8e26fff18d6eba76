"""The level kernels of the H.264 device encoder, beside their plain
PyTorch versions.

Counterparts of ``opencv_opencl_tpu/ops/h264_levels.py:279 encode_levels``
and ``:1487 encode_p_levels``, which are no Pallas kernels but XLA
``lax.scan``s over the MB columns.  The kernels are CUDA C++ for Hopper in
``opencv_opencl_tpu_torch/csrc/h264_levels.cu``:

===============  ========================================  ====================
wrapper          plain version                             replaces
===============  ========================================  ====================
encode_levels    ``ops.h264_levels.encode_levels_plain``   h264_levels.py:279
                 (the split grids below)                   (H1)
encode_p_levels  ``ops.h264_levels.encode_p_levels_plain`` h264_levels.py:1487
                 (the split grids, after the search)       (H2)
===============  ========================================  ====================

As in ``ops/cuda/natural.py``: the wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel on the current
stream or raises, and counts its launches in ``encode_levels.launches``.
The kernel writes every output of a frame into one int16 buffer,
:func:`level_layout`'s segments, so that the host can fetch them in one
copy (:func:`split_levels` cuts a tensor or a numpy array of that layout);
a P frame's buffer (:func:`p_level_layout`) adds the search's MV field and
reference index, which ``motion_search_kernel`` writes there (with
``parts`` the quadrant fields and the partition modes, which
``parts_search_kernel`` writes).

A call of either wrapper launches three grids on the current stream, laid
out by :func:`levels_plan`: ``levels_split_kernel`` (a warp an MB: what the
left neighbour cannot change, and H2's inter candidate whole),
``levels_chain_kernel`` (a warp an MB row: the decisions and the carried
edge; with ``i4`` also the Intra_4x4 trial, 16 sub-blocks an MB) and
``levels_intra_kernel`` (a warp an MB: the intra MBs' levels and
reconstruction), through a scratch of ``LEVEL_RECORD_WORDS`` int32 a MB
(``I4_RECORD_WORDS`` with ``i4``) that the wrapper allocates for the call
(from PyTorch's caching allocator: one scratch shared between calls would
be overwritten by a second call in flight on another stream or thread).
``launches`` counts one a call, H1 with ``i4`` in
``encode_levels.i4_launches`` (``launch_counts()["encode_levels_i4"]``).  A
phase's device time is its kernel's own name in ``torch.profiler``'s keys
of an ordinary call.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import _on_card, _raise_on, _stream
from opencv_opencl_tpu_torch.ops.h264_levels import (
    LevelArrays, PLevelArrays, _check_p_call, _check_planes,
    _search_refs, encode_levels_plain, encode_p_levels_plain, level_plan)

__all__ = ["encode_levels", "intra_levels", "level_layout", "level_words",
           "split_levels", "plan_words", "encode_p_levels", "p_levels_into",
           "p_level_layout", "p_level_words", "split_p_levels",
           "launch_counts", "reset_launch_counts", "levels_plan",
           "LEVEL_RECORD_WORDS", "I4_RECORD_WORDS"]

# the split design's scratch, int32 words a MB (csrc/h264_levels.cu
# kRecWords; with i4 kRecWordsI4, which adds each luma block's T(src) as 8
# words and its cost; the launcher refuses another count), and the MBs (a
# warp each) a block of its A and C grids (kSplitWarps)
LEVEL_RECORD_WORDS = 188
I4_RECORD_WORDS = LEVEL_RECORD_WORDS + 16 * 8 + 16
SPLIT_WARPS = 4

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


def levels_plan(mb_h: int, mb_w: int, i4: bool = False) -> dict:
    """The split design's launches for an (mb_h, mb_w) MB grid: the
    scratch (int32 words a MB, words and bytes), and the (blocks, threads)
    of phase A (a warp an MB, ``SPLIT_WARPS`` a block), B (a warp an MB row,
    one a block) and C (as A)."""
    n = mb_h * mb_w
    blocks = -(-n // SPLIT_WARPS)
    words = I4_RECORD_WORDS if i4 else LEVEL_RECORD_WORDS
    return {"record_words": words, "scratch_words": words * n,
            "scratch_bytes": 4 * words * n, "split": (blocks, 32 * SPLIT_WARPS),
            "chain": (mb_h, 32), "intra": (blocks, 32 * SPLIT_WARPS)}


def _scratch(device, plan: dict) -> torch.Tensor:
    return torch.empty(plan["scratch_words"], dtype=torch.int32, device=device)


def intra_levels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 qp: int, out: torch.Tensor, full_recon: bool = False,
                 i4: bool = False, chromah: bool = False):
    """Launch H1 over CUDA planes into ``out``, a contiguous int16 buffer of
    :func:`level_words` elements: the split design's three grids (their
    ``i4`` instances with ``i4``).  Returns the reconstructed planes
    ``(ry, rcb, rcr)`` with ``full_recon``, else None.  ``y`` has unit
    pixel stride; ``cb``/``cr`` may be the interleaved views of an NV12
    chroma plane (pixel stride 2)."""
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
    layout = levels_plan(mb_h, mb_w, i4)
    scratch = _scratch(y.device, layout)
    plan = plan_words(qp)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.intra_levels_launch(
            y.data_ptr(), y.stride(0), cb.data_ptr(), cb.stride(0), cb.stride(1),
            cr.data_ptr(), cr.stride(0), cr.stride(1), mb_h, mb_w,
            plan.ctypes.data, int(i4), int(chromah), out.data_ptr(),
            *((t.data_ptr() for t in recon) if recon else (None, None, None)),
            scratch.data_ptr(), layout["record_words"], _stream(y.device))
    _raise_on(err, "levels_split/chain/intra_kernel")
    if i4:
        encode_levels.i4_launches += 1
    else:
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


def p_level_layout(mb_h: int, mb_w: int,
                   parts: bool = False) -> list[tuple[str, tuple, int]]:
    """The segments of a P frame's int16 level buffer, in order: (name,
    shape, offset in elements): H1's first four, then ``mode``, the MV
    field ``mv`` (dy, dx) and the reference index ``ref``.  With ``parts``
    ``mv`` is the quadrant field (4, 2), ``ref`` one a quadrant (4,), and
    the partition modes ``pmode`` follow."""
    segs = [("zdc", (16,)), ("acz", (16, 16)), ("czdc", (2, 4)),
            ("cacz", (2, 4, 16)), ("mode", ())]
    segs += ([("mv", (4, 2)), ("ref", (4,)), ("pmode", ())] if parts
             else [("mv", (2,)), ("ref", ())])
    out, off = [], 0
    for name, shape in segs:
        out.append((name, (mb_h, mb_w) + shape, off))
        off += mb_h * mb_w * int(np.prod(shape, dtype=np.int64))
    return out


def p_level_words(mb_h: int, mb_w: int, parts: bool = False) -> int:
    """int16 elements of a P frame's level buffer (412 a MB, 422 with
    ``parts``)."""
    return (422 if parts else 412) * mb_h * mb_w


def split_p_levels(flat, mb_h: int, mb_w: int, parts: bool = False) -> dict:
    """Views of a P level buffer (a tensor or a numpy array), by name."""
    out = {}
    for name, shape, off in p_level_layout(mb_h, mb_w, parts):
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[off:off + n].reshape(shape)
    return out


def p_levels_into(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  pred_y: torch.Tensor, pred_cb: torch.Tensor,
                  pred_cr: torch.Tensor, qp: int, out: torch.Tensor,
                  motion: bool = False, two_refs: bool = False,
                  band: tuple[int, int] | None = None, parts: bool = False):
    """Launch H2 (the split design's three grids) over CUDA planes into
    ``out``, a contiguous int16 buffer of :func:`p_level_words` elements (of
    the ``parts`` layout with ``parts``) whose ``mv`` (with ``motion``),
    ``ref`` (with ``two_refs``) and ``pmode`` (with ``parts``) segments
    already hold the search's fields: an MB may skip only where its
    (quadrant 0's) vector and reference are zero and, with ``parts``, its
    partition is 16x16.  ``pred_*`` are the motion-compensated planes (the
    reference at zero motion), contiguous; ``band`` the GDR intra rows [lo,
    hi).  Returns the new reconstructed planes ``(ry, rcb, rcr)``; the
    predictions are only read."""
    mb_h, mb_w = _check_planes(y, cb, cr)
    if not _on_card(y):
        raise ValueError(f"p_levels_into launches on a CUDA device, got {y.device}")
    if y.stride(1) != 1:
        raise ValueError(f"y must have unit pixel stride, got {y.stride()}")
    _check_strides(cb, "cb")
    _check_strides(cr, "cr")
    _check_planes(pred_y, pred_cb, pred_cr)
    for name, t, like in (("pred_y", pred_y, y), ("pred_cb", pred_cb, cb),
                          ("pred_cr", pred_cr, cr)):
        if (tuple(t.shape) != tuple(like.shape) or not t.is_contiguous()
                or t.device != y.device):
            raise ValueError(f"{name} must be a contiguous {tuple(like.shape)} "
                             f"plane on {y.device}")
    if parts and not motion:
        raise ValueError("parts needs the search's fields (motion=True)")
    need = p_level_words(mb_h, mb_w, parts)
    if (out.dtype != torch.int16 or out.device != y.device
            or not out.is_contiguous() or out.numel() != need):
        raise ValueError(f"out must be a contiguous int16 buffer of {need} "
                         f"elements on {y.device}")
    H, W = y.shape
    recon = (torch.empty((H, W), dtype=torch.uint8, device=y.device),
             torch.empty((H // 2, W // 2), dtype=torch.uint8, device=y.device),
             torch.empty((H // 2, W // 2), dtype=torch.uint8, device=y.device))
    scratch = _scratch(y.device, levels_plan(mb_h, mb_w))
    lo, hi = (0, 0) if band is None else (int(band[0]), int(band[1]))
    plan = plan_words(qp)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.p_levels_launch(
            y.data_ptr(), y.stride(0), cb.data_ptr(), cb.stride(0), cb.stride(1),
            cr.data_ptr(), cr.stride(0), cr.stride(1), pred_y.data_ptr(),
            pred_cb.data_ptr(), pred_cr.data_ptr(), mb_h, mb_w, plan.ctypes.data,
            int(motion), int(two_refs), int(parts), lo, hi, out.data_ptr(),
            *(t.data_ptr() for t in recon), scratch.data_ptr(), LEVEL_RECORD_WORDS,
            _stream(y.device))
    _raise_on(err, "levels_split/chain/intra_kernel")
    encode_p_levels.launches += 1
    return recon


def encode_p_levels(y, cb, cr, ry, rcb, rcr, qp: int, search: int = 0,
                    subpel: int = 0, ry2=None, rcb2=None, rcr2=None,
                    gdr_band: tuple | None = None, parts: int = 0) -> PLevelArrays:
    """:func:`ops.h264_levels.encode_p_levels`: the kernels for CUDA planes
    (the search's two, then H2's three grids), the plain version for CPU
    ones."""
    mb_h, mb_w = _check_p_call(y, cb, cr, ry, rcb, rcr, ry2, gdr_band, parts,
                               search, subpel)
    if not _on_card(y):
        return encode_p_levels_plain(y, cb, cr, ry, rcb, rcr, qp, search, subpel,
                                     ry2, rcb2, rcr2, gdr_band, parts)
    from opencv_opencl_tpu_torch.ops.cuda import h264_inter

    parts = bool(parts)
    y = y if y.stride(1) == 1 else y.contiguous()
    out = torch.empty(p_level_words(mb_h, mb_w, parts), dtype=torch.int16,
                      device=y.device)
    fields = split_p_levels(out, mb_h, mb_w, parts)
    refs = [tuple(t.contiguous() for t in r)
            for r in _search_refs(ry, rcb, rcr, ry2, rcb2, rcr2)]
    two = search > 0 and len(refs) > 1
    if search:
        H, W = y.shape
        pred = (torch.empty((H, W), dtype=torch.uint8, device=y.device),
                torch.empty((H // 2, W // 2), dtype=torch.uint8, device=y.device),
                torch.empty((H // 2, W // 2), dtype=torch.uint8, device=y.device))
        if parts:
            h264_inter.parts_search_into(y, refs if two else refs[:1], search,
                                         subpel, qp, fields["pmode"], fields["mv"],
                                         fields["ref"] if two else None, *pred)
        else:
            h264_inter.search_into(y, refs if two else refs[:1], search, subpel,
                                   None if gdr_band is None else int(gdr_band[0]),
                                   fields["mv"], fields["ref"] if two else None,
                                   *pred)
    else:
        pred = refs[0]
    recon = p_levels_into(y, cb, cr, *pred, qp, out, motion=search > 0,
                          two_refs=two, band=gdr_band, parts=parts)
    return PLevelArrays(fields["mode"], fields["zdc"], fields["acz"], fields["czdc"],
                        fields["cacz"], *recon, fields["mv"] if search else None,
                        fields["ref"] if two else None,
                        fields["pmode"] if parts else None)


_WRAPPERS = (encode_levels, encode_p_levels)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
    encode_levels.i4_launches = 0


def launch_counts() -> dict[str, int]:
    """Launches by wrapper name; H1's with ``i4`` under
    ``encode_levels_i4``."""
    counts = {fn.__name__: fn.launches for fn in _WRAPPERS}
    counts["encode_levels_i4"] = encode_levels.i4_launches
    return counts


reset_launch_counts()
