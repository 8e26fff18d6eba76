"""The NV12 frame-enhancement step on PyTorch tensors.

Counterpart of ``opencv_opencl_tpu/models/enhancer.py``: NV12 batch in ->
enhance the Y plane -> chroma policy (gray / passthrough) -> NV12 out, with
the same bit-exact OpenCV semantics.  On a CUDA tensor the CLAHE step runs
the three kernels of ``ops/cuda/natural.py``.

Example
-------
>>> cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
...                      chroma=ChromaPolicy.PASSTHROUGH)
>>> enhancer = Enhancer(cfg, FrameSpec(width=1920, height=1080), device="cuda")
>>> out = np.asarray(enhancer.process_batch(nv12_batch))  # (N, 1620, 1920)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch

__all__ = ["EnhancerConfig", "Enhancer", "build_enhance_fn", "make_enhance_y"]


@dataclasses.dataclass(frozen=True)
class EnhancerConfig:
    """What to run per frame; the JAX package's fields and validation.

    op: "histeq" (global equalization), "clahe", or "none" (passthrough).
    chroma: GRAY (UV=128) or PASSTHROUGH, the two reference chroma policies.
    hist_method: histogram strategy of the JAX package ("onehot" |
        "scatter"); the port has one histogram kernel and ignores it.
    use_ref_frame: two-input mode — LUTs from the previous frame.
    hist_downsample: 1 = exact.  N > 1 builds histograms from every Nth row
        with the counts rescaled (the opt-in approximate mode).
    """

    op: str = "histeq"
    clip_limit: float = 2.0
    tile_grid: tuple[int, int] = (8, 8)
    chroma: ChromaPolicy = ChromaPolicy.GRAY
    hist_method: str = "onehot"
    use_ref_frame: bool = False
    hist_downsample: int = 1

    def __post_init__(self):
        if self.op not in ("histeq", "clahe", "none"):
            raise ValueError(f"unknown op {self.op!r}")
        if self.hist_downsample < 1:
            raise ValueError("hist_downsample must be >= 1")


def make_enhance_y(cfg: EnhancerConfig, spec: FrameSpec):
    """Build the Y-plane batch enhancement for one config.

    Returns ``(enhance_y, plan)``: ``enhance_y(y, out)`` enhances uint8
    (N, H, W) frames into ``out`` (which may be ``y``) and returns it;
    ``plan`` is the CLAHE plan (None for op="none").
    """
    if cfg.op == "histeq":
        raise NotImplementedError(
            "op='histeq' is not ported to PyTorch yet; it comes with the port "
            "of ops/histeq.py (ROADMAP.md, Queue 1 item 5)")
    if cfg.use_ref_frame:
        raise NotImplementedError(
            "use_ref_frame is not ported to PyTorch yet; streaming CLAHE "
            "comes with ROADMAP.md Queue 1 item 6")
    if cfg.op == "none":
        def copy_y(y, out):
            return out if out is y else out.copy_(y)

        return copy_y, None

    plan = clahe_ops.make_clahe_plan(spec.height, spec.width,
                                     float(cfg.clip_limit),
                                     tuple(cfg.tile_grid))
    ds = int(cfg.hist_downsample)
    if ds > 1 and plan.tile_h % ds:
        raise ValueError(
            f"hist_downsample={ds} must divide the tile height "
            f"({plan.tile_h} for {spec.height}x{spec.width} grid "
            f"{tuple(cfg.tile_grid)})")

    def enhance_y(y, out):
        return clahe_ops.clahe_apply(y, plan, hist_rowstep=ds, out=out)

    return enhance_y, plan


def build_enhance_fn(cfg: EnhancerConfig, spec: FrameSpec,
                     donate: bool = True):
    """Returns ``fn(nv12_batch: uint8 tensor (N, H*3/2, W)) -> same shape``.

    ``donate=True`` stands in for JAX's buffer donation: the result is
    written into the input tensor.  The interpolation kernel writes the
    enhanced Y rows in place (each output pixel depends only on its own
    input pixel and the LUTs, which are complete before it starts), the
    PASSTHROUGH chroma rows are never touched, and GRAY fills them with 128.
    The caller must not expect the input's old contents after the call.
    ``donate=False`` writes into a new tensor.
    """
    h = spec.height
    enhance_y, _ = make_enhance_y(cfg, spec)

    def fn(nv12_batch: torch.Tensor) -> torch.Tensor:
        if (nv12_batch.dtype != torch.uint8 or nv12_batch.ndim != 3
                or tuple(nv12_batch.shape[1:]) != (spec.buffer_rows, spec.width)):
            raise ValueError(
                f"expected uint8 (N, {spec.buffer_rows}, {spec.width}), got "
                f"{nv12_batch.dtype} {tuple(nv12_batch.shape)}")
        out = nv12_batch if donate else torch.empty_like(nv12_batch)
        enhance_y(nv12_batch[:, :h], out[:, :h])
        if cfg.chroma == ChromaPolicy.GRAY:
            out[:, h:].fill_(128)
        elif not donate:
            out[:, h:].copy_(nv12_batch[:, h:])
        return out

    return fn


class Enhancer:
    """Config + spec -> a reusable step on ``device``.

    ``process_batch`` takes a host batch (numpy or tensor), copies it to
    the device, runs the step in place there and returns a
    :class:`DeviceBatch` whose host copy is already under way —
    ``np.asarray`` of it is the enhanced batch, as ``runtime/feeder``
    expects.
    """

    def __init__(self, cfg: EnhancerConfig, spec: FrameSpec,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        self._fn = build_enhance_fn(cfg, spec, donate=True)
        self._d2h = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)

    def _to_device(self, batch) -> torch.Tensor:
        t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(batch))
        # always a copy: the step writes in place, and the caller's buffer
        # (the feeder's recycled staging slot) must stay as it was
        return t.to(self.device, copy=True)

    def process_batch(self, nv12_batch) -> DeviceBatch:
        """uint8 (N, H*3/2, W) -> the enhanced batch, on its way to the host."""
        return DeviceBatch(self._fn(self._to_device(nv12_batch)), self._d2h)

    def process_frame(self, nv12) -> DeviceBatch:
        """Single frame (H*3/2, W) convenience (batch of 1 under the hood)."""
        return DeviceBatch(self._fn(self._to_device(nv12)[None])[0], self._d2h)
