"""The NV12 frame-enhancement step on PyTorch tensors.

Counterpart of ``opencv_opencl_tpu/models/enhancer.py``: NV12 batch in ->
enhance the Y plane -> chroma policy (gray / passthrough) -> NV12 out, with
the same bit-exact OpenCV semantics.  On a CUDA tensor the CLAHE step runs
K1, K2 and K3 (``ops/cuda/natural.py``); histeq runs K1 on the whole frame
and K4 (``ops/cuda/lut.py``); the streaming ref-frame CLAHE of
:class:`StreamingEnhancer` runs K2 and K7, or K2, K1 and K3 where the
geometry needs reflect-101 padding.

Example
-------
>>> cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
...                      chroma=ChromaPolicy.PASSTHROUGH)
>>> enhancer = Enhancer(cfg, FrameSpec(width=1920, height=1080), device="cuda")
>>> out = np.asarray(enhancer.process_batch(nv12_batch))  # (N, 1620, 1920)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
from opencv_opencl_tpu_torch.ops import histeq as histeq_ops
from opencv_opencl_tpu_torch.ops import histogram
from opencv_opencl_tpu_torch.ops.cuda import natural
from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch

__all__ = ["EnhancerConfig", "Enhancer", "build_enhance_fn",
           "make_enhance_y", "StreamingEnhancer",
           "build_streaming_clahe_fn", "initial_hists", "hists_from_jax"]


@dataclasses.dataclass(frozen=True)
class EnhancerConfig:
    """What to run per frame; the JAX package's fields and validation.

    op: "histeq" (global equalization), "clahe", or "none" (passthrough).
    chroma: GRAY (UV=128) or PASSTHROUGH, the two reference chroma policies.
    hist_method: histogram strategy of the JAX package ("onehot" |
        "scatter"; one kernel here); any other value raises ``ValueError``
        at the first step, as in the JAX package.
    use_ref_frame: two-input mode — histeq maps frame i of a batch with
        the LUT of frame i-1 (frame 0 maps itself); clahe ignores it here
        and streams through :class:`StreamingEnhancer`.
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
    ``plan`` is the CLAHE plan (None for histeq and none).
    """
    h, w = spec.height, spec.width
    ds = int(cfg.hist_downsample)
    if ds > 1 and cfg.use_ref_frame:
        # the ref-frame modes carry exact histograms between frames
        raise ValueError(
            "hist_downsample is not supported with use_ref_frame "
            "(the ref-frame hist carry is exact-only)")

    if cfg.op == "none":
        def copy_y(y, out):
            return out if out is y else out.copy_(y)

        return copy_y, None

    if cfg.op == "histeq":
        # ds > 1: the approximate mode, histograms of every ds-th row with
        # the counts rescaled; the map itself stays exact
        total = -(-h // ds) * w * ds

        def equalize_y(y, out):
            hists = histogram.hist256(y[:, ::ds], cfg.hist_method)
            if ds > 1:
                hists = hists * ds
            if cfg.use_ref_frame:
                # frame i maps with frame i-1's LUT, frame 0 with its own;
                # nothing carries across batches
                hists = torch.cat([hists[:1], hists[:-1]])
            return histeq_ops.equalize_frames(y, hists, total, out=out)

        return equalize_y, None

    # op == "clahe": use_ref_frame is ignored, as in the JAX package
    plan = clahe_ops.make_clahe_plan(h, w, float(cfg.clip_limit),
                                     tuple(cfg.tile_grid))
    if ds > 1 and plan.tile_h % ds:
        raise ValueError(
            f"hist_downsample={ds} must divide the tile height "
            f"({plan.tile_h} for {h}x{w} grid {tuple(cfg.tile_grid)})")

    def enhance_y(y, out):
        return clahe_ops.clahe_apply(y, plan, cfg.hist_method,
                                     hist_rowstep=ds, out=out)

    return enhance_y, plan


def _check_batch(nv12_batch: torch.Tensor, spec: FrameSpec) -> None:
    if (nv12_batch.dtype != torch.uint8 or nv12_batch.ndim != 3
            or tuple(nv12_batch.shape[1:]) != (spec.buffer_rows, spec.width)):
        raise ValueError(
            f"expected uint8 (N, {spec.buffer_rows}, {spec.width}), got "
            f"{nv12_batch.dtype} {tuple(nv12_batch.shape)}")


def build_enhance_fn(cfg: EnhancerConfig, spec: FrameSpec,
                     donate: bool = True):
    """Returns ``fn(nv12_batch: uint8 tensor (N, H*3/2, W)) -> same shape``.

    ``donate=True`` stands in for JAX's buffer donation: the result is
    written into the input tensor.  The last kernel of each op (K3 for
    CLAHE, K4 for histeq) writes the enhanced Y rows in place (each output
    pixel depends only on its own input pixel and the LUTs, which are
    complete before it starts), the PASSTHROUGH chroma rows are never
    touched, and GRAY fills them with 128.
    The caller must not expect the input's old contents after the call.
    ``donate=False`` writes into a new tensor.
    """
    h = spec.height
    enhance_y, _ = make_enhance_y(cfg, spec)

    def fn(nv12_batch: torch.Tensor) -> torch.Tensor:
        _check_batch(nv12_batch, spec)
        out = nv12_batch if donate else torch.empty_like(nv12_batch)
        enhance_y(nv12_batch[:, :h], out[:, :h])
        if cfg.chroma == ChromaPolicy.GRAY:
            out[:, h:].fill_(128)
        elif not donate:
            out[:, h:].copy_(nv12_batch[:, h:])
        return out

    return fn


def initial_hists(plan, device: str | torch.device = "cuda") -> torch.Tensor:
    """Stream-start tile histograms, int32 (T, 256): uniform mass with the
    remainder in bin 0 (an identity-like LUT), the stand-in for the
    previous frame's at the start of a stream."""
    base = plan.tile_area // 256
    hists = torch.full((plan.num_tiles, 256), base, dtype=torch.int32)
    hists[:, 0] += plan.tile_area - base * 256
    return hists.to(device)


def hists_from_jax(hists, device: str | torch.device = "cuda") -> torch.Tensor:
    """The port's streaming state from the JAX ``StreamingEnhancer``'s
    (its ``_hists``, (T, 256) int32, as numpy): the same counts on
    ``device``."""
    arr = np.asarray(hists)
    if arr.ndim != 2 or arr.shape[1] != 256:
        raise ValueError(f"expected (T, 256) histograms, got {arr.shape}")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def build_streaming_clahe_fn(cfg: EnhancerConfig, spec: FrameSpec):
    """Ref-frame streaming CLAHE: ``(fn, plan)`` with ``fn(nv12_batch,
    prev_hists) -> (out_batch, hists)``.

    Frame i is mapped with the tile LUTs built (K2) from frame i-1's
    histograms while frame i's own are counted: one pass of K7 where the
    geometry is tile-divisible, else K1 then K3 (the histogram first,
    since the map overwrites the frame).  ``prev_hists`` and the returned
    ``hists`` are (T, 256) int32 on the batch's device.  The batch is
    written in place, as the JAX package donates it.
    """
    if cfg.hist_downsample != 1:
        raise ValueError(
            "hist_downsample is not supported in the streaming "
            "(ref-frame) mode: its hist carry is exact-only")
    h = spec.height
    plan = clahe_ops.make_clahe_plan(h, spec.width, float(cfg.clip_limit),
                                     tuple(cfg.tile_grid))
    fused = natural.fused_interp_hist_fits(plan)

    def fn(nv12_batch: torch.Tensor, prev_hists: torch.Tensor):
        clahe_ops._check_method(cfg.hist_method)
        _check_batch(nv12_batch, spec)
        hists = prev_hists
        for i in range(nv12_batch.shape[0]):
            frame = nv12_batch[i:i + 1, :h]
            luts = natural.build_luts(hists[None], plan.clip, plan.lut_scale)
            if fused:
                _, new = natural.clahe_interp_and_hist(frame, luts, plan,
                                                       out=frame)
            else:
                new = natural.tile_histograms(frame, plan)
                natural.clahe_interpolate(frame, luts, plan, out=frame)
            hists = new[0]
        if cfg.chroma == ChromaPolicy.GRAY:
            nv12_batch[:, h:].fill_(128)
        return nv12_batch, hists

    return fn, plan


def _to_device(batch, device: torch.device) -> torch.Tensor:
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    # always a copy: the steps write in place, and the caller's buffer
    # (the feeder's recycled staging slot) must stay as it was
    return t.to(device, copy=True)


def _d2h_stream(device: torch.device) -> torch.cuda.Stream | None:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


class StreamingEnhancer:
    """Stateful ref-frame CLAHE stream on ``device``: a drop-in
    ``process_batch`` for the FrameFeeder.  The histogram state carries
    across batches; frame 0 of the stream uses :func:`initial_hists`."""

    def __init__(self, cfg: EnhancerConfig, spec: FrameSpec,
                 device: str | torch.device = "cuda"):
        if cfg.op != "clahe":
            raise ValueError("StreamingEnhancer is the clahe ref-frame mode")
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        self._fn, self._plan = build_streaming_clahe_fn(cfg, spec)
        self._d2h = _d2h_stream(self.device)
        self.reset()

    def process_batch(self, nv12_batch) -> DeviceBatch:
        """uint8 (N, H*3/2, W) -> the enhanced batch, on its way to the host."""
        out, self._hists = self._fn(_to_device(nv12_batch, self.device),
                                    self._hists)
        return DeviceBatch(out, self._d2h)

    def reset(self) -> None:
        self._hists = initial_hists(self._plan, self.device)


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
        self._d2h = _d2h_stream(self.device)

    def process_batch(self, nv12_batch) -> DeviceBatch:
        """uint8 (N, H*3/2, W) -> the enhanced batch, on its way to the host."""
        return DeviceBatch(self._fn(_to_device(nv12_batch, self.device)),
                           self._d2h)

    def process_frame(self, nv12) -> DeviceBatch:
        """Single frame (H*3/2, W) convenience (batch of 1 under the hood)."""
        return DeviceBatch(self._fn(_to_device(nv12, self.device)[None])[0],
                           self._d2h)

    @functools.cached_property
    def compiled_cost(self):
        """The step, after one run on a zero frame on the device (which
        loads the kernels there): the warm-up, as the JAX ``Enhancer``'s
        ``compiled_cost`` compiles its program.  It takes a uint8 (N,
        H*3/2, W) tensor on the device and writes the result into it."""
        self._fn(torch.zeros((1, self.spec.buffer_rows, self.spec.width),
                             dtype=torch.uint8, device=self.device))
        return self._fn
