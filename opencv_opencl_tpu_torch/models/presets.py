"""Named pipeline presets — one per reference program/binary.

Each preset bundles the exact defaults of its reference counterpart
(resolution, rate, op, chroma policy, encoder settings) so a reference user
can run the equivalent pipeline by name:

    >>> from opencv_opencl_tpu_torch.models.presets import PRESETS, build
    >>> enhancer, spec, enc = build("histequalize")             # on the card
    >>> enhancer, spec, enc = build("histequalize", device="cpu")

The mapping mirrors SURVEY §2 / the appendix file-to-binary table.
Counterpart of ``opencv_opencl_tpu/models/presets.py`` over the port's
``Enhancer``, ``EnhancerConfig`` and ``FrameSpec``: the same presets with the
same values.
"""

from __future__ import annotations

import dataclasses

import torch

from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.io.gst import EncoderConfig
from opencv_opencl_tpu_torch.models.enhancer import Enhancer, EnhancerConfig

__all__ = ["Preset", "PRESETS", "build"]


@dataclasses.dataclass(frozen=True)
class Preset:
    """A reference program's configuration, on this side."""

    reference: str            # source file / binary it mirrors
    description: str
    width: int
    height: int
    fps: float
    enhancer: EnhancerConfig
    encoder: EncoderConfig
    tuned_emit: bool = False  # the `improvement` ELF pipeline deltas


PRESETS: dict[str, Preset] = {
    # OpenCVequalHist.cpp / `histequalize` ELF: live 1080p60 relay,
    # equalizeHist, UV=128 (OpenCVequalHist.cpp:262-266)
    "histequalize": Preset(
        reference="OpenCVequalHist.cpp",
        description="live relay, global equalizeHist, gray chroma",
        width=1920, height=1080, fps=60,
        enhancer=EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY),
        encoder=EncoderConfig(codec="h264", bitrate_kbps=20000),
    ),
    # ColoropenCVCwqualHist.cpp / improvement.cpp / `COLOR`/`sei` ELFs:
    # color-preserving variant (UV passthrough)
    "color": Preset(
        reference="ColoropenCVCwqualHist.cpp / improvement.cpp",
        description="live relay, equalizeHist, color preserved",
        width=1920, height=1080, fps=60,
        enhancer=EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH),
        encoder=EncoderConfig(codec="h264", bitrate_kbps=20000),
    ),
    # nextimprovement.cpp / `NEXT` ELF: zero-copy variant — behaviourally
    # the color preset (the zero-copy part is the architecture here)
    "next": Preset(
        reference="nextimprovement.cpp",
        description="zero-copy equalizeHist relay (fused NV12 step)",
        width=1920, height=1080, fps=60,
        enhancer=EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH),
        encoder=EncoderConfig(codec="h264", bitrate_kbps=20000),
    ),
    # OpenCLequalHist.cpp: FPGA-offload relay — here the card *is* the
    # accelerator; two-input ref-frame hook retained
    "opencl": Preset(
        reference="OpenCLequalHist.cpp + accel.cpp",
        description="accelerator-offload equalizeHist relay",
        width=1920, height=1080, fps=60,
        enhancer=EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY),
        encoder=EncoderConfig(codec="h264", bitrate_kbps=20000),
    ),
    # `improvement` ELF (binary-only): frame re-ordering + tuned emit
    "improvement": Preset(
        reference="`improvement` ELF (binary-only)",
        description="relay with frame ordering + tuned RTP emit",
        width=1920, height=1080, fps=60,
        enhancer=EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH),
        encoder=EncoderConfig(codec="h264", bitrate_kbps=20000),
        tuned_emit=True,
    ),
    # `IMP` ELF (binary-only): 4K-optimized CLAHE-capable relay
    "imp": Preset(
        reference="`IMP` ELF (binary-only)",
        description="4K-optimized CLAHE relay with frame ordering",
        width=3840, height=2160, fps=60,
        enhancer=EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                                chroma=ChromaPolicy.PASSTHROUGH),
        encoder=EncoderConfig(codec="h265", bitrate_kbps=25000),
        tuned_emit=True,
    ),
    # CLAHECompare.cpp: file-based CLAHE relay defaults (:287-297)
    "clahecompare": Preset(
        reference="CLAHECompare.cpp",
        description="file CLAHE relay (720p30, clip 2.0, 8x8)",
        width=1280, height=720, fps=30,
        enhancer=EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                                chroma=ChromaPolicy.PASSTHROUGH),
        encoder=EncoderConfig(codec="h264", bitrate_kbps=25000),
    ),
    # AirplanMP4.cpp: MP4 equalizeHist relay (UV=128)
    "airplanmp4": Preset(
        reference="AirplanMP4.cpp",
        description="MP4 equalizeHist relay, gray chroma",
        width=1280, height=720, fps=30,
        enhancer=EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY),
        encoder=EncoderConfig(codec="h264", bitrate_kbps=10000),
    ),
}


def build(name: str, device: str | torch.device = "cuda"
          ) -> tuple[Enhancer, FrameSpec, EncoderConfig]:
    """Instantiate a preset on ``device``: (enhancer, frame spec, encoder
    config)."""
    p = PRESETS[name]
    spec = FrameSpec(width=p.width, height=p.height, fps=p.fps)
    return Enhancer(p.enhancer, spec, device), spec, p.encoder
