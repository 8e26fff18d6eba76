"""Frame layouts and the numpy golden models: the port's own copies of
``opencv_opencl_tpu/core/frames.py`` and ``core/golden.py``."""

from opencv_opencl_tpu_torch.core.frames import (
    ChromaPolicy,
    FrameFormat,
    FrameSpec,
    join_nv12,
    nv12_size,
    nv12_uv,
    nv12_y,
    split_nv12,
)

__all__ = [
    "ChromaPolicy",
    "FrameFormat",
    "FrameSpec",
    "join_nv12",
    "nv12_size",
    "nv12_uv",
    "nv12_y",
    "split_nv12",
]
