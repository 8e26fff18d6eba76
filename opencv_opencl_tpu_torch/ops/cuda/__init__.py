"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version
(counterpart of ``opencv_opencl_tpu.ops.pallas``): K1-K3, K5 (with K3v1),
K7 and K10 in ``natural``, K4, K6 (with K9), K6r and K8 in ``lut``; and H1,
the H.264 intra level kernel (counterpart of the XLA scan of
``opencv_opencl_tpu.ops.h264_levels``), in ``h264_levels``."""

from opencv_opencl_tpu_torch.ops.cuda import h264_levels, lut, natural

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches by wrapper name since the last reset, every kernel."""
    return {**natural.launch_counts(), **lut.launch_counts(),
            **h264_levels.launch_counts()}


def reset_launch_counts() -> None:
    natural.reset_launch_counts()
    lut.reset_launch_counts()
    h264_levels.reset_launch_counts()
