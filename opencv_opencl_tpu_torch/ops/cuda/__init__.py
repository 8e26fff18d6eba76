"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version
(counterpart of ``opencv_opencl_tpu.ops.pallas``): K1-K3, K5 (with K3v1),
K7 and K10 in ``natural``, K4, K6 (with K9), K6r and K8 in ``lut``."""

from opencv_opencl_tpu_torch.ops.cuda import lut, natural

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches by wrapper name since the last reset, every kernel."""
    return {**natural.launch_counts(), **lut.launch_counts()}


def reset_launch_counts() -> None:
    natural.reset_launch_counts()
    lut.reset_launch_counts()
