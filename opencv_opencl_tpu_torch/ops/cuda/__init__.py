"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version
(counterpart of ``opencv_opencl_tpu.ops.pallas``): K1-K3, K5 (with K3v1),
K7 and K10 in ``natural``, K4, K6 (with K9), K6r and K8 in ``lut``; and the H.264 device encoder's kernels (counterparts of
XLA programs of ``opencv_opencl_tpu.ops.h264_levels`` and
``.h264_deblock``): H1 and H2, the intra and P level kernels, in
``h264_levels``, H3 and H4, the sub-pel planes and the motion search, in
``h264_inter`` with H6, the partition search, H5, the deblocking filter,
in ``h264_deblock``, and H7 and H8, the CAVLC bit packers of the intra and
P frames (counterparts of ``.h264_bitpack``), in ``h264_bitpack``."""

from opencv_opencl_tpu_torch.ops.cuda import (
    h264_bitpack, h264_deblock, h264_inter, h264_levels, lut, natural)

_MODULES = (natural, lut, h264_levels, h264_inter, h264_deblock, h264_bitpack)

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches by wrapper name since the last reset, every kernel."""
    counts: dict[str, int] = {}
    for module in _MODULES:
        counts.update(module.launch_counts())
    return counts


def reset_launch_counts() -> None:
    for module in _MODULES:
        module.reset_launch_counts()
