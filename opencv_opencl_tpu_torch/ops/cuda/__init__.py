"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version
(counterpart of ``opencv_opencl_tpu.ops.pallas``)."""
