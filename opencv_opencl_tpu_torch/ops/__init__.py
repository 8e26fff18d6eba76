"""Enhancement ops on PyTorch tensors (counterpart of ``opencv_opencl_tpu.ops``)."""
