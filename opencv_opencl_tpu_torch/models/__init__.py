"""The NV12 enhancement pipeline (counterpart of ``opencv_opencl_tpu.models``)."""
