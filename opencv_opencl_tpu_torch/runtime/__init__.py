"""Runtime glue between the port and the shared ``opencv_opencl_tpu.runtime``."""

from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch

__all__ = ["DeviceBatch"]
