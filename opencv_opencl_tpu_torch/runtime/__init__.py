"""The port's runtime: the frame feeder, leaky queues and resequencer (its
own copies of ``opencv_opencl_tpu/runtime``), and the device-to-host
handoff that the feeder materialises."""

from opencv_opencl_tpu_torch.runtime.feeder import FrameFeeder
from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch
from opencv_opencl_tpu_torch.runtime.queues import Closed, LeakyQueue
from opencv_opencl_tpu_torch.runtime.sequencer import Resequencer

__all__ = ["FrameFeeder", "DeviceBatch", "Closed", "LeakyQueue", "Resequencer"]
