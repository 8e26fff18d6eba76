"""Streaming counters and timing: the port's own copies of
``opencv_opencl_tpu/metrics/counters.py`` and ``metrics/timing.py``."""

from opencv_opencl_tpu_torch.metrics.counters import (
    FrameRateCounters,
    StatusReporter,
    classify_status,
)
from opencv_opencl_tpu_torch.metrics.timing import Span, TimingStats

__all__ = [
    "FrameRateCounters",
    "StatusReporter",
    "classify_status",
    "Span",
    "TimingStats",
]
