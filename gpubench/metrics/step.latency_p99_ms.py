"""The 99th percentile by nearest rank of the untraced steps' latency,
from the call into the port's step to the moment the host saw its
output complete, in ms.

In the CLAHE cells (moves ``frames_per_s``)."""

from gpubench.metrics import latency_ms


def read(ctx):
    return latency_ms(ctx)
