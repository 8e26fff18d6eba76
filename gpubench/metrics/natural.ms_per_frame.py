"""Device ms a frame of K1-K3 in the traced window.

In the CLAHE cells (moves ``frames_per_s``)."""

from gpubench.metrics import natural_ms_per_frame


def read(ctx):
    return natural_ms_per_frame(ctx)
