"""K1-K3's share of their roofline, %: the least time the card could
take for the traced frames over K1-K3's device time.

In the encoding cells (moves ``encoded_frames_per_s``)."""

from gpubench.metrics import natural_roofline


def read(ctx):
    return natural_roofline(ctx)
