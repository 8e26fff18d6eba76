"""The share of the traced window, %, with nothing running on the card.

In the encoding cells (moves ``encoded_frames_per_s``)."""

from gpubench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
