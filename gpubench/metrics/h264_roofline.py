"""H1-H5's share of their roofline, %: the least time the card could take
for the traced IDR and P frames (``yardstick.idr_frame_bound``,
``yardstick.p_frame_bound``: counted from the shapes and the search's
candidates, whatever kernel computes them) over H1-H5's device time."""

from gpubench import yardstick
from gpubench.metrics import H264


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    t = ctx.trace.device_time(H264)
    s = ctx.system
    if t <= 0 or not hasattr(s, "gop"):
        return None
    least = (ctx.traced["idr_frames"] * yardstick.idr_frame_bound(s.height, s.width, s.deblock)
             + ctx.traced["p_frames"] * yardstick.p_frame_bound(
                 s.height, s.width, s.search, s.subpel, s.deblock))
    return 100.0 * least / t
