"""Device ms a frame of H1-H5 (``ops/cuda/h264_levels``, ``h264_inter``,
``h264_deblock``: the level grids, ``subpel_planes_kernel``,
``motion_search_kernel``, ``deblock_bs_kernel``, ``deblock_kernel``) in the
traced window."""

from gpubench.metrics import H264


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    t = ctx.trace.device_time(H264)
    return 1e3 * t / ctx.traced["frames"] if t > 0 else None
