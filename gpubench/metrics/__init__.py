"""One reader a per-layer metric: ``<metric>.py`` defines ``read(ctx)``,
which returns the metric's value, or None where the run gave it nothing to
read (the harness then leaves the metric out of the line).  ``ctx`` is
``run.Context``: the traced window's ``trace`` (``trace.DeviceTrace``), the
frames and steps issued under it (``traced``), the untraced steps' host
records (``host``) and the ``system``.

A quantity that cells with different end-to-end metrics report is one
metric a group (``<name>`` for ``frames_per_s``, ``<name>.encode`` for
``encoded_frames_per_s``); the arithmetic they share is here."""

from gpubench import yardstick

# the port's kernels by layer, matched on the short kernel name
NATURAL = r"^(tile_hist_kernel|build_luts_kernel|interp_kernel)(<|$)"
H264 = (r"^(levels_split_kernel|levels_chain_kernel|levels_intra_kernel|"
        r"intra_levels_kernel|subpel_planes_kernel|motion_search_kernel|"
        r"deblock_bs_kernel|deblock_kernel)(<|$)")
# a percentile of the steps' latency needs ten steps beyond it
LATENCY_PCT = 99
LATENCY_MIN_STEPS = 1000


def natural_ms_per_frame(ctx):
    """Device ms a frame of K1-K3 in the traced window."""
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    t = ctx.trace.device_time(NATURAL)
    return 1e3 * t / ctx.traced["frames"] if t > 0 else None


def natural_roofline(ctx):
    """K1-K3's share of their roofline, %: the least time the card could
    take for the traced frames over K1-K3's device time."""
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    t = ctx.trace.device_time(NATURAL)
    if t <= 0:
        return None
    s = ctx.system
    return 100.0 * ctx.traced["frames"] * yardstick.clahe_frame_bound(
        s.height, s.width, s.tiles) / t


def idle_pct(ctx):
    """The share of the traced window, %, with nothing running on the card."""
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def latency_ms(ctx):
    """The 99th percentile by nearest rank of the untraced steps' latency,
    from the call into the port's step to the moment the host saw its
    output complete, in ms."""
    lat = [r.done_s - r.issued_s for r in ctx.host]
    if len(lat) < LATENCY_MIN_STEPS:
        return None
    return 1e3 * yardstick.nearest_rank(lat, LATENCY_PCT)
