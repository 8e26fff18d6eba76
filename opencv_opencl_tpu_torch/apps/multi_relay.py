"""Multi-stream relay: N independent streams served by ONE card.

Counterpart of ``opencv_opencl_tpu/apps/multi_relay.py`` on the port's
``Enhancer``, ``ShardedEnhancer`` and ``StreamMux``.

Usage:
  python -m opencv_opencl_tpu_torch.apps.multi_relay --streams=4
      [--width=1920 --height=1080 --fps=30] [--op=clahe|histeq]
      [--chroma=gray|passthrough] [--clipLimit=2.0] [--tile=8]
      [--batch=4] [--workers=2] [--max-frames=N] [--duration=s]
      [--source=test|<video file>]      # one source replicated per stream
      [--sink=null|rtp://host:port|rtp+raw://host:port|rtp+h264://host:port|rtp+h265://host:port]
                         # rtp: stream i goes to port+2*i
      [--encoder=auto|pcm|cavlc[:...]|tpu[:...]|ffmpeg|gi]  # for rtp+h26x sinks:
                         # one encoder + RTP session per stream
      [--status-interval=2]
      [--mesh=auto|DxS]  # several cards: shard the stream batch over a
                         # (data, space) mesh of processes (see relay)
      [--adaptive-rate [--max-rate=FPS]]  # per-stream AIMD on each RTP
                         # session's RTCP loss: a congested viewer sheds
                         # only its own frames
      [--priorities=2,1,...]  # per-stream QoS classes (higher = more
                         # important): overload evicts the lowest class
                         # first, so premium streams survive congestion
      [--hist-downsample=N]  # APPROXIMATE fast-histogram mode (see relay)
      [--native]         # GIL-free C++ staging ring; composes with
                         # --priorities (fp_ring_push_prio evicts the
                         # lowest class and reports whose frame it was,
                         # keeping per-stream drop accounting truthful)
      [--device=cuda|cpu]  # the step runs on the card; ``cpu`` is for tests

The serving extension of ``relay``: one card enhances frames faster than one
stream delivers them, so production packs many streams per card.  Frames
from all streams share device batches via ``runtime/mux.StreamMux``; outputs
route back per stream in order.  The reference cannot do this at all — its
OpenCL context is process-exclusive (``OpenCLequalHist.cpp:106-140``) and
each relay binary owns one stream.

RTP port spacing is 2 per stream because each RTP session's RTCP rides
its companion port (port+1, io/rtcp.py).

The device encoders (``--encoder=tpu[:i4][:chromah][:overlap][:bitpack]``,
``CudaCavlcEncoder``, and with ``gop=N`` or ``gdr=N`` ``CudaGopEncoder``,
with ``:parts`` too, one per stream) run on ``--device``.  ``--encoder``
is read only for an encoded sink, as in the JAX package, and ignored
otherwise.

``--mesh``: with no process group, ``1x1`` (and ``auto``) starts a one-rank
group, as in the relay.  Inside a group started by
``parallel/launch.run_on_mesh`` (rank function ``launch.run_multi_relay``)
every rank runs :func:`run` with the same arguments and reads the same
sources; rank 0 alone opens the sinks and prints, and its verdict on their
flags reaches every rank before any collective (``relay.lead_verdict``).
The mux then cuts whole batches whatever the timing, and the rounds wait
for room in the queue where one process would drop the oldest frame: every
rank makes the same collective calls, and every stream emits every frame
it submitted.  ``--duration``, ``--max-rate`` and ``--adaptive-rate`` are
refused there, on every rank.  Where the JAX package shards one process's
batch over its devices and drops under overload, a group never drops.
"""

from __future__ import annotations

import sys
import time

import contextlib

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args, resolve_device)
from opencv_opencl_tpu_torch.apps.relay import (
    group_rank_and_size, lead_verdict, mesh_for_app, timed_flags_refusal)


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {
            "streams": int, "width": int, "height": int, "fps": float,
            "op": str, "chroma": str, "clipLimit": float, "tile": int,
            "batch": int, "workers": int, "max-frames": int,
            "duration": float, "source": str, "sink": str,
            "status-interval": float, "rtcp-schedule": str, "mesh": str,
            "adaptive-rate": bool, "max-rate": float, "priorities": str,
            "native": bool, "encoder": str, "hist-downsample": int,
            "device": str,
        },
    )
    if "max-rate" in opts and opts["max-rate"] <= 0:
        print("--max-rate must be > 0", file=sys.stderr)
        return 2
    with contextlib.ExitStack() as stack:
        return _run(opts, stack)


def _run(opts: dict, stack: contextlib.ExitStack) -> int:
    n = opts.get("streams", 2)
    width = opts.get("width", 1920)
    height = opts.get("height", 1080)
    fps = opts.get("fps", 30.0)
    op = opts.get("op", "clahe")
    max_frames = opts.get("max-frames")
    duration = opts.get("duration")
    sink_spec = opts.get("sink", "null")
    interval = opts.get("status-interval", 2.0)

    device = resolve_device(opts.get("device", "cuda"))
    if device is None:
        return 1

    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.io.videofile import FileSource, NullSink, TestSource
    from opencv_opencl_tpu_torch.models.enhancer import Enhancer, EnhancerConfig
    from opencv_opencl_tpu_torch.runtime.mux import StreamMux

    # in a process group every rank serves the streams; rank 0 alone owns
    # the sinks and prints
    rank, world = group_rank_and_size() if "mesh" in opts else (0, 1)
    lead = rank == 0
    say = print if lead else (lambda *args, **kwargs: None)
    refusal = timed_flags_refusal(opts, world)
    if refusal:
        say(refusal, file=sys.stderr)
        return 2

    spec = FrameSpec(width=width, height=height, fps=fps)
    chroma = (ChromaPolicy.GRAY if opts.get("chroma", "").lower() == "gray"
              else ChromaPolicy.PASSTHROUGH)
    try:
        cfg = EnhancerConfig(
            op=op, clip_limit=opts.get("clipLimit", 2.0),
            tile_grid=(opts.get("tile", 8),) * 2, chroma=chroma,
            hist_downsample=opts.get("hist-downsample", 1),
        )
    except ValueError as e:
        say(str(e), file=sys.stderr)
        return 2
    if cfg.hist_downsample > 1:
        if "mesh" in opts:
            say("--hist-downsample is not supported with --mesh "
                "(the sharded path is exact-only)", file=sys.stderr)
            return 2
        print(f"APPROXIMATE histogram mode: every "
              f"{cfg.hist_downsample}th row (not bit-exact vs cv2)")

    # rank 0 owns the sinks; the other ranks get rank 0's verdict on their
    # flags before any collective
    sinks, rc = lead_verdict(lead, world, device,
                             lambda: _open_sinks(sink_spec, opts, spec, n, fps, device))
    if rc:
        return rc
    if not lead:
        sinks = [NullSink() for _ in range(n)]
    for snk in sinks:
        stack.callback(snk.close)

    if "mesh" in opts:
        # several cards: the stream batch shards over the mesh's data axis
        # (whole frames per card), rows over space, behind the same
        # StreamMux front
        from opencv_opencl_tpu_torch.parallel.sharded import ShardedEnhancer

        try:
            mesh = mesh_for_app(opts["mesh"], device, stack)
        except ValueError as e:
            say(str(e), file=sys.stderr)
            return 2
        enhancer = ShardedEnhancer(cfg, spec, mesh=mesh, device=device)
        ndata, nspace = enhancer.part.ndata, enhancer.part.nspace
        batch = opts.get("batch", 4)
        if batch < 1 or batch % ndata:
            say(f"--batch={batch} must be a positive multiple of the "
                f"mesh data axis ({ndata})", file=sys.stderr)
            return 2
        say(f"Sharded over mesh {{'data': {ndata}, 'space': {nspace}}} "
            f"({ndata * nspace} devices)")
    else:
        try:
            enhancer = Enhancer(cfg, spec, device)
        except ValueError as e:  # e.g. hist-downsample vs tile height
            print(str(e), file=sys.stderr)
            return 2

    governors = None
    adaptive = opts.get("adaptive-rate", False)
    if adaptive:
        # per-stream congestion control: each stream's RTCP receiver
        # reports drive its own AIMD loop, so one congested viewer sheds
        # only its own frames — the other streams keep their full rate.
        # Default ceiling 10% above the pacing rate (slot-grid resonance
        # with an exactly-at-fps submit cadence would shed clean frames).
        from opencv_opencl_tpu_torch.runtime.governor import (
            AdaptiveRateGovernor, feed_governor_from_rtcp)

        rate_cap = opts.get("max-rate", (fps or 30.0) * 1.1)
        governors = [AdaptiveRateGovernor(rate_cap) for _ in range(n)]
    elif "max-rate" in opts:
        # static per-stream cap, like relay --max-rate (drop-only)
        from opencv_opencl_tpu_torch.runtime.governor import RateGovernor

        governors = [RateGovernor(opts["max-rate"]) for _ in range(n)]

    def on_out(stream, sseq, frame, meta):
        sinks[stream].write(frame)

    priorities = None
    if "priorities" in opts:
        try:
            priorities = [int(x) for x in opts["priorities"].split(",")]
        except ValueError:
            say(f"--priorities={opts['priorities']!r} invalid: "
                f"comma-separated ints", file=sys.stderr)
            return 2
        if len(priorities) != n:
            say(f"--priorities needs {n} entries (one per stream)",
                file=sys.stderr)
            return 2
    queue_capacity = max(8, 4 * n)
    mux = StreamMux(enhancer.process_batch, n, on_output=on_out,
                    priorities=priorities,
                    batch_size=opts.get("batch", 4),
                    depth=opts.get("workers", 2),
                    queue_capacity=queue_capacity,
                    # several ranks: the same batches on every rank,
                    # whatever the timing
                    whole_batches=world > 1,
                    native_staging=((spec.buffer_rows, spec.width)
                                    if opts.get("native") else False))
    src_path = opts.get("source", "test")
    sources = []
    for s in range(n):
        if src_path == "test":
            sources.append(iter(TestSource(spec)))
        else:
            sources.append(iter(FileSource(src_path, width=width,
                                           height=height, loop=True)))

    say(f"Serving {n} streams of {width}x{height} {op} on one card "
        f"(batch={opts.get('batch', 4)}, depth={opts.get('workers', 2)})")
    mux.start()
    t0 = time.monotonic()
    last_tick = t0
    k = 0
    period = 1.0 / fps if fps > 0 else 0.0
    try:
        while True:
            if max_frames is not None and k >= max_frames:
                break
            if duration is not None and time.monotonic() - t0 > duration:
                break
            for s in range(n):
                if governors is not None:
                    if adaptive:
                        feed_governor_from_rtcp(governors[s], sinks[s],
                                                label=f" stream {s}")
                    if not governors[s].admit():
                        continue  # shed THIS stream's frame only
                while world > 1 and mux.feeder.queue_length() >= queue_capacity:
                    time.sleep(0.001)  # no leaky drop: it would differ by rank
                try:
                    mux.submit(s, next(sources[s]))
                except StopIteration:
                    sources[s] = iter(TestSource(spec))
                    mux.submit(s, next(sources[s]))
            k += 1
            now = time.monotonic()
            if now - last_tick >= interval:
                st = mux.stats
                agg_fps = st["emitted"] / (now - t0)
                say(f"[status] rounds={k} emitted={st['emitted']} "
                    f"({agg_fps:.1f} fps aggregate, "
                    f"{agg_fps / n:.1f}/stream) "
                    f"dropped(late)={st['dropped_late']} "
                    f"errors={st['processing_errors']}")
                last_tick = now
            next_t = t0 + k * period
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
    except KeyboardInterrupt:
        say("\nInterrupted.")
    mux.stop(drain=True)
    stack.close()  # the sinks, and the mesh's process group
    wall = time.monotonic() - t0
    st = mux.stats
    say(f"\nShutdown: {st['emitted']} frames across {n} streams in "
        f"{wall:.2f}s ({st['emitted'] / wall if wall > 0 else 0:.1f} fps "
        f"aggregate); per-stream: "
        + ", ".join(
            f"#{i}={p['emitted']}/{p['submitted']}"
            + (f" (dropped {p['dropped']})" if p["dropped"] else "")
            for i, p in enumerate(st["per_stream"])))
    return 0


def _open_sinks(sink_spec: str, opts: dict, spec, n: int, fps: float, device):
    """Rank 0's ``n`` sinks of ``--sink``, stream ``i`` at port + 2i:
    ``(sinks, 0)``, or ``(None, 2)`` where their flags are refused (the
    refusal printed)."""
    from opencv_opencl_tpu_torch.io.videofile import NullSink

    schedule = opts.get("rtcp-schedule", "tick")
    sinks = []
    if sink_spec.startswith(("rtp://", "rtp+raw://")):
        from opencv_opencl_tpu_torch.io.rtp import RtpUdpSink

        if schedule not in ("tick", "rfc3550"):
            print(f"--rtcp-schedule={schedule!r} invalid: tick|rfc3550",
                  file=sys.stderr)
            return None, 2
        kind = "raw" if sink_spec.startswith("rtp+raw://") else "jpeg"
        scheme = sink_spec.split("://", 1)[0]
        host, port = sink_spec.split("://", 1)[1].rsplit(":", 1)
        for s in range(n):
            sinks.append(RtpUdpSink(host, int(port) + 2 * s, kind=kind, fps=fps,
                                    rtcp_schedule=schedule))
        print(f"Sinks: {scheme}://{host}:{port}..{int(port) + 2 * (n - 1)} "
              f"(stride 2: RTCP companions)")
    elif sink_spec.startswith(("rtp+h264://", "rtp+h265://")):
        # encoded emit per stream (OpenCVequalHist.cpp:308-332 chain),
        # one encoder + RTP session per stream, same 2-port stride
        from opencv_opencl_tpu_torch.io.encoder import encoded_rtp_sink_from_url

        try:
            for s in range(n):
                sinks.append(encoded_rtp_sink_from_url(
                    sink_spec, spec.width, spec.height, fps=fps,
                    backend=opts.get("encoder", "auto"),
                    rtcp_schedule=schedule, port_offset=2 * s, device=device))
        except ValueError as e:
            for snk in sinks:
                snk.close()
            print(str(e), file=sys.stderr)
            return None, 2
        print(f"Sinks: encoded RTP {sink_spec} .. +{2 * (n - 1)} "
              f"(encoder={type(sinks[0].encoder).__name__})")
    else:
        sinks = [NullSink() for _ in range(n)]
    return sinks, 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
