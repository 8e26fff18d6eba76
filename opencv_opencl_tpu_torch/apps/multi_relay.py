"""Multi-stream relay: N independent streams served by ONE card.

Counterpart of ``opencv_opencl_tpu/apps/multi_relay.py`` on the port's
``Enhancer``, ``ShardedEnhancer`` and ``StreamMux``.

Usage:
  python -m opencv_opencl_tpu_torch.apps.multi_relay --streams=4
      [--width=1920 --height=1080 --fps=30] [--op=clahe|histeq]
      [--chroma=gray|passthrough] [--clipLimit=2.0] [--tile=8]
      [--batch=4] [--workers=2] [--max-frames=N] [--duration=s]
      [--source=test|<video file>]      # one source replicated per stream
      [--sink=null|rtp://host:port|rtp+raw://host:port]
                         # rtp: stream i goes to port+2*i
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

Not ported yet, refused with return code 2: the ``rtp+h264://`` and
``rtp+h265://`` sinks; ``--encoder`` is read only for an encoded sink, as
in the JAX package, and ignored otherwise.  ``--mesh`` takes a
mesh of one position (``1x1`` or ``auto``) here: the mux cuts batches by
arrival, which several ranks would not do alike.
"""

from __future__ import annotations

import sys
import time

import contextlib

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args)
from opencv_opencl_tpu_torch.apps.relay import (
    group_rank_and_size, mesh_for_app, not_ported, resolve_device)


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
    refusal = not_ported(opts, opts.get("sink", "null"))
    if refusal is not None:
        print(refusal, file=sys.stderr)
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
        print(str(e), file=sys.stderr)
        return 2
    if cfg.hist_downsample > 1:
        if "mesh" in opts:
            print("--hist-downsample is not supported with --mesh "
                  "(the sharded path is exact-only)", file=sys.stderr)
            return 2
        print(f"APPROXIMATE histogram mode: every "
              f"{cfg.hist_downsample}th row (not bit-exact vs cv2)")
    if "mesh" in opts:
        # several cards: the stream batch shards over the mesh's data axis
        # (whole frames per card), rows over space, behind the same
        # StreamMux front
        from opencv_opencl_tpu_torch.parallel.sharded import ShardedEnhancer

        if group_rank_and_size()[1] > 1:
            print("--mesh in a process group of several ranks is not "
                  "supported here: the mux cuts batches by arrival",
                  file=sys.stderr)
            return 2
        try:
            mesh = mesh_for_app(opts["mesh"], device, stack)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        enhancer = ShardedEnhancer(cfg, spec, mesh=mesh, device=device)
        ndata, nspace = enhancer.part.ndata, enhancer.part.nspace
        batch = opts.get("batch", 4)
        if batch < 1 or batch % ndata:
            print(f"--batch={batch} must be a positive multiple of the "
                  f"mesh data axis ({ndata})", file=sys.stderr)
            return 2
        print(f"Sharded over mesh {{'data': {ndata}, 'space': {nspace}}} "
              f"({ndata * nspace} devices)")
    else:
        try:
            enhancer = Enhancer(cfg, spec, device)
        except ValueError as e:  # e.g. hist-downsample vs tile height
            print(str(e), file=sys.stderr)
            return 2

    sinks = []
    if sink_spec.startswith(("rtp://", "rtp+raw://")):
        from opencv_opencl_tpu_torch.io.rtp import RtpUdpSink

        kind = "raw" if sink_spec.startswith("rtp+raw://") else "jpeg"
        scheme = sink_spec.split("://", 1)[0]
        host, port = sink_spec.split("://", 1)[1].rsplit(":", 1)
        for s in range(n):
            sinks.append(RtpUdpSink(
                host, int(port) + 2 * s, kind=kind, fps=fps,
                rtcp_schedule=opts.get("rtcp-schedule", "tick")))
        print(f"Sinks: {scheme}://{host}:{port}..{int(port) + 2 * (n - 1)} "
              f"(stride 2: RTCP companions)")
    else:
        sinks = [NullSink() for _ in range(n)]
    for snk in sinks:
        stack.callback(snk.close)

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
            print(f"--priorities={opts['priorities']!r} invalid: "
                  f"comma-separated ints", file=sys.stderr)
            return 2
        if len(priorities) != n:
            print(f"--priorities needs {n} entries (one per stream)",
                  file=sys.stderr)
            return 2
    mux = StreamMux(enhancer.process_batch, n, on_output=on_out,
                    priorities=priorities,
                    batch_size=opts.get("batch", 4),
                    depth=opts.get("workers", 2),
                    queue_capacity=max(8, 4 * n),
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

    print(f"Serving {n} streams of {width}x{height} {op} on one card "
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
                print(f"[status] rounds={k} emitted={st['emitted']} "
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
        print("\nInterrupted.")
    mux.stop(drain=True)
    stack.close()  # the sinks, and the mesh's process group
    wall = time.monotonic() - t0
    st = mux.stats
    print(f"\nShutdown: {st['emitted']} frames across {n} streams in "
          f"{wall:.2f}s ({st['emitted'] / wall if wall > 0 else 0:.1f} fps "
          f"aggregate); per-stream: "
          + ", ".join(
              f"#{i}={p['emitted']}/{p['submitted']}"
              + (f" (dropped {p['dropped']})" if p["dropped"] else "")
              for i, p in enumerate(st["per_stream"])))
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
