"""Live relay (<- reference ``OpenCVequalHist.cpp`` family + ``OpenCLequalHist.cpp``).

Counterpart of ``opencv_opencl_tpu/apps/relay.py`` on the port's
``Enhancer``, ``StreamingEnhancer``, ``ShardedEnhancer``, ``FrameFeeder``
and ``StatusReporter``: the same flags, the same printed lines, the same
refusals with the same messages and return code 2.

Usage:
  python -m opencv_opencl_tpu_torch.apps.relay [--codec=h264|h265] [--bitrate=20000]
      [--workers=2] [--width=1920] [--height=1080] [--fps=60]
      [--op=histeq|clahe|none] [--chroma=gray|passthrough]
      [--clipLimit=2.0] [--tile=8] [--batch=4]
      [--source=test|<video file>] [--sink=null|<output file>]
                   # sinks also accept rtp://host:port (JPEG/RTP) and
                   # rtp+raw://host:port (raw NV12 lines); *.nv12 / *.raw
                   # files take the raw frames
      [--hist-downsample=N]  # APPROXIMATE throughput mode: histograms
                   # from every Nth row, counts rescaled (selective
                   # downsampling, arXiv:1709.04583); default 1 = exact
      [--duration=seconds] [--max-frames=N] [--status-interval=2]
      [--ref-frame]  # clahe: LUTs from the previous frame (latency
                     # hiding; one fused map + histogram kernel per frame)
      [--max-rate=N] [--adaptive-rate]  # static videorate cap, or an
                     # RTCP-loss-driven AIMD rate loop (native RTP sinks)
      [--rtcp-schedule=tick|rfc3550]  # fixed 2-s SR cadence (reference
                     # semantics) or the RFC 3550 interval algorithm
      [--mesh=auto|DxS]  # several cards: shard the batch over a (data,
                     # space) mesh of processes; batch must be a multiple
                     # of D.  Takes precedence over --ref-frame (the
                     # sharded path is stateless).
      [--preset=<name>]  # defaults of a reference program (models/presets)
      [--device=cuda|cpu]  # the step runs on the card; ``cpu`` (the plain
                     # PyTorch versions of the kernels) exists for the tests

The relay runs on the card: without ``--device=cpu`` and without a CUDA
card it fails, it does not carry on on the CPU.

``--mesh``: the port's meshes take one process per position
(``parallel/mesh.py``).  With no process group, ``1x1`` (and ``auto``) starts
a one-rank group itself.  Inside a group started by
``parallel/launch.run_on_mesh`` every rank calls :func:`run` with the same
arguments and reads the same source; only rank 0 owns the sink and prints.
The frames are then cut into whole batches whatever the timing, so that
every rank makes the same collective calls; the time-driven flags
(``--duration``, ``--max-rate``, ``--adaptive-rate``) are refused there.

``--native`` stages the frames through the C++ ring of the port's
``native`` package (built with g++ at first use; where it cannot be built
the Python queue takes over, as in the JAX package, and the started line
says ``staging=python queue``).  It composes with ``--mesh``: the ring too
gives the feeder whole batches only.

Not ported yet, refused with return code 2: the ``rtp+h264://`` and
``rtp+h265://`` sinks, ``--fused-encode`` (the H.264 device encoder) and
``--io=gst``.  ``--encoder`` is read only for an encoded sink, as in the
JAX package: with any other sink it is ignored.

Defaults mirror the reference live relay (1920x1080 @ 60, h264, 20 Mbps,
2 workers: ``OpenCVequalHist.cpp:262-266``).  The worker pool + GAsyncQueue +
FPGA DMA of the reference become the FrameFeeder (``--workers`` is the
in-flight pipeline depth, clamped to 8 like the reference's thread cap);
``--chroma`` selects between the gray (UV=128) and color-preserving
(passthrough) variants of the reference family; the 2-second status tick and
ACTIVE/IDLE/BACKLOG classifier are reproduced from ``OpenCLequalHist.cpp``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args)

_NOT_PORTED = {
    "fused-encode": "--fused-encode (the fused enhance + encode program)",
}


def not_ported(opts: dict, sink: str) -> str | None:
    """The one-line refusal for a flag or sink this package does not have
    yet, or None."""
    what = None
    if sink.startswith(("rtp+h264://", "rtp+h265://")):
        what = f"--sink={sink.split('://', 1)[0]}:// (the encoded RTP sinks)"
    elif opts.get("io") == "gst":
        what = "--io=gst (the GStreamer appsink/appsrc bridge)"
    else:
        for key, text in _NOT_PORTED.items():
            if opts.get(key):
                what = text
                break
    return None if what is None else f"{what}: not ported yet"


def resolve_device(name: str):
    """``--device`` as a torch device, or None (with a line on stderr) when
    it names the card and there is none."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this app runs on the card "
              "(torch.cuda.is_available() is false); --device=cpu runs the "
              "kernels' plain versions for tests", file=sys.stderr)
        return None
    return device


def mesh_for_app(spec: str, device, stack: contextlib.ExitStack):
    """The mesh of a ``--mesh`` flag.  With no process group a mesh of one
    position starts a one-rank group (closed again by ``stack``); inside a
    group the mesh must take every rank.  Raises ValueError with the
    user-facing message."""
    import torch.distributed as dist

    from opencv_opencl_tpu_torch.parallel.launch import init_process_group
    from opencv_opencl_tpu_torch.parallel.mesh import (
        make_mesh, parse_mesh_spec)

    shape = parse_mesh_spec(spec)
    if not dist.is_initialized():
        n = 1 if shape is None else shape[0] * shape[1]
        if n > 1:
            raise ValueError(f"requested {n} devices, have 1")
        rendezvous = stack.enter_context(
            tempfile.TemporaryDirectory(prefix="relay_mesh_"))
        init_process_group(0, 1, os.path.join(rendezvous, "rendezvous"),
                           device.type)
        stack.callback(dist.destroy_process_group)
    return make_mesh(shape=shape)


def group_rank_and_size() -> tuple[int, int]:
    """This process's rank and the size of its process group; (0, 1) with
    no group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {
            "codec": str, "bitrate": int, "workers": int, "width": int,
            "height": int, "fps": float, "op": str, "chroma": str,
            "clipLimit": float, "tile": int, "batch": int, "source": str,
            "sink": str, "duration": float, "max-frames": int,
            "status-interval": float, "realtime": bool, "max-rate": float,
            "adaptive-rate": bool, "native": bool, "preset": str,
            "io": str, "ref-frame": bool, "sdp-file": str,
            "rtcp-schedule": str, "mesh": str, "encoder": str,
            "hist-downsample": int, "fused-encode": bool, "device": str,
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
    if "preset" in opts:
        from opencv_opencl_tpu_torch.models.presets import PRESETS

        p = PRESETS[opts["preset"]]
        opts.setdefault("codec", p.encoder.codec)
        opts.setdefault("bitrate", p.encoder.bitrate_kbps)
        opts.setdefault("width", p.width)
        opts.setdefault("height", p.height)
        opts.setdefault("fps", p.fps)
        opts.setdefault("op", p.enhancer.op)
        opts.setdefault("chroma", p.enhancer.chroma.value)
        opts.setdefault("clipLimit", p.enhancer.clip_limit)
        opts.setdefault("tile", p.enhancer.tile_grid[0])
    codec = opts.get("codec", "h264")
    bitrate = opts.get("bitrate", 20000)
    workers = min(max(opts.get("workers", 2), 1), 8)
    width = opts.get("width", 1920)
    height = opts.get("height", 1080)
    fps = opts.get("fps", 60.0)
    op = opts.get("op", "histeq")
    chroma_s = opts.get("chroma", "gray")
    batch = opts.get("batch", 4)
    source = opts.get("source", "test")
    sink_path = opts.get("sink", "null")
    duration = opts.get("duration")
    max_frames = opts.get("max-frames")
    interval = opts.get("status-interval", 2.0)
    realtime = opts.get("realtime", False)

    device = resolve_device(opts.get("device", "cuda"))
    if device is None:
        return 1

    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.io.videofile import (
        FileSink, FileSource, NullSink, RawSink, TestSource,
    )
    from opencv_opencl_tpu_torch.metrics.counters import (
        FrameRateCounters, StatusReporter)
    from opencv_opencl_tpu_torch.models.enhancer import (
        Enhancer, EnhancerConfig)
    from opencv_opencl_tpu_torch.runtime.feeder import FrameFeeder
    from opencv_opencl_tpu_torch.runtime.governor import RateGovernor

    # in a process group every rank runs the relay; rank 0 alone owns the
    # sink and prints
    rank, world = group_rank_and_size() if "mesh" in opts else (0, 1)
    lead = rank == 0
    say = print if lead else (lambda *args, **kwargs: None)
    if world > 1:
        timed = [f"--{k}" for k in ("duration", "max-rate", "adaptive-rate")
                 if opts.get(k)]
        if timed:
            print(f"{', '.join(timed)} not supported in a process group of "
                  f"{world} ranks: every rank must see the same frames",
                  file=sys.stderr)
            return 2
    if "preset" in opts:
        say(f"Preset '{opts['preset']}' ({p.reference}): {p.description}")

    chroma = (ChromaPolicy.GRAY if chroma_s.lower() == "gray"
              else ChromaPolicy.PASSTHROUGH)

    if source == "test":
        spec = FrameSpec(width=width, height=height, fps=fps)
        src = TestSource(spec, num_frames=max_frames)
    else:
        src = FileSource(source, width=width, height=height)
        spec = FrameSpec(width=src.spec.width, height=src.spec.height, fps=fps)

    if not lead or sink_path == "null":
        sink = NullSink()
    elif sink_path.startswith(("rtp://", "rtp+raw://")):
        # native RTP/UDP data plane (no GStreamer needed): JPEG/RTP
        # (RFC 2435, interoperable with rtpjpegdepay) or raw NV12 lines
        from opencv_opencl_tpu_torch.io.rtp import RtpUdpSink

        kind = "raw" if sink_path.startswith("rtp+raw://") else "jpeg"
        hostport = sink_path.split("://", 1)[1]
        rtp_host, rtp_port = hostport.rsplit(":", 1)
        schedule = opts.get("rtcp-schedule", "tick")
        if schedule not in ("tick", "rfc3550"):
            print(f"--rtcp-schedule={schedule!r} invalid: tick|rfc3550",
                  file=sys.stderr)
            return 2
        sink = RtpUdpSink(rtp_host, int(rtp_port), kind=kind, fps=fps,
                          rtcp_schedule=schedule)
        if "sdp-file" in opts:
            # a stock player (ffplay/VLC) opens this file to receive the
            # stream — the in-repo equivalent of handing the lab PC the
            # udpsink coordinates
            from opencv_opencl_tpu_torch.io.sdp import build_rtp_session_sdp

            with open(opts["sdp-file"], "w") as f:
                f.write(build_rtp_session_sdp(
                    rtp_host, int(rtp_port), kind,
                    width=spec.width, height=spec.height))
            print(f"SDP written: {opts['sdp-file']}")
    elif sink_path.endswith(".nv12") or sink_path.endswith(".raw"):
        sink = RawSink(sink_path)
    else:
        sink = FileSink(sink_path, spec)
    sink_open = [True]

    def close_sink() -> None:
        if sink_open:
            sink_open.clear()
            sink.close()

    stack.callback(close_sink)  # also on the refusals below

    try:
        cfg = EnhancerConfig(
            op=op, clip_limit=opts.get("clipLimit", 2.0),
            tile_grid=(opts.get("tile", 8),) * 2, chroma=chroma,
            use_ref_frame=opts.get("ref-frame", False),
            hist_downsample=opts.get("hist-downsample", 1),
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if cfg.hist_downsample > 1:
        if "mesh" in opts or cfg.use_ref_frame:
            print("--hist-downsample is not supported with --mesh or "
                  "--ref-frame (exact-only paths)", file=sys.stderr)
            return 2
        say(f"APPROXIMATE histogram mode: every "
            f"{cfg.hist_downsample}th row (not bit-exact vs cv2)")
    if "mesh" in opts:
        # several cards: shard the batch over `data`, rows over `space` —
        # the scaling analogue of the reference's worker pool, one flag
        from opencv_opencl_tpu_torch.parallel.sharded import ShardedEnhancer

        try:
            # only mesh construction errors belong to the flag; anything
            # the sharded step raises is a real config error
            mesh = mesh_for_app(opts["mesh"], device, stack)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        enhancer = ShardedEnhancer(cfg, spec, mesh=mesh, device=device)
        ndata, nspace = enhancer.part.ndata, enhancer.part.nspace
        if batch < 1 or batch % ndata:
            print(f"--batch={batch} must be a positive multiple of the "
                  f"mesh data axis ({ndata})", file=sys.stderr)
            return 2
        say(f"Sharded over mesh {{'data': {ndata}, 'space': {nspace}}} "
            f"({ndata * nspace} devices)")
    elif cfg.use_ref_frame and op == "clahe":
        # streaming mode: LUTs from the previous frame's histograms (the
        # accel.cpp two-input hook); the map and the histograms of a frame
        # are one kernel pass
        from opencv_opencl_tpu_torch.models.enhancer import StreamingEnhancer

        enhancer = StreamingEnhancer(cfg, spec, device)
    else:
        try:
            enhancer = Enhancer(cfg, spec, device)
        except ValueError as e:  # e.g. hist-downsample vs tile height
            print(str(e), file=sys.stderr)
            return 2
    counters = FrameRateCounters()

    def on_output(seq, frame, meta):
        sink.write(frame)
        counters.count("encoder_frames")
        counters.count("encoder_bytes", frame.nbytes)

    queue_capacity = 8
    feeder = FrameFeeder(
        enhancer.process_batch, batch_size=batch, depth=workers,
        queue_capacity=queue_capacity, on_output=on_output,
        counters=counters,
        # several ranks: the same batches on every rank, whatever the timing
        whole_batches=world > 1,
        native_staging=((spec.buffer_rows, spec.width)
                        if opts.get("native") else False),
    )
    reporter = StatusReporter(
        counters, interval_s=interval, num_workers=workers,
        queue_length_fn=feeder.queue_length,
        avg_process_ms_fn=lambda: feeder.timing.avg_total_ms,
    )

    say("Building the kernels and warming up (one-time, like the xclbin "
        "load)...")
    feeder.warmup((spec.buffer_rows, spec.width))
    if hasattr(enhancer, "reset"):
        # warmup ran zero frames through the stateful streaming enhancer —
        # restore the documented identity-like initial histogram state
        enhancer.reset()
    staging = "native C++ ring" if feeder._native is not None else "python queue"
    say(f"NV12 {op} relay pipeline started "
        f"({spec.width}x{spec.height}@{fps:g}, codec={codec}, "
        f"bitrate={bitrate} kbps, workers={workers}, chroma={chroma.value}, "
        f"staging={staging})")
    say("(with frame ordering)")

    if opts.get("adaptive-rate"):
        # congestion-aware: RTCP receiver reports drive an AIMD rate loop
        # (ceiling = --max-rate or the configured fps)
        from opencv_opencl_tpu_torch.runtime.governor import (
            AdaptiveRateGovernor, feed_governor_from_rtcp)

        # default ceiling 10% above the pacing rate: an exactly-at-fps
        # submit cadence would otherwise resonate with the admit slot
        # grid and shed frames on a loss-free stream
        governor = AdaptiveRateGovernor(
            opts.get("max-rate", (fps or 30.0) * 1.1))
    else:
        governor = (RateGovernor(opts["max-rate"])
                    if "max-rate" in opts else None)

    feeder.start()
    if lead:
        reporter.start()
    t_start = time.monotonic()
    frame_period = 1.0 / fps if fps > 0 else 0.0
    n = 0
    try:
        for nv12 in src:
            counters.count("camera_frames")
            if governor is not None and not governor.admit():
                continue  # videorate drop-only: cap the input rate
            while world > 1 and feeder.queue_length() >= queue_capacity:
                time.sleep(0.001)  # no leaky drop: it would differ by rank
            feeder.submit(nv12, meta={"pts": n * frame_period})
            n += 1
            if opts.get("adaptive-rate"):
                feed_governor_from_rtcp(governor, sink)
            if max_frames is not None and n >= max_frames:
                break
            if duration is not None and time.monotonic() - t_start > duration:
                break
            if realtime:
                next_t = t_start + n * frame_period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
    except KeyboardInterrupt:
        say("\nInterrupted.")
    feeder.stop(drain=True)
    if lead:
        reporter.stop()
        reporter.tick()
    if getattr(sink, "rtcp", None) is not None:
        # surface the far end's Receiver Report, if any arrived (loss/RTT
        # — the numbers the reference read off details.html)
        sink.rtcp.poll()
        if sink.rtcp.remote_blocks:
            blk = sink.rtcp.remote_blocks[-1]
            rtt = f"{sink.rtt_ms:.1f} ms" if sink.rtt_ms is not None else "n/a"
            print(f"[rtcp] receiver reports: lost={blk.cumulative_lost} "
                  f"fraction={blk.fraction_lost}/256 "
                  f"jitter={blk.jitter} rtp-units rtt={rtt}")
    close_sink()

    stats = feeder.stats
    wall = time.monotonic() - t_start
    say(f"\nShutdown: {stats['emitted']} frames emitted in {wall:.2f}s "
        f"({stats['emitted'] / wall if wall > 0 else 0:.1f} fps), "
        f"dropped(late)={stats['dropped_late']}, "
        f"dropped(overflow)={stats['dropped_overflow']}, "
        f"errors={stats['processing_errors']}")
    if lead:
        feeder.timing.final_report()
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
