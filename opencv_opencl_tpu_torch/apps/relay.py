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
                   # sinks also accept rtp://host:port (JPEG/RTP),
                   # rtp+raw://host:port (raw NV12 lines), and
                   # rtp+h264://host:port / rtp+h265://host:port
                   # (encoded RFC 6184/7798 — the full reference emit
                   # chain, encoder chosen via --encoder); *.nv12 / *.raw
                   # files take the raw frames
      [--encoder=auto|pcm[:slices]|cavlc[:qp=N][:slices=M][:gop=N][:search=R][:halfpel|:quarterpel|:fastsub]|tpu[:qp=N][:gop=N|:gdr=N][:search=R][:halfpel|:quarterpel|:fastsub][:refs=2][:deblock][:i4][:chromah][:overlap]|ffmpeg|gi]
                   # encoder for rtp+h26x sinks (io.encoder; pcm = in-repo
                   # lossless I_PCM, cavlc = in-repo compressed, both with
                   # the C++ fast path of the port's native library; tpu =
                   # the CAVLC encoder with its arithmetic on the card, on
                   # --device, entropy coding on the host: intra, or with
                   # gop=N / gdr=N the GOP encoder with the reference
                   # pictures on the card)
      [--fused-encode]  # with --sink=rtp+h264:// --encoder=tpu[...]:
                   # enhance + H.264 level computation in one device
                   # step a batch — frames never return to the host as
                   # pixels, only quantized levels come down
                   # (models/fused_encode.py)
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
Rank 0 alone opens the sink and checks its flags (``--rtcp-schedule``,
``--sdp-file``, ``--encoder``); its return code reaches every rank before
any collective (:func:`lead_verdict`), so a refusal ends every rank with
rank 0's code, printed once.  The frames are then cut into whole batches
whatever the timing, so that every rank makes the same collective calls;
the time-driven flags (``--duration``, ``--max-rate``, ``--adaptive-rate``)
are refused there, on every rank.

``--native`` stages the frames through the C++ ring of the port's
``native`` package (built with g++ at first use; where it cannot be built
the Python queue takes over, as in the JAX package, and the started line
says ``staging=python queue``).  It composes with ``--mesh``: the ring too
gives the feeder whole batches only.

``--fused-encode`` runs the enhancement and the device encoder's level
computation as one step a batch on the card (models/fused_encode.py):
the packed levels come down, not the frames, and the sink's encoder
assembles the access units from them (``EncodedRtpSink.write_packed``).
It needs ``--sink=rtp+h264://`` with ``--encoder=tpu[...]`` and no
``--ref-frame`` or ``--io=gst``, as in the JAX package.  With ``--mesh`` it
runs GOP-per-rank (``parallel/sharded_encode.py``): every rank enhances and
encodes its own whole GOPs of each batch (its own frames with the intra
encoder), from the encoder that every rank builds from ``--encoder`` at
rank 0's qp, broadcast each batch; rank 0 gathers the packed levels and
owns the sink.  ``--batch`` must be a multiple of the mesh's ranks times
the GOP; ``gdr`` and ``cpb`` are refused there, and a step that fails on
any rank fails the run on every rank (return code 1).

``--io=gst`` runs capture and emit as GStreamer pipelines over python-gi
(``io/gst_adapter.GstAppBridge``: appsink -> the feeder -> appsrc), for
``--source=test``, ``/dev/video*`` or a file and ``--sink=null``,
``rtp+raw://``, ``rtp(+h26x)://`` or a file; without python-gi it refuses
with return code 2, and so it does in a process group of several ranks.
``--encoder`` is read only for an encoded sink, as in the JAX package: with
any other sink it is ignored.  The encoded sinks encode after the card has enhanced the
frames: ``pcm`` and ``cavlc`` on the host, ``tpu`` on ``--device`` with its
entropy coding on the host (the intra encoder ``CudaCavlcEncoder``, or with
``gop=N`` (N > 1) or ``gdr=N`` the GOP encoder ``CudaGopEncoder``, whose
reference pictures stay on the card, with its partition modes
``:parts``); with ``:bitpack`` the CAVLC bits are packed on the card too
and the host assembles them.  The ``Encoder:`` line names the port's class.

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

import numpy as np

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args, resolve_device)


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


def timed_flags_refusal(opts: dict, world: int, extra: tuple[str, ...] = ()) -> str | None:
    """The refusal of the flags that cut batches apart by rank, in a group
    of ``world`` ranks (None where there is none): the clock's
    (``--duration``, ``--max-rate``, ``--adaptive-rate``) and ``extra``."""
    timed = [f"--{k}" for k in ("duration", "max-rate", "adaptive-rate")
             if opts.get(k)] + list(extra)
    if world < 2 or not timed:
        return None
    return (f"{', '.join(timed)} not supported in a process group of "
            f"{world} ranks: every rank must see the same frames")


def lead_verdict(lead: bool, world: int, device, open_on_lead):
    """``open_on_lead()`` on rank 0 alone, ``(value, rc)`` (rc 0, or the
    return code of a refusal it has printed), and ``(None, 0)`` on the other
    ranks; in a group of several ranks rank 0's rc is then broadcast, before
    any other collective, and returned on every rank.  Where rank 0 raises,
    the other ranks get rc 1."""
    from opencv_opencl_tpu_torch.parallel.collectives import broadcast_int

    value, rc = None, 0
    if lead:
        try:
            value, rc = open_on_lead()
        except BaseException:
            if world > 1:
                broadcast_int(1, device)
            raise
    if world > 1:
        rc = broadcast_int(rc, device)
    return value, rc


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
    if opts.get("io") == "gst":
        from opencv_opencl_tpu_torch.io.gst_adapter import gi_available

        if not gi_available():
            print("--io=gst unavailable: python-gi with GStreamer 1.0 is "
                  "not available on this host; use io.videofile "
                  "sources/sinks or install gir1.2-gstreamer",
                  file=sys.stderr)
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
    from opencv_opencl_tpu_torch.io.videofile import FileSource, NullSink, TestSource
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
    gst_mode = opts.get("io") == "gst"
    # live capture and the clock cut batches apart by rank
    refusal = timed_flags_refusal(opts, world, ("--io=gst",) if gst_mode else ())
    if refusal:
        say(refusal, file=sys.stderr)
        return 2
    if "preset" in opts:
        say(f"Preset '{opts['preset']}' ({p.reference}): {p.description}")

    chroma = (ChromaPolicy.GRAY if chroma_s.lower() == "gray"
              else ChromaPolicy.PASSTHROUGH)

    src = sink = None
    if gst_mode:
        # the GStreamer pipelines own capture and emit: no cv2 source or
        # sink is opened (a FileSink would truncate the very file the gst
        # filesink writes; sockets and captures would leak)
        spec = FrameSpec(width=width, height=height, fps=fps)
    elif source == "test":
        spec = FrameSpec(width=width, height=height, fps=fps)
        src = TestSource(spec, num_frames=max_frames)
    else:
        src = FileSource(source, width=width, height=height)
        spec = FrameSpec(width=src.spec.width, height=src.spec.height, fps=fps)

    fused = bool(opts.get("fused-encode"))
    # rank 0 owns the sink; the other ranks get rank 0's verdict on its
    # flags before any collective
    sink, rc = (None, 0) if gst_mode else lead_verdict(
        lead, world, device,
        lambda: _open_sink(sink_path, opts, spec, fps, bitrate, device))
    if rc:
        return rc
    rank_enc = None
    if not lead:
        sink = NullSink()
        if fused and sink_path.startswith(("rtp+h264://", "rtp+h265://")):
            # the other ranks build rank 0's encoder from the same flags,
            # for its GOP configuration
            rank_enc = _rank_encoder(sink_path, opts, spec, fps, bitrate, device)
            stack.callback(rank_enc.close)
    sink_open = [True]

    def close_sink() -> None:
        if sink_open:
            sink_open.clear()
            if sink is not None:
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
        say(str(e), file=sys.stderr)
        return 2
    if cfg.hist_downsample > 1:
        if "mesh" in opts or cfg.use_ref_frame:
            say("--hist-downsample is not supported with --mesh or "
                "--ref-frame (exact-only paths)", file=sys.stderr)
            return 2
        say(f"APPROXIMATE histogram mode: every "
            f"{cfg.hist_downsample}th row (not bit-exact vs cv2)")
    mesh = None
    if "mesh" in opts:
        try:
            # only mesh construction errors belong to the flag; anything
            # the sharded step raises is a real config error
            mesh = mesh_for_app(opts["mesh"], device, stack)
        except ValueError as e:
            say(str(e), file=sys.stderr)
            return 2
    if mesh is not None and fused:
        # the enhancement runs inside the mesh encode step
        # (parallel/sharded_encode.py): no separate sharded enhancer
        enhancer = None
    elif mesh is not None:
        # several cards: shard the batch over `data`, rows over `space` —
        # the scaling analogue of the reference's worker pool, one flag
        from opencv_opencl_tpu_torch.parallel.sharded import ShardedEnhancer

        enhancer = ShardedEnhancer(cfg, spec, mesh=mesh, device=device)
        ndata, nspace = enhancer.part.ndata, enhancer.part.nspace
        if batch < 1 or batch % ndata:
            say(f"--batch={batch} must be a positive multiple of the "
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

    process_fn = enhancer.process_batch if enhancer is not None else None
    fused_gop = False
    fused_reset = None
    mesh_failures: list = []
    if fused:
        from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder

        enc = getattr(sink, "encoder", None) if lead else rank_enc
        if (gst_mode or cfg.use_ref_frame or enc is None
                or not hasattr(enc, "encode_from_packed")):
            say("--fused-encode requires --sink=rtp+h264:// with "
                "--encoder=tpu[...] (and no --io=gst or "
                "--ref-frame)", file=sys.stderr)
            return 2
        fused_gop = isinstance(enc, CudaGopEncoder)
        if mesh is not None:
            if fused_gop and (enc.gdr or enc._cpb is not None):
                say("--fused-encode with --mesh requires IDR GOP "
                    "boundaries and per-frame-synchronous state to "
                    "stay on one chip: no gdr, no cpb", file=sys.stderr)
                return 2
            process_fn, ndev, unit = _fused_mesh_step(
                cfg, spec, enc, device, mesh, mesh_failures)
            if batch < 1 or batch % (ndev * unit):
                say(f"--batch={batch} must be a positive multiple "
                    f"of mesh devices x GOP frames "
                    f"({ndev} x {unit})", file=sys.stderr)
                return 2
            say(f"Fused enhance+encode over mesh "
                f"{{'data': {mesh.size(0)}, 'space': {mesh.size(1)}}} "
                f"({ndev} devices, "
                f"{'GOP' if fused_gop else 'frame'}-per-device; "
                f"frames stay in HBM as pixels)")
        else:
            process_fn, fused_reset = _fused_step(cfg, spec, enc, device)
            print("Fused enhance+encode: frames stay in HBM as "
                  "pixels; the host receives quantized levels only"
                  + (f" (GOP {enc.gop}, recon resident in HBM)"
                     if fused_gop else ""))

    def on_output(seq, frame, meta):
        if fused:
            if not lead:
                return  # rank 0 alone holds the lanes and the sink
            nbytes = sink.write_packed(frame)
            counters.count("encoder_frames")
            counters.count("encoder_bytes", nbytes)
            return
        if sink is not None:
            sink.write(frame)
        counters.count("encoder_frames")
        counters.count("encoder_bytes", frame.nbytes)

    queue_capacity = 8
    feeder = FrameFeeder(
        process_fn, batch_size=batch, depth=workers,
        queue_capacity=queue_capacity, on_output=on_output,
        counters=counters,
        pad_batches=not fused_gop,  # the GOP chain must not see fake frames
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
    if fused_reset is not None:
        # same for the fused GOP chain (reference pictures + frame index)
        fused_reset()
    staging = "native C++ ring" if feeder._native is not None else "python queue"
    say(f"NV12 {op} relay pipeline started "
        f"({spec.width}x{spec.height}@{fps:g}, codec={codec}, "
        f"bitrate={bitrate} kbps, workers={workers}, chroma={chroma.value}, "
        f"staging={staging})")
    say("(with frame ordering)")

    if gst_mode:
        return _run_gst(feeder, reporter, spec, fps, codec, bitrate, source,
                        sink_path, width, height, max_frames, duration)

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
            if mesh_failures:
                break  # every rank saw the failure at the same batch
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
    if mesh_failures:
        print(f"the fused mesh step failed: {mesh_failures[0]}", file=sys.stderr)
        return 1
    return 0


def _run_gst(feeder, reporter, spec, fps, codec, bitrate, source, sink_path,
             width, height, max_frames, duration) -> int:
    """``--io=gst``: capture pipeline -> appsink -> the feeder -> appsrc ->
    emit pipeline over python-gi (the reference's own frame transport,
    ``OpenCVequalHist.cpp:71-98``), until the capture's end of stream or
    ``duration``."""
    from opencv_opencl_tpu_torch.io import gst as gstb
    from opencv_opencl_tpu_torch.io.gst_adapter import (
        GstAppBridge, TimestampPolicy)

    if source == "test":
        cap = gstb.test_capture_pipeline(
            width=width, height=height, fps=int(fps), num_buffers=max_frames)
        policy = TimestampPolicy.RELAY
    elif source.startswith("/dev/video"):
        cap = gstb.capture_pipeline(device=source, width=width,
                                    height=height, fps=int(fps))
        policy = TimestampPolicy.RELAY
    else:
        cap = gstb.file_capture_pipeline(source, width=width,
                                         height=height, fps_num=int(fps))
        policy = TimestampPolicy.SYNTHESIZE
    gst_enc = gstb.EncoderConfig(codec=codec, bitrate_kbps=bitrate)
    raw_caps = (f"appsrc name=my_src format=time is-live=true "
                f"do-timestamp=true caps=video/x-raw,format=NV12,"
                f"width={width},height={height},framerate={int(fps)}/1 ")
    if sink_path == "null":
        emit = raw_caps + "! fakesink sync=false"
    elif sink_path.startswith("rtp+raw://"):
        # raw (unencoded) RTP: rtpvrawpay wants I420
        h_, p_ = sink_path.split("://", 1)[1].rsplit(":", 1)
        emit = (raw_caps + "! videoconvert ! video/x-raw,format=I420 ! "
                f"rtpvrawpay mtu=1200 ! "
                f"udpsink host={h_} port={p_} sync=false qos-dscp=60")
    elif "://" in sink_path:
        h_, p_ = sink_path.split("://", 1)[1].rsplit(":", 1)
        emit = gstb.emit_pipeline(gst_enc, width=width, height=height,
                                  fps=int(fps), host=h_, port=int(p_))
    else:
        emit = gstb.file_emit_pipeline(gst_enc, width=width, height=height,
                                       fps_num=int(fps), output_file=sink_path)
    try:
        bridge = GstAppBridge.from_gi(cap, emit, feeder,
                                      (spec.buffer_rows, spec.width), fps=fps,
                                      policy=policy)
    except RuntimeError as e:
        print(f"--io=gst unavailable: {e}", file=sys.stderr)
        return 2
    feeder.start()
    reporter.start()
    bridge.start()
    try:
        bridge.wait(duration)
    except KeyboardInterrupt:
        print("\nInterrupted.")
    bridge.stop()
    feeder.stop(drain=True)
    reporter.stop()
    reporter.tick()
    stats = feeder.stats
    print(f"\nShutdown: {stats['emitted']} frames emitted, "
          f"dropped(late)={stats['dropped_late']}, "
          f"errors={stats['processing_errors']}")
    feeder.timing.final_report()
    return 0


def _open_sink(sink_path: str, opts: dict, spec, fps: float, bitrate: int, device):
    """Rank 0's sink of ``--sink``: ``(sink, 0)``, or ``(None, 2)`` where its
    flags are refused (the refusal printed)."""
    from opencv_opencl_tpu_torch.io.videofile import FileSink, NullSink, RawSink

    if sink_path == "null":
        return NullSink(), 0
    if sink_path.startswith(("rtp://", "rtp+raw://")):
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
            return None, 2
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
        return sink, 0
    if sink_path.startswith(("rtp+h264://", "rtp+h265://")):
        # full reference emit chain: encode -> RFC 6184/7798 payload ->
        # UDP (OpenCVequalHist.cpp:308-332), behind the pluggable
        # encoder boundary (io.encoder: pcm | cavlc | tpu | ffmpeg | gi |
        # auto)
        from opencv_opencl_tpu_torch.io.encoder import encoded_rtp_sink_from_url

        es_codec = "h264" if sink_path.startswith("rtp+h264://") else "h265"
        try:
            sink = encoded_rtp_sink_from_url(
                sink_path, spec.width, spec.height, fps=fps,
                bitrate_kbps=bitrate, backend=opts.get("encoder", "auto"),
                rtcp_schedule=opts.get("rtcp-schedule", "tick"), device=device)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return None, 2
        rtp_host, rtp_port = sink.rtp.addr[0], sink.rtp.addr[1]
        print(f"Encoder: {type(sink.encoder).__name__} ({es_codec})")
        if "sdp-file" in opts:
            # hand stock players (ffplay/VLC) the session description
            from opencv_opencl_tpu_torch.io.sdp import build_rtp_session_sdp

            with open(opts["sdp-file"], "w") as f:
                f.write(build_rtp_session_sdp(
                    rtp_host, int(rtp_port), es_codec,
                    width=spec.width, height=spec.height))
            print(f"SDP written: {opts['sdp-file']}")
        return sink, 0
    if sink_path.endswith(".nv12") or sink_path.endswith(".raw"):
        return RawSink(sink_path), 0
    return FileSink(sink_path, spec), 0


def _rank_encoder(sink_path, opts, spec, fps, bitrate, device):
    """The encoder of rank 0's encoded sink ``sink_path``, built on another
    rank from the same flags; raises ValueError where rank 0's sink
    refuses them."""
    from opencv_opencl_tpu_torch.io.encoder import make_encoder

    return make_encoder(opts.get("encoder", "auto"), spec.width, spec.height,
                        fps=fps, codec="h264" if sink_path.startswith("rtp+h264://")
                        else "h265", bitrate_kbps=bitrate, device=device)


def _fused_options(enc) -> dict:
    """The fused step's options for the device encoder ``enc``, the same on
    one card and on a mesh: its bit packer and, for the GOP encoder
    (``gop`` among the keys), its GOP configuration."""
    from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder

    kw = dict(bitpack=enc._nw_mb if enc._bitpack else 0)
    if isinstance(enc, CudaGopEncoder):
        kw.update(gop=enc.gop, search=enc.search, subpel=enc.subpel,
                  refs=enc.refs, deblock=enc.deblock, parts=enc.parts)
    return kw


def _handoff(packed, d2h):
    """The packed lanes as a ``DeviceBatch``: their copy to the host under
    way on the side stream ``d2h`` where they lie on the card."""
    from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch

    return DeviceBatch(packed, d2h if packed.is_cuda else None)


def _fused_mesh_step(cfg, spec, enc, device, mesh, failures: list):
    """The fused step of ``--fused-encode --mesh`` for the encoder's
    configuration (parallel/sharded_encode.py): ``(process_fn, devices,
    unit)``.  Every rank calls ``process_fn`` with the same batch; on rank 0
    it returns the batch's packed lanes, on the other ranks None.  A
    failure on any rank fails the step on every rank and is appended to
    ``failures``; every later call then raises without a collective, on
    every rank alike."""
    from opencv_opencl_tpu_torch.models.enhancer import _d2h_stream
    from opencv_opencl_tpu_torch.parallel.sharded_encode import (
        build_mesh_gop_fn, build_mesh_levels_fn, pad_batch_for_mesh)

    kw = _fused_options(enc)
    build = build_mesh_gop_fn if "gop" in kw else build_mesh_levels_fn
    mesh_fn, unit = build(cfg, spec, mesh=mesh, device=device, **kw)
    ndev = mesh.size()
    d2h = _d2h_stream(device)

    def process_fn(nv12_batch):
        if failures:
            raise RuntimeError(f"the mesh step failed before: {failures[0]}")
        # the steps are stateless, so padding is safe: pad frames come after
        # every real frame; the tail of a stream encodes a short last GOP
        padded, real = pad_batch_for_mesh(np.asarray(nv12_batch), ndev, unit)
        try:
            # rank 0's qp, broadcast inside the step, rides in-band in the
            # packed lanes (lane 408)
            packed = mesh_fn(padded, enc.qp)
        except Exception as e:
            failures.append(e)
            raise
        return None if packed is None else _handoff(packed[:real], d2h)

    return process_fn, ndev, unit


def _fused_step(cfg, spec, enc, device):
    """The fused enhance + encode step of ``--fused-encode`` for the sink's
    encoder ``enc``: ``(process_fn, reset)`` (``reset`` None for the
    stateless intra step).  ``process_fn`` returns the packed levels as a
    ``DeviceBatch``, their copy to the host under way on a side stream."""
    from opencv_opencl_tpu_torch.models.enhancer import _d2h_stream
    from opencv_opencl_tpu_torch.models.fused_encode import (
        build_enhance_gop_fn, build_enhance_levels_fn)

    d2h = _d2h_stream(device)
    kw = _fused_options(enc)
    if "gop" not in kw:
        fused_fn = build_enhance_levels_fn(cfg, spec, device=device, **kw)

        def process_fn(nv12_batch):
            # qp is read at dispatch and rides in-band in the packed
            # levels, so the entropy stage writes the slice-header qp the
            # levels were quantized with
            return _handoff(fused_fn(nv12_batch, enc.qp), d2h)

        return process_fn, None
    # GOP: the step chains the reference pictures and the frame index
    # across batches; padding would advance them on fake frames (the
    # filter and the GDR band run inside the step)
    fused_fn = build_enhance_gop_fn(cfg, spec, gdr=enc.gdr, device=device, **kw)
    state = {}

    def reset():
        state["recon"] = enc.initial_recon()
        state["idx"] = 0

    def process_fn(nv12_batch):
        packed, *rec = fused_fn(nv12_batch, enc.qp, state["idx"],
                                *state["recon"])
        state["recon"] = tuple(rec)
        state["idx"] += int(nv12_batch.shape[0])
        return _handoff(packed, d2h)

    reset()
    return process_fn, reset


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
