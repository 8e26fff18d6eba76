"""File-based CLAHE video relay (<- reference ``CLAHECompare.cpp`` +
``clahevideo.cpp``).

Usage:
  python -m opencv_opencl_tpu_torch.apps.clahe_video --input=video.mp4 \\
      [--output=out.mp4] [--resolution=1280x720] [--fps=30] [--loop] \\
      [--udp=host:port] [--udp-kind=jpeg|raw|h264|h265] [--udp-only] \\
      [--encoder=auto|pcm[:slices]|cavlc[:qp=N][:slices=M][:gop=N]|tpu[...]|ffmpeg|gi]  # h264/h265 udp legs \\
      [--clipLimit=2.0] [--tile=8] [--codec=h264|h265] \\
      [--bitrate=25000] [--timing-window=200] [--detailed-timing] \\
      [--max-frames=N] [--op=clahe|histeq] [--device=cuda|cpu]

Counterpart of ``opencv_opencl_tpu/apps/clahe_video.py`` on the port's
``Enhancer``: the same flags, printed lines, files, datagrams and return
codes.  Defaults mirror the reference (1280x720 @ 30, clip 2.0, tile 8, 25
Mbps: ``CLAHECompare.cpp:287-297``).  The reference's emit side is a tee:
RTP/UDP always, plus ``mp4mux ! filesink`` unless ``--udp-only``
(``CLAHECompare.cpp:438-483``) — here ``--udp=host:port`` attaches the
native RTP sink (io/rtp.py, RTCP on) alongside the mp4 FileSink, and
``--udp-only`` drops the file branch.  Timing instrumentation reproduces
``clahevideo.cpp``: per-frame compute/memory/total decomposition, rolling
window reports every 100 frames, detailed per-frame prints for the first 10
frames then every 50th, and a final performance analysis block.

Each frame runs on the card: CLAHE is K1, K2 and K3, histeq K1 and K4.
Without a CUDA card the app fails (return code 1) unless ``--device=cpu``
names the kernels' plain versions (for tests).  :func:`enhance_frames` is
the per-frame loop over any iterable of NV12 frames, so that it runs where
cv2 does not; :func:`run` reads the file through cv2 (``FileSource``).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args, resolve_device)


def enhance_frames(frames, enhancer, sinks, timing, max_frames: int | None = None,
                   detailed: bool = False) -> int:
    """Enhance each NV12 frame of ``frames`` with ``enhancer`` (its
    ``process_frame``) and write it to every sink, recording the frame's
    compute (the step, waited for), memory (the copy to the host) and total
    milliseconds in ``timing`` (a ``TimingStats``); stops after
    ``max_frames``.  Returns the number of frames."""
    import torch

    from opencv_opencl_tpu_torch.metrics.timing import Span

    on_card = enhancer.device.type == "cuda"
    frame_count = 0
    for nv12 in frames:
        if max_frames is not None and frame_count >= max_frames:
            break
        t_frame = time.perf_counter()
        compute = Span()
        mem = Span()
        with compute:
            out_dev = enhancer.process_frame(nv12)
            if on_card:
                torch.cuda.current_stream(enhancer.device).synchronize()
        with mem:
            out = np.asarray(out_dev)
        for sink in sinks:
            sink.write(out)
        total_ms = (time.perf_counter() - t_frame) * 1e3
        timing.record(compute.ms, mem.ms, total_ms)
        frame_count += 1
        if detailed and (frame_count <= 10 or frame_count % 50 == 0):
            print(f"Frame {frame_count}: Compute={compute.ms:.3f}ms, "
                  f"Memory={mem.ms:.3f}ms, Total={total_ms:.3f}ms, "
                  f"Other={total_ms - compute.ms - mem.ms:.3f}ms")
        if frame_count % 100 == 0:
            timing.window_report()
    return frame_count


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {
            "input": str, "output": str, "loop": bool, "udp-only": bool,
            "udp": str, "udp-kind": str, "rtcp-schedule": str,
            "encoder": str, "hist-downsample": int,
            "resolution": str, "fps": str, "clipLimit": float, "tile": int,
            "codec": str, "bitrate": int, "timing-window": int,
            "detailed-timing": bool, "max-frames": int, "op": str,
            "chroma": str, "device": str,
        },
    )
    input_file = opts.get("input")
    if not input_file:
        print(f"Usage: {sys.argv[0]} --input=/path/to/video.mp4 [OPTIONS]",
              file=sys.stderr)
        print("Options: --output= --resolution=WxH --fps=N --loop --udp-only\n"
              "         --clipLimit=2.0 --tile=8 --codec=h264|h265 "
              "--bitrate=25000\n"
              "         --timing-window=200 --detailed-timing --max-frames=N",
              file=sys.stderr)
        return 1
    device = resolve_device(opts.get("device", "cuda"))
    if device is None:
        return 1

    width, height = 1280, 720
    if "resolution" in opts:
        try:
            w, h = opts["resolution"].lower().split("x")
            width, height = int(w), int(h)
        except ValueError:
            print("Invalid resolution format. Use --resolution=WIDTHxHEIGHT",
                  file=sys.stderr)
    fps = 30.0
    if "fps" in opts:
        s = opts["fps"]
        fps = (float(s.split("/")[0]) / float(s.split("/")[1])
               if "/" in s else float(s))
    clip_limit = opts.get("clipLimit", 2.0)
    tile = opts.get("tile", 8)
    op = opts.get("op", "clahe")
    window = opts.get("timing-window", 200)
    detailed = opts.get("detailed-timing", False)
    max_frames = opts.get("max-frames")
    loop = opts.get("loop", False)

    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.io.videofile import (
        FileSink, FileSource, NullSink, resample_fps,
    )
    from opencv_opencl_tpu_torch.metrics.timing import TimingStats
    from opencv_opencl_tpu_torch.models.enhancer import Enhancer, EnhancerConfig

    src = FileSource(input_file, width=width, height=height, loop=loop)
    spec = FrameSpec(width=src.spec.width, height=src.spec.height, fps=fps)
    print(f"Input: {input_file} -> {spec.width}x{spec.height} @ {fps:g} fps")
    print(f"CLAHE parameters: clipLimit={clip_limit:g}, "
          f"tileGrid={tile}x{tile}")

    sinks = []
    descs = []
    mp4_tee: dict = {}
    if "udp" in opts:
        # the reference's RTP/UDP leg of the tee, natively
        udp_host, udp_port = opts["udp"].rsplit(":", 1)
        kind = opts.get("udp-kind", "jpeg")
        if kind in ("h264", "h265"):
            # encoded leg (the reference always encoded before its tee,
            # CLAHECompare.cpp:438-483): pluggable encoder boundary.
            # Same shared construction as relay/multi_relay — forwards
            # --bitrate and fails with rc=2, not a traceback.
            from opencv_opencl_tpu_torch.io.encoder import encoded_rtp_sink_from_url

            try:
                esink = encoded_rtp_sink_from_url(
                    f"rtp+{kind}://{opts['udp']}", spec.width, spec.height,
                    fps=fps, bitrate_kbps=opts.get("bitrate", 25000),
                    backend=opts.get("encoder", "auto"),
                    rtcp_schedule=opts.get("rtcp-schedule", "tick"),
                    device=device)
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 2
            # the reference's ACTUAL tee: ONE encode into udpsink +
            # mp4mux (CLAHECompare.cpp:438-483) — when the file leg is
            # an .mp4 and the udp leg is h264, mux the SAME access
            # units at close (io/mp4.py) instead of re-encoding pixels
            if (kind == "h264" and opts.get("output", "")
                    .lower().endswith(".mp4")
                    and not opts.get("udp-only")):
                tee_aus: list[bytes] = []
                esink.au_tap = tee_aus.append
                mp4_tee.update(path=opts["output"], aus=tee_aus)
            sinks.append(esink)
        else:
            from opencv_opencl_tpu_torch.io.rtp import RtpUdpSink

            sinks.append(RtpUdpSink(
                udp_host, int(udp_port), kind=kind, fps=fps,
                rtcp_schedule=opts.get("rtcp-schedule", "tick")))
        descs.append(f"rtp+{kind}://{opts['udp']}" if kind != "jpeg"
                     else f"rtp://{opts['udp']}")
    if opts.get("output") and not opts.get("udp-only"):
        if mp4_tee:
            descs.append(f"{opts['output']} (same-encode mp4 tee)")
        else:
            sinks.append(FileSink(opts["output"], spec))
            descs.append(opts["output"])
    if not sinks:
        sinks.append(NullSink())
        descs.append("(udp-only / null sink)")
    print(f"Output: {' + '.join(descs)}")

    chroma = (ChromaPolicy.GRAY if opts.get("chroma", "").lower() == "gray"
              else ChromaPolicy.PASSTHROUGH)
    try:
        enhancer = Enhancer(
            EnhancerConfig(
                op=op, clip_limit=clip_limit, tile_grid=(tile, tile),
                chroma=chroma,
                hist_downsample=opts.get("hist-downsample", 1),
            ),
            spec, device=device,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if opts.get("hist-downsample", 1) > 1:
        print(f"APPROXIMATE histogram mode: every "
              f"{opts['hist-downsample']}th row (not bit-exact vs cv2)")
    timing = TimingStats(
        window=window, detailed=False,
        label=f"clipLimit={clip_limit:.1f}, tileGrid={tile}x{tile}",
    )
    print("=== TIMING MEASUREMENT STARTED ===")

    # videorate equivalent: convert the decoded rate to the target --fps
    enhance_frames(resample_fps(src, src.spec.fps, fps), enhancer, sinks,
                   timing, max_frames, detailed)

    for sink in sinks:
        sink.close()
    src.close()
    for sink in sinks:
        if isinstance(sink, FileSink):
            print(f"MP4 saved ({sink.frames} frames)")
    if mp4_tee and mp4_tee["aus"]:
        from opencv_opencl_tpu_torch.io.mp4 import write_mp4

        info = write_mp4(mp4_tee["path"], mp4_tee["aus"], fps)
        print(f"MP4 saved ({info['samples']} frames, same-encode tee, "
              f"{info['sync_samples']} sync samples)")
    timing.final_report()
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
