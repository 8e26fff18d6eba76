"""RTP/UDP receiver — the PC-side counterpart of the relay's native RTP
sinks (the reference pointed ``udpsink`` at a lab PC, 192.168.25.69:5004,
and watched with an external player; this is the in-repo player/recorder).

Usage:
  python -m opencv_opencl_tpu_torch.apps.rtp_receiver --port=5004
      [--kind=jpeg|raw|h264|h265]
      [--width=W --height=H]   # raw needs the geometry
      [--output=out.mp4]       # h264: a REAL MP4 (no transcode,
                               #   io/mp4.py; --fps sets the timescale);
                               # .h264/.h265: Annex-B elementary file
      [--max-frames=N] [--timeout=5] [--stats-interval=2]

Receives the JPEG/RTP (RFC 2435), raw NV12, or H.26x (RFC 6184/7798)
stream produced by ``relay --sink=rtp://...`` / ``rtp+raw://...`` or
``H26xRtpSink``, optionally recording to a file, and prints periodic
receive stats with RTCP loss/jitter/bitrate (the ``details.html``
getStats analogue for headless hosts).

The port's own copy of ``opencv_opencl_tpu/apps/rtp_receiver.py``: the
same flags and lines; cv2 is imported only for the JPEG and raw kinds.
"""

from __future__ import annotations

import sys
import time

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args)


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {"port": int, "kind": str, "width": int, "height": int,
         "output": str, "max-frames": int, "timeout": float,
         "stats-interval": float, "host": str, "pt": int,
         "fps": float},
    )
    port = opts.get("port", 5004)
    kind = opts.get("kind", "jpeg")
    timeout = opts.get("timeout", 5.0)
    max_frames = opts.get("max-frames")
    interval = opts.get("stats-interval", 2.0)

    if kind in ("h264", "h265"):
        return _run_h26x(opts, port, kind, timeout, max_frames, interval)

    import cv2
    import numpy as np

    from opencv_opencl_tpu_torch.io.rtp import RtpUdpReceiver

    frame_shape = None
    if kind == "raw":
        if "width" not in opts or "height" not in opts:
            print("--kind=raw needs --width and --height", file=sys.stderr)
            return 1
        frame_shape = (opts["height"] * 3 // 2, opts["width"])

    rx = RtpUdpReceiver(host=opts.get("host", "0.0.0.0"), port=port,
                        kind=kind, frame_shape=frame_shape, timeout=timeout,
                        pt=opts.get("pt"))
    print(f"Listening for {kind} RTP on :{rx.port}")

    writer = None
    frames = 0
    byte_est = 0
    t0 = time.monotonic()
    last_tick = t0
    try:
        while max_frames is None or frames < max_frames:
            try:
                frame = rx.recv_frame()
            except (TimeoutError, OSError):
                print("Receive timeout — stream ended?")
                break
            if frame is None:
                continue
            if kind == "raw":
                bgr = cv2.cvtColor(frame, cv2.COLOR_YUV2BGR_NV12)
            else:
                bgr = frame
            frames += 1
            byte_est += bgr.nbytes
            if "output" in opts:
                if writer is None:
                    writer = cv2.VideoWriter(
                        opts["output"], cv2.VideoWriter_fourcc(*"mp4v"),
                        30, (bgr.shape[1], bgr.shape[0]))
                writer.write(bgr)
            now = time.monotonic()
            if now - last_tick >= interval:
                fps = frames / (now - t0)
                line = (f"[stats] frames={frames} fps={fps:.1f} "
                        f"size={bgr.shape[1]}x{bgr.shape[0]}")
                if rx.rtcp is not None:
                    # the details.html getStats fields, from RTCP receive
                    # accounting (loss / jitter / wire bitrate)
                    st = rx.rtcp.stats
                    mbps = st.octets * 8 / (now - t0) / 1e6
                    line += (f" bitrate={mbps:.2f}Mbps"
                             f" lost={st.cumulative_lost}"
                             f" jitter={st.jitter_ms():.2f}ms"
                             f" rr_sent={rx.rtcp.rr_sent}")
                print(line)
                last_tick = now
    except KeyboardInterrupt:
        print("\nInterrupted.")
    finally:
        if writer is not None:
            writer.release()
            print(f"Saved {frames} frames to {opts['output']}")
        rx.close()
    wall = time.monotonic() - t0
    print(f"Received {frames} frames in {wall:.1f}s "
          f"({frames / wall if wall > 0 else 0:.1f} fps)")
    return 0


def _run_h26x(opts, port, kind, timeout, max_frames, interval) -> int:
    """Record an RFC 6184/7798 stream to an Annex-B elementary file,
    or — when ``--output`` ends in .mp4 and kind is h264 — to a REAL
    MP4 container with no transcode (io/mp4.py muxes the received
    access units; the reference's mp4mux tee leg)."""
    from opencv_opencl_tpu_torch.io.rtp_h26x import H26xRtpReceiver

    rx = H26xRtpReceiver(host=opts.get("host", "0.0.0.0"), port=port,
                         codec=kind, timeout=timeout,
                         pt=opts.get("pt"))  # None = lock first dynamic PT
    print(f"Listening for {kind} RTP on :{rx.port}")
    mux_mp4 = ("output" in opts and kind == "h264"
               and opts["output"].lower().endswith(".mp4"))
    mp4_aus: list[bytes] = []
    out = (open(opts["output"], "wb")
           if "output" in opts and not mux_mp4 else None)
    aus = 0
    nbytes = 0
    t0 = time.monotonic()
    last_tick = t0
    try:
        while max_frames is None or aus < max_frames:
            try:
                au = rx.recv_access_unit()
            except (TimeoutError, OSError):
                print("Receive timeout — stream ended?")
                break
            aus += 1
            nbytes += len(au)
            if out is not None:
                out.write(au)
            if mux_mp4:
                mp4_aus.append(au)
            now = time.monotonic()
            if now - last_tick >= interval:
                line = (f"[stats] aus={aus} fps={aus / (now - t0):.1f} "
                        f"dropped={rx.depay.aus_dropped}")
                if rx.rtcp is not None:
                    st = rx.rtcp.stats
                    mbps = st.octets * 8 / (now - t0) / 1e6
                    line += (f" bitrate={mbps:.2f}Mbps"
                             f" lost={st.cumulative_lost}"
                             f" jitter={st.jitter_ms():.2f}ms")
                print(line)
                last_tick = now
    except KeyboardInterrupt:
        print("\nInterrupted.")
    finally:
        if out is not None:
            out.close()
            print(f"Saved {aus} access units ({nbytes} bytes) "
                  f"to {opts['output']}")
        if mux_mp4 and mp4_aus:
            from opencv_opencl_tpu_torch.io.mp4 import write_mp4

            info = write_mp4(opts["output"], mp4_aus,
                             fps=opts.get("fps", 30.0))
            print(f"MP4 saved to {opts['output']}: "
                  f"{info['samples']} samples "
                  f"{info['width']}x{info['height']} "
                  f"({info['sync_samples']} sync)")
        rx.close()
    wall = time.monotonic() - t0
    print(f"Received {aus} access units in {wall:.1f}s "
          f"(dropped={rx.depay.aus_dropped})")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
