"""Stream a pre-encoded H.264/H.265 elementary stream over RTP/UDP.

Usage:
  python -m opencv_opencl_tpu_torch.apps.h26x_stream --input=video.h264
      [--host=127.0.0.1] [--port=5004] [--codec=h264|h265] [--fps=30]
      [--loop] [--max-frames=N] [--mtu=1200]
      [--rtcp-schedule=tick|rfc3550]

The replay complement of ``rtp_receiver --kind=h264`` (which records an
Annex-B elementary file from RTP): this app plays such a file back onto
the wire with RFC 6184/7798 payloading and RTCP Sender Reports — the
native stand-in for the reference's file-fed emit pipelines
(``filesrc ! h264parse ! rtph264pay ! udpsink``,
``OpenCVequalHist.cpp:308-332`` tuning) on hosts without GStreamer.

Access-unit boundaries follow the standard elementary-stream rules: a
new AU starts at an AUD, or at a VCL NAL whose first-slice-of-picture
flag is set (H.264 ``first_mb_in_slice == 0`` = leading ue(v) bit;
H.265 ``first_slice_segment_in_pic_flag``), so multi-slice pictures
stay one AU; prefix NALs (AUD/VPS/SPS/PPS/prefix SEI) attach to the AU
they precede, suffix NALs (end-of-seq/stream, H.265 suffix SEI) to the
AU they follow.

The port's own copy of ``opencv_opencl_tpu/apps/h26x_stream.py``: the
same flags and lines.
"""

from __future__ import annotations

import sys
import time

from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args)


# split_access_units moved to io/rtp_h26x (the encoder boundary
# needs it without importing an app); re-exported for callers.
from opencv_opencl_tpu_torch.io.rtp_h26x import split_access_units  # noqa: E402,F401


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {"input": str, "host": str, "port": int, "codec": str,
         "fps": float, "loop": bool, "max-frames": int, "mtu": int,
         "rtcp-schedule": str},
    )
    if "input" not in opts:
        print("--input=<annexb elementary stream> is required",
              file=sys.stderr)
        return 2
    codec = opts.get("codec", "h264")
    if codec not in ("h264", "h265"):
        print(f"--codec={codec!r} invalid: h264|h265", file=sys.stderr)
        return 2
    fps = opts.get("fps", 30.0)
    if fps <= 0:
        print("--fps must be > 0", file=sys.stderr)
        return 2
    max_frames = opts.get("max-frames")
    if max_frames is not None and max_frames < 1:
        print("--max-frames must be >= 1", file=sys.stderr)
        return 2

    from opencv_opencl_tpu_torch.io.rtp_h26x import H26xRtpSink

    try:
        data = open(opts["input"], "rb").read()
    except OSError as e:
        print(f"cannot read {opts['input']}: {e}", file=sys.stderr)
        return 2
    aus = split_access_units(data, codec)
    if not aus:
        print(f"no access units found in {opts['input']}", file=sys.stderr)
        return 2

    try:
        sink = H26xRtpSink(opts.get("host", "127.0.0.1"),
                           opts.get("port", 5004), codec=codec, fps=fps,
                           mtu=opts.get("mtu", 1200),
                           rtcp_schedule=opts.get("rtcp-schedule", "tick"))
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(f"Streaming {len(aus)} {codec} access units "
          f"({len(data)} bytes) to "
          f"rtp://{opts.get('host', '127.0.0.1')}:{opts.get('port', 5004)} "
          f"@ {fps:g} fps")
    period = 1.0 / fps if fps > 0 else 0.0
    sent = 0
    t0 = time.monotonic()
    try:
        while True:
            for au in aus:
                sink.write(au)
                sent += 1
                if max_frames is not None and sent >= max_frames:
                    raise StopIteration
                next_t = t0 + sent * period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            if not opts.get("loop"):
                break
    except StopIteration:
        pass
    except KeyboardInterrupt:
        print("\nInterrupted.")
    finally:
        # always send the RTCP BYE + release the sockets, even when a
        # send error (unresolvable host, ...) aborts the stream
        wall = time.monotonic() - t0
        print(f"Sent {sent} AUs, {sink.packets} packets, "
              f"{sink.bytes} bytes in {wall:.2f}s"
              + (f" (rtt {sink.rtt_ms:.1f} ms)"
                 if sink.rtt_ms is not None else ""))
        sink.close()
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
