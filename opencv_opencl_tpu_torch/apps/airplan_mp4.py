"""MP4 equalizeHist relay (<- reference ``AirplanMP4.cpp``).

Usage:
  python -m opencv_opencl_tpu_torch.apps.airplan_mp4 --input=video.mp4 \\
      [--output=out.mp4] [--codec=h264|h265] [--bitrate=10000] \\
      [--max-frames=N] [--chroma=gray|passthrough] [--device=cuda|cpu]

Counterpart of ``opencv_opencl_tpu/apps/airplan_mp4.py``: the same flags,
printed lines, files and return codes.  The reference decodes an MP4
through the hardware decoder, clones the Y plane, runs cv::equalizeHist,
sets UV=128 and re-encodes to RTP (``AirplanMP4.cpp:82-107,331-355``),
preserving input timestamps (``:125``).  This is the same pipeline as
``clahe_video`` with the histeq op (K1 on a 1x1 grid and K4 on the card)
and gray chroma defaults — implemented as a thin preset over it so the two
stay behaviourally identical.  ``--io=gst`` runs the reference's own media
path over python-gi (``io/gst_adapter.GstAppBridge``) and refuses with
return code 2 where python-gi is missing.

The app runs on the card: without a CUDA card it fails (return code 1)
unless ``--device=cpu`` names the kernels' plain versions (for tests).
"""

from __future__ import annotations

import sys

from opencv_opencl_tpu_torch.apps import clahe_video
from opencv_opencl_tpu_torch.apps._cli import (
    install_sigterm_handler, parse_kv_args, resolve_device)


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {"input": str, "output": str, "codec": str, "bitrate": int,
         "max-frames": int, "chroma": str, "resolution": str, "fps": str,
         "io": str, "decoder": str, "host": str, "port": int,
         "width": int, "height": int, "duration": float, "device": str},
    )
    if "input" not in opts:
        print(f"Usage: {sys.argv[0]} --input=video.mp4 [--output=out.mp4] ...",
              file=sys.stderr)
        return 1
    if opts.get("io") == "gst":
        return _run_gst(opts)
    fwd = [f"--input={opts['input']}", "--op=histeq",
           f"--chroma={opts.get('chroma', 'gray')}"]
    for k in ("output", "codec", "bitrate", "max-frames", "resolution", "fps",
              "device"):
        if k in opts:
            fwd.append(f"--{k}={opts[k]}")
    return clahe_video.run(fwd)


def _run_gst(opts: dict) -> int:
    """The reference's ACTUAL media path: qtdemux ! h264parse ! omxh264dec
    (``AirplanMP4.cpp:309-317``) -> feeder -> OMX re-encode -> RTP/UDP
    (``:331-355``), input timestamps copied through (``:125``)."""
    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.io import gst as gstb
    from opencv_opencl_tpu_torch.io.gst_adapter import (
        GstAppBridge, TimestampPolicy, gi_available,
    )
    from opencv_opencl_tpu_torch.models.enhancer import Enhancer, EnhancerConfig
    from opencv_opencl_tpu_torch.runtime.feeder import FrameFeeder

    if not gi_available():
        print("--io=gst unavailable: python-gi with GStreamer 1.0 is not "
              "available on this host", file=sys.stderr)
        return 2
    device = resolve_device(opts.get("device", "cuda"))
    if device is None:
        return 1
    width = opts.get("width")
    height = opts.get("height")
    if width is None or height is None:
        # the decoder emits the file's NATIVE geometry (no scaler in the
        # reference chain) — probe it so the frame shape always matches
        import cv2

        cap = cv2.VideoCapture(opts["input"])
        width = width or int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 1280
        height = height or int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 720
        cap.release()
        print(f"Probed input geometry: {width}x{height}")
    chroma = (ChromaPolicy.PASSTHROUGH
              if opts.get("chroma") == "passthrough" else ChromaPolicy.GRAY)
    spec = FrameSpec(width=width, height=height, fps=30)
    enhancer = Enhancer(EnhancerConfig(op="histeq", chroma=chroma), spec,
                        device=device)
    feeder = FrameFeeder(enhancer.process_batch, batch_size=4, depth=2)
    cap = gstb.mp4_capture_pipeline(opts["input"],
                                    decoder=opts.get("decoder", "omx"))
    enc = gstb.EncoderConfig(codec=opts.get("codec", "h264"),
                             bitrate_kbps=opts.get("bitrate", 10000))
    emit = gstb.emit_pipeline(enc, width=width, height=height,
                              host=opts.get("host", "192.168.25.69"),
                              port=opts.get("port", 5004))
    bridge = GstAppBridge.from_gi(
        cap, emit, feeder, (spec.buffer_rows, width),
        policy=TimestampPolicy.COPY,  # AirplanMP4.cpp:125
    )
    feeder.start()
    bridge.start()
    print(f"MP4 hardware-decode relay: {opts['input']} -> "
          f"rtp://{opts.get('host', '192.168.25.69')}:{opts.get('port', 5004)}")
    try:
        bridge.wait(opts.get("duration"))
    except KeyboardInterrupt:
        pass
    bridge.stop()
    feeder.stop(drain=True)
    print(f"Done: {feeder.stats['emitted']} frames")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
