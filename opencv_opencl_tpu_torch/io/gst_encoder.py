"""GStreamer-backed H.26x frame encoder (gi hosts).

The reference's own encode stage (``appsrc -> omxh264enc -> rtph264pay``,
``OpenCVequalHist.cpp:308-332``) minus the payloader: here the pipeline
ends in ``h264parse/h265parse -> appsink`` so the relay gets Annex-B
access units back and feeds them to the NATIVE RTP payloaders
(io.rtp_h26x) instead of GStreamer's.  Prefers OMX when the element
exists (the board case), else x264enc/x265enc zerolatency
(``webrtc/index.cpp:239-273`` settings).

The Gst module is injected like io.gst_adapter so the push/pull mapping
is testable against ``tests/fake_gst.py``; ``from_gi()`` builds the real
thing.

The port's own copy of ``opencv_opencl_tpu/io/gst_encoder.py``; ``gi``
is imported only inside functions.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["GiPipelineEncoder", "encoder_pipeline_desc"]


def encoder_pipeline_desc(width: int, height: int, fps: float,
                          codec: str = "h264", bitrate_kbps: int = 2000,
                          use_omx: bool = False) -> str:
    """appsrc -> encoder -> parse -> appsink description."""
    caps = (f"video/x-raw,format=NV12,width={width},height={height},"
            f"framerate={int(round(fps))}/1")
    if codec == "h264":
        enc = (f"omxh264enc control-rate=low-latency "
               f"target-bitrate={bitrate_kbps}" if use_omx else
               f"x264enc tune=zerolatency speed-preset=ultrafast "
               f"bitrate={bitrate_kbps} key-int-max=60")
        parse = "h264parse config-interval=-1"
        out_caps = "video/x-h264,stream-format=byte-stream,alignment=au"
    elif codec == "h265":
        enc = (f"omxh265enc control-rate=low-latency "
               f"target-bitrate={bitrate_kbps}" if use_omx else
               f"x265enc tune=zerolatency bitrate={bitrate_kbps}")
        parse = "h265parse config-interval=-1"
        out_caps = "video/x-h265,stream-format=byte-stream,alignment=au"
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return (f"appsrc name=enc_src is-live=true format=time caps={caps} ! "
            f"queue ! {enc} ! {parse} ! {out_caps} ! "
            f"appsink name=enc_sink emit-signals=false sync=false "
            f"max-buffers=8")


class GiPipelineEncoder:
    """FrameEncoder protocol over a gi pipeline (see io.encoder)."""

    def __init__(self, width: int, height: int, fps: float = 30.0,
                 codec: str = "h264", bitrate_kbps: int = 2000,
                 gst: Any = None, use_omx: bool | None = None) -> None:
        self.codec = codec
        self.width = width
        self.height = height
        self.fps = fps
        if gst is None:
            import gi

            gi.require_version("Gst", "1.0")
            from gi.repository import Gst as gst

            if not gst.is_initialized():
                gst.init(None)
        self.gst = gst
        if use_omx is None:
            # probe the encoder element for THIS codec — a board with
            # only omxh264enc must not emit omxh265enc pipelines
            use_omx = self._have_element(f"omx{codec}enc")
        self.desc = encoder_pipeline_desc(width, height, fps, codec,
                                          bitrate_kbps, use_omx=use_omx)
        self.pipeline = gst.parse_launch(self.desc)
        self.src = self.pipeline.get_by_name("enc_src")
        self.sink = self.pipeline.get_by_name("enc_sink")
        self.pipeline.set_state(gst.State.PLAYING)
        self.frames = 0
        self._pts = 0
        self._dur = int(round(1e9 / fps)) if fps else 0

    def _have_element(self, name: str) -> bool:
        factory = getattr(self.gst, "ElementFactory", None)
        if factory is None:
            return False
        try:
            return factory.find(name) is not None
        except Exception:
            return False

    def _pull_available(self, timeout_ns: int = 0) -> list[bytes]:
        out: list[bytes] = []
        while True:
            sample = self.sink.emit("try-pull-sample", timeout_ns)
            if sample is None:
                return out
            buf = sample.get_buffer()
            ok, info = buf.map(self.gst.MapFlags.READ)
            if ok:
                out.append(bytes(info.data))
                buf.unmap(info)

    def encode(self, nv12: np.ndarray) -> list[bytes]:
        data = np.asarray(nv12, np.uint8).tobytes()
        buf = self.gst.Buffer.new_wrapped(data)
        buf.pts = self._pts
        buf.duration = self._dur
        self._pts += self._dur
        ret = self.src.emit("push-buffer", buf)
        ok = getattr(self.gst, "FlowReturn", None)
        if ok is not None and ret is not None and ret != ok.OK:
            # a failed/flushing pipeline must surface, not silently
            # swallow every frame (the feeder counts this push_failure)
            raise RuntimeError(f"gi encoder push-buffer failed: {ret}")
        self.frames += 1
        return self._pull_available()

    def flush(self, deadline_s: float = 10.0) -> list[bytes]:
        import time

        self.src.emit("end-of-stream")
        # drain with a real per-pull timeout until appsink reports EOS
        # (a zero-timeout spin could race the encoder and drop its tail);
        # the deadline bounds a wedged pipeline
        out = []
        t_end = time.monotonic() + deadline_s
        while time.monotonic() < t_end:
            got = self._pull_available(timeout_ns=200_000_000)
            out.extend(got)
            try:
                if self.sink.get_property("eos"):
                    break
            except Exception:
                break
            if not got:
                time.sleep(0.01)
        return out

    def close(self) -> None:
        try:
            self.pipeline.set_state(self.gst.State.NULL)
        except Exception:
            pass
