"""Live appsink -> TPU -> appsrc bridge over python-gi GStreamer.

This is the frame-in/frame-out heart of the reference relays, rebuilt for
the TPU feeder:

- ``new_sample_cb`` (``OpenCVequalHist.cpp:71-98``): pull the sample, cache
  the video info from caps once, count, O(1) enqueue — here
  ``FrameFeeder.submit`` replaces the GAsyncQueue push.
- output push (``OpenCVequalHist.cpp:148-186``): wrap the processed NV12
  bytes in a GstBuffer and push into appsrc.  Three timestamp policies
  reproduce the reference variants:

  * RELAY       — clear PTS/DTS/duration; the live appsrc re-timestamps
                  (``OpenCVequalHist.cpp:176-178`` + ``do-timestamp=true``).
  * SYNTHESIZE  — pts = n * frame_duration, dts = pts, explicit duration,
                  monotonic counter (``CLAHECompare.cpp:180-183``).
  * COPY        — copy the input buffer's PTS/DTS/duration through
                  (``AirplanMP4.cpp:125`` gst_buffer_copy_into COPY_TIMESTAMPS).

- EOS protocol (``CLAHECompare.cpp:207-281``): capture-side EOS either
  seeks back to 0 (``--loop``) or drains the feeder and sends appsrc EOS;
  the emit-side EOS then finalizes (mp4 moov write) and stops the bridge.

The GStreamer stack is injected (``gst=``) so hosts without gi can test the
full mapping logic against a fake; ``GstAppBridge.from_gi()`` builds the
real thing and raises a clear error when gi is absent.

The port's own copy of ``opencv_opencl_tpu/io/gst_adapter.py``; ``gi``
is imported only inside functions.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable

import numpy as np

__all__ = ["TimestampPolicy", "GstAppBridge", "gi_available"]


def gi_available() -> bool:
    """True when python-gi with GStreamer 1.x is importable."""
    try:
        import gi  # noqa: F401

        gi.require_version("Gst", "1.0")
        from gi.repository import Gst  # noqa: F401

        return True
    except Exception:
        return False


class TimestampPolicy(enum.Enum):
    RELAY = "relay"            # clear; live appsrc re-timestamps
    SYNTHESIZE = "synthesize"  # n * frame_duration (file-based CLAHE relays)
    COPY = "copy"              # input timestamps pass through (AirplanMP4)


class GstAppBridge:
    """Drives capture-pipeline -> FrameFeeder -> emit-pipeline.

    Parameters
    ----------
    gst: the ``Gst`` module (real gi or a test fake). Must be initialized.
    capture_desc / emit_desc: gst-launch pipeline descriptions containing an
        appsink named ``appsink_name`` and an appsrc named ``appsrc_name``
        (see io.gst builders).
    feeder: a started-or-startable FrameFeeder whose on_output is free (the
        bridge takes it over).
    frame_shape: (rows, width) of the NV12 buffer (height*3/2, width).
    fps: frames/sec for SYNTHESIZE mode frame_duration.
    loop: on capture EOS, seek back to 0 instead of finishing (--loop).
    on_stop: called once after the emit pipeline finalizes.
    """

    def __init__(
        self,
        gst: Any,
        capture_desc: str,
        emit_desc: str,
        feeder: Any,
        frame_shape: tuple[int, int],
        fps: float = 30.0,
        policy: TimestampPolicy = TimestampPolicy.RELAY,
        appsink_name: str = "cv_sink",
        appsrc_name: str = "my_src",
        loop: bool = False,
        on_stop: Callable[[], None] | None = None,
        glib: Any = None,
    ) -> None:
        self.gst = gst
        self.capture_desc = capture_desc
        self.emit_desc = emit_desc
        self.feeder = feeder
        self.frame_shape = tuple(frame_shape)
        self.fps = float(fps)
        self.policy = policy
        self.appsink_name = appsink_name
        self.appsrc_name = appsrc_name
        self.loop = loop
        self.on_stop = on_stop or (lambda: None)
        # real gi needs an iterated GLib main context for bus signal
        # dispatch; from_gi() passes GLib and start() runs the loop in a
        # daemon thread (the fake-Gst tests dispatch synchronously)
        self.glib = glib
        self._mainloop = None
        self._mainloop_thread: threading.Thread | None = None
        self.frame_duration_ns = int(round(1e9 / self.fps)) if self.fps else 0
        self._out_count = 0
        self._video_info: tuple[int, int] | None = None  # cached from caps
        self.capture = None
        self.emit = None
        self._appsink = None
        self._appsrc = None
        self._finished = threading.Event()
        self._lock = threading.Lock()
        feeder.on_output = self._on_feeder_output

    # ---- construction helpers ----

    @classmethod
    def from_gi(cls, *args, **kwargs) -> "GstAppBridge":
        """Build against the real python-gi GStreamer stack."""
        if not gi_available():
            raise RuntimeError(
                "python-gi with GStreamer 1.0 is not available on this host; "
                "use io.videofile sources/sinks or install gir1.2-gstreamer"
            )
        import gi

        gi.require_version("Gst", "1.0")
        gi.require_version("GstApp", "1.0")
        from gi.repository import Gst, GstApp  # noqa: F401

        from gi.repository import GLib

        if not Gst.is_initialized():
            Gst.init(None)
        kwargs.setdefault("glib", GLib)
        return cls(Gst, *args, **kwargs)

    # ---- lifecycle ----

    def start(self) -> "GstAppBridge":
        gst = self.gst
        self.capture = gst.parse_launch(self.capture_desc)
        self.emit = gst.parse_launch(self.emit_desc)
        self._appsink = self.capture.get_by_name(self.appsink_name)
        self._appsrc = self.emit.get_by_name(self.appsrc_name)
        if self._appsink is None or self._appsrc is None:
            raise ValueError(
                f"pipelines must contain appsink '{self.appsink_name}' and "
                f"appsrc '{self.appsrc_name}'"
            )
        self._appsink.connect("new-sample", self._on_new_sample)
        for pipe, cb in ((self.capture, self._on_capture_message),
                         (self.emit, self._on_emit_message)):
            bus = pipe.get_bus()
            bus.add_signal_watch()
            bus.connect("message", cb)
        if self.glib is not None:
            self._mainloop = self.glib.MainLoop()
            self._mainloop_thread = threading.Thread(
                target=self._mainloop.run, daemon=True, name="gst-mainloop")
            self._mainloop_thread.start()
        self.emit.set_state(gst.State.PLAYING)
        self.capture.set_state(gst.State.PLAYING)
        return self

    def stop(self) -> None:
        gst = self.gst
        with self._lock:
            if self.capture is not None:
                self.capture.set_state(gst.State.NULL)
            if self.emit is not None:
                self.emit.set_state(gst.State.NULL)
        if self._mainloop is not None:
            self._mainloop.quit()
            t = self._mainloop_thread
            # bus callbacks run ON the mainloop thread and may call stop():
            # joining the current thread would raise and skip _finished
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5)
            self._mainloop = None
        self._finished.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._finished.wait(timeout)

    # ---- capture side (GStreamer streaming thread) ----

    def _on_new_sample(self, sink) -> Any:
        gst = self.gst
        sample = sink.emit("pull-sample")
        if sample is None:
            return gst.FlowReturn.EOS
        buf = sample.get_buffer()
        if self._video_info is None:
            self._video_info = self._parse_caps(sample)
            w, h = self._video_info
            if (h * 3 // 2, w) != self.frame_shape:
                print(
                    f"GstAppBridge: stream is {w}x{h} but the pipeline was "
                    f"configured for frame_shape={self.frame_shape} — "
                    f"frames will be DROPPED; pass matching "
                    f"--width/--height", flush=True)
        ok, mapinfo = buf.map(gst.MapFlags.READ)
        if not ok:
            return gst.FlowReturn.ERROR
        try:
            rows, width = self.frame_shape
            w, h = self._video_info
            if (h * 3 // 2, w) != (rows, width):
                self.feeder.counters.count("processing_errors")
                return gst.FlowReturn.OK  # mismatched stream: drop, counted
            data = np.frombuffer(mapinfo.data, dtype=np.uint8)
            if data.size < rows * width:
                self.feeder.counters.count("processing_errors")
                return gst.FlowReturn.OK  # short buffer: count + skip
            frame = data[: rows * width].reshape(rows, width).copy()
        finally:
            buf.unmap(mapinfo)
        meta = {
            "pts": getattr(buf, "pts", None),
            "dts": getattr(buf, "dts", None),
            "duration": getattr(buf, "duration", None),
        }
        self.feeder.submit(frame, meta=meta)
        return gst.FlowReturn.OK

    def _parse_caps(self, sample) -> tuple[int, int]:
        """Cache (width, height) from the first sample's caps — the
        GstVideoInfo-once pattern of OpenCVequalHist.cpp:80-87."""
        try:
            s = sample.get_caps().get_structure(0)
            return (s.get_value("width"), s.get_value("height"))
        except Exception:
            rows, width = self.frame_shape
            return (width, rows * 2 // 3)

    # ---- output side (feeder thread) ----

    def _on_feeder_output(self, seq: int, frame: np.ndarray, meta: Any) -> None:
        gst = self.gst
        buf = gst.Buffer.new_wrapped(frame.tobytes())
        none = gst.CLOCK_TIME_NONE
        if self.policy is TimestampPolicy.RELAY:
            buf.pts = none
            buf.dts = none
            buf.duration = none
        elif self.policy is TimestampPolicy.SYNTHESIZE:
            pts = self._out_count * self.frame_duration_ns
            buf.pts = pts
            buf.dts = pts
            buf.duration = self.frame_duration_ns
        else:  # COPY
            m = meta or {}
            buf.pts = m.get("pts") if m.get("pts") is not None else none
            buf.dts = m.get("dts") if m.get("dts") is not None else none
            buf.duration = (m.get("duration")
                            if m.get("duration") is not None else none)
        self._out_count += 1
        ret = self._appsrc.emit("push-buffer", buf)
        if ret != gst.FlowReturn.OK:
            raise RuntimeError(f"push-buffer returned {ret}")  # counted by
            # the feeder as a push_failure (reference :184-186 semantics)

    # ---- bus handling (EOS protocol of CLAHECompare.cpp:207-281) ----

    def _on_capture_message(self, bus, msg) -> None:
        gst = self.gst
        t = msg.type
        if t == gst.MessageType.EOS:
            if self.loop:
                self.capture.seek_simple(
                    gst.Format.TIME,
                    gst.SeekFlags.FLUSH | gst.SeekFlags.KEY_UNIT,
                    0,
                )
            else:
                # drain everything queued, then propagate EOS downstream so
                # the muxer can finalize (the dual-EOS handshake)
                self.feeder.stop(drain=True)
                self._appsrc.emit("end-of-stream")
        elif t == gst.MessageType.ERROR:
            self.stop()

    def _on_emit_message(self, bus, msg) -> None:
        gst = self.gst
        t = msg.type
        if t == gst.MessageType.EOS:
            # output finalized (e.g. MP4 moov written)
            self.emit.set_state(gst.State.NULL)
            self.capture.set_state(gst.State.NULL)
            self._finished.set()
            self.on_stop()
        elif t == gst.MessageType.ERROR:
            self.stop()
