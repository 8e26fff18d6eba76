"""File/synthetic video sources and sinks producing NV12 frames.

The port's own copy of ``opencv_opencl_tpu/io/videofile.py``: the same
frames from ``TestSource`` for the same seed; ``FileSource`` and
``FileSink`` import cv2 when they are constructed, not before.

The host-side replacement for the reference's GStreamer capture/emit
pipelines when no GStreamer stack is present: ``filesrc -> decodebin ->
videoconvert/scale/rate -> NV12 -> appsink`` (``CLAHECompare.cpp:419-423``)
becomes :class:`FileSource` (cv2.VideoCapture + exact BGR->NV12), the
``appsrc -> enc -> mp4mux -> filesink`` branch becomes :class:`FileSink`
(cv2.VideoWriter), and ``videotestsrc`` (``webrtc/vad.cpp:312``) becomes
:class:`TestSource`.  ``--loop`` playback (flushing seek on EOS,
``CLAHECompare.cpp:216-225``) is a FileSource option.
"""

from __future__ import annotations

import numpy as np

from opencv_opencl_tpu_torch.core import color as gcolor
from opencv_opencl_tpu_torch.core.frames import FrameSpec

__all__ = ["FileSource", "TestSource", "FileSink", "RawSink", "NullSink",
           "resample_fps"]


def resample_fps(frames, src_fps: float, dst_fps: float):
    """Drop/duplicate frames to convert ``src_fps`` -> ``dst_fps`` (the
    GStreamer ``videorate`` element's caps-rate conversion,
    ``CLAHECompare.cpp:419-423``): output slot k takes the nearest source
    frame round(k * src/dst)."""
    if src_fps <= 0 or dst_fps <= 0 or abs(src_fps - dst_fps) < 1e-9:
        yield from frames
        return
    ratio = src_fps / dst_fps
    k = 0
    for i, f in enumerate(frames):
        while int(k * ratio + 0.5) == i:
            yield f
            k += 1


class FileSource:
    """Decode a video file to NV12 frames (optionally resized / looped)."""

    def __init__(self, path: str, width: int | None = None,
                 height: int | None = None, loop: bool = False):
        import cv2

        self._cv2 = cv2
        self.path = path
        self.loop = loop
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        src_w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        src_h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        w = width or src_w
        h = height or src_h
        w -= w % 2
        h -= h % 2
        self.spec = FrameSpec(width=w, height=h, fps=fps)
        self.loops_done = 0

    def read(self) -> np.ndarray | None:
        """Next NV12 frame, or None at end of stream (after loop handling)."""
        ok, bgr = self.cap.read()
        if not ok:
            if self.loop:
                # the reference's flushing seek back to 0 on EOS
                self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
                self.loops_done += 1
                ok, bgr = self.cap.read()
            if not ok:
                return None
        if bgr.shape[1] != self.spec.width or bgr.shape[0] != self.spec.height:
            bgr = self._cv2.resize(bgr, (self.spec.width, self.spec.height))
        return gcolor.bgr2nv12(bgr)

    def __iter__(self):
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def close(self) -> None:
        self.cap.release()


class TestSource:
    """Synthetic NV12 source (the ``videotestsrc`` stand-in): a moving
    gradient with per-frame noise, deterministic per seed."""

    def __init__(self, spec: FrameSpec, num_frames: int | None = None, seed: int = 0):
        self.spec = spec
        self.num_frames = num_frames
        self._rng = np.random.default_rng(seed)
        self._i = 0
        base = np.linspace(0, 255, spec.width, dtype=np.float32)[None, :]
        self._base = np.broadcast_to(base, (spec.height, spec.width))

    def read(self) -> np.ndarray | None:
        if self.num_frames is not None and self._i >= self.num_frames:
            return None
        shift = (self._i * 7) % self.spec.width
        y = np.roll(self._base, shift, axis=1)
        y = np.clip(
            y + self._rng.normal(0, 12, y.shape), 0, 255
        ).astype(np.uint8)
        uv = self._rng.integers(96, 160, (self.spec.height // 2, self.spec.width),
                                dtype=np.uint8)
        self._i += 1
        return np.concatenate([y, uv], axis=0)

    def __iter__(self):
        while True:
            f = self.read()
            if f is None:
                return
            yield f


class FileSink:
    """Encode NV12 frames to a video file (the mp4mux -> filesink branch)."""

    def __init__(self, path: str, spec: FrameSpec, fourcc: str = "mp4v"):
        import cv2

        self._cv2 = cv2
        self.spec = spec
        self.writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*fourcc), spec.fps,
            (spec.width, spec.height),
        )
        if not self.writer.isOpened():
            raise IOError(f"cannot open video writer: {path}")
        self.frames = 0

    def write(self, nv12: np.ndarray) -> None:
        bgr = self._cv2.cvtColor(nv12, self._cv2.COLOR_YUV2BGR_NV12)
        self.writer.write(bgr)
        self.frames += 1

    def close(self) -> None:
        """Finalize the container (the reference's dual-EOS mp4 handshake,
        ``CLAHECompare.cpp:226-243``, collapses to an explicit close here)."""
        self.writer.release()


class RawSink:
    """Append raw NV12 bytes to a file (debug / pipe-to-gstreamer)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.frames = 0

    def write(self, nv12: np.ndarray) -> None:
        self.f.write(np.ascontiguousarray(nv12).tobytes())
        self.frames += 1

    def close(self) -> None:
        self.f.close()


class NullSink:
    """Discard frames (throughput benchmarking)."""

    def __init__(self):
        self.frames = 0

    def write(self, nv12: np.ndarray) -> None:
        self.frames += 1

    def close(self) -> None:
        pass
