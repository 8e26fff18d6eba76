"""Streaming counters + periodic status reporting.

Rebuilds the reference's L4 instrumentation:

- ``FrameRateCounters`` — the atomic per-stage frame/byte counters
  (``OpenCVequalHist.cpp:20-30``, ``OpenCLequalHist.cpp:39-61``);
- ``StatusReporter`` — the 2-second status tick with the exact fields of the
  CPU build (``OpenCVequalHist.cpp:200-234``) and the richer FPGA build with
  bitrate + status classification (``OpenCLequalHist.cpp:439-508``):
  ACTIVE / IDLE / QUEUE BACKLOG / ACCEL ERRORS / PROCESSING ERRORS.

Counters are plain ints guarded by a lock: Python threads hammering
``count()`` from feeder callbacks need the same semantics the reference got
from ``std::atomic`` with relaxed ordering.

The port's own copy of ``opencv_opencl_tpu/metrics/counters.py``.
"""

from __future__ import annotations

import threading
import time

__all__ = ["FrameRateCounters", "StatusReporter", "classify_status"]


class FrameRateCounters:
    """Per-stage frame/byte/error counters (thread-safe)."""

    STAGES = (
        "camera_frames",        # capture-side pad probe
        "input_frames",         # frames entering the processing queue
        "output_frames",        # frames processed (worker/feeder output)
        "encoder_frames",       # frames delivered to the encoder side
        "encoder_bytes",        # bytes delivered to the encoder side
        "processing_errors",
        "push_failures",
        "accel_errors",         # device-side failures (the opencl_errors slot)
        "dropped_late",         # resequencer late-drops (reference `improvement` ELF)
        "dropped_overflow",     # leaky-queue drops
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v = {s: 0 for s in self.STAGES}

    def count(self, stage: str, n: int = 1) -> None:
        with self._lock:
            self._v[stage] += n

    def get(self, stage: str) -> int:
        with self._lock:
            return self._v[stage]

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._v)


def classify_status(
    *,
    accel_errors: int,
    processing_errors: int,
    queue_length: int,
    output_fps: float,
    backlog_threshold: int = 5,
) -> str:
    """The reference's status classifier (``OpenCLequalHist.cpp:467-479``)."""
    if accel_errors > 0:
        return "ACCEL ERRORS"
    if processing_errors > 0:
        return "PROCESSING ERRORS"
    if queue_length > backlog_threshold:
        return "QUEUE BACKLOG"
    if output_fps > 0:
        return "ACTIVE"
    return "IDLE"


class StatusReporter:
    """Periodic (default 2 s) status block over a FrameRateCounters.

    ``tick()`` computes interval rates from counter deltas and returns the
    formatted block; ``start()`` runs it on a daemon timer thread (the GLib
    ``g_timeout_add_seconds(2, ...)`` equivalent).  ``queue_length_fn`` and
    ``avg_process_ms_fn`` are optional live probes into the runtime.
    """

    def __init__(
        self,
        counters: FrameRateCounters,
        interval_s: float = 2.0,
        queue_length_fn=None,
        avg_process_ms_fn=None,
        num_workers: int = 1,
        printer=print,
    ) -> None:
        self.counters = counters
        self.interval_s = interval_s
        self.queue_length_fn = queue_length_fn or (lambda: 0)
        self.avg_process_ms_fn = avg_process_ms_fn or (lambda: 0.0)
        self.num_workers = num_workers
        self.printer = printer
        self._prev = counters.snapshot()
        self._prev_t = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_status = "IDLE"

    def tick(self) -> str:
        now = time.monotonic()
        dt = max(now - self._prev_t, 1e-9)
        cur = self.counters.snapshot()
        rate = {k: (cur[k] - self._prev[k]) / dt for k in cur}
        self._prev, self._prev_t = cur, now

        qlen = self.queue_length_fn()
        avg_ms = self.avg_process_ms_fn()
        bitrate_kbps = rate["encoder_bytes"] * 8.0 / 1000.0
        self.last_status = classify_status(
            accel_errors=cur["accel_errors"],
            processing_errors=cur["processing_errors"],
            queue_length=qlen,
            output_fps=rate["output_frames"],
        )
        block = (
            f"\n=== FRAME RATE MONITORING (every {self.interval_s:.0f}s) ===\n"
            f"Camera Capture Rate: {rate['camera_frames']:6.1f} fps\n"
            f"Input Rate:          {rate['input_frames']:6.1f} fps\n"
            f"Output Rate:         {rate['output_frames']:6.1f} fps\n"
            f"Encoder Input Rate:  {rate['encoder_frames']:6.1f} fps\n"
            f"Output Bitrate:      {bitrate_kbps:6.1f} kbps\n"
            f"\n"
            f"Queue Length: {qlen} | Processing Errors: "
            f"{cur['processing_errors'] + cur['accel_errors']} | "
            f"Push Failures: {cur['push_failures']} | "
            f"Frames dropped (late): {cur['dropped_late']} | "
            f"Avg Process Time: {avg_ms:.2f} ms\n"
            f"Processing Status: {self.last_status} "
            f"(workers={self.num_workers}, avg_frame_time={avg_ms:.1f}ms)\n"
        )
        self.printer(block)
        return block

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.tick()

        self._thread = threading.Thread(target=loop, daemon=True, name="status-tick")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)
            self._thread = None
