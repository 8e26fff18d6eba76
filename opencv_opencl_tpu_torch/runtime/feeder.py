"""Host->device double-buffered frame feeder — the processing engine.

The port's own copy of ``opencv_opencl_tpu/runtime/feeder.py``, with the
C++ staging ring of the port's ``native`` package behind
``native_staging``: the same frames give the same outputs, order and
stats.  One option is the port's: ``whole_batches``, for a step that is a
collective over several processes (``parallel/sharded.ShardedEnhancer`` in a
process group), where every process must cut the same frames into the same
batches whatever its timing; it holds on both staging paths.

Two faults of the JAX package's native path are repaired here.  Its loop
stops at the first pop that times out once ``stop()`` has begun, so a frame
submitted between that pop and the ring's close is lost; here the loop
stops only when the closed ring is empty and no ``submit()`` is inside the
ring's push (which checks ``closed`` before it copies the frame in).  And
it forgets the metas of sequence numbers below the oldest one popped,
which loses the meta of a frame whose producer took its number first but
pushed it last; here a meta is forgotten only when its frame is emitted or
dropped.

reference                                  here
---------------------------------------   -----------------------------------
appsink cb -> GAsyncQueue (O(1) ref)       submit() -> LeakyQueue, or the
                                             C++ ring (native_staging)
1-8 worker threads pop + process           feeder thread batches frames and
  (OpenCVequalHist.cpp:102-196)              dispatches the batch step
ARM->FPGA DMA write/exec/read              H2D copy + kernel launches +
  (OpenCLequalHist.cpp:346-365)              overlapped host readback
ProcessedFrame re-order map (binary-only)  Resequencer
appsrc push                                on_output callback

Double buffering: kernel launches are asynchronous, so the feeder keeps up
to ``depth`` batches in flight — while batch i runs on the device, batch
i+1 is staged and dispatched; only then is batch i's result materialized
to host memory (``np.asarray`` of what ``process_batch`` returned, a
``runtime.handoff.DeviceBatch`` in the port).

The ``workers`` knob of the reference CLIs (clamped to 8,
``OpenCVequalHist.cpp:274-275``) maps to ``depth`` here.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import numpy as np

from opencv_opencl_tpu_torch.metrics.counters import FrameRateCounters
from opencv_opencl_tpu_torch.metrics.timing import TimingStats
from opencv_opencl_tpu_torch.runtime.queues import (
    Closed,
    LeakyQueue,
    PriorityLeakyQueue,
)
from opencv_opencl_tpu_torch.runtime.sequencer import Resequencer

__all__ = ["FrameFeeder"]

_POP_TIMEOUT_S = 0.05  # the reference workers' 50 ms timeout pop


def _staging_shape(native_staging) -> tuple[int, ...]:
    """``native_staging`` as the frame shape of the C++ ring's slots."""
    try:
        shape = tuple(int(d) for d in native_staging)
    except TypeError:
        shape = ()
    if not shape or min(shape) < 1:
        raise ValueError(f"native_staging takes the frame shape (rows, width), "
                         f"got {native_staging!r}")
    return shape


class FrameFeeder:
    """Streaming frame processor around a batch step.

    Parameters
    ----------
    process_batch: callable mapping uint8 (N, rows, W) -> an array-like of
        the same shape (e.g. ``Enhancer.process_batch``). N may vary per
        call up to ``batch_size``.
    batch_size: max frames fused into one device dispatch.
    depth: in-flight batches (double buffering at 2; reference --workers).
    queue_capacity: input LeakyQueue size (reference max-size-buffers=8).
    on_output: called with (seq, np.uint8 frame, meta) in seq order.
    native_staging: the frame shape (rows, width): stage frames through
        the C++ preallocated ring (GIL-free memcpy, and the batch popped
        straight into a staging slot; the reference's preallocated
        GstBuffer pool); metas ride a Python dict.  Where the native
        library cannot be built the Python queue takes over, as in the JAX
        package.
    whole_batches: dispatch only full batches of ``batch_size`` frames (and
        the remainder when the feeder stops), never what happens to be
        queued: the batches then depend on the frames alone, not on timing.
    """

    def __init__(
        self,
        process_batch: Callable,
        batch_size: int = 4,
        depth: int = 2,
        queue_capacity: int = 8,
        on_output: Callable[[int, np.ndarray, Any], None] | None = None,
        counters: FrameRateCounters | None = None,
        timing: TimingStats | None = None,
        pad_batches: bool = True,
        native_staging: bool | tuple[int, ...] = False,
        priority_of: Callable | None = None,
        on_drop_item: Callable | None = None,
        whole_batches: bool = False,
    ) -> None:
        self.process_batch = process_batch
        self.batch_size = max(1, batch_size)
        self.depth = min(max(1, depth), 8)
        self.on_output = on_output or (lambda seq, frame, meta: None)
        self.counters = counters or FrameRateCounters()
        self.timing = timing or TimingStats(label="feeder")
        self.pad_batches = pad_batches
        self.whole_batches = whole_batches
        self._native = None
        self._native_shape = None
        self._native_metas: dict[int, Any] = {}
        self._meta_lock = threading.Lock()
        self._pushing = 0  # submit() calls inside the ring's push
        if native_staging:
            shape = _staging_shape(native_staging)
            from opencv_opencl_tpu_torch import native

            if native.available():
                self._native_shape = shape
                self._native = native.NativeRing(queue_capacity,
                                                 int(np.prod(shape)))
        # QoS + native staging compose: the C++ ring's priority-aware
        # eviction (fp_ring_push_prio) reports WHICH seq it evicted, so
        # per-stream drop accounting stays truthful on the GIL-free path
        self._priority_of = priority_of
        self._on_drop_item = on_drop_item

        def _note_drop(item):
            self.counters.count("dropped_overflow")
            if on_drop_item is not None:
                on_drop_item(item)

        qkw = dict(max_size=queue_capacity, on_drop=_note_drop)
        if priority_of is not None:
            self._inq = PriorityLeakyQueue(priority_of=priority_of, **qkw)
        else:
            self._inq = LeakyQueue(**qkw)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._out_seq = 0  # dense output ordering, assigned at dispatch
        self._reseq = Resequencer(self._emit)
        self._inflight: list[tuple] = []
        # preallocated host staging buffers (one per in-flight batch + 1):
        # no per-batch np.stack allocation — the analogue of the reference's
        # pre-allocated per-worker CL buffers (OpenCLequalHist.cpp:175-192).
        # A slot is recycled only once its batch retires, so it can never be
        # rewritten while a (possibly zero-copy) transfer still reads it.
        self._staging_free: list[np.ndarray] = []
        self._staging_shape: tuple[int, ...] | None = None
        self._thread: threading.Thread | None = None

    # ---- input side (any thread) ----

    def submit(self, frame: np.ndarray, meta: Any = None) -> int:
        """O(1) enqueue of one frame; returns its sequence number."""
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        self.counters.count("input_frames")
        # a frame arriving after stop() (the appsink callback can race
        # shutdown) degrades to a drop — never an exception in the caller
        if self._native is not None:
            self._native_submit(seq, frame, meta)
            return seq
        try:
            self._inq.put((seq, np.asarray(frame), meta))
        except Closed:
            self.counters.count("dropped_overflow")
        return seq

    def _native_submit(self, seq: int, frame: np.ndarray, meta: Any) -> None:
        flat = np.asarray(frame).reshape(-1)
        prio = (int(self._priority_of((seq, frame, meta)))
                if self._priority_of is not None else 0)
        with self._meta_lock:
            self._native_metas[seq] = meta
            self._pushing += 1
        try:
            # uniform priority (no priority_of) degrades to the plain
            # drop-oldest policy, but the ring still reports WHICH seq it
            # evicted, keeping per-stream accounting truthful
            status, evicted_seq = self._native.push_prio(flat, seq, prio)
        except RuntimeError:  # ring closed
            status, evicted_seq = "rejected", None
        finally:
            with self._meta_lock:
                self._pushing -= 1
        if status == "ok":
            return
        self.counters.count("dropped_overflow")
        if status == "rejected":
            # the incoming frame itself was dropped
            with self._meta_lock:
                self._native_metas.pop(seq, None)
            if self._on_drop_item is not None:
                self._on_drop_item((seq, frame, meta))
        else:
            # evicted: attribute the drop to the EVICTED frame's stream,
            # not the new one's
            with self._meta_lock:
                ev_meta = self._native_metas.pop(evicted_seq, None)
            if self._on_drop_item is not None:
                self._on_drop_item((evicted_seq, None, ev_meta))

    def queue_length(self) -> int:
        if self._native is not None:
            return len(self._native)
        return len(self._inq)

    def _acquire_slot(self, frame_shape: tuple[int, ...]) -> np.ndarray:
        shape = (self.batch_size, *frame_shape)
        if self._staging_shape != shape:
            self._staging_shape = shape
            self._staging_free = [
                np.empty(shape, np.uint8) for _ in range(self.depth + 2)
            ]
        return (self._staging_free.pop() if self._staging_free
                else np.empty(shape, np.uint8))

    def _native_pop(self, slot: np.ndarray, start: int) -> list | None:
        """Pop up to ``batch_size - start`` frames from the C++ ring
        straight into rows ``start`` on of the staging ``slot`` (the ring's
        GIL-free memcpy is the only copy).  Returns the items, [] on a
        timeout, None once the ring is closed and empty."""
        n, seqs = self._native.pop_batch(
            slot.reshape(self.batch_size, -1)[start:], self.batch_size - start,
            timeout_ms=int(_POP_TIMEOUT_S * 1000))
        if n < 0:
            return None
        with self._meta_lock:
            return [(int(seq), slot[start + i], self._native_metas.pop(int(seq), None))
                    for i, seq in enumerate(seqs[:n])]

    # ---- output side (feeder thread) ----

    def _emit(self, seq: int, item: tuple[np.ndarray, Any]) -> None:
        frame, meta = item
        self.counters.count("output_frames")
        try:
            self.on_output(seq, frame, meta)
        except Exception:
            self.counters.count("push_failures")

    def _retire_oldest(self) -> None:
        entries, device_out, t_dispatch, slot = self._inflight.pop(0)
        t0 = time.perf_counter()
        host = np.asarray(device_out)  # blocks until device done + D2H copy
        mem_ms = (time.perf_counter() - t0) * 1e3
        compute_ms = (t0 - t_dispatch) * 1e3
        self.timing.record(compute_ms, mem_ms, compute_ms + mem_ms)
        for i, (seq, meta) in enumerate(entries):
            self._reseq.push(seq, (host[i], meta))
        del device_out
        if slot is not None and slot.shape == self._staging_shape:
            # shape-tag check: a mid-stream frame-shape change resets the
            # pool; stale-shape slots must not poison it
            self._staging_free.append(slot)

    def _stage(self, frames: list[np.ndarray],
               slot: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Assemble a batch into a recycled staging buffer (alloc-free in
        steady state).  Returns (batch_view, slot).  A pre-filled ``slot``
        (the native ring's pop target) skips the copy."""
        if slot is None:
            slot = self._acquire_slot(frames[0].shape)
            for i, f in enumerate(frames):
                np.copyto(slot[i], f)
        if self.pad_batches and len(frames) < self.batch_size:
            # keep the device shape static: pad with repeats of the last
            for i in range(len(frames), self.batch_size):
                np.copyto(slot[i], frames[-1])
            return slot, slot
        return slot[: len(frames)], slot

    def _dispatch(self, items: list[tuple[int, np.ndarray, Any]],
                  slot: np.ndarray | None = None) -> None:
        frames = [f for (_, f, _) in items]
        n = len(frames)
        batch, slot = self._stage(frames, slot)
        t_dispatch = time.perf_counter()
        try:
            out = self.process_batch(batch)
        except Exception:
            self.counters.count("processing_errors", n)
            if slot.shape == self._staging_shape:
                self._staging_free.append(slot)
            return  # no output seqs consumed -> no resequencer gap
        # dense output sequence assigned at dispatch (queue drops and
        # processing errors therefore never create gaps the resequencer
        # would stall on — the stream degrades to drops, never to stalls)
        entries = [(self._out_seq + i, meta)
                   for i, (_, _, meta) in enumerate(items)]
        self._out_seq += len(items)
        self._inflight.append((entries, out, t_dispatch, slot))
        while len(self._inflight) >= self.depth:
            self._retire_oldest()

    def _run(self) -> None:
        pending: list = []  # whole_batches: frames waiting for a full batch
        slot = None         # native staging: the slot `pending` lies in
        while True:
            if self._native is not None:
                if slot is None:
                    slot = self._acquire_slot(self._native_shape)
                got = self._native_pop(slot, len(pending))
                if got is None:
                    # closed and empty, unless a submit() is still inside
                    # the ring's push: the ring checks `closed` before its
                    # copy, so that frame lands after this pop
                    if self._pushing:
                        time.sleep(0.001)
                        continue
                    break
            else:
                try:
                    got = self._inq.get_batch(self.batch_size - len(pending),
                                              timeout=_POP_TIMEOUT_S)
                except Closed:
                    break
                except TimeoutError:
                    got = []
            if not got:
                # idle: retire in-flight work so latency stays low.  Not a
                # reason to stop, even once stop() has begun: a frame put
                # just after this timeout would be lost; the closed queue
                # (or ring) says so once it is drained
                while self._inflight:
                    self._retire_oldest()
                continue
            if self.whole_batches:
                pending += got
                if len(pending) < self.batch_size:
                    continue
                got, pending = pending, []
            self._dispatch_counted(got, slot)
            slot = None
        if pending:
            self._dispatch_counted(pending, slot)
        elif slot is not None:
            self._staging_free.append(slot)
        while self._inflight:
            self._retire_oldest()
        self._reseq.flush()

    def _dispatch_counted(self, got: list, slot: np.ndarray | None) -> None:
        try:
            self._dispatch(got, slot)
        except Exception:
            # staging/assembly failures must not kill the feeder
            # thread — count and keep streaming (drop semantics)
            self.counters.count("processing_errors", len(got))

    # ---- lifecycle ----

    def start(self) -> "FrameFeeder":
        if self._thread is not None:
            raise RuntimeError("feeder already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="torch-feeder")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 600.0) -> None:
        """Stop the feeder; with drain=True, process everything queued first.

        ``timeout`` bounds the join — generous by default because the very
        first dispatch may include the kernels' build (the reference's
        equivalent one-time cost is the xclbin load).
        """
        if self._thread is None:
            return
        if not drain:
            self._inq.clear()
        self._inq.close()  # queued frames still drain; get raises Closed after
        if self._native is not None:
            # queued frames still drain: pop returns -1 only once the closed
            # ring is empty; later submit() calls are dropped, not queued
            # where no one pops them
            self._native.close()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self.counters.count("processing_errors")
        self._thread = None

    def warmup(self, frame_shape: tuple[int, ...]) -> None:
        """Run the batch step once before streaming starts (builds the
        kernels) — the analogue of the reference loading the FPGA bitstream
        before PLAYING (OpenCLequalHist.cpp:106-140)."""
        dummy = np.zeros((self.batch_size, *frame_shape), dtype=np.uint8)
        np.asarray(self.process_batch(dummy))

    @property
    def stats(self) -> dict[str, int]:
        s = self.counters.snapshot()
        s["dropped_late"] = self._reseq.dropped_late
        s["frames_lost"] = self._reseq.frames_lost
        s["emitted"] = self._reseq.emitted
        return s
