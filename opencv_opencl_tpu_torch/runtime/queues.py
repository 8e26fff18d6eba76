"""Leaky frame queue — the L2 transport primitive.

Rebuilds the reference's backpressure design: GStreamer ``queue
leaky=downstream max-size-buffers=N`` plus ``appsink max-buffers=1
drop=true`` (``OpenCVequalHist.cpp:292-298,310-331``): under overload the
*oldest* queued frame is dropped so the stream degrades to frame drops and
never stalls (latency-first).

The port's own copy of ``opencv_opencl_tpu/runtime/queues.py``.
"""

from __future__ import annotations

import collections
import threading
from typing import Any

__all__ = ["LeakyQueue", "PriorityLeakyQueue", "Closed"]


class Closed(Exception):
    """Raised by get() after close() once the queue is drained."""


class LeakyQueue:
    """Bounded thread-safe FIFO that drops the oldest item when full.

    ``put`` never blocks (O(1) ref+enqueue, like the reference's appsink
    callback ``OpenCVequalHist.cpp:71-98``); ``get`` blocks with an optional
    timeout (the workers' 50 ms ``g_async_queue_timeout_pop``).
    """

    def __init__(self, max_size: int = 8, on_drop=None) -> None:
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max_size = max_size
        self.on_drop = on_drop
        self._q: collections.deque[Any] = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self.dropped = 0

    def put(self, item: Any) -> bool:
        """Enqueue; returns False if an old frame was dropped to make room."""
        dropped_item = None
        with self._lock:
            if self._closed:
                raise Closed("queue is closed")
            if len(self._q) >= self.max_size:
                dropped_item = self._q.popleft()
                self.dropped += 1
            self._q.append(item)
            self._not_empty.notify()
        if dropped_item is not None and self.on_drop is not None:
            self.on_drop(dropped_item)
        return dropped_item is None

    def get(self, timeout: float | None = None) -> Any:
        """Dequeue; raises TimeoutError on timeout, Closed when drained."""
        with self._not_empty:
            while not self._q:
                if self._closed:
                    raise Closed("queue is closed")
                if not self._not_empty.wait(timeout):
                    raise TimeoutError("queue get timed out")
            return self._q.popleft()

    def get_batch(self, max_items: int, timeout: float | None = None) -> list[Any]:
        """Dequeue 1..max_items items: blocks for the first, then drains
        whatever else is immediately available (batching for the device)."""
        first = self.get(timeout)
        out = [first]
        with self._lock:
            while self._q and len(out) < max_items:
                out.append(self._q.popleft())
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def clear(self) -> int:
        """Discard everything queued; returns the number discarded."""
        with self._lock:
            n = len(self._q)
            self._q.clear()
            return n

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()


class PriorityLeakyQueue(LeakyQueue):
    """LeakyQueue whose overflow eviction honors per-item priorities.

    On overflow the OLDEST item among those with the LOWEST priority is
    evicted; an incoming item ranking below everything queued is dropped
    itself.  Equal priorities degrade to the plain drop-oldest policy.
    ``priority_of(item) -> int`` (higher = more important) is consulted
    only on overflow, so the happy path stays O(1); the scan is bounded
    by ``max_size`` (small by design).

    The serving QoS hook: `StreamMux(priorities=...)` routes premium
    streams' frames here so congestion sheds best-effort streams first —
    beyond the reference, whose single queue drops blindly
    (``OpenCVequalHist.cpp:71-98``).
    """

    def __init__(self, max_size: int = 8, on_drop=None,
                 priority_of=None) -> None:
        super().__init__(max_size=max_size, on_drop=on_drop)
        self._prio = priority_of or (lambda item: 0)

    def put(self, item: Any) -> bool:
        dropped_item = None
        with self._lock:
            if self._closed:
                raise Closed("queue is closed")
            if len(self._q) >= self.max_size:
                p_new = self._prio(item)
                idx = 0
                p_min = None
                for i, it in enumerate(self._q):
                    p = self._prio(it)
                    if p_min is None or p < p_min:
                        idx, p_min = i, p
                if p_min is not None and p_min <= p_new:
                    dropped_item = self._q[idx]
                    del self._q[idx]
                else:
                    dropped_item = item  # incoming ranks below the queue
                    item = None
                self.dropped += 1
            if item is not None:
                self._q.append(item)
                self._not_empty.notify()
        if dropped_item is not None and self.on_drop is not None:
            self.on_drop(dropped_item)
        return dropped_item is None
