"""Out-of-order frame resequencer with late-drop.

Rebuilds the binary-only capability of the reference's ``improvement`` ELF
(SURVEY §2): a ``std::map<uint64_t, ProcessedFrame*>`` that re-orders frames
completed out of order by worker threads before the appsrc push, drops
frames that arrive after their slot has been given up (the ELF's
``Frames dropped (late)`` counter), and bounds its own memory by skipping
ahead when too many frames are pending.

The port's own copy of ``opencv_opencl_tpu/runtime/sequencer.py``.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["Resequencer"]


class Resequencer:
    """Emit (seq, frame) pairs in strictly increasing seq order.

    Parameters
    ----------
    emit: called with (seq, frame) for every in-order frame.
    max_pending: when more than this many frames wait on a gap, the gap is
        declared lost — the sequencer skips to the oldest pending frame
        (counting the skipped slots in ``frames_lost``) so a dead worker
        can't stall the stream.
    """

    def __init__(self, emit: Callable[[int, Any], None], max_pending: int = 16):
        self.emit = emit
        self.max_pending = max_pending
        self.next_seq = 0
        self.pending: dict[int, Any] = {}
        self.dropped_late = 0
        self.frames_lost = 0
        self.emitted = 0

    def push(self, seq: int, frame: Any) -> None:
        if seq < self.next_seq:
            # its slot was already skipped/emitted: the late-drop path
            self.dropped_late += 1
            return
        self.pending[seq] = frame
        self._drain()
        if len(self.pending) > self.max_pending:
            # give up on the gap: skip to the oldest pending frame
            oldest = min(self.pending)
            self.frames_lost += oldest - self.next_seq
            self.next_seq = oldest
            self._drain()

    def _drain(self) -> None:
        while self.next_seq in self.pending:
            frame = self.pending.pop(self.next_seq)
            self.emit(self.next_seq, frame)
            self.next_seq += 1
            self.emitted += 1

    def flush(self) -> None:
        """Emit everything still pending, in order (end-of-stream)."""
        for seq in sorted(self.pending):
            self.frames_lost += seq - self.next_seq
            self.emit(seq, self.pending[seq])
            self.next_seq = seq + 1
            self.emitted += 1
        self.pending.clear()
