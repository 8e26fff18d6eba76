"""Frame-rate governor — the ``videorate drop-only=true max-rate=N`` stage.

The port's own copy of ``opencv_opencl_tpu/runtime/governor.py``.

The reference caps the camera rate by dropping frames in GStreamer
(``OpenCVequalHist.cpp:294-295``); this is the host-side equivalent for
non-GStreamer sources: a deterministic drop-only limiter that never
duplicates and never stalls.
"""

from __future__ import annotations

import time

__all__ = ["RateGovernor", "AdaptiveRateGovernor",
           "feed_governor_from_rtcp"]


class RateGovernor:
    """Drop-only rate limiter: ``admit()`` returns False for frames that
    would exceed ``max_rate`` (frames/second)."""

    def __init__(self, max_rate: float, clock=time.monotonic):
        if max_rate <= 0:
            raise ValueError("max_rate must be > 0")
        self.period = 1.0 / max_rate
        self.clock = clock
        self._next_due = None
        self.admitted = 0
        self.dropped = 0

    def admit(self) -> bool:
        now = self.clock()
        if self._next_due is None:
            self._next_due = now + self.period
            self.admitted += 1
            return True
        if now >= self._next_due:
            # schedule from the slot grid, not from `now`, so sustained
            # input converges to exactly max_rate (videorate semantics)
            self._next_due += self.period
            if self._next_due < now:  # fell behind: resync
                self._next_due = now + self.period
            self.admitted += 1
            return True
        self.dropped += 1
        return False


class AdaptiveRateGovernor(RateGovernor):
    """Congestion-aware drop-only limiter: the admitted rate follows RTCP
    receiver reports with an AIMD-style loop (multiplicative backoff on
    loss, gentle recovery on clean reports), capped at the configured
    ceiling.

    The reference only has the static ``videorate max-rate`` cap
    (``OpenCVequalHist.cpp:294-295``) and leaves congestion to the
    encoder's ``control-rate=low-latency``; with the native RTP plane the
    far end's RRs (``io/rtcp.py``) carry ``fraction_lost``, so the relay
    can shed frames *before* the network does — the loss-based half of a
    WebRTC-style congestion controller.
    """

    def __init__(self, max_rate: float, min_rate: float = 1.0,
                 clock=time.monotonic, loss_threshold: float = 0.02,
                 backoff: float = 0.7, recover: float = 1.05):
        super().__init__(max_rate, clock)
        if not (0 < backoff < 1) or recover < 1:
            raise ValueError("need 0 < backoff < 1 and recover >= 1")
        self.ceiling = float(max_rate)
        self.min_rate = float(min_rate)
        self.rate = float(max_rate)
        self.loss_threshold = loss_threshold
        self.backoff = backoff
        self.recover = recover
        self.backoffs = 0

    def _set_rate(self, rate: float) -> None:
        rate = min(max(rate, self.min_rate), self.ceiling)
        if rate != self.rate:
            self.rate = rate
            self.period = 1.0 / rate
            # re-anchor the slot grid so the new period takes effect now
            self._next_due = None

    def on_receiver_report(self, fraction_lost: int) -> float:
        """Feed one RR's ``fraction_lost`` (0..255); returns the new rate."""
        loss = fraction_lost / 256.0
        if loss > self.loss_threshold:
            self.backoffs += 1
            self._set_rate(self.rate * self.backoff)
        else:
            self._set_rate(self.rate * self.recover)
        return self.rate


def feed_governor_from_rtcp(governor: AdaptiveRateGovernor, sink,
                            label: str = "") -> None:
    """Drain a sink's pending RTCP receiver reports into the governor.

    One BACKOFF decision per drain: a burst of queued RRs (a stalled
    main loop, a fast reporter) feeds only the WORST fraction_lost —
    applying the multiplicative backoff once per report would collapse
    the rate toward min_rate for what is a single congestion episode.
    Clean drains keep per-report recovery (one gentle step per clean
    block), so post-congestion ramp-up speed is unchanged.  Shared by
    relay and multi_relay so the AIMD feeding logic cannot drift.
    """
    rtcp = getattr(sink, "rtcp", None)
    if rtcp is None:
        return
    rtcp.poll()
    blocks = rtcp.take_blocks()
    if not blocks:
        return
    worst = max(b.fraction_lost for b in blocks)
    if worst / 256.0 > governor.loss_threshold:
        rate = governor.on_receiver_report(worst)
        print(f"[adaptive-rate]{label} loss={worst}/256 "
              f"-> {rate:.1f} fps")
    else:
        for b in blocks:
            governor.on_receiver_report(b.fraction_lost)
