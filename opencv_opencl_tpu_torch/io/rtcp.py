"""RTCP (RFC 3550) control plane for the native RTP data path.

The port's own copy of ``opencv_opencl_tpu/io/rtcp.py`` (host code on
sockets; the same reports byte for byte).

The reference observes stream health on the receiving side with a 1 Hz
``pc.getStats()`` panel — resolution, codec, fps, bitrate, packet loss,
RTT (``webrtc/details.html:292-392``).  WebRTC gets those numbers from
RTCP; the native RTP plane (io/rtp.py) gets them from this module:

- **Sender Reports (SR)** from ``RtpUdpSink`` — NTP/RTP timestamp pair,
  packet and octet counts — so receivers can compute loss/RTT and map
  media time to wall time.
- **Receiver Reports (RR)** from ``RtpUdpReceiver`` — fraction lost,
  cumulative lost, extended highest sequence, interarrival jitter, and
  LSR/DLSR so the sender can compute round-trip time exactly as WebRTC's
  ``currentRoundTripTime`` does.
- ``ReceiverStats`` implements the RFC 3550 Appendix A.1 sequence-number
  state machine (dropout/misorder resync) and the A.8 jitter estimator.

RTCP rides the conventional companion port (RTP port + 1).  Both ends
are poll-driven (no extra threads): the sink ships an SR from ``write()``
and the receiver ships an RR from its receive loop when the report
interval has elapsed, and both drain their RTCP socket non-blockingly.
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from collections import deque

__all__ = [
    "RTCP_SR",
    "RTCP_RR",
    "RTCP_SDES",
    "RTCP_BYE",
    "ReceiverStats",
    "ReportBlock",
    "RtcpPeer",
    "build_bye",
    "build_receiver_report",
    "build_sdes_cname",
    "build_sender_report",
    "ntp_now",
    "ntp_to_middle32",
    "parse_compound",
    "rtcp_interval",
]

RTCP_SR = 200
RTCP_RR = 201
RTCP_SDES = 202
RTCP_BYE = 203

# RFC 3550 A.1 constants
MAX_DROPOUT = 3000
MAX_MISORDER = 100
RTP_SEQ_MOD = 1 << 16

_NTP_EPOCH_DELTA = 2208988800  # seconds between 1900 (NTP) and 1970 (unix)


def ntp_now(now: float | None = None) -> tuple[int, int]:
    """Current time as a 64-bit NTP (seconds, fraction) pair."""
    t = time.time() if now is None else now
    sec = int(t) + _NTP_EPOCH_DELTA
    frac = int((t - int(t)) * (1 << 32)) & 0xFFFFFFFF
    return sec & 0xFFFFFFFF, frac


def ntp_to_middle32(sec: int, frac: int) -> int:
    """The middle 32 bits of an NTP timestamp (LSR/DLSR units, 1/65536 s)."""
    return ((sec & 0xFFFF) << 16) | (frac >> 16)


class ReportBlock:
    """One RR/SR report block (RFC 3550 §6.4.1)."""

    __slots__ = ("ssrc", "fraction_lost", "cumulative_lost",
                 "ext_highest_seq", "jitter", "lsr", "dlsr")

    def __init__(self, ssrc, fraction_lost, cumulative_lost,
                 ext_highest_seq, jitter, lsr, dlsr):
        self.ssrc = ssrc
        self.fraction_lost = fraction_lost
        self.cumulative_lost = cumulative_lost
        self.ext_highest_seq = ext_highest_seq
        self.jitter = jitter
        self.lsr = lsr
        self.dlsr = dlsr

    def pack(self) -> bytes:
        # 24-bit two's complement, clamped (RFC 3550 §6.4.1)
        lost = max(-(1 << 23), min(self.cumulative_lost, (1 << 23) - 1))
        lost &= 0xFFFFFF
        return struct.pack(
            "!IBBHIIII",
            self.ssrc & 0xFFFFFFFF,
            self.fraction_lost & 0xFF,
            (lost >> 16) & 0xFF,
            lost & 0xFFFF,
            self.ext_highest_seq & 0xFFFFFFFF,
            self.jitter & 0xFFFFFFFF,
            self.lsr & 0xFFFFFFFF,
            self.dlsr & 0xFFFFFFFF,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "ReportBlock":
        ssrc, fl, l_hi, l_lo, ehsn, jit, lsr, dlsr = struct.unpack(
            "!IBBHIIII", data[:24])
        lost = (l_hi << 16) | l_lo
        if lost & (1 << 23):
            lost -= 1 << 24
        return cls(ssrc, fl, lost, ehsn, jit, lsr, dlsr)


def _rtcp_header(pt: int, count: int, body_len: int) -> bytes:
    # length is in 32-bit words minus one, body must be 32-bit aligned
    return struct.pack("!BBH", (2 << 6) | (count & 0x1F), pt,
                       (body_len // 4))


def build_sender_report(ssrc: int, ntp: tuple[int, int], rtp_ts: int,
                        packet_count: int, octet_count: int,
                        blocks: list[ReportBlock] | None = None) -> bytes:
    blocks = blocks or []
    body = struct.pack("!IIIIII", ssrc & 0xFFFFFFFF, ntp[0], ntp[1],
                       rtp_ts & 0xFFFFFFFF, packet_count & 0xFFFFFFFF,
                       octet_count & 0xFFFFFFFF)
    body += b"".join(b.pack() for b in blocks)
    return _rtcp_header(RTCP_SR, len(blocks), len(body)) + body


def build_receiver_report(ssrc: int, blocks: list[ReportBlock]) -> bytes:
    body = struct.pack("!I", ssrc & 0xFFFFFFFF)
    body += b"".join(b.pack() for b in blocks)
    return _rtcp_header(RTCP_RR, len(blocks), len(body)) + body


def build_sdes_cname(ssrc: int, cname: str) -> bytes:
    item = cname.encode()[:255]
    chunk = struct.pack("!I", ssrc & 0xFFFFFFFF) + bytes([1, len(item)]) + item
    # chunk terminates with >=1 null and pads to a 32-bit boundary
    pad = 4 - (len(chunk) % 4)
    chunk += b"\x00" * pad
    return _rtcp_header(RTCP_SDES, 1, len(chunk)) + chunk


def build_bye(ssrc: int) -> bytes:
    return _rtcp_header(RTCP_BYE, 1, 4) + struct.pack("!I", ssrc & 0xFFFFFFFF)


def parse_compound(data: bytes) -> list[dict]:
    """Parse a (possibly compound) RTCP datagram into packet dicts."""
    out: list[dict] = []
    i = 0
    while i + 4 <= len(data):
        b0, pt, length = struct.unpack("!BBH", data[i : i + 4])
        if (b0 >> 6) != 2:
            break  # not RTCP
        count = b0 & 0x1F
        end = i + 4 + length * 4
        if end > len(data):
            break  # truncated
        body = data[i + 4 : end]
        if pt == RTCP_SR and len(body) >= 24:
            ssrc, ntp_s, ntp_f, rtp_ts, pkts, octets = struct.unpack(
                "!IIIIII", body[:24])
            blocks = [ReportBlock.unpack(body[24 + 24 * k : 48 + 24 * k])
                      for k in range(count) if 48 + 24 * k <= len(body)]
            out.append({"type": "SR", "ssrc": ssrc, "ntp": (ntp_s, ntp_f),
                        "rtp_ts": rtp_ts, "packet_count": pkts,
                        "octet_count": octets, "blocks": blocks})
        elif pt == RTCP_RR and len(body) >= 4:
            (ssrc,) = struct.unpack("!I", body[:4])
            blocks = [ReportBlock.unpack(body[4 + 24 * k : 28 + 24 * k])
                      for k in range(count) if 28 + 24 * k <= len(body)]
            out.append({"type": "RR", "ssrc": ssrc, "blocks": blocks})
        elif pt == RTCP_SDES:
            items = {}
            j = 0
            for _ in range(count):
                if j + 4 > len(body):
                    break
                (ssrc,) = struct.unpack("!I", body[j : j + 4])
                j += 4
                while j + 2 <= len(body) and body[j] != 0:
                    typ, ln = body[j], body[j + 1]
                    items[(ssrc, typ)] = body[j + 2 : j + 2 + ln].decode(
                        "utf-8", "replace")
                    j += 2 + ln
                j = (j // 4 + 1) * 4  # skip null terminator + padding
            out.append({"type": "SDES", "items": items})
        elif pt == RTCP_BYE:
            ssrcs = [struct.unpack("!I", body[4 * k : 4 * k + 4])[0]
                     for k in range(count) if 4 * k + 4 <= len(body)]
            out.append({"type": "BYE", "ssrcs": ssrcs})
        i = end
    return out


class ReceiverStats:
    """Per-source receive statistics (RFC 3550 Appendix A.1 + A.8).

    Feed every received RTP packet via :meth:`note`; ask for a
    :class:`ReportBlock` via :meth:`report_block` when sending an RR.
    """

    def __init__(self, clock_rate: int = 90000):
        self.clock_rate = clock_rate
        self.ssrc: int | None = None
        self._initialized = False
        # A.1 state
        self.base_seq = 0
        self.max_seq = 0
        self.cycles = 0
        self.bad_seq = RTP_SEQ_MOD + 1
        self.received = 0
        self.expected_prior = 0
        self.received_prior = 0
        # A.8 jitter state (in RTP clock units; transit kept as an
        # integer mod 2^32 so the 32-bit RTP timestamp wrap — ~13.2 h at
        # 90 kHz — cancels in the difference instead of poisoning the EWMA)
        self.jitter = 0.0
        self._last_transit: int | None = None
        # SR bookkeeping for LSR/DLSR
        self.last_sr_middle32 = 0
        self.last_sr_arrival: float | None = None
        # bitrate accounting
        self.octets = 0

    # -- sequence machine ------------------------------------------------

    def _init_seq(self, seq: int) -> None:
        self.base_seq = seq
        self.max_seq = seq
        self.cycles = 0
        self.bad_seq = RTP_SEQ_MOD + 1
        self.received = 1
        self.expected_prior = 0
        self.received_prior = 0

    def _update_seq(self, seq: int) -> None:
        udelta = (seq - self.max_seq) & 0xFFFF
        if udelta < MAX_DROPOUT:
            if seq < self.max_seq:
                self.cycles += RTP_SEQ_MOD  # wrapped
            self.max_seq = seq
            self.received += 1
        elif udelta <= RTP_SEQ_MOD - MAX_MISORDER:
            # large jump: maybe the source restarted
            if seq == self.bad_seq:
                self._init_seq(seq)
            else:
                self.bad_seq = (seq + 1) & (RTP_SEQ_MOD - 1)
        else:
            # duplicate or reordered (within MAX_MISORDER): count it
            self.received += 1

    def note(self, seq: int, rtp_ts: int, payload_len: int = 0,
             arrival: float | None = None) -> None:
        """Record one received RTP packet."""
        if not self._initialized:
            self._init_seq(seq)
            self._initialized = True
        else:
            self._update_seq(seq)
        self.octets += payload_len
        # A.8 interarrival jitter, in RTP clock units.  RFC 3550 does this
        # arithmetic on unsigned ints mod 2^32: the signed mod-2^32
        # difference makes timestamp wraps cancel (a float transit would
        # see one ~2^32 delta at each wrap and report garbage jitter for
        # the next ~16 reports of a long-running session).
        t = time.monotonic() if arrival is None else arrival
        transit = (int(t * self.clock_rate) - rtp_ts) & 0xFFFFFFFF
        if self._last_transit is not None:
            d = ((transit - self._last_transit + (1 << 31)) & 0xFFFFFFFF) - (
                1 << 31)
            self.jitter += (abs(d) - self.jitter) / 16.0
        self._last_transit = transit

    def note_sr(self, ntp: tuple[int, int],
                arrival: float | None = None) -> None:
        """Record an incoming Sender Report (for LSR/DLSR in our RRs)."""
        self.last_sr_middle32 = ntp_to_middle32(*ntp)
        self.last_sr_arrival = (
            time.monotonic() if arrival is None else arrival)

    # -- derived numbers ---------------------------------------------------

    @property
    def ext_highest_seq(self) -> int:
        return self.cycles + self.max_seq

    @property
    def expected(self) -> int:
        return self.ext_highest_seq - self.base_seq + 1

    @property
    def cumulative_lost(self) -> int:
        return self.expected - self.received

    def fraction_lost_interval(self) -> int:
        """8-bit fraction lost since the previous call (RFC 3550 A.3)."""
        expected = self.expected
        expected_interval = expected - self.expected_prior
        received_interval = self.received - self.received_prior
        self.expected_prior = expected
        self.received_prior = self.received
        lost_interval = expected_interval - received_interval
        if expected_interval <= 0 or lost_interval <= 0:
            return 0
        return min(255, (lost_interval << 8) // expected_interval)

    def jitter_ms(self) -> float:
        return self.jitter * 1000.0 / self.clock_rate

    def report_block(self, now: float | None = None) -> ReportBlock:
        if self.last_sr_arrival is None:
            lsr = dlsr = 0
        else:
            lsr = self.last_sr_middle32
            t = time.monotonic() if now is None else now
            dlsr = int((t - self.last_sr_arrival) * 65536) & 0xFFFFFFFF
        lost = self.cumulative_lost
        lost = max(-(1 << 23), min(lost, (1 << 23) - 1))
        return ReportBlock(
            ssrc=self.ssrc or 0,
            fraction_lost=self.fraction_lost_interval(),
            cumulative_lost=lost,
            ext_highest_seq=self.ext_highest_seq,
            jitter=int(self.jitter),
            lsr=lsr,
            dlsr=dlsr,
        )


# RFC 3550 §6.2 / A.7 scheduling constants
RTCP_MIN_TIME = 5.0            # seconds; halved for the very first packet
SENDER_BW_FRACTION = 0.25      # senders get >= 1/4 of the RTCP bandwidth
RCVR_BW_FRACTION = 1.0 - SENDER_BW_FRACTION
_COMPENSATION = 2.71828 - 1.5  # e-3/2: unconditional reconsideration fix
RTCP_BW_FRACTION = 0.05        # RTCP budget = 5% of the session bandwidth
_UDP_IP_OVERHEAD = 28          # avg_rtcp_size includes lower layers (A.7)


def rtcp_interval(members: int, senders: int, rtcp_bw: float,
                  we_sent: bool, avg_rtcp_size: float, initial: bool,
                  rand: float | None = None) -> float:
    """The RFC 3550 §6.3.1 / A.7 ``rtcp_interval()`` computation.

    ``rtcp_bw`` is the RTCP budget in bytes/second (conventionally 5% of
    the session bandwidth); ``avg_rtcp_size`` the EWMA compound-packet
    size including UDP/IP overhead; ``rand`` overrides the uniform [0,1)
    draw (tests).  Returns the randomized interval T in seconds: the
    deterministic ``Td = max(Tmin, n * avg_size / bw)`` drawn over
    [0.5, 1.5]*Td and divided by e-3/2 to compensate for the timer
    reconsideration convergence bias.
    """
    rtcp_min_time = RTCP_MIN_TIME / 2.0 if initial else RTCP_MIN_TIME
    n = max(members, 1)
    if senders > 0 and senders <= members * SENDER_BW_FRACTION:
        # split the budget: 25% to the sender subgroup, 75% to receivers
        if we_sent:
            rtcp_bw *= SENDER_BW_FRACTION
            n = senders
        else:
            rtcp_bw *= RCVR_BW_FRACTION
            n -= senders
    t = avg_rtcp_size * n / rtcp_bw if rtcp_bw > 0 else rtcp_min_time
    if t < rtcp_min_time:
        t = rtcp_min_time
    r = random.random() if rand is None else rand
    return t * (r + 0.5) / _COMPENSATION


def companion_peer(ssrc: int, rtp_port: int, *,
                   remote: tuple[str, int] | None = None,
                   schedule: str = "tick",
                   fallback_ephemeral: bool = True) -> "RtcpPeer | None":
    """Build an :class:`RtcpPeer` on the RFC 3550 companion port
    (``rtp_port + 1``; ephemeral when RTP landed on 65535).  When the
    companion port is taken: fall back to an ephemeral port
    (``fallback_ephemeral``, sender side — in-repo receivers reply to
    the SR's source address) or return ``None`` (receiver side:
    stats-only mode)."""
    companion = rtp_port + 1 if rtp_port + 1 <= 65535 else 0
    if remote is not None and remote[1] > 65535:
        # RTP destination on 65535: no companion port exists on the far
        # side — learn the peer from its first RTCP packet instead
        remote = None
    try:
        return RtcpPeer(ssrc, local_port=companion, remote=remote,
                        schedule=schedule)
    except OSError:
        if not fallback_ephemeral:
            return None
        return RtcpPeer(ssrc, remote=remote, schedule=schedule)


class RtcpPeer:
    """Poll-driven RTCP endpoint on the companion port (RTP port + 1).

    One class serves both roles: the media *sender* calls
    :meth:`maybe_send_sr` from its write path and reads remote loss/RTT
    from :attr:`remote_blocks` / :attr:`rtt_ms`; the media *receiver*
    calls :meth:`maybe_send_rr` from its receive loop (stats come from
    the :class:`ReceiverStats` it owns).  ``poll()`` drains the socket
    either way.  No threads.

    Two transmit schedules (``schedule=``):

    - ``"tick"`` (default) — a fixed ``interval`` cadence, mirroring the
      reference's 2-second status tick (``OpenCVequalHist.cpp:200-234``).
    - ``"rfc3550"`` — the full §6.2/§6.3/A.7 interval algorithm:
      member/sender tables fed from received SR/RR/SDES/BYE, a 5%%-of-
      session-bandwidth RTCP budget with the 25/75 sender/receiver
      split, EWMA compound-packet sizing, randomized [0.5,1.5]*Td
      transmit times with the e-3/2 compensation, the halved initial
      minimum, and §6.3.4 reverse reconsideration on BYE.
    """

    def __init__(self, ssrc: int, *, local_port: int = 0,
                 remote: tuple[str, int] | None = None,
                 interval: float = 2.0, cname: str = "opencv-opencl-tpu",
                 clock_rate: int = 90000, schedule: str = "tick",
                 session_bw: float = 4_000_000.0):
        if schedule not in ("tick", "rfc3550"):
            raise ValueError(f"unknown rtcp schedule {schedule!r}")
        self.ssrc = ssrc
        self.remote = remote
        self.interval = interval
        self.schedule = schedule
        # §6.2: the RTCP budget is 5% of the session bandwidth (bits/s
        # in, bytes/s kept — the units avg_rtcp_size is counted in)
        self.rtcp_bw = RTCP_BW_FRACTION * session_bw / 8.0
        # member/sender tables (§6.3.3): ourselves + every SSRC heard,
        # with last-heard times for the §6.3.5 timeout (a crashed sender
        # that restarts with a fresh random SSRC and never BYEs must not
        # inflate the member count — and the interval — forever)
        self.members: set[int] = {ssrc}
        self.senders: set[int] = set()
        self._heard: dict[int, float] = {}
        self._we_sent = False
        self._pmembers = 1
        self.avg_rtcp_size = 52.0 + _UDP_IP_OVERHEAD  # probe size, §6.3.2
        self._tn: float | None = None  # next transmit time (rfc3550 mode)
        self._tp: float | None = None  # last transmit time (A.7 OnExpire)
        self._initial = True
        self.cname = cname
        self.stats = ReceiverStats(clock_rate=clock_rate)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", local_port))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self._last_report = 0.0
        # what the far end told us about our stream (sender side); bounded
        # — an always-on relay accumulates ~43k RRs/day at the 2 s cadence,
        # so history is a deque and one-shot consumers use take_blocks()
        self.remote_blocks: deque[ReportBlock] = deque(maxlen=64)
        self._fresh_blocks: list[ReportBlock] = []
        self.rtt_ms: float | None = None
        # last SR seen (receiver side)
        self.remote_sr: dict | None = None
        self.sr_sent = 0
        self.rr_sent = 0
        # One peer may be driven from two threads (relay --adaptive-rate:
        # the feeder output thread calls sink.write() -> maybe_send_sr()
        # while the main loop calls poll()/take_blocks()).  The RLock
        # guards every mutation of the member/sender tables, the _due
        # scheduling state, and the fresh-block swap; RLock because
        # maybe_send_* re-enter poll()/_due() internally.
        self._lock = threading.RLock()

    # -- receiving ---------------------------------------------------------

    def poll(self) -> None:
        """Drain incoming RTCP datagrams (non-blocking, thread-safe)."""
        with self._lock:
            self._poll_locked()

    def _poll_locked(self) -> None:
        while True:
            try:
                data, addr = self.sock.recvfrom(4096)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self.remote is None:
                self.remote = addr  # learn the peer from its first packet
            now = time.monotonic()
            self._note_rtcp_size(len(data))
            for pkt in parse_compound(data):
                if pkt["type"] == "SR":
                    self.members.add(pkt["ssrc"])
                    self.senders.add(pkt["ssrc"])
                    self._heard[pkt["ssrc"]] = now
                    self.remote_sr = pkt
                    self.stats.note_sr(pkt["ntp"], arrival=now)
                elif pkt["type"] == "BYE":
                    for s in pkt["ssrcs"]:
                        self.members.discard(s)
                        self.senders.discard(s)
                        self._heard.pop(s, None)
                    self._reverse_reconsider(now)
                elif pkt["type"] == "SDES":
                    for (s, _typ) in pkt["items"]:
                        self.members.add(s)
                        self._heard[s] = now
                elif pkt["type"] == "RR":
                    self.members.add(pkt["ssrc"])
                    self._heard[pkt["ssrc"]] = now
                    for blk in pkt["blocks"]:
                        if blk.ssrc == self.ssrc:
                            self.remote_blocks.append(blk)
                            if len(self._fresh_blocks) < 1024:
                                self._fresh_blocks.append(blk)
                            self._update_rtt(blk)

    def take_blocks(self) -> list[ReportBlock]:
        """Drain report blocks not yet consumed (each returned once).

        Thread-safe: the list swap happens under the peer lock so a
        concurrent poll() from the sink's write thread cannot append to
        the list being handed out (a lost RR block is a missed AIMD
        backoff on a congested link)."""
        with self._lock:
            out = self._fresh_blocks
            self._fresh_blocks = []
            return out

    def _update_rtt(self, blk: ReportBlock) -> None:
        if blk.lsr == 0:
            return
        now = ntp_to_middle32(*ntp_now())
        delta = (now - blk.lsr - blk.dlsr) & 0xFFFFFFFF
        if delta < (1 << 31):  # sane (non-negative) only
            self.rtt_ms = delta * 1000.0 / 65536.0

    # -- scheduling --------------------------------------------------------

    def _note_rtcp_size(self, size: int) -> None:
        """§6.3.3: EWMA (gain 1/16) over compound packets sent AND
        received, counting lower-layer overhead."""
        self.avg_rtcp_size += (
            size + _UDP_IP_OVERHEAD - self.avg_rtcp_size) / 16.0

    def _reverse_reconsider(self, now: float) -> None:
        """§6.3.4 reverse reconsideration: when BYEs shrink the group,
        pull the next report forward proportionally."""
        if self._tn is None or self._pmembers <= 0:
            return
        frac = len(self.members) / self._pmembers
        self._tn = now + frac * (self._tn - now)
        self._pmembers = len(self.members)

    def _deterministic_interval(self) -> float:
        """Td of §6.3.1 — the unrandomized, uncompensated interval the
        §6.3.5 timeouts are multiples of."""
        n = max(len(self.members), 1)
        senders = len(self.senders)
        bw = self.rtcp_bw
        if senders > 0 and senders <= n * SENDER_BW_FRACTION:
            if self._we_sent:
                bw *= SENDER_BW_FRACTION
                n = senders
            else:
                bw *= RCVR_BW_FRACTION
                n -= senders
        td = self.avg_rtcp_size * n / bw if bw > 0 else RTCP_MIN_TIME
        return max(td, RTCP_MIN_TIME)

    def _timeout_members(self, now: float) -> None:
        """§6.3.5: drop members not heard from within 5 deterministic
        intervals (Td, Tmin-floored) and senders within 2 — with reverse
        reconsideration, like a BYE."""
        td = self._deterministic_interval()
        dead = [s for s, t in self._heard.items() if now - t > 5.0 * td]
        for s in dead:
            self.members.discard(s)
            self.senders.discard(s)
            del self._heard[s]
        for s in list(self.senders):
            t = self._heard.get(s)
            if t is not None and now - t > 2.0 * td:
                self.senders.discard(s)
        if dead:
            self._reverse_reconsider(now)

    def _interval(self) -> float:
        self._timeout_members(time.monotonic())
        return rtcp_interval(len(self.members), len(self.senders),
                             self.rtcp_bw, self._we_sent,
                             self.avg_rtcp_size, self._initial)

    def _due(self) -> bool:
        now = time.monotonic()
        if self.schedule == "tick":
            # the reference's fixed status cadence
            # (OpenCVequalHist.cpp:200-234)
            if now - self._last_report >= self.interval:
                self._last_report = now
                return True
            return False
        # rfc3550: randomized, bandwidth/membership-scaled transmit times
        if self._tn is None:
            self._tn = now + self._interval()  # initial: half Tmin-based
            self._pmembers = len(self.members)
            return False
        if now >= self._tn:
            # §6.3.6/A.7 OnExpire — conditional (timer) reconsideration:
            # redraw T and transmit only if tp + T has also passed; else
            # defer to tp + T.  Without this the e-3/2 compensation makes
            # the mean interval ~0.82*Td, violating Tmin and the budget.
            t = self._interval()
            if self._tp is not None and self._tp + t > now:
                self._tn = self._tp + t
                # A.7 OnExpire updates pmembers in BOTH branches — a
                # stale value would invert reverse reconsideration
                self._pmembers = len(self.members)
                return False
            self._initial = False
            self._tp = now
            self._tn = now + self._interval()
            self._pmembers = len(self.members)
            return True
        return False

    def _send(self, payload: bytes) -> None:
        if self.remote is None:
            return
        compound = payload + build_sdes_cname(self.ssrc, self.cname)
        self._note_rtcp_size(len(compound))
        try:
            self.sock.sendto(compound, self.remote)
        except (OSError, OverflowError):
            pass  # RTCP is advisory; never take down the media path

    def maybe_send_sr(self, rtp_ts: int, packet_count: int,
                      octet_count: int) -> bool:
        with self._lock:
            self._we_sent = True
            self.senders.add(self.ssrc)
            self._poll_locked()
            if not self._due():
                return False
            self._send(build_sender_report(self.ssrc, ntp_now(), rtp_ts,
                                           packet_count, octet_count))
            self.sr_sent += 1
            return True

    def maybe_send_rr(self, force: bool = False) -> bool:
        with self._lock:
            self._poll_locked()
            if not (force or self._due()):
                return False
            if not self.stats._initialized:
                return False  # nothing received yet: nothing to report
            self._send(build_receiver_report(self.ssrc,
                                             [self.stats.report_block()]))
            self.rr_sent += 1
            return True

    def send_bye(self) -> None:
        with self._lock:
            self._send(build_bye(self.ssrc))

    def close(self) -> None:
        self.sock.close()
