"""RTP payloading for H.264 (RFC 6184) and H.265 (RFC 7798).

The reference's emit pipeline ends in ``omxh264enc ! rtph264pay !
udpsink`` (H.265 variant ``rtph265pay``) with the tuned ``mtu=1200``
(``OpenCVequalHist.cpp:308-332``; mtu from the ``improvement`` ELF's
pipeline strings).  On GStreamer hosts that path is kept verbatim
(io/gst.py builders); this module is the native packetizer for it, so a
host with *any* H.26x encoder (or pre-encoded elementary streams) can
put standards-compliant RTP on the wire without GStreamer — and the
matching depacketizer turns it back into an Annex-B elementary stream.

The container this framework is developed in has no H.264/H.265 encoder
(cv2's FFmpeg ships without libx264/libx265 and OMX/VCU is MPSoC
hardware), so the packetizers are deliberately **encoder-independent**:
input is an Annex-B access unit (``bytes``), output is RTP packets.
Interop surface per RFC 6184: Single NAL Unit packets, STAP-A
aggregation (SPS/PPS ride one datagram), FU-A fragmentation; per RFC
7798: Aggregation Packets (type 48) and Fragmentation Units (type 49).

Loss behavior mirrors io/rtp.py's receivers: a sequence-number gap
inside an access unit poisons it — the depacketizer drops the whole AU
and resyncs, never emitting a torn bitstream to a decoder.

The port's own copy of ``opencv_opencl_tpu/io/rtp_h26x.py``: the same
datagrams, the C++ send path through the port's ``native``.
"""

from __future__ import annotations

import socket
import struct

from opencv_opencl_tpu_torch.io.rtp import StreamLock, _rtp_header

__all__ = [
    "split_access_units",
    "H264RtpPayloader",
    "H265RtpPayloader",
    "H26xDepacketizer",
    "H26xRtpSink",
    "H26xRtpReceiver",
    "split_annexb",
]

DEFAULT_MTU = 1200  # the reference's tuned rtph264pay mtu (improvement ELF)
PT_H26X = 96        # dynamic payload type, as rtph264pay defaults

_START3 = b"\x00\x00\x01"
_START4 = b"\x00\x00\x00\x01"


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into raw NAL units (no start codes)."""
    nals = []
    i = data.find(_START3)
    while i != -1:
        start = i + 3
        j = data.find(_START3, start)
        end = j if j != -1 else len(data)
        # a 4-byte start code is a 3-byte one preceded by 0x00
        nal_end = end - 1 if (j != -1 and data[end - 1] == 0) else end
        nal = data[start:nal_end]
        if nal:
            nals.append(nal)
        i = j
    return nals


class _H26xPayloaderBase:
    """Shared packetization driver; codec specifics live in subclasses."""

    #: header bytes of one NAL unit (1 for H.264, 2 for H.265)
    nal_hdr_len = 1

    def __init__(self, mtu: int = DEFAULT_MTU, ssrc: int = 0x48323634,
                 fps: float = 30.0, pt: int = PT_H26X,
                 aggregate: bool = True):
        # FU fragments need >=1 payload byte after RTP header + payload
        # header + FU header, or _fu_fragments would loop forever
        min_mtu = 12 + self.nal_hdr_len + 1 + 1
        if mtu < min_mtu:
            raise ValueError(f"mtu {mtu} < minimum {min_mtu} for "
                             f"{type(self).__name__}")
        self.mtu = mtu
        self.ssrc = ssrc
        self.pt = pt
        self.aggregate = aggregate
        self.seq = 0
        self.ts = 0
        self.last_ts = 0  # timestamp of the most recently packetized AU
        self.ts_step = int(round(90000 / fps)) if fps > 0 else 3000

    # -- codec hooks -------------------------------------------------------

    def _agg_packet(self, nals: list[bytes]) -> bytes:
        raise NotImplementedError

    def _fu_fragments(self, nal: bytes, room: int) -> list[bytes]:
        raise NotImplementedError

    # -- driver ------------------------------------------------------------

    def packetize(self, access_unit: bytes) -> list[bytes]:
        """One Annex-B access unit -> RTP packets (marker on the last)."""
        nals = split_annexb(access_unit)
        if not nals:
            return []
        room = self.mtu - 12
        payloads: list[bytes] = []
        i = 0
        while i < len(nals):
            nal = nals[i]
            if len(nal) > room:
                payloads.extend(self._fu_fragments(nal, room))
                i += 1
                continue
            if self.aggregate:
                # greedy aggregation: how many consecutive small NALs fit?
                agg_hdr = self.nal_hdr_len
                total = agg_hdr
                j = i
                while j < len(nals) and total + 2 + len(nals[j]) <= room:
                    total += 2 + len(nals[j])
                    j += 1
                if j - i >= 2:
                    payloads.append(self._agg_packet(nals[i:j]))
                    i = j
                    continue
            payloads.append(nal)  # Single NAL Unit packet
            i += 1
        packets = []
        for k, payload in enumerate(payloads):
            marker = k == len(payloads) - 1
            hdr = _rtp_header(self.pt, self.seq, self.ts, self.ssrc, marker)
            packets.append(hdr + payload)
            self.seq = (self.seq + 1) & 0xFFFF
        self.last_ts = self.ts
        self.ts = (self.ts + self.ts_step) & 0xFFFFFFFF
        return packets


class H264RtpPayloader(_H26xPayloaderBase):
    """RFC 6184: Single NAL / STAP-A (24) / FU-A (28)."""

    nal_hdr_len = 1

    def _agg_packet(self, nals: list[bytes]) -> bytes:
        # STAP-A indicator: F=0, NRI = max of the aggregated NALs, type 24
        nri = max(n[0] & 0x60 for n in nals)
        out = [bytes([nri | 24])]
        for n in nals:
            out.append(struct.pack("!H", len(n)) + n)
        return b"".join(out)

    def _fu_fragments(self, nal: bytes, room: int) -> list[bytes]:
        indicator = (nal[0] & 0xE0) | 28          # F+NRI kept, type FU-A
        ntype = nal[0] & 0x1F
        body = nal[1:]
        frag_room = room - 2                       # indicator + FU header
        frags = []
        off = 0
        while off < len(body):
            chunk = body[off : off + frag_room]
            start = off == 0
            end = off + len(chunk) >= len(body)
            fu_hdr = (0x80 if start else 0) | (0x40 if end else 0) | ntype
            frags.append(bytes([indicator, fu_hdr]) + chunk)
            off += len(chunk)
        return frags


class H265RtpPayloader(_H26xPayloaderBase):
    """RFC 7798: Single NAL / AP (48) / FU (49).  2-byte NAL headers."""

    nal_hdr_len = 2

    def _agg_packet(self, nals: list[bytes]) -> bytes:
        # PayloadHdr: type=48, layer-id/TID = minima of the aggregated NALs
        layer_tid = min(struct.unpack("!H", n[:2])[0] & 0x01FF for n in nals)
        out = [struct.pack("!H", (48 << 9) | layer_tid)]
        for n in nals:
            out.append(struct.pack("!H", len(n)) + n)
        return b"".join(out)

    def _fu_fragments(self, nal: bytes, room: int) -> list[bytes]:
        (h,) = struct.unpack("!H", nal[:2])
        ntype = (h >> 9) & 0x3F
        payload_hdr = struct.pack("!H", (h & 0x81FF) | (49 << 9))
        body = nal[2:]
        frag_room = room - 3                       # PayloadHdr + FU header
        frags = []
        off = 0
        while off < len(body):
            chunk = body[off : off + frag_room]
            start = off == 0
            end = off + len(chunk) >= len(body)
            fu_hdr = (0x80 if start else 0) | (0x40 if end else 0) | ntype
            frags.append(payload_hdr + bytes([fu_hdr]) + chunk)
            off += len(chunk)
        return frags


class H26xDepacketizer:
    """Packets (arrival order) -> Annex-B access units, loss-tolerant.

    Feed raw RTP packets via :meth:`push`; it returns a completed
    Annex-B access unit (4-byte start codes) when the packet carried the
    AU's marker and every sequence number of the AU was seen, else
    ``None``.  A gap poisons the whole AU (dropped, counted in
    :attr:`aus_dropped`) — decoders never see torn NALs.
    """

    def __init__(self, codec: str = "h264"):
        if codec not in ("h264", "h265"):
            raise ValueError(f"unknown codec {codec!r}")
        self.codec = codec
        self._nals: list[bytes] = []
        self._fu: list[bytes] | None = None
        self._fu_first: int | None = None
        self._cur_ts: int | None = None
        self._expect_seq: int | None = None
        self._broken = False
        self.aus_dropped = 0
        self.packets_bad = 0
        self.packets_dup = 0

    def _reset_au(self) -> None:
        self._nals = []
        self._fu = None
        self._fu_first = None
        self._broken = False

    def reset_stream(self) -> None:
        """Forget the sequence/timestamp chain (a NEW stream took the
        receiver's StreamLock after a silence relock: the old sender's
        seq state would poison the new stream's first AU)."""
        self._reset_au()
        self._cur_ts = None
        self._expect_seq = None

    def push(self, pkt: bytes) -> bytes | None:
        if len(pkt) < 13:
            self.packets_bad += 1
            return None
        marker = bool(pkt[1] & 0x80)
        seq = struct.unpack("!H", pkt[2:4])[0]
        ts = struct.unpack("!I", pkt[4:8])[0]
        payload = pkt[12:]

        if (self._expect_seq is not None
                and ((seq - self._expect_seq) & 0xFFFF) == 0xFFFF):
            # exact re-send of the previous packet (network duplicate):
            # ignore it entirely — processing it would double its NAL and
            # the old seq!=expected check would poison a perfectly good AU
            self.packets_dup += 1
            return None

        ts_changed = False
        if self._cur_ts is None:
            self._cur_ts = ts
        elif ts != self._cur_ts:
            # new AU began before the previous one's marker: drop the old
            ts_changed = True
            if self._nals or self._fu or self._broken:
                self.aus_dropped += 1
            self._reset_au()
            self._cur_ts = ts
        if self._expect_seq is not None and seq != self._expect_seq:
            gap = (seq - self._expect_seq) & 0xFFFF
            if ts_changed and gap == 1:
                # A single missing packet straddling the AU boundary is
                # the OLD AU's lost tail, not this one's head: a
                # marker-setting sender (rtph264pay et al.) ends every AU
                # with its marker packet, so had the missing packet
                # belonged to the new AU the old AU's marker would have
                # arrived and emitted it already.  Poisoning here would
                # double the effective AU drop rate under tail loss.
                # (Gaps >= 2 can hide both a tail and a head: poison.)
                pass
            else:
                self._broken = True  # a packet of this AU is missing
        self._expect_seq = (seq + 1) & 0xFFFF

        try:
            if self.codec == "h264":
                self._push_h264(payload)
            else:
                self._push_h265(payload)
        except (IndexError, struct.error):
            self.packets_bad += 1
            self._broken = True

        if marker:
            broken = self._broken or self._fu is not None
            nals = self._nals
            self._reset_au()
            self._cur_ts = None
            if broken or not nals:
                self.aus_dropped += 1
                return None
            return b"".join(_START4 + n for n in nals)
        return None

    # -- H.264 (RFC 6184) ----------------------------------------------------

    def _push_h264(self, p: bytes) -> None:
        ntype = p[0] & 0x1F
        if 1 <= ntype <= 23:  # Single NAL Unit packet
            self._nals.append(p)
        elif ntype == 24:  # STAP-A
            i = 1
            while i + 2 <= len(p):
                (n,) = struct.unpack("!H", p[i : i + 2])
                if n == 0 or i + 2 + n > len(p):
                    # zero-length or truncated aggregation unit: poison
                    # the AU rather than emit a torn/empty NAL
                    self.packets_bad += 1
                    self._broken = True
                    return
                self._nals.append(p[i + 2 : i + 2 + n])
                i += 2 + n
        elif ntype == 28:  # FU-A
            fu = p[1]
            start, end = fu & 0x80, fu & 0x40
            if start:
                first = (p[0] & 0xE0) | (fu & 0x1F)
                self._fu = [bytes([first]), p[2:]]
                self._fu_first = first
            elif self._fu is not None:
                self._fu.append(p[2:])
            else:
                self._broken = True  # mid-FU without its start: lost packet
                return
            if end and self._fu is not None:
                self._nals.append(b"".join(self._fu))
                self._fu = None
        else:
            self.packets_bad += 1

    # -- H.265 (RFC 7798) ----------------------------------------------------

    def _push_h265(self, p: bytes) -> None:
        (h,) = struct.unpack("!H", p[:2])
        ntype = (h >> 9) & 0x3F
        if ntype < 48:  # single NAL
            self._nals.append(p)
        elif ntype == 48:  # AP
            i = 2
            while i + 2 <= len(p):
                (n,) = struct.unpack("!H", p[i : i + 2])
                if n == 0 or i + 2 + n > len(p):
                    self.packets_bad += 1
                    self._broken = True
                    return
                self._nals.append(p[i + 2 : i + 2 + n])
                i += 2 + n
        elif ntype == 49:  # FU
            fu = p[2]
            start, end = fu & 0x80, fu & 0x40
            if start:
                orig = struct.pack("!H", (h & 0x81FF) | ((fu & 0x3F) << 9))
                self._fu = [orig, p[3:]]
            elif self._fu is not None:
                self._fu.append(p[3:])
            else:
                self._broken = True
                return
            if end and self._fu is not None:
                self._nals.append(b"".join(self._fu))
                self._fu = None
        else:
            self.packets_bad += 1


def split_access_units(data: bytes, codec: str) -> list[bytes]:
    """Annex-B byte stream -> access units (4-byte start codes kept).

    The ES-replay app's AU splitter (AUD/first-slice heuristics per
    H.264 §7.4.1.2.3 / H.265 §7.4.2.4.4), shared with the encoder
    boundary (io.encoder.FfmpegEncoder AU framing).
    """

    def ntype(nal: bytes) -> int:
        return (nal[0] & 0x1F) if codec == "h264" else ((nal[0] >> 1) & 0x3F)

    def is_vcl(nal: bytes) -> bool:
        return (1 <= ntype(nal) <= 5) if codec == "h264" else ntype(nal) < 32

    def is_aud(nal: bytes) -> bool:
        return ntype(nal) == (9 if codec == "h264" else 35)

    def is_suffix(nal: bytes) -> bool:
        # end-of-sequence / end-of-stream / filler; H.265 suffix SEI
        if codec == "h264":
            return ntype(nal) in (10, 11, 12)
        return ntype(nal) in (36, 37, 38, 40)

    def first_slice_of_picture(nal: bytes) -> bool:
        # H.264: first_mb_in_slice is the leading ue(v) of the slice
        # header — value 0 encodes as a leading 1-bit.  Data partitions
        # B/C (types 3/4) start with slice_id instead, so only types
        # 1/2/5 are picture-start candidates.  H.265:
        # first_slice_segment_in_pic_flag is the first header bit after
        # the 2-byte NAL header.
        if codec == "h264":
            return (ntype(nal) in (1, 2, 5)
                    and len(nal) > 1 and bool(nal[1] & 0x80))
        return len(nal) > 2 and bool(nal[2] & 0x80)

    aus: list[list[bytes]] = []
    cur: list[bytes] = []       # the AU being assembled
    pending: list[bytes] = []   # prefix NALs awaiting their picture

    def flush() -> None:
        nonlocal cur
        if cur:
            aus.append(cur)
            cur = []

    for nal in split_annexb(data):
        if is_aud(nal):
            flush()
            pending.append(nal)
        elif is_vcl(nal):
            if first_slice_of_picture(nal) or not cur:
                flush()
                cur = pending + [nal]
            else:
                cur += pending + [nal]  # continuation slice, same AU
            pending = []
        elif is_suffix(nal):
            (cur if cur else pending).append(nal)
        else:
            pending.append(nal)  # VPS/SPS/PPS/prefix SEI: next AU's
    flush()
    if pending:
        # trailing prefix NALs with no picture: keep them (tail of the
        # last AU) rather than dropping bytes
        if aus:
            aus[-1].extend(pending)
        else:
            aus.append(pending)
    return [b"".join(_START4 + n for n in au) for au in aus]


class H26xRtpSink:
    """Stream pre-encoded Annex-B access units as RTP/UDP.

    The io.videofile sink shape (``write()/close()``) but taking encoded
    AUs rather than NV12 — the native stand-in for ``rtph264pay !
    udpsink`` when an encoder exists upstream (reference tuning:
    ``OpenCVequalHist.cpp:308-332``).  RTCP Sender Reports ride the
    companion port as in io/rtp.py.
    """

    def __init__(self, host: str, port: int, codec: str = "h264",
                 fps: float = 30.0, mtu: int = DEFAULT_MTU,
                 buffer_size: int = 60_000_000, rtcp: bool = True,
                 rtcp_schedule: str = "tick"):
        # validate (payloader construction raises on bad codec/mtu)
        # BEFORE binding sockets, so a rejected config leaks no fd
        if codec == "h264":
            self.payloader = H264RtpPayloader(mtu=mtu, fps=fps)
        elif codec == "h265":
            self.payloader = H265RtpPayloader(mtu=mtu, fps=fps)
        else:
            raise ValueError(f"unknown codec {codec!r}")
        self.addr = (host, port)
        try:
            # the C++ batch sender needs a literal IP (inet_pton);
            # resolve hostnames once here, or fall back to Python sendto
            self._ip = socket.gethostbyname(host)
        except OSError:
            self._ip = None
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                 buffer_size)
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, 60 << 2)
        except OSError:
            pass
        # RFC 3550 port convention: RTCP on RTP source port + 1
        self.sock.bind(("0.0.0.0", 0))
        self.rtp_port = self.sock.getsockname()[1]
        self.rtcp = None
        if rtcp:
            from opencv_opencl_tpu_torch.io.rtcp import companion_peer

            self.rtcp = companion_peer(self.payloader.ssrc, self.rtp_port,
                                       remote=(host, port + 1),
                                       schedule=rtcp_schedule)
        self.frames = 0
        self.packets = 0
        self.bytes = 0
        self.payload_octets = 0

    def _ship(self, pkts: list[bytes]) -> int:
        """Send the packet batch; returns how many made it out.  Uses
        the GIL-free C++ sendmmsg path when the native runtime is
        available (one join + a few syscalls vs ~10k Python sendto
        calls for a 4K PCM access unit), else the portable loop."""
        from opencv_opencl_tpu_torch import native

        if self._ip is not None and native.available():
            try:
                return native.send_packets(self.sock.fileno(), pkts,
                                           self._ip, self.addr[1])
            except OSError as e:
                return getattr(e, "packets_sent", 0)
        sent = 0
        for pkt in pkts:
            self.sock.sendto(pkt, self.addr)
            sent += 1
        return sent

    def write(self, access_unit: bytes) -> None:
        pkts = self.payloader.packetize(bytes(access_unit))
        sent = self._ship(pkts)
        self.packets += sent
        nbytes = (sum(map(len, pkts)) if sent == len(pkts)
                  else sum(len(p) for p in pkts[:sent]))
        self.bytes += nbytes
        self.payload_octets += nbytes - 12 * sent
        self.frames += 1
        if self.rtcp is not None:
            # pair NTP-now with the AU just sent (ts was already advanced
            # past it by packetize) so the SR's clock mapping is honest
            self.rtcp.maybe_send_sr(self.payloader.last_ts, self.packets,
                                    self.payload_octets)

    @property
    def rtt_ms(self):
        return self.rtcp.rtt_ms if self.rtcp is not None else None

    def close(self) -> None:
        if self.rtcp is not None:
            self.rtcp.send_bye()
            self.rtcp.close()
        self.sock.close()


class H26xRtpReceiver:
    """Receive an H.26x RTP stream back into Annex-B access units."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 codec: str = "h264", timeout: float = 5.0,
                 buffer_size: int = 60_000_000, rtcp: bool = True,
                 pt: int | None = None, rtcp_schedule: str = "tick",
                 relock_timeout: float | None = 5.0):
        # pt=None: lock onto the first dynamic payload type seen, so
        # external senders whose SDP negotiated PT != 96 interoperate;
        # pass pt= to pin a specific negotiated type
        self._lock = StreamLock(pt=pt, require_dynamic=True,
                                 relock_timeout=relock_timeout)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 buffer_size)
        except OSError:
            pass
        self.sock.bind((host, port))
        self.sock.settimeout(timeout)
        self.port = self.sock.getsockname()[1]
        self.depay = H26xDepacketizer(codec)
        self._relocks_seen = 0
        self.rtcp = None
        if rtcp:
            from opencv_opencl_tpu_torch.io.rtcp import companion_peer

            self.rtcp = companion_peer(0x48525856, self.port,
                                       schedule=rtcp_schedule,
                                       fallback_ephemeral=False)

    def recv_access_unit(self) -> bytes | None:
        """Block until one complete access unit arrives."""
        while True:
            pkt, _ = self.sock.recvfrom(65536)
            if len(pkt) < 13:
                self.depay.packets_bad += 1
                continue
            # shared version/PT/SSRC gate (io.rtp.StreamLock): foreign
            # datagrams must corrupt neither the depacketizer's seq
            # chain nor the RTCP loss stats
            if not self._lock.accept(pkt):
                self.depay.packets_bad += 1
                continue
            if self._lock.relocks != self._relocks_seen:
                # a restarted sender took the lock: fresh seq/ts chain
                # and fresh RTCP sequence machine for the new SSRC
                self._relocks_seen = self._lock.relocks
                self.depay.reset_stream()
                if self.rtcp is not None:
                    from opencv_opencl_tpu_torch.io.rtcp import ReceiverStats

                    self.rtcp.stats = ReceiverStats(
                        clock_rate=self.rtcp.stats.clock_rate)
            if self.rtcp is not None:
                if self.rtcp.stats.ssrc is None:
                    self.rtcp.stats.ssrc = self._lock.ssrc
                self.rtcp.stats.note(struct.unpack("!H", pkt[2:4])[0],
                                     struct.unpack("!I", pkt[4:8])[0],
                                     len(pkt) - 12)
                self.rtcp.maybe_send_rr()
            au = self.depay.push(pkt)
            if au is not None:
                return au

    def close(self) -> None:
        if self.rtcp is not None:
            self.rtcp.maybe_send_rr(force=True)
            self.rtcp.send_bye()
            self.rtcp.close()
        self.sock.close()
