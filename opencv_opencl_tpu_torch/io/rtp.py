"""RTP-over-UDP data plane for GStreamer-less hosts.

The port's own copy of ``opencv_opencl_tpu/io/rtp.py`` (host code on
sockets and numpy; the same frames give the same packets).  As in the JAX
package, the raw sink sends through the C++ packetizer of the port's
``native`` package (``rtp_send_raw``: sendmmsg batches, GIL-free) when that
library builds, and packetizes in Python otherwise.

The reference's emit side really puts media packets on the wire
(``udpsink host=192.168.25.69 port=5004`` with 60 MB socket buffers and
QoS DSCP 60, ``OpenCVequalHist.cpp:316-331``).  Hosts with GStreamer keep
that path (the io.gst pipeline strings + --io=gst); this module provides a native
packet-emitting fallback so the relay can stream without any external
stack:

- **JPEG/RTP (RFC 2435)** — frames are JPEG-encoded (cv2), the JFIF is
  parsed down to its scan data + quantization tables, and packetized with
  the standard main header / in-band Q-table header (Q=255), so a stock
  ``udpsrc ! rtpjpegdepay ! jpegdec`` or ffmpeg can receive the stream.
  The receiver side reconstructs the JFIF headers per RFC 2435 Appendix B
  (standard Huffman tables).
- **Raw NV12 (RFC 4175-style)** — line-based packetization of the NV12
  buffer (extended sequence number + per-SRD line/offset/length headers),
  bit-exact on loopback; for LAN-grade links where encode latency matters
  more than bandwidth (the zero-copy spirit of ``nextimprovement.cpp``).

``RtpUdpSink`` matches the io.videofile sink API (``write(nv12)/close()``)
so the relay selects it with ``--sink=rtp://host:port`` /
``rtp+raw://host:port``; ``RtpUdpReceiver`` is the matching depacketizer
used by the loopback tests and headless viewers.
"""

from __future__ import annotations

import socket
import struct
import time

import numpy as np

__all__ = [
    "JpegRtpPayloader",
    "RawNv12Payloader",
    "RtpUdpSink",
    "RtpUdpReceiver",
    "StreamLock",
    "parse_jpeg",
    "rebuild_jfif",
]

RTP_VERSION = 2
PT_JPEG = 26           # RFC 3551 static payload type for JPEG
PT_RAW = 96            # dynamic
DEFAULT_MTU = 1200     # the tuned reference mtu (improvement ELF)


def _rtp_header(pt: int, seq: int, ts: int, ssrc: int, marker: bool) -> bytes:
    b0 = RTP_VERSION << 6
    b1 = (0x80 if marker else 0) | (pt & 0x7F)
    return struct.pack("!BBHII", b0, b1, seq & 0xFFFF, ts & 0xFFFFFFFF, ssrc)


class StreamLock:
    """Version/PT/SSRC gate shared by every receiver: locks onto the
    first matching stream so foreign datagrams (a second sender, a stray
    process on the port) can corrupt neither frame reassembly nor the
    RTCP sequence/jitter machine.

    ``pt=None`` locks onto the first payload type seen (restricted to
    the dynamic range 96-127 when ``require_dynamic``), matching
    standards senders whose SDP negotiated any dynamic PT.

    The lock re-arms after ``relock_timeout`` seconds of silence: a
    standards sender that restarts picks a fresh random SSRC per run
    (RFC 3550 §8; gst rtph264pay does exactly this), and pinning the
    dead SSRC forever would silently ignore the restarted stream for
    the life of the receiver.  A foreign stream can only steal the lock
    once the locked stream has actually gone quiet."""

    def __init__(self, pt: int | None = None, require_dynamic: bool = False,
                 relock_timeout: float | None = 5.0):
        self.pt = pt
        self._pt_fixed = pt is not None
        self.ssrc: int | None = None
        self.require_dynamic = require_dynamic
        self.relock_timeout = relock_timeout
        self._last_accept: float | None = None
        self.relocks = 0

    def accept(self, pkt: bytes, now: float | None = None) -> bool:
        if pkt[0] >> 6 != RTP_VERSION:
            return False
        pt = pkt[1] & 0x7F
        ssrc = struct.unpack("!I", pkt[8:12])[0]
        t = time.monotonic() if now is None else now
        mismatch = ((self.pt is not None and pt != self.pt)
                    or (self.ssrc is not None and ssrc != self.ssrc))
        if mismatch:
            stale = (self.relock_timeout is not None
                     and self._last_accept is not None
                     and t - self._last_accept > self.relock_timeout)
            pt_ok = pt == self.pt if self._pt_fixed else (
                not (self.require_dynamic and pt < 96))
            if not (stale and pt_ok):
                return False
            # silence timeout elapsed: re-lock onto the new stream
            self.ssrc = None
            if not self._pt_fixed:
                self.pt = None
            self.relocks += 1
        if self.pt is None:
            if self.require_dynamic and pt < 96:
                return False
            self.pt = pt
        if self.ssrc is None:
            self.ssrc = ssrc
        self._last_accept = t
        return True


# ------------------------------------------------------------ JPEG / JFIF ----


def parse_jpeg(data: bytes):
    """Extract (scan_data, qtables, width, height, type) from a baseline
    JFIF produced by cv2/libjpeg.  type: 1 = 4:2:0, 0 = 4:2:2 (RFC 2435)."""
    assert data[0:2] == b"\xff\xd8", "not a JPEG (no SOI)"
    i = 2
    qtables: dict[int, bytes] = {}
    width = height = None
    jtype = 1
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError(f"marker sync lost at {i}")
        marker = data[i + 1]
        if marker == 0xD9:  # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # standalone
            i += 2
            continue
        seglen = struct.unpack("!H", data[i + 2 : i + 4])[0]
        seg = data[i + 4 : i + 2 + seglen]
        if marker == 0xDB:  # DQT (may hold several tables)
            j = 0
            while j < len(seg):
                pq_tq = seg[j]
                tq = pq_tq & 0x0F
                if pq_tq >> 4:
                    raise ValueError("16-bit quant tables unsupported")
                qtables[tq] = seg[j + 1 : j + 65]
                j += 65
        elif marker == 0xC0:  # SOF0 baseline
            height, width = struct.unpack("!HH", seg[1:5])
            # seg: precision, H, W, ncomp, then per-comp (id, sampling, quant)
            # first component's sampling factors: 0x22 -> 4:2:0, 0x21 -> 4:2:2
            sampling = seg[7]
            jtype = 1 if sampling == 0x22 else 0
        elif marker in (0xC1, 0xC2, 0xC3):
            raise ValueError("non-baseline JPEG unsupported by RFC 2435")
        elif marker == 0xDA:  # SOS: scan data follows until EOI
            scan_start = i + 2 + seglen
            end = data.rfind(b"\xff\xd9")
            return (data[scan_start:end], qtables, width, height, jtype)
        i += 2 + seglen
    raise ValueError("no SOS segment found")


# RFC 2435 Appendix B: standard Huffman tables (JPEG Annex K.3)
_LUM_DC_CODELENS = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
_LUM_DC_SYMBOLS = bytes(range(12))
_LUM_AC_CODELENS = bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D])
_LUM_AC_SYMBOLS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])
_CHM_DC_CODELENS = bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_CHM_DC_SYMBOLS = bytes(range(12))
_CHM_AC_CODELENS = bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
_CHM_AC_SYMBOLS = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])


def _dht(class_id: int, table_id: int, codelens: bytes, symbols: bytes) -> bytes:
    body = bytes([class_id << 4 | table_id]) + codelens + symbols
    return b"\xff\xc4" + struct.pack("!H", len(body) + 2) + body


def rebuild_jfif(scan: bytes, qtables: dict[int, bytes], width: int,
                 height: int, jtype: int) -> bytes:
    """RFC 2435 Appendix B MakeHeaders: reconstruct a decodable JFIF around
    received scan data using the in-band quant tables and the standard
    Huffman tables."""
    out = [b"\xff\xd8"]
    for tq in sorted(qtables):
        body = bytes([tq]) + qtables[tq]
        out.append(b"\xff\xdb" + struct.pack("!H", len(body) + 2) + body)
    samp = 0x22 if jtype == 1 else 0x21
    q_chroma = 1 if 1 in qtables else 0
    sof = (struct.pack("!BHHB", 8, height, width, 3)
           + bytes([1, samp, 0])            # Y: quant table 0
           + bytes([2, 0x11, q_chroma])     # Cb
           + bytes([3, 0x11, q_chroma]))    # Cr
    out.append(b"\xff\xc0" + struct.pack("!H", len(sof) + 2) + sof)
    out.append(_dht(0, 0, _LUM_DC_CODELENS, _LUM_DC_SYMBOLS))
    out.append(_dht(1, 0, _LUM_AC_CODELENS, _LUM_AC_SYMBOLS))
    out.append(_dht(0, 1, _CHM_DC_CODELENS, _CHM_DC_SYMBOLS))
    out.append(_dht(1, 1, _CHM_AC_CODELENS, _CHM_AC_SYMBOLS))
    sos = (bytes([3])
           + bytes([1, 0x00])
           + bytes([2, 0x11])
           + bytes([3, 0x11])
           + bytes([0, 63, 0]))
    out.append(b"\xff\xda" + struct.pack("!H", len(sos) + 2) + sos)
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


class JpegRtpPayloader:
    """NV12 frame -> JPEG -> RFC 2435 RTP packets (Q=255 in-band tables)."""

    def __init__(self, quality: int = 85, mtu: int = DEFAULT_MTU,
                 ssrc: int = 0x54505531, fps: float = 30.0):
        import cv2

        self._cv2 = cv2
        self.quality = int(quality)
        self.mtu = mtu
        self.ssrc = ssrc
        self.seq = 0
        self.ts = 0
        self.last_ts = 0  # timestamp of the most recently packetized frame
        self.ts_step = int(round(90000 / fps)) if fps > 0 else 3000

    def packetize(self, nv12: np.ndarray) -> list[bytes]:
        cv2 = self._cv2
        bgr = cv2.cvtColor(nv12, cv2.COLOR_YUV2BGR_NV12)
        h, w = bgr.shape[:2]
        if w > 2040 or h > 2040:
            # RFC 2435 caps dimensions at 2040 (8-bit width/8 fields)
            scale = 2040 / max(w, h)
            bgr = cv2.resize(bgr, (int(w * scale) & ~7, int(h * scale) & ~7))
            h, w = bgr.shape[:2]
        if (w & 7) or (h & 7):
            # the header carries dim/8: crop to multiples of 8 (lossy path;
            # a stock rtpjpegdepay would rebuild a mismatched SOF otherwise)
            bgr = bgr[: h & ~7, : w & ~7]
            h, w = bgr.shape[:2]
        ok, enc = cv2.imencode(
            ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, self.quality])
        if not ok:
            raise RuntimeError("JPEG encode failed")
        scan, qtables, jw, jh, jtype = parse_jpeg(enc.tobytes())
        qt_payload = qtables.get(0, b"\x00" * 64) + qtables.get(
            1, qtables.get(0, b"\x00" * 64))
        packets = []
        off = 0
        first = True
        payload_room = self.mtu - 12 - 8
        while off < len(scan):
            jpeg_hdr = struct.pack(
                "!BBBBBBBB", 0,
                (off >> 16) & 0xFF, (off >> 8) & 0xFF, off & 0xFF,
                jtype, 255, jw // 8, jh // 8,
            )
            extra = b""
            room = payload_room
            if first:
                extra = struct.pack("!BBH", 0, 0, len(qt_payload)) + qt_payload
                room -= len(extra)
                first = False
            chunk = scan[off : off + room]
            marker = off + len(chunk) >= len(scan)
            hdr = _rtp_header(PT_JPEG, self.seq, self.ts, self.ssrc, marker)
            packets.append(hdr + jpeg_hdr + extra + chunk)
            self.seq = (self.seq + 1) & 0xFFFF
            off += len(chunk)
        self.last_ts = self.ts
        self.ts = (self.ts + self.ts_step) & 0xFFFFFFFF
        return packets


class RawNv12Payloader:
    """NV12 frame -> RFC 4175-style line-packetized RTP (bit-exact)."""

    def __init__(self, mtu: int = DEFAULT_MTU, ssrc: int = 0x54505532,
                 fps: float = 30.0):
        self.mtu = mtu
        self.ssrc = ssrc
        self.seq = 0
        self.ts = 0
        self.last_ts = 0
        self.ts_step = int(round(90000 / fps)) if fps > 0 else 3000

    def packetize(self, nv12: np.ndarray) -> list[bytes]:
        rows, width = nv12.shape
        flat = np.ascontiguousarray(nv12)
        packets = []
        # payload: 2B extended seq (0) then one SRD: length, line, offset
        room = self.mtu - 12 - 2 - 6
        for line in range(rows):
            off = 0
            while off < width:
                n = min(room, width - off)
                srd = struct.pack("!HHH", n, line, off)
                marker = line == rows - 1 and off + n >= width
                hdr = _rtp_header(PT_RAW, self.seq, self.ts, self.ssrc, marker)
                packets.append(hdr + b"\x00\x00" + srd
                               + flat[line, off : off + n].tobytes())
                self.seq = (self.seq + 1) & 0xFFFF
                off += n
        self.last_ts = self.ts
        self.ts = (self.ts + self.ts_step) & 0xFFFFFFFF
        return packets


class RtpUdpSink:
    """io.videofile-shaped sink streaming RTP/UDP (reference udpsink tuning:
    60 MB socket buffer, QoS DSCP 60 — ``OpenCVequalHist.cpp:316-331``)."""

    def __init__(self, host: str, port: int, kind: str = "jpeg",
                 fps: float = 30.0, quality: int = 85,
                 mtu: int = DEFAULT_MTU, buffer_size: int = 60_000_000,
                 rtcp: bool = True, rtcp_schedule: str = "tick"):
        # validate kind (payloader construction) before binding sockets
        if kind == "jpeg":
            self.payloader = JpegRtpPayloader(quality=quality, mtu=mtu,
                                              fps=fps)
        elif kind == "raw":
            self.payloader = RawNv12Payloader(mtu=mtu, fps=fps)
        else:
            raise ValueError(f"unknown rtp payload kind {kind!r}")
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                 buffer_size)
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, 60 << 2)
        except OSError:
            pass  # container caps: keep streaming regardless
        # pin the RTP source port now so RTCP can ride the RFC 3550
        # convention (RTP source port + 1) — standards peers address their
        # RRs there, not to the SR datagram's source address
        self.sock.bind(("0.0.0.0", 0))
        self.rtp_port = self.sock.getsockname()[1]
        self.rtcp = None
        if rtcp:
            # Sender Reports on the conventional companion port; Receiver
            # Reports coming back carry loss/jitter/RTT (the getStats
            # numbers of webrtc/details.html:292-392, natively).
            from opencv_opencl_tpu_torch.io.rtcp import companion_peer

            self.rtcp = companion_peer(self.payloader.ssrc, self.rtp_port,
                                       remote=(host, port + 1),
                                       schedule=rtcp_schedule)
        self.payload_octets = 0
        # raw frames go out through the C++ packetizer (sendmmsg) where
        # the native library builds; the Python one sends the same bytes
        self._use_native = False
        if kind == "raw":
            from opencv_opencl_tpu_torch import native

            self._use_native = native.available()
        self.frames = 0
        self.packets = 0
        self.bytes = 0
        self.send_errors = 0

    def write(self, nv12: np.ndarray) -> None:
        nv12 = np.asarray(nv12)
        if self._use_native:
            self._write_native(nv12)
            return
        for pkt in self.payloader.packetize(nv12):
            self.sock.sendto(pkt, self.addr)
            self.packets += 1
            self.bytes += len(pkt)
            self.payload_octets += len(pkt) - 12
        self.frames += 1
        self._rtcp_tick()

    def _write_native(self, nv12: np.ndarray) -> None:
        """GIL-free C++ send: header arena + zero-copy payload iovecs +
        sendmmsg (the Python packetizer makes ~13,000 ``sendto`` calls per
        4K frame)."""
        from opencv_opencl_tpu_torch import native

        p = self.payloader
        try:
            n = native.rtp_send_raw(self.sock.fileno(), nv12, p.mtu, p.seq,
                                    p.ts, p.ssrc, PT_RAW, self.addr[0],
                                    self.addr[1])
        except OSError as e:
            # a partial frame may be on the wire; NEVER re-send with stale
            # sequence numbers — skip the frame, stay consistent
            n = getattr(e, "packets_sent", 0)
            self.send_errors += 1
        self.packets += n
        p.seq = (p.seq + max(n, 0)) & 0xFFFF
        p.last_ts = p.ts
        p.ts = (p.ts + p.ts_step) & 0xFFFFFFFF
        # headers (20 bytes a packet) and the payload bytes that went out
        self.bytes += max(n, 0) * 20 + (nv12.nbytes if n > 0 else 0)
        self.payload_octets += max(n, 0) * 8 + (nv12.nbytes if n > 0 else 0)
        self.frames += 1
        self._rtcp_tick()

    def _rtcp_tick(self) -> None:
        if self.rtcp is not None:
            # pair NTP-now with the frame just sent: packetize already
            # advanced .ts one frame period past it
            self.rtcp.maybe_send_sr(self.payloader.last_ts, self.packets,
                                    self.payload_octets)

    @property
    def rtt_ms(self) -> float | None:
        """Round-trip time from the latest Receiver Report, if any."""
        return self.rtcp.rtt_ms if self.rtcp is not None else None

    def close(self) -> None:
        if self.rtcp is not None:
            self.rtcp.send_bye()
            self.rtcp.close()
        self.sock.close()


class RtpUdpReceiver:
    """Depacketize JPEG (RFC 2435) or raw streams back to frames."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 kind: str = "jpeg", frame_shape: tuple[int, int] | None = None,
                 timeout: float = 5.0, buffer_size: int = 60_000_000,
                 rtcp: bool = True, rtcp_schedule: str = "tick",
                 pt: int | None = None, relock_timeout: float | None = 5.0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            # the reference's 60 MB socket buffers (udpsink buffer-size):
            # a 4K raw frame is ~12 MB of datagrams per frame interval
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 buffer_size)
        except OSError:
            pass
        self.sock.bind((host, port))
        self.sock.settimeout(timeout)
        self.port = self.sock.getsockname()[1]
        self.kind = kind
        self.frame_shape = frame_shape
        self.frames_dropped = 0  # incomplete frames discarded (loss resync)
        self.packets_bad = 0     # runt/foreign/mismatched datagrams ignored
        if pt is None:
            pt = PT_JPEG if kind == "jpeg" else PT_RAW
        self._lock = StreamLock(pt=pt, relock_timeout=relock_timeout)
        self._relocks_seen = 0
        self.rtcp = None
        if rtcp:
            # Receiver Reports (loss/jitter + LSR/DLSR for the sender's
            # RTT) on the companion port; the peer is learned from the
            # sender's SRs.  RFC 3550 via io/rtcp.py.
            from opencv_opencl_tpu_torch.io.rtcp import companion_peer

            # companion port taken -> None: stats-only mode
            self.rtcp = companion_peer(0x52435652, self.port,
                                       schedule=rtcp_schedule,
                                       fallback_ephemeral=False)

    def recv_frame(self) -> np.ndarray | None:
        """Block until one complete frame arrives (marker bit)."""
        if self.kind == "jpeg":
            return self._recv_jpeg()
        return self._recv_raw()

    def _accept(self, pkt: bytes) -> bool:
        return self._lock.accept(pkt)

    def _note_packet(self, pkt: bytes) -> None:
        """Feed RTCP receive stats (seq machine + jitter) and emit RRs."""
        if self.rtcp is None:
            return
        if self._lock.relocks != self._relocks_seen:
            # a restarted sender took the lock (fresh SSRC): report on
            # the new stream, not the dead one's sequence space
            self._relocks_seen = self._lock.relocks
            from opencv_opencl_tpu_torch.io.rtcp import ReceiverStats

            self.rtcp.stats = ReceiverStats(
                clock_rate=self.rtcp.stats.clock_rate)
        if self.rtcp.stats.ssrc is None:
            self.rtcp.stats.ssrc = self._lock.ssrc
        seq = struct.unpack("!H", pkt[2:4])[0]
        ts = struct.unpack("!I", pkt[4:8])[0]
        self.rtcp.stats.note(seq, ts, len(pkt) - 12)
        self.rtcp.maybe_send_rr()

    def _recv_jpeg(self):
        import cv2

        frags: dict[int, bytes] = {}
        qtables: dict[int, bytes] = {}
        geom = None
        cur_ts = None
        while True:
            pkt, _ = self.sock.recvfrom(65536)
            if len(pkt) < 20 or not self._accept(pkt):
                self.packets_bad += 1
                continue
            self._note_packet(pkt)
            marker = bool(pkt[1] & 0x80)
            ts = struct.unpack("!I", pkt[4:8])[0]
            if cur_ts is None:
                cur_ts = ts
            elif ts != cur_ts:
                # a new frame started: the previous one lost its marker
                # packet — drop its fragments and resync (stream degrades
                # to frame drops, never to corrupted decodes)
                frags.clear()
                qtables.clear()
                self.frames_dropped += 1
                cur_ts = ts
            p = pkt[12:]
            off = (p[1] << 16) | (p[2] << 8) | p[3]
            jtype, q, w8, h8 = p[4], p[5], p[6], p[7]
            geom = (w8 * 8, h8 * 8, jtype)
            body = p[8:]
            if off == 0 and q >= 128:
                # in-band quantization header: validate before trusting
                # the length field (a truncated datagram must drop the
                # frame, not crash the receive loop or poison the JFIF)
                if len(body) < 4:
                    self.packets_bad += 1
                    continue
                qlen = struct.unpack("!H", body[2:4])[0]
                if qlen < 64 or len(body) < 4 + qlen:
                    self.packets_bad += 1
                    continue
                qt = body[4 : 4 + qlen]
                qtables[0] = qt[0:64]
                qtables[1] = qt[64:128] if qlen >= 128 else qt[0:64]
                body = body[4 + qlen :]
            frags[off] = body
            if marker:
                # completeness: fragment offsets must tile the scan with
                # no holes (a lost mid-frame packet leaves a gap)
                expect = 0
                complete = True
                for k in sorted(frags):
                    if k != expect:
                        complete = False
                        break
                    expect = k + len(frags[k])
                if complete and qtables:
                    break
                frags.clear()
                qtables.clear()
                self.frames_dropped += 1
                cur_ts = None
        scan = b"".join(frags[k] for k in sorted(frags))
        w, h, jtype = geom
        jfif = rebuild_jfif(scan, qtables, w, h, jtype)
        bgr = cv2.imdecode(np.frombuffer(jfif, np.uint8), cv2.IMREAD_COLOR)
        return bgr  # decoded image (lossy path: BGR out)

    def _recv_raw(self):
        rows, width = self.frame_shape
        frame = np.zeros((rows, width), np.uint8)
        filled = 0
        cur_ts = None
        while True:
            pkt, _ = self.sock.recvfrom(65536)
            if len(pkt) < 20 or not self._accept(pkt):
                self.packets_bad += 1
                continue
            self._note_packet(pkt)
            marker = bool(pkt[1] & 0x80)
            ts = struct.unpack("!I", pkt[4:8])[0]
            if cur_ts is None:
                cur_ts = ts
            elif ts != cur_ts:
                # previous frame never completed: drop + resync
                frame[:] = 0
                filled = 0
                self.frames_dropped += 1
                cur_ts = ts
            p = pkt[14:]  # strip RTP + extended seq
            n, line, off = struct.unpack("!HHH", p[:6])
            if line >= rows or off + n > width or len(p) < 6 + n:
                # geometry-mismatched or truncated SRD: not our stream
                self.packets_bad += 1
                continue
            frame[line, off : off + n] = np.frombuffer(
                p[6 : 6 + n], np.uint8)
            filled += n
            if marker:
                if filled == rows * width:
                    return frame
                # lost packets: incomplete frame — drop, await the next
                frame[:] = 0
                filled = 0
                self.frames_dropped += 1
                cur_ts = None

    def close(self) -> None:
        if self.rtcp is not None:
            # a final (forced) RR so short sessions still report, then BYE
            self.rtcp.maybe_send_rr(force=True)
            self.rtcp.send_bye()
            self.rtcp.close()
        self.sock.close()
