"""Minimal SDP offer/answer generation and parsing (RFC 4566 / JSEP shape).

The port's own copy of ``opencv_opencl_tpu/io/sdp.py`` (host code, the
same strings).

On GStreamer hosts the sender's SDP comes from webrtcbin
(``webrtc/sender.cpp:182-229`` create-offer ->
set-local-description); this module provides the same negotiation artifacts
for hosts without GStreamer so the control plane carries *real, parseable*
SDP end-to-end instead of a placeholder blob: a structurally valid offer
for the sender's media configuration, a parser for offers/answers, and an
answer generator for the viewer side (what ``webrtc/inn.html:383-406`` does
with ``pc.createAnswer``).

The ICE credentials/fingerprint are freshly generated values in the valid
format — the DTLS handshake itself still belongs to a real WebRTC stack;
this covers the signaling-plane semantics (m-line mirroring, direction
reversal, payload-type agreement, BUNDLE).
"""

from __future__ import annotations

import dataclasses
import secrets

__all__ = [
    "MediaDescription",
    "SdpSession",
    "build_offer",
    "build_answer",
    "build_rtp_session_sdp",
    "parse_sdp",
    "media_for_codec",
]

_CODEC_MAP = {
    "h264": ("H264", 96, 90000),
    "h265": ("H265", 96, 90000),
    "vp8": ("VP8", 96, 90000),
    "opus": ("OPUS", 97, 48000),
}


@dataclasses.dataclass
class MediaDescription:
    """One m= section."""

    kind: str                 # "video" | "audio"
    payload_type: int
    encoding_name: str
    clock_rate: int
    direction: str = "sendonly"
    mid: str = "video0"
    channels: int | None = None   # opus: 2
    attributes: list[str] = dataclasses.field(default_factory=list)

    @property
    def rtpmap(self) -> str:
        tail = f"/{self.channels}" if self.channels else ""
        return (f"a=rtpmap:{self.payload_type} "
                f"{self.encoding_name}/{self.clock_rate}{tail}")


@dataclasses.dataclass
class SdpSession:
    session_name: str
    medias: list[MediaDescription]
    session_attributes: list[str] = dataclasses.field(default_factory=list)
    ice_ufrag: str | None = None
    ice_pwd: str | None = None
    fingerprint: str | None = None


def media_for_codec(codec: str, kind: str = "video",
                    direction: str = "sendonly",
                    mid: str | None = None) -> MediaDescription:
    name, pt, rate = _CODEC_MAP[codec.lower()]
    return MediaDescription(
        kind=kind, payload_type=pt, encoding_name=name, clock_rate=rate,
        direction=direction,
        mid=mid or ("audio1" if kind == "audio" else "video0"),
        channels=2 if codec.lower() == "opus" else None,
    )


def _gen_fingerprint() -> str:
    raw = secrets.token_bytes(32)
    return "sha-256 " + ":".join(f"{b:02X}" for b in raw)


def build_offer(medias: list[MediaDescription],
                session_name: str = "tpu-relay") -> str:
    """A structurally valid JSEP-style offer for the given media set."""
    ufrag = secrets.token_urlsafe(6)
    pwd = secrets.token_urlsafe(18)
    fp = _gen_fingerprint()
    sid = secrets.randbits(62)
    lines = [
        "v=0",
        f"o=- {sid} 2 IN IP4 127.0.0.1",
        f"s={session_name}",
        "t=0 0",
        "a=group:BUNDLE " + " ".join(m.mid for m in medias),
        "a=msid-semantic: WMS tpu",
    ]
    for m in medias:
        lines += [
            f"m={m.kind} 9 UDP/TLS/RTP/SAVPF {m.payload_type}",
            "c=IN IP4 0.0.0.0",
            f"a=ice-ufrag:{ufrag}",
            f"a=ice-pwd:{pwd}",
            f"a=fingerprint:{fp}",
            "a=setup:actpass",
            f"a=mid:{m.mid}",
            f"a={m.direction}",
            "a=rtcp-mux",
            m.rtpmap,
            *m.attributes,
        ]
    return "\r\n".join(lines) + "\r\n"


def build_rtp_session_sdp(host: str, port: int, kind: str,
                          width: int | None = None,
                          height: int | None = None,
                          session_name: str = "opencv-opencl-tpu") -> str:
    """A plain (non-WebRTC) RTP session description for the native RTP
    sinks (io/rtp.py, io/rtp_h26x.py) — the ``.sdp`` file a stock player
    (ffplay/VLC/GStreamer ``sdpdemux``) opens to receive the stream the
    reference pointed at a lab PC (``udpsink host=… port=5004``,
    ``OpenCVequalHist.cpp:316-317``).

    kinds: ``jpeg`` (RFC 2435, static PT 26 — universally decodable),
    ``h264``/``h265`` (RFC 6184/7798, packetization-mode=1), and ``raw``
    (our RFC 4175-style NV12 line format; advertised with the private
    encoding name ``X-NV12`` since 4175 has no NV12 sampling — only our
    receiver decodes it, so the SDP is honest about that).
    """
    sid = secrets.randbits(62)
    lines = [
        "v=0",
        f"o=- {sid} 1 IN IP4 {host}",
        f"s={session_name}",
        f"c=IN IP4 {host}",
        "t=0 0",
    ]
    if kind == "jpeg":
        lines += [f"m=video {port} RTP/AVP 26", "a=rtpmap:26 JPEG/90000"]
    elif kind in ("h264", "h265"):
        enc = "H264" if kind == "h264" else "H265"
        lines += [
            f"m=video {port} RTP/AVP 96",
            f"a=rtpmap:96 {enc}/90000",
            "a=fmtp:96 packetization-mode=1",
        ]
    elif kind == "raw":
        fmtp = "a=fmtp:96 sampling=YCbCr-4:2:0; depth=8"
        if width and height:
            fmtp += f"; width={width}; height={height}"
        lines += [
            f"m=video {port} RTP/AVP 96",
            "a=rtpmap:96 X-NV12/90000",
            fmtp,
        ]
    else:
        raise ValueError(f"unknown rtp payload kind {kind!r}")
    return "\r\n".join(lines) + "\r\n"


_REVERSE = {"sendonly": "recvonly", "recvonly": "sendonly",
            "sendrecv": "sendrecv", "inactive": "inactive"}


def build_answer(offer: SdpSession, session_name: str = "viewer") -> str:
    """Mirror each offered m-line with the direction reversed and the
    DTLS role pinned (setup:active) — the shape pc.createAnswer returns."""
    ufrag = secrets.token_urlsafe(6)
    pwd = secrets.token_urlsafe(18)
    fp = _gen_fingerprint()
    sid = secrets.randbits(62)
    lines = [
        "v=0",
        f"o=- {sid} 2 IN IP4 127.0.0.1",
        f"s={session_name}",
        "t=0 0",
        "a=group:BUNDLE " + " ".join(m.mid for m in offer.medias),
        "a=msid-semantic: WMS",
    ]
    for m in offer.medias:
        lines += [
            f"m={m.kind} 9 UDP/TLS/RTP/SAVPF {m.payload_type}",
            "c=IN IP4 0.0.0.0",
            f"a=ice-ufrag:{ufrag}",
            f"a=ice-pwd:{pwd}",
            f"a=fingerprint:{fp}",
            "a=setup:active",
            f"a=mid:{m.mid}",
            f"a={_REVERSE.get(m.direction, 'recvonly')}",
            "a=rtcp-mux",
            m.rtpmap,
        ]
    return "\r\n".join(lines) + "\r\n"


def parse_sdp(text: str) -> SdpSession:
    """Parse the subset of SDP the signaling plane needs: session name,
    m-lines with payload types, rtpmap, mid, direction, ICE/DTLS attrs."""
    session_name = ""
    medias: list[MediaDescription] = []
    session_attrs: list[str] = []
    ufrag = pwd = fp = None
    cur: MediaDescription | None = None
    for raw in text.replace("\r\n", "\n").split("\n"):
        line = raw.strip()
        if not line or "=" not in line:
            continue
        key, val = line.split("=", 1)
        if key == "s":
            session_name = val
        elif key == "m":
            parts = val.split()
            if not parts:
                # malformed m-line from a broken peer: its following a=
                # attributes must be discarded, not attributed to the
                # previous media section — point cur at a throwaway
                cur = MediaDescription(
                    kind="", payload_type=0, encoding_name="",
                    clock_rate=0, direction="sendrecv", mid="")
                continue
            kind = parts[0]
            pts = []
            for tok in parts[3:]:
                try:
                    pts.append(int(tok))
                except ValueError:
                    pass  # salvage the valid payload types around it
            cur = MediaDescription(
                kind=kind, payload_type=pts[0] if pts else 0,
                encoding_name="", clock_rate=0, direction="sendrecv",
                mid="",
            )
            medias.append(cur)
        elif key == "a":
            if cur is None:
                session_attrs.append(val)
                continue
            if val.startswith("rtpmap:"):
                # tolerate malformed rtpmap from broken peers: a parse
                # failure must not crash the signaling dispatch
                try:
                    body = val[len("rtpmap:"):]
                    pt_s, enc = body.split(" ", 1)
                    if int(pt_s) == cur.payload_type:
                        enc_parts = enc.split("/")
                        cur.encoding_name = enc_parts[0]
                        cur.clock_rate = int(enc_parts[1])
                        if len(enc_parts) > 2:
                            cur.channels = int(enc_parts[2])
                except (ValueError, IndexError):
                    pass
            elif val.startswith("mid:"):
                cur.mid = val[4:]
            elif val in _REVERSE:
                cur.direction = val
            elif val.startswith("ice-ufrag:"):
                ufrag = val.split(":", 1)[1]
            elif val.startswith("ice-pwd:"):
                pwd = val.split(":", 1)[1]
            elif val.startswith("fingerprint:"):
                fp = val.split(":", 1)[1]
            else:
                cur.attributes.append(val)
    return SdpSession(
        session_name=session_name, medias=medias,
        session_attributes=session_attrs,
        ice_ufrag=ufrag, ice_pwd=pwd, fingerprint=fp,
    )
