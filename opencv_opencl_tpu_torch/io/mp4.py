"""Minimal ISO-BMFF (MP4) muxer for the in-repo H.264 streams.

The reference's relays tee their encoded stream into an MP4 file
(``filesink location=out.mp4`` behind ``mp4mux`` —
``CLAHECompare.cpp`` family).  The framework's cv2
``FileSink`` re-encodes pixels with mp4v; this module instead wraps the
ALREADY-ENCODED Annex-B H.264 access units (from the in-repo CAVLC/GOP
encoders, or any stream ``H26xRtpReceiver`` reassembles) into a real
MP4 container with no transcode:

- one video track, ``avc1`` sample entry with the stream's own SPS/PPS
  in the ``avcC`` record (parameter sets are stripped from the
  samples, as avc1 requires);
- samples are the access units converted from Annex-B start codes to
  4-byte-length-prefixed NAL units;
- IDR samples indexed in ``stss`` (sync sample table) so players seek
  to the GOP starts the encoder laid down;
- width/height parsed from the SPS itself (exp-Golomb reader below —
  handles the baseline/main shapes the in-repo encoders and common
  external encoders emit, including frame cropping);
- validated by decoding the result through libavformat/libavcodec
  (cv2.VideoCapture) bit-exactly against the encoder reconstruction
  (tests/test_mp4.py).

One chunk, `stts` with a single constant delta (constant fps), 90 kHz
media timescale: the exact shape of the fixed-rate streams the relays
produce.

The port's own copy of ``opencv_opencl_tpu/io/mp4.py``: the same boxes.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_mp4", "split_nals", "parse_sps_dims"]

_TIMESCALE = 90000


def split_nals(au: bytes) -> list[bytes]:
    """Split one Annex-B access unit into NAL units (3- and 4-byte
    start codes both accepted; the leading start code is required)."""
    out = []
    i = au.find(b"\x00\x00\x01")
    if i < 0:
        raise ValueError("no start code in access unit")
    i += 3
    while True:
        j = au.find(b"\x00\x00\x01", i)
        if j < 0:
            out.append(au[i:])
            return out
        end = j
        if end > i and au[end - 1] == 0:  # 4-byte start code
            end -= 1
        out.append(au[i:end])
        i = j + 3


class _BitReader:
    def __init__(self, rbsp: bytes):
        self.d = rbsp
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.d[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-Golomb code")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def _unescape(nal: bytes) -> bytes:
    """Remove emulation-prevention bytes (00 00 03 -> 00 00)."""
    return nal.replace(b"\x00\x00\x03", b"\x00\x00")


def parse_sps_dims(sps: bytes) -> tuple[int, int]:
    """(width, height) from an SPS NAL (header byte included).  Parses
    the frame_mbs_only baseline/main/high shapes incl. cropping; high
    profiles with scaling lists are rejected explicitly rather than
    misparsed."""
    r = _BitReader(_unescape(sps[1:]))
    profile = r.u(8)
    r.u(8)                      # constraint flags + reserved
    r.u(8)                      # level_idc
    r.ue()                      # seq_parameter_set_id
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        chroma = r.ue()
        if chroma == 3:
            r.u(1)
        r.ue()                  # bit_depth_luma_minus8
        r.ue()                  # bit_depth_chroma_minus8
        r.u(1)                  # qpprime_y_zero_transform_bypass
        if r.u(1):              # seq_scaling_matrix_present
            raise ValueError("SPS with scaling lists not supported")
    r.ue()                      # log2_max_frame_num_minus4
    poc = r.ue()                # pic_order_cnt_type
    if poc == 0:
        r.ue()                  # log2_max_pic_order_cnt_lsb_minus4
    elif poc == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()                      # max_num_ref_frames
    r.u(1)                      # gaps_in_frame_num_value_allowed
    w_mbs = r.ue() + 1
    h_units = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)                  # mb_adaptive_frame_field
    r.u(1)                      # direct_8x8_inference
    width = w_mbs * 16
    height = h_units * 16 * (2 - frame_mbs_only)
    if r.u(1):                  # frame_cropping_flag (4:2:0 units)
        cl, cr_, ct, cb = r.ue(), r.ue(), r.ue(), r.ue()
        width -= 2 * (cl + cr_)
        height -= (2 * (2 - frame_mbs_only)) * (ct + cb)
    return width, height


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _full(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags) + payload)


def write_mp4(path: str, aus: list[bytes], fps: float) -> dict:
    """Mux Annex-B H.264 access units into an MP4 file.  The first
    in-band SPS/PPS become the avcC record; parameter sets are stripped
    from the samples (avc1 stores them out of band).  Returns summary
    info (width, height, samples, sync sample count)."""
    if not aus:
        raise ValueError("no access units")
    sps = pps = None
    samples: list[bytes] = []
    sync: list[int] = []
    for au in aus:
        parts = []
        is_idr = False
        for nal in split_nals(au):
            t = nal[0] & 0x1F
            if t == 7:
                sps = sps or bytes(nal)
                continue
            if t == 8:
                pps = pps or bytes(nal)
                continue
            if t == 5:
                is_idr = True
            parts.append(struct.pack(">I", len(nal)) + nal)
        if not parts:
            continue
        if is_idr:
            sync.append(len(samples) + 1)       # 1-based
        samples.append(b"".join(parts))
    if sps is None or pps is None:
        raise ValueError("stream carries no SPS/PPS (cannot build avcC)")
    width, height = parse_sps_dims(sps)
    n = len(samples)
    delta = round(_TIMESCALE / fps)
    dur = n * delta

    avcc = _box(b"avcC", bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
                + struct.pack(">H", len(sps)) + sps
                + bytes([1]) + struct.pack(">H", len(pps)) + pps)
    avc1 = _box(b"avc1",
                b"\x00" * 6 + struct.pack(">H", 1)      # data_ref_idx
                + b"\x00" * 16                          # pre_defined
                + struct.pack(">HH", width, height)
                + struct.pack(">II", 0x00480000, 0x00480000)
                + b"\x00" * 4 + struct.pack(">H", 1)    # frame_count
                + b"\x00" * 32                          # compressorname
                + struct.pack(">Hh", 0x0018, -1) + avcc)
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + avc1)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", 0, 0,
                 struct.pack(">II", 0, n)
                 + b"".join(struct.pack(">I", len(s)) for s in samples))
    stss = _full(b"stss", 0, 0,
                 struct.pack(">I", len(sync))
                 + b"".join(struct.pack(">I", i) for i in sync))

    # the chunk offset depends on the total header size — build the
    # moov once with a placeholder to learn the layout, then rebuild
    def build(offset: int) -> bytes:
        stco = _full(b"stco", 0, 0, struct.pack(">II", 1, offset))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stss + stco)
        url = _full(b"url ", 0, 1, b"")
        dinf = _box(b"dinf", _full(b"dref", 0, 0,
                                   struct.pack(">I", 1) + url))
        vmhd = _full(b"vmhd", 0, 1, b"\x00" * 8)
        minf = _box(b"minf", vmhd + dinf + stbl)
        hdlr = _full(b"hdlr", 0, 0,
                     b"\x00" * 4 + b"vide" + b"\x00" * 12
                     + b"VideoHandler\x00")
        mdhd = _full(b"mdhd", 0, 0,
                     struct.pack(">IIII", 0, 0, _TIMESCALE, dur)
                     + struct.pack(">HH", 0x55C4, 0))   # und language
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full(b"tkhd", 0, 3,
                     struct.pack(">IIIII", 0, 0, 1, 0, dur)
                     + b"\x00" * 8 + struct.pack(">HHHH", 0, 0, 0, 0)
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0,
                                   0, 0, 0x40000000)
                     + struct.pack(">II", width << 16, height << 16))
        trak = _box(b"trak", tkhd + mdia)
        mvhd = _full(b"mvhd", 0, 0,
                     struct.pack(">IIII", 0, 0, _TIMESCALE, dur)
                     + struct.pack(">IH", 0x00010000, 0x0100)
                     + b"\x00" * 10
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0,
                                   0, 0, 0x40000000)
                     + b"\x00" * 24 + struct.pack(">I", 2))
        moov = _box(b"moov", mvhd + trak)
        return moov

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200)
                + b"isomiso2avc1mp41")
    mdat_payload = b"".join(samples)
    probe = build(0)
    offset = len(ftyp) + len(probe) + 8     # mdat header
    moov = build(offset)
    assert len(moov) == len(probe)
    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(moov)
        f.write(_box(b"mdat", mdat_payload))
    return {"width": width, "height": height, "samples": n,
            "sync_samples": len(sync), "bytes": len(mdat_payload)}
