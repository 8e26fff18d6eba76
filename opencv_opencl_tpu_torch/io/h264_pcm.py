"""Pure-Python lossless H.264 encoder (I_PCM macroblocks).

The reference's emit side always encodes before transmitting
(``OpenCVequalHist.cpp:308-332``: appsrc -> omxh264enc ->
rtph264pay -> udpsink).  This container has no H.264 *encoder* (no x264,
no ffmpeg CLI, no OMX hardware) — but H.264 itself has a lossless,
entropy-coding-free macroblock mode: **I_PCM** (ITU-T H.264 §7.3.5 /
§8.3.5), where each 16x16 macroblock is a fixed 2-byte CAVLC prefix
(``ue(25)`` + alignment) followed by the raw luma/chroma samples.  That
makes a standards-compliant baseline-profile encoder expressible in
~200 lines of numpy, bit-exact by construction, decodable by every
H.264 decoder (libavcodec, omxh264dec, browsers), and fast: after the
slice header every macroblock is byte-aligned, so the whole slice is a
single vectorized assembly:

    [4-byte slice head][MB0 samples][\\x0d\\x00 MB1 samples]...[0x80]

Bitstream layout choices (all spec-conformant, chosen for simplicity):
baseline profile (66), one IDR slice per frame (``idr_pic_id``
alternates 0/1 as §7.4.3 requires for consecutive IDRs),
``pic_order_cnt_type=2``, CAVLC, no VUI.  Emulation prevention
(§7.4.1.1) is applied with a sequential-equivalent regex pass.

This is the always-available backend of the relay's pluggable encoder
boundary (io.encoder); external/gi encoders take over when a host
provides them.

The port's own copy of ``opencv_opencl_tpu/io/h264_pcm.py``: the same
bytes, its C++ fast path through the port's ``native``.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["PcmH264Encoder", "encode_frame_pcm", "build_sps", "build_pps",
           "encode_frame_pcm_slices", "encode_frame_pcm_slices_native"]

_START4 = b"\x00\x00\x00\x01"
# 00 00 followed by a byte <= 03 needs an 03 escape; re.sub's
# non-overlapping left-to-right scan with a lookahead reproduces the
# spec's sequential zero-run algorithm exactly (the run counter resets
# after each insertion, and the trigger byte is re-examined).  Kept as
# the small-input path and the test oracle for the vectorized version.
_EMU_RE = re.compile(b"\x00\x00(?=[\x00-\x03])", re.DOTALL)


def _escape_np(data: np.ndarray) -> bytes:
    """Vectorized emulation prevention over zero runs.

    The sequential algorithm only ever inserts inside or at the end of a
    maximal run of zeros: a run of length L gets floor((L-1)/2) escapes
    at its 3rd, 5th, ... zeros, and ends with 2 - (L % 2) pending zeros,
    so its following byte triggers one more escape iff L is even and the
    byte is 1..3 (a following 0 would extend the run).  This closed form
    turns the regex scan — pathological on dark PCM frames, where every
    byte is 0x00 — into a few numpy passes + one np.insert.
    """
    z = data == 0
    if not z.any():
        return data.tobytes()
    # run boundaries via boolean transitions (np.diff on multi-MB int8
    # measured ~100x slower than this on the pinned numpy)
    t = np.flatnonzero(z[1:] != z[:-1]) + 1
    if z[0]:
        t = np.concatenate(([0], t))
    if z[-1]:
        t = np.concatenate((t, [len(z)]))
    starts, ends = t[0::2], t[1::2]  # run k: [starts[k], ends[k])
    lens = ends - starts
    pos_chunks = []
    # in-run escapes: s+2, s+4, ..., count floor((L-1)/2) per run
    k = (lens - 1) // 2
    if np.any(k > 0):
        ks = k[k > 0]
        base = np.repeat(starts[k > 0] + 2, ks)
        csum = np.concatenate([[0], np.cumsum(ks)])
        within = np.arange(csum[-1]) - np.repeat(csum[:-1], ks)
        pos_chunks.append(base + 2 * within)
    # end-of-run trigger: L even and the following byte is 1..3
    even = lens % 2 == 0
    fb = ends[even]
    fb = fb[fb < len(data)]
    fb = fb[data[fb] <= 3]
    if len(fb):
        pos_chunks.append(fb)
    if not pos_chunks:
        return data.tobytes()
    pos = np.concatenate(pos_chunks)
    pos.sort()
    return np.insert(data, pos, 3).tobytes()


def _escape(rbsp: bytes | np.ndarray) -> bytes:
    """Insert emulation-prevention 0x03 bytes (§7.4.1.1)."""
    if isinstance(rbsp, np.ndarray):
        return _escape_np(rbsp)
    if len(rbsp) > 4096:
        return _escape_np(np.frombuffer(rbsp, np.uint8))
    return _EMU_RE.sub(b"\x00\x00\x03", rbsp)


class _BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []

    def u(self, value: int, n: int) -> "_BitWriter":
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)
        return self

    def ue(self, value: int) -> "_BitWriter":
        # Exp-Golomb: leading zeros + binary(value+1)
        code = value + 1
        n = code.bit_length()
        return self.u(code, 2 * n - 1)

    def se(self, value: int) -> "_BitWriter":
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def trailing(self) -> "_BitWriter":
        """rbsp_trailing_bits: stop bit + zero alignment."""
        self._bits.append(1)
        while len(self._bits) % 8:
            self._bits.append(0)
        return self

    def align_zero(self) -> "_BitWriter":
        while len(self._bits) % 8:
            self._bits.append(0)
        return self

    def bytes(self) -> bytes:
        assert len(self._bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self._bits), 8):
            b = 0
            for bit in self._bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


# (MaxFS macroblocks per frame, MaxDpbMbs) per level, Table A-1
# (subset; 6.0-6.2 cover 8K, which this framework supports beyond the
# reference's 4K cap)
_LEVEL_BY_MBS = [(99, 396, 10), (396, 900, 11), (792, 4752, 21),
                 (1620, 8100, 22), (3600, 18000, 31),
                 (5120, 20480, 32), (8192, 32768, 40),
                 (22080, 110400, 50), (36864, 184320, 51),
                 (139264, 696320, 60)]


def _level_for(mbs: int, dpb_frames: int = 1) -> int:
    """Smallest level whose MaxFS fits the frame AND whose MaxDpbMbs
    fits ``dpb_frames`` decoded pictures (A.3.1: max_num_ref_frames <=
    MaxDpbMbs / frame MBs) — multi-reference streams must bump the
    level when the DPB, not the frame, is the binding constraint."""
    for max_fs, max_dpb, level in _LEVEL_BY_MBS:
        if mbs <= max_fs and dpb_frames * mbs <= max_dpb:
            return level
    return 62


def build_sps(width: int, height: int, hrd=None) -> bytes:
    """Sequence parameter set for a frame_mbs_only baseline stream.
    ``hrd`` (io.h264_hrd.HrdParams) adds VUI timing + NAL HRD
    parameters — the declared CPB model of cpb-constrained streams."""
    mb_w = -(-width // 16)
    mb_h = -(-height // 16)
    crop_r = (mb_w * 16 - width) // 2   # CropUnitX = 2 (4:2:0)
    crop_b = (mb_h * 16 - height) // 2  # CropUnitY = 2 (frame_mbs_only)
    w = _BitWriter()
    w.u(0, 1).u(3, 2).u(7, 5)        # nal: forbidden=0, ref_idc=3, type=SPS
    w.u(66, 8)                       # profile_idc: baseline
    w.u(0b11000000, 8)               # constraint_set0+1, reserved zeros
    w.u(_level_for(mb_w * mb_h), 8)  # level_idc
    w.ue(0)                          # seq_parameter_set_id
    w.ue(0)                          # log2_max_frame_num_minus4 -> u(4)
    w.ue(2)                          # pic_order_cnt_type: 2 (no POC syntax)
    w.ue(0)                          # max_num_ref_frames (all-IDR stream)
    w.u(0, 1)                        # gaps_in_frame_num_value_allowed
    w.ue(mb_w - 1)                   # pic_width_in_mbs_minus1
    w.ue(mb_h - 1)                   # pic_height_in_map_units_minus1
    w.u(1, 1)                        # frame_mbs_only_flag
    w.u(1, 1)                        # direct_8x8_inference_flag
    if crop_r or crop_b:
        w.u(1, 1)                    # frame_cropping_flag
        w.ue(0).ue(crop_r).ue(0).ue(crop_b)
    else:
        w.u(0, 1)
    if hrd is None:
        w.u(0, 1)                    # vui_parameters_present_flag
    else:
        hrd.write_vui(w)
    w.trailing()
    return _escape(w.bytes())


def build_pps() -> bytes:
    """Picture parameter set: CAVLC, single slice group, defaults."""
    w = _BitWriter()
    w.u(0, 1).u(3, 2).u(8, 5)  # nal header: PPS
    w.ue(0)                    # pic_parameter_set_id
    w.ue(0)                    # seq_parameter_set_id
    w.u(0, 1)                  # entropy_coding_mode_flag: CAVLC
    w.u(0, 1)                  # bottom_field_pic_order_in_frame_present
    w.ue(0)                    # num_slice_groups_minus1
    w.ue(0).ue(0)              # num_ref_idx_l{0,1}_default_active_minus1
    w.u(0, 1)                  # weighted_pred_flag
    w.u(0, 2)                  # weighted_bipred_idc
    w.se(0).se(0)              # pic_init_qp/qs_minus26
    w.se(0)                    # chroma_qp_index_offset
    w.u(0, 1)                  # deblocking_filter_control_present_flag
    w.u(0, 1)                  # constrained_intra_pred_flag
    w.u(0, 1)                  # redundant_pic_cnt_present_flag
    w.trailing()
    return _escape(w.bytes())


def _slice_head(idr_pic_id: int, first_mb: int = 0) -> bytes:
    """IDR slice header + the slice's first MB's mb_type/alignment,
    byte-aligned so every subsequent macroblock is the fixed 2-byte
    prefix.  ``first_mb`` > 0 starts a non-first slice of the picture
    (multi-slice frames: each slice is independently parallelizable and
    RTP-friendlier than one giant NAL)."""
    w = _BitWriter()
    w.u(0, 1).u(3, 2).u(5, 5)  # nal header: IDR slice, ref_idc 3
    w.ue(first_mb)             # first_mb_in_slice
    w.ue(7)                    # slice_type: I (all slices of picture)
    w.ue(0)                    # pic_parameter_set_id
    w.u(0, 4)                  # frame_num (log2_max_frame_num = 4)
    w.ue(idr_pic_id)           # idr_pic_id (alternates, §7.4.3)
    w.u(0, 1)                  # no_output_of_prior_pics_flag
    w.u(0, 1)                  # long_term_reference_flag
    w.se(0)                    # slice_qp_delta
    w.ue(25)                   # MB0 mb_type: I_PCM
    w.align_zero()             # pcm_alignment_zero_bit(s)
    return w.bytes()


# every non-first macroblock: ue(25) then alignment = 0x0D 0x00
_MB_PREFIX = bytes([0x0D, 0x00])


def _fill_mb_samples(nv12: np.ndarray, width: int, height: int,
                     dest: np.ndarray, mb_row0: int = 0,
                     mb_rows: int | None = None) -> None:
    """Write per-macroblock samples (256 luma + 64 Cb + 64 Cr, MB raster
    order, edge-replicated to the 16-pixel grid) into ``dest`` of shape
    (band_mbs, 384) — which may be a STRIDED view into the slice buffer,
    so the band's pixels are copied exactly once.  ``mb_row0``/``mb_rows``
    select an MB-row band (the multi-slice path fills each slice's
    buffer directly, in parallel, with no intermediate full-frame table)."""
    mb_w = -(-width // 16)
    mb_h_full = -(-height // 16)
    if mb_rows is None:
        mb_rows = mb_h_full
    y = nv12[:height][mb_row0 * 16 : (mb_row0 + mb_rows) * 16]
    uv = nv12[height:].reshape(height // 2, width // 2, 2)
    pad_y = (mb_rows * 16 - y.shape[0], mb_w * 16 - width)
    if pad_y != (0, 0):  # np.pad copies even for zero widths: skip it
        y = np.pad(y, ((0, pad_y[0]), (0, pad_y[1])), mode="edge")
    cb = uv[mb_row0 * 8 : (mb_row0 + mb_rows) * 8, :, 0]
    cr = uv[mb_row0 * 8 : (mb_row0 + mb_rows) * 8, :, 1]
    pad_c = (mb_rows * 8 - cb.shape[0], mb_w * 8 - width // 2)
    if pad_c != (0, 0):
        cb = np.pad(cb, ((0, pad_c[0]), (0, pad_c[1])), mode="edge")
        cr = np.pad(cr, ((0, pad_c[0]), (0, pad_c[1])), mode="edge")
    # 4-D destination views over the strided dest: one strided copy from
    # the transposed SOURCE views, no intermediate materialization
    d4y = np.lib.stride_tricks.as_strided(
        dest[:, :256], (mb_rows, mb_w, 16, 16),
        (mb_w * dest.strides[0], dest.strides[0], 16, 1))
    d4y[:] = y.reshape(mb_rows, 16, mb_w, 16).transpose(0, 2, 1, 3)
    for off, plane in ((256, cb), (320, cr)):
        d4 = np.lib.stride_tricks.as_strided(
            dest[:, off : off + 64], (mb_rows, mb_w, 8, 8),
            (mb_w * dest.strides[0], dest.strides[0], 8, 1))
        d4[:] = plane.reshape(mb_rows, 8, mb_w, 8).transpose(0, 2, 1, 3)


def encode_frame_pcm_slices(nv12: np.ndarray, width: int, height: int,
                            idr_pic_id: int = 0, slices: int = 2,
                            pool=None) -> list[bytes]:
    """The frame as ``slices`` IDR slice NALs (MB-row bands, no start
    codes).  Each slice's buffer is filled DIRECTLY from its band's
    pixels and escaped independently, so a thread pool parallelizes the
    whole per-slice pipeline — fill, prefix stamp, escape (numpy copies
    release the GIL).  The reference tuned ``omxh264enc num-slices=8``
    for the same reasons: parallel encode + smaller NALs on the wire.

    Per-slice buffer layout: [head][MB_first 384B]([2B prefix][384B])*
    [0x80], where the band table is a (band_mbs, 386) view whose first
    row's 2-byte prefix slot overlaps the head's tail — prefixes are
    stamped first, then the head overwrites the first MB's slot (its
    mb_type+alignment live inside the head)."""
    if width % 2 or height % 2:
        raise ValueError("NV12 requires even dimensions")
    nv12 = np.ascontiguousarray(nv12)
    mb_w = -(-width // 16)
    mb_h = -(-height // 16)
    slices = max(1, min(int(slices), mb_h))
    row_bounds = [round(i * mb_h / slices) for i in range(slices + 1)]

    def one(i: int) -> bytes:
        r0, r1 = row_bounds[i], row_bounds[i + 1]
        band = (r1 - r0) * mb_w
        head = _slice_head(idr_pic_id, first_mb=r0 * mb_w)
        off = len(head) - 2
        buf = np.empty(off + band * 386 + 1, np.uint8)
        mbs = buf[off : off + band * 386].reshape(band, 386)
        mbs[:, 0] = 0x0D
        mbs[:, 1] = 0x00
        _fill_mb_samples(nv12, width, height, mbs[:, 2:],
                         mb_row0=r0, mb_rows=r1 - r0)
        buf[: len(head)] = np.frombuffer(head, np.uint8)
        buf[-1] = 0x80  # rbsp_slice_trailing_bits
        return _escape(buf)

    if pool is not None and slices > 1:
        return list(pool.map(one, range(slices)))
    return [one(i) for i in range(slices)]


def encode_frame_pcm(nv12: np.ndarray, width: int, height: int,
                     idr_pic_id: int = 0) -> bytes:
    """One IDR slice NAL (no start code) holding the whole frame as
    I_PCM macroblocks — losslessly (the slices=1 degenerate case)."""
    return encode_frame_pcm_slices(nv12, width, height, idr_pic_id,
                                   slices=1)[0]


def encode_frame_pcm_slices_native(nv12: np.ndarray, width: int,
                                   height: int, idr_pic_id: int = 0,
                                   slices: int = 1, threads: int = 0,
                                   workspace: dict | None = None,
                                   copy: bool = True) -> list:
    """C++ fast path for :func:`encode_frame_pcm_slices` — identical
    output bytes (diffed in tests/test_native_pcm.py), several times the
    speed: the fused MB-fill + §7.4.1.1 escape pass runs GIL-free in
    ``native.pcm_encode_slices`` while the slice heads (the actual
    bitstream syntax) stay in the tested Python bit writer.
    ``workspace``/``copy`` as in :func:`native.pcm_encode_slices`
    (arena reuse; ``copy=False`` returns views valid until the next
    call).  Raises RuntimeError when the native runtime is unavailable."""
    from opencv_opencl_tpu_torch import native

    if width % 2 or height % 2:
        raise ValueError("NV12 requires even dimensions")
    mb_h = -(-height // 16)
    slices = max(1, min(int(slices), mb_h))
    row_bounds = [round(i * mb_h / slices) for i in range(slices + 1)]
    mb_w = -(-width // 16)
    heads = [_slice_head(idr_pic_id, first_mb=row_bounds[i] * mb_w)
             for i in range(slices)]
    return native.pcm_encode_slices(
        np.asarray(nv12, np.uint8), width, height, heads, row_bounds,
        threads=threads, workspace=workspace, copy=copy)


class PcmH264Encoder:
    """Frame-in/AU-out H.264 encoder, losslessly PCM-coding every frame.

    Implements the io.encoder FrameEncoder protocol: ``encode`` returns
    the completed Annex-B access units for one NV12 frame (always
    exactly one here — SPS+PPS ride ahead of each IDR so any receiver
    can join mid-stream, like ``rtph264pay config-interval=-1``).
    """

    codec = "h264"

    def __init__(self, width: int, height: int, slices: int = 1,
                 threads: int = 0, native: str = "auto") -> None:
        """``slices`` > 1 splits every frame into that many IDR slices
        (MB-row bands) — smaller NALs on the wire and, with
        ``threads`` > 0, parallel per-slice assembly/escaping (C++
        std::threads on the native path; a Python thread pool on the
        fallback — numpy copies release the GIL).  ``native`` is
        ``"auto"`` (C++ fast path when the toolchain built it — ~10x),
        ``"never"`` (pure Python — the oracle the native path is diffed
        against), or ``"require"`` (raise if unavailable)."""
        if width % 2 or height % 2:
            raise ValueError("NV12 requires even dimensions")
        self.width = width
        self.height = height
        self.slices = max(1, int(slices))
        self._sps = build_sps(width, height)
        self._pps = build_pps()
        self._idr_pic_id = 0
        self.frames = 0
        self._pool = None
        self._threads = max(0, int(threads))
        from opencv_opencl_tpu_torch import native as _native_mod

        if native == "never":
            self._native = False
        elif native == "require":
            if not _native_mod.available():
                raise RuntimeError(
                    f"native runtime unavailable: {_native_mod.build_error()}")
            self._native = True
        else:
            self._native = _native_mod.available()
        self._workspace: dict = {}
        if not self._native and self._threads > 0 and self.slices > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=threads,
                                            thread_name_prefix="pcm-slice")

    def encode(self, nv12: np.ndarray) -> list[bytes]:
        rows = self.height * 3 // 2
        arr = np.asarray(nv12, dtype=np.uint8).reshape(rows, self.width)
        self._idr_pic_id ^= 1  # consecutive IDRs must differ (§7.4.3)
        idr = self._idr_pic_id ^ 1  # this frame's id (pre-toggle value)
        self.frames += 1
        prelude = _START4 + self._sps + _START4 + self._pps
        if self._native:
            # whole-AU assembly in C++ (start codes included): ONE copy
            from opencv_opencl_tpu_torch import native

            mb_h = -(-self.height // 16)
            slices = min(self.slices, mb_h)
            row_bounds = [round(i * mb_h / slices)
                          for i in range(slices + 1)]
            mb_w = -(-self.width // 16)
            heads = [_slice_head(idr, first_mb=row_bounds[i] * mb_w)
                     for i in range(slices)]
            return [native.pcm_encode_au(
                arr, self.width, self.height, prelude, heads, row_bounds,
                threads=self._threads, workspace=self._workspace)]
        if self.slices > 1:
            nals = encode_frame_pcm_slices(
                arr, self.width, self.height, idr,
                slices=self.slices, pool=self._pool)
        else:
            nals = [encode_frame_pcm(arr, self.width, self.height, idr)]
        return [prelude + b"".join(_START4 + n for n in nals)]

    def flush(self) -> list[bytes]:
        return []

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
