"""Pluggable frame->H.26x encoder boundary for the relay emit path.

The reference always encodes before transmit (``appsrc -> omxh264enc ->
rtph264pay -> udpsink``, ``OpenCVequalHist.cpp:308-332``).
Hosts differ in what encoder they offer, so the relay's
``--sink=rtp+h264://`` goes through this seam:

- ``pcm``    — the in-repo lossless I_PCM encoder (io.h264_pcm, C++
  fast path): always available, standards-compliant, big output.
- ``cavlc``  — the in-repo COMPRESSED intra encoder (io.h264_cavlc,
  I_16x16 + CAVLC, C++ fast path): always available AND honors
  ``--bitrate`` via closed-loop QP adaptation; ``cavlc:qp=N`` fixes the
  quantizer, ``:slices=M`` splits frames into M independent slice bands
  (threaded on multi-core hosts, like the reference's num-slices=8).
- ``tpu``    — the CAVLC encoder with its arithmetic on the card
  (io.h264_cavlc.CudaCavlcEncoder, the JAX package's ``TpuCavlcEncoder``:
  prediction, transforms and quantization in one kernel launch a frame,
  entropy coding on every host thread); ``:i4``, ``:chromah``,
  ``:overlap``, ``:deblock``, ``:cpb=``, ``:initdelay=`` as in the JAX
  package.  ``:gop=N`` (N > 1) and ``:gdr=N`` build the GOP encoder with
  the reference pictures on the card (io.h264_inter.CudaGopEncoder, the
  JAX package's ``TpuGopEncoder``), with ``:search=R``, ``:halfpel``,
  ``:quarterpel``, ``:fastsub``, ``:refs=2`` and ``:parts`` (sub-16x16
  partitions) as there; ``:bitpack`` packs the CAVLC bits on the card too
  (both encoders).
- ``ffmpeg`` — an external ``ffmpeg`` process fed raw NV12 on stdin,
  Annex-B H.264/H.265 on stdout (x264-class compression when the host
  ships ffmpeg).
- ``gi``     — a GStreamer ``appsrc -> encoder -> h264parse -> appsink``
  pipeline over python-gi (the reference's own encoder elements — OMX on
  a board, x264enc elsewhere).
- ``auto``   — first of gi, ffmpeg, pcm that works on this host.

Every backend implements the same protocol::

    enc.encode(nv12_frame) -> list[annexb AU bytes]   # 0..n completed AUs
    enc.flush()            -> list[annexb AU bytes]   # drain at EOS
    enc.close()

Access units carry 4-byte start codes, ready for
:class:`opencv_opencl_tpu_torch.io.rtp_h26x.H26xRtpSink`.

The port's own copy of ``opencv_opencl_tpu/io/encoder.py``: the same
backends (``tpu``'s classes are ``CudaCavlcEncoder`` and ``CudaGopEncoder``,
where the JAX package names ``TpuCavlcEncoder`` and ``TpuGopEncoder``), and
``EncodedRtpSink.write_packed``, the entry of the fused enhance + encode
step (models/fused_encode.py).
"""

from __future__ import annotations

import shutil
import subprocess
import threading
from typing import Any, Protocol

import numpy as np

__all__ = ["FrameEncoder", "FfmpegEncoder", "EncodedRtpSink",
           "encoded_rtp_sink_from_url", "make_encoder",
           "available_encoders"]


class FrameEncoder(Protocol):
    codec: str

    def encode(self, nv12: np.ndarray) -> list[bytes]: ...

    def flush(self) -> list[bytes]: ...

    def close(self) -> None: ...


class FfmpegEncoder:
    """External ffmpeg process: NV12 frames in, Annex-B ES out.

    The stdout reader runs on a thread (ffmpeg buffers arbitrarily);
    ``encode`` returns whatever access units completed so far, ``flush``
    closes stdin and drains the rest.  AU boundaries come from the same
    first-slice heuristics as the ES replay app
    (apps/h26x_stream.split_access_units).
    """

    def __init__(self, width: int, height: int, fps: float = 30.0,
                 codec: str = "h264", bitrate_kbps: int = 2000,
                 ffmpeg: str = "ffmpeg") -> None:
        self.codec = codec
        self.width = width
        self.height = height
        venc = "libx264" if codec == "h264" else "libx265"
        fmt = "h264" if codec == "h264" else "hevc"
        args = [
            ffmpeg, "-hide_banner", "-loglevel", "error",
            "-f", "rawvideo", "-pix_fmt", "nv12",
            "-s", f"{width}x{height}", "-r", str(fps), "-i", "-",
            "-c:v", venc, "-b:v", f"{bitrate_kbps}k",
            "-tune", "zerolatency", "-f", fmt, "-",
        ]
        self._proc = subprocess.Popen(
            args, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        self._buf = bytearray()
        self._lock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True, name="ffmpeg-out")
        self._reader.start()
        self.frames = 0

    def _read_loop(self) -> None:
        while True:
            chunk = self._proc.stdout.read(65536)
            if not chunk:
                return
            with self._lock:
                self._buf.extend(chunk)

    @staticmethod
    def _nal_cut_offsets(data: bytes) -> list[int]:
        """Start offsets (INCLUDING the start code) of every non-empty
        NAL in ``data``, mirroring ``split_annexb`` exactly — a bare
        trailing start code or an empty NAL (adjacent codes) is not a
        NAL there and must not be counted here, or the tail cut lands
        one NAL too far and deletes the kept AU's first NAL from the
        buffer.  Needed because split_access_units NORMALIZES start
        codes to 4 bytes, so length arithmetic on the reassembled AU is
        wrong whenever the encoder emitted 3-byte codes (x264's usual
        non-first-NAL form)."""
        offs = []
        i = data.find(b"\x00\x00\x01")
        while i != -1:
            start = i + 3
            j = data.find(b"\x00\x00\x01", start)
            end = j if j != -1 else len(data)
            nal_end = end - 1 if (j != -1 and data[end - 1] == 0) else end
            if nal_end > start:  # non-empty, mirrors split_annexb
                offs.append(i - 1 if (i > 0 and data[i - 1] == 0) else i)
            i = j
        return offs

    def _take_complete_aus(self, final: bool) -> list[bytes]:
        from opencv_opencl_tpu_torch.io.rtp_h26x import (
            split_access_units, split_annexb)

        with self._lock:
            data = bytes(self._buf)
        if not data:
            return []
        aus = split_access_units(data, self.codec)
        if not aus:
            return []
        if not final:
            # the last AU may still be growing: keep it buffered
            keep = aus.pop()
            n_keep = len(split_annexb(keep))
            offs = self._nal_cut_offsets(data)
            if n_keep > len(offs):
                # inconsistent snapshot: consume nothing, emit nothing
                # (emitting without consuming would duplicate AUs later)
                return []
            consumed = offs[-n_keep]
        else:
            consumed = len(data)
        with self._lock:
            del self._buf[:consumed]
        return aus

    def encode(self, nv12: np.ndarray) -> list[bytes]:
        arr = np.asarray(nv12, np.uint8)
        self._proc.stdin.write(arr.tobytes())
        self.frames += 1
        return self._take_complete_aus(final=False)

    def flush(self) -> list[bytes]:
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        try:
            self._proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            # a wedged ffmpeg must not turn shutdown into a traceback:
            # kill it and return whatever completed AUs we did get
            self._proc.kill()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self._reader.join(timeout=10)
        return self._take_complete_aus(final=True)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait(timeout=10)


def _gi_encoder(width: int, height: int, fps: float, codec: str,
                bitrate_kbps: int):
    """GStreamer appsrc->x264enc/omx->appsink encoder (gi hosts only)."""
    from opencv_opencl_tpu_torch.io.gst_encoder import GiPipelineEncoder

    return GiPipelineEncoder(width, height, fps=fps, codec=codec,
                             bitrate_kbps=bitrate_kbps)


def available_encoders() -> list[str]:
    """Backend names usable on this host, in auto-selection order."""
    out = []
    from opencv_opencl_tpu_torch.io.gst_adapter import gi_available

    if gi_available():
        out.append("gi")
    if shutil.which("ffmpeg"):
        out.append("ffmpeg")
    out.append("pcm")
    return out


class EncodedRtpSink:
    """NV12-frame sink = pluggable encoder + H26x RTP payloader.

    Gives the relay the reference's full emit chain (encode -> payload ->
    UDP, ``OpenCVequalHist.cpp:308-332``) behind the io.videofile sink
    shape: ``write(frame)`` encodes and ships every completed access
    unit; ``close()`` flushes the encoder tail first.
    """

    def __init__(self, encoder: Any, host: str, port: int,
                 fps: float = 30.0, mtu: int = 1200,
                 rtcp_schedule: str = "tick",
                 au_tap=None) -> None:
        from opencv_opencl_tpu_torch.io.rtp_h26x import H26xRtpSink

        self.encoder = encoder
        self.rtp = H26xRtpSink(host, port, codec=encoder.codec, fps=fps,
                               mtu=mtu, rtcp_schedule=rtcp_schedule)
        self.aus_sent = 0
        # tee: an optional callable receiving every shipped AU (the
        # reference tees ONE encode into udpsink + mp4mux; apps pass a
        # collector here and mux at close — io/mp4.py)
        self.au_tap = au_tap

    def _ship(self, au: bytes) -> None:
        self.rtp.write(au)
        self.aus_sent += 1
        if self.au_tap is not None:
            self.au_tap(au)

    def write(self, nv12: np.ndarray) -> None:
        for au in self.encoder.encode(nv12):
            self._ship(au)

    def write_packed(self, packed: np.ndarray) -> int:
        """Ship the access unit of one fused-step packed level tensor
        (models/fused_encode.py; the ``tpu`` encoders only).  Returns the
        AU bytes shipped, for the caller's byte counters."""
        total = 0
        for au in self.encoder.encode_from_packed(packed):
            self._ship(au)
            total += len(au)
        return total

    @property
    def rtcp(self):
        return self.rtp.rtcp

    @property
    def rtt_ms(self):
        return self.rtp.rtt_ms

    def close(self) -> None:
        try:
            for au in self.encoder.flush():
                self._ship(au)
        finally:
            self.encoder.close()
            self.rtp.close()


def encoded_rtp_sink_from_url(url: str, width: int, height: int, *,
                              fps: float = 30.0, bitrate_kbps: int = 2000,
                              backend: str = "auto",
                              rtcp_schedule: str = "tick",
                              port_offset: int = 0,
                              device=None) -> EncodedRtpSink:
    """Parse ``rtp+h264://host:port`` / ``rtp+h265://...`` and build the
    full encoded emit chain — the ONE construction every app shares
    (relay, multi_relay, clahe_video), so validation and option
    forwarding cannot drift between them.  Raises ValueError with a
    user-facing message on a bad scheme/schedule/backend.  ``device`` goes
    to :func:`make_encoder`."""
    if rtcp_schedule not in ("tick", "rfc3550"):
        raise ValueError(
            f"rtcp-schedule={rtcp_schedule!r} invalid: tick|rfc3550")
    for scheme, codec in (("rtp+h264://", "h264"), ("rtp+h265://", "h265")):
        if url.startswith(scheme):
            break
    else:
        raise ValueError(f"not an encoded RTP url: {url!r}")
    hostport = url.split("://", 1)[1]
    try:
        host, port_s = hostport.rsplit(":", 1)
        port = int(port_s)
    except ValueError:
        raise ValueError(f"bad host:port in {url!r}")
    enc = make_encoder(backend, width, height, fps=fps, codec=codec,
                       bitrate_kbps=bitrate_kbps, device=device)
    return EncodedRtpSink(enc, host, port + port_offset, fps=fps,
                          rtcp_schedule=rtcp_schedule)


def make_encoder(backend: str, width: int, height: int, fps: float = 30.0,
                 codec: str = "h264", bitrate_kbps: int = 2000, *,
                 device=None) -> Any:
    """Build a FrameEncoder; ``backend`` is
    pcm[:slices]|cavlc[:qp=N][:slices=M][:gop=N]|tpu[:qp=N][:i4]...|ffmpeg|gi|auto.

    ``device`` is where the ``tpu`` encoder runs (default: the card; "cpu"
    runs its kernel's plain version); the other backends do not read it.

    ``auto`` tries each available backend IN ORDER and falls through on
    construction failure (e.g. python-gi present but the encoder element
    missing — gst-plugins absent), so it really is "the first that
    WORKS on this host", not the first that imports."""
    if backend == "auto":
        candidates = [b for b in available_encoders()
                      if not (b == "pcm" and codec != "h264")]
        errors = []
        for cand in candidates:
            try:
                return make_encoder(cand, width, height, fps=fps,
                                    codec=codec, bitrate_kbps=bitrate_kbps,
                                    device=device)
            except Exception as e:  # element missing, process spawn, ...
                errors.append(f"{cand}: {e}")
        raise ValueError(
            f"no working {codec} encoder on this host "
            f"(tried {', '.join(errors) or 'nothing'})")
    if backend == "pcm" or backend.startswith("pcm:"):
        if codec != "h264":
            raise ValueError("the in-repo PCM encoder is h264-only")
        from opencv_opencl_tpu_torch.io.h264_pcm import PcmH264Encoder

        slices = 1
        if backend.startswith("pcm:"):
            # pcm:N = N slices per frame, assembled on a thread pool
            # (the reference's omxh264enc num-slices=8 analogue)
            try:
                slices = int(backend.split(":", 1)[1])
            except ValueError:
                raise ValueError(f"bad pcm slice count in {backend!r}")
            if slices < 1:
                raise ValueError(
                    f"pcm slice count must be >= 1, got {slices}")
        import os

        threads = min(slices, os.cpu_count() or 1) if slices > 1 else 0
        return PcmH264Encoder(width, height, slices=slices,
                              threads=threads)
    if backend == "cavlc" or backend.startswith("cavlc:"):
        # the in-repo COMPRESSED encoder (io.h264_cavlc): the only
        # always-available backend that honors --bitrate like the
        # reference's omxh264enc target-bitrate.  `cavlc` = closed-loop
        # rate control at bitrate_kbps; `cavlc:qp=N` = fixed quantizer.
        if codec != "h264":
            raise ValueError("the in-repo CAVLC encoder is h264-only")
        from opencv_opencl_tpu_torch.io.h264_cavlc import CavlcH264Encoder

        qp = None
        slices = 1
        gop = None
        gdr = 0
        search = 0
        refs = 1
        halfpel = False
        quarterpel = False
        fastsub = False
        parts = False
        deblock = False
        i4 = False
        chromah = False
        cpb_ms = None
        initdelay_ms = None
        for opt in backend.split(":")[1:]:
            key, _, val = opt.partition("=")
            if key == "halfpel" and not val:
                halfpel = True
                continue
            if key == "quarterpel" and not val:
                quarterpel = True
                continue
            if key == "fastsub" and not val:
                fastsub = True
                continue
            if key == "parts" and not val:
                parts = True
                continue
            if key == "deblock" and not val:
                deblock = True
                continue
            if key == "i4" and not val:
                i4 = True
                continue
            if key == "chromah" and not val:
                chromah = True
                continue
            if (key not in ("qp", "slices", "gop", "search", "refs",
                            "gdr", "cpb", "initdelay")
                    or not val):
                raise ValueError(
                    f"bad cavlc option {opt!r} "
                    "(qp=N, slices=N, gop=N, gdr=N, search=N, refs=N, "
                    "cpb=MS, initdelay=MS, halfpel, quarterpel, "
                    "fastsub, parts, deblock, i4, chromah)")
            try:
                ival = int(val)
            except ValueError:
                raise ValueError(f"bad cavlc {key} in {backend!r}")
            if key == "qp":
                if not 0 <= ival <= 51:
                    raise ValueError(f"cavlc qp must be 0..51, got {ival}")
                qp = ival
            elif key == "gop":
                if ival < 1:
                    raise ValueError(f"cavlc gop must be >= 1, got {ival}")
                gop = ival
            elif key == "gdr":
                if ival < 1:
                    raise ValueError(f"cavlc gdr must be >= 1, got {ival}")
                gdr = ival
            elif key == "cpb":
                cpb_ms = ival   # validated by HrdParams
            elif key == "initdelay":
                initdelay_ms = ival
            elif key == "search":
                search = ival  # validated by the encoder: int in [1, 15]
            elif key == "refs":
                refs = ival    # validated by the encoder: [1, 4]
            else:
                if ival < 1:
                    raise ValueError(
                        f"cavlc slices must be >= 1, got {ival}")
                slices = ival
        import os

        if gdr:
            # GDR horizontal intra refresh (gdr-mode=horizontal): a
            # gop-less stream — one IDR, then a marching intra band
            # every `gdr` frames with recovery point SEIs
            from opencv_opencl_tpu_torch.io.h264_inter import GopCavlcEncoder

            if gop is not None:
                raise ValueError(
                    "cavlc gdr=N replaces gop=N (GDR streams have no "
                    "periodic IDR) — give one or the other")
            mb_h = -(-height // 16)
            kw = dict(slices=mb_h, search=search, halfpel=halfpel,
                      quarterpel=quarterpel, fastsub=fastsub, refs=refs,
                      parts=parts, deblock=deblock, cpb_ms=cpb_ms,
                      initial_delay_ms=initdelay_ms, i4=i4, chromah=chromah)
            if qp is not None:
                return GopCavlcEncoder(width, height, qp=qp, gdr=gdr,
                                       **kw)
            return GopCavlcEncoder(width, height, qp=30, gdr=gdr,
                                   bitrate_kbps=bitrate_kbps, fps=fps,
                                   **kw)
        if gop is not None and gop > 1:
            # low-delay-P GOP stream (the reference's gop-mode=low-delay-p
            # periodicity-idr analogue): IDR every `gop` frames,
            # zero-motion P pictures in between (io.h264_inter)
            from opencv_opencl_tpu_torch.io.h264_inter import GopCavlcEncoder

            if parts and slices == 1:
                # partitions need the one-row-slice predictor collapse
                # (the TPU contract); default there like gdr does
                slices = -(-height // 16)
            kw = dict(slices=slices, search=search, halfpel=halfpel,
                      quarterpel=quarterpel, fastsub=fastsub, refs=refs,
                      parts=parts, deblock=deblock, cpb_ms=cpb_ms,
                      initial_delay_ms=initdelay_ms, i4=i4, chromah=chromah)
            if qp is not None:
                return GopCavlcEncoder(width, height, qp=qp, gop=gop,
                                       **kw)
            return GopCavlcEncoder(width, height, qp=30, gop=gop,
                                   bitrate_kbps=bitrate_kbps, fps=fps,
                                   **kw)
        if (search or halfpel or quarterpel or fastsub or parts
                or refs > 1):
            raise ValueError(
                "cavlc search=N/halfpel/quarterpel/fastsub/parts need "
                "a gop=N option (motion search is a P-frame feature)")
        threads = min(slices, os.cpu_count() or 1) if slices > 1 else 0
        kw = dict(slices=slices, threads=threads, deblock=deblock,
                  cpb_ms=cpb_ms, initial_delay_ms=initdelay_ms, i4=i4, chromah=chromah)
        if qp is not None:
            # fixed quantizer: no rate control
            return CavlcH264Encoder(width, height, qp=qp, **kw)
        return CavlcH264Encoder(width, height, qp=30,
                                bitrate_kbps=bitrate_kbps, fps=fps,
                                **kw)
    if backend == "tpu" or backend.startswith("tpu:"):
        # the CAVLC encoder with its arithmetic on the card (one launch of
        # the intra level kernel a frame, ops/h264_levels.py); the host
        # does entropy coding only.  Streams are byte-identical to
        # cavlc:slices=<mb rows>.  gop=N > 1 and gdr=N build the GOP
        # encoder (io/h264_inter.CudaGopEncoder: the P-frame kernels,
        # the reference pictures on the card); bitpack packs the bits on
        # the card too (ops/h264_bitpack.py).
        if codec != "h264":
            raise ValueError("the TPU CAVLC encoder is h264-only")
        from opencv_opencl_tpu_torch.io.h264_cavlc import CudaCavlcEncoder

        qp = None
        gop = None
        gdr = 0
        overlap = False
        search = 0
        refs = 1
        halfpel = False
        quarterpel = False
        fastsub = False
        parts = False
        bitpack = False
        deblock = False
        i4 = False
        chromah = False
        cpb_ms = None
        initdelay_ms = None
        for opt in backend.split(":")[1:]:
            key, _, val = opt.partition("=")
            if key == "overlap" and not val:
                overlap = True
                continue
            if key in ("cpb", "initdelay") and val:
                try:
                    ms = int(val)
                except ValueError:
                    raise ValueError(f"bad tpu {key} in {backend!r}")
                if key == "cpb":
                    cpb_ms = ms
                else:
                    initdelay_ms = ms
                continue
            if key == "halfpel" and not val:
                halfpel = True
                continue
            if key == "quarterpel" and not val:
                quarterpel = True
                continue
            if key == "fastsub" and not val:
                fastsub = True
                continue
            if key == "bitpack" and not val:
                bitpack = True
                continue
            if key == "parts" and not val:
                parts = True
                continue
            if key == "deblock" and not val:
                deblock = True
                continue
            if key == "i4" and not val:
                i4 = True
                continue
            if key == "chromah" and not val:
                chromah = True
                continue
            if key == "gop" and val:
                try:
                    gop = int(val)
                except ValueError:
                    raise ValueError(f"bad tpu gop in {backend!r}")
                if gop < 1:
                    raise ValueError(f"tpu gop must be >= 1, got {gop}")
                continue
            if key == "gdr" and val:
                try:
                    gdr = int(val)
                except ValueError:
                    raise ValueError(f"bad tpu gdr in {backend!r}")
                if gdr < 1:
                    raise ValueError(f"tpu gdr must be >= 1, got {gdr}")
                continue
            if key == "search" and val:
                try:
                    search = int(val)
                except ValueError:
                    raise ValueError(f"bad tpu search in {backend!r}")
                continue
            if key == "refs" and val:
                try:
                    refs = int(val)
                except ValueError:
                    raise ValueError(f"bad tpu refs in {backend!r}")
                continue
            if key != "qp" or not val:
                raise ValueError(
                    f"bad tpu option {opt!r} (qp=N|gop=N|gdr=N|"
                    "search=N|refs=N|cpb=MS|initdelay=MS|halfpel|"
                    "quarterpel|fastsub|parts|deblock|bitpack|"
                    "overlap|i4|chromah)")
            try:
                qp = int(val)
            except ValueError:
                raise ValueError(f"bad tpu qp in {backend!r}")
            if not 0 <= qp <= 51:
                raise ValueError(f"tpu qp must be 0..51, got {qp}")
        if gdr or (gop is not None and gop > 1):
            # the GOP stream with the reference pictures on the card
            from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder

            if gdr and gop is not None:
                raise ValueError(
                    "tpu gdr=N replaces gop=N (GDR streams have no "
                    "periodic IDR) — give one or the other")
            kw = dict(overlap=overlap, search=search, halfpel=halfpel,
                      quarterpel=quarterpel, fastsub=fastsub,
                      refs=refs, parts=parts, bitpack=bitpack,
                      deblock=deblock, cpb_ms=cpb_ms,
                      initial_delay_ms=initdelay_ms, i4=i4, chromah=chromah,
                      device=device)
            if gdr:
                kw["gdr"] = gdr
            else:
                kw["gop"] = gop
            if qp is not None:
                return CudaGopEncoder(width, height, qp=qp, **kw)
            return CudaGopEncoder(width, height, qp=30,
                                  bitrate_kbps=bitrate_kbps, fps=fps, **kw)
        if (search or halfpel or quarterpel or fastsub or parts
                or refs > 1):
            raise ValueError(
                "tpu search=N/halfpel/quarterpel/fastsub/parts need a "
                "gop=N option (motion search is a P-frame feature)")
        kw = dict(overlap=overlap, deblock=deblock, bitpack=bitpack,
                  cpb_ms=cpb_ms, initial_delay_ms=initdelay_ms, i4=i4,
                  chromah=chromah, device=device)
        if qp is not None:
            return CudaCavlcEncoder(width, height, qp=qp, **kw)
        return CudaCavlcEncoder(width, height, qp=30,
                                bitrate_kbps=bitrate_kbps, fps=fps, **kw)
    if backend == "ffmpeg":
        if not shutil.which("ffmpeg"):
            raise ValueError("ffmpeg not on PATH (try --encoder=pcm)")
        return FfmpegEncoder(width, height, fps=fps, codec=codec,
                             bitrate_kbps=bitrate_kbps)
    if backend == "gi":
        return _gi_encoder(width, height, fps, codec, bitrate_kbps)
    raise ValueError(
        f"unknown encoder backend {backend!r} (pcm[:slices]|"
        "cavlc[:qp=N][:slices=M][:gop=N]|tpu[:qp=N][:gop=N][:overlap]|ffmpeg|gi|auto)")
