"""Native C++ runtime bindings (ctypes), built on first use.

The port's copy of ``opencv_opencl_tpu/native``: the same C++ source
(``framepipe.cpp``: the staging ring, the resequencer, the NV12 helpers,
the sendmmsg RTP senders and the H.264 byte and entropy coders) and the
same Python API.  The frame-transport hot path runs in C++ with the GIL
released (ctypes releases it around every foreign call).  Without a C++
toolchain ``available()`` is False, ``build_error()`` says why, and the
callers take their Python versions (``runtime/queues.py``, the Python
packetizer of ``io/rtp.py``).  The encoders' docstrings name the JAX
package's Python oracles (``opencv_opencl_tpu/io/h264_*.py``), whose
encoders the port does not have yet; ``tests/test_torch_native.py`` holds
this library byte-equal to the JAX package's on every function.

How it builds: ``g++ -O3 -march=native`` (again without ``-march=native``
where the compiler refuses it), into the package's git-ignored
``_build/``, under a name that hashes the source and the flags, with the
CPU target that ``-march=native`` selects on this host: an edited source
gets a new library, an unchanged one is reused, and a library built for
another CPU (a ``_build/`` copied between machines) is not loaded.  The library is
written under a temporary name and renamed, so processes that build at
once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from opencv_opencl_tpu_torch.native.slice_heads import (
    BitWriter,
    packed,
    slice_head_cavlc,
    slice_head_p,
)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "framepipe.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
# the flags of the second try, where the compiler refuses -march=native
PORTABLE_FLAGS = tuple(f for f in FLAGS if f != "-march=native")

_lib = None
_lib_path: str | None = None
_target: str | None = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def _native_target() -> str:
    """The target options ``-march=native`` selects on this host, as g++
    prints them ("" without g++)."""
    global _target
    if _target is None:
        try:
            _target = subprocess.run(
                ["g++", "-march=native", "-Q", "--help=target"],
                capture_output=True, text=True, timeout=60).stdout
        except (OSError, subprocess.SubprocessError):
            _target = ""
    return _target


def library_path(flags: tuple[str, ...] = FLAGS) -> str:
    """Where the library of the current source built with ``flags`` (and,
    with ``-march=native``, for this host's CPU) lives."""
    digest = hashlib.sha256(" ".join(flags).encode())
    if "-march=native" in flags:
        digest.update(_native_target().encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"libframepipe_{digest.hexdigest()[:16]}.so")


def _compile(flags: tuple[str, ...], out: str) -> str | None:
    """Build ``out`` with ``flags``; returns g++'s complaint or None."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        res = subprocess.run(["g++", *flags, _SRC, "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return res.stderr[:2000] or f"g++ exited with {res.returncode}"
        os.replace(tmp, out)
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build() -> tuple[str | None, str | None]:
    """(path of a built library, None), or (None, the error)."""
    err = None
    for flags in (FLAGS, PORTABLE_FLAGS):
        path = library_path(flags)
        if os.path.exists(path):
            return path, None
        try:
            err = _compile(flags, path)
        except (OSError, subprocess.SubprocessError) as e:
            err = str(e)
        if err is None:
            return path, None
    return None, err


def _load():
    global _lib, _lib_path, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path, err = _build()
        if err is not None:
            _build_error = err
            return None
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fp_ring_new.restype = ctypes.c_void_p
        lib.fp_ring_new.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.fp_ring_free.argtypes = [ctypes.c_void_p]
        lib.fp_ring_push.restype = ctypes.c_int
        lib.fp_ring_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
        lib.fp_ring_push_prio.restype = ctypes.c_int
        lib.fp_ring_push_prio.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_uint64, ctypes.c_int32, u64p,
        ]
        lib.fp_ring_pop_batch.restype = ctypes.c_int64
        lib.fp_ring_pop_batch.argtypes = [
            ctypes.c_void_p, u8p, u64p, ctypes.c_size_t, ctypes.c_int64,
        ]
        lib.fp_ring_len.restype = ctypes.c_int64
        lib.fp_ring_len.argtypes = [ctypes.c_void_p]
        lib.fp_ring_dropped.restype = ctypes.c_uint64
        lib.fp_ring_dropped.argtypes = [ctypes.c_void_p]
        lib.fp_ring_close.argtypes = [ctypes.c_void_p]
        lib.fp_reseq_new.restype = ctypes.c_void_p
        lib.fp_reseq_new.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.fp_reseq_free.argtypes = [ctypes.c_void_p]
        lib.fp_reseq_push.restype = ctypes.c_int64
        lib.fp_reseq_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u8p]
        lib.fp_reseq_emit.restype = ctypes.c_int64
        lib.fp_reseq_emit.argtypes = [ctypes.c_void_p, u8p]
        lib.fp_reseq_dropped_late.restype = ctypes.c_uint64
        lib.fp_reseq_dropped_late.argtypes = [ctypes.c_void_p]
        lib.fp_reseq_frames_lost.restype = ctypes.c_uint64
        lib.fp_reseq_frames_lost.argtypes = [ctypes.c_void_p]
        lib.fp_reseq_pending.restype = ctypes.c_int64
        lib.fp_reseq_pending.argtypes = [ctypes.c_void_p]
        for name in ("fp_uv_interleave", "fp_uv_deinterleave"):
            getattr(lib, name).argtypes = [u8p, u8p, u8p, ctypes.c_size_t,
                                           ctypes.c_size_t]
        lib.fp_uv_gray.argtypes = [u8p, ctypes.c_size_t]
        lib.fp_send_packets.restype = ctypes.c_int64
        lib.fp_send_packets.argtypes = [
            ctypes.c_int, u8p, u64p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint16,
        ]
        lib.fp_rtp_send_raw.restype = ctypes.c_int64
        lib.fp_rtp_send_raw.argtypes = [
            ctypes.c_int, u8p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint8, ctypes.c_char_p,
            ctypes.c_uint16,
        ]
        lib.fp_pcm_encode.restype = ctypes.c_int64
        lib.fp_pcm_encode.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, u64p, u64p,
            ctypes.c_uint64, ctypes.c_int, u8p, ctypes.c_uint64, u64p,
        ]
        lib.fp_pcm_encode_au.restype = ctypes.c_int64
        lib.fp_pcm_encode_au.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, ctypes.c_uint64,
            u8p, u64p, u64p, ctypes.c_uint64, ctypes.c_int, u8p,
            ctypes.c_uint64,
        ]
        lib.fp_cavlc_encode.restype = ctypes.c_int64
        lib.fp_cavlc_encode.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, u8p,
            ctypes.c_uint64, u8p, ctypes.c_uint64, u8p, ctypes.c_uint64,
        ]
        lib.fp_cavlc_encode_slices.restype = ctypes.c_int64
        lib.fp_cavlc_encode_slices.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, u8p,
            u64p, u64p, ctypes.c_uint64, ctypes.c_int, u8p,
            ctypes.c_uint64, u8p, u64p,
        ]
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.fp_cavlc_entropy_rows.restype = ctypes.c_int64
        lib.fp_cavlc_entropy_rows.argtypes = [
            i16p,
            i16p, i16p, i16p, i16p, ctypes.c_uint64, ctypes.c_uint64,
            u8p, u64p, ctypes.c_int, u8p, ctypes.c_uint64, u8p, u64p,
            i16p, i16p,
        ]
        lib.fp_cavlc_entropy_rows_p.restype = ctypes.c_int64
        lib.fp_cavlc_entropy_rows_p.argtypes = [
            i16p, i16p, i16p, i16p, i16p, i16p, i16p, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint64, u8p, u64p, ctypes.c_int,
            u8p, ctypes.c_uint64, u8p, u64p, i16p, i16p, i16p,
        ]
        _lib, _lib_path = lib, path
        return _lib


def available() -> bool:
    return _load() is not None


def has_cavlc() -> bool:
    """True when the built library exports the CAVLC intra encoder."""
    lib = _load()
    return lib is not None and hasattr(lib, "fp_cavlc_encode")


def build_error() -> str | None:
    _load()
    return _build_error


def loaded_path() -> str | None:
    """The file of the loaded library (None before a successful load)."""
    _load()
    return _lib_path


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeRing:
    """Preallocated leaky staging ring (C++), frame granularity."""

    def __init__(self, capacity: int, frame_bytes: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self._lib = lib
        self.frame_bytes = frame_bytes
        self._h = lib.fp_ring_new(capacity, frame_bytes)

    def push(self, frame: np.ndarray, seq: int) -> bool:
        """Returns True if no drop occurred.  False means A frame was
        dropped — usually the oldest queued one, but on a ring shared
        with higher-priority push_prio frames (or when every slot is
        momentarily in flight) the INCOMING frame itself may be the one
        dropped; use push_prio for attributable semantics."""
        frame = np.ascontiguousarray(frame)
        assert frame.nbytes == self.frame_bytes
        r = self._lib.fp_ring_push(self._h, _ptr(frame), seq)
        if r < 0:
            raise RuntimeError("ring closed")
        return r == 0

    def push_prio(self, frame: np.ndarray, seq: int,
                  prio: int) -> tuple[str, int | None]:
        """Priority-aware push (QoS serving keeps the GIL-free path).

        Returns ``(status, evicted_seq)`` with status one of:
        ``"ok"`` (queued, no drop), ``"evicted"`` (queued; the oldest
        lowest-priority frame — seq returned — was dropped), or
        ``"rejected"`` (this frame ranks below everything queued and was
        dropped itself).  Raises when the ring is closed."""
        frame = np.ascontiguousarray(frame)
        assert frame.nbytes == self.frame_bytes
        evicted = ctypes.c_uint64(0)
        r = self._lib.fp_ring_push_prio(
            self._h, _ptr(frame), seq, prio, ctypes.byref(evicted))
        if r < 0:
            raise RuntimeError("ring closed")
        if r == 1:
            return "evicted", int(evicted.value)
        return ("rejected", None) if r == 2 else ("ok", None)

    def pop_batch(self, batch_out: np.ndarray, max_frames: int,
                  timeout_ms: int = 50):
        """Fill batch_out's first rows; returns (n, seqs) — n==-1 => closed."""
        seqs = np.zeros(max_frames, dtype=np.uint64)
        n = self._lib.fp_ring_pop_batch(
            self._h, _ptr(batch_out),
            seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            max_frames, timeout_ms,
        )
        return int(n), seqs[: max(int(n), 0)]

    def __len__(self) -> int:
        return int(self._lib.fp_ring_len(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.fp_ring_dropped(self._h))

    def close(self) -> None:
        self._lib.fp_ring_close(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fp_ring_free(self._h)
            self._h = None


class NativeResequencer:
    """C++ ordered-map resequencer (the `improvement` ELF ProcessedFrame map)."""

    def __init__(self, max_pending: int, frame_bytes: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self._lib = lib
        self.frame_bytes = frame_bytes
        self._h = lib.fp_reseq_new(max_pending, frame_bytes)

    def push(self, seq: int, frame: np.ndarray) -> int:
        """Returns how many frames are now emittable in order."""
        frame = np.ascontiguousarray(frame)
        assert frame.nbytes == self.frame_bytes
        return int(self._lib.fp_reseq_push(self._h, seq, _ptr(frame)))

    def emit(self, out: np.ndarray) -> int:
        """Pop next in-order frame into out; returns seq or -1."""
        return int(self._lib.fp_reseq_emit(self._h, _ptr(out)))

    @property
    def dropped_late(self) -> int:
        return int(self._lib.fp_reseq_dropped_late(self._h))

    @property
    def frames_lost(self) -> int:
        return int(self._lib.fp_reseq_frames_lost(self._h))

    @property
    def pending(self) -> int:
        return int(self._lib.fp_reseq_pending(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fp_reseq_free(self._h)
            self._h = None


def uv_interleave(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    lib = _load()
    half_h, half_w = u.shape
    out = np.empty((half_h, 2 * half_w), dtype=np.uint8)
    lib.fp_uv_interleave(_ptr(np.ascontiguousarray(u)),
                         _ptr(np.ascontiguousarray(v)),
                         _ptr(out), half_h, half_w)
    return out


def uv_deinterleave(uv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    half_h, w = uv.shape
    half_w = w // 2
    u = np.empty((half_h, half_w), dtype=np.uint8)
    v = np.empty((half_h, half_w), dtype=np.uint8)
    lib.fp_uv_deinterleave(_ptr(np.ascontiguousarray(uv)), _ptr(u), _ptr(v),
                           half_h, half_w)
    return u, v


def uv_gray(uv: np.ndarray) -> None:
    """In-place UV := 128 (the reference memset)."""
    lib = _load()
    lib.fp_uv_gray(_ptr(uv), uv.nbytes)


def send_packets(fd: int, packets: list[bytes], host: str,
                 port: int) -> int:
    """Ship pre-built datagrams via C++ sendmmsg batches, GIL-free.

    One ``b"".join`` + a few syscalls replaces the per-packet Python
    ``sendto`` loop (~33 ms for a 10k-packet 4K access unit).  Returns
    packets sent; raises OSError with ``packets_sent`` on failure, like
    :func:`rtp_send_raw`."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    blob = b"".join(packets)
    lens = np.array([len(p) for p in packets], dtype=np.uint64)
    n = lib.fp_send_packets(
        fd, ctypes.cast(ctypes.c_char_p(blob),
                        ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(packets), host.encode(), port,
    )
    if n < 0:
        err = OSError("fp_send_packets failed")
        err.packets_sent = int(-n - 1)
        raise err
    return int(n)


def pcm_encode_slices(nv12: np.ndarray, width: int, height: int,
                      heads: list[bytes], row_bounds: list[int],
                      threads: int = 0, workspace: dict | None = None,
                      copy: bool = True) -> list:
    """Native H.264 I_PCM slice assembly (fill + escape) in C++, GIL-free.

    ``heads`` are the pre-built slice-header bytes (one per slice, from
    ``io.h264_pcm._slice_head``) and ``row_bounds`` the MB-row band
    boundaries — the bitstream layout stays owned by the tested Python
    bit writer; C++ owns only the hot byte work.  Output is byte-identical
    to ``io.h264_pcm.encode_frame_pcm_slices`` (diffed in
    tests/test_native_pcm.py).

    ``workspace`` (a dict the caller keeps across frames) reuses the
    output arena — a fresh multi-MB ``np.empty`` per 4K frame costs real
    milliseconds in page faults.  ``copy=False`` returns memoryviews INTO
    that arena (valid until the next call with the same workspace): the
    caller's ``b"".join`` is then the only copy on the way to the wire."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    nv12 = np.ascontiguousarray(nv12)
    nslices = len(heads)
    assert nslices >= 1 and len(row_bounds) == nslices + 1
    mb_w = -(-width // 16)
    head_lens = np.array([len(h) for h in heads], dtype=np.uint64)
    bounds = np.asarray(row_bounds, dtype=np.uint64)
    heads_blob = np.frombuffer(b"".join(heads), dtype=np.uint8)
    bands = (bounds[1:].astype(np.int64) - bounds[:-1].astype(np.int64))
    raws = head_lens.astype(np.int64) - 2 + bands * mb_w * 386 + 1
    stride = int((int(raws.max()) + 1) // 2 * 3)
    need = nslices * stride
    if (workspace is not None and workspace.get("size", -1) >= need
            and len(workspace["lens"]) >= nslices):
        out = workspace["out"]
        out_lens = workspace["lens"]
    else:
        out = np.empty(need, dtype=np.uint8)
        out_lens = np.zeros(max(nslices, 64), dtype=np.uint64)
        if workspace is not None:
            workspace.update(out=out, lens=out_lens, size=need)
    rc = lib.fp_pcm_encode(
        _ptr(nv12), width, height, _ptr(heads_blob),
        head_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        nslices, threads, _ptr(out), stride,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise RuntimeError("fp_pcm_encode failed (bad args or overflow)")
    mk = (lambda s: s.tobytes()) if copy else (lambda s: s.data)
    return [mk(out[i * stride : i * stride + int(out_lens[i])])
            for i in range(nslices)]


def pcm_encode_au(nv12: np.ndarray, width: int, height: int,
                  prelude: bytes, heads: list[bytes],
                  row_bounds: list[int], threads: int = 0,
                  workspace: dict | None = None) -> bytes:
    """One COMPLETE Annex-B access unit ([SPS+PPS prelude][SC slice]...)
    assembled in C++ — start codes included, so the only Python-side
    copy is the final ``bytes()`` of the arena (the three-copy
    ``sc + nal`` / join / prepend chain cost 5x the encode itself at
    4K).  Arguments as :func:`pcm_encode_slices` plus ``prelude``, the
    pre-escaped parameter-set block with start codes."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    nv12 = np.ascontiguousarray(nv12)
    nslices = len(heads)
    assert nslices >= 1 and len(row_bounds) == nslices + 1
    mb_w = -(-width // 16)
    head_lens = np.array([len(h) for h in heads], dtype=np.uint64)
    bounds = np.asarray(row_bounds, dtype=np.uint64)
    heads_blob = np.frombuffer(b"".join(heads), dtype=np.uint8)
    prelude_a = np.frombuffer(prelude, dtype=np.uint8)
    bands = (bounds[1:].astype(np.int64) - bounds[:-1].astype(np.int64))
    raws = head_lens.astype(np.int64) - 2 + bands * mb_w * 386 + 1
    need = len(prelude) + int(((raws + 1) // 2 * 3 + 4).sum())
    if workspace is not None and workspace.get("au_size", -1) >= need:
        out = workspace["au"]
    else:
        out = np.empty(need, dtype=np.uint8)
        if workspace is not None:
            workspace.update(au=out, au_size=need)
    n = lib.fp_pcm_encode_au(
        _ptr(nv12), width, height, _ptr(prelude_a), len(prelude),
        _ptr(heads_blob),
        head_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        nslices, threads, _ptr(out), out.nbytes,
    )
    if n < 0:
        raise RuntimeError("fp_pcm_encode_au failed (bad args or overflow)")
    return out[: int(n)].tobytes()


def cavlc_encode_frame(nv12: np.ndarray, width: int, height: int, qp: int,
                       idr_pic_id: int,
                       workspace: dict | None = None) -> bytes:
    """Native compressed intra H.264 encode (io.h264_cavlc's production
    path): one 16-aligned NV12 frame -> one escaped single-slice IDR NAL
    (no start code), byte-identical to
    ``io.h264_cavlc.encode_frame_cavlc`` (diffed in
    tests/test_cavlc_native.py).  The slice head is built by the tested
    Python bit writer and passed as packed BITS (the header is not
    byte-aligned; MB data continues bit-packed after it); C++ owns the
    transforms/quant/CAVLC/reconstruction hot loop.  ``workspace`` (a
    dict kept across frames) reuses the RBSP scratch + output arenas."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    w = BitWriter()
    slice_head_cavlc(w, idr_pic_id, qp)
    head, nbits = packed(w)
    nv12 = np.ascontiguousarray(nv12)
    mb = (width // 16) * (height // 16)
    # worst-case RBSP: ~2200 B/MB (dense max-level CAVLC exceeds raw
    # sample size by design; see the level-escape bound in the oracle)
    rbsp_cap = 2200 * mb + len(head) + 64
    out_cap = rbsp_cap // 2 * 3 + 16
    if workspace is not None and workspace.get("cavlc_cap", -1) >= rbsp_cap:
        scratch, out = workspace["cavlc_scratch"], workspace["cavlc_out"]
    else:
        scratch = np.empty(rbsp_cap, dtype=np.uint8)
        out = np.empty(out_cap, dtype=np.uint8)
        if workspace is not None:
            workspace.update(cavlc_scratch=scratch, cavlc_out=out,
                             cavlc_cap=rbsp_cap)
    n = lib.fp_cavlc_encode(_ptr(nv12), width, height, qp, _ptr(head),
                            nbits, _ptr(scratch), scratch.nbytes,
                            _ptr(out), out.nbytes)
    if n < 0:
        raise RuntimeError("fp_cavlc_encode failed (bad args or overflow)")
    return out[: int(n)].tobytes()


def cavlc_encode_slices(nv12: np.ndarray, width: int, height: int,
                        qp: int, idr_pic_id: int, slices: int = 1,
                        threads: int = 0,
                        workspace: dict | None = None,
                        deblock: bool = False) -> list[bytes]:
    """Native multi-slice CAVLC encode: ``slices`` independent MB-row
    bands, each an IDR slice NAL (no start codes), byte-identical per
    slice to ``io.h264_cavlc.encode_frame_cavlc_slices``.  ``threads``
    > 1 encodes bands in parallel (contexts reset per slice, so bands
    share nothing but disjoint rows of the reconstruction planes)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    nv12 = np.ascontiguousarray(nv12)
    mb_w, mb_h = width // 16, height // 16
    slices = max(1, min(int(slices), mb_h))
    bounds = [round(i * mb_h / slices) for i in range(slices + 1)]
    heads, nbits = [], []
    for i in range(slices):
        w = BitWriter()
        slice_head_cavlc(w, idr_pic_id, qp, first_mb=bounds[i] * mb_w,
                         deblock=deblock)
        head, n = packed(w)
        heads.append(head)
        nbits.append(n)
    blob = np.concatenate(heads)
    nbits_a = np.asarray(nbits, dtype=np.uint64)
    bounds_a = np.asarray(bounds, dtype=np.uint64)
    max_band = max(bounds[i + 1] - bounds[i] for i in range(slices))
    rbsp_cap = 2200 * max_band * mb_w + 32 + 64
    stride = (rbsp_cap // 2 * 3 + 16 + 63) // 64 * 64
    need = slices * stride
    if (workspace is not None
            and workspace.get("cavlc_sl_cap", -1) >= need
            and len(workspace["cavlc_sl_lens"]) >= slices):
        scratch = workspace["cavlc_sl_scratch"]
        out = workspace["cavlc_sl_out"]
        lens = workspace["cavlc_sl_lens"]
    else:
        scratch = np.empty(need, dtype=np.uint8)
        out = np.empty(need, dtype=np.uint8)
        lens = np.zeros(max(slices, 64), dtype=np.uint64)
        if workspace is not None:
            workspace.update(cavlc_sl_scratch=scratch, cavlc_sl_out=out,
                             cavlc_sl_lens=lens, cavlc_sl_cap=need)
    rc = lib.fp_cavlc_encode_slices(
        _ptr(nv12), width, height, qp, _ptr(blob),
        nbits_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bounds_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        slices, threads, _ptr(scratch), stride, _ptr(out),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if rc != 0:
        raise RuntimeError(
            "fp_cavlc_encode_slices failed (bad args or overflow)")
    return [out[i * stride : i * stride + int(lens[i])].tobytes()
            for i in range(slices)]


def cavlc_entropy_rows(zdc: np.ndarray, acz: np.ndarray,
                       czdc: np.ndarray, cacz: np.ndarray, qp: int,
                       idr_pic_id: int, threads: int = 0,
                       workspace: dict | None = None,
                       imode: np.ndarray | None = None,
                       deblock: bool = False,
                       i4modes: np.ndarray | None = None,
                       cmode: np.ndarray | None = None) -> list[bytes]:
    """Native entropy coding of precomputed quantized levels
    (ops/h264_levels.py LevelArrays) into one IDR slice NAL per MB row
    — the CPU stage of the device encode path.  ``imode`` is the per-MB
    intra pred mode plane (0 = I_4x4, 1 = HORIZONTAL, 2 = DC; None =
    all DC); ``i4modes`` the z-scan (mb_h, mb_w, 16) block-mode field
    used where imode == 0 (acz then carries FULL 16-coeff blocks);
    ``cmode`` the per-MB intra_chroma_pred_mode plane (0 DC, 1 HOR).
    Byte-identical to ``io.h264_cavlc.encode_frame_from_levels`` (the
    Python oracle, diffed in tests/test_h264_levels.py /
    test_h264_i4.py / test_h264_chromah.py)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    zdc = np.ascontiguousarray(zdc, dtype=np.int16)
    acz = np.ascontiguousarray(acz, dtype=np.int16)
    czdc = np.ascontiguousarray(czdc, dtype=np.int16)
    cacz = np.ascontiguousarray(cacz, dtype=np.int16)
    if imode is not None:
        imode = np.ascontiguousarray(imode, dtype=np.int16)
    if i4modes is not None:
        i4modes = np.ascontiguousarray(i4modes, dtype=np.int16)
    if cmode is not None:
        cmode = np.ascontiguousarray(cmode, dtype=np.int16)
    mb_h, mb_w = zdc.shape[:2]
    heads, nbits = [], []
    for i in range(mb_h):
        w = BitWriter()
        slice_head_cavlc(w, idr_pic_id, qp, first_mb=i * mb_w,
                         deblock=deblock)
        head, n = packed(w)
        heads.append(head)
        nbits.append(n)
    blob = np.concatenate(heads)
    nbits_a = np.asarray(nbits, dtype=np.uint64)
    rbsp_cap = 2200 * mb_w + 32 + 64
    stride = (rbsp_cap // 2 * 3 + 16 + 63) // 64 * 64
    need = mb_h * stride
    if (workspace is not None
            and workspace.get("cavlc_er_cap", -1) >= need
            and len(workspace["cavlc_er_lens"]) >= mb_h):
        scratch = workspace["cavlc_er_scratch"]
        out = workspace["cavlc_er_out"]
        lens = workspace["cavlc_er_lens"]
    else:
        scratch = np.empty(need, dtype=np.uint8)
        out = np.empty(need, dtype=np.uint8)
        lens = np.zeros(max(mb_h, 64), dtype=np.uint64)
        if workspace is not None:
            workspace.update(cavlc_er_scratch=scratch, cavlc_er_out=out,
                             cavlc_er_lens=lens, cavlc_er_cap=need)
    i16p = ctypes.POINTER(ctypes.c_int16)
    rc = lib.fp_cavlc_entropy_rows(
        zdc.ctypes.data_as(i16p), acz.ctypes.data_as(i16p),
        czdc.ctypes.data_as(i16p), cacz.ctypes.data_as(i16p),
        imode.ctypes.data_as(i16p) if imode is not None else None,
        mb_h, mb_w, _ptr(blob),
        nbits_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        threads, _ptr(scratch), stride, _ptr(out),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        i4modes.ctypes.data_as(i16p) if i4modes is not None else None,
        cmode.ctypes.data_as(i16p) if cmode is not None else None)
    if rc != 0:
        raise RuntimeError(
            "fp_cavlc_entropy_rows failed (bad args or overflow)")
    return [out[i * stride : i * stride + int(lens[i])].tobytes()
            for i in range(mb_h)]


def cavlc_entropy_rows_p(mode: np.ndarray, zdc: np.ndarray,
                         acz: np.ndarray, czdc: np.ndarray,
                         cacz: np.ndarray, qp: int, frame_num: int,
                         threads: int = 0,
                         workspace: dict | None = None,
                         mv: np.ndarray | None = None,
                         ref: np.ndarray | None = None,
                         active_refs: int = 1,
                         deblock: bool = False,
                         slice_local: bool = False,
                         pmode: np.ndarray | None = None,
                         mv4: np.ndarray | None = None,
                         ref4: np.ndarray | None = None) -> list[bytes]:
    """Native entropy coding of one P frame's chosen-mode levels
    (ops/h264_levels.py PLevelArrays) into one P slice NAL per MB row —
    the CPU stage of the device GOP path.  ``mv`` is the (mb_h, mb_w, 2)
    (dy, dx) QUARTER-pel field from the device motion search (None =
    zero motion); ``ref``/``active_refs`` the multi-reference
    configuration (te(v)-coded ref_idx_l0 when active_refs > 1).
    ``pmode``/``mv4``/``ref4`` select the PARTITIONED write path
    (16x8/8x16/8x8 mb_types, per-partition mvd and te(v) ref_idx —
    quadrant-major (mb_h, mb_w, 4[, 2]) fields).  Byte-identical to
    ``io.h264_inter.encode_frame_p_from_levels`` (the Python oracle,
    diffed in tests/test_h264_inter_tpu.py / test_h264_parts.py)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    mode = np.ascontiguousarray(mode, dtype=np.int16)
    zdc = np.ascontiguousarray(zdc, dtype=np.int16)
    acz = np.ascontiguousarray(acz, dtype=np.int16)
    czdc = np.ascontiguousarray(czdc, dtype=np.int16)
    cacz = np.ascontiguousarray(cacz, dtype=np.int16)
    if mv is not None:
        mv = np.ascontiguousarray(mv, dtype=np.int16)
    if ref is not None:
        ref = np.ascontiguousarray(ref, dtype=np.int16)
    if pmode is not None:
        pmode = np.ascontiguousarray(pmode, dtype=np.int16)
        mv4 = np.ascontiguousarray(mv4, dtype=np.int16)
        if ref4 is not None:
            ref4 = np.ascontiguousarray(ref4, dtype=np.int16)
    mb_h, mb_w = mode.shape[:2]
    heads, nbits = [], []
    for i in range(mb_h):
        w = BitWriter()
        slice_head_p(w, qp, frame_num, first_mb=i * mb_w,
                     active_refs=active_refs, deblock=deblock,
                     slice_local=slice_local)
        head, n = packed(w)
        heads.append(head)
        nbits.append(n)
    blob = np.concatenate(heads)
    nbits_a = np.asarray(nbits, dtype=np.uint64)
    rbsp_cap = 2200 * mb_w + 32 + 64
    stride = (rbsp_cap // 2 * 3 + 16 + 63) // 64 * 64
    need = mb_h * stride
    if (workspace is not None
            and workspace.get("cavlc_er_cap", -1) >= need
            and len(workspace["cavlc_er_lens"]) >= mb_h):
        scratch = workspace["cavlc_er_scratch"]
        out = workspace["cavlc_er_out"]
        lens = workspace["cavlc_er_lens"]
    else:
        scratch = np.empty(need, dtype=np.uint8)
        out = np.empty(need, dtype=np.uint8)
        lens = np.zeros(max(mb_h, 64), dtype=np.uint64)
        if workspace is not None:
            workspace.update(cavlc_er_scratch=scratch, cavlc_er_out=out,
                             cavlc_er_lens=lens, cavlc_er_cap=need)
    i16p = ctypes.POINTER(ctypes.c_int16)
    rc = lib.fp_cavlc_entropy_rows_p(
        mode.ctypes.data_as(i16p), zdc.ctypes.data_as(i16p),
        acz.ctypes.data_as(i16p), czdc.ctypes.data_as(i16p),
        cacz.ctypes.data_as(i16p),
        mv.ctypes.data_as(i16p) if mv is not None else None,
        ref.ctypes.data_as(i16p) if ref is not None else None,
        active_refs, mb_h, mb_w, _ptr(blob),
        nbits_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        threads, _ptr(scratch), stride, _ptr(out),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pmode.ctypes.data_as(i16p) if pmode is not None else None,
        mv4.ctypes.data_as(i16p) if pmode is not None else None,
        ref4.ctypes.data_as(i16p) if ref4 is not None else None)
    if rc != 0:
        raise RuntimeError(
            "fp_cavlc_entropy_rows_p failed (bad args or overflow)")
    return [out[i * stride : i * stride + int(lens[i])].tobytes()
            for i in range(mb_h)]


def rtp_send_raw(fd: int, frame: np.ndarray, mtu: int, seq0: int, ts: int,
                 ssrc: int, pt: int, host: str, port: int) -> int:
    """Packetize + send one raw NV12 frame as RTP/UDP entirely in C++
    (header arena + zero-copy payload iovecs + sendmmsg batches, GIL-free).
    Returns packets sent, or raises on socket/address failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    frame = np.ascontiguousarray(frame)
    rows, width = frame.shape
    n = lib.fp_rtp_send_raw(
        fd, _ptr(frame), rows, width, mtu, seq0 & 0xFFFF, ts & 0xFFFFFFFF,
        ssrc, pt, host.encode(), port,
    )
    if n < 0:
        # encoding: -(sent+1) => `sent` packets made it out before the error
        err = OSError("fp_rtp_send_raw failed")
        err.packets_sent = int(-n - 1)
        raise err
    return int(n)
