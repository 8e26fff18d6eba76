"""The port's native C++ runtime (``opencv_opencl_tpu_torch/native``) and
what it serves, against the JAX package's.

- the staging ring, the resequencer and the NV12 helpers, as the JAX
  package's ``tests/test_native.py`` and ``tests/test_runtime.py`` test
  them (order, drop-oldest, ``push_prio`` eviction, slot reuse, many
  producers, the TSAN/ASAN stress script);
- the build: into the port's ``_build/``, named by a hash of the source,
  the flags and the CPU that ``-march=native`` selects, again without
  ``-march=native`` where the compiler refuses it, concurrent builds of one
  library;
- the library against the JAX package's: both loaded with ``ctypes.CDLL``
  (RTLD_LOCAL), each from its own file, byte-equal on the same seeded
  inputs for the I_PCM slices and access units, the CAVLC frame and slice
  encoders, the intra and P entropy rows, the NV12 helpers and the
  datagrams ``rtp_send_raw`` and ``send_packets`` put on loopback;
- ``FrameFeeder(native_staging=...)``: the same outputs, order, drops and
  counters as the Python queue (and as the JAX package's ring), whole
  batches, no frame lost when ``stop()`` races the last submits (also one
  whose push passed the ring's ``closed`` check, on a stand-in ring that
  widens that window), no meta lost to a producer that pushes out of
  order;
- ``RtpUdpSink(kind="raw")`` on the C++ packetizer: the Python
  packetizer's datagrams and counters, partial sends;
- the relay and the multi-stream relay with ``--native`` on the CPU.
"""

import ctypes
import os
import re
import shutil
import socket
import subprocess
import threading
import time

import numpy as np
import pytest

from opencv_opencl_tpu import native as jax_native
from opencv_opencl_tpu.io import h264_pcm as jax_pcm
from opencv_opencl_tpu.runtime import feeder as jax_feeder
from opencv_opencl_tpu_torch import native
from opencv_opencl_tpu_torch.apps import multi_relay, relay
from opencv_opencl_tpu_torch.core.frames import FrameSpec
from opencv_opencl_tpu_torch.io import rtp, videofile
from opencv_opencl_tpu_torch.parallel import launch
from opencv_opencl_tpu_torch.runtime import feeder
from opencv_opencl_tpu_torch.runtime.mux import StreamMux

FRAME = 64 * 48
PORT_DIR = os.path.dirname(native.__file__)


@pytest.fixture(autouse=True)
def _native_built():
    """Build the library on first use, inside a test (not at import): every
    test here needs it."""
    if not native.available():
        pytest.skip(f"native runtime unavailable: {native.build_error()}")


def _frames(rng, n):
    return rng.integers(0, 256, (n, FRAME), dtype=np.uint8)


# ------------------------------------------------------------ the ring ----


def test_ring_push_pop_batch_order():
    rng = np.random.default_rng(0)
    ring = native.NativeRing(capacity=8, frame_bytes=FRAME)
    fs = _frames(rng, 5)
    for i, f in enumerate(fs):
        assert ring.push(f, i)
    out = np.zeros((4, FRAME), dtype=np.uint8)
    n, seqs = ring.pop_batch(out, 4)
    assert n == 4 and list(seqs) == [0, 1, 2, 3]
    assert all(np.array_equal(out[i], fs[i]) for i in range(4))
    n2, seqs2 = ring.pop_batch(out, 4)
    assert n2 == 1 and seqs2[0] == 4


def test_ring_leaky_drop_oldest():
    fs = _frames(np.random.default_rng(1), 3)
    ring = native.NativeRing(capacity=2, frame_bytes=FRAME)
    assert ring.push(fs[0], 0) and ring.push(fs[1], 1)
    assert not ring.push(fs[2], 2)  # frame 0 dropped
    assert ring.dropped == 1
    n, seqs = ring.pop_batch(np.zeros((4, FRAME), dtype=np.uint8), 4)
    assert list(seqs) == [1, 2]


def test_ring_pop_timeout_then_closed_and_drained():
    ring = native.NativeRing(capacity=2, frame_bytes=FRAME)
    out = np.zeros((1, FRAME), dtype=np.uint8)
    assert ring.pop_batch(out, 1, timeout_ms=10)[0] == 0    # timeout
    ring.push(np.ones(FRAME, np.uint8), 7)
    ring.close()
    with pytest.raises(RuntimeError, match="closed"):
        ring.push(np.ones(FRAME, np.uint8), 8)
    n, seqs = ring.pop_batch(out, 1, timeout_ms=10)          # still drains
    assert n == 1 and list(seqs) == [7] and out.all()
    assert ring.pop_batch(out, 1, timeout_ms=10)[0] == -1    # closed + empty


def test_ring_slot_reuse():
    rng = np.random.default_rng(2)
    ring = native.NativeRing(capacity=2, frame_bytes=FRAME)
    out = np.zeros((2, FRAME), dtype=np.uint8)
    for round_ in range(5):
        fs = _frames(rng, 2)
        ring.push(fs[0], 2 * round_)
        ring.push(fs[1], 2 * round_ + 1)
        n, _ = ring.pop_batch(out, 2)
        assert n == 2 and np.array_equal(out, fs)


def test_ring_priority_eviction():
    """Overflow evicts the oldest lowest-priority frame (attributed by
    seq); an incoming frame ranking below the whole queue is rejected;
    uniform priorities degrade to drop-oldest."""
    ring = native.NativeRing(2, 8)
    f = np.arange(8, dtype=np.uint8)
    assert ring.push_prio(f, 10, 0) == ("ok", None)
    assert ring.push_prio(f, 11, 5) == ("ok", None)
    assert ring.push_prio(f, 12, 5) == ("evicted", 10)
    assert ring.push_prio(f, 13, 0) == ("rejected", None)
    assert ring.dropped == 2
    out = np.zeros((2, 8), np.uint8)
    n, seqs = ring.pop_batch(out, 2)
    assert n == 2 and list(seqs) == [11, 12]
    assert ring.push_prio(f, 20, 0) == ("ok", None)
    assert ring.push_prio(f, 21, 0) == ("ok", None)
    assert ring.push_prio(f, 22, 0) == ("evicted", 20)
    ring.close()


def test_ring_multiproducer_stress():
    """4 producer threads against one consumer: no duplicates, FIFO per
    producer, every frame popped or counted as dropped."""
    ring = native.NativeRing(capacity=16, frame_bytes=FRAME)
    per_producer, n_producers = 200, 4

    def produce(pid):
        for i, f in enumerate(_frames(np.random.default_rng(pid), per_producer)):
            ring.push(f, pid * 100000 + i)

    threads = [threading.Thread(target=produce, args=(p,)) for p in range(n_producers)]
    got = []
    out = np.zeros((8, FRAME), dtype=np.uint8)
    for t in threads:
        t.start()
    deadline = time.time() + 20
    while time.time() < deadline:
        _, seqs = ring.pop_batch(out, 8, timeout_ms=20)
        got.extend(int(s) for s in seqs)
        if all(not t.is_alive() for t in threads) and len(ring) == 0:
            break
    for t in threads:
        t.join()
    got.extend(int(s) for s in ring.pop_batch(out, 8, timeout_ms=20)[1])
    assert len(got) == len(set(got))
    assert len(got) + ring.dropped == n_producers * per_producer
    for p in range(n_producers):
        mine = [s for s in got if s // 100000 == p]
        assert mine == sorted(mine)


def test_reseq_reorder():
    fs = _frames(np.random.default_rng(3), 4)
    rs = native.NativeResequencer(max_pending=8, frame_bytes=FRAME)
    assert rs.push(1, fs[1]) == 0     # gap at 0
    assert rs.push(0, fs[0]) == 2     # both ready
    out = np.zeros(FRAME, dtype=np.uint8)
    assert rs.emit(out) == 0 and np.array_equal(out, fs[0])
    assert rs.emit(out) == 1 and np.array_equal(out, fs[1])
    assert rs.emit(out) == -1 and rs.pending == 0


def test_reseq_late_drop_and_skip():
    fs = _frames(np.random.default_rng(4), 5)
    rs = native.NativeResequencer(max_pending=2, frame_bytes=FRAME)
    for seq in (1, 2, 3):             # the third exceeds max_pending: skip 0
        rs.push(seq, fs[seq])
    assert rs.frames_lost == 1
    assert rs.emit(np.zeros(FRAME, dtype=np.uint8)) == 1
    rs.push(0, fs[0])                 # too late
    assert rs.dropped_late == 1


@pytest.mark.parametrize("shape", [(24, 32), (1, 1), (540, 960)])
def test_uv_helpers_round_trip_and_equal_jax(shape):
    rng = np.random.default_rng(5)
    u, v = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2))
    uv = native.uv_interleave(u, v)
    assert uv.shape == (shape[0], 2 * shape[1])
    assert np.array_equal(uv[:, 0::2], u) and np.array_equal(uv[:, 1::2], v)
    assert np.array_equal(uv, jax_native.uv_interleave(u, v))
    u2, v2 = native.uv_deinterleave(uv)
    assert np.array_equal(u2, u) and np.array_equal(v2, v)
    assert all(np.array_equal(a, b) for a, b in zip((u2, v2),
                                                    jax_native.uv_deinterleave(uv)))
    native.uv_gray(uv)
    assert (uv == 128).all()


def test_native_tsan_asan_stress(tmp_path):
    """The ring and the resequencer under 4-producer contention, built with
    -fsanitize=thread and then address,undefined, into a directory of the
    script's own."""
    res = subprocess.run(["sh", os.path.join(PORT_DIR, "build_stress.sh"),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "no data races detected" in res.stdout
    assert "ASAN/UBSAN: clean" in res.stdout
    assert sorted(os.listdir(tmp_path)) == ["framepipe_stress_asan",
                                            "framepipe_stress_tsan"]


# ------------------------------------------------------------ the build ----


def test_library_is_the_ports_own_file_beside_the_jax_packages():
    assert jax_native.available()
    path = native.loaded_path()
    assert path in (native.library_path(native.FLAGS),
                    native.library_path(native.PORTABLE_FLAGS))
    assert os.path.dirname(path) == os.path.join(os.path.dirname(PORT_DIR), "_build")
    assert re.fullmatch(r"libframepipe_[0-9a-f]{16}\.so", os.path.basename(path))
    # ctypes.CDLL loads RTLD_LOCAL: two handles, two files, two copies of
    # every symbol
    ours, theirs = native._load(), jax_native._load()
    assert ours._name == path and theirs._name != path
    assert os.path.realpath(theirs._name).startswith(
        os.path.dirname(os.path.realpath(jax_native.__file__)))
    assert (ctypes.cast(ours.fp_ring_new, ctypes.c_void_p).value
            != ctypes.cast(theirs.fp_ring_new, ctypes.c_void_p).value)
    assert native.has_cavlc() and native.build_error() is None


def test_library_name_hashes_the_source_the_flags_and_the_cpu(tmp_path, monkeypatch):
    names = {native.library_path(native.FLAGS),
             native.library_path(native.PORTABLE_FLAGS)}
    src = tmp_path / "framepipe.cpp"
    shutil.copy(native._SRC, src)
    with open(src, "a") as f:
        f.write("// an edit\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    names.add(native.library_path(native.FLAGS))
    portable = native.library_path(native.PORTABLE_FLAGS)
    # another CPU: another -march=native library, the same portable one
    monkeypatch.setattr(native, "_target", "  -march=  another-cpu\n")
    names.add(native.library_path(native.FLAGS))
    assert len(names) == 4
    assert native.library_path(native.PORTABLE_FLAGS) == portable
    assert "-march=native" not in native.PORTABLE_FLAGS


def test_build_tries_again_without_march_native(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    tried = []

    def compile_(flags, out):
        tried.append(flags)
        if "-march=native" in flags:
            return "error: bad value for -march"
        open(out, "wb").close()
        return None

    monkeypatch.setattr(native, "_compile", compile_)
    path, err = native._build()
    assert err is None and tried == [native.FLAGS, native.PORTABLE_FLAGS]
    assert path == native.library_path(native.PORTABLE_FLAGS)
    assert os.path.dirname(path) == str(tmp_path)
    monkeypatch.setattr(native, "_compile", lambda flags, out: "no g++")
    os.remove(path)
    assert native._build() == (None, "no g++")


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Builds that start together each write a temporary file and rename
    it: every one gets the same loadable library, no temporary is left."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    results = []
    threads = [threading.Thread(target=lambda: results.append(native._build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = native.library_path(native.FLAGS)
    assert results == [(want, None)] * 2
    assert os.listdir(tmp_path) == [os.path.basename(want)]
    assert ctypes.CDLL(want).fp_ring_new


# -------------------------------------- the library against the JAX one ----


def _nv12(w, h, seed, fill=None):
    if fill is not None:
        return np.full((h * 3 // 2, w), fill, np.uint8)
    return np.random.default_rng(seed).integers(0, 256, (h * 3 // 2, w), np.uint8)


@pytest.mark.parametrize("w,h,slices,fill", [
    (64, 48, 1, None), (34, 18, 2, None), (256, 16, 1, None), (48, 64, 3, 0),
    (48, 32, 2, 3)])
def test_pcm_encoders_equal_jax(w, h, slices, fill):
    frame = _nv12(w, h, w + h + slices, fill)
    mb_h, mb_w = -(-h // 16), -(-w // 16)
    bounds = [round(i * mb_h / slices) for i in range(slices + 1)]
    heads = [jax_pcm._slice_head(1, first_mb=bounds[i] * mb_w) for i in range(slices)]
    prelude = (jax_pcm._START4 + jax_pcm.build_sps(w, h) + jax_pcm._START4
               + jax_pcm.build_pps())
    ours, theirs = ((mod.pcm_encode_slices(frame, w, h, heads, bounds),
                     mod.pcm_encode_au(frame, w, h, prelude, heads, bounds))
                    for mod in (native, jax_native))
    assert ours == theirs
    assert ours[1].startswith(prelude) and len(ours[0]) == slices
    assert ours[0] == jax_pcm.encode_frame_pcm_slices(frame, w, h, 1, slices=slices)


@pytest.mark.parametrize("qp", [0, 18, 28, 51])
def test_cavlc_frame_encoder_equals_jax(qp):
    w, h = 64, 48
    frame = _nv12(w, h, qp)
    ws = {}
    got = [native.cavlc_encode_frame(frame, w, h, qp, idr, workspace=ws)
           for idr in (0, 1)]
    assert got == [jax_native.cavlc_encode_frame(frame, w, h, qp, idr)
                   for idr in (0, 1)]


@pytest.mark.parametrize("slices,threads,deblock", [(1, 0, False), (3, 2, False),
                                                    (3, 0, True)])
def test_cavlc_slice_encoder_equals_jax(slices, threads, deblock):
    w, h = 96, 64
    frame = _nv12(w, h, slices + threads)
    kw = dict(slices=slices, threads=threads, deblock=deblock)
    got = native.cavlc_encode_slices(frame, w, h, 26, 1, **kw)
    assert got == jax_native.cavlc_encode_slices(frame, w, h, 26, 1, **kw)
    assert len(got) == slices


@pytest.fixture(scope="module")
def intra_levels():
    """Quantized levels of a small frame from the JAX package's level stage,
    as it gives them (DC prediction) and with seeded I_4x4 block modes and
    horizontal chroma on some macroblocks (the syntax the coder writes for
    them, whatever levels they carry)."""
    from opencv_opencl_tpu.ops import h264_levels as hl

    w, h = 64, 48
    lv, imode = hl.encode_levels_nv12(_nv12(w, h, 7), w, h, 28)
    arrays = tuple(np.asarray(a) for a in lv)
    rng = np.random.default_rng(8)
    mbs = imode.shape
    return {"plain": dict(arrays=arrays, imode=np.asarray(imode)),
            "i4_chromah": dict(arrays=arrays, imode=rng.integers(0, 3, mbs),
                               i4modes=rng.integers(0, 9, (*mbs, 16)),
                               cmode=rng.integers(0, 2, mbs))}


@pytest.mark.parametrize("form,threads,deblock", [
    ("plain", 1, False), ("plain", 3, True), ("i4_chromah", 0, False)])
def test_cavlc_entropy_rows_equal_jax(intra_levels, form, threads, deblock):
    lv = dict(intra_levels[form])
    arrays = lv.pop("arrays")
    got = native.cavlc_entropy_rows(*arrays, 28, 1, threads=threads,
                                    deblock=deblock, **lv)
    assert got == jax_native.cavlc_entropy_rows(*arrays, 28, 1, threads=threads,
                                                deblock=deblock, **lv)
    assert len(got) == arrays[0].shape[0]


@pytest.fixture(scope="module")
def p_levels():
    """A P frame's levels from the JAX package's level stage."""
    import jax.numpy as jnp

    from opencv_opencl_tpu.ops.h264_levels import (
        encode_levels_recon_jit, encode_p_levels_jit)

    w, h, qp = 64, 48, 28
    f0 = _nv12(w, h, 31)
    f1 = f0.copy()
    f1[5:25, 8:40] ^= 0x11
    f1[32:48] = np.linspace(40, 200, w)[None, :].astype(np.uint8)
    uv0 = f0[h:].reshape(h // 2, w // 2, 2)
    uv1 = f1[h:].reshape(h // 2, w // 2, 2)
    _, ry, rcb, rcr, _ = encode_levels_recon_jit(
        jnp.asarray(f0[:h]), jnp.asarray(uv0[:, :, 0]), jnp.asarray(uv0[:, :, 1]),
        jnp.int32(qp))
    plv = encode_p_levels_jit(jnp.asarray(f1[:h]), jnp.asarray(uv1[:, :, 0]),
                              jnp.asarray(uv1[:, :, 1]), ry, rcb, rcr, jnp.int32(qp))
    return tuple(np.asarray(a) for a in plv[:5])


@pytest.mark.parametrize("case", ["zero_motion", "motion_refs_deblock",
                                  "partitions"])
def test_cavlc_entropy_rows_p_equal_jax(p_levels, case):
    mode = p_levels[0]
    mb_h, mb_w = mode.shape[:2]
    rng = np.random.default_rng(11)
    kw = {}
    if case == "motion_refs_deblock":
        kw = dict(mv=rng.integers(-8, 9, (mb_h, mb_w, 2)),
                  ref=rng.integers(0, 2, (mb_h, mb_w)), active_refs=2,
                  deblock=True, slice_local=True, threads=2)
    elif case == "partitions":
        kw = dict(pmode=rng.integers(0, 4, (mb_h, mb_w)),
                  mv4=rng.integers(-6, 7, (mb_h, mb_w, 4, 2)),
                  ref4=rng.integers(0, 2, (mb_h, mb_w, 4)), active_refs=2)
    got = native.cavlc_entropy_rows_p(*p_levels, 28, 3, **kw)
    assert got == jax_native.cavlc_entropy_rows_p(*p_levels, 28, 3, **kw)
    assert len(got) == mb_h


def _catch(send, count_timeout=3.0):
    """Run ``send(fd, port)`` from a fresh UDP socket to one bound on
    127.0.0.1; returns the datagrams that arrived."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(count_timeout)
        n = send(tx.fileno(), rx.getsockname()[1])
        return n, [rx.recv(65536) for _ in range(n)]
    finally:
        tx.close()
        rx.close()


@pytest.mark.parametrize("w,h,mtu", [(64, 48, 64), (96, 64, rtp.DEFAULT_MTU),
                                     (1920, 4, rtp.DEFAULT_MTU)])
def test_rtp_send_raw_puts_the_same_datagrams_on_loopback(w, h, mtu):
    frame = _nv12(w, h, mtu)
    seq0, ts, ssrc = 65530, 0xFFFFFFF0, 0x54505532     # both wrap
    got = {}
    for mod in (native, jax_native):
        got[mod] = _catch(lambda fd, port: mod.rtp_send_raw(
            fd, frame, mtu, seq0, ts, ssrc, rtp.PT_RAW, "127.0.0.1", port))
    py = rtp.RawNv12Payloader(mtu=mtu, ssrc=ssrc)
    py.seq, py.ts = seq0, ts
    want = py.packetize(frame)
    assert got[native] == got[jax_native] == (len(want), want)


def test_send_packets_puts_the_same_datagrams_on_loopback():
    rng = np.random.default_rng(12)
    packets = [rng.integers(0, 256, int(n), np.uint8).tobytes()
               for n in rng.integers(1, 1000, 70)]
    for mod in (native, jax_native):
        assert _catch(lambda fd, port: mod.send_packets(
            fd, packets, "127.0.0.1", port)) == (70, packets)
    with pytest.raises(OSError) as e:
        native.rtp_send_raw(-1, _nv12(64, 48, 0), 64, 0, 0, 1, 96, "127.0.0.1", 9)
    assert e.value.packets_sent == 0


# ------------------------------------------------- the feeder on the ring ----


def _step(batch):
    """Each pixel plus its row index."""
    return (batch.astype(np.int32) + np.arange(batch.shape[1])[None, :, None]
            ).astype(np.uint8)


def _feeder_run(mod, frames, staging, **kw):
    outs, drops, lock = [], [], threading.Lock()

    def on_output(seq, frame, meta):
        with lock:
            outs.append((seq, meta, frame.copy()))

    f = mod.FrameFeeder(_step, batch_size=3, depth=2, on_output=on_output,
                        on_drop_item=lambda item: drops.append(item[0]),
                        native_staging=staging, **kw)
    assert (f._native is not None) == bool(staging)
    # queue everything first: the drops and the batches are then the same
    for i, frame in enumerate(frames):
        f.submit(frame, meta=("m", i))
    f.start()
    f.stop(drain=True, timeout=60)
    return outs, drops, f.stats


@pytest.mark.parametrize("priority", [False, True], ids=["leaky", "priority"])
def test_feeder_on_the_ring_equals_the_python_queue_and_jax(priority):
    frames = [np.full((6, 5), i, np.uint8) for i in range(11)]
    kw = dict(queue_capacity=7)
    if priority:
        kw["priority_of"] = lambda item: item[0] % 3
    ring = _feeder_run(feeder, frames, (6, 5), **kw)
    queue = _feeder_run(feeder, frames, False, **kw)
    jax_ring = _feeder_run(jax_feeder, frames, (6, 5), **kw)
    for other in (queue, jax_ring):
        assert [(s, m) for s, m, _ in ring[0]] == [(s, m) for s, m, _ in other[0]]
        assert all(np.array_equal(a, b) for (_, _, a), (_, _, b)
                   in zip(ring[0], other[0]))
        assert ring[1] == other[1] and ring[1]           # the same frames dropped
        assert ring[2] == other[2]
    assert [s for s, _, _ in ring[0]] == list(range(len(ring[0])))


def test_feeder_on_the_ring_through_the_ports_enhancer():
    """The JAX package's ``test_feeder_native_staging``: histeq through the
    port's Enhancer on the CPU, the ring's outputs equal the queue's."""
    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy
    from opencv_opencl_tpu_torch.models.enhancer import Enhancer, EnhancerConfig

    spec = FrameSpec(width=64, height=48)
    enh = Enhancer(EnhancerConfig(op="histeq", chroma=ChromaPolicy.PASSTHROUGH),
                   spec, device="cpu")
    frames = np.random.default_rng(13).integers(
        0, 256, (6, spec.buffer_rows, spec.width), dtype=np.uint8)
    runs = []
    for staging in ((spec.buffer_rows, spec.width), False):
        results = {}
        f = feeder.FrameFeeder(
            enh.process_batch, batch_size=2, depth=2, native_staging=staging,
            on_output=lambda seq, frame, meta: results.__setitem__(seq, (frame, meta)))
        f.start()
        for i, fr in enumerate(frames):
            f.submit(fr, meta=i)
        f.stop(drain=True)
        assert sorted(results) == list(range(6))
        assert [results[i][1] for i in range(6)] == list(range(6))
        runs.append(np.stack([results[i][0] for i in range(6)]))
    assert np.array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], frames)


def test_feeder_on_the_ring_stays_ordered_under_drops():
    """The JAX package's ``test_feeder_durability_under_drops`` on the
    ring: a stream with overflow drops stays ordered and gapless, with exact
    accounting."""
    seen = []
    f = feeder.FrameFeeder(_step, batch_size=4, depth=2, queue_capacity=4,
                           native_staging=(8, 16),
                           on_output=lambda s, fr, m: seen.append(s))
    f.start()
    frames = np.random.default_rng(14).integers(0, 256, (200, 8, 16), np.uint8)
    for i, fr in enumerate(frames):
        f.submit(fr, meta=i)
        if i % 3 == 0:
            time.sleep(0.001)
    f.stop(drain=True)
    s = f.stats
    assert s["emitted"] + s["dropped_overflow"] == 200
    assert seen == sorted(seen) and len(set(seen)) == len(seen)
    assert s["frames_lost"] == 0 and s.get("processing_errors", 0) == 0


def test_feeder_on_the_ring_drops_a_frame_submitted_after_stop():
    f = feeder.FrameFeeder(lambda b: b, batch_size=2, native_staging=(8, 16))
    f.start()
    f.submit(np.zeros((8, 16), np.uint8))
    f.stop(drain=True)
    before = f.stats["dropped_overflow"]
    f.submit(np.zeros((8, 16), np.uint8))  # must not raise
    assert f.stats["dropped_overflow"] == before + 1
    assert f.queue_length() == 0 and f.stats["emitted"] == 1


@pytest.mark.parametrize("staging", [(6, 8), False], ids=["ring", "queue"])
def test_feeder_whole_batches_on_both_stagings(staging):
    sizes, got = [], []

    def step(batch):
        sizes.append(len(batch))
        return np.asarray(batch).copy()

    f = feeder.FrameFeeder(step, batch_size=4, depth=2, queue_capacity=16,
                           on_output=lambda seq, fr, meta: got.append((meta, int(fr[0, 0]))),
                           pad_batches=False, whole_batches=True,
                           native_staging=staging)
    f.start()
    for k in range(10):
        f.submit(np.full((6, 8), k, np.uint8), meta=k)
        time.sleep(0.06 if k in (1, 6) else 0.0)   # longer than the pop timeout
    f.stop(drain=True, timeout=30)
    assert sizes == [4, 4, 2]
    assert got == [(k, k) for k in range(10)]


def test_feeder_on_the_ring_drains_a_frame_queued_as_its_pop_times_out():
    """The race of the JAX package's native loop: its pop times out, the
    last frame is pushed and ``stop()`` closes the ring; the loop must pop
    on until the closed ring is empty (the pop is made to time out then,
    once)."""
    outs = []
    f = feeder.FrameFeeder(_step, batch_size=2, depth=1, native_staging=(4, 6),
                           on_output=lambda seq, frame, meta: outs.append(meta))
    ring = f._native
    closed, real_close, real_pop = threading.Event(), ring.close, ring.pop_batch

    def close():
        real_close()
        closed.set()

    def pop_batch(out, max_frames, timeout_ms=50):
        if not closed.is_set():
            closed.wait(10.0)
            return 0, np.zeros(0, np.uint64)       # the pop that timed out
        return real_pop(out, max_frames, timeout_ms)

    ring.close, ring.pop_batch = close, pop_batch
    f.start()
    for k in range(3):
        f.submit(np.full((4, 6), k, np.uint8), meta=k)
    f.stop(drain=True, timeout=10.0)
    assert closed.is_set()
    assert outs == [0, 1, 2] and f.stats["emitted"] == 3


class _WindowRing:
    """The C++ ring's protocol in Python, with its window made wide: a push
    checks ``closed``, then waits (``between``) before its frame is queued,
    as ``fp_ring_push_prio`` copies the frame between its two locks."""

    def __init__(self, frame_bytes):
        self.frame_bytes, self.queue, self.closed = frame_bytes, [], False
        self.lock, self.between = threading.Lock(), lambda: None
        self.saw_closed = threading.Event()

    def push_prio(self, frame, seq, prio):
        with self.lock:
            if self.closed:
                raise RuntimeError("ring closed")
        self.between()
        with self.lock:
            self.queue.append((seq, frame.copy()))
        return "ok", None

    def pop_batch(self, out, max_frames, timeout_ms=50):
        with self.lock:
            if not self.queue:
                if self.closed:
                    self.saw_closed.set()
                    return -1, np.zeros(0, np.uint64)
                got = []
            else:
                got, self.queue = self.queue[:max_frames], self.queue[max_frames:]
        if not got:
            time.sleep(timeout_ms / 1000)
            return 0, np.zeros(0, np.uint64)
        for i, (_, frame) in enumerate(got):
            out[i] = frame
        return len(got), np.array([seq for seq, _ in got], np.uint64)

    def close(self):
        with self.lock:
            self.closed = True

    def __len__(self):
        return len(self.queue)


def test_feeder_on_the_ring_waits_for_a_push_that_passed_the_closed_check():
    """A submit() whose push passed the ring's ``closed`` check when
    ``stop()`` closed the ring lands its frame after the feeder's pop has
    seen the ring closed and empty; the feeder pops it and emits it."""
    outs = []
    f = feeder.FrameFeeder(_step, batch_size=1, depth=1, native_staging=(2, 4),
                           on_output=lambda seq, frame, meta: outs.append(meta))
    ring = f._native = _WindowRing(8)
    entered = threading.Event()

    def between():
        entered.set()
        assert ring.saw_closed.wait(10.0)    # the pop saw closed and empty

    ring.between = between
    f.start()
    late = threading.Thread(target=f.submit, args=(np.ones((2, 4), np.uint8), "late"))
    late.start()
    assert entered.wait(10.0)
    f.stop(drain=True, timeout=10.0)
    late.join(10.0)
    assert outs == ["late"] and f.stats["emitted"] == 1
    assert f.stats["dropped_overflow"] == 0 and len(ring) == 0


@pytest.mark.parametrize("batch_size", [1, 4])
def test_feeder_on_the_ring_emits_every_frame_submitted_as_stop_begins(batch_size):
    """Frames submitted just before ``stop()`` are all emitted, and a
    producer racing ``stop()`` loses nothing: every frame is emitted or
    counted as dropped, those submitted before ``stop()`` was called all
    emitted, in order; repeated."""
    for trial in range(25):
        outs = []
        f = feeder.FrameFeeder(lambda b: b, batch_size=batch_size, depth=2,
                               queue_capacity=64, native_staging=(2, 8),
                               on_output=lambda seq, fr, meta: outs.append(meta))
        f.start()
        n = 1 + trial % 7
        for k in range(n):
            f.submit(np.full((2, 8), k, np.uint8), meta=k)
        submitted = []
        racer = threading.Thread(target=lambda: submitted.extend(
            f.submit(np.zeros((2, 8), np.uint8), meta=n + k) for k in range(20)))
        racer.start()
        f.stop(drain=True, timeout=30)
        racer.join()
        s = f.stats
        assert outs[:n] == list(range(n)) and outs == sorted(outs)
        assert s["emitted"] + s["dropped_overflow"] == n + 20
        assert s.get("processing_errors", 0) == 0


def test_feeder_on_the_ring_keeps_the_meta_of_a_frame_pushed_late():
    """Two producers: the first takes seq 0 but pushes after seq 1 has been
    popped and emitted.  The JAX package forgets metas below the oldest seq
    popped, so frame 0 would come out without its meta; here it keeps it."""
    metas, emitted_b = [], threading.Event()

    def on_output(seq, frame, meta):
        metas.append(meta)
        if meta == "b":
            emitted_b.set()

    f = feeder.FrameFeeder(lambda b: b, batch_size=1, depth=1,
                           native_staging=(2, 4), on_output=on_output)
    ring = f._native
    real_push = ring.push_prio

    def push_prio(frame, seq, prio):
        if seq == 0:
            assert emitted_b.wait(10.0)
        return real_push(frame, seq, prio)

    ring.push_prio = push_prio
    f.start()
    late = threading.Thread(target=f.submit, args=(np.zeros((2, 4), np.uint8), "a"))
    late.start()
    while f._seq == 0:          # the late producer holds seq 0
        time.sleep(0.001)
    f.submit(np.ones((2, 4), np.uint8), "b")
    late.join(10.0)
    f.stop(drain=True, timeout=10.0)
    assert metas == ["b", "a"]


def test_mux_priorities_on_the_ring():
    """``StreamMux`` with ``priorities`` over the ring's ``push_prio``: the
    premium stream survives and per-stream drops are attributed to the
    evicted frame's stream (the JAX package's
    ``test_mux_priorities_with_native_staging``)."""
    gate = threading.Event()

    def slow_process(batch):
        gate.wait(5.0)
        return batch

    out = []
    mux = StreamMux(slow_process, 2, on_output=lambda s, k, f, m: out.append(s),
                    priorities=[0, 5], batch_size=1, depth=1, queue_capacity=2,
                    native_staging=(6, 8))
    assert mux.feeder._native is not None
    mux.start()
    try:
        f = np.zeros((6, 8), np.uint8)
        for i in range(8):
            mux.submit(i % 2, f)
            time.sleep(0.01)
        gate.set()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(out) < 3:
            time.sleep(0.05)
    finally:
        gate.set()
        mux.stop(drain=True)
    st = mux.stats
    prem, be = st["per_stream"][1], st["per_stream"][0]
    assert prem["emitted"] >= be["emitted"] and prem["emitted"] >= 2
    assert be["dropped"] >= prem["dropped"] and be["dropped"] >= 1
    for p in (prem, be):
        assert p["emitted"] + p["dropped"] == p["submitted"]
    assert be["dropped"] + prem["dropped"] == st["dropped_overflow"]


# ------------------------------------------------------- the raw RTP sink ----


def _sink_run(monkeypatch, use_native, frames, mtu=256):
    monkeypatch.setattr(native, "available", lambda: use_native)

    def send(fd, port):
        sink = rtp.RtpUdpSink("127.0.0.1", port, kind="raw", fps=25.0, mtu=mtu,
                              rtcp=False)
        assert sink._use_native is use_native
        sink.payloader.seq = 65500                      # wraps inside the run
        for fr in frames:
            sink.write(fr)
        sink.close()
        send.counters = (sink.frames, sink.packets, sink.bytes,
                         sink.payload_octets, sink.send_errors,
                         sink.payloader.seq, sink.payloader.ts,
                         sink.payloader.last_ts)
        return sink.packets

    n, datagrams = _catch(send)
    return datagrams, send.counters


def test_rtp_raw_sink_on_the_cpp_packetizer_sends_the_python_datagrams(monkeypatch):
    frames = list(videofile.TestSource(FrameSpec(width=64, height=48), 3, seed=5))
    got = _sink_run(monkeypatch, True, frames)
    want = _sink_run(monkeypatch, False, frames)
    assert got == want
    assert len(got[0]) == got[1][1] == 3 * 72
    rx = rtp.RtpUdpReceiver(port=0, kind="raw", frame_shape=(72, 64), timeout=2.0,
                            rtcp=False)
    monkeypatch.setattr(native, "available", lambda: True)
    sink = rtp.RtpUdpSink("127.0.0.1", rx.port, kind="raw", fps=30.0, rtcp=False)
    try:
        for fr in frames:
            sink.write(fr)
            assert np.array_equal(rx.recv_frame(), fr)
    finally:
        sink.close()
        rx.close()


def test_rtp_raw_sink_partial_send_skips_the_frame_and_keeps_the_sequence(
        monkeypatch):
    """A send that fails after ``packets_sent`` packets: the sequence moves
    on by those packets, the timestamp by one frame, the error is counted,
    and the next frame goes out whole."""
    sink = rtp.RtpUdpSink("127.0.0.1", 9, kind="raw", fps=30.0, mtu=64, rtcp=False)
    assert sink._use_native
    frame = np.zeros((72, 64), np.uint8)
    calls = []

    def failing(fd, fr, mtu, seq0, ts, ssrc, pt, host, port):
        calls.append((seq0, ts))
        err = OSError("fp_rtp_send_raw failed")
        err.packets_sent = 5
        raise err

    monkeypatch.setattr(native, "rtp_send_raw", failing)
    sink.write(frame)
    assert sink.send_errors == 1 and sink.packets == 5
    assert sink.payloader.seq == 5 and sink.payloader.ts == 3000
    assert sink.bytes == 5 * 20 + frame.nbytes
    monkeypatch.setattr(native, "rtp_send_raw",
                        lambda fd, fr, mtu, seq0, ts, *a: calls.append((seq0, ts)) or 7)
    sink.write(frame)
    assert calls == [(0, 0), (5, 3000)]
    assert sink.packets == 12 and sink.payloader.seq == 12 and sink.frames == 2
    sink.close()


# ------------------------------------------------------------- the apps ----


def _relay_frames(tmp_path, name, extra, frames=8, w=64, h=48):
    path = tmp_path / f"{name}.nv12"
    rc = relay.run(["--source=test", f"--width={w}", f"--height={h}", "--batch=2",
                    f"--max-frames={frames}", "--status-interval=60",
                    "--device=cpu", f"--sink={path}"] + extra)
    assert rc == 0
    return np.fromfile(str(path), np.uint8).reshape(-1, h * 3 // 2, w)


@pytest.mark.parametrize("extra", [["--op=clahe", "--chroma=passthrough"],
                                   ["--op=histeq", "--chroma=gray", "--mesh=1x1"],
                                   ["--op=clahe", "--chroma=passthrough",
                                    "--ref-frame"]],
                         ids=["clahe", "histeq_mesh_1x1", "ref_frame"])
def test_relay_native_gives_the_frames_of_the_python_queue(tmp_path, capsys, extra):
    queue = _relay_frames(tmp_path, "queue", extra)
    assert "staging=python queue" in capsys.readouterr().out
    ring = _relay_frames(tmp_path, "ring", extra + ["--native"])
    out = capsys.readouterr().out
    assert "staging=native C++ ring" in out and "8 frames emitted" in out
    assert ring.shape == queue.shape == (8, 72, 64)
    assert np.array_equal(ring, queue)


def test_relay_native_on_a_gloo_mesh_of_two_cuts_whole_batches(tmp_path):
    """``--native --mesh=2x1``: each rank stages through its own ring and
    still cuts whole batches; rank 0's file equals the one-process run's."""
    ours = tmp_path / "mesh.nv12"
    config = ["--op=histeq", "--chroma=gray"]
    args = ["--source=test", "--width=64", "--height=48", "--batch=2",
            "--max-frames=6", "--status-interval=60", "--device=cpu"] + config
    rcs = launch.run_on_mesh((2, 1), launch.run_relay,
                             (args + ["--mesh=2x1", "--native", f"--sink={ours}"],),
                             device_type="cpu", timeout=110.0)
    assert rcs == [0, 0]
    want = _relay_frames(tmp_path, "single", config, frames=6)
    got = np.fromfile(str(ours), np.uint8).reshape(-1, 72, 64)
    assert got.shape == (6, 72, 64) and np.array_equal(got, want)


def test_multi_relay_native_with_priorities(capsys):
    args = ["--streams=3", "--width=64", "--height=48", "--op=histeq",
            "--batch=2", "--max-frames=5", "--fps=200", "--status-interval=60",
            "--device=cpu", "--priorities=2,1,0"]
    counts = []
    for extra in (["--native"], []):
        assert multi_relay.run(args + extra) == 0
        out = capsys.readouterr().out
        m = re.search(r"Shutdown: (\d+) frames across 3 streams", out)
        per = [(int(e), int(s)) for e, s in re.findall(r"#\d+=(\d+)/(\d+)", out)]
        assert m and [s for _, s in per] == [5, 5, 5]
        assert int(m.group(1)) == sum(e for e, _ in per) > 0
        counts.append(per)
    assert multi_relay.run(args[:-1] + ["--priorities=1,2", "--native"]) == 2
    assert "--priorities needs 3 entries" in capsys.readouterr().err
