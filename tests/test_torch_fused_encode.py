"""The port's fused enhance + encode step (``models/fused_encode.py``) on the
CPU against the JAX package's.

``build_enhance_levels_fn`` and ``build_enhance_gop_fn`` with
``device="cpu"`` (the kernels' plain versions) give the JAX package's packed
tensors element for element, and the GOP step its reference pictures, over
two batches of three frames that cross a GOP boundary (``gop=4``: IDRs at
frames 0 and 4).  The access units that the port's encoders assemble from
them (``encode_from_packed``) equal, byte for byte, those of the JAX
package's encoders on the same packed input, and those of the port's
unfused encoders (``CudaCavlcEncoder`` / ``CudaGopEncoder`` on
``device="cpu"``) on the enhanced frames.

The JAX package's CLAHE on its CPU backend flips rare exact-tie pixels by
one (LLVM contracts the bilinear blend into an FMA; ``tests/conftest.py``'s
``assert_clahe_close``), where the port's equals ``core/golden.py``.  For
the CLAHE cases the JAX step is therefore given the port's enhanced frames
with ``op="none"``: the encode half is held to JAX element for element,
the enhancement to golden (``tests/test_torch_enhancer.py``).

Each JAX configuration compiles once (module-scoped fixtures, one batch
shape); the two with ``bitpack`` take most of the file's time.
"""

import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opencv_opencl_tpu.core.frames import ChromaPolicy as JaxChroma
from opencv_opencl_tpu.core.frames import FrameSpec as JaxSpec
from opencv_opencl_tpu.io.h264_cavlc import TpuCavlcEncoder
from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
from opencv_opencl_tpu.models import fused_encode as jax_fused
from opencv_opencl_tpu.models.enhancer import EnhancerConfig as JaxConfig
from opencv_opencl_tpu_torch.core import golden
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.io.encoder import EncodedRtpSink
from opencv_opencl_tpu_torch.io.h264_cavlc import CudaCavlcEncoder
from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder, _split_bits_lanes
from opencv_opencl_tpu_torch.models import fused_encode
from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig, build_enhance_fn

QP = 28
GOP = 4
BATCHES = ((0, 3), (3, 6))   # frames 0-2, then 3-5: the IDR of frame 4


def frames_for(w, h, n, seed):
    """The left half static, the right half panning two pixels a frame, and
    a new random block from frame 1 on: skip, inter (with motion) and intra
    MBs all occur."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
    out = []
    for i in range(n):
        f = base.copy()
        f[:, w // 2:] = np.roll(base[:, w // 2:], 2 * i, 1)
        if i:
            f[8:24, 4 * i:4 * i + 24] = rng.integers(0, 256, (16, 24), np.uint8)
        out.append(f)
    return np.stack(out)


def configs(op, chroma):
    jax_cfg = JaxConfig(op="none" if op == "clahe" else op,
                        chroma=JaxChroma(chroma.value))
    return EnhancerConfig(op=op, chroma=chroma), jax_cfg


def enhanced(cfg, spec, frames):
    return build_enhance_fn(cfg, spec, donate=False)(torch.from_numpy(frames)).numpy()


def jax_input(op, cfg, spec, frames):
    """What the JAX step is given: the frames, or for CLAHE the port's
    enhanced frames (module docstring)."""
    return enhanced(cfg, spec, frames) if op == "clahe" else frames


# --------------------------------------------------------------- intra ----

LEVEL_CASES = {
    "clahe_passthrough_96x64": (96, 64, "clahe", ChromaPolicy.PASSTHROUGH, 0),
    "histeq_passthrough_100x56_bitpack": (100, 56, "histeq",
                                          ChromaPolicy.PASSTHROUGH, 64),
    "none_gray_112x72": (112, 72, "none", ChromaPolicy.GRAY, 0),
}


@pytest.fixture(scope="module")
def level_runs():
    runs = {}

    def run(name):
        if name not in runs:
            w, h, op, chroma, bitpack = LEVEL_CASES[name]
            cfg, jax_cfg = configs(op, chroma)
            spec = FrameSpec(width=w, height=h, fps=30)
            frames = frames_for(w, h, 3, seed=w)
            got = fused_encode.build_enhance_levels_fn(
                cfg, spec, bitpack=bitpack, device="cpu")(frames, QP)
            want = np.asarray(jax_fused.build_enhance_levels_fn(
                jax_cfg, JaxSpec(width=w, height=h, fps=30), bitpack=bitpack)(
                    jax_input(op, cfg, spec, frames), jnp.int32(QP)))
            runs[name] = (got.numpy(), want, enhanced(cfg, spec, frames))
        return runs[name]

    return run


@pytest.mark.parametrize("name", list(LEVEL_CASES))
def test_levels_packed_equal_jax(name, level_runs):
    got, want, _ = level_runs(name)
    w, h, _, _, bitpack = LEVEL_CASES[name]
    lanes = 410 + (1 + 2 * bitpack if bitpack else 0)
    assert got.dtype == np.int16
    assert got.shape == (3, -(-h // 16), -(-w // 16), lanes)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 408] == QP).all()


@pytest.mark.parametrize("name", list(LEVEL_CASES))
def test_levels_aus_equal_jax_and_unfused(name, level_runs):
    got, _, enh = level_runs(name)
    w, h, _, _, bitpack = LEVEL_CASES[name]
    kw = dict(bitpack=True, nw_mb=bitpack) if bitpack else {}
    port = CudaCavlcEncoder(w, h, qp=QP, device="cpu", **kw)
    jax_enc = TpuCavlcEncoder(w, h, qp=QP, **kw)
    unfused = CudaCavlcEncoder(w, h, qp=QP, device="cpu", **kw)
    aus = [au for p in got for au in port.encode_from_packed(p)]
    assert aus == [au for p in got for au in jax_enc.encode_from_packed(p)]
    assert aus == [au for f in enh for au in unfused.encode(f)]
    assert port._bits_overflows == 0


def test_levels_overflowing_bits_take_the_entropy_path(level_runs):
    """An MB over ``nw_mb`` words: the levels in the packed tensor are
    coded on the host, counted, and the AU is the same."""
    got, _, _ = level_runs("histeq_passthrough_100x56_bitpack")
    plain = CudaCavlcEncoder(100, 56, qp=QP, device="cpu")
    want = [au for p in got for au in plain.encode_from_packed(p[..., :410])]
    capped = got.copy()
    capped[..., 410] = np.where(np.arange(7) == 3, 32 * 64 + 1, capped[..., 410])
    enc = CudaCavlcEncoder(100, 56, qp=QP, device="cpu", bitpack=True, nw_mb=64)
    assert [au for p in capped for au in enc.encode_from_packed(p)] == want
    assert enc._bits_overflows == 3


def test_inband_qp_wins_over_a_changed_encoder_qp():
    """The slice header carries the qp the levels were quantized with, even
    where rate control moved ``enc.qp`` between dispatch and assembly."""
    w, h = 96, 64
    spec = FrameSpec(width=w, height=h, fps=30)
    cfg = EnhancerConfig(op="none", chroma=ChromaPolicy.PASSTHROUGH)
    frames = frames_for(w, h, 1, seed=9)
    packed = fused_encode.build_enhance_levels_fn(cfg, spec, device="cpu")(frames, 30)
    enc = CudaCavlcEncoder(w, h, qp=30, device="cpu")
    enc.qp = 44
    assert enc.encode_from_packed(packed[0].numpy()) == \
        CudaCavlcEncoder(w, h, qp=30, device="cpu").encode(frames[0])
    gop_fn = fused_encode.build_enhance_gop_fn(cfg, spec, GOP, device="cpu")
    genc = CudaGopEncoder(w, h, qp=30, gop=GOP, device="cpu")
    packed, *_ = gop_fn(np.concatenate([frames, frames]), 30, 0, *genc.initial_recon())
    genc.qp = 44
    got = [au for p in packed.numpy() for au in genc.encode_from_packed(p)]
    ref = CudaGopEncoder(w, h, qp=30, gop=GOP, device="cpu")
    assert got == [au for f in (frames[0], frames[0]) for au in ref.encode(f)]


def test_i4_and_chromah_are_not_read_by_the_fused_intra_step(level_runs):
    """As in the JAX package, the fused levels are I_16x16 with DC chroma
    whatever the encoder's ``i4`` and ``chromah``: its AUs are those of the
    plain ``tpu`` encoder and of the JAX encoder with the same options, and
    differ from the unfused ``tpu:i4:chromah`` stream (ROADMAP.md, Queue 3,
    "Found in the reference")."""
    got, _, enh = level_runs("clahe_passthrough_96x64")
    opts = dict(qp=QP, i4=True, chromah=True)
    encs = (CudaCavlcEncoder(96, 64, device="cpu", **opts),
            CudaCavlcEncoder(96, 64, qp=QP, device="cpu"), TpuCavlcEncoder(96, 64, **opts))
    fused, plain, jax_i4 = ([au for p in got for au in enc.encode_from_packed(p)]
                            for enc in encs)
    assert fused == plain == jax_i4
    unfused = CudaCavlcEncoder(96, 64, device="cpu", **opts)
    assert fused != [au for f in enh for au in unfused.encode(f)]


# ----------------------------------------------------------------- GOP ----

# (w, h, op, chroma, the step's options)
GOP_CASES = {
    "zero_motion_bitpack": (96, 64, "clahe", ChromaPolicy.PASSTHROUGH,
                            dict(bitpack=64)),
    "search4_fastsub_deblock": (100, 56, "histeq", ChromaPolicy.GRAY,
                                dict(search=4, subpel=3, deblock=True)),
    "refs2": (112, 72, "none", ChromaPolicy.PASSTHROUGH, dict(search=2, refs=2)),
    "parts_halfpel": (96, 64, "histeq", ChromaPolicy.PASSTHROUGH,
                      dict(search=2, subpel=1, parts=True)),
    "gdr3_deblock": (96, 64, "none", ChromaPolicy.PASSTHROUGH,
                     dict(gdr=3, deblock=True)),
}


def encoder_kwargs(opts):
    """``CudaGopEncoder`` / ``TpuGopEncoder`` keywords for a step's
    options."""
    kw = {k: opts[k] for k in ("search", "refs", "deblock", "gdr", "parts") if k in opts}
    kw.update({("halfpel", "quarterpel", "fastsub")[opts["subpel"] - 1]: True}
              if opts.get("subpel") else {})
    if opts.get("bitpack"):
        kw.update(bitpack=True, nw_mb=opts["bitpack"])
    return kw


@pytest.fixture(scope="module")
def gop_runs():
    runs = {}

    def run(name):
        if name not in runs:
            w, h, op, chroma, opts = GOP_CASES[name]
            cfg, jax_cfg = configs(op, chroma)
            spec = FrameSpec(width=w, height=h, fps=30)
            frames = frames_for(w, h, 6, seed=h)
            enc = CudaGopEncoder(w, h, qp=QP, gop=GOP, device="cpu",
                                 **encoder_kwargs(opts))
            fn = fused_encode.build_enhance_gop_fn(cfg, spec, enc.gop, device="cpu",
                                                   **opts)
            jax_fn = jax_fused.build_enhance_gop_fn(
                jax_cfg, JaxSpec(width=w, height=h, fps=30), enc.gop, **opts)
            jax_frames = jax_input(op, cfg, spec, frames)
            rec, jax_rec = enc.initial_recon(), enc.initial_recon()
            jax_rec = [jnp.asarray(t.numpy()) for t in jax_rec]
            out = []
            for lo, hi in BATCHES:
                packed, *rec = fn(frames[lo:hi], QP, lo, *rec)
                jax_packed, *jax_rec = jax_fn(jax_frames[lo:hi], jnp.int32(QP), lo,
                                              *jax_rec)
                out.append((packed.numpy(), [t.numpy() for t in rec],
                            np.asarray(jax_packed), [np.asarray(t) for t in jax_rec]))
            runs[name] = (out, enhanced(cfg, spec, frames))
        return runs[name]

    return run


def gop_lanes(opts):
    base = ((423 if opts.get("refs", 1) > 1 else 419) if opts.get("parts")
            else 413 if opts.get("refs", 1) > 1 else 412 if opts.get("search") else 410)
    return base + (1 + 2 * opts["bitpack"] if opts.get("bitpack") else 0)


@pytest.mark.parametrize("name", list(GOP_CASES))
def test_gop_packed_and_recon_equal_jax(name, gop_runs):
    out, _ = gop_runs(name)
    w, h, _, _, opts = GOP_CASES[name]
    for packed, rec, jax_packed, jax_rec in out:
        assert packed.dtype == np.int16
        assert packed.shape == (3, -(-h // 16), -(-w // 16), gop_lanes(opts))
        np.testing.assert_array_equal(packed, jax_packed)
        assert len(rec) == len(jax_rec) == 3 * opts.get("refs", 1)
        for a, b in zip(rec, jax_rec):
            np.testing.assert_array_equal(a, b)
    modes = np.concatenate([o[0][:, 0, 0, 409] for o in out])
    # the IDR marker (-1 DC / -2 HORIZONTAL) on the GOP's first frames
    idr = np.arange(6) % (1 << 30 if opts.get("gdr") else GOP) == 0
    assert ((modes < 0) == idr).all()
    if opts.get("search"):
        # the MV lanes carry motion on the panning half
        assert np.concatenate([o[0][1:, ..., 410:412] for o in out]).any()


@pytest.mark.parametrize("name", list(GOP_CASES))
def test_gop_aus_equal_jax_and_unfused(name, gop_runs):
    out, enh = gop_runs(name)
    w, h, _, _, opts = GOP_CASES[name]
    kw = encoder_kwargs(opts)
    port = CudaGopEncoder(w, h, qp=QP, gop=GOP, device="cpu", **kw)
    jax_enc = TpuGopEncoder(w, h, qp=QP, gop=GOP, **kw)
    packed = np.concatenate([o[0] for o in out])
    aus = [au for p in packed for au in port.encode_from_packed(p)]
    assert aus == [au for p in packed for au in jax_enc.encode_from_packed(p)]
    unfused = CudaGopEncoder(w, h, qp=QP, gop=GOP, device="cpu", **kw)
    assert aus == [au for f in enh for au in unfused.encode(f)]
    # a frame with an MB over the cap went through the entropy path
    base = gop_lanes({**opts, "bitpack": 0})
    over = (int((packed[..., base] > 32 * opts["bitpack"]).any(axis=(1, 2)).sum())
            if opts.get("bitpack") else 0)
    assert port._bits_overflows == unfused._bits_overflows == over


# ----------------------------------------------------- smaller contracts ----

REFUSALS = [
    ("levels", dict(use_ref_frame=True), {}),
    ("gop", dict(use_ref_frame=True), dict(gop=4)),
    ("gop", {}, dict(gop=1)),
    ("gop", {}, dict(gop=4, refs=3, search=2)),
    ("gop", {}, dict(gop=4, refs=2)),
    ("gop", {}, dict(gop=4, gdr=3, refs=2, search=2)),
    ("gop", {}, dict(gop=4, parts=True)),
    ("gop", {}, dict(gop=4, parts=True, search=2, subpel=3)),
    ("gop", {}, dict(gop=4, parts=True, search=2, gdr=3)),
    ("gop", {}, dict(gop=4, parts=True, search=8, subpel=2, refs=2)),
]


@pytest.mark.parametrize("kind,cfg_kw,kw", REFUSALS,
                         ids=[f"{k}-{sorted({**c, **o}.items())}" for k, c, o in REFUSALS])
def test_refusals_are_the_jax_ones(kind, cfg_kw, kw):
    spec, jax_spec = FrameSpec(width=96, height=64), JaxSpec(width=96, height=64)
    name = "build_enhance_levels_fn" if kind == "levels" else "build_enhance_gop_fn"
    with pytest.raises(ValueError) as got:
        getattr(fused_encode, name)(EnhancerConfig(op="clahe", **cfg_kw), spec,
                                    device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        getattr(jax_fused, name)(JaxConfig(op="clahe", **cfg_kw), jax_spec, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("lanes", [409, 411, 420])
def test_encode_from_packed_refuses_a_bad_lane_count_as_jax(lanes):
    packed = np.zeros((4, 6, lanes), np.int16)
    with pytest.raises(ValueError) as got:
        CudaGopEncoder(96, 64, gop=GOP, device="cpu").encode_from_packed(packed)
    with pytest.raises(ValueError) as want:
        TpuGopEncoder(96, 64, gop=GOP).encode_from_packed(packed)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("refs", [1, 2])
def test_initial_recon_is_zero_planes_on_the_encoders_device(refs):
    enc = CudaGopEncoder(100, 56, gop=GOP, search=2, refs=refs, device="cpu")
    rec = enc.initial_recon()
    want = TpuGopEncoder(100, 56, gop=GOP, search=2, refs=refs).initial_recon()
    assert [tuple(t.shape) for t in rec] == [a.shape for a in want] \
        == [(64, 112), (32, 56), (32, 56)] * refs
    assert all(t.device.type == "cpu" and t.dtype == torch.uint8
               and not t.any() for t in rec)


def test_the_step_factories_run_on_the_card_by_default():
    cfg, spec = EnhancerConfig(), FrameSpec(width=96, height=64)
    for build, args in ((fused_encode.build_enhance_levels_fn, ()),
                        (fused_encode.build_enhance_gop_fn, (GOP,))):
        if torch.cuda.is_available():
            assert callable(build(cfg, spec, *args))
        else:
            with pytest.raises(RuntimeError, match="runs on the card"):
                build(cfg, spec, *args)


def test_bits_lanes_are_the_jax_little_endian_halves():
    """uint32 words become (low, high) int16 halves in memory order after
    the bit-count lane, as the JAX ``_bits_lanes``; ``_split_bits_lanes``
    inverts it."""
    words = np.array([[[0x00000001, 0xFFFF8000, 0x12345678]],
                      [[0x80000000, 0x0000FFFF, 0xDEADBEEF]]], np.uint32)
    nbits = np.array([[70], [5]], np.int32)
    got = fused_encode._bits_lanes(torch.from_numpy(words.view(np.int32)).view(torch.uint32),
                                   torch.from_numpy(nbits)).numpy()
    want = np.asarray(jax_fused._bits_lanes(jnp.asarray(words), jnp.asarray(nbits)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].tolist() == [70, 1, 0, -32768, -1, 0x5678, 0x1234]
    back_words, back_nbits = _split_bits_lanes(got)
    np.testing.assert_array_equal(back_words, words)
    np.testing.assert_array_equal(back_nbits, nbits)


def test_write_packed_ships_the_au_and_returns_its_bytes():
    w, h = 96, 64
    spec = FrameSpec(width=w, height=h, fps=30)
    frames = frames_for(w, h, 2, seed=5)
    packed = fused_encode.build_enhance_levels_fn(EnhancerConfig(), spec,
                                                  device="cpu")(frames, QP).numpy()
    shipped = []
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as catcher:
        catcher.bind(("127.0.0.1", 0))
        sink = EncodedRtpSink(CudaCavlcEncoder(w, h, qp=QP, device="cpu"), "127.0.0.1",
                              catcher.getsockname()[1], au_tap=shipped.append)
        try:
            sizes = [sink.write_packed(p) for p in packed]
        finally:
            sink.close()
    assert sink.aus_sent == 2 and sizes == [len(au) for au in shipped]
    ref = CudaCavlcEncoder(w, h, qp=QP, device="cpu")
    assert shipped == [au for f in frames for au in ref.encode(np.concatenate(
        [golden.equalize_hist(f[:h]), np.full_like(f[h:], 128)]))]
