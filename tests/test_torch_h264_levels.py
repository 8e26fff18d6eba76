"""The port's intra device encoder against the JAX package's.

``ops/h264_levels.encode_levels`` (on the CPU its plain version, which the
kernel ``intra_levels_kernel`` is held to on the card) against the JAX
``encode_levels`` on seed-made NV12 planes (32x32 to 96x64, one MB row and
one MB column): the levels, the modes and the reconstructed planes, for
the default, ``full_recon``, ``chromah`` and ``i4``.  The JAX function is
compiled once a shape and option set (its QP is traced); the Intra_4x4
program, ~30 s to compile on the CPU, once, for two inputs of one shape.
``CudaCavlcEncoder`` on ``device="cpu"`` against ``CavlcH264Encoder
(slices=mb_h)`` (the JAX tests' ``TestLevelsParity``,
``TestTpuCavlcEncoder`` and ``TestIntraHorizontal``): the same access
units across QPs, rate control, ``overlap`` one frame late, both native
modes.  ``make_encoder`` over every ``tpu`` option the JAX factory parses.
Every comparison is exact (integer levels and bytes: tolerance 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.io import encoder as jax_encoder
from opencv_opencl_tpu.io import h264_cavlc as jax_cavlc
from opencv_opencl_tpu.io import h264_inter as jax_inter
from opencv_opencl_tpu.ops import h264_levels as jax_levels
from opencv_opencl_tpu_torch import native
from opencv_opencl_tpu_torch.io import encoder, h264_cavlc, h264_inter
from opencv_opencl_tpu_torch.ops import h264_levels
from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kernel


def nv12(w, h, seed, kind="smooth"):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
    if kind == "black":
        return np.zeros((h * 3 // 2, w), np.uint8)
    if kind == "ramp":      # rows constant: HORIZONTAL prediction wins
        y = np.repeat(np.linspace(20, 235, h).astype(np.uint8)[:, None], w, 1)
        uv = np.repeat(np.linspace(60, 190, h // 2).astype(np.uint8)[:, None], w, 1)
        return np.concatenate([y, uv], 0)
    if kind == "checker":
        f = np.full((h * 3 // 2, w), 128, np.uint8)
        f[:h][(np.add.outer(np.arange(h), np.arange(w)) & 1) == 0] = 255
        f[:h][(np.add.outer(np.arange(h), np.arange(w)) & 1) == 1] = 0
        return f
    gx = np.linspace(0, 255, w)[None, :]
    gy = np.linspace(0, 80, h)[:, None]
    y = np.clip(gx + gy + rng.normal(0, 12, (h, w)), 0, 255)
    uv = np.clip(128 + rng.normal(0, 12, (h // 2, w)), 0, 255)
    return np.concatenate([y, uv], 0).astype(np.uint8)


def planes(frame, h):
    w = frame.shape[1]
    uv = frame[h:].reshape(h // 2, w // 2, 2)
    return frame[:h], np.ascontiguousarray(uv[:, :, 0]), np.ascontiguousarray(uv[:, :, 1])


def flat(out):
    """Every array of an encode_levels result, in order, as numpy."""
    arrays = []
    for o in out:
        arrays += [np.asarray(a) for a in o] if isinstance(o, tuple) else [np.asarray(o)]
    return arrays


def assert_same(got, want):
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@functools.lru_cache(maxsize=None)
def jax_fn(**flags):
    """The JAX function jitted once an option set (qp is traced)."""
    return jax.jit(functools.partial(jax_levels.encode_levels, **flags))


def both(frame, h, qp, **flags):
    y, cb, cr = planes(frame, h)
    want = jax_fn(**flags)(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jnp.int32(qp))
    got = h264_levels.encode_levels(torch.from_numpy(y), torch.from_numpy(cb),
                                    torch.from_numpy(cr), qp, **flags)
    return got, want


# ------------------------------------------------------ the levels ----


@pytest.mark.parametrize("flags", [{}, {"full_recon": True}, {"chromah": True}],
                         ids=["default", "full_recon", "chromah"])
@pytest.mark.parametrize("qp,kind", [(0, "random"), (0, "black"), (18, "smooth"),
                                     (28, "ramp"), (37, "checker"), (51, "random")])
def test_levels_equal_jax(flags, qp, kind):
    frame = nv12(64, 48, qp, kind)
    assert_same(*both(frame, 48, qp, **flags))


@pytest.mark.parametrize("w,h", [(96, 16), (16, 64)], ids=["one_mb_row", "one_mb_column"])
def test_levels_equal_jax_on_one_row_and_one_column(w, h):
    frame = nv12(w, h, 3)
    assert_same(*both(frame, h, 26, full_recon=True, chromah=True))


@pytest.mark.parametrize("qp,kind", [(24, "smooth"), (0, "random")])
def test_i4_levels_equal_jax(qp, kind):
    """Intra_4x4 with the full reconstruction, one JAX program for both."""
    frame = nv12(64, 48, qp + 1, kind)
    assert_same(*both(frame, 48, qp, i4=True, full_recon=True))


@pytest.mark.parametrize("qp,kind", [(24, "smooth"), (8, "random"), (30, "ramp")])
def test_i4_chromah_stream_equals_the_host_oracle(qp, kind):
    """i4 + chromah levels, entropy-coded, give the port's
    ``CavlcH264Encoder(slices=mb_h, i4=True, chromah=True)`` slices (held
    to the JAX package's in ``tests/test_torch_h264.py``)."""
    w, h = 48, 32
    frame = nv12(w, h, qp, kind)
    y, cb, cr = (torch.from_numpy(p) for p in planes(frame, h))
    lv, imode, i4modes, cmode = h264_levels.encode_levels(y, cb, cr, qp, i4=True,
                                                          chromah=True)
    got = h264_cavlc.encode_frame_from_levels(
        *(a.numpy() for a in lv), qp, idr_pic_id=1, imode=imode.numpy(),
        i4modes=i4modes.numpy(), cmode=cmode.numpy())
    want = h264_cavlc.encode_frame_cavlc_slices(frame, w, h, qp, idr_pic_id=1,
                                                slices=h // 16, i4=True, chromah=True)
    assert got == [bytes(n) for n in want]
    assert (imode.numpy() == 0).any() or kind == "ramp"


def test_full_recon_equals_the_host_oracle_recon():
    w, h, qp = 64, 48, 22
    frame = nv12(w, h, 5)
    y, cb, cr = (torch.from_numpy(p) for p in planes(frame, h))
    _, ry, rcb, rcr, _ = h264_levels.encode_levels(y, cb, cr, qp, full_recon=True)
    _, recon = h264_cavlc.encode_frame_cavlc_slices(frame, w, h, qp, slices=h // 16,
                                                    return_recon=True)
    for got, want in zip((ry, rcb, rcr), recon):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def test_encode_levels_nv12_and_the_plan_equal_jax():
    w, h, qp = 64, 32, 33
    frame = nv12(w, h, 9)
    got = h264_levels.encode_levels_nv12(frame, w, h, qp, device="cpu")
    want = jax_levels.encode_levels_nv12(frame, w, h, qp)
    assert_same(got, want)
    for q in (0, 17, 29, 30, 51):
        plan = h264_levels.level_plan(q)
        assert plan["qpc"] == int(jax_levels._QPC_TAB[q])
        assert plan["mf_y"] == [int(x) for x in jax_levels._MF_TAB[q % 6]]
        assert kernel.plan_words(q).tolist() == [
            plan["qp"], plan["qpc"], plan["qbits"], plan["qbits_c"], plan["f_y"],
            plan["f_c"], *plan["mf_y"], *plan["mf_c"], *plan["v_y"], *plan["v_c"]]
    with pytest.raises(ValueError, match="qp must be 0..51"):
        h264_levels.level_plan(52)


def test_pack_levels_round_trip_equals_jax():
    w, h, qp = 48, 32, 27
    frame = nv12(w, h, 4)
    y, cb, cr = planes(frame, h)
    lv, _ = h264_levels.encode_levels(*(torch.from_numpy(p) for p in (y, cb, cr)), qp)
    packed = h264_levels.pack_levels(lv, qp)
    jlv, _ = jax_fn()(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jnp.int32(qp))
    jpacked = np.asarray(jax_levels.pack_levels(jlv, jnp.int32(qp)))
    assert packed.shape == (2, 3, h264_levels.PACKED_LANES) == jpacked.shape
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    back, back_qp = h264_levels.unpack_levels_host(packed.numpy())
    jback, jqp = jax_levels.unpack_levels_host(jpacked)
    assert back_qp == jqp == qp
    for a, b, c in zip(back, lv, jback):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="410 lanes"):
        h264_levels.unpack_levels_host(np.zeros((2, 3, 410), np.int16))


def test_level_buffer_layout_is_the_kernels():
    """The segments the launcher in ``csrc/h264_levels.cu`` writes: zdc,
    acz, czdc, cacz and imode at 0, 16n, 272n, 280n, 408n; i4modes at 409n;
    cmode at 425n with i4, 409n without (n MBs)."""
    n = 3 * 5
    offs = {name: off for name, _, off in kernel.level_layout(3, 5, True, True)}
    assert offs == {"zdc": 0, "acz": 16 * n, "czdc": 272 * n, "cacz": 280 * n,
                    "imode": 408 * n, "i4modes": 409 * n, "cmode": 425 * n}
    assert kernel.level_layout(3, 5, False, True)[-1][2] == 409 * n
    assert kernel.level_words(3, 5) == 409 * n
    assert kernel.level_words(3, 5, True, True) == 426 * n
    buf = np.arange(kernel.level_words(3, 5, True, False))
    parts = kernel.split_levels(buf, 3, 5, i4=True)
    assert parts["acz"].shape == (3, 5, 16, 16) and parts["i4modes"][0, 0, 0] == 409 * n


def test_the_wrapper_takes_the_plain_version_on_the_cpu_only():
    """On CPU planes the plain version runs and no launch is counted; the
    launcher refuses CPU planes and nothing falls back; a card that is not
    there is not replaced by the CPU."""
    w, h = 32, 32
    y, cb, cr = (torch.from_numpy(p) for p in planes(nv12(w, h, 2), h))
    kernel.reset_launch_counts()
    assert_same(kernel.encode_levels(y, cb, cr, 20, chromah=True),
                h264_levels.encode_levels_plain(y, cb, cr, 20, chromah=True))
    assert kernel.launch_counts() == {"encode_levels": 0, "encode_p_levels": 0,
                                      "encode_levels_i4": 0}
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.intra_levels(y, cb, cr, 20, torch.empty(kernel.level_words(2, 2),
                                                        dtype=torch.int16))
    with pytest.raises(ValueError, match="16-aligned"):
        h264_levels.encode_levels(y[:24], cb[:12], cr[:12], 20)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            h264_levels.encode_levels_nv12(nv12(w, h, 2), w, h, 20)
        with pytest.raises(RuntimeError, match="is_available"):
            h264_cavlc.CudaCavlcEncoder(w, h)


# ------------------------------------------------------- the encoder ----


def oracle(w, h, **kw):
    return h264_cavlc.CavlcH264Encoder(w, h, slices=-(-h // 16), native="never", **kw)


def cuda_cpu(w, h, **kw):
    return h264_cavlc.CudaCavlcEncoder(w, h, device="cpu", **kw)


@pytest.mark.parametrize("qp", [0, 7, 18, 28, 37, 46, 51])
def test_encoder_access_units_equal_the_host_oracle_across_qp(qp):
    w, h = 96, 64
    f = nv12(w, h, qp)
    assert cuda_cpu(w, h, qp=qp).encode(f) == oracle(w, h, qp=qp).encode(f)


@pytest.mark.parametrize("kind,w,h,qp", [
    ("random", 64, 48, 24), ("black", 64, 48, 0), ("checker", 64, 48, 8),
    ("smooth", 190, 106, 27), ("smooth", 256, 16, 26), ("smooth", 16, 128, 26)],
    ids=["random", "black_qp0_clamp", "checker", "cropped", "one_mb_row",
         "one_mb_column"])
def test_encoder_access_units_equal_the_host_oracle(kind, w, h, qp):
    enc, ref = cuda_cpu(w, h, qp=qp), oracle(w, h, qp=qp)
    for seed in range(2):
        f = nv12(w, h, seed + 7, kind)
        assert enc.encode(f) == ref.encode(f)


@pytest.mark.parametrize("kw", [{"i4": True}, {"chromah": True},
                                {"i4": True, "chromah": True, "deblock": True}],
                         ids=["i4", "chromah", "i4_chromah_deblock"])
def test_encoder_options_equal_the_host_oracle(kw):
    w, h = 48, 32
    enc, ref = cuda_cpu(w, h, qp=26, **kw), oracle(w, h, qp=26, **kw)
    for seed, kind in ((1, "smooth"), (2, "ramp")):
        f = nv12(w, h, seed, kind)
        assert enc.encode(f) == ref.encode(f)


def test_horizontal_mode_is_chosen_on_a_vertical_ramp():
    w, h = 96, 64
    f = nv12(w, h, 0, "ramp")
    y, cb, cr = (torch.from_numpy(p) for p in planes(f, h))
    _, imode = h264_levels.encode_levels(y, cb, cr, 28)
    assert (imode.numpy() == 1).any()
    assert cuda_cpu(w, h, qp=26).encode(f) == oracle(w, h, qp=26).encode(f)


def test_rate_control_is_inherited():
    w, h = 64, 48
    enc = cuda_cpu(w, h, bitrate_kbps=50, fps=30.0)
    ref = oracle(w, h, bitrate_kbps=50, fps=30.0)
    qp0 = enc.qp
    for seed in range(3):
        f = nv12(w, h, seed, "random")
        assert enc.encode(f) == ref.encode(f)
        assert enc.qp == ref.qp
    assert enc.qp > qp0


def test_overlap_gives_the_same_stream_one_frame_late():
    w, h = 96, 64
    frames = [nv12(w, h, s) for s in range(4)]
    sync = cuda_cpu(w, h, qp=26)
    want = [au for f in frames for au in sync.encode(f)]
    pipe = cuda_cpu(w, h, qp=26, overlap=True)
    assert pipe.encode(frames[0]) == []
    got = [au for f in frames[1:] for au in pipe.encode(f)]
    got += pipe.flush()
    assert got == want
    assert pipe.flush() == []


def test_overlap_rate_control_lags_one_frame():
    w, h = 64, 48
    enc = cuda_cpu(w, h, bitrate_kbps=50, fps=30.0, overlap=True)
    qp0 = enc.qp
    enc.encode(nv12(w, h, 0, "random"))
    assert enc.qp == qp0
    enc.encode(nv12(w, h, 1, "random"))
    assert enc.qp > qp0


def test_native_require_equals_never():
    if not (native.available() and native.has_cavlc()):
        pytest.skip(f"native runtime unavailable: {native.build_error()}")
    w, h = 64, 48
    for kw in ({}, {"i4": True, "chromah": True}):
        fast = cuda_cpu(w, h, qp=20, native="require", **kw)
        slow = cuda_cpu(w, h, qp=20, native="never", **kw)
        assert fast._native and not slow._native
        for seed in range(2):
            f = nv12(w, h, seed, "random")
            assert fast.encode(f) == slow.encode(f)


# --------------------------------------------------------- the factory ----

# every option the JAX factory parses for tpu, at 64x48 (3 MB rows); the
# intra specs stream the access units of the cavlc spec with one slice a MB
# row
TPU_SPECS = [
    "tpu", "tpu:qp=0", "tpu:qp=51", "tpu:qp=28:deblock", "tpu:qp=24:i4",
    "tpu:qp=24:chromah", "tpu:qp=24:i4:chromah:overlap", "tpu:qp=30:overlap",
    "tpu:cpb=500", "tpu:cpb=500:initdelay=200", "tpu:qp=28:gop=1",
    "tpu:qp=28:gop=4", "tpu:gop=3:search=2:halfpel", "tpu:qp=28:gdr=3",
    "tpu:qp=28:bitpack", "tpu:qp=28:gop=4:bitpack", "tpu:qp=30:search=2",
    "tpu:qp=30:halfpel", "tpu:qp=30:cpb=500", "tpu:gdr=3:gop=8",
    "tpu:initdelay=100", "tpu:qp=52", "tpu:qp=x", "tpu:gop=0", "tpu:gdr=0",
    "tpu:cpb=x", "tpu:bogus", "tpu:qp", "tpu:overlap:cpb=500",
]


def outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return type(e).__name__, str(e)


@pytest.mark.parametrize("spec", TPU_SPECS)
def test_make_encoder_tpu_specs_as_jax(spec):
    """The port's classes for the JAX package's TpuCavlcEncoder and
    TpuGopEncoder (the same options, the bit packer's included, and the host
    oracle's access units), and its ValueError elsewhere."""
    ours = outcome(lambda: encoder.make_encoder(spec, 64, 48, fps=30.0,
                                                bitrate_kbps=300, device="cpu"))
    theirs = outcome(lambda: jax_encoder.make_encoder(spec, 64, 48, fps=30.0,
                                                      bitrate_kbps=300))
    if isinstance(theirs, jax_cavlc.TpuCavlcEncoder):
        assert isinstance(ours, h264_cavlc.CudaCavlcEncoder)
        keys = ("qp", "i4", "chromah", "deblock", "_overlap", "_bitpack", "_nw_mb")
        assert [getattr(ours, k) for k in keys] == [getattr(theirs, k) for k in keys]
        cavlc = ":".join(["cavlc", "slices=3"] + [o for o in spec.split(":")[1:]
                                                  if o not in ("overlap", "bitpack")])
        frames = [nv12(64, 48, s, "random" if s % 2 else "smooth") for s in range(3)]
        ref = jax_encoder.make_encoder(cavlc, 64, 48, fps=30.0, bitrate_kbps=300)
        got = [au for f in frames for au in ours.encode(f)] + ours.flush()
        assert got == [au for f in frames for au in ref.encode(f)] + ref.flush()
    elif isinstance(theirs, jax_inter.TpuGopEncoder):
        assert isinstance(ours, h264_inter.CudaGopEncoder)
        keys = ("qp", "gop", "gdr", "search", "subpel", "refs", "deblock", "_overlap",
                "parts", "_bitpack", "_nw_mb")
        assert [getattr(ours, k) for k in keys] == [getattr(theirs, k) for k in keys]
        cavlc = ":".join(["cavlc", "slices=3"] + [o for o in spec.split(":")[1:]
                                                  if o != "bitpack"])
        frames = [nv12(64, 48, s, "random" if s % 2 else "smooth") for s in range(3)]
        ref = jax_encoder.make_encoder(cavlc, 64, 48, fps=30.0, bitrate_kbps=300)
        got = [au for f in frames for au in ours.encode(f)] + ours.flush()
        assert got == [au for f in frames for au in ref.encode(f)] + ref.flush()
    else:
        assert isinstance(theirs, tuple), f"no counterpart for {theirs!r}"
        assert ours == theirs and ours[0] == "ValueError"


def test_make_encoder_tpu_is_h264_only_as_jax():
    got = outcome(lambda: encoder.make_encoder("tpu", 64, 48, codec="h265"))
    assert got == outcome(lambda: jax_encoder.make_encoder("tpu", 64, 48, codec="h265"))
    assert got == ("ValueError", "the TPU CAVLC encoder is h264-only")


def test_sink_factory_passes_the_device_on():
    sink = encoder.encoded_rtp_sink_from_url("rtp+h264://127.0.0.1:9", 64, 48,
                                             backend="tpu:qp=30", device="cpu")
    try:
        assert isinstance(sink.encoder, h264_cavlc.CudaCavlcEncoder)
        assert sink.encoder.device == torch.device("cpu")
    finally:
        sink.close()
