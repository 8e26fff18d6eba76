"""The port's host H.264 encoders against the JAX package's.

The port copies ``io/h264_pcm.py``, ``io/h264_hrd.py``, ``io/h264_cavlc.py``
(up to ``CavlcH264Encoder``), ``io/h264_deblock.py`` and ``io/h264_inter.py``
(``CudaGopEncoder`` in place of ``TpuGopEncoder``, held to the host oracle in
``tests/test_torch_gop_encoder.py``).  Each case runs a JAX function and the port's
copy on the same seed-made NV12 frames (32x32 to 64x48, one cropped
geometry) and asks for the same bytes, the same arrays or the same error
(tolerance 0):

- every option ``make_encoder`` parses for ``pcm`` and ``cavlc`` (slices,
  qp, rate control, deblock, cpb/initdelay, i4, chromah, gop, search,
  halfpel, quarterpel, fastsub, parts, refs, gdr) streams the same access
  units, and the refusals raise the same ``ValueError``;
- ``PcmH264Encoder`` and ``CavlcH264Encoder`` with ``native="require"``
  (the port's C++ library) equal ``native="never"`` (the Python oracle)
  and the JAX package's oracle;
- the pieces under the encoders: parameter sets and SEI, the intra and P
  entropy coders from levels, motion search and its planes, the in-loop
  filter and the CPB model.

The relays and the RTP side are in ``tests/test_torch_encoders.py``.
"""

import numpy as np
import pytest
import torch

from opencv_opencl_tpu.io import encoder as jax_encoder
from opencv_opencl_tpu.io import h264_cavlc as jax_cavlc
from opencv_opencl_tpu.io import h264_deblock as jax_deblock
from opencv_opencl_tpu.io import h264_hrd as jax_hrd
from opencv_opencl_tpu.io import h264_inter as jax_inter
from opencv_opencl_tpu.io import h264_pcm as jax_pcm
from opencv_opencl_tpu_torch import native
from opencv_opencl_tpu_torch.io import (
    encoder, h264_cavlc, h264_deblock, h264_hrd, h264_inter, h264_pcm)


def moving_frames(w, h, n, seed=0, step=2):
    """A smooth gradient, a square moving ``step`` px a frame, a chroma
    patch moving with it and seeded noise: content on which the GOP
    encoders choose skip, inter and intra macroblocks."""
    rng = np.random.default_rng(seed)
    gx = np.linspace(0, 200, w)[None, :]
    gy = np.linspace(0, 55, h)[:, None]
    out = []
    for i in range(n):
        y = gx + gy
        y0, x0 = 4 + step * i, 6 + step * i
        y[y0:y0 + 12, x0:x0 + 12] += 40
        uv = np.full((h // 2, w), 128.0)
        uv[2:8, 8 + step * i:20 + step * i] += 25
        f = np.concatenate([y, uv], 0) + rng.normal(0, 2, (h * 3 // 2, w))
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return out


def noise_frame(w, h, seed, fill=None):
    if fill is not None:
        return np.full((h * 3 // 2, w), fill, np.uint8)
    return np.random.default_rng(seed).integers(0, 256, (h * 3 // 2, w), np.uint8)


def outcome(fn):
    """``fn()``, or the type and message of what it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return type(e).__name__, str(e)


def stream(enc, frames):
    """The access units of ``frames`` and of the flush, and the QP the
    encoder ends on."""
    aus = [au for f in frames for au in enc.encode(f)]
    aus += enc.flush()
    enc.close()
    return aus, enc.qp if hasattr(enc, "qp") else None


# ------------------------------------------------- the encoder factory ----

# every option make_encoder parses for pcm and cavlc, at 64x48 (3 MB rows)
SPECS = [
    "pcm", "pcm:2", "pcm:3",
    "cavlc", "cavlc:qp=0", "cavlc:qp=51", "cavlc:qp=28:slices=2",
    "cavlc:qp=28:slices=3:deblock", "cavlc:qp=24:i4", "cavlc:qp=24:chromah",
    "cavlc:qp=24:i4:chromah:slices=3", "cavlc:cpb=500",
    "cavlc:cpb=500:initdelay=200",
    "cavlc:qp=28:gop=3", "cavlc:gop=3", "cavlc:qp=28:gop=3:deblock",
    "cavlc:qp=28:gop=3:slices=2", "cavlc:qp=28:gop=3:search=2",
    "cavlc:qp=28:gop=3:search=2:halfpel", "cavlc:qp=28:gop=3:search=2:quarterpel",
    "cavlc:qp=28:gop=3:search=2:fastsub", "cavlc:qp=28:gop=3:search=2:parts",
    "cavlc:qp=28:gop=3:search=2:refs=2:slices=3",
    "cavlc:qp=28:gop=4:search=2:parts:refs=2:deblock",
    "cavlc:qp=28:gop=3:search=2:halfpel:refs=2:slices=3",
    "cavlc:qp=26:gop=3:i4:chromah", "cavlc:gop=3:cpb=500:initdelay=200",
    "cavlc:qp=28:gdr=2", "cavlc:qp=28:gdr=2:search=2", "cavlc:gdr=2:deblock",
]


@pytest.mark.parametrize("spec", SPECS)
def test_make_encoder_streams_the_jax_access_units(spec):
    frames = moving_frames(64, 48, 5, seed=len(spec))
    ours = encoder.make_encoder(spec, 64, 48, fps=30.0, bitrate_kbps=300)
    theirs = jax_encoder.make_encoder(spec, 64, 48, fps=30.0, bitrate_kbps=300)
    assert type(ours).__name__ == type(theirs).__name__
    got, want = stream(ours, frames), stream(theirs, frames)
    assert got == want
    assert len(got[0]) == 5 and got[0][0].startswith(h264_pcm._START4)


@pytest.mark.parametrize("spec,w,h", [("cavlc:qp=30", 40, 24),
                                      ("cavlc:qp=30:gop=2:search=1", 40, 24),
                                      ("pcm:2", 34, 18)])
def test_cropped_geometry_streams_the_jax_access_units(spec, w, h):
    frames = moving_frames(w, h, 3, seed=w)
    got = stream(encoder.make_encoder(spec, w, h), frames)
    assert got == stream(jax_encoder.make_encoder(spec, w, h), frames)


REFUSALS = [
    "cavlc:qp=30:gdr=3:gop=8", "cavlc:initdelay=100", "cavlc:qp=30:search=2",
    "cavlc:qp=30:gop=8:halfpel", "cavlc:qp=30:gop=8:refs=2",
    "cavlc:qp=30:gop=8:search=2:fastsub:quarterpel", "cavlc:qp=52",
    "cavlc:qp=x", "cavlc:gop=0", "cavlc:gdr=0", "cavlc:slices=0",
    "cavlc:bogus", "cavlc:qp", "cavlc:qp=30:gop=4:search=16",
    "cavlc:qp=30:gop=4:search=2:refs=5:slices=3", "cavlc:cpb=0", "pcm:0",
    "pcm:x", "nope", "ffmpeg:x",
]


@pytest.mark.parametrize("spec", REFUSALS)
def test_make_encoder_refuses_as_jax(spec):
    got = outcome(lambda: encoder.make_encoder(spec, 64, 48, bitrate_kbps=400))
    want = outcome(lambda: jax_encoder.make_encoder(spec, 64, 48, bitrate_kbps=400))
    assert got[0] in ("ValueError", "RuntimeError") and got == want


@pytest.mark.parametrize("spec", ["pcm", "pcm:2", "cavlc:qp=30"])
def test_h265_is_refused_by_the_in_repo_encoders_as_jax(spec):
    got = outcome(lambda: encoder.make_encoder(spec, 64, 48, codec="h265"))
    assert got[0] == "ValueError" and "h264-only" in got[1]
    assert got == outcome(lambda: jax_encoder.make_encoder(spec, 64, 48,
                                                           codec="h265"))


@pytest.mark.parametrize("spec", ["tpu", "tpu:qp=30", "tpu:qp=30:gop=8:search=2"])
def test_the_device_encoders_run_on_the_card_unless_asked_for_the_cpu(spec):
    """The device encoders, intra and GOP, are ported and run on the card
    unless asked for the CPU: with no card and no device they raise, they
    never carry on on the CPU."""
    enc = encoder.make_encoder(spec, 64, 48, device="cpu")
    cls = h264_inter.CudaGopEncoder if "gop" in spec else h264_cavlc.CudaCavlcEncoder
    assert isinstance(enc, cls) and enc.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            encoder.make_encoder(spec, 64, 48)


# ----------------------------------------------- both native modes ----


@pytest.mark.parametrize("w,h,slices,threads,fill", [
    (64, 48, 1, 0, None), (34, 18, 2, 0, None), (48, 32, 2, 2, None),
    (48, 32, 3, 0, 0), (32, 32, 2, 0, 255)])
def test_pcm_encoder_native_modes_equal_the_jax_oracle(w, h, slices, threads, fill):
    if not native.available():
        pytest.skip(f"native runtime unavailable: {native.build_error()}")
    frames = [noise_frame(w, h, s, fill) for s in range(3)]
    got = {mode: stream(h264_pcm.PcmH264Encoder(w, h, slices=slices,
                                                threads=threads, native=mode),
                        frames) for mode in ("require", "never")}
    want = stream(jax_pcm.PcmH264Encoder(w, h, slices=slices, threads=threads,
                                         native="never"), frames)
    assert got["require"] == got["never"] == want
    assert h264_pcm.PcmH264Encoder(w, h, native="require")._native
    assert h264_pcm.encode_frame_pcm(frames[0], w, h, 1) == \
        jax_pcm.encode_frame_pcm(frames[0], w, h, 1)


@pytest.mark.parametrize("kw", [
    dict(qp=0), dict(qp=28), dict(qp=51), dict(qp=30, slices=3),
    dict(qp=26, slices=3, threads=2, deblock=True),
    dict(qp=30, bitrate_kbps=200, fps=30.0),
    dict(qp=30, bitrate_kbps=200, fps=30.0, cpb_ms=400, initial_delay_ms=150),
    dict(qp=24, i4=True), dict(qp=24, chromah=True, slices=2)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_cavlc_encoder_native_modes_equal_the_jax_oracle(kw):
    if not (native.available() and native.has_cavlc()):
        pytest.skip(f"native cavlc unavailable: {native.build_error()}")
    frames = moving_frames(48, 32, 3, seed=kw["qp"]) + [noise_frame(48, 32, 5)]
    ours = {mode: h264_cavlc.CavlcH264Encoder(48, 32, native=mode, **kw)
            for mode in ("require", "never")}
    assert ours["require"]._native and not ours["never"]._native
    got = {mode: stream(enc, frames) for mode, enc in ours.items()}
    want = stream(jax_cavlc.CavlcH264Encoder(48, 32, native="never", **kw), frames)
    assert got["require"] == got["never"] == want


def test_cavlc_encoder_refuses_as_jax():
    for kw in (dict(width=31), dict(slices=0), dict(initial_delay_ms=100),
               dict(cpb_ms=300)):
        args = {"width": 48, "height": 32, "qp": 30, **kw}
        got = outcome(lambda: h264_cavlc.CavlcH264Encoder(**args))
        assert got == outcome(lambda: jax_cavlc.CavlcH264Encoder(**args))
        assert got[0] == "ValueError"
    enc = h264_cavlc.CavlcH264Encoder(48, 32, native="never")
    got = outcome(lambda: enc.encode(np.zeros((40, 48), np.uint8)))
    jenc = jax_cavlc.CavlcH264Encoder(48, 32, native="never")
    assert got == outcome(lambda: jenc.encode(np.zeros((40, 48), np.uint8)))


# --------------------------------------------------- under the encoders ----


def test_parameter_sets_and_sei_equal_jax():
    hrd = (h264_hrd.HrdParams(800, 500, 200, 30.0), jax_hrd.HrdParams(800, 500, 200, 30.0))
    for w, h in ((64, 48), (40, 24), (1920, 1080), (3840, 2160)):
        assert h264_pcm.build_sps(w, h) == jax_pcm.build_sps(w, h)
        assert h264_pcm.build_sps(w, h, hrd[0]) == jax_pcm.build_sps(w, h, hrd[1])
        for refs in (1, 2, 4):
            assert (h264_inter.build_sps_gop(w, h, refs, hrd[0])
                    == jax_inter.build_sps_gop(w, h, refs, hrd[1]))
    assert h264_pcm.build_pps() == jax_pcm.build_pps()
    assert h264_cavlc.build_pps_cavlc() == jax_cavlc.build_pps_cavlc()
    for n in (0, 1, 7, 300):
        for exact in (True, False):
            assert (h264_inter.build_recovery_point_sei(n, exact)
                    == jax_inter.build_recovery_point_sei(n, exact))
    data = np.random.default_rng(3).integers(0, 4, 4000).astype(np.uint8)
    assert h264_pcm._escape(data) == jax_pcm._escape(data)


def _levels(rng, mb_h, mb_w, density=0.15):
    def sparse(*shape):
        v = rng.integers(-6, 7, shape)
        return np.where(rng.random(shape) < density, v, 0)

    acz = sparse(mb_h, mb_w, 16, 16)
    acz[..., 0] = 0                                  # the DC slot
    cacz = sparse(mb_h, mb_w, 2, 4, 16)
    cacz[..., 0] = 0
    return (sparse(mb_h, mb_w, 16), acz, sparse(mb_h, mb_w, 2, 4), cacz)


@pytest.mark.parametrize("form", ["plain", "i4_chromah_deblock"])
def test_intra_entropy_from_levels_equals_jax(form):
    rng = np.random.default_rng(21)
    lv = _levels(rng, 3, 4)
    kw = {}
    if form != "plain":
        kw = dict(imode=rng.integers(0, 3, (3, 4)), i4modes=rng.integers(0, 9, (3, 4, 16)),
                  cmode=rng.integers(0, 2, (3, 4)), deblock=True)
    got = h264_cavlc.encode_frame_from_levels(*lv, 28, 1, **kw)
    assert got == jax_cavlc.encode_frame_from_levels(*lv, 28, 1, **kw)
    assert len(got) == 3
    frame = noise_frame(64, 48, 9)
    for slices in (1, 3):
        assert (h264_cavlc.encode_frame_cavlc_slices(frame, 64, 48, 30, 1, slices=slices)
                == jax_cavlc.encode_frame_cavlc_slices(frame, 64, 48, 30, 1, slices=slices))
    assert (h264_cavlc.level_cost(*lv) == jax_cavlc.level_cost(*lv))


@pytest.mark.parametrize("case", ["zero_motion", "motion_refs_deblock", "partitions"])
def test_p_entropy_from_levels_equals_jax(case):
    rng = np.random.default_rng(31)
    mb_h, mb_w = 3, 4
    mode = rng.integers(0, 4, (mb_h, mb_w))
    lv = _levels(rng, mb_h, mb_w)
    kw = {}
    if case == "motion_refs_deblock":
        kw = dict(mv=rng.integers(-8, 9, (mb_h, mb_w, 2)),
                  ref=rng.integers(0, 2, (mb_h, mb_w)), active_refs=2,
                  deblock=True, slice_local=True)
    elif case == "partitions":
        kw = dict(pmode=rng.integers(0, 4, (mb_h, mb_w)),
                  mv=rng.integers(-6, 7, (mb_h, mb_w, 4, 2)),
                  ref=rng.integers(0, 2, (mb_h, mb_w, 4)), active_refs=2)
    got = h264_inter.encode_frame_p_from_levels(mode, *lv, 28, 3, **kw)
    assert got == jax_inter.encode_frame_p_from_levels(mode, *lv, 28, 3, **kw)
    assert len(got) == mb_h


@pytest.mark.parametrize("subpel", [0, 1, 2])
def test_motion_search_and_planes_equal_jax(subpel):
    cur, prev = moving_frames(64, 48, 2, seed=4 + subpel, step=3)
    y, ry = cur[:48].astype(np.int64), prev[:48].astype(np.int64)
    assert h264_inter.search_candidates(2) == jax_inter.search_candidates(2)
    assert (h264_inter.search_candidates_qpel(3, subpel)
            == jax_inter.search_candidates_qpel(3, subpel))
    margin = 6
    planes = {mod: (None if subpel == 0 else
                    (mod.halfpel_planes if subpel == 1 else mod.quarterpel_planes)(ry, margin))
              for mod in (h264_inter, jax_inter)}
    if subpel:
        assert np.array_equal(planes[h264_inter], planes[jax_inter])
    got = {mod: mod.motion_search(y, ry, 2, subpel=subpel, planes=planes[mod],
                                  margin=margin if subpel else 0)
           for mod in (h264_inter, jax_inter)}
    assert np.array_equal(got[h264_inter], got[jax_inter])
    parts = {mod: mod.motion_search_parts(y, ry, 2, subpel=subpel, planes=planes[mod],
                                          margin=margin if subpel else 0, qp=28)
             for mod in (h264_inter, jax_inter)}
    for a, b in zip(parts[h264_inter], parts[jax_inter]):
        assert np.array_equal(a, b)
    if subpel == 2:
        fast = [mod.motion_search_fast(y, ry, 2, planes=planes[mod], margin=margin)
                for mod in (h264_inter, jax_inter)]
        assert np.array_equal(*fast)
    ref = {"y": ry, "cb": prev[48:, 0::2].astype(np.int64),
           "cr": prev[48:, 1::2].astype(np.int64)}
    mc = [mod.mc_planes(ref, got[mod], planes=planes[mod], margin=margin if subpel else 0)
          for mod in (h264_inter, jax_inter)]
    assert mc[0].keys() == mc[1].keys()
    for k in mc[0]:
        assert np.array_equal(mc[0][k], mc[1][k])


@pytest.mark.parametrize("case", ["idr", "inter", "parts_slice_local"])
def test_deblock_picture_equals_jax(case):
    # smooth content with a step at each 4x4 block: edges the filter takes
    rng = np.random.default_rng(41)
    planes = tuple(
        (np.add.outer(np.arange(h), np.arange(w)) + 100
         + np.kron(rng.integers(-4, 5, (h // 4, w // 4)), np.ones((4, 4), int))
         + rng.integers(-1, 2, (h, w))).astype(np.int64)
        for h, w in ((48, 64), (24, 32), (24, 32)))
    infos = {}
    for mod in (h264_deblock, jax_deblock):
        r = np.random.default_rng(42)
        if case == "idr":
            infos[mod] = None
            continue
        info = mod.DeblockInfo(3, 4, parts=case != "inter")
        info.intra[:] = r.random((3, 4)) < 0.3
        info.nnz4[:] = r.random((12, 16)) < 0.4
        info.mv[:] = r.integers(-9, 10, info.mv.shape)
        info.ref[:] = r.integers(0, 2, info.ref.shape)
        infos[mod] = info
    local = case == "parts_slice_local"
    for qp in (18, 30, 45):
        got = h264_deblock.deblock_picture(*planes, qp, infos[h264_deblock],
                                           slice_local_rows=local)
        want = jax_deblock.deblock_picture(*planes, qp, infos[jax_deblock],
                                           slice_local_rows=local)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        assert any(not np.array_equal(a, p) for a, p in zip(got, planes))
    bad = (np.zeros((40, 64)), np.zeros((20, 32)), np.zeros((20, 32)))
    assert outcome(lambda: h264_deblock.deblock_picture(*bad, 30)) == \
        outcome(lambda: jax_deblock.deblock_picture(*bad, 30))


def test_cpb_model_equals_jax():
    sizes = np.random.default_rng(51).integers(1000, 60000, 40)
    models = [mod.CpbModel(800, 500, 200, 30.0) for mod in (h264_hrd, jax_hrd)]
    for bits in sizes:
        assert models[0].budget_bits() == models[1].budget_bits()
        assert models[0].add_frame(int(bits)) == models[1].add_frame(int(bits))
    assert (models[0].slack, models[0].violations) == (models[1].slack, models[1].violations)
    assert models[0].violations > 0
    for args in ((800, 0, 100, 30.0), (800, 100, 200, 30.0), (0, 500, 200, 30.0),
                 (800, 500, 200, 0.0)):
        assert outcome(lambda: vars(h264_hrd.HrdParams(*args))) == \
            outcome(lambda: vars(jax_hrd.HrdParams(*args)))
