"""The port's sub-16x16 partition modes (``parts``) on the CPU against the
JAX package's and the host oracle.

``ops/h264_levels.motion_search_parts`` (full-, half- and quarter-pel, one
and two references) equals the JAX ``motion_search_mc_parts`` exactly
(tolerance 0: partition modes, quadrant fields and prediction planes), on
seed-made frames of 96x64 (the frames of ``tests/test_torch_h264_inter.py``
and frames whose halves move apart, so that every partition mode occurs);
``encode_p_levels(parts=1)`` equals the JAX function's levels, modes,
fields and reconstruction; ``bs_grids`` with quadrant-granular fields equals
the JAX one.  Every JAX program is one module-scoped ``jax.jit`` a
configuration.  ``CudaGopEncoder(device="cpu", parts=True)`` streams equal
``GopCavlcEncoder(slices=mb_h, parts=True)``'s byte for byte in the cases of
``tests/test_h264_parts.py``'s ``TestTpuParity`` and ``TestPartsRefs2``
(with ``deblock`` and ``overlap`` too), and ``make_encoder`` parses and
refuses ``parts`` as the reference does.  On the CPU the wrappers run the
plain versions and count no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.ops import h264_deblock as jax_deblock
from opencv_opencl_tpu.ops import h264_levels as jax_levels
from opencv_opencl_tpu_torch.io import encoder
from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder, GopCavlcEncoder
from opencv_opencl_tpu_torch.ops import h264_deblock, h264_levels
from opencv_opencl_tpu_torch.ops.cuda import h264_inter as inter_kernels
from tests.test_h264_parts import shear_frames
from tests.test_torch_h264_inter import assert_equal, frames, t

H, W = 64, 96
QP = 30


def split_frames(seed: int, h: int = H, w: int = W):
    """A source made MB by MB from the reference at integer shifts of at
    most one pixel: the whole MB at one shift, its 16x8 halves, its 8x16
    halves or its quadrants at different ones, so that every partition
    mode wins somewhere; the second reference is the first moved by one
    pixel, so that both references win somewhere."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 8, w + 8)).astype(np.int32)
    base = ((base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3).astype(np.uint8)
    ry = base[4:4 + h, 4:4 + w].copy()
    y = np.empty_like(ry)
    for my in range(0, h, 16):
        for mx in range(0, w, 16):
            kind = (my // 16 + mx // 16) % 4
            for q in range(4):
                part = (0 if kind == 0 else q >> 1 if kind == 1 else q & 1 if kind == 2
                        else q)
                dy, dx = (part * 5 + seed) % 3 - 1, (part * 7 + my) % 3 - 1
                r, c = my + 8 * (q >> 1), mx + 8 * (q & 1)
                y[r:r + 8, c:c + 8] = base[4 + r + dy:12 + r + dy, 4 + c + dx:12 + c + dx]
    cb = rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(100, 150, (h // 2, w // 2)).astype(np.uint8)
    ry2 = base[3:3 + h, 5:5 + w].copy()
    return (y, cb, cr, (ry, np.roll(cb, 1, 1), np.roll(cr, -1, 1)),
            (ry2, np.roll(cb, (1, -1), (0, 1)), cr.copy()))


CONTENTS = {"shifted": frames, "split": split_frames}


@pytest.fixture(scope="module")
def jax_parts():
    """One program a (search, subpel, references) configuration, qp traced."""
    progs = {}

    def get(search, subpel, nrefs):
        key = (search, subpel, nrefs)
        if key not in progs:
            if nrefs == 1:
                progs[key] = jax.jit(lambda y, ry, rcb, rcr, qp: (
                    jax_levels.motion_search_mc_parts(y, ry, rcb, rcr, search, subpel, qp)))
            else:
                progs[key] = jax.jit(lambda y, ry, rcb, rcr, qp, a, b, c: (
                    jax_levels.motion_search_mc_parts(y, ry, rcb, rcr, search, subpel,
                                                      qp, refs2=(a, b, c))))
        return progs[key]
    return get


@pytest.mark.parametrize("search,subpel,nrefs", [
    (3, 0, 1), (2, 1, 1), (2, 2, 1), (2, 0, 2), (1, 2, 2),
], ids=["fullpel", "halfpel", "quarterpel", "refs2_fullpel", "refs2_quarterpel"])
@pytest.mark.parametrize("content", sorted(CONTENTS))
def test_motion_search_parts_equals_jax(jax_parts, content, search, subpel, nrefs):
    """pmode, mv4, ref4 and the three prediction planes at two QPs."""
    y, _, _, r1, r2 = CONTENTS[content](5)
    refs = [tuple(t(a) for a in r1)] + ([tuple(t(a) for a in r2)] if nrefs > 1 else [])
    prog = jax_parts(search, subpel, nrefs)
    modes = set()
    for qp in (QP, 45):
        got = h264_levels.motion_search_parts(t(y), refs, search, subpel, qp)
        args = [jnp.asarray(a) for a in (y, *r1)] + [jnp.int32(qp)]
        if nrefs > 1:
            args += [jnp.asarray(a) for a in r2]
        want = prog(*args)
        for name, g, w in zip(("pmode", "mv4", "ref4", "pred_y", "pred_cb", "pred_cr"),
                              got, want):
            if w is None:
                assert g is None, name
                continue
            assert_equal(g, w, f"{name} qp {qp}")
        assert got[0].dtype == torch.int16 and got[1].dtype == torch.int16
        modes |= set(np.unique(got[0].numpy()).tolist())
    if content == "split":
        assert modes == {0, 1, 2, 3}


def test_motion_search_parts_refusals():
    y, _, _, r1, r2 = frames(1)
    refs = [tuple(t(a) for a in r1), tuple(t(a) for a in r2)]
    with pytest.raises(ValueError, match="exceeds the key packing"):
        h264_levels.motion_search_parts(t(y), refs, 8, 2, QP)
    with pytest.raises(ValueError, match="fastsub"):
        h264_levels.motion_search_parts(t(y), refs[:1], 2, 3, QP)
    inter_kernels.reset_launch_counts()
    h264_levels.motion_search_parts(t(y), refs[:1], 1, 0, QP)
    assert inter_kernels.launch_counts()["motion_search_parts"] == 0


@pytest.fixture(scope="module")
def jax_p_parts():
    progs = {}

    def get(search, subpel, nrefs):
        key = (search, subpel, nrefs)
        if key not in progs:
            if nrefs == 1:
                progs[key] = jax.jit(lambda y, cb, cr, ry, rcb, rcr, qp: (
                    jax_levels.encode_p_levels(y, cb, cr, ry, rcb, rcr, qp, search,
                                               subpel, parts=1)))
            else:
                progs[key] = jax.jit(lambda y, cb, cr, ry, rcb, rcr, qp, a, b, c: (
                    jax_levels.encode_p_levels(y, cb, cr, ry, rcb, rcr, qp, search,
                                               subpel, ry2=a, rcb2=b, rcr2=c, parts=1)))
        return progs[key]
    return get


@pytest.mark.parametrize("search,subpel,nrefs", [
    (3, 0, 1), (2, 2, 1), (2, 1, 2),
], ids=["fullpel", "quarterpel", "refs2_halfpel"])
def test_encode_p_levels_parts_equals_jax(jax_p_parts, search, subpel, nrefs):
    y, cb, cr, r1, r2 = split_frames(7)
    prog = jax_p_parts(search, subpel, nrefs)
    for qp in (0, QP):
        args = [jnp.asarray(a) for a in (y, cb, cr, *r1)] + [jnp.int32(qp)]
        kw = {}
        if nrefs > 1:
            args += [jnp.asarray(a) for a in r2]
            kw = dict(ry2=t(r2[0]), rcb2=t(r2[1]), rcr2=t(r2[2]))
        want = prog(*args)
        got = h264_levels.encode_p_levels(t(y), t(cb), t(cr), *(t(a) for a in r1), qp,
                                          search, subpel, parts=1, **kw)
        for name in want._fields:
            w, g = getattr(want, name), getattr(got, name)
            if w is None:
                assert g is None, name
            else:
                assert_equal(g, w, f"{name} qp {qp}")
        assert got.pmode is not None and tuple(got.mv.shape[2:]) == (4, 2)


@pytest.mark.parametrize("kw,msg", [
    (dict(search=0, subpel=0), "parts requires search"),
    (dict(search=2, subpel=3), "parts does not compose with fastsub"),
    (dict(search=2, subpel=0, gdr_band=(0, 1)), "parts requires no gdr"),
], ids=["no_search", "fastsub", "gdr"])
def test_encode_p_levels_parts_refusals(kw, msg):
    y, cb, cr, r1, _ = frames(2)
    with pytest.raises(ValueError, match=msg):
        h264_levels.encode_p_levels(t(y), t(cb), t(cr), *(t(a) for a in r1), QP,
                                    parts=1, **kw)


@pytest.fixture(scope="module")
def jax_bs():
    return jax.jit(jax_deblock.bs_grids)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bs_grids_quadrant_fields_equal_jax(jax_bs, seed):
    rng = np.random.default_rng(seed)
    mb_h, mb_w = 4, 6
    intra = rng.random((mb_h, mb_w)) < 0.2
    nnz4 = rng.random((4 * mb_h, 4 * mb_w)) < 0.3
    mv = rng.integers(-6, 7, (2 * mb_h, 2 * mb_w, 2)).astype(np.int16)
    mv[rng.random((2 * mb_h, 2 * mb_w)) < 0.4] = 0
    ref = (rng.random((2 * mb_h, 2 * mb_w)) < 0.3).astype(np.int16)
    got = h264_deblock.bs_grids(t(intra), t(nnz4), t(mv), t(ref))
    want = jax_bs(*(jnp.asarray(a) for a in (intra, nnz4, mv, ref)))
    for g, w, name in zip(got, want, ("bs_v", "bs_h")):
        assert_equal(g, w, name)
    # the edges inside a partitioned MB carry their motion-driven bS
    assert (got[0][:, 2::4] == 1).any() or (got[1][2::4] == 1).any()


def test_deblock_planes_quadrant_fields_equal_jax():
    rng = np.random.default_rng(4)
    mb_h, mb_w = 3, 4
    y = rng.integers(60, 200, (16 * mb_h, 16 * mb_w)).astype(np.uint8)
    cb = rng.integers(80, 170, (8 * mb_h, 8 * mb_w)).astype(np.uint8)
    cr = rng.integers(80, 170, (8 * mb_h, 8 * mb_w)).astype(np.uint8)
    intra = rng.random((mb_h, mb_w)) < 0.2
    nnz4 = rng.random((4 * mb_h, 4 * mb_w)) < 0.3
    mv = rng.integers(-6, 7, (2 * mb_h, 2 * mb_w, 2)).astype(np.int32)
    ref = (rng.random((2 * mb_h, 2 * mb_w)) < 0.3).astype(np.int32)
    got = h264_deblock.deblock_planes(t(y), t(cb), t(cr), 36, t(intra), t(nnz4),
                                      t(mv), t(ref))
    want = jax_deblock.deblock_planes(*(jnp.asarray(a) for a in (y, cb, cr)),
                                      jnp.int32(36),
                                      *(jnp.asarray(a) for a in (intra, nnz4, mv, ref)))
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        assert_equal(g, w, name)


def encode_all(enc, frames_):
    return [au for f in frames_ for au in enc.encode(f)] + enc.flush()


def flicker_shear(n=6, w=128, h=96):
    """``tests/test_h264_parts.py``'s ``flicker_shear_frames``: the shear
    with every other frame brightened, so that two references matter."""
    from tests.test_h264_parts import flicker_shear_frames

    return flicker_shear_frames()[:n]


def fuzz_parts(seed, w=128, h=96):
    rng = np.random.default_rng(seed)
    qp = int(rng.integers(24, 44))
    out = []
    base = rng.integers(0, 256, (h, w), np.uint8)
    for _ in range(4):
        y = np.roll(base, int(rng.integers(-3, 4)), 1)
        y[40:56, 16:64] = rng.integers(0, 256, (16, 48), np.uint8)
        uv = rng.integers(0, 256, (h // 2, w), np.uint8)
        out.append(np.concatenate([y, uv], 0))
    return qp, out


# (id, width, height, frames, encoder options); TestTpuParity's and
# TestPartsRefs2's cases, cut to four frames, and their compositions
STREAMS = [
    ("fullpel", 128, 96, lambda: shear_frames(4), dict(qp=QP, gop=4, search=4)),
    ("halfpel", 128, 96, lambda: shear_frames(4), dict(qp=QP, gop=4, search=4, halfpel=True)),
    ("quarterpel", 128, 96, lambda: shear_frames(4),
     dict(qp=QP, gop=4, search=2, quarterpel=True)),
    ("nonaligned", 104, 56, lambda: shear_frames(4, w=104, h=56, split=24, step=2),
     dict(qp=QP, gop=4, search=2)),
    ("fuzz_1", 128, 96, lambda: fuzz_parts(1)[1], dict(qp=fuzz_parts(1)[0], gop=4, search=2)),
    ("fuzz_2", 128, 96, lambda: fuzz_parts(2)[1], dict(qp=fuzz_parts(2)[0], gop=4, search=2)),
    ("refs2_fullpel", 128, 96, lambda: flicker_shear(4),
     dict(qp=QP, gop=4, search=3, refs=2)),
    ("refs2_halfpel", 128, 96, lambda: flicker_shear(4),
     dict(qp=QP, gop=4, search=3, halfpel=True, refs=2)),
    ("refs2_quarterpel", 128, 96, lambda: flicker_shear(4),
     dict(qp=QP, gop=4, search=2, quarterpel=True, refs=2)),
    ("deblock", 128, 96, lambda: shear_frames(4), dict(qp=QP, gop=3, search=3, deblock=True)),
    ("deblock_refs2_quarterpel", 64, 48, lambda: [f[:72, :64] for f in flicker_shear(4)],
     dict(qp=QP, gop=4, search=1, quarterpel=True, refs=2, deblock=True)),
    ("i4_chromah_idr", 128, 96, lambda: shear_frames(4),
     dict(qp=QP, gop=2, search=2, i4=True, chromah=True)),
]


@pytest.mark.parametrize("w,h,make,kw", [c[1:] for c in STREAMS], ids=[c[0] for c in STREAMS])
def test_parts_stream_equals_the_host_oracle(w, h, make, kw):
    fs = make()
    mb_h = -(-h // 16)
    got = encode_all(CudaGopEncoder(w, h, device="cpu", parts=True, **kw), fs)
    want = encode_all(GopCavlcEncoder(w, h, slices=mb_h, parts=True, **kw), fs)
    assert len(got) == len(fs)
    assert got == want


def test_parts_overlap_shifts_by_one_frame_bytes_unchanged():
    fs = shear_frames(4)
    kw = dict(qp=QP, gop=4, search=4, parts=True, device="cpu")
    want = encode_all(CudaGopEncoder(128, 96, **kw), fs)
    pipe = CudaGopEncoder(128, 96, overlap=True, **kw)
    assert pipe.encode(fs[0]) == []
    got = [au for f in fs[1:] for au in pipe.encode(f)] + pipe.flush()
    assert got == want


@pytest.mark.parametrize("kw,msg", [
    (dict(parts=True), "parts requires search"),
    (dict(parts=True, search=2, fastsub=True), "parts does not compose with fastsub"),
    (dict(parts=True, search=2, gdr=3), "parts requires no gdr"),
    (dict(parts=True, search=8, quarterpel=True, refs=2), "needs search <= 7"),
    (dict(parts=True, search=2, cpb_ms=500, bitrate_kbps=400), "does not compose with cpb"),
], ids=["no_search", "fastsub", "gdr", "qpel_refs2_radius", "cpb"])
def test_parts_refusals_equal_the_reference(kw, msg):
    with pytest.raises(ValueError, match=msg):
        CudaGopEncoder(64, 48, device="cpu", **kw)


@pytest.mark.parametrize("spec,kind", [
    ("tpu:qp=30:gop=4:search=2:parts", dict(gop=4, search=2, subpel=0, parts=True)),
    ("tpu:gop=8:search=2:quarterpel:refs=2:parts:deblock",
     dict(gop=8, subpel=2, refs=2, parts=True, deblock=True)),
    ("tpu:gop=4:search=3:halfpel:parts:overlap", dict(gop=4, subpel=1, parts=True)),
], ids=["fullpel", "qpel_refs2_deblock", "halfpel_overlap"])
def test_factory_builds_parts(spec, kind):
    enc = encoder.make_encoder(spec, 64, 48, bitrate_kbps=400, device="cpu")
    assert type(enc) is CudaGopEncoder
    for key, value in kind.items():
        assert getattr(enc, key) == value, key
    fs = shear_frames(2, w=64, h=48, split=24)
    assert len([au for f in fs for au in enc.encode(f)] + enc.flush()) == 2


@pytest.mark.parametrize("spec,msg", [
    ("tpu:qp=30:parts", "gop=N option"),
    ("tpu:qp=30:gop=4:parts", "parts requires search"),
    ("tpu:gdr=3:search=2:parts", "parts requires no gdr"),
    ("tpu:gop=4:search=2:fastsub:parts", "parts does not compose with fastsub"),
], ids=["no_gop", "no_search", "gdr", "fastsub"])
def test_factory_refuses_parts_as_the_reference(spec, msg):
    from opencv_opencl_tpu.io.encoder import make_encoder as jax_make

    with pytest.raises(ValueError, match=msg):
        jax_make(spec, 64, 48)
    with pytest.raises(ValueError, match=msg):
        encoder.make_encoder(spec, 64, 48, device="cpu")
