"""The port's CAVLC bit packer (``bitpack``) on the CPU against the JAX
package's and the host oracle.

``ops/h264_bitpack.pack_i_mbs`` and ``pack_p_mbs`` (the plain versions on
CPU tensors) equal the JAX functions' words and bit counts exactly
(tolerance 0) on the same levels: random blocks (sparse and dense, small
levels and levels up to the 12-bit escape), whole I frames (I_16x16,
Intra_4x4 with chroma HORIZONTAL) and whole P frames (zero motion, a
search, the partition modes with one and two references), and at a 3-word
cap.  All at one shape, 8 x 6 MBs: the JAX functions run op by op (not
under ``jax.jit``), so that the compiled ops are shared by every case of
the module (about 30 s in all on a CPU; a ``jax.jit`` of each packer compiles
for 14-40 s).  ``CudaCavlcEncoder(device="cpu", bitpack=True)`` and
``CudaGopEncoder(device="cpu", bitpack=True)`` stream equal to the host
oracle (``CavlcH264Encoder`` / ``GopCavlcEncoder`` with one slice a MB
row) byte for byte, with ``i4`` / ``chromah``, ``overlap``, ``parts`` with
one and two references (``tests/test_h264_parts.py``'s
``TestPartsBitpack``), two references, GDR and ``deblock``; at
``nw_mb=3`` every frame overflows the cap, goes through the host entropy
path and is counted, at 64 none.  ``make_encoder`` builds ``:bitpack`` as
the reference does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.ops import h264_bitpack as jax_bitpack
from opencv_opencl_tpu_torch.io import encoder
from opencv_opencl_tpu_torch.io.h264_cavlc import CavlcH264Encoder, CudaCavlcEncoder
from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder, GopCavlcEncoder
from opencv_opencl_tpu_torch.ops import h264_bitpack, h264_levels
from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as packer
from tests.test_h264_parts import flicker_shear_frames, shear_frames

MB_H, MB_W = 6, 8
W, H = 16 * MB_W, 16 * MB_H


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def random_levels(seed: int, dense: bool = False):
    """Levels of every MB: sparse small ones, dense ones (nC >= 8, more than
    10 coefficients, suffixLength steps) and some up to the 12-bit escape."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        mag = rng.choice([1, 2, 3, 40, 2063], size=shape, p=[0.5, 0.2, 0.15, 0.1, 0.05])
        a = (mag * rng.choice([-1, 1], size=shape)).astype(np.int16)
        a[rng.random(shape) < (0.3 if dense else 0.8)] = 0
        a[rng.random(shape[:3]) < 0.3] = 0          # whole blocks and MBs empty
        return a

    zdc = draw((MB_H, MB_W, 16))
    acz = draw((MB_H, MB_W, 16, 16))
    czdc = draw((MB_H, MB_W, 2, 4))
    cacz = draw((MB_H, MB_W, 2, 4, 16))
    return rng, zdc, acz, czdc, cacz


def assert_packed(got, want, what):
    gw, gn = got
    ww, wn = want
    assert gw.dtype == torch.uint32 and gn.dtype == torch.int32, what
    assert np.array_equal(gn.numpy(), np.asarray(wn)), f"{what}: nbits"
    assert np.array_equal(gw.numpy(), np.asarray(ww)), f"{what}: words"


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("i4", [False, True], ids=["i16", "i4_chromah"])
def test_pack_i_random_levels_equal_jax(dense, i4):
    rng, zdc, acz, czdc, cacz = random_levels(1 + dense + 2 * i4, dense)
    imode = rng.integers(1, 3, (MB_H, MB_W)).astype(np.int16)
    i4modes = cmode = None
    acz_i = acz.copy()
    acz_i[..., 0] = 0
    if i4:
        imode[rng.random((MB_H, MB_W)) < 0.5] = 0
        i4modes = rng.integers(0, 9, (MB_H, MB_W, 16)).astype(np.int16)
        cmode = rng.integers(0, 4, (MB_H, MB_W)).astype(np.int16)
        # Intra_4x4 MBs carry 16 coefficients a block
        acz_i = np.where((imode == 0)[..., None, None], acz, acz_i)
    cacz[..., 0] = 0
    args = (zdc, acz_i, czdc, cacz, imode)
    got = h264_bitpack.pack_i_mbs(*map(t, args), 64, t(i4modes), t(cmode))
    want = jax_bitpack.pack_i_mbs(*map(j, args), nw_mb=64, i4modes=j(i4modes),
                                  cmode=j(cmode))
    assert_packed(got, want, "pack_i_mbs")
    assert (got[1].numpy() > 0).all()


def p_random(seed: int, dense: bool):
    rng, zdc, acz, czdc, cacz = random_levels(seed, dense)
    mode = rng.integers(0, 4, (MB_H, MB_W)).astype(np.int16)
    mode[:, 2:4] = 0                                  # skip runs
    intra = (mode >= 2)[..., None]
    zdc = np.where(intra, zdc, 0).astype(np.int16)
    acz[..., 0] = np.where(intra, 0, acz[..., 0])
    skip = (mode == 0)
    for a in (zdc, acz, czdc, cacz):
        a[skip] = 0
    cacz[..., 0] = 0
    return rng, mode, zdc, acz, czdc, cacz


@pytest.mark.parametrize("active", [1, 2])
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_pack_p_random_levels_equal_jax(dense, active):
    rng, mode, zdc, acz, czdc, cacz = p_random(10 + dense + 2 * active, dense)
    mv = rng.integers(-40, 41, (MB_H, MB_W, 2)).astype(np.int16)
    ref = rng.integers(0, active, (MB_H, MB_W)).astype(np.int16)
    args = (mode, zdc, acz, czdc, cacz, mv, ref)
    got = h264_bitpack.pack_p_mbs(*map(t, args), active, 64)
    want = jax_bitpack.pack_p_mbs(*map(j, args), active, nw_mb=64)
    assert_packed(got, want, "pack_p_mbs")
    assert ((got[1].numpy() == 0) == (mode == 0)).all()


@pytest.mark.parametrize("active", [1, 2])
def test_pack_p_parts_random_equal_jax(active):
    rng, mode, zdc, acz, czdc, cacz = p_random(20 + active, False)
    pmode = rng.integers(0, 4, (MB_H, MB_W)).astype(np.int16)
    mv4 = rng.integers(-30, 31, (MB_H, MB_W, 4, 2)).astype(np.int16)
    mv4[rng.random((MB_H, MB_W)) < 0.3] = 0
    ref4 = rng.integers(0, active, (MB_H, MB_W, 4)).astype(np.int16)
    args = (mode, zdc, acz, czdc, cacz)
    got = h264_bitpack.pack_p_mbs(*map(t, args), None, None, active, 64, pmode=t(pmode),
                                  mv4=t(mv4), ref4=t(ref4))
    want = jax_bitpack.pack_p_mbs(*map(j, args), None, None, active, nw_mb=64,
                                  pmode=j(pmode), mv4=j(mv4), ref4=j(ref4))
    assert_packed(got, want, "pack_p_mbs parts")


def frame_planes(frame):
    y = t(frame[:H])
    uv = frame[H:].reshape(H // 2, W // 2, 2)
    return y, t(uv[:, :, 0]), t(uv[:, :, 1])


def test_pack_i_whole_frames_equal_jax():
    """The levels of real frames: I_16x16, and Intra_4x4 with chroma
    HORIZONTAL."""
    frame = shear_frames(1)[0]
    for kw in (dict(), dict(i4=True, chromah=True)):
        lv, imode, *extra = h264_levels.encode_levels(*frame_planes(frame), 24, **kw)
        ex = dict(zip(["i4modes"] * ("i4" in kw) + ["cmode"] * ("chromah" in kw), extra))
        got = h264_bitpack.pack_i_mbs(*lv, imode, 64, ex.get("i4modes"), ex.get("cmode"))
        want = jax_bitpack.pack_i_mbs(*(j(a.numpy()) for a in (*lv, imode)), nw_mb=64,
                                      **{k: j(v.numpy()) for k, v in ex.items()})
        assert_packed(got, want, f"I frame {kw}")


@pytest.mark.parametrize("kw", [
    dict(search=0), dict(search=3), dict(search=2, parts=1),
    dict(search=2, subpel=2, parts=1, two=True),
], ids=["zero_motion", "search", "parts", "parts_refs2_quarterpel"])
def test_pack_p_whole_frames_equal_jax(kw):
    """The levels, fields and modes of real P frames."""
    kw = dict(kw)
    two = kw.pop("two", False)
    fs = flicker_shear_frames()
    cur = frame_planes(fs[3])
    r1, r2 = frame_planes(fs[2]), frame_planes(fs[1])
    extra = dict(ry2=r2[0], rcb2=r2[1], rcr2=r2[2]) if two else {}
    plv = h264_levels.encode_p_levels(*cur, *r1, 30, **kw, **extra)
    active = 2 if two else 1
    lv = (plv.mode, plv.zdc, plv.acz, plv.czdc, plv.cacz)
    if plv.pmode is None:
        got = h264_bitpack.pack_p_mbs(*lv, plv.mv, plv.ref, active, 64)
        want = jax_bitpack.pack_p_mbs(*(j(a.numpy()) for a in lv),
                                      None if plv.mv is None else j(plv.mv.numpy()),
                                      None if plv.ref is None else j(plv.ref.numpy()),
                                      active, nw_mb=64)
    else:
        got = h264_bitpack.pack_p_mbs(*lv, None, None, active, 64, pmode=plv.pmode,
                                      mv4=plv.mv, ref4=plv.ref)
        want = jax_bitpack.pack_p_mbs(
            *(j(a.numpy()) for a in lv), None, None, active, nw_mb=64,
            pmode=j(plv.pmode.numpy()), mv4=j(plv.mv.numpy()),
            ref4=None if plv.ref is None else j(plv.ref.numpy()))
    assert_packed(got, want, f"P frame {kw}")
    assert (plv.mode.numpy() == 1).any()


def test_three_word_cap_equals_jax():
    """An MB over the cap reports its true bit count with its first 96
    bits."""
    rng, mode, zdc, acz, czdc, cacz = p_random(30, True)
    pmode = rng.integers(0, 4, (MB_H, MB_W)).astype(np.int16)
    mv4 = rng.integers(-30, 31, (MB_H, MB_W, 4, 2)).astype(np.int16)
    ref4 = rng.integers(0, 2, (MB_H, MB_W, 4)).astype(np.int16)
    args = (mode, zdc, acz, czdc, cacz)
    got = h264_bitpack.pack_p_mbs(*map(t, args), None, None, 2, 3, pmode=t(pmode),
                                  mv4=t(mv4), ref4=t(ref4))
    want = jax_bitpack.pack_p_mbs(*map(j, args), None, None, 2, nw_mb=3, pmode=j(pmode),
                                  mv4=j(mv4), ref4=j(ref4))
    assert_packed(got, want, "pack_p_mbs at 3 words")
    assert (got[1].numpy() > 96).any() and tuple(got[0].shape) == (MB_H, MB_W, 3)
    full = h264_bitpack.pack_p_mbs(*map(t, args), None, None, 2, 64, pmode=t(pmode),
                                   mv4=t(mv4), ref4=t(ref4))
    assert torch.equal(full[1], got[1])
    assert np.array_equal(full[0].numpy()[..., :3], got[0].numpy())


def test_packers_on_the_cpu_count_no_launch():
    packer.reset_launch_counts()
    rng, zdc, acz, czdc, cacz = random_levels(5)
    imode = rng.integers(1, 3, (MB_H, MB_W)).astype(np.int16)
    h264_bitpack.pack_i_mbs(*map(t, (zdc, acz, czdc, cacz, imode)))
    assert packer.launch_counts() == {"pack_i_mbs": 0, "pack_p_mbs": 0}
    assert h264_bitpack.vlc_table().size == 1328


def encode_all(enc, frames):
    return [au for f in frames for au in enc.encode(f)] + enc.flush()


INTRA = [
    ("i16", dict(qp=30), False),
    ("i4_chromah", dict(qp=26, i4=True, chromah=True), False),
    ("overlap", dict(qp=30), True),
    ("deblock_rate_control", dict(qp=34, deblock=True, bitrate_kbps=300), False),
]


@pytest.mark.parametrize("nw_mb", [64, 3])
@pytest.mark.parametrize("kw,overlap", [c[1:] for c in INTRA], ids=[c[0] for c in INTRA])
def test_intra_bitpack_stream_equals_the_host_oracle(kw, overlap, nw_mb):
    fs = shear_frames(3)
    enc = CudaCavlcEncoder(W, H, device="cpu", bitpack=True, nw_mb=nw_mb,
                           overlap=overlap, **kw)
    got = encode_all(enc, fs)
    assert got == encode_all(CavlcH264Encoder(W, H, slices=MB_H, **kw), fs)
    assert enc._bits_overflows == (len(fs) if nw_mb == 3 else 0)


GOP = [
    ("gop", dict(qp=30, gop=3), shear_frames),
    ("search_deblock", dict(qp=30, gop=4, search=4, deblock=True), shear_frames),
    ("parts", dict(qp=30, gop=6, search=3, parts=True), flicker_shear_frames),
    ("parts_refs2", dict(qp=30, gop=6, search=3, parts=True, refs=2), flicker_shear_frames),
    ("refs2_quarterpel", dict(qp=30, gop=4, search=2, quarterpel=True, refs=2),
     flicker_shear_frames),
    ("fastsub", dict(qp=30, gop=4, search=3, fastsub=True), shear_frames),
    ("gdr_deblock", dict(qp=30, gdr=3, search=2, deblock=True), shear_frames),
    ("i4_chromah_idr", dict(qp=28, gop=3, search=2, i4=True, chromah=True), shear_frames),
]


@pytest.mark.parametrize("kw,make", [c[1:] for c in GOP], ids=[c[0] for c in GOP])
def test_gop_bitpack_stream_equals_the_host_oracle(kw, make):
    fs = make()[:4]
    enc = CudaGopEncoder(W, H, device="cpu", bitpack=True, **kw)
    assert encode_all(enc, fs) == encode_all(GopCavlcEncoder(W, H, slices=MB_H, **kw), fs)
    assert enc._bits_overflows == 0


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_gop_bitpack_overflow_takes_the_host_path(overlap):
    """At 3 words every frame overflows: the stream is the oracle's all the
    same, each frame counted."""
    fs = flicker_shear_frames()[:4]
    kw = dict(qp=30, gop=4, search=3, parts=True, refs=2)
    enc = CudaGopEncoder(W, H, device="cpu", bitpack=True, nw_mb=3, overlap=overlap, **kw)
    assert encode_all(enc, fs) == encode_all(GopCavlcEncoder(W, H, slices=MB_H, **kw), fs)
    assert enc._bits_overflows == len(fs)


@pytest.mark.parametrize("spec,cls,kind", [
    ("tpu:qp=30:bitpack", CudaCavlcEncoder, dict()),
    ("tpu:qp=30:i4:chromah:bitpack:overlap", CudaCavlcEncoder, dict(i4=True, chromah=True)),
    ("tpu:qp=30:gop=4:search=2:parts:bitpack", CudaGopEncoder, dict(parts=True, search=2)),
    ("tpu:qp=30:gdr=3:search=2:deblock:bitpack", CudaGopEncoder, dict(gdr=3, deblock=True)),
], ids=["intra", "i4_chromah_overlap", "gop_parts", "gdr_deblock"])
def test_factory_builds_bitpack(spec, cls, kind):
    enc = encoder.make_encoder(spec, 64, 48, device="cpu")
    assert type(enc) is cls and enc._bitpack and enc._nw_mb == 64
    for key, value in kind.items():
        assert getattr(enc, key) == value, key
    fs = shear_frames(2, w=64, h=48, split=24)
    assert len(encode_all(enc, fs)) == 2
