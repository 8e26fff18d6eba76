"""The port's P-frame arithmetic on the CPU against the JAX package's.

``ops/h264_levels.py``'s sub-pel planes (``halfpel_planes`` /
``quarterpel_planes``), ``motion_search`` (full-pel, half-pel, quarter-pel
and ``fastsub``, one and two references, the GDR clean-region rule) and
``encode_p_levels`` (zero motion, each sub-pel mode, two references, a GDR
band; QPs 0, 30, 51) equal the JAX functions' outputs exactly (tolerance 0:
integer levels, MVs and planes), on seed-made frames of 96x64.  Every JAX
program is one module-scoped ``jax.jit`` a configuration, at one shape, so
that each compiles once; ``clean_rows=0`` and the empty band ``(0, 0)``
restrict nothing, so that one program holds a configuration with and
without GDR.  The planes and the search of frames one MB row high and one
MB column wide are held to the port's host oracle (``io/h264_inter.py``).
On the CPU the wrappers run the plain versions and count no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.ops import h264_levels as jax_levels
from opencv_opencl_tpu_torch.io import h264_inter as host
from opencv_opencl_tpu_torch.ops import h264_levels
from opencv_opencl_tpu_torch.ops.cuda import h264_inter as inter_kernels
from opencv_opencl_tpu_torch.ops.cuda import h264_levels as level_kernels

H, W = 64, 96
SEARCH = 2


def frames(seed: int, h: int = H, w: int = W):
    """A source picture and two references: the first the source moved by
    (2, -3) pixels with noise, the second a smoothed other picture; a
    static band keeps some MBs skippable."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 8, w + 8)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    y = base[4:4 + h, 4:4 + w].astype(np.uint8)
    ry = np.clip(base[2:2 + h, 7:7 + w] + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.uint8)
    ry[: h // 4] = y[: h // 4]
    cb = rng.integers(100, 150, (h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(110, 140, (h // 2, w // 2)).astype(np.uint8)
    rcb, rcr = np.roll(cb, 1, 1), np.roll(cr, -1, 0)
    rcb[: h // 8], rcr[: h // 8] = cb[: h // 8], cr[: h // 8]
    other = np.clip(np.roll(base, 5, 1)[:h, :w] + 3, 0, 255).astype(np.uint8)
    ry2, rcb2, rcr2 = other, np.roll(cb, -2, 0), np.roll(cr, 2, 1)
    return y, cb, cr, (ry, rcb, rcr), (ry2, rcb2, rcr2)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), what


@pytest.fixture(scope="module")
def jax_planes():
    return {n: jax.jit(f, static_argnums=1) for n, f in (
        (4, jax_levels.halfpel_planes_jax), (16, jax_levels.quarterpel_planes_jax))}


@pytest.mark.parametrize("nplanes", [4, 16])
@pytest.mark.parametrize("margin", [SEARCH + 1, 5])
def test_planes_equal_jax_and_the_host_oracle(jax_planes, nplanes, margin):
    ry = frames(0)[3][0]
    got = (h264_levels.halfpel_planes if nplanes == 4
           else h264_levels.quarterpel_planes)(t(ry), margin)
    assert got.dtype == torch.uint8
    assert_equal(got, jax_planes[nplanes](jnp.asarray(ry), margin), "planes vs JAX")
    oracle = host.halfpel_planes if nplanes == 4 else host.quarterpel_planes
    assert_equal(got, oracle(ry, margin), "planes vs the host oracle")


@pytest.mark.parametrize("h,w", [(16, 96), (64, 16), (32, 32)])
def test_planes_and_search_of_one_row_and_one_column(h, w):
    y, _, _, (ry, rcb, rcr), _ = frames(3, h, w)
    for nplanes, oracle in ((4, host.halfpel_planes), (16, host.quarterpel_planes)):
        assert_equal(h264_levels.subpel_planes(t(ry), SEARCH + 1, nplanes),
                     oracle(ry, SEARCH + 1), f"planes {nplanes}")
    refs = [(t(ry), t(rcb), t(rcr))]
    for subpel in (0, 1, 2):
        mv = h264_levels.motion_search(t(y), refs, SEARCH, subpel)[0]
        assert_equal(mv, host.motion_search(y, ry, SEARCH, subpel), f"mv {subpel}")
    mv = h264_levels.motion_search(t(y), refs, SEARCH, 3, clean_rows=1)[0]
    assert_equal(mv, host.motion_search_fast(y, ry, SEARCH, clean_rows=1), "fastsub")


@pytest.fixture(scope="module")
def jax_searches():
    """One program a (subpel, references) configuration; the single
    reference's take ``clean_rows`` traced."""
    one = {sp: jax.jit(lambda y, ry, rcb, rcr, cl, sp=sp: (
        jax_levels.motion_search_mc_fast(y, ry, rcb, rcr, SEARCH, clean_rows=cl)
        if sp == 3 else
        jax_levels.motion_search_mc(y, ry, rcb, rcr, SEARCH, sp, clean_rows=cl)))
        for sp in range(4)}
    two = {sp: jax.jit(lambda y, a, b, sp=sp: (
        jax_levels.motion_search_mc_fast_multi(y, [a, b], SEARCH) if sp == 3 else
        jax_levels.motion_search_mc_multi(y, [a, b], SEARCH, sp)))
        for sp in range(4)}
    return one, two


@pytest.mark.parametrize("subpel", [0, 1, 2, 3], ids=["fullpel", "halfpel",
                                                      "quarterpel", "fastsub"])
@pytest.mark.parametrize("refs", [1, 2])
def test_motion_search_equals_jax(jax_searches, subpel, refs):
    """mv, ref and the three prediction planes, with and without the GDR
    rule (one reference), on two seeds."""
    one, two = jax_searches
    for seed in (1, 2):
        y, _, _, r1, r2 = frames(seed)
        if refs == 1:
            for clean in (None, 2):
                got = h264_levels.motion_search(t(y), [tuple(map(t, r1))], SEARCH,
                                                subpel, clean_rows=clean)
                want = one[subpel](jnp.asarray(y), *map(jnp.asarray, r1),
                                   jnp.int32(clean or 0))
                assert len(got) == 4
                for name, a, b in zip(("mv", "pred_y", "pred_cb", "pred_cr"), got, want):
                    assert_equal(a, b, f"{name} seed {seed} clean {clean}")
        else:
            got = h264_levels.motion_search(t(y), [tuple(map(t, r1)), tuple(map(t, r2))],
                                            SEARCH, subpel)
            want = two[subpel](jnp.asarray(y), tuple(map(jnp.asarray, r1)),
                               tuple(map(jnp.asarray, r2)))
            assert len(got) == 5
            for name, a, b in zip(("mv", "ref", "pred_y", "pred_cb", "pred_cr"), got, want):
                assert_equal(a, b, f"{name} seed {seed}")
            assert got[1].dtype == torch.int16
        assert got[0].dtype == torch.int16 and got[-3].dtype == torch.uint8


@pytest.fixture(scope="module")
def jax_p_levels():
    """encode_p_levels by configuration (search, subpel, two references);
    qp and the GDR band traced."""
    progs = {}
    for search, subpel, two in ((0, 0, False), (SEARCH, 0, False), (SEARCH, 1, False),
                                (SEARCH, 2, False), (SEARCH, 3, False), (SEARCH, 1, True)):
        if two:
            fn = (lambda y, cb, cr, r1, r2, qp, band, s=search, sp=subpel:
                  jax_levels.encode_p_levels(y, cb, cr, *r1, qp, s, sp, *r2))
        else:
            fn = (lambda y, cb, cr, r1, r2, qp, band, s=search, sp=subpel:
                  jax_levels.encode_p_levels(y, cb, cr, *r1, qp, s, sp, gdr_band=band))
        progs[(search, subpel, two)] = jax.jit(fn)
    return progs


P_CONFIGS = [(0, 0, False), (SEARCH, 0, False), (SEARCH, 1, False),
             (SEARCH, 2, False), (SEARCH, 3, False), (SEARCH, 1, True)]


@pytest.mark.parametrize("search,subpel,two", P_CONFIGS,
                         ids=["zero", "fullpel", "halfpel", "quarterpel", "fastsub",
                              "refs2"])
def test_encode_p_levels_equals_jax(jax_p_levels, search, subpel, two):
    """Every field of PLevelArrays at QPs 0, 30 and 51, with a GDR band
    (one reference) and without; the decisions cover skip, inter and
    intra."""
    y, cb, cr, r1, r2 = frames(4)
    modes = set()
    for qp in (0, 30, 51):
        for band in ([(0, 0), (1, 3)] if not two else [(0, 0)]):
            kw = dict(ry2=t(r2[0]), rcb2=t(r2[1]), rcr2=t(r2[2])) if two else {}
            if band != (0, 0):
                kw["gdr_band"] = band
            got = h264_levels.encode_p_levels(t(y), t(cb), t(cr), *map(t, r1), qp,
                                              search, subpel, **kw)
            want = jax_p_levels[(search, subpel, two)](
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
                tuple(map(jnp.asarray, r1)), tuple(map(jnp.asarray, r2)),
                jnp.int32(qp), tuple(jnp.int32(b) for b in band))
            for name in h264_levels.PLevelArrays._fields:
                a, b = getattr(got, name), getattr(want, name)
                if b is None:
                    assert a is None, name
                    continue
                assert_equal(a, b, f"{name} qp {qp} band {band}")
            assert got.mode.dtype == torch.int16 and got.recon_y.dtype == torch.uint8
            modes |= set(np.unique(got.mode.numpy()).tolist())
            if band == (1, 3):
                assert (got.mode[1:3] >= 2).all()
    assert {0, 1} <= modes and modes & {2, 3}


def test_encode_p_levels_refusals_and_no_launch_on_the_cpu():
    # the intra bias of the decision is the host oracle's
    assert h264_levels.INTRA_BIAS == host._INTRA_BIAS
    y, cb, cr, r1, r2 = frames(5)
    args = (t(y), t(cb), t(cr), *map(t, r1), 30)
    with pytest.raises(ValueError, match="two references"):
        h264_levels.encode_p_levels(*args, SEARCH, 0, *map(t, r2), gdr_band=(0, 1))
    with pytest.raises(ValueError, match="parts requires search"):
        h264_levels.encode_p_levels(*args, 0, 0, parts=1)
    with pytest.raises(ValueError, match="16-aligned"):
        h264_levels.encode_p_levels(t(y[:24]), t(cb[:12]), t(cr[:12]),
                                    *(t(p[:24 // (1 + (i > 0))]) for i, p in enumerate(r1)),
                                    30)
    with pytest.raises(ValueError, match="subpel"):
        h264_levels.motion_search(t(y), [tuple(map(t, r1))], SEARCH, 4)
    with pytest.raises(ValueError, match="clean_rows"):
        h264_levels.motion_search(t(y), [tuple(map(t, r1)), tuple(map(t, r2))], SEARCH, 0,
                                  clean_rows=1)
    for fn in (inter_kernels.search_into, level_kernels.p_levels_into):
        with pytest.raises(ValueError, match="CUDA device"):
            if fn is inter_kernels.search_into:
                fn(t(y), [tuple(map(t, r1))], SEARCH, 0, None,
                   torch.empty((4, 6, 2), dtype=torch.int16), None,
                   *(torch.empty_like(p) for p in map(t, r1)))
            else:
                fn(t(y), t(cb), t(cr), *map(t, r1), 30,
                   torch.empty(level_kernels.p_level_words(4, 6), dtype=torch.int16))
    assert inter_kernels.launch_counts() == {"subpel_planes": 0, "motion_search": 0,
                                             "motion_search_parts": 0}
    assert level_kernels.launch_counts()["encode_p_levels"] == 0
