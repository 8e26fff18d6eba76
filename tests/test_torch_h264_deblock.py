"""The port's in-loop deblocking on the CPU against the JAX package's and
the port's host oracle.

``ops/h264_deblock.py``'s ``bs_grids`` and ``deblock_planes`` equal the
JAX functions' outputs exactly (tolerance 0) on random pictures with
adversarial metadata (the cases of ``tests/test_h264_deblock_tpu.py``:
intra, coded blocks, motion on both sides of the |dmv| >= 4 threshold,
two references), with and without ``slice_local``, at one shape (one
``jax.jit`` a ``slice_local``); and they equal
``io.h264_deblock.deblock_picture`` at every geometry of those cases, one
MB row and one MB column included, and on an all-intra IDR picture.  On
the CPU the wrapper runs the plain version and counts no launch.
``bs_words`` (the plain version of ``deblock_bs_kernel``, every MB's bS
as 4-bit fields) unpacks, field by field, to the JAX ``bs_grids`` on the
same cases, with MB and quadrant fields, with and without ``slice_local``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.ops import h264_deblock as jax_deblock
from opencv_opencl_tpu_torch.io.h264_deblock import DeblockInfo, deblock_picture
from opencv_opencl_tpu_torch.ops import h264_deblock
from opencv_opencl_tpu_torch.ops.cuda import h264_deblock as deblock_kernel


def rand_case(rng, mb_h, mb_w):
    H, W = mb_h * 16, mb_w * 16
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    # smooth stripes open the |p0 - q0| < alpha activity gates
    y[:, : W // 2] = np.linspace(40, 90, W // 2)[None, :].astype(np.uint8)
    cb = np.tile(np.linspace(100, 140, W // 2)[None, :], (H // 2, 1)).astype(np.uint8)
    cr = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    cr[: H // 4] = 128
    info = DeblockInfo(mb_h, mb_w)
    info.intra[:] = rng.random((mb_h, mb_w)) < 0.3
    info.nnz4[:] = rng.random((mb_h * 4, mb_w * 4)) < 0.4
    info.mv[:] = rng.integers(-20, 21, (mb_h, mb_w, 2))
    info.ref[:] = rng.integers(0, 2, (mb_h, mb_w))
    return y, cb, cr, info


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port(y, cb, cr, qp, info, slice_local=False):
    return h264_deblock.deblock_planes(t(y), t(cb), t(cr), qp, t(info.intra),
                                       t(info.nnz4), t(info.mv), t(info.ref),
                                       slice_local=slice_local)


@pytest.fixture(scope="module")
def jax_fns():
    progs = {sl: jax.jit(lambda y, cb, cr, qp, i, n, m, r, sl=sl: jax_deblock.deblock_planes(
        y, cb, cr, qp, i, n, m, r, sl)) for sl in (False, True)}
    return progs, jax.jit(jax_deblock.bs_grids)


@pytest.mark.parametrize("slice_local", [False, True], ids=["idc0", "slice_local"])
def test_deblock_and_bs_grids_equal_jax(jax_fns, slice_local):
    progs, bs_fn = jax_fns
    for seed, qp in ((0, 35), (3, 51), (4, 20), (9, 44)):
        rng = np.random.default_rng(seed)
        y, cb, cr, info = rand_case(rng, 3, 4)
        if seed == 9:       # motion at the threshold on every other MB
            info.mv[:, ::2] = info.mv[:, 1::2] + np.array([4, -3])
            info.nnz4[:] = False
        got = port(y, cb, cr, qp, info, slice_local)
        want = progs[slice_local](*(jnp.asarray(a) for a in (y, cb, cr)), jnp.int32(qp),
                                  *(jnp.asarray(a) for a in (info.intra, info.nnz4,
                                                            info.mv, info.ref)))
        for name, a, b in zip(("y", "cb", "cr"), got, want):
            assert a.dtype == torch.uint8
            assert np.array_equal(a.numpy(), np.asarray(b)), f"{name} seed {seed}"
        assert (got[0].numpy() != y).any()
        grids = h264_deblock.bs_grids(t(info.intra), t(info.nnz4), t(info.mv), t(info.ref))
        for a, b in zip(grids, bs_fn(*(jnp.asarray(a) for a in (
                info.intra, info.nnz4, info.mv, info.ref)))):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert set(np.unique(grids[0].numpy())) >= {0, 1, 2, 3, 4} - ({2} if seed == 9 else set())


@pytest.mark.parametrize("seed,mb_h,mb_w,qp", [
    (0, 3, 4, 35), (1, 1, 6, 26), (2, 5, 1, 44), (3, 4, 4, 51),
    (4, 2, 7, 20), (5, 6, 3, 38),
])
def test_deblock_equals_the_host_oracle(seed, mb_h, mb_w, qp):
    rng = np.random.default_rng(seed)
    y, cb, cr, info = rand_case(rng, mb_h, mb_w)
    for slice_local in (False, True):
        want = deblock_picture(y, cb, cr, qp, info, slice_local_rows=slice_local)
        got = port(y, cb, cr, qp, info, slice_local)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy().astype(np.int64), b)
    assert (got[0].numpy() != y).any() or mb_h == 1 or mb_w == 1


def test_all_intra_idr_picture_and_no_launch_on_the_cpu():
    rng = np.random.default_rng(9)
    y, cb, cr, _ = rand_case(rng, 3, 3)
    info = DeblockInfo.for_idr(3, 3)
    want = deblock_picture(y, cb, cr, 40, info)
    deblock_kernel.reset_launch_counts()
    got = port(y, cb, cr, 40, info)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().astype(np.int64), b)
    assert (got[0].numpy() != y).mean() > 0.05       # the strong filter ran
    assert deblock_kernel.launch_counts() == {"deblock_planes": 0}
    with pytest.raises(ValueError, match="CUDA device"):
        deblock_kernel.deblock_into(t(y), t(cb), t(cr), 40, t(info.intra), t(info.nnz4),
                                    None, None)
    with pytest.raises(ValueError, match="nnz4"):
        h264_deblock.deblock_planes(t(y), t(cb), t(cr), 40, t(info.intra),
                                    t(info.nnz4[:4]), t(info.mv), t(info.ref))


def _unpack_words(words: np.ndarray):
    """(mb_h, mb_w, 4) words -> (bs_v, bs_h) grids: field f of word f // 8 at
    bits 4 (f % 8); vertical field s * 4 + e at block (4i + s, 4j + e),
    horizontal field s * 4 + e at block (4i + e, 4j + s)."""
    mb_h, mb_w = words.shape[:2]
    v = np.stack([(words[..., f // 8] >> 4 * (f % 8)) & 15 for f in range(16)], -1)
    h = np.stack([(words[..., 2 + f // 8] >> 4 * (f % 8)) & 15 for f in range(16)], -1)
    bs_v = v.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3).reshape(4 * mb_h, 4 * mb_w)
    bs_h = h.reshape(mb_h, mb_w, 4, 4).transpose(0, 3, 1, 2).reshape(4 * mb_h, 4 * mb_w)
    return bs_v, bs_h


@pytest.mark.parametrize("slice_local", [False, True], ids=["idc0", "slice_local"])
def test_bs_words_unpack_to_jax_bs_grids(jax_fns, slice_local):
    _, bs_fn = jax_fns
    for seed, quad in ((0, False), (3, False), (4, True), (9, False)):
        rng = np.random.default_rng(seed)
        _, _, _, info = rand_case(rng, 3, 4)
        mv, ref = info.mv, info.ref
        if quad:        # one vector and reference an 8x8 block
            mv = rng.integers(-20, 21, (6, 8, 2)).astype(mv.dtype)
            ref = rng.integers(0, 2, (6, 8)).astype(ref.dtype)
        words = h264_deblock.bs_words(t(info.intra), t(info.nnz4), t(mv), t(ref),
                                      slice_local=slice_local).numpy()
        assert words.shape == (3, 4, 4) and (words >= 0).all() and (words < 2 ** 32).all()
        want_v, want_h = (np.asarray(g).copy() for g in bs_fn(
            *(jnp.asarray(a) for a in (info.intra, info.nnz4, mv, ref))))
        if slice_local:
            want_h[::4] = 0
        got_v, got_h = _unpack_words(words)
        assert np.array_equal(got_v, want_v), f"seed {seed}"
        assert np.array_equal(got_h, want_h), f"seed {seed}"
        assert set(np.unique(got_v)) >= {0, 3, 4}
