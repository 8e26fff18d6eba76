"""The plain versions of the port's three kernels against the JAX package.

Each plain PyTorch version in ``opencv_opencl_tpu_torch/ops/cuda/natural.py``
is the oracle its CUDA kernel is held to on the card, so here it is held to
the TPU kernel it replaces, run in Pallas interpret mode on the same inputs
(made with numpy from a seed), and to the numpy golden model.  Tolerance:
0 (exact), except where the JAX side itself is off cv2 by an FMA tie on
the CPU (K3 in interpret mode; see assert_clahe_close).  On the CPU every
wrapper takes its plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.ops import clahe as jax_clahe
from opencv_opencl_tpu.ops.pallas import natural as jax_natural
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops.cuda import natural
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

GEOMETRIES = [
    (96, 128, 2.0, (8, 8)),
    (97, 131, 2.0, (8, 8)),      # odd: reflect-padded tiles
    (64, 256, 3.0, (4, 4)),
    (120, 256, 40.0, (8, 8)),    # cv2 default clip
    (33, 47, 2.5, (3, 5)),       # asymmetric grid
    (6, 6, 2.0, (8, 8)),         # one-row tiles
    (3, 5, 40.0, (8, 8)),        # pad >= dim: multi-reflection
    (40, 60, 2.0, (1, 1)),       # a single tile
]


def _frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


def _jax_ext(y, jplan):
    return np.asarray(jax_clahe._extend(y, jplan))


# ------------------------------------------------------------------ K1 ----


@pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
def test_tile_histograms_ref_equals_radix_kernel(h, w, clip, grid):
    frames = _frames(1, 2, h, w)
    jplan = jax_clahe.make_clahe_plan(h, w, clip, grid)
    plan = torch_clahe.make_clahe_plan(h, w, clip, grid)
    got = natural.tile_histograms_ref(torch.from_numpy(frames), plan)
    assert got.dtype == torch.int32 and got.shape == (2, plan.num_tiles, 256)
    want = np.asarray(jax_natural.tile_histograms_radix(
        _jax_ext(frames[0], jplan), jplan.tiles_y, jplan.tiles_x, jplan.tile_h,
        jplan.tile_w, interpret=True))
    assert np.array_equal(got[0].numpy(), want)
    # frames of a batch are counted apart
    assert torch.equal(got[1:], natural.tile_histograms_ref(
        torch.from_numpy(frames[1:]), plan))
    assert (got.sum(dim=-1) == plan.tile_area).all()


@pytest.mark.parametrize("h,w,grid,rowstep", [
    (96, 128, (8, 8), 2),
    (97, 131, (8, 8), 13),       # tile_h 13 on padded rows
    (64, 256, (4, 4), 4),
])
def test_tile_histograms_ref_rowstep_equals_jax(h, w, grid, rowstep):
    """hist_rowstep > 1: every rowstep-th row of the extended frame, counts
    scaled by rowstep (ops/clahe.py _tile_hists_fast)."""
    y = _frames(2, 1, h, w)[0]
    jplan = jax_clahe.make_clahe_plan(h, w, 2.0, grid)
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    assert plan.tile_h % rowstep == 0
    want = np.asarray(jax_natural.tile_histograms_radix(
        _jax_ext(y, jplan)[::rowstep], jplan.tiles_y, jplan.tiles_x,
        jplan.tile_h // rowstep, jplan.tile_w, interpret=True)) * rowstep
    got = natural.tile_histograms_ref(torch.from_numpy(y[None]), plan, rowstep)
    assert np.array_equal(got[0].numpy(), want)


def test_tile_histograms_of_constant_frame():
    plan = torch_clahe.make_clahe_plan(64, 128, 2.0, (8, 8))
    y = torch.full((2, 64, 128), 200, dtype=torch.uint8)
    got = natural.tile_histograms(y, plan)
    assert (got[..., 200] == plan.tile_area).all()
    assert got.sum() == 2 * plan.num_tiles * plan.tile_area


def test_tile_histograms_take_strided_nv12_rows():
    """The Y rows of an NV12 batch go in as a strided view, no copy."""
    h, w = 48, 64
    nv12 = _frames(3, 2, h * 3 // 2, w)
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    view = torch.from_numpy(nv12)[:, :h]
    assert not view.is_contiguous()
    assert torch.equal(natural.tile_histograms(view, plan),
                       natural.tile_histograms(view.contiguous(), plan))


# ------------------------------------------------------------------ K2 ----


def _realistic_hists(seed, plan):
    rng = np.random.default_rng(seed)
    hists = rng.integers(0, plan.tile_area // 4 + 2,
                         (plan.num_tiles, 256)).astype(np.int32)
    hists[:, 0] += plan.tile_area - hists.sum(axis=1, dtype=np.int64).astype(np.int32)
    hists[:, 0] = np.maximum(hists[:, 0], 0)
    return hists


def _residual_edge_hists(plan):
    """Residual 0, 1 and 255, one full bin, and a uniform histogram
    (tests/test_natural_kernels.py TestLutPackFused.test_residual_edge_cases)."""
    hists = np.zeros((plan.num_tiles, 256), np.int32)
    c, area = plan.clip, plan.tile_area
    hists[0, 0] = area
    hists[1, :] = area // 256
    hists[1, 0] += area - hists[1].sum()
    hists[2, :2] = [c + 255, area - (c + 255)]
    hists[3, :2] = [c + 256, area - (c + 256)]
    hists[4, :2] = [c + 1, area - (c + 1)]
    return hists


def _assert_luts_equal_lut_pack(hists, h, w, clip, grid):
    jplan = jax_clahe.make_clahe_plan(h, w, clip, grid)
    spec = jax_natural.make_natural_spec(h, w, clip, grid)
    pack = np.asarray(jax_natural.build_lut_pack_pallas(
        hists, jplan.clip, jplan.lut_scale, spec, interpret=True))
    luts = natural.build_luts_ref(torch.from_numpy(hists[None]), jplan.clip,
                                  jplan.lut_scale)
    assert luts.dtype == torch.uint8
    got = luts[0].numpy()[spec.pack2_idx]
    assert np.array_equal(got, pack.astype(np.float32).astype(np.uint8))
    # and the JAX package's plain LUT build, every tile
    want = np.asarray(jax_clahe._luts_from_hists(hists, jplan))
    assert np.array_equal(luts[0].numpy(), want)


@pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
def test_build_luts_ref_equals_lut_pack_kernel(h, w, clip, grid):
    plan = torch_clahe.make_clahe_plan(h, w, clip, grid)
    _assert_luts_equal_lut_pack(_realistic_hists(4, plan), h, w, clip, grid)


@pytest.mark.parametrize("clip", [2.0, 40.0])
def test_build_luts_ref_residual_edge_cases(clip):
    plan = torch_clahe.make_clahe_plan(96, 128, clip, (8, 8))
    _assert_luts_equal_lut_pack(_residual_edge_hists(plan), 96, 128, clip, (8, 8))


def test_build_luts_ref_without_clip():
    plan = torch_clahe.make_clahe_plan(64, 128, 0.0, (8, 8))
    assert plan.clip == 0
    _assert_luts_equal_lut_pack(_realistic_hists(5, plan), 64, 128, 0.0, (8, 8))


# ------------------------------------------------------------------ K3 ----


@pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
def test_clahe_interpolate_ref_equals_natural_kernel(h, w, clip, grid):
    frames = _frames(6, 2, h, w)
    jplan = jax_clahe.make_clahe_plan(h, w, clip, grid)
    plan = torch_clahe.make_clahe_plan(h, w, clip, grid)
    spec = jax_natural.make_natural_spec(h, w, clip, grid)
    hists = natural.tile_histograms_ref(torch.from_numpy(frames), plan)
    luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
    got = natural.clahe_interpolate_ref(torch.from_numpy(frames), luts, plan)
    for i, y in enumerate(frames):
        # the golden model, exact: LUTs laid out (tiles_y, tiles_x, 256)
        gold = golden.clahe_apply_luts(
            y, luts[i].numpy().reshape(jplan.tiles_y, jplan.tiles_x, 256),
            jplan.tile_h, jplan.tile_w)
        assert np.array_equal(got[i].numpy(), gold)
    # the TPU kernel in interpret mode: on the CPU, XLA contracts its blend
    # into FMAs and flips exact ties by 1 LSB (tests/conftest.py), so this
    # one comparison allows the FMA ties; the port itself is exact above
    want = np.asarray(jax_natural.clahe_interpolate_natural(
        frames[0], luts[0].numpy(), spec, interpret=True))
    assert_clahe_close(got[0].numpy(), want)


def test_clahe_interpolate_writes_in_place():
    h, w = 48, 64
    nv12 = torch.from_numpy(_frames(8, 2, h * 3 // 2, w))
    before = nv12.clone()
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    y = nv12[:, :h]
    luts = natural.build_luts(natural.tile_histograms(y, plan), plan.clip,
                              plan.lut_scale)
    want = natural.clahe_interpolate_ref(before[:, :h], luts, plan)
    out = natural.clahe_interpolate(y, luts, plan, out=y)
    assert out.data_ptr() == nv12.data_ptr()
    assert torch.equal(nv12[:, :h], want)
    assert torch.equal(nv12[:, h:], before[:, h:])


# ------------------------------------------------------- the whole op ----


@pytest.mark.parametrize("h,w,clip,grid", GEOMETRIES)
def test_clahe_apply_equals_golden_and_cv2(h, w, clip, grid):
    """The three plain versions in a row (the JAX package's clahe_apply is
    compared on the NV12 slice in test_torch_enhancer.py)."""
    import cv2

    frames = _frames(9, 2, h, w)
    plan = torch_clahe.make_clahe_plan(h, w, clip, grid)
    got = torch_clahe.clahe_apply(torch.from_numpy(frames), plan).numpy()
    for i, y in enumerate(frames):
        assert np.array_equal(got[i], golden.clahe(y, clip, grid))
        assert np.array_equal(got[i], cv2.createCLAHE(clip, grid).apply(y))


# ---------------------------------------------------- wrapper contract ----


def test_wrappers_launch_nothing_on_cpu():
    from opencv_opencl_tpu_torch.ops import cuda, histeq

    cuda.reset_launch_counts()
    plan = torch_clahe.make_clahe_plan(32, 32, 2.0, (4, 4))
    y = torch.from_numpy(_frames(10, 1, 32, 32))
    torch_clahe.clahe_apply(y, plan)
    luts = natural.build_luts_ref(natural.tile_histograms_ref(y, plan),
                                  plan.clip, plan.lut_scale)
    natural.clahe_interp_and_hist(y, luts, plan)
    natural.clahe_interpolate_band(y[:, 8:24], luts, plan, 8)
    natural.clahe_interpolate_pack(y, luts, plan)
    histeq.equalize_hist_batch(y, device="cpu")
    assert cuda.launch_counts() == {
        "tile_histograms": 0, "build_luts": 0, "clahe_interpolate": 0,
        "clahe_interp_and_hist": 0, "clahe_interpolate_band": 0,
        "clahe_interpolate_pack": 0, "apply_lut": 0,
        "clahe_interpolate_cells": 0, "tile_histograms_extended": 0,
        "clahe_interpolate_cells_band": 0, "tile_histograms_batched": 0,
        "clahe_interpolate_cells_radix": 0}


def test_wrappers_reject_bad_inputs():
    plan = torch_clahe.make_clahe_plan(32, 32, 2.0, (4, 4))
    y = torch.zeros((1, 32, 32), dtype=torch.uint8)
    luts = torch.zeros((1, 16, 256), dtype=torch.uint8)
    with pytest.raises(TypeError):
        natural.tile_histograms(y.to(torch.int32), plan)
    with pytest.raises(ValueError):
        natural.tile_histograms(y[0], plan)                      # not a batch
    with pytest.raises(ValueError):
        natural.tile_histograms(torch.zeros((1, 32, 31), dtype=torch.uint8), plan)
    with pytest.raises(ValueError):
        natural.tile_histograms(y.transpose(1, 2).contiguous().transpose(1, 2),
                                plan)                            # column stride
    with pytest.raises(ValueError):
        natural.tile_histograms(y, plan, rowstep=3)              # 8 % 3
    with pytest.raises(TypeError):
        natural.build_luts(torch.zeros((1, 16, 256)), plan.clip, plan.lut_scale)
    with pytest.raises(ValueError):
        natural.build_luts(torch.zeros((1, 16, 255), dtype=torch.int32),
                           plan.clip, plan.lut_scale)
    with pytest.raises(ValueError):
        natural.clahe_interpolate(y, luts[:, :15], plan)
    with pytest.raises(ValueError):
        natural.clahe_interpolate(y, luts, plan,
                                  out=torch.zeros((2, 32, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        natural.clahe_interpolate(y.to("meta"), luts.to("meta"), plan)
