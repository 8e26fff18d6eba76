"""The port's CLAHE plan against the JAX package's, field by field.

The plan carries every constant of the step (tile geometry, padding, the
integer clip limit, the f32 LUT scale and interpolation weights), so it
must equal the JAX plan exactly: same values, same dtypes, and the f32
values bit for bit.  Tolerance: 0 (bit-equal).
"""

import dataclasses

import numpy as np
import pytest
import torch

from opencv_opencl_tpu.ops import clahe as jax_clahe
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe

torch.set_num_threads(1)

PLAN_CASES = [
    (2160, 3840, 2.0, (8, 8)),    # the main path: 4K, clip 2.0, 8x8
    (1079, 1919, 2.0, (8, 8)),    # odd: reflect-padded tiles
    (1080, 1920, 40.0, (8, 8)),
    (33, 47, 2.5, (8, 8)),
    (6, 6, 2.0, (8, 8)),          # tiles of one row
    (3, 3, 40.0, (8, 8)),         # pad >= dim: multi-reflection
    (270, 480, 2.0, (1, 1)),
    (97, 131, 40.0, (3, 5)),      # asymmetric grid
    (64, 128, 0.0, (8, 8)),       # clip 0: no clipping
]


def _assert_fields_equal(want, got):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), f.name
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            assert a.shape == b.shape, f.name
            # bit-equal, so a differently rounded f32 weight cannot pass
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert type(a) is type(b), (f.name, type(a), type(b))
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("h,w,clip,grid", PLAN_CASES)
def test_plan_equals_jax_plan(h, w, clip, grid):
    want = jax_clahe.make_clahe_plan(h, w, clip, grid)
    got = torch_clahe.make_clahe_plan(h, w, clip, grid)
    _assert_fields_equal(want, got)
    assert got.num_tiles == want.num_tiles
    assert got.tile_area == want.tile_area
    # lut_scale is the f32 value 255/area, not its f64 neighbour
    assert np.float32(got.lut_scale).view(np.int32) == np.float32(
        want.lut_scale).view(np.int32)
    assert float(np.float32(got.lut_scale)) == got.lut_scale


@pytest.mark.parametrize("h,w,clip,grid", PLAN_CASES)
def test_plan_from_jax_round_trips(h, w, clip, grid):
    jplan = jax_clahe.make_clahe_plan(h, w, clip, grid)
    carried = torch_clahe.plan_from_jax(jplan)
    _assert_fields_equal(jplan, carried)
    _assert_fields_equal(carried, torch_clahe.make_clahe_plan(h, w, clip, grid))


@pytest.mark.parametrize("h,w,clip,grid", PLAN_CASES[1:])
def test_plan_from_jax_gives_the_same_output(h, w, clip, grid):
    y = np.random.default_rng(7).integers(0, 256, (h, w), dtype=np.uint8)
    t = torch.from_numpy(y)
    carried = torch_clahe.plan_from_jax(jax_clahe.make_clahe_plan(h, w, clip, grid))
    own = torch_clahe.make_clahe_plan(h, w, clip, grid)
    assert torch.equal(torch_clahe.clahe_apply(t, carried),
                       torch_clahe.clahe_apply(t, own))


def test_device_arrays_keep_host_values():
    plan = torch_clahe.make_clahe_plan(1079, 1919, 2.0, (8, 8))
    arrays = plan.device_arrays("cpu")
    assert plan.device_arrays(torch.device("cpu")) is arrays  # cached per device
    for t, a in zip(arrays, (plan.ty1, plan.ty2, plan.ya, plan.tx1, plan.tx2,
                             plan.xa)):
        assert t.numpy().dtype == a.dtype
        assert t.numpy().tobytes() == a.tobytes()


@pytest.mark.parametrize("rowstep", [0, -1, 7])
def test_hist_rowstep_validated_like_jax(rowstep):
    # tile_h is 270 at 4K with 8 tile rows: 7 does not divide it
    jplan = jax_clahe.make_clahe_plan(2160, 3840, 2.0, (8, 8))
    plan = torch_clahe.make_clahe_plan(2160, 3840, 2.0, (8, 8))
    y = torch.zeros((2160, 3840), dtype=torch.uint8)
    with pytest.raises(ValueError, match="hist_rowstep"):
        torch_clahe.clahe_apply(y, plan, hist_rowstep=rowstep)
    with pytest.raises(ValueError, match="hist_rowstep"):
        jax_clahe.clahe_apply(np.zeros((2160, 3840), np.uint8), jplan,
                              hist_rowstep=rowstep)


def test_clahe_and_cv2_api_wrapper():
    import cv2

    y = np.random.default_rng(3).integers(0, 256, (2, 40, 60), dtype=np.uint8)
    c = torch_clahe.CLAHE(3.0, (4, 4), device="cpu")
    c.setClipLimit(2.0)
    c.setTilesGridSize((5, 3))
    assert c.getClipLimit() == 2.0 and c.getTilesGridSize() == (5, 3)
    out = c.apply(torch.from_numpy(y)).numpy()
    for i in range(2):
        assert np.array_equal(out[i], cv2.createCLAHE(2.0, (5, 3)).apply(y[i]))
    one = torch_clahe.clahe(y[0], 2.0, (5, 3), device="cpu")
    assert one.device.type == "cpu"
    assert np.array_equal(one.numpy(), out[0])
