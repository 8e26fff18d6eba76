"""The port's auto-CLAHE (per-frame entropy-scaled clip) against the JAX
package and cv2.

Same frames, made with numpy from a seed, through
``opencv_opencl_tpu.ops.auto_clahe`` and the port's on CPU tensors.
Tolerances:

- the f32 clip limit: within 3 ulps of the JAX package's.  It is an f32 sum
  of 256 ``p * log2 p`` terms, whose order and ``log2`` XLA and torch do
  not share; 3 ulps is the largest difference measured over 240 seeded
  frames of random, narrow-normal and sparse content (most are 0-1);
- the integer clip that the LUTs use: equal;
- K2 with one clip per frame against ``_luts_with_traced_clip``: exact;
- ``clahe_auto``'s output: 0 LSB against cv2 at the clip the JAX package
  chose, and within ``assert_clahe_close`` of the JAX package's output
  (the JAX CPU backend FMA-contracts the blend, tests/conftest.py).

The last four tests are the port's copies of ``tests/test_auto_clahe.py``.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.ops import auto_clahe as jax_auto
from opencv_opencl_tpu.ops import clahe as jax_clahe
from opencv_opencl_tpu_torch.ops import auto_clahe
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops.cuda import natural
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

CLIP_ULPS = 3


def _frame(seed, h, w, kind):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "narrow":
        return np.clip(rng.normal(128, 6, (h, w)), 0, 255).astype(np.uint8)
    if kind == "sparse":
        return rng.choice(np.arange(0, 256, 9, dtype=np.uint8), (h, w))
    if kind == "flat":
        return np.full((h, w), 100, np.uint8)
    base = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    return np.clip(base + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _ulps(a, b) -> int:
    ia = np.float32(a).view(np.int32).astype(np.int64)
    ib = np.float32(b).view(np.int32).astype(np.int64)
    return int(abs(ia - ib))


def _int_clip(clip: float, tile_area: int) -> int:
    """The JAX package's integer clip: max(int32(f32(clip * area) / 256), 1)."""
    return max(int(np.float32(np.float32(clip) * np.float32(tile_area))
                   / np.float32(256.0)), 1)


FRAMES = [(seed, h, w, kind) for seed, (h, w) in enumerate(
    [(64, 64), (96, 128), (37, 91), (120, 200)])
    for kind in ("random", "narrow", "sparse", "gradient")]


@pytest.mark.parametrize("seed,h,w,kind", FRAMES)
def test_clip_estimate_equals_jax(seed, h, w, kind):
    y = _frame(seed, h, w, kind)
    want = float(jax_auto.estimate_clip_limit(jnp.asarray(y)))
    got = auto_clahe.estimate_clip_limit(torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == ()
    assert _ulps(float(got), want) <= CLIP_ULPS, (float(got), want)
    for grid in ((8, 8), (4, 4)):
        area = torch_clahe.make_clahe_plan(h, w, 40.0, grid).tile_area
        assert _int_clip(float(got), area) == _int_clip(want, area)


def test_clip_estimate_of_a_batch_is_per_frame():
    frames = np.stack([_frame(i, 48, 80, k)
                       for i, k in enumerate(("random", "narrow", "flat"))])
    got = auto_clahe.estimate_clip_limit(torch.from_numpy(frames), 0.5, 3.5)
    assert got.shape == (3,)
    for i in range(3):
        one = auto_clahe.estimate_clip_limit(torch.from_numpy(frames[i]), 0.5, 3.5)
        assert torch.equal(got[i], one)
    want = np.asarray(jax.vmap(
        lambda f: jax_auto.estimate_clip_limit(f, 0.5, 3.5))(jnp.asarray(frames)))
    assert max(_ulps(g, w) for g, w in zip(got.numpy(), want)) <= CLIP_ULPS


@pytest.mark.parametrize("h,w,grid", [(96, 128, (8, 8)), (66, 120, (4, 4))])
def test_luts_with_per_frame_clip_equal_jax(h, w, grid):
    frames = np.stack([_frame(20 + i, h, w, k)
                       for i, k in enumerate(("random", "gradient", "narrow"))])
    plan = torch_clahe.make_clahe_plan(h, w, 40.0, grid)
    jplan = jax_clahe.make_clahe_plan(h, w, 40.0, grid)
    hists = natural.tile_histograms_ref(torch.from_numpy(frames), plan)
    clips = np.array([1.0, 2.37, 3.99], np.float32)
    got = auto_clahe.luts_with_clip(hists, plan, torch.from_numpy(clips))
    for i in range(3):
        want = jax_auto._luts_with_traced_clip(
            jnp.asarray(hists[i].numpy()), jplan, jnp.float32(clips[i]))
        assert np.array_equal(got[i].numpy(), np.asarray(want))


def test_build_luts_takes_a_per_frame_clip_tensor():
    frames = torch.from_numpy(np.stack([_frame(30 + i, 64, 64, "random")
                                        for i in range(3)]))
    plan = torch_clahe.make_clahe_plan(64, 64, 2.0, (4, 4))
    hists = natural.tile_histograms_ref(frames, plan)
    clips = [1, 0, 77]            # 0: no clipping for that frame
    got = natural.build_luts(hists, torch.tensor(clips, dtype=torch.int32),
                             plan.lut_scale)
    for i, c in enumerate(clips):
        assert torch.equal(got[i:i + 1],
                           natural.build_luts(hists[i:i + 1], c, plan.lut_scale))


def test_build_luts_rejects_a_bad_clip_tensor():
    plan = torch_clahe.make_clahe_plan(32, 32, 2.0, (4, 4))
    hists = torch.zeros((2, 16, 256), dtype=torch.int32)
    for bad in (torch.ones(3, dtype=torch.int32),           # not one per frame
                torch.ones((2, 1), dtype=torch.int32),
                torch.ones(2, dtype=torch.int64),            # not int32
                torch.ones(2, dtype=torch.float32),
                torch.ones(2, dtype=torch.int32, device="meta")):  # other device
        with pytest.raises(ValueError, match="clip"):
            natural.build_luts(hists, bad, plan.lut_scale)


@pytest.mark.parametrize("h,w,grid", [(96, 128, (8, 8)), (64, 64, (4, 4)),
                                      (66, 120, (8, 8))])
def test_clahe_auto_equals_jax_and_cv2(h, w, grid):
    frames = np.stack([_frame(40 + i, h, w, k)
                       for i, k in enumerate(("random", "gradient", "narrow"))])
    got, clips = auto_clahe.clahe_auto(frames, grid, device="cpu")
    assert got.shape == frames.shape and clips.shape == (3,)
    want, want_clips = jax_auto.clahe_auto(jnp.asarray(frames), grid)
    area = torch_clahe.make_clahe_plan(h, w, 40.0, grid).tile_area
    for i in range(3):
        c_jax = float(want_clips[i])
        assert _ulps(float(clips[i]), c_jax) <= CLIP_ULPS
        assert _int_clip(float(clips[i]), area) == _int_clip(c_jax, area)
        assert_clahe_close(got[i].numpy(), np.asarray(want[i]))
        # cv2 reckons its integer clip in f64; at these clips it is the same
        assert max(int(c_jax * area / 256.0), 1) == _int_clip(c_jax, area)
        ref = cv2.createCLAHE(clipLimit=c_jax, tileGridSize=grid).apply(frames[i])
        assert np.array_equal(got[i].numpy(), ref)


def test_clahe_auto_runs_k3_where_there_is_no_cell_spec():
    """3000 rows on 8 tile rows have no cell-grid spec: the step takes K3,
    and still equals cv2 at its own clip."""
    y = _frame(50, 3000, 24, "gradient")
    out, clip = auto_clahe.clahe_auto(y, (8, 8), device="cpu")
    ref = cv2.createCLAHE(clipLimit=float(clip), tileGridSize=(8, 8)).apply(y)
    assert np.array_equal(out.numpy(), ref)


def test_clahe_auto_checks_method():
    y = _frame(51, 32, 32, "random")
    a, ca = auto_clahe.clahe_auto(y, (4, 4), method="onehot", device="cpu")
    b, cb = auto_clahe.clahe_auto(y, (4, 4), method="scatter", device="cpu")
    assert torch.equal(a, b) and torch.equal(ca, cb)
    with pytest.raises(ValueError, match="unknown histogram method"):
        auto_clahe.clahe_auto(y, (4, 4), method="radix", device="cpu")


# ------------------------------------- copies of tests/test_auto_clahe.py ----


def test_estimator_bounds(rng):
    flat = np.full((64, 64), 100, np.uint8)
    rich = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    c_flat = float(auto_clahe.estimate_clip_limit(torch.from_numpy(flat)))
    c_rich = float(auto_clahe.estimate_clip_limit(torch.from_numpy(rich)))
    assert 1.0 <= c_flat < c_rich <= 4.0
    assert c_flat == 1.0  # zero entropy -> clip_min
    assert c_rich > 3.5   # near-uniform histogram -> near clip_max


def test_auto_clahe_matches_fixed_clip(rng):
    y = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    out, clip = auto_clahe.clahe_auto(y, (8, 8), device="cpu")
    ref = cv2.createCLAHE(clipLimit=float(clip), tileGridSize=(8, 8)).apply(y)
    assert np.array_equal(out.numpy(), ref)


def test_auto_clahe_batch(rng):
    batch = rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
    out, clips = auto_clahe.clahe_auto(batch, (4, 4), device="cpu")
    assert out.shape == batch.shape
    assert clips.shape == (3,)


def test_clip_varies_with_content(rng):
    lowc = np.clip(rng.normal(128, 4, (64, 64)), 0, 255).astype(np.uint8)
    highc = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    _, c1 = auto_clahe.clahe_auto(lowc, (4, 4), device="cpu")
    _, c2 = auto_clahe.clahe_auto(highc, (4, 4), device="cpu")
    assert float(c1) < float(c2)
