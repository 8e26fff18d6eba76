"""The port's cell-grid CLAHE (K6) and second tile-histogram kernel (K8).

Same inputs, made with numpy from a seed, through the JAX package and the
port on CPU tensors, where the wrappers run their plain versions:

- ``make_interp_spec``: the port's spec is None exactly where the JAX
  package's is, and ``pad_top``, ``pad_left`` and ``cell_lut_idx`` agree,
  over a sweep of geometries (including the ones the JAX package refuses).
- K6's plain version against ``lut_kernels.clahe_interpolate_pallas`` in
  interpret mode (``assert_clahe_close``: the JAX CPU backend FMA-contracts
  the blend, tests/conftest.py), against ``golden.clahe_apply_luts`` and
  K3's plain version at 0 LSB.
- K8's plain version against ``lut_kernels.tile_histograms_pallas``,
  exactly, including the unaligned 27x30 tiles, and against K1's.
- ``clahe(backend="pallas")`` and ``"xla"`` against the JAX package's
  ``clahe`` with the same backend, and against cv2 at 0 LSB.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.ops import clahe as jax_clahe
from opencv_opencl_tpu.ops.pallas import lut_kernels
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops import cuda
from opencv_opencl_tpu_torch.ops.cuda import lut, natural
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)


def _frames(seed, n, h, w, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "constant":
        return np.full((n, h, w), 61, np.uint8)
    if kind == "structured":
        base = np.linspace(10, 200, w, dtype=np.float32)[None, :]
        return np.clip(base + rng.normal(0, 25, (n, h, w)), 0, 255).astype(np.uint8)
    return rng.integers(0, 256, (n, h, w), dtype=np.uint8)


def _luts(frames: torch.Tensor, plan) -> torch.Tensor:
    return natural.build_luts_ref(natural.tile_histograms_ref(frames, plan),
                                  plan.clip, plan.lut_scale)


# ---------------------------------------------------- make_interp_spec ----


SPEC_GEOMETRIES = [
    (2160, 3840, (8, 8)),     # 4K: the main path's geometry
    (1080, 1920, (8, 8)),     # tile height 135
    (720, 1280, (8, 8)),
    (1079, 1919, (8, 8)),     # reflect-padded tiles
    (96, 128, (8, 8)),
    (64, 64, (8, 8)),
    (64, 64, (4, 4)),
    (99, 28, (8, 11)),        # mixed divisibility
    (64, 10000, (1, 8)),      # one tile column 10000 wide
    (33, 47, (3, 5)),
    (3, 3, (8, 8)),           # pad >= dim
    (3000, 1919, (8, 8)),     # no cell mapping: None
    (649, 16, (1, 8)),        # no cell mapping: None
    (64, 20000, (1, 8)),      # a cell row's one-hot beyond 8 MB: None
]


@pytest.mark.parametrize("h,w,grid", SPEC_GEOMETRIES)
def test_interp_spec_equals_jax(h, w, grid):
    want = lut_kernels.make_interp_spec(h, w, 2.0, grid)
    got = lut.make_interp_spec(h, w, 2.0, grid)
    assert (got is None) == (want is None)
    if want is None:
        return
    for name in ("height", "width", "tiles_x", "tiles_y", "tile_h", "tile_w",
                 "pad_top", "pad_left"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.cell_lut_idx.dtype == np.int32
    assert np.array_equal(got.cell_lut_idx, want.cell_lut_idx)
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    assert got.ya is plan.ya and got.xa is plan.xa


def test_interp_spec_cells_reproduce_the_plan_indices():
    """Every pixel's cell names the four tiles the plan's per-pixel indices
    name: what makes K6 equal K3."""
    for h, w, grid in SPEC_GEOMETRIES:
        spec = lut.make_interp_spec(h, w, 2.0, grid)
        if spec is None:
            continue
        plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
        cy = (np.arange(h) + spec.pad_top) // spec.tile_h
        cx = (np.arange(w) + spec.pad_left) // spec.tile_w
        assert cy.max() < spec.cy and cx.max() < spec.cx
        idx = spec.cell_lut_idx
        assert np.array_equal(idx[cy, 0, 0] // plan.tiles_x, plan.ty1)
        assert np.array_equal(idx[cy, 0, 3] // plan.tiles_x, plan.ty2)
        assert np.array_equal(idx[0, cx, 0] % plan.tiles_x, plan.tx1)
        assert np.array_equal(idx[0, cx, 3] % plan.tiles_x, plan.tx2)


# ------------------------------------------------------------------ K6 ----


@pytest.mark.parametrize("h,w,grid", [
    (96, 128, (8, 8)),
    (64, 128, (4, 4)),
    (80, 160, (8, 4)),        # asymmetric
    (99, 28, (8, 11)),
])
def test_cells_ref_equals_jax_kernel_and_golden(h, w, grid):
    y = _frames(1, 1, h, w)[0]
    luts, th, tw = golden.clahe_luts(y, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    got = lut.clahe_interpolate_cells(
        torch.from_numpy(y[None]), torch.from_numpy(luts.reshape(1, -1, 256)),
        spec)[0].numpy()
    assert np.array_equal(got, golden.clahe_apply_luts(y, luts, th, tw))
    jspec = lut_kernels.make_interp_spec(h, w, 2.0, grid)
    want = lut_kernels.clahe_interpolate_pallas(
        jnp.asarray(y), jnp.asarray(luts.reshape(-1, 256)), jspec)
    assert_clahe_close(got, np.asarray(want))


@pytest.mark.parametrize("n,h,w,grid,kind", [
    (3, 96, 128, (8, 8), "structured"),
    (2, 66, 120, (8, 8), "random"),        # padded tiles
    (1, 1079, 1919, (8, 8), "structured"),
    (2, 64, 64, (16, 16), "random"),       # tiles of 4x4
    (2, 6, 6, (8, 8), "random"),           # tiles of one row
    (2, 64, 128, (8, 8), "constant"),
    (2, 33, 47, (3, 5), "random"),
])
def test_cells_ref_equals_k3_ref(n, h, w, grid, kind):
    frames = torch.from_numpy(_frames(2, n, h, w, kind))
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    luts = _luts(frames, plan)
    assert torch.equal(lut.clahe_interpolate_cells(frames, luts, spec),
                       natural.clahe_interpolate_ref(frames, luts, plan))


def test_cells_write_in_place_over_nv12_rows():
    h, w = 96, 128
    nv12 = torch.from_numpy(np.concatenate(
        [_frames(3, 2, h, w, "structured"), _frames(4, 2, h // 2, w)], axis=1))
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    spec = lut.make_interp_spec(h, w, 2.0, (8, 8))
    luts = _luts(nv12[:, :h], plan)
    want = natural.clahe_interpolate_ref(nv12[:, :h], luts, plan)
    work = nv12.clone()
    lut.clahe_interpolate_cells(work[:, :h], luts, spec, out=work[:, :h])
    assert torch.equal(work[:, :h], want)
    assert torch.equal(work[:, h:], nv12[:, h:])


def test_cells_reject_bad_inputs_and_the_radix_variant():
    spec = lut.make_interp_spec(32, 32, 2.0, (4, 4))
    y = torch.zeros((1, 32, 32), dtype=torch.uint8)
    luts = torch.zeros((1, 16, 256), dtype=torch.uint8)
    # the radix variant is taken, not refused, and checks its inputs too
    assert torch.equal(lut.clahe_interpolate_cells(y, luts, spec, radix=True),
                       lut.clahe_interpolate_cells(y, luts, spec))
    with pytest.raises(ValueError):
        lut.clahe_interpolate_cells(y, luts[:, :15], spec, radix=True)
    with pytest.raises(ValueError):
        lut.clahe_interpolate_cells(y, luts[:, :15], spec)
    with pytest.raises(ValueError):
        lut.clahe_interpolate_cells(torch.zeros((1, 32, 31), dtype=torch.uint8),
                                    luts, spec)
    with pytest.raises(ValueError):
        lut.clahe_interpolate_cells(y, luts, spec,
                                    out=torch.zeros((2, 32, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        lut.clahe_interpolate_cells(y.to("meta"), luts.to("meta"), spec)


# ------------------------------------------------------------------ K8 ----


@pytest.mark.parametrize("h,w,tiles_y,tiles_x,low", [
    (96, 256, 4, 2, 0),       # 4x2 tiles of 24x128
    (54, 90, 2, 3, 1),        # 27x30 tiles: the TPU's unaligned slack case
    (64, 64, 1, 1, 0),        # one tile: a whole-frame histogram
])
def test_extended_hists_ref_equals_jax_kernel(h, w, tiles_y, tiles_x, low):
    ext = np.random.default_rng(5).integers(low, 256, (2, h, w), dtype=np.uint8)
    th, tw = h // tiles_y, w // tiles_x
    got = lut.tile_histograms_extended(torch.from_numpy(ext), tiles_y, tiles_x,
                                       th, tw)
    assert got.dtype == torch.int32 and got.shape == (2, tiles_y * tiles_x, 256)
    for i in range(2):
        want = lut_kernels.tile_histograms_pallas(jnp.asarray(ext[i]), tiles_y,
                                                  tiles_x, th, tw)
        assert np.array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w,grid", [(96, 128, (8, 8)), (66, 120, (8, 8)),
                                      (40, 60, (1, 1))])
def test_extended_hists_equal_k1_on_the_extended_frame(h, w, grid):
    frames = torch.from_numpy(_frames(6, 2, h, w, "structured"))
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    ext = natural.extend(frames, plan)
    got = lut.tile_histograms_extended(ext, plan.tiles_y, plan.tiles_x,
                                       plan.tile_h, plan.tile_w)
    assert torch.equal(got, natural.tile_histograms_ref(frames, plan))


def test_extended_hists_take_strided_rows_and_reject_bad_shapes():
    nv12 = torch.from_numpy(_frames(7, 2, 144, 128))
    y = nv12[:, :96]
    assert not y.is_contiguous()
    assert torch.equal(lut.tile_histograms_extended(y, 4, 2, 24, 64),
                       lut.tile_histograms_extended(y.contiguous(), 4, 2, 24, 64))
    with pytest.raises(ValueError):
        lut.tile_histograms_extended(y, 4, 2, 24, 63)     # not tile-divisible
    with pytest.raises(ValueError):
        lut.tile_histograms_extended(y[0], 4, 2, 24, 64)  # not a batch


# ------------------------------------------------ clahe(backend=...) ----


@pytest.mark.parametrize("h,w,clip,grid", [
    (96, 128, 2.0, (8, 8)),
    (99, 28, 2.0, (8, 11)),
    (66, 120, 3.0, (4, 4)),
])
def test_pallas_backend_equals_jax_and_cv2(h, w, clip, grid):
    y = _frames(8, 1, h, w)[0]
    got = torch_clahe.clahe(y, clip, grid, backend="pallas", device="cpu").numpy()
    assert np.array_equal(got, cv2.createCLAHE(clip, grid).apply(y))
    want = jax_clahe.clahe(jnp.asarray(y), clip, grid, backend="pallas")
    assert_clahe_close(got, np.asarray(want))


@pytest.mark.parametrize("h,w,clip,grid", [(96, 128, 2.0, (8, 8)),
                                           (33, 47, 40.0, (3, 5))])
def test_xla_backend_equals_jax_and_cv2(h, w, clip, grid):
    frames = _frames(9, 2, h, w)
    got = torch_clahe.clahe(frames, clip, grid, backend="xla", device="cpu").numpy()
    for i, y in enumerate(frames):
        assert np.array_equal(got[i], cv2.createCLAHE(clip, grid).apply(y))
        want = jax_clahe.clahe(jnp.asarray(y), clip, grid, backend="xla")
        assert_clahe_close(got[i], np.asarray(want))


def test_backends_agree_on_a_batch_with_rowstep_and_out():
    h, w = 96, 128
    frames = torch.from_numpy(_frames(10, 3, h, w, "structured"))
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    results = {}
    for backend in ("auto", "natural", "pallas", "xla"):
        for rowstep in (1, 2):
            out = torch.empty_like(frames)
            res = torch_clahe.clahe_apply(frames, plan, backend=backend,
                                          hist_rowstep=rowstep, out=out)
            assert res.data_ptr() == out.data_ptr()
            results[backend, rowstep] = out
    for rowstep in (1, 2):
        for backend in ("natural", "pallas", "xla"):
            assert torch.equal(results[backend, rowstep], results["auto", rowstep])
    jplan = jax_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    want = jax_clahe.clahe_apply(jnp.asarray(frames[0].numpy()), jplan,
                                 backend="pallas", hist_rowstep=2)
    assert_clahe_close(results["pallas", 2][0].numpy(), np.asarray(want))


def test_pallas_backend_raises_where_jax_raises():
    y = np.zeros((3000, 28), np.uint8)
    with pytest.raises(ValueError, match="no pallas fast path"):
        jax_clahe.clahe(jnp.asarray(y), 2.0, (8, 8), backend="pallas")
    with pytest.raises(ValueError, match="no pallas fast path"):
        torch_clahe.clahe(y, 2.0, (8, 8), backend="pallas", device="cpu")
    # the other backends take that geometry
    small = _frames(11, 1, 300, 28)[0]
    assert np.array_equal(
        torch_clahe.clahe(small, 2.0, (8, 8), backend="xla", device="cpu").numpy(),
        torch_clahe.clahe(small, 2.0, (8, 8), device="cpu").numpy())


def test_method_and_backend_are_checked():
    y = _frames(12, 1, 32, 32)[0]
    onehot = torch_clahe.clahe(y, 2.0, (4, 4), method="onehot", device="cpu")
    assert torch.equal(
        torch_clahe.clahe(y, 2.0, (4, 4), method="scatter", device="cpu"), onehot)
    assert torch.equal(
        torch_clahe.CLAHE(2.0, (4, 4), device="cpu").apply(y, "scatter"), onehot)
    with pytest.raises(ValueError, match="unknown histogram method"):
        torch_clahe.clahe(y, 2.0, (4, 4), method="radix", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        torch_clahe.clahe(y, 2.0, (4, 4), backend="tpu", device="cpu")


def test_cpu_paths_launch_no_kernel():
    cuda.reset_launch_counts()
    frames = torch.from_numpy(_frames(13, 2, 32, 32))
    plan = torch_clahe.make_clahe_plan(32, 32, 2.0, (4, 4))
    torch_clahe.clahe_apply(frames, plan, backend="pallas")
    lut.tile_histograms_extended(frames, 4, 4, 8, 8)
    assert set(cuda.launch_counts().values()) == {0}
