"""The port's K10 (row-batched tile histograms) and K6r (the radix variant
of the cell-grid interpolation).

Same inputs, made with numpy from a seed, through the JAX package and the
port on CPU tensors, where the wrappers run their plain versions:

- ``tile_histograms_batched`` against
  ``experiments.tile_histograms_radix_batched`` in interpret mode for
  ``batch_rows`` 2, 4 and 8, against ``natural.tile_histograms_radix``, and
  against the port's K1 and K8 plain versions: **exact** (integer counts).
  The ``ValueError`` for another ``batch_rows`` carries the JAX message.
- ``clahe_interpolate_cells(radix=True)`` against
  ``lut_kernels.clahe_interpolate_pallas(radix=True)`` in interpret mode with
  ``assert_clahe_close`` (at most 1 LSB on tie pixels: the JAX CPU backend
  FMA-contracts the blend, tests/conftest.py), and against
  ``golden.clahe_apply_luts``, the port's ``radix=False`` and K3's plain
  version at **0 LSB**.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.ops.pallas import experiments, lut_kernels
from opencv_opencl_tpu.ops.pallas import natural as jax_natural
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops import cuda
from opencv_opencl_tpu_torch.ops.cuda import lut, natural
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)


def _frames(seed, n, h, w, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "constant":
        return np.full((n, h, w), 61, np.uint8)
    return rng.integers(0, 256, (n, h, w), dtype=np.uint8)


# ----------------------------------------------------------------- K10 ----


@pytest.mark.parametrize("batch_rows", [2, 4, 8])
@pytest.mark.parametrize("kind", ["random", "constant"])
def test_batched_hists_equal_jax_batched_and_unbatched(batch_rows, kind):
    y = _frames(31, 1, 96, 256, kind)[0]
    args = (4, 2, 24, 128)
    want = np.asarray(experiments.tile_histograms_radix_batched(
        y, *args, interpret=True, batch_rows=batch_rows))
    base = np.asarray(jax_natural.tile_histograms_radix(y, *args, interpret=True))
    got = natural.tile_histograms_batched(torch.from_numpy(y), *args,
                                          batch_rows=batch_rows)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), base)
    assert int(got.sum()) == y.size


@pytest.mark.parametrize("batch_rows", [2, 4, 8])
def test_batched_hists_on_a_batch_equal_jax_per_frame_and_k1_k8(batch_rows):
    """(N, He, We) in, (N, T, 256) out; the 27x30 tiles are aligned to nothing
    (the JAX kernel pads them and takes the padding out of bin 0)."""
    frames = _frames(32, 3, 108, 120)
    args = (4, 4, 27, 30)
    t = torch.from_numpy(frames)
    got = natural.tile_histograms_batched(t, *args, batch_rows=batch_rows)
    assert tuple(got.shape) == (3, 16, 256)
    for i, f in enumerate(frames):
        want = np.asarray(experiments.tile_histograms_radix_batched(
            f, *args, interpret=True, batch_rows=batch_rows))
        assert np.array_equal(got[i].numpy(), want), i
    plan = torch_clahe.make_clahe_plan(108, 120, 2.0, (4, 4))
    assert (plan.tile_h, plan.tile_w) == (27, 30)
    assert torch.equal(got, natural.tile_histograms_ref(t, plan))
    assert torch.equal(got, lut.tile_histograms_extended_ref(t, *args))
    assert torch.equal(got, natural.tile_histograms_batched_ref(t, *args))


def test_batched_hists_of_an_extended_odd_frame_equal_k1():
    """A 97x131 frame on a 3x5 grid, reflect-extended to its tile multiple
    first, as K10's contract has it; a strided view goes in as it is."""
    frames = _frames(33, 2, 97, 131)
    plan = torch_clahe.make_clahe_plan(97, 131, 2.0, (5, 3))
    t = torch.from_numpy(frames)
    ext = natural.extend(t, plan)
    args = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
    got = natural.tile_histograms_batched(ext, *args, batch_rows=4)
    assert torch.equal(got, natural.tile_histograms_ref(t, plan))
    wide = torch.zeros((2, ext.shape[1], ext.shape[2] + 9), dtype=torch.uint8)
    wide[:, :, 5:5 + ext.shape[2]] = ext
    view = wide[:, :, 5:5 + ext.shape[2]]
    assert not view.is_contiguous()
    assert torch.equal(natural.tile_histograms_batched(view, *args), got)


def test_batched_hists_reject_bad_batch_rows_and_shapes():
    y = np.zeros((16, 128), np.uint8)
    with pytest.raises(ValueError, match=r"batch_rows") as jax_err:
        experiments.tile_histograms_radix_batched(y, 1, 1, 16, 128, batch_rows=3)
    with pytest.raises(ValueError, match=r"batch_rows") as port_err:
        natural.tile_histograms_batched(torch.from_numpy(y), 1, 1, 16, 128,
                                        batch_rows=3)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError):
        natural.tile_histograms_batched(torch.from_numpy(y), 1, 1, 16, 64)
    with pytest.raises(ValueError):
        natural.tile_histograms_batched(torch.from_numpy(y), 2, 1, 16, 128)
    with pytest.raises(TypeError):
        natural.tile_histograms_batched(torch.zeros((16, 128)), 1, 1, 16, 128)
    with pytest.raises(ValueError):
        natural.tile_histograms_batched(torch.from_numpy(y)[None, None],
                                        1, 1, 16, 128)


def test_new_wrappers_count_no_launch_on_the_cpu():
    cuda.reset_launch_counts()
    y = torch.from_numpy(_frames(34, 1, 32, 32))
    natural.tile_histograms_batched(y, 4, 4, 8, 8)
    spec = lut.make_interp_spec(32, 32, 2.0, (4, 4))
    luts = torch.zeros((1, 16, 256), dtype=torch.uint8)
    lut.clahe_interpolate_cells(y, luts, spec, radix=True)
    counts = cuda.launch_counts()
    assert counts["tile_histograms_batched"] == 0
    assert counts["clahe_interpolate_cells_radix"] == 0
    assert counts["clahe_interpolate_cells"] == 0


# ----------------------------------------------------------------- K6r ----


@pytest.mark.parametrize("h,w,grid", [
    (96, 128, (8, 8)),        # the JAX package's own radix case
    (270, 480, (8, 8)),
    (66, 120, (8, 8)),        # reflect-padded tiles
    (99, 28, (8, 11)),        # mixed divisibility, pad_top / pad_left bumped
    (40, 60, (1, 1)),         # every cell: one LUT four times
])
def test_radix_cells_equal_jax_radix_golden_and_the_plain_forms(h, w, grid):
    y = _frames(41, 1, h, w)[0]
    luts, th, tw = golden.clahe_luts(y, 2.0, grid)
    jax_spec = lut_kernels.make_interp_spec(h, w, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    assert jax_spec is not None and spec is not None
    want_jax = np.asarray(lut_kernels.clahe_interpolate_pallas(
        jnp.asarray(y), jnp.asarray(luts.reshape(-1, 256)), jax_spec,
        interpret=True, radix=True))
    ref = golden.clahe_apply_luts(y, luts, th, tw)

    ty = torch.from_numpy(y)[None]
    tl = torch.from_numpy(np.ascontiguousarray(luts.reshape(1, -1, 256)))
    got = lut.clahe_interpolate_cells(ty, tl, spec, radix=True)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, h, w)
    assert_clahe_close(got[0].numpy(), want_jax)
    assert np.array_equal(got[0].numpy(), ref)                      # 0 LSB
    assert torch.equal(got, lut.clahe_interpolate_cells(ty, tl, spec))
    assert torch.equal(got, lut.clahe_interpolate_cells_ref(ty, tl, spec, radix=True))
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    assert torch.equal(got, natural.clahe_interpolate_ref(ty, tl, plan))


def test_radix_cells_on_a_batch_in_place_over_nv12_rows():
    """Other frames' LUTs per frame, strided Y rows, ``out`` aliasing ``y``."""
    h, w, grid = 64, 96, (4, 4)
    rng = np.random.default_rng(42)
    nv12 = torch.from_numpy(rng.integers(0, 256, (3, h * 3 // 2, w), dtype=np.uint8))
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    luts = natural.build_luts_ref(
        natural.tile_histograms_ref(torch.from_numpy(_frames(43, 3, h, w)), plan),
        plan.clip, plan.lut_scale)
    want = natural.clahe_interpolate_ref(nv12[:, :h], luts, plan)
    work = nv12.clone()
    lut.clahe_interpolate_cells(work[:, :h], luts, spec, out=work[:, :h], radix=True)
    assert torch.equal(work[:, :h], want)
    assert torch.equal(work[:, h:], nv12[:, h:])


def test_cell_pack_holds_each_cells_four_luts_by_hi_and_lo():
    h, w, grid = 64, 64, (4, 4)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    rng = np.random.default_rng(44)
    luts = torch.from_numpy(rng.integers(0, 256, (2, 16, 256), dtype=np.uint8))
    pack = lut.build_cell_pack(luts, spec)
    assert tuple(pack.shape) == (2, spec.cy, spec.cx, 16, 16, 4)
    for cy, cx, v in ((0, 0, 0), (2, 3, 200), (4, 4, 255), (1, 4, 17)):
        for j in range(4):
            tile = int(spec.cell_lut_idx[cy, cx, j])
            assert torch.equal(pack[:, cy, cx, v >> 4, v & 15, j], luts[:, tile, v])
    # a corner cell names one LUT four times
    assert len(set(spec.cell_lut_idx[0, 0].tolist())) == 1
