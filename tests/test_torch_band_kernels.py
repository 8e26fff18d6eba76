"""The port's band kernels: K5 and K3v1 (the pack interpolation), K9 (the
cell-grid interpolation on a band) and K1 on a band of tile rows.

Same inputs, made with numpy from a seed, through the JAX package and the
port on CPU tensors, where the wrappers run their plain versions:

- the pack geometry (``make_pack_spec``) against ``NaturalSpec`` field for
  field, and the pack gathered at a pixel's value against the four direct
  LUT lookups;
- K5 against ``natural.clahe_interpolate_natural_band`` in interpret mode,
  every band of the sharded geometry for ``space`` 2, 3 and 4, with
  ``assert_clahe_close`` (the JAX CPU backend FMA-contracts the blend,
  tests/conftest.py); against ``core/golden.py`` and K3's plain version at
  0 LSB; and K5's blocks as ``interp_kernel`` walks them (the band's row
  ranges, each blending its rows with the one row pair's pack it stages)
  against golden at 0 LSB;
- K3v1 against ``clahe_interpolate_natural(variant=1)`` the same way;
- K9 against ``lut_kernels.clahe_interpolate_pallas_band`` in interpret
  mode on bands at ``row0`` that are and are not multiples of ``tile_h``,
  and exactly against K6's plain version;
- K1 per band of tile rows (with fake tile rows) against K1 on the whole
  frame and against ``natural.tile_histograms_radix`` on the band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.ops import clahe as jax_clahe
from opencv_opencl_tpu.ops.pallas import lut_kernels
from opencv_opencl_tpu.ops.pallas import natural as jax_natural
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops.cuda import lut, natural
from opencv_opencl_tpu_torch.parallel.sharded import _clahe_geometry
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

CLIP = 2.0
GEOMETRIES = [
    (64, 128, (8, 8)),
    (63, 127, (8, 8)),     # reflect-padded tiles
    (97, 131, (8, 8)),     # odd geometry
    (67, 131, (5, 3)),     # odd grid
]


def _frames(seed, n, h, w):
    rng = np.random.default_rng(seed)
    base = np.linspace(10, 200, w, dtype=np.float32)[None, :]
    return np.clip(base + rng.normal(0, 30, (n, h, w)), 0, 255).astype(np.uint8)


def _luts(frames: torch.Tensor, plan) -> torch.Tensor:
    return natural.build_luts_ref(natural.tile_histograms_ref(frames, plan),
                                  plan.clip, plan.lut_scale)


def _bands(h, space):
    """The sharded step's interpolation bands: (row0, rows_loc) per
    position, rows_loc a multiple of 8."""
    rows_loc = -(-h // (8 * space)) * 8
    return [(s * rows_loc, rows_loc) for s in range(space)]


# ---------------------------------------------------------------- pack ----


@pytest.mark.parametrize("h,w,grid", GEOMETRIES + [(1080, 1920, (8, 8)),
                                                   (3, 3, (8, 8))])
def test_pack_spec_equals_jax_natural_spec(h, w, grid):
    want = jax_natural.make_natural_spec(h, w, CLIP, grid, rs=8)
    got = natural.make_pack_spec(h, w, CLIP, grid)
    assert (got.groups, got.row_pairs) == (want.groups, want.row_pairs)
    rows, groups, stride = want.row_pairs, want.groups, want.pack_rows
    theirs = want.pack_idx.reshape(rows, stride)
    for j in range(4):      # l11, l12, l21, l22
        assert np.array_equal(got.pack_idx[:, :, j],
                              theirs[:, j * groups:(j + 1) * groups]), j
    assert np.array_equal(got.rp_of_r, want.rp_rows.reshape(-1)[:h])
    assert np.array_equal(got.ya, want.ya_rows.reshape(-1)[:h])
    # the JAX package's column-group masks select column c's group
    assert np.array_equal(got.g_of_c, want.m_table[:groups].argmax(axis=0))
    assert np.array_equal(got.xa, want.xat[1])
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    assert got.ya is plan.ya and got.xa is plan.xa


@pytest.mark.parametrize("h,w,grid", GEOMETRIES)
def test_pack_holds_the_four_direct_lookups(h, w, grid):
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    spec = natural.make_pack_spec(h, w, CLIP, grid)
    y = torch.from_numpy(_frames(2, 2, h, w))
    luts = _luts(y, plan)
    pack = natural.build_lut_pack(luts, spec)
    assert pack.shape == (2, spec.row_pairs, spec.groups, 256, 4)
    assert pack.is_contiguous() and pack.dtype == torch.uint8
    n = torch.arange(2)[:, None, None]
    four = pack[n, torch.from_numpy(spec.rp_of_r).long()[None, :, None],
                torch.from_numpy(spec.g_of_c).long()[None, None, :], y.long()]
    tiles = luts.reshape(2, plan.tiles_y, plan.tiles_x, 256)
    for j, (ty, tx) in enumerate(((plan.ty1, plan.tx1), (plan.ty1, plan.tx2),
                                  (plan.ty2, plan.tx1), (plan.ty2, plan.tx2))):
        direct = tiles[n, torch.from_numpy(ty).long()[None, :, None],
                       torch.from_numpy(tx).long()[None, None, :], y.long()]
        assert torch.equal(four[..., j], direct), j


def test_pack_spec_rejects_indices_off_the_clip_pattern():
    with pytest.raises(ValueError, match="pattern"):
        natural._pair_ids(np.array([0, 0, 2]), np.array([0, 1, 2]), 4)


# ------------------------------------------------------------------ K5 ----


@pytest.mark.parametrize("space", [2, 3, 4])
@pytest.mark.parametrize("h,w,grid", GEOMETRIES)
def test_band_equals_jax_kernel_golden_and_k3(h, w, grid, space):
    y = _frames(3, 1, h, w)[0]
    luts_np, th, tw = golden.clahe_luts(y, CLIP, grid)
    want = golden.clahe_apply_luts(y, luts_np, th, tw)
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    yt = torch.from_numpy(y[None])
    luts = torch.from_numpy(luts_np.reshape(1, -1, 256))
    assert np.array_equal(natural.clahe_interpolate_ref(yt, luts, plan)[0].numpy(),
                          want)
    hq = _clahe_geometry(plan, space)[2]
    assert hq == space * _bands(h, space)[0][1]
    nspec = jax_natural.make_natural_spec(h, w, CLIP, grid, rs=8, rows_pad=hq)
    y_pad = np.zeros((hq, w), np.uint8)
    y_pad[:h] = y
    for row0, rows_loc in _bands(h, space):
        live = max(0, min(rows_loc, h - row0))
        band = yt[:, row0:row0 + live]
        got = natural.clahe_interpolate_band(band, luts, plan, row0)[0].numpy()
        assert got.shape == (live, w)
        assert np.array_equal(got, want[row0:row0 + live]), row0
        jax_band = np.asarray(jax_natural.clahe_interpolate_natural_band(
            jnp.asarray(y_pad[row0:row0 + rows_loc]),
            jnp.asarray(luts_np.reshape(-1, 256)), nspec, row0, interpret=True))
        if live:
            assert_clahe_close(got, jax_band[:live])


def _k5_blocks(band: torch.Tensor, luts: torch.Tensor, plan, row0: int) -> torch.Tensor:
    """K5 as ``interp_kernel`` computes it, block by block: the band's row
    ranges (global rows), each blended with the pack of the row pair of its
    first row (what the block stages), read at ``row - row0``."""
    spec = natural.make_pack_spec(plan.height, plan.width, CLIP,
                                  (plan.tiles_x, plan.tiles_y))
    n, rows, _ = band.shape
    live = natural.live_rows(rows, plan.height, row0)
    pack = natural.build_lut_pack(luts, spec).to(torch.float32)   # (N, R, G, 256, 4)
    groups = torch.from_numpy(spec.g_of_c).long()[None, None, :]
    frames = torch.arange(n)[:, None, None]
    out = band.clone()
    if not live:            # the wrapper launches nothing
        return out
    ranges = spec.row_ranges(natural.interp_rows_per_block(n, live),
                             span=(row0, row0 + live))
    for lo, hi in ranges:
        staged = pack[:, spec.rp_of_r[lo]]                      # (N, G, 256, 4)
        four = staged[frames, groups, band[:, lo - row0:hi - row0].long()]
        ya = torch.from_numpy(spec.ya[lo:hi])[None, :, None]
        out[:, lo - row0:hi - row0] = natural.blend(
            four[..., 0], four[..., 1], four[..., 2], four[..., 3],
            torch.from_numpy(spec.xa), ya)
    return out


@pytest.mark.parametrize("space", [2, 3, 4])
@pytest.mark.parametrize("h,w,grid", GEOMETRIES + [(270, 480, (8, 8))])
def test_band_blocks_of_the_kernel_equal_golden(h, w, grid, space):
    y = _frames(10, 2, h, w)
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    want = np.stack([golden.clahe(f, CLIP, grid) for f in y])
    yt = torch.from_numpy(y)
    luts = _luts(yt, plan)
    bands = _bands(h, space) + [(h // 2 + 1, h), (h - 3, 8)]   # inside a pair, past the end
    for row0, rows in bands:
        band = torch.cat([yt[:, row0:], yt[:, :rows]], dim=1)[:, :rows]
        live = natural.live_rows(rows, h, row0)
        got = _k5_blocks(band, luts, plan, row0)
        assert np.array_equal(got[:, :live].numpy(), want[:, row0:row0 + live]), row0
        assert torch.equal(got[:, live:], band[:, live:])
        assert torch.equal(got, natural.clahe_interpolate_band(band, luts, plan, row0))


def test_band_any_row0_in_place_and_past_the_frame():
    h, w, grid = 63, 127, (8, 8)
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    y = torch.from_numpy(_frames(4, 2, h, w))
    luts = _luts(y, plan)
    want = natural.clahe_interpolate_ref(y, luts, plan)
    for row0, rows in ((0, h), (5, 13), (17, 46), (62, 1), (31, 0)):
        got = natural.clahe_interpolate_band(y[:, row0:row0 + rows], luts, plan, row0)
        assert torch.equal(got, want[:, row0:row0 + rows]), row0
    # in place over the rows of a larger buffer; the other rows stay
    buf = torch.cat([y, torch.full((2, 9, w), 7, dtype=torch.uint8)], dim=1)
    keep = buf.clone()
    band = buf[:, 8:40]
    assert natural.clahe_interpolate_band(band, luts, plan, 8, out=band) is band
    assert torch.equal(buf[:, 8:40], want[:, 8:40])
    assert torch.equal(buf[:, :8], keep[:, :8]) and torch.equal(buf[:, 40:], keep[:, 40:])
    # a band that runs past the frame's last row: those rows come back as
    # they went in
    past = torch.cat([y[:, 56:], torch.full((2, 9, w), 7, dtype=torch.uint8)], dim=1)
    got = natural.clahe_interpolate_band(past, luts, plan, 56)
    assert torch.equal(got[:, :h - 56], want[:, 56:])
    assert torch.equal(got[:, h - 56:], past[:, h - 56:])


def test_band_rejects_bad_inputs():
    plan = torch_clahe.make_clahe_plan(32, 32, CLIP, (4, 4))
    y = torch.zeros((1, 16, 32), dtype=torch.uint8)
    luts = torch.zeros((1, 16, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="row0"):
        natural.clahe_interpolate_band(y, luts, plan, -8)
    with pytest.raises(ValueError, match="wide"):
        natural.clahe_interpolate_band(y[:, :, :31], luts, plan, 0)
    with pytest.raises(ValueError, match="luts shape"):
        natural.clahe_interpolate_band(y, luts[:, :15], plan, 0)
    with pytest.raises(ValueError, match="out must match"):
        natural.clahe_interpolate_band(y, luts, plan, 0, out=y[:, :8])
    with pytest.raises(TypeError):
        natural.clahe_interpolate_band(y.to(torch.int32), luts, plan, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        natural.clahe_interpolate_band(y.to("meta"), luts.to("meta"), plan, 0)
    spec = lut.make_interp_spec(32, 32, CLIP, (4, 4))
    with pytest.raises(ValueError, match="row0"):
        lut.clahe_interpolate_cells_band(y, luts, spec, -1)
    with pytest.raises(ValueError, match="wide"):
        lut.clahe_interpolate_cells_band(y[:, :, :31], luts, spec, 0)


# ---------------------------------------------------------------- K3v1 ----


@pytest.mark.parametrize("h,w,grid", GEOMETRIES)
def test_pack_interpolation_equals_jax_variant1_golden_and_k3(h, w, grid):
    y = _frames(5, 1, h, w)[0]
    luts_np, th, tw = golden.clahe_luts(y, CLIP, grid)
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    yt = torch.from_numpy(y[None])
    luts = torch.from_numpy(luts_np.reshape(1, -1, 256))
    got = natural.clahe_interpolate_pack(yt, luts, plan)
    assert torch.equal(got, natural.clahe_interpolate_ref(yt, luts, plan))
    assert np.array_equal(got[0].numpy(), golden.clahe_apply_luts(y, luts_np, th, tw))
    nspec = jax_natural.make_natural_spec(h, w, CLIP, grid)
    jax_out = np.asarray(jax_natural.clahe_interpolate_natural(
        jnp.asarray(y), jnp.asarray(luts_np.reshape(-1, 256)), nspec,
        interpret=True, variant=1))
    assert_clahe_close(got[0].numpy(), jax_out)
    out = torch.empty_like(yt)
    assert natural.clahe_interpolate_pack(yt, luts, plan, out=out) is out
    assert torch.equal(out, got)


# ------------------------------------------------------------------ K9 ----


@pytest.mark.parametrize("h,w,grid", [
    (96, 128, (8, 8)),      # tile_h 12
    (64, 128, (4, 4)),      # tile_h 16
    (99, 28, (8, 11)),      # reflect-padded, tile_h 9
])
def test_cells_band_equals_jax_kernel_and_k6(h, w, grid):
    y = _frames(6, 1, h, w)[0]
    luts_np, th, tw = golden.clahe_luts(y, CLIP, grid)
    spec = lut.make_interp_spec(h, w, CLIP, grid)
    jax_spec = lut_kernels.make_interp_spec(h, w, CLIP, grid)
    assert spec is not None and jax_spec is not None
    yt = torch.from_numpy(y[None])
    luts = torch.from_numpy(luts_np.reshape(1, -1, 256))
    whole = lut.clahe_interpolate_cells_ref(yt, luts, spec)
    assert np.array_equal(whole[0].numpy(), golden.clahe_apply_luts(y, luts_np, th, tw))
    bands = [(0, h), (spec.tile_h, 2 * spec.tile_h), (2 * spec.tile_h, h - 2 * spec.tile_h),
             (5, 29), (spec.tile_h + 3, 7), (h - 1, 1)]
    for row0, rows in bands:
        band = yt[:, row0:row0 + rows]
        got = lut.clahe_interpolate_cells_band(band, luts, spec, row0)
        assert torch.equal(got, whole[:, row0:row0 + rows]), (row0, rows)
        jax_out = np.asarray(lut_kernels.clahe_interpolate_pallas_band(
            jnp.asarray(y[row0:row0 + rows]), jnp.asarray(luts_np.reshape(-1, 256)),
            jax_spec, row0, interpret=True))
        assert_clahe_close(got[0].numpy(), jax_out)
    # in place, and past the frame's last row
    buf = yt.clone()
    band = buf[:, 10:50]
    assert lut.clahe_interpolate_cells_band(band, luts, spec, 10, out=band) is band
    assert torch.equal(buf[:, 10:50], whole[:, 10:50])
    assert torch.equal(buf[:, :10], yt[:, :10]) and torch.equal(buf[:, 50:], yt[:, 50:])
    past = torch.cat([yt[:, h - 4:], torch.full((1, 3, w), 9, dtype=torch.uint8)], dim=1)
    got = lut.clahe_interpolate_cells_band(past, luts, spec, h - 4)
    assert torch.equal(got[:, :4], whole[:, h - 4:]) and torch.equal(got[:, 4:], past[:, 4:])


@pytest.mark.parametrize("h,w,grid", GEOMETRIES)
def test_cells_band_equals_pack_band(h, w, grid):
    """K9 against K5 on the sharded step's bands, where the geometry has a
    cell-grid spec."""
    spec = lut.make_interp_spec(h, w, CLIP, grid)
    assert spec is not None
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    y = torch.from_numpy(_frames(7, 2, h, w))
    luts = _luts(y, plan)
    for space in (2, 3, 4):
        for row0, rows_loc in _bands(h, space):
            band = y[:, row0:row0 + rows_loc]
            assert torch.equal(
                lut.clahe_interpolate_cells_band(band, luts, spec, row0),
                natural.clahe_interpolate_band(band, luts, plan, row0))


# ------------------------------------------------------- K1 on a band ----


@pytest.mark.parametrize("space", [2, 3, 4])
@pytest.mark.parametrize("h,w,grid", GEOMETRIES)
def test_tile_histograms_per_band_equal_the_whole_frame(h, w, grid, space):
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    y_np = _frames(8, 2, h, w)
    y = torch.from_numpy(y_np)
    whole = natural.tile_histograms(y, plan)
    tiles_yp = _clahe_geometry(plan, space)[0]
    tiles_loc = tiles_yp // space
    ext = np.asarray(jax_clahe._extend(jnp.asarray(y_np[0]),
                                       jax_clahe.make_clahe_plan(h, w, CLIP, grid)))
    parts = []
    for s in range(space):
        ty0, ty1 = min(s * tiles_loc, plan.tiles_y), min((s + 1) * tiles_loc, plan.tiles_y)
        lo, hi = natural.band_source_rows(plan, (ty0, ty1))
        got = natural.tile_histograms(y[:, lo:hi], plan, 1, (ty0, ty1), lo)
        assert got.shape == (2, (ty1 - ty0) * plan.tiles_x, 256)
        parts.append(got)
        if ty1 > ty0:
            # the JAX package's band histograms: K1 on the band of the
            # extended frame
            jax_hists = np.asarray(jax_natural.tile_histograms_radix(
                jnp.asarray(ext[ty0 * plan.tile_h:ty1 * plan.tile_h]), ty1 - ty0,
                plan.tiles_x, plan.tile_h, plan.tile_w, interpret=True))
            assert np.array_equal(got[0].numpy(), jax_hists)
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_tile_histograms_band_checks_its_slab():
    plan = torch_clahe.make_clahe_plan(97, 131, CLIP, (8, 8))
    y = torch.from_numpy(_frames(9, 1, 97, 131))
    # the last tile row mirrors the bottom pad (7 rows of its 13): it reads
    # rows above its own first row, 91
    assert (plan.tile_h, plan.pad_bottom) == (13, 7)
    assert natural.band_source_rows(plan, (7, 8)) == (89, 97)
    assert natural.band_source_rows(plan, (6, 8)) == (78, 97)
    assert natural.band_source_rows(plan, (8, 8)) == (0, 0)
    with pytest.raises(ValueError, match="the slab holds"):
        natural.tile_histograms(y[:, 91:], plan, 1, (7, 8), 91)
    with pytest.raises(ValueError, match="tile_rows"):
        natural.tile_histograms(y, plan, 1, (7, 9), 0)
    with pytest.raises(ValueError, match="wide"):
        natural.tile_histograms(y[:, :, :100], plan, 1, (0, 2), 0)
    # rowstep on a band, against the whole frame's
    plan = torch_clahe.make_clahe_plan(64, 128, CLIP, (8, 8))
    y = torch.from_numpy(_frames(9, 1, 64, 128))
    want = natural.tile_histograms(y, plan, 2)
    got = natural.tile_histograms(y[:, 16:40], plan, 2, (2, 5), 16)
    assert torch.equal(got, want[:, 2 * 8:5 * 8])
