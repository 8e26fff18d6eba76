"""The port's streaming ref-frame CLAHE (slice 2) against the JAX package.

Same NV12 batches (numpy, from a seed) through the JAX ``StreamingEnhancer``
and the port's on the CPU, where K7's plain version
(``clahe_interp_and_hist_ref``) and K1-K3's run.  Tolerances: the carried
histograms are integers and equal exactly; the chroma rows equal exactly;
the Y rows equal golden's previous-frame chain exactly (frame i mapped with
``golden.clahe_luts`` of frame i-1), and the JAX output within
``assert_clahe_close``, because the JAX CPU backend FMA-contracts the blend
(tests/conftest.py).  K7's plain version is also held to the TPU kernel,
``experiments.clahe_interp_and_hist_natural`` in interpret mode.
"""

import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.models import enhancer as jax_enhancer
from opencv_opencl_tpu.ops import clahe as jax_clahe
from opencv_opencl_tpu.ops.pallas import experiments
from opencv_opencl_tpu.ops.pallas import natural as jax_natural
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.models import enhancer as torch_enhancer
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops.cuda import natural
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

EVEN_SPEC = FrameSpec(width=128, height=96)   # tile-divisible: K7's path
PAD_SPEC = FrameSpec(width=120, height=66)    # padded: K1 then K3
CLIP = 2.0


def _nv12(seed, n, spec):
    rng = np.random.default_rng(seed)
    base = np.linspace(10, 200, spec.width, dtype=np.float32)[None, :]
    y = np.clip(base + rng.normal(0, 30, (n, spec.height, spec.width)), 0, 255)
    uv = rng.integers(0, 256, (n, spec.height // 2, spec.width), dtype=np.uint8)
    return np.concatenate([y.astype(np.uint8), uv], axis=1)


def _cfgs(chroma=ChromaPolicy.PASSTHROUGH, **kw):
    return (jax_enhancer.EnhancerConfig(op="clahe", clip_limit=CLIP, chroma=chroma, **kw),
            torch_enhancer.EnhancerConfig(op="clahe", clip_limit=CLIP, chroma=chroma, **kw))


def _golden_chain(frames, spec, start_luts):
    """Frame i mapped with golden's LUTs of frame i-1; frame 0 with
    ``start_luts`` (the LUTs of the histograms carried in)."""
    h = spec.height
    plan = jax_clahe.make_clahe_plan(h, spec.width, CLIP, (8, 8))
    out = []
    for i, frame in enumerate(frames):
        if i == 0:
            luts, th, tw = start_luts, plan.tile_h, plan.tile_w
        else:
            luts, th, tw = golden.clahe_luts(frames[i - 1][:h], CLIP, (8, 8))
        out.append(golden.clahe_apply_luts(frame[:h], luts, th, tw))
    return np.stack(out)


def _luts_of(hists, spec):
    plan = jax_clahe.make_clahe_plan(spec.height, spec.width, CLIP, (8, 8))
    luts = np.asarray(jax_clahe._luts_from_hists(np.asarray(hists), plan))
    return luts.reshape(plan.tiles_y, plan.tiles_x, 256)


@pytest.mark.parametrize("h,w,grid", [(96, 128, (8, 8)), (66, 120, (8, 8)),
                                      (33, 47, (3, 5)), (2160, 3840, (8, 8))])
def test_initial_hists_equals_jax(h, w, grid):
    jplan = jax_clahe.make_clahe_plan(h, w, CLIP, grid)
    got = torch_enhancer.initial_hists(torch_clahe.make_clahe_plan(h, w, CLIP, grid),
                                       device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jax_enhancer.initial_hists(jplan)))
    assert (got.sum(dim=1) == jplan.tile_area).all()


@pytest.mark.parametrize("chroma", [ChromaPolicy.PASSTHROUGH, ChromaPolicy.GRAY])
@pytest.mark.parametrize("spec", [EVEN_SPEC, PAD_SPEC], ids=["fused", "padded"])
def test_streaming_equals_jax_and_golden_across_batches(spec, chroma):
    jcfg, tcfg = _cfgs(chroma)
    jax_stream = jax_enhancer.StreamingEnhancer(jcfg, spec)
    port = torch_enhancer.StreamingEnhancer(tcfg, spec, device="cpu")
    batches = [_nv12(20, 3, spec), _nv12(21, 2, spec)]
    start = _luts_of(jax_enhancer.initial_hists(
        jax_clahe.make_clahe_plan(spec.height, spec.width, CLIP, (8, 8))), spec)
    want_y = _golden_chain(np.concatenate(batches), spec, start)
    h, seen = spec.height, 0
    for batch in batches:
        want = np.asarray(jax_stream.process_batch(batch.copy()))
        got = np.asarray(port.process_batch(batch))
        assert got.shape == batch.shape
        assert np.array_equal(got[:, :h], want_y[seen:seen + len(batch)])
        assert_clahe_close(got[:, :h], want[:, :h])
        assert np.array_equal(got[:, h:], want[:, h:])
        assert np.array_equal(
            got[:, h:], np.full_like(batch[:, h:], 128)
            if chroma == ChromaPolicy.GRAY else batch[:, h:])
        # the state carried to the next batch: the last frame's histograms
        assert np.array_equal(port._hists.numpy(), np.asarray(jax_stream._hists))
        seen += len(batch)


def test_streaming_reset_restores_the_start_state():
    _, tcfg = _cfgs()
    port = torch_enhancer.StreamingEnhancer(tcfg, EVEN_SPEC, device="cpu")
    batch = _nv12(22, 2, EVEN_SPEC)
    first = np.asarray(port.process_batch(batch))
    np.asarray(port.process_batch(_nv12(23, 2, EVEN_SPEC)))
    port.reset()
    assert np.array_equal(np.asarray(port.process_batch(batch)), first)


def test_hists_from_jax_continues_a_jax_stream():
    jcfg, tcfg = _cfgs()
    jax_stream = jax_enhancer.StreamingEnhancer(jcfg, EVEN_SPEC)
    first, second = _nv12(24, 2, EVEN_SPEC), _nv12(25, 2, EVEN_SPEC)
    np.asarray(jax_stream.process_batch(first))
    port = torch_enhancer.StreamingEnhancer(tcfg, EVEN_SPEC, device="cpu")
    port._hists = torch_enhancer.hists_from_jax(np.asarray(jax_stream._hists), "cpu")
    assert port._hists.dtype == torch.int32
    got = np.asarray(port.process_batch(second.copy()))
    want = np.asarray(jax_stream.process_batch(second.copy()))
    h = EVEN_SPEC.height
    assert_clahe_close(got[:, :h], want[:, :h])
    chain = _golden_chain(np.concatenate([first, second]), EVEN_SPEC,
                          _luts_of(jax_enhancer.initial_hists(
                              jax_clahe.make_clahe_plan(96, 128, CLIP, (8, 8))),
                              EVEN_SPEC))
    assert np.array_equal(got[:, :h], chain[2:])
    assert np.array_equal(port._hists.numpy(), np.asarray(jax_stream._hists))
    with pytest.raises(ValueError, match="256"):
        torch_enhancer.hists_from_jax(np.zeros((64, 255), np.int32), "cpu")


@pytest.mark.parametrize("kw", [dict(op="histeq"), dict(op="none"),
                                dict(op="clahe", hist_downsample=2)])
def test_streaming_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jax_enhancer.StreamingEnhancer(jax_enhancer.EnhancerConfig(**kw), EVEN_SPEC)
    with pytest.raises(ValueError):
        torch_enhancer.StreamingEnhancer(torch_enhancer.EnhancerConfig(**kw),
                                         EVEN_SPEC, device="cpu")


def test_streaming_step_picks_its_kernels_by_geometry(monkeypatch):
    """K7 where the plan has no padding, K1 then K3 elsewhere; the step
    writes the batch in place."""
    calls = []
    for name in ("clahe_interp_and_hist", "tile_histograms", "clahe_interpolate"):
        real = getattr(natural, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(natural, name, spy)
    _, tcfg = _cfgs()
    for spec, want in ((EVEN_SPEC, ["clahe_interp_and_hist"] * 2),
                       (PAD_SPEC, ["tile_histograms", "clahe_interpolate"] * 2)):
        calls.clear()
        fn, plan = torch_enhancer.build_streaming_clahe_fn(tcfg, spec)
        x = torch.from_numpy(_nv12(26, 2, spec))
        out, hists = fn(x, torch_enhancer.initial_hists(plan, "cpu"))
        assert calls == want
        assert out.data_ptr() == x.data_ptr() and hists.shape == (plan.num_tiles, 256)


# ------------------------------------------------------------------ K7 ----


@pytest.mark.parametrize("h,w,grid", [(96, 128, (8, 8)), (64, 256, (4, 4)),
                                      (80, 120, (5, 4))])
def test_interp_and_hist_ref_equals_experiment_kernel(h, w, grid):
    """The cases of tests/test_natural_kernels.py TestFusedExperiment."""
    rng = np.random.default_rng(27)
    y, prev = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    jplan = jax_clahe.make_clahe_plan(h, w, CLIP, grid)
    luts = np.array(jax_clahe._luts_from_hists(
        jax_clahe._tile_histograms(prev, jplan, "onehot"), jplan))
    spec = jax_natural.make_natural_spec(h, w, CLIP, grid)
    want_out, want_hists = experiments.clahe_interp_and_hist_natural(
        y, luts, spec, interpret=True)
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    t_luts = torch.from_numpy(luts.reshape(1, plan.num_tiles, 256))
    out, hists = natural.clahe_interp_and_hist(torch.from_numpy(y[None]), t_luts, plan)
    assert hists.dtype == torch.int32
    assert np.array_equal(hists[0].numpy(), np.asarray(want_hists))
    assert_clahe_close(out[0].numpy(), np.asarray(want_out))
    assert np.array_equal(out[0].numpy(), golden.clahe_apply_luts(
        y, luts.reshape(plan.tiles_y, plan.tiles_x, 256), plan.tile_h, plan.tile_w))
    ref_out, ref_hists = natural.clahe_interp_and_hist_ref(
        torch.from_numpy(y[None]), t_luts, plan)
    assert torch.equal(ref_out, out) and torch.equal(ref_hists, hists)


def test_interp_and_hist_in_place_counts_the_input():
    rng = np.random.default_rng(28)
    nv12 = torch.from_numpy(rng.integers(0, 256, (2, 144, 128), dtype=np.uint8))
    keep = nv12.clone()
    plan = torch_clahe.make_clahe_plan(96, 128, CLIP, (8, 8))
    luts = natural.build_luts_ref(natural.tile_histograms_ref(
        keep[:, :96].flip(0), plan), plan.clip, plan.lut_scale)
    y = nv12[:, :96]
    out, hists = natural.clahe_interp_and_hist(y, luts, plan, out=y)
    assert out.data_ptr() == nv12.data_ptr()
    assert torch.equal(hists, natural.tile_histograms_ref(keep[:, :96], plan))
    assert torch.equal(nv12[:, :96],
                       natural.clahe_interpolate_ref(keep[:, :96], luts, plan))
    assert torch.equal(nv12[:, 96:], keep[:, 96:])


def test_interp_and_hist_rejects_padded_geometry():
    plan = torch_clahe.make_clahe_plan(66, 120, CLIP, (8, 8))
    assert not natural.fused_interp_hist_fits(plan)
    assert natural.fused_interp_hist_fits(torch_clahe.make_clahe_plan(96, 128, CLIP, (8, 8)))
    y = torch.zeros((1, 66, 120), dtype=torch.uint8)
    luts = torch.zeros((1, plan.num_tiles, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="tile-divisible"):
        natural.clahe_interp_and_hist(y, luts, plan)


@pytest.mark.parametrize("h,w,grid,frames,want", [
    (2160, 3840, (8, 8), 1, (48, 384)),     # 384 blocks per 4K frame
    (1080, 1920, (8, 8), 1, (32, 384)),
    (2160, 3840, (8, 8), 4, (48, 1536)),
    (96, 128, (8, 8), 2, (5, 512)),
    (80, 120, (5, 4), 1, (2, 200)),
    (68, 120, (8, 4), 1, (2, 288)),         # tile_h 17
])
def test_fused_grid_keeps_blocks_inside_a_tile_row(h, w, grid, frames, want):
    """K7's grid: (row ranges cut at row pairs and tile rows) x tile columns
    x frames; no range leaves its tile row."""
    plan = torch_clahe.make_clahe_plan(h, w, CLIP, grid)
    rows = natural.fused_rows_per_block(frames, plan)
    ranges = natural.make_pack_spec(h, w, CLIP, grid).row_ranges(rows, plan.tile_h)
    assert (rows, len(ranges) * plan.tiles_x * frames) == want
    assert np.all(ranges[:, 0] // plan.tile_h == (ranges[:, 1] - 1) // plan.tile_h)
