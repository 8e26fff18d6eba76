"""The port's CUDA kernels on the card, each against its plain version.

Needs a CUDA card (marker ``cuda``); every test skips without one.  On a
machine with a card and no JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The same cases as ``chip_smoke.py`` phase 3, at small sizes: the wrappers'
outputs (K1, K8 and K10 histograms, K2 LUTs with one clip or one per frame,
K3, K4, K6 and K6r frames, K7 frames and histograms (both on their 16-byte
and byte paths), K5, K3v1 and K9 bands,
K1 on bands of tile rows) must equal the plain PyTorch versions on the same CUDA
inputs exactly, and the CLAHE (every backend), auto-CLAHE, histeq,
streaming and sharded steps must equal ``core.golden`` and the same steps
on the CPU.  Tolerance: 0.
"""

import numpy as np
import pytest
import torch

from opencv_opencl_tpu_torch.core import golden
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.models import enhancer as torch_enhancer
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops import histeq as torch_histeq
from opencv_opencl_tpu_torch.ops import cuda as torch_cuda
from opencv_opencl_tpu_torch.ops.cuda import _build, lut, natural
from opencv_opencl_tpu_torch.parallel import launch, sharded

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frames(seed, n, h, w, content="random"):
    rng = np.random.default_rng(seed)
    if content == "constant":
        return np.full((n, h, w), 77, np.uint8)
    if content == "structured":     # gradient plus noise
        base = (np.linspace(0, 200, w, dtype=np.float32)[None, :]
                + np.linspace(0, 55, h, dtype=np.float32)[:, None])
        noise = rng.normal(0, 18, (n, h, w)).astype(np.float32)
        return np.clip(base[None] + noise, 0, 255).astype(np.uint8)
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    if content == "nv12":
        uv = rng.integers(0, 256, (n, h // 2, w), dtype=np.uint8)
        return np.concatenate([y, uv], axis=1)
    return y


CASES = [
    # (n, h, w, clip, grid, rowstep, content)
    (2, 96, 128, 2.0, (8, 8), 1, "nv12"),      # strided Y rows of NV12
    (2, 96, 128, 2.0, (8, 8), 2, "nv12"),      # hist_rowstep=2
    (1, 1079, 1919, 2.0, (8, 8), 1, "random"),  # odd geometry
    (2, 64, 128, 2.0, (8, 8), 1, "constant"),
    (3, 6, 6, 2.0, (8, 8), 1, "random"),
    (2, 3, 3, 40.0, (8, 8), 1, "random"),      # pad >= dim
    (2, 40, 60, 2.0, (1, 1), 1, "random"),
    (2, 33, 47, 40.0, (3, 5), 1, "random"),
    (1, 64, 128, 0.0, (8, 8), 1, "random"),    # no clipping
    (1, 64, 64, 2.0, (16, 16), 1, "random"),   # 256 tiles
    (2, 135, 240, 2.0, (8, 8), 1, "nv12"),     # 1080p / 8: groups change inside units
    (2, 48, 160, 2.0, (5, 3), 1, "nv12"),      # K1: 32-wide interior tiles, 16-byte path
    (1, 32, 256, 2.0, (64, 4), 1, "random"),   # K3: 65 groups, the pack not staged
]


@pytest.mark.parametrize("n,h,w,clip,grid,rowstep,content", CASES)
def test_kernels_equal_plain_versions(device, n, h, w, clip, grid, rowstep, content):
    batch = torch.from_numpy(_frames(1, n, h, w, content)).to(device)
    y = batch[:, :h]
    plan = torch_clahe.make_clahe_plan(h, w, clip, grid)

    hists = natural.tile_histograms(y, plan, rowstep)
    hists_ref = natural.tile_histograms_ref(y, plan, rowstep)
    assert torch.equal(hists, hists_ref)
    luts = natural.build_luts(hists_ref, plan.clip, plan.lut_scale)
    luts_ref = natural.build_luts_ref(hists_ref, plan.clip, plan.lut_scale)
    assert torch.equal(luts, luts_ref)
    out = natural.clahe_interpolate(y, luts_ref, plan)
    out_ref = natural.clahe_interpolate_ref(y, luts_ref, plan)
    assert torch.equal(out, out_ref)

    inplace = batch.clone()
    natural.clahe_interpolate(inplace[:, :h], luts_ref, plan, out=inplace[:, :h])
    assert torch.equal(inplace[:, :h], out_ref)
    assert torch.equal(inplace[:, h:], batch[:, h:])
    torch.cuda.synchronize(device)


@pytest.mark.parametrize("h,w,grid", [(135, 240, (8, 8)), (67, 119, (8, 8)),
                                      (96, 128, (8, 8)), (97, 131, (3, 5))])
def test_k1_k3_on_views_that_take_the_byte_paths(device, h, w, grid):
    """An unaligned view (y[..., 1:]: the byte paths throughout), and a view
    whose base and strides are aligned but whose width is not a multiple of
    16 (K3: 16-byte units and a byte tail), against the plain versions."""
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    wide = torch.from_numpy(_frames(11, 2, h, 16 * (w // 16 + 2))).to(device)
    luts = natural.build_luts_ref(natural.tile_histograms_ref(wide[:, :, :w], plan),
                                  plan.clip, plan.lut_scale)
    for y in (wide[:, :, 1:w + 1], wide[:, :, :w]):
        assert torch.equal(natural.tile_histograms(y, plan),
                           natural.tile_histograms_ref(y, plan))
        want = natural.clahe_interpolate_ref(y, luts, plan)
        assert torch.equal(natural.clahe_interpolate(y, luts, plan), want)
        inplace = wide.clone()
        view = inplace[:, :, 1:w + 1] if y.data_ptr() % 16 else inplace[:, :, :w]
        natural.clahe_interpolate(view, luts, plan, out=view)
        assert torch.equal(view, want)
    assert not natural.interp_vec(wide[:, :, 1:w + 1], wide[:, :, 1:w + 1])
    assert natural.interp_vec(wide[:, :, :w], wide[:, :, :w])
    torch.cuda.synchronize(device)


def test_lut_build_residual_edge_cases(device):
    plan = torch_clahe.make_clahe_plan(96, 128, 2.0, (8, 8))
    hists = np.zeros((1, plan.num_tiles, 256), np.int32)
    c, area = plan.clip, plan.tile_area
    hists[0, 0, 0] = area
    hists[0, 1, :] = area // 256
    hists[0, 1, 0] += area - hists[0, 1].sum()
    # residuals 255, 0, 1 and the non-divisors 3, 100 and 129 of 256
    for row, e in enumerate((255, 256, 1, 3, 100, 129), start=2):
        hists[0, row, :2] = [c + e, area - (c + e)]
    h = torch.from_numpy(hists).to(device)
    assert torch.equal(natural.build_luts(h, plan.clip, plan.lut_scale),
                       natural.build_luts_ref(h, plan.clip, plan.lut_scale))
    # a row count that leaves the last block's warps partly idle (K2 runs
    # one warp per row), and the empty kernel launched with its grid
    odd = h[:, :7].contiguous()
    assert torch.equal(natural.build_luts(odd, plan.clip, plan.lut_scale),
                       natural.build_luts_ref(odd, plan.clip, plan.lut_scale))
    natural.launch_floor(odd)
    torch.cuda.synchronize(device)


def test_step_equals_golden_and_counts_launches(device):
    h, w = 108, 192
    frames = _frames(2, 2, h, w)
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    natural.reset_launch_counts()
    out = torch_clahe.clahe_apply(torch.from_numpy(frames).to(device), plan)
    assert natural.launch_counts() == {
        "tile_histograms": 1, "build_luts": 1, "clahe_interpolate": 1,
        "clahe_interp_and_hist": 0, "clahe_interpolate_band": 0,
        "clahe_interpolate_pack": 0, "tile_histograms_batched": 0}
    for i, f in enumerate(frames):
        assert np.array_equal(out[i].cpu().numpy(), golden.clahe(f, 2.0, (8, 8)))
    assert _build.is_built()


@pytest.mark.parametrize("chroma", [ChromaPolicy.PASSTHROUGH, ChromaPolicy.GRAY])
def test_enhancer_on_card_equals_cpu(device, chroma):
    spec = FrameSpec(width=120, height=66)
    cfg = torch_enhancer.EnhancerConfig(op="clahe", clip_limit=2.0, chroma=chroma)
    batch = _frames(3, 3, spec.buffer_rows, spec.width)
    on_card = np.asarray(torch_enhancer.Enhancer(cfg, spec, device).process_batch(batch))
    on_cpu = np.asarray(torch_enhancer.Enhancer(cfg, spec, "cpu").process_batch(batch))
    assert np.array_equal(on_card, on_cpu)


def test_wrappers_raise_on_mixed_devices(device):
    plan = torch_clahe.make_clahe_plan(32, 32, 2.0, (4, 4))
    y = torch.zeros((1, 32, 32), dtype=torch.uint8, device=device)
    luts = torch.zeros((1, 16, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="luts on"):
        natural.clahe_interpolate(y, luts, plan)
    with pytest.raises(ValueError, match="contiguous"):
        natural.build_luts(torch.zeros((1, 256, 16), dtype=torch.int32,
                                       device=device).transpose(1, 2),
                           plan.clip, plan.lut_scale)


# ------------------------------------------------------------------ K4 ----


def _luts(seed, n, kind):
    if kind == "identity":
        return np.tile(np.arange(256, dtype=np.uint8), (n, 1))
    return np.random.default_rng(seed).integers(0, 256, (n, 256), dtype=np.uint8)


@pytest.mark.parametrize("n,h,w,content,lut_kind", [
    (2, 96, 128, "nv12", "random"),        # in place over NV12 Y rows
    (2, 96, 128, "nv12", "identity"),
    (1, 1079, 1919, "random", "random"),   # odd width: unaligned rows
    (2, 64, 128, "constant", "random"),
    (3, 5, 7, "random", "random"),         # shorter than one 16-byte unit
])
def test_apply_lut_equals_plain(device, n, h, w, content, lut_kind):
    batch = torch.from_numpy(_frames(4, n, h, w, content)).to(device)
    y = batch[:, :h]
    luts = torch.from_numpy(_luts(5, n, lut_kind)).to(device)
    want = lut.apply_lut_ref(y, luts)
    assert torch.equal(lut.apply_lut(y, luts), want)
    inplace = batch.clone()
    lut.apply_lut(inplace[:, :h], luts, out=inplace[:, :h])
    assert torch.equal(inplace[:, :h], want)
    assert torch.equal(inplace[:, h:], batch[:, h:])
    # source and destination aligned differently: the byte path
    shifted = torch.zeros((n, h, w + 1), dtype=torch.uint8, device=device)
    shifted[:, :, 1:] = y
    assert torch.equal(lut.apply_lut(shifted[:, :, 1:], luts), want)
    torch.cuda.synchronize(device)


def test_histeq_equals_golden_and_counts_launches(device):
    frames = _frames(6, 2, 108, 192)
    torch_cuda.reset_launch_counts()
    out = torch_histeq.equalize_hist_batch(frames, device=device)
    counts = torch_cuda.launch_counts()
    assert counts["tile_histograms"] == 1 and counts["apply_lut"] == 1
    for i, f in enumerate(frames):
        assert np.array_equal(out[i].cpu().numpy(), golden.equalize_hist(f))
    const = np.full((64, 96), 9, np.uint8)
    assert np.array_equal(
        torch_histeq.equalize_hist(const, device=device).cpu().numpy(), const)


@pytest.mark.parametrize("kw", [dict(), dict(hist_downsample=3),
                                dict(use_ref_frame=True)])
def test_histeq_step_on_card_equals_cpu(device, kw):
    spec = FrameSpec(width=120, height=66)
    cfg = torch_enhancer.EnhancerConfig(op="histeq", **kw)
    batch = _frames(7, 3, spec.buffer_rows, spec.width)
    on_card = np.asarray(torch_enhancer.Enhancer(cfg, spec, device).process_batch(batch))
    on_cpu = np.asarray(torch_enhancer.Enhancer(cfg, spec, "cpu").process_batch(batch))
    assert np.array_equal(on_card, on_cpu)


# ------------------------------------------------------------------ K7 ----


@pytest.mark.parametrize("n,h,w,grid,content", [
    (2, 96, 128, (8, 8), "nv12"),          # in place over NV12 Y rows
    (2, 64, 256, (4, 4), "random"),
    (2, 80, 120, (5, 4), "random"),
    (1, 1080, 1920, (8, 8), "random"),     # 15-row blocks
    (2, 96, 128, (8, 8), "constant"),
    (1, 64, 64, (16, 16), "random"),       # 256 tiles, tile width 4: bytes
    (1, 2160, 3840, (8, 8), "structured"),  # 4K: 16-byte units, 16-row blocks
    (1, 2160, 3840, (8, 8), "constant"),
    (2, 1080, 1920, (8, 8), "nv12"),       # groups change inside units
])
def test_interp_and_hist_equals_plain(device, n, h, w, grid, content):
    batch = torch.from_numpy(_frames(8, n, h, w, content)).to(device)
    y = batch[:, :h]
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    # the previous frame's LUTs: those of other content
    prev = torch.from_numpy(_frames(9, n, h, w)).to(device)
    luts = natural.build_luts_ref(natural.tile_histograms_ref(prev, plan),
                                  plan.clip, plan.lut_scale)
    out_ref, hists_ref = natural.clahe_interp_and_hist_ref(y, luts, plan)
    out, hists = natural.clahe_interp_and_hist(y, luts, plan)
    assert torch.equal(out, out_ref) and torch.equal(hists, hists_ref)
    # K7 equals K3 followed by K1
    assert torch.equal(out, natural.clahe_interpolate(y, luts, plan))
    assert torch.equal(hists, natural.tile_histograms(y, plan))
    inplace = batch.clone()
    _, hists_in = natural.clahe_interp_and_hist(inplace[:, :h], luts, plan,
                                                out=inplace[:, :h])
    assert torch.equal(inplace[:, :h], out_ref) and torch.equal(hists_in, hists_ref)
    assert torch.equal(inplace[:, h:], batch[:, h:])
    torch.cuda.synchronize(device)


@pytest.mark.parametrize("h,w,grid", [(1080, 1920, (8, 8)), (96, 128, (8, 8)),
                                      (270, 480, (2, 2)), (80, 120, (5, 4))])
def test_k7_k6_on_views_that_take_the_byte_paths(device, h, w, grid):
    """K7 and K6 (and K9) on a view from column 1 (base and rows off 16
    bytes: the byte paths throughout) and on an aligned view of a wider
    buffer, in place and out of place, against the plain versions."""
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    wide = torch.from_numpy(_frames(21, 2, h, 16 * (w // 16 + 2), "structured")).to(device)
    luts = natural.build_luts_ref(natural.tile_histograms_ref(
        torch.from_numpy(_frames(22, 2, h, w)).to(device), plan), plan.clip, plan.lut_scale)
    for col0 in (1, 0):
        y = wide[:, :, col0:col0 + w]
        assert natural.interp_vec(y, y) == (col0 == 0)
        out_ref, hists_ref = natural.clahe_interp_and_hist_ref(y, luts, plan)
        out, hists = natural.clahe_interp_and_hist(y, luts, plan)
        assert torch.equal(out, out_ref) and torch.equal(hists, hists_ref)
        want = lut.clahe_interpolate_cells_ref(y, luts, spec)
        assert torch.equal(want, out_ref)
        assert torch.equal(lut.clahe_interpolate_cells(y, luts, spec), want)
        assert torch.equal(lut.clahe_interpolate_cells_band(
            y[:, h // 3:], luts, spec, h // 3), want[:, h // 3:])
        for fn in ("k7", "k6"):
            inplace = wide.clone()
            view = inplace[:, :, col0:col0 + w]
            if fn == "k7":
                _, hists_in = natural.clahe_interp_and_hist(view, luts, plan, out=view)
                assert torch.equal(hists_in, hists_ref)
            else:
                lut.clahe_interpolate_cells(view, luts, spec, out=view)
            assert torch.equal(view, want)
            assert torch.equal(inplace[:, :, :col0], wide[:, :, :col0])
            assert torch.equal(inplace[:, :, col0 + w:], wide[:, :, col0 + w:])
    torch.cuda.synchronize(device)


def test_interp_and_hist_rejects_padded_geometry(device):
    plan = torch_clahe.make_clahe_plan(66, 120, 2.0, (8, 8))
    y = torch.zeros((1, 66, 120), dtype=torch.uint8, device=device)
    luts = torch.zeros((1, plan.num_tiles, 256), dtype=torch.uint8, device=device)
    with pytest.raises(ValueError, match="tile-divisible"):
        natural.clahe_interp_and_hist(y, luts, plan)


@pytest.mark.parametrize("spec,fused", [(FrameSpec(width=128, height=96), True),
                                        (FrameSpec(width=120, height=66), False)])
def test_streaming_on_card_equals_cpu_and_golden(device, spec, fused):
    cfg = torch_enhancer.EnhancerConfig(op="clahe", clip_limit=2.0,
                                        chroma=ChromaPolicy.PASSTHROUGH)
    card = torch_enhancer.StreamingEnhancer(cfg, spec, device)
    cpu = torch_enhancer.StreamingEnhancer(cfg, spec, "cpu")
    h = spec.height
    prev = None
    torch_cuda.reset_launch_counts()
    for b in range(2):
        batch = _frames(10 + b, 3, spec.buffer_rows, spec.width)
        got = np.asarray(card.process_batch(batch))
        assert np.array_equal(got, np.asarray(cpu.process_batch(batch)))
        for i in range(3):
            if prev is not None:
                luts, th, tw = golden.clahe_luts(prev, 2.0, (8, 8))
                assert np.array_equal(
                    got[i, :h], golden.clahe_apply_luts(batch[i, :h], luts, th, tw))
            prev = batch[i, :h]
    counts = torch_cuda.launch_counts()
    assert counts["build_luts"] == 6
    assert counts["clahe_interp_and_hist"] == (6 if fused else 0)
    assert counts["clahe_interpolate"] == (0 if fused else 6)


# ------------------------------------------------------ K6, K8, K2 clips ----


@pytest.mark.parametrize("n,h,w,grid,content", [
    (2, 96, 128, (8, 8), "nv12"),          # in place over NV12 Y rows
    (2, 66, 120, (8, 8), "random"),        # padded tiles
    (1, 1080, 1920, (8, 8), "random"),     # tile height 135
    (1, 1079, 1919, (8, 8), "random"),
    (2, 64, 128, (8, 8), "constant"),
    (2, 64, 64, (16, 16), "random"),
    (3, 6, 6, (8, 8), "random"),           # cells of one row
    (2, 33, 47, (3, 5), "random"),
    (2, 1080, 1920, (8, 8), "nv12"),       # 8 head and 8 tail bytes a cell
    (1, 2160, 3840, (8, 8), "structured"),  # 4K: whole units only
    (1, 2160, 3840, (8, 8), "constant"),
])
def test_interpolate_cells_equals_plain_and_k3(device, n, h, w, grid, content):
    batch = torch.from_numpy(_frames(12, n, h, w, content)).to(device)
    y = batch[:, :h]
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    luts = natural.build_luts_ref(
        natural.tile_histograms_ref(torch.from_numpy(_frames(13, n, h, w)).to(device),
                                    plan), plan.clip, plan.lut_scale)
    want = lut.clahe_interpolate_cells_ref(y, luts, spec)
    assert torch.equal(lut.clahe_interpolate_cells(y, luts, spec), want)
    assert torch.equal(natural.clahe_interpolate(y, luts, plan), want)
    inplace = batch.clone()
    lut.clahe_interpolate_cells(inplace[:, :h], luts, spec, out=inplace[:, :h])
    assert torch.equal(inplace[:, :h], want)
    assert torch.equal(inplace[:, h:], batch[:, h:])
    torch.cuda.synchronize(device)


def test_interpolate_cells_rejects_the_radix_variant(device):
    """The radix variant is no longer refused: on the card it launches K6's
    kernel, counted as K6r's launch and not K6's, and gives K6's output."""
    spec = lut.make_interp_spec(32, 32, 2.0, (4, 4))
    y = torch.from_numpy(_frames(16, 1, 32, 32)).to(device)
    luts = torch.from_numpy(
        np.random.default_rng(17).integers(0, 256, (1, 16, 256), dtype=np.uint8)
    ).to(device)
    torch_cuda.reset_launch_counts()
    got = lut.clahe_interpolate_cells(y, luts, spec, radix=True)
    counts = torch_cuda.launch_counts()
    assert counts["clahe_interpolate_cells_radix"] == 1
    assert counts["clahe_interpolate_cells"] == 0
    assert torch.equal(got, lut.clahe_interpolate_cells(y, luts, spec))
    with pytest.raises(ValueError):
        lut.clahe_interpolate_cells(y, luts[:, :15], spec, radix=True)


@pytest.mark.parametrize("n,h,w,grid,content", [
    (2, 96, 128, (8, 8), "nv12"),          # in place over NV12 Y rows
    (2, 66, 120, (8, 8), "random"),        # padded tiles
    (1, 1080, 1920, (8, 8), "random"),     # tile height 135
    (1, 1079, 1919, (8, 8), "random"),     # pad_left one more than tile_w // 2
    (2, 64, 128, (8, 8), "constant"),
    (2, 64, 64, (16, 16), "random"),
    (3, 6, 6, (8, 8), "random"),           # cells of one row
    (2, 33, 47, (3, 5), "random"),
    (1, 40, 60, (1, 1), "random"),         # every cell the same LUT four times
])
def test_interpolate_cells_radix_equals_plain_k6_and_k3(device, n, h, w, grid, content):
    batch = torch.from_numpy(_frames(18, n, h, w, content)).to(device)
    y = batch[:, :h]
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    luts = natural.build_luts_ref(
        natural.tile_histograms_ref(torch.from_numpy(_frames(19, n, h, w)).to(device),
                                    plan), plan.clip, plan.lut_scale)
    want = lut.clahe_interpolate_cells_ref(y, luts, spec, radix=True)
    assert torch.equal(want, lut.clahe_interpolate_cells_ref(y, luts, spec))
    got = lut.clahe_interpolate_cells(y, luts, spec, radix=True)
    assert torch.equal(got, want)
    assert torch.equal(got, lut.clahe_interpolate_cells(y, luts, spec))
    assert torch.equal(got, natural.clahe_interpolate(y, luts, plan))
    inplace = batch.clone()
    lut.clahe_interpolate_cells(inplace[:, :h], luts, spec, out=inplace[:, :h],
                                radix=True)
    assert torch.equal(inplace[:, :h], want)
    assert torch.equal(inplace[:, h:], batch[:, h:])
    torch.cuda.synchronize(device)


@pytest.mark.parametrize("batch_rows", [2, 4, 8])
@pytest.mark.parametrize("n,h,w,grid,content", [
    (2, 96, 128, (8, 8), "nv12"),          # 16-byte path, strided rows
    (2, 66, 120, (8, 8), "random"),        # tile width 15: the byte path
    (2, 64, 128, (8, 8), "constant"),      # one group of 32 equal values
    (2, 40, 60, (1, 1), "random"),         # tile width 60: partial warps
    (1, 1080, 1920, (8, 8), "random"),     # tile height 135: short last groups
    (1, 1079, 1919, (8, 8), "random"),     # extended to 1080x1920 first
    (1, 2160, 3840, (1, 1), "random"),     # one tile, 240 units a row
])
def test_batched_hists_equal_plain_k1_and_k8(device, n, h, w, grid, content, batch_rows):
    batch = torch.from_numpy(_frames(20, n, h, w, content)).to(device)
    y = batch[:, :h]
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    ext = natural.extend(y, plan)
    args = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
    got = natural.tile_histograms_batched(ext, *args, batch_rows=batch_rows)
    assert torch.equal(got, natural.tile_histograms_batched_ref(ext, *args))
    assert torch.equal(got, natural.tile_histograms(y, plan))
    assert torch.equal(got, lut.tile_histograms_extended(ext, *args))
    assert torch.equal(got[0], natural.tile_histograms_batched(
        ext[0], *args, batch_rows=batch_rows))
    torch.cuda.synchronize(device)


def test_tile_hist_launch_refuses_loads_other_than_2_4_8(device):
    """K1's launcher takes 2, 4 or 8 loads in flight (K10's batch_rows) and
    refuses any other number with cudaErrorInvalidValue, launching nothing."""
    h, w = 96, 128
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    y = torch.from_numpy(_frames(22, 2, h, w)).to(device)
    lib = _build.load()
    names = natural._TILE_HIST_ARGS
    for loads, want_err in ((2, 0), (4, 0), (8, 0), (3, 1), (16, 1), (0, 1)):
        out = torch.zeros((2, plan.num_tiles, 256), dtype=torch.int32, device=device)
        args = dict(natural.tile_hist_args(y, plan), loads=loads)
        err = lib.tile_hist_launch(y.data_ptr(), 2, *(args[k] for k in names),
                                   out.data_ptr(), natural._stream(device))
        torch.cuda.synchronize(device)
        assert err == want_err, loads
        if want_err:
            assert not out.any()
        else:
            assert torch.equal(out, natural.tile_histograms_ref(y, plan))


def test_batched_hists_on_an_unaligned_view_and_bad_batch_rows(device):
    """A view whose base and row stride 16 bytes do not divide takes the byte
    path, with a tile width (30) that leaves a partial warp."""
    wide = torch.from_numpy(_frames(21, 2, 48, 131)).to(device)
    ext = wide[:, :, 7:127]                       # (2, 48, 120), stride 131
    for batch_rows in (2, 4, 8):
        got = natural.tile_histograms_batched(ext, 4, 4, 12, 30, batch_rows)
        assert torch.equal(got, natural.tile_histograms_batched_ref(ext, 4, 4, 12, 30))
    with pytest.raises(ValueError, match="batch_rows must be one of"):
        natural.tile_histograms_batched(ext, 4, 4, 12, 30, batch_rows=3)
    torch.cuda.synchronize(device)


@pytest.mark.parametrize("n,h,w,grid,content", [
    (2, 96, 128, (8, 8), "nv12"),          # strided rows
    (2, 66, 120, (8, 8), "random"),        # extended by reflect-101 first
    (2, 64, 128, (8, 8), "constant"),      # every lane on one bin
    (2, 40, 60, (1, 1), "random"),
    (1, 1080, 1920, (8, 8), "random"),
])
def test_extended_hists_equal_plain_and_k1(device, n, h, w, grid, content):
    batch = torch.from_numpy(_frames(14, n, h, w, content)).to(device)
    y = batch[:, :h]
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    ext = natural.extend(y, plan)
    args = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
    got = lut.tile_histograms_extended(ext, *args)
    assert torch.equal(got, lut.tile_histograms_extended_ref(ext, *args))
    assert torch.equal(got, natural.tile_histograms(y, plan))
    torch.cuda.synchronize(device)


def test_build_luts_with_clip_tensor_equals_plain(device):
    plan = torch_clahe.make_clahe_plan(96, 128, 2.0, (8, 8))
    frames = torch.from_numpy(_frames(15, 4, 96, 128)).to(device)
    hists = natural.tile_histograms_ref(frames, plan)
    clips = torch.tensor([1, 0, 17, 400], dtype=torch.int32, device=device)
    got = natural.build_luts(hists, clips, plan.lut_scale)
    assert torch.equal(got, natural.build_luts_ref(hists, clips, plan.lut_scale))
    for i, c in enumerate(clips.tolist()):
        assert torch.equal(got[i], natural.build_luts_ref(hists[i:i + 1], c,
                                                          plan.lut_scale)[0])
    strided = torch.ones(8, dtype=torch.int32, device=device)[::2]
    for bad in (clips[:3], clips.to(torch.int64), clips.cpu(), strided):
        with pytest.raises(ValueError, match="clip"):
            natural.build_luts(hists, bad, plan.lut_scale)
    torch.cuda.synchronize(device)


def test_clahe_auto_on_card_equals_cpu_and_counts_launches(device):
    from opencv_opencl_tpu_torch.ops import auto_clahe

    frames = np.stack([_frames(16, 1, 108, 192)[0],
                       np.full((108, 192), 90, np.uint8),
                       (_frames(17, 1, 108, 192)[0] // 8 + 100)])
    torch_cuda.reset_launch_counts()
    out, clips = auto_clahe.clahe_auto(frames, (8, 8), device=device)
    counts = torch_cuda.launch_counts()
    assert counts["tile_histograms"] == 2 and counts["build_luts"] == 1
    assert counts["clahe_interpolate_cells"] == 1
    assert counts["clahe_interpolate"] == 0
    cpu_out, cpu_clips = auto_clahe.clahe_auto(frames, (8, 8), device="cpu")
    assert torch.equal(out.cpu(), cpu_out)
    area = torch_clahe.make_clahe_plan(108, 192, 40.0, (8, 8)).tile_area
    assert torch.equal(auto_clahe.int_clips(clips.cpu(), area),
                       auto_clahe.int_clips(cpu_clips, area))


@pytest.mark.parametrize("h,w,grid", [(108, 192, (8, 8)), (66, 120, (4, 4))])
def test_pallas_backend_on_card_equals_cpu_and_counts_launches(device, h, w, grid):
    frames = _frames(18, 3, h, w)
    torch_cuda.reset_launch_counts()
    out = torch_clahe.clahe(frames, 2.0, grid, backend="pallas", device=device)
    counts = torch_cuda.launch_counts()
    assert (counts["tile_histograms"], counts["build_luts"],
            counts["clahe_interpolate_cells"], counts["clahe_interpolate"]) == (1, 1, 1, 0)
    assert torch.equal(out.cpu(), torch_clahe.clahe(frames, 2.0, grid,
                                                    backend="xla", device="cpu"))
    for i, f in enumerate(frames):
        assert np.array_equal(out[i].cpu().numpy(), golden.clahe(f, 2.0, grid))


BAND_CASES = [
    # (n, h, w, grid, content)
    (2, 96, 128, (8, 8), "nv12"),       # strided Y rows of NV12
    (1, 1080, 1920, (8, 8), "nv12"),    # K9's head, unit and tail columns
    (1, 1079, 1919, (8, 8), "random"),  # odd geometry
    (2, 67, 131, (5, 3), "random"),     # odd grid
    (2, 64, 128, (8, 8), "constant"),
]


@pytest.mark.parametrize("n,h,w,grid,content", BAND_CASES)
def test_band_kernels_equal_plain_and_whole_frame_kernels(device, n, h, w, grid, content):
    """K5, K3v1 and K9 on the sharded step's bands for 2, 3 and 4 positions,
    in place, against their plain versions, K3 and K6; K1 per band of tile
    rows against K1 on the whole frame."""
    batch = torch.from_numpy(_frames(11, n, h, w, content)).to(device)
    y = batch[:, :h]
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    spec = lut.make_interp_spec(h, w, 2.0, grid)
    luts = natural.build_luts_ref(natural.tile_histograms_ref(
        torch.from_numpy(_frames(12, n, h, w)).to(device), plan), plan.clip, plan.lut_scale)
    k3 = natural.clahe_interpolate(y, luts, plan)
    assert torch.equal(natural.clahe_interpolate_pack(y, luts, plan), k3)
    assert torch.equal(natural.clahe_interpolate_pack_ref(y, luts, plan), k3)
    whole_hists = natural.tile_histograms(y, plan)
    for space in (2, 3, 4):
        tiles_yp, _, hq = sharded._clahe_geometry(plan, space)
        inplace = batch.clone()
        hists = []
        for s in range(space):
            row0 = min(s * (hq // space), h)
            row1 = min((s + 1) * (hq // space), h)
            band = y[:, row0:row1]
            got = natural.clahe_interpolate_band(band, luts, plan, row0)
            assert torch.equal(got, natural.clahe_interpolate_band_ref(band, luts, plan, row0))
            assert torch.equal(got, k3[:, row0:row1])
            got9 = lut.clahe_interpolate_cells_band(band, luts, spec, row0)
            assert torch.equal(got9, lut.clahe_interpolate_cells_band_ref(band, luts, spec, row0))
            assert torch.equal(got9, got)
            view = inplace[:, row0:row1]
            natural.clahe_interpolate_band(view, luts, plan, row0, out=view)
            tile_rows = (min(s * (tiles_yp // space), plan.tiles_y),
                         min((s + 1) * (tiles_yp // space), plan.tiles_y))
            lo, hi = natural.band_source_rows(plan, tile_rows)
            hists.append(natural.tile_histograms(y[:, lo:hi], plan, 1, tile_rows, lo))
        assert torch.equal(inplace[:, :h], k3)
        assert torch.equal(inplace[:, h:], batch[:, h:])
        assert torch.equal(torch.cat(hists, dim=1), whole_hists)
    # any row0, and a band that runs past the frame: those rows stay
    past = torch.cat([y[:, h - 5:], y[:, :3]], dim=1).contiguous()
    for fn, geom in ((natural.clahe_interpolate_band, plan),
                     (lut.clahe_interpolate_cells_band, spec)):
        assert torch.equal(fn(y[:, 5:h - 3], luts, geom, 5), k3[:, 5:h - 3])
        got = fn(past, luts, geom, h - 5)
        assert torch.equal(got[:, :5], k3[:, h - 5:]) and torch.equal(got[:, 5:], past[:, 5:])


def test_lut_pack_on_card_holds_the_direct_lookups(device):
    plan = torch_clahe.make_clahe_plan(96, 128, 2.0, (8, 8))
    spec = natural.make_pack_spec(96, 128, 2.0, (8, 8))
    luts = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (2, plan.num_tiles, 256), dtype=np.uint8)).to(device)
    pack = natural.build_lut_pack(luts, spec)
    assert pack.is_contiguous() and pack.shape == (2, 9, 9, 256, 4)
    assert torch.equal(pack.cpu(), natural.build_lut_pack(luts.cpu(), spec))


@pytest.mark.parametrize("op,chroma", [("clahe", ChromaPolicy.PASSTHROUGH),
                                       ("histeq", ChromaPolicy.GRAY)])
def test_sharded_enhancer_in_process_on_card_equals_cpu(device, op, chroma):
    """Every mesh position run in this process on the card: the kernels on
    the bands, against the single-device Enhancer on the CPU."""
    spec = FrameSpec(width=120, height=66)
    cfg = torch_enhancer.EnhancerConfig(op=op, clip_limit=2.0, tile_grid=(8, 8),
                                        chroma=chroma)
    batch = _frames(14, 4, spec.buffer_rows, spec.width)
    want = np.asarray(torch_enhancer.Enhancer(cfg, spec, "cpu").process_batch(batch))
    for shape in ((2, 2), (1, 4), (2, 3), (1, 1)):
        torch_cuda.reset_launch_counts()
        enhancer = sharded.ShardedEnhancer(cfg, spec, mesh=shape, device=device)
        assert np.array_equal(np.asarray(enhancer.process_batch(batch)), want), shape
        counts = torch_cuda.launch_counts()
        bands = enhancer._y_step.bands
        # a position whose band is empty (66 rows in 4 bands of 24) has
        # nothing to map
        mapping = shape[0] * sum(r1 > r0 for r0, r1 in map(bands.rows, range(shape[1])))
        assert counts["tile_histograms"] == shape[0] * shape[1]
        if op == "clahe":
            assert counts["build_luts"] == counts["clahe_interpolate_band"] == mapping
            assert counts["clahe_interpolate"] == 0
        else:
            assert counts["apply_lut"] == mapping


def test_sharded_enhancer_on_a_process_group_sharing_the_card(device):
    """Two spawned processes on the one card (gloo, staged through the
    host): each compares the assembled batch with the single-card Enhancer."""
    spec = FrameSpec(width=128, height=96)
    cfg = torch_enhancer.EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                                        chroma=ChromaPolicy.PASSTHROUGH)
    batch = _frames(15, 2, spec.buffer_rows, spec.width)
    ranks = launch.run_on_mesh((1, 2), launch.compare_with_enhancer,
                               ([(cfg, spec, [batch])],), device_type="cuda",
                               timeout=240.0)
    for rank, (res,) in enumerate(ranks):
        assert res["equal"] == [True] and res["local_equal"] == [True]
        assert res["launches"]["clahe_interpolate_band"] == 2    # assembled + local
        assert res["part"].rows == ((0, 48), (48, 96))[rank]
        assert res["loaded"] == []
