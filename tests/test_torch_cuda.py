"""The port's CUDA kernels on the card, each against its plain version.

Needs a CUDA card (marker ``cuda``); every test skips without one.  On a
machine with a card and no JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The same cases as ``chip_smoke.py`` phase 3, at small sizes: the wrappers'
outputs (K1 histograms, K2 LUTs, K3 frames) must equal the plain PyTorch
versions on the same CUDA inputs exactly, and the whole step must equal
``core.golden``.  Tolerance: 0.
"""

import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.models import enhancer as torch_enhancer
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.ops.cuda import _build, natural

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
    (1, 64, 64, 2.0, (16, 16), 1, "random"),   # 256 tiles: LUTs read via __ldg
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


def test_lut_build_residual_edge_cases(device):
    plan = torch_clahe.make_clahe_plan(96, 128, 2.0, (8, 8))
    hists = np.zeros((1, plan.num_tiles, 256), np.int32)
    c, area = plan.clip, plan.tile_area
    hists[0, 0, 0] = area
    hists[0, 1, :] = area // 256
    hists[0, 1, 0] += area - hists[0, 1].sum()
    hists[0, 2, :2] = [c + 255, area - (c + 255)]
    hists[0, 3, :2] = [c + 256, area - (c + 256)]
    hists[0, 4, :2] = [c + 1, area - (c + 1)]
    h = torch.from_numpy(hists).to(device)
    assert torch.equal(natural.build_luts(h, plan.clip, plan.lut_scale),
                       natural.build_luts_ref(h, plan.clip, plan.lut_scale))


def test_step_equals_golden_and_counts_launches(device):
    h, w = 108, 192
    frames = _frames(2, 2, h, w)
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, (8, 8))
    natural.reset_launch_counts()
    out = torch_clahe.clahe_apply(torch.from_numpy(frames).to(device), plan)
    assert natural.launch_counts() == {
        "tile_histograms": 1, "build_luts": 1, "clahe_interpolate": 1}
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
