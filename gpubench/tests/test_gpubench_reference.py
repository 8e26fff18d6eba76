"""The plain references against the port's plain path at small sizes, the
control against the reference, the traffic generator's sequence."""

import pytest
import torch

from gpubench import frames
from gpubench.reference import clahe, gop


def _nv12(seed, n, h, w):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h * 3 // 2, w), dtype=torch.uint8, generator=g)


@pytest.mark.parametrize("h,w,grid,clip", [(64, 96, (8, 8), 2.0), (70, 130, (8, 8), 2.0),
                                          (216, 384, (8, 8), 2.0), (48, 64, (4, 3), 40.0)])
def test_clahe_reference_equals_the_port(h, w, grid, clip):
    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig, build_enhance_fn

    x = _nv12(h + w, 3, h, w)
    cfg = EnhancerConfig(op="clahe", clip_limit=clip, tile_grid=grid,
                         chroma=ChromaPolicy.PASSTHROUGH)
    out = build_enhance_fn(cfg, FrameSpec(width=w, height=h), donate=False)(x)
    plan = clahe.make_plan(h, w, clip, grid)
    assert torch.equal(clahe.clahe(x[:, :h], plan), out[:, :h])


def test_the_control_fails_the_clahe_comparison():
    x = _nv12(5, 2, 64, 96)
    plan = clahe.make_plan(64, 96, 2.0, (8, 8))
    ref = clahe.clahe(x[:, :64], plan)
    low = clahe.clahe(x[:, :64], plan, torch.bfloat16)
    assert int((ref != low).sum()) > 0


def test_gop_reference_equals_the_port():
    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig
    from opencv_opencl_tpu_torch.models.fused_encode import build_enhance_gop_fn

    h, w = 64, 96
    tr = frames.Traffic.from_json({"streams": 1, "frames_per_stream": 3, "in_flight": 2,
                                   "pool_frames": 6, "pan": [1, 2], "still_left": 0.25,
                                   "noise_block": [16, 16]})
    seq = frames.make_sequence(tr, w, h, 2**31 + 9, 3, "cpu")
    cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                         chroma=ChromaPolicy.PASSTHROUGH)
    fn = build_enhance_gop_fn(cfg, FrameSpec(width=w, height=h), gop=5, search=8,
                              subpel=3, deblock=True, device="cpu")
    plan = clahe.make_plan(h, w, 2.0, (8, 8))
    zero = (torch.zeros((h, w), dtype=torch.uint8),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8))
    got_rec = want_rec = zero
    for k in range(3):       # frames 0-8: an IDR, P frames, the next IDR at 5
        x = seq[3 * k:3 * k + 3]
        packed, *got_rec = fn(x, 30, 3 * k, *got_rec)
        want, want_rec = gop.encode(x, plan, 30, 3 * k, 5, 8, 3, True, want_rec)
        assert torch.equal(packed, want)
        assert all(torch.equal(a, b) for a, b in zip(got_rec, want_rec))
    low, _ = gop.encode(seq[:3], plan, 30, 0, 5, 8, 3, True, zero, torch.bfloat16)
    want, _ = gop.encode(seq[:3], plan, 30, 0, 5, 8, 3, True, zero)
    assert int((low != want).sum()) > 0


def test_the_sequence_is_seeded_and_plays_forward_and_back():
    tr = frames.Traffic.from_json({"streams": 4, "frames_per_stream": 1, "in_flight": 2,
                                   "pool_frames": 5, "pan": [1, 2]})
    a = frames.make_sequence(tr, 64, 32, 2**31 + 3, 4, "cpu")
    b = frames.make_sequence(tr, 64, 32, 2**31 + 3, 4, "cpu")
    c = frames.make_sequence(tr, 64, 32, 2**31 + 4, 4, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (tr.period + 3, 48, 64)
    assert [frames.pingpong(t, 5) for t in range(10)] == [0, 1, 2, 3, 4, 3, 2, 1, 0, 1]
    for t in range(a.shape[0]):
        assert torch.equal(a[t], a[frames.pingpong(t, 5)])
    # the pan: frame 1 is frame 0 moved by (1, 2) where the canvas allows
    assert torch.equal(a[1, 1:31, 0:62], a[0, 2:32, 2:64])


def test_a_fixed_camera_holds_still_but_for_noise_and_its_object():
    tr = frames.Traffic.from_json({"streams": 1, "frames_per_stream": 4, "in_flight": 2,
                                   "pool_frames": 4, "sensor_noise_sd": 2,
                                   "object": {"size": [8, 8], "step": [0, 8]}})
    a = frames.make_sequence(tr, 64, 32, 7, 4, "cpu").to(torch.int32)
    d = (a[1, :32] - a[0, :32]).abs()
    assert d.float().median() <= 3 and d.max() > 20
