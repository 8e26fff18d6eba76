"""The port's histeq (slice 2) against the JAX package, golden and cv2.

Same inputs, made with numpy from a seed, through the JAX functions and
the port's on CPU tensors: ``hist256``, ``equalize_lut``, the LUT map (K4's
plain version against ``lut_kernels.apply_lut_pallas`` in interpret mode),
the ``ops/histeq.py`` entry points and the three histeq branches of
``make_enhance_y`` (exact, ``hist_downsample > 1``, ``use_ref_frame``) in the
NV12 step.  Tolerance: 0 LSB everywhere — histeq has no blend, so the JAX
package on the CPU is exact too.
"""

import cv2
import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.models import enhancer as jax_enhancer
from opencv_opencl_tpu.ops import histeq as jax_histeq
from opencv_opencl_tpu.ops import histogram as jax_histogram
from opencv_opencl_tpu.ops.pallas import lut_kernels
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.models import enhancer as torch_enhancer
from opencv_opencl_tpu_torch.ops import histeq, histogram
from opencv_opencl_tpu_torch.ops.cuda import lut
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

SPEC = FrameSpec(width=120, height=68)   # 68 % 3 != 0: a ragged ds=3 tail


def _frames(seed, n, h, w, kind="structured"):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    if kind == "constant":
        return np.full((n, h, w), 93, np.uint8)
    if kind == "sparse":       # few distinct values, first bin well above 0
        return rng.choice(np.array([40, 41, 200], np.uint8), (n, h, w))
    base = np.linspace(20, 180, w, dtype=np.float32)[None, :]
    return np.clip(base + rng.normal(0, 20, (n, h, w)), 0, 255).astype(np.uint8)


def _nv12(seed, n, spec, kind="structured"):
    y = _frames(seed, n, spec.height, spec.width, kind)
    uv = np.random.default_rng(seed + 1).integers(
        0, 256, (n, spec.height // 2, spec.width), dtype=np.uint8)
    return np.concatenate([y, uv], axis=1)


# ------------------------------------------------------------- hist256 ----


@pytest.mark.parametrize("h,w", [(68, 120), (97, 131), (1, 1), (5, 300)])
def test_hist256_equals_golden_and_jax(h, w):
    y = _frames(1, 3, h, w, "random")
    got = histogram.hist256(torch.from_numpy(y))
    assert got.dtype == torch.int32 and got.shape == (3, 256)
    for i in range(3):
        assert np.array_equal(got[i].numpy(), golden.hist256(y[i]))
        assert np.array_equal(got[i].numpy(), np.asarray(jax_histogram.hist256(y[i])))
    assert torch.equal(histogram.hist256(torch.from_numpy(y[0])), got[0])


def test_hist256_takes_strided_rows():
    """The view ``y[:, ::ds]`` goes to the histogram without a copy."""
    nv12 = torch.from_numpy(_nv12(2, 2, SPEC))
    sub = nv12[:, :SPEC.height:3]
    assert not sub.is_contiguous()
    got = histogram.hist256(sub)
    for i in range(2):
        assert np.array_equal(got[i].numpy(), golden.hist256(sub[i].numpy()))


# -------------------------------------------------------- equalize_lut ----


def _hists_cases():
    rng = np.random.default_rng(3)
    cases = [golden.hist256(f) for f in _frames(4, 2, 40, 60, "random")]
    cases += [golden.hist256(_frames(5, 1, 40, 60, k)[0])
              for k in ("constant", "sparse", "structured")]
    two = np.zeros(256, np.int64)
    two[[0, 255]] = [1, 2399]                       # mass in the last bin
    ties = np.zeros(256, np.int64)
    ties[7] = 2
    ties[8:8 + 240] = 2
    ties[250] = 30                                  # 255/510: exact .5 ties
    cases += [two, ties, rng.integers(0, 50, 256).astype(np.int64)]
    return np.stack(cases)


def test_equalize_lut_equals_jax_and_golden():
    hists = _hists_cases()
    totals = hists.sum(axis=1)
    for h, total in zip(hists, totals):
        got = histogram.equalize_lut(torch.from_numpy(h).to(torch.int32), int(total))
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), golden.equalize_lut(h, int(total)))
        assert np.array_equal(got.numpy(), np.asarray(
            jax_histogram.equalize_lut(h.astype(np.int32), total=int(total))))


def test_equalize_lut_batched_rows_are_independent():
    hists = _hists_cases()[:5]   # the same total: 40 x 60 frames
    total = int(hists[0].sum())
    got = histogram.equalize_lut(torch.from_numpy(hists).to(torch.int32), total)
    for i, h in enumerate(hists):
        assert np.array_equal(got[i].numpy(), golden.equalize_lut(h, total))


def test_equalize_lut_half_to_even_and_constant_identity():
    # scale = 255/510 = 0.5 exactly: odd cumulative counts land on .5 ties
    h = np.zeros(256, np.int64)
    h[10] = 2
    h[11:11 + 255] = 2
    total = int(h.sum())
    got = histogram.equalize_lut(torch.from_numpy(h).to(torch.int32), total).numpy()
    cum_excl = np.cumsum(h) - h[10]
    want = np.clip(np.rint(cum_excl * np.float32(255.0 / (total - 2))), 0, 255)
    assert np.array_equal(got[10:], want[10:].astype(np.uint8))
    assert got[10] == 0 and not got[:10].any()
    const = np.zeros(256, np.int64)
    const[93] = 500
    assert np.array_equal(
        histogram.equalize_lut(torch.from_numpy(const).to(torch.int32), 500).numpy(),
        np.arange(256, dtype=np.uint8))


# ------------------------------------------------------------ LUT map ----


@pytest.mark.parametrize("h,w", [(16, 1024), (13, 37), (1, 1)])
def test_apply_lut_equals_pallas_kernel(h, w):
    rng = np.random.default_rng(6)
    y = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    luts = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    got = lut.apply_lut(torch.from_numpy(y), torch.from_numpy(luts))
    for i in range(2):
        want = np.asarray(lut_kernels.apply_lut_pallas(y[i], luts[i], interpret=True))
        assert np.array_equal(got[i].numpy(), want)
        assert np.array_equal(
            histeq.apply_lut(y[i], luts[i], device="cpu").numpy(), want)
    assert torch.equal(histeq.apply_lut(y, luts, device="cpu"), got)


def test_apply_lut_in_place_over_nv12_rows():
    nv12 = torch.from_numpy(_nv12(7, 2, SPEC))
    keep = nv12.clone()
    luts = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 256), dtype=np.uint8))
    y = nv12[:, :SPEC.height]
    out = lut.apply_lut(y, luts, out=y)
    assert out.data_ptr() == nv12.data_ptr()
    assert torch.equal(nv12[:, :SPEC.height],
                       lut.apply_lut_ref(keep[:, :SPEC.height], luts))
    assert torch.equal(nv12[:, SPEC.height:], keep[:, SPEC.height:])


def test_apply_lut_checks_its_inputs():
    y = torch.zeros((2, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="luts must be"):
        lut.apply_lut(y, torch.zeros((1, 256), dtype=torch.uint8))
    with pytest.raises(TypeError):
        lut.apply_lut(y.to(torch.int32), torch.zeros((2, 256), dtype=torch.uint8))
    with pytest.raises(ValueError, match="unit column stride"):
        lut.apply_lut(y.transpose(1, 2)[:, :, ::2],
                      torch.zeros((2, 256), dtype=torch.uint8))


# ------------------------------------------------------- ops/histeq.py ----


@pytest.mark.parametrize("method", ["onehot", "scatter"])
def test_entry_points_take_the_reference_method_and_backend(method):
    """The JAX package's signatures: ``method`` (and ``backend`` for
    ``apply_lut``) in the reference's position, ``device`` by keyword; both
    packages give the same output for every method and backend."""
    y = _frames(12, 2, 40, 56, "random")
    luts = np.random.default_rng(13).integers(0, 256, (2, 256), dtype=np.uint8)
    assert np.array_equal(
        histeq.equalize_hist_batch(y, method, device="cpu").numpy(),
        np.asarray(jax_histeq.equalize_hist_batch(y, method)))
    assert np.array_equal(histeq.equalize_hist(y[0], method, device="cpu").numpy(),
                          np.asarray(jax_histeq.equalize_hist(y[0], method)))
    assert np.array_equal(
        histeq.equalize_hist_ref(y[0], y[1], method, device="cpu").numpy(),
        np.asarray(jax_histeq.equalize_hist_ref(y[0], y[1], method)))
    assert np.array_equal(histogram.hist256(torch.from_numpy(y[0]), method).numpy(),
                          np.asarray(jax_histogram.hist256(y[0], method)))
    for backend in ("auto", "pallas", "xla"):
        assert np.array_equal(
            histeq.apply_lut(y[0], luts[0], backend, device="cpu").numpy(),
            np.asarray(jax_histeq.apply_lut(y[0], luts[0], backend)))


@pytest.mark.parametrize("call", ["hist256", "equalize_hist", "equalize_hist_ref",
                                  "equalize_hist_batch"])
def test_unknown_method_raises_like_jax(call):
    y = _frames(14, 2, 16, 24, "random")
    ours = {"hist256": lambda m: histogram.hist256(torch.from_numpy(y), m),
            "equalize_hist": lambda m: histeq.equalize_hist(y[0], m, device="cpu"),
            "equalize_hist_ref": lambda m: histeq.equalize_hist_ref(
                y[0], y[1], m, device="cpu"),
            "equalize_hist_batch": lambda m: histeq.equalize_hist_batch(
                y, m, device="cpu")}[call]
    theirs = {"hist256": lambda m: jax_histogram.hist256(y[0], m),
              "equalize_hist": lambda m: jax_histeq.equalize_hist(y[0], m),
              "equalize_hist_ref": lambda m: jax_histeq.equalize_hist_ref(
                  y[0], y[1], m),
              "equalize_hist_batch": lambda m: jax_histeq.equalize_hist_batch(
                  y, m)}[call]
    for fn in (ours, theirs):
        with pytest.raises(ValueError, match="unknown histogram method 'radix'"):
            fn("radix")
    # a device where the method goes is a method too
    with pytest.raises(ValueError, match="unknown histogram method 'cpu'"):
        ours("cpu")


@pytest.mark.parametrize("op", ["histeq", "clahe"])
@pytest.mark.parametrize("method", ["scatter", "bogus"])
def test_enhancer_hist_method_like_jax(op, method):
    """``EnhancerConfig.hist_method`` reaches the histograms: a known method
    gives the JAX package's output, an unknown one raises at the first step
    in both packages."""
    spec = FrameSpec(width=64, height=48)
    batch = _nv12(15, 2, spec, "random")
    ours = torch_enhancer.Enhancer(
        torch_enhancer.EnhancerConfig(op=op, hist_method=method), spec, "cpu")
    jax_spec = jax_enhancer.FrameSpec(width=64, height=48)
    theirs = jax_enhancer.Enhancer(
        jax_enhancer.EnhancerConfig(op=op, hist_method=method), jax_spec)
    if method == "bogus":
        for enhancer in (ours, theirs):
            with pytest.raises(ValueError, match="unknown histogram method"):
                np.asarray(enhancer.process_batch(batch))
        return
    got = np.asarray(ours.process_batch(batch))
    want = np.asarray(theirs.process_batch(batch))
    if op == "histeq":
        assert np.array_equal(got, want)
    else:
        assert_clahe_close(got, want)       # FMA ties in JAX


@pytest.mark.parametrize("kind", ["structured", "random", "constant", "sparse"])
def test_equalize_hist_equals_jax_golden_cv2(kind):
    y = _frames(9, 3, 50, 70, kind)
    batch = histeq.equalize_hist_batch(y, device="cpu")
    assert batch.device.type == "cpu"
    assert np.array_equal(batch.numpy(), np.asarray(jax_histeq.equalize_hist_batch(y)))
    for i in range(3):
        want = cv2.equalizeHist(y[i])
        assert np.array_equal(golden.equalize_hist(y[i]), want)
        assert np.array_equal(histeq.equalize_hist(y[i], device="cpu").numpy(), want)
        assert np.array_equal(np.asarray(jax_histeq.equalize_hist(y[i])), want)
        assert np.array_equal(batch[i].numpy(), want)
    got = histeq.equalize_hist_ref(y[0], y[1], device="cpu").numpy()
    assert np.array_equal(got, golden.equalize_hist(y[0], ref=y[1]))
    assert np.array_equal(got, np.asarray(jax_histeq.equalize_hist_ref(y[0], y[1])))


# ------------------------------------------------ the NV12 histeq step ----


def _golden_histeq_nv12(src, spec, chroma, ds=1, ref_frame=False):
    h, w = spec.height, spec.width
    out = src.copy()
    for i, frame in enumerate(src):
        y = frame[:h]
        if ds > 1:
            hist = golden.hist256(y[::ds]) * ds
            out[i, :h] = golden.equalize_lut(hist, -(-h // ds) * w * ds)[y]
        elif ref_frame:
            out[i, :h] = golden.equalize_hist(y, ref=src[max(i - 1, 0), :h])
        else:
            out[i, :h] = golden.equalize_hist(y)
    if chroma == ChromaPolicy.GRAY:
        out[:, h:] = 128
    return out


BRANCHES = [dict(), dict(hist_downsample=2), dict(hist_downsample=3),
            dict(use_ref_frame=True)]


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("chroma", [ChromaPolicy.GRAY, ChromaPolicy.PASSTHROUGH])
@pytest.mark.parametrize("kw", BRANCHES, ids=["exact", "ds2", "ds3", "ref_frame"])
def test_histeq_step_equals_jax_and_golden(kw, chroma, donate):
    src = _nv12(10, 3, SPEC)
    jcfg = jax_enhancer.EnhancerConfig(op="histeq", chroma=chroma, **kw)
    want = np.asarray(jax_enhancer.build_enhance_fn(jcfg, SPEC, donate=False)(src))
    cfg = torch_enhancer.EnhancerConfig(op="histeq", chroma=chroma, **kw)
    x = torch.from_numpy(src.copy())
    got = torch_enhancer.build_enhance_fn(cfg, SPEC, donate=donate)(x).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _golden_histeq_nv12(
        src, SPEC, chroma, kw.get("hist_downsample", 1), kw.get("use_ref_frame", False)))
    assert np.array_equal(x.numpy(), got if donate else src)


def test_histeq_ref_frame_carries_nothing_across_batches():
    cfg = torch_enhancer.EnhancerConfig(op="histeq", use_ref_frame=True)
    enh = torch_enhancer.Enhancer(cfg, SPEC, device="cpu")
    first, second = _nv12(11, 2, SPEC), _nv12(12, 2, SPEC)
    np.asarray(enh.process_batch(first))
    out = np.asarray(enh.process_batch(second))
    h = SPEC.height
    assert np.array_equal(out[0, :h], golden.equalize_hist(second[0, :h]))
    assert np.array_equal(out[1, :h], golden.equalize_hist(second[1, :h],
                                                           ref=second[0, :h]))


@pytest.mark.parametrize("op", ["histeq", "clahe", "none"])
def test_downsample_with_ref_frame_raises(op):
    kw = dict(op=op, hist_downsample=2, use_ref_frame=True)
    with pytest.raises(ValueError, match="use_ref_frame"):
        jax_enhancer.build_enhance_fn(jax_enhancer.EnhancerConfig(**kw), SPEC)
    with pytest.raises(ValueError, match="use_ref_frame"):
        torch_enhancer.build_enhance_fn(torch_enhancer.EnhancerConfig(**kw), SPEC)


def test_clahe_step_ignores_use_ref_frame():
    """The JAX package runs same-frame CLAHE when use_ref_frame is set on
    op="clahe" (streaming CLAHE is StreamingEnhancer); so does the port."""
    spec = FrameSpec(width=128, height=96)
    src = _nv12(13, 2, spec)
    outs = []
    for ref in (True, False):
        cfg = torch_enhancer.EnhancerConfig(op="clahe", use_ref_frame=ref)
        outs.append(torch_enhancer.build_enhance_fn(cfg, spec, donate=False)(
            torch.from_numpy(src)).numpy())
    assert np.array_equal(outs[0], outs[1])
    h = spec.height
    for i in range(2):
        assert np.array_equal(outs[0][i, :h], golden.clahe(src[i, :h], 2.0, (8, 8)))


def test_histeq_enhancer_is_the_default_config():
    cfg = torch_enhancer.EnhancerConfig()
    assert cfg.op == "histeq" and cfg.chroma == ChromaPolicy.GRAY
    src = _nv12(14, 2, SPEC)
    out = np.asarray(torch_enhancer.Enhancer(cfg, SPEC, device="cpu").process_batch(src))
    assert np.array_equal(out, _golden_histeq_nv12(src, SPEC, ChromaPolicy.GRAY))
    frame = np.asarray(torch_enhancer.Enhancer(cfg, SPEC, device="cpu")
                       .process_frame(src[1]))
    assert np.array_equal(frame, out[1])
