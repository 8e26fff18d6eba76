"""The port's NV12 step (slice 1) against the JAX package, end to end.

Same NV12 batches (numpy, from a seed) through the JAX ``build_enhance_fn``
and the port's.  Tolerance: 0 LSB against ``core.golden`` (and so cv2) and
on every chroma row.  The JAX package on the CPU is itself off golden by
rare FMA ties in its blend (tests/conftest.py), so the Y rows are held to
the JAX output with ``assert_clahe_close`` and to golden exactly.  Then
the port's ``Enhancer`` through the port's own ``runtime.feeder.FrameFeeder``
against the JAX ``Enhancer`` through the JAX package's, and the checks that
the port and ``chip_smoke.py`` import neither JAX nor the JAX package.
"""

import ast
import functools
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu.models import enhancer as jax_enhancer
from opencv_opencl_tpu.runtime import feeder as jax_feeder
from opencv_opencl_tpu_torch import native as torch_native
from opencv_opencl_tpu_torch.models import enhancer as torch_enhancer
from opencv_opencl_tpu_torch.runtime import feeder as torch_feeder
from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "opencv_opencl_tpu_torch")

PAD_SPEC = FrameSpec(width=120, height=66)     # not tile-divisible: padded
EVEN_SPEC = FrameSpec(width=128, height=96)    # tile_h 12: hist_downsample 2


def _nv12(seed, n, spec):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 180, spec.width, dtype=np.float32)[None, :]
    y = np.clip(base + rng.normal(0, 25, (n, spec.height, spec.width)), 0, 255)
    uv = rng.integers(0, 256, (n, spec.height // 2, spec.width), dtype=np.uint8)
    return np.concatenate([y.astype(np.uint8), uv], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_out(spec, op, clip, chroma, ds, seed, n):
    cfg = jax_enhancer.EnhancerConfig(op=op, clip_limit=clip, chroma=chroma,
                                      hist_downsample=ds)
    fn = jax_enhancer.build_enhance_fn(cfg, spec, donate=False)
    return np.asarray(fn(_nv12(seed, n, spec)))


def _port_run(spec, op, clip, chroma, ds, donate, seed, n):
    cfg = torch_enhancer.EnhancerConfig(op=op, clip_limit=clip, chroma=chroma,
                                        hist_downsample=ds)
    fn = torch_enhancer.build_enhance_fn(cfg, spec, donate=donate)
    x = torch.from_numpy(_nv12(seed, n, spec))
    return x, fn(x)


def _golden_nv12(src, spec, clip, chroma, ds=1):
    """The expected NV12 batch, from the numpy golden model.  With
    ``ds > 1`` the LUTs come from every ds-th row (integer-exact in the JAX
    package's plain histogram and LUT build) and golden interpolates."""
    from opencv_opencl_tpu.ops import clahe as jax_clahe

    h = spec.height
    out = src.copy()
    for i, frame in enumerate(src):
        y = frame[:h]
        if ds == 1:
            out[i, :h] = golden.clahe(y, clip, (8, 8))
        else:
            plan = jax_clahe.make_clahe_plan(h, spec.width, clip, (8, 8))
            hists = jax_clahe._tile_histograms(y, plan, "onehot", rowstep=ds)
            luts = np.asarray(jax_clahe._luts_from_hists(hists, plan))
            out[i, :h] = golden.clahe_apply_luts(
                y, luts.reshape(plan.tiles_y, plan.tiles_x, 256),
                plan.tile_h, plan.tile_w)
    if chroma == ChromaPolicy.GRAY:
        out[:, h:] = 128
    return out


def _assert_step_output(got, src, jax_out, spec, clip, chroma, ds=1):
    h = spec.height
    assert np.array_equal(got, _golden_nv12(src, spec, clip, chroma, ds))
    assert np.array_equal(got[:, h:], jax_out[:, h:])
    assert_clahe_close(got[:, :h], jax_out[:, :h])


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("chroma", [ChromaPolicy.PASSTHROUGH, ChromaPolicy.GRAY])
@pytest.mark.parametrize("clip", [2.0, 40.0])
def test_clahe_step_equals_jax_and_golden(clip, chroma, donate):
    spec, n = PAD_SPEC, 3
    src = _nv12(11, n, spec)
    x, out = _port_run(spec, "clahe", clip, chroma, 1, donate, 11, n)
    got = out.numpy()
    _assert_step_output(got, src, _jax_out(spec, "clahe", clip, chroma, 1, 11, n),
                        spec, clip, chroma)
    # donation: only donate=True overwrites the input tensor
    assert (out.data_ptr() == x.data_ptr()) == donate
    assert np.array_equal(x.numpy(), got if donate else src)


@pytest.mark.parametrize("ds", [2, 3])
def test_hist_downsample_equals_jax(ds):
    spec, n = EVEN_SPEC, 2
    _, out = _port_run(spec, "clahe", 2.0, ChromaPolicy.PASSTHROUGH, ds, True, 12, n)
    _assert_step_output(
        out.numpy(), _nv12(12, n, spec),
        _jax_out(spec, "clahe", 2.0, ChromaPolicy.PASSTHROUGH, ds, 12, n),
        spec, 2.0, ChromaPolicy.PASSTHROUGH, ds)


def test_hist_downsample_must_divide_tile_height():
    cfg = torch_enhancer.EnhancerConfig(op="clahe", hist_downsample=5)
    with pytest.raises(ValueError, match="hist_downsample"):
        torch_enhancer.build_enhance_fn(cfg, EVEN_SPEC)
    with pytest.raises(ValueError, match="hist_downsample"):
        jax_enhancer.build_enhance_fn(
            jax_enhancer.EnhancerConfig(op="clahe", hist_downsample=5), EVEN_SPEC)


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("chroma", [ChromaPolicy.PASSTHROUGH, ChromaPolicy.GRAY])
def test_op_none_equals_jax(chroma, donate):
    spec, n = PAD_SPEC, 2
    x, out = _port_run(spec, "none", 2.0, chroma, 1, donate, 13, n)
    assert np.array_equal(out.numpy(), _jax_out(spec, "none", 2.0, chroma, 1, 13, n))


def test_unported_modes_raise():
    """The feeder stages through the C++ ring (ported) given the frame
    shape, and refuses a ``native_staging`` that names none."""
    enh = torch_enhancer.Enhancer(torch_enhancer.EnhancerConfig(), PAD_SPEC,
                                  device="cpu")
    with pytest.raises(ValueError, match="native_staging"):
        torch_feeder.FrameFeeder(enh.process_batch, native_staging=True)
    fed = torch_feeder.FrameFeeder(
        enh.process_batch, native_staging=(PAD_SPEC.buffer_rows, PAD_SPEC.width))
    assert (fed._native is not None) == torch_native.available()


@pytest.mark.parametrize("kwargs", [dict(op="sharpen"), dict(hist_downsample=0)])
def test_config_validation_matches_jax(kwargs):
    with pytest.raises(ValueError):
        jax_enhancer.EnhancerConfig(**kwargs)
    with pytest.raises(ValueError):
        torch_enhancer.EnhancerConfig(**kwargs)


def test_step_rejects_wrong_batch_shape():
    fn = torch_enhancer.build_enhance_fn(
        torch_enhancer.EnhancerConfig(op="clahe"), PAD_SPEC)
    with pytest.raises(ValueError, match="expected uint8"):
        fn(torch.zeros((1, PAD_SPEC.height, PAD_SPEC.width), dtype=torch.uint8))


# ------------------------------------------------------------ Enhancer ----


def _cfg(enhancer_mod):
    return enhancer_mod.EnhancerConfig(op="clahe", clip_limit=2.0,
                                       tile_grid=(8, 8),
                                       chroma=ChromaPolicy.PASSTHROUGH)


def test_enhancer_keeps_the_host_batch():
    enh = torch_enhancer.Enhancer(_cfg(torch_enhancer), PAD_SPEC, device="cpu")
    src = _nv12(14, 2, PAD_SPEC)
    keep = src.copy()
    res = enh.process_batch(src)
    assert isinstance(res, DeviceBatch)
    out = np.asarray(res)
    assert np.array_equal(src, keep)          # the staging buffer is intact
    _assert_step_output(out, src, _jax_out(PAD_SPEC, "clahe", 2.0,
                                           ChromaPolicy.PASSTHROUGH, 1, 14, 2),
                        PAD_SPEC, 2.0, ChromaPolicy.PASSTHROUGH)
    frame = np.asarray(enh.process_frame(src[1]))
    assert np.array_equal(frame, out[1])


def test_device_batch_array_protocol():
    t = torch.arange(12, dtype=torch.uint8).reshape(2, 2, 3)
    b = DeviceBatch(t)
    assert b.tensor is t
    assert np.array_equal(np.asarray(b), t.numpy())
    assert np.asarray(b, dtype=np.int32).dtype == np.int32
    copied = np.array(b, copy=True)
    copied[0, 0, 0] = 99
    assert t[0, 0, 0] == 0


def _through_feeder(feeder_mod, process_batch, frames):
    outs, lock = {}, threading.Lock()

    def on_output(seq, frame, meta):
        with lock:
            outs[seq] = (meta, frame.copy())

    feeder = feeder_mod.FrameFeeder(process_batch, batch_size=4, depth=2,
                                    queue_capacity=len(frames) + 4,
                                    on_output=on_output)
    feeder.start()
    for i, f in enumerate(frames):
        feeder.submit(f, meta=i)
    feeder.stop(drain=True, timeout=120)
    return outs, feeder.stats


def test_enhancer_through_feeder_equals_jax_enhancer():
    frames = list(_nv12(15, 10, PAD_SPEC))
    port = torch_enhancer.Enhancer(_cfg(torch_enhancer), PAD_SPEC, device="cpu")
    ref = jax_enhancer.Enhancer(_cfg(jax_enhancer), PAD_SPEC)
    got, stats = _through_feeder(torch_feeder, port.process_batch, frames)
    want, _ = _through_feeder(jax_feeder, ref.process_batch, frames)
    assert stats.get("processing_errors", 0) == 0
    assert stats["emitted"] == len(frames)
    assert sorted(got) == list(range(len(frames)))
    for seq in range(len(frames)):
        assert got[seq][0] == seq                 # in order
    got_batch = np.stack([got[seq][1] for seq in range(len(frames))])
    want_batch = np.stack([want[seq][1] for seq in range(len(frames))])
    _assert_step_output(got_batch, np.stack(frames), want_batch, PAD_SPEC,
                        2.0, ChromaPolicy.PASSTHROUGH)


# -------------------------------------------------------------- no JAX ----


def _imports(path):
    """(module name, at module level) for every import of a source file; an
    import inside a function or a method is not at module level."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def walk(node, top):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                yield from ((a.name, top) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and not child.level:
                yield child.module, top
            else:
                inner = top and not isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
                yield from walk(child, inner)

    yield from walk(tree, True)


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, ROOT) for p in _port_sources()) + ["chip_smoke.py"])
def test_port_imports_no_jax(path):
    """No source of the port (``apps/``, ``io/``, ``models/``, ``runtime/``,
    ``__main__.py`` and the rest, and ``chip_smoke.py``) imports jax or the
    JAX package anywhere, nor cv2 at module level (``io/videofile.py`` and
    ``io/rtp.py`` import cv2 inside the methods that need it, as the JAX
    package's do)."""
    for name, top in _imports(os.path.join(ROOT, path)):
        root = name.split(".")[0]
        assert root not in ("jax", "opencv_opencl_tpu"), (path, name)
        assert not (root == "cv2" and top), (path, name, "at module level")
    if path == "chip_smoke.py":     # the card's machine has no cv2 at all
        assert "cv2" not in {n.split(".")[0] for n, _ in
                             _imports(os.path.join(ROOT, path))}


def test_import_scan_tells_module_level_from_lazy_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\ntry:\n    import cv2\nexcept ImportError:\n    cv2 = None\n"
                   "class A:\n    import json\n    def f(self):\n        import jax\n"
                   "def g():\n    from opencv_opencl_tpu.io import rtp\n")
    assert sorted(_imports(str(src))) == [
        ("cv2", True), ("jax", False), ("json", True),
        ("opencv_opencl_tpu.io", False), ("os", True)]
    paths = {os.path.relpath(p, PORT) for p in _port_sources()}
    for needed in ("apps/relay.py", "apps/multi_relay.py", "apps/_cli.py",
                   "io/videofile.py", "io/rtp.py", "io/rtcp.py", "io/sdp.py",
                   "io/gst.py", "models/presets.py", "runtime/governor.py",
                   "runtime/mux.py", "__main__.py", "native/__init__.py"):
        assert needed in paths, needed


def test_port_runs_without_loading_jax():
    code = """
import pkgutil, sys, importlib
import numpy as np
import opencv_opencl_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.models.enhancer import (
    Enhancer, EnhancerConfig, StreamingEnhancer)
spec = FrameSpec(width=64, height=32)
clahe = EnhancerConfig(op="clahe", chroma=ChromaPolicy.PASSTHROUGH)
for enh in (Enhancer(clahe, spec, device="cpu"),
            Enhancer(EnhancerConfig(), spec, device="cpu"),
            StreamingEnhancer(clahe, spec, device="cpu")):
    out = np.asarray(enh.process_batch(np.zeros((2, 48, 64), np.uint8)))
    assert out.shape == (2, 48, 64)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "opencv_opencl_tpu"))
assert not loaded, loaded
print("NOJAX-OK")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout


def _run_chip_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    res = _run_chip_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
