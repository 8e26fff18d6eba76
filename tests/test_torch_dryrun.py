"""The port's ``entry.py`` against the root ``__graft_entry__.py``.

- ``entry(device="cpu")``: the same batch as ``__graft_entry__.entry()``;
  its step's output within ``assert_clahe_close`` of the JAX step's (JAX's
  CPU backend FMA-contracts the CLAHE blend, tests/conftest.py) and equal
  to ``core/golden.py``.
- ``dryrun_multichip(n, device_type="cpu")`` for 8 and 2 processes on gloo:
  the JAX dry run's line word for word (for 8 as ``MULTICHIP_r05.json``
  records it), every rank's checks passed (its sharded outputs bit-equal to
  the single-card ``Enhancer``'s, rank 0's streams byte-equal to the
  single-card encoder's), and rank 0's sharded outputs held to the JAX
  package's ``build_sharded_pipeline`` on its 8-device CPU mesh cut to the
  same shape: histeq exact, CLAHE within ``assert_clahe_close`` and equal
  to golden.
- Without a card the dry run raises before it starts a process.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__ as graft
from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.core.frames import ChromaPolicy as JaxChroma
from opencv_opencl_tpu.models.enhancer import EnhancerConfig as JaxConfig
from opencv_opencl_tpu.parallel import build_sharded_pipeline as jax_pipeline
from opencv_opencl_tpu.parallel import make_mesh as jax_make_mesh
from opencv_opencl_tpu_torch import entry
from opencv_opencl_tpu_torch.parallel import launch
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX dry run's line for 2 devices (mesh (2, 1)); for 8 it is
# MULTICHIP_r05.json's
JAX_LINE_2 = ("dryrun_multichip OK: mesh(data=2, space=1), batch=4, frame=128x128 + "
              "odd 131x67 + fused enhance+GOP encode (6 frames GOP-per-device, "
              "byte-identical) + slice-band encode (2 bands, MC-halo windows, "
              "byte-identical)")


def _jax_line(n: int) -> str:
    if n == 2:
        return JAX_LINE_2
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        record = json.load(f)
    assert record["n_devices"] == n and record["ok"]
    return record["tail"].strip()


def test_entry_equals_the_jax_entry_and_golden():
    fn, (batch,) = entry.entry(device="cpu")
    cache_dir = jax.config.jax_compilation_cache_dir
    jax_fn, (jax_batch,) = graft.entry()
    # graft.entry() turns on a persistent compile cache; the test keeps
    # JAX's cache setting as it found it
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert batch.device.type == "cpu"
    assert np.array_equal(batch.numpy(), jax_batch)
    out = fn(batch).numpy()
    want = np.asarray(jax_fn(jax_batch))
    h = 720
    assert out.shape == want.shape == (2, h * 3 // 2, 1280)
    assert_clahe_close(out[:, :h], want[:, :h])
    assert np.array_equal(out[:, h:], jax_batch[:, h:])
    for frame, src in zip(out, jax_batch):
        assert np.array_equal(frame[:h], golden.clahe(src[:h], 2.0, (8, 8)))
    assert np.array_equal(batch.numpy(), jax_batch)     # the step wrote a new tensor


def _jax_outputs(n: int, y, uv, y3, uv3, tiles_y: int):
    """The JAX package's sharded CLAHE passthrough, histeq gray and odd
    CLAHE steps on its CPU mesh of ``n`` devices, on the dry run's
    inputs."""
    mesh = jax_make_mesh(n)
    clahe_cfg = JaxConfig(op="clahe", clip_limit=2.0, tile_grid=(8, tiles_y),
                          chroma=JaxChroma.PASSTHROUGH)
    histeq_cfg = JaxConfig(op="histeq", chroma=JaxChroma.GRAY)
    h, w = y.shape[1:]
    uv_sharding = NamedSharding(mesh, P("data", "space", None))
    outs = {}
    for name, cfg in (("clahe", clahe_cfg), ("histeq", histeq_cfg)):
        fn, sharding = jax_pipeline(cfg, h, w, mesh)
        y_out, uv_out = fn(jax.device_put(y, sharding), jax.device_put(uv, uv_sharding))
        outs[name] = np.concatenate([np.asarray(y_out), np.asarray(uv_out)], axis=1)
    fn3, sharding3 = jax_pipeline(clahe_cfg, *y3.shape[1:], mesh)
    outs["odd"] = np.asarray(fn3(jax.device_put(y3, sharding3), uv3)[0])
    return outs


@pytest.mark.parametrize("n", [8, 2])
def test_dryrun_multichip_on_cpu_equals_the_jax_dry_run(n, capfd):
    ranks = entry.dryrun_multichip(n, device_type="cpu", return_outputs=True)
    out = capfd.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("dryrun_multichip")]
    assert lines == [_jax_line(n), f"dryrun_multichip backend: gloo, {n} processes on cpu"]
    assert len(ranks) == n
    for res in ranks:
        assert res["backend"] == "gloo" and not res["loaded"]
        assert all(res["checks"].values()), res["checks"]
        assert all(r is None for r in res["errors"])
    d, s, batch, w, h = ranks[0]["geometry"]
    assert (d, s) == jax_make_mesh(n).devices.shape
    assert [len(aus) > 0 for aus in ranks[0]["aus"]] == [True] * 3

    # the dry run's inputs, drawn as the JAX dry run draws them
    tiles_y = 8 if 8 % s == 0 else s
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (batch, h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (batch, h // 2, w), dtype=np.uint8)
    y3 = rng.integers(0, 256, (batch, 67, 131), dtype=np.uint8)
    uv3 = rng.integers(0, 256, (batch, 34, 131), dtype=np.uint8)
    got = ranks[0]["outputs"]
    want = _jax_outputs(n, y, uv, y3, uv3, tiles_y)
    assert np.array_equal(got["histeq"], want["histeq"])
    assert_clahe_close(got["clahe"][:, :h], want["clahe"][:, :h])
    assert np.array_equal(got["clahe"][:, h:], uv)
    assert_clahe_close(got["odd"], want["odd"])
    for frame, src in zip(got["clahe"], y):
        assert np.array_equal(frame[:h], golden.clahe(src, 2.0, (8, tiles_y)))
    for frame, src in zip(got["odd"], y3):
        assert np.array_equal(frame, golden.clahe(src, 2.0, (8, tiles_y)))


def test_dryrun_multichip_without_a_card_raises_and_spawns_nothing(monkeypatch):
    spawned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "run_on_mesh", lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        entry.main(["2"])
    with pytest.raises(ValueError, match="device_type"):
        entry.dryrun_multichip(2, device_type="tpu")
    assert spawned == []
    assert entry.main([]) == 2 and entry.main(["x"]) == 2 and entry.main(["0"]) == 2
