"""The port's sharded (data x space) enhancement path against the JAX package.

Same inputs, made with numpy from a seed, on the CPU (``device="cpu"``: the
wrappers run their plain versions):

- ``best_mesh_shape`` and ``mesh_from_cli``'s errors against the JAX module;
- the sharded step with every mesh position run in this process (a ``(D, S)``
  tuple in place of a mesh: no process group) against ``sharded_clahe``,
  ``sharded_histeq`` and ``build_sharded_pipeline`` of the JAX package on its
  8-device CPU mesh, over the cases of ``tests/test_parallel.py``.  histeq
  is bit-equal; CLAHE is held to the JAX output with ``assert_clahe_close``
  (the JAX CPU backend FMA-contracts the blend, tests/conftest.py) and to cv2
  and the port's single-device path exactly;
- through real process groups (``run_on_mesh``: spawned processes, gloo, a
  file rendezvous): ``ShardedEnhancer`` on 2x2, 1x4 and 2x3 meshes bit-equal
  to the port's single-device ``Enhancer``, a rank's failure and the timeout
  reported, and no child loading JAX or the JAX package.
"""

import cv2
import numpy as np
import pytest
import torch

from opencv_opencl_tpu import parallel as jax_parallel
from opencv_opencl_tpu.core import frames as jax_frames
from opencv_opencl_tpu.models import enhancer as jax_enhancer
from opencv_opencl_tpu.ops import clahe as jax_clahe
from opencv_opencl_tpu.parallel import mesh as jax_mesh
from opencv_opencl_tpu.parallel import sharded as jax_sharded
from opencv_opencl_tpu_torch import parallel as torch_parallel
from opencv_opencl_tpu_torch.core import frames as torch_frames
from opencv_opencl_tpu_torch.models import enhancer as torch_enhancer
from opencv_opencl_tpu_torch.ops import clahe as torch_clahe
from opencv_opencl_tpu_torch.parallel import launch
from opencv_opencl_tpu_torch.parallel import mesh as torch_mesh
from opencv_opencl_tpu_torch.parallel import sharded as torch_sharded
from tests.conftest import assert_clahe_close

torch.set_num_threads(1)

SPAWN_TIMEOUT = 120.0


def _frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


# ---------------------------------------------------------------- mesh ----


@pytest.mark.parametrize("n", range(1, 17))
def test_best_mesh_shape_equals_jax(n):
    assert torch_mesh.best_mesh_shape(n) == jax_mesh.best_mesh_shape(n)
    assert torch_parallel.best_mesh_shape is torch_mesh.best_mesh_shape


@pytest.mark.parametrize("spec,message", [
    ("4y2", "--mesh='4y2' invalid: use 'auto' or DxS (e.g. 4x2)"),
    ("ax2", "--mesh='ax2' invalid: use 'auto' or DxS (e.g. 4x2)"),
    ("0x2", "--mesh='0x2' invalid: axes must be >= 1"),
    ("2x-1", "--mesh='2x-1' invalid: axes must be >= 1"),
])
def test_mesh_from_cli_errors_equal_jax(spec, message):
    for mod in (jax_mesh, torch_mesh):
        with pytest.raises(ValueError) as err:
            mod.mesh_from_cli(spec)
        assert str(err.value) == message


def test_make_mesh_counts_the_ranks_of_the_process_group():
    # no process group in this process: one device
    with pytest.raises(ValueError, match="requested 16 devices, have 1"):
        torch_mesh.mesh_from_cli("4x4")
    with pytest.raises(ValueError, match="requested 16 devices, have 8"):
        jax_mesh.mesh_from_cli("4x4")
    with pytest.raises(ValueError, match=r"mesh shape \(2, 2\) != 1 devices"):
        torch_mesh.make_mesh(1, shape=(2, 2))
    with pytest.raises(ValueError, match=r"mesh shape \(2, 2\) != 1 devices"):
        jax_mesh.make_mesh(1, shape=(2, 2))
    with pytest.raises(RuntimeError, match="no process group"):
        torch_mesh.make_mesh()


def test_package_exports_equal_jax():
    assert sorted(torch_parallel.__all__) == sorted(jax_parallel.__all__)
    assert set(jax_sharded.__all__) - {"input_sharding"} <= set(torch_sharded.__all__)


@pytest.mark.parametrize("h,w,grid", [(64, 128, (8, 8)), (63, 127, (8, 8)),
                                      (97, 131, (8, 8)), (67, 131, (5, 3)),
                                      (2160, 3840, (8, 8)), (1080, 1920, (8, 8))])
def test_clahe_geometry_equals_jax(h, w, grid):
    for nsp in (1, 2, 3, 4, 8):
        assert (torch_sharded._clahe_geometry(
                    torch_clahe.make_clahe_plan(h, w, 2.0, grid), nsp)
                == jax_sharded._clahe_geometry(
                    jax_clahe.make_clahe_plan(h, w, 2.0, grid), nsp))


# ------------------------------------------- every position in one process ----


CLAHE_CASES = [
    # (h, w, grid, mesh shape, backend)
    (64, 128, (8, 8), (4, 2), "auto"),
    (64, 128, (8, 8), (2, 4), "auto"),
    (63, 127, (8, 8), (4, 2), "auto"),     # reflect-padded tiles
    (97, 131, (8, 8), (2, 4), "auto"),     # odd geometry, space=4
    (64, 128, (8, 8), (2, 3), "auto"),     # tiles_y=8 NOT divisible by space=3
    (67, 131, (5, 3), (2, 3), "auto"),     # odd grid AND odd mesh
    (64, 128, (8, 8), (2, 2), "pallas"),
    (64, 128, (8, 8), (2, 4), "pallas"),
    # "xla" on geometry whose rows divide by 8 * space: on other heights the
    # JAX package's plain band path slices its row tables past their end
    # (a clamped dynamic_slice) and is itself off cv2 in the last band
    (64, 128, (8, 8), (2, 2), "xla"),
    (63, 127, (8, 8), (2, 2), "xla-port-only"),
]


@pytest.mark.parametrize("h,w,grid,shape,backend", CLAHE_CASES)
def test_sharded_clahe_equals_jax_mesh_and_cv2(h, w, grid, shape, backend):
    batch = _frames(21, shape[0], h, w)
    plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
    with_jax = backend != "xla-port-only"
    backend = backend.split("-")[0]
    out = torch_parallel.sharded_clahe(shape, plan, backend=backend,
                                       device="cpu")(batch).numpy()
    assert out.shape == batch.shape and out.dtype == np.uint8
    single = torch_clahe.clahe_apply(torch.from_numpy(batch), plan).numpy()
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=grid)
    for i in range(shape[0]):
        assert np.array_equal(out[i], c.apply(batch[i]))
    assert np.array_equal(out, single)
    if with_jax:
        mesh = jax_parallel.make_mesh(shape[0] * shape[1], shape=shape)
        jax_out = np.asarray(jax_parallel.sharded_clahe(
            mesh, jax_clahe.make_clahe_plan(h, w, 2.0, grid), backend=backend)(batch))
        assert_clahe_close(out, jax_out)


@pytest.mark.parametrize("h,w,shape", [(64, 128, (4, 2)), (61, 127, (2, 3)),
                                       (10, 16, (1, 8))])
def test_sharded_histeq_equals_jax_mesh_and_cv2(h, w, shape):
    batch = _frames(22, shape[0], h, w)
    out = torch_parallel.sharded_histeq(shape, h, w, device="cpu")(batch).numpy()
    mesh = jax_parallel.make_mesh(shape[0] * shape[1], shape=shape)
    jax_out = np.asarray(jax_parallel.sharded_histeq(mesh, h, w)(batch))
    assert np.array_equal(out, jax_out)
    for i in range(shape[0]):
        assert np.array_equal(out[i], cv2.equalizeHist(batch[i]))


def test_sharded_steps_reject_what_they_cannot_take():
    plan = torch_clahe.make_clahe_plan(64, 128, 2.0, (8, 8))
    with pytest.raises(ValueError, match="unknown backend"):
        torch_parallel.sharded_clahe((2, 2), plan, backend="mosaic", device="cpu")
    with pytest.raises(ValueError, match="unknown histogram method"):
        torch_parallel.sharded_histeq((2, 2), 64, 128, method="sort", device="cpu")
    step = torch_parallel.sharded_clahe((2, 2), plan, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh data axis 2"):
        step(_frames(0, 3, 64, 128))
    with pytest.raises(ValueError, match="frames are"):
        step(_frames(0, 2, 64, 120))
    with pytest.raises(ValueError, match="expected uint8"):
        step(np.zeros((2, 64, 128), np.int32))
    with pytest.raises(ValueError, match="no position of its own"):
        step.local(_frames(0, 2, 64, 128))


PIPELINE_CASES = [
    # (op, chroma, h, w, mesh shape)
    ("clahe", "PASSTHROUGH", 119, 191, (2, 3)),   # odd everything
    ("clahe", "PASSTHROUGH", 64, 128, (4, 2)),
    ("histeq", "GRAY", 64, 128, (2, 2)),
    ("none", "GRAY", 64, 128, (2, 2)),
    ("none", "PASSTHROUGH", 61, 127, (2, 3)),
]


@pytest.mark.parametrize("op,chroma,h,w,shape", PIPELINE_CASES)
def test_sharded_pipeline_equals_jax_mesh(op, chroma, h, w, shape):
    y = _frames(23, shape[0], h, w)
    uv = _frames(24, shape[0], (h + 1) // 2, w)
    cfg = torch_enhancer.EnhancerConfig(op=op, clip_limit=2.0, tile_grid=(8, 8),
                                        chroma=torch_frames.ChromaPolicy[chroma])
    fn, part = torch_parallel.build_sharded_pipeline(cfg, h, w, shape, device="cpu")
    assert part is None
    y_out, uv_out = fn(y, uv)
    y_out, uv_out = y_out.numpy(), uv_out.numpy()
    jax_cfg = jax_enhancer.EnhancerConfig(op=op, clip_limit=2.0, tile_grid=(8, 8),
                                          chroma=jax_frames.ChromaPolicy[chroma])
    jax_fn, _ = jax_parallel.build_sharded_pipeline(
        jax_cfg, h, w, jax_parallel.make_mesh(shape[0] * shape[1], shape=shape))
    jax_y, jax_uv = (np.asarray(a) for a in jax_fn(y, uv))
    assert np.array_equal(uv_out, jax_uv)
    assert uv_out.shape == uv.shape and uv_out.dtype == np.uint8
    if op == "clahe":
        c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        for i in range(shape[0]):
            assert np.array_equal(y_out[i], c.apply(y[i]))
        assert_clahe_close(y_out, jax_y)
    else:
        assert np.array_equal(y_out, jax_y)


def test_sharded_pipeline_rejects_hist_downsample_like_jax():
    messages = []
    for mod, build, mesh in (
            (jax_enhancer, jax_parallel.build_sharded_pipeline,
             jax_parallel.make_mesh(4, shape=(2, 2))),
            (torch_enhancer, torch_parallel.build_sharded_pipeline, (2, 2))):
        cfg = mod.EnhancerConfig(op="clahe", hist_downsample=2)
        with pytest.raises(ValueError, match="hist_downsample") as err:
            build(cfg, 64, 128, mesh)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("op,chroma", [("clahe", "PASSTHROUGH"),
                                       ("histeq", "GRAY")])
def test_sharded_enhancer_in_process_equals_single_device_and_jax(op, chroma):
    spec = torch_frames.FrameSpec(width=120, height=66)     # padded tiles
    cfg = torch_enhancer.EnhancerConfig(op=op, clip_limit=2.0, tile_grid=(8, 8),
                                        chroma=torch_frames.ChromaPolicy[chroma])
    batch = _frames(25, 4, spec.buffer_rows, spec.width)
    keep = batch.copy()
    ref = np.asarray(torch_enhancer.Enhancer(cfg, spec, "cpu").process_batch(batch))
    jax_ref = np.asarray(jax_sharded.ShardedEnhancer(
        jax_enhancer.EnhancerConfig(op=op, clip_limit=2.0, tile_grid=(8, 8),
                                    chroma=jax_frames.ChromaPolicy[chroma]),
        jax_frames.FrameSpec(width=120, height=66), shape=(2, 2)).process_batch(batch))
    for shape in ((4, 2), (2, 2), (2, 4), (1, 3), (4, 1), (1, 1)):
        se = torch_sharded.ShardedEnhancer(cfg, spec, mesh=shape, device="cpu")
        out = np.asarray(se.process_batch(batch))
        assert out.shape == batch.shape
        assert np.array_equal(out, ref), f"mesh {shape} diverged"
        assert np.array_equal(batch, keep)       # the caller's buffer is intact
    assert np.array_equal(out[:, spec.height:], jax_ref[:, spec.height:])
    if op == "clahe":
        assert_clahe_close(out[:, :spec.height], jax_ref[:, :spec.height])
    else:
        assert np.array_equal(out, jax_ref)
    assert np.array_equal(np.asarray(se.process_frame(batch[2])), ref[2])
    with pytest.raises(ValueError, match="batch 3 not divisible by mesh data axis 2"):
        torch_sharded.ShardedEnhancer(cfg, spec, mesh=(2, 2),
                                      device="cpu").process_batch(batch[:3])
    with pytest.raises(ValueError, match="expected uint8"):
        se.process_batch(batch[:, :spec.height])


def test_rank_parts_cover_the_frame_once():
    """Every Y row is written by exactly one space position, and each
    position's slab holds what it reads and writes."""
    for h, w, grid in ((64, 128, (8, 8)), (97, 131, (8, 8)), (67, 131, (5, 3)),
                       (17, 32, (2, 2)), (2160, 3840, (8, 8))):
        plan = torch_clahe.make_clahe_plan(h, w, 2.0, grid)
        for nsp in (1, 2, 3, 4, 8):
            for bands in (torch_sharded._ClaheBands(plan, nsp, "auto"),
                          torch_sharded._HisteqBands(h, w, nsp)):
                written = np.zeros(h, int)
                for s in range(nsp):
                    r0, r1 = bands.rows(s)
                    lo, hi = bands.slab(s)
                    written[r0:r1] += 1
                    assert r1 == r0 or (lo <= r0 and r1 <= hi)
                    assert 0 <= lo <= hi <= h
                assert (written == 1).all(), (h, grid, nsp)


# ------------------------------------------------- real process groups ----


def _cases(batch_frames):
    pad = torch_frames.FrameSpec(width=120, height=66)
    even = torch_frames.FrameSpec(width=128, height=64)
    clahe = torch_enhancer.EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                                          chroma=torch_frames.ChromaPolicy.PASSTHROUGH)
    return [
        (clahe, even, [_frames(31, batch_frames, even.buffer_rows, even.width)]),
        (clahe, pad, [_frames(32, batch_frames, pad.buffer_rows, pad.width),
                      _frames(33, batch_frames, pad.buffer_rows, pad.width)]),
        (torch_enhancer.EnhancerConfig(), pad,
         [_frames(34, batch_frames, pad.buffer_rows, pad.width)]),
        (torch_enhancer.EnhancerConfig(op="none", chroma=torch_frames.ChromaPolicy.PASSTHROUGH),
         even, [_frames(35, batch_frames, even.buffer_rows, even.width)]),
    ]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 3)])
def test_sharded_enhancer_on_process_groups_equals_single_device(shape):
    """Spawned processes, gloo, one per mesh position: every assembled batch
    and every position's own band equal the single-device Enhancer's, on every
    rank; no child has loaded JAX or the JAX package."""
    cases = _cases(batch_frames=4)
    per_rank = launch.run_on_mesh(shape, launch.compare_with_enhancer,
                                  (cases, 1, True), device_type="cpu",
                                  timeout=SPAWN_TIMEOUT)
    assert len(per_rank) == shape[0] * shape[1]
    for rank, results in enumerate(per_rank):
        assert len(results) == len(cases)
        for (cfg, spec, batches), res in zip(cases, results):
            assert res["backend"] == "gloo"
            assert res["loaded"] == []
            assert res["equal"] == [True] * len(batches), (rank, cfg.op)
            assert res["local_equal"] == [True] * len(batches), (rank, cfg.op)
            part = res["part"]
            assert (part.d, part.s) == divmod(rank, shape[1])
            assert (part.ndata, part.nspace) == shape
            assert all(n == 0 for n in res["launches"].values())
            single = torch_enhancer.Enhancer(cfg, spec, "cpu")
            for batch, out in zip(batches, res["outputs"]):
                assert np.array_equal(out, np.asarray(single.process_batch(batch)))


def test_run_on_mesh_reports_a_rank_that_fails():
    cases = _cases(batch_frames=3)[:1]      # 3 frames on a data axis of 2
    with pytest.raises(RuntimeError) as err:
        launch.run_on_mesh((2, 1), launch.compare_with_enhancer, (cases,),
                           device_type="cpu", timeout=SPAWN_TIMEOUT)
    assert "exited with code 1" in str(err.value)
    assert "batch 3 not divisible by mesh data axis 2" in str(err.value)


def test_run_on_mesh_times_out_and_stops_its_children():
    import multiprocessing

    # no child can have started, joined the group and finished in 0.2 s
    with pytest.raises(TimeoutError, match="had not finished"):
        launch.run_on_mesh((1, 2), launch.compare_with_enhancer,
                           (_cases(batch_frames=2)[:1],), device_type="cpu",
                           timeout=0.2)
    assert multiprocessing.active_children() == []
    with pytest.raises(ValueError, match="no position"):
        launch.run_on_mesh((0, 2), launch.compare_with_enhancer, ())
