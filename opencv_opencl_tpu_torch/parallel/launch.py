"""Start one process per mesh position and run a function on the mesh.

The counterpart of the virtual 8-device CPU mesh that the JAX package's
tests and its multi-chip dry run use: :func:`run_on_mesh` spawns ``D * S``
processes, each of which joins a ``torch.distributed`` process group over a
``file://`` rendezvous in a temporary directory (no fixed TCP port, so
several runs may go on at once), builds the (data, space) mesh and calls the
given function on it.  The start method is ``spawn``, never ``fork``: the
parent may hold a CUDA context.  A child imports ``torch`` and this package
and the module of the function it is given, so that function must be
importable (this module has the ones the package's own checks use).

The backend is NCCL when every process gets a card of its own, and gloo on
the CPU or when the processes share a card (``device_type="cuda"`` with more
processes than cards): the collectives then stage through the host
(``parallel/collectives.py``).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_process_group", "run_on_mesh", "compare_with_enhancer",
           "compare_with_encoder", "run_relay", "run_multi_relay"]


def init_process_group(rank: int, world_size: int, rendezvous_file: str,
                       device_type: str = "cuda",
                       timeout: float = 120.0) -> torch.device:
    """Join the default process group of ``world_size`` ranks over the file
    ``rendezvous_file`` (a path that does not exist yet, the same for every
    rank) and return the device this rank computes on.  NCCL when
    ``device_type`` is "cuda" and there is a card per rank, else gloo."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' needs a CUDA card")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if world_size <= cards else "gloo"
    else:
        device = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{rendezvous_file}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    return device


def _worker(rank: int, shape: tuple[int, int], fn, args: tuple,
            device_type: str, timeout: float, workdir: str) -> None:
    """One mesh position: join the group, build the mesh, run ``fn`` and
    leave its result (or the traceback) in ``workdir``."""
    from opencv_opencl_tpu_torch.parallel.mesh import make_mesh

    try:
        torch.set_num_threads(1)
        device = init_process_group(rank, shape[0] * shape[1],
                                    os.path.join(workdir, "rendezvous"),
                                    device_type, timeout)
        try:
            result = fn(make_mesh(shape=shape), device, *args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            dist.destroy_process_group()
        tmp = os.path.join(workdir, f"result_{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(workdir, f"result_{rank}.pkl"))
    except Exception:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def _failure(rank: int, exitcode: int | None, workdir: str) -> str:
    path = os.path.join(workdir, f"error_{rank}.txt")
    trace = ""
    if os.path.exists(path):
        with open(path) as f:
            trace = f.read()
    return f"rank {rank} exited with code {exitcode}\n{trace}"


def run_on_mesh(shape: tuple[int, int], fn, args: tuple = (),
                device_type: str = "cuda", timeout: float = 120.0) -> list:
    """Run ``fn(mesh, device, *args)`` on every position of a ``(D, S)``
    mesh, one spawned process each, and return the results in rank order
    (rank ``d * S + s``).  ``fn`` and ``args`` are pickled to the children
    and the results back, so results should be host values.  Raises
    ``RuntimeError`` with the rank's traceback when a rank fails, and
    ``TimeoutError`` when the ranks have not finished after ``timeout``
    seconds; either way every child is stopped before it returns."""
    world = shape[0] * shape[1]
    if world < 1:
        raise ValueError(f"mesh shape {shape} has no position")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mesh_") as workdir:
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(rank, tuple(shape), fn, tuple(args),
                                   device_type, timeout, workdir))
                 for rank in range(world)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            pending = set(range(world))
            while pending:
                for rank in sorted(pending):
                    procs[rank].join(timeout=0.05)
                    if procs[rank].is_alive():
                        continue
                    pending.discard(rank)
                    if procs[rank].exitcode != 0:
                        raise RuntimeError(
                            _failure(rank, procs[rank].exitcode, workdir))
                if pending and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(pending)} of mesh {tuple(shape)} had not "
                        f"finished after {timeout} s")
            results = []
            for rank in range(world):
                with open(os.path.join(workdir, f"result_{rank}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join(timeout=10)


def compare_with_enhancer(mesh, device, cases, repeats: int = 1,
                          return_outputs: bool = False) -> list[dict]:
    """A position's check of the sharded step against the single-device one.
    ``cases`` is a list of ``(cfg, spec, batches)``, the same on every
    position: every NV12 batch of ``batches`` (numpy) goes through
    ``Enhancer`` on this position's device and, ``repeats`` times, through
    ``ShardedEnhancer`` on the mesh, assembled and as the position's own part.

    Returns one dict of host values per case: ``equal`` (one bool per
    sharded call: the assembled batch equals the single-device one),
    ``local_equal`` (the position's band equals its rows of it),
    ``launches`` (the kernel launches of the sharded calls alone), ``part``
    (the position's :class:`RankPart`), ``local_ms`` (median device time of
    the position's own part of the step, upload included, from CUDA events;
    None on the CPU), ``backend``, ``loaded`` (modules of JAX or the JAX
    package in this process; must be empty) and, if asked, ``outputs``."""
    from opencv_opencl_tpu_torch.models.enhancer import Enhancer
    from opencv_opencl_tpu_torch.ops import cuda as cuda_ops
    from opencv_opencl_tpu_torch.parallel.sharded import ShardedEnhancer

    results = []
    for cfg, spec, batches in cases:
        single = Enhancer(cfg, spec, device)
        want = [np.asarray(single.process_batch(b)) for b in batches]
        sharded = ShardedEnhancer(cfg, spec, mesh=mesh, device=device)
        part = sharded.part
        cuda_ops.reset_launch_counts()
        equal, local_equal, outputs, times = [], [], [], []
        for k in range(repeats * len(batches)):
            batch, ref = batches[k % len(batches)], want[k % len(batches)]
            out = np.asarray(sharded.process_batch(batch))
            equal.append(bool(np.array_equal(out, ref)))
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            band = sharded.process_local(batch)
            if device.type == "cuda":
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            rows = ref[part.frames(len(ref)), part.rows[0]:part.rows[1]]
            local_equal.append(bool(np.array_equal(band.cpu().numpy(), rows)))
            if return_outputs:
                outputs.append(out)
        result = {
            "equal": equal, "local_equal": local_equal,
            "launches": cuda_ops.launch_counts(), "part": part,
            "local_ms": statistics.median(times) if times else None,
            "backend": dist.get_backend(),
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "opencv_opencl_tpu")),
        }
        if return_outputs:
            result["outputs"] = outputs
        results.append(result)
    return results


# what the ranks other than 0 add to the qp they pass the GOP-per-rank step
QP_SKEW = 7


def _encoder_for(case: dict, device):
    """The single-card device encoder of a :func:`compare_with_encoder`
    case."""
    from opencv_opencl_tpu_torch.io.h264_cavlc import CudaCavlcEncoder
    from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder

    spec = case["spec"]
    kw = dict(case["enc"])
    if case["mode"] == "levels":
        return CudaCavlcEncoder(spec.width, spec.height, qp=case["qp"],
                                device=device, **kw)
    return CudaGopEncoder(spec.width, spec.height, qp=case["qp"], device=device, **kw)


def _wall_ms(fn, device):
    """``fn()`` and its wall time in ms, the card's work included."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def compare_with_encoder(mesh, device, cases, reference: bool = True,
                         timed: bool = False) -> list[dict]:
    """A position's run of the sharded encoder (``parallel/sharded_encode.py``)
    and of the single-card encoders it must equal.  ``cases`` is a list of
    dicts, the same on every position:

    - ``mode`` "gop" or "levels": ``cfg``, ``spec``, ``enc`` (the kwargs of
      ``CudaGopEncoder`` / ``CudaCavlcEncoder``), ``qp`` and ``frames``
      (numpy NV12, any count): the GOP-per-rank step over the frames padded
      with ``pad_batch_for_mesh``; rank 0 assembles the access units with
      the encoder's ``encode_from_packed``.  The other ranks pass the step
      ``qp + QP_SKEW``: it must quantize at rank 0's qp, which it
      broadcasts;
    - ``mode`` "banded": ``spec``, ``enc`` (``BandedCudaGopEncoder``'s
      kwargs), ``qp`` and ``frames``: the banded encoder over the frames;
      where its constructor refuses the case, ``error`` is the message.

    Returns one dict of host values per case: on rank 0 ``aus`` and, for
    the GOP-per-rank modes, ``packed`` (the real frames' lanes); with
    ``reference``, on rank ``i % n`` for case ``i`` ``single``, the access
    units of the single-card encoder with the same options (on the frames
    enhanced by the single-card ``build_enhance_fn`` for the GOP-per-rank
    modes); on every rank ``launches`` (of the sharded calls alone),
    ``ms`` (wall ms: for the GOP-per-rank modes ``call`` the sharded step,
    and with ``timed``, after a first call that loads the kernels, also its
    phases ``step`` and ``gather`` as the call measures them; ``frames``
    the banded encoder's ms a frame), ``backend`` and ``loaded`` (modules of
    JAX or the JAX package; must be empty)."""
    from opencv_opencl_tpu_torch.models.enhancer import build_enhance_fn
    from opencv_opencl_tpu_torch.ops import cuda as cuda_ops
    from opencv_opencl_tpu_torch.parallel.sharded_encode import (
        BandedCudaGopEncoder, build_mesh_gop_fn, build_mesh_levels_fn,
        pad_batch_for_mesh)

    rank, n = dist.get_rank(), dist.get_world_size()
    results = []
    for i, case in enumerate(cases):
        spec, frames, kw = case["spec"], case["frames"], dict(case["enc"])
        res = {"backend": dist.get_backend(), "single": None, "ms": {}}
        if case["mode"] == "banded":
            try:
                enc = BandedCudaGopEncoder(spec.width, spec.height, mesh,
                                           qp=case["qp"], device=device, **kw)
            except ValueError as e:  # a refusal, the same on every rank
                res["error"] = str(e)
                results.append(res)
                continue
            cuda_ops.reset_launch_counts()
            aus, times = [], []
            for f in frames:
                got, ms = _wall_ms(lambda f=f: enc.encode(f), device)
                aus += got
                times.append(ms)
            aus += enc.flush()
            if rank == 0:
                res["aus"] = aus
            res["launches"] = cuda_ops.launch_counts()
            res["ms"]["frames"] = times
            if reference and i % n == rank:
                single = _encoder_for({**case, "mode": "gop"}, device)
                res["single"] = [au for f in frames for au in single.encode(f)]
                res["single"] += single.flush()
        else:
            enc = _encoder_for(case, device)
            bitpack = enc._nw_mb if enc._bitpack else 0
            if case["mode"] == "gop":
                fn, unit = build_mesh_gop_fn(
                    case["cfg"], spec, enc.gop, mesh, search=enc.search,
                    subpel=enc.subpel, refs=enc.refs, deblock=enc.deblock,
                    bitpack=bitpack, parts=enc.parts, device=device)
            else:
                fn, unit = build_mesh_levels_fn(case["cfg"], spec, mesh,
                                                bitpack=bitpack, device=device)
            padded, real = pad_batch_for_mesh(frames, n, unit)
            qp = case["qp"] + (QP_SKEW if rank else 0)
            if timed:
                fn(padded, qp)   # the first call loads the kernels
            cuda_ops.reset_launch_counts()
            packed, res["ms"]["call"] = _wall_ms(
                lambda: fn(padded, qp, times=res["ms"] if timed else None), device)
            res["launches"] = cuda_ops.launch_counts()
            if packed is not None:
                packed = packed[:real].cpu().numpy()
                res["packed"] = packed
                res["aus"] = [au for p in packed for au in enc.encode_from_packed(p)]
            if reference and i % n == rank:
                enhanced = build_enhance_fn(case["cfg"], spec, donate=False)(
                    torch.from_numpy(np.ascontiguousarray(frames)).to(device))
                single = _encoder_for(case, device)
                res["single"] = [au for f in enhanced.cpu().numpy()
                                 for au in single.encode(f)] + single.flush()
        res["loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "opencv_opencl_tpu"))
        results.append(res)
    return results


def run_relay(mesh, device, argv: list[str]) -> int:
    """A position's call of the relay app inside the group that
    :func:`run_on_mesh` started: every rank runs ``apps.relay.run(argv)``
    with the same arguments (``--mesh=DxS`` of the group's shape among
    them; the app builds its own mesh over the group) and returns its
    return code.  Rank 0 owns the sink and prints."""
    from opencv_opencl_tpu_torch.apps import relay

    del mesh, device  # the app takes both from its flags and the group
    return relay.run(list(argv))


def run_multi_relay(mesh, device, argv: list[str]) -> int:
    """A position's call of the multi-stream relay app, as
    :func:`run_relay`: every rank runs ``apps.multi_relay.run(argv)`` with
    the same arguments (``--mesh=DxS`` of the group's shape among them) and
    returns its return code.  Rank 0 owns the sinks and prints."""
    from opencv_opencl_tpu_torch.apps import multi_relay

    del mesh, device  # the app takes both from its flags and the group
    return multi_relay.run(list(argv))
