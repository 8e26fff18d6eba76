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
           "run_relay"]


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


def run_relay(mesh, device, argv: list[str]) -> int:
    """A position's call of the relay app inside the group that
    :func:`run_on_mesh` started: every rank runs ``apps.relay.run(argv)``
    with the same arguments (``--mesh=DxS`` of the group's shape among
    them; the app builds its own mesh over the group) and returns its
    return code.  Rank 0 owns the sink and prints."""
    from opencv_opencl_tpu_torch.apps import relay

    del mesh, device  # the app takes both from its flags and the group
    return relay.run(list(argv))
