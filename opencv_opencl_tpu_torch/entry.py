"""The port's single-card step and its multi-process dry run.

Counterpart of the repository root's ``__graft_entry__.py``:

- :func:`entry` is ``__graft_entry__.entry``: the batched NV12 CLAHE step
  at the reference's file-relay configuration (1280x720, clip 2.0, 8x8
  tiles, chroma passthrough) and a batch of 2 random frames;
- :func:`dryrun_multichip` is ``__graft_entry__.dryrun_multichip`` (its
  body ``_dryrun_impl``) over ``n`` processes, one per position of a
  (data, space) mesh (``parallel/launch.run_on_mesh``), at the same
  geometry and on the same inputs.  Where the JAX dry run checks the
  enhanced frames' shapes, every rank here holds its outputs to the
  single-card step's, bit for bit, and rank 0 holds every stream to the
  single-card encoder's, byte for byte.

Run the dry run with ``python -m opencv_opencl_tpu_torch.entry <n>`` (on
the card: ``n`` processes that share it over gloo, or NCCL with a card per
process).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig, build_enhance_fn
from opencv_opencl_tpu_torch.parallel import launch
from opencv_opencl_tpu_torch.parallel.mesh import best_mesh_shape

__all__ = ["entry", "dryrun_multichip", "dryrun_rank"]

# the ranks build no kernel (the caller's process has), but a CPU rank runs
# the plain versions of the GOP encoder's kernels, and on the card up to
# eight processes share one card
_TIMEOUT_S = 900.0


def entry(device: str | torch.device = "cuda"):
    """Returns ``(fn, (batch,))``: ``fn`` the NV12 CLAHE step
    (``models/enhancer.build_enhance_fn``, writing a new tensor) at
    1280x720, clip 2.0, 8x8 tiles, chroma passthrough, and ``batch`` two
    uint8 frames (2, 1080, 1280) from ``numpy.random.default_rng(0)``, on
    ``device``."""
    spec = FrameSpec(width=1280, height=720, fps=30)
    cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                         chroma=ChromaPolicy.PASSTHROUGH)
    fn = build_enhance_fn(cfg, spec, donate=False)
    batch = np.random.default_rng(0).integers(
        0, 256, (2, spec.buffer_rows, spec.width), dtype=np.uint8)
    return fn, (torch.from_numpy(batch).to(device),)


def _geometry(d: int, s: int) -> tuple[int, int, int, int]:
    """``(tiles_y, height, width, batch)`` of the sharded steps on a
    (d, s) mesh: the tile rows divide by the space axis (8 where s divides
    8, else s), the height by the tile rows."""
    tiles_y = 8 if 8 % s == 0 else s
    return tiles_y, 16 * tiles_y, 128, 2 * d


def _encode_cases(rng, n: int) -> list[dict]:
    """The three encoder cases of the dry run, as
    ``launch.compare_with_encoder`` takes them: the GOP-per-rank fused step
    over ``n * 3`` frames of 64x48 (GOP 3, search 2, QP 30), the same with
    ``parts`` and two references on frames that flicker, and the banded
    encoder over 4 frames of ``16 * n`` rows (GOP 4, search 2)."""
    we, he, gop, qp = 64, 48, 3, 30
    spec = FrameSpec(width=we, height=he, fps=30)
    cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                         chroma=ChromaPolicy.PASSTHROUGH)
    base = rng.integers(0, 256, (he, we), dtype=np.uint8)
    uvb = rng.integers(96, 160, (he // 2, we), dtype=np.uint8)
    frames = np.stack([np.concatenate([np.roll(base, 2 * i, 1), np.roll(uvb, 2 * i, 1)], 0)
                       for i in range(n * gop)])
    flicker = frames.copy()
    flicker[::2, :he] = np.clip(flicker[::2, :he].astype(np.int32) + 20, 0,
                                255).astype(np.uint8)
    hb = 16 * n                            # one MB row a rank
    ramp = np.broadcast_to(np.arange(we, dtype=np.uint8), (hb, we))
    banded = np.stack([np.concatenate([np.roll(ramp, 2 * i, 1),
                                       np.full((hb // 2, we), 128, np.uint8)], 0)
                       for i in range(4)])
    return [
        dict(mode="gop", cfg=cfg, spec=spec, enc=dict(gop=gop, search=2), qp=qp,
             frames=frames),
        dict(mode="gop", cfg=cfg, spec=spec,
             enc=dict(gop=gop, search=2, parts=True, refs=2), qp=qp, frames=flicker),
        dict(mode="banded", spec=FrameSpec(width=we, height=hb, fps=30),
             enc=dict(gop=4, search=2), qp=qp, frames=banded),
    ]


ENHANCE_CHECKS = ("sharded CLAHE passthrough", "sharded histeq gray")
ENCODE_CHECKS = ("GOP-per-rank stream", "GOP-per-rank parts refs=2 stream",
                 "banded stream")


def dryrun_rank(mesh, device, return_outputs: bool = False) -> dict:
    """One position's part of the dry run; every rank of ``mesh``'s group
    calls it.  Returns host values: ``backend``, ``device``, ``loaded``
    (modules of JAX or the JAX package; must be empty), ``geometry``
    ``(d, s, batch, width, height)``, ``frames`` (of the GOP-per-rank
    step), ``checks`` (name -> this rank's verdict), ``launches`` (name ->
    the kernel launches of the sharded calls alone), rank 0's ``aus`` (one
    list of access units a stream), and with ``return_outputs``
    ``outputs``: the assembled ``clahe`` and ``histeq`` NV12 batches and the
    ``odd`` Y batch.  Rank 0 gathers every rank's result, raises
    ``RuntimeError`` naming the rank and the check that failed, and prints
    the JAX dry run's line."""
    from opencv_opencl_tpu_torch.ops import cuda as cuda_ops
    from opencv_opencl_tpu_torch.ops.clahe import clahe
    from opencv_opencl_tpu_torch.parallel.sharded import build_sharded_pipeline

    rank, n = dist.get_rank(), dist.get_world_size()
    d, s = mesh.size(0), mesh.size(1)
    tiles_y, height, width, batch = _geometry(d, s)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (batch, height, width), dtype=np.uint8)
    uv = rng.integers(0, 256, (batch, height // 2, width), dtype=np.uint8)
    spec = FrameSpec(width=width, height=height, fps=30)
    clahe_cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, tiles_y),
                               chroma=ChromaPolicy.PASSTHROUGH)
    histeq_cfg = EnhancerConfig(op="histeq", chroma=ChromaPolicy.GRAY)
    nv12 = np.concatenate([y, uv], axis=1)
    enhanced = launch.compare_with_enhancer(
        mesh, device, [(clahe_cfg, spec, [nv12]), (histeq_cfg, spec, [nv12])],
        return_outputs=return_outputs)

    # odd geometry: reflect-padded tiles, tile rows the space axis does not
    # divide
    ho, wo = 67, 131
    y3 = rng.integers(0, 256, (batch, ho, wo), dtype=np.uint8)
    uv3 = rng.integers(0, 256, (batch, (ho + 1) // 2, wo), dtype=np.uint8)
    fn3, _ = build_sharded_pipeline(clahe_cfg, ho, wo, mesh, device=device)
    cuda_ops.reset_launch_counts()
    y3_out, uv3_out = fn3(y3, uv3)
    odd_launches = cuda_ops.launch_counts()
    y3_out = y3_out.cpu()
    want3 = clahe(y3, 2.0, (8, tiles_y), device=device).cpu()
    odd_equal = (torch.equal(y3_out, want3)
                 and torch.equal(uv3_out.cpu(), torch.from_numpy(uv3)))

    cases = _encode_cases(rng, n)
    encoded = launch.compare_with_encoder(mesh, device, cases)

    checks = {name: all(r["equal"]) and all(r["local_equal"])
              for name, r in zip(ENHANCE_CHECKS, enhanced)}
    checks["sharded odd 131x67 CLAHE"] = odd_equal
    checks["no JAX"] = not encoded[-1]["loaded"]
    result = {
        "backend": dist.get_backend(), "device": _device_name(device),
        "loaded": encoded[-1]["loaded"], "geometry": (d, s, batch, width, height),
        "frames": len(cases[0]["frames"]), "checks": checks,
        "launches": {**{name: r["launches"] for name, r in zip(ENHANCE_CHECKS, enhanced)},
                     "sharded odd 131x67 CLAHE": odd_launches,
                     **{name: r["launches"] for name, r in zip(ENCODE_CHECKS, encoded)}},
        # what rank 0 compares: its streams, and the single-card streams
        # of the cases this rank ran (case i on rank i % n)
        "single": [r["single"] for r in encoded],
        "errors": [r.get("error") for r in encoded],
    }
    if rank == 0:
        result["aus"] = [r["aus"] for r in encoded]
    if return_outputs:
        result["outputs"] = {"clahe": enhanced[0]["outputs"][0],
                             "histeq": enhanced[1]["outputs"][0],
                             "odd": y3_out.numpy()}
    gathered = [None] * n if rank == 0 else None
    dist.gather_object(result, gathered, dst=0)
    if rank == 0:
        _verdict(gathered)
        print(f"dryrun_multichip OK: mesh(data={d}, space={s}), "
              f"batch={batch}, frame={width}x{height} + odd {wo}x{ho} + "
              f"fused enhance+GOP encode ({result['frames']} frames GOP-per-device, "
              f"byte-identical) + slice-band encode ({n} bands, "
              f"MC-halo windows, byte-identical)")
        print(f"dryrun_multichip backend: {result['backend']}, {n} processes on "
              f"{result['device']}", flush=True)
    del result["single"]
    return result


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _verdict(results: list[dict]) -> None:
    """Rank 0's checks of every rank's result: its own checks, and rank 0's
    streams against the single-card encoder's.  Raises ``RuntimeError``
    naming the first rank and check that failed."""
    for rank, res in enumerate(results):
        for name, ok in res["checks"].items():
            if not ok:
                raise RuntimeError(f"dryrun_multichip: rank {rank}: {name} differs "
                                   f"from the single-card step")
    for i, name in enumerate(ENCODE_CHECKS):
        error = results[0]["errors"][i]
        if error is not None:
            raise RuntimeError(f"dryrun_multichip: rank 0: {name}: {error}")
        owner = i % len(results)
        if results[0]["aus"][i] != results[owner]["single"][i]:
            raise RuntimeError(
                f"dryrun_multichip: rank 0: {name} differs from the single-card "
                f"encoder's (run on rank {owner})")


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     return_outputs: bool = False) -> list[dict]:
    """The dry run of ``__graft_entry__.dryrun_multichip`` over
    ``n_devices`` processes on a ``best_mesh_shape(n_devices)`` mesh, each
    running :func:`dryrun_rank`: on the card (``device_type="cuda"``; gloo
    where the processes share a card, NCCL with a card each) or on the CPU
    (``"cpu"``, gloo).  Returns the ranks' results in rank order.  Raises
    ``RuntimeError`` when a rank fails or an output differs from the
    single-card port's, and before it starts a process when
    ``device_type`` is "cuda" and there is no card."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device_type='cuda') needs a CUDA card; "
                           "device_type='cpu' runs the ranks on the CPU")
    return launch.run_on_mesh(best_mesh_shape(n_devices), dryrun_rank,
                              (return_outputs,), device_type=device_type,
                              timeout=_TIMEOUT_S)


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not argv[0].isdigit() or int(argv[0]) < 1:
        print("usage: python -m opencv_opencl_tpu_torch.entry <n processes>",
              file=sys.stderr)
        return 2
    dryrun_multichip(int(argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
