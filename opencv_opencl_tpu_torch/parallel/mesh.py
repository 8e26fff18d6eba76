"""Device-mesh helpers for multi-GPU scaling.

Counterpart of ``opencv_opencl_tpu/parallel/mesh.py``.  The reference's
parallelism axes map onto a 2-D ``torch.distributed`` ``DeviceMesh``, one
process per mesh position, rank ``d * S + s``:

- ``data``  — frame-level data parallelism: the batch is split over
  processes, each enhancing its own frames.
- ``space`` — intra-frame spatial parallelism: the rows of the Y plane are
  split into bands, with the per-tile histograms exchanged by a (tiny)
  all-gather and the global histogram reduced by an all-reduce.

The "devices" a mesh can take are the ranks of the default process group
(NCCL for one process per card, gloo on the CPU or where several
processes share one card); ``parallel/launch.py`` starts such a group.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "best_mesh_shape", "parse_mesh_spec", "mesh_from_cli"]


def best_mesh_shape(n: int) -> tuple[int, int]:
    """Split n devices into (data, space) as close to square as possible,
    biasing the data axis (frame DP scales perfectly; spatial sharding pays
    one all-gather)."""
    best = (n, 1)
    for space in range(1, n + 1):
        if n % space:
            continue
        data = n // space
        if data >= space:
            best = (data, space)
    return best


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(
    n_devices: int | None = None,
    shape: tuple[int, int] | None = None,
    axis_names: tuple[str, str] = ("data", "space"),
) -> DeviceMesh:
    """Create a 2-D (data, space) mesh over the default process group.

    Every rank calls it with the same arguments.  The mesh must take every
    rank of the group (a ``DeviceMesh`` spans its process group), so ``n``
    smaller than the group raises as well as ``n`` larger."""
    have = _ranks()
    if n_devices is not None:
        n = n_devices
    elif shape is not None:
        n = shape[0] * shape[1]  # an explicit shape names its own size
    else:
        n = have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if shape is None:
        shape = best_mesh_shape(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start one process per mesh position "
            "(parallel.launch.run_on_mesh) or call "
            "parallel.launch.init_process_group first")
    if n != have:
        raise ValueError(f"mesh of {n} devices in a process group of {have} "
                         "ranks: a mesh takes one process per position")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def parse_mesh_spec(spec: str) -> tuple[int, int] | None:
    """A ``--mesh`` flag value as a shape: None for 'auto', (D, S) for
    'DxS' (e.g. '4x2').  Raises ValueError with a user-facing message for a
    malformed spec."""
    if spec == "auto":
        return None
    try:
        d, s = spec.lower().split("x", 1)
        shape = (int(d), int(s))
    except ValueError:
        raise ValueError(
            f"--mesh={spec!r} invalid: use 'auto' or DxS (e.g. 4x2)"
        ) from None
    if shape[0] < 1 or shape[1] < 1:
        raise ValueError(
            f"--mesh={spec!r} invalid: axes must be >= 1")
    return shape


def mesh_from_cli(spec: str) -> DeviceMesh:
    """Parse a ``--mesh`` flag value ('auto' or 'DxS', e.g. '4x2') and
    build the mesh.  Raises ValueError with a user-facing message for a
    malformed spec or an unsatisfiable device count — one parser shared
    by every app exposing the flag."""
    return make_mesh(shape=parse_mesh_spec(spec))
