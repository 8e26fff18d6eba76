"""The two collectives of the sharded step, over one dimension of the mesh.

On NCCL they run on the device tensors.  On gloo with tensors on a card
(several processes sharing one card) they stage through host memory: gloo
does not gather CUDA tensors, and both payloads are tiny, 1 KB per frame for
the histeq histogram and ``T * 1 KB`` per frame for the tile histograms.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_gather_cat"]


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, on ``t``'s device
    (``t`` itself may be overwritten)."""
    if _through_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        return host.to(t.device)
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in rank
    order, on ``t``'s device."""
    src = t.cpu() if _through_host(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)
