"""The collectives of the sharded steps, over one dimension of the mesh or
the whole group.

On NCCL they run on the device tensors.  On gloo with tensors on a card
(several processes sharing one card) they stage through host memory: gloo
does not gather CUDA tensors.  The sharded enhancement's payloads are tiny,
1 KB per frame for the histeq histogram and ``T * 1 KB`` per frame for the
tile histograms; the sharded encoder's (``parallel/sharded_encode.py``) are
the packed levels (26.7 MB a 4K frame), gathered to rank 0 alone, and the
banded encoder's reference pictures.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_gather_cat", "gather_cat", "broadcast_int"]


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


def gather_cat(t: torch.Tensor, group=None, dim: int = 0,
               dst: int = 0) -> torch.Tensor | None:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in rank
    order, on rank ``dst`` alone (None on the others).  Staged through the
    host, the result stays there: its next stop is the host anyway."""
    if dist.get_world_size(group) == 1:
        return t
    # as bytes: neither gloo nor NCCL gathers int16
    src = (t.cpu() if _through_host(t, group) else t).contiguous().view(torch.uint8)
    parts = None
    if dist.get_rank(group) == dst:
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.gather(src, parts, dst=dst, group=group)
    return None if parts is None else torch.cat(parts, dim=dim).view(t.dtype)


def broadcast_int(value: int, device: torch.device, group=None, src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank."""
    if dist.get_world_size(group) == 1:
        return int(value)
    on = device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    t = torch.tensor([int(value)], dtype=torch.int64, device=on)
    dist.broadcast(t, src=src, group=group)
    return int(t.item())
