"""Fused enhance + encode over a mesh of processes: GOPs a rank, or one
frame's MB rows in bands.

Counterpart of ``opencv_opencl_tpu/parallel/sharded_encode.py`` on
``torch.distributed`` (one process per mesh position, rank ``d * S + s``,
``parallel/mesh.py``).  Two modes:

- **GOP-per-rank** (:func:`build_mesh_gop_fn`, :func:`build_mesh_levels_fn`).
  The encoder's only sequential dependency is the reconstruction chain
  inside a GOP: every GOP starts with an IDR, whose intra step reads no
  reference picture, so GOPs are independent units of work.  Every rank gets
  the same padded batch (the relay feeds every rank the same frames), takes
  the contiguous block of frames ``[r*N/n, (r+1)*N/n)`` of its rank ``r``
  and runs the single-card fused step
  (``models/fused_encode.build_enhance_gop_fn``, or
  ``build_enhance_levels_fn`` for the intra encoder) on it from zero
  reference pictures, which the block's first frame, an IDR, never reads.
  The packed lanes are gathered in frame order to rank 0, which alone owns
  the encoder and the sink; the stream is byte-identical to the single-card
  encoder's at equal qp.  The steps are stateless, so a ragged tail is
  padded (:func:`pad_batch_for_mesh`) and the padded outputs dropped.
- **Banded** (:class:`BandedCudaGopEncoder`): one frame's MB rows split over
  the ranks.  Each rank runs the single-card kernels on its band plus halo
  rows of the reference pictures and crops the result to its band; one
  slice per MB row makes that exact.

Where the port differs from the JAX package:

- the builders return ``(fn, unit)``: a process group has no input sharding
  to hand back (the JAX ``(fn, sharding, unit)``);
- ``fn`` takes the qp on rank 0 and broadcasts it to the other ranks on
  every call, since only rank 0 has the encoder and its rate control; the
  qp then rides in-band in lane 408 of the packed lanes;
- ``fn`` returns the gathered lanes on rank 0 and None on the other ranks;
  a step that fails on any rank raises on every rank (no rank carries on
  alone, none waits in a collective for a rank that has failed);
- the banded class is ``BandedCudaGopEncoder`` (``BandedTpuGopEncoder``), and
  ``encode`` / ``flush`` return the access units on rank 0 and ``[]`` on the
  other ranks; each rank all-gathers the new reference picture once a frame,
  where the JAX class all-gathers the references at each P frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from opencv_opencl_tpu_torch.core.frames import FrameSpec
from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig
from opencv_opencl_tpu_torch.models.fused_encode import (
    _device, build_enhance_gop_fn, build_enhance_levels_fn, make_gop_levels)
from opencv_opencl_tpu_torch.parallel.collectives import (
    all_gather_cat, all_reduce_sum, broadcast_int, gather_cat)
from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch

__all__ = [
    "build_mesh_gop_fn",
    "build_mesh_levels_fn",
    "pad_batch_for_mesh",
    "BandedCudaGopEncoder",
]


def _position(mesh) -> tuple[int, int]:
    """This process's rank on the mesh, data axis first (``d * S + s``, the
    JAX ``P(("data", "space"))`` order), and the mesh's size.  The mesh
    spans the default group (``parallel/mesh.make_mesh``), whose ranks are
    in the same order."""
    names = mesh.mesh_dim_names
    nspace = mesh.size(1) if len(names) > 1 else 1
    rank = mesh.get_local_rank(names[0]) * nspace
    if len(names) > 1:
        rank += mesh.get_local_rank(names[1])
    if rank != dist.get_rank():
        raise ValueError(f"mesh position {rank} is rank {dist.get_rank()} of "
                         "the group: the mesh must list the group's ranks in order")
    return rank, mesh.size()


def _agreed(step, device: torch.device):
    """Run ``step()`` on every rank and return its result; when it raises
    on any rank, raise on every rank, so that no rank goes on to a
    collective that a failed rank will never join."""
    if dist.get_world_size() == 1:
        return step()
    error = None
    try:
        out = step()
    except Exception as e:  # noqa: BLE001 - re-raised below, on every rank
        error, out = e, None
    flag = torch.tensor([0 if error is None else 1], dtype=torch.int32,
                        device=device)
    failed = int(all_reduce_sum(flag).item())
    if error is not None:
        raise error
    if failed:
        raise RuntimeError(f"the step failed on {failed} other rank(s) of the mesh")
    return out


def _synced_ms(device: torch.device) -> float:
    """The wall clock in ms once the work queued on ``device`` is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() * 1e3


def _mesh_fn(step, mesh, device: torch.device, unit: int):
    """``fn(nv12_batch, qp, times=None)`` of the GOP-per-rank builders over
    ``step(block, qp) -> packed`` (the rank's own frames).  Given a dict
    ``times``, the call waits for the card around its phases and writes
    their wall ms there: ``step`` the rank's own block through the step,
    ``gather`` the gather of the lanes to rank 0."""
    rank, n = _position(mesh)

    def fn(nv12_batch, qp, times: dict | None = None):
        batch = (nv12_batch if isinstance(nv12_batch, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(nv12_batch)))
        total = int(batch.shape[0])
        if total % (n * unit):
            raise ValueError(
                f"a batch of {total} frames is not a multiple of mesh devices "
                f"x GOP frames ({n} x {unit}): pad it (pad_batch_for_mesh)")
        # rank 0's qp on every rank: rate control moves it between batches
        qp = broadcast_int(qp, device)
        per = total // n

        def own():
            t0 = _synced_ms(device) if times is not None else 0.0
            out = step(batch[rank * per:(rank + 1) * per], qp)
            if times is not None:
                times["step"] = _synced_ms(device) - t0
            return out

        packed = _agreed(own, device)
        t0 = _synced_ms(device) if times is not None else 0.0
        lanes = gather_cat(packed)
        if times is not None:
            times["gather"] = _synced_ms(device) - t0
        return lanes

    return fn


def build_mesh_gop_fn(cfg: EnhancerConfig, spec: FrameSpec, gop: int, mesh,
                      search: int = 0, subpel: int = 0, refs: int = 1,
                      deblock: bool = False, bitpack: int = 0,
                      parts: bool = False, device=None):
    """Returns ``(fn, unit)``, ``unit == gop``:
    ``fn(nv12: uint8 (N, H*3/2, W), qp: int) -> int16 (N, mb_h, mb_w, L)``
    on rank 0, None on the other ranks, called by every rank of ``mesh``
    with the same batch.  N must be a multiple of ``unit`` times the mesh's
    size (:func:`pad_batch_for_mesh` pads a ragged tail); rank ``r`` runs
    the single-card fused GOP step (``build_enhance_gop_fn``; the lanes L
    are its lanes) on frames ``[r*N/n, (r+1)*N/n)`` on ``device`` (None:
    the card) and rank 0 gathers the lanes in frame order: on the card
    with NCCL, on the host with gloo.  The host entropy stage consumes them
    in stream order (``CudaGopEncoder.encode_from_packed``: frame_num and
    idr_pic_id advance on the host, as in the single-card stream).
    ``qp`` is read on rank 0 and broadcast."""
    dev = _device(device, "build_mesh_gop_fn")
    raw = build_enhance_gop_fn(cfg, spec, gop, search=search, subpel=subpel,
                               refs=refs, deblock=deblock, gdr=0,
                               bitpack=bitpack, parts=parts, device=dev)
    h16, w16 = -(-spec.height // 16) * 16, -(-spec.width // 16) * 16
    # zero reference pictures: frame 0 of every rank's block is an IDR, so
    # no P frame reads them before the block's first reconstruction exists
    shapes = ((h16, w16), (h16 // 2, w16 // 2), (h16 // 2, w16 // 2)) * refs
    seed = tuple(torch.zeros(s, dtype=torch.uint8, device=dev) for s in shapes)

    def step(block, qp):
        packed, *_ = raw(block, qp, 0, *seed)
        return packed

    return _mesh_fn(step, mesh, dev, int(gop)), int(gop)


def build_mesh_levels_fn(cfg: EnhancerConfig, spec: FrameSpec, mesh,
                         bitpack: int = 0, device=None):
    """The intra encoder's variant (``--encoder=tpu`` without gop): every
    frame is an independent unit, so ``unit == 1``.  Same contract as
    :func:`build_mesh_gop_fn`, over ``build_enhance_levels_fn``."""
    dev = _device(device, "build_mesh_levels_fn")
    raw = build_enhance_levels_fn(cfg, spec, bitpack=bitpack, device=dev)
    return _mesh_fn(raw, mesh, dev, 1), 1


def pad_batch_for_mesh(batch: np.ndarray, ndev: int,
                       unit: int) -> tuple[np.ndarray, int]:
    """Pad a frame batch up to a multiple of ``ndev * unit`` frames by
    repeating the last frame; returns ``(padded, real_count)`` — the
    caller emits only the first ``real_count`` packed outputs.

    Safe ONLY because mesh steps are stateless: the pad frames extend
    the final (possibly partial) GOP, and a scan is causal — appended
    frames cannot change the outputs of the real frames before them.
    The single-chip fused path must NOT pad (its recon/idx chain
    persists across dispatches)."""
    n = int(batch.shape[0])
    block = ndev * unit
    want = -(-n // block) * block
    if want == n:
        return batch, n
    pad = np.broadcast_to(batch[-1:], (want - n,) + batch.shape[1:])
    return np.concatenate([batch, pad], axis=0), n


def _window(plane: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """Rows ``[lo, lo + rows)`` of ``plane``, rows outside the picture
    replicated from its first or last row (the full-frame kernels' edge
    rule), as a contiguous plane."""
    idx = torch.arange(lo, lo + rows, device=plane.device).clamp_(0, plane.shape[0] - 1)
    return plane.index_select(0, idx)


class BandedCudaGopEncoder:
    """Spatially banded single-stream GOP encoder: ONE frame's MB rows are
    split over every rank of ``mesh``, which scales a frame's latency (the
    GOP-per-rank mode scales throughput, but each frame still runs on one
    card).

    Every rank is given every frame.  A rank codes an IDR from its band of
    MB rows (H1, the split grids of ``csrc/h264_levels.cu``).  For a P
    frame it windows its band plus ``halo_rows`` rows above and below, of
    the frame and of the reference pictures, edge-replicated at the
    picture's borders as the full-frame kernels read them; the halo covers
    the motion search's reach and the interpolation filter's support.  It
    runs the single-card kernels on the window (``subpel_planes_kernel``
    and ``motion_search_kernel``, or ``parts_search_kernel``, then H2, the
    split grids with the inter candidate) and crops the levels and the
    reconstruction to its band.  One slice per MB row makes every per-row computation (the intra
    left edge, the skip predictor, the entropy contexts) band-local, so the
    crop is exact.  The band's levels go to rank 0 (the packed lanes of
    ``models/fused_encode.make_gop_levels``), and every rank all-gathers the
    new reference picture.

    The host entropy stage is the single-card one, by delegation: rank 0's
    ``CudaGopEncoder`` assembles the access units from the gathered lanes
    (``encode_from_packed``).  On rank 0 ``encode`` and ``flush`` return
    access units byte-identical to ``CudaGopEncoder``'s with the same
    options; on every other rank they return ``[]``.  Every rank must call
    them with the same frames.

    Composition: ``search >= 1`` is required (banding exists for the motion
    halo; zero-motion bands are independent through the GOP-per-rank
    mode); full, half and quarter-pel, ``parts``, ``overlap`` and ``refs=2``
    compose; gdr, deblock, bitpack and cpb do not (state across MB rows or
    a per-MB layout)."""

    codec = "h264"

    def __init__(self, width: int, height: int, mesh, qp: int = 30,
                 gop: int = 30, search: int = 4, halfpel: bool = False,
                 quarterpel: bool = False, parts: bool = False,
                 overlap: bool = False, refs: int = 1, device=None) -> None:
        from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder
        from opencv_opencl_tpu_torch.models.enhancer import _d2h_stream

        if search < 1:
            raise ValueError("banded encoding requires search=R >= 1")
        self._inner = CudaGopEncoder(width, height, qp=qp, gop=gop,
                                     search=search, halfpel=halfpel,
                                     quarterpel=quarterpel, parts=parts,
                                     refs=refs, device=device)
        self.mesh = mesh
        self.device = self._inner.device
        self._rank, nb = _position(mesh)
        h16 = -(-height // 16) * 16
        w16 = -(-width // 16) * 16
        mb_h = h16 // 16
        if mb_h % nb:
            raise ValueError(
                f"banded encoding needs MB rows ({mb_h}) divisible by "
                f"the device count ({nb})")
        band_mbs = mb_h // nb
        subpel = self._inner.subpel
        # halo: search reach + 6-tap/bilinear support rows, rounded to
        # whole MB rows so the window stays a valid frame
        s16 = 16 * (-(-(search + (3 if subpel else 0)) // 16))
        self.band_mbs, self.halo_rows = band_mbs, s16
        self._h16, self._w16 = h16, w16
        opts = dict(search=search, subpel=subpel, refs=refs, parts=parts)
        self._do_i, _ = make_gop_levels(band_mbs, w16 // 16, self.device, **opts)
        _, self._do_p = make_gop_levels(band_mbs + 2 * s16 // 16, w16 // 16,
                                        self.device, **opts)
        self._overlap = bool(overlap)
        self._pending = None
        self._d2h = _d2h_stream(self.device)
        self._frames = 0
        self._refs: list[tuple] = []   # full reference pictures, newest first

    # ---- io.encoder protocol: the entropy stage is the inner encoder's
    @property
    def gop(self) -> int:
        return self._inner.gop

    @property
    def qp(self) -> int:
        return self._inner.qp

    def _planes(self, nv12) -> tuple[torch.Tensor, ...]:
        """The 16-aligned frame on the device as (y, cb, cr) planes."""
        h16, w16 = self._h16, self._w16
        arr = np.asarray(nv12, dtype=np.uint8).reshape(
            self._inner.height * 3 // 2, self._inner.width)
        padded, _, _ = self._inner._intra._pad(arr)
        frame = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        uv = frame[h16:].view(h16 // 2, w16 // 2, 2)
        return frame[:h16], uv[:, :, 0], uv[:, :, 1]

    def _band_step(self, y, cb, cr) -> tuple[torch.Tensor, tuple]:
        """This rank's packed lanes and band of the new reference picture."""
        qp, rows, s16 = self._inner.qp, self.band_mbs * 16, self.halo_rows
        lo = self._rank * rows
        idx = self._frames
        if idx % self.gop == 0:
            return self._do_i(y[lo:lo + rows], cb[lo // 2:(lo + rows) // 2],
                              cr[lo // 2:(lo + rows) // 2], qp)

        def win(planes):
            return (_window(planes[0], lo - s16, rows + 2 * s16),
                    *(_window(p, (lo - s16) // 2, (rows + 2 * s16) // 2)
                      for p in planes[1:]))

        # with refs=2 the frame right after each IDR predicts from one picture
        two = self._inner.refs > 1 and idx % self.gop != 1
        packed, rec = self._do_p(*win((y, cb, cr)), qp, idx, win(self._refs[0]),
                                 win(self._refs[1]) if two else None)
        k = s16 // 16
        return packed[k:k + self.band_mbs], (
            rec[0][s16:s16 + rows], *(p[s16 // 2:(s16 + rows) // 2] for p in rec[1:]))

    def _step(self, nv12):
        """Code one frame on every rank: rank 0's gathered lanes on their
        way to the host, None on the other ranks."""
        y, cb, cr = self._planes(nv12)
        packed, rec = _agreed(lambda: self._band_step(y, cb, cr), self.device)
        # the new reference picture, whole, on every rank: one gather of
        # the three band planes
        flat = all_gather_cat(torch.cat([p.reshape(-1) for p in rec]))
        rows, w16 = self.band_mbs * 16, self._w16
        bands = flat.view(-1, rows * w16 * 3 // 2)
        full = (bands[:, :rows * w16].reshape(-1, w16),
                bands[:, rows * w16:rows * w16 * 5 // 4].reshape(-1, w16 // 2),
                bands[:, rows * w16 * 5 // 4:].reshape(-1, w16 // 2))
        full = tuple(p.contiguous() for p in full)
        if self._frames % self.gop == 0:
            self._refs = [full]
        else:
            self._refs = ([full] + self._refs)[:self._inner.refs]
        self._frames += 1
        lanes = gather_cat(packed)
        if lanes is None:
            return None
        return DeviceBatch(lanes, self._d2h if lanes.is_cuda else None)

    def encode(self, nv12) -> list[bytes]:
        lanes = self._step(nv12)
        if lanes is None:
            return []
        if not self._overlap:
            return self._inner.encode_from_packed(lanes.numpy())
        # depth-1 pipeline: frame N's lanes come down while frame N-1's
        # access unit is assembled (bytes unchanged; flush drains the tail)
        prev, self._pending = self._pending, lanes
        return [] if prev is None else self._inner.encode_from_packed(prev.numpy())

    def flush(self) -> list[bytes]:
        prev, self._pending = self._pending, None
        return [] if prev is None else self._inner.encode_from_packed(prev.numpy())

    def close(self) -> None:
        self._inner.close()
