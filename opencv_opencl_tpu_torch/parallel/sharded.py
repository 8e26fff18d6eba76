"""Multi-GPU sharded enhancement: frame DP x spatial row-band sharding.

Counterpart of ``opencv_opencl_tpu/parallel/sharded.py`` on
``torch.distributed``: one process per mesh position, rank ``d * S + s``.

- **data** axis: the batch of frames is split across positions — each
  enhances its own frames end to end, no communication.
- **space** axis: each frame's rows are split into horizontal bands.
  Histogram equalization needs one *global* histogram -> an all-reduce over
  the space axis (256 int32 = 1 KB per frame).  CLAHE's per-tile histograms
  are band-local (bands own whole tile rows), and the bilinear blend needs
  neighbour tiles' LUTs -> an all-gather of the per-band tile histograms,
  after which LUT construction is replicated math and interpolation is
  band-local.  Pixels cross no card inside the step.

**Arbitrary geometry**, by the JAX package's scheme without its padded
copies: bands own whole tile rows of the plan, with FAKE tile rows (zero
histograms, which no real pixel references) up to a space-divisible tile
count; the interpolation bands are ``hq / S`` rows with
``hq = ceil(H, 8 * S)``, clipped to the frame, so the last band may be
short or empty and there are no pad rows to slice off.  A position uploads
only the rows it reads: the hull of its histogram band's source rows (the
reflect-101 sources of a bottom pad can lie above the band's own first
row) and of its interpolation band.

On the card a position runs the hand-written kernels: K1 on its band of
tile rows, K2, and K5 (``interp_kernel`` with a row origin) in place on
its band for CLAHE; K1 on its band and K4 for histeq.  ``backend="xla"``
selects the plain band versions instead.

The per-position work is written as plain functions of the position, with
the collective passed in.  A ``(D, S)`` tuple in place of a ``DeviceMesh``
runs every position in the calling process, one after another (no process
group): the single-process form that the CPU tests hold against the JAX
package's 8-device CPU mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from opencv_opencl_tpu_torch.core.frames import ChromaPolicy
from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig, _d2h_stream
from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
from opencv_opencl_tpu_torch.ops import histeq as histeq_ops
from opencv_opencl_tpu_torch.ops import histogram as hist_ops
from opencv_opencl_tpu_torch.ops.cuda import natural
from opencv_opencl_tpu_torch.parallel import collectives
from opencv_opencl_tpu_torch.runtime.handoff import DeviceBatch

__all__ = [
    "RankPart",
    "sharded_histeq",
    "sharded_clahe",
    "build_sharded_pipeline",
    "ShardedEnhancer",
]

_BAND_RS = 8  # interpolation bands are multiples of 8 rows, as in the JAX package

Mesh = DeviceMesh | tuple[int, int]


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _span(s: int, size: int, limit: int) -> tuple[int, int]:
    """Band ``s`` of ``size`` units, clipped to ``limit``."""
    return min(s * size, limit), min((s + 1) * size, limit)


def _hull(*spans: tuple[int, int]) -> tuple[int, int]:
    spans = [sp for sp in spans if sp[1] > sp[0]]
    if not spans:
        return 0, 0
    return min(lo for lo, _ in spans), max(hi for _, hi in spans)


# ------------------------------------------------------ per-position work ----
# A "bands" object holds what one op needs to know about the space axis:
# which rows position s reads (`slab`) and writes (`rows`), the local stage
# before the collective (`local`), the collective's kind (`collective`) and
# the stage after it (`finish`, in place on the slab).


class _HisteqBands:
    """equalizeHist over ``nsp`` row bands: hist256 of the band's real rows
    (so there is no bin-0 pad to subtract), all-reduce, the LUT, K4."""

    collective = "sum"

    def __init__(self, height: int, width: int, nsp: int):
        self.height, self.width, self.nsp = height, width, nsp
        self.rows_loc = _ceil_to(height, nsp) // nsp
        self.total = height * width

    def rows(self, s: int) -> tuple[int, int]:
        return _span(s, self.rows_loc, self.height)

    slab = rows

    def local(self, slab: torch.Tensor, slab_row0: int, s: int) -> torch.Tensor:
        if slab.shape[1] == 0:
            return torch.zeros((slab.shape[0], 256), dtype=torch.int32,
                               device=slab.device)
        return hist_ops.hist256(slab)

    def finish(self, slab: torch.Tensor, slab_row0: int, s: int,
               hists: torch.Tensor) -> torch.Tensor:
        if slab.shape[1]:
            histeq_ops.equalize_frames(slab, hists, self.total, out=slab)
        return slab


class _ClaheBands:
    """CLAHE over ``nsp`` row bands: K1 on the band's tile rows (zeros for
    the fake ones), all-gather, K2 on the real tiles, K5 on the band."""

    collective = "gather"

    def __init__(self, plan: clahe_ops.ClahePlan, nsp: int, backend: str):
        if backend not in ("auto", "natural", "pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        self.plan, self.nsp = plan, nsp
        self.height, self.width = plan.height, plan.width
        tiles_yp, _, hq = _clahe_geometry(plan, nsp)
        self.tiles_loc = tiles_yp // nsp
        self.rows_loc = hq // nsp
        self.kernels = backend != "xla"

    def tile_rows(self, s: int) -> tuple[int, int]:
        return _span(s, self.tiles_loc, self.plan.tiles_y)

    def rows(self, s: int) -> tuple[int, int]:
        return _span(s, self.rows_loc, self.height)

    def slab(self, s: int) -> tuple[int, int]:
        return _hull(natural.band_source_rows(self.plan, self.tile_rows(s)),
                     self.rows(s))

    def local(self, slab: torch.Tensor, slab_row0: int, s: int) -> torch.Tensor:
        plan, tile_rows = self.plan, self.tile_rows(s)
        count = natural.tile_histograms if self.kernels else natural.tile_histograms_ref
        hists = count(slab, plan, 1, tile_rows, slab_row0)
        fake = self.tiles_loc - (tile_rows[1] - tile_rows[0])
        if fake:
            hists = torch.cat([hists, hists.new_zeros(
                (hists.shape[0], fake * plan.tiles_x, 256))], dim=1)
        return hists

    def finish(self, slab: torch.Tensor, slab_row0: int, s: int,
               hists: torch.Tensor) -> torch.Tensor:
        plan = self.plan
        r0, r1 = self.rows(s)
        band = slab[:, r0 - slab_row0:r1 - slab_row0] if r1 > r0 else slab[:, :0]
        if band.shape[1] == 0:
            return band
        hists = hists[:, :plan.num_tiles].contiguous()
        if self.kernels:
            luts = natural.build_luts(hists, plan.clip, plan.lut_scale)
            natural.clahe_interpolate_band(band, luts, plan, r0, out=band)
        else:
            luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
            band.copy_(natural.clahe_interpolate_band_ref(band, luts, plan, r0))
        return band


class _PassBands(_HisteqBands):
    """The pass-through op: the Y rows as they are, no collective."""

    collective = None

    def local(self, slab, slab_row0, s):
        return None

    def finish(self, slab, slab_row0, s, hists):
        return slab


def _clahe_geometry(plan: clahe_ops.ClahePlan, nsp: int):
    """Static padded-grid geometry for a (space=nsp) mesh: the tile rows
    with fake ones up to a multiple of nsp, the rows they cover, and the
    interpolation rows up to a multiple of 8 * nsp."""
    tiles_yp = _ceil_to(plan.tiles_y, nsp)
    hp = tiles_yp * plan.tile_h
    hq = _ceil_to(plan.height, _BAND_RS * nsp)
    return tiles_yp, hp, hq


@dataclasses.dataclass(frozen=True)
class RankPart:
    """What one mesh position takes of a batch: frames
    ``[d * N / ndata, (d + 1) * N / ndata)``, the Y rows it writes (its
    band) and the Y rows it reads and uploads (its slab)."""

    d: int
    ndata: int
    s: int
    nspace: int
    rows: tuple[int, int]
    slab: tuple[int, int]

    def frames(self, n: int) -> slice:
        if n % self.ndata:
            raise ValueError(
                f"batch {n} not divisible by mesh data axis {self.ndata}")
        per = n // self.ndata
        return slice(self.d * per, (self.d + 1) * per)


def _part(bands, d: int, s: int, ndata: int) -> RankPart:
    return RankPart(d=d, ndata=ndata, s=s, nspace=bands.nsp,
                    rows=bands.rows(s), slab=bands.slab(s))


def _host_frames(y) -> torch.Tensor:
    """The global (N, H, W) uint8 batch as a host tensor (no copy of numpy)."""
    t = y if isinstance(y, torch.Tensor) else torch.from_numpy(np.asarray(y))
    if t.dtype != torch.uint8 or t.ndim != 3:
        raise ValueError(f"expected uint8 (N, H, W), got {t.dtype} {tuple(t.shape)}")
    return t.cpu()


def _upload(y: torch.Tensor, part: RankPart, device: torch.device) -> torch.Tensor:
    """The position's slab on ``device``: its frames, the rows it reads.
    Always a copy: the step writes in place."""
    lo, hi = part.slab
    return y[part.frames(y.shape[0]), lo:hi].to(device, copy=True)


def _slab_step(bands, slab: torch.Tensor, part: RankPart, combine) -> torch.Tensor:
    """One position's step on its slab, in place: the local stage,
    ``combine`` (the collective over the space axis), the stage after it.
    Returns the position's band, a view of the slab."""
    local = bands.local(slab, part.slab[0], part.s)
    if local is not None:
        local = combine(local)
    return bands.finish(slab, part.slab[0], part.s, local)


def _step_in_process(bands, y: torch.Tensor, shape: tuple[int, int],
                     device: torch.device) -> torch.Tensor:
    """Every position of a (D, S) mesh in this process, one after another;
    the collective is a sum or a concatenation of the positions' local
    results.  Returns the assembled (N, H, W) frames on ``device``."""
    ndata, nsp = shape
    out = torch.empty(y.shape, dtype=torch.uint8, device=device)
    for d in range(ndata):
        parts = [_part(bands, d, s, ndata) for s in range(nsp)]
        slabs = [_upload(y, p, device) for p in parts]
        locals_ = [bands.local(slab, p.slab[0], p.s)
                   for slab, p in zip(slabs, parts)]
        if bands.collective == "gather":
            combined = torch.cat(locals_, dim=1)
        elif bands.collective == "sum":
            combined = torch.stack(locals_).sum(dim=0, dtype=torch.int32)
        else:
            combined = None
        for slab, p in zip(slabs, parts):
            band = bands.finish(slab, p.slab[0], p.s, combined)
            out[p.frames(y.shape[0]), p.rows[0]:p.rows[1]] = band
    return out


class _MeshStep:
    """One op's Y step over a mesh: ``local`` gives this position's band,
    ``__call__`` the assembled (N, H, W) frames."""

    def __init__(self, make_bands, mesh: Mesh, data_axis: str,
                 space_axis: str, device: str | torch.device):
        self.device = torch.device(device)
        self.mesh = mesh
        if isinstance(mesh, tuple):     # every position in this process
            self.ndata, nsp = mesh
            self.bands = make_bands(nsp)
            self.part = None
            return
        self._space = mesh.get_group(space_axis)
        self.ndata = dist.get_world_size(mesh.get_group(data_axis))
        self.bands = make_bands(dist.get_world_size(self._space))
        self.part = _part(self.bands, mesh.get_local_rank(data_axis),
                          mesh.get_local_rank(space_axis), self.ndata)

    def _combine(self, local: torch.Tensor) -> torch.Tensor:
        if self.bands.collective == "gather":
            return collectives.all_gather_cat(local, self._space, dim=1)
        return collectives.all_reduce_sum(local, self._space)

    def _own_part(self) -> RankPart:
        if self.part is None:
            raise ValueError("a (D, S) tuple runs every position in this "
                             "process; it has no position of its own")
        return self.part

    def local(self, y) -> torch.Tensor:
        """This position's band of the enhanced frames, on the device."""
        return self.step_slab(_upload(_host_frames(y), self._own_part(),
                                      self.device))

    def step_slab(self, slab: torch.Tensor) -> torch.Tensor:
        """The position's step on its slab (its frames, rows ``part.slab``)
        already on the device, in place; returns its band, a view of the
        slab."""
        part = self._own_part()
        lo, hi = part.slab
        if slab.ndim != 3 or tuple(slab.shape[1:]) != (hi - lo, self.bands.width):
            raise ValueError(f"the slab is {tuple(slab.shape)}, not "
                             f"(n, {hi - lo}, {self.bands.width})")
        return _slab_step(self.bands, slab, part, self._combine)

    def __call__(self, y) -> torch.Tensor:
        """The enhanced (N, H, W) frames, assembled on every position: an
        all-gather of the bands after the step.  On NCCL they stay on the
        device; on gloo the bands go through the host and the result is a
        host tensor."""
        y = _host_frames(y)
        bands = self.bands
        if y.shape[1:] != (bands.height, bands.width):
            raise ValueError(f"frames are {tuple(y.shape[1:])}, the step was "
                             f"built for ({bands.height}, {bands.width})")
        if y.shape[0] % self.ndata:
            raise ValueError(
                f"batch {y.shape[0]} not divisible by mesh data axis {self.ndata}")
        if self.part is None:
            return _step_in_process(bands, y, self.mesh, self.device)
        band = self.step_slab(_upload(y, self.part, self.device))
        n_loc, nsp = band.shape[0], bands.nsp
        padded = band.new_zeros((1, n_loc, bands.rows_loc, bands.width))
        padded[0, :, :band.shape[1]] = band
        if dist.get_backend() == "gloo":
            padded = padded.cpu()
        # rank d * S + s holds frames d, rows s: (D, S, n, rows, W) ->
        # (D, n, S, rows, W) -> (N, S * rows, W)
        whole = collectives.all_gather_cat(padded)
        whole = whole.view(self.ndata, nsp, n_loc, bands.rows_loc, bands.width)
        whole = whole.permute(0, 2, 1, 3, 4).reshape(
            y.shape[0], nsp * bands.rows_loc, bands.width)
        return whole[:, :bands.height]


# ---------------------------------------------------------------- histeq ----


def sharded_histeq(mesh: Mesh, height: int, width: int,
                   method: str = "onehot",
                   data_axis: str = "data", space_axis: str = "space",
                   device: str | torch.device = "cuda") -> _MeshStep:
    """(N, H, W) -> (N, H, W) equalizeHist over a (data, space) mesh, any
    height.  Every position calls the result with the same global batch
    (numpy or a host tensor) and gets the assembled frames;
    ``.local(y)`` gives the position's band alone."""
    clahe_ops._check_method(method)
    return _MeshStep(lambda nsp: _HisteqBands(height, width, nsp), mesh,
                     data_axis, space_axis, device)


# ----------------------------------------------------------------- clahe ----


def sharded_clahe(mesh: Mesh, plan: clahe_ops.ClahePlan,
                  method: str = "onehot",
                  data_axis: str = "data", space_axis: str = "space",
                  backend: str = "auto",
                  device: str | torch.device = "cuda") -> _MeshStep:
    """(N, H, W) -> (N, H, W) CLAHE over a (data, space) mesh, for ANY frame
    geometry, tile grid and space-axis size (see the module docstring).
    ``backend`` "auto", "natural" and "pallas" all run K1, K2 and K5, as in
    the JAX package; "xla" the plain band versions."""
    clahe_ops._check_method(method)
    return _MeshStep(lambda nsp: _ClaheBands(plan, nsp, backend), mesh,
                     data_axis, space_axis, device)


# ----------------------------------------------------------- full pipeline ----


def _build_y_step(cfg: EnhancerConfig, height: int, width: int, mesh: Mesh,
                  data_axis: str, space_axis: str,
                  device: str | torch.device) -> _MeshStep:
    """The Y step of one config over a mesh: CLAHE, histeq or the
    pass-through op."""
    if getattr(cfg, "hist_downsample", 1) != 1:
        raise ValueError(
            "hist_downsample is not supported on the sharded path "
            "(the banded histogram stages are exact-only); drop --mesh "
            "or use the exact mode")
    if cfg.op == "clahe":
        plan = clahe_ops.make_clahe_plan(
            height, width, float(cfg.clip_limit), tuple(cfg.tile_grid))
        return sharded_clahe(mesh, plan, cfg.hist_method, data_axis,
                             space_axis, "auto", device)
    if cfg.op == "histeq":
        return sharded_histeq(mesh, height, width, cfg.hist_method,
                              data_axis, space_axis, device)
    return _MeshStep(lambda nsp: _PassBands(height, width, nsp), mesh,
                     data_axis, space_axis, device)


def build_sharded_pipeline(cfg: EnhancerConfig, height: int, width: int,
                           mesh: Mesh,
                           data_axis: str = "data", space_axis: str = "space",
                           device: str | torch.device = "cuda"):
    """The full multi-GPU NV12 step: (y, uv) batches in, enhanced out.

    Returns ``(fn, part)``: ``fn(y, uv)`` takes the global batches on the
    host and returns the assembled ``(y_out, uv_out)``; ``part`` is this
    position's :class:`RankPart` (None for a (D, S) tuple).  The chroma
    policy is elementwise: ``uv_out`` is ``uv`` itself or a 128 fill of its
    shape, on the host.
    """
    y_step = _build_y_step(cfg, height, width, mesh, data_axis, space_axis,
                           device)

    def fn(y, uv):
        uv = uv if isinstance(uv, torch.Tensor) else torch.from_numpy(np.asarray(uv))
        uv_out = torch.full_like(uv, 128) if cfg.chroma == ChromaPolicy.GRAY else uv
        return y_step(y), uv_out

    return fn, y_step.part


class ShardedEnhancer:
    """Drop-in multi-GPU replacement for ``models.enhancer.Enhancer``: the
    same ``process_batch(nv12_batch) -> nv12_batch`` surface the
    FrameFeeder drives, with the batch split over the ``data`` axis and
    each frame's rows banded over ``space``.  Every position of the mesh
    makes the same calls with the same batches.

    The batch size must be a multiple of the mesh's data axis (each
    position owns whole frames).
    """

    def __init__(self, cfg: EnhancerConfig, spec, mesh: Mesh | None = None,
                 shape: tuple[int, int] | None = None,
                 device: str | torch.device = "cuda"):
        from opencv_opencl_tpu_torch.parallel.mesh import make_mesh

        self.cfg = cfg
        self.spec = spec
        self.mesh = mesh if mesh is not None else make_mesh(shape=shape)
        self.device = torch.device(device)
        self.h, self.w = spec.height, spec.width
        self._y_step = _build_y_step(cfg, self.h, self.w, self.mesh, "data",
                                     "space", self.device)
        self.part = self._y_step.part
        self._d2h = _d2h_stream(self.device)

    def _host_batch(self, nv12_batch) -> torch.Tensor:
        x = _host_frames(nv12_batch)
        if tuple(x.shape[1:]) != (self.spec.buffer_rows, self.w):
            raise ValueError(
                f"expected uint8 (N, {self.spec.buffer_rows}, {self.w}), got "
                f"{tuple(x.shape)}")
        return x

    def _assembled(self, nv12_batch) -> torch.Tensor:
        """The whole enhanced batch, where the assembly left the Y rows."""
        x = self._host_batch(nv12_batch)
        y_out = self._y_step(x[:, :self.h])
        out = torch.empty(x.shape, dtype=torch.uint8, device=y_out.device)
        out[:, :self.h] = y_out
        if self.cfg.chroma == ChromaPolicy.GRAY:
            out[:, self.h:] = 128
        else:
            out[:, self.h:] = x[:, self.h:]
        return out

    def _handoff(self, out: torch.Tensor) -> DeviceBatch:
        return DeviceBatch(out, self._d2h if out.is_cuda else None)

    def process_batch(self, nv12_batch) -> DeviceBatch:
        """uint8 (N, H*3/2, W) -> the whole enhanced batch, assembled on
        every position, on its way to the host."""
        return self._handoff(self._assembled(nv12_batch))

    def process_local(self, nv12_batch) -> torch.Tensor:
        """This position's part alone, with no assembly: its band of the
        enhanced Y rows, ``part.rows`` of frames ``part.frames(N)``, on the
        device."""
        x = self._host_batch(nv12_batch)
        return self._y_step.local(x[:, :self.h])

    def process_frame(self, nv12) -> DeviceBatch:
        """Single frame (H*3/2, W) convenience (batch of 1 under the hood)."""
        frame = nv12 if isinstance(nv12, torch.Tensor) else torch.from_numpy(
            np.asarray(nv12))
        return self._handoff(self._assembled(frame[None])[0])
