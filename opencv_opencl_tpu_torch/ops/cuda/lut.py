"""The kernels of ``lut_kernels.py`` (K4, K6, K6r, K8, K9), each beside its
plain PyTorch version.

Counterpart of ``opencv_opencl_tpu/ops/pallas/lut_kernels.py``.  The
kernels are CUDA C++ for Hopper in ``opencv_opencl_tpu_torch/csrc/lut.cu``:

========================  ===========================  ==========================
wrapper                   plain version                TPU kernel it replaces
========================  ===========================  ==========================
apply_lut                 apply_lut_ref                apply_lut_pallas (K4)
clahe_interpolate_cells   clahe_interpolate_cells_ref  clahe_interpolate_pallas,
                                                       radix=False (K6)
tile_histograms_extended  tile_histograms_extended_    tile_histograms_pallas
                          ref                          (K8)
clahe_interpolate_cells_  clahe_interpolate_cells_     clahe_interpolate_pallas_
band                      band_ref                     band (K9; K6's kernel)
clahe_interpolate_cells   clahe_interpolate_cells_ref  clahe_interpolate_pallas,
(radix=True)              (radix=True)                 radix=True (K6r; K6's
                                                       kernel)
========================  ===========================  ==========================

As in ``ops/cuda/natural.py``: a wrapper takes its plain version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel on the
current stream or raises, and counts its launches in ``<wrapper>.launches``.
Frames are (N, H, W) uint8 with unit column stride; rows and frames may be
strided, so the Y rows of an NV12 batch go in without a copy.

K6 is CLAHE's bilinear blend (K3's contract) organised by cells: the
regions between tile centres where the same four tile LUTs apply.
:func:`make_interp_spec` is the host-side geometry, ``make_interp_spec``
of the JAX module without its TPU layout fields (the (8, 128)-aligned cell
padding, ``rows_sub``, ``row_block_live`` and the padded weight tables),
which the Hopper kernel does not use.  K8 is K1's contract on an already
extended frame; no path runs it (nor does any path of the JAX package): it
is K1's kernel, ``tile_hist_kernel<4>`` in ``csrc/natural.cu``, launched as
K10 launches it, and checked and timed beside K1.
K9 is K6's kernel on a band of rows that starts at a global row, as the
JAX package has one Pallas body behind both; no path of either package
runs it (the sharded step takes K5), and it is checked and timed beside K5.
K6r, the JAX module's radix-16 variant, is K6's kernel on whole frames
(``clahe_interpolate_cells(radix=True)``, counted apart): the radix
selection answered an expensive gather on the TPU, and K6 already reads a
pixel's four LUT entries as one 32-bit word of the cell's interleaved pack
in shared memory.  Only the tests of the JAX package run its TPU kernel;
here it is checked and timed beside K6, K3 and K5.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops.cuda import _build
from opencv_opencl_tpu_torch.ops.cuda.natural import (
    _HIST_LOADS,
    _THREADS,
    _check,
    _check_band,
    _check_band_out,
    _check_frames,
    _check_luts,
    _on_card,
    _raise_on,
    _stream,
    _tile_hist,
    batched_hist_args,
    bincount_tiles,
    blend,
    interp_vec,
    live_rows,
    unit_major,
)

__all__ = [
    "apply_lut",
    "apply_lut_ref",
    "InterpSpec",
    "make_interp_spec",
    "cells_rows_per_block",
    "clahe_interpolate_cells",
    "clahe_interpolate_cells_ref",
    "build_cell_pack",
    "clahe_interpolate_cells_band",
    "clahe_interpolate_cells_band_ref",
    "tile_histograms_extended",
    "tile_histograms_extended_ref",
    "launch_counts",
    "reset_launch_counts",
]

# K4 rows per block: one row per warp of the 8-warp block, so a 4K batch of
# 4 gives 1080 blocks, about 8 per SM of an H100's 132
_ROWS_PER_BLOCK = 8
# K6 rows per block: as many as this many passes of the block's 256 threads
# map in 16-byte units of two rows of a cell (32 rows of a 4K cell).  On an
# H100 (700 W) K6 took 0.0520 ms at 4K b4 with 16 rows a block, 0.0504 with
# 24, 0.0470 with 32, 0.0478 with 48 and 0.0481 with 64
# (scripts/torch_kernel_turns.py --cells-rows)
_CELL_PASSES = 2
# the JAX module's cut: a cell row's one-hot, 256 x tw_pad bf16, within 8 MB
_ONEHOT_ROW_BYTES_LIMIT = 8 * 1024 * 1024


# ------------------------------------------------------------------ K4 ----


def apply_lut_ref(y: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`apply_lut`: ``gather`` along each frame's
    LUT."""
    n = y.shape[0]
    return torch.gather(luts, 1, y.reshape(n, -1).long()).reshape(y.shape)


def _check_unit_cols(t: torch.Tensor, name: str) -> None:
    _check(t, name, torch.uint8, 3)
    if t.stride(2) != 1 and t.shape[2] > 1:
        raise ValueError(f"{name} must have unit column stride, got "
                         f"strides {t.stride()}")


def _check_out(out: torch.Tensor | None, y: torch.Tensor) -> None:
    if out is not None:
        _check_unit_cols(out, "out")
        if out.shape != y.shape or out.device != y.device:
            raise ValueError("out must match y in shape and device")


def apply_lut(y: torch.Tensor, luts: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Map (N, H, W) uint8 frames through one 256-entry uint8 LUT per frame,
    ``luts`` (N, 256).  Rows and frames may be strided (the Y rows of an
    NV12 batch); ``out`` (same shape) may be ``y`` itself."""
    _check_unit_cols(y, "y")
    _check(luts, "luts", torch.uint8, 2)
    if tuple(luts.shape) != (y.shape[0], 256):
        raise ValueError(f"luts must be ({y.shape[0]}, 256), got "
                         f"{tuple(luts.shape)}")
    _check_out(out, y)
    if luts.device != y.device:
        raise ValueError(f"luts on {luts.device}, frames on {y.device}")
    if not _on_card(y):
        res = apply_lut_ref(y, luts)
        return res if out is None else out.copy_(res)
    if not luts.is_contiguous():
        raise ValueError("luts must be contiguous")
    lib = _build.load()
    if out is None:
        out = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
    n, h, w = y.shape
    if n and h and w:
        with torch.cuda.device(y.device):
            err = lib.apply_lut_launch(
                y.data_ptr(), y.stride(0), y.stride(1), luts.data_ptr(), n, h,
                w, out.data_ptr(), out.stride(0), out.stride(1),
                _ROWS_PER_BLOCK, _stream(y.device))
        _raise_on(err, "apply_lut_kernel")
        apply_lut.launches += 1
    return out


# ------------------------------------------------------------------ K6 ----


@dataclasses.dataclass(frozen=True)
class InterpSpec:
    """Static geometry of the cell-grid CLAHE interpolation.

    The frame sits in a grid of (tiles_y + 1) x (tiles_x + 1) cells of
    (tile_h, tile_w) pixels at offset (pad_top, pad_left): frame row r lies
    in cell row (r + pad_top) // tile_h, and the cell's four LUTs are
    ``cell_lut_idx[cy, cx]``.  ``ya`` and ``xa`` are the plan's f32 row and
    column weights.  ``device_arrays`` caches the arrays as tensors, once
    per device."""

    height: int
    width: int
    tiles_x: int
    tiles_y: int
    tile_h: int          # interpolation tile size (from the CLAHE plan)
    tile_w: int
    pad_top: int         # frame origin inside the cell grid
    pad_left: int
    cell_lut_idx: np.ndarray  # int32 (CY, CX, 4): flat tile index of the 4 LUTs
    ya: np.ndarray            # float32[H]
    xa: np.ndarray            # float32[W]
    _device_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def cy(self) -> int:
        return self.tiles_y + 1

    @property
    def cx(self) -> int:
        return self.tiles_x + 1

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def device_arrays(self, device) -> tuple[torch.Tensor, ...]:
        """(cell_lut_idx, ya, xa) on ``device``, as the host built them."""
        device = torch.device(device)
        arrays = self._device_cache.get(device)
        if arrays is None:
            arrays = tuple(torch.from_numpy(a).to(device)
                           for a in (self.cell_lut_idx, self.ya, self.xa))
            self._device_cache[device] = arrays
        return arrays

    def column_parts(self) -> np.ndarray:
        """K6's columns of each cell column cx: (CX, 4) int32 (c0, a, b, c1),
        the cell's frame columns [c0, c1) cut into head bytes [c0, a) up to
        the first multiple of 16, whole 16-byte units [a, b) and tail bytes
        [b, c1).  A cell with no whole unit has a == b; a cell outside the
        frame has c0 == c1."""
        cx = np.arange(self.cx)
        c0 = np.clip(cx * self.tile_w - self.pad_left, 0, self.width)
        c1 = np.maximum(np.clip((cx + 1) * self.tile_w - self.pad_left, 0,
                                self.width), c0)
        a = np.minimum(-(-c0 // 16) * 16, c1)
        b = np.maximum(c1 // 16 * 16, a)
        return np.stack([c0, a, b, c1], axis=1).astype(np.int32)

    def unit_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """K6's column tables on ``device``: :meth:`column_parts`, and the
        plan's ``xa`` by 16-pixel unit, (4, W // 16, 4) f32
        (``natural.unit_major``: the values of ``PackSpec.unit_tables``)."""
        key = (torch.device(device), "unit_tables")
        tables = self._device_cache.get(key)
        if tables is None:
            tables = (torch.from_numpy(self.column_parts()).to(key[0]),
                      torch.from_numpy(unit_major(self.xa)).to(key[0]))
            self._device_cache[key] = tables
        return tables


def _cell_mapping_ok(lo: np.ndarray, hi: np.ndarray, n: int, tile: int,
                     pad: int, tiles: int) -> bool:
    """Verify clip(floor((p+pad)/tile) - 1) reproduces the plan's exact
    f32-derived per-pixel tile indices."""
    c = (np.arange(n) + pad) // tile
    lo2 = np.clip(c - 1, 0, tiles - 1)
    hi2 = np.clip(c, 0, tiles - 1)
    return bool(np.array_equal(lo2, lo) and np.array_equal(hi2, hi))


@functools.lru_cache(maxsize=64)
def make_interp_spec(height: int, width: int, clip_limit: float,
                     tile_grid: tuple[int, int]) -> InterpSpec | None:
    """The cell-grid spec for a CLAHE plan, or None where the JAX package's
    ``make_interp_spec`` gives None: a geometry whose cells do not
    reproduce the plan's per-pixel tile indices at either rounding of the
    offset, or whose cell row's one-hot would exceed the TPU's 8 MB."""
    # ops.clahe imports this package, so its plan builder is imported here
    from opencv_opencl_tpu_torch.ops.clahe import make_clahe_plan

    plan = make_clahe_plan(height, width, clip_limit, tile_grid)
    th, tw = plan.tile_h, plan.tile_w
    pad_top, pad_left = th // 2, tw // 2
    if not _cell_mapping_ok(plan.ty1, plan.ty2, height, th, pad_top,
                            plan.tiles_y):
        pad_top += 1  # odd tile sizes: the boundary rounds the other way
        if not _cell_mapping_ok(plan.ty1, plan.ty2, height, th, pad_top,
                                plan.tiles_y):
            return None
    if not _cell_mapping_ok(plan.tx1, plan.tx2, width, tw, pad_left,
                            plan.tiles_x):
        pad_left += 1
        if not _cell_mapping_ok(plan.tx1, plan.tx2, width, tw, pad_left,
                                plan.tiles_x):
            return None
    tw_pad = -(-tw // 128) * 128
    if 256 * tw_pad * 2 > _ONEHOT_ROW_BYTES_LIMIT:
        return None

    # the 4 contributing LUT (flat) indices per cell: l11, l12, l21, l22
    cy, cx = plan.tiles_y + 1, plan.tiles_x + 1
    y1 = np.clip(np.arange(cy)[:, None] - 1, 0, plan.tiles_y - 1)
    y2 = np.clip(np.arange(cy)[:, None], 0, plan.tiles_y - 1)
    x1 = np.clip(np.arange(cx)[None, :] - 1, 0, plan.tiles_x - 1)
    x2 = np.clip(np.arange(cx)[None, :], 0, plan.tiles_x - 1)
    tx = plan.tiles_x
    cell_lut_idx = np.stack(
        [np.broadcast_to(a * tx + b, (cy, cx))
         for a, b in ((y1, x1), (y1, x2), (y2, x1), (y2, x2))],
        axis=-1).astype(np.int32)
    return InterpSpec(
        height=height, width=width, tiles_x=plan.tiles_x,
        tiles_y=plan.tiles_y, tile_h=th, tile_w=tw, pad_top=pad_top,
        pad_left=pad_left, cell_lut_idx=cell_lut_idx, ya=plan.ya, xa=plan.xa)


def clahe_interpolate_cells_band_ref(y_band: torch.Tensor, luts: torch.Tensor,
                                     spec: InterpSpec, row0: int) -> torch.Tensor:
    """Plain version of :func:`clahe_interpolate_cells_band`: each pixel's
    cell from the spec's offsets and its global row, the cell's four LUTs
    gathered at its value, then the blend (``natural.blend``).  Rows at or
    beyond the frame's height come back unchanged."""
    n, band_rows, w = y_band.shape
    live = live_rows(band_rows, spec.height, row0)
    cell_lut_idx, ya, xa = spec.device_arrays(y_band.device)
    global_rows = torch.arange(row0, row0 + live, device=y_band.device)
    rows = (global_rows + spec.pad_top) // spec.tile_h
    cols = (torch.arange(w, device=y_band.device) + spec.pad_left) // spec.tile_w
    four = cell_lut_idx[rows[:, None], cols[None, :]].long() * 256  # (rows, W, 4)
    flat = luts.reshape(-1)
    v = y_band[:, :live].long() + (torch.arange(n, device=y_band.device)
                                   * (spec.num_tiles * 256))[:, None, None]

    def lookup(k):
        return flat[four[..., k] + v].to(torch.float32)

    res = blend(lookup(0), lookup(1), lookup(2), lookup(3), xa,
                ya[row0:row0 + live, None])
    return res if live == band_rows else torch.cat([res, y_band[:, live:]], dim=1)


def build_cell_pack(luts: torch.Tensor, spec: InterpSpec) -> torch.Tensor:
    """(N, T, 256) uint8 LUTs -> (N, CY, CX, 16, 16, 4): ``pack[n, cy, cx,
    hi, lo]`` holds the four LUT entries (l11, l12, l21, l22) of cell
    (cy, cx) at value ``16*hi + lo``, the layout K6's blocks (and so
    K6r's) stage in shared memory."""
    cell_lut_idx = spec.device_arrays(luts.device)[0].long()
    pack = luts[:, cell_lut_idx].permute(0, 1, 2, 4, 3)     # (N, CY, CX, 256, 4)
    return pack.reshape(*pack.shape[:3], 16, 16, 4)


def _interpolate_cells_radix_ref(y: torch.Tensor, luts: torch.Tensor,
                                 spec: InterpSpec) -> torch.Tensor:
    """The radix form of the plain version: each pixel's four entries come
    out of its cell's interleaved pack in two stages, the high then the low
    four bits of its value."""
    n, h, w = y.shape
    _, ya, xa = spec.device_arrays(y.device)
    rows = (torch.arange(h, device=y.device) + spec.pad_top) // spec.tile_h
    cols = (torch.arange(w, device=y.device) + spec.pad_left) // spec.tile_w
    words = build_cell_pack(luts, spec).reshape(-1, 4)
    v = y.long()
    frames = torch.arange(n, device=y.device)[:, None, None]
    cell = (frames * spec.cy + rows[None, :, None]) * spec.cx + cols[None, None, :]
    four = words[((cell * 16 + (v >> 4)) * 16) + (v & 15)].to(torch.float32)
    return blend(four[..., 0], four[..., 1], four[..., 2], four[..., 3], xa,
                 ya[:, None])


def clahe_interpolate_cells_ref(y: torch.Tensor, luts: torch.Tensor,
                                spec: InterpSpec,
                                radix: bool = False) -> torch.Tensor:
    """Plain version of :func:`clahe_interpolate_cells`: the band version
    over the whole frame, or with ``radix=True`` the two-stage selection
    from the interleaved cell pack (the same output)."""
    if radix:
        return _interpolate_cells_radix_ref(y, luts, spec)
    return clahe_interpolate_cells_band_ref(y, luts, spec, 0)


def clahe_interpolate_cells(y: torch.Tensor, luts: torch.Tensor,
                            spec: InterpSpec, out: torch.Tensor | None = None,
                            radix: bool = False) -> torch.Tensor:
    """CLAHE bilinear LUT interpolation of (N, H, W) uint8 frames on the
    cell grid of ``spec``, with (N, T, 256) uint8 ``luts``: K3's output, bit
    for bit.  ``out`` (same shape, unit column stride) may be ``y`` itself.
    On the card the LUTs must be contiguous and 4-byte aligned (the kernel
    stages them as 32-bit words); others raise.

    ``radix=True`` (the JAX module's radix-16 kernel variant, K6r) gives
    the same output through the same kernel and the same launch; its
    launches are counted in ``clahe_interpolate_cells.radix_launches``."""
    _check_frames(y, spec)
    _check_luts(luts, y, spec)
    _check_out(out, y)
    if not _on_card(y):
        res = clahe_interpolate_cells_ref(y, luts, spec, radix)
        return res if out is None else out.copy_(res)
    out, launched = _interpolate_cells(y, luts, spec, 0, out)
    if radix:
        clahe_interpolate_cells.radix_launches += launched
    else:
        clahe_interpolate_cells.launches += launched
    return out


def cells_rows_per_block(spec: InterpSpec) -> int:
    """K6's rows per block: as many as ``_CELL_PASSES`` passes of the
    block's threads map in a cell, two rows of a 16-byte unit each (32 at
    4K, 68 at 1080p)."""
    passes = 2 * _CELL_PASSES * max(1, _THREADS // max(1, spec.tile_w // 16))
    return max(1, min(spec.tile_h, passes))


def _check_cell_grid(spec: InterpSpec, n: int) -> None:
    if spec.cx > 65535 or n > 65535:
        raise ValueError(f"{spec.cx} cell columns or {n} frames exceed the "
                         "launch grid")


def _interpolate_cells(y_band: torch.Tensor, luts: torch.Tensor,
                       spec: InterpSpec, row0: int,
                       out: torch.Tensor | None) -> tuple[torch.Tensor, bool]:
    """Launch ``interp_cells_kernel`` on a band on the card (the whole
    frame is the band at row 0); returns the output and whether a launch
    was made (the callers count it)."""
    # the kernel stages each LUT as 32-bit words
    if not luts.is_contiguous() or luts.data_ptr() % 4:
        raise ValueError("luts must be contiguous and 4-byte aligned")
    n, band_rows, _ = y_band.shape
    _check_cell_grid(spec, n)
    lib = _build.load()
    live = live_rows(band_rows, spec.height, row0)
    if out is None:
        out = torch.empty(y_band.shape, dtype=torch.uint8, device=y_band.device)
        if live < band_rows:
            out[:, live:].copy_(y_band[:, live:])
    if not (n and live):
        return out, False
    cell_lut_idx, ya, xa = spec.device_arrays(y_band.device)
    col_parts, xa_units = spec.unit_tables(y_band.device)
    with torch.cuda.device(y_band.device):
        err = lib.interp_cells_launch(
            y_band.data_ptr(), y_band.stride(0), y_band.stride(1),
            luts.data_ptr(), n, spec.num_tiles, cell_lut_idx.data_ptr(),
            spec.cx, spec.height, spec.tile_h, spec.pad_top,
            cells_rows_per_block(spec), row0, live, col_parts.data_ptr(),
            ya.data_ptr(), xa.data_ptr(), xa_units.data_ptr(),
            spec.width // 16, out.data_ptr(), out.stride(0), out.stride(1),
            int(interp_vec(y_band, out)), _stream(y_band.device))
    _raise_on(err, "interp_cells_kernel")
    return out, True


def clahe_interpolate_cells_band(y_band: torch.Tensor, luts: torch.Tensor,
                                 spec: InterpSpec, row0: int,
                                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K6's blend on a band: (N, rows, W) uint8 whose first row is global
    row ``row0`` (any ``row0 >= 0``, any number of rows) of the spec's
    frames, with the whole frames' (N, T, 256) LUTs.  Rows at or beyond the
    frame's height are not written (with ``out=None`` they come back
    unchanged).  ``out`` may be ``y_band`` itself."""
    _check_band(y_band, spec.width)
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    _check_luts(luts, y_band, spec)
    _check_band_out(out, y_band, spec.width)
    if not _on_card(y_band):
        res = clahe_interpolate_cells_band_ref(y_band, luts, spec, row0)
        return res if out is None else out.copy_(res)
    out, launched = _interpolate_cells(y_band, luts, spec, row0, out)
    clahe_interpolate_cells_band.launches += launched
    return out


# ------------------------------------------------------------------ K8 ----


def tile_histograms_extended_ref(ext: torch.Tensor, tiles_y: int, tiles_x: int,
                                 tile_h: int, tile_w: int) -> torch.Tensor:
    """Plain version of :func:`tile_histograms_extended`: ``bincount`` per
    tile."""
    return bincount_tiles(ext, tiles_y, tiles_x, tile_h, tile_w).to(torch.int32)


def tile_histograms_extended(ext: torch.Tensor, tiles_y: int, tiles_x: int,
                             tile_h: int, tile_w: int) -> torch.Tensor:
    """(N, tiles_y*tile_h, tiles_x*tile_w) uint8 frames, already extended
    to the tile-divisible size -> (N, T, 256) int32 histograms of their
    tiles in row-major order (``tile_histograms_pallas`` with a batch
    axis): K1's kernel with K1's loads in flight, planned by
    ``natural.batched_hist_args`` (every tile interior, one rowstep, no
    band), counted here apart from K1 and K10."""
    _check_unit_cols(ext, "ext")
    if tuple(ext.shape[1:]) != (tiles_y * tile_h, tiles_x * tile_w):
        raise ValueError(f"ext frames are {tuple(ext.shape[1:])}, not "
                         f"{tiles_y}x{tiles_x} tiles of {tile_h}x{tile_w}")
    if not _on_card(ext):
        return tile_histograms_extended_ref(ext, tiles_y, tiles_x, tile_h, tile_w)
    n = ext.shape[0]
    num_tiles = tiles_y * tiles_x
    out = torch.zeros((n, num_tiles, 256), dtype=torch.int32, device=ext.device)
    if n and num_tiles and tile_h and tile_w:
        _tile_hist(ext, out, batched_hist_args(ext, tiles_y, tiles_x, tile_h,
                                               tile_w, _HIST_LOADS))
        tile_histograms_extended.launches += 1
    return out


_WRAPPERS = (apply_lut, clahe_interpolate_cells, tile_histograms_extended,
             clahe_interpolate_cells_band)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
    clahe_interpolate_cells.radix_launches = 0


def launch_counts() -> dict[str, int]:
    """Launches by wrapper name; K6r's, made through
    ``clahe_interpolate_cells(radix=True)``, under
    ``clahe_interpolate_cells_radix``."""
    counts = {fn.__name__: fn.launches for fn in _WRAPPERS}
    counts["clahe_interpolate_cells_radix"] = clahe_interpolate_cells.radix_launches
    return counts


reset_launch_counts()
