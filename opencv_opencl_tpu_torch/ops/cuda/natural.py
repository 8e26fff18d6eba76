"""The CLAHE kernels of the NV12 step, each beside its plain PyTorch version.

Counterpart of ``opencv_opencl_tpu/ops/pallas/natural.py``.  The kernels
are CUDA C++ for Hopper in ``opencv_opencl_tpu_torch/csrc/natural.cu``:

==================  ===================  =====================================
wrapper             plain version        TPU kernel it replaces
==================  ===================  =====================================
tile_histograms     tile_histograms_ref  natural.tile_histograms_radix (K1)
build_luts          build_luts_ref       natural.build_lut_pack_pallas (K2)
clahe_interpolate   clahe_interpolate_   natural.clahe_interpolate_natural,
                    ref                  variant 2 (K3)
clahe_interp_and_   clahe_interp_and_    experiments.clahe_interp_and_hist_
hist                hist_ref             natural (K7)
clahe_interpolate_  clahe_interpolate_   natural.clahe_interpolate_natural_
band                band_ref             band (K5)
clahe_interpolate_  clahe_interpolate_   natural.clahe_interpolate_natural,
pack                pack_ref             variant 1 (K3v1; K5's kernel)
tile_histograms_    tile_histograms_     experiments.tile_histograms_radix_
batched             batched_ref          batched (K10)
==================  ===================  =====================================

K3, K5 and K3v1 are one kernel, ``interp_kernel``, with three entry points
(the JAX package has one Pallas body behind K5 and K3v1, and K3's computes
the same blend): K3 and K3v1 run it on whole frames, K5 on a band of rows
that starts at a global row ``row0`` (the sharded step).  Its blocks are
ranges of rows inside one row pair (:meth:`PackSpec.row_ranges`), each
staging its pair's interleaved LUT pack, whose plain form is
:func:`build_lut_pack`.
``tile_histograms`` also takes a band: ``tile_rows`` of the plan, read from
a slab of the frame that starts at ``slab_row0``.  K10 is K1's contract on
an already extended frame, and here K1's kernel, ``tile_hist_kernel<R>``,
with ``batch_rows`` as R, the 16-byte loads a thread keeps in flight
(:func:`batched_hist_args`; K1 itself takes 4); no path runs it (nor does
any path of the JAX package), and it is checked and timed beside K1 and K8.

A wrapper takes its plain version only for a tensor on the CPU.  For a
CUDA tensor it launches its kernel on the current stream or raises; it
never falls back.  Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``.

All four take a batch: frames are (N, H, W) uint8 with unit column
stride (rows and frames may be strided, so the Y rows of an NV12 batch go
in without a copy); histograms are (N, T, 256) int32 and LUTs (N, T, 256)
uint8, with T = tiles_y * tiles_x in row-major tile order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from opencv_opencl_tpu_torch.core.golden import reflect101_indices
from opencv_opencl_tpu_torch.ops.cuda import _build

__all__ = [
    "extend",
    "bincount_tiles",
    "clip_histograms",
    "blend",
    "tile_histograms",
    "tile_histograms_ref",
    "build_luts",
    "build_luts_ref",
    "launch_floor",
    "clahe_interpolate",
    "clahe_interpolate_ref",
    "clahe_interp_and_hist",
    "clahe_interp_and_hist_ref",
    "fused_interp_hist_fits",
    "fused_rows_per_block",
    "fused_vec",
    "interior_tiles",
    "hist_slices",
    "tile_hist_args",
    "batched_hist_args",
    "tile_hist_vec",
    "interp_vec",
    "interp_rows_per_block",
    "PackSpec",
    "unit_major",
    "make_pack_spec",
    "build_lut_pack",
    "band_source_rows",
    "clahe_interpolate_band",
    "clahe_interpolate_band_ref",
    "clahe_interpolate_pack",
    "clahe_interpolate_pack_ref",
    "tile_histograms_batched",
    "tile_histograms_batched_ref",
    "launch_counts",
    "reset_launch_counts",
]

# K1 cuts each tile into row slices until the grid has about this many
# blocks: 8 per SM of an H100's 132
_HIST_TARGET_BLOCKS = 8 * 132
# K1's 16-byte loads in flight a thread (tile_hist_kernel<R>); K10 takes
# its batch_rows, one of _BATCH_ROWS
_HIST_LOADS = 4
_BATCH_ROWS = (2, 4, 8)
# K3 rows per block: as many as keep the grid at about _INTERP_TARGET_BLOCKS
# blocks (16 per SM: four waves or more of the five 256-thread blocks an SM
# holds at 48 registers), within [_INTERP_MIN_ROWS, _INTERP_MAX_ROWS]: a
# block stages its row pair's LUT pack ((tiles_x + 1) KB, from L2) once, so
# it maps at least a few full rows.  At 4K b4 that is 4 rows; on an H100
# (700 W) K3 took 0.0489 ms with 4 rows a block, 0.0503 with 8, 0.0536 with
# 2 and 0.0548 with 16 (scripts/torch_kernel_turns.py --interp-rows)
_INTERP_TARGET_BLOCKS = 16 * 132
_INTERP_MIN_ROWS = 4
_INTERP_MAX_ROWS = 32
# K7 runs on one frame at a time in the streaming step, so its grid is
# (range of rows, tile column): the rows per block are as many as
# _FUSED_PASSES passes of the block's 256 threads map in 16-byte units of
# two rows (48 at 4K: 384 blocks a frame), and fewer where the frames would
# otherwise give the grid fewer than about _FUSED_TARGET_BLOCKS blocks (2
# per SM of an H100's 132).  On an H100 (700 W) K7 took 0.0223 ms a 4K frame
# with 16 rows a block, 0.0220 with 24, 0.0211 with 32, 0.0207 with 48 and
# 64 (scripts/torch_kernel_turns.py --fused-rows): a block stages its 2 KB
# and folds its 8 KB of bins once, so it maps several passes
_THREADS = 256
_FUSED_PASSES = 3
_FUSED_TARGET_BLOCKS = 2 * 132


# ------------------------------------------------------------ plain math ----


def extend(y: torch.Tensor, plan) -> torch.Tensor:
    """Reflect-101 extension of (..., H, W) frames to the tile-divisible size.

    ``reflect101_indices`` also covers a pad at least as large as the
    dimension (OpenCV's multi-reflection), which ``jnp.pad`` cannot."""
    if not (plan.pad_bottom or plan.pad_right):
        return y
    rows = torch.from_numpy(
        reflect101_indices(plan.height + plan.pad_bottom, plan.height)).to(y.device)
    cols = torch.from_numpy(
        reflect101_indices(plan.width + plan.pad_right, plan.width)).to(y.device)
    return y.index_select(-2, rows).index_select(-1, cols)


def clip_histograms(hists: torch.Tensor, clip: int | torch.Tensor) -> torch.Tensor:
    """OpenCV's single-pass clip and redistribution over the last axis
    (``clip`` an int, or a tensor that broadcasts against ``hists``).

    The excess above ``clip`` is shared as ``excess // 256`` to every bin;
    the residual goes one count at a time with stride
    ``max(256 // residual, 1)`` from bin 0 (ops/clahe.py _clip_histograms)."""
    clipped = (hists - clip).clamp_min(0).sum(dim=-1, keepdim=True,
                                              dtype=torch.int32)
    redist = clipped // 256
    residual = clipped - redist * 256
    step = (256 // residual.clamp_min(1)).clamp_min(1)
    bins = torch.arange(256, dtype=torch.int32, device=hists.device)
    bump = (bins % step == 0) & (bins // step < residual)
    return hists.clamp_max(clip) + redist + bump.to(torch.int32)


def bincount_tiles(ext: torch.Tensor, tiles_y: int, tiles_x: int,
                   tile_h: int, tile_w: int) -> torch.Tensor:
    """(N, tiles_y*tile_h, tiles_x*tile_w) uint8 -> (N, T, 256) int64
    histograms of its tiles, in row-major tile order: one ``bincount``."""
    n = ext.shape[0]
    num_tiles = tiles_y * tiles_x
    tiles = (ext.reshape(n, tiles_y, tile_h, tiles_x, tile_w)
             .permute(0, 1, 3, 2, 4)
             .reshape(n * num_tiles, tile_h * tile_w))
    offsets = torch.arange(n * num_tiles, device=ext.device)[:, None] * 256
    hists = torch.bincount((tiles.long() + offsets).reshape(-1),
                           minlength=n * num_tiles * 256)
    return hists.reshape(n, num_tiles, 256)


def _band_ext_rows(plan, tile_rows: tuple[int, int]) -> np.ndarray:
    """The frame row behind every extended row of the plan's tile rows
    [ty0, ty1): reflect-101 sources for the rows of the bottom pad."""
    ty0, ty1 = tile_rows
    return reflect101_indices(plan.height + plan.pad_bottom,
                              plan.height)[ty0 * plan.tile_h:ty1 * plan.tile_h]


def band_source_rows(plan, tile_rows: tuple[int, int]) -> tuple[int, int]:
    """The frame rows [lo, hi) that the histograms of the plan's tile rows
    [ty0, ty1) read.  With a bottom pad the last tile row mirrors rows that
    may lie above its own first row."""
    rows = _band_ext_rows(plan, tile_rows)
    if not rows.size:
        return 0, 0
    return int(rows.min()), int(rows.max()) + 1


def tile_histograms_ref(y: torch.Tensor, plan, rowstep: int = 1,
                        tile_rows: tuple[int, int] | None = None,
                        slab_row0: int = 0) -> torch.Tensor:
    """Plain version of :func:`tile_histograms`: ``bincount`` over tiles."""
    if tile_rows is None:
        tile_rows = (0, plan.tiles_y)
    rows = torch.from_numpy(_band_ext_rows(plan, tile_rows) - slab_row0).to(y.device)
    cols = torch.from_numpy(
        reflect101_indices(plan.width + plan.pad_right, plan.width)).to(y.device)
    ext = y.index_select(-2, rows).index_select(-1, cols)
    if rowstep > 1:
        ext = ext[:, ::rowstep]
    hists = bincount_tiles(ext, tile_rows[1] - tile_rows[0], plan.tiles_x,
                           plan.tile_h // rowstep, plan.tile_w)
    return (hists * rowstep).to(torch.int32)


def _check_clips(clip: torch.Tensor, hists: torch.Tensor) -> None:
    """A per-frame clip is an int32 (N,) tensor on the histograms' device:
    the kernel reads one entry per frame, so any other length would read
    out of bounds or leave frames without one."""
    if clip.dtype != torch.int32:
        raise ValueError(f"clip must be int32, got {clip.dtype}")
    if tuple(clip.shape) != (hists.shape[0],):
        raise ValueError(f"clip must have shape ({hists.shape[0]},), one per "
                         f"frame, got {tuple(clip.shape)}")
    if clip.device != hists.device:
        raise ValueError(f"clip on {clip.device}, hists on {hists.device}")


def build_luts_ref(hists: torch.Tensor, clip: int | torch.Tensor,
                   lut_scale: float) -> torch.Tensor:
    """Plain version of :func:`build_luts`: clip, int32 cumsum, f32 scale,
    round half to even (``torch.round``, like ``jnp.rint``)."""
    if isinstance(clip, torch.Tensor):
        c = clip[:, None, None]
        hists = torch.where(c > 0, clip_histograms(hists, c), hists)
    elif clip > 0:
        hists = clip_histograms(hists, clip)
    cdf = torch.cumsum(hists, dim=-1, dtype=torch.int32)
    scale = torch.tensor(lut_scale, dtype=torch.float32, device=hists.device)
    return torch.round(cdf.to(torch.float32) * scale).clamp(0, 255).to(torch.uint8)


def blend(l11: torch.Tensor, l12: torch.Tensor, l21: torch.Tensor,
          l22: torch.Tensor, xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """The bilinear blend of four f32 LUT values as separate eager
    multiplies and adds, so every product rounds to f32 before its add
    (OpenCV's order, ops/clahe.py _blend), then round half to even."""
    xa1 = 1.0 - xa
    ya1 = 1.0 - ya
    r1 = l11 * xa1 + l12 * xa
    r2 = l21 * xa1 + l22 * xa
    res = r1 * ya1 + r2 * ya
    return torch.round(res).clamp(0, 255).to(torch.uint8)


def live_rows(rows: int, height: int, row0: int) -> int:
    """How many of a band's ``rows`` rows, the first at global row ``row0``,
    lie inside a frame of ``height`` rows."""
    return max(0, min(rows, height - row0))


def clahe_interpolate_band_ref(y_band: torch.Tensor, luts: torch.Tensor,
                               plan, row0: int) -> torch.Tensor:
    """Plain version of :func:`clahe_interpolate_band`: the plan's row
    arrays sliced at ``row0``, four gathers at the per-pixel tile indices,
    then :func:`blend` (``ops/clahe._interpolate_rows`` of the JAX package).
    Rows at or beyond the frame's height come back unchanged."""
    n, rows, _ = y_band.shape
    live = live_rows(rows, plan.height, row0)
    ty1, ty2, ya, tx1, tx2, xa = plan.device_arrays(y_band.device)
    ty1, ty2, ya = (a[row0:row0 + live, None] for a in (ty1, ty2, ya))
    flat = luts.reshape(-1)
    v = y_band[:, :live].long() + (torch.arange(n, device=y_band.device)
                                   * (plan.num_tiles * 256))[:, None, None]

    def lookup(tyr, txc):
        return flat[(tyr * plan.tiles_x + txc).long() * 256 + v].to(torch.float32)

    res = blend(lookup(ty1, tx1), lookup(ty1, tx2), lookup(ty2, tx1),
                lookup(ty2, tx2), xa, ya)
    return res if live == rows else torch.cat([res, y_band[:, live:]], dim=1)


def clahe_interpolate_ref(y: torch.Tensor, luts: torch.Tensor,
                          plan) -> torch.Tensor:
    """Plain version of :func:`clahe_interpolate`: the band version over
    the whole frame."""
    return clahe_interpolate_band_ref(y, luts, plan, 0)


# ------------------------------------------- the LUT pack (K3, K5, K7) ----


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static geometry of the pack interpolation (K3, K5, K3v1 and K7),
    the Hopper form of the JAX package's ``NaturalSpec`` (variant 1).

    Row r lies in row pair ``rp_of_r[r]`` (tile rows clip(rp-1), clip(rp)),
    column c in group ``g_of_c[c]`` likewise; ``pack_idx[rp, g]`` holds the
    flat tile ids of the four LUTs (l11, l12, l21, l22) that apply there.
    ``ya`` and ``xa`` are the plan's f32 weights.  ``device_arrays`` caches
    the arrays as tensors, once per device, and so do ``unit_tables`` and
    ``device_row_ranges`` (the column tables by unit and the blocks of K3,
    K5 and K7)."""

    height: int
    width: int
    tiles_x: int
    tiles_y: int
    rp_of_r: np.ndarray       # int32[H]
    ya: np.ndarray            # float32[H]
    g_of_c: np.ndarray        # int32[W]
    xa: np.ndarray            # float32[W]
    pack_idx: np.ndarray      # int64 (R, G, 4)
    _device_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def groups(self) -> int:
        return self.tiles_x + 1

    @property
    def row_pairs(self) -> int:
        return self.tiles_y + 1

    def device_arrays(self, device) -> tuple[torch.Tensor, ...]:
        """(rp_of_r, ya, g_of_c, xa, pack_idx) on ``device``."""
        device = torch.device(device)
        arrays = self._device_cache.get(device)
        if arrays is None:
            arrays = tuple(torch.from_numpy(a).to(device)
                           for a in (self.rp_of_r, self.ya, self.g_of_c,
                                     self.xa, self.pack_idx))
            self._device_cache[device] = arrays
        return arrays

    def row_ranges(self, rows_per_block: int, tile_h: int | None = None,
                   span: tuple[int, int] | None = None) -> np.ndarray:
        """K3's blocks: (B, 2) int32 [start, end) rows in order, the rows
        of each row pair cut into ceil(len / rows_per_block) ranges whose
        lengths differ by at most one, so no range leaves its row pair.
        With ``tile_h`` (K7's blocks) the rows are also cut at every
        multiple of ``tile_h``, so no range leaves its tile row either.
        With ``span=(lo, hi)`` (K5's blocks on a band) only the global rows
        [lo, hi) are cut, the first range starting at ``lo`` even inside a
        row pair; the whole frame is ``(0, height)``."""
        first, last = (0, self.height) if span is None else span
        if not 0 <= first <= last <= self.height:
            raise ValueError(f"span {span} outside the plan's {self.height} rows")
        cuts = set(np.flatnonzero(np.diff(self.rp_of_r)) + 1)
        if tile_h is not None:
            cuts |= set(range(tile_h, self.height, tile_h))
        bounds = np.array([first, *sorted(c for c in cuts if first < c < last),
                           last])
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi == lo:        # an empty span
                continue
            n = -(-(hi - lo) // rows_per_block)
            edges = lo + np.arange(n + 1) * (hi - lo) // n
            parts.append(np.stack([edges[:-1], edges[1:]], axis=1))
        if not parts:
            return np.zeros((0, 2), np.int32)
        return np.concatenate(parts).astype(np.int32)

    def unit_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """K3's and K7's column tables by 16-pixel unit, (g_of_c, xa) each
        as a (4, W // 16, 4) tensor on ``device`` (:func:`unit_major`).  The
        same int32 and f32 values as the plan's, reordered."""
        key = (torch.device(device), "unit_tables")
        tables = self._device_cache.get(key)
        if tables is None:
            tables = tuple(torch.from_numpy(unit_major(a)).to(key[0])
                           for a in (self.g_of_c, self.xa))
            self._device_cache[key] = tables
        return tables

    def device_row_ranges(self, device, rows_per_block: int,
                          tile_h: int | None = None,
                          span: tuple[int, int] | None = None) -> torch.Tensor:
        """:meth:`row_ranges` on ``device``, cached with the arrays."""
        key = (torch.device(device), "row_ranges", rows_per_block, tile_h, span)
        ranges = self._device_cache.get(key)
        if ranges is None:
            ranges = torch.from_numpy(
                self.row_ranges(rows_per_block, tile_h, span)).to(key[0])
            self._device_cache[key] = ranges
        return ranges


def unit_major(a: np.ndarray) -> np.ndarray:
    """A per-column table (W,) reordered by 16-pixel unit, (4, W // 16, 4):
    entry [j, u, k] is column 16*u + 4*j + k, so the lanes of a warp that
    map consecutive units read consecutive 16-byte pieces.  The columns past
    the last whole unit are left out."""
    units = a.shape[0] // 16
    return np.ascontiguousarray(
        a[:units * 16].reshape(units, 4, 4).transpose(1, 0, 2))


def _pair_ids(lo: np.ndarray, hi: np.ndarray, tiles: int) -> np.ndarray:
    """Map per-pixel (clip(p-1), clip(p)) index pairs back to p, and check
    against the plan's own arrays that nothing was lost."""
    p = np.where((lo == 0) & (hi == 0), 0, lo + 1).astype(np.int32)
    if not (np.array_equal(np.clip(p - 1, 0, tiles - 1), lo)
            and np.array_equal(np.clip(p, 0, tiles - 1), hi)):
        raise ValueError("the plan's tile indices do not follow the "
                         "(clip(p-1), clip(p)) pattern")
    return p


@functools.lru_cache(maxsize=64)
def make_pack_spec(height: int, width: int, clip_limit: float,
                   tile_grid: tuple[int, int]) -> PackSpec:
    """The pack geometry of a CLAHE plan (every geometry has one: the TPU's
    width cap has no counterpart here)."""
    # ops.clahe imports this module, so its plan builder is imported here
    from opencv_opencl_tpu_torch.ops.clahe import make_clahe_plan

    plan = make_clahe_plan(height, width, clip_limit, tile_grid)
    tx, ty = plan.tiles_x, plan.tiles_y
    lo_y = np.clip(np.arange(ty + 1) - 1, 0, ty - 1)[:, None]
    hi_y = np.clip(np.arange(ty + 1), 0, ty - 1)[:, None]
    lo_x = np.clip(np.arange(tx + 1) - 1, 0, tx - 1)[None, :]
    hi_x = np.clip(np.arange(tx + 1), 0, tx - 1)[None, :]
    pack_idx = np.stack(
        [np.broadcast_to(a * tx + b, (ty + 1, tx + 1))
         for a, b in ((lo_y, lo_x), (lo_y, hi_x), (hi_y, lo_x), (hi_y, hi_x))],
        axis=-1).astype(np.int64)
    return PackSpec(
        height=height, width=width, tiles_x=tx, tiles_y=ty,
        rp_of_r=_pair_ids(plan.ty1, plan.ty2, ty), ya=plan.ya,
        g_of_c=_pair_ids(plan.tx1, plan.tx2, tx), xa=plan.xa,
        pack_idx=pack_idx)


def _pack_spec_of(plan) -> PackSpec:
    return make_pack_spec(plan.height, plan.width, plan.clip_limit,
                          (plan.tiles_x, plan.tiles_y))


def build_lut_pack(luts: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """(N, T, 256) uint8 LUTs -> the interleaved pack (N, R, G, 256, 4)
    uint8: ``pack[n, rp, g, v]`` holds the four LUT entries (l11, l12, l21,
    l22) at value v for row pair rp and column group g, so the kernel reads
    them as one 32-bit word.  A gather and a permute, as the JAX package
    builds its pack with ``jnp.take`` outside the kernel."""
    pack_idx = spec.device_arrays(luts.device)[4]
    return luts[:, pack_idx].permute(0, 1, 2, 4, 3).contiguous()


def clahe_interpolate_pack_ref(y: torch.Tensor, luts: torch.Tensor,
                               plan) -> torch.Tensor:
    """Plain version of :func:`clahe_interpolate_pack`: the four LUT
    entries gathered from the pack at each pixel's (row pair, group,
    value), then :func:`blend`."""
    spec = _pack_spec_of(plan)
    rp_of_r, ya, g_of_c, xa, _ = spec.device_arrays(y.device)
    pack = build_lut_pack(luts, spec)
    n = torch.arange(y.shape[0], device=y.device)[:, None, None]
    four = pack[n, rp_of_r.long()[None, :, None], g_of_c.long()[None, None, :],
                y.long()].to(torch.float32)        # (N, H, W, 4)
    return blend(four[..., 0], four[..., 1], four[..., 2], four[..., 3], xa,
                 ya[:, None])


def clahe_interp_and_hist_ref(y: torch.Tensor, luts: torch.Tensor,
                              plan) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`clahe_interp_and_hist`: the blend with the
    given LUTs, and the tile histograms of the same frames."""
    return clahe_interpolate_ref(y, luts, plan), tile_histograms_ref(y, plan)


# -------------------------------------------------------------- wrappers ----


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for others."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _check_band(y: torch.Tensor, width: int, name: str = "y_band") -> None:
    """A band of frames: (N, rows, W) uint8 with the plan's width and unit
    column stride."""
    _check(y, name, torch.uint8, 3)
    if y.shape[2] != width:
        raise ValueError(f"{name} is {y.shape[2]} wide, the plan {width}")
    if y.stride(2) != 1 and width > 1:
        raise ValueError(f"{name} must have unit column stride, got "
                         f"strides {y.stride()}")


def _check_frames(y: torch.Tensor, plan, name: str = "y") -> None:
    _check(y, name, torch.uint8, 3)
    if tuple(y.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"{name} frames are {tuple(y.shape[1:])}, plan is "
                         f"({plan.height}, {plan.width})")
    _check_band(y, plan.width, name)


def _aligned16(*values: int) -> bool:
    return all(v % 16 == 0 for v in values)


def interior_tiles(plan) -> tuple[int, int]:
    """(rows, cols): the plan's tile rows [0, rows) and tile columns
    [0, cols) lie inside the frame, so K1 counts them without reflect-101
    index math (padding is only ever at the bottom and the right)."""
    return (min(plan.tiles_y, plan.height // plan.tile_h),
            min(plan.tiles_x, plan.width // plan.tile_w))


def hist_slices(frames: int, tiles: int, rows: int) -> int:
    """K1's row slices per tile for ``frames`` frames of ``tiles`` tiles of
    ``rows`` counted rows: enough blocks for about ``_HIST_TARGET_BLOCKS``,
    at most one slice a row."""
    return max(1, min(rows, -(-_HIST_TARGET_BLOCKS // (frames * tiles))))


# the arguments of tile_hist_launch between the frame count and `out`
_TILE_HIST_ARGS = ("height", "width", "frame_stride", "row_stride",
                   "tile_rows", "tiles_x", "tile_h", "tile_w", "rowstep",
                   "slices", "ty0", "slab_row0", "inner_rows", "inner_cols",
                   "vec", "loads")


def tile_hist_args(y: torch.Tensor, plan, rowstep: int = 1,
                   tile_rows: tuple[int, int] | None = None,
                   slab_row0: int = 0) -> dict[str, int]:
    """K1's launch over (N, rows, W) frames or a slab of them (see
    :func:`tile_histograms`), by the names of ``tile_hist_launch``'s
    arguments: the plan's geometry, :func:`hist_slices`, the interior
    tiles, :func:`tile_hist_vec` and ``_HIST_LOADS`` loads in flight."""
    ty0, ty1 = (0, plan.tiles_y) if tile_rows is None else tile_rows
    inner_rows, inner_cols = interior_tiles(plan)
    return {
        "height": plan.height, "width": plan.width,
        "frame_stride": y.stride(0), "row_stride": y.stride(1),
        "tile_rows": ty1 - ty0, "tiles_x": plan.tiles_x, "tile_h": plan.tile_h,
        "tile_w": plan.tile_w, "rowstep": rowstep,
        "slices": hist_slices(y.shape[0], (ty1 - ty0) * plan.tiles_x,
                              plan.tile_h // rowstep),
        "ty0": ty0, "slab_row0": slab_row0, "inner_rows": inner_rows,
        "inner_cols": inner_cols, "vec": int(tile_hist_vec(y, plan)),
        "loads": _HIST_LOADS,
    }


def batched_hist_args(ext: torch.Tensor, tiles_y: int, tiles_x: int,
                      tile_h: int, tile_w: int, batch_rows: int) -> dict[str, int]:
    """K10's launch of K1's kernel on (N, He, We) frames already extended
    to ``tiles_y`` x ``tiles_x`` tiles of ``tile_h`` x ``tile_w``, by the
    names of ``tile_hist_launch``'s arguments: the frame is its own
    extension (its height and width are the tile multiples), so every tile
    is interior; one rowstep, no band; K1's slices; the 16-byte path when
    the base, both strides and the tile width are multiples of 16 (as
    :func:`tile_hist_vec`); ``batch_rows`` (2, 4 or 8) loads in flight."""
    _check_batch_rows(batch_rows)
    return {
        "height": tiles_y * tile_h, "width": tiles_x * tile_w,
        "frame_stride": ext.stride(0), "row_stride": ext.stride(1),
        "tile_rows": tiles_y, "tiles_x": tiles_x, "tile_h": tile_h,
        "tile_w": tile_w, "rowstep": 1,
        "slices": hist_slices(ext.shape[0], tiles_y * tiles_x, tile_h),
        "ty0": 0, "slab_row0": 0, "inner_rows": tiles_y, "inner_cols": tiles_x,
        "vec": int(_aligned16(ext.data_ptr(), ext.stride(0), ext.stride(1),
                              tile_w)),
        "loads": batch_rows,
    }


def _check_batch_rows(batch_rows: int) -> None:
    if batch_rows not in _BATCH_ROWS:
        raise ValueError(
            f"batch_rows must be one of (2, 4, 8), got {batch_rows}")


def tile_hist_vec(y: torch.Tensor, plan) -> bool:
    """Whether K1 reads the interior tiles of ``y`` with 16-byte loads:
    the base, both strides and the tile width are multiples of 16."""
    return _aligned16(y.data_ptr(), y.stride(0), y.stride(1), plan.tile_w)


def interp_vec(y: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether K3 maps whole 16-byte units (the columns past a row's last
    whole unit take its byte path): both bases and all four strides are
    multiples of 16."""
    return _aligned16(y.data_ptr(), y.stride(0), y.stride(1),
                      out.data_ptr(), out.stride(0), out.stride(1))


def interp_rows_per_block(frames: int, height: int) -> int:
    """K3's rows per block for ``frames`` frames of ``height`` rows."""
    return max(_INTERP_MIN_ROWS, min(_INTERP_MAX_ROWS,
                                     frames * height // _INTERP_TARGET_BLOCKS))


def _raise_on(err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def tile_histograms(y: torch.Tensor, plan, rowstep: int = 1,
                    tile_rows: tuple[int, int] | None = None,
                    slab_row0: int = 0) -> torch.Tensor:
    """(N, H, W) uint8 frames -> (N, T, 256) int32 tile histograms of the
    reflect-101 extended frames; ``rowstep > 1`` counts every rowstep-th row
    of each tile and scales the counts by rowstep (the approximate mode).

    With ``tile_rows=(ty0, ty1)`` only those tile rows of the plan are
    counted, (N, (ty1-ty0)*tiles_x, 256), and ``y`` is a slab of the frames
    whose first row is frame row ``slab_row0``; it must hold every row the
    band reads (:func:`band_source_rows`)."""
    if tile_rows is None and slab_row0 == 0:
        _check_frames(y, plan)
        tile_rows = (0, plan.tiles_y)
    else:
        _check_band(y, plan.width, "y")
        tile_rows = (0, plan.tiles_y) if tile_rows is None else tuple(tile_rows)
        if not 0 <= tile_rows[0] <= tile_rows[1] <= plan.tiles_y:
            raise ValueError(f"tile_rows {tile_rows} outside the plan's "
                             f"{plan.tiles_y} tile rows")
        lo, hi = band_source_rows(plan, tile_rows)
        if hi > lo and not (slab_row0 <= lo and hi <= slab_row0 + y.shape[1]):
            raise ValueError(
                f"tile rows {tile_rows} read frame rows [{lo}, {hi}); the slab "
                f"holds [{slab_row0}, {slab_row0 + y.shape[1]})")
    if rowstep < 1 or plan.tile_h % rowstep:
        raise ValueError(f"rowstep={rowstep} must divide tile_h ({plan.tile_h})")
    if not _on_card(y):
        return tile_histograms_ref(y, plan, rowstep, tile_rows, slab_row0)
    n = y.shape[0]
    tiles = (tile_rows[1] - tile_rows[0]) * plan.tiles_x
    out = torch.zeros((n, tiles, 256), dtype=torch.int32, device=y.device)
    if n == 0 or tiles == 0:
        return out
    _tile_hist(y, out, tile_hist_args(y, plan, rowstep, tile_rows, slab_row0))
    tile_histograms.launches += 1
    return out


def _tile_hist(y: torch.Tensor, out: torch.Tensor, args: dict[str, int]) -> None:
    """Launch ``tile_hist_kernel<args["loads"]>`` on the card over the
    frames ``y`` into the zeroed histograms ``out`` (K1 and K10)."""
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.tile_hist_launch(
            y.data_ptr(), y.shape[0], *(args[k] for k in _TILE_HIST_ARGS),
            out.data_ptr(), _stream(y.device))
    _raise_on(err, "tile_hist_kernel")


def build_luts(hists: torch.Tensor, clip: int | torch.Tensor,
               lut_scale: float) -> torch.Tensor:
    """(N, T, 256) int32 histograms -> (N, T, 256) uint8 LUTs: clip at
    ``clip`` (0 = no clipping) with OpenCV's redistribution, inclusive int32
    cumsum, ``clip(rint(cdf * lut_scale), 0, 255)`` with f32 ``lut_scale``.

    ``clip`` is one host int for every frame, or an int32 (N,) tensor on the
    histograms' device with one clip per frame (auto-CLAHE: the clip never
    leaves the device)."""
    _check(hists, "hists", torch.int32, 3)
    if hists.shape[-1] != 256:
        raise ValueError(f"hists must have 256 bins, got {tuple(hists.shape)}")
    per_frame = isinstance(clip, torch.Tensor)
    if per_frame:
        _check_clips(clip, hists)
    if not _on_card(hists):
        return build_luts_ref(hists, clip, lut_scale)
    if not hists.is_contiguous() or hists.data_ptr() % 16:
        raise ValueError("hists must be contiguous and 16-byte aligned")
    if per_frame and not clip.is_contiguous():
        raise ValueError("clip must be contiguous")
    lib = _build.load()
    luts = torch.empty(hists.shape, dtype=torch.uint8, device=hists.device)
    rows = hists.shape[0] * hists.shape[1]
    if rows:
        with torch.cuda.device(hists.device):
            err = lib.build_luts_launch(
                hists.data_ptr(), rows, 0 if per_frame else int(clip),
                clip.data_ptr() if per_frame else None, hists.shape[1],
                float(lut_scale), luts.data_ptr(), _stream(hists.device))
        _raise_on(err, "build_luts_kernel")
        build_luts.launches += 1
    return luts


def launch_floor(hists: torch.Tensor) -> None:
    """Launch an empty kernel with the grid :func:`build_luts` gives
    ``hists`` (a CUDA tensor): the card's floor for such a launch, timed
    beside K2.  Counted nowhere; no path calls it."""
    lib = _build.load()
    with torch.cuda.device(hists.device):
        err = lib.launch_floor_launch(hists.shape[0] * hists.shape[1],
                                      _stream(hists.device))
    _raise_on(err, "launch_floor_kernel")


def clahe_interpolate(y: torch.Tensor, luts: torch.Tensor, plan,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear blend of the four neighbouring tile LUTs at each pixel of
    (N, H, W) uint8 frames.  ``out`` (same shape, unit column stride) may be
    ``y`` itself: the kernel writes each pixel after reading it."""
    _check_frames(y, plan)
    _check(luts, "luts", torch.uint8, 3)
    if tuple(luts.shape) != (y.shape[0], plan.num_tiles, 256):
        raise ValueError(f"luts shape {tuple(luts.shape)} does not match "
                         f"{y.shape[0]} frames of {plan.num_tiles} tiles")
    if out is not None:
        _check_frames(out, plan, "out")
        if out.shape != y.shape or out.device != y.device:
            raise ValueError("out must match y in shape and device")
    if luts.device != y.device:
        raise ValueError(f"luts on {luts.device}, frames on {y.device}")
    if not _on_card(y):
        res = clahe_interpolate_ref(y, luts, plan)
        if out is None:
            return res
        return out.copy_(res)
    out, launched = _interpolate(y, luts, plan, 0, out)
    clahe_interpolate.launches += launched
    return out


def _check_luts(luts: torch.Tensor, y: torch.Tensor, plan) -> None:
    _check(luts, "luts", torch.uint8, 3)
    if tuple(luts.shape) != (y.shape[0], plan.num_tiles, 256):
        raise ValueError(f"luts shape {tuple(luts.shape)} does not match "
                         f"{y.shape[0]} frames of {plan.num_tiles} tiles")
    if luts.device != y.device:
        raise ValueError(f"luts on {luts.device}, frames on {y.device}")


def _interpolate(y: torch.Tensor, luts: torch.Tensor, plan, row0: int,
                 out: torch.Tensor | None) -> tuple[torch.Tensor, bool]:
    """Launch ``interp_kernel`` on the card over (N, rows, W) frames whose
    first row is global row ``row0`` (K3 and K3v1: 0; K5: its band's);
    returns the output and whether a launch was made (the callers count it).
    Rows at or beyond the frame's height are not written."""
    if not luts.is_contiguous() or luts.data_ptr() % 4:
        raise ValueError("luts must be contiguous and 4-byte aligned")
    lib = _build.load()
    n, rows, _ = y.shape
    live = live_rows(rows, plan.height, row0)
    if out is None:
        out = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
        if live < rows:
            out[:, live:].copy_(y[:, live:])
    if not (n and live and plan.width):
        return out, False
    spec = _pack_spec_of(plan)
    rp_of_r, ya, g_of_c, xa, _ = spec.device_arrays(y.device)
    g_units, xa_units = spec.unit_tables(y.device)
    ranges = spec.device_row_ranges(y.device, interp_rows_per_block(n, live),
                                    span=(row0, row0 + live))
    with torch.cuda.device(y.device):
        err = lib.interp_launch(
            y.data_ptr(), y.stride(0), y.stride(1), luts.data_ptr(), n,
            plan.width, plan.tiles_y, plan.tiles_x, ranges.data_ptr(),
            ranges.shape[0], rp_of_r.data_ptr(), ya.data_ptr(),
            g_of_c.data_ptr(), xa.data_ptr(), g_units.data_ptr(),
            xa_units.data_ptr(), out.data_ptr(), out.stride(0), out.stride(1),
            int(interp_vec(y, out)), row0, _stream(y.device))
    _raise_on(err, "interp_kernel")
    return out, True


def _check_band_out(out: torch.Tensor | None, y_band: torch.Tensor,
                    width: int) -> None:
    if out is not None:
        _check_band(out, width, "out")
        if out.shape != y_band.shape or out.device != y_band.device:
            raise ValueError("out must match y_band in shape and device")


def clahe_interpolate_band(y_band: torch.Tensor, luts: torch.Tensor, plan,
                           row0: int, out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """K3's blend on a band: (N, rows, W) uint8 whose first row is global
    row ``row0`` (any ``row0 >= 0``) of the plan's frames, with the whole
    frames' (N, T, 256) LUTs.  Rows at or beyond the frame's height are not
    written (with ``out=None`` they come back unchanged).  ``out`` may be
    ``y_band`` itself."""
    _check_band(y_band, plan.width)
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    _check_luts(luts, y_band, plan)
    _check_band_out(out, y_band, plan.width)
    if not _on_card(y_band):
        res = clahe_interpolate_band_ref(y_band, luts, plan, row0)
        return res if out is None else out.copy_(res)
    out, launched = _interpolate(y_band, luts, plan, row0, out)
    clahe_interpolate_band.launches += launched
    return out


def clahe_interpolate_pack(y: torch.Tensor, luts: torch.Tensor, plan,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`clahe_interpolate` in the JAX package's variant 1: whole
    (N, H, W) uint8 frames through K5's kernel at ``row0 = 0``, which is
    K3's.  K3's output, bit for bit.  ``out`` may be ``y`` itself."""
    _check_frames(y, plan)
    _check_luts(luts, y, plan)
    if out is not None:
        _check_frames(out, plan, "out")
        if out.shape != y.shape or out.device != y.device:
            raise ValueError("out must match y in shape and device")
    if not _on_card(y):
        res = clahe_interpolate_pack_ref(y, luts, plan)
        return res if out is None else out.copy_(res)
    out, launched = _interpolate(y, luts, plan, 0, out)
    clahe_interpolate_pack.launches += launched
    return out


def fused_interp_hist_fits(plan) -> bool:
    """Whether :func:`clahe_interp_and_hist` takes this geometry: no
    reflect-101 padding, the TPU kernel's contract."""
    return not (plan.pad_bottom or plan.pad_right)


def fused_vec(y: torch.Tensor, out: torch.Tensor, plan) -> bool:
    """Whether K7 maps 16-byte units: both bases and all four strides are
    multiples of 16 (:func:`interp_vec`), and so is the tile width, so that
    a unit never straddles a tile column."""
    return interp_vec(y, out) and plan.tile_w % 16 == 0


def fused_rows_per_block(frames: int, plan) -> int:
    """K7's rows per block for ``frames`` frames: as many as
    ``_FUSED_PASSES`` passes of the block's threads map, two rows of a
    16-byte unit each (48 at 4K), or fewer down to 2 where the grid of
    (range of rows, tile column) would otherwise have fewer than
    ``_FUSED_TARGET_BLOCKS`` blocks (32 at 1080p)."""
    passes = 2 * _FUSED_PASSES * max(1, _THREADS // max(1, plan.tile_w // 16))
    enough = frames * plan.tiles_x * plan.height // _FUSED_TARGET_BLOCKS
    return max(2, min(passes, enough, plan.tile_h))


def clahe_interp_and_hist(y: torch.Tensor, luts: torch.Tensor, plan,
                          out: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The streaming step's one pass over (N, H, W) uint8 frames: the
    bilinear blend with ``luts`` (the previous frame's) and the (N, T, 256)
    int32 tile histograms of ``y`` itself.  Tile-divisible geometry only
    (see :func:`fused_interp_hist_fits`); raises otherwise.  ``out`` may
    be ``y``: every pixel is counted before it is overwritten."""
    _check_frames(y, plan)
    _check(luts, "luts", torch.uint8, 3)
    if not fused_interp_hist_fits(plan):
        raise ValueError(
            f"clahe_interp_and_hist needs tile-divisible geometry; got "
            f"{plan.height}x{plan.width} on a {plan.tiles_x}x{plan.tiles_y} grid")
    if tuple(luts.shape) != (y.shape[0], plan.num_tiles, 256):
        raise ValueError(f"luts shape {tuple(luts.shape)} does not match "
                         f"{y.shape[0]} frames of {plan.num_tiles} tiles")
    if out is not None:
        _check_frames(out, plan, "out")
        if out.shape != y.shape or out.device != y.device:
            raise ValueError("out must match y in shape and device")
    if luts.device != y.device:
        raise ValueError(f"luts on {luts.device}, frames on {y.device}")
    if not _on_card(y):
        res, hists = clahe_interp_and_hist_ref(y, luts, plan)
        return (res if out is None else out.copy_(res)), hists
    if not luts.is_contiguous() or luts.data_ptr() % 4:
        raise ValueError("luts must be contiguous and 4-byte aligned")
    lib = _build.load()
    n = y.shape[0]
    if out is None:
        out = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
    hists = torch.zeros((n, plan.num_tiles, 256), dtype=torch.int32,
                        device=y.device)
    spec = _pack_spec_of(plan)
    rp_of_r, ya, g_of_c, xa, _ = spec.device_arrays(y.device)
    g_units, xa_units = spec.unit_tables(y.device)
    ranges = spec.device_row_ranges(
        y.device, fused_rows_per_block(n, plan), plan.tile_h)
    if n:
        with torch.cuda.device(y.device):
            err = lib.interp_hist_launch(
                y.data_ptr(), y.stride(0), y.stride(1), luts.data_ptr(), n,
                plan.width, plan.tiles_y, plan.tiles_x, plan.tile_h,
                plan.tile_w, ranges.data_ptr(), ranges.shape[0],
                rp_of_r.data_ptr(), ya.data_ptr(), g_of_c.data_ptr(),
                xa.data_ptr(), g_units.data_ptr(), xa_units.data_ptr(),
                out.data_ptr(), out.stride(0), out.stride(1),
                int(fused_vec(y, out, plan)), hists.data_ptr(),
                _stream(y.device))
        _raise_on(err, "interp_hist_kernel")
        clahe_interp_and_hist.launches += 1
    return out, hists


# ----------------------------------------------------------------- K10 ----


def tile_histograms_batched_ref(ext: torch.Tensor, tiles_y: int, tiles_x: int,
                                tile_h: int, tile_w: int) -> torch.Tensor:
    """Plain version of :func:`tile_histograms_batched`: ``bincount`` per
    tile (``batch_rows`` changes how the kernel walks, not what it counts)."""
    batch = ext if ext.ndim == 3 else ext[None]
    hists = bincount_tiles(batch, tiles_y, tiles_x, tile_h, tile_w).to(torch.int32)
    return hists if ext.ndim == 3 else hists[0]


def tile_histograms_batched(ext: torch.Tensor, tiles_y: int, tiles_x: int,
                            tile_h: int, tile_w: int,
                            batch_rows: int = 8) -> torch.Tensor:
    """An already reflect-extended, tile-divisible uint8 plane
    (tiles_y*tile_h, tiles_x*tile_w) -> (T, 256) int32 histograms of its
    tiles in row-major order, or (N, He, We) frames -> (N, T, 256): K1's
    counts, through K1's kernel with ``batch_rows`` (2, 4 or 8) 16-byte
    loads in flight a thread (:func:`batched_hist_args`)."""
    _check_batch_rows(batch_rows)
    if not isinstance(ext, torch.Tensor) or ext.ndim not in (2, 3):
        raise ValueError("ext must be a (He, We) or (N, He, We) tensor")
    batch = ext if ext.ndim == 3 else ext[None]
    _check_band(batch, tiles_x * tile_w, "ext")
    if batch.shape[1] != tiles_y * tile_h:
        raise ValueError(f"ext frames are {tuple(batch.shape[1:])}, not "
                         f"{tiles_y}x{tiles_x} tiles of {tile_h}x{tile_w}")
    if not _on_card(batch):
        return tile_histograms_batched_ref(ext, tiles_y, tiles_x, tile_h, tile_w)
    n = batch.shape[0]
    num_tiles = tiles_y * tiles_x
    out = torch.zeros((n, num_tiles, 256), dtype=torch.int32, device=ext.device)
    if n and num_tiles and tile_h and tile_w:
        _tile_hist(batch, out, batched_hist_args(batch, tiles_y, tiles_x, tile_h,
                                                 tile_w, batch_rows))
        tile_histograms_batched.launches += 1
    return out if ext.ndim == 3 else out[0]


_WRAPPERS = (tile_histograms, build_luts, clahe_interpolate,
             clahe_interp_and_hist, clahe_interpolate_band,
             clahe_interpolate_pack, tile_histograms_batched)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
