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
==================  ===================  =====================================

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
    "clahe_interpolate",
    "clahe_interpolate_ref",
    "clahe_interp_and_hist",
    "clahe_interp_and_hist_ref",
    "fused_interp_hist_fits",
    "launch_counts",
    "reset_launch_counts",
]

# K1 cuts each tile into row slices until the grid has about this many
# blocks: 8 per SM of an H100's 132
_HIST_TARGET_BLOCKS = 8 * 132
# K3 rows per block: the frame's LUTs are staged in shared memory once per
# block, so a block covers several full rows
_INTERP_ROWS_PER_BLOCK = 16
# K7 runs on one frame at a time in the streaming step, so its blocks split
# the frame's tile columns as well as its rows until the grid has about this
# many blocks: 4 per SM of an H100's 132
_FUSED_TARGET_BLOCKS = 4 * 132
# a K7 block keeps one 256-bin int32 histogram per tile column it covers in
# shared memory, within the 48 KB a block gets without opting in to more
_FUSED_MAX_TILES_PER_BLOCK = 48


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


def tile_histograms_ref(y: torch.Tensor, plan, rowstep: int = 1) -> torch.Tensor:
    """Plain version of :func:`tile_histograms`: ``bincount`` over tiles."""
    ext = extend(y, plan)
    if rowstep > 1:
        ext = ext[:, ::rowstep]
    hists = bincount_tiles(ext, plan.tiles_y, plan.tiles_x,
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


def clahe_interpolate_ref(y: torch.Tensor, luts: torch.Tensor,
                          plan) -> torch.Tensor:
    """Plain version of :func:`clahe_interpolate`: four gathers at the
    plan's per-pixel tile indices, then :func:`blend`."""
    n = y.shape[0]
    ty1, ty2, ya, tx1, tx2, xa = plan.device_arrays(y.device)
    ty1, ty2, ya = ty1[:, None], ty2[:, None], ya[:, None]
    flat = luts.reshape(-1)
    v = y.long() + (torch.arange(n, device=y.device)
                    * (plan.num_tiles * 256))[:, None, None]

    def lookup(tyr, txc):
        return flat[(tyr * plan.tiles_x + txc).long() * 256 + v].to(torch.float32)

    return blend(lookup(ty1, tx1), lookup(ty1, tx2), lookup(ty2, tx1),
                 lookup(ty2, tx2), xa, ya)


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


def _check_frames(y: torch.Tensor, plan, name: str = "y") -> None:
    _check(y, name, torch.uint8, 3)
    if tuple(y.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"{name} frames are {tuple(y.shape[1:])}, plan is "
                         f"({plan.height}, {plan.width})")
    if y.stride(2) != 1 and plan.width > 1:
        raise ValueError(f"{name} must have unit column stride, got "
                         f"strides {y.stride()}")


def _raise_on(err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def tile_histograms(y: torch.Tensor, plan, rowstep: int = 1) -> torch.Tensor:
    """(N, H, W) uint8 frames -> (N, T, 256) int32 tile histograms of the
    reflect-101 extended frames; ``rowstep > 1`` counts every rowstep-th row
    of each tile and scales the counts by rowstep (the approximate mode)."""
    _check_frames(y, plan)
    if rowstep < 1 or plan.tile_h % rowstep:
        raise ValueError(f"rowstep={rowstep} must divide tile_h ({plan.tile_h})")
    if not _on_card(y):
        return tile_histograms_ref(y, plan, rowstep)
    lib = _build.load()
    n = y.shape[0]
    out = torch.zeros((n, plan.num_tiles, 256), dtype=torch.int32, device=y.device)
    if n == 0:
        return out
    rows = plan.tile_h // rowstep
    slices = max(1, min(rows, -(-_HIST_TARGET_BLOCKS // (n * plan.num_tiles))))
    with torch.cuda.device(y.device):
        err = lib.tile_hist_launch(
            y.data_ptr(), n, plan.height, plan.width, y.stride(0), y.stride(1),
            plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w, rowstep,
            slices, out.data_ptr(), _stream(y.device))
    _raise_on(err, "tile_hist_kernel")
    tile_histograms.launches += 1
    return out


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
    if not hists.is_contiguous():
        raise ValueError("hists must be contiguous")
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
    if not luts.is_contiguous():
        raise ValueError("luts must be contiguous")
    lib = _build.load()
    if out is None:
        out = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
    ty1, ty2, ya, tx1, tx2, xa = plan.device_arrays(y.device)
    if y.shape[0]:
        with torch.cuda.device(y.device):
            err = lib.interp_launch(
                y.data_ptr(), y.stride(0), y.stride(1), luts.data_ptr(),
                y.shape[0], plan.height, plan.width, plan.tiles_y,
                plan.tiles_x, ty1.data_ptr(), ty2.data_ptr(), ya.data_ptr(),
                tx1.data_ptr(), tx2.data_ptr(), xa.data_ptr(), out.data_ptr(),
                out.stride(0), out.stride(1), _INTERP_ROWS_PER_BLOCK,
                _stream(y.device))
        _raise_on(err, "interp_kernel")
        clahe_interpolate.launches += 1
    return out


def fused_interp_hist_fits(plan) -> bool:
    """Whether :func:`clahe_interp_and_hist` takes this geometry: no
    reflect-101 padding, the TPU kernel's contract."""
    return not (plan.pad_bottom or plan.pad_right)


def _fused_grid(plan, frames: int) -> tuple[int, int]:
    """K7's (rows_per_block, tiles_per_block).  The rows are the largest
    divisor of tile_h up to 16, so that no block straddles a tile row (15
    for the 270 and 135 rows of 4K and 1080p); the tile columns are split
    into the fewest equal groups that bring the grid to
    ``_FUSED_TARGET_BLOCKS``."""
    rows = max(d for d in range(1, min(plan.tile_h, 16) + 1)
               if plan.tile_h % d == 0)
    row_blocks = plan.height // rows * frames
    for groups in range(1, plan.tiles_x + 1):
        per_block = plan.tiles_x // groups
        if (plan.tiles_x % groups == 0
                and per_block <= _FUSED_MAX_TILES_PER_BLOCK
                and row_blocks * groups >= _FUSED_TARGET_BLOCKS):
            return rows, per_block
    return rows, 1


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
    if not luts.is_contiguous():
        raise ValueError("luts must be contiguous")
    lib = _build.load()
    n = y.shape[0]
    if out is None:
        out = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
    hists = torch.zeros((n, plan.num_tiles, 256), dtype=torch.int32,
                        device=y.device)
    ty1, ty2, ya, tx1, tx2, xa = plan.device_arrays(y.device)
    rows, tiles_per_block = _fused_grid(plan, n)
    if n:
        with torch.cuda.device(y.device):
            err = lib.interp_hist_launch(
                y.data_ptr(), y.stride(0), y.stride(1), luts.data_ptr(), n,
                plan.height, plan.tiles_y, plan.tiles_x, plan.tile_h,
                plan.tile_w, ty1.data_ptr(), ty2.data_ptr(), ya.data_ptr(),
                tx1.data_ptr(), tx2.data_ptr(), xa.data_ptr(), out.data_ptr(),
                out.stride(0), out.stride(1), rows, tiles_per_block,
                hists.data_ptr(), _stream(y.device))
        _raise_on(err, "interp_hist_kernel")
        clahe_interp_and_hist.launches += 1
    return out, hists


_WRAPPERS = (tile_histograms, build_luts, clahe_interpolate,
             clahe_interp_and_hist)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
