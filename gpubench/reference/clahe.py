"""The plain CLAHE reference: OpenCV's ``createCLAHE(clipLimit,
tileGridSize).apply`` on a batch of uint8 frames, in plain PyTorch.

A frozen copy of the port's plain versions: the plan from
``opencv_opencl_tpu_torch/ops/clahe.py`` (``make_clahe_plan``,
``_interp_coords``), the histograms, the clip and LUT build and the blend
from ``opencv_opencl_tpu_torch/ops/cuda/natural.py`` (``reflect101_indices``,
``tile_histograms_ref``, ``bincount_tiles``, ``clip_histograms``,
``build_luts_ref``, ``blend``, ``clahe_interpolate_band_ref``).  It imports
nothing of the port.  ``blend_dtype`` is float32, OpenCV's precision;
bfloat16 is the lower-precision control that the comparison must fail.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Plan:
    height: int
    width: int
    tiles_x: int
    tiles_y: int
    tile_h: int
    tile_w: int
    pad_bottom: int
    pad_right: int
    clip: int
    lut_scale: float
    ty1: np.ndarray
    ty2: np.ndarray
    ya: np.ndarray
    tx1: np.ndarray
    tx2: np.ndarray
    xa: np.ndarray

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def _interp_coords(n: int, tile: int, tiles: int):
    """OpenCV-exact per-pixel tile coordinates: p*(1.0f/tile) - 0.5f in f32."""
    inv = np.float32(1.0) / np.float32(tile)
    f = (np.arange(n, dtype=np.float32) * inv - np.float32(0.5)).astype(np.float32)
    lo = np.floor(f).astype(np.int32)
    frac = (f - lo).astype(np.float32)
    return (np.clip(lo, 0, tiles - 1).astype(np.int32),
            np.clip(lo + 1, 0, tiles - 1).astype(np.int32), frac)


def make_plan(height: int, width: int, clip_limit: float,
              tile_grid: tuple[int, int]) -> Plan:
    """``tile_grid`` is (tilesX, tilesY), OpenCV's cv::Size order; a
    dimension that does not divide pads by reflect-101 as OpenCV does."""
    tiles_x, tiles_y = tile_grid
    if height % tiles_y == 0 and width % tiles_x == 0:
        pb = pr = 0
    else:
        pb = tiles_y - height % tiles_y
        pr = tiles_x - width % tiles_x
    tile_h, tile_w = (height + pb) // tiles_y, (width + pr) // tiles_x
    area = tile_h * tile_w
    clip = max(int(clip_limit * area / 256.0), 1) if clip_limit > 0 else 0
    ty1, ty2, ya = _interp_coords(height, tile_h, tiles_y)
    tx1, tx2, xa = _interp_coords(width, tile_w, tiles_x)
    return Plan(height, width, tiles_x, tiles_y, tile_h, tile_w, pb, pr, clip,
                float(np.float32(255.0) / np.float32(area)),
                ty1, ty2, ya, tx1, tx2, xa)


def _reflect101(n_ext: int, n: int) -> np.ndarray:
    i = np.arange(n_ext)
    if n == 1:
        return np.zeros(n_ext, np.int64)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i < n, i, period - i).astype(np.int64)


def tile_histograms(y: torch.Tensor, plan: Plan) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, T, 256) int32 tile histograms, one bincount."""
    rows = torch.from_numpy(_reflect101(plan.height + plan.pad_bottom,
                                        plan.height)).to(y.device)
    cols = torch.from_numpy(_reflect101(plan.width + plan.pad_right,
                                        plan.width)).to(y.device)
    ext = y.index_select(-2, rows).index_select(-1, cols)
    n, t = ext.shape[0], plan.num_tiles
    tiles = (ext.reshape(n, plan.tiles_y, plan.tile_h, plan.tiles_x, plan.tile_w)
             .permute(0, 1, 3, 2, 4).reshape(n * t, plan.tile_h * plan.tile_w))
    offsets = torch.arange(n * t, device=y.device)[:, None] * 256
    hists = torch.bincount((tiles.long() + offsets).reshape(-1),
                           minlength=n * t * 256)
    return hists.reshape(n, t, 256).to(torch.int32)


def clip_histograms(hists: torch.Tensor, clip: int) -> torch.Tensor:
    """OpenCV's single-pass clip: the excess shared as ``excess // 256`` a
    bin, the residual one count at a time with stride
    ``max(256 // residual, 1)`` from bin 0."""
    clipped = (hists - clip).clamp_min(0).sum(dim=-1, keepdim=True,
                                              dtype=torch.int32)
    redist = clipped // 256
    residual = clipped - redist * 256
    step = (256 // residual.clamp_min(1)).clamp_min(1)
    bins = torch.arange(256, dtype=torch.int32, device=hists.device)
    bump = (bins % step == 0) & (bins // step < residual)
    return hists.clamp_max(clip) + redist + bump.to(torch.int32)


def build_luts(hists: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Clip, int32 cumsum, f32 scale, round half to even."""
    if plan.clip > 0:
        hists = clip_histograms(hists, plan.clip)
    cdf = torch.cumsum(hists, dim=-1, dtype=torch.int32)
    scale = torch.tensor(plan.lut_scale, dtype=torch.float32, device=hists.device)
    return torch.round(cdf.to(torch.float32) * scale).clamp(0, 255).to(torch.uint8)


def interpolate(y: torch.Tensor, luts: torch.Tensor, plan: Plan,
                blend_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Four LUT gathers at each pixel's tiles, then OpenCV's bilinear blend
    as separate multiplies and adds (every product rounded before its add),
    round half to even."""
    dev, n = y.device, y.shape[0]

    def arr(a):
        return torch.from_numpy(a).to(dev)

    ty1, ty2, ya = arr(plan.ty1)[:, None], arr(plan.ty2)[:, None], arr(plan.ya)[:, None]
    tx1, tx2, xa = arr(plan.tx1), arr(plan.tx2), arr(plan.xa)
    flat = luts.reshape(-1)
    v = y.long() + (torch.arange(n, device=dev) * (plan.num_tiles * 256))[:, None, None]

    def lookup(tyr, txc):
        return flat[(tyr * plan.tiles_x + txc).long() * 256 + v].to(blend_dtype)

    xa, ya = xa.to(blend_dtype), ya.to(blend_dtype)
    xa1, ya1 = 1.0 - xa, 1.0 - ya
    r1 = lookup(ty1, tx1) * xa1 + lookup(ty1, tx2) * xa
    r2 = lookup(ty2, tx1) * xa1 + lookup(ty2, tx2) * xa
    res = r1 * ya1 + r2 * ya
    return torch.round(res.to(torch.float32)).clamp(0, 255).to(torch.uint8)


def clahe(y: torch.Tensor, plan: Plan,
          blend_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CLAHE of uint8 (N, H, W) frames."""
    return interpolate(y, build_luts(tile_histograms(y, plan), plan), plan,
                       blend_dtype)
