"""CLAHE on PyTorch tensors, OpenCV-exact, batched.

Counterpart of ``opencv_opencl_tpu/ops/clahe.py``.  CLAHE factors into a
*plan* (everything the frame geometry fixes: tile sizes, reflect-101
padding, the integer clip limit, per-axis interpolation indices and f32
weights), built once on the host in numpy with OpenCV's f32 arithmetic,
and an *apply* over that plan.

On a CUDA tensor, :func:`clahe_apply` runs three hand-written kernels
(``ops/cuda/natural.py``): tile histograms (K1), LUT build (K2) and the
bilinear interpolation (K3), or, with ``backend="pallas"``, the cell-grid
interpolation (K6, ``ops/cuda/lut.py``) in place of K3.  On a CPU tensor
the same wrappers run their plain PyTorch versions.  Either way the output
equals ``cv2.createCLAHE(clip, grid).apply`` exactly.

The plain versions live beside the kernels' wrappers, in
``ops/cuda/natural.py``; the JAX module's private functions map to them as
``_extend`` -> ``extend``, ``_tile_histograms`` -> ``tile_histograms_ref``,
``_clip_histograms`` -> ``clip_histograms``, ``_luts_from_hists`` ->
``build_luts_ref`` and ``_interpolate`` -> ``clahe_interpolate_ref``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from opencv_opencl_tpu_torch.ops.cuda import lut, natural

__all__ = ["ClahePlan", "make_clahe_plan", "plan_from_jax", "clahe_apply",
           "clahe", "CLAHE"]


@dataclasses.dataclass(frozen=True)
class ClahePlan:
    """Static CLAHE geometry and interpolation constants for one frame shape.

    The fields are those of the JAX package's ``ClahePlan``, with the same
    values and dtypes.  ``device_arrays`` caches the per-axis arrays as
    tensors, once per device."""

    height: int
    width: int
    tiles_x: int
    tiles_y: int
    clip_limit: float
    tile_h: int          # tile size in the padded image
    tile_w: int
    pad_bottom: int
    pad_right: int
    clip: int            # integer clip limit (0 = no clipping)
    lut_scale: float     # float32 255/tileArea
    ty1: np.ndarray      # int32[H] low tile row
    ty2: np.ndarray      # int32[H] high tile row
    ya: np.ndarray       # float32[H] row fraction
    tx1: np.ndarray      # int32[W]
    tx2: np.ndarray      # int32[W]
    xa: np.ndarray       # float32[W]

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tile_area(self) -> int:
        return self.tile_h * self.tile_w

    def device_arrays(self, device) -> tuple[torch.Tensor, ...]:
        """(ty1, ty2, ya, tx1, tx2, xa) on ``device``: the host-built int32
        and f32 values, copied as they are."""
        device = torch.device(device)
        # kept beside the fields, not among them: two plans of one geometry
        # stay equal field for field whether or not one has been used
        cache = self.__dict__.setdefault("_device_cache", {})
        arrays = cache.get(device)
        if arrays is None:
            arrays = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.ty1, self.ty2, self.ya, self.tx1, self.tx2,
                          self.xa))
            cache[device] = arrays
        return arrays


_PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(ClahePlan))


def _interp_coords(n: int, tile: int, tiles: int):
    """OpenCV-exact per-pixel tile coordinates: p*(1.0f/tile) - 0.5f in f32."""
    inv = np.float32(1.0) / np.float32(tile)
    f = (np.arange(n, dtype=np.float32) * inv - np.float32(0.5)).astype(np.float32)
    lo = np.floor(f).astype(np.int32)
    frac = (f - lo).astype(np.float32)
    return (
        np.clip(lo, 0, tiles - 1).astype(np.int32),
        np.clip(lo + 1, 0, tiles - 1).astype(np.int32),
        frac,
    )


@functools.lru_cache(maxsize=64)
def make_clahe_plan(
    height: int,
    width: int,
    clip_limit: float = 40.0,
    tile_grid: tuple[int, int] = (8, 8),
) -> ClahePlan:
    """Build the static plan for (height, width) frames.

    ``tile_grid`` is (tilesX, tilesY), OpenCV cv::Size argument order.
    """
    tiles_x, tiles_y = tile_grid
    if height % tiles_y == 0 and width % tiles_x == 0:
        pb = pr = 0
    else:
        # OpenCV pads with NO modulo wrap once either dim is non-divisible
        # (a divisible dim still gets a full extra tile) — see golden.py
        pb = tiles_y - height % tiles_y
        pr = tiles_x - width % tiles_x
    tile_h = (height + pb) // tiles_y
    tile_w = (width + pr) // tiles_x
    tile_area = tile_h * tile_w
    clip = max(int(clip_limit * tile_area / 256.0), 1) if clip_limit > 0 else 0
    lut_scale = float(np.float32(255.0) / np.float32(tile_area))
    ty1, ty2, ya = _interp_coords(height, tile_h, tiles_y)
    tx1, tx2, xa = _interp_coords(width, tile_w, tiles_x)
    return ClahePlan(
        height=height, width=width, tiles_x=tiles_x, tiles_y=tiles_y,
        clip_limit=clip_limit, tile_h=tile_h, tile_w=tile_w,
        pad_bottom=pb, pad_right=pr, clip=clip, lut_scale=lut_scale,
        ty1=ty1, ty2=ty2, ya=ya, tx1=tx1, tx2=tx2, xa=xa,
    )


def plan_from_jax(plan) -> ClahePlan:
    """The port's plan from the JAX package's ``ClahePlan``: its fields are
    ints, floats and numpy arrays, taken over unchanged (the f32 weights and
    ``lut_scale`` keep the exact values the host built)."""
    return ClahePlan(**{name: getattr(plan, name) for name in _PLAN_FIELDS})


def _check_method(method: str) -> None:
    """The histogram methods of the JAX package's ``hist256``; on the card
    both are the same kernel."""
    if method not in ("onehot", "scatter"):
        raise ValueError(f"unknown histogram method {method!r}")


def clahe_apply(y: torch.Tensor, plan: ClahePlan, method: str = "onehot",
                backend: str = "auto", hist_rowstep: int = 1,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """CLAHE one frame (H, W) or a batch (N, H, W) of uint8 against a plan.

    backend, as the JAX package maps it: "auto" and "natural" run tile
    histograms (K1), the LUT build (K2) and the interpolation (K3), which
    covers every width on the card; "pallas" runs K1, K2 and the cell-grid
    interpolation (K6), and raises ``ValueError`` on a geometry without a
    cell-grid spec (``ops/cuda/lut.make_interp_spec``); "xla" runs the
    three plain versions, wherever the frames are (only a caller who names
    it gets them).  Any other backend raises.  A batch is one launch per
    kernel.

    method: "onehot" or "scatter" (the JAX package's histogram methods;
    the same kernel here); anything else raises.

    hist_rowstep: 1 = exact (the default; bit-exact vs cv2).  N > 1 is the
    opt-in APPROXIMATE mode: tile histograms from every Nth row with the
    counts rescaled; the interpolation stays exact.  Requires
    ``tile_h % N == 0``.

    out: where to write the result (same shape as ``y``; may be ``y``
    itself, which the in-place NV12 step uses).
    """
    _check_method(method)
    if hist_rowstep != 1:
        if hist_rowstep < 1 or plan.tile_h % hist_rowstep:
            raise ValueError(
                f"hist_rowstep={hist_rowstep} must divide tile_h "
                f"({plan.tile_h})")
    if y.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (N, H, W), got {tuple(y.shape)}")
    frames = y if y.ndim == 3 else y.unsqueeze(0)
    dst = out if out is None or out.ndim == 3 else out.unsqueeze(0)
    if backend in ("auto", "natural", "pallas"):
        spec = None
        if backend == "pallas":
            spec = lut.make_interp_spec(plan.height, plan.width,
                                        plan.clip_limit,
                                        (plan.tiles_x, plan.tiles_y))
            if spec is None:
                raise ValueError(
                    f"geometry {plan.height}x{plan.width} grid "
                    f"{plan.tiles_x}x{plan.tiles_y} has no pallas fast path")
        hists = natural.tile_histograms(frames, plan, hist_rowstep)
        luts = natural.build_luts(hists, plan.clip, plan.lut_scale)
        if spec is None:
            res = natural.clahe_interpolate(frames, luts, plan, out=dst)
        else:
            res = lut.clahe_interpolate_cells(frames, luts, spec, out=dst)
    elif backend == "xla":
        hists = natural.tile_histograms_ref(frames, plan, hist_rowstep)
        luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
        res = natural.clahe_interpolate_ref(frames, luts, plan)
        if dst is not None:
            res = dst.copy_(res)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return res if y.ndim == 3 else res[0]


def clahe(
    y,
    clip_limit: float = 40.0,
    tile_grid: tuple[int, int] = (8, 8),
    method: str = "onehot",
    backend: str = "auto",
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """One-shot OpenCV-exact CLAHE of a tensor (or numpy array) (H, W) or
    (N, H, W), moved to ``device`` first; the plan is cached per frame
    shape.  ``method`` and ``backend`` as in :func:`clahe_apply`."""
    y = torch.as_tensor(y).to(device)
    plan = make_clahe_plan(y.shape[-2], y.shape[-1], float(clip_limit),
                           tuple(tile_grid))
    return clahe_apply(y, plan, method, backend)


class CLAHE:
    """cv2.createCLAHE-shaped stateful wrapper: construct once, apply per
    frame (the reference's reusable ``cv::Ptr<cv::CLAHE>``) on ``device``."""

    def __init__(self, clip_limit: float = 40.0,
                 tile_grid_size: tuple[int, int] = (8, 8),
                 device: str | torch.device = "cuda"):
        self.clip_limit = float(clip_limit)
        self.tile_grid_size = tuple(tile_grid_size)
        self.device = torch.device(device)

    def apply(self, y, method: str = "onehot"):
        return clahe(y, self.clip_limit, self.tile_grid_size, method,
                     device=self.device)

    # cv2 API parity
    def setClipLimit(self, v: float) -> None:
        self.clip_limit = float(v)

    def getClipLimit(self) -> float:
        return self.clip_limit

    def setTilesGridSize(self, v: tuple[int, int]) -> None:
        self.tile_grid_size = tuple(v)

    def getTilesGridSize(self) -> tuple[int, int]:
        return self.tile_grid_size
