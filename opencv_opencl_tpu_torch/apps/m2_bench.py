"""Method-comparison micro-bench (<- reference ``m2.cpp``).

Usage: python -m opencv_opencl_tpu_torch.apps.m2_bench <input.jpg> <output.jpg>
           [--device=cuda|cpu]

Counterpart of ``opencv_opencl_tpu/apps/m2_bench.py``: the same arguments,
printed lines, output file and return codes.  The reference compared
split/merge vs zero-copy Mat views to justify the zero-copy worker design
(``m2.cpp:42-85``, rationale for ``nextimprovement.cpp``).  Here METHOD 1
runs each stage on its own, with a ``torch.cuda.synchronize()`` after each
(split -> equalize -> merge), and METHOD 2 runs the same YUV pipeline as one
function with no synchronize until its end, where the JAX app runs one
jitted program.  Both equalize with K1 on a 1x1 grid and K4.

The app runs on the card: without a CUDA card it fails (return code 1)
unless ``--device=cpu`` names the kernels' plain versions (for tests).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from opencv_opencl_tpu_torch.apps._cli import pop_device_flag, resolve_device
from opencv_opencl_tpu_torch.apps.histeq_image import stage_clock
from opencv_opencl_tpu_torch.ops import color, histeq


def to_yuv(bgr: np.ndarray, device):
    """BGR (H, W, 3) uint8 on the host -> YUV (H, W, 3) on ``device``."""
    return color.bgr2yuv(torch.from_numpy(np.ascontiguousarray(bgr)), device=device)


def method1(yuv, device):
    """Staged: split, equalize and merge, each waited for; returns the merged
    YUV image and its microseconds."""
    now = stage_clock(device)
    t0 = now()
    y, u, v = yuv[..., 0].contiguous(), yuv[..., 1], yuv[..., 2]
    now()
    y_eq = histeq.equalize_hist(y, device=device)
    now()
    merged = torch.stack([y_eq, u, v], dim=-1)
    return merged, (now() - t0) * 1e6


def fused(yuv, device):
    """The whole YUV pipeline as one function, nothing waited for."""
    y_eq = histeq.equalize_hist(yuv[..., 0].contiguous(), device=device)
    return torch.stack([y_eq, yuv[..., 1], yuv[..., 2]], dim=-1)


def method2(yuv, device):
    """:func:`fused` after one warm-up call; returns its output and its
    microseconds up to the synchronize at its end."""
    now = stage_clock(device)
    fused(yuv, device)
    now()
    t0 = time.perf_counter()
    out = fused(yuv, device)
    return out, (now() - t0) * 1e6


def run(argv: list[str]) -> int:
    argv, device_name = pop_device_flag(argv)
    if len(argv) != 2:
        print(f"Usage: {sys.argv[0]} <input.jpg> <output.jpg>")
        return -1
    input_file, output_file = argv
    device = resolve_device(device_name)
    if device is None:
        return 1

    import cv2

    t_start = time.perf_counter()
    bgr = cv2.imread(input_file, cv2.IMREAD_COLOR)
    if bgr is None:
        print(f"Error: Could not load image {input_file}", file=sys.stderr)
        return -1
    print(f"Processing image: {bgr.shape[1]}x{bgr.shape[0]}")

    yuv = to_yuv(bgr, device)
    t_convert = stage_clock(device)()

    print("\n=== METHOD 1: staged dispatches (split/merge) ===")
    merged, m1_us = method1(yuv, device)

    print("\n=== METHOD 2: fused single-dispatch pipeline ===")
    _, m2_us = method2(yuv, device)

    result = color.yuv2bgr(merged, device=device).cpu().numpy()
    save_start = time.perf_counter()
    ok = cv2.imwrite(output_file, result)
    save_us = (time.perf_counter() - save_start) * 1e6
    if not ok:
        print("Error: Could not save image", file=sys.stderr)
        return -1
    print(f"\nEnhanced image saved to: {output_file}")

    convert_us = (t_convert - t_start) * 1e6
    total_us = (time.perf_counter() - t_start) * 1e6
    print("\n=== PERFORMANCE COMPARISON ===")
    print(f"Image loading + BGR->YUV:  {convert_us:.0f} μs")
    print(f"Method 1 (split/merge):    {m1_us:.0f} μs")
    print(f"Method 2 (fused jit):      {m2_us:.0f} μs")
    print(f"Saving result:             {save_us:.0f} μs")
    print(f"Total time:                {total_us:.0f} μs")
    print("\nPotential FPS (processing only):")
    print(f"Method 1: {1e6 / m1_us if m1_us > 0 else 0:.4f} fps")
    print(f"Method 2: {1e6 / m2_us if m2_us > 0 else 0:.4f} fps")
    if m1_us > 0 and m2_us > 0:
        print(f"Method 2 speedup: {m1_us / m2_us:.4f}x faster")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
