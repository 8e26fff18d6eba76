"""Single-frame histogram-equalization tool (<- reference ``singlecolor.cpp``).

Usage: python -m opencv_opencl_tpu_torch.apps.histeq_image <input.jpg> <output.jpg>
           [--device=cuda|cpu]

Counterpart of ``opencv_opencl_tpu/apps/histeq_image.py``: the same
arguments, printed lines, output file and return codes.  Flow and printout
mirror the reference (``singlecolor.cpp:15-110``): load -> BGR2YUV ->
split -> equalizeHist(Y) on the card (K1 on a 1x1 grid, then K4) -> merge
-> YUV2BGR -> save, with the per-stage microsecond breakdown and
"potential FPS".  Each stage ends with a ``torch.cuda.synchronize()``.

The app runs on the card: without a CUDA card it fails (return code 1)
unless ``--device=cpu`` names the kernels' plain versions (for tests).
:func:`enhance_bgr` holds everything between the read and the write, on
numpy in and out, so that it runs where cv2 does not.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from opencv_opencl_tpu_torch.apps._cli import pop_device_flag, resolve_device
from opencv_opencl_tpu_torch.ops import color, histeq

STAGES = ("yuv", "split", "eq", "merge", "bgr")


def stage_clock(device):
    """A function that waits for ``device`` and reads ``time.perf_counter``."""

    def now() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    return now


def enhance_bgr(bgr: np.ndarray, device) -> tuple[np.ndarray, dict[str, float]]:
    """BGR (H, W, 3) uint8 -> the equalized BGR image on the host, and the
    microseconds of each of :data:`STAGES` (the upload is part of the BGR->YUV
    stage and the download part of the YUV->BGR one, as in the JAX app)."""
    now = stage_clock(device)
    t = [now()]
    yuv = color.bgr2yuv(torch.from_numpy(np.ascontiguousarray(bgr)), device=device)
    t.append(now())
    y, u, v = yuv[..., 0].contiguous(), yuv[..., 1], yuv[..., 2]
    t.append(now())
    y_eq = histeq.equalize_hist(y, device=device)
    t.append(now())
    merged = torch.stack([y_eq, u, v], dim=-1)
    t.append(now())
    out = color.yuv2bgr(merged, device=device).cpu().numpy()
    t.append(now())
    return out, {name: (b - a) * 1e6 for name, a, b in zip(STAGES, t, t[1:])}


def run(argv: list[str]) -> int:
    argv, device_name = pop_device_flag(argv)
    if len(argv) != 2:
        print(f"Usage: {sys.argv[0]} <input.jpg> <output.jpg>")
        print(f"Example: {sys.argv[0]} input.jpg output_enhanced.jpg")
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
    print(f"Loaded image: {bgr.shape[1]}x{bgr.shape[0]}")
    t_load = time.perf_counter()

    out_np, stage_us = enhance_bgr(bgr, device)
    print(f"Y channel size: {bgr.shape[1]}x{bgr.shape[0]}")
    t_bgr = time.perf_counter()

    if not cv2.imwrite(output_file, out_np):
        print(f"Error: Could not save image to {output_file}", file=sys.stderr)
        return -1
    print(f"Enhanced image saved to: {output_file}")
    t_save = time.perf_counter()

    load_us = (t_load - t_start) * 1e6
    yuv_us, split_us, eq_us, merge_us, bgr_us = (stage_us[s] for s in STAGES)
    save_us = (t_save - t_bgr) * 1e6
    total_us = (t_save - t_start) * 1e6

    print("\n=== PERFORMANCE BREAKDOWN ===")
    print(f"Image loading:        {load_us:.0f} μs")
    print(f"BGR->YUV conversion:  {yuv_us:.0f} μs")
    print(f"Channel splitting:    {split_us:.0f} μs")
    print(f"Histogram equalize:   {eq_us:.0f} μs")
    print(f"Channel merging:      {merge_us:.0f} μs")
    print(f"YUV->BGR conversion:  {bgr_us:.0f} μs")
    print(f"Image saving:         {save_us:.0f} μs")
    print(f"TOTAL PROCESSING:     {total_us:.0f} μs ({total_us / 1000.0:.3f} ms)")

    processing_us = eq_us + merge_us + yuv_us + split_us + bgr_us
    if processing_us > 0:
        print(f"Core processing time: {processing_us:.0f} μs")
        print(f"Potential FPS:        {1e6 / processing_us:.4f} fps")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
