"""Single-frame CLAHE tool (<- reference ``clahe1frame.cpp``).

Usage:
  python -m opencv_opencl_tpu_torch.apps.clahe_image --input=2K.jpg \\
      [--clipLimit=3.0] [--tileGridSize=4] [--device=cuda|cpu]

Counterpart of ``opencv_opencl_tpu/apps/clahe_image.py``: the same flags,
checks, printed lines, output file and return codes.  Output file naming
matches the reference exactly (``clahe1frame.cpp:104-113``):
``<base><clipStr>-<t>x<t><ext>`` with fractional clip limits spelled with
'p' (2.5 -> "2p5").  Prints ``CLAHE_apply_time_ms=`` for the timed
compute-only section: the tile histograms (K1), the LUT build (K2) and the
interpolation (K3) of the Y plane, after a warm-up, between CUDA events.

The app runs on the card: without a CUDA card it fails (return code 1)
unless ``--device=cpu`` names the kernels' plain versions (for tests).
:func:`clahe_bgr` holds everything between the read and the write.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from opencv_opencl_tpu_torch.apps._cli import parse_kv_args, resolve_device
from opencv_opencl_tpu_torch.ops import color
from opencv_opencl_tpu_torch.ops.clahe import clahe_apply, make_clahe_plan


def clip_to_string_for_filename(clip: float) -> str:
    """clahe1frame.cpp:43-51: integers bare, fractions with '.'->'p'."""
    iv = round(clip)
    if abs(clip - iv) < 1e-9:
        return str(int(iv))
    s = f"{clip:f}".rstrip("0").rstrip(".")
    return s.replace(".", "p")


def output_name(input_path: str, clip: float, tile: int) -> str:
    base_file = os.path.basename(input_path)
    dot = base_file.rfind(".")
    base = base_file if dot < 0 else base_file[:dot]
    ext = ".jpg" if dot < 0 else base_file[dot:]
    return f"{base}{clip_to_string_for_filename(clip)}-{tile}x{tile}{ext}"


def elapsed_ms(fn, device) -> tuple[object, float]:
    """``fn()`` and its milliseconds: between CUDA events on the card, on
    ``time.perf_counter`` on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        result = fn()
        return result, (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def clahe_bgr(bgr: np.ndarray, clip_limit: float, tile: int,
              device) -> tuple[np.ndarray, float]:
    """BGR (H, W, 3) uint8 -> the image with CLAHE on its Y plane (clip
    ``clip_limit``, ``tile`` x ``tile`` tiles), on the host, and the
    milliseconds of the CLAHE compute alone after one warm-up call."""
    yuv = color.bgr2yuv(torch.from_numpy(np.ascontiguousarray(bgr)), device=device)
    # the Y plane of interleaved YUV is a stride-3 view: the kernels take rows
    # of unit column stride
    y = yuv[..., 0].contiguous()
    plan = make_clahe_plan(y.shape[0], y.shape[1], float(clip_limit), (tile, tile))
    clahe_apply(y, plan, "onehot")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # === TIMED SECTION: CLAHE compute only ===
    y_eq, ms = elapsed_ms(lambda: clahe_apply(y, plan, "onehot"), device)
    # =========================================
    merged = torch.stack([y_eq, yuv[..., 1], yuv[..., 2]], dim=-1)
    return color.yuv2bgr(merged, device=device).cpu().numpy(), ms


def run(argv: list[str]) -> int:
    opts, _ = parse_kv_args(
        argv,
        {"input": str, "clipLimit": float, "tileGridSize": int, "tile": int,
         "device": str},
    )
    input_path = opts.get("input", "")
    clip_limit = opts.get("clipLimit", 3.0)
    tile = opts.get("tileGridSize", opts.get("tile", 4))

    if not input_path:
        print(
            f"Usage: {sys.argv[0]} --input=<image> [--clipLimit=3.0] "
            f"[--tileGridSize=4]",
            file=sys.stderr,
        )
        return 1
    if clip_limit <= 0.0:
        print("Error: --clipLimit must be > 0", file=sys.stderr)
        return 1
    if tile < 1:
        print("Error: --tileGridSize must be >= 1", file=sys.stderr)
        return 1
    device = resolve_device(opts.get("device", "cuda"))
    if device is None:
        return 1

    import cv2

    bgr = cv2.imread(input_path, cv2.IMREAD_COLOR)
    if bgr is None:
        print(f"Error: cannot open image: {input_path}", file=sys.stderr)
        return 1

    out_bgr, clahe_ms = clahe_bgr(bgr, clip_limit, tile, device)

    out_name = output_name(input_path, clip_limit, tile)
    if not cv2.imwrite(out_name, out_bgr):
        print(f"Error: failed to write output: {out_name}", file=sys.stderr)
        return 1

    print(
        f"CLAHE_apply_time_ms={clahe_ms:.3f} "
        f"(clipLimit={clip_limit:g}, tileGridSize={tile}x{tile})"
    )
    print(f"Saved: {out_name}")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
