"""Card-vs-OpenCV parity + timing bench (<- reference ``1frameMeasure.cpp``).

Usage:
  python -m opencv_opencl_tpu_torch.apps.parity_bench --input=hun.png \\
      [--op=histeq|clahe] [--clipLimit=2.0] [--tile=8] [--threshold=1] \\
      [--dump-images] [--repeat=256] [--device=cuda|cpu]

Counterpart of ``opencv_opencl_tpu/apps/parity_bench.py``: the same flags,
printed lines, dumped images and return codes, except that the time of the
port's side is printed as ``GPU {op} time`` where the JAX app prints ``TPU
{op} time``.  The same Y plane goes through the CPU OpenCV implementation
and the card's kernels (histeq: K1 on a 1x1 grid and K4; clahe: K1, K2 and
K3), both timed; ``absdiff`` + an analyzeDiff-style check (pixels exceeding
``threshold``, default +/-1 LSB, must be 0%%); optional debug image dumps
(input_y / out_ocv_y / out_tpu_y / out_diff_y).  The card's time is that of
``repeat`` chained calls (``y = fn(y)``) between two CUDA events, less that
of one call, over ``repeat``: the median of 3.

The app runs on the card: without a CUDA card it fails (return code 1)
unless ``--device=cpu`` names the kernels' plain versions (for tests).
:func:`device_parity` holds the card's side; cv2 stays in :func:`run`.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from opencv_opencl_tpu_torch.apps._cli import parse_kv_args, resolve_device
from opencv_opencl_tpu_torch.apps.clahe_image import elapsed_ms
from opencv_opencl_tpu_torch.ops import histeq
from opencv_opencl_tpu_torch.ops.clahe import clahe_apply, make_clahe_plan


def analyze_diff(diff, threshold: int) -> float:
    """xf::cv::analyzeDiff equivalent: % of pixels with |diff| > threshold."""
    return float((diff > threshold).mean() * 100.0)


def abs_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``cv2.absdiff`` of two uint8 images."""
    return np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.uint8)


def device_parity(y_plane: np.ndarray, y_ref: np.ndarray, op: str, device,
                  clip_limit: float = 2.0, tile: int = 8, threshold: int = 1,
                  repeat: int = 256) -> tuple[np.ndarray, float, float]:
    """The port's side of the bench on the uint8 Y plane (H, W): its output
    of ``op`` ("histeq" or "clahe"), the chained milliseconds a call and the
    % of pixels more than ``threshold`` off ``y_ref``."""
    if op == "histeq":
        fn = lambda y: histeq.equalize_hist(y, device=device)  # noqa: E731
    elif op == "clahe":
        plan = make_clahe_plan(y_plane.shape[0], y_plane.shape[1],
                               float(clip_limit), (tile, tile))
        fn = lambda y: clahe_apply(y, plan, "onehot")  # noqa: E731
    else:
        raise ValueError(f"unknown op {op!r}")
    y_dev = torch.from_numpy(np.ascontiguousarray(y_plane)).to(device)
    y_out = fn(y_dev)  # the first call builds or loads the kernels

    def chain(n: int) -> float:
        def calls():
            y = y_dev
            for _ in range(n):
                y = fn(y)
            return y
        return elapsed_ms(calls, device)[1]

    chain(1)
    samples = []
    for _ in range(3):  # median of 3: one slow sample can't skew it
        one = chain(1)
        samples.append(max((chain(repeat + 1) - one) / repeat, 0.0))
    out = y_out.cpu().numpy()
    return out, sorted(samples)[1], analyze_diff(abs_diff(y_ref, out), threshold)


def run(argv: list[str]) -> int:
    opts, pos = parse_kv_args(
        argv,
        {
            "input": str, "op": str, "clipLimit": float, "tile": int,
            "threshold": int, "dump-images": bool, "repeat": int,
            "device": str,
        },
    )
    input_path = opts.get("input", pos[0] if pos else "")
    op = opts.get("op", "histeq")
    clip_limit = opts.get("clipLimit", 2.0)
    tile = opts.get("tile", 8)
    threshold = opts.get("threshold", 1)
    repeat = max(opts.get("repeat", 256), 1)

    if not input_path:
        print(f"Usage: {sys.argv[0]} --input=<image> [--op=histeq|clahe] ...",
              file=sys.stderr)
        return -1
    device = resolve_device(opts.get("device", "cuda"))
    if device is None:
        return 1

    import cv2

    bgr = cv2.imread(input_path, cv2.IMREAD_COLOR)
    if bgr is None:
        print("Cannot open image", file=sys.stderr)
        return -1
    # I420 requires even dimensions; crop like GStreamer caps negotiation would
    bgr = bgr[: bgr.shape[0] - bgr.shape[0] % 2, : bgr.shape[1] - bgr.shape[1] % 2]
    height, width = bgr.shape[:2]
    print(f"Input image height : {height}")
    print(f"Input image width  : {width}")

    yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
    y_plane = yuv[:height].copy()

    # -------------------- OpenCV software --------------------
    if op == "histeq":
        cv_fn = lambda: cv2.equalizeHist(y_plane)  # noqa: E731
    elif op == "clahe":
        c = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=(tile, tile))
        cv_fn = lambda: c.apply(y_plane)  # noqa: E731
    else:
        print(f"unknown --op: {op}", file=sys.stderr)
        return -1
    t1 = time.perf_counter()
    y_ocv = cv_fn()
    t2 = time.perf_counter()
    print(f"OpenCV {op} time: {(t2 - t1) * 1e3:.3f} ms")

    # -------------------- the card's kernels --------------------
    y_dev_out, dev_ms, err_per = device_parity(
        y_plane, y_ocv, op, device, clip_limit, tile, threshold, repeat)
    print(f"GPU {op} time: {dev_ms:.3f} ms  "
          f"(chained avg of {repeat}, median of 3)")

    # -------------------- Compare results --------------------
    diff = abs_diff(y_ocv, y_dev_out)
    if err_per > 0.0:
        print(f"ERROR: Results mismatch, error = {err_per}%", file=sys.stderr)
        rc = 1
    else:
        print("Results match!")
        rc = 0
    print(f"Max absolute difference: {int(diff.max())} LSB")

    if opts.get("dump-images"):
        cv2.imwrite("input_y.jpg", y_plane)
        cv2.imwrite("out_ocv_y.jpg", y_ocv)
        cv2.imwrite("out_tpu_y.jpg", y_dev_out)
        cv2.imwrite("out_diff_y.jpg", diff)
        print("Saved: input_y.jpg out_ocv_y.jpg out_tpu_y.jpg out_diff_y.jpg")
    return rc


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
