#!/usr/bin/env python3
"""Time the port's K1 and K3 kernels (and the steps around them) of two or
more trees in turns on one CUDA card.

Each tree is a checkout of this repository (for example the parent commit,
unpacked with ``git archive`` into the git-ignored ``_checkout/``).  For each
content (structured, random, constant) the script runs one process per tree
and turn, in the order A B ... B A, so that a drift of the card's clock
shows as a difference between the two readings of the same tree.  Each
process imports ``opencv_opencl_tpu_torch`` from its tree (``PYTHONPATH``),
builds that tree's kernels, and times device-alone CUDA-event medians at 4K
batch 4 over the Y rows of an NV12 batch:

    python3 scripts/torch_kernel_turns.py _checkout/parent .

Options: ``--contents structured,random,constant``; ``--interp-rows 4,8,16``
also times K3 of the trees whose wrapper has ``interp_rows_per_block`` at
each of those rows per block; ``--ptxas`` prints what ``nvcc -Xptxas -v``
says of each tree's ``csrc/natural.cu`` (registers, shared memory, spills)
for K1 and K3.  The last line is one JSON object with every reading and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

WIDTH, HEIGHT, BATCH = 3840, 2160, 4
KERNEL_NAMES = ("tile_hist_kernel", "interp_kernel")


def make_content(kind: str, seed: int = 2024):
    """A 4K batch-4 NV12 batch (numpy) whose Y rows are ``kind``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (BATCH, HEIGHT, WIDTH)
    if kind == "structured":
        base = (np.linspace(0, 200, WIDTH, dtype=np.float32)[None, :]
                + np.linspace(0, 55, HEIGHT, dtype=np.float32)[:, None])
        noise = rng.normal(0, 18, shape).astype(np.float32)
        y = np.clip(base[None] + noise, 0, 255).astype(np.uint8)
    elif kind == "random":
        y = rng.integers(0, 256, shape, dtype=np.uint8)
    elif kind == "constant":
        y = np.full(shape, 77, np.uint8)
    else:
        raise ValueError(f"unknown content {kind!r}")
    uv = rng.integers(0, 256, (BATCH, HEIGHT // 2, WIDTH), dtype=np.uint8)
    return np.concatenate([y, uv], axis=1)


def device_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device-alone time of one call: the card spins while the host
    queues the start event, the call and the end event behind it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def child(content: str, interp_rows: list[int]) -> dict:
    """Time the kernels and steps of the package on ``sys.path``."""
    import torch

    from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
    from opencv_opencl_tpu_torch.ops import histogram
    from opencv_opencl_tpu_torch.ops.cuda import lut, natural

    device = torch.device("cuda", 0)
    batch = torch.from_numpy(make_content(content)).to(device)
    y = batch[:, :HEIGHT]
    plan = clahe_ops.make_clahe_plan(HEIGHT, WIDTH, 2.0, (8, 8))
    hists = natural.tile_histograms_ref(y, plan)
    luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
    out = torch.empty_like(y)
    natural.clahe_interpolate(y, luts, plan, out=out)
    work = batch.clone()
    # whether the outputs equal the plain versions (a copy of a tree with a
    # part of a kernel taken out, to see what bounds it, does not)
    res = {
        "k1_equal": torch.equal(natural.tile_histograms(y, plan), hists),
        "k3_equal": torch.equal(out, natural.clahe_interpolate_ref(y, luts, plan)),
        "tile_hist_kernel": device_ms(lambda: natural.tile_histograms(y, plan)),
        "tile_hist_kernel_1x1": device_ms(lambda: histogram.hist256(y)),
        "interp_kernel": device_ms(
            lambda: natural.clahe_interpolate(y, luts, plan, out=out)),
        "interp_kernel_in_place": device_ms(
            lambda: natural.clahe_interpolate(work[:, :HEIGHT], luts, plan,
                                              out=work[:, :HEIGHT])),
        "clahe_step": device_ms(
            lambda: clahe_ops.clahe_apply(work[:, :HEIGHT], plan,
                                          out=work[:, :HEIGHT])),
        "cell_grid_step": device_ms(
            lambda: clahe_ops.clahe_apply(y, plan, backend="pallas", out=out)),
    }
    res["histeq_step"] = device_ms(
        lambda: lut.apply_lut(work[:, :HEIGHT], histogram.equalize_lut(
            histogram.hist256(work[:, :HEIGHT]), HEIGHT * WIDTH),
            out=work[:, :HEIGHT]))
    if interp_rows and hasattr(natural, "interp_rows_per_block"):
        chosen = natural.interp_rows_per_block
        for rows in interp_rows:
            natural.interp_rows_per_block = lambda n, h, rows=rows: rows
            natural.clahe_interpolate(y, luts, plan, out=out)
            res[f"k3_equal_rows_{rows}"] = torch.equal(
                out, natural.clahe_interpolate_ref(y, luts, plan))
            res[f"interp_kernel_rows_{rows}"] = device_ms(
                lambda: natural.clahe_interpolate(y, luts, plan, out=out))
        natural.interp_rows_per_block = chosen
        res["interp_rows_chosen"] = chosen(BATCH, HEIGHT)
    return res


def ptxas(tree: str) -> list[str]:
    """nvcc -Xptxas -v on the tree's natural.cu: the lines of K1 and K3."""
    sys.path.insert(0, os.path.abspath(tree))
    from opencv_opencl_tpu_torch.ops.cuda import _build

    src = os.path.join(tree, "opencv_opencl_tpu_torch", "csrc", "natural.cu")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    res = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                          os.devnull, src], capture_output=True, text=True)
    sys.path.pop(0)
    lines = (res.stdout + res.stderr).splitlines()
    keep, name = [], None
    for line in lines:
        if "Compiling entry function" in line or "Function properties for" in line:
            name = next((k for k in KERNEL_NAMES if k in line), None)
        if name and ("Used" in line or "spill" in line or "Compiling" in line):
            keep.append(f"{name}: {line.strip()}")
    return keep


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--contents", default="structured,random,constant")
    ap.add_argument("--interp-rows", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    rows = [int(r) for r in args.interp_rows.split(",") if r]
    if args.child is not None:
        print(json.dumps(child(args.child, rows)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_turns: this needs a CUDA card", file=sys.stderr)
        return 1
    name_power = card()
    print(name_power, flush=True)
    report: dict = {"card": name_power, "trees": args.trees, "readings": {}}
    if args.ptxas:
        report["ptxas"] = {}
        for tree in args.trees:
            report["ptxas"][tree] = ptxas(tree)
            for line in report["ptxas"][tree]:
                print(f"ptxas {tree} {line}", flush=True)
    order = args.trees + args.trees[::-1]
    for content in args.contents.split(","):
        readings: dict = {tree: [] for tree in args.trees}
        for tree in order:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", content,
                 "--interp-rows", args.interp_rows],
                cwd=os.path.abspath(tree), env=env, capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout, res.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree} {content}: rc {res.returncode}")
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            readings[tree].append(reading)
            print(f"turn {content} {tree}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in reading.items()) + f" ms [{name_power}]", flush=True)
        report["readings"][content] = readings
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
