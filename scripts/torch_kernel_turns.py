#!/usr/bin/env python3
"""Time the port's K1, K2, K3 (with K5 and K3v1), K6, K7, K8, K10 and K6r
kernels (and the steps around them) of two or more trees in turns on one
CUDA card.

Each tree is a checkout of this repository (for example the parent commit,
unpacked with ``git archive`` into the git-ignored ``_checkout/``).  For each
content (structured, random, constant) the script runs one process per tree
and turn, in the order A B ... B A, so that a drift of the card's clock
shows as a difference between the two readings of the same tree.  Each
process imports ``opencv_opencl_tpu_torch`` from its tree (``PYTHONPATH``),
builds that tree's kernels, and times device-alone CUDA-event medians at 4K
batch 4 over the Y rows of an NV12 batch (K7 per 4K frame, as the streaming
step launches it; K5 on the band of a 2x2 mesh, two frames of rows [1080,
2160), and over the batch as one band; K3v1; K10 for each batch_rows 2, 4
and 8 and K8 (``lut.tile_histograms_extended``: K1's kernel, or
``tile_hist_private_kernel`` in older trees) beside K1, on the
batch's Y rows as an extended frame; K6r beside K6).  K2 is timed as a run of
``K2_LAUNCHES`` launches queued behind a spin of the card, over the count,
beside ``torch.profiler``'s device time per call and, in a tree that has
it, an empty kernel launched the same way (``natural.launch_floor``, the
card's floor for a launch).  The 1x1 sharded CLAHE Y step runs on a
process group of one rank (NCCL), timed device alone and from an idle
card, with the profiler's device time per step by kernel:

    python3 scripts/torch_kernel_turns.py _checkout/parent .

Options: ``--contents structured,random,constant``; ``--interp-rows 4,8,16``
also times K3 (and K5 on the 2x2 band) of the trees whose wrapper has
``interp_rows_per_block`` at each of those rows per block, ``--fused-rows
8,16,32`` K7 of the trees with ``fused_rows_per_block`` and ``--cells-rows
8,16,32`` K6 of the trees with ``lut.cells_rows_per_block``; ``--ptxas``
prints what ``nvcc -Xptxas -v`` says of each tree's ``csrc/*.cu``
(registers, shared memory, spills) for K1 (each instance of
``tile_hist_kernel<R>``: 4 for K1, 2, 4 and 8 for K10), K2, K3, K6, K7, and
in older trees ``interp_pack_kernel`` (K5), ``tile_hist_batched_kernel``
(K10), ``interp_cells_radix_kernel`` (K6r) and ``tile_hist_private_kernel``
(K8).  The last line is one JSON
object with every reading and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, BATCH = 3840, 2160, 4
KERNEL_NAMES = ("tile_hist_kernel", "build_luts_kernel", "interp_kernel",
                "interp_pack_kernel", "interp_hist_kernel", "interp_cells_kernel",
                "tile_hist_batched_kernel", "interp_cells_radix_kernel",
                "tile_hist_private_kernel")
# K2 launches a timed run queues behind one spin of the card
K2_LAUNCHES = 200


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


def per_launch_ms(fn, launches: int = K2_LAUNCHES, reps: int = 7) -> float:
    """Median over ``reps`` runs of the device time of ``launches`` calls
    back to back, over the count: the card spins while the host queues
    the start event, the calls and the end event behind it, so neither
    the events nor the host's launch work are in the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / launches)
    return statistics.median(runs)


def profile_us(fn, calls: int = 20) -> dict[str, float]:
    """torch.profiler's device time per call of ``fn``, in us, by kernel
    (and collective), over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {evt.key: evt.device_time_total / calls for evt in prof.key_averages()
            if getattr(evt, "device_time_total", 0) > 0}


def pick(us: dict[str, float], part: str) -> float:
    """The summed device us of the profiler keys that hold ``part``."""
    return sum(v for k, v in us.items() if part in k)


def sweep(res: dict, module, name: str, rows_list: list[int], label: str,
          run, equal) -> None:
    """Time ``run`` with ``module.name`` (a rows-per-block function) giving
    each of ``rows_list`` in turn, where the tree's module has it."""
    if not rows_list or not hasattr(module, name):
        return
    chosen = getattr(module, name)
    for rows in rows_list:
        setattr(module, name, lambda *args, rows=rows: rows)
        run()
        res[f"{label}_equal_rows_{rows}"] = equal()
        res[f"{label}_rows_{rows}"] = device_ms(run)
    setattr(module, name, chosen)


def child(content: str, interp_rows: list[int], fused_rows: list[int],
          cells_rows: list[int]) -> dict:
    """Time the kernels and steps of the package on ``sys.path``."""
    import torch

    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.models import enhancer
    from opencv_opencl_tpu_torch.ops import auto_clahe
    from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
    from opencv_opencl_tpu_torch.ops import histogram
    from opencv_opencl_tpu_torch.ops.cuda import lut, natural

    device = torch.device("cuda", 0)
    batch = torch.from_numpy(make_content(content)).to(device)
    y = batch[:, :HEIGHT]
    plan = clahe_ops.make_clahe_plan(HEIGHT, WIDTH, 2.0, (8, 8))
    spec = lut.make_interp_spec(HEIGHT, WIDTH, 2.0, (8, 8))
    hists = natural.tile_histograms_ref(y, plan)
    luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
    out = torch.empty_like(y)
    natural.clahe_interpolate(y, luts, plan, out=out)
    work = batch.clone()
    # K7 on one frame, with the LUTs of another frame (the previous one)
    frame, frame_luts = y[:1], luts[1:2].contiguous()
    frame_out = torch.empty_like(frame)
    frame_ref = natural.clahe_interp_and_hist_ref(frame, frame_luts, plan)
    cells_ref = lut.clahe_interpolate_cells_ref(y, luts, spec)

    def k7_equal() -> bool:
        got = natural.clahe_interp_and_hist(frame, frame_luts, plan, out=frame_out)
        return torch.equal(got[0], frame_ref[0]) and torch.equal(got[1], frame_ref[1])

    def k6_equal() -> bool:
        lut.clahe_interpolate_cells(y, luts, spec, out=out)
        return torch.equal(out, cells_ref)

    cfg = enhancer.EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                                  chroma=ChromaPolicy.PASSTHROUGH)
    stream_fn, _ = enhancer.build_streaming_clahe_fn(
        cfg, FrameSpec(width=WIDTH, height=HEIGHT))
    state = enhancer.initial_hists(plan, device)
    # whether the outputs equal the plain versions (a copy of a tree with a
    # part of a kernel taken out, to see what bounds it, does not)
    res = {
        "k1_equal": torch.equal(natural.tile_histograms(y, plan), hists),
        "k3_equal": torch.equal(out, natural.clahe_interpolate_ref(y, luts, plan)),
        "k7_equal": k7_equal(),
        "k6_equal": k6_equal(),
        "tile_hist_kernel": device_ms(lambda: natural.tile_histograms(y, plan)),
        "tile_hist_kernel_1x1": device_ms(lambda: histogram.hist256(y)),
        "interp_kernel": device_ms(
            lambda: natural.clahe_interpolate(y, luts, plan, out=out)),
        "interp_kernel_in_place": device_ms(
            lambda: natural.clahe_interpolate(work[:, :HEIGHT], luts, plan,
                                              out=work[:, :HEIGHT])),
        "interp_hist_kernel": device_ms(
            lambda: natural.clahe_interp_and_hist(frame, frame_luts, plan,
                                                  out=frame_out)),
        "interp_hist_kernel_in_place": device_ms(
            lambda: natural.clahe_interp_and_hist(work[:1, :HEIGHT], frame_luts,
                                                  plan, out=work[:1, :HEIGHT])),
        "k3_then_k1_per_frame": device_ms(
            lambda: (natural.tile_histograms(frame, plan),
                     natural.clahe_interpolate(frame, frame_luts, plan,
                                               out=frame_out))),
        "interp_cells_kernel": device_ms(
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out)),
        "interp_cells_kernel_in_place": device_ms(
            lambda: lut.clahe_interpolate_cells(work[:, :HEIGHT], luts, spec,
                                                out=work[:, :HEIGHT])),
        "clahe_step": device_ms(
            lambda: clahe_ops.clahe_apply(work[:, :HEIGHT], plan,
                                          out=work[:, :HEIGHT])),
        "cell_grid_step": device_ms(
            lambda: clahe_ops.clahe_apply(y, plan, backend="pallas", out=out)),
        "streaming_step": device_ms(lambda: stream_fn(work, state)),
        "auto_step": device_ms(
            lambda: auto_clahe.clahe_auto(y, (8, 8), device=device)),
    }
    res["histeq_step"] = device_ms(
        lambda: lut.apply_lut(work[:, :HEIGHT], histogram.equalize_lut(
            histogram.hist256(work[:, :HEIGHT]), HEIGHT * WIDTH),
            out=work[:, :HEIGHT]))
    res.update(band_and_lut_readings(y, hists, luts, plan, out))
    res.update(hist_and_radix_readings(y, hists, luts, plan, spec, out, cells_ref))
    res.update(sharded_readings(batch.clone(), device))
    if interp_rows and hasattr(natural, "interp_rows_per_block"):
        chosen = natural.interp_rows_per_block
        band = y[:BATCH // 2, HEIGHT // 2:]
        band_luts = luts[:BATCH // 2].contiguous()
        band_out = torch.empty_like(band)
        band_ref = natural.clahe_interpolate_band_ref(band, band_luts, plan, HEIGHT // 2)
        for rows in interp_rows:
            natural.interp_rows_per_block = lambda n, h, rows=rows: rows
            natural.clahe_interpolate(y, luts, plan, out=out)
            res[f"k3_equal_rows_{rows}"] = torch.equal(
                out, natural.clahe_interpolate_ref(y, luts, plan))
            res[f"interp_kernel_rows_{rows}"] = device_ms(
                lambda: natural.clahe_interpolate(y, luts, plan, out=out))
            # K5 on a 2x2 mesh's band (the same kernel, in the trees where
            # the band takes K3's rows per block)
            natural.clahe_interpolate_band(band, band_luts, plan, HEIGHT // 2,
                                           out=band_out)
            res[f"k5_equal_rows_{rows}"] = torch.equal(band_out, band_ref)
            res[f"interp_kernel_band_2x2_rows_{rows}"] = device_ms(
                lambda: natural.clahe_interpolate_band(band, band_luts, plan,
                                                       HEIGHT // 2, out=band_out))
        natural.interp_rows_per_block = chosen
        res["interp_rows_chosen"] = chosen(BATCH, HEIGHT)
    sweep(res, natural, "fused_rows_per_block", fused_rows, "interp_hist_kernel",
          lambda: natural.clahe_interp_and_hist(frame, frame_luts, plan,
                                                out=frame_out), k7_equal)
    sweep(res, lut, "cells_rows_per_block", cells_rows, "interp_cells_kernel",
          lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out), k6_equal)
    return res


def band_and_lut_readings(y, hists, luts, plan, out) -> dict:
    """K5 on a 2x2 mesh's band and as one band, K3v1, and K2 as one call,
    as a run of launches and by the profiler, with the launch floor."""
    import torch

    from opencv_opencl_tpu_torch.ops.cuda import natural

    band = y[:BATCH // 2, HEIGHT // 2:]
    band_luts = luts[:BATCH // 2].contiguous()
    band_out = torch.empty_like(band)
    res = {
        "k5_equal": torch.equal(
            natural.clahe_interpolate_band(band, band_luts, plan, HEIGHT // 2),
            natural.clahe_interpolate_band_ref(band, band_luts, plan, HEIGHT // 2)),
        "k2_equal": torch.equal(natural.build_luts(hists, plan.clip, plan.lut_scale),
                                natural.build_luts_ref(hists, plan.clip,
                                                       plan.lut_scale)),
        "interp_kernel_band_2x2": device_ms(
            lambda: natural.clahe_interpolate_band(band, band_luts, plan,
                                                   HEIGHT // 2, out=band_out)),
        "interp_kernel_one_band": device_ms(
            lambda: natural.clahe_interpolate_band(y, luts, plan, 0, out=out)),
        "interp_kernel_variant1": device_ms(
            lambda: natural.clahe_interpolate_pack(y, luts, plan, out=out)),
    }
    k2 = lambda: natural.build_luts(hists, plan.clip, plan.lut_scale)  # noqa: E731
    res["build_luts_kernel_one_call"] = device_ms(k2)
    res["build_luts_kernel_per_launch"] = per_launch_ms(k2)
    res["build_luts_kernel_profiler_us"] = pick(profile_us(k2), "build_luts_kernel")
    if hasattr(natural, "launch_floor"):
        floor = lambda: natural.launch_floor(hists)  # noqa: E731
        res["launch_floor_per_launch"] = per_launch_ms(floor)
        res["launch_floor_profiler_us"] = pick(profile_us(floor), "launch_floor_kernel")
    return res


def hist_and_radix_readings(y, hists, luts, plan, spec, out, cells_ref) -> dict:
    """K10 for each batch_rows and K8 on the Y rows as an extended frame
    (4K is tile-divisible), K1 once more between them, and K6r: whether
    each equals the plain version, and its device ms."""
    import torch

    from opencv_opencl_tpu_torch.ops.cuda import lut, natural

    tiles = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
    res = {}
    for rows in (2, 4, 8):
        k10 = lambda rows=rows: natural.tile_histograms_batched(  # noqa: E731
            y, *tiles, batch_rows=rows)
        res[f"k10_equal_rows_{rows}"] = torch.equal(k10(), hists)
        res[f"tile_hist_batched_rows_{rows}"] = device_ms(k10)
    res["tile_hist_kernel_again"] = device_ms(lambda: natural.tile_histograms(y, plan))
    res["k8_equal"] = torch.equal(lut.tile_histograms_extended(y, *tiles), hists)
    res["tile_histograms_extended"] = device_ms(
        lambda: lut.tile_histograms_extended(y, *tiles))
    lut.clahe_interpolate_cells(y, luts, spec, out=out, radix=True)
    res["k6r_equal"] = torch.equal(out, cells_ref)
    res["interp_cells_radix"] = device_ms(
        lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out, radix=True))
    res["interp_cells_kernel_again"] = device_ms(
        lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out))
    return res


def sharded_readings(batch, device) -> dict:
    """The 1x1 sharded CLAHE Y step (a process group of one rank on NCCL)
    beside the single-card Y step, device alone and from an idle card, and
    the profiler's device us per step by kernel."""
    import torch.distributed as dist

    from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu_torch.models.enhancer import EnhancerConfig, make_enhance_y
    from opencv_opencl_tpu_torch.parallel import launch, sharded

    cfg = EnhancerConfig(op="clahe", clip_limit=2.0, tile_grid=(8, 8),
                         chroma=ChromaPolicy.PASSTHROUGH)
    spec = FrameSpec(width=WIDTH, height=HEIGHT)
    slab = batch[:, :HEIGHT]
    res = {}
    with tempfile.TemporaryDirectory(prefix="turns_") as rendezvous:
        launch.init_process_group(0, 1, os.path.join(rendezvous, "rendezvous"), "cuda")
        try:
            step = sharded.ShardedEnhancer(cfg, spec, shape=(1, 1), device=device)._y_step
            single, _ = make_enhance_y(cfg, spec)
            res["sharded_1x1_backend"] = dist.get_backend()
            res["sharded_1x1_clahe_step"] = device_ms(lambda: step.step_slab(slab))
            res["sharded_1x1_clahe_step_idle"] = idle_ms(lambda: step.step_slab(slab))
            res["single_card_clahe_y_step"] = device_ms(lambda: single(slab, slab))
            us = profile_us(lambda: step.step_slab(slab), calls=10)
            res["sharded_1x1_profiler_us"] = {k: round(v, 2) for k, v in sorted(
                us.items(), key=lambda kv: -kv[1])[:8]}
        finally:
            dist.destroy_process_group()
    return res


def idle_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median time of one call from an idle card: the host's launch work
    up to each launch is in it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas(tree: str) -> list[str]:
    """nvcc -Xptxas -v on the tree's csrc/*.cu: the lines of the kernels in
    KERNEL_NAMES."""
    sys.path.insert(0, REPO)
    from opencv_opencl_tpu_torch.ops.cuda import _build

    sys.path.pop(0)
    return _build.ptxas_report(
        KERNEL_NAMES, os.path.join(tree, "opencv_opencl_tpu_torch", "csrc"))


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--contents", default="structured,random,constant")
    ap.add_argument("--interp-rows", default="")
    ap.add_argument("--fused-rows", default="")
    ap.add_argument("--cells-rows", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sweeps = [[int(r) for r in arg.split(",") if r]
              for arg in (args.interp_rows, args.fused_rows, args.cells_rows)]
    if args.child is not None:
        print(json.dumps(child(args.child, *sweeps)), flush=True)
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
                 "--interp-rows", args.interp_rows, "--fused-rows", args.fused_rows,
                 "--cells-rows", args.cells_rows],
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
