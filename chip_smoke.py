#!/usr/bin/env python3
"""Drive the PyTorch port's NV12 CLAHE step on a CUDA card and check it.

Run from the repository root, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. device   the card, and its name and power limit from nvidia-smi;
2. build    the CUDA kernels from ``opencv_opencl_tpu_torch/csrc``;
3. kernels  K1, K2 and K3 against their plain PyTorch versions on the card,
            exact, over 4K batches, odd and tiny geometries, a constant
            frame, hist_rowstep=2 and several tile grids;
4. golden   the CUDA path against the numpy golden model, 0 LSB;
5. main     ``Enhancer`` (CLAHE clip 2.0, 8x8, chroma passthrough, 4K)
            driven through ``runtime.feeder.FrameFeeder``: every output equal
            to the plain path's, no processing errors, every kernel launched;
6. timings  CUDA-event medians of the 4K batch-4 step and of each kernel
            beside its plain version, the feeder's end-to-end rate, and
            torch.profiler's device time per kernel over ten steps.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports no JAX:
the oracles on the card are the plain versions and ``core/golden.py``.
"""

from __future__ import annotations

import json
import statistics
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from opencv_opencl_tpu.core import golden
from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu.runtime.feeder import FrameFeeder
from opencv_opencl_tpu_torch.models.enhancer import (
    Enhancer,
    EnhancerConfig,
    build_enhance_fn,
)
from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
from opencv_opencl_tpu_torch.ops.cuda import _build, natural
from opencv_opencl_tpu_torch.utils.envinfo import nvidia_smi_name_power

WIDTH, HEIGHT, BATCH = 3840, 2160, 4
CLIP, GRID = 2.0, (8, 8)
FEEDER_FRAMES = 64
DISTINCT_FRAMES = 8
SOURCE = "opencv_opencl_tpu_torch/csrc/natural.cu"
KERNELS = (
    # (name, wrapper, TPU entry function it replaces)
    ("tile_hist_kernel", "tile_histograms",
     "opencv_opencl_tpu/ops/pallas/natural.py:493"),
    ("build_luts_kernel", "build_luts",
     "opencv_opencl_tpu/ops/pallas/natural.py:417"),
    ("interp_kernel", "clahe_interpolate",
     "opencv_opencl_tpu/ops/pallas/natural.py:273"),
)


def main_config(h=HEIGHT, w=WIDTH) -> tuple[FrameSpec, EnhancerConfig]:
    """The main path's step: CLAHE clip 2.0, 8x8 tiles, chroma passthrough."""
    return FrameSpec(width=w, height=h), EnhancerConfig(
        op="clahe", clip_limit=CLIP, tile_grid=GRID,
        chroma=ChromaPolicy.PASSTHROUGH)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def random_y(rng, n, h, w) -> np.ndarray:
    return rng.integers(0, 256, (n, h, w), dtype=np.uint8)


def structured_y(rng, n, h, w) -> np.ndarray:
    """Gradient plus noise: LUTs that differ from tile to tile."""
    base = (np.linspace(0, 200, w, dtype=np.float32)[None, :]
            + np.linspace(0, 55, h, dtype=np.float32)[:, None])
    noise = rng.normal(0, 18, (n, h, w)).astype(np.float32)
    return np.clip(base[None] + noise, 0, 255).astype(np.uint8)


def nv12_batch(rng, n, h, w) -> np.ndarray:
    y = structured_y(rng, n, h, w)
    uv = rng.integers(0, 256, (n, h // 2, w), dtype=np.uint8)
    return np.concatenate([y, uv], axis=1)


def plain_step(frames: torch.Tensor, plan, rowstep: int = 1) -> torch.Tensor:
    """The CLAHE step through the three plain versions only."""
    hists = natural.tile_histograms_ref(frames, plan, rowstep)
    luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
    return natural.clahe_interpolate_ref(frames, luts, plan)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


# ------------------------------------------------------------- phase 3 ----


def kernel_cases(rng):
    """(label, frames, h, clip, grid, rowstep): ``frames`` is (N, h, W) or
    an NV12 batch (N, h*3/2, W), whose strided Y rows go to the kernels."""
    four_k = nv12_batch(rng, BATCH, HEIGHT, WIDTH)
    four_k_random = four_k.copy()
    four_k_random[:, :HEIGHT] = random_y(rng, BATCH, HEIGHT, WIDTH)
    return [
        ("4k_b4_random_nv12", four_k_random, HEIGHT, CLIP, GRID, 1),
        ("4k_b4_structured_nv12", four_k, HEIGHT, CLIP, GRID, 1),
        ("4k_b4_rowstep2_nv12", four_k, HEIGHT, CLIP, GRID, 2),
        ("1079x1919_odd", random_y(rng, 2, 1079, 1919), 1079, CLIP, GRID, 1),
        ("4k_constant", np.full((2, HEIGHT, WIDTH), 77, np.uint8), HEIGHT,
         CLIP, GRID, 1),
        ("6x6_grid8x8", random_y(rng, 3, 6, 6), 6, CLIP, GRID, 1),
        ("3x3_grid8x8_pad_ge_dim", random_y(rng, 2, 3, 3), 3, 40.0, GRID, 1),
        ("270x480_grid1x1", random_y(rng, 2, 270, 480), 270, CLIP, (1, 1), 1),
        ("97x131_grid3x5", random_y(rng, 2, 97, 131), 97, 40.0, (3, 5), 1),
        ("64x128_noclip", random_y(rng, 1, 64, 128), 64, 0.0, GRID, 1),
    ]


def residual_edge_hists(plan) -> np.ndarray:
    """Histograms whose redistribution residual is 0, 1 and 255, one bin
    holding everything, and a uniform one."""
    hists = np.zeros((1, plan.num_tiles, 256), np.int32)
    h, c, area = hists[0], plan.clip, plan.tile_area
    h[0, 0] = area
    h[1, :] = area // 256
    h[1, 0] += area - h[1].sum()
    h[2, :2] = [c + 255, area - (c + 255)]
    h[3, :2] = [c + 256, area - (c + 256)]
    h[4, :2] = [c + 1, area - (c + 1)]
    return hists


def phase_kernels(device, cases) -> dict[str, int]:
    errs = {name: 0 for name, _, _ in KERNELS}
    for label, frames_np, h, clip, grid, rowstep in cases:
        batch = torch.from_numpy(frames_np).to(device)
        y = batch[:, :h]
        plan = clahe_ops.make_clahe_plan(h, y.shape[2], clip, grid)

        hk = natural.tile_histograms(y, plan, rowstep)
        hr = natural.tile_histograms_ref(y, plan, rowstep)
        e1 = max_err(hk, hr)
        lk = natural.build_luts(hr, plan.clip, plan.lut_scale)
        lr = natural.build_luts_ref(hr, plan.clip, plan.lut_scale)
        e2 = max_err(lk, lr)
        ok = natural.clahe_interpolate(y, lr, plan)
        orf = natural.clahe_interpolate_ref(y, lr, plan)
        e3 = max_err(ok, orf)
        # in place, as the NV12 step runs it: the chroma rows stay untouched
        inplace = batch.clone()
        natural.clahe_interpolate(inplace[:, :h], lr, plan, out=inplace[:, :h])
        e3 = max(e3, max_err(inplace[:, :h], orf),
                 max_err(inplace[:, h:], batch[:, h:]))
        if label == "4k_b4_structured_nv12":  # K2 alone on edge cases
            edge = torch.from_numpy(residual_edge_hists(plan)).to(device)
            e2 = max(e2, max_err(natural.build_luts(edge, plan.clip, plan.lut_scale),
                                 natural.build_luts_ref(edge, plan.clip, plan.lut_scale)))
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K1 {e1} K2 {e2} K3 {e3} (max abs err)", flush=True)
        for name, e in zip(errs, (e1, e2, e3)):
            errs[name] = max(errs[name], e)
    check(all(e == 0 for e in errs.values()), f"kernel mismatch {errs}")
    return errs


# ------------------------------------------------------------- phase 4 ----


def phase_golden(device, rng, h=1080, w=1920) -> None:
    frames = structured_y(rng, 2, h, w)
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    out = clahe_ops.clahe_apply(torch.from_numpy(frames).to(device), plan).cpu().numpy()
    for i, f in enumerate(frames):
        d = int(np.abs(out[i].astype(int) - golden.clahe(f, CLIP, GRID).astype(int)).max())
        print(f"golden {h}x{w} frame {i}: max abs diff {d}", flush=True)
        check(d == 0, f"frame {i} differs from core.golden.clahe by {d}")


# ------------------------------------------------------------- phase 5 ----


def phase_main_path(device, rng, h=HEIGHT, w=WIDTH, batch=BATCH,
                    n_frames=FEEDER_FRAMES) -> dict[str, int]:
    """Drive the Enhancer through the FrameFeeder, checking every output;
    returns the kernels' launch counts in this run."""

    spec, cfg = main_config(h, w)
    enhancer = Enhancer(cfg, spec, device=device)
    frames = nv12_batch(rng, DISTINCT_FRAMES, h, w)
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    y_plain = plain_step(torch.from_numpy(frames[:, :h]).to(device), plan).cpu().numpy()
    expected = np.concatenate([y_plain, frames[:, h:]], axis=1)

    results: list[tuple[int, bool]] = []
    lock = threading.Lock()

    def on_output(seq, frame, meta):
        with lock:
            results.append((seq, bool(np.array_equal(frame, expected[meta]))))

    feeder = FrameFeeder(enhancer.process_batch, batch_size=batch, depth=2,
                         queue_capacity=2 * n_frames, on_output=on_output)
    feeder.warmup((spec.buffer_rows, w))
    natural.reset_launch_counts()
    feeder.start()
    for i in range(n_frames):
        feeder.submit(frames[i % DISTINCT_FRAMES], meta=i % DISTINCT_FRAMES)
    feeder.stop(drain=True)
    counts = natural.launch_counts()
    stats = feeder.stats

    print(f"main path: {len(results)} outputs of {n_frames} submitted, "
          f"stats {stats}, launches {counts}", flush=True)
    check(stats.get("processing_errors", 0) == 0,
          f"processing_errors {stats.get('processing_errors')}")
    check(len(results) == n_frames, f"{len(results)} outputs for {n_frames} frames")
    check([s for s, _ in results] == list(range(n_frames)), "outputs out of order")
    check(all(ok for _, ok in results),
          f"{sum(not ok for _, ok in results)} outputs differ from the plain path")
    check(all(c > 0 for c in counts.values()), f"a kernel was not launched: {counts}")
    return counts


def feeder_fps(device, rng, h=HEIGHT, w=WIDTH, batch=BATCH,
               n_frames=FEEDER_FRAMES) -> float:
    """Frames per second through the FrameFeeder, host frames in and host
    frames out (H2D, the step, D2H and the feeder's own copies)."""

    spec, cfg = main_config(h, w)
    frames = nv12_batch(rng, DISTINCT_FRAMES, h, w)
    feeder = FrameFeeder(Enhancer(cfg, spec, device=device).process_batch,
                         batch_size=batch, depth=2, queue_capacity=2 * n_frames)
    feeder.warmup((spec.buffer_rows, w))
    t0 = time.perf_counter()
    feeder.start()
    for i in range(n_frames):
        feeder.submit(frames[i % DISTINCT_FRAMES])
    feeder.stop(drain=True)
    elapsed = time.perf_counter() - t0
    stats = feeder.stats
    check(stats["emitted"] == n_frames and stats.get("processing_errors", 0) == 0,
          f"feeder timing run: {stats}")
    return n_frames / elapsed


# ------------------------------------------------------------- phase 6 ----


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_timings(device, rng, card: str) -> dict[str, tuple[float, float]]:
    spec, cfg = main_config()
    step = build_enhance_fn(cfg, spec, donate=True)
    plan = clahe_ops.make_clahe_plan(HEIGHT, WIDTH, CLIP, GRID)
    batch = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH)).to(device)
    y = batch[:, :HEIGHT]

    def plain():
        y.copy_(plain_step(y, plan))

    step_ms = time_ms(lambda: step(batch))
    plain_step_ms = time_ms(plain)
    print(f"time step 4K b{BATCH}: {step_ms:.4f} ms/batch, "
          f"{step_ms / BATCH:.4f} ms/frame, {1e3 * BATCH / step_ms:.1f} fps "
          f"(plain path {plain_step_ms / BATCH:.4f} ms/frame) [{card}]", flush=True)

    hists = natural.tile_histograms_ref(y, plan)
    luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
    out = torch.empty_like(y)
    const = torch.full((BATCH, HEIGHT, WIDTH), 77, dtype=torch.uint8, device=device)
    times = {
        "tile_hist_kernel": (
            time_ms(lambda: natural.tile_histograms(y, plan)),
            time_ms(lambda: natural.tile_histograms_ref(y, plan))),
        "build_luts_kernel": (
            time_ms(lambda: natural.build_luts(hists, plan.clip, plan.lut_scale)),
            time_ms(lambda: natural.build_luts_ref(hists, plan.clip, plan.lut_scale))),
        "interp_kernel": (
            time_ms(lambda: natural.clahe_interpolate(y, luts, plan, out=out)),
            time_ms(lambda: natural.clahe_interpolate_ref(y, luts, plan))),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"time {name} 4K b{BATCH}: {ms:.4f} ms (plain {plain_ms:.4f} ms) [{card}]",
              flush=True)
    const_ms = time_ms(lambda: natural.tile_histograms(const, plan))
    print(f"time tile_hist_kernel 4K b{BATCH} constant frame: {const_ms:.4f} ms [{card}]",
          flush=True)
    return times


def phase_profile(device, rng) -> None:
    """Device time by kernel over ten 4K batch-4 steps (torch.profiler)."""

    spec, cfg = main_config()
    step = build_enhance_fn(cfg, spec, donate=True)
    batch = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH)).to(device)
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step(batch)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", 0.0)
        if dev_us > 0:
            print(f"profile {evt.key}: {evt.count} calls, "
                  f"{dev_us / max(evt.count, 1):.2f} us device time per call", flush=True)


# ---------------------------------------------------------------- main ----


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "a CUDA card", file=sys.stderr)
        return 1


    # phase 1: device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi_name_power()
    check(card is not None, "nvidia-smi gave no name and power limit")
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(card, flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}",
          flush=True)

    rng = np.random.default_rng(2024)
    errs = phase_kernels(device, kernel_cases(rng))      # phase 3
    phase_golden(device, rng)                             # phase 4
    counts = phase_main_path(device, rng)                 # phase 5
    times = phase_timings(device, rng, card)              # phase 6
    e2e_fps = feeder_fps(device, rng)
    print(f"time feeder end to end 4K b{BATCH} (H2D + step + D2H): "
          f"{e2e_fps:.1f} fps over {FEEDER_FRAMES} frames [{card}]", flush=True)
    phase_profile(device, rng)

    check("jax" not in sys.modules, "jax was imported")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": counts[wrapper], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, wrapper, replaces in KERNELS
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
