#!/usr/bin/env python3
"""Time the port's K1, K2, K3 (with K5 and K3v1), K6, K7, K8, K10 and K6r
kernels (and the steps around them), or with ``--h264`` its H2-H6, of two
or more trees in turns on one CUDA card.

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

With ``--h264`` the children time the device encoders' kernels instead,
on one 4K P frame of structured content moving by (1, 2) pixels a frame:
H3 (16 planes at margin 9; also 4 planes at margin 5, 1 plane at margin 8
and, where the tree has ``planes_floor_into``, each one's write floor), H4
(``fastsub`` at search 8 and the exhaustive
quarter-pel lattice at search 4, each alone on a built stack and right
after H3 has written it: the pair less H3), H2 (QP 30), H1 on the same
frame (the default, and ``full_recon`` as on an IDR), H5 on the P frame's
own metadata and on an IDR's (each beside the wavefront's floor where the
tree has ``deblock_floor_into``) and H6 (full-pel, half-pel search 8,
quarter-pel search 4 and two references at full-pel search 8), H1 with
``i4`` and ``chromah``, H7 on the frame's default and ``i4:chromah`` IDR
levels (where the tree has ``pack_i_floor_into``, each beside its
read-and-store floor) and H8 on its parts P frame (full-pel search 8) and
on the P_16x16 frame of H2 (each beside its read-and-store floor where the
tree has ``pack_p_floor_into``), with checksums of their outputs, so that
the trees are seen to compute the same thing; in a tree with the split
H1/H2 (``levels_plan``), each of their phases as torch.profiler's device
time of its grid in an ordinary call (H1 with ``i4`` where the tree has
``I4_RECORD_WORDS``).

Options: ``--contents structured,random,constant``; ``--interp-rows 4,8,16``
also times K3 (and K5 on the 2x2 band) of the trees whose wrapper has
``interp_rows_per_block`` at each of those rows per block, ``--fused-rows
8,16,32`` K7 of the trees with ``fused_rows_per_block``, ``--cells-rows
8,16,32`` K6 of the trees with ``lut.cells_rows_per_block`` and, with
``--h264``, ``--deblock-rows 2,4,8,16`` H5 of the trees with
``deblock_rows_per_block`` and ``--pack-runs 1,4,16`` H8 (and H7 on the
default IDR) of the trees with ``PACK_P_RUN`` at each of those MBs a warp,
through the launchers' ``run`` argument
(each reading also held equal to the default's output); ``--ptxas``
prints what ``nvcc -Xptxas -v`` says of each tree's ``csrc/*.cu``
(registers, shared memory, spills) for H3 (each instance of
``subpel_planes_kernel<NP>`` and ``subpel_floor_kernel<NP>``), H4, H5 (and
its bS pass), H6, H1 and H2 (the split design's grids, and the direct
``intra_levels_kernel`` of trees that have it), H7 and H8, and
for K1 (each instance of
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
                "tile_hist_private_kernel", "motion_search_kernel", "deblock_kernel",
                "deblock_bs_kernel", "parts_search_kernel", "subpel_planes_kernel",
                "subpel_floor_kernel", "intra_levels_kernel", "levels_split_kernel",
                "levels_chain_kernel", "levels_intra_kernel", "pack_i_kernel",
                "pack_p_kernel")
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


def moving_planes(dev, n: int = 3, seed: int = 2024):
    """``n`` 4K frames (y, cb, cr planes, contiguous, on ``dev``) of one
    structured picture moving by (1, 2) luma pixels a frame, its left
    quarter still and a block of noise jumping from frame to frame."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h, w = HEIGHT, WIDTH
    base = (np.linspace(0, 200, w + 2 * n, dtype=np.float32)[None, :]
            + np.linspace(0, 55, h + 2 * n, dtype=np.float32)[:, None])
    ycan = np.clip(base + rng.normal(0, 18, base.shape), 0, 255).astype(np.uint8)
    uvcan = rng.integers(96, 160, (h // 2 + n, w + 2 * n), dtype=np.uint8)
    out = []
    for i in range(n):
        y = ycan[i:i + h, 2 * i:2 * i + w].copy()
        uv = uvcan[i // 2:i // 2 + h // 2, 2 * i:2 * i + w].copy()
        y[:, :w // 4] = ycan[:h, :w // 4]
        uv[:, :w // 4] = uvcan[:h // 2, :w // 4]
        r0, c0 = (37 * i) % (h - 32), (101 * i) % (w - 64)
        y[r0:r0 + 32, c0:c0 + 64] = rng.integers(0, 256, (32, 64), dtype=np.uint8)
        uvt = torch.from_numpy(uv).to(dev).view(h // 2, w // 2, 2)
        out.append((torch.from_numpy(y).to(dev), uvt[..., 0].contiguous(),
                    uvt[..., 1].contiguous()))
    return out


def h264_readings(dev=None, deblock_rows=(), pack_runs=()) -> dict:
    """The device GOP encoder's kernels on one 4K P frame (see --h264); with
    ``deblock_rows``, H5 again at each of those MB rows a block, in trees
    that have ``deblock_rows_per_block``; with ``pack_runs``, H8 again at
    each of those MBs a warp, in trees that have ``PACK_P_RUN``."""
    import torch

    from opencv_opencl_tpu_torch.ops import h264_deblock as deblock_ops
    from opencv_opencl_tpu_torch.ops import h264_levels as levels_ops
    from opencv_opencl_tpu_torch.ops.cuda import h264_deblock as kd
    from opencv_opencl_tpu_torch.ops.cuda import h264_inter as ki
    from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kl

    dev = dev or torch.device("cuda", 0)
    h, w = HEIGHT, WIDTH
    mb_h, mb_w = h // 16, w // 16
    ref2, ref, src = moving_planes(dev)
    mv = torch.empty((mb_h, mb_w, 2), dtype=torch.int16, device=dev)
    pred = (torch.empty((h, w), dtype=torch.uint8, device=dev),
            torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev),
            torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev))
    res = {}
    for name, search, subpel in (("fastsub_s8", 8, 3), ("qpel_s4", 4, 2)):
        P, margin = levels_ops.search_plan(search, subpel)
        stack = torch.empty((P, h + 2 * margin, w + 2 * margin), dtype=torch.uint8,
                            device=dev)
        h3 = lambda: ki.planes_into(ref[0], margin, P, stack)  # noqa: E731
        h4 = lambda: ki.search_stack_into(  # noqa: E731
            src[0], stack, [ref], search, subpel, None, mv, None, *pred)
        h3()
        h4()
        res[f"h4_{name}_checksum"] = int(mv.to(torch.int64).abs().sum()
                                         + pred[0].to(torch.int64).sum())
        res[f"subpel_planes_{name}"] = device_ms(h3)
        res[f"motion_search_{name}_alone"] = device_ms(h4)
        res[f"motion_search_{name}_after_h3"] = (
            device_ms(lambda: (h3(), h4())) - res[f"subpel_planes_{name}"])
    # H3's half-pel and full-pel stacks, and each one's write floor
    for m, n in ((9, 16), (5, 4), (8, 1)):
        stack = torch.empty((n, h + 2 * m, w + 2 * m), dtype=torch.uint8, device=dev)
        ki.planes_into(ref[0], m, n, stack)
        res[f"h3_{n}p_checksum"] = int(stack.to(torch.int64).sum())
        if n != 16:
            res[f"subpel_planes_{n}p_m{m}"] = device_ms(
                lambda: ki.planes_into(ref[0], m, n, stack))
        if hasattr(ki, "planes_floor_into"):
            res[f"subpel_planes_{n}p_m{m}_floor"] = device_ms(
                lambda: ki.planes_floor_into(ref[0], m, n, stack))
    # zeros: with one reference no kernel writes the buffer's ref field, so
    # the checksum reads only what the kernels write
    out = torch.zeros(kl.p_level_words(mb_h, mb_w), dtype=torch.int16, device=dev)
    fields = kl.split_p_levels(out, mb_h, mb_w)
    ki.search_into(src[0], [ref], 8, 3, None, fields["mv"], None, *pred)
    res["p_levels"] = device_ms(lambda: kl.p_levels_into(*src, *pred, 30, out, motion=True))
    recon = kl.p_levels_into(*src, *pred, 30, out, motion=True)
    res["h2_checksum"] = int(out.to(torch.int64).abs().sum()
                             + sum(p.to(torch.int64).sum() for p in recon))
    iout = torch.empty(kl.level_words(mb_h, mb_w), dtype=torch.int16, device=dev)
    res["intra_levels"] = device_ms(lambda: kl.intra_levels(*src, 30, iout))
    res["intra_levels_full_recon"] = device_ms(
        lambda: kl.intra_levels(*src, 30, iout, full_recon=True))
    irec = kl.intra_levels(*src, 30, iout, full_recon=True)
    res["h1_checksum"] = int(iout.to(torch.int64).abs().sum()
                             + sum(p.to(torch.int64).sum() for p in irec))
    if hasattr(kl, "levels_plan"):
        # the split design's phases: each grid's device time in the
        # profiler's keys of an ordinary call
        for name, call in (
                ("p_levels", lambda: kl.p_levels_into(*src, *pred, 30, out, motion=True)),
                ("intra_levels", lambda: kl.intra_levels(*src, 30, iout))):
            us = profile_us(call)
            for grid, phase in (("levels_split_kernel", "a"), ("levels_chain_kernel", "b"),
                                ("levels_intra_kernel", "c")):
                res[f"{name}_{phase}_profiler_ms"] = pick(us, grid) / 1e3
    zero_ref = torch.zeros((mb_h, mb_w), dtype=torch.int16, device=dev)
    metas = {"p": (fields["mode"] >= 2, deblock_ops.nnz4_grid(fields["acz"]),
                   fields["mv"], zero_ref),
             "idr": (torch.ones((mb_h, mb_w), dtype=torch.bool, device=dev),
                     torch.zeros((4 * mb_h, 4 * mb_w), dtype=torch.bool, device=dev),
                     torch.zeros((mb_h, mb_w, 2), dtype=torch.int16, device=dev), zero_ref)}
    for name, meta in metas.items():
        work = tuple(p.clone() for p in recon)
        kd.deblock_into(*work, 30, *meta)
        work_once = tuple(p.clone() for p in work)
        res[f"h5_{name}_checksum"] = int(sum(p.to(torch.int64).sum() for p in work))
        res[f"deblock_{name}"] = device_ms(lambda: kd.deblock_into(*work, 30, *meta))
        if hasattr(kd, "deblock_floor_into"):
            res[f"deblock_{name}_floor"] = device_ms(
                lambda: kd.deblock_floor_into(*work, 30, *meta))
        if deblock_rows and hasattr(kd, "deblock_rows_per_block"):
            chosen = kd.deblock_rows_per_block
            for rows in deblock_rows:
                kd.deblock_rows_per_block = lambda mb_h, mb_w, r=rows: min(r, mb_h)
                again = tuple(p.clone() for p in recon)
                kd.deblock_into(*again, 30, *meta)
                res[f"h5_{name}_equal_rows_{rows}"] = all(
                    torch.equal(a, b) for a, b in zip(again, work_once))
                res[f"deblock_{name}_rows_{rows}"] = device_ms(
                    lambda: kd.deblock_into(*again, 30, *meta))
                res[f"deblock_{name}_floor_rows_{rows}"] = device_ms(
                    lambda: kd.deblock_floor_into(*again, 30, *meta))
            kd.deblock_rows_per_block = chosen
    pout = torch.empty(kl.p_level_words(mb_h, mb_w, True), dtype=torch.int16, device=dev)
    pf = kl.split_p_levels(pout, mb_h, mb_w, True)
    ref4 = torch.empty((mb_h, mb_w, 4), dtype=torch.int16, device=dev)
    for name, search, subpel, refs in (("s8", 8, 0, [ref]), ("halfpel_s8", 8, 1, [ref]),
                                       ("qpel_s4", 4, 2, [ref]), ("refs2_s8", 8, 0, [ref, ref2])):
        P, margin = levels_ops.search_plan(search, subpel)
        stack = torch.cat([levels_ops.subpel_planes(r[0], margin, P) for r in refs])
        two = ref4 if len(refs) > 1 else None
        h6 = lambda: ki.parts_stack_into(  # noqa: E731
            src[0], stack, refs, search, subpel, 30, pf["pmode"], pf["mv"], two, *pred)
        h6()
        res[f"h6_{name}_checksum"] = int(
            pf["mv"].to(torch.int64).abs().sum() + pf["pmode"].to(torch.int64).sum()
            + pred[0].to(torch.int64).sum() + pred[1].to(torch.int64).sum()
            + (0 if two is None else int(two.to(torch.int64).sum())))
        res[f"parts_search_{name}"] = device_ms(h6)
    # H1 with i4 (and chroma HORIZONTAL) on the same frame; in a tree with
    # the split i4 design its phases too
    i4out = torch.empty(kl.level_words(mb_h, mb_w, True, True), dtype=torch.int16,
                        device=dev)
    h1_i4 = lambda: kl.intra_levels(*src, 30, i4out, i4=True, chromah=True)  # noqa: E731
    res["intra_levels_i4_chromah"] = device_ms(h1_i4)
    res["h1_i4_checksum"] = int(i4out.to(torch.int64).abs().sum())
    if hasattr(kl, "I4_RECORD_WORDS"):
        us = profile_us(h1_i4)
        for grid, phase in (("levels_split_kernel", "a"), ("levels_chain_kernel", "b"),
                            ("levels_intra_kernel", "c")):
            res[f"intra_levels_i4_chromah_{phase}_profiler_ms"] = pick(us, grid) / 1e3
    # H7 on the default and the i4:chromah IDR of the frame, and where the
    # tree has it its read-and-store floor; H8 on a parts P frame
    from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as kb

    words = torch.empty((mb_h, mb_w, 64), dtype=torch.uint32, device=dev)
    nbits = torch.empty((mb_h, mb_w), dtype=torch.int32, device=dev)
    for name, buf, i4 in (("default", iout, False), ("i4_chromah", i4out, True)):
        iv = kl.split_levels(buf, mb_h, mb_w, i4, i4)
        ilv = (iv["zdc"], iv["acz"], iv["czdc"], iv["cacz"], iv["imode"])
        ex = {k: iv[k] for k in ("i4modes", "cmode") if k in iv}
        h7 = lambda: kb.pack_i_into(*ilv, words, nbits, **ex)  # noqa: E731
        h7()
        res[f"h7_{name}_checksum"] = int(words.view(torch.int32).to(torch.int64).abs().sum()
                                         + nbits.to(torch.int64).sum())
        res[f"pack_i_{name}"] = device_ms(h7)
        if hasattr(kb, "pack_i_floor_into"):
            res[f"pack_i_{name}_floor"] = device_ms(
                lambda: kb.pack_i_floor_into(*ilv, words, nbits, **ex))
    P, margin = levels_ops.search_plan(8, 0)
    stack = levels_ops.subpel_planes(ref[0], margin, P)
    ki.parts_stack_into(src[0], stack, [ref], 8, 0, 30, pf["pmode"], pf["mv"], None, *pred)
    kl.p_levels_into(*src, *pred, 30, pout, motion=True, parts=True)
    plv = (pf["mode"], pf["zdc"], pf["acz"], pf["czdc"], pf["cacz"])
    h8 = lambda: kb.pack_p_into(*plv, None, None, 1, words, nbits,  # noqa: E731
                                pmode=pf["pmode"], mv4=pf["mv"])
    h8()
    res["h8_checksum"] = int(words.view(torch.int32).to(torch.int64).abs().sum()
                             + nbits.to(torch.int64).sum())
    res["pack_p_parts_s8"] = device_ms(h8)
    if hasattr(kb, "pack_p_floor_into"):
        res["pack_p_parts_s8_floor"] = device_ms(lambda: kb.pack_p_floor_into(
            *plv, None, None, 1, words, nbits, pmode=pf["pmode"], mv4=pf["mv"]))
    # H8 on the P_16x16 frame of H2 above (fastsub at search 8)
    h8_16 = lambda: kb.pack_p_into(  # noqa: E731
        fields["mode"], fields["zdc"], fields["acz"], fields["czdc"], fields["cacz"],
        fields["mv"], None, 1, words, nbits)
    h8_16()
    res["h8_p16_checksum"] = int(words.view(torch.int32).to(torch.int64).abs().sum()
                                 + nbits.to(torch.int64).sum())
    res["pack_p_p16_fastsub_s8"] = device_ms(h8_16)
    if hasattr(kb, "pack_p_floor_into"):
        res["pack_p_p16_fastsub_s8_floor"] = device_ms(lambda: kb.pack_p_floor_into(
            fields["mode"], fields["zdc"], fields["acz"], fields["czdc"], fields["cacz"],
            fields["mv"], None, 1, words, nbits))
    if pack_runs and hasattr(kb, "PACK_P_RUN"):
        # the launchers' run argument; the wrappers keep their own runs
        p16 = (fields["mode"], fields["zdc"], fields["acz"], fields["czdc"], fields["cacz"],
               fields["mv"], None, 1, words, nbits, None, None, None)
        parts = (*plv, None, None, 1, words, nbits, pf["pmode"], pf["mv"], None)
        iv = kl.split_levels(iout, mb_h, mb_w)
        ilv = (iv["zdc"], iv["acz"], iv["czdc"], iv["cacz"], iv["imode"], words, nbits,
               None, None)
        for run in pack_runs:
            for name, launch, a, key in (("pack_p_parts_s8", kb._pack_p, parts, "h8_checksum"),
                                         ("pack_p_p16_fastsub_s8", kb._pack_p, p16,
                                          "h8_p16_checksum"),
                                         ("pack_i_default", kb._pack_i, ilv,
                                          "h7_default_checksum")):
                fn = lambda: launch(*a, floor=False, run=run)  # noqa: E731
                fn()
                res[f"{name}_equal_run_{run}"] = res[key] == int(
                    words.view(torch.int32).to(torch.int64).abs().sum()
                    + nbits.to(torch.int64).sum())
                res[f"{name}_run_{run}"] = device_ms(fn)
    return res


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
    ap.add_argument("--h264", action="store_true",
                    help="time the device GOP encoder's kernels instead")
    ap.add_argument("--deblock-rows", default="")
    ap.add_argument("--pack-runs", default="")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sweeps = [[int(r) for r in arg.split(",") if r]
              for arg in (args.interp_rows, args.fused_rows, args.cells_rows)]
    if args.child is not None:
        res = (h264_readings(deblock_rows=[int(r) for r in args.deblock_rows.split(",") if r],
                             pack_runs=[int(r) for r in args.pack_runs.split(",") if r])
               if args.child == "h264" else child(args.child, *sweeps))
        print(json.dumps(res), flush=True)
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
    for content in ["h264"] if args.h264 else args.contents.split(","):
        readings: dict = {tree: [] for tree in args.trees}
        for tree in order:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", content,
                 "--interp-rows", args.interp_rows, "--fused-rows", args.fused_rows,
                 "--cells-rows", args.cells_rows, "--deblock-rows", args.deblock_rows,
                 "--pack-runs", args.pack_runs],
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
