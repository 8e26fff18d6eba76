#!/usr/bin/env python3
"""Drive the PyTorch port's NV12 steps on a CUDA card and check them.

Run from the repository root, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. device   the card, and its name and power limit from nvidia-smi;
2. build    the CUDA kernels from ``opencv_opencl_tpu_torch/csrc``, and
            what ``nvcc -Xptxas -v`` says of K3 (also K5 and K3v1), K2 and
            K1's three instances (``tile_hist_kernel<4>``, also K8's, and
            ``<2>``, ``<8>`` for K10) (registers, shared memory, spills);
            the native C++ runtime from ``opencv_opencl_tpu_torch/native``
            (g++; seconds and path), which the relay's last runs need;
3. kernels  every kernel against its plain PyTorch version on the card,
            exact: K1, K2 and K3 over 4K batches (structured, random and
            ladder NV12 rows, and a view from column 1 whose base and rows
            lie off 16 bytes, which K1 and K3 read on their byte paths),
            1080p NV12 rows (K3's column groups change inside a 16-pixel
            unit), odd and tiny geometries, a constant frame,
            hist_rowstep=2 and several tile grids; K4 in
            place over a 4K NV12 batch with random and identity LUTs, at
            1079x1919 and on a constant frame; K7 at 4K and 1080p on
            structured, random and constant content, on a 4K ladder batch
            and on a view of the 4K batch from column 1 (its byte path), in
            place over NV12 Y rows, and against K3 followed by K1; K2 with
            one clip per frame in a device tensor; K6 at 4K b4, 1080p,
            1919x1079, on a 4K ladder batch, on a view of the 4K batch from
            column 1 and on a constant frame in place over NV12 Y rows, and
            against K3; K8 (the tile histograms of an extended frame, K1's
            kernel with 4 loads in flight) at 4K b4 on an 8x8 and a 1x1
            grid on structured, random and constant content, and against
            K1; K5 (K3's
            kernel with a row origin) on a 4K b4 NV12 batch cut into 2, 3
            and 4 bands of the sharded geometry (the last one short; at 4K
            the bands of 2 start inside a row pair), in place, on a band at
            row 13 and one past the frame, at 1080p, 1079x1919 and on a
            constant frame, against its plain version and against K3; K3v1
            (the same kernel over whole frames) against K3; K9 (K6's kernel
            on a band) on the same bands against K6 and K5; K1 per band of
            tile rows (space 3, with fake tile rows) against K1 on the
            whole frame; K10 (the tile histograms of an extended frame,
            K1's kernel with batch_rows loads in flight) at 4K b4 on an 8x8
            and a 1x1 grid for batch_rows 2, 4 and 8 on structured, random
            and constant content, on a 1919x1079 frame extended to its tile
            multiple and on an unaligned view, against its plain version,
            K1 and K8; K6r (the radix variant, K6's kernel) at 4K b4,
            1080p, 1919x1079 and on a constant frame in place over NV12 Y
            rows, against its plain version, K6 and K3;
4. golden   the CUDA paths against the numpy golden models, 0 LSB: CLAHE
            (natural and cell-grid backends) and histeq at 1080p, streaming
            CLAHE over four 1080p frames against golden's previous-frame
            LUT chain, auto-CLAHE over four 1080p frames at the clips the
            card chose, and a BGR round trip (CLAHE on Y, and NV12) against
            the port's ``core/color.py``; the sharded CLAHE and histeq steps
            at 1080p, every mesh position run in this process;
5. main     three paths driven through the port's ``FrameFeeder`` at 4K
            batch 4, 64 frames each, every output checked in sequence
            order against the plain versions: ``Enhancer`` with histeq
            (chroma gray), ``StreamingEnhancer`` (CLAHE clip 2.0, 8x8,
            passthrough) and ``Enhancer`` with CLAHE (the same); then two
            paths with no Enhancer, driven through their entry points on
            16 4K batches of 4 held on the card: ``clahe_auto`` (flat to
            rich content, four different clips) and ``clahe_apply`` with
            ``backend="pallas"`` (clip 2.0, 8x8); the launch counts are set
            to 0 before each path and read after it, and every kernel of a
            path must have been launched (K8 lies on no path: its launches
            are those of its phase-3 check, as are K3v1's and K9's); then
            the sharded path: ``ShardedEnhancer`` on a 1x1 mesh on NCCL in
            this process, through the ``FrameFeeder`` (CLAHE passthrough and
            histeq gray, 64 frames each), and the same two configurations
            on a 2x2 and a 1x4 mesh of four spawned processes that share
            the card (gloo, staged through the host), 16 batches each,
            every assembled batch and every position's band compared with
            the single-card ``Enhancer``'s inside each rank; then the relay
            apps as a user starts them, in this process:
            ``apps.relay.run`` at 3840x2160, batch 4, ``--source=test``, 64
            frames, for (a) histeq gray to the null sink, (b) CLAHE
            passthrough to a raw NV12 file that is compared frame by frame
            with the plain versions on the same ``TestSource`` frames, (c)
            ``--ref-frame``, (d) ``--mesh=1x1`` (the app starts its own
            one-rank NCCL group), (e) ``--sink=rtp+raw://`` on loopback,
            unpaced, the sink sending through the C++ packetizer
            (``rtp_send_raw``), with a receiver thread that reassembles
            frames and compares them, and (f) the same with ``--native``
            (the C++ staging ring, which the relay's started line must
            name); and ``apps.multi_relay.run`` with 4 streams of 1080p, 32
            frames each, on the Python queue and with ``--native
            --priorities``;
6. timings  CUDA-event medians of the five 4K batch-4 steps and of each
            kernel beside its plain version and, where one exists, the one
            PyTorch call that computes the same function; K2 also as a run
            of launches back to back over the count, beside an empty
            kernel launched the same way (the floor of a launch) and
            torch.profiler's device time per call; K6 beside K3, K8
            beside K1, K2 with a clip tensor beside K2 with an int, K5 and
            K3v1 beside K3 and K9 beside K6, in turns; the 1x1 sharded step
            beside the CLAHE step; each rank's time for its part of the 2x2
            and 1x4 steps; the feeder's end-to-end rates, on the Python
            queue and on the C++ ring; torch.profiler's device time per
            kernel for each step; the relay's and the multi-stream relay's
            own ``Shutdown`` rates; K10 for each
            batch_rows beside K1 and K8 on structured, random and constant
            content, and K6r beside K6 and K5, in turns.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports no JAX
and nothing of the JAX package: the oracles on the card are the plain
versions and the port's ``core/golden.py``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import socket
import statistics
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from opencv_opencl_tpu_torch import native
from opencv_opencl_tpu_torch.apps import multi_relay, relay
from opencv_opencl_tpu_torch.core import color as color_oracle
from opencv_opencl_tpu_torch.core import golden
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.io.rtp import RtpUdpReceiver, RtpUdpSink
from opencv_opencl_tpu_torch.io.videofile import TestSource
from opencv_opencl_tpu_torch.models.enhancer import (
    Enhancer,
    EnhancerConfig,
    StreamingEnhancer,
    build_enhance_fn,
    build_streaming_clahe_fn,
    initial_hists,
    make_enhance_y,
)
from opencv_opencl_tpu_torch.ops import auto_clahe
from opencv_opencl_tpu_torch.ops import clahe as clahe_ops
from opencv_opencl_tpu_torch.ops import color
from opencv_opencl_tpu_torch.ops import cuda as cuda_ops
from opencv_opencl_tpu_torch.ops import histeq as histeq_ops
from opencv_opencl_tpu_torch.ops import histogram
from opencv_opencl_tpu_torch.ops.cuda import _build, lut, natural
from opencv_opencl_tpu_torch.parallel import launch, sharded
from opencv_opencl_tpu_torch.runtime.feeder import FrameFeeder
from opencv_opencl_tpu_torch.utils.envinfo import nvidia_smi_name_power

WIDTH, HEIGHT, BATCH = 3840, 2160, 4
CLIP, GRID = 2.0, (8, 8)
FEEDER_FRAMES = 64
DISTINCT_FRAMES = 8
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, and the
# f32 rate outside the tensor cores, which bounds the kernels' arithmetic
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
KERNELS = (
    # (kernel name, wrapper, source, TPU entry function it replaces); a name
    # with a ":suffix" is a second TPU kernel behind the same CUDA kernel
    ("tile_hist_kernel", "tile_histograms",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/natural.py:493"),
    ("build_luts_kernel", "build_luts",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/natural.py:417"),
    ("interp_kernel", "clahe_interpolate",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/natural.py:273"),
    ("apply_lut_kernel", "apply_lut",
     "opencv_opencl_tpu_torch/csrc/lut.cu",
     "opencv_opencl_tpu/ops/pallas/lut_kernels.py:87"),
    ("interp_hist_kernel", "clahe_interp_and_hist",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/experiments.py:212"),
    ("interp_cells_kernel", "clahe_interpolate_cells",
     "opencv_opencl_tpu_torch/csrc/lut.cu",
     "opencv_opencl_tpu/ops/pallas/lut_kernels.py:477"),
    ("tile_hist_kernel:extended", "tile_histograms_extended",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/lut_kernels.py:142"),
    ("interp_kernel:band", "clahe_interpolate_band",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/natural.py:525"),
    ("interp_kernel:variant1", "clahe_interpolate_pack",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/natural.py:273"),
    ("interp_cells_kernel:band", "clahe_interpolate_cells_band",
     "opencv_opencl_tpu_torch/csrc/lut.cu",
     "opencv_opencl_tpu/ops/pallas/lut_kernels.py:356"),
    ("tile_hist_kernel:batched", "tile_histograms_batched",
     "opencv_opencl_tpu_torch/csrc/natural.cu",
     "opencv_opencl_tpu/ops/pallas/experiments.py:116"),
    ("interp_cells_kernel:radix", "clahe_interpolate_cells_radix",
     "opencv_opencl_tpu_torch/csrc/lut.cu",
     "opencv_opencl_tpu/ops/pallas/lut_kernels.py:477:radix"),
)
# K8, K3v1, K9, K10 and K6r lie on no path (nor do their TPU kernels on any
# path of the JAX package): their launches are those of their phase-3 checks
OFF_PATH = ("tile_histograms_extended", "clahe_interpolate_pack",
            "clahe_interpolate_cells_band", "tile_histograms_batched",
            "clahe_interpolate_cells_radix")
# K2 launches a timed run queues behind one spin of the card
K2_LAUNCHES = 200
# batches per configuration on the spawned 2x2 and 1x4 meshes
SHARDED_BATCHES = 4
RELAY_FRAMES = 64
MULTI_STREAMS, MULTI_FRAMES = 4, 32
# the raw RTP receiver's socket buffer: a 4K frame leaves the C++ sender
# as one burst of ~13,000 datagrams (~30 MB of kernel buffers on loopback)
RECEIVER_BUFFER = 1 << 26
SPAWN_TIMEOUT = 420.0


def clahe_config(h=HEIGHT, w=WIDTH) -> tuple[FrameSpec, EnhancerConfig]:
    """The CLAHE steps: clip 2.0, 8x8 tiles, chroma passthrough."""
    return FrameSpec(width=w, height=h), EnhancerConfig(
        op="clahe", clip_limit=CLIP, tile_grid=GRID,
        chroma=ChromaPolicy.PASSTHROUGH)


def histeq_config(h=HEIGHT, w=WIDTH) -> tuple[FrameSpec, EnhancerConfig]:
    """The histeq step: EnhancerConfig's defaults (histeq, chroma gray)."""
    return FrameSpec(width=w, height=h), EnhancerConfig()


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


def ladder_y(rng, n, h, w) -> np.ndarray:
    """Frames from flat to rich content (a flat field with faint noise, a
    narrow normal, gradient plus noise, uniform random, repeating), so that
    auto-CLAHE picks a different clip for each."""
    kinds = [
        lambda: rng.normal(100, 1.5, (h, w)),
        lambda: rng.normal(128, 8, (h, w)),
        lambda: structured_y(rng, 1, h, w)[0].astype(np.float64),
        lambda: rng.integers(0, 256, (h, w)).astype(np.float64),
    ]
    return np.stack([np.clip(kinds[i % 4](), 0, 255).astype(np.uint8)
                     for i in range(n)])


def nv12_batch(rng, n, h, w, make_y=structured_y) -> np.ndarray:
    y = make_y(rng, n, h, w)
    uv = rng.integers(0, 256, (n, h // 2, w), dtype=np.uint8)
    return np.concatenate([y, uv], axis=1)


def plain_step(frames: torch.Tensor, plan, rowstep: int = 1) -> torch.Tensor:
    """The CLAHE step through the three plain versions only."""
    hists = natural.tile_histograms_ref(frames, plan, rowstep)
    luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
    return natural.clahe_interpolate_ref(frames, luts, plan)


def whole_frame_plan(h, w):
    """K1's geometry for a whole-frame histogram (ops/histogram.hist256)."""
    return clahe_ops.make_clahe_plan(h, w, 0.0, (1, 1))


def plain_histeq(frames: torch.Tensor) -> torch.Tensor:
    """The histeq step through the plain versions only."""
    n, h, w = frames.shape
    hists = natural.tile_histograms_ref(frames, whole_frame_plan(h, w))[:, 0]
    return lut.apply_lut_ref(frames, histogram.equalize_lut(hists, h * w))


def plain_auto(frames: torch.Tensor, grid=GRID) -> tuple[torch.Tensor, torch.Tensor]:
    """The auto-CLAHE step through the plain versions only: its output and
    its f32 clips."""
    n, h, w = frames.shape
    plan = clahe_ops.make_clahe_plan(h, w, 40.0, grid)
    hist = natural.tile_histograms_ref(frames, whole_frame_plan(h, w))[:, 0]
    clips = auto_clahe.clip_from_hists(hist, h * w)
    luts = natural.build_luts_ref(natural.tile_histograms_ref(frames, plan),
                                  auto_clahe.int_clips(clips, plan.tile_area),
                                  plan.lut_scale)
    spec = lut.make_interp_spec(h, w, 40.0, grid)
    check(spec is not None, f"{h}x{w} has no cell-grid spec")
    return lut.clahe_interpolate_cells_ref(frames, luts, spec), clips


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


# ------------------------------------------------------------- phase 3 ----


def kernel_cases(rng):
    """(label, frames, h, clip, grid, rowstep, col0): ``frames`` is (N, h, W)
    or an NV12 batch (N, h*3/2, W), whose strided Y rows from column
    ``col0`` on go to the kernels (``col0 = 1``: a view whose base and
    rows lie off 16 bytes, which K1 and K3 read on their byte paths)."""
    four_k = nv12_batch(rng, BATCH, HEIGHT, WIDTH)
    four_k_random = four_k.copy()
    four_k_random[:, :HEIGHT] = random_y(rng, BATCH, HEIGHT, WIDTH)
    return [
        ("4k_b4_random_nv12", four_k_random, HEIGHT, CLIP, GRID, 1, 0),
        ("4k_b4_structured_nv12", four_k, HEIGHT, CLIP, GRID, 1, 0),
        ("4k_b4_rowstep2_nv12", four_k, HEIGHT, CLIP, GRID, 2, 0),
        ("4k_b4_nv12_view_from_column_1", four_k, HEIGHT, CLIP, GRID, 1, 1),
        ("4k_b4_ladder_nv12", nv12_batch(rng, BATCH, HEIGHT, WIDTH, ladder_y),
         HEIGHT, CLIP, GRID, 1, 0),
        ("1080p_b4_structured_nv12", nv12_batch(rng, BATCH, 1080, 1920), 1080,
         CLIP, GRID, 1, 0),
        ("1079x1919_odd", random_y(rng, 2, 1079, 1919), 1079, CLIP, GRID, 1, 0),
        ("4k_constant", np.full((2, HEIGHT, WIDTH), 77, np.uint8), HEIGHT,
         CLIP, GRID, 1, 0),
        ("6x6_grid8x8", random_y(rng, 3, 6, 6), 6, CLIP, GRID, 1, 0),
        ("3x3_grid8x8_pad_ge_dim", random_y(rng, 2, 3, 3), 3, 40.0, GRID, 1, 0),
        ("270x480_grid1x1", random_y(rng, 2, 270, 480), 270, CLIP, (1, 1), 1, 0),
        ("97x131_grid3x5", random_y(rng, 2, 97, 131), 97, 40.0, (3, 5), 1, 0),
        ("64x128_noclip", random_y(rng, 1, 64, 128), 64, 0.0, GRID, 1, 0),
    ]


def residual_edge_hists(plan) -> np.ndarray:
    """Histograms whose redistribution residual is 0, 1 and 255 and the
    non-divisors 3, 100 and 129 of 256 (steps 85, 2 and 1), one bin holding
    everything, and a uniform one."""
    hists = np.zeros((1, plan.num_tiles, 256), np.int32)
    h, c, area = hists[0], plan.clip, plan.tile_area
    h[0, 0] = area
    h[1, :] = area // 256
    h[1, 0] += area - h[1].sum()
    for row, e in enumerate((255, 256, 1, 3, 100, 129), start=2):
        h[row, :2] = [c + e, area - (c + e)]
    return hists


def phase_clahe_kernels(device, cases) -> dict[str, int]:
    """K1, K2 and K3 against their plain versions."""
    errs = {"tile_hist_kernel": 0, "build_luts_kernel": 0, "interp_kernel": 0}
    for label, frames_np, h, clip, grid, rowstep, col0 in cases:
        batch = torch.from_numpy(frames_np).to(device)
        y = batch[:, :h, col0:]
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
        # in place, as the NV12 step runs it: the chroma rows (and the
        # columns left of col0) stay untouched
        inplace = batch.clone()
        natural.clahe_interpolate(inplace[:, :h, col0:], lr, plan,
                                  out=inplace[:, :h, col0:])
        e3 = max(e3, max_err(inplace[:, :h, col0:], orf),
                 max_err(inplace[:, h:], batch[:, h:]),
                 max_err(inplace[:, :h, :col0], batch[:, :h, :col0]))
        if label == "4k_b4_structured_nv12":  # K2 alone on edge cases
            edge = torch.from_numpy(residual_edge_hists(plan)).to(device)
            e2 = max(e2, max_err(natural.build_luts(edge, plan.clip, plan.lut_scale),
                                 natural.build_luts_ref(edge, plan.clip, plan.lut_scale)))
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K1 {e1} K2 {e2} K3 {e3} (max abs err; 16-byte "
              f"paths: K1 {natural.tile_hist_vec(y, plan)}, K3 "
              f"{natural.interp_vec(y, ok)})", flush=True)
        for name, e in zip(errs, (e1, e2, e3)):
            errs[name] = max(errs[name], e)
    return errs


def phase_lut_kernel(device, rng) -> int:
    """K4 against its plain version: in place over the Y rows of a 4K NV12
    batch with a random and with the identity LUT per frame, an odd
    geometry, and a constant frame."""
    four_k = nv12_batch(rng, BATCH, HEIGHT, WIDTH)
    identity = np.tile(np.arange(256, dtype=np.uint8), (BATCH, 1))
    cases = [
        ("4k_b4_nv12_random_lut", four_k, HEIGHT,
         rng.integers(0, 256, (BATCH, 256), dtype=np.uint8)),
        ("4k_b4_nv12_identity_lut", four_k, HEIGHT, identity),
        ("1079x1919_odd", random_y(rng, 2, 1079, 1919), 1079,
         rng.integers(0, 256, (2, 256), dtype=np.uint8)),
        ("4k_constant", np.full((2, HEIGHT, WIDTH), 77, np.uint8), HEIGHT,
         rng.integers(0, 256, (2, 256), dtype=np.uint8)),
    ]
    worst = 0
    for label, frames_np, h, luts_np in cases:
        batch = torch.from_numpy(frames_np).to(device)
        y = batch[:, :h]
        luts = torch.from_numpy(luts_np).to(device)
        want = lut.apply_lut_ref(y, luts)
        e = max_err(lut.apply_lut(y, luts), want)
        inplace = batch.clone()
        lut.apply_lut(inplace[:, :h], luts, out=inplace[:, :h])
        e = max(e, max_err(inplace[:, :h], want), max_err(inplace[:, h:], batch[:, h:]))
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K4 {e} (max abs err)", flush=True)
        worst = max(worst, e)
    return worst


def phase_fused_kernel(device, rng) -> int:
    """K7 against its plain version and against K3 followed by K1, in place
    over NV12 Y rows, with the LUTs of other frames (the previous ones): at
    4K and 1080p (16-byte units), on a 4K view from column 1, 3832 columns
    wide (base and rows off 16 bytes, tile width 479: the byte path), and on
    a 4K ladder batch (flat to rich content)."""
    four_k = nv12_batch(rng, BATCH, HEIGHT, WIDTH)
    cases = [
        # (label, frames, height, first column, width)
        ("4k_b4_structured_nv12", four_k, HEIGHT, 0, WIDTH),
        ("4k_b2_random_nv12", np.concatenate(
            [random_y(rng, 2, HEIGHT, WIDTH),
             random_y(rng, 2, HEIGHT // 2, WIDTH)], axis=1), HEIGHT, 0, WIDTH),
        ("4k_constant_nv12", np.full((1, HEIGHT * 3 // 2, WIDTH), 77, np.uint8),
         HEIGHT, 0, WIDTH),
        ("4k_b4_nv12_view_from_column_1", four_k, HEIGHT, 1, 3832),
        ("4k_b4_ladder_nv12", nv12_batch(rng, BATCH, HEIGHT, WIDTH, ladder_y),
         HEIGHT, 0, WIDTH),
        ("1080p_b4_structured_nv12", nv12_batch(rng, BATCH, 1080, 1920), 1080, 0,
         1920),
        ("1080p_b2_random_nv12", random_y(rng, 2, 1620, 1920), 1080, 0, 1920),
        ("1080p_constant_nv12", np.full((2, 1620, 1920), 200, np.uint8), 1080, 0,
         1920),
    ]
    worst = 0
    for label, frames_np, h, col0, w in cases:
        batch = torch.from_numpy(frames_np).to(device)
        y = batch[:, :h, col0:col0 + w]
        n = y.shape[0]
        plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
        prev = torch.from_numpy(structured_y(rng, n, h, w)).to(device)
        luts = natural.build_luts_ref(natural.tile_histograms_ref(prev, plan),
                                      plan.clip, plan.lut_scale)
        out_ref, hists_ref = natural.clahe_interp_and_hist_ref(y, luts, plan)
        separate = natural.clahe_interpolate(y, luts, plan)
        separate_h = natural.tile_histograms(y, plan)
        out, hists = natural.clahe_interp_and_hist(y, luts, plan)
        e_plain = max(max_err(out, out_ref), max_err(hists, hists_ref))
        inplace = batch.clone()
        view = inplace[:, :h, col0:col0 + w]
        _, hists = natural.clahe_interp_and_hist(view, luts, plan, out=view)
        e_plain = max(e_plain, max_err(view, out_ref), max_err(hists, hists_ref),
                      max_err(inplace[:, h:], batch[:, h:]),
                      max_err(inplace[:, :h, :col0], batch[:, :h, :col0]),
                      max_err(inplace[:, :h, col0 + w:], batch[:, :h, col0 + w:]))
        e_k3k1 = max(max_err(out, separate), max_err(hists, separate_h))
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K7 {e_plain} vs plain, {e_k3k1} vs K3+K1 "
              f"(max abs err; 16-byte path {natural.fused_vec(y, y, plan)})",
              flush=True)
        worst = max(worst, e_plain, e_k3k1)
    return worst


def phase_clip_tensor(device, rng) -> int:
    """K2 with one clip per frame, read on the device, against its plain
    version: 4K b4 histograms with clips from auto-CLAHE's range, with 0
    (no clipping), 1 and beyond every count, and the residual edge cases."""
    plan = clahe_ops.make_clahe_plan(HEIGHT, WIDTH, CLIP, GRID)
    y = torch.from_numpy(structured_y(rng, BATCH, HEIGHT, WIDTH)).to(device)
    hists = natural.tile_histograms_ref(y, plan)
    edge = torch.from_numpy(residual_edge_hists(plan)).to(device)
    cases = [("4k_b4_auto_range", hists, [506, 1012, 1519, 2025]),
             ("4k_b4_0_1_clip_huge", hists, [0, 1, plan.clip, 1 << 30]),
             ("residual_edges", edge, [plan.clip])]
    worst = 0
    for label, h, clips in cases:
        c = torch.tensor(clips, dtype=torch.int32, device=device)
        e = max_err(natural.build_luts(h, c, plan.lut_scale),
                    natural.build_luts_ref(h, c, plan.lut_scale))
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K2 with a clip tensor {e} (max abs err)", flush=True)
        worst = max(worst, e)
    return worst


def phase_cell_kernel(device, rng) -> int:
    """K6 against its plain version and against K3 on the same LUTs, in
    place over NV12 Y rows: 4K b4 (whole 16-byte units), 1080p (tile height
    135; 8 head and 8 tail bytes a cell), 1919x1079 and a view of the 4K
    batch from column 1 (the byte path), a 4K ladder batch and a constant
    frame; the LUTs are those of other frames."""
    four_k = nv12_batch(rng, BATCH, HEIGHT, WIDTH)
    cases = [
        # (label, frames, height, first column, width)
        ("4k_b4_structured_nv12", four_k, HEIGHT, 0, WIDTH),
        ("1080p_b4_random_nv12", nv12_batch(rng, BATCH, 1080, 1920, random_y), 1080,
         0, 1920),
        ("1079x1919_odd", random_y(rng, 2, 1079, 1919), 1079, 0, 1919),
        ("4k_b4_nv12_view_from_column_1", four_k, HEIGHT, 1, WIDTH - 1),
        ("4k_b4_ladder_nv12", nv12_batch(rng, BATCH, HEIGHT, WIDTH, ladder_y),
         HEIGHT, 0, WIDTH),
        ("4k_constant", np.full((1, HEIGHT, WIDTH), 77, np.uint8), HEIGHT, 0, WIDTH),
    ]
    worst = 0
    for label, frames_np, h, col0, w in cases:
        spec = lut.make_interp_spec(h, w, CLIP, GRID)
        check(spec is not None, f"{label} has no cell-grid spec")
        batch = torch.from_numpy(frames_np).to(device)
        y = batch[:, :h, col0:col0 + w]
        n = y.shape[0]
        plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
        prev = torch.from_numpy(structured_y(rng, n, h, w)).to(device)
        luts = natural.build_luts_ref(natural.tile_histograms_ref(prev, plan),
                                      plan.clip, plan.lut_scale)
        want = lut.clahe_interpolate_cells_ref(y, luts, spec)
        got = lut.clahe_interpolate_cells(y, luts, spec)
        inplace = batch.clone()
        view = inplace[:, :h, col0:col0 + w]
        lut.clahe_interpolate_cells(view, luts, spec, out=view)
        e_plain = max(max_err(got, want), max_err(view, want),
                      max_err(inplace[:, h:], batch[:, h:]),
                      max_err(inplace[:, :h, :col0], batch[:, :h, :col0]))
        e_k3 = max_err(got, natural.clahe_interpolate(y, luts, plan))
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K6 {e_plain} vs plain, {e_k3} vs K3 (max abs "
              f"err; pad_top {spec.pad_top}, pad_left {spec.pad_left}, 16-byte "
              f"path {natural.interp_vec(y, got)})", flush=True)
        worst = max(worst, e_plain, e_k3)
    return worst


def phase_extended_hist_kernel(device, rng) -> tuple[int, int]:
    """K8 (K1's kernel on an extended frame) against its plain version and
    against K1 on the same tile-divisible 4K b4 frames (structured NV12 Y
    rows, random and constant), at an 8x8 and a 1x1 grid; returns the error
    and K8's launches here."""
    frames = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH)).to(device)
    noise = torch.from_numpy(random_y(rng, BATCH, HEIGHT, WIDTH)).to(device)
    const = torch.full((BATCH, HEIGHT, WIDTH), 77, dtype=torch.uint8, device=device)
    lut.tile_histograms_extended.launches = 0
    worst = 0
    for label, y in (("4k_b4_structured_nv12", frames[:, :HEIGHT]),
                     ("4k_b4_random", noise), ("4k_b4_constant", const)):
        for grid in (GRID, (1, 1)):
            plan = clahe_ops.make_clahe_plan(HEIGHT, WIDTH, CLIP, grid)
            args = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
            got = lut.tile_histograms_extended(y, *args)
            e_plain = max_err(got, lut.tile_histograms_extended_ref(y, *args))
            e_k1 = max_err(got, natural.tile_histograms(y, plan))
            torch.cuda.synchronize(device)
            print(f"kernels {label} grid {grid[0]}x{grid[1]}: K8 {e_plain} vs "
                  f"plain, {e_k1} vs K1 (max abs err)", flush=True)
            worst = max(worst, e_plain, e_k1)
    return worst, lut.tile_histograms_extended.launches


def sharded_bands(plan, space: int) -> list[tuple[int, int]]:
    """The sharded step's interpolation bands for ``space`` positions:
    (row0, row1) per position, clipped to the frame (the last one short)."""
    rows_loc = sharded._clahe_geometry(plan, space)[2] // space
    return [(min(s * rows_loc, plan.height), min((s + 1) * rows_loc, plan.height))
            for s in range(space)]


def phase_band_kernels(device, rng) -> tuple[dict[str, int], dict[str, int]]:
    """K5 against its plain version and against K3, K3v1 against K3, K9
    against K6 and K5, on the sharded step's bands (2, 3 and 4 positions,
    row0 = s * rows_loc, the last band short), in place over NV12 Y rows;
    K1 per band of tile rows (3 positions, with fake tile rows) against K1
    on the whole frame.  Returns the errors, and the launches made here by
    the wrappers that lie on no path."""
    cases = [
        ("4k_b4_structured_nv12", nv12_batch(rng, BATCH, HEIGHT, WIDTH), HEIGHT, WIDTH),
        ("1080p_b4_random_nv12", nv12_batch(rng, BATCH, 1080, 1920, random_y), 1080, 1920),
        ("1079x1919_odd", random_y(rng, 2, 1079, 1919), 1079, 1919),
        ("4k_constant", np.full((1, HEIGHT, WIDTH), 77, np.uint8), HEIGHT, WIDTH),
    ]
    natural.clahe_interpolate_pack.launches = 0
    lut.clahe_interpolate_cells_band.launches = 0
    errs = {"interp_kernel:band": 0, "interp_kernel:variant1": 0,
            "interp_cells_kernel:band": 0, "tile_hist_kernel": 0}
    for label, frames_np, h, w in cases:
        plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
        spec = lut.make_interp_spec(h, w, CLIP, GRID)
        check(spec is not None, f"{label} has no cell-grid spec")
        batch = torch.from_numpy(frames_np).to(device)
        y = batch[:, :h]
        n = y.shape[0]
        prev = torch.from_numpy(structured_y(rng, n, h, w)).to(device)
        luts = natural.build_luts_ref(natural.tile_histograms_ref(prev, plan),
                                      plan.clip, plan.lut_scale)
        k3 = natural.clahe_interpolate(y, luts, plan)
        k6 = lut.clahe_interpolate_cells(y, luts, spec)
        e_v1 = max_err(natural.clahe_interpolate_pack(y, luts, plan), k3)
        e_v1 = max(e_v1, max_err(natural.clahe_interpolate_pack_ref(y, luts, plan), k3))
        e_k5 = e_k5_k3 = e_k9 = 0
        vec = set()
        for space in (2, 3, 4):
            inplace5, inplace9 = batch.clone(), batch.clone()
            for row0, row1 in sharded_bands(plan, space):
                band = y[:, row0:row1]
                want = natural.clahe_interpolate_band_ref(band, luts, plan, row0)
                got = natural.clahe_interpolate_band(band, luts, plan, row0)
                e_k5 = max(e_k5, max_err(got, want))
                e_k5_k3 = max(e_k5_k3, max_err(got, k3[:, row0:row1]))
                got9 = lut.clahe_interpolate_cells_band(band, luts, spec, row0)
                e_k9 = max(e_k9, max_err(got9, k6[:, row0:row1]), max_err(got9, got),
                           max_err(got9, lut.clahe_interpolate_cells_band_ref(
                               band, luts, spec, row0)))
                for buf, fn, geom in ((inplace5, natural.clahe_interpolate_band, plan),
                                      (inplace9, lut.clahe_interpolate_cells_band, spec)):
                    view = buf[:, row0:row1]
                    fn(view, luts, geom, row0, out=view)
                vec.add(natural.interp_vec(inplace5[:, row0:row1], inplace5[:, row0:row1]))
            # the bands written in place make up the whole frame; the chroma
            # rows stay untouched
            e_k5 = max(e_k5, max_err(inplace5[:, :h], k3),
                       max_err(inplace5[:, h:], batch[:, h:]))
            e_k9 = max(e_k9, max_err(inplace9[:, :h], k3),
                       max_err(inplace9[:, h:], batch[:, h:]))
        # a band at a row0 that is no multiple of 8 (inside a row pair, as
        # the 4K bands at row0 1080 of space 2 are), and one that runs past
        # the frame's last row (those rows are not written)
        for row0, rows in ((13, 700), (h - 37, 64)):
            src = torch.cat([y[:, row0:], y[:, :64]], dim=1)[:, :rows].contiguous()
            live = min(rows, h - row0)
            for fn, geom in ((natural.clahe_interpolate_band, plan),
                             (lut.clahe_interpolate_cells_band, spec)):
                got = fn(src, luts, geom, row0)
                e = max(max_err(got[:, :live], k3[:, row0:row0 + live]),
                        max_err(got[:, live:], src[:, live:]))
                if fn is natural.clahe_interpolate_band:
                    e_k5 = max(e_k5, e)
                else:
                    e_k9 = max(e_k9, e)
        # K1 on the bands of tile rows of 3 positions against the whole frame
        whole = natural.tile_histograms(y, plan)
        tiles_loc = sharded._clahe_geometry(plan, 3)[0] // 3
        parts = []
        for s in range(3):
            tile_rows = (min(s * tiles_loc, plan.tiles_y),
                         min((s + 1) * tiles_loc, plan.tiles_y))
            lo, hi = natural.band_source_rows(plan, tile_rows)
            parts.append(natural.tile_histograms(y[:, lo:hi], plan, 1, tile_rows, lo))
            check(parts[-1].shape[1] == (tile_rows[1] - tile_rows[0]) * plan.tiles_x,
                  f"{label}: band histograms of shape {tuple(parts[-1].shape)}")
        e_k1 = max_err(torch.cat(parts, dim=1), whole)
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K5 {e_k5} vs plain, {e_k5_k3} vs K3; K3v1 {e_v1} vs "
              f"K3; K9 {e_k9} vs K6, K5 and plain; K1 per band {e_k1} vs whole "
              f"(max abs err; K5's bands in place on the 16-byte path: "
              f"{sorted(vec)})", flush=True)
        for name, e in (("interp_kernel:band", max(e_k5, e_k5_k3)),
                        ("interp_kernel:variant1", e_v1),
                        ("interp_cells_kernel:band", e_k9), ("tile_hist_kernel", e_k1)):
            errs[name] = max(errs[name], e)
    return errs, {"clahe_interpolate_pack": natural.clahe_interpolate_pack.launches,
                  "clahe_interpolate_cells_band":
                      lut.clahe_interpolate_cells_band.launches}


def phase_batched_hist_kernel(device, rng) -> tuple[int, int]:
    """K10 against its plain version, K1 and K8, for batch_rows 2, 4 and 8:
    4K b4 (structured NV12 Y rows, random, constant) on an 8x8 and a 1x1
    grid (K1's 16-byte path with 2, 4 and 8 loads in flight), a 1919x1079
    frame reflect-extended to its tile multiple, and an unaligned view with
    30-wide tiles (K1's byte path); returns the error and K10's launches
    here."""
    frames = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH)).to(device)
    natural.tile_histograms_batched.launches = 0
    cases = [("4k_b4_structured_nv12", frames[:, :HEIGHT], (GRID, (1, 1))),
             ("4k_b4_random", torch.from_numpy(
                 random_y(rng, BATCH, HEIGHT, WIDTH)).to(device), (GRID, (1, 1))),
             ("4k_b4_constant", torch.full((BATCH, HEIGHT, WIDTH), 77,
                                           dtype=torch.uint8, device=device),
              (GRID, (1, 1))),
             ("1079x1919_odd_extended", torch.from_numpy(
                 random_y(rng, 2, 1079, 1919)).to(device), (GRID,))]
    worst = 0
    for label, y, grids in cases:
        for grid in grids:
            plan = clahe_ops.make_clahe_plan(y.shape[1], y.shape[2], CLIP, grid)
            ext = natural.extend(y, plan)
            args = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
            want = natural.tile_histograms_batched_ref(ext, *args)
            k1 = natural.tile_histograms(y, plan)
            k8 = lut.tile_histograms_extended(ext, *args)
            errs = []
            for batch_rows in (2, 4, 8):
                got = natural.tile_histograms_batched(ext, *args, batch_rows=batch_rows)
                errs.append(max(max_err(got, want), max_err(got, k1), max_err(got, k8)))
            torch.cuda.synchronize(device)
            print(f"kernels {label} grid {grid[0]}x{grid[1]}: K10 {errs} for "
                  f"batch_rows 2, 4, 8 vs plain, K1 and K8 (max abs err)", flush=True)
            worst = max(worst, *errs)
    wide = torch.from_numpy(random_y(rng, 2, 48, 131)).to(device)
    view = wide[:, :, 7:127]            # base and row stride off 16 bytes
    want = natural.tile_histograms_batched_ref(view, 4, 4, 12, 30)
    errs = [max_err(natural.tile_histograms_batched(view, 4, 4, 12, 30, r), want)
            for r in (2, 4, 8)]
    torch.cuda.synchronize(device)
    print(f"kernels 48x120_view_tiles_12x30_unaligned: K10 {errs} for batch_rows "
          f"2, 4, 8 vs plain (max abs err)", flush=True)
    return max(worst, *errs), natural.tile_histograms_batched.launches


def phase_radix_cell_kernel(device, rng) -> tuple[int, int]:
    """K6r against its plain version, K6 and K3 on the same LUTs (those of
    other frames), in place over NV12 Y rows: 4K b4, 1080p, 1919x1079 and a
    constant frame; returns the error and K6r's launches here."""
    cases = [
        ("4k_b4_structured_nv12", nv12_batch(rng, BATCH, HEIGHT, WIDTH), HEIGHT, WIDTH),
        ("1080p_b4_random_nv12", nv12_batch(rng, BATCH, 1080, 1920, random_y), 1080, 1920),
        ("1079x1919_odd", random_y(rng, 2, 1079, 1919), 1079, 1919),
        ("4k_constant", np.full((1, HEIGHT, WIDTH), 77, np.uint8), HEIGHT, WIDTH),
    ]
    lut.clahe_interpolate_cells.radix_launches = 0
    worst = 0
    for label, frames_np, h, w in cases:
        spec = lut.make_interp_spec(h, w, CLIP, GRID)
        check(spec is not None, f"{label} has no cell-grid spec")
        batch = torch.from_numpy(frames_np).to(device)
        y = batch[:, :h]
        plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
        prev = torch.from_numpy(structured_y(rng, y.shape[0], h, w)).to(device)
        luts = natural.build_luts_ref(natural.tile_histograms_ref(prev, plan),
                                      plan.clip, plan.lut_scale)
        want = lut.clahe_interpolate_cells_ref(y, luts, spec, radix=True)
        got = lut.clahe_interpolate_cells(y, luts, spec, radix=True)
        inplace = batch.clone()
        lut.clahe_interpolate_cells(inplace[:, :h], luts, spec, out=inplace[:, :h],
                                    radix=True)
        e_plain = max(max_err(got, want), max_err(inplace[:, :h], want),
                      max_err(inplace[:, h:], batch[:, h:]))
        e_k6 = max_err(got, lut.clahe_interpolate_cells(y, luts, spec))
        e_k3 = max_err(got, natural.clahe_interpolate(y, luts, plan))
        torch.cuda.synchronize(device)
        print(f"kernels {label}: K6r {e_plain} vs plain, {e_k6} vs K6, {e_k3} vs K3 "
              f"(max abs err)", flush=True)
        worst = max(worst, e_plain, e_k6, e_k3)
    return worst, lut.clahe_interpolate_cells.radix_launches


# ------------------------------------------------------------- phase 4 ----


def phase_golden(device, rng, h=1080, w=1920) -> None:
    frames = structured_y(rng, 2, h, w)
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    out = clahe_ops.clahe_apply(torch.from_numpy(frames).to(device), plan).cpu().numpy()
    eq = histeq_ops.equalize_hist_batch(frames, device=device).cpu().numpy()
    for i, f in enumerate(frames):
        d = int(np.abs(out[i].astype(int) - golden.clahe(f, CLIP, GRID).astype(int)).max())
        e = int(np.abs(eq[i].astype(int) - golden.equalize_hist(f).astype(int)).max())
        print(f"golden {h}x{w} frame {i}: CLAHE max abs diff {d}, histeq {e}",
              flush=True)
        check(d == 0, f"frame {i} differs from core.golden.clahe by {d}")
        check(e == 0, f"frame {i} differs from core.golden.equalize_hist by {e}")

    # streaming: frame i mapped with the LUTs of frame i-1, frame 0 with
    # those of the stream-start histograms
    spec, cfg = clahe_config(h, w)
    nv12 = nv12_batch(rng, 4, h, w)
    got = np.asarray(StreamingEnhancer(cfg, spec, device).process_batch(nv12))
    start = natural.build_luts_ref(initial_hists(plan, "cpu")[None], plan.clip,
                                   plan.lut_scale)[0].numpy()
    for i in range(4):
        if i == 0:
            luts = start.reshape(plan.tiles_y, plan.tiles_x, 256)
            th, tw = plan.tile_h, plan.tile_w
        else:
            luts, th, tw = golden.clahe_luts(nv12[i - 1, :h], CLIP, GRID)
        want = golden.clahe_apply_luts(nv12[i, :h], luts, th, tw)
        d = int(np.abs(got[i, :h].astype(int) - want.astype(int)).max())
        print(f"golden streaming {h}x{w} frame {i}: max abs diff {d}", flush=True)
        check(d == 0, f"streaming frame {i} differs from golden's chain by {d}")
        check(np.array_equal(got[i, h:], nv12[i, h:]), "streaming chroma changed")


def golden_at_int_clip(frame: np.ndarray, clip: float, int_clip: int,
                       tile_area: int) -> np.ndarray:
    """``golden.clahe`` at the integer clip reckoned in f32 (as the JAX
    package and the port do).  golden reckons its integer clip from the
    float clip in f64; where that differs, it is given a clip limit whose
    f64 reckoning is ``int_clip``, and the difference is printed."""
    golden_int = max(int(clip * tile_area / 256.0), 1)
    if golden_int == int_clip:
        return golden.clahe(frame, clip, GRID)
    print(f"golden's f64 integer clip {golden_int} differs from the f32 one "
          f"{int_clip} at clip {clip!r}", flush=True)
    return golden.clahe(frame, (int_clip + 0.5) * 256.0 / tile_area, GRID)


def phase_golden_slice3(device, rng, h=1080, w=1920) -> None:
    """The cell-grid CLAHE, auto-CLAHE and the colour conversions on the
    card against core/golden.py and core/color.py at 1080p, 0 LSB."""
    frames = structured_y(rng, 2, h, w)
    out = clahe_ops.clahe(frames, CLIP, GRID, backend="pallas",
                          device=device).cpu().numpy()
    for i, f in enumerate(frames):
        d = int(np.abs(out[i].astype(int) - golden.clahe(f, CLIP, GRID).astype(int)).max())
        print(f"golden {h}x{w} frame {i}: CLAHE backend=pallas max abs diff {d}",
              flush=True)
        check(d == 0, f"pallas frame {i} differs from core.golden.clahe by {d}")

    frames = ladder_y(rng, BATCH, h, w)
    out, clips = auto_clahe.clahe_auto(frames, GRID, device=device)
    area = clahe_ops.make_clahe_plan(h, w, 40.0, GRID).tile_area
    ints = auto_clahe.int_clips(clips, area).cpu().numpy()
    out, clips = out.cpu().numpy(), clips.cpu().numpy()
    for i, f in enumerate(frames):
        want = golden_at_int_clip(f, float(clips[i]), int(ints[i]), area)
        d = int(np.abs(out[i].astype(int) - want.astype(int)).max())
        print(f"golden {h}x{w} frame {i}: clahe_auto clip {float(clips[i])!r} "
              f"(integer {int(ints[i])}) max abs diff {d}", flush=True)
        check(d == 0, f"auto frame {i} differs from core.golden.clahe by {d}")
    check(len(set(clips.tolist())) == BATCH, f"auto clips not distinct: {clips}")

    # a BGR round trip through CLAHE on Y, and through NV12
    bgr = np.stack([structured_y(rng, 1, h, w)[0] for _ in range(3)], axis=-1)
    yuv = color.bgr2yuv(bgr, device)
    y_eq = clahe_ops.clahe(yuv[..., 0].contiguous(), CLIP, GRID, device=device)
    back = color.yuv2bgr(torch.stack([y_eq, yuv[..., 1], yuv[..., 2]], -1), device)
    nv12 = color.bgr2nv12(bgr, device)
    from_nv12 = color.nv12_to_bgr(nv12, device=device)
    want_yuv = color_oracle.bgr2yuv(bgr)
    want_y = golden.clahe(np.ascontiguousarray(want_yuv[..., 0]), CLIP, GRID)
    want_back = color_oracle.yuv2bgr(
        np.stack([want_y, want_yuv[..., 1], want_yuv[..., 2]], -1))
    want_nv12 = color_oracle.bgr2nv12(bgr)
    for label, got, want in (("bgr2yuv", yuv, want_yuv),
                             ("clahe on Y, yuv2bgr", back, want_back),
                             ("bgr2nv12", nv12, want_nv12),
                             ("nv12_to_bgr", from_nv12,
                              color_oracle.nv12_to_bgr(want_nv12))):
        got = got.cpu().numpy()
        check(got.shape == want.shape, f"{label}: shape {got.shape} vs {want.shape}")
        d = int(np.abs(got.astype(int) - want.astype(int)).max())
        print(f"golden {h}x{w} BGR round trip {label}: max abs diff {d}", flush=True)
        check(d == 0, f"{label} differs from core/color.py by {d}")


def phase_golden_sharded(device, rng, h=1080, w=1920) -> None:
    """The sharded CLAHE and histeq steps on the card against
    core/golden.py at 1080p, 0 LSB: every position of a 2x2 and a 1x3 mesh
    run in this process, one after another (no process group)."""
    frames = structured_y(rng, 2, h, w)
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    for shape in ((2, 2), (1, 3)):
        out = sharded.sharded_clahe(shape, plan, device=device)(frames).cpu().numpy()
        eq = sharded.sharded_histeq(shape, h, w, device=device)(frames).cpu().numpy()
        for i, f in enumerate(frames):
            d = int(np.abs(out[i].astype(int) - golden.clahe(f, CLIP, GRID).astype(int)).max())
            e = int(np.abs(eq[i].astype(int) - golden.equalize_hist(f).astype(int)).max())
            print(f"golden {h}x{w} frame {i} sharded {shape[0]}x{shape[1]}: CLAHE max "
                  f"abs diff {d}, histeq {e}", flush=True)
            check(d == 0, f"sharded {shape} CLAHE frame {i} differs from golden by {d}")
            check(e == 0, f"sharded {shape} histeq frame {i} differs from golden by {e}")


# ------------------------------------------------------------- phase 5 ----


def drive_feeder(process_batch, frames, expected, reset=None,
                 batch=BATCH, n_frames=FEEDER_FRAMES) -> tuple[dict, dict]:
    """Submit ``n_frames`` frames (``frames[k % len(frames)]``) through a
    FrameFeeder and check every output against ``expected(k)`` in sequence
    order; returns the launch counts of this run and the feeder's stats.
    Every frame is queued before the feeder starts, so it takes full
    batches."""
    results: list[tuple[int, bool]] = []
    lock = threading.Lock()

    def on_output(seq, frame, meta):
        with lock:
            results.append((seq, bool(np.array_equal(frame, expected(meta)))))

    rows, w = frames.shape[1:]
    feeder = FrameFeeder(process_batch, batch_size=batch, depth=2,
                         queue_capacity=2 * n_frames, on_output=on_output)
    feeder.warmup((rows, w))
    if reset is not None:
        reset()
    cuda_ops.reset_launch_counts()
    for k in range(n_frames):
        feeder.submit(frames[k % len(frames)], meta=k)
    feeder.start()
    feeder.stop(drain=True)
    counts = cuda_ops.launch_counts()
    stats = feeder.stats
    check(stats.get("processing_errors", 0) == 0,
          f"processing_errors {stats.get('processing_errors')}")
    check(len(results) == n_frames, f"{len(results)} outputs for {n_frames} frames")
    check([s for s, _ in results] == list(range(n_frames)), "outputs out of order")
    check(all(ok for _, ok in results),
          f"{sum(not ok for _, ok in results)} outputs differ from the plain path")
    return counts, stats


def phase_main_paths(device, rng, h=HEIGHT, w=WIDTH) -> dict[str, dict[str, int]]:
    """The three paths through the FrameFeeder; returns each path's launch
    counts."""
    frames = nv12_batch(rng, DISTINCT_FRAMES, h, w)
    y = torch.from_numpy(frames[:, :h]).to(device)
    per_path = {}

    # histeq, chroma gray
    spec, cfg = histeq_config(h, w)
    gray = np.full((DISTINCT_FRAMES, h // 2, w), 128, np.uint8)
    want = np.concatenate([plain_histeq(y).cpu().numpy(), gray], axis=1)
    per_path["histeq"], stats = drive_feeder(
        Enhancer(cfg, spec, device).process_batch, frames,
        lambda k: want[k % DISTINCT_FRAMES])
    print(f"main path histeq: stats {stats}, launches {per_path['histeq']}", flush=True)

    # streaming CLAHE: frame k maps with the LUTs of frame k-1 (the frames
    # repeat every DISTINCT_FRAMES), frame 0 with the stream-start ones
    spec, cfg = clahe_config(h, w)
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    hists = natural.tile_histograms_ref(y, plan)
    prev_hists = torch.cat([hists[-1:], hists[:-1]])
    y_stream = natural.clahe_interpolate_ref(
        y, natural.build_luts_ref(prev_hists, plan.clip, plan.lut_scale), plan)
    want_stream = np.concatenate([y_stream.cpu().numpy(), frames[:, h:]], axis=1)
    start = natural.build_luts_ref(initial_hists(plan, device)[None], plan.clip,
                                   plan.lut_scale)
    want_first = np.concatenate(
        [natural.clahe_interpolate_ref(y[:1], start, plan).cpu().numpy()[0],
         frames[0, h:]], axis=0)
    streaming = StreamingEnhancer(cfg, spec, device)
    per_path["streaming"], stats = drive_feeder(
        streaming.process_batch, frames,
        lambda k: want_first if k == 0 else want_stream[k % DISTINCT_FRAMES],
        reset=streaming.reset)
    print(f"main path streaming: stats {stats}, launches {per_path['streaming']}",
          flush=True)

    # CLAHE, chroma passthrough
    spec, cfg = clahe_config(h, w)
    want_clahe = np.concatenate([plain_step(y, plan).cpu().numpy(), frames[:, h:]],
                                axis=1)
    per_path["clahe"], stats = drive_feeder(
        Enhancer(cfg, spec, device).process_batch, frames,
        lambda k: want_clahe[k % DISTINCT_FRAMES])
    print(f"main path clahe: stats {stats}, launches {per_path['clahe']}", flush=True)

    check(per_path["histeq"]["tile_histograms"] > 0 and per_path["histeq"]["apply_lut"] > 0,
          f"histeq path launched no K1 or K4: {per_path['histeq']}")
    check(per_path["streaming"]["build_luts"] > 0
          and per_path["streaming"]["clahe_interp_and_hist"] > 0,
          f"streaming path launched no K2 or K7: {per_path['streaming']}")
    check(all(per_path["clahe"][k] > 0 for k in
              ("tile_histograms", "build_luts", "clahe_interpolate")),
          f"CLAHE path launched no K1, K2 or K3: {per_path['clahe']}")
    return per_path


def drive_step(step, inputs, expected, steps=FEEDER_FRAMES // BATCH) -> dict:
    """Call ``step`` on ``inputs[k % len(inputs)]`` for k < steps with the
    launch counts set to 0 before and read after; then check each result
    against ``expected(k, result)``, which returns the largest difference."""
    cuda_ops.reset_launch_counts()
    results = [step(inputs[k % len(inputs)]) for k in range(steps)]
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    errs = [expected(k, r) for k, r in enumerate(results)]
    check(max(errs) == 0, f"{sum(e > 0 for e in errs)} of {steps} steps differ "
          f"from the plain path by up to {max(errs)}")
    return counts


def phase_slice3_paths(device, rng, h=HEIGHT, w=WIDTH) -> dict[str, dict[str, int]]:
    """Auto-CLAHE and the cell-grid CLAHE (``backend="pallas"``, clip 2.0,
    8x8) at 4K b4, 16 batches each through their entry points (the JAX
    package has no Enhancer for either), on the Y rows of NV12 batches held
    on the card; every output checked against the plain path."""
    batches = [torch.from_numpy(nv12_batch(rng, BATCH, h, w, ladder_y)).to(device)
               for _ in range(2)]
    ys = [b[:, :h] for b in batches]
    per_path = {}

    want_auto = [plain_auto(y) for y in ys]
    for _, clips in want_auto:
        check(len(set(clips.tolist())) == BATCH, f"auto clips not distinct: {clips}")

    def auto_err(k, result) -> int:
        (out, clips), (want, want_clips) = result, want_auto[k % 2]
        check(torch.equal(clips, want_clips),
              f"step {k}: clips {clips.tolist()}, plain {want_clips.tolist()}")
        return max_err(out, want)

    per_path["auto"] = drive_step(
        lambda y: auto_clahe.clahe_auto(y, GRID, device=device), ys, auto_err)
    print(f"main path auto 4K b{BATCH}: clips {want_auto[0][1].tolist()} and "
          f"{want_auto[1][1].tolist()}, launches {per_path['auto']}", flush=True)

    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    want_cells = [plain_step(y, plan) for y in ys]
    per_path["pallas"] = drive_step(
        lambda y: clahe_ops.clahe_apply(y, plan, backend="pallas"), ys,
        lambda k, r: max_err(r, want_cells[k % 2]))
    print(f"main path pallas 4K b{BATCH}: launches {per_path['pallas']}", flush=True)

    for label in ("auto", "pallas"):
        c = per_path[label]
        check(c["tile_histograms"] > 0 and c["build_luts"] > 0
              and c["clahe_interpolate_cells"] > 0 and c["clahe_interpolate"] == 0,
              f"{label} path did not run K1, K2 and K6 alone: {c}")
    return per_path


def sum_counts(counts: list[dict[str, int]]) -> dict[str, int]:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_sharded_paths(device, rng, h=HEIGHT, w=WIDTH):
    """The sharded path at 4K b4, CLAHE (clip 2.0, 8x8, passthrough) and
    histeq (chroma gray).  (a) ``ShardedEnhancer`` on a 1x1 mesh on NCCL in
    this process, through the FrameFeeder, every output against the plain
    versions.  (b) The same on a 2x2 and a 1x4 mesh of four spawned
    processes that share the card (gloo, staged through the host): each rank
    compares every assembled batch, and its own band, with the single-card
    Enhancer's, and returns its launch counts.  Returns each path's launch
    counts and each rank's time for its part of a step."""
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1, "the 1x1 mesh needs the NCCL group")
    frames = nv12_batch(rng, DISTINCT_FRAMES, h, w)
    y = torch.from_numpy(frames[:, :h]).to(device)
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    gray = np.full((DISTINCT_FRAMES, h // 2, w), 128, np.uint8)
    want = {"clahe": np.concatenate([plain_step(y, plan).cpu().numpy(), frames[:, h:]],
                                    axis=1),
            "histeq": np.concatenate([plain_histeq(y).cpu().numpy(), gray], axis=1)}
    configs = {"clahe": clahe_config(h, w), "histeq": histeq_config(h, w)}
    per_path, rank_ms = {}, {}
    for label, (spec, cfg) in configs.items():
        enhancer = sharded.ShardedEnhancer(cfg, spec, shape=(1, 1), device=device)
        check(enhancer.part.rows == (0, h) and enhancer.part.slab == (0, h),
              f"1x1 part {enhancer.part}")
        name = f"sharded_1x1_{label}"
        per_path[name], stats = drive_feeder(
            enhancer.process_batch, frames,
            lambda k, label=label: want[label][k % DISTINCT_FRAMES])
        print(f"main path {name} (nccl): stats {stats}, launches {per_path[name]}",
              flush=True)

    batches = [frames[:BATCH], frames[BATCH:2 * BATCH]]
    cases = [(cfg, spec, batches) for spec, cfg in configs.values()]
    repeats = max(1, SHARDED_BATCHES // len(batches))
    for shape in ((2, 2), (1, 4)):
        t0 = time.perf_counter()
        ranks = launch.run_on_mesh(shape, launch.compare_with_enhancer,
                                   (cases, repeats), device_type="cuda",
                                   timeout=SPAWN_TIMEOUT)
        elapsed = time.perf_counter() - t0
        for (label, _), results in zip(configs.items(), zip(*ranks)):
            name = f"sharded_{shape[0]}x{shape[1]}_{label}"
            for rank, res in enumerate(results):
                check(res["backend"] == "gloo", f"{name} rank {rank}: {res['backend']}")
                check(not res["loaded"], f"{name} rank {rank} loaded {res['loaded']}")
                check(len(res["equal"]) == SHARDED_BATCHES and all(res["equal"]),
                      f"{name} rank {rank}: assembled batches differ from the "
                      f"single-card Enhancer's: {res['equal']}")
                check(all(res["local_equal"]),
                      f"{name} rank {rank}: its band differs: {res['local_equal']}")
                check((res["part"].d, res["part"].s) == divmod(rank, shape[1]),
                      f"{name} rank {rank}: {res['part']}")
            per_path[name] = sum_counts([res["launches"] for res in results])
            rank_ms[name] = [res["local_ms"] for res in results]
            if label == "clahe":
                moved = [res["launches"]["clahe_interpolate_band"] for res in results
                         if res["part"].rows[0] > 0]
                check(moved and all(n > 0 for n in moved),
                      f"{name}: K5 was not launched at a row0 != 0: {moved}")
            print(f"main path {name} (gloo, 4 processes on the card): "
                  f"{SHARDED_BATCHES} batches equal on every rank; rows "
                  f"{[res['part'].rows for res in results]}, launches "
                  f"{per_path[name]}", flush=True)
        print(f"main path sharded {shape[0]}x{shape[1]}: {elapsed:.1f} s for both "
              f"configurations, spawn and reference included", flush=True)

    for name, counts in per_path.items():
        if name.endswith("clahe"):
            need, none = ("tile_histograms", "build_luts", "clahe_interpolate_band"), \
                ("clahe_interpolate", "apply_lut")
        else:
            need, none = ("tile_histograms", "apply_lut"), \
                ("clahe_interpolate", "clahe_interpolate_band", "build_luts")
        check(all(counts[k] > 0 for k in need) and all(counts[k] == 0 for k in none),
              f"{name} did not run {need} alone: {counts}")
    return per_path, rank_ms


def run_app(app, argv: list[str], label: str) -> str:
    """Call an app's ``run(argv)`` in this process with the launch counts at
    0 and its standard output captured (and echoed, every line tagged);
    a return code other than 0 fails the script."""
    captured = io.StringIO()
    cuda_ops.reset_launch_counts()
    with contextlib.redirect_stdout(captured):
        rc = app.run(argv)
    text = captured.getvalue()
    for line in text.splitlines():
        if line.strip():
            print(f"{label} | {line}", flush=True)
    check(rc == 0, f"{label}: {app.__name__}.run({argv}) returned {rc}")
    return text


def relay_shutdown(text: str, label: str, frames: int,
                   must_emit_all: bool = True) -> tuple[float, int]:
    """The relay's own rate and the frames it emitted, from its
    ``Shutdown`` line, after checking that it saw no processing error and
    (unless told otherwise) emitted every frame and dropped none."""
    m = re.search(r"Shutdown: (\d+) frames emitted in [\d.]+s \(([\d.]+) fps\), "
                  r"dropped\(late\)=(\d+), dropped\(overflow\)=(\d+), "
                  r"errors=(\d+)", text)
    check(m is not None, f"{label}: no Shutdown line")
    emitted, fps, late, overflow, errors = m.groups()
    check(int(errors) == 0 and int(late) == 0
          and int(emitted) + int(overflow) == frames, f"{label}: {m.group(0)}")
    if must_emit_all:
        check(int(emitted) == frames, f"{label}: {m.group(0)}")
    for marker in ("relay pipeline started", "(with frame ordering)",
                   "FINAL PERFORMANCE ANALYSIS"):
        check(marker in text, f"{label}: no {marker!r} in the output")
    return float(fps), int(emitted)


class RawFrameCatcher(threading.Thread):
    """A receiver of an ``rtp+raw://`` stream on 127.0.0.1: reassembles
    frames until it holds ``keep`` complete ones (or is stopped), then
    leaves the wire alone: what the sender goes on to send is dropped by the
    socket, which a UDP sender does not notice."""

    def __init__(self, rows: int, width: int, keep: int = 3):
        super().__init__(daemon=True, name="rtp-raw-catcher")
        # a stream frame the relay's queue dropped never reaches the wire, so
        # the kept frames are matched to the expected ones in order, not by
        # position
        self.rx = RtpUdpReceiver(host="127.0.0.1", port=0, kind="raw",
                                 frame_shape=(rows, width), timeout=0.5,
                                 rtcp=False, buffer_size=RECEIVER_BUFFER)
        # past the host's rmem_max where the process may (CAP_NET_ADMIN)
        with contextlib.suppress(OSError):
            self.rx.sock.setsockopt(socket.SOL_SOCKET,
                                    getattr(socket, "SO_RCVBUFFORCE", 33),
                                    RECEIVER_BUFFER)
        self.buffer = self.rx.sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
        self.port = self.rx.port
        self.kept: list[np.ndarray] = []
        self.keep = keep
        self._done = threading.Event()

    def run(self) -> None:
        while not self._done.is_set() and len(self.kept) < self.keep:
            try:
                self.kept.append(self.rx.recv_frame())
            except OSError:      # the socket's timeout: nothing on the wire
                continue

    def finish(self) -> None:
        self._done.set()
        self.join(timeout=10)
        check(not self.is_alive(), "the RTP receiver thread did not stop")
        self.rx.close()


def relay_over_rtp(w: int, h: int, want: np.ndarray,
                   staging: bool = False) -> tuple[float, dict]:
    """Configurations (e) and (f): CLAHE passthrough to
    ``rtp+raw://127.0.0.1:<port>``, unpaced, with a receiver thread on
    loopback; (f) adds ``--native``, whose started line must name the C++
    ring.  The sink must send every frame through ``native.rtp_send_raw``
    (counted here by a wrapper): one GIL-free call of sendmmsg batches per
    frame.  Every complete frame the receiver kept must equal one of the
    expected frames, in order.  The receiver shares this process's
    interpreter lock with the relay, so the lock's switch interval is
    shortened for the run."""
    label = f"relay ({'f' if staging else 'e'}) {w}x{h}"
    catcher = RawFrameCatcher(h * 3 // 2, w)
    interval = sys.getswitchinterval()
    sends = []      # each call's seconds
    send_raw = native.rtp_send_raw

    def counted(*args):
        t0 = time.perf_counter()
        try:
            return send_raw(*args)
        finally:
            sends.append(time.perf_counter() - t0)

    native.rtp_send_raw = counted
    sys.setswitchinterval(2e-4)
    catcher.start()
    try:
        text = run_app(relay, [
            "--source=test", f"--width={w}", f"--height={h}", f"--batch={BATCH}",
            f"--max-frames={RELAY_FRAMES}", "--op=clahe", "--chroma=passthrough",
            f"--sink=rtp+raw://127.0.0.1:{catcher.port}", "--status-interval=60"]
            + (["--native"] if staging else []), label)
        counts = cuda_ops.launch_counts()
        time.sleep(0.3)          # what is still in the socket buffer
    finally:
        native.rtp_send_raw = send_raw
        sys.setswitchinterval(interval)
        catcher.finish()
    fps, emitted = relay_shutdown(text, label, RELAY_FRAMES, must_emit_all=False)
    word = "native C++ ring" if staging else "python queue"
    check(f"staging={word})" in text, f"{label}: the started line names no {word}")
    check(len(sends) == emitted, f"{label}: {len(sends)} rtp_send_raw calls for "
          f"{emitted} frames emitted")
    last = -1
    for frame in catcher.kept:
        hits = [k for k in range(last + 1, RELAY_FRAMES)
                if np.array_equal(frame, want[k])]
        check(bool(hits), f"{label}: a reassembled frame equals no expected "
              f"frame after frame {last}")
        last = hits[0]
    print(f"{label}: the receiver reassembled {len(catcher.kept)} complete "
          f"frames (stream frames up to {last}; {catcher.rx.frames_dropped} "
          f"before them dropped for lost packets; receive buffer "
          f"{catcher.buffer} bytes), each equal to the plain versions' frame; "
          f"{len(sends)} frames sent by rtp_send_raw, "
          f"{1e3 * statistics.median(sends):.2f} ms a frame (median)", flush=True)
    return fps, {"complete": len(catcher.kept), "counts": counts,
                 "emitted": emitted, "send_ms": 1e3 * statistics.median(sends)}


def expected_relay_frames(device, w: int, h: int) -> np.ndarray:
    """What the relay's CLAHE passthrough configuration must write: the
    ``TestSource`` frames (seed 0, as the relay makes them) through the
    plain versions."""
    src = np.stack(list(TestSource(FrameSpec(width=w, height=h),
                                   num_frames=RELAY_FRAMES)))
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    want = src.copy()
    for k in range(0, RELAY_FRAMES, BATCH):
        y = torch.from_numpy(src[k:k + BATCH, :h]).to(device)
        want[k:k + BATCH, :h] = plain_step(y, plan).cpu().numpy()
    return want


def phase_relay_paths(device, h=HEIGHT, w=WIDTH):
    """This slice's path: the relay apps as a user starts them, at 4K batch
    4 on ``TestSource`` frames.  Returns each configuration's launch counts
    and the apps' own rates."""
    check(not dist.is_initialized(), "the relay's --mesh=1x1 starts its own group")
    base = ["--source=test", f"--width={w}", f"--height={h}", f"--batch={BATCH}",
            f"--max-frames={RELAY_FRAMES}", "--status-interval=60"]
    want = expected_relay_frames(device, w, h)
    per_path, rates = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_relay_") as tmp:
        raw = os.path.join(tmp, "clahe.nv12")
        configs = [
            ("relay_a_histeq_gray_null",
             ["--op=histeq", "--chroma=gray", "--sink=null"],
             ("tile_histograms", "apply_lut")),
            ("relay_b_clahe_rawfile",
             ["--op=clahe", "--chroma=passthrough", f"--sink={raw}"],
             ("tile_histograms", "build_luts", "clahe_interpolate")),
            ("relay_c_clahe_ref_frame",
             ["--op=clahe", "--chroma=passthrough", "--ref-frame", "--sink=null"],
             ("build_luts", "clahe_interp_and_hist")),
            ("relay_d_clahe_mesh_1x1",
             ["--op=clahe", "--chroma=passthrough", "--mesh=1x1", "--sink=null"],
             ("tile_histograms", "build_luts", "clahe_interpolate_band")),
        ]
        for name, extra, need in configs:
            text = run_app(relay, base + extra, name)
            per_path[name] = cuda_ops.launch_counts()
            rates[name], _ = relay_shutdown(text, name, RELAY_FRAMES)
            check(all(per_path[name][k] > 0 for k in need),
                  f"{name} did not launch {need}: {per_path[name]}")
            if "mesh" in name:
                check("Sharded over mesh {'data': 1, 'space': 1} (1 devices)" in text
                      and not dist.is_initialized(),
                      f"{name}: no mesh line, or the app left its group open")
        got = np.fromfile(raw, np.uint8)
        check(got.size == want.size, f"the raw sink holds {got.size} bytes, not "
              f"{want.size}")
        got = got.reshape(want.shape)
        bad = [k for k in range(RELAY_FRAMES) if not np.array_equal(got[k], want[k])]
        check(not bad, f"relay (b): frames {bad} differ from the plain versions")
        print(f"relay (b): all {RELAY_FRAMES} frames of the raw file equal the plain "
              f"versions on the same TestSource frames", flush=True)
        del got

    # (e) and (f) over loopback, unpaced, at 4K; at 1080p as well if the
    # relay dropped frames or no 4K frame arrived whole
    for name, staging in (("relay_e_clahe_rtp_raw", False),
                          ("relay_f_clahe_rtp_raw_native", True)):
        rates[name], info = relay_over_rtp(w, h, want, staging)
        if info["complete"] == 0 or info["emitted"] != RELAY_FRAMES:
            print(f"{name}: at 4K the relay emitted {info['emitted']} of "
                  f"{RELAY_FRAMES} frames and {info['complete']} arrived whole; "
                  f"at 1080p:", flush=True)
            rates[name + "_1080p"], info = relay_over_rtp(
                1920, 1080, expected_relay_frames(device, 1920, 1080), staging)
            check(info["complete"] > 0 and info["emitted"] == RELAY_FRAMES,
                  f"{name} at 1080p: emitted {info['emitted']}, "
                  f"{info['complete']} frames arrived whole")
        per_path[name] = info["counts"]
        check(all(per_path[name][k] > 0 for k in
                  ("tile_histograms", "build_luts", "clahe_interpolate")),
              f"{name} launched no K1, K2 or K3: {per_path[name]}")
    del want

    # the multi-stream relay: 4 streams of 1080p through one StreamMux, on
    # the Python queue, then on the C++ ring with a priority per stream
    ring_class, rings = native.NativeRing, []

    class CountedRing(ring_class):
        def __init__(self, *args):
            super().__init__(*args)
            rings.append(self)

    for name, extra in (("multi_relay_4x1080p_clahe", []),
                        ("multi_relay_4x1080p_clahe_native_priorities",
                         ["--native", "--priorities=3,2,1,0"])):
        native.NativeRing = CountedRing
        try:
            text = run_app(multi_relay, [
                f"--streams={MULTI_STREAMS}", "--width=1920", "--height=1080",
                "--fps=1000", f"--max-frames={MULTI_FRAMES}", f"--batch={BATCH}",
                "--op=clahe", "--chroma=passthrough", "--sink=null",
                "--status-interval=1"] + extra, name)
        finally:
            native.NativeRing = ring_class
        per_path[name] = cuda_ops.launch_counts()
        check(len(rings) == (1 if extra else 0),
              f"{name}: {len(rings)} C++ rings made for the mux's feeder")
        m = re.search(r"Shutdown: (\d+) frames across (\d+) streams in [\d.]+s "
                      r"\(([\d.]+) fps aggregate\)", text)
        check(m is not None, f"{name}: no Shutdown line")
        per_stream = re.findall(r"#\d+=(\d+)/(\d+)", text)
        total = MULTI_STREAMS * MULTI_FRAMES
        check(int(m.group(1)) == total and int(m.group(2)) == MULTI_STREAMS
              and per_stream == [(str(MULTI_FRAMES),) * 2] * MULTI_STREAMS,
              f"{name}: {m.group(0)}; per stream {per_stream}")
        check(all(e == "0" for e in re.findall(r"errors=(\d+)", text)),
              f"{name}: processing errors in its status lines")
        check(all(per_path[name][k] > 0 for k in
                  ("tile_histograms", "build_luts", "clahe_interpolate")),
              f"{name} launched no K1, K2 or K3: {per_path[name]}")
        rates[name] = float(m.group(3))
    return per_path, rates


def feeder_fps(process_batch, frames, batch=BATCH, n_frames=FEEDER_FRAMES,
               staging: bool = False) -> float:
    """Frames per second through the FrameFeeder, host frames in and host
    frames out (H2D, the step, D2H and the feeder's own copies), on the
    Python queue or (``staging``) on the C++ ring."""
    feeder = FrameFeeder(process_batch, batch_size=batch, depth=2,
                         queue_capacity=2 * n_frames,
                         native_staging=frames.shape[1:] if staging else False)
    check(not staging or feeder._native is not None, "no C++ ring in the feeder")
    feeder.warmup(frames.shape[1:])
    t0 = time.perf_counter()
    feeder.start()
    for i in range(n_frames):
        feeder.submit(frames[i % len(frames)])
    feeder.stop(drain=True)
    elapsed = time.perf_counter() - t0
    stats = feeder.stats
    check(stats["emitted"] == n_frames and stats.get("processing_errors", 0) == 0,
          f"feeder timing run: {stats}")
    return n_frames / elapsed


# ------------------------------------------------------------- phase 6 ----


def sink_write_ms(frame: np.ndarray) -> dict[str, list[float]]:
    """Host ms of the raw RTP sink's ``write`` of one NV12 frame to a
    socket on loopback (nothing reads it: the kernel drops what overflows
    its buffer), through the C++ packetizer and the Python one, in turns."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    sink = RtpUdpSink("127.0.0.1", rx.getsockname()[1], kind="raw", rtcp=False)
    check(sink._use_native, "the raw RTP sink did not take rtp_send_raw")
    reads = {"rtp_send_raw": [], "python": []}
    try:
        for use_native in (True, False, False, True):
            sink._use_native = use_native
            t0 = time.perf_counter()
            sink.write(frame)
            reads["rtp_send_raw" if use_native else "python"].append(
                1e3 * (time.perf_counter() - t0))
    finally:
        sink.close()
        rx.close()
    return reads



def time_ms(fn, reps: int = 30, warmup: int = 5, busy: bool = False) -> float:
    """Median time of one call, from CUDA events around each call.

    With ``busy=False`` the card is idle when the start event is recorded,
    so the time includes the host's work up to each launch, as a caller of
    the step pays it.  With ``busy=True`` the card first spins (about a
    millisecond) while the host queues the start event, the call and the
    end event behind it: the time is then the device's alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn) -> float:
    return time_ms(fn, busy=True)


def per_launch_ms(fn, launches: int = K2_LAUNCHES, reps: int = 7) -> float:
    """Median over ``reps`` runs of the device time of ``launches`` calls
    back to back, over the count: the card spins while the host queues the
    start event, the calls and the end event behind it."""
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


def profile_us(fn, kernel: str, calls: int = 20) -> float:
    """torch.profiler's device time of ``kernel`` per call of ``fn``, in us."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(evt.device_time_total for evt in prof.key_averages()
               if kernel in evt.key) / calls


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it: each
    input read once and each output written once at the HBM rate, or the
    operations at the f32 rate outside the tensor cores."""
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= ops_ms else (ops_ms, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def print_step(label: str, ms: float, dev_ms: float, card: str) -> None:
    print(f"time {label} step 4K b{BATCH}: {ms:.4f} ms/batch, "
          f"{ms / BATCH:.4f} ms/frame, {1e3 * BATCH / ms:.1f} fps; device alone "
          f"{dev_ms:.4f} ms/batch, {1e3 * BATCH / dev_ms:.1f} fps [{card}]",
          flush=True)


def phase_timings(device, rng, card: str) -> dict[str, dict]:
    """Every kernel at the main path's shapes beside its plain version and,
    where one exists, the one PyTorch call that computes the same function;
    and the three steps at 4K b4."""
    plan = clahe_ops.make_clahe_plan(HEIGHT, WIDTH, CLIP, GRID)
    batch = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH)).to(device)
    y = batch[:, :HEIGHT]
    px = BATCH * HEIGHT * WIDTH

    for label, (spec, cfg) in (("clahe", clahe_config()),
                               ("histeq", histeq_config())):
        step = build_enhance_fn(cfg, spec, donate=True)
        work = batch.clone()
        print_step(label, time_ms(lambda: step(work)),
                   device_ms(lambda: step(work)), card)
    spec, cfg = clahe_config()
    stream_fn, _ = build_streaming_clahe_fn(cfg, spec)
    work = batch.clone()
    state = initial_hists(plan, device)
    print_step("streaming", time_ms(lambda: stream_fn(work, state)),
               device_ms(lambda: stream_fn(work, state)), card)
    plain_ms = device_ms(lambda: y.copy_(plain_step(y, plan)))
    print(f"time plain CLAHE step 4K b{BATCH}: {plain_ms / BATCH:.4f} ms/frame "
          f"[{card}]", flush=True)
    ladder = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH, ladder_y)).to(device)
    y_ladder = ladder[:, :HEIGHT]
    cells_out = torch.empty_like(y)
    for label, step in (
            ("auto", lambda: auto_clahe.clahe_auto(y_ladder, GRID, device=device)),
            ("pallas", lambda: clahe_ops.clahe_apply(y, plan, backend="pallas",
                                                     out=cells_out))):
        print_step(label, time_ms(step), device_ms(step), card)
    print(f"time plain auto step 4K b{BATCH}: "
          f"{device_ms(lambda: plain_auto(y_ladder)) / BATCH:.4f} ms/frame [{card}]",
          flush=True)

    hists = natural.tile_histograms_ref(y, plan)
    luts = natural.build_luts_ref(hists, plan.clip, plan.lut_scale)
    out = torch.empty_like(y)
    frame = y[:1]
    frame_luts = luts[:1].contiguous()
    frame_out = torch.empty_like(frame)
    eq_luts = histogram.equalize_lut(natural.tile_histograms_ref(
        y, whole_frame_plan(HEIGHT, WIDTH))[:, 0], HEIGHT * WIDTH)
    y_flat = y.contiguous().view(BATCH, -1)
    arrays = plan.device_arrays(device)
    frame_px = HEIGHT * WIDTH
    spec = lut.make_interp_spec(HEIGHT, WIDTH, CLIP, GRID)
    tiles = (plan.tiles_y, plan.tiles_x, plan.tile_h, plan.tile_w)
    band_row0, band_row1 = sharded_bands(plan, 2)[1]
    band = y[:BATCH // 2, band_row0:band_row1]
    band_luts = luts[:BATCH // 2].contiguous()
    band_out = torch.empty(band.shape, dtype=torch.uint8, device=device)
    pack_arrays = natural.make_pack_spec(HEIGHT, WIDTH, CLIP, GRID).device_arrays(
        device)[:4]
    fx = {
        # name: (kernel, plain version, library call or None, bytes, ops);
        # ops are f32 operations, or one integer add per histogram count:
        # 10 per pixel in the blend (three products-and-sums of two terms
        # and 1 - xa), 4 per bin in the LUT build, none in the LUT map
        "tile_hist_kernel": (
            lambda: natural.tile_histograms(y, plan),
            lambda: natural.tile_histograms_ref(y, plan), None,
            px + nbytes(hists), px),
        "build_luts_kernel": (
            lambda: natural.build_luts(hists, plan.clip, plan.lut_scale),
            lambda: natural.build_luts_ref(hists, plan.clip, plan.lut_scale), None,
            nbytes(hists, luts), 4 * hists.numel()),
        "interp_kernel": (
            lambda: natural.clahe_interpolate(y, luts, plan, out=out),
            lambda: natural.clahe_interpolate_ref(y, luts, plan), None,
            2 * px + nbytes(luts, *arrays), 10 * px),
        "apply_lut_kernel": (
            lambda: lut.apply_lut(y, eq_luts, out=out),
            lambda: lut.apply_lut_ref(y, eq_luts),
            lambda: torch.gather(eq_luts, 1, y_flat.long()),
            2 * px + nbytes(eq_luts), 0),
        "interp_hist_kernel": (
            lambda: natural.clahe_interp_and_hist(frame, frame_luts, plan,
                                                  out=frame_out),
            lambda: natural.clahe_interp_and_hist_ref(frame, frame_luts, plan), None,
            2 * frame_px + nbytes(frame_luts, *arrays) + plan.num_tiles * 256 * 4,
            11 * frame_px),
        "interp_cells_kernel": (
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out),
            lambda: lut.clahe_interpolate_cells_ref(y, luts, spec), None,
            2 * px + nbytes(luts, *spec.device_arrays(device)), 10 * px),
        "tile_hist_kernel:extended": (
            lambda: lut.tile_histograms_extended(y, *tiles),
            lambda: lut.tile_histograms_extended_ref(y, *tiles), None,
            px + nbytes(hists), px),
        # K5 and K9 on the band of a 2x2 mesh's second space position: two
        # frames, rows [1080, 2160); K3v1 over the whole batch
        "interp_kernel:band": (
            lambda: natural.clahe_interpolate_band(band, band_luts, plan, band_row0,
                                                   out=band_out),
            lambda: natural.clahe_interpolate_band_ref(band, band_luts, plan,
                                                       band_row0), None,
            2 * band.numel() + nbytes(band_luts, *pack_arrays), 10 * band.numel()),
        "interp_kernel:variant1": (
            lambda: natural.clahe_interpolate_pack(y, luts, plan, out=out),
            lambda: natural.clahe_interpolate_pack_ref(y, luts, plan), None,
            2 * px + nbytes(luts, *pack_arrays), 10 * px),
        "interp_cells_kernel:band": (
            lambda: lut.clahe_interpolate_cells_band(band, band_luts, spec,
                                                     band_row0, out=band_out),
            lambda: lut.clahe_interpolate_cells_band_ref(band, band_luts, spec,
                                                         band_row0), None,
            2 * band.numel() + nbytes(band_luts, *spec.device_arrays(device)),
            10 * band.numel()),
        # K10 (batch_rows 8, its default) and K6r over the whole batch
        "tile_hist_kernel:batched": (
            lambda: natural.tile_histograms_batched(y, *tiles),
            lambda: natural.tile_histograms_batched_ref(y, *tiles), None,
            px + nbytes(hists), px),
        "interp_cells_kernel:radix": (
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out, radix=True),
            lambda: lut.clahe_interpolate_cells_ref(y, luts, spec, radix=True), None,
            2 * px + nbytes(luts, *spec.device_arrays(device)), 10 * px),
    }
    times = {}
    for name, (kernel, plain, library, moved, ops) in fx.items():
        bound_ms, bound_by = bound(moved, ops)
        times[name] = {
            "ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library) if library is not None else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        t = times[name]
        lib = f"{t['library_ms']:.4f} ms" if library is not None else "none"
        print(f"time {name}: {t['ms']:.4f} ms on the device, "
              f"{time_ms(kernel):.4f} ms a call from an idle card (plain "
              f"{t['plain_ms']:.4f} ms, library {lib}, bound {bound_ms:.4f} ms "
              f"by {bound_by}) [{card}]", flush=True)

    # K7 per frame against K3 then K1 on the same frame
    k3k1_ms = device_ms(lambda: (natural.tile_histograms(frame, plan),
                                 natural.clahe_interpolate(frame, frame_luts, plan,
                                                           out=frame_out)))
    print(f"time K3 + K1 per 4K frame: {k3k1_ms:.4f} ms on the device against K7 "
          f"{times['interp_hist_kernel']['ms']:.4f} ms [{card}]", flush=True)
    const = torch.full((BATCH, HEIGHT, WIDTH), 77, dtype=torch.uint8, device=device)
    const_ms = device_ms(lambda: natural.tile_histograms(const, plan))
    print(f"time tile_hist_kernel 4K b{BATCH} constant frame: {const_ms:.4f} ms "
          f"[{card}]", flush=True)
    const_luts = natural.build_luts_ref(natural.tile_histograms_ref(const, plan),
                                        plan.clip, plan.lut_scale)
    const_ms = device_ms(lambda: natural.clahe_interpolate(const, const_luts, plan,
                                                           out=out))
    print(f"time interp_kernel 4K b{BATCH} constant frame: {const_ms:.4f} ms "
          f"(bound {times['interp_kernel']['bound_ms']:.4f} ms) [{card}]", flush=True)

    # the slice-3 kernels beside the kernels of the same contract, in turns
    whole = whole_frame_plan(HEIGHT, WIDTH)
    clips = torch.tensor([506, 1012, 1519, 2025], dtype=torch.int32, device=device)
    pairs = {
        "K6 interp_cells_kernel vs K3 interp_kernel": (
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out),
            lambda: natural.clahe_interpolate(y, luts, plan, out=out)),
        "K8 tile_hist_kernel:extended vs K1 tile_hist_kernel, 8x8": (
            lambda: lut.tile_histograms_extended(y, *tiles),
            lambda: natural.tile_histograms(y, plan)),
        "K8 tile_hist_kernel:extended vs K1 tile_hist_kernel, 8x8 constant": (
            lambda: lut.tile_histograms_extended(const, *tiles),
            lambda: natural.tile_histograms(const, plan)),
        "K8 tile_hist_kernel:extended vs K1 tile_hist_kernel, 1x1": (
            lambda: lut.tile_histograms_extended(y, 1, 1, HEIGHT, WIDTH),
            lambda: natural.tile_histograms(y, whole)),
        "K2 build_luts_kernel clip tensor vs int": (
            lambda: natural.build_luts(hists, clips, plan.lut_scale),
            lambda: natural.build_luts(hists, plan.clip, plan.lut_scale)),
        "K5 interp_kernel:band, the batch as one band, vs K3 interp_kernel": (
            lambda: natural.clahe_interpolate_band(y, luts, plan, 0, out=out),
            lambda: natural.clahe_interpolate(y, luts, plan, out=out)),
        "K3v1 interp_kernel:variant1 vs K3 interp_kernel": (
            lambda: natural.clahe_interpolate_pack(y, luts, plan, out=out),
            lambda: natural.clahe_interpolate(y, luts, plan, out=out)),
        "K9 interp_cells_kernel, the batch as one band, vs K6": (
            lambda: lut.clahe_interpolate_cells_band(y, luts, spec, 0, out=out),
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out)),
        "K6r interp_cells_kernel:radix vs K6 interp_cells_kernel": (
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out, radix=True),
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out)),
        "K6r interp_cells_kernel:radix vs K5 interp_kernel:band, the batch as one "
        "band": (
            lambda: lut.clahe_interpolate_cells(y, luts, spec, out=out, radix=True),
            lambda: natural.clahe_interpolate_band(y, luts, plan, 0, out=out)),
        "K9 vs K5 on a 2x2 band (2 frames, 1080 rows)": (
            lambda: lut.clahe_interpolate_cells_band(band, band_luts, spec,
                                                     band_row0, out=band_out),
            lambda: natural.clahe_interpolate_band(band, band_luts, plan, band_row0,
                                                   out=band_out)),
    }
    for label, (new, old) in pairs.items():
        reads = [device_ms(new), device_ms(old), device_ms(old), device_ms(new)]
        print(f"time {label} 4K b{BATCH}: {reads[0]:.4f} / {reads[3]:.4f} ms against "
              f"{reads[1]:.4f} / {reads[2]:.4f} ms on the device [{card}]", flush=True)
        if label.startswith("K2"):
            times["build_luts_kernel"]["clip_tensor_ms"] = min(reads[0], reads[3])
    # K10 (K1's kernel with batch_rows loads in flight) for each batch_rows
    # beside K1 (4 loads) and K8, by content, in turns
    random_frames = torch.from_numpy(random_y(rng, BATCH, HEIGHT, WIDTH)).to(device)
    for label, frames in (("structured", y), ("random", random_frames), ("constant", const)):
        fns = [(f"K10 rows {r}", lambda r=r: natural.tile_histograms_batched(
            frames, *tiles, batch_rows=r)) for r in (2, 4, 8)]
        fns += [("K1", lambda: natural.tile_histograms(frames, plan)),
                ("K8", lambda: lut.tile_histograms_extended(frames, *tiles))]
        reads = {name: [] for name, _ in fns}
        for name, fn in fns + fns[::-1]:
            reads[name].append(device_ms(fn))
        times["tile_hist_kernel:batched"][f"{label}_ms"] = {
            name: min(v) for name, v in reads.items()}
        print(f"time tile histograms 4K b{BATCH} {label} content, in turns: "
              + "; ".join(f"{name} {v[0]:.4f} / {v[1]:.4f}" for name, v in reads.items())
              + f" ms on the device [{card}]", flush=True)
    # K2 as a run of launches (one call between events is mostly the
    # events), beside an empty kernel launched the same way and the
    # profiler's device time per call
    k2 = times["build_luts_kernel"]
    k2["one_call_ms"] = k2["ms"]
    k2["ms"] = per_launch_ms(lambda: natural.build_luts(hists, plan.clip,
                                                        plan.lut_scale))
    k2["launch_floor_ms"] = per_launch_ms(lambda: natural.launch_floor(hists))
    k2["profiler_us"] = profile_us(
        lambda: natural.build_luts(hists, plan.clip, plan.lut_scale), "build_luts_kernel")
    k2["launch_floor_profiler_us"] = profile_us(
        lambda: natural.launch_floor(hists), "launch_floor_kernel")
    print(f"time build_luts_kernel 4K b{BATCH}, {K2_LAUNCHES} launches back to back: "
          f"{k2['ms']:.5f} ms a launch (one call between events {k2['one_call_ms']:.4f}; "
          f"profiler {k2['profiler_us']:.2f} us a call); an empty kernel launched "
          f"the same way {k2['launch_floor_ms']:.5f} ms (profiler "
          f"{k2['launch_floor_profiler_us']:.2f} us); bound {k2['bound_ms']:.5f} ms "
          f"[{card}]", flush=True)

    # the 1x1 sharded step (the glue and two world-size-1 NCCL collectives)
    # beside the single-card step, on the Y rows of a batch on the card
    work = batch.clone()
    slab = work[:, :HEIGHT]
    for label, (fspec, cfg) in (("clahe", clahe_config()), ("histeq", histeq_config())):
        step = sharded.ShardedEnhancer(cfg, fspec, shape=(1, 1), device=device)._y_step
        single, _ = make_enhance_y(cfg, fspec)
        reads = [[fn(lambda: step.step_slab(slab)), fn(lambda: single(slab, slab)),
                  fn(lambda: single(slab, slab)), fn(lambda: step.step_slab(slab))]
                 for fn in (time_ms, device_ms)]
        print(f"time sharded 1x1 {label} Y step (nccl) 4K b{BATCH}: idle card "
              f"{reads[0][0]:.4f} / {reads[0][3]:.4f} ms against the single-card Y step "
              f"{reads[0][1]:.4f} / {reads[0][2]:.4f}; device alone {reads[1][0]:.4f} / "
              f"{reads[1][3]:.4f} against {reads[1][1]:.4f} / {reads[1][2]:.4f} [{card}]",
              flush=True)
    return times


def phase_profile(device, rng) -> None:
    """Device time by kernel over ten 4K batch-4 steps of each path
    (torch.profiler)."""
    batch = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH)).to(device)
    plan = clahe_ops.make_clahe_plan(HEIGHT, WIDTH, CLIP, GRID)
    spec, cfg = clahe_config()
    clahe = build_enhance_fn(cfg, spec)
    stream_fn, _ = build_streaming_clahe_fn(cfg, spec)
    histeq = build_enhance_fn(*histeq_config()[::-1])
    state = initial_hists(plan, device)
    ladder = torch.from_numpy(nv12_batch(rng, BATCH, HEIGHT, WIDTH, ladder_y)).to(device)
    steps = {"clahe": lambda: clahe(batch), "histeq": lambda: histeq(batch),
             "streaming": lambda: stream_fn(batch, state),
             "auto": lambda: auto_clahe.clahe_auto(ladder[:, :HEIGHT], GRID,
                                                   device=device),
             "pallas": lambda: clahe_ops.clahe_apply(batch[:, :HEIGHT], plan,
                                                     backend="pallas")}
    sharded_step = sharded.ShardedEnhancer(cfg, spec, shape=(1, 1), device=device)._y_step
    steps["sharded_1x1_clahe"] = lambda: sharded_step.step_slab(batch[:, :HEIGHT])
    for label, step in steps.items():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            dev_us = getattr(evt, "device_time_total", 0.0)
            if dev_us > 0:
                print(f"profile {label} {evt.key}: {evt.count} calls, "
                      f"{dev_us / max(evt.count, 1):.2f} us device time per call, "
                      f"{dev_us / 10:.2f} us per step", flush=True)


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
    for line in _build.ptxas_report(("interp_kernel", "build_luts_kernel",
                                     "tile_hist_kernel")):
        print(f"ptxas {line}", flush=True)
    t0 = time.perf_counter()
    check(native.available(), f"the native runtime did not build: "
          f"{native.build_error()}")
    print(f"build native runtime: {time.perf_counter() - t0:.1f} s -> "
          f"{native.loaded_path()}", flush=True)

    # phase 3: kernels
    rng = np.random.default_rng(2024)
    errs = phase_clahe_kernels(device, kernel_cases(rng))
    errs["apply_lut_kernel"] = phase_lut_kernel(device, rng)
    errs["interp_hist_kernel"] = phase_fused_kernel(device, rng)
    errs["build_luts_kernel"] = max(errs["build_luts_kernel"],
                                    phase_clip_tensor(device, rng))
    errs["interp_cells_kernel"] = phase_cell_kernel(device, rng)
    errs["tile_hist_kernel:extended"], k8_launches = \
        phase_extended_hist_kernel(device, rng)
    band_errs, off_path_launches = phase_band_kernels(device, rng)
    off_path_launches["tile_histograms_extended"] = k8_launches
    errs["tile_hist_kernel:batched"], \
        off_path_launches["tile_histograms_batched"] = \
        phase_batched_hist_kernel(device, rng)
    errs["interp_cells_kernel:radix"], \
        off_path_launches["clahe_interpolate_cells_radix"] = \
        phase_radix_cell_kernel(device, rng)
    errs["tile_hist_kernel"] = max(errs["tile_hist_kernel"],
                                   band_errs.pop("tile_hist_kernel"))
    errs.update(band_errs)
    check(all(e == 0 for e in errs.values()), f"kernel mismatch {errs}")

    phase_golden(device, rng)                              # phase 4
    phase_golden_slice3(device, rng)
    phase_golden_sharded(device, rng)
    per_path = phase_main_paths(device, rng)               # phase 5
    per_path.update(phase_slice3_paths(device, rng))
    # the relay apps first: their --mesh=1x1 starts and ends a group of its own
    relay_paths, relay_rates = phase_relay_paths(device)
    per_path.update(relay_paths)
    # the 1x1 mesh of the sharded path lives in this process: a process
    # group of one rank on NCCL, until the script ends
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as rendezvous:
        launch.init_process_group(0, 1, os.path.join(rendezvous, "rendezvous"), "cuda")
        try:
            check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
            sharded_paths, rank_ms = phase_sharded_paths(device, rng)
            per_path.update(sharded_paths)
            launches = {wrapper: sum(c[wrapper] for c in per_path.values())
                        for _, wrapper, _, _ in KERNELS}
            check(all(n > 0 for w, n in launches.items() if w not in OFF_PATH),
                  f"a kernel was not launched on a path: {launches}")
            for wrapper in OFF_PATH:
                check(launches[wrapper] == 0 and off_path_launches[wrapper] > 0,
                      f"{wrapper}: {launches[wrapper]} launches on the paths, "
                      f"{off_path_launches[wrapper]} in its check")
                launches[wrapper] = off_path_launches[wrapper]

            times = phase_timings(device, rng, card)       # phase 6
            for name, ms in rank_ms.items():
                print(f"time {name} 4K b{BATCH}: each rank's own part of the step, "
                      f"upload included, four processes on one card: "
                      f"{[round(t, 4) for t in ms]} ms [{card}]", flush=True)
            for name, fps in relay_rates.items():
                print(f"time {name}: the app's own Shutdown rate {fps:.1f} fps "
                      f"(TestSource on the host, H2D, step, D2H and the sink) "
                      f"[{card}]", flush=True)
            sink_ms = sink_write_ms(nv12_batch(rng, 1, HEIGHT, WIDTH)[0])
            print(f"time raw RTP sink write of one 4K NV12 frame on loopback, "
                  f"host ms in turns: C++ rtp_send_raw "
                  f"{' / '.join(f'{t:.2f}' for t in sink_ms['rtp_send_raw'])}, "
                  f"Python packetizer "
                  f"{' / '.join(f'{t:.2f}' for t in sink_ms['python'])} [{card}]",
                  flush=True)
            frames = nv12_batch(rng, DISTINCT_FRAMES, HEIGHT, WIDTH)
            spec, cfg = clahe_config()
            for label, process_batch in (
                    ("clahe", Enhancer(cfg, spec, device).process_batch),
                    ("histeq", Enhancer(*histeq_config()[::-1], device).process_batch),
                    ("streaming", StreamingEnhancer(cfg, spec, device).process_batch),
                    ("sharded 1x1 clahe", sharded.ShardedEnhancer(
                        cfg, spec, shape=(1, 1), device=device).process_batch)):
                # the Python queue and the C++ ring in turns on the two
                # single-card steps
                turns = ((False, True, True, False) if label in ("clahe", "histeq")
                         else (False,))
                fps = [feeder_fps(process_batch, frames, staging=staging)
                       for staging in turns]
                names = " / ".join("C++ ring" if t else "Python queue" for t in turns)
                print(f"time feeder end to end {label} 4K b{BATCH} (H2D + step + "
                      f"D2H), {names}: {' / '.join(f'{x:.1f}' for x in fps)} fps "
                      f"over {FEEDER_FRAMES} frames [{card}]", flush=True)
            phase_profile(device, rng)
        finally:
            dist.destroy_process_group()

    check("jax" not in sys.modules and "cv2" not in sys.modules,
          "jax or cv2 was imported")
    check(not any(m == "opencv_opencl_tpu" or m.startswith("opencv_opencl_tpu.")
                  for m in sys.modules), "the JAX package was imported")
    kernels = [
        {"name": name.split(":")[0], "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[wrapper],
         "max_abs_err": errs[name], **times[name]}
        for name, wrapper, source, replaces in KERNELS
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
