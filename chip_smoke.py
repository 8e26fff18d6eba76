#!/usr/bin/env python3
"""Drive the PyTorch port's NV12 steps on a CUDA card and check them.

Run from the repository root, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. device   the card, and its name and power limit from nvidia-smi;
2. build    the CUDA kernels from ``opencv_opencl_tpu_torch/csrc``, and
            what ``nvcc -Xptxas -v`` says of K3 (also K5 and K3v1), K2 and
            K1's three instances (``tile_hist_kernel<4>``, also K8's, and
            ``<2>``, ``<8>`` for K10), H1 and the GOP encoder's H2 (the
            split design's ``levels_split_kernel``, ``levels_chain_kernel``
            and ``levels_intra_kernel``, each for H1, H1 with ``i4`` and
            H2), H3
            ``subpel_planes_kernel`` (and its write floor
            ``subpel_floor_kernel``, each for 1, 4 and 16 planes), H4
            ``motion_search_kernel``, H5
            ``deblock_kernel``, H6 ``parts_search_kernel``, H7
            ``pack_i_kernel`` and H8 ``pack_p_kernel`` (registers, shared
            memory, spills);
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
            rows, against its plain version, K6 and K3; H1 (the intra level
            stage of the H.264 device encoder) against its plain version,
            every output (levels, modes, reconstructed planes): at 4K for the
            default, ``chromah`` and ``full_recon`` at QP 0 and 30 on
            structured and random content, the default on a constant frame;
            Intra_4x4 with ``chromah`` and ``full_recon`` at 4K at QP 0, 26
            and 51 on mixed content and at one of them on structured, random
            and constant content (with ``full_recon`` alone on structured),
            and at 1920x1088 on mixed content; at 640x368, one MB row, one MB column and 48x32
            the default, ``chromah``, ``full_recon``, both, and Intra_4x4
            with ``full_recon`` and with ``chromah`` at QP 0, 26 (the
            default: 30) and 51 on those and on mixed content (runs of 8-12
            MBs of noise or of horizontal stripes between runs of a moving
            picture), and the default on mixed content at 4K and 1920x1088;
            then the device encoder's streams: ``tpu`` at 4K equal
            to ``CavlcH264Encoder(slices=135)`` on the native rows, with and
            without ``overlap``, and ``tpu:i4:chromah`` at 4K equal to the
            plain version's levels entropy-coded on the native rows and at
            256x144 to the Python ``CavlcH264Encoder(slices=9, i4, chromah)``;
            H3, H4, H2 and H5 (the GOP encoder's P frames) against their
            plain versions, every output, 0 difference, on moving
            structured, random and constant content: H3 at 4K with margins
            9 (16 planes), 5 (4 planes) and 8 (1 plane), and with each at
            the five edge geometries; H4 at 4K full-pel and
            ``fastsub`` at search 8 with one and two references and under
            the GDR clean-row rule, and at 1920x1088 the exhaustive half-
            and quarter-pel lattices at search 2; H2 (after the search) at
            4K at QP 0 and 30, with and without motion and with a GDR band,
            and at the five edge geometries on mixed content (the P frame
            of runs of noise between runs of the moving reference) and,
            below 1920x1088, random and constant content, at QP 0, 30 and
            51: zero motion, ``fastsub`` with a GDR band, the quarter-pel
            lattice with two references and the ``parts`` layout;
            H5 at 4K on an IDR and on a P frame's own metadata, with and
            without ``slice_local``; then the GOP encoder's streams on the
            card: at 640x368 over four frames (IDR, P, P, IDR) equal to the
            Python ``GopCavlcEncoder(slices=23)``'s for
            ``gop=3:search=4:fastsub:deblock`` and
            ``gop=3:search=2:quarterpel:refs=2``, and at 1920x1088 over
            three frames equal to ``CudaGopEncoder(device="cpu")``'s, both
            oracles in child processes while the card works; H6
            (``parts_search_kernel``) at 4K at full- and half-pel search 8,
            quarter-pel search 4 and two references at quarter-pel search
            3 on moving, random and constant content (constant content
            ties everywhere: the index in the key decides), and at the five
            edge geometries with each sub-pel mode and one and two
            references, H2 on the ``parts`` layout and H5 on quadrant fields, H7
            (``pack_i_kernel``) on H1's levels (default, and Intra_4x4 with
            chroma HORIZONTAL; at 4K and the five edge geometries) and H8
            (``pack_p_kernel``) on H2's (P_16x16 and parts, one and two
            references; at 4K and the five edge geometries) and on a 4K
            frame of synthetic fields (long skip runs, skipped rows,
            levels under skipped MBs), at 64 words an MB and at a cap of 3
            (at the edge geometries also at 1100), against their plain
            versions; the streams
            ``gop=3:search=4:parts:deblock:bitpack`` (also at ``nw_mb=3``,
            where frames overflow the cap and take the host entropy path)
            and ``gop=3:search=2:quarterpel:refs=2:parts`` against the
            Python oracle, and ``tpu:bitpack`` and ``tpu:i4:chromah:bitpack``
            at 4K against the streams without the packer; the fused
            enhance + encode step (``models/fused_encode.py``: K1-K4 and
            H1-H8 one step a batch on device-resident frames) for histeq
            intra with and without the packer and CLAHE GOPs
            (``gop=4:search=8:fastsub:deblock``, ``parts:bitpack``,
            ``refs=2``), at 4K over two batches of 4 and at 1920x1080 over
            one batch of 3: the AUs that ``encode_from_packed`` assembles
            equal to the unfused card encoder's on the same enhanced
            frames, and at 1920x1080 the packed lanes and reference
            pictures equal to the CPU plain versions' (a child process);
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
            the image and video apps' compute parts (``phase_app_paths``;
            their ``run`` reads and writes through cv2, which the card's
            machine lacks), each path's launches counted around the app's
            own function and its output held at 0 LSB to the same function
            on the CPU (the plain versions) and to ``core/golden.py``:
            ``histeq_image.enhance_bgr`` (K1 on a 1x1 grid, K4) and
            ``clahe_image.clahe_bgr`` (K1-K3, clip 3.0, 4x4 tiles) on a
            4K BGR image, the latter also at 1919x1079, ``m2_bench``'s two
            methods (equal to each other), ``parity_bench.device_parity``
            for histeq and CLAHE (clip 2.0, 8x8; no pixel off golden) and
            ``clahe_video.enhance_frames`` over 16 ``TestSource`` 4K frames
            into a ``RawSink`` (every frame the plain versions'), each
            app's own times printed with the card; then
            the sharded path: ``ShardedEnhancer`` on a 1x1 mesh on NCCL in
            this process, through the ``FrameFeeder`` (CLAHE passthrough and
            histeq gray, 64 frames each), and the same two configurations
            on a 2x2 and a 1x4 mesh of four spawned processes that share
            the card (gloo, staged through the host), 16 batches each,
            every assembled batch and every position's band compared with
            the single-card ``Enhancer``'s inside each rank; then the relay
            apps as a user starts them, in this process:
            ``apps.relay.run`` at 3840x2160, batch 4, ``--source=test``, 32
            frames, for (a) histeq gray to the null sink, (b) CLAHE
            passthrough to a raw NV12 file that is compared frame by frame
            with the plain versions on the same ``TestSource`` frames, (c)
            ``--ref-frame``, (d) ``--mesh=1x1`` (the app starts its own
            one-rank NCCL group), (e) ``--sink=rtp+raw://`` on loopback,
            unpaced, the sink sending through the C++ packetizer
            (``rtp_send_raw``), with a receiver thread that reassembles
            frames and compares them, and (f) the same with ``--native``
            (the C++ staging ring, which the relay's started line must
            name); (g) ``--sink=rtp+h264://`` with ``--encoder=cavlc`` (the
            native C++ CAVLC rows, which the sink's encoder must be on), 16
            frames, received by the port's ``rtp_receiver`` app in a child
            process, which must record every access unit, and (h) the same
            with ``--encoder=pcm`` (lossless I_PCM, ~12.4 MB an access
            unit), received by an ``H26xRtpReceiver`` thread, which counts
            what it loses; in both every frame the encoder takes must be an
            expected frame, every access unit sent must equal what a new
            encoder makes from those frames, and every access unit received
            must be the next one sent; (i) ``--encoder=tpu`` (H1 on the
            card, entropy coding on the native rows), received by the
            ``rtp_receiver`` app, every access unit equal to a new
            ``CavlcH264Encoder(slices=135)``'s on the frames the encoder
            took; (j) ``--encoder=tpu:gop=30:search=8:fastsub:deblock`` (H1
            on the IDR, H3, H4, H2 and H5 on each P frame, entropy coding on
            the native rows), received the same way, every access unit
            equal to a new ``CudaGopEncoder``'s of the same spec on the
            frames the encoder took; (k)
            ``--encoder=tpu:gop=30:search=8:parts:deblock:bitpack`` (H1 and
            H7 on the IDR; H3, H6, H2, H5 and H8 on each P frame; the host
            assembles the packed bits), checked as (j), no frame over the
            cap; (p) ``--encoder=tpu:i4:chromah:bitpack`` (H1 with ``i4``
            and H7 a frame), every access unit equal to a new
            ``tpu:i4:chromah`` encoder's (H1 with ``i4``, entropy coding on
            the native rows); (l) relay (j)'s spec and (m) ``--encoder=tpu:bitpack``,
            each with ``--fused-encode`` (the frames stay on the card, the
            packed levels come down; every frame the fused step takes must
            be a source frame, in order, after the warm-up batch, and every
            access unit must equal a new encoder's on the expected frame at
            the in-band qp, the frame's launches counted from its index);
            the Python CAVLC oracle, in a child
            process started before phase 3, encodes the first two expected
            frames, which must give the native rows' access units (and (g)'s
            first two); and ``apps.multi_relay.run`` with 4 streams of
            1080p, 32 frames each, on the Python queue and with ``--native
            --priorities``; then the sharded encoder
            (``parallel/sharded_encode.py``, ``phase_sharded_encode``): (a)
            GOP-per-rank fused enhance + encode at 4K CLAHE for the intra
            encoder with and without ``bitpack`` and
            ``gop=4:search=8:fastsub:deblock`` over 13 frames (two GOPs a
            rank of 2x1 and a ragged tail that pads), on a 1x1 mesh on NCCL
            in this process and a 2x1 mesh of two processes that share the
            card (gloo), the ranks other than 0 passing another qp, which
            the broadcast must override; (b) ``BandedCudaGopEncoder`` at 4K
            over 3 ranks (45 MB rows a band) for ``search=4`` and
            ``search=2:quarterpel:parts``, an IDR and three P frames; rank
            0's AUs equal to the single-card ``CudaGopEncoder`` /
            ``CudaCavlcEncoder``'s on the single-card enhanced frames, every
            rank's kernels counted; (c) relay (n), ``relay.run`` in a 2x1
            group with ``--mesh=2x1 --fused-encode
            --encoder=tpu:qp=30:gop=4:search=8:fastsub:deblock`` on 16
            ``TestSource`` frames, recorded by the ``rtp_receiver`` child,
            the recording equal to a single-card ``CudaGopEncoder``'s
            stream; each rank's ms a 4K block through the fused step, the
            gather's ms and the banded encoder's ms a P frame are printed
            with the card (processes sharing one card: no multi-card
            speed-up); (d) the dry run, ``entry.dryrun_multichip(4)``: four
            processes on a 2x2 mesh sharing the card, each holding its
            sharded CLAHE, histeq and odd 131x67 outputs to the
            single-card steps and rank 0 the GOP-per-rank, partition and
            banded streams to the single-card encoder's, and
            ``entry.entry()``'s step against its plain version on the CPU
            and golden; (e) relay (o), ``multi_relay --mesh=2x1`` in a
            group of two processes (``launch.run_multi_relay``), 2 streams
            of 1080p CLAHE passthrough to ``rtp+raw://``, 16 rounds, every
            frame of every stream received and equal to the single-card
            ``Enhancer``'s, emitted equal to submitted for each stream;
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
            own ``Shutdown`` rates (and, in phase 5, the encoded relays'
            host encode ms a 4K frame, and the native CAVLC rows' and the
            Python oracle's); H1 per 4K frame, default (also each phase of
            the split design, its grid's time in the profiler's keys, and
            the chain's time a step from its phase B over 240 and 120 MB
            columns), ``full_recon`` and
            ``i4:chromah`` (also by phase, with the chain's floor: 3,840
            Intra_4x4 steps a row), beside its plain version and its bound, the levels' copy to the
            host, the host entropy coding, ``CudaCavlcEncoder.encode`` with
            and without ``overlap`` and the native ``cavlc`` encoders on the
            same frames; per 4K P frame H3 (16 planes at margin 9; 4 at 5
            and 1 at 8 and the write floor beside it), H4 (``fastsub`` at
            search 8 and the exhaustive quarter-pel lattice at search 4), H2
            (also by phase, as H1) and H5 beside their plain versions and bounds, the P levels'
            copy to the host, the P entropy coding and
            ``CudaGopEncoder.encode`` of relay (j)'s spec with and without
            ``overlap``; H6 (full-pel search 8, half-pel search 8,
            quarter-pel search 4, two references at full-pel search 8), H8
            on a parts P frame (and its read-and-store floor; on a
            P_16x16 and a constant P frame too) and H7 on an IDR (and its
            read-and-store floor; on an ``i4:chromah`` IDR too)
            beside their plain versions and bounds, the packed bits' copy to
            the host beside the levels', the kernels of a whole P frame
            back to back (``fastsub``: H3, H4, H2, H5; ``parts``: H3, H6,
            H2, H5, H8), and ``encode`` of relay (k)'s spec
            without the packer, with it, and with it and ``overlap``; the
            fused step of (l) on 4 P frames and of (m) on a 4K batch, from
            an idle card and device alone, the packed lanes' copy to the
            host and ``encode_from_packed`` a frame, beside the CLAHE step,
            the enhanced batch's copy and the unfused encoder's ``encode``;
            K10 for each
            batch_rows beside K1 and K8 on structured, random and constant
            content, and K6r beside K6 and K5, in turns.

The WebRTC sender and its signaling server (``apps/sender.py``,
``io/signaling.py``, ``io/webrtc_controller.py``) launch no kernel, and the
card's machine has no websockets: no phase runs them here, and the CPU
tests (``tests/test_torch_webrtc.py``) alone hold them to the JAX package.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports no JAX
and nothing of the JAX package: the oracles on the card are the plain
versions and the port's ``core/golden.py``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from opencv_opencl_tpu_torch import entry, native
from opencv_opencl_tpu_torch.apps import (
    clahe_image, clahe_video, histeq_image, m2_bench, multi_relay, parity_bench, relay)
from opencv_opencl_tpu_torch.io import encoder as encoder_io
from opencv_opencl_tpu_torch.io import rtp_h26x
from opencv_opencl_tpu_torch.io.h264_cavlc import CavlcH264Encoder, CudaCavlcEncoder
from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder
from opencv_opencl_tpu_torch.core import color as color_oracle
from opencv_opencl_tpu_torch.core import golden
from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.io.rtp import RtpUdpReceiver, RtpUdpSink
from opencv_opencl_tpu_torch.io.videofile import RawSink, TestSource
from opencv_opencl_tpu_torch.metrics.timing import TimingStats
from opencv_opencl_tpu_torch.models import fused_encode
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
from opencv_opencl_tpu_torch.ops import h264_bitpack as bitpack_ops
from opencv_opencl_tpu_torch.ops import h264_deblock as deblock_ops
from opencv_opencl_tpu_torch.ops import h264_levels as levels_ops
from opencv_opencl_tpu_torch.ops import histogram
from opencv_opencl_tpu_torch.ops.cuda import _build, lut, natural
from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as bitpack_kernel
from opencv_opencl_tpu_torch.ops.cuda import h264_deblock as deblock_kernel
from opencv_opencl_tpu_torch.ops.cuda import h264_inter as inter_kernel
from opencv_opencl_tpu_torch.ops.cuda import h264_levels as levels_kernel
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
    # H1-H5: the JAX functions are XLA programs (H1's and H2's lax.scans
    # over the MB columns, H4's fori_loop over the candidates, H5's scan
    # over the anti-diagonals), not Pallas kernels.  The rows named
    # intra_levels_kernel (H1, and H1 with i4) and p_levels_kernel (H2) keep
    # the names of the one-grid kernels they were: each stands for the split
    # design's three grids in h264_levels.cu (levels_split_kernel<P, I4>,
    # levels_chain_kernel<P, I4>, levels_intra_kernel<P, I4>), one launch
    # of its wrapper
    ("intra_levels_kernel", "encode_levels",
     "opencv_opencl_tpu_torch/csrc/h264_levels.cu",
     "opencv_opencl_tpu/ops/h264_levels.py:279"),
    ("intra_levels_kernel:i4", "encode_levels_i4",
     "opencv_opencl_tpu_torch/csrc/h264_levels.cu",
     "opencv_opencl_tpu/ops/h264_levels.py:279:i4"),
    ("p_levels_kernel", "encode_p_levels",
     "opencv_opencl_tpu_torch/csrc/h264_levels.cu",
     "opencv_opencl_tpu/ops/h264_levels.py:1487"),
    ("subpel_planes_kernel", "subpel_planes",
     "opencv_opencl_tpu_torch/csrc/h264_inter.cu",
     "opencv_opencl_tpu/ops/h264_levels.py:703"),
    ("motion_search_kernel", "motion_search",
     "opencv_opencl_tpu_torch/csrc/h264_inter.cu",
     "opencv_opencl_tpu/ops/h264_levels.py:838"),
    ("deblock_kernel", "deblock_planes",
     "opencv_opencl_tpu_torch/csrc/h264_deblock.cu",
     "opencv_opencl_tpu/ops/h264_deblock.py:226"),
    # H6-H8: the partition search (two fori_loops over the candidates) and
    # the CAVLC bit packers, XLA programs too
    ("parts_search_kernel", "motion_search_parts",
     "opencv_opencl_tpu_torch/csrc/h264_inter.cu",
     "opencv_opencl_tpu/ops/h264_levels.py:1197"),
    ("pack_i_kernel", "pack_i_mbs",
     "opencv_opencl_tpu_torch/csrc/h264_bitpack.cu",
     "opencv_opencl_tpu/ops/h264_bitpack.py:347"),
    ("pack_p_kernel", "pack_p_mbs",
     "opencv_opencl_tpu_torch/csrc/h264_bitpack.cu",
     "opencv_opencl_tpu/ops/h264_bitpack.py:548"),
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
# frames of relays (a)-(f): 24 since the Intra_4x4 checks at 4K (32 since
# the apps' phase came in, 48 since the device encoder's checks, 64 before),
# each relay reads TestSource's ~3-5 fps
RELAY_FRAMES = 24
MULTI_STREAMS, MULTI_FRAMES = 4, 32
# the raw RTP receiver's socket buffer: a 4K frame leaves the C++ sender
# as one burst of ~13,000 datagrams (~30 MB of kernel buffers on loopback)
RECEIVER_BUFFER = 1 << 26
SPAWN_TIMEOUT = 420.0
# relays (g) and (h), the encoded RTP sinks: frames each, the encoder's frame
# rate and bitrate (the relay's defaults, given as flags), the receive
# buffer (a 4K I_PCM access unit is ~12.4 MB, ~10,400 datagrams), and the
# frames the Python CAVLC oracle encodes (~90 s a 4K frame on one host core,
# in a child process from before phase 3 to the relays)
ENCODED_FRAMES = 16
ENCODED_FPS, ENCODED_KBPS = 60.0, 20000
ENCODED_BUFFER = 1 << 27
ORACLE_FRAMES = 2
ORACLE_TIMEOUT = 600.0
# H1's check: the QPs at 4K (0 reaches the level clamp), the QPs of its
# Intra_4x4 cases (the plain Intra_4x4 version launches thousands of small
# ops a MB column: seconds a 4K frame), the frames each encoder stream
# check encodes, and the geometry where the Python oracle holds the
# Intra_4x4 + chroma HORIZONTAL stream
INTRA_QPS = (0, 30)
INTRA_I4_QPS = (0, 26, 51)
INTRA_FRAMES = 2
INTRA_ORACLE_SHAPE = (144, 256)
# H2-H5's checks: the search radius of relay (j) and of the 4K checks, the
# exhaustive lattices' radius and geometry, the GDR clean rows of the 4K
# checks; the streams: the GOP encoder on the card against the host oracle
# GopCavlcEncoder(slices=mb_h) at P_STREAM_SHAPE over P_STREAM_FRAMES frames
# (IDR, P, P, IDR) for each of P_STREAMS, and against the same class on the
# CPU at CPU_STREAM_SHAPE, both oracles in child processes while the card
# works; relay (j)'s spec (docs/ENCODER.md's fastsub line with the in-loop
# filter); the radius of the exhaustive quarter-pel search that is timed
P_SEARCH = 8
P_EXHAUSTIVE_SEARCH, P_EXHAUSTIVE_SHAPE = 2, (1088, 1920)
P_CLEAN_ROWS = 45
P_STREAM_SHAPE, P_STREAM_FRAMES = (368, 640), 4
P_STREAMS = (dict(qp=30, gop=3, search=4, fastsub=True, deblock=True),
             dict(qp=30, gop=3, search=2, quarterpel=True, refs=2),
             dict(qp=30, gop=3, search=4, parts=True, deblock=True, bitpack=True),
             dict(qp=30, gop=3, search=2, quarterpel=True, refs=2, parts=True))
CPU_STREAM_SHAPE, CPU_STREAM_FRAMES = (1088, 1920), 3
CPU_STREAM = dict(qp=30, gop=3, search=P_SEARCH, fastsub=True, deblock=True)
GOP_SPEC = f"tpu:gop=30:search={P_SEARCH}:fastsub:deblock"
P_TIMED_QPEL_SEARCH = 4
# geometries whose MB rows or columns are no multiple of H5's band (16 MB
# rows a block) or of H4's MBs a block (5 for fastsub at search 8, 6 for the
# quarter-pel lattice at search 4): 68 MB rows, 640x368, one MB row, one MB
# column, 48x32
EDGE_SHAPES = ((1088, 1920), (368, 640), (16, 640), (368, 16), (32, 48))
# H6-H8's checks: the partition searches at 4K (search, sub-pel mode,
# references), the bit packers' cap of the stream that must overflow it,
# and relay (k)'s spec (the partition modes with the in-loop filter and the
# device bit packer)
PARTS_CASES = ((P_SEARCH, 0, 1), (P_SEARCH, 1, 1), (P_TIMED_QPEL_SEARCH, 2, 1), (3, 2, 2))
# H6 at each of EDGE_SHAPES: (search, sub-pel mode), each with one and two
# references; H3's (margin, planes): quarter-pel (and fastsub), half-pel and
# relay (k)'s full-pel stack
PARTS_EDGE_CASES = ((P_SEARCH, 0), (P_SEARCH, 1), (P_TIMED_QPEL_SEARCH, 2))
H3_MODES = ((P_SEARCH + 1, 16), (5, 4), (P_SEARCH, 1))
CAP_NW_MB = 3
# the packers' checks at more words an MB than a block's shared memory
# could hold for four MBs (the cap neither packer has any longer)
LONG_NW_MB = 1100
# H8 at each of EDGE_SHAPES: (search, sub-pel mode, two references, parts)
# of the P frames whose levels it packs
PACK_P_EDGE_CASES = ((2, 3, False, False), (2, 2, True, False), (2, 1, True, True))
PARTS_SPEC = f"tpu:gop=30:search={P_SEARCH}:parts:deblock:bitpack"
# the fused enhance + encode step's checks: the configurations (name, the
# enhancement, the step's options; with "gop" the GOP step), run at 4K over
# two batches of 4 and at 1920x1080 (which pads to 1088) over one batch of
# 3, where a child process computes the plain versions on the CPU while the
# card works; relays (l) and (m) run the GOP step of relay (j)'s spec and
# the intra step with the bit packer
FUSED_CASES = (
    ("intra_histeq", "histeq", {}),
    ("intra_histeq_bitpack", "histeq", {"bitpack": 64}),
    ("gop_fastsub_deblock", "clahe", {"gop": 4, "search": P_SEARCH, "subpel": 3,
                                      "deblock": True}),
    ("gop_parts_bitpack", "clahe", {"gop": 4, "search": P_SEARCH, "parts": True,
                                    "bitpack": 64}),
    ("gop_refs2", "clahe", {"gop": 4, "search": P_SEARCH, "refs": 2}),
)
FUSED_4K_FRAMES, FUSED_CPU_SHAPE, FUSED_CPU_FRAMES = 8, (1080, 1920), 3
FUSED_GOP_SPEC, FUSED_INTRA_SPEC = GOP_SPEC, "tpu:bitpack"
# the sharded encoder (parallel/sharded_encode.py), GOP-per-rank: the
# encoders (name, mode, options) of the fused step at 4K CLAHE on a 1x1 mesh
# on NCCL and a 2x1 mesh of two processes sharing the card (gloo), over
# frames that give each rank of 2x1 two GOPs with a ragged tail; the banded
# encoder at 4K over 3 ranks (135 MB rows, 45 a band: 135 divides by neither
# 2 nor 4), an IDR and three P frames; relay (n): --mesh=2x1 --fused-encode
# with relay (j)'s search at a fixed qp (the stream is held to a single-card
# encoder's) and GOPs of 4, one GOP a rank a batch
MESH_ENCODE_CASES = (("intra", "levels", {}),
                     ("intra_bitpack", "levels", {"bitpack": True, "nw_mb": 64}),
                     ("gop_fastsub_deblock", "gop",
                      dict(gop=4, search=P_SEARCH, fastsub=True, deblock=True)))
MESH_ENCODE_QP, MESH_GOP_FRAMES, MESH_INTRA_FRAMES = 30, 2 * 2 * 4 - 3, 3
BANDED_RANKS, BANDED_FRAMES = 3, 4
BANDED_CASES = (("search4", dict(search=4)),
                ("search2_quarterpel_parts", dict(search=2, quarterpel=True, parts=True)))
MESH_RELAY_GOP, MESH_RELAY_FRAMES = 4, 16
MESH_RELAY_SPEC = f"tpu:qp=30:gop={MESH_RELAY_GOP}:search={P_SEARCH}:fastsub:deblock"
# the dry run (entry.py): its processes, four on a 2x2 mesh sharing the
# card; relay (o): multi_relay --mesh=2x1, its streams of 1080p CLAHE
# passthrough to rtp+raw:// and its rounds (a frame a stream each)
DRYRUN_PROCESSES = 4
GROUP_RELAY_STREAMS, GROUP_RELAY_ROUNDS = 2, 16
# the image and video apps' compute parts: clahe_image's defaults (clip 3.0,
# 4x4 tiles) at 4K and on an odd frame, parity_bench's (clip 2.0, 8x8, 256
# chained calls), and clahe_video's loop over TestSource 4K frames (its
# defaults: CLAHE clip 2.0, 8x8, chroma passthrough)
APP_CLAHE_CLIP, APP_CLAHE_TILE, APP_ODD_SHAPE = 3.0, 4, (1079, 1919)
APP_PARITY_REPEAT, APP_VIDEO_FRAMES = 256, 16
REPO = os.path.dirname(os.path.abspath(__file__))


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


def content_nv12(rng, kind: str, h: int, w: int) -> np.ndarray:
    """One NV12 frame of structured (gradient plus noise), random or
    constant content."""
    if kind == "constant":
        return np.full((h * 3 // 2, w), 77, np.uint8)
    return nv12_batch(rng, 1, h, w, random_y if kind == "random" else structured_y)[0]


def intra_planes(frame: torch.Tensor, h: int):
    """The Y plane and the interleaved Cb, Cr views of an NV12 frame."""
    uv = frame[h:].view(h // 2, frame.shape[1] // 2, 2)
    return frame[:h], uv[:, :, 0], uv[:, :, 1]


def intra_outputs(out) -> list[torch.Tensor]:
    """Every tensor of an ``encode_levels`` result, in order."""
    arrays = []
    for o in out:
        arrays += list(o) if isinstance(o, tuple) else [o]
    return arrays


def phase_intra_levels_kernel(device, rng) -> tuple[int, int]:
    """H1 against ``encode_levels_plain`` on the card, every output (levels,
    modes, reconstructed planes): at 4K for the default, ``chromah`` and
    ``full_recon`` at each of ``INTRA_QPS`` (on a constant frame the default
    only) on structured, random and constant content, and the default on
    mixed content (:func:`mixed_nv12`) at 4K (each of ``INTRA_QPS``) and
    1920x1088 (QP 30); H1 with ``i4`` (``chromah`` and ``full_recon``) at
    4K on mixed content at each of ``INTRA_I4_QPS``, on structured (also
    with ``full_recon`` alone at QP 0), random and constant content at one
    of them each, and at 1920x1088 on mixed content at QP 26; then at
    the small ``EDGE_SHAPES`` (640x368, one MB row, one MB column, 48x32)
    the default, ``chromah``, ``full_recon`` and both at QP 0, 30 and 51,
    and ``i4`` with ``full_recon`` and with ``chromah`` at each of
    ``INTRA_I4_QPS``, on the four contents.  Returns the largest absolute
    difference of H1 and of H1 with ``i4``."""
    levels_kernel.reset_launch_counts()
    i4_all = {"i4": True, "chromah": True, "full_recon": True}
    i4_recon = {"i4": True, "full_recon": True}
    cases = [((HEIGHT, WIDTH), flags, qp)
             for flags in ({}, {"chromah": True}, {"full_recon": True})
             for qp in INTRA_QPS]
    # i4 at 4K (the plain Intra_4x4 version takes ~7 s a frame): each
    # content at one of INTRA_I4_QPS, mixed content at each
    i4_4k = {"structured": [(i4_all, 26), (i4_recon, 0)], "random": [(i4_all, 0)],
             "constant": [(i4_all, 51)]}
    small = [(shape, flags, qp) for shape in EDGE_SHAPES[1:]
             for flags in ({}, {"chromah": True}, {"full_recon": True},
                           {"chromah": True, "full_recon": True})
             for qp in (0, 30, 51)]
    small += [(shape, flags, qp) for shape in EDGE_SHAPES[1:]
              for flags in (i4_recon, {"i4": True, "chromah": True})
              for qp in INTRA_I4_QPS]
    # mixed content also at 4K and 1920x1088, the default flags and i4
    mixed = ([((HEIGHT, WIDTH), {}, qp) for qp in INTRA_QPS] + [(EDGE_SHAPES[0], {}, 30)]
             + [((HEIGHT, WIDTH), i4_all, qp) for qp in INTRA_I4_QPS]
             + [(EDGE_SHAPES[0], i4_all, 26)])
    err, err_i4, checked, checked_i4 = 0, 0, 0, 0
    for kind in ("structured", "random", "constant", "mixed"):
        todo = ((cases + [((HEIGHT, WIDTH), f, qp) for f, qp in i4_4k[kind]])
                if kind != "mixed" else mixed) + small
        frames = {shape: torch.from_numpy(
            mixed_nv12(rng, *shape)[1] if kind == "mixed" else content_nv12(rng, kind, *shape)
        ).to(device) for shape in {c[0] for c in todo}}
        for shape, flags, qp in todo:
            if (kind == "constant" and shape == (HEIGHT, WIDTH) and flags
                    and "i4" not in flags):
                continue
            if "i4" in flags:
                checked_i4 += 1
            else:
                checked += 1
            planes = intra_planes(frames[shape], shape[0])
            t0 = time.perf_counter()
            got = intra_outputs(levels_ops.encode_levels(*planes, qp, **flags))
            want = intra_outputs(levels_ops.encode_levels_plain(*planes, qp, **flags))
            check(len(got) == len(want), f"H1 gave {len(got)} outputs, the plain "
                  f"version {len(want)}")
            e = max(max_err(a, b) for a, b in zip(got, want))
            if "i4" in flags:
                err_i4 = max(err_i4, e)
            else:
                err = max(err, e)
            if shape in EDGE_SHAPES[1:] and e == 0:
                continue
            imode = got[7 if "full_recon" in flags else 4]
            i4_mbs = f", {int((imode == 0).sum())} Intra_4x4 MBs" if "i4" in flags else ""
            print(f"kernel intra_levels_kernel {shape[1]}x{shape[0]} {kind} qp {qp} "
                  f"{'+'.join(flags) or 'default'}: max abs err {e} over {len(got)} "
                  f"outputs{i4_mbs} ({time.perf_counter() - t0:.1f} s with the plain "
                  f"version)", flush=True)
    print(f"kernel intra_levels_kernel at {', '.join(f'{w}x{h}' for h, w in EDGE_SHAPES[1:])}: "
          f"{len(small) * 4} checks, max abs err {max(err, err_i4)} so far", flush=True)
    counts = levels_kernel.launch_counts()
    check(counts["encode_levels"] == checked and counts["encode_levels_i4"] == checked_i4,
          f"H1 launched {counts['encode_levels']} times for {checked} checks, with i4 "
          f"{counts['encode_levels_i4']} for {checked_i4}")
    return err, err_i4


def au_of(nals: list[bytes], parameter_sets: CavlcH264Encoder) -> bytes:
    """An access unit: the SPS and PPS of ``parameter_sets``, then ``nals``."""
    return b"".join(b"\x00\x00\x00\x01" + bytes(n) for n in
                    (parameter_sets._sps, parameter_sets._pps, *nals))


def phase_intra_streams(device, rng) -> None:
    """The device encoder's access units.  ``tpu`` at 4K (QP 30) equals
    ``CavlcH264Encoder(slices=mb_h)`` on the native C++ rows, with and
    without ``overlap`` (one frame late, drained by ``flush``).
    ``tpu:i4:chromah``, whose host oracle is the Python encoder (minutes a
    4K frame), equals at 4K the access unit entropy-coded on the native
    rows from the plain version's levels, and at 256x144 the Python
    ``CavlcH264Encoder(slices=mb_h, i4=True, chromah=True)``.  With the
    device bit packer, ``tpu:bitpack`` and ``tpu:i4:chromah:bitpack`` at 4K
    give the same access units as ``tpu`` and ``tpu:i4:chromah``, no frame
    over the cap."""
    h, w = HEIGHT, WIDTH
    frames = [content_nv12(rng, kind, h, w) for kind in ("structured", "random")]
    frames = frames[:INTRA_FRAMES]
    ref = CavlcH264Encoder(w, h, qp=30, slices=h // 16, threads=os.cpu_count() or 1,
                           native="require")
    want = [au for f in frames for au in ref.encode(f)]
    for overlap in (False, True):
        enc = CudaCavlcEncoder(w, h, qp=30, overlap=overlap)
        check(enc.device.type == "cuda" and enc._native,
              f"the device encoder is on {enc.device}, native {enc._native}")
        got = [au for f in frames for au in enc.encode(f)] + enc.flush()
        check(got == want, f"tpu{':overlap' if overlap else ''} at 4K: access units "
              f"other than CavlcH264Encoder(slices={h // 16})'s")
    print(f"stream tpu at 4K: {len(want)} access units ({[len(a) for a in want]} "
          f"bytes) equal CavlcH264Encoder(slices={h // 16}) on the native rows, "
          f"with and without overlap", flush=True)

    enc = CudaCavlcEncoder(w, h, qp=30, i4=True, chromah=True)
    got = enc.encode(frames[0])
    planes = intra_planes(torch.from_numpy(frames[0]).to(device), h)
    lv, imode, i4modes, cmode = levels_ops.encode_levels_plain(
        *planes, 30, i4=True, chromah=True)
    nals = native.cavlc_entropy_rows(
        *(a.cpu().numpy() for a in lv), 30, 0, threads=os.cpu_count() or 1,
        imode=imode.cpu().numpy(), i4modes=i4modes.cpu().numpy(),
        cmode=cmode.cpu().numpy())
    i4_mbs = int((imode == 0).sum())
    check(got == [au_of(nals, ref)] and i4_mbs > 0,
          f"tpu:i4:chromah at 4K: not the plain version's access unit "
          f"({i4_mbs} Intra_4x4 MBs)")
    for kw, stream, refs in ((dict(), want, frames), (dict(i4=True, chromah=True), got,
                                                      frames[:1])):
        enc = CudaCavlcEncoder(w, h, qp=30, bitpack=True, **kw)
        bits = [au for f in refs for au in enc.encode(f)] + enc.flush()
        spec = ":".join(["tpu", *kw, "bitpack"])
        check(bits == stream and enc._bits_overflows == 0,
              f"{spec} at 4K: access units other than without the bit packer's, or "
              f"{enc._bits_overflows} frames over its cap")
        print(f"stream {spec} at 4K: {len(bits)} access units equal "
              f"{'tpu:i4:chromah' if kw else 'tpu'}'s, no frame over the cap",
              flush=True)
    sh, sw = INTRA_ORACLE_SHAPE
    small = content_nv12(rng, "structured", sh, sw)
    oracle = CavlcH264Encoder(sw, sh, qp=26, slices=sh // 16, i4=True, chromah=True,
                              native="never")
    check(CudaCavlcEncoder(sw, sh, qp=26, i4=True, chromah=True).encode(small)
          == oracle.encode(small), f"tpu:i4:chromah at {sw}x{sh}: access units other "
          f"than the Python oracle's")
    print(f"stream tpu:i4:chromah: at 4K equal to the plain version's levels on the "
          f"native rows ({len(got[0])} bytes, {i4_mbs} Intra_4x4 MBs), at {sw}x{sh} "
          f"to the Python CavlcH264Encoder(slices={sh // 16}, i4, chromah)",
          flush=True)


def moving_nv12(rng, h: int, w: int, n: int) -> list[np.ndarray]:
    """``n`` NV12 frames of one structured picture moving by (1, 2) luma
    pixels a frame, its left quarter still (MBs that skip) and a block of
    noise that jumps from frame to frame (MBs that go intra)."""
    ycan = structured_y(rng, 1, h + 2 * n, w + 2 * n)[0]
    uvcan = rng.integers(96, 160, (h // 2 + n, w + 2 * n), dtype=np.uint8)
    out = []
    for i in range(n):
        y = ycan[i:i + h, 2 * i:2 * i + w].copy()
        uv = uvcan[i // 2:i // 2 + h // 2, 2 * i:2 * i + w].copy()
        y[:, :w // 4] = ycan[:h, :w // 4]
        uv[:, :w // 4] = uvcan[:h // 2, :w // 4]
        r0, c0 = (37 * i) % max(h - 32, 1), (101 * i) % max(w - 64, 1)
        y[r0:r0 + 32, c0:c0 + 64] = rng.integers(0, 256, (32, 64), dtype=np.uint8)
        out.append(np.concatenate([y, uv]))
    return out


def mixed_nv12(rng, h: int, w: int, runs: tuple[int, int] = (8, 12)
               ) -> tuple[np.ndarray, np.ndarray]:
    """A reference NV12 frame (gradient plus noise) and a P frame that makes
    the level kernels' chain matter: along each MB row, runs of ``runs[0]``
    to ``runs[1]`` MBs that only intra prediction codes well (fresh noise
    and horizontal stripes, a run each in turn) between runs of 1 to 5 MBs
    of the reference moved by (1, 2) pixels with a little noise (inter or
    skip); narrower frames cut the runs.  The tests' copy is in
    ``tests/test_torch_cuda.py``: this script imports nothing from
    ``tests/``."""
    rows = h * 3 // 2
    base = (np.linspace(0, 200, w, dtype=np.float32)[None, :]
            + np.linspace(0, 55, rows, dtype=np.float32)[:, None])
    ref = np.clip(base + rng.normal(0, 18, (rows, w)), 0, 255).astype(np.uint8)
    moved = np.roll(ref, (1, 2), (0, 1))
    moved[h:] = ref[h:]
    cur = np.clip(moved + rng.integers(-1, 2, (rows, w)), 0, 255).astype(np.uint8)
    stripes = np.clip(rng.integers(0, 256, (rows, 1)) + rng.integers(-3, 4, (rows, w)),
                      0, 255).astype(np.uint8)
    run = 0
    for mby in range(h // 16):
        x = int(rng.integers(0, 4))
        while x < w // 16:
            x1 = min(x + int(rng.integers(runs[0], runs[1] + 1)), w // 16)
            for r0, r1 in ((16 * mby, 16 * mby + 16), (h + 8 * mby, h + 8 * mby + 8)):
                cols = slice(16 * x, 16 * x1)
                cur[r0:r1, cols] = (stripes[r0:r1, cols] if run % 2 else
                                    rng.integers(0, 256, (r1 - r0, 16 * (x1 - x)), np.uint8))
            run += 1
            x = x1 + int(rng.integers(1, 6))
    return ref, cur


def p_planes(device, frame: np.ndarray) -> tuple[torch.Tensor, ...]:
    """The three planes of an NV12 frame on the card, each contiguous (a
    reference picture's layout)."""
    h = frame.shape[0] * 2 // 3
    return tuple(p.contiguous() for p in
                 intra_planes(torch.from_numpy(frame).to(device), h))


def p_content(device, rng, kind: str, h: int, w: int):
    """A source picture and two references on the card: ``moving`` content
    (the references the two frames before), ``random`` or ``structured``
    (the references the source moved and with noise), ``constant``, or
    ``mixed`` (:func:`mixed_nv12`; the second reference the first moved)."""
    if kind == "moving":
        f = moving_nv12(rng, h, w, 3)
        return p_planes(device, f[2]), p_planes(device, f[1]), p_planes(device, f[0])
    if kind == "constant":
        f = content_nv12(rng, "constant", h, w)
        return (p_planes(device, f),) * 3
    if kind == "mixed":
        ref, cur = mixed_nv12(rng, h, w)
        return (p_planes(device, cur), p_planes(device, ref),
                p_planes(device, np.roll(ref, (-2, 4), (0, 1))))
    src = content_nv12(rng, "structured" if kind == "structured" else "random", h, w)
    noise = rng.integers(-3, 4, src.shape)
    ref1 = np.clip(np.roll(src, (2, -6), (0, 1)).astype(np.int32) + noise, 0, 255)
    ref2 = np.roll(src, (-4, 2), (0, 1))
    return (p_planes(device, src), p_planes(device, ref1.astype(np.uint8)),
            p_planes(device, ref2))


def deblock_meta(plv, mb_h: int, mb_w: int, device) -> tuple[torch.Tensor, ...]:
    """A P frame's own deblocking metadata (intra, nnz4, mv, ref) from its
    levels, or an IDR's (all intra) for ``plv`` None."""
    zero_mv = torch.zeros((mb_h, mb_w, 2), dtype=torch.int16, device=device)
    zero_ref = torch.zeros((mb_h, mb_w), dtype=torch.int16, device=device)
    if plv is None:
        return (torch.ones((mb_h, mb_w), dtype=torch.bool, device=device),
                torch.zeros((4 * mb_h, 4 * mb_w), dtype=torch.bool, device=device),
                zero_mv, zero_ref)
    return (plv.mode >= 2, deblock_ops.nnz4_grid(plv.acz), zero_mv if plv.mv is None else plv.mv,
            zero_ref if plv.ref is None else plv.ref)


def phase_p_kernels(device, rng) -> dict[str, int]:
    """H3, H4, H2 and H5 against their plain versions on the card, every
    output, with 0 difference, on moving structured, random and constant
    content (fewer cases on the last two): H3 at 4K with margins 9 (16
    planes, quarter-pel at search 8), 5 (4 planes, half-pel) and 8 (1
    plane, relay (k)'s full-pel stack: ``H3_MODES``); H4 at 4K,
    full-pel and ``fastsub`` at search 8, one reference, two references and
    one reference under the GDR clean-row rule, and at 1920x1088 the
    exhaustive half-pel and quarter-pel lattices at search 2; H2 (through
    ``encode_p_levels``, the search's kernels before it) at 4K at QP 0 and
    30, with and without motion and with a GDR band; H5 at 4K on an IDR
    (all intra) and on a P frame's own metadata, with and without
    ``slice_local`` (not on the constant frame, where it changes nothing).
    Then at each of ``EDGE_SHAPES`` on structured content: H3 with each
    of ``H3_MODES`` (plane rows of no multiple of 4 or of the kernel's 496
    columns a block, one MB row and column); H4 ``fastsub`` at
    search 8 with one and two references and under the GDR clean-row rule,
    and the quarter-pel lattice at search 4; H2 as :func:`p_edge_checks`
    says; H5 on an IDR and on the own metadata of a two-reference
    ``fastsub`` P frame, with and without ``slice_local``.  Returns the
    largest absolute difference by kernel."""
    for module in (levels_kernel, inter_kernel, deblock_kernel):
        module.reset_launch_counts()
    errs = dict.fromkeys(("p_levels_kernel", "subpel_planes_kernel",
                          "motion_search_kernel", "deblock_kernel"), 0)
    h, w = HEIGHT, WIDTH
    mb_h, mb_w = h // 16, w // 16

    def compare(kernel: str, label: str, got, want, plain: float) -> None:
        got = [g for g in (got if isinstance(got, tuple) else (got,)) if g is not None]
        want = [g for g in (want if isinstance(want, tuple) else (want,)) if g is not None]
        check(len(got) == len(want), f"{kernel} {label}: {len(got)} outputs, the "
              f"plain version {len(want)}")
        e = max(max_err(a, b) for a, b in zip(got, want))
        errs[kernel] = max(errs[kernel], e)
        print(f"kernel {kernel} {label}: max abs err {e} over {len(got)} outputs "
              f"({plain:.1f} s in the plain version)", flush=True)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for kind in ("moving", "random", "constant"):
        src, ref1, ref2 = p_content(device, rng, kind, h, w)
        full = kind == "moving"
        for margin, n in H3_MODES:
            want, secs = timed(lambda: levels_ops.subpel_planes_plain(ref1[0], margin, n))
            compare("subpel_planes_kernel", f"4K {kind} margin {margin} {n} planes",
                    levels_ops.subpel_planes(ref1[0], margin, n), want, secs)
        cases = [(0, [ref1], None), (3, [ref1, ref2], None)]
        if full:
            cases += [(3, [ref1], None), (0, [ref1, ref2], None),
                      (0, [ref1], P_CLEAN_ROWS), (3, [ref1], P_CLEAN_ROWS)]
        if kind == "constant":
            cases = cases[:1]
        for subpel, refs, clean in cases:
            label = (f"4K {kind} {'fastsub' if subpel else 'full-pel'} search {P_SEARCH} "
                     f"{len(refs)} ref{'s' if len(refs) > 1 else ''}"
                     + (f" clean rows {clean}" if clean else ""))
            want, secs = timed(lambda: levels_ops.motion_search_plain(
                src[0], refs, P_SEARCH, subpel, clean))
            compare("motion_search_kernel", label, levels_ops.motion_search(
                src[0], refs, P_SEARCH, subpel, clean), want, secs)
        pcases = [(30, 0, 0, None), (30, P_SEARCH, 3, None)]
        if full:
            pcases += [(0, P_SEARCH, 0, None), (30, P_SEARCH, 3, (P_CLEAN_ROWS, 70))]
        if kind == "constant":
            pcases = pcases[:1]
        last = None
        for qp, search, subpel, band in pcases:
            label = (f"4K {kind} qp {qp} " + (f"search {P_SEARCH} "
                     f"{'fastsub' if subpel else 'full-pel'}" if search else "zero motion")
                     + (f" GDR band {band}" if band else ""))
            args = (*src, *ref1, qp, search, subpel)
            want, secs = timed(lambda: levels_ops.encode_p_levels_plain(
                *args, gdr_band=band))
            got = levels_ops.encode_p_levels(*args, gdr_band=band)
            compare("p_levels_kernel", label, tuple(got), tuple(want), secs)
            modes = torch.bincount(got.mode.flatten().to(torch.int64), minlength=4)
            print(f"kernel p_levels_kernel {label}: modes skip/inter/intra DC/intra H "
                  f"{modes.tolist()}", flush=True)
            last = got
        metas = {"moving": [("IDR", None, False), ("P", last, False),
                            ("P slice_local", last, True)],
                 "random": [("P slice_local", last, True)],
                 "constant": []}[kind]
        recon = (last.recon_y, last.recon_cb, last.recon_cr)
        for label, plv, slice_local in metas:
            meta = deblock_meta(plv, mb_h, mb_w, device)
            want, secs = timed(lambda: deblock_ops.deblock_planes_plain(
                *recon, 30, *meta, slice_local=slice_local))
            got = deblock_ops.deblock_planes(*recon, 30, *meta, slice_local=slice_local)
            changed = int((got[0] != recon[0]).sum())
            compare("deblock_kernel", f"4K {kind} {label} ({changed} luma samples "
                    f"filtered)", got, want, secs)
    # the exhaustive sub-pel lattices at 1080p
    eh, ew = P_EXHAUSTIVE_SHAPE
    for kind in ("moving", "random"):
        src, ref1, ref2 = p_content(device, rng, kind, eh, ew)
        for subpel, refs in ((1, [ref1]), (2, [ref1, ref2])):
            want, secs = timed(lambda: levels_ops.motion_search_plain(
                src[0], refs, P_EXHAUSTIVE_SEARCH, subpel))
            compare("motion_search_kernel", f"{ew}x{eh} {kind} "
                    f"{'half' if subpel == 1 else 'quarter'}-pel search "
                    f"{P_EXHAUSTIVE_SEARCH} {len(refs)} ref(s)", levels_ops.motion_search(
                        src[0], refs, P_EXHAUSTIVE_SEARCH, subpel), want, secs)
    # H4 and H5 where their bands and blocks do not divide the picture
    for eh, ew in EDGE_SHAPES:
        emb_h, emb_w = eh // 16, ew // 16
        src, ref1, ref2 = p_content(device, rng, "structured", eh, ew)
        for margin, n in H3_MODES:
            want, secs = timed(lambda: levels_ops.subpel_planes_plain(ref1[0], margin, n))
            compare("subpel_planes_kernel", f"{ew}x{eh} structured margin {margin} {n} planes",
                    levels_ops.subpel_planes(ref1[0], margin, n), want, secs)
        clean = max(1, emb_h // 2)
        for search, subpel, refs, cl in ((P_SEARCH, 3, [ref1], None),
                                         (P_SEARCH, 3, [ref1, ref2], None),
                                         (P_SEARCH, 3, [ref1], clean),
                                         (P_TIMED_QPEL_SEARCH, 2, [ref1], None)):
            label = (f"{ew}x{eh} structured "
                     f"{'fastsub' if subpel == 3 else 'quarter-pel'} search {search} "
                     f"{len(refs)} ref{'s' if len(refs) > 1 else ''}"
                     + (f" clean rows {cl}" if cl else ""))
            want, secs = timed(lambda: levels_ops.motion_search_plain(
                src[0], refs, search, subpel, cl))
            compare("motion_search_kernel", label, levels_ops.motion_search(
                src[0], refs, search, subpel, cl), want, secs)
        plv = levels_ops.encode_p_levels(*src, *ref1, 30, P_SEARCH, 3, *ref2)
        p_edge_checks(eh, ew, device, rng, compare, timed)
        recon = (plv.recon_y, plv.recon_cb, plv.recon_cr)
        for label, meta_of, slice_local in (("IDR", None, False), ("P", plv, False),
                                            ("P slice_local", plv, True)):
            meta = deblock_meta(meta_of, emb_h, emb_w, device)
            want, secs = timed(lambda: deblock_ops.deblock_planes_plain(
                *recon, 30, *meta, slice_local=slice_local))
            got = deblock_ops.deblock_planes(*recon, 30, *meta, slice_local=slice_local)
            changed = int((got[0] != recon[0]).sum())
            compare("deblock_kernel", f"{ew}x{eh} structured {label}, fastsub two refs "
                    f"({changed} luma samples filtered)", got, want, secs)
    counts = {**levels_kernel.launch_counts(), **inter_kernel.launch_counts(),
              **deblock_kernel.launch_counts()}
    check(all(counts[k] > 0 for k in ("encode_p_levels", "subpel_planes",
                                       "motion_search", "deblock_planes")),
          f"a P-frame kernel was not launched by its checks: {counts}")
    print(f"kernels H2-H5 checked: launches {counts}", flush=True)
    return errs


def p_edge_checks(h: int, w: int, device, rng, compare, timed) -> None:
    """H2 (through ``encode_p_levels``, the search's kernels before it) at
    one of ``EDGE_SHAPES``: on mixed content (:func:`mixed_nv12`) and, below
    1920x1088, also on random and constant content, at QP 0, 30 and 51 (at
    1920x1088 QP 30): zero motion, ``fastsub`` at search 8 with a GDR band,
    the quarter-pel lattice at search 2 with two references, and the
    ``parts`` layout (half-pel search 2)."""
    big = h * w >= 1920 * 1088
    for kind in ("mixed",) if big else ("mixed", "random", "constant"):
        src, ref1, ref2 = p_content(device, rng, kind, h, w)
        band = (max(0, h // 32 - 1), max(1, h // 32 + 1))
        modes = torch.zeros(4, dtype=torch.int64, device=device)
        for qp in (30,) if big else (0, 30, 51):
            for search, subpel, refs, gdr, parts in (
                    (0, 0, (), None, 0), (P_SEARCH, 3, (), band, 0),
                    (2, 2, ref2, None, 0), (2, 1, (), None, 1)):
                args = (*src, *ref1, qp, search, subpel, *(refs or (None,) * 3))
                want, secs = timed(lambda: levels_ops.encode_p_levels_plain(
                    *args, gdr_band=gdr, parts=parts))
                got = levels_ops.encode_p_levels(*args, gdr_band=gdr, parts=parts)
                label = (f"{w}x{h} {kind} qp {qp} search {search} subpel {subpel}"
                         + (" two refs" if refs else "") + (f" GDR band {gdr}" if gdr else "")
                         + (" parts" if parts else ""))
                if big or kind == "mixed" and qp == 30 and not search:
                    compare("p_levels_kernel", label, tuple(got), tuple(want), secs)
                else:
                    e = max(max_err(a, b) for a, b in zip(got, want) if a is not None)
                    check(e == 0, f"p_levels_kernel {label}: max abs err {e}")
                modes += torch.bincount(got.mode.flatten().to(torch.int64), minlength=4)
        print(f"kernel p_levels_kernel {w}x{h} {kind}: every case exact; modes "
              f"skip/inter/intra DC/intra H {modes.tolist()}", flush=True)


def quad_meta(plv, mb_h: int, mb_w: int, device) -> tuple[torch.Tensor, ...]:
    """A partitioned P frame's own deblocking metadata: intra, nnz4, and its
    quadrant fields as the (2 mb_h, 2 mb_w) grid of 8x8 blocks (ref 0 with
    one reference)."""
    ref = (torch.zeros((2 * mb_h, 2 * mb_w), dtype=torch.int16, device=device)
           if plv.ref is None else deblock_ops.block_grid(plv.ref))
    return (plv.mode >= 2, deblock_ops.nnz4_grid(plv.acz),
            deblock_ops.block_grid(plv.mv), ref)


def packed(out) -> tuple[torch.Tensor, torch.Tensor]:
    """A packer's (words, nbits) with the uint32 words as their int32 bits."""
    return out[0].view(torch.int32), out[1]


def pack_p_args(plv, active: int):
    """pack_p_mbs's arguments for a P frame's levels (the partition fields
    where it has them)."""
    lv = (plv.mode, plv.zdc, plv.acz, plv.czdc, plv.cacz)
    if plv.pmode is None:
        return (*lv, plv.mv, plv.ref, active), {}
    return (*lv, None, None, active), dict(pmode=plv.pmode, mv4=plv.mv, ref4=plv.ref)


def phase_parts_kernels(device, rng) -> dict[str, int]:
    """H6, H2 on the ``parts`` layout, H5 with quadrant fields, H7 and H8
    against their plain versions on the card, every output, 0 difference,
    at 4K on moving structured content: H6 at full-pel and half-pel search
    8, quarter-pel search 4, and with two references at quarter-pel search
    3 (``PARTS_CASES``), also on random and constant content (where every
    candidate ties and the index in the key decides), and at each of
    ``EDGE_SHAPES`` on structured content with each of ``PARTS_EDGE_CASES``
    and one and two references; H2 (through ``encode_p_levels(parts=1)``, H3 and H6
    before it) at QP 30 at full-pel search 8 and with two references at
    quarter-pel search 3, and H5 on the second frame's own quadrant fields; H7 on
    H1's levels (default, and ``i4`` + ``chromah``) at 64 words an MB and at
    ``CAP_NW_MB``, at 4K and at each of ``EDGE_SHAPES`` on mixed content; H8 on H2's levels: zero motion, ``fastsub`` at search 8
    with one and two references, and both partitioned frames, at 64 words
    and one at ``CAP_NW_MB``; H8 at each of ``EDGE_SHAPES`` on H2's levels
    of mixed content (``PACK_P_EDGE_CASES``) at 64 words, ``CAP_NW_MB`` and
    ``LONG_NW_MB`` (H7 too), and on a 4K frame of the port's
    ``synthetic_p_fields`` in both layouts with two references at 64 words
    and ``CAP_NW_MB``.  For a packer, equal words over every word and equal
    bit counts.  Then H5 on the quadrant fields of a partitioned
    two-reference quarter-pel P frame at each of ``EDGE_SHAPES``.  Returns
    the largest absolute difference by kernel."""
    for module in (levels_kernel, inter_kernel, deblock_kernel, bitpack_kernel):
        module.reset_launch_counts()
    errs = dict.fromkeys(("parts_search_kernel", "p_levels_kernel", "deblock_kernel",
                          "pack_i_kernel", "pack_p_kernel"), 0)
    h, w = HEIGHT, WIDTH
    mb_h, mb_w = h // 16, w // 16

    def compare(kernel: str, label: str, got, want, secs: float, quiet: bool = False) -> int:
        got = [g for g in got if g is not None]
        want = [g for g in want if g is not None]
        check(len(got) == len(want), f"{kernel} {label}: {len(got)} outputs, the "
              f"plain version {len(want)}")
        e = max(max_err(a, b) for a, b in zip(got, want))
        errs[kernel] = max(errs[kernel], e)
        if not quiet:
            print(f"kernel {kernel} {label}: max abs err {e} over {len(got)} outputs "
                  f"({secs:.1f} s in the plain version)", flush=True)
        return e

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def parts_case(where: str, src, refs, search: int, subpel: int) -> None:
        label = (f"{where} {('full', 'half', 'quarter')[subpel]}-pel search {search} "
                 f"{len(refs)} ref{'s' if len(refs) > 1 else ''}")
        want, secs = timed(lambda: levels_ops.motion_search_parts_plain(
            src[0], refs, search, subpel, 30))
        got = levels_ops.motion_search_parts(src[0], refs, search, subpel, 30)
        compare("parts_search_kernel", label, got, want, secs)
        modes = torch.bincount(got[0].flatten().to(torch.int64), minlength=4)
        print(f"kernel parts_search_kernel {label}: partition modes 16x16/16x8/8x16/8x8 "
              f"{modes.tolist()}", flush=True)

    src, ref1, ref2 = p_content(device, rng, "moving", h, w)
    for search, subpel, nrefs in PARTS_CASES:
        parts_case("4K moving", src, [ref1, ref2][:nrefs], search, subpel)
    for kind in ("random", "constant"):
        ksrc, kref1, kref2 = p_content(device, rng, kind, h, w)
        for search, subpel, nrefs in PARTS_CASES:
            parts_case(f"4K {kind}", ksrc, [kref1, kref2][:nrefs], search, subpel)
    for eh, ew in EDGE_SHAPES:
        esrc, eref1, eref2 = p_content(device, rng, "structured", eh, ew)
        for search, subpel in PARTS_EDGE_CASES:
            for refs in ([eref1], [eref1, eref2]):
                parts_case(f"{ew}x{eh} structured", esrc, refs, search, subpel)

    # H2 on the parts layout, H5 on its quadrant fields, H8 on its levels
    frames = []
    for search, subpel, nrefs in ((P_SEARCH, 0, 1), (3, 2, 2)):
        args = (*src, *ref1, 30, search, subpel, *(ref2 if nrefs > 1 else (None,) * 3))
        label = f"4K moving qp 30 parts search {search} sub-pel {subpel} {nrefs} ref(s)"
        want, secs = timed(lambda: levels_ops.encode_p_levels_plain(*args, parts=1))
        got = levels_ops.encode_p_levels(*args, parts=1)
        compare("p_levels_kernel", label, tuple(got), tuple(want), secs)
        frames.append((got, nrefs))
        if nrefs == 1:
            continue        # the plain H5 takes seconds a 4K frame: one case
        recon = (got.recon_y, got.recon_cb, got.recon_cr)
        meta = quad_meta(got, mb_h, mb_w, device)
        want, secs = timed(lambda: deblock_ops.deblock_planes_plain(*recon, 30, *meta))
        compare("deblock_kernel", f"{label}, its quadrant fields",
                deblock_ops.deblock_planes(*recon, 30, *meta), want, secs)
    for eh, ew in EDGE_SHAPES:
        esrc, eref1, eref2 = p_content(device, rng, "structured", eh, ew)
        got = levels_ops.encode_p_levels(*esrc, *eref1, 30, 3, 2, *eref2, parts=1)
        recon = (got.recon_y, got.recon_cb, got.recon_cr)
        meta = quad_meta(got, eh // 16, ew // 16, device)
        want, secs = timed(lambda: deblock_ops.deblock_planes_plain(*recon, 30, *meta))
        compare("deblock_kernel", f"{ew}x{eh} structured qp 30 parts search 3 sub-pel 2 "
                f"2 refs, its quadrant fields", deblock_ops.deblock_planes(*recon, 30, *meta),
                want, secs)
    for qp, search, subpel, nrefs in ((30, 0, 0, 1), (30, P_SEARCH, 3, 1),
                                      (30, P_SEARCH, 3, 2)):
        second = ref2 if nrefs > 1 else (None,) * 3
        frames.append((levels_ops.encode_p_levels(*src, *ref1, qp, search, subpel, *second),
                       nrefs))
    for k, (plv, nrefs) in enumerate(frames):
        a, kw = pack_p_args(plv, nrefs)
        for nw in (64, CAP_NW_MB)[:2 if k == 0 else 1]:
            label = (f"4K P frame {'parts' if plv.pmode is not None else 'P_16x16'} "
                     f"{nrefs} active ref(s) {nw} words")
            want, secs = timed(lambda: bitpack_ops.pack_p_mbs_plain(*a, nw, **kw))
            got = bitpack_ops.pack_p_mbs(*a, nw, **kw)
            compare("pack_p_kernel", label, packed(got), packed(want), secs)
            print(f"kernel pack_p_kernel {label}: {int(got[1].sum())} bits, "
                  f"{int((got[1] > 32 * nw).sum())} MBs over the cap", flush=True)

    lv0 = frames[0][0]
    vec = all(t.data_ptr() % 16 == 0 for t in (lv0.zdc, lv0.acz, lv0.czdc, lv0.cacz))
    print(f"kernel pack_p_kernel 4K: the levels' 16-byte loads taken (vec) {vec}", flush=True)
    check(vec, "pack_p_kernel: H2's level segments are not 16-byte aligned")

    # H8 at the edge geometries on mixed content (random and constant content
    # there are tests/test_torch_cuda.py's test_pack_p_at_the_tilings_edges):
    # rows of one MB, of 40 (runs of 3 and of 1), one MB row, one MB column
    for eh, ew in EDGE_SHAPES:
        e, n, bits, t0 = 0, 0, 0, time.perf_counter()
        esrc, eref1, eref2 = p_content(device, rng, "mixed", eh, ew)
        for search, subpel, two, partitioned in PACK_P_EDGE_CASES:
            plv = levels_ops.encode_p_levels(*esrc, *eref1, 30, search, subpel,
                                             *(eref2 if two else (None,) * 3),
                                             parts=int(partitioned))
            a, kw = pack_p_args(plv, 2 if two else 1)
            for nw in (64, CAP_NW_MB, LONG_NW_MB):
                got = bitpack_ops.pack_p_mbs(*a, nw, **kw)
                e = max(e, compare("pack_p_kernel", f"{ew}x{eh}", packed(got), packed(
                    bitpack_ops.pack_p_mbs_plain(*a, nw, **kw)), 0.0, quiet=True))
                n += 1
                bits += int(got[1].sum())
        print(f"kernel pack_p_kernel {ew}x{eh} mixed: max abs err {e} over {n} cases "
              f"({bits} bits; {time.perf_counter() - t0:.1f} s)", flush=True)
    # H8 on a 4K frame of synthetic fields, both layouts
    syn = {k: torch.from_numpy(v).to(device)
           for k, v in bitpack_ops.synthetic_p_fields(rng, mb_h, mb_w).items()}
    coded = syn["mode"] != 0
    row_coded = coded.any(1)
    print(f"kernel pack_p_kernel 4K synthetic fields: {int(coded.sum())} coded MBs of "
          f"{mb_h * mb_w}, {int((~row_coded).sum())} rows with none", flush=True)
    slv = tuple(syn[k] for k in ("mode", "zdc", "acz", "czdc", "cacz"))
    for label, a, kw in (("P_16x16", (*slv, syn["mv"], syn["ref"], 2), {}),
                         ("parts", (*slv, None, None, 2),
                          dict(pmode=syn["pmode"], mv4=syn["mv4"], ref4=syn["ref4"]))):
        for nw in (64, CAP_NW_MB):
            full = f"4K synthetic fields {label} 2 active refs {nw} words"
            want, secs = timed(lambda: bitpack_ops.pack_p_mbs_plain(*a, nw, **kw))
            got = bitpack_ops.pack_p_mbs(*a, nw, **kw)
            compare("pack_p_kernel", full, packed(got), packed(want), secs)
            print(f"kernel pack_p_kernel {full}: {int(got[1].sum())} bits, "
                  f"{int((got[1] > 32 * nw).sum())} MBs over the cap", flush=True)

    # H7 on H1's levels
    frame = torch.from_numpy(content_nv12(rng, "structured", h, w)).to(device)
    for flags in ({}, {"i4": True, "chromah": True}):
        lv, imode, *extra = levels_kernel.encode_levels(*intra_planes(frame, h), 30, **flags)
        ex = dict(zip(["i4modes"] * ("i4" in flags) + ["cmode"] * ("chromah" in flags),
                      extra))
        for nw in (64, CAP_NW_MB):
            label = f"4K {'+'.join(flags) or 'default'} {nw} words"
            want, secs = timed(lambda: bitpack_ops.pack_i_mbs_plain(*lv, imode, nw, **ex))
            got = bitpack_ops.pack_i_mbs(*lv, imode, nw, **ex)
            compare("pack_i_kernel", label, packed(got), packed(want), secs)
    # H7 at the edge geometries: rows of one MB, of 40 (runs of 16, 16 and
    # 8), one MB row, one MB column
    for eh, ew in EDGE_SHAPES:
        eframe = torch.from_numpy(mixed_nv12(rng, eh, ew)[1]).to(device)
        for flags in ({}, {"i4": True, "chromah": True}):
            lv, imode, *extra = levels_kernel.encode_levels(*intra_planes(eframe, eh), 30,
                                                            **flags)
            ex = dict(zip(["i4modes"] * ("i4" in flags) + ["cmode"] * ("chromah" in flags),
                          extra))
            for nw in (64, CAP_NW_MB, LONG_NW_MB):
                label = f"{ew}x{eh} mixed {'+'.join(flags) or 'default'} {nw} words"
                want, secs = timed(lambda: bitpack_ops.pack_i_mbs_plain(*lv, imode, nw, **ex))
                got = bitpack_ops.pack_i_mbs(*lv, imode, nw, **ex)
                compare("pack_i_kernel", label, packed(got), packed(want), secs)
    counts = {**levels_kernel.launch_counts(), **inter_kernel.launch_counts(),
              **deblock_kernel.launch_counts(), **bitpack_kernel.launch_counts()}
    check(all(counts[k] > 0 for k in ("motion_search_parts", "encode_p_levels",
                                       "deblock_planes", "pack_i_mbs", "pack_p_mbs")),
          f"a kernel was not launched by its checks: {counts}")
    print(f"kernels H6-H8 (and H2, H5 on the parts fields) checked: launches {counts}",
          flush=True)
    return errs


# the GOP encoder's oracles in a child process: the frames, the output
# path, "host" (GopCavlcEncoder(slices=mb_h), Python) or "cpu" (the same
# class on the CPU, the kernels' plain versions) and the encoders' options
# as JSON in; every stream's access units out
GOP_CHILD = r"""
import json, sys
import numpy as np
import torch
from opencv_opencl_tpu_torch.io.h264_inter import CudaGopEncoder, GopCavlcEncoder

torch.set_num_threads(2)
frames = np.load(sys.argv[1])
h, w = frames.shape[1] * 2 // 3, frames.shape[2]
streams = []
for kw in json.loads(sys.argv[4]):
    host = {k: v for k, v in kw.items() if k not in ("bitpack", "nw_mb")}
    enc = (GopCavlcEncoder(w, h, slices=h // 16, **host) if sys.argv[3] == "host"
           else CudaGopEncoder(w, h, device="cpu", **kw))
    streams.append([au for f in frames for au in enc.encode(f)] + enc.flush())
aus = [au for s in streams for au in s]
np.savez(sys.argv[2], blob=np.frombuffer(b"".join(aus), np.uint8),
         lens=np.array([len(a) for a in aus]), counts=np.array([len(s) for s in streams]))
"""


# the fused enhance + encode step of each of FUSED_CASES on the CPU (the
# kernels' plain versions), all frames one batch from the first reference
# pictures: the packed lanes and the reference pictures out
FUSED_CHILD = r"""
import json, sys
import numpy as np
import torch
import chip_smoke

torch.set_num_threads(2)
frames = np.load(sys.argv[1])
h, w = frames.shape[1] * 2 // 3, frames.shape[2]
out = {}
for name, op, opts in json.loads(sys.argv[3]):
    packed, recon = chip_smoke.drive_fused(
        chip_smoke.fused_step(op, opts, h, w, "cpu"), opts, frames, len(frames),
        chip_smoke.fused_encoder(opts, h, w, "cpu"))
    out[name] = packed
    for i, t in enumerate(recon or ()):
        out[f"{name}.recon{i}"] = t.numpy()
np.savez(sys.argv[2], **out)
"""


@contextlib.contextmanager
def gop_oracles(tmp: str):
    """Start the GOP encoder's two oracle children on seed-made frames:
    ``GopCavlcEncoder(slices=mb_h)`` for each of ``P_STREAMS`` at
    ``P_STREAM_SHAPE``, and ``CudaGopEncoder(device="cpu")`` for
    ``CPU_STREAM`` at ``CPU_STREAM_SHAPE``; and the fused step's plain
    versions on the CPU for each of ``FUSED_CASES`` at ``FUSED_CPU_SHAPE``
    (``FUSED_CHILD``); yields {name: (frames, child, output path,
    options)}."""
    rng = np.random.default_rng(13)
    runs = {"host": (P_STREAM_SHAPE, P_STREAM_FRAMES, list(P_STREAMS)),
            "cpu": (CPU_STREAM_SHAPE, CPU_STREAM_FRAMES, [CPU_STREAM])}
    with contextlib.ExitStack() as stack:
        out = {}
        for name, ((h, w), n, kws) in runs.items():
            frames = np.stack(moving_nv12(rng, h, w, n))
            path_in = os.path.join(tmp, f"gop_{name}_in.npy")
            path_out = os.path.join(tmp, f"gop_{name}_out.npz")
            np.save(path_in, frames)
            proc = stack.enter_context(child(GOP_CHILD, [path_in, path_out, name,
                                                         json.dumps(kws)]))
            out[name] = (frames, proc, path_out, kws)
        # the fused step's plain versions on the CPU at 1920x1080
        frames = np.stack(moving_nv12(rng, *FUSED_CPU_SHAPE, FUSED_CPU_FRAMES))
        path_in = os.path.join(tmp, "fused_in.npy")
        path_out = os.path.join(tmp, "fused_out.npz")
        np.save(path_in, frames)
        proc = stack.enter_context(child(FUSED_CHILD, [path_in, path_out,
                                                       json.dumps(FUSED_CASES)]))
        out["fused"] = (frames, proc, path_out, FUSED_CASES)
        yield out


def gop_oracle_streams(proc, path: str) -> list[list[bytes]]:
    """A GOP oracle child's streams of access units."""
    try:
        text, _ = proc.communicate(timeout=ORACLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"a GOP oracle took more than {ORACLE_TIMEOUT} s")
    check(proc.returncode == 0, f"a GOP oracle failed: {text[-2000:]}")
    data = np.load(path)
    blob, aus, pos = data["blob"].tobytes(), [], 0
    for n in data["lens"]:
        aus.append(blob[pos:pos + int(n)])
        pos += int(n)
    streams, pos = [], 0
    for n in data["counts"]:
        streams.append(aus[pos:pos + int(n)])
        pos += int(n)
    return streams


def phase_p_streams(oracles) -> None:
    """The GOP encoder's access units on the card: at 640x368 over four
    frames (IDR, P, P, IDR) equal to ``GopCavlcEncoder(slices=mb_h)``'s for
    each of ``P_STREAMS`` (the partition modes and the device bit packer
    among them; a stream with ``bitpack`` is also made at ``nw_mb=3``, where
    MBs overflow the cap and their frames take the host entropy path: the
    same access units, the overflow counter above 0, where it is 0 at 64
    words), and at 1920x1088 over three frames equal to the same class's on
    the CPU (the kernels' plain versions)."""
    for name, label in (("host", "GopCavlcEncoder(slices=mb_h)"),
                        ("cpu", "CudaGopEncoder(device='cpu')")):
        frames, proc, path, kws = oracles[name]
        h, w = frames.shape[1] * 2 // 3, frames.shape[2]
        t0 = time.perf_counter()
        want = gop_oracle_streams(proc, path)
        waited = time.perf_counter() - t0
        for kw, stream in zip(kws, want):
            runs = [kw] + ([dict(kw, nw_mb=CAP_NW_MB)] if kw.get("bitpack") else [])
            for run in runs:
                enc = CudaGopEncoder(w, h, **run)
                check(enc.device.type == "cuda", f"the GOP encoder is on {enc.device}")
                got = [au for f in frames for au in enc.encode(f)] + enc.flush()
                spec = ":".join(f"{k}={v}" if v is not True else k for k, v in run.items())
                check(got == stream, f"stream tpu:{spec} at {w}x{h}: access units other "
                      f"than {label}'s")
                capped = run.get("nw_mb") == CAP_NW_MB
                check(enc._bits_overflows > 0 if capped else enc._bits_overflows == 0,
                      f"stream tpu:{spec}: {enc._bits_overflows} frames over the "
                      f"bit packer's cap")
                print(f"stream tpu:{spec} at {w}x{h}: {len(got)} access units "
                      f"({[len(a) for a in got]} bytes) equal {label}'s (waited "
                      f"{waited:.1f} s for the oracle); frames over the bit packer's "
                      f"cap {enc._bits_overflows}", flush=True)


def fused_step(op: str, opts: dict, h: int, w: int, device):
    """The fused enhance + encode step of a ``FUSED_CASES`` entry."""
    spec, cfg = clahe_config(h, w) if op == "clahe" else histeq_config(h, w)
    kw = dict(opts)
    if "gop" in kw:
        return fused_encode.build_enhance_gop_fn(cfg, spec, kw.pop("gop"),
                                                 device=device, **kw)
    return fused_encode.build_enhance_levels_fn(cfg, spec, device=device, **kw)


def fused_encoder(opts: dict, h: int, w: int, device):
    """The device encoder whose options match a ``FUSED_CASES`` entry's
    step (QP 30)."""
    packer = dict(bitpack=True, nw_mb=opts["bitpack"]) if opts.get("bitpack") else {}
    if "gop" not in opts:
        return CudaCavlcEncoder(w, h, qp=30, device=device, **packer)
    sub = opts.get("subpel", 0)
    return CudaGopEncoder(w, h, qp=30, gop=opts["gop"], search=opts.get("search", 0),
                          halfpel=sub == 1, quarterpel=sub == 2, fastsub=sub == 3,
                          refs=opts.get("refs", 1), parts=opts.get("parts", False),
                          deblock=opts.get("deblock", False), device=device, **packer)


def drive_fused(fn, opts: dict, frames: np.ndarray, batch: int, enc):
    """Run a fused step over ``frames`` in batches of ``batch`` from the
    encoder's first reference pictures: (the packed lanes of every frame
    on the host, the last reference pictures or None)."""
    recon = enc.initial_recon() if "gop" in opts else None
    packed = []
    for lo in range(0, len(frames), batch):
        if recon is None:
            out = fn(frames[lo:lo + batch], 30)
        else:
            out, *recon = fn(frames[lo:lo + batch], 30, lo, *recon)
        packed.append(out.cpu().numpy())
    return np.concatenate(packed), recon


def fused_oracle_arrays(proc, path: str) -> dict[str, np.ndarray]:
    """The fused child's packed lanes and reference pictures, by name."""
    try:
        text, _ = proc.communicate(timeout=ORACLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"the fused step's CPU child took more than {ORACLE_TIMEOUT} s")
    check(proc.returncode == 0, f"the fused step's CPU child failed: {text[-2000:]}")
    return dict(np.load(path))


def phase_fused_encode(device, rng, fused) -> None:
    """The fused enhance + encode step (models/fused_encode.py) on the card,
    for each of ``FUSED_CASES``: at 4K over two batches of 4 (the GOP steps'
    chain carried across them on the card; ``gop=4``: IDRs at frames 0 and
    4) and at 1920x1080 over one batch of 3.  The access units that the
    device encoder assembles from the packed lanes (``encode_from_packed``)
    must equal those of the same encoder, unfused, on the card, from the
    same frames enhanced by the card's ``Enhancer`` step; at 1920x1080 the
    packed lanes and the last reference pictures must also equal the CPU
    plain versions' (a child started with the GOP oracles), exactly."""
    frames_cpu, proc, path, _ = fused
    runs = ((np.stack(moving_nv12(rng, HEIGHT, WIDTH, FUSED_4K_FRAMES)), BATCH),
            (frames_cpu, len(frames_cpu)))
    oracle = None
    for frames, batch in runs:
        h, w = frames.shape[1] * 2 // 3, frames.shape[2]
        enhanced = {}
        for name, op, opts in FUSED_CASES:
            if op not in enhanced:
                spec, cfg = clahe_config(h, w) if op == "clahe" else histeq_config(h, w)
                enhanced[op] = build_enhance_fn(cfg, spec, donate=False)(
                    torch.from_numpy(frames).to(device)).cpu().numpy()
            enc = fused_encoder(opts, h, w, device)
            packed, recon = drive_fused(fused_step(op, opts, h, w, device), opts,
                                        frames, batch, enc)
            got = [au for p in packed for au in enc.encode_from_packed(p)]
            ref = fused_encoder(opts, h, w, device)
            want = [au for f in enhanced[op] for au in ref.encode(f)] + ref.flush()
            check(got == want, f"fused {name} at {w}x{h}: access units other than "
                  f"the unfused encoder's")
            check(enc._bits_overflows == getattr(ref, "_bits_overflows", 0),
                  f"fused {name} at {w}x{h}: {enc._bits_overflows} frames over the "
                  f"bit packer's cap, the unfused encoder "
                  f"{getattr(ref, '_bits_overflows', 0)}")
            held = "the unfused card encoder's"
            if frames is frames_cpu:
                if oracle is None:
                    t0 = time.perf_counter()
                    oracle = fused_oracle_arrays(proc, path)
                    print(f"fused step: waited {time.perf_counter() - t0:.1f} s for "
                          f"the CPU child", flush=True)
                check(np.array_equal(packed, oracle[name]), f"fused {name} at {w}x{h}: "
                      f"packed lanes other than the CPU plain versions'")
                for i, t in enumerate(recon or ()):
                    check(np.array_equal(t.cpu().numpy(), oracle[f"{name}.recon{i}"]),
                          f"fused {name} at {w}x{h}: reference picture {i} other "
                          f"than the CPU plain versions'")
                held += " and the CPU plain versions' packed lanes"
            print(f"fused {name} at {w}x{h}, {len(frames)} frames in batches of "
                  f"{batch}: packed {packed.shape[-1]} lanes, AUs "
                  f"{[len(a) for a in got]} bytes, equal to {held}; frames over the "
                  f"bit packer's cap {enc._bits_overflows}", flush=True)


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


def golden_bgr(bgr: np.ndarray, enhance_y) -> np.ndarray:
    """The image apps' flow on the numpy oracles: BGR -> YUV, ``enhance_y``
    on Y, back to BGR."""
    yuv = color_oracle.bgr2yuv(bgr)
    y = enhance_y(np.ascontiguousarray(yuv[..., 0]))
    return color_oracle.yuv2bgr(np.stack([y, yuv[..., 1], yuv[..., 2]], axis=-1))


def counted(fn):
    """``fn()`` with the launch counts set to 0 before and read after."""
    cuda_ops.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, cuda_ops.launch_counts()


def check_only(label: str, counts: dict[str, int], wrappers: tuple[str, ...]) -> None:
    check(all(counts[w] > 0 for w in wrappers)
          and all(n == 0 for w, n in counts.items() if w not in wrappers),
          f"{label} did not launch {wrappers} alone: {counts}")


def phase_app_paths(device, rng, card: str, tmp: str, h=HEIGHT,
                    w=WIDTH) -> dict[str, dict[str, int]]:
    """The image and video apps' compute parts on the card (their ``run``
    reads and writes through cv2, which the card's machine lacks): each
    path's launches counted around the app's own function, its output held
    at 0 LSB to the same function on the CPU (the kernels' plain versions)
    and to ``core/golden.py``, and its own times printed with the card.
    ``histeq_image.enhance_bgr`` (K1 on a 1x1 grid, K4) and
    ``clahe_image.clahe_bgr`` (K1, K2, K3; at clip 3.0 and 4x4 tiles, at 4K
    and 1919x1079) on BGR images; ``m2_bench``'s two methods, equal to each
    other and to golden; ``parity_bench.device_parity`` for histeq and CLAHE
    (clip 2.0, 8x8) with golden as the reference, no pixel off;
    ``clahe_video.enhance_frames`` over 16 ``TestSource`` 4K frames into a
    ``RawSink``, every frame the plain versions'."""
    cpu = torch.device("cpu")
    per_path = {}
    bgr = color_oracle.nv12_to_bgr(nv12_batch(rng, 1, h, w)[0])

    (out, stage_us), per_path["app histeq_image"] = counted(
        lambda: histeq_image.enhance_bgr(bgr, device))
    _, warm_us = histeq_image.enhance_bgr(bgr, device)
    check_only("histeq_image", per_path["app histeq_image"],
               ("tile_histograms", "apply_lut"))
    want = golden_bgr(bgr, golden.equalize_hist)
    check(np.array_equal(out, histeq_image.enhance_bgr(bgr, cpu)[0])
          and np.array_equal(out, want), "histeq_image differs from plain or golden")
    print(f"time app histeq_image {w}x{h}: stage us, first call "
          f"{ {k: round(v, 1) for k, v in stage_us.items()} }, second "
          f"{ {k: round(v, 1) for k, v in warm_us.items()} } [{card}]", flush=True)

    counts = []
    for ah, aw in ((h, w), APP_ODD_SHAPE):
        image = bgr if (ah, aw) == (h, w) else color_oracle.nv12_to_bgr(
            nv12_batch(rng, 1, ah + 1, aw + 1)[0])[:ah, :aw]
        (out, ms), c = counted(lambda: clahe_image.clahe_bgr(
            image, APP_CLAHE_CLIP, APP_CLAHE_TILE, device))
        counts.append(c)
        want = golden_bgr(image, lambda y: golden.clahe(
            y, APP_CLAHE_CLIP, (APP_CLAHE_TILE, APP_CLAHE_TILE)))
        plain, _ = clahe_image.clahe_bgr(image, APP_CLAHE_CLIP, APP_CLAHE_TILE, cpu)
        check(np.array_equal(out, plain) and np.array_equal(out, want),
              f"clahe_image {aw}x{ah} differs from plain or golden")
        # the app's one call beside the same compute's medians of 30, from an
        # idle card and device alone (outside the path's counts)
        y = color.bgr2yuv(image, device)[..., 0].contiguous()
        plan = clahe_ops.make_clahe_plan(ah, aw, APP_CLAHE_CLIP,
                                         (APP_CLAHE_TILE, APP_CLAHE_TILE))
        idle = time_ms(lambda: clahe_ops.clahe_apply(y, plan, "onehot"))
        alone = device_ms(lambda: clahe_ops.clahe_apply(y, plan, "onehot"))
        print(f"time app clahe_image {aw}x{ah}: CLAHE_apply_time_ms={ms:.4f} "
              f"(clipLimit={APP_CLAHE_CLIP:g}, tileGridSize={APP_CLAHE_TILE}x"
              f"{APP_CLAHE_TILE}), CUDA events around K1, K2, K3 after a warm-up; "
              f"the same compute, median of 30: idle card {idle:.4f} ms, device "
              f"alone {alone:.4f} ms [{card}]", flush=True)
    per_path["app clahe_image"] = sum_counts(counts)
    check_only("clahe_image", per_path["app clahe_image"],
               ("tile_histograms", "build_luts", "clahe_interpolate"))

    yuv = m2_bench.to_yuv(bgr, device)
    ((m1, m1_us), (m2, m2_us)), per_path["app m2_bench"] = counted(
        lambda: (m2_bench.method1(yuv, device), m2_bench.method2(yuv, device)))
    check_only("m2_bench", per_path["app m2_bench"], ("tile_histograms", "apply_lut"))
    check(torch.equal(m1, m2), "m2_bench's methods differ")
    check(np.array_equal(color.yuv2bgr(m1, device).cpu().numpy(),
                         golden_bgr(bgr, golden.equalize_hist)),
          "m2_bench differs from golden")
    print(f"time app m2_bench {w}x{h}: Method 1 (staged) {m1_us:.1f} us, Method 2 "
          f"(one function) {m2_us:.1f} us [{card}]", flush=True)

    y = color_oracle.bgr2yuv_i420(bgr)[:h]
    counts = []
    for op, want in (("histeq", golden.equalize_hist(y)),
                     ("clahe", golden.clahe(y, CLIP, GRID))):
        (out, ms, err), c = counted(lambda: parity_bench.device_parity(
            y, want, op, device, CLIP, GRID[0], 0, APP_PARITY_REPEAT))
        counts.append(c)
        check(err == 0.0 and np.array_equal(out, want),
              f"parity_bench {op}: {err}% of pixels off golden")
        print(f"time app parity_bench {w}x{h} {op}: GPU {op} time {ms:.4f} ms "
              f"(chained avg of {APP_PARITY_REPEAT}, median of 3), 0% of pixels "
              f"off golden [{card}]", flush=True)
    per_path["app parity_bench"] = sum_counts(counts)
    check_only("parity_bench", per_path["app parity_bench"],
               ("tile_histograms", "build_luts", "clahe_interpolate", "apply_lut"))

    spec, cfg = clahe_config(h, w)
    frames = list(TestSource(spec, num_frames=APP_VIDEO_FRAMES))
    path = os.path.join(tmp, "clahe_video.nv12")
    sink = RawSink(path)
    timing = TimingStats(window=APP_VIDEO_FRAMES, label="clahe_video")
    enhancer = Enhancer(cfg, spec, device)
    n, per_path["app clahe_video"] = counted(lambda: clahe_video.enhance_frames(
        iter(frames), enhancer, [sink], timing))
    sink.close()
    check(n == sink.frames == APP_VIDEO_FRAMES, f"clahe_video wrote {sink.frames}")
    check_only("clahe_video", per_path["app clahe_video"],
               ("tile_histograms", "build_luts", "clahe_interpolate"))
    got = np.fromfile(path, np.uint8).reshape(APP_VIDEO_FRAMES, h * 3 // 2, w)
    batch = torch.from_numpy(np.stack(frames)).to(device)
    plan = clahe_ops.make_clahe_plan(h, w, CLIP, GRID)
    want = torch.cat([plain_step(batch[:, :h], plan), batch[:, h:]], dim=1)
    bad = int((torch.from_numpy(got).to(device) != want).flatten(1).any(1).sum())
    check(bad == 0, f"clahe_video: {bad} of {APP_VIDEO_FRAMES} frames differ from plain")
    per = max(timing.frame_count, 1)
    print(f"time app clahe_video {w}x{h} CLAHE: {APP_VIDEO_FRAMES} TestSource frames "
          f"into a RawSink, per frame compute {timing.sum_compute / per:.3f} ms, "
          f"memory {timing.sum_memory / per:.3f} ms, total "
          f"{timing.sum_total / per:.3f} ms, p50 {timing.percentile_total_ms(50):.3f} "
          f"[{card}]", flush=True)
    print(f"app paths: launches "
          f"{ {k: {w: n for w, n in c.items() if n} for k, c in per_path.items()} }",
          flush=True)
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


def mesh_encode_checks(label: str, ranks: list, names: list[str]) -> dict:
    """The checks of the sharded encoder's cases on one mesh
    (``launch.compare_with_encoder``'s results, by rank): rank 0's access
    units equal the single-card encoder's, no rank loaded JAX, every rank
    launched its kernels.  Returns each case's launch counts, summed over
    the ranks."""
    per_path = {}
    for i, name in enumerate(names):
        res = [r[i] for r in ranks]
        single = next((r["single"] for r in res if r["single"] is not None), None)
        check(single is not None and res[0].get("aus") == single,
              f"sharded encoder {label} {name}: rank 0's access units differ from "
              f"the single-card encoder's")
        check(all(not r["loaded"] for r in res), f"{label} {name}: JAX was loaded")
        for rank, r in enumerate(res):
            counts = r["launches"]
            check(counts["encode_levels"] > 0,
                  f"{label} {name}: rank {rank} did not launch H1: {counts}")
        per_path[f"sharded_encode_{label}_{name}"] = sum_counts([r["launches"] for r in res])
    return per_path


def mesh_block_launches(mode: str, opts: dict, frames: int, ranks: int) -> dict[str, int]:
    """The launches one rank of a GOP-per-rank call makes on its own block
    of the padded batch (the wrappers that launch, by count): the enhance
    kernels and H1 (and H7 with ``bitpack``) once a block for the intra
    step; for the GOP step the enhance kernels once, H1 on each IDR, H3, H4
    and H2 on each P frame, H5 on every frame with ``deblock``."""
    unit = opts.get("gop", 1)
    per = -(-frames // (ranks * unit)) * unit
    want = {"tile_histograms": 1, "build_luts": 1, "clahe_interpolate": 1}
    if mode == "levels":
        want["encode_levels"] = 1
        if opts.get("bitpack"):
            want["pack_i_mbs"] = 1
        return want
    idr = per // unit
    want.update(encode_levels=idr, subpel_planes=per - idr, motion_search=per - idr,
                encode_p_levels=per - idr)
    if opts.get("deblock"):
        want["deblock_planes"] = per
    return want


def phase_sharded_encode(device, rng, card: str, tmp: str) -> dict[str, dict[str, int]]:
    """The sharded encoder (``parallel/sharded_encode.py``) on the card.

    (a) GOP-per-rank, fused, at 4K CLAHE (clip 2.0, 8x8, passthrough): each
    of ``MESH_ENCODE_CASES`` on a 1x1 mesh on NCCL in this process and on a
    2x1 mesh of two spawned processes that share the card (gloo, through
    the host); the ranks other than 0 pass another qp, which rank 0's
    broadcast must override; rank 0's access units must equal the
    single-card ``CudaGopEncoder`` / ``CudaCavlcEncoder``'s on the frames
    the single-card ``build_enhance_fn`` enhanced.  (b) The banded encoder
    at 4K over 3 ranks (gloo), for ``BANDED_CASES``: its access units must
    equal ``CudaGopEncoder``'s.  (c) Relay (n): ``relay.run`` on a 2x1 group
    (``launch.run_relay``) with ``--mesh=2x1 --fused-encode`` to
    ``rtp+h264://``, received by the port's ``rtp_receiver`` child: the
    stream it records must equal a single-card ``CudaGopEncoder``'s on the
    ``TestSource`` frames the single-card ``Enhancer`` enhanced.  Every
    rank is held to its kernels' launches; the times are wall times, the
    processes sharing one card (no multi-card speed-up).  Returns each
    path's launch counts."""
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1, "the 1x1 mesh needs the NCCL group")
    from opencv_opencl_tpu_torch.parallel.mesh import make_mesh

    spec, cfg = clahe_config(HEIGHT, WIDTH)
    frames = np.stack(moving_nv12(rng, HEIGHT, WIDTH, MESH_GOP_FRAMES))
    cases = [dict(mode=mode, cfg=cfg, spec=spec, enc=opts, qp=MESH_ENCODE_QP,
                  frames=frames if mode == "gop" else frames[:MESH_INTRA_FRAMES])
             for _, mode, opts in MESH_ENCODE_CASES]
    names = [name for name, _, _ in MESH_ENCODE_CASES]
    per_path = {}
    for label in ("1x1", "2x1"):
        t0 = time.perf_counter()
        if label == "1x1":
            ranks = [launch.compare_with_encoder(make_mesh(shape=(1, 1)), device, cases,
                                                 True, True)]
        else:
            ranks = launch.run_on_mesh((2, 1), launch.compare_with_encoder,
                                       (cases, True, True), device_type="cuda",
                                       timeout=SPAWN_TIMEOUT)
        elapsed = time.perf_counter() - t0
        want_backend = "nccl" if label == "1x1" else "gloo"
        check(all(r[0]["backend"] == want_backend for r in ranks),
              f"sharded encoder {label}: backend {[r[0]['backend'] for r in ranks]}")
        paths = mesh_encode_checks(label, ranks, names)
        for i, (name, mode, opts) in enumerate(MESH_ENCODE_CASES):
            counts = paths[f"sharded_encode_{label}_{name}"]
            n = len(cases[i]["frames"])
            want = mesh_block_launches(mode, opts, n, len(ranks))
            for rank, r in enumerate(ranks):
                got = {k: v for k, v in r[i]["launches"].items() if v}
                check(got == want,
                      f"sharded encoder {label} {name} rank {rank}: launches {got}, "
                      f"want {want} (its own block of the padded batch, once)")
            ms = [r[i]["ms"] for r in ranks]
            print(f"main path sharded_encode_{label}_{name} ({want_backend}): {n} 4K "
                  f"frames, rank 0's AUs equal the single-card encoder's, launches "
                  f"{counts}", flush=True)
            print(f"time sharded_encode {label} {name} 4K: the mesh call "
                  f"{[round(m['call'], 2) for m in ms]} ms, in it each rank's block "
                  f"({-(-n // (len(ranks) * (opts.get('gop', 1)))) * opts.get('gop', 1)} "
                  f"frames) through the fused step "
                  f"{[round(m['step'], 2) for m in ms]} ms and the gather of the lanes "
                  f"to rank 0 {[round(m['gather'], 2) for m in ms]} ms (wall, by rank; "
                  f"the ranks share one card) [{card}]", flush=True)
        per_path.update(paths)
        print(f"main path sharded_encode {label}: {elapsed:.1f} s for the "
              f"{len(cases)} encoders, spawn and references included", flush=True)

    bspec = FrameSpec(width=WIDTH, height=HEIGHT)
    bframes = np.stack(moving_nv12(rng, HEIGHT, WIDTH, BANDED_FRAMES))
    bcases = [dict(mode="banded", spec=bspec, enc=dict(gop=BANDED_FRAMES, **kw),
                   qp=MESH_ENCODE_QP, frames=bframes) for _, kw in BANDED_CASES]
    t0 = time.perf_counter()
    ranks = launch.run_on_mesh((BANDED_RANKS, 1), launch.compare_with_encoder,
                               (bcases, True, True), device_type="cuda",
                               timeout=SPAWN_TIMEOUT)
    elapsed = time.perf_counter() - t0
    paths = mesh_encode_checks(f"banded_{BANDED_RANKS}x1",
                               ranks, [name for name, _ in BANDED_CASES])
    for i, (name, kw) in enumerate(BANDED_CASES):
        counts = paths[f"sharded_encode_banded_{BANDED_RANKS}x1_{name}"]
        search = "motion_search_parts" if kw.get("parts") else "motion_search"
        ps = BANDED_RANKS * (BANDED_FRAMES - 1)
        check(counts["encode_levels"] == BANDED_RANKS
              and all(counts[k] == ps for k in (search, "encode_p_levels"))
              and counts["subpel_planes"] >= ps,
              f"banded {name}: launches {counts}, want H1 once a rank and H3, "
              f"{search} and H2 on each of the {ps} (rank, P frame) windows")
        p_ms = [[round(t, 2) for t in r[i]["ms"]["frames"][1:]] for r in ranks]
        print(f"main path sharded_encode_banded_{BANDED_RANKS}x1_{name} (gloo): "
              f"{BANDED_FRAMES} 4K frames, {HEIGHT // 16 // BANDED_RANKS} MB rows a band, "
              f"rank 0's AUs equal CudaGopEncoder's, launches {counts}", flush=True)
        print(f"time sharded_encode banded {name} 4K over {BANDED_RANKS} ranks: ms a P "
              f"frame by rank {p_ms} (wall: upload, the band's kernels, the "
              f"reference's all-gather and rank 0's entropy stage; the ranks share "
              f"one card) [{card}]", flush=True)
    per_path.update(paths)
    print(f"main path sharded_encode banded: {elapsed:.1f} s, spawn and references "
          f"included", flush=True)
    mesh_relay(device, card, tmp)
    per_path.update(phase_dryrun(device, card))
    per_path.update(group_multi_relay(device, card))
    return per_path


def phase_dryrun(device, card: str) -> dict[str, dict[str, int]]:
    """The dry run (``entry.py``): ``entry.dryrun_multichip(4)``, four
    processes on a 2x2 mesh that share the card (gloo), each holding its
    sharded CLAHE, histeq and odd 131x67 outputs to the single-card steps
    bit for bit and rank 0 holding the GOP-per-rank, partition and banded
    streams to the single-card encoder's byte for byte (rank 0 prints the
    JAX dry run's line); then ``entry.entry()``'s step (720p b2 CLAHE) on
    the card, held to its plain version on the CPU and to
    ``core/golden.py``.  Returns each path's launch counts."""
    t0 = time.perf_counter()
    ranks = entry.dryrun_multichip(DRYRUN_PROCESSES, device_type="cuda")
    elapsed = time.perf_counter() - t0
    for rank, res in enumerate(ranks):
        check(res["backend"] == "gloo" and not res["loaded"],
              f"dry run rank {rank}: backend {res['backend']}, loaded {res['loaded']}")
        check(all(res["checks"].values()), f"dry run rank {rank}: {res['checks']}")
    check(ranks[0]["geometry"][:2] == (2, 2), f"dry run mesh {ranks[0]['geometry']}")
    dry = sum_counts([c for res in ranks for c in res["launches"].values()])
    for rank, res in enumerate(ranks):
        band = res["launches"]["sharded CLAHE passthrough"]
        gop = res["launches"]["GOP-per-rank stream"]
        check(all(band[k] > 0 for k in ("tile_histograms", "build_luts",
                                        "clahe_interpolate_band"))
              and res["launches"]["sharded histeq gray"]["apply_lut"] > 0
              and all(gop[k] > 0 for k in ("clahe_interpolate", "encode_levels",
                                           "subpel_planes", "motion_search",
                                           "encode_p_levels"))
              and res["launches"]["GOP-per-rank parts refs=2 stream"][
                  "motion_search_parts"] > 0,
              f"dry run rank {rank}: launches {res['launches']}")
    print(f"main path dryrun_multichip({DRYRUN_PROCESSES}) (gloo, 4 processes on the "
          f"card, mesh 2x2): every rank's sharded outputs equal the single-card "
          f"steps', rank 0's streams the single-card encoder's; launches {dry}",
          flush=True)
    print(f"time dryrun_multichip({DRYRUN_PROCESSES}): {elapsed:.1f} s wall, spawn, "
          f"kernel load and single-card references included [{card}]", flush=True)

    fn, (batch,) = entry.entry()
    cuda_ops.reset_launch_counts()
    out = fn(batch)
    torch.cuda.synchronize()
    step = cuda_ops.launch_counts()
    plain_fn, (plain_batch,) = entry.entry(device="cpu")
    check(torch.equal(batch.cpu(), plain_batch), "entry(): the batches differ")
    check(torch.equal(out.cpu(), plain_fn(plain_batch)),
          "entry(): the card's step differs from its plain version on the CPU")
    for i, f in enumerate(plain_batch.numpy()):
        check(np.array_equal(out[i, :720].cpu().numpy(), golden.clahe(f[:720], CLIP, GRID)),
              f"entry(): frame {i} differs from core.golden.clahe")
    check(all(step[k] == 1 for k in ("tile_histograms", "build_luts", "clahe_interpolate")),
          f"entry(): launches {step}")
    print(f"main path entry() 720p b2 CLAHE: equal to its plain version on the CPU "
          f"and to core.golden.clahe; launches {step}", flush=True)
    return {"dryrun_2x2": dry, "entry_720p": step}


def group_multi_relay_rank(mesh, device, argv: list[str]):
    """A rank of relay (o): ``launch.run_multi_relay`` with the launch
    counts at 0 and the app's output captured; returns (return code,
    output, launch counts)."""
    captured = io.StringIO()
    cuda_ops.reset_launch_counts()
    with contextlib.redirect_stdout(captured):
        rc = launch.run_multi_relay(mesh, device, argv)
    return rc, captured.getvalue(), cuda_ops.launch_counts()


def stride_two_catchers(n: int, rows: int, width: int, keep: int):
    """``(base, catchers)``: a started ``RawFrameCatcher`` a stream on
    127.0.0.1 at ``base + 2*i``, each keeping ``keep`` frames."""
    for _ in range(20):
        base, catchers = free_udp_port(), []
        try:
            for i in range(n):
                catchers.append(RawFrameCatcher(rows, width, keep, port=base + 2 * i))
        except OSError:          # a port of the stride was taken
            for c in catchers:
                c.rx.close()
            continue
        for c in catchers:
            c.start()
        return base, catchers
    check(False, "no free UDP ports at a stride of two")


def group_multi_relay(device, card: str) -> dict[str, dict[str, int]]:
    """Relay (o): ``multi_relay --mesh=2x1`` on a group of two processes
    that share the card (``launch.run_multi_relay``, gloo), 2 streams of
    1080p CLAHE passthrough from ``TestSource`` to ``rtp+raw://`` (stream i
    at port + 2i), 16 rounds.  Both ranks must return 0, each must launch
    the sharded CLAHE kernels, a receiver a stream must get every frame,
    equal to the single-card ``Enhancer``'s output of the ``TestSource``
    frames, and the Shutdown line must read emitted == submitted for each
    stream.  Returns the path's launch counts."""
    w, h, n, rounds = 1920, 1080, GROUP_RELAY_STREAMS, GROUP_RELAY_ROUNDS
    base, catchers = stride_two_catchers(n, h * 3 // 2, w, rounds)
    argv = [f"--streams={n}", f"--width={w}", f"--height={h}", "--op=clahe",
            "--chroma=passthrough", f"--batch={BATCH}", f"--max-frames={rounds}",
            "--fps=1000", f"--sink=rtp+raw://127.0.0.1:{base}", "--mesh=2x1",
            "--status-interval=60"]
    try:
        t0 = time.perf_counter()
        ranks = launch.run_on_mesh((2, 1), group_multi_relay_rank, (argv,),
                                   device_type="cuda", timeout=SPAWN_TIMEOUT)
        elapsed = time.perf_counter() - t0
        for c in catchers:
            c.join(timeout=30)   # each stops once it holds every frame
    finally:
        for c in catchers:
            c.finish()
    for line in ranks[0][1].splitlines():
        if line.strip():
            print(f"relay_o | {line}", flush=True)
    check([r[0] for r in ranks] == [0, 0], f"relay (o): return codes {[r[0] for r in ranks]}")
    check(ranks[1][1] == "", f"relay (o): rank 1 printed {ranks[1][1]!r}")
    for rank, (_, _, counts) in enumerate(ranks):
        check(all(counts[k] > 0 for k in ("tile_histograms", "build_luts",
                                          "clahe_interpolate_band")),
              f"relay (o) rank {rank} launched no K1, K2 or K5: {counts}")
    text = ranks[0][1]
    m = re.search(r"Shutdown: (\d+) frames across (\d+) streams in [\d.]+s "
                  r"\(([\d.]+) fps aggregate\)", text)
    check(m is not None, "relay (o): no Shutdown line")
    per_stream = re.findall(r"#\d+=(\d+)/(\d+)", text)
    check(int(m.group(1)) == n * rounds and per_stream == [(str(rounds),) * 2] * n,
          f"relay (o): {m.group(0)}; per stream {per_stream}")
    spec, cfg = clahe_config(h, w)
    src = np.stack(list(TestSource(FrameSpec(width=w, height=h), num_frames=rounds)))
    enhancer = Enhancer(cfg, spec, device)
    want = np.concatenate([np.asarray(enhancer.process_batch(src[k:k + BATCH]))
                           for k in range(0, rounds, BATCH)])
    for i, c in enumerate(catchers):
        check(len(c.kept) == rounds and all(np.array_equal(f, want[k])
                                            for k, f in enumerate(c.kept)),
              f"relay (o): stream {i} received {len(c.kept)} of {rounds} frames, or "
              f"a frame differs from the single-card Enhancer's")
    print(f"relay (o) multi_relay --mesh=2x1, {n} streams of {w}x{h} CLAHE to rtp+raw: "
          f"every frame of every stream received, equal to the single-card "
          f"Enhancer's; {m.group(0)}", flush=True)
    print(f"time relay (o) multi_relay --mesh=2x1 {n}x1080p: the app's own Shutdown "
          f"rate {float(m.group(3)):.1f} fps aggregate (TestSource on the host, two "
          f"processes sharing the card, the bands' gather through the host, the raw "
          f"RTP sink); {elapsed:.1f} s wall with spawn and kernel load [{card}]",
          flush=True)
    return {"relay_o_multi_relay_2x1": sum_counts([r[2] for r in ranks])}


def mesh_relay(device, card: str, tmp: str) -> None:
    """Relay (n): ``--mesh=2x1 --fused-encode`` (``MESH_RELAY_SPEC``) at 4K
    CLAHE passthrough on a 2x1 group of two processes that share the card,
    ``TestSource`` frames, one batch a GOP a rank; the port's
    ``rtp_receiver`` child records the stream, which must equal a
    single-card ``CudaGopEncoder``'s on the ``TestSource`` frames that the
    single-card ``Enhancer`` enhanced."""
    w, h = WIDTH, HEIGHT
    port = free_udp_port()
    out = os.path.join(tmp, "relay_n.h264")
    argv = ["--source=test", f"--width={w}", f"--height={h}",
            f"--batch={2 * MESH_RELAY_GOP}", f"--max-frames={MESH_RELAY_FRAMES}",
            "--op=clahe", "--chroma=passthrough", f"--fps={ENCODED_FPS:g}",
            f"--sink=rtp+h264://127.0.0.1:{port}", f"--encoder={MESH_RELAY_SPEC}",
            "--fused-encode", "--mesh=2x1", "--status-interval=60"]
    with child(RECEIVER_CHILD, [str(ENCODED_BUFFER), f"--port={port}",
                                "--host=127.0.0.1", "--kind=h264",
                                f"--max-frames={MESH_RELAY_FRAMES}",
                                "--timeout=180", f"--output={out}"]) as proc:
        lines = []
        while not any(line.startswith("Listening for h264 RTP") for line in lines):
            line = proc.stdout.readline()
            check(bool(line), f"relay (n): rtp_receiver ended before it listened: {lines}")
            lines.append(line.rstrip())
        t0 = time.perf_counter()
        rcs = launch.run_on_mesh((2, 1), launch.run_relay, (argv,), device_type="cuda",
                                 timeout=SPAWN_TIMEOUT)
        elapsed = time.perf_counter() - t0
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.terminate()
        rest, _ = proc.communicate(timeout=30)
        lines += rest.splitlines()
    for line in lines:
        print(f"relay_n | rtp_receiver | {line}", flush=True)
    check(rcs == [0, 0], f"relay (n): return codes {rcs}")
    spec, cfg = clahe_config(h, w)
    src = np.stack(list(TestSource(FrameSpec(width=w, height=h),
                                   num_frames=MESH_RELAY_FRAMES)))
    enhancer = Enhancer(cfg, spec, device)
    enc = CudaGopEncoder(w, h, qp=30, gop=MESH_RELAY_GOP, search=P_SEARCH, fastsub=True,
                         deblock=True, device=device)
    want = []
    for k in range(0, MESH_RELAY_FRAMES, BATCH):
        for f in np.asarray(enhancer.process_batch(src[k:k + BATCH])):
            want += enc.encode(f)
    want += enc.flush()
    with open(out, "rb") as f:
        recorded = f.read()
    check(recorded == b"".join(want),
          f"relay (n): the recorded stream ({len(recorded)} bytes) is not the "
          f"single-card encoder's ({sum(len(a) for a in want)} bytes, {len(want)} AUs)")
    print(f"relay (n) --mesh=2x1 --fused-encode --encoder={MESH_RELAY_SPEC}: "
          f"{MESH_RELAY_FRAMES} 4K frames, the rtp_receiver's recording equals the "
          f"single-card CudaGopEncoder's {len(want)} AUs", flush=True)
    print(f"time relay (n) 4K --mesh=2x1 --fused-encode: {elapsed:.1f} s for "
          f"{MESH_RELAY_FRAMES} frames, spawn, kernel load and TestSource on the host "
          f"included [{card}]", flush=True)


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

    def __init__(self, rows: int, width: int, keep: int = 3, port: int = 0):
        super().__init__(daemon=True, name="rtp-raw-catcher")
        # a stream frame the relay's queue dropped never reaches the wire, so
        # the kept frames are matched to the expected ones in order, not by
        # position
        self.rx = RtpUdpReceiver(host="127.0.0.1", port=port, kind="raw",
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


def source_fingerprints(w: int, h: int, n: int) -> dict[bytes, int]:
    """The first ``n`` ``TestSource`` frames' SHA-1 digests, to their index."""
    src = TestSource(FrameSpec(width=w, height=h), num_frames=n)
    return {hashlib.sha1(np.ascontiguousarray(f)).digest(): k for k, f in enumerate(src)}


# the Python CAVLC oracle on the expected frames in a child process: the
# frames in, the access units and the seconds of each frame out
ORACLE_CHILD = r"""
import sys, time
import numpy as np
from opencv_opencl_tpu_torch.io.h264_cavlc import CavlcH264Encoder

frames = np.load(sys.argv[1])
h, w = frames.shape[1] * 2 // 3, frames.shape[2]
enc = CavlcH264Encoder(w, h, qp=30, bitrate_kbps=int(sys.argv[4]),
                       fps=float(sys.argv[3]), native="never")
aus, secs = [], []
for frame in frames:
    t0 = time.perf_counter()
    aus += enc.encode(frame)
    secs.append(time.perf_counter() - t0)
np.savez(sys.argv[2], blob=np.frombuffer(b"".join(aus), np.uint8),
         lens=np.array([len(a) for a in aus]), secs=np.array(secs))
"""

# the port's rtp_receiver app with its socket's buffer raised past the
# host's rmem_max where the process may (CAP_NET_ADMIN)
RECEIVER_CHILD = r"""
import contextlib, socket, sys
from opencv_opencl_tpu_torch.apps import rtp_receiver
from opencv_opencl_tpu_torch.io import rtp_h26x

class Receiver(rtp_h26x.H26xRtpReceiver):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        with contextlib.suppress(OSError):
            self.sock.setsockopt(socket.SOL_SOCKET,
                                 getattr(socket, "SO_RCVBUFFORCE", 33),
                                 int(sys.argv[1]))
        print("receive buffer", self.sock.getsockopt(socket.SOL_SOCKET,
                                                     socket.SO_RCVBUF), flush=True)

rtp_h26x.H26xRtpReceiver = Receiver
sys.exit(rtp_receiver.run(sys.argv[2:]))
"""


@contextlib.contextmanager
def child(code: str, args: list[str]):
    """A Python child process running ``code`` from the repository root,
    its output on a pipe; killed on the way out if it is still running."""
    proc = subprocess.Popen([sys.executable, "-u", "-c", code, *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def oracle_result(proc, path: str) -> tuple[list[bytes], list[float]]:
    """The Python oracle child's access units and seconds a frame."""
    try:
        out, _ = proc.communicate(timeout=ORACLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"the Python CAVLC oracle took more than {ORACLE_TIMEOUT} s")
    check(proc.returncode == 0, f"the Python CAVLC oracle failed: {out[-2000:]}")
    data = np.load(path)
    blob, aus, pos = data["blob"].tobytes(), [], 0
    for n in data["lens"]:
        aus.append(blob[pos:pos + int(n)])
        pos += int(n)
    return aus, [float(t) for t in data["secs"]]


class AccessUnitCatcher(threading.Thread):
    """The port's ``H26xRtpReceiver`` on 127.0.0.1 in a thread, its socket's
    buffer raised past the host's rmem_max where the process may: keeps every
    access unit that arrives whole (the depacketizer drops an AU with a lost
    packet whole, never torn)."""

    def __init__(self):
        super().__init__(daemon=True, name="rtp-h264-catcher")
        self.rx = rtp_h26x.H26xRtpReceiver(host="127.0.0.1", port=0, codec="h264",
                                           timeout=0.5, rtcp=False,
                                           buffer_size=ENCODED_BUFFER)
        with contextlib.suppress(OSError):
            self.rx.sock.setsockopt(socket.SOL_SOCKET,
                                    getattr(socket, "SO_RCVBUFFORCE", 33),
                                    ENCODED_BUFFER)
        self.buffer = self.rx.sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
        self.port = self.rx.port
        self.aus: list[bytes] = []
        self._done = threading.Event()

    def run(self) -> None:
        while True:
            try:
                self.aus.append(self.rx.recv_access_unit())
            except OSError:      # the socket's timeout: nothing on the wire
                if self._done.is_set():
                    return

    def finish(self) -> None:
        """Stop once the socket has been quiet for its timeout: what the
        sender sent before is still read (a thread that shares the
        interpreter lock with the relay lags it by some access units)."""
        self._done.set()
        self.join(timeout=120)
        check(not self.is_alive(), "the H.264 RTP receiver thread did not stop")
        self.rx.close()


def kept_in_order(kept: list[bytes], sent: list[bytes]) -> bool:
    """Whether ``kept`` is ``sent`` with some access units left out."""
    it = iter(sent)
    return all(any(au == s for s in it) for au in kept)


def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def encoded_relay(w: int, h: int, want: np.ndarray, spec: str, label: str,
                  tmp: str, sources: dict | None = None) -> tuple[float, dict]:
    """Configurations (g) to (k) and (p): CLAHE passthrough to
    ``rtp+h264://127.0.0.1:<port>`` with ``--encoder=<spec>``, at 4K batch 4,
    each frame enhanced by K1, K2 and K3 on the card, then encoded on the
    host ((g) ``cavlc``, (h) ``pcm``), by H1 on the card and entropy-coded
    on the host ((i) ``tpu``), or by the GOP encoder ((j) ``tpu:gop=30:...``:
    H1 on the IDR, H3, H4, H2 and H5 on each P frame, entropy coding on the
    host), or by the GOP encoder with the partition modes and the bit packer
    ((k) ``tpu:gop=30:...:parts:deblock:bitpack``: H1 and H7 on the IDR,
    H3, H6, H2, H5 and H8 on each P frame, the host assembling the packed
    bits), or by H1 with ``i4`` and H7 on the card ((p)
    ``tpu:i4:chromah:bitpack``).  (g) and (i)-(k), (p) are received by the port's ``rtp_receiver`` app
    in a child process, which must record every access unit; (h) by an
    ``H26xRtpReceiver`` thread, which counts what it loses.  The sink's
    encoder is watched: each frame it takes must be one of the expected
    frames, in order, and the access units it sends must equal those a new
    encoder of the same spec makes from those expected frames ((i): a new
    ``CavlcH264Encoder(slices=mb_h)`` on the native rows, the host oracle of
    the device encoder; (j), (k): a new ``CudaGopEncoder`` of the same spec;
    (p): a new ``tpu:i4:chromah`` encoder, without the packer;
    rate control is the same).

    With ``sources`` (the ``TestSource`` frames' fingerprints, by index)
    the relay runs ``--fused-encode``: (l) relay (j)'s spec, (m)
    ``tpu:bitpack``.  The frames then never come down: the fused step
    (models/fused_encode.py) is watched, each frame it takes must be one of
    the source frames, in order, after the warm-up batch, and the sink's
    ``write_packed`` is watched for the in-band qp of each frame; each access
    unit must equal a new encoder's of the same spec on the expected frame,
    at that qp (the step reads the qp at dispatch, before the rate control
    of the frames still in flight)."""
    fused = sources is not None
    fingerprints = ({hashlib.sha1(want[k]).digest(): k for k in range(ENCODED_FRAMES)}
                    if not fused else sources)
    made, inputs, sent, encode_s, qps, steps = [], [], [], [], [], []
    build = encoder_io.encoded_rtp_sink_from_url
    step_makers = {name: getattr(fused_encode, name)
                for name in ("build_enhance_levels_fn", "build_enhance_gop_fn")}

    def watched_step(name):
        def build_step(*args, **kwargs):
            fn = step_makers[name](*args, **kwargs)

            def step(batch, qp, *rest):
                keys = [fingerprints.get(hashlib.sha1(np.ascontiguousarray(f)).digest(),
                                         -1) for f in np.asarray(batch)]
                # (the frame index of the first frame, the source frames)
                steps.append((rest[0] if rest else None, keys))
                return fn(batch, qp, *rest)

            return step

        return build_step

    def watched(*args, **kwargs):
        sink = build(*args, **kwargs)
        made.append((sink, kwargs))
        sink.au_tap = sent.append
        if fused:
            write_packed = sink.write_packed
            from_packed = sink.encoder.encode_from_packed

            def recorded_write_packed(packed):
                qps.append(int(packed[0, 0, 408]))
                return write_packed(packed)

            def timed_from_packed(packed):
                t0 = time.perf_counter()
                try:
                    return from_packed(packed)
                finally:
                    encode_s.append(time.perf_counter() - t0)

            sink.write_packed = recorded_write_packed
            sink.encoder.encode_from_packed = timed_from_packed
            return sink
        write, encode = sink.write, sink.encoder.encode

        def timed_encode(nv12):
            t0 = time.perf_counter()
            try:
                return encode(nv12)
            finally:
                encode_s.append(time.perf_counter() - t0)

        def recorded_write(nv12):
            key = hashlib.sha1(np.ascontiguousarray(nv12)).digest()
            inputs.append(fingerprints.get(key, -1))
            write(nv12)

        sink.encoder.encode = timed_encode
        sink.write = recorded_write
        return sink

    by_app = spec.startswith(("cavlc", "tpu"))
    device_encoder = spec.startswith("tpu")
    gop_encoder = spec.startswith("tpu:gop=")
    out = os.path.join(tmp, f"{label}.h264")
    port = free_udp_port() if by_app else None
    catcher = None if by_app else AccessUnitCatcher()
    receiver = (child(RECEIVER_CHILD, [str(ENCODED_BUFFER), f"--port={port}",
                                       "--host=127.0.0.1", "--kind=h264",
                                       f"--max-frames={ENCODED_FRAMES}",
                                       "--timeout=20", f"--output={out}"])
                if by_app else contextlib.nullcontext())
    interval = sys.getswitchinterval()
    with receiver as proc:
        lines = []
        if by_app:
            while not any(line.startswith("Listening for h264 RTP") for line in lines):
                line = proc.stdout.readline()
                check(bool(line), f"{label}: rtp_receiver ended before it listened: "
                      f"{lines}")
                lines.append(line.rstrip())
        else:
            port = catcher.port
            sys.setswitchinterval(2e-4)
            catcher.start()
        encoder_io.encoded_rtp_sink_from_url = watched
        for name in step_makers:
            setattr(fused_encode, name, watched_step(name))
        try:
            text = run_app(relay, [
                "--source=test", f"--width={w}", f"--height={h}", f"--batch={BATCH}",
                f"--max-frames={ENCODED_FRAMES}", "--op=clahe",
                "--chroma=passthrough", f"--fps={ENCODED_FPS:g}",
                f"--bitrate={ENCODED_KBPS}", f"--sink=rtp+h264://127.0.0.1:{port}",
                f"--encoder={spec}", "--status-interval=60"]
                + (["--fused-encode"] if fused else []), label)
            counts = cuda_ops.launch_counts()
        finally:
            encoder_io.encoded_rtp_sink_from_url = build
            for name, fn in step_makers.items():
                setattr(fused_encode, name, fn)
            sys.setswitchinterval(interval)
            if by_app:
                # every AU arrived: the app stops at --max-frames; else stop it
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                rest, _ = proc.communicate(timeout=30)
                lines += rest.splitlines()
            else:
                catcher.finish()
    for line in lines:
        print(f"{label} | rtp_receiver | {line}", flush=True)
    fps, emitted = relay_shutdown(text, label, ENCODED_FRAMES, must_emit_all=False)
    check(len(made) == 1, f"{label}: {len(made)} encoded sinks made")
    sink, kwargs = made[0]
    enc = sink.encoder
    check(f"Encoder: {type(enc).__name__} (h264)" in text, f"{label}: no Encoder line")
    if by_app:
        check(native.available() and native.has_cavlc(),
              f"{label}: the native CAVLC rows did not build: {native.build_error()}")
        intra4 = ":i4" in spec
        check(getattr(enc, "_intra", enc)._native and enc.i4 == intra4
              and enc.chromah == intra4,
              f"{label}: the sink's encoder is not on the native CAVLC rows, or not "
              f"with the spec's i4 and chromah")
    if fused:
        # the warm-up batch of zero frames first, then the source frames
        check(len(steps) > 1 and all(k == -1 for k in steps[0][1]),
              f"{label}: the fused step's first batch is not the warm-up's")
        # (the intra step's short batches are padded with repeats of their
        # last frame)
        inputs = [k for _, keys in steps[1:] for j, k in enumerate(keys)
                  if j == 0 or k != keys[j - 1]]
        check("Fused enhance+encode: frames stay in HBM as pixels; the host "
              "receives quantized levels only" in text, f"{label}: no fused line")
        if gop_encoder:
            # the frame index of every frame the GOP step ran: the warm-up
            # batch from 0, the stream from 0 again after the reset, each
            # batch where the one before it ended
            starts = [0, 0]
            for _, keys in steps[1:-1]:
                starts.append(starts[-1] + len(keys))
            check([i0 for i0, _ in steps] == starts,
                  f"{label}: the GOP step's batches start at "
                  f"{[i0 for i0, _ in steps]}, not {starts}")
            frame_idx = [i0 + i for i0, keys in steps for i in range(len(keys))]
    else:
        frame_idx = list(range(len(encode_s)))
    if gop_encoder:
        idrs = sum(i % enc.gop == 0 for i in frame_idx)
        ps = len(frame_idx) - idrs
        check(isinstance(enc, CudaGopEncoder) and enc.device.type == "cuda",
              f"{label}: the sink's encoder {type(enc).__name__} is not on the card")
        # (k): the partition search in place of the search, the bit packers
        search = "motion_search_parts" if enc.parts else "motion_search"
        other = "motion_search" if enc.parts else "motion_search_parts"
        packs = ((idrs, ps) if enc._bitpack else (0, 0))
        check(counts["encode_levels"] == idrs and ps > 0
              and all(counts[k] == ps for k in
                      ("encode_p_levels", search, "subpel_planes"))
              and counts[other] == 0
              and (counts["pack_i_mbs"], counts["pack_p_mbs"]) == packs
              and counts["deblock_planes"] == len(frame_idx),
              f"{label}: {len(frame_idx)} frames through the kernels ({idrs} IDR), "
              f"launches {counts}")
        print(f"{label}: launches H1 {counts['encode_levels']}, H3 "
              f"{counts['subpel_planes']}, H4 {counts['motion_search']}, H6 "
              f"{counts['motion_search_parts']}, H2 {counts['encode_p_levels']}, H5 "
              f"{counts['deblock_planes']}, H7 {counts['pack_i_mbs']}, H8 "
              f"{counts['pack_p_mbs']} for {len(frame_idx)} frames ({idrs} IDR); "
              f"frames over the bit packer's cap (coded on the host entropy path) "
              f"{getattr(enc, '_bits_overflows', 0)}", flush=True)
    elif device_encoder:
        check(isinstance(enc, CudaCavlcEncoder) and enc.device.type == "cuda",
              f"{label}: the sink's encoder {type(enc).__name__} is not on the card")
        # fused: H1 (and H7) once a batch, warm-up included; i4: H1 with i4
        launched = len(steps) if fused else len(encode_s)
        h1, other = (("encode_levels_i4", "encode_levels") if enc.i4
                     else ("encode_levels", "encode_levels_i4"))
        check(counts[h1] == launched > 0 and counts[other] == 0
              and counts["pack_i_mbs"] == (launched if enc._bitpack else 0),
              f"{label}: H1 launched {counts[h1]} times ({other} {counts[other]}), H7 "
              f"{counts['pack_i_mbs']}, for {launched} {'batches' if fused else 'frames'}")
        print(f"{label}: launches H1{' with i4' if enc.i4 else ''} {counts[h1]}, H7 "
              f"{counts['pack_i_mbs']} for {len(encode_s)} frames in {launched} "
              f"{'batches' if fused else 'frames'}; frames over the bit packer's cap "
              f"{enc._bits_overflows}", flush=True)
    check(all(per > 0 for per in (counts["tile_histograms"], counts["build_luts"],
                                  counts["clahe_interpolate"])),
          f"{label} launched no K1, K2 or K3: {counts}")
    check(len(inputs) == emitted and all(k >= 0 for k in inputs)
          and inputs == sorted(set(inputs)),
          f"{label}: the encoder took frames {inputs} of the expected ones "
          f"({emitted} emitted)")
    if fused:
        # each frame at the qp the step quantized it with
        check(len(qps) == len(inputs), f"{label}: {len(qps)} packed frames written "
              f"for {len(inputs)} frames through the step")
        ref = encoder_io.make_encoder(kwargs["backend"], w, h, fps=kwargs["fps"],
                                      device="cuda")
        expected = []
        for k, qp in zip(inputs, qps):
            ref.qp = qp
            expected += ref.encode(want[k])
    elif gop_encoder:
        ref = encoder_io.make_encoder(kwargs["backend"], w, h, fps=kwargs["fps"],
                                      bitrate_kbps=kwargs["bitrate_kbps"],
                                      device="cuda")
    elif device_encoder and enc.i4:
        # the device encoder without the packer: H1 with i4 on the card,
        # entropy coding on the native rows (its host oracle is the Python
        # encoder, minutes a 4K frame: phase 3 holds it)
        ref = encoder_io.make_encoder(kwargs["backend"].replace(":bitpack", ""), w, h,
                                      fps=kwargs["fps"],
                                      bitrate_kbps=kwargs["bitrate_kbps"], device="cuda")
    elif device_encoder:
        ref = CavlcH264Encoder(w, h, qp=30, bitrate_kbps=kwargs["bitrate_kbps"],
                               fps=kwargs["fps"], slices=-(-h // 16),
                               threads=os.cpu_count() or 1, native="require")
    else:
        ref = encoder_io.make_encoder(kwargs["backend"], w, h, fps=kwargs["fps"],
                                      bitrate_kbps=kwargs["bitrate_kbps"])
    if not fused:
        expected = [au for k in inputs for au in ref.encode(want[k])]
    expected += ref.flush()
    check(sent == expected, f"{label}: the sink sent access units other than "
          f"those a new encoder makes from the expected frames")
    if by_app:
        recorded = open(out, "rb").read()
        kept = rtp_h26x.split_access_units(recorded, "h264")
        check(recorded == b"".join(sent), f"{label}: rtp_receiver recorded "
              f"{len(kept)} access units, {len(recorded)} bytes, not the "
              f"{len(sent)} sent ({sum(map(len, sent))} bytes)")
        buffer = next((line for line in lines if line.startswith("receive buffer")),
                      "receive buffer unknown")
    else:
        kept = catcher.aus
        check(kept_in_order(kept, sent), f"{label}: an access unit the receiver "
              f"kept is not the next one sent")
        buffer = f"receive buffer {catcher.buffer}"
    info = {"emitted": emitted, "kept": len(kept), "lost": len(sent) - len(kept),
            "encode_ms": 1e3 * statistics.median(encode_s), "counts": counts,
            "inputs": inputs, "sent": sent, "au_bytes": statistics.median(map(len, sent)),
            "qps": qps}
    print(f"{label}: {type(enc).__name__} encoded {len(encode_s)} frames, "
          f"{info['encode_ms']:.1f} ms a 4K frame (median, host), AUs of "
          f"{info['au_bytes']:.0f} bytes (median); {len(sent)} AUs sent, "
          f"{len(kept)} kept and {info['lost']} lost on loopback ({buffer}); every "
          f"one equal to the encoder's on the expected frames", flush=True)
    return fps, info


@contextlib.contextmanager
def relay_oracle(device, h=HEIGHT, w=WIDTH):
    """The relays' expected frames and their folder, and the Python CAVLC
    oracle's child process on the first ``ORACLE_FRAMES`` of them with the
    file it writes: the oracle takes minutes at 4K on one host core, so it
    starts before phase 3 and is read after relay (g)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_relay_") as tmp:
        want = expected_relay_frames(device, w, h)
        oracle_in = os.path.join(tmp, "oracle_in.npy")
        oracle_out = os.path.join(tmp, "oracle_out.npz")
        np.save(oracle_in, want[:ORACLE_FRAMES])
        with child(ORACLE_CHILD, [oracle_in, oracle_out, f"{ENCODED_FPS:g}",
                                  str(ENCODED_KBPS)]) as oracle:
            yield want, oracle, oracle_out, tmp


def phase_relay_paths(device, card: str, want, oracle, oracle_out, tmp, h=HEIGHT,
                      w=WIDTH):
    """This slice's path: the relay apps as a user starts them, at 4K batch
    4 on ``TestSource`` frames (``want``, ``oracle``, ``oracle_out`` and
    ``tmp`` from :func:`relay_oracle`).  Returns each configuration's
    launch counts and the apps' own rates."""
    check(not dist.is_initialized(), "the relay's --mesh=1x1 starts its own group")
    return relay_paths(device, card, want, oracle, oracle_out, tmp, h, w)


def relay_paths(device, card, want, oracle, oracle_out, tmp, h, w):
    """Relays (a) to (m) and (p), and the two multi-stream runs; ``want`` holds the
    frames the CLAHE configurations must give, ``oracle`` is the Python
    CAVLC oracle's child process, which writes ``oracle_out``."""
    base = ["--source=test", f"--width={w}", f"--height={h}", f"--batch={BATCH}",
            f"--max-frames={RELAY_FRAMES}", "--status-interval=60"]
    per_path, rates = {}, {}
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

    # (g) to (k) and (p): the encoded RTP sinks, CAVLC on the native C++
    # rows and lossless I_PCM, encoded on the host after K1, K2 and K3 on
    # the card, the device intra encoder (H1 on the card, entropy coding on
    # the native rows), the device GOP encoder (H1 on the IDR; H3, H4, H2
    # and H5 on the P frames), the GOP encoder with the partition modes
    # and the bit packer (H1 and H7 on the IDR; H3, H6, H2, H5 and H8 on the
    # P frames; the host assembles the packed bits), and the intra encoder
    # with Intra_4x4, chroma HORIZONTAL and the bit packer (H1 with i4 and
    # H7 a frame)
    encoded = {}
    for name, spec in (("relay_g_clahe_rtp_h264_cavlc", "cavlc"),
                       ("relay_h_clahe_rtp_h264_pcm", "pcm"),
                       ("relay_i_clahe_rtp_h264_tpu", "tpu"),
                       ("relay_j_clahe_rtp_h264_tpu_gop", GOP_SPEC),
                       ("relay_k_clahe_rtp_h264_tpu_gop_parts_bitpack", PARTS_SPEC),
                       ("relay_p_clahe_rtp_h264_tpu_i4_chromah_bitpack",
                        "tpu:i4:chromah:bitpack")):
        rates[name], encoded[name] = encoded_relay(w, h, want, spec, name, tmp)
        per_path[name] = encoded[name]["counts"]
        print(f"time {name} 4K b{BATCH}: Shutdown {rates[name]:.1f} fps, "
              f"{encoded[name]['emitted']} of {ENCODED_FRAMES} frames emitted, "
              f"{encoded[name]['kept']} AUs kept, {encoded[name]['lost']} lost, "
              f"host encode {encoded[name]['encode_ms']:.1f} ms a frame [{card}]",
              flush=True)
    # (l) and (m): --fused-encode, the enhancement and the device encoder's
    # kernels one step a batch on the card, the packed lanes down (l: relay
    # (j)'s GOP spec; m: the intra encoder with the bit packer)
    sources = source_fingerprints(w, h, ENCODED_FRAMES)
    for name, spec in (("relay_l_clahe_rtp_h264_tpu_gop_fused", FUSED_GOP_SPEC),
                       ("relay_m_clahe_rtp_h264_tpu_bitpack_fused", FUSED_INTRA_SPEC)):
        rates[name], encoded[name] = encoded_relay(w, h, want, spec, name, tmp,
                                                   sources=sources)
        per_path[name] = encoded[name]["counts"]
        print(f"{name}: the in-band qp of the {len(encoded[name]['qps'])} frames "
              f"{sorted(set(encoded[name]['qps']))}", flush=True)
        print(f"time {name} 4K b{BATCH}: Shutdown {rates[name]:.1f} fps, "
              f"{encoded[name]['emitted']} of {ENCODED_FRAMES} frames emitted, "
              f"{encoded[name]['kept']} AUs kept, {encoded[name]['lost']} lost, "
              f"host encode_from_packed {encoded[name]['encode_ms']:.1f} ms a frame "
              f"[{card}]",
              flush=True)
    # the native rows against the Python oracle on the first expected frames
    oracle_aus, oracle_s = oracle_result(oracle, oracle_out)
    enc = CavlcH264Encoder(w, h, qp=30, bitrate_kbps=ENCODED_KBPS, fps=ENCODED_FPS,
                           native="require")
    native_aus, native_s = [], []
    for k in range(ORACLE_FRAMES):
        t0 = time.perf_counter()
        native_aus += enc.encode(want[k])
        native_s.append(time.perf_counter() - t0)
    check(native_aus == oracle_aus, "the native CAVLC rows and the Python oracle "
          "made different access units from the same 4K frames")
    g = encoded["relay_g_clahe_rtp_h264_cavlc"]
    first = g["inputs"][:ORACLE_FRAMES] == list(range(ORACLE_FRAMES))
    check(not first or g["sent"][:ORACLE_FRAMES] == oracle_aus,
          "relay (g)'s first access units differ from the Python oracle's")
    print(f"relay (g): the {ORACLE_FRAMES} first access units "
          f"{'of the relay ' if first else 'of the expected frames '}equal the "
          f"Python oracle's (CavlcH264Encoder native='never'), "
          f"{' / '.join(str(len(a)) for a in oracle_aus)} bytes", flush=True)
    print(f"time CAVLC encode of a 4K frame, host ms: native C++ rows "
          f"{' / '.join(f'{1e3 * t:.1f}' for t in native_s)}, Python oracle "
          f"{' / '.join(f'{1e3 * t:.1f}' for t in oracle_s)} [{card}]", flush=True)
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


def profile_keys(fn, calls: int = 20) -> dict[str, float]:
    """torch.profiler's device time per call of ``fn``, in us, by key."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {evt.key: evt.device_time_total / calls for evt in prof.key_averages()}


def profile_us(fn, kernel: str, calls: int = 20) -> float:
    """torch.profiler's device time of ``kernel`` per call of ``fn``, in us."""
    return sum(us for key, us in profile_keys(fn, calls).items() if kernel in key)


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


def intra_ops(mb_h: int, mb_w: int, i4: bool = False, chromah: bool = False) -> int:
    """Integer operations H1's arithmetic needs for one frame, counted from
    the algorithm, not from the kernel's threads: a 2-D 4x4 transform is 8
    one-dimensional ones of 10 operations; a quantization 6 (abs, multiply,
    add, shift, sign, clamp), a cost term 3, a dequantization 2, a
    reconstructed pixel 3 (add, two clamps); every candidate is evaluated,
    whatever the data, so the count does not depend on it."""
    block = 80
    luma = 2 * (16 * block + 256 * 6 + 256 * 3 + 16 * 6)     # DC and HORIZONTAL
    chroma = (8 * block + 128 * 6 + 128 * 3 + 8 * 6) * (2 if chromah else 1)
    recon = 24 * block + 384 * 2 + 384 * 3
    trial = 0
    if i4:
        per_mode = 16 * 4 + block + 16 * 6 + 16 * 3        # predict, transform, quantize, cost
        trial = 16 * (9 * per_mode + block + 16 * 5)       # 16 sub-blocks, reconstruction
    return mb_h * mb_w * (luma + chroma + recon + trial)


SPLIT_GRIDS = ("levels_split_kernel", "levels_chain_kernel", "levels_intra_kernel")


def split_phases(label: str, call, half_call, cols: int, card: str, steps: int = 1) -> None:
    """The split design's phases, each its grid's device time in
    torch.profiler's keys of an ordinary ``call``, and the chain's floor:
    phase B of ``call`` over the frame's ``cols`` MB columns and of
    ``half_call`` over its left half, whose difference over the columns
    between is the time an MB of the chain takes; with ``i4`` an MB is
    ``steps`` (16) dependent Intra_4x4 steps after the I_16x16 one."""
    whole = profile_keys(call)
    ms = [sum(us for key, us in whole.items() if grid in key) / 1e3 for grid in SPLIT_GRIDS]
    b_half = profile_us(half_call, SPLIT_GRIDS[1]) / 1e3
    step = (ms[1] - b_half) / (cols - cols // 2)
    per = f" an MB, {1e3 * step / steps:.3f} us a sub-block step" if steps > 1 else " a step"
    print(f"time {label} by phase (profiler): A {ms[0]:.4f}, B {ms[1]:.4f}, C {ms[2]:.4f} "
          f"ms; the chain's floor: B {ms[1]:.4f} ms over {cols} MB columns, {b_half:.4f} "
          f"over {cols // 2}: {1e3 * step:.3f} us{per}, {cols} x step "
          f"{cols * step:.4f} ms [{card}]", flush=True)


def intra_timings(device, rng, card: str) -> dict[str, dict]:
    """H1 per 4K frame (device alone), default and ``i4:chromah`` (also by
    phase, with the chain's floor: :func:`split_phases`), ``full_recon``,
    beside the plain version and the bound; the levels' copy to pinned host
    memory; the host entropy coding on the native rows (every host thread);
    ``CudaCavlcEncoder.encode`` with and without ``overlap``; and the native
    ``cavlc`` encoder on the same frames, on one core (relay (g)'s) and on
    ``mb_h`` slices over every thread.  No single PyTorch call computes the
    function: library ms is none."""
    h, w = HEIGHT, WIDTH
    mb_h, mb_w = h // 16, w // 16
    threads = os.cpu_count() or 1
    frames = [content_nv12(rng, kind, h, w) for kind in ("structured", "random")]
    frame = torch.from_numpy(frames[0]).to(device)
    planes = intra_planes(frame, h)
    times = {}
    for flags in ({}, {"i4": True, "chromah": True}):
        out = torch.empty(levels_kernel.level_words(mb_h, mb_w, **flags),
                          dtype=torch.int16, device=device)
        ms = device_ms(lambda: levels_kernel.intra_levels(*planes, 30, out, **flags))
        moved = frame.numel() + nbytes(out)
        bound_ms, bound_by = bound(moved, intra_ops(mb_h, mb_w, **flags))
        label = "+".join(flags) or "default"
        print(f"time intra_levels_kernel 4K {label}: {ms:.4f} ms on the device "
              f"(bound {bound_ms:.4f} ms by {bound_by}: {moved} bytes, "
              f"{intra_ops(mb_h, mb_w, **flags)} operations) [{card}]", flush=True)
        if flags:
            # the chain with the Intra_4x4 trial: 16 sub-blocks an MB
            half = tuple(p[:, :p.shape[1] // 2] for p in planes)
            half_out = torch.empty(levels_kernel.level_words(mb_h, mb_w // 2, **flags),
                                   dtype=torch.int16, device=device)
            split_phases(f"intra_levels_kernel 4K {label}",
                         lambda: levels_kernel.intra_levels(*planes, 30, out, **flags),
                         lambda: levels_kernel.intra_levels(*half, 30, half_out, **flags),
                         mb_w, card, steps=16)
            plain_ms = time_ms(lambda: levels_ops.encode_levels_plain(*planes, 30, **flags),
                               reps=1, warmup=0)
            times["intra_levels_kernel:i4"] = {"ms": ms, "plain_ms": plain_ms,
                                               "library_ms": None, "bound_ms": bound_ms,
                                               "bound_by": bound_by}
            print(f"time intra_levels_kernel plain version 4K {label}: {plain_ms:.1f} ms "
                  f"[{card}]", flush=True)
        else:
            half = tuple(p[:, :p.shape[1] // 2] for p in planes)
            half_out = torch.empty(levels_kernel.level_words(mb_h, mb_w // 2),
                                   dtype=torch.int16, device=device)
            split_phases("intra_levels_kernel 4K default",
                         lambda: levels_kernel.intra_levels(*planes, 30, out),
                         lambda: levels_kernel.intra_levels(*half, 30, half_out), mb_w, card)
            full = device_ms(lambda: levels_kernel.intra_levels(*planes, 30, out,
                                                                full_recon=True))
            print(f"time intra_levels_kernel 4K full_recon (an IDR's): {full:.4f} ms on "
                  f"the device [{card}]", flush=True)
            # one call: phase 3 ran the plain version at 4K already
            plain_ms = time_ms(lambda: levels_ops.encode_levels_plain(*planes, 30),
                               reps=1, warmup=0)
            times["intra_levels_kernel"] = {"ms": ms, "plain_ms": plain_ms,
                                            "library_ms": None, "bound_ms": bound_ms,
                                            "bound_by": bound_by}
            print(f"time intra_levels_kernel plain version 4K: {plain_ms:.1f} ms "
                  f"[{card}]", flush=True)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            d2h = device_ms(lambda: host.copy_(out, non_blocking=True))
            print(f"time intra levels D2H 4K: {d2h:.4f} ms for {nbytes(out)} bytes "
                  f"into pinned memory [{card}]", flush=True)
            parts = levels_kernel.split_levels(host.numpy(), mb_h, mb_w)
            # the encoder's own way: a workspace kept between frames (its
            # scratch is ~200 MB at 4K), after one call that makes it
            workspace, entropy = {}, []
            for _ in range(6):
                t0 = time.perf_counter()
                native.cavlc_entropy_rows(parts["zdc"], parts["acz"], parts["czdc"],
                                          parts["cacz"], 30, 0, threads=threads,
                                          workspace=workspace, imode=parts["imode"])
                entropy.append(1e3 * (time.perf_counter() - t0))
            print(f"time intra entropy 4K on the native rows, {threads} threads: "
                  f"{statistics.median(entropy[1:]):.1f} ms (median of 5, the "
                  f"workspace made by a first call of {entropy[0]:.1f} ms) [{card}]",
                  flush=True)
    encode = {}
    for name, make in (
            ("tpu", lambda: CudaCavlcEncoder(w, h, qp=30)),
            ("tpu:overlap", lambda: CudaCavlcEncoder(w, h, qp=30, overlap=True)),
            ("tpu:i4:chromah", lambda: CudaCavlcEncoder(w, h, qp=30, i4=True,
                                                        chromah=True)),
            ("cavlc (one core, relay (g))", lambda: CavlcH264Encoder(w, h, qp=30)),
            (f"cavlc:slices={mb_h} ({threads} threads)",
             lambda: CavlcH264Encoder(w, h, qp=30, slices=mb_h, threads=threads))):
        enc, per = make(), []
        reps = 3 if name.startswith("cavlc") else 8
        enc.encode(frames[1])
        for k in range(reps):
            t0 = time.perf_counter()
            enc.encode(frames[k % 2])
            per.append(1e3 * (time.perf_counter() - t0))
        enc.flush()
        encode[name] = statistics.median(per)
    print("time encode a 4K frame, host ms (median): " + ", ".join(
        f"{name} {ms:.1f}" for name, ms in encode.items()) + f" [{card}]", flush=True)
    return times


def p_ops(mb_h: int, mb_w: int) -> int:
    """Integer operations H2's arithmetic needs for one P frame, counted as
    ``intra_ops`` counts H1's: the I_16x16 DC and HORIZONTAL candidates, the
    inter candidate (a residual, 16 full-block transforms, quantizations
    and cost terms), both chroma candidates, the decision, and one
    reconstruction; every candidate is evaluated whatever the data."""
    block = 80
    intra = 2 * (256 + 16 * block + 256 * 6 + 256 * 3 + 16 * 6)
    inter = 256 + 16 * block + 256 * 6 + 256 * 3
    chroma = 2 * (128 + 8 * block + 128 * 6 + 128 * 3 + 8 * 6)
    recon = 24 * block + 384 * 2 + 384 * 3
    return mb_h * mb_w * (intra + inter + chroma + 16 + recon)


def planes_ops(oh: int, ow: int, nplanes: int) -> int:
    """H3's operations: per output position a horizontal and a vertical
    6-tap (11 each), their rounding and clipping (4 each), j's 6-tap of the
    vertical sums (15), and 3 for each average of the quarter planes; one
    plane is a clamped copy, no arithmetic."""
    if nplanes == 1:
        return 0
    return oh * ow * (15 * 2 + 15 + (12 * 3 if nplanes == 16 else 0))


def deblock_ops_count(mb_h: int, mb_w: int) -> int:
    """H5's operations: every line across every edge (16 luma lines x 8
    edges, 8 chroma lines x 4 edges x 2 planes a MB) tested and filtered,
    about 30 each, and a bS of 16 segments x 2 directions, about 10 each."""
    return mb_h * mb_w * ((16 * 8 + 8 * 4 * 2) * 30 + 32 * 10)


def gop_timings(device, rng, card: str) -> dict[str, dict]:
    """Per 4K P frame (moving content, QP 30), device alone: H3 (16 planes at
    margin 9), H4 (``fastsub`` at search 8, relay (j)'s, and the exhaustive
    quarter-pel lattice at search 4; right after H3 has written the stack, as
    the encoder finds it: H3 + H4 less H3, and beside it H4 alone), H2 and H5
    (on the planes H2 has just written; beside it the wavefront's floor, the
    same launch without the edge arithmetic, and an IDR's metadata), each
    beside its plain version and its bound (H2 also by phase, with the
    chain's floor: :func:`split_phases`); the P levels' copy to pinned host memory; the
    host entropy coding of a P frame on the native rows; H3's write floor
    and its half-pel and full-pel stacks; H6 at full-pel, half-pel and
    quarter-pel and with two references; H8 on the parts frame beside its
    read-and-store floor, and on relay (j)'s P_16x16 frame and a constant
    one, each beside its floor; a whole P frame's device work back to back
    (fastsub, and parts with the bit packer); and
    ``CudaGopEncoder.encode`` of relay (j)'s spec with and without
    ``overlap``.  No single PyTorch call computes any of these functions:
    library ms is none."""
    h, w = HEIGHT, WIDTH
    mb_h, mb_w = h // 16, w // 16
    threads = os.cpu_count() or 1
    src, ref1, ref2 = p_content(device, rng, "moving", h, w)
    times = {}

    def record(name: str, ms: float, plain_ms: float, moved: int, ops: int,
               what: str) -> None:
        bound_ms, bound_by = bound(moved, ops)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                       "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"time {name} 4K P frame {what}: {ms:.4f} ms on the device, plain "
              f"version {plain_ms:.1f} ms (bound {bound_ms:.4f} ms by {bound_by}: "
              f"{moved} bytes, {ops} operations) [{card}]", flush=True)

    # H3
    P, margin = levels_ops.search_plan(P_SEARCH, 3)
    stack = torch.empty((P, h + 2 * margin, w + 2 * margin), dtype=torch.uint8,
                        device=device)
    ms = device_ms(lambda: inter_kernel.planes_into(ref1[0], margin, P, stack))
    plain = time_ms(lambda: levels_ops.subpel_planes_plain(ref1[0], margin, P), reps=3,
                    warmup=1)
    record("subpel_planes_kernel", ms, plain, nbytes(ref1[0], stack),
           planes_ops(*stack.shape[1:], P), f"(16 planes, margin {margin})")
    # its write floor (the same grid and stores, every plane from G), and
    # the half-pel and full-pel stacks
    floor = device_ms(lambda: inter_kernel.planes_floor_into(ref1[0], margin, P, stack))
    print(f"time subpel_planes_kernel 4K P frame: the write floor (16 planes, margin "
          f"{margin}) {floor:.4f} ms [{card}]", flush=True)
    for m, n in H3_MODES[1:]:
        other = torch.empty((n, h + 2 * m, w + 2 * m), dtype=torch.uint8, device=device)
        t = device_ms(lambda: inter_kernel.planes_into(ref1[0], m, n, other))
        t_floor = device_ms(lambda: inter_kernel.planes_floor_into(ref1[0], m, n, other))
        bound_ms, bound_by = bound(nbytes(ref1[0], other), planes_ops(*other.shape[1:], n))
        print(f"time subpel_planes_kernel 4K P frame ({n} plane{'s' if n > 1 else ''}, "
              f"margin {m}): {t:.4f} ms on the device, write floor {t_floor:.4f} ms (bound "
              f"{bound_ms:.4f} ms by {bound_by}) [{card}]", flush=True)

    # H4: relay (j)'s fastsub, then the exhaustive quarter-pel lattice
    mv = torch.empty((mb_h, mb_w, 2), dtype=torch.int16, device=device)
    pred = (torch.empty((h, w), dtype=torch.uint8, device=device),
            torch.empty((h // 2, w // 2), dtype=torch.uint8, device=device),
            torch.empty((h // 2, w // 2), dtype=torch.uint8, device=device))
    # H4 as the encoder finds the stack: right after H3 has written it (more
    # than the L2 holds), the pair's time less H3's; beside it H4 alone,
    # call after call on the same stack
    for search, subpel in ((P_SEARCH, 3), (P_TIMED_QPEL_SEARCH, 2)):
        P, margin = levels_ops.search_plan(search, subpel)
        stack = levels_ops.subpel_planes(ref1[0], margin, P)
        alone = device_ms(lambda: inter_kernel.search_stack_into(
            src[0], stack, [ref1], search, subpel, None, mv, None, *pred))
        planes = device_ms(lambda: inter_kernel.planes_into(ref1[0], margin, P, stack))
        pair = device_ms(lambda: (inter_kernel.planes_into(ref1[0], margin, P, stack),
                                  inter_kernel.search_stack_into(
                                      src[0], stack, [ref1], search, subpel, None, mv,
                                      None, *pred)))
        ms = pair - planes
        plain = time_ms(lambda: levels_ops.search_stack_plain(
            src[0], stack, [ref1], search, subpel), reps=1, warmup=1)
        n = len(levels_ops.search_candidates(search, subpel)) + (49 if subpel == 3 else 0)
        moved = nbytes(src[0], stack, ref1[1], ref1[2], mv, *pred)
        what = (f"(fastsub, search {search}, {n} candidates)" if subpel == 3 else
                f"(exhaustive quarter-pel, search {search}, {n} candidates)")
        print(f"time motion_search_kernel 4K P frame {what}: after H3 {ms:.4f} ms (H3 + "
              f"H4 {pair:.4f} less H3 {planes:.4f}), alone on the same stack "
              f"{alone:.4f} ms [{card}]", flush=True)
        if subpel == 3:
            record("motion_search_kernel", ms, plain, moved, 3 * n * h * w, what)
        else:
            bound_ms, bound_by = bound(moved, 3 * n * h * w)
            print(f"time motion_search_kernel 4K P frame {what}: {ms:.4f} ms on the "
                  f"device, plain version {plain:.1f} ms (bound {bound_ms:.4f} ms by "
                  f"{bound_by}) [{card}]", flush=True)

    # H2 on relay (j)'s prediction, then H5 on its recon
    out = torch.empty(levels_kernel.p_level_words(mb_h, mb_w), dtype=torch.int16,
                      device=device)
    parts = levels_kernel.split_p_levels(out, mb_h, mb_w)
    inter_kernel.search_into(src[0], [ref1], P_SEARCH, 3, None, parts["mv"], None, *pred)
    ms = device_ms(lambda: levels_kernel.p_levels_into(*src, *pred, 30, out, motion=True))
    mv_zero = (parts["mv"] == 0).all(-1)
    plain = time_ms(lambda: levels_ops.p_levels_plain(*src, *pred, mv_zero, 30), reps=1,
                    warmup=0)
    moved = nbytes(*src, *pred, out) + nbytes(*pred)
    record("p_levels_kernel", ms, plain, moved, p_ops(mb_h, mb_w), "(QP 30, fastsub)")
    # the left half: the source's views, the predictions' contiguous
    # copies, and a levels buffer holding the frame's search fields
    half = (tuple(p[:, :p.shape[1] // 2] for p in src)
            + tuple(p[:, :p.shape[1] // 2].contiguous() for p in pred))
    half_out = torch.empty(levels_kernel.p_level_words(mb_h, mb_w // 2), dtype=torch.int16,
                           device=device)
    levels_kernel.split_p_levels(half_out, mb_h, mb_w // 2)["mv"].copy_(
        parts["mv"][:, :mb_w // 2])
    split_phases("p_levels_kernel 4K P frame (QP 30, fastsub)",
                 lambda: levels_kernel.p_levels_into(*src, *pred, 30, out, motion=True),
                 lambda: levels_kernel.p_levels_into(*half, 30, half_out, motion=True),
                 mb_w, card)
    recon = levels_kernel.p_levels_into(*src, *pred, 30, out, motion=True)
    plv = levels_ops.PLevelArrays(parts["mode"], parts["zdc"], parts["acz"],
                                  parts["czdc"], parts["cacz"], *recon, parts["mv"])
    meta = deblock_meta(plv, mb_h, mb_w, device)
    work = tuple(p.clone() for p in recon)
    ms = device_ms(lambda: deblock_kernel.deblock_into(*work, 30, *meta))
    plain = time_ms(lambda: deblock_ops.deblock_planes_plain(*recon, 30, *meta), reps=1,
                    warmup=0)
    moved = 2 * nbytes(*recon) + nbytes(*meta)
    record("deblock_kernel", ms, plain, moved, deblock_ops_count(mb_h, mb_w),
           "(its own metadata)")
    # the wavefront's own floor (the same launch without the edge
    # arithmetic), and an IDR's metadata (every edge intra)
    floor = device_ms(lambda: deblock_kernel.deblock_floor_into(*work, 30, *meta))
    idr = deblock_meta(None, mb_h, mb_w, device)
    idr_ms = device_ms(lambda: deblock_kernel.deblock_into(*work, 30, *idr))
    idr_floor = device_ms(lambda: deblock_kernel.deblock_floor_into(*work, 30, *idr))
    steps = mb_w + mb_h - 1        # a row one MB behind the row above
    print(f"time deblock_kernel 4K P frame: {ms:.4f} ms, the wavefront's floor "
          f"{floor:.4f} ms ({1e3 * floor / steps:.3f} us a step of {steps}); on an IDR's "
          f"metadata {idr_ms:.4f} ms, floor {idr_floor:.4f} ms; bound "
          f"{times['deblock_kernel']['bound_ms']:.4f} ms by bytes [{card}]", flush=True)

    # the levels down, and the host entropy coding
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    d2h = device_ms(lambda: host.copy_(out, non_blocking=True))
    print(f"time P levels D2H 4K: {d2h:.4f} ms for {nbytes(out)} bytes into pinned "
          f"memory [{card}]", flush=True)
    lv = levels_kernel.split_p_levels(host.numpy(), mb_h, mb_w)
    workspace, entropy = {}, []
    for _ in range(6):
        t0 = time.perf_counter()
        native.cavlc_entropy_rows_p(lv["mode"], lv["zdc"], lv["acz"], lv["czdc"],
                                    lv["cacz"], 30, 1, threads=threads,
                                    workspace=workspace, mv=lv["mv"], deblock=True)
        entropy.append(1e3 * (time.perf_counter() - t0))
    modes = np.bincount(lv["mode"].ravel(), minlength=4).tolist()
    print(f"time P entropy 4K on the native rows, {threads} threads: "
          f"{statistics.median(entropy[1:]):.1f} ms (median of 5, the workspace made "
          f"by a first call of {entropy[0]:.1f} ms; modes skip/inter/intra DC/intra H "
          f"{modes}) [{card}]", flush=True)

    # H6 at relay (k)'s search, then the sub-pel lattices; H2 on the parts
    # layout; H8 on its levels; H7 on an IDR's
    pout = torch.empty(levels_kernel.p_level_words(mb_h, mb_w, True), dtype=torch.int16,
                       device=device)
    fields = levels_kernel.split_p_levels(pout, mb_h, mb_w, True)
    ref4 = torch.empty((mb_h, mb_w, 4), dtype=torch.int16, device=device)
    for search, subpel, nrefs in ((P_SEARCH, 0, 1), (P_SEARCH, 1, 1),
                                  (P_TIMED_QPEL_SEARCH, 2, 1), (P_SEARCH, 0, 2)):
        refs = [ref1, ref2][:nrefs]
        P, margin = levels_ops.search_plan(search, subpel)
        stack = torch.cat([levels_ops.subpel_planes(r[0], margin, P) for r in refs])
        two = ref4 if nrefs > 1 else None
        ms = device_ms(lambda: inter_kernel.parts_stack_into(
            src[0], stack, refs, search, subpel, 30, fields["pmode"], fields["mv"],
            two, *pred))
        plain = time_ms(lambda: levels_ops.parts_stack_plain(
            src[0], stack, refs, search, subpel, 30), reps=1, warmup=1)
        n = nrefs * len(levels_ops.search_candidates(search, subpel))
        moved = nbytes(src[0], stack, fields["pmode"], fields["mv"], *pred,
                       *(t for r in refs for t in r[1:]), *((ref4,) if nrefs > 1 else ()))
        what = (f"({('full', 'half', 'quarter')[subpel]}-pel, search {search}, "
                f"{nrefs} ref{'s' if nrefs > 1 else ''}, {n} candidates)")
        if (subpel, nrefs) == (0, 1):
            record("parts_search_kernel", ms, plain, moved, 3 * n * h * w, what)
        else:
            bound_ms, bound_by = bound(moved, 3 * n * h * w)
            print(f"time parts_search_kernel 4K P frame {what}: {ms:.4f} ms on the "
                  f"device, plain version {plain:.1f} ms (bound {bound_ms:.4f} ms by "
                  f"{bound_by}) [{card}]", flush=True)
    P, margin = levels_ops.search_plan(P_SEARCH, 0)
    stack = levels_ops.subpel_planes(ref1[0], margin, P)
    inter_kernel.parts_stack_into(src[0], stack, [ref1], P_SEARCH, 0, 30, fields["pmode"],
                                  fields["mv"], None, *pred)
    levels_kernel.p_levels_into(*src, *pred, 30, pout, motion=True, parts=True)
    words = torch.empty((mb_h, mb_w, 64), dtype=torch.uint32, device=device)
    nbits = torch.empty((mb_h, mb_w), dtype=torch.int32, device=device)
    lv = (fields["mode"], fields["zdc"], fields["acz"], fields["czdc"], fields["cacz"])
    pkw = dict(pmode=fields["pmode"], mv4=fields["mv"])
    ms = device_ms(lambda: bitpack_kernel.pack_p_into(*lv, None, None, 1, words, nbits,
                                                      **pkw))
    plain = time_ms(lambda: bitpack_ops.pack_p_mbs_plain(*lv, None, None, 1, 64, **pkw),
                    reps=1, warmup=1)
    moved, coded = pack_p_bytes(fields["mode"], words, nbits, fields["pmode"], fields["mv"])
    record("pack_p_kernel", ms, plain, moved, pack_ops(coded * P_MB_LEVELS),
           f"(parts, search {P_SEARCH}, {int(nbits.sum())} bits; "
           f"{bitpack_kernel.pack_plan(mb_h, mb_w, bitpack_kernel.PACK_P_RUN)['run']} "
           f"MBs a warp)")
    floor = device_ms(lambda: bitpack_kernel.pack_p_floor_into(*lv, None, None, 1, words, nbits,
                                                               **pkw))
    print(f"time pack_p_kernel 4K parts P frame read-and-store floor (the same loads and "
          f"stores, no tokens): {floor:.4f} ms on the device [{card}]", flush=True)
    # H8 on relay (j)'s P_16x16 frame (fastsub; its levels in `out`), and on
    # a P_16x16 frame of constant content
    cst, cref, _ = p_content(device, rng, "constant", h, w)
    cout = torch.empty(levels_kernel.p_level_words(mb_h, mb_w), dtype=torch.int16,
                       device=device)
    cf = levels_kernel.split_p_levels(cout, mb_h, mb_w)
    inter_kernel.search_into(cst[0], [cref], P_SEARCH, 3, None, cf["mv"], None, *pred)
    levels_kernel.p_levels_into(*cst, *pred, 30, cout, motion=True)
    for what, f in (("P_16x16, fastsub search 8", parts),
                    ("P_16x16 of constant content", cf)):
        flv = (f["mode"], f["zdc"], f["acz"], f["czdc"], f["cacz"], f["mv"], None, 1)
        t = device_ms(lambda: bitpack_kernel.pack_p_into(*flv, words, nbits))
        t_floor = device_ms(lambda: bitpack_kernel.pack_p_floor_into(*flv, words, nbits))
        bitpack_kernel.pack_p_into(*flv, words, nbits)
        moved, coded = pack_p_bytes(f["mode"], words, nbits, f["mv"])
        bound_ms, bound_by = bound(moved, pack_ops(coded * P_MB_LEVELS))
        print(f"time pack_p_kernel 4K {what} ({int(nbits.sum())} bits, "
              f"{coded} coded MBs): {t:.4f} ms on the device, "
              f"read-and-store floor {t_floor:.4f} ms (bound {bound_ms:.4f} ms by "
              f"{bound_by}) [{card}]", flush=True)
    iout = torch.empty(levels_kernel.level_words(mb_h, mb_w), dtype=torch.int16,
                       device=device)
    levels_kernel.intra_levels(*src, 30, iout)
    iv = levels_kernel.split_levels(iout, mb_h, mb_w)
    ilv = (iv["zdc"], iv["acz"], iv["czdc"], iv["cacz"], iv["imode"])
    floor = device_ms(lambda: bitpack_kernel.pack_i_floor_into(*ilv, words, nbits))
    ms = device_ms(lambda: bitpack_kernel.pack_i_into(*ilv, words, nbits))
    plain = time_ms(lambda: bitpack_ops.pack_i_mbs_plain(*ilv, 64), reps=1, warmup=1)
    record("pack_i_kernel", ms, plain, nbytes(iout, words, nbits),
           pack_ops(iout.numel()), f"(an IDR of the moving content, "
           f"{int(nbits.sum())} bits; {bitpack_kernel.pack_plan(mb_h, mb_w)['run']} MBs "
           f"a warp)")
    print(f"time pack_i_kernel 4K read-and-store floor (the same loads and stores, no "
          f"tokens): {floor:.4f} ms on the device [{card}]", flush=True)
    # H7 on an i4:chromah IDR of the same frame
    iout4 = torch.empty(levels_kernel.level_words(mb_h, mb_w, True, True),
                        dtype=torch.int16, device=device)
    levels_kernel.intra_levels(*src, 30, iout4, i4=True, chromah=True)
    iv4 = levels_kernel.split_levels(iout4, mb_h, mb_w, True, True)
    ilv4 = (iv4["zdc"], iv4["acz"], iv4["czdc"], iv4["cacz"], iv4["imode"])
    ex4 = dict(i4modes=iv4["i4modes"], cmode=iv4["cmode"])
    floor4 = device_ms(lambda: bitpack_kernel.pack_i_floor_into(*ilv4, words, nbits, **ex4))
    ms4 = device_ms(lambda: bitpack_kernel.pack_i_into(*ilv4, words, nbits, **ex4))
    bound4, by4 = bound(nbytes(iout4, words, nbits), pack_ops(iout4.numel()))
    print(f"time pack_i_kernel 4K i4:chromah IDR of the moving content "
          f"({int(nbits.sum())} bits, {int((iv4['imode'] == 0).sum())} Intra_4x4 MBs): "
          f"{ms4:.4f} ms on the device, read-and-store floor {floor4:.4f} ms (bound "
          f"{bound4:.4f} ms by {by4}) [{card}]", flush=True)
    host_words = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
    host_nbits = torch.empty(nbits.shape, dtype=nbits.dtype, pin_memory=True)
    host_mode = torch.empty(fields["mode"].shape, dtype=torch.int16, pin_memory=True)
    host_levels = torch.empty(pout.shape, dtype=pout.dtype, pin_memory=True)

    def bits_down():
        host_words.copy_(words, non_blocking=True)
        host_nbits.copy_(nbits, non_blocking=True)
        host_mode.copy_(fields["mode"], non_blocking=True)

    d2h_bits = device_ms(bits_down)
    d2h_levels = device_ms(lambda: host_levels.copy_(pout, non_blocking=True))
    print(f"time parts P frame D2H 4K: the packed words, bit counts and mode row "
          f"{nbytes(words, nbits, fields['mode'])} bytes in {d2h_bits:.4f} ms, the "
          f"levels {nbytes(pout)} bytes in {d2h_levels:.4f} ms, into pinned memory "
          f"[{card}]", flush=True)

    # a whole P frame's device work back to back, as CudaGopEncoder launches
    # it (the torch ops between the kernels included): relay (j)'s fastsub
    # (H3, H4, H2, H5) and relay (k)'s parts with the bit packer (H3, H6,
    # H2, H5, H8)
    def p_frame(partitioned: bool) -> None:
        f, o = (fields, pout) if partitioned else (parts, out)
        if partitioned:
            inter_kernel.parts_search_into(src[0], [ref1], P_SEARCH, 0, 30, f["pmode"],
                                           f["mv"], None, *pred)
        else:
            inter_kernel.search_into(src[0], [ref1], P_SEARCH, 3, None, f["mv"], None, *pred)
        rec = levels_kernel.p_levels_into(*src, *pred, 30, o, motion=True,
                                          parts=partitioned)
        mv = deblock_ops.block_grid(f["mv"]) if partitioned else f["mv"]
        deblock_kernel.deblock_into(*rec, 30, f["mode"] >= 2, deblock_ops.nnz4_grid(f["acz"]),
                                    mv, None)
        if partitioned:
            bitpack_kernel.pack_p_into(f["mode"], f["zdc"], f["acz"], f["czdc"], f["cacz"],
                                       None, None, 1, words, nbits, pmode=f["pmode"],
                                       mv4=f["mv"])

    for partitioned in (False, True):
        ms = device_ms(lambda: p_frame(partitioned))
        what = ("parts:deblock:bitpack at search 8: H3, H6, H2, H5, H8" if partitioned
                else "fastsub:deblock at search 8: H3, H4, H2, H5")
        print(f"time P frame device work 4K ({what}), back to back as the encoder "
              f"launches it: {ms:.4f} ms [{card}]", flush=True)

    # the encoder, a frame at a time, P frames after one IDR
    frames = moving_nv12(rng, h, w, 9)
    encode = {}
    parts_plain = PARTS_SPEC.replace(":bitpack", "")
    for name, spec in (("tpu:gop", GOP_SPEC), ("tpu:gop:overlap", GOP_SPEC + ":overlap"),
                       (parts_plain, parts_plain), (PARTS_SPEC, PARTS_SPEC),
                       (PARTS_SPEC + ":overlap", PARTS_SPEC + ":overlap")):
        enc = encoder_io.make_encoder(spec, w, h, fps=ENCODED_FPS, device="cuda")
        enc.encode(frames[0])
        per = []
        for f in frames[1:]:
            t0 = time.perf_counter()
            enc.encode(f)
            per.append(1e3 * (time.perf_counter() - t0))
        enc.flush()
        encode[name] = (statistics.median(per), enc._bits_overflows)
    print(f"time encode a 4K P frame, host ms (median of 8; frames over the bit "
          f"packer's cap): " + ", ".join(f"{name} {ms:.1f} ({over})" for name, (ms, over)
                                         in encode.items()) + f" [{card}]", flush=True)
    return times


# the int16 levels of one P MB: zdc, acz, czdc, cacz
P_MB_LEVELS = 16 + 256 + 8 + 128


def pack_p_bytes(mode, words, nbits, *fields) -> tuple[int, int]:
    """H8's bytes and its coded MBs: the mode row, the levels of the coded
    MBs only (a skipped MB's are never needed: its counts are zero by the
    contract), the given per-MB ``fields`` (vectors, references, partition
    modes) of the inter MBs only, and the words and counts it writes."""
    coded, inter = int((mode != 0).sum()), int((mode == 1).sum())
    per_mb = sum(f[0, 0].numel() * f.element_size() for f in fields)
    return (nbytes(mode, words, nbits) + 2 * P_MB_LEVELS * coded + per_mb * inter,
            coded)


def pack_ops(levels: int) -> int:
    """H7's and H8's operations, counted generously: about ten for each
    int16 value of the level buffer (its zero test and count, its rank, its
    token and its bits).  Far below the bytes' time: the packers' bound is
    their bytes."""
    return 10 * levels


def fused_timings(device, rng, card: str) -> None:
    """The fused enhance + encode step on a 4K batch of 4 held on the card
    (moving content, QP 30), for relay (l)'s GOP step (every frame a P
    frame) and relay (m)'s intra step with the bit packer: the step from an
    idle card and the device alone; the packed lanes' copy to pinned host
    memory; ``encode_from_packed`` on the host, per frame.  Beside them the
    unfused path on the same frames: the CLAHE step (device alone), the
    enhanced batch's copy to pinned host memory, and the unfused card
    encoder's ``encode`` per frame on the host (upload, kernels, the levels'
    copy down and the entropy coding)."""
    h, w = HEIGHT, WIDTH
    frames = np.stack(moving_nv12(rng, h, w, BATCH + 1))
    first = torch.from_numpy(frames[:1]).to(device)
    batch = torch.from_numpy(frames[1:]).to(device)
    spec, cfg = clahe_config()
    enhance = build_enhance_fn(cfg, spec, donate=False)
    enhanced = enhance(batch)
    enh_host = torch.empty(enhanced.shape, dtype=torch.uint8, pin_memory=True)
    enh_dev = device_ms(lambda: enhance(batch))
    enh_d2h = device_ms(lambda: enh_host.copy_(enhanced, non_blocking=True))
    enh_first = enhance(first).cpu().numpy()[0]
    print(f"time unfused CLAHE step 4K b{BATCH}: device alone {enh_dev:.4f} ms; the "
          f"enhanced batch's copy to pinned host memory {enh_d2h:.4f} ms "
          f"({nbytes(enhanced)} bytes) [{card}]", flush=True)
    for label, opts, spec_str in (("gop", {"gop": 30, "search": P_SEARCH, "subpel": 3,
                                           "deblock": True}, FUSED_GOP_SPEC),
                                  ("intra bitpack", {"bitpack": 64}, FUSED_INTRA_SPEC)):
        fn = fused_step("clahe", opts, h, w, device)
        enc = fused_encoder(opts, h, w, "cuda")
        if "gop" in opts:
            idr, *recon = fn(first, 30, 0, *enc.initial_recon())
            enc.encode_from_packed(idr[0].cpu().numpy())

            def call():
                return fn(batch, 30, 1, *recon)[0]
        else:
            def call():
                return fn(batch, 30)
        idle = time_ms(call, reps=10, warmup=2)
        dev = device_ms(call)
        packed = call()
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        d2h = device_ms(lambda: host.copy_(packed, non_blocking=True))
        host.copy_(packed)
        assemble = []
        for p in host.numpy():
            t0 = time.perf_counter()
            enc.encode_from_packed(p)
            assemble.append(1e3 * (time.perf_counter() - t0))
        ref = fused_encoder(opts, h, w, "cuda")
        if "gop" in opts:
            ref.encode(enh_first)
        unfused = []
        for f in enh_host.numpy():
            t0 = time.perf_counter()
            ref.encode(f)
            unfused.append(1e3 * (time.perf_counter() - t0))
        print(f"time fused step {label} ({spec_str}) 4K b{BATCH}: {idle:.4f} ms/batch "
              f"from an idle card, device alone {dev:.4f} ms/batch; the packed lanes' "
              f"copy to pinned host memory {d2h:.4f} ms ({nbytes(packed)} bytes, "
              f"{packed.shape[-1]} lanes); encode_from_packed host "
              f"{' / '.join(f'{t:.2f}' for t in assemble)} ms a frame; unfused: the "
              f"CLAHE step device alone {enh_dev:.4f} ms/batch and the card encoder's "
              f"encode host {' / '.join(f'{t:.2f}' for t in unfused)} ms a frame "
              f"[{card}]", flush=True)


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
    started = last = time.perf_counter()

    def lap(what: str) -> None:
        """The wall seconds of the phase just ended, and of the run so far:
        the script has a time limit, and a machine's host sets much of it."""
        nonlocal last
        now = time.perf_counter()
        print(f"wall {what}: {now - last:.1f} s (run {now - started:.1f} s)", flush=True)
        last = now

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
                                     "tile_hist_kernel", "levels_split_kernel", "levels_chain_kernel",
                                     "levels_intra_kernel", "subpel_planes_kernel",
                                     "subpel_floor_kernel",
                                     "motion_search_kernel", "deblock_kernel",
                                     "deblock_bs_kernel",
                                     "parts_search_kernel", "pack_i_kernel",
                                     "pack_p_kernel")):
        print(f"ptxas {line}", flush=True)
    t0 = time.perf_counter()
    check(native.available(), f"the native runtime did not build: "
          f"{native.build_error()}")
    print(f"build native runtime: {time.perf_counter() - t0:.1f} s -> "
          f"{native.loaded_path()}", flush=True)
    lap("build")

    # the relays' expected frames, and the Python CAVLC oracle on two of them
    # in a child process from here on (it is read after relay (g))
    with relay_oracle(device) as early:
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
        lap("phase 3, K1-K10")
        errs["intra_levels_kernel"], errs["intra_levels_kernel:i4"] = \
            phase_intra_levels_kernel(device, rng)
        lap("phase 3, H1")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_gop_") as tmp, \
                gop_oracles(tmp) as oracles:
            errs.update(phase_p_kernels(device, rng))
            lap("phase 3, H2-H5")
            for name, e in phase_parts_kernels(device, rng).items():
                errs[name] = max(errs.get(name, 0), e)
            check(all(e == 0 for e in errs.values()), f"kernel mismatch {errs}")
            lap("phase 3, H6-H8")
            phase_intra_streams(device, rng)
            phase_p_streams(oracles)
            lap("phase 3, the encoders' streams")
            phase_fused_encode(device, rng, oracles["fused"])
            lap("phase 3, the fused step")

        phase_golden(device, rng)                              # phase 4
        phase_golden_slice3(device, rng)
        phase_golden_sharded(device, rng)
        lap("phase 4")
        per_path = phase_main_paths(device, rng)               # phase 5
        per_path.update(phase_slice3_paths(device, rng))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_apps_") as tmp:
            per_path.update(phase_app_paths(device, rng, card, tmp))
        lap("phase 5, the paths and apps")
        # the relay apps first: their --mesh=1x1 starts and ends a group of its own
        paths_of_relays, relay_rates = phase_relay_paths(device, card, *early)
        per_path.update(paths_of_relays)
        lap("phase 5, the relays")
    # the 1x1 mesh of the sharded path lives in this process: a process
    # group of one rank on NCCL, until the script ends
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as rendezvous:
        launch.init_process_group(0, 1, os.path.join(rendezvous, "rendezvous"), "cuda")
        try:
            check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
            sharded_paths, rank_ms = phase_sharded_paths(device, rng)
            per_path.update(sharded_paths)
            lap("phase 5, the sharded paths")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
                per_path.update(phase_sharded_encode(device, rng, card, tmp))
            lap("phase 5, the sharded encoder, the dry run, relay (o)")
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
            lap("phase 6, K1-K10")
            times.update(intra_timings(device, rng, card))
            times.update(gop_timings(device, rng, card))
            lap("phase 6, H1-H8")
            fused_timings(device, rng, card)
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
            lap("phase 6, the fused step, the feeders, the profile")
        finally:
            dist.destroy_process_group()

    check(not {"jax", "cv2", "websockets"} & set(sys.modules),
          "jax, cv2 or websockets was imported")
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
