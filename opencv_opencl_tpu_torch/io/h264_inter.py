"""P-slice (inter) extension of the CAVLC H.264 encoder: low-delay-P GOP.

The reference configures its VCU for exactly this stream shape —
``gop-mode=low-delay-p periodicity-idr=240``
(``OpenCVequalHist.cpp:313-315``): one IDR every N
frames, every other frame a P picture referencing the frame before it.
The all-IDR intra encoder (io.h264_cavlc) cannot exploit temporal
redundancy; this module adds the missing inter path with a
**zero-motion** design:

- every macroblock of a P slice is **P_Skip** (bitstream cost: one
  count in ``mb_skip_run``), **P_L0_16x16** with ``mvd = (0,0)`` and a
  coded residual against the co-located macroblock of the
  reconstructed previous frame, or — when temporal prediction loses —
  an **I_16x16** intra macroblock (``mb_type = 5 + intra type``; the
  per-MB fallback that keeps P frames no worse than intra frames even
  under global motion).  With every coded motion vector zero, the
  P_Skip predicted MV (spec 8.4.1.1) is provably (0,0) for every MB —
  neighbor A/B unavailable => 0; otherwise some zero-MV/ref-0 neighbor
  triggers the early-out — so skip == "copy co-located";
- the inter/intra mode decision is a pure function of the two
  candidates' quantized levels (``_cost``: sum of 2|l| + (l != 0) over
  every coded coefficient, intra biased by +8 for its dearer syntax) —
  deliberately NOT exact-bit trial encoding, so the TPU level program
  can reproduce byte-identical decisions without entropy coding in the
  loop;
- ``search=0`` (default) does no motion search: the design target is
  the static/slowly-varying regions of enhancement relays, where skip
  runs collapse the per-frame cost to almost nothing; moving regions
  degrade to coded zero-MV residuals or per-MB intra, whichever is
  cheaper.  ``search=R`` adds the exhaustive full-pel SAD search
  (:func:`motion_search`, device twin
  ops/h264_levels.motion_search_mc) with real mvd coding;
- the in-loop deblocking filter stays disabled, so decoder output ==
  encoder reconstruction EXACTLY, frame after frame — conformance
  tests decode whole GOPs through libavcodec and require bit-identical
  planes (tests/test_h264_inter.py);
- inter quantization uses the inter rounding offset (f = 2^qbits / 6;
  intra uses /3), and inter luma residuals are plain 4x4 blocks (all
  16 coefficients — no Intra_16x16 DC/AC split);
- slices are MB-row bands like the intra path, but P bands have NO
  left-to-right dependency at all (prediction reads the previous
  picture, not spatial neighbors) — every band, indeed every MB, is
  independently computable.  This is what makes the TPU formulation of
  the P path (ops/h264_levels.encode_p_levels) a pure elementwise
  program with no scan.

Python here is the tested oracle, like io.h264_cavlc.

The port's own copy of ``opencv_opencl_tpu/io/h264_inter.py``: the same
bytes.  ``CudaGopEncoder`` is its ``TpuGopEncoder`` (the device GOP
encoder on the card, with its ``parts`` and ``bitpack`` options), with the
fused-GOP helpers (``initial_recon``, ``encode_from_packed``) as methods
of the class.
"""

from __future__ import annotations

import numpy as np

from opencv_opencl_tpu_torch.io.h264_cavlc import (
    _BLOCK_SCAN,
    _CF,
    _H2,
    _LEVEL_CLAMP,
    _MF,
    _QPC,
    _ZIGZAG,
    _chroma_dc_dequant,
    _dequant4x4,
    _inv4x4,
    _mf_mat,
    _write_residual_block,
)
from opencv_opencl_tpu_torch.io.h264_pcm import (
    _START4, _BitWriter, _escape, _level_for)

__all__ = ["build_sps_gop", "build_recovery_point_sei",
           "encode_frame_p_slices",
           "encode_frame_p_from_levels", "GopCavlcEncoder",
           "search_candidates",
           "search_candidates_qpel", "halfpel_planes",
           "quarterpel_planes", "motion_search", "mc_planes",
           "SEARCH_KEY_RADIX", "CudaGopEncoder"]


def build_sps_gop(width: int, height: int, refs: int = 1,
                  hrd=None) -> bytes:
    """SPS for a low-delay-P stream: like io.h264_pcm.build_sps but with
    ``max_num_ref_frames=refs`` (P pictures reference the previous
    ``refs`` pictures; the sliding window evicts older ones
    automatically)."""
    mb_w = -(-width // 16)
    mb_h = -(-height // 16)
    crop_r = (mb_w * 16 - width) // 2
    crop_b = (mb_h * 16 - height) // 2
    w = _BitWriter()
    w.u(0, 1).u(3, 2).u(7, 5)        # nal: forbidden=0, ref_idc=3, SPS
    w.u(66, 8)                       # profile_idc: baseline
    w.u(0b11000000, 8)               # constraint_set0+1
    # level must fit the DPB too: refs reference pictures + the
    # current one (A.3.1 MaxDpbMbs bound)
    w.u(_level_for(mb_w * mb_h, dpb_frames=refs + 1), 8)  # level_idc
    w.ue(0)                          # seq_parameter_set_id
    w.ue(0)                          # log2_max_frame_num_minus4 -> u(4)
    w.ue(2)                          # pic_order_cnt_type: 2 (low-delay)
    w.ue(refs)                       # max_num_ref_frames
    w.u(0, 1)                        # gaps_in_frame_num_value_allowed
    w.ue(mb_w - 1)
    w.ue(mb_h - 1)
    w.u(1, 1)                        # frame_mbs_only_flag
    w.u(1, 1)                        # direct_8x8_inference_flag
    if crop_r or crop_b:
        w.u(1, 1)
        w.ue(0).ue(crop_r).ue(0).ue(crop_b)
    else:
        w.u(0, 1)
    if hrd is None:
        w.u(0, 1)                    # vui_parameters_present_flag
    else:
        hrd.write_vui(w)
    w.trailing()
    return _escape(w.bytes())


def build_recovery_point_sei(recovery_frame_cnt: int,
                             exact_match: bool = True) -> bytes:
    """Recovery point SEI NAL (spec D.1.8/D.2.8) — the stream marker of
    GDR refresh: a decoder that starts here has bit-exact output after
    ``recovery_frame_cnt`` more frames (``exact_match_flag=1``; the
    marching-intra wave guarantees it).  The reference requests this
    stream shape with ``gdr-mode=horizontal``
    (``OpenCVequalHist.cpp:313,325``)."""
    p = _BitWriter()
    p.ue(recovery_frame_cnt)
    p.u(1 if exact_match else 0, 1)   # exact_match_flag
    p.u(0, 1)                         # broken_link_flag
    p.u(0, 2)                         # changing_slice_group_idc
    if len(p._bits) % 8:              # sei_payload byte alignment
        p.u(1, 1)
        while len(p._bits) % 8:
            p.u(0, 1)
    payload = p.bytes()
    w = _BitWriter()
    w.u(0, 1).u(0, 2).u(6, 5)         # nal header: SEI (ref_idc 0)
    w.u(6, 8)                         # payloadType: recovery_point
    w.u(len(payload), 8)              # payloadSize
    for b in payload:
        w.u(b, 8)
    w.trailing()
    return bytes(_escape(w.bytes()))


# coded_block_pattern -> codeNum for Inter MBs (spec Table 9-4,
# ChromaArrayType=1), as the inverse of the decoder-side mapping.
_CBP_INTER_CODENUM = np.zeros(48, dtype=np.int64)
_CBP_INTER_CODENUM[[0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11,
                    13, 14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39,
                    43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27,
                    29, 30, 22, 25, 38, 41]] = np.arange(48)


def _quant4x4_inter(w: np.ndarray, qp: int) -> np.ndarray:
    """Forward quant with the inter rounding offset f = 2^qbits / 6."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 6
    z = np.sign(w) * ((np.abs(w) * _mf_mat(qp) + f) >> qbits)
    np.clip(z, -_LEVEL_CLAMP, _LEVEL_CLAMP, out=z)
    return z


def _slice_head_p(w: _BitWriter, qp: int, frame_num: int,
                  first_mb: int = 0, active_refs: int = 1,
                  deblock: bool = False,
                  slice_local: bool = False) -> None:
    """Non-IDR P slice header (deblocking off, POC type 2: no POC
    syntax, sliding-window marking).  ``active_refs`` > 1 overrides
    the PPS's single active reference (multi-ref streams: the list is
    the default descending-PicNum order [prev, prev-1, ...])."""
    w.u(0, 1).u(2, 2).u(1, 5)  # nal: ref_idc=2, non-IDR slice
    w.ue(first_mb)             # first_mb_in_slice
    w.ue(5)                    # slice_type: P (all slices of picture)
    w.ue(0)                    # pic_parameter_set_id
    w.u(frame_num & 0xF, 4)    # frame_num (log2_max_frame_num = 4)
    if active_refs > 1:
        w.u(1, 1)              # num_ref_idx_active_override_flag
        w.ue(active_refs - 1)  # num_ref_idx_l0_active_minus1
    else:
        w.u(0, 1)              # num_ref_idx_active_override_flag
    w.u(0, 1)                  # ref_pic_list_modification_flag_l0
    w.u(0, 1)                  # adaptive_ref_pic_marking_mode_flag
    w.se(qp - 26)              # slice_qp_delta
    if deblock:
        # idc 0 = filter everywhere; idc 2 = not across slice
        # boundaries (one-slice-per-MB-row GDR+deblock streams)
        w.ue(2 if slice_local else 0)
        w.se(0)                # slice_alpha_c0_offset_div2
        w.se(0)                # slice_beta_offset_div2
    else:
        w.ue(1)                # disable_deblocking_filter_idc: OFF


def encode_frame_p_slices(nv12: np.ndarray, recon: tuple, width: int,
                          height: int, qp: int, frame_num: int,
                          slices: int = 1, return_recon: bool = False,
                          search: int = 0, subpel: int = 0,
                          deblock: bool = False, deblock_info=None,
                          force_intra_rows: tuple[int, int] | None = None,
                          slice_local: bool = False,
                          parts: bool = False):
    """Encode one 16-aligned NV12 frame as ``slices`` P slice NALs
    against ``recon`` = (ry, rcb, rcr), the reconstructed previous
    picture (int arrays, unpadded HxW — exactly what
    ``encode_frame_cavlc_slices(..., return_recon=True)`` and this
    function return).  With ``return_recon``, also returns this frame's
    reconstruction (what any conformant decoder must display).

    ``search=0`` is the zero-motion design of the module docstring;
    ``search=R`` (1..15) adds an exhaustive full-pel SAD search
    (:func:`motion_search`) and codes P_L0_16x16 MBs with real
    ``mvd``.  P_Skip stays restricted to mv == (0, 0): the skip MV
    predictor (spec 8.4.1.1) is (0, 0) whenever the top neighbor is
    unavailable OR some zero-MV neighbor triggers the early-out, and
    keeping skip zero-motion means the coded MV field equals the
    searched field — the property that lets the TPU program pick modes
    with no raster dependency."""
    if width % 16 or height % 16:
        raise ValueError("P path requires 16-aligned padded frames")
    mb_w, mb_h = width // 16, height // 16
    qpc = _QPC[min(max(qp, 0), 51)]
    y = nv12[:height].astype(np.int64)
    uv = nv12[height:].reshape(height // 2, width // 2, 2)
    src = {"y": y, "cb": uv[:, :, 0].astype(np.int64),
           "cr": uv[:, :, 1].astype(np.int64)}
    recon_list = recon if isinstance(recon, list) else [recon]
    refs = [{"y": r[0].astype(np.int64), "cb": r[1].astype(np.int64),
             "cr": r[2].astype(np.int64)} for r in recon_list]
    active_refs = len(refs)
    ref = refs[0]
    ry, rcb, rcr = ref["y"], ref["cb"], ref["cr"]
    refsel = np.zeros((mb_h, mb_w), dtype=np.int64)
    pmode = mv4 = None
    if parts:
        # sub-16x16 partitions (16x8 / 8x16 / 8x8): per-partition mvd
        # needs the one-row-slice predictor collapse, and the other
        # sequential-state features don't compose (scope mirrors the
        # TPU program — ops/h264_levels.encode_p_levels parts=1)
        if not search:
            raise ValueError("parts requires search=R > 0")
        if subpel == 3:
            raise ValueError("parts does not compose with fastsub")
        if force_intra_rows is not None:
            raise ValueError("parts requires no gdr")
        if max(1, min(int(slices), mb_h)) != mb_h:
            raise ValueError("parts requires one slice per MB row "
                             f"(slices={mb_h} here)")
        margin = search + (1 if subpel else 0)
        if active_refs > 1:
            # parts x refs: per-partition (ref, mv) from the nine
            # running minima over the flat ref-major candidate order
            builders = {2: quarterpel_planes, 1: halfpel_planes}
            build = builders.get(subpel)
            if build is None:
                def build(p, m):
                    return np.pad(p, m,
                                  mode="edge").astype(np.uint8)[None]
                margin = search
            planes_list = [build(r["y"], margin) for r in refs]
            pmode, mv4, ref4 = motion_search_parts_multi(
                y, planes_list, search, subpel, margin, qp=qp)
            pred = mc_planes_multi(
                refs, mv4_to_quadrant_field(mv4),
                ref4_to_quadrant_field(ref4),
                planes_list, margin, block=8)
            mv = mv4[:, :, 0]
            refsel = ref4[:, :, 0]
        else:
            planes = (quarterpel_planes(ry, margin) if subpel == 2
                      else halfpel_planes(ry, margin) if subpel == 1
                      else None)
            pmode, mv4 = motion_search_parts(
                y, ry, search, subpel=subpel, planes=planes,
                margin=margin, qp=qp)
            ref4 = None
            pred = mc_planes(ref, mv4_to_quadrant_field(mv4),
                             planes=planes, margin=margin, block=8)
            mv = mv4[:, :, 0]   # 16x16-context fallback (q0 == the
            #                     full-MB mv whenever pmode == 0)
    elif active_refs > 1:
        # multi-reference P: the MV predictor stays the left-only rule
        # only at one slice per MB row (8.4.1.3's B/C-unavailable case
        # uses the RAW left MV regardless of its refIdx; the general
        # median would need ref-matching candidates)
        if not search:
            raise ValueError("multi-ref P frames require search=R > 0")
        if max(1, min(int(slices), mb_h)) != mb_h:
            raise NotImplementedError(
                "multi-ref P frames require one slice per MB row")
        margin = search + 1
        builders = {3: quarterpel_planes, 2: quarterpel_planes,
                    1: halfpel_planes}
        build = builders.get(subpel)
        if build is None:
            def build(p, m):
                return np.pad(p, m, mode="edge").astype(np.uint8)[None]
        planes_list = [build(r["y"], margin) for r in refs]
        if subpel == 3:
            mv, refsel = motion_search_fast_multi(y, planes_list,
                                                  search, margin)
        else:
            mv, refsel = motion_search_multi(y, planes_list, search,
                                             subpel, margin)
        pred = mc_planes_multi(refs, mv, refsel, planes_list, margin)
    elif search and subpel == 3:
        # hierarchical quarter-pel (fastsub): full-pel stage + one
        # 49-offset refinement; MC reads the same 16-plane stack
        margin = search + 1
        planes = quarterpel_planes(ry, margin)
        mv = motion_search_fast(
            y, ry, search, planes=planes, margin=margin,
            clean_rows=None if force_intra_rows is None
            else force_intra_rows[0])
        pred = mc_planes(ref, mv, planes=planes, margin=margin)
    elif search and subpel:
        margin = search + 1
        planes = (quarterpel_planes(ry, margin) if subpel == 2
                  else halfpel_planes(ry, margin))
        mv = motion_search(y, ry, search, subpel=subpel, planes=planes,
                           margin=margin,
                           clean_rows=None if force_intra_rows is None
                           else force_intra_rows[0])
        pred = mc_planes(ref, mv, planes=planes, margin=margin)
    elif search:
        mv = motion_search(y, ry, search,
                           clean_rows=None if force_intra_rows is None
                           else force_intra_rows[0])
        pred = mc_planes(ref, mv)
    else:
        mv = np.zeros((mb_h, mb_w, 2), dtype=np.int64)
        pred = ref
    out = {"y": np.empty_like(ry), "cb": np.empty_like(rcb),
           "cr": np.empty_like(rcr)}

    slices = max(1, min(int(slices), mb_h))
    bounds = [round(i * mb_h / slices) for i in range(slices + 1)]
    nals = []
    for si in range(slices):
        w = _BitWriter()
        _slice_head_p(w, qp, frame_num, first_mb=bounds[si] * mb_w,
                      active_refs=active_refs, deblock=deblock,
                      slice_local=slice_local)
        # per-slice nC context rows (one MB row of 4x4 blocks + left pad;
        # P slices still use spatial neighbors for nC, within the slice)
        lnnz = np.zeros((mb_h * 4 + 1, mb_w * 4 + 1), dtype=np.int64)
        cbnnz = np.zeros((mb_h * 2 + 1, mb_w * 2 + 1), dtype=np.int64)
        crnnz = np.zeros_like(cbnnz)
        skip_run = 0
        # MV-prediction state for this slice: the final coded MV field
        # (mvp_skip for skips, (0,0) rows for intra) plus the inter
        # mask — what spec 8.4.1.3's neighbor derivation reads.
        mv_coded = np.zeros((mb_h, mb_w, 2), dtype=np.int64)
        inter_mask = np.zeros((mb_h, mb_w), dtype=bool)
        mvq_coded = (np.zeros((mb_h * 2, mb_w * 2, 2), dtype=np.int64)
                     if parts else None)
        refq_coded = (np.zeros((mb_h * 2, mb_w * 2), dtype=np.int64)
                      if parts and active_refs > 1 else None)
        for mby in range(bounds[si], bounds[si + 1]):
            for mbx in range(mb_w):
                skip_run = _encode_p_mb(
                    w, mby, mbx, src, pred, out, qp, qpc, skip_run,
                    lnnz, cbnnz, crnnz,
                    top_ok=mby > bounds[si], left_ok=mbx > 0,
                    mv2=(int(mv[mby, mbx, 0]), int(mv[mby, mbx, 1])),
                    mv_coded=mv_coded, inter_mask=inter_mask,
                    slice_top=bounds[si],
                    ref2=int(refsel[mby, mbx]),
                    active_refs=active_refs, dbi=deblock_info,
                    force_intra=(force_intra_rows is not None
                                 and force_intra_rows[0] <= mby
                                 < force_intra_rows[1]),
                    part2=(None if not parts
                           else (int(pmode[mby, mbx]), mv4[mby, mbx],
                                 None if ref4 is None
                                 else ref4[mby, mbx])),
                    mvq_coded=mvq_coded, refq_coded=refq_coded)
        if skip_run:
            w.ue(skip_run)  # trailing skipped MBs end the slice
        w.trailing()
        nals.append(bytes(
            _escape(np.frombuffer(w.bytes(), dtype=np.uint8))))
    if return_recon:
        return nals, (out["y"], out["cb"], out["cr"])
    return nals


def search_candidates(search: int) -> list[tuple[int, int]]:
    """Deterministic candidate order of the full-pel motion search:
    every (dy, dx) in [-search, search]^2, sorted by
    (|dy| + |dx|, dy, dx) so (0, 0) is index 0 and smaller motion wins
    SAD ties.  ``search`` must be in [1, 15] (sub-pel lattices bound
    the count against SEARCH_KEY_RADIX — see search_candidates_qpel).

    Full-pel luma MVs keep luma MC a pure block copy; chroma moves by
    mv/2 chroma samples, so odd MVs land on half-sample positions —
    handled by the spec's 1/8-pel bilinear (8.4.2.2.2) with fractions
    in {0, 4}, still exact integer arithmetic (:func:`mc_planes`).
    The order is part of the TPU/oracle byte-exactness contract: both
    sides MUST pick the same MV for the same SAD field.
    """
    if not 1 <= search <= 15:
        raise ValueError(f"search must be an int in [1, 15], "
                         f"got {search}")
    cands = [(dy, dx) for dy in range(-search, search + 1)
             for dx in range(-search, search + 1)]
    cands.sort(key=lambda d: (abs(d[0]) + abs(d[1]), d[0], d[1]))
    return cands


# the tie-break packing radix of the shared selection key
# sad * RADIX + candidate_index: must exceed the largest candidate
# count ((8*11+1)^2 = 7921 at quarter-pel R=11) while keeping
# sad * RADIX + idx < 2^31 exact in int32 (65280 * 8192 ~= 5.3e8 OK)
SEARCH_KEY_RADIX = 8192

# Partition-decision lambda (SAD units per extra motion vector), the
# x264-style sqrt-lambda curve quantized to integers so the oracle and
# the TPU program share ONE exact table: an extra mvd costs ~8 bits,
# and bits cost ~2^((qp-12)/6) SAD each at the inter operating point.
# Part of the byte-exactness contract like SEARCH_KEY_RADIX.
PART_LAMBDA = tuple(round(8 * 2 ** ((q - 12) / 6)) for q in range(52))


def search_candidates_qpel(search: int,
                           subpel: int = 0) -> list[tuple[int, int]]:
    """The motion search candidate set in QUARTER-pel wire units, in
    the shared deterministic order (sorted by (|qy| + |qx|, qy, qx),
    (0, 0) first).  ``subpel=0``: the full-pel grid of
    :func:`search_candidates` scaled by 4 (same relative order — the
    sort key is scale-invariant).  ``subpel=1``: the half-pel lattice
    {(2a, 2b): |a|, |b| <= 2*search}.  ``subpel=2``: the full
    quarter-pel lattice {(a, b): |a|, |b| <= 4*search} (R <= 11 keeps
    (8R+1)^2 inside the SEARCH_KEY_RADIX tie-break packing)."""
    if subpel == 0:
        return [(4 * dy, 4 * dx) for dy, dx in search_candidates(search)]
    if not 1 <= search <= 15:
        raise ValueError(f"search must be an int in [1, 15], "
                         f"got {search}")
    if subpel == 2:
        if search > 11:
            raise ValueError("quarter-pel search radius must be <= 11 "
                             f"(candidate-count bound), got {search}")
        r = 4 * search
        cands = [(a, b) for a in range(-r, r + 1)
                 for b in range(-r, r + 1)]
    else:
        r = 2 * search
        cands = [(2 * a, 2 * b) for a in range(-r, r + 1)
                 for b in range(-r, r + 1)]
    cands.sort(key=lambda d: (abs(d[0]) + abs(d[1]), d[0], d[1]))
    return cands


def _base_planes(ry: np.ndarray, margin: int,
                 extra: int = 0) -> list[np.ndarray]:  # int64 internal
    """[G, b, h, j] of spec 8.4.2.2.1 over an edge-extended reference,
    each ``(H + 2*margin + extra, W + 2*margin + extra)`` — ``extra``
    rows/cols on the high side feed the quarter planes' +1 shifted
    views."""
    t = (1, -5, 20, 20, -5, 1)
    ext = np.pad(ry, margin + 3 + extra, mode="edge").astype(np.int64)
    eh, ew = ext.shape
    H, W = ry.shape
    oh = H + 2 * margin + extra
    ow = W + 2 * margin + extra
    o = 3 + extra
    g = ext[o:o + oh, o:o + ow]
    b1 = sum(c * ext[o:o + oh, o - 2 + k:o - 2 + k + ow]
             for k, c in enumerate(t))
    b = np.clip((b1 + 16) >> 5, 0, 255)
    # unnormalized vertical halves on ALL ext columns (j's input)
    h1f = sum(c * ext[k:eh - 5 + k, :] for k, c in enumerate(t))
    h = np.clip((h1f[o - 2:o - 2 + oh, o:o + ow] + 16) >> 5, 0, 255)
    j1 = sum(c * h1f[o - 2:o - 2 + oh, o - 2 + k:o - 2 + k + ow]
             for k, c in enumerate(t))
    j = np.clip((j1 + 512) >> 10, 0, 255)
    # uint8 storage: clipped pixel values — sub-pel MC at 1080p would
    # otherwise hold hundreds of MB of int64 planes (the device twin
    # stores uint8 for the same reason)
    return [g.astype(np.uint8), b.astype(np.uint8),
            h.astype(np.uint8), j.astype(np.uint8)]


def halfpel_planes(ry: np.ndarray, margin: int) -> np.ndarray:
    """The four half-sample luma planes [G, b, h, j] of spec 8.4.2.2.1
    over an edge-extended reference, each shaped
    ``(H + 2*margin, W + 2*margin)``:

      G[m, n] = ref[clip(m - margin), clip(n - margin)]  (integer)
      b = 6-tap horizontal half right of G:  Clip1((b1 + 16) >> 5)
      h = 6-tap vertical half below G:       Clip1((h1 + 16) >> 5)
      j = 6-tap horizontal of the UNNORMALIZED vertical intermediates:
          Clip1((j1 + 512) >> 10)

    Every tap reads the edge-replicated extension — identical to the
    decoder clamping each sample coordinate (8.4.2.2.1), so planes are
    valid arbitrarily far outside the picture up to ``margin``.
    Returned pre-stacked (4, oh, ow) uint8."""
    return np.stack(_base_planes(ry, margin))


def quarterpel_planes(ry: np.ndarray, margin: int) -> np.ndarray:
    """All 16 sub-sample luma planes of spec 8.4.2.2.1 in (fy, fx)
    raster order [G a b c / d e f g / h i j k / n p q r], each
    ``(H + 2*margin, W + 2*margin)``.  The 12 quarter positions are
    the spec's rounding averages of half-sample neighbors, e.g.
    a = (G + b + 1) >> 1, r = (m + s + 1) >> 1 with m = h one column
    right and s = b one row down.  Returned pre-stacked
    (16, oh, ow) uint8 (averages computed in int16 — G + B <= 510)."""
    g2, b2, h2, j2 = (q.astype(np.int16)
                      for q in _base_planes(ry, margin, extra=1))
    G, B = g2[:-1, :-1], b2[:-1, :-1]
    Hh, J = h2[:-1, :-1], j2[:-1, :-1]
    Gr, Gd = g2[:-1, 1:], g2[1:, :-1]
    m_, s_ = h2[:-1, 1:], b2[1:, :-1]
    return np.stack([
        G, (G + B + 1) >> 1, B, (Gr + B + 1) >> 1,
        (G + Hh + 1) >> 1, (B + Hh + 1) >> 1, (B + J + 1) >> 1,
        (B + m_ + 1) >> 1,
        Hh, (Hh + J + 1) >> 1, J, (J + m_ + 1) >> 1,
        (Gd + Hh + 1) >> 1, (Hh + s_ + 1) >> 1, (J + s_ + 1) >> 1,
        (m_ + s_ + 1) >> 1,
    ]).astype(np.uint8)


def _plane_index(fy, fx, nplanes: int):
    """Plane index of fraction (fy, fx) in a base stack of 1 (G only),
    4 ([G, b, h, j]) or 16 (full (fy, fx) raster) planes."""
    if nplanes == 16:
        return fy * 4 + fx
    if nplanes == 4:
        return fy // 2 * 2 + fx // 2
    return fy * 0


# Reference rows read BELOW an MC block's bottom sample, per vertical
# quarter fraction (qy & 3): 0 none; 1/2 the 6-tap half-sample support
# (+3, also covers the chroma bilinear's +2); 3 the down-average
# quarter positions (n/p/q/r read the NEXT row's half samples: +4).
# This is the exact reach bound the GDR clean-region restriction uses.
_MC_ROW_EXT = (0, 3, 3, 4)

# Exclusion key for restricted candidates: strictly above every valid
# packed key (max sad 65280 * radix 8192 + idx < 2^30) and equal to
# the device program's int32 init value, so oracle and device make
# identical selections even on all-excluded ties.
_BAD_KEY = (1 << 31) - 1


def motion_search(y: np.ndarray, ry: np.ndarray, search: int,
                  subpel: int = 0,
                  planes: np.ndarray | None = None,
                  margin: int = 0,
                  clean_rows: int | None = None) -> np.ndarray:
    """Exhaustive per-MB SAD search over :func:`search_candidates_qpel`
    against the reconstructed previous picture; returns the MV field
    ``(mb_h, mb_w, 2)`` int64 as (dy, dx) in QUARTER-pel units.  With
    ``subpel`` 1 (half) or 2 (quarter) the candidates cover the sub-pel
    lattice and SADs are computed against the interpolated planes (pass
    ``planes``/``margin`` from :func:`halfpel_planes` /
    :func:`quarterpel_planes` to share them with MC).

    Out-of-picture candidates are evaluated against edge-replicated
    samples — exactly the decoder's reference clipping
    (spec 8.4.2.2.1: xInt = Clip3(0, w-1, ...)), so MVs may point
    outside the frame and stay conformant.  Selection is the argmin of
    ``sad * SEARCH_KEY_RADIX + candidate_index`` (SAD <= 16*16*255 <
    2^16, so the packing is exact in int32 — the same packing the TPU
    program uses)."""
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    if subpel and planes is None:
        margin = search + 1
        planes = (quarterpel_planes(ry, margin) if subpel == 2
                  else halfpel_planes(ry, margin))
    elif not subpel:
        margin = search
        planes = np.pad(ry, search, mode="edge"
                        ).astype(np.uint8)[None]
    cur = y.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
    cands = search_candidates_qpel(search, subpel)
    rows = np.arange(mb_h)
    best = None
    best_key = None
    for idx, (qy, qx) in enumerate(cands):
        p = planes[_plane_index(qy & 3, qx & 3, len(planes))]
        iy, ix = margin + (qy >> 2), margin + (qx >> 2)
        ref = p[iy:iy + H, ix:ix + W]
        sad = np.abs(
            cur - ref.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
        ).sum(axis=(1, 3), dtype=np.int64)
        key = sad * SEARCH_KEY_RADIX + idx
        if clean_rows is not None:
            # GDR clean-region restriction: an already-refreshed MB row
            # must not read reference samples at or below the wave
            # (16*clean_rows), including interpolation support — a
            # mid-stream joiner's dirty region would leak in otherwise.
            # The zero-MV candidate is always legal, so every row keeps
            # at least one choice.
            maxrow = 16 * rows + 15 + (qy >> 2) + _MC_ROW_EXT[qy & 3]
            bad = (rows < clean_rows) & (maxrow > 16 * clean_rows - 1)
            key = np.where(bad[:, None], np.int64(_BAD_KEY), key)
        if best is None:
            best, best_key = np.full((mb_h, mb_w), idx), key
        else:
            take = key < best_key
            best = np.where(take, idx, best)
            best_key = np.where(take, key, best_key)
    carr = np.asarray(cands, dtype=np.int64)
    return carr[best]


def motion_search_parts(y: np.ndarray, ry: np.ndarray, search: int,
                        subpel: int = 0,
                        planes: np.ndarray | None = None,
                        margin: int = 0, qp: int = 30):
    """Exhaustive per-PARTITION SAD search (P_L0_16x16 / P_L0_L0_16x8 /
    P_L0_L0_8x16 / P_8x8 with 8x8 sub-partitions): one sweep over the
    shared candidate order accumulates 8x8-granular SAD minima, from
    which every partition hypothesis's best MV falls out (a 16x8 SAD is
    the sum of its two 8x8 halves for the SAME candidate, so each
    hypothesis keeps its own running ``sad * SEARCH_KEY_RADIX + idx``
    key).  The partition mode minimizes ``SAD + PART_LAMBDA[qp] *
    extra_mvs`` with ties preferring coarser partitions — a pure
    function of the SAD field, reproduced exactly by the TPU program
    (ops/h264_levels.motion_search_mc_parts).

    Returns ``(pmode (mb_h, mb_w) int64 in {0: 16x16, 1: 16x8,
    2: 8x16, 3: 8x8}, mv4 (mb_h, mb_w, 4, 2) int64 quarter-pel MVs in
    quadrant raster order [q0 tl, q1 tr, q2 bl, q3 br])`` — partitions
    wider than a quadrant replicate their MV into every quadrant they
    cover, so MC is uniformly 8x8-granular.

    Reference analogue: the VCU's low-delay-P partition decisions
    behind ``OpenCVequalHist.cpp:313-315``.
    """
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    if subpel and planes is None:
        margin = search + 1
        planes = (quarterpel_planes(ry, margin) if subpel == 2
                  else halfpel_planes(ry, margin))
    elif not subpel:
        margin = search
        planes = np.pad(ry, search, mode="edge"
                        ).astype(np.uint8)[None]
    cur = y.reshape(mb_h, 2, 8, mb_w, 2, 8).astype(np.int32)
    cands = search_candidates_qpel(search, subpel)
    kq = kh = kv = kf = None
    for idx, (qy, qx) in enumerate(cands):
        p = planes[_plane_index(qy & 3, qx & 3, len(planes))]
        iy, ix = margin + (qy >> 2), margin + (qx >> 2)
        ref = p[iy:iy + H, ix:ix + W]
        sad8 = np.abs(
            cur - ref.reshape(mb_h, 2, 8, mb_w, 2, 8).astype(np.int32)
        ).sum(axis=(2, 5), dtype=np.int64)      # (mb_h, 2, mb_w, 2)
        keyq = sad8 * SEARCH_KEY_RADIX + idx
        keyh = sad8.sum(axis=3) * SEARCH_KEY_RADIX + idx
        keyv = sad8.sum(axis=1) * SEARCH_KEY_RADIX + idx
        keyf = sad8.sum(axis=(1, 3)) * SEARCH_KEY_RADIX + idx
        if kq is None:
            kq, kh, kv, kf = keyq, keyh, keyv, keyf
        else:
            kq = np.minimum(kq, keyq)
            kh = np.minimum(kh, keyh)
            kv = np.minimum(kv, keyv)
            kf = np.minimum(kf, keyf)
    carr = np.asarray(cands, dtype=np.int64)
    lam = PART_LAMBDA[min(max(int(qp), 0), 51)]
    cost_f = kf // SEARCH_KEY_RADIX
    cost_h = (kh // SEARCH_KEY_RADIX).sum(axis=1) + lam
    cost_v = (kv // SEARCH_KEY_RADIX).sum(axis=2) + lam
    cost_q = (kq // SEARCH_KEY_RADIX).sum(axis=(1, 3)) + 3 * lam
    pmode = np.zeros((mb_h, mb_w), np.int64)
    best = cost_f
    for m, c in ((1, cost_h), (2, cost_v), (3, cost_q)):
        take = c < best                 # strict: ties keep coarser
        pmode = np.where(take, m, pmode)
        best = np.where(take, c, best)
    mvf = carr[kf % SEARCH_KEY_RADIX]               # (mb_h, mb_w, 2)
    mvh = carr[kh % SEARCH_KEY_RADIX]               # (mb_h, 2, mb_w, 2)
    mvv = carr[kv % SEARCH_KEY_RADIX]               # (mb_h, mb_w, 2, 2)
    mvq = carr[kq % SEARCH_KEY_RADIX]            # (mb_h, 2, mb_w, 2, 2)
    mv4_f = np.broadcast_to(mvf[:, :, None, :], (mb_h, mb_w, 4, 2))
    mv4_h = np.repeat(mvh.transpose(0, 2, 1, 3), 2, axis=2)
    mv4_v = np.tile(mvv, (1, 1, 2, 1))
    mv4_q = mvq.transpose(0, 2, 1, 3, 4).reshape(mb_h, mb_w, 4, 2)
    sel = pmode[:, :, None, None]
    mv4 = np.where(sel == 0, mv4_f,
                   np.where(sel == 1, mv4_h,
                            np.where(sel == 2, mv4_v, mv4_q)))
    return pmode, mv4


def motion_search_parts_multi(y: np.ndarray,
                              planes_list: list[np.ndarray],
                              search: int, subpel: int,
                              margin: int, qp: int = 30):
    """:func:`motion_search_parts` over MULTIPLE references: the
    references are searched ref-major as one flat candidate sequence
    (i = r * n + idx, like :func:`motion_search_multi`), so every
    hypothesis key's winner carries its own (ref, mv) — per-PARTITION
    reference indices fall out of the same nine running minima.
    Strict minimum + ref-major order = at equal SAD the earlier (more
    recent) reference wins, the shared multi-reference rule.

    The flat index must fit the key packing: ``nrefs * len(cands) <=
    SEARCH_KEY_RADIX`` (full/half-pel: every radius; quarter-pel:
    R <= 7 at 2 references).

    Returns (pmode, mv4 quadrant-major quarter-pel, ref4 (mb_h, mb_w,
    4) int64 per-quadrant reference indices).
    """
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    nrefs = len(planes_list)
    cur = y.reshape(mb_h, 2, 8, mb_w, 2, 8).astype(np.int32)
    cands = search_candidates_qpel(search, subpel)
    n = len(cands)
    if nrefs * n > SEARCH_KEY_RADIX:
        raise ValueError(
            f"parts refs={nrefs} at this sub-pel radius exceeds the "
            f"key packing ({nrefs}*{n} > {SEARCH_KEY_RADIX}); "
            "quarter-pel parts with 2 references needs R <= 7")
    kq = kh = kv = kf = None
    for r in range(nrefs):
        planes = planes_list[r]
        for idx, (qy, qx) in enumerate(cands):
            i = r * n + idx
            p = planes[_plane_index(qy & 3, qx & 3, len(planes))]
            iy, ix = margin + (qy >> 2), margin + (qx >> 2)
            ref = p[iy:iy + H, ix:ix + W]
            sad8 = np.abs(
                cur - ref.reshape(mb_h, 2, 8, mb_w, 2, 8)
                .astype(np.int32)).sum(axis=(2, 5), dtype=np.int64)
            keyq = sad8 * SEARCH_KEY_RADIX + i
            keyh = sad8.sum(axis=3) * SEARCH_KEY_RADIX + i
            keyv = sad8.sum(axis=1) * SEARCH_KEY_RADIX + i
            keyf = sad8.sum(axis=(1, 3)) * SEARCH_KEY_RADIX + i
            if kq is None:
                kq, kh, kv, kf = keyq, keyh, keyv, keyf
            else:
                kq = np.minimum(kq, keyq)
                kh = np.minimum(kh, keyh)
                kv = np.minimum(kv, keyv)
                kf = np.minimum(kf, keyf)
    carr = np.asarray(cands, dtype=np.int64)
    lam = PART_LAMBDA[min(max(int(qp), 0), 51)]
    cost_f = kf // SEARCH_KEY_RADIX
    cost_h = (kh // SEARCH_KEY_RADIX).sum(axis=1) + lam
    cost_v = (kv // SEARCH_KEY_RADIX).sum(axis=2) + lam
    cost_q = (kq // SEARCH_KEY_RADIX).sum(axis=(1, 3)) + 3 * lam
    pmode = np.zeros((mb_h, mb_w), np.int64)
    best = cost_f
    for m, c in ((1, cost_h), (2, cost_v), (3, cost_q)):
        take = c < best                 # strict: ties keep coarser
        pmode = np.where(take, m, pmode)
        best = np.where(take, c, best)
    iff = kf % SEARCH_KEY_RADIX
    ihh = kh % SEARCH_KEY_RADIX
    ivv = kv % SEARCH_KEY_RADIX
    iqq = kq % SEARCH_KEY_RADIX

    def expand(iw_f, iw_h, iw_v, iw_q):
        """Per-quadrant winner index field (mb_h, mb_w, 4) selected by
        partition mode (quadrant-major q0 tl, q1 tr, q2 bl, q3 br)."""
        e_f = np.broadcast_to(iw_f[:, :, None], (mb_h, mb_w, 4))
        e_h = np.repeat(iw_h.transpose(0, 2, 1), 2, axis=2)
        e_v = np.tile(iw_v, (1, 1, 2))
        e_q = iw_q.transpose(0, 2, 1, 3).reshape(mb_h, mb_w, 4)
        sel = pmode[:, :, None]
        return np.where(sel == 0, e_f,
                        np.where(sel == 1, e_h,
                                 np.where(sel == 2, e_v, e_q)))

    iq4 = expand(iff, ihh, ivv, iqq)        # (mb_h, mb_w, 4) flat i
    mv4 = carr[iq4 % n]
    ref4 = iq4 // n
    return pmode, mv4, ref4


def mv4_to_quadrant_field(mv4: np.ndarray) -> np.ndarray:
    """(mb_h, mb_w, 4, 2) quadrant-major MV field -> the 8x8-granular
    grid (2*mb_h, 2*mb_w, 2) that block-8 MC consumes."""
    mb_h, mb_w = mv4.shape[:2]
    return (mv4.reshape(mb_h, mb_w, 2, 2, 2).transpose(0, 2, 1, 3, 4)
            .reshape(2 * mb_h, 2 * mb_w, 2))


def ref4_to_quadrant_field(ref4: np.ndarray) -> np.ndarray:
    """(mb_h, mb_w, 4) quadrant-major ref field -> (2mb_h, 2mb_w)."""
    mb_h, mb_w = ref4.shape[:2]
    return (ref4.reshape(mb_h, mb_w, 2, 2).transpose(0, 2, 1, 3)
            .reshape(2 * mb_h, 2 * mb_w))


def mc_planes(ref: dict, mv: np.ndarray,
              planes: np.ndarray | None = None,
              margin: int = 0, block: int = 16) -> dict:
    """Motion-compensated prediction planes for a per-MB QUARTER-pel
    MV field.  Luma: a block copy at full-pel positions (``planes``
    None — requires mv % 4 == 0), or a per-MB select from the
    :func:`halfpel_planes` stack [G, b, h, j] at half-pel positions
    (plane index from the MV fractions, integer offset ``mv >> 2``).
    Per-sample clipping to the picture (spec 8.4.2.2.1) — the planes
    carry it via their edge-extended construction.  Chroma uses
    mvC = mvL in eighth-chroma-sample units: integer part ``mv >> 3``
    (arithmetic shift = spec floor), fraction ``mv & 7``, interpolated
    with the spec 8.4.2.2.2 bilinear
    ``((8-xF)(8-yF)A + xF(8-yF)B + (8-xF)yF C + xF yF D + 32) >> 6``
    — exact integer arithmetic; at zero fractions it reduces to the
    block copy.  A zero field returns the co-located planes
    byte-for-byte.  ``block`` is the MV-field granularity in luma
    samples: 16 for per-MB fields, 8 for the quadrant fields of the
    partition modes (chroma granularity is block/2)."""
    H, W = ref["y"].shape
    cb2 = block // 2
    dyg = np.repeat(np.repeat(mv[:, :, 0] >> 2, block, 0), block, 1)
    dxg = np.repeat(np.repeat(mv[:, :, 1] >> 2, block, 0), block, 1)
    if planes is None:
        rows = np.clip(np.arange(H)[:, None] + dyg, 0, H - 1)
        cols = np.clip(np.arange(W)[None, :] + dxg, 0, W - 1)
        out = {"y": ref["y"][rows, cols]}
    else:
        pidx = _plane_index(mv[:, :, 0] & 3, mv[:, :, 1] & 3,
                            len(planes))
        pg = np.repeat(np.repeat(pidx, block, 0), block, 1)
        rows = margin + np.arange(H)[:, None] + dyg
        cols = margin + np.arange(W)[None, :] + dxg
        stack = np.asarray(planes)
        out = {"y": stack[pg, rows, cols].astype(np.int64)}
    cdyg = np.repeat(np.repeat(mv[:, :, 0] >> 3, cb2, 0), cb2, 1)
    cdxg = np.repeat(np.repeat(mv[:, :, 1] >> 3, cb2, 0), cb2, 1)
    fyg = np.repeat(np.repeat(mv[:, :, 0] & 7, cb2, 0), cb2, 1)
    fxg = np.repeat(np.repeat(mv[:, :, 1] & 7, cb2, 0), cb2, 1)
    ch, cw = H // 2, W // 2
    r0 = np.clip(np.arange(ch)[:, None] + cdyg, 0, ch - 1)
    r1 = np.clip(np.arange(ch)[:, None] + cdyg + 1, 0, ch - 1)
    c0 = np.clip(np.arange(cw)[None, :] + cdxg, 0, cw - 1)
    c1 = np.clip(np.arange(cw)[None, :] + cdxg + 1, 0, cw - 1)
    wa = (8 - fxg) * (8 - fyg)
    wb = fxg * (8 - fyg)
    wc = (8 - fxg) * fyg
    wd = fxg * fyg
    for name in ("cb", "cr"):
        p = ref[name]
        out[name] = (wa * p[r0, c0] + wb * p[r0, c1] +
                     wc * p[r1, c0] + wd * p[r1, c1] + 32) >> 6
    return out


# Hierarchical refinement neighborhood: every quarter-pel offset
# within (-1, 1) pel of the full-pel winner, in the shared
# deterministic order (sorted by (|qy| + |qx|, qy, qx), (0, 0) first —
# index 0 IS the full-pel winner, so an all-tie field keeps it).
# 49 < SEARCH_KEY_RADIX, so the same key packing applies.
FASTSUB_OFFSETS: list[tuple[int, int]] = sorted(
    ((a, b) for a in range(-3, 4) for b in range(-3, 4)),
    key=lambda d: (abs(d[0]) + abs(d[1]), d[0], d[1]))


def motion_search_fast(y: np.ndarray, ry: np.ndarray, search: int,
                       planes: np.ndarray | None = None,
                       margin: int = 0,
                       clean_rows: int | None = None) -> np.ndarray:
    """Hierarchical quarter-pel search (``fastsub``): exhaustive
    FULL-pel stage (:func:`motion_search`), then one refinement stage
    over :data:`FASTSUB_OFFSETS` — all 49 quarter-pel offsets within
    ±3/4 pel of each MB's full-pel winner.  (2R+1)² + 49 SAD passes
    instead of the exhaustive lattice's (8R+1)² — at R=8 that is
    12.5x fewer — at the cost of assuming the sub-pel optimum lies
    around the full-pel one (the standard coarse-to-fine trade;
    x264's subme ladder makes the same bet).

    The refinement stays TPU-uniform because the full-pel winner
    contributes no fraction: every offset's plane index (off & 3) and
    patch offset (off >> 2) are the SAME for all MBs — the device twin
    (ops.h264_levels.motion_search_mc_fast) exploits exactly this with
    one per-MB recentering gather.  Selection per stage is the argmin
    of ``sad * SEARCH_KEY_RADIX + index`` over the stage's candidate
    list — the decision rule (both stages) is part of the TPU/oracle
    byte-exactness contract.  Radius may be 1..15 (the quarter-pel
    R<=11 bound does not apply: the stage candidate counts are
    (2R+1)² <= 961 and 49).

    Returns the MV field (mb_h, mb_w, 2) int64 in QUARTER-pel units,
    |mv| <= 4*search + 3."""
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    if planes is None:
        margin = search + 1
        planes = quarterpel_planes(ry, margin)
    mv0 = motion_search(y, ry, search, clean_rows=clean_rows)
    cur = y.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
    dyg = np.repeat(np.repeat(mv0[:, :, 0] >> 2, 16, 0), 16, 1)
    dxg = np.repeat(np.repeat(mv0[:, :, 1] >> 2, 16, 0), 16, 1)
    rows0 = margin + np.arange(H)[:, None] + dyg
    cols0 = margin + np.arange(W)[None, :] + dxg
    rows_mb = np.arange(mb_h)[:, None]
    ext = np.asarray(_MC_ROW_EXT)
    best = None
    best_key = None
    for j, (qy, qx) in enumerate(FASTSUB_OFFSETS):
        p = planes[(qy & 3) * 4 + (qx & 3)]
        ref = p[rows0 + (qy >> 2), cols0 + (qx >> 2)]
        sad = np.abs(
            cur - ref.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
        ).sum(axis=(1, 3), dtype=np.int64)
        key = sad * SEARCH_KEY_RADIX + j
        if clean_rows is not None:
            # same clean-region reach bound as the exhaustive search,
            # with the per-MB total MV (winner + offset); index 0 is
            # the full-pel winner (reach EXT[0] = 0), already legal —
            # every MB keeps at least one choice
            ty = mv0[:, :, 0] + qy
            maxrow = 16 * rows_mb + 15 + (ty >> 2) + ext[qy & 3]
            bad = (rows_mb < clean_rows) & (maxrow > 16 * clean_rows - 1)
            key = np.where(bad, np.int64(_BAD_KEY), key)
        if best is None:
            best, best_key = np.full((mb_h, mb_w), j), key
        else:
            take = key < best_key
            best = np.where(take, j, best)
            best_key = np.where(take, key, best_key)
    offs = np.asarray(FASTSUB_OFFSETS, dtype=np.int64)
    return mv0 + offs[best]


def motion_search_multi(y: np.ndarray, planes_list: list[np.ndarray],
                        search: int, subpel: int,
                        margin: int) -> tuple[np.ndarray, np.ndarray]:
    """Exhaustive search over MULTIPLE reference pictures: per MB the
    best (ref, mv) with the shared ``sad * SEARCH_KEY_RADIX + index``
    key, references compared in list order with STRICT less-than — at
    equal (sad, index) the earlier (more recent, cheaper-to-code)
    reference wins.  ``planes_list[r]`` is reference r's stacked
    sub-pel plane set (:func:`halfpel_planes` / mono full-pel pad).
    Returns (mv (mb_h, mb_w, 2) quarter-pel, ref (mb_h, mb_w))."""
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    cur = y.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
    cands = search_candidates_qpel(search, subpel)
    best_key = None
    best_idx = np.zeros((mb_h, mb_w), np.int64)
    best_ref = np.zeros((mb_h, mb_w), np.int64)
    for r, planes in enumerate(planes_list):
        for idx, (qy, qx) in enumerate(cands):
            p = planes[_plane_index(qy & 3, qx & 3, len(planes))]
            iy, ix = margin + (qy >> 2), margin + (qx >> 2)
            ref = p[iy:iy + H, ix:ix + W]
            sad = np.abs(
                cur - ref.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
            ).sum(axis=(1, 3), dtype=np.int64)
            key = sad * SEARCH_KEY_RADIX + idx
            if best_key is None:
                best_key = key
                best_idx[:] = idx
            else:
                take = key < best_key
                best_key = np.where(take, key, best_key)
                best_idx = np.where(take, idx, best_idx)
                best_ref = np.where(take, r, best_ref)
    carr = np.asarray(cands, dtype=np.int64)
    return carr[best_idx], best_ref


def motion_search_fast_multi(y: np.ndarray,
                             planes_list: list[np.ndarray],
                             search: int, margin: int
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Hierarchical quarter-pel search over MULTIPLE references
    (``fastsub`` + ``refs>1``): the exhaustive full-pel stage picks a
    per-MB (ref, mv) with :func:`motion_search_multi`'s exact rule
    (ref-major order, strict less-than), then the 49-offset
    :data:`FASTSUB_OFFSETS` refinement runs on each MB's WINNING
    reference only (the reference choice is a stage-1 decision — the
    refinement adjusts the vector, never the picture, so ref_idx
    coding cost stays what the full-pel stage saw).

    ``planes_list[r]`` must be reference r's 16-plane quarter-pel
    stack (the full-pel stage reads its plane 0 — the integer
    samples).  Returns (mv quarter-pel, ref), the
    :func:`motion_search_multi` contract."""
    H, W = y.shape
    mb_h, mb_w = H // 16, W // 16
    mv0, ref0 = motion_search_multi(y, planes_list, search, 0, margin)
    big = np.concatenate(planes_list)
    P = len(planes_list[0])
    cur = y.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
    pg = np.repeat(np.repeat(ref0 * P, 16, 0), 16, 1)
    dyg = np.repeat(np.repeat(mv0[:, :, 0] >> 2, 16, 0), 16, 1)
    dxg = np.repeat(np.repeat(mv0[:, :, 1] >> 2, 16, 0), 16, 1)
    rows0 = margin + np.arange(H)[:, None] + dyg
    cols0 = margin + np.arange(W)[None, :] + dxg
    best = None
    best_key = None
    for j, (qy, qx) in enumerate(FASTSUB_OFFSETS):
        ref = big[pg + (qy & 3) * 4 + (qx & 3),
                  rows0 + (qy >> 2), cols0 + (qx >> 2)]
        sad = np.abs(
            cur - ref.reshape(mb_h, 16, mb_w, 16).astype(np.int32)
        ).sum(axis=(1, 3), dtype=np.int64)
        key = sad * SEARCH_KEY_RADIX + j
        if best is None:
            best, best_key = np.full((mb_h, mb_w), j), key
        else:
            take = key < best_key
            best = np.where(take, j, best)
            best_key = np.where(take, key, best_key)
    offs = np.asarray(FASTSUB_OFFSETS, dtype=np.int64)
    return mv0 + offs[best], ref0


def mc_planes_multi(refs: list[dict], mv: np.ndarray, ref: np.ndarray,
                    planes_list: list[np.ndarray],
                    margin: int, block: int = 16) -> dict:
    """Motion compensation with a per-block reference index: luma from
    the concatenated plane stacks (plane id = ref * P + sub-position),
    chroma via the general bilinear on per-sample gathers from the
    stacked reference chroma planes.  ``block`` is the (mv, ref) field
    granularity in luma samples: 16 for per-MB fields, 8 for the
    quadrant fields of the partition modes."""
    H, W = refs[0]["y"].shape
    P = len(planes_list[0])
    big = np.concatenate(planes_list)
    pidx = (ref * P
            + _plane_index(mv[:, :, 0] & 3, mv[:, :, 1] & 3, P))
    pg = np.repeat(np.repeat(pidx, block, 0), block, 1)
    dyg = np.repeat(np.repeat(mv[:, :, 0] >> 2, block, 0), block, 1)
    dxg = np.repeat(np.repeat(mv[:, :, 1] >> 2, block, 0), block, 1)
    rows = margin + np.arange(H)[:, None] + dyg
    cols = margin + np.arange(W)[None, :] + dxg
    out = {"y": big[pg, rows, cols].astype(np.int64)}

    ch, cw = H // 2, W // 2
    cb2 = block // 2
    rg = np.repeat(np.repeat(ref, cb2, 0), cb2, 1)
    cdyg = np.repeat(np.repeat(mv[:, :, 0] >> 3, cb2, 0), cb2, 1)
    cdxg = np.repeat(np.repeat(mv[:, :, 1] >> 3, cb2, 0), cb2, 1)
    fyg = np.repeat(np.repeat(mv[:, :, 0] & 7, cb2, 0), cb2, 1)
    fxg = np.repeat(np.repeat(mv[:, :, 1] & 7, cb2, 0), cb2, 1)
    r0 = np.clip(np.arange(ch)[:, None] + cdyg, 0, ch - 1)
    r1 = np.clip(np.arange(ch)[:, None] + cdyg + 1, 0, ch - 1)
    c0 = np.clip(np.arange(cw)[None, :] + cdxg, 0, cw - 1)
    c1 = np.clip(np.arange(cw)[None, :] + cdxg + 1, 0, cw - 1)
    wa = (8 - fxg) * (8 - fyg)
    wb = fxg * (8 - fyg)
    wc = (8 - fxg) * fyg
    wd = fxg * fyg
    for name in ("cb", "cr"):
        cstack = np.stack([rf[name] for rf in refs])
        out[name] = (wa * cstack[rg, r0, c0] + wb * cstack[rg, r0, c1] +
                     wc * cstack[rg, r1, c0] + wd * cstack[rg, r1, c1]
                     + 32) >> 6
    return out


def _cost(*arrays) -> int:
    """Deterministic CAVLC bit-cost proxy of quantized levels (the
    single shared definition: io.h264_cavlc.level_cost).  Monotone in
    both magnitude and count (the two drivers of CAVLC length),
    integer-exact, and reproducible by the TPU level program in int32
    — the whole point: the mode decision must be a pure function of
    the levels, never of entropy-coded bits."""
    from opencv_opencl_tpu_torch.io.h264_cavlc import level_cost

    return level_cost(*arrays)


_INTRA_BIAS = 8  # intra syntax overhead (mb_type 5+x, chroma mode) in
#                  proxy units; inter pays ~3 bits (type + 2 mvd)


def _intra_luma_levels(resid: np.ndarray, qp: int):
    """Quantized I_16x16 luma levels (DC split + AC) of one residual."""
    from opencv_opencl_tpu_torch.io.h264_cavlc import _H4, _quant4x4

    wdc = np.empty((4, 4), dtype=np.int64)
    acz = {}
    for by in range(4):
        for bx in range(4):
            blk = resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            t = _CF @ blk @ _CF.T
            wdc[by, bx] = t[0, 0]
            acz[(bx, by)] = _quant4x4(t, qp, skip_dc=True)
    ydc = (_H4 @ wdc @ _H4) >> 1
    qbits = 15 + qp // 6
    f2 = 2 * ((1 << qbits) // 3)
    zdc = np.sign(ydc) * ((np.abs(ydc) * _MF[qp % 6][0] + f2) >>
                          (qbits + 1))
    np.clip(zdc, -_LEVEL_CLAMP, _LEVEL_CLAMP, out=zdc)
    return zdc, acz


def _intra_candidate(mby: int, mbx: int, src: dict, out: dict, qp: int,
                     qpc: int, top_ok: bool, left_ok: bool) -> dict:
    """Best I_16x16 luma candidate (DC, or HORIZONTAL when the left
    recon column exists and its quantized levels cost less by the
    shared proxy) for one MB of a P slice, predicting from the CURRENT
    picture's reconstruction (constrained_intra_pred_flag=0: inter/
    skip neighbors are usable).  Same arithmetic as the I-slice
    encoder (io.h264_cavlc._MbEncoder.encode_mb); chroma prediction
    stays DC."""
    from opencv_opencl_tpu_torch.io.h264_cavlc import (
        _pred_dc_chroma, _quant4x4)

    y0, x0 = mby * 16, mbx * 16
    cy0, cx0 = mby * 8, mbx * 8
    oy = out["y"]
    if top_ok and left_ok:
        s = int(oy[y0 - 1, x0:x0 + 16].sum()) + \
            int(oy[y0:y0 + 16, x0 - 1].sum())
        pred = (s + 16) >> 5
    elif top_ok:
        pred = (int(oy[y0 - 1, x0:x0 + 16].sum()) + 8) >> 4
    elif left_ok:
        pred = (int(oy[y0:y0 + 16, x0 - 1].sum()) + 8) >> 4
    else:
        pred = 128
    srcmb = src["y"][y0:y0 + 16, x0:x0 + 16]
    zdc, acz = _intra_luma_levels(srcmb - pred, qp)
    predmode = 2                      # Intra_16x16_DC
    if left_ok:
        # HORIZONTAL: each row replicates its left recon pixel
        pred_h = oy[y0:y0 + 16, x0 - 1:x0]        # (16, 1) broadcast
        zdc_h, acz_h = _intra_luma_levels(srcmb - pred_h, qp)
        if (_cost(zdc_h, *acz_h.values())
                < _cost(zdc, *acz.values())):
            pred, zdc, acz, predmode = pred_h, zdc_h, acz_h, 1
    cbp_luma = any(np.any(acz[k]) for k in acz)

    cdata = {}
    chroma_dc_nz = chroma_ac_nz = False
    for name in ("cb", "cr"):
        cpred = _pred_dc_chroma(out[name], cy0, cx0, top_ok, left_ok)
        cres = src[name][cy0:cy0 + 8, cx0:cx0 + 8] - cpred
        cwdc = np.empty((2, 2), dtype=np.int64)
        cacz = {}
        for by in range(2):
            for bx in range(2):
                blk = cres[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
                t = _CF @ blk @ _CF.T
                cwdc[by, bx] = t[0, 0]
                cacz[(bx, by)] = _quant4x4(t, qpc, skip_dc=True)
        fdc = _H2 @ cwdc @ _H2
        cqbits = 15 + qpc // 6
        cf2 = 2 * ((1 << cqbits) // 3)
        czdc = np.sign(fdc) * ((np.abs(fdc) * _MF[qpc % 6][0] + cf2) >>
                               (cqbits + 1))
        np.clip(czdc, -_LEVEL_CLAMP, _LEVEL_CLAMP, out=czdc)
        if np.any(czdc):
            chroma_dc_nz = True
        if any(np.any(cacz[k]) for k in cacz):
            chroma_ac_nz = True
        cdata[name] = (cpred, cacz, czdc)
    cbp_chroma = 2 if chroma_ac_nz else (1 if chroma_dc_nz else 0)
    cost = (_cost(zdc, *acz.values(),
                  *(cdata[n][2] for n in ("cb", "cr")),
                  *(b for n in ("cb", "cr")
                    for b in cdata[n][1].values())) + _INTRA_BIAS)
    return dict(pred=pred, acz=acz, zdc=zdc, cdata=cdata,
                cbp_luma=cbp_luma, cbp_chroma=cbp_chroma, cost=cost,
                predmode=predmode)


def _mvp_16x16(mby: int, mbx: int, mv_coded: np.ndarray,
               inter_mask: np.ndarray, slice_top: int,
               mb_w: int) -> tuple[int, int]:
    """MV predictor for a P_L0_16x16 macroblock (spec 8.4.1.3):
    neighbors A = left, B = top, C = top-right with the top-left D
    substituted when C is unavailable.  An intra neighbor is an
    *available macroblock* whose motion data is unusable (candidate
    (0, 0), not same-reference).  Returns (mvp_y, mvp_x) in the same
    (quarter-pel) units as ``mv_coded``.

    With one slice per MB row, B/C/D are never available and this
    collapses to: mvA when the left MB is inter, else (0, 0) — the
    shortcut the TPU entropy stage (encode_frame_p_from_levels, native
    rows) relies on."""

    def fetch(y: int, x: int, avail: bool):
        if not avail:
            return False, False, (0, 0)
        inter = bool(inter_mask[y, x])
        mvn = ((int(mv_coded[y, x, 0]), int(mv_coded[y, x, 1]))
               if inter else (0, 0))
        return True, inter, mvn

    a_av, a_ref, mva = fetch(mby, mbx - 1, mbx > 0)
    b_av, b_ref, mvb = fetch(mby - 1, mbx, mby > slice_top)
    c_av, c_ref, mvc = fetch(mby - 1, mbx + 1,
                             mby > slice_top and mbx + 1 < mb_w)
    if not c_av:
        c_av, c_ref, mvc = fetch(mby - 1, mbx - 1,
                                 mby > slice_top and mbx > 0)
    match = int(a_ref) + int(b_ref) + int(c_ref)
    if match == 1:
        return mva if a_ref else (mvb if b_ref else mvc)
    if match == 0 and not b_av and not c_av and a_av:
        return mva
    ys = sorted((mva[0], mvb[0], mvc[0]))
    xs = sorted((mva[1], mvb[1], mvc[1]))
    return ys[1], xs[1]


def _mvp_skip(mby: int, mbx: int, mv_coded: np.ndarray,
              inter_mask: np.ndarray, slice_top: int,
              mb_w: int) -> tuple[int, int]:
    """P_Skip MV predictor (spec 8.4.1.1): (0, 0) when A or B is
    unavailable or either is a zero-MV ref-0 neighbor, else the
    8.4.1.3 median.  One slice per MB row => B always unavailable =>
    always (0, 0) (the zero-motion module invariant)."""
    if mbx == 0 or mby == slice_top:
        return 0, 0
    for (ny, nx) in ((mby, mbx - 1), (mby - 1, mbx)):
        if inter_mask[ny, nx] and not mv_coded[ny, nx].any():
            return 0, 0
    return _mvp_16x16(mby, mbx, mv_coded, inter_mask, slice_top, mb_w)


def _median2(a, b, c) -> tuple[int, int]:
    """Component-wise median of three MVs (spec 8.4.1.3.1)."""
    return (sorted((a[0], b[0], c[0]))[1],
            sorted((a[1], b[1], c[1]))[1])


_MVP_UNAVAIL = ((0, 0), -1, False)


def _mvp_parts(pidx: int, pmode: int, left_avail: bool,
               left_inter: bool, left_q1, left_q3,
               own, myref: int = 0,
               left_r1: int = 0, left_r3: int = 0,
               ownref=None) -> tuple[int, int]:
    """MV predictor for partition ``pidx`` of a partitioned P MB under
    ONE slice per MB row (spec 8.4.1.3 with every above-row neighbor
    unavailable), now reference-aware: with ``refs > 1`` the
    directional rules gate on refIdx equality and the general process
    applies the exactly-one-match rule before the median.  With one
    reference every inter neighbor matches and this reproduces the
    original refs=1 collapse byte for byte (the derivation below).

    ``left_q1``/``left_q3``/``left_r1``/``left_r3`` are the left MB's
    right-edge quadrant MVs and refs; ``own``/``ownref`` this MB's
    already-coded quadrant fields; ``myref`` the current partition's
    reference.

    Neighbor map per partition (A left, B above, C above-right with D
    fallback; anything above the MB row is out-of-slice):

    - 16x16 / 16x8 top / 8x8 q0: B, C, D unavailable -> the spec copy
      rule returns A = left q1 REGARDLESS of refIdx (ref-independent).
    - 16x8 bottom: directional A (= left q3) if refs match; else
      general over (A = left q3, B = own top, C->D = left q1).
    - 8x16 left: directional A (= left q1) if refs match; else the
      copy rule still yields left q1's effective MV (ref-independent).
    - 8x16 right: directional C out-of-slice; copy rule -> own left.
    - 8x8 q1: copy rule -> own q0.  q2: general over (left q3, own
      q0, own q1).  q3: general over (own q2, own q1, C->D = own q0).
    """
    a1 = ((tuple(left_q1) if left_inter else (0, 0)),
          (left_r1 if left_inter else -1), left_avail)
    a3 = ((tuple(left_q3) if left_inter else (0, 0)),
          (left_r3 if left_inter else -1), left_avail)

    def ownn(q):
        r = 0 if ownref is None else int(ownref[q])
        return ((int(own[q][0]), int(own[q][1])), r, True)

    def general(A, B, C):
        eff = [(x[0], x[1]) if x[2] else ((0, 0), -1)
               for x in (A, B, C)]
        if not B[2] and not C[2] and A[2]:
            return eff[0][0]            # spec copy rule: raw mvA
        match = [e[0] for e in eff if e[1] == myref]
        if len(match) == 1:
            return match[0]
        return _median2(eff[0][0], eff[1][0], eff[2][0])

    U = _MVP_UNAVAIL
    if pmode == 0:
        return general(a1, U, U)
    if pmode == 1:                       # 16x8: partitions (q0, q2)
        if pidx == 0:
            return general(a1, U, U)
        if a3[2] and a3[1] == myref:     # directional A
            return a3[0]
        return general(a3, ownn(0), a1)
    if pmode == 2:                       # 8x16: partitions (q0, q1)
        if pidx == 0:
            if a1[2] and a1[1] == myref:  # directional A
                return a1[0]
            return general(a1, U, U)
        return general(ownn(0), U, U)
    # pmode 3: 8x8 sub-partitions q0..q3
    if pidx == 0:
        return general(a1, U, U)
    if pidx == 1:
        return general(ownn(0), U, U)
    if pidx == 2:
        return general(a3, ownn(0), ownn(1))
    return general(ownn(2), ownn(1), ownn(0))


# partition list per pmode: (partition index for mvd order,
# quadrant indices covered)
_PART_QUADS = {0: ((0, (0, 1, 2, 3)),),
               1: ((0, (0, 1)), (1, (2, 3))),
               2: ((0, (0, 2)), (1, (1, 3))),
               3: ((0, (0,)), (1, (1,)), (2, (2,)), (3, (3,)))}


def _encode_p_mb(w: _BitWriter, mby: int, mbx: int, src: dict, ref: dict,
                 out: dict, qp: int, qpc: int, skip_run: int,
                 lnnz: np.ndarray, cbnnz: np.ndarray, crnnz: np.ndarray,
                 top_ok: bool, left_ok: bool,
                 mv2: tuple[int, int] = (0, 0),
                 mv_coded: np.ndarray | None = None,
                 inter_mask: np.ndarray | None = None,
                 slice_top: int = 0, ref2: int = 0,
                 active_refs: int = 1, dbi=None,
                 force_intra: bool = False,
                 part2: tuple | None = None,
                 mvq_coded: np.ndarray | None = None,
                 refq_coded: np.ndarray | None = None) -> int:
    """One P macroblock: P_Skip if the inter candidate quantizes to all
    zero (and the searched MV matches the skip predictor with
    reference 0), else the cheaper of P_L0_16x16 (te(v) ref_idx when
    more than one reference is active, mvd = mv - mvp) and I_16x16 by
    the ``_cost`` proxy.  ``ref`` is the motion-compensated prediction
    plane set (the raw previous picture when search is off).  Returns
    the updated skip_run.

    ``part2 = (pmode, mv4)`` selects the partitioned write path
    (P_L0_L0_16x8 / P_L0_L0_8x16 / P_8x8 with per-partition mvd —
    requires one slice per MB row and ``mvq_coded``, the 8x8-granular
    coded-MV context); the prediction planes are already partition-
    compensated, so the residual/recon path is untouched."""
    y0, x0 = mby * 16, mbx * 16
    cy0, cx0 = mby * 8, mbx * 8

    if force_intra:
        # GDR refresh band: the MB is intra regardless of cost (the
        # marching wave of gdr-mode=horizontal,
        # OpenCVequalHist.cpp:313,325) — no inter candidate is even
        # computed, so the band never references the previous picture
        intra = _intra_candidate(mby, mbx, src, out, qp, qpc, top_ok,
                                 left_ok)
        _write_intra_in_p(w, mby, mbx, out, qp, qpc, skip_run, intra,
                          lnnz, cbnnz, crnnz, top_ok, left_ok)
        if dbi is not None:
            dbi.intra[mby, mbx] = True
        return 0

    # ---- inter candidate: residual vs co-located reference
    pred_y = ref["y"][y0:y0 + 16, x0:x0 + 16]
    res = src["y"][y0:y0 + 16, x0:x0 + 16] - pred_y
    lz = {}
    for by in range(4):
        for bx in range(4):
            blk = res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            lz[(bx, by)] = _quant4x4_inter(_CF @ blk @ _CF.T, qp)
    cbp_luma = 0
    for q, (qx, qy) in enumerate(((0, 0), (2, 0), (0, 2), (2, 2))):
        if any(np.any(lz[(qx + dx, qy + dy)])
               for dx in (0, 1) for dy in (0, 1)):
            cbp_luma |= 1 << q

    cdata = {}
    chroma_dc_nz = chroma_ac_nz = False
    for name in ("cb", "cr"):
        pred = ref[name][cy0:cy0 + 8, cx0:cx0 + 8]
        cres = src[name][cy0:cy0 + 8, cx0:cx0 + 8] - pred
        cwdc = np.empty((2, 2), dtype=np.int64)
        cacz = {}
        for by in range(2):
            for bx in range(2):
                blk = cres[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
                t = _CF @ blk @ _CF.T
                cwdc[by, bx] = t[0, 0]
                z = _quant4x4_inter(t, qpc)
                z[0, 0] = 0
                cacz[(bx, by)] = z
        fdc = _H2 @ cwdc @ _H2
        cqbits = 15 + qpc // 6
        cf2 = 2 * ((1 << cqbits) // 6)
        czdc = np.sign(fdc) * ((np.abs(fdc) * _MF[qpc % 6][0] + cf2) >>
                               (cqbits + 1))
        np.clip(czdc, -_LEVEL_CLAMP, _LEVEL_CLAMP, out=czdc)
        if np.any(czdc):
            chroma_dc_nz = True
        if any(np.any(cacz[k]) for k in cacz):
            chroma_ac_nz = True
        cdata[name] = (pred, cacz, czdc)
    cbp_chroma = 2 if chroma_ac_nz else (1 if chroma_dc_nz else 0)
    cbp = cbp_luma | (cbp_chroma << 4)

    nby0, nbx0 = mby * 4 + 1, mbx * 4 + 1
    cny0, cnx0 = mby * 2 + 1, mbx * 2 + 1

    mb_w = inter_mask.shape[1] if inter_mask is not None else 0
    if (cbp == 0 and ref2 == 0
            and (part2 is None or part2[0] == 0)
            and (inter_mask is None or mv2 == _mvp_skip(
                mby, mbx, mv_coded, inter_mask, slice_top, mb_w))):
        # P_Skip: recon = the MC prediction (decoder MC at mvp_skip ==
        # our searched MV by the guard above); zero nC context
        out["y"][y0:y0 + 16, x0:x0 + 16] = pred_y
        for name in ("cb", "cr"):
            out[name][cy0:cy0 + 8, cx0:cx0 + 8] = cdata[name][0]
        lnnz[nby0:nby0 + 4, nbx0:nbx0 + 4] = 0
        cbnnz[cny0:cny0 + 2, cnx0:cnx0 + 2] = 0
        crnnz[cny0:cny0 + 2, cnx0:cnx0 + 2] = 0
        if inter_mask is not None:
            inter_mask[mby, mbx] = True
            mv_coded[mby, mbx] = mv2
        if mvq_coded is not None:
            mvq_coded[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = mv2
        if refq_coded is not None:
            refq_coded[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0
        if dbi is not None:  # P_Skip: no levels, mv = skip predictor
            if part2 is not None:   # quadrant-granular dbi fields
                dbi.mv[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = mv2
                dbi.ref[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0
            else:
                dbi.mv[mby, mbx] = mv2
        return skip_run + 1

    cost_inter = _cost(*lz.values(),
                       *(cdata[n][2] for n in ("cb", "cr")),
                       *(b for n in ("cb", "cr")
                         for b in cdata[n][1].values()))
    intra = _intra_candidate(mby, mbx, src, out, qp, qpc, top_ok,
                             left_ok)
    if intra["cost"] < cost_inter:
        _write_intra_in_p(w, mby, mbx, out, qp, qpc, skip_run, intra,
                          lnnz, cbnnz, crnnz, top_ok, left_ok)
        if dbi is not None:
            dbi.intra[mby, mbx] = True
        return 0

    # ---- coded inter MB: P_L0_16x16 or a partition mode
    w.ue(skip_run)             # mb_skip_run before this MB
    if part2 is not None:
        # partitioned write path (one slice per MB row): mb_type is
        # the pmode code, P_8x8 adds four sub_mb_type 0 (8x8), then
        # per-partition te(v) ref_idx (refs > 1) and one mvd per
        # partition against the reference-aware 8.4.1.3 predictors
        # collapsed for out-of-slice above rows (_mvp_parts)
        pmode, mv4, ref4 = (part2 if len(part2) == 3
                            else (*part2, None))
        w.ue(int(pmode))       # 0/1/2/3: 16x16 / 16x8 / 8x16 / 8x8
        if pmode == 3:
            for _ in range(4):
                w.ue(0)        # sub_mb_type: P_L0_8x8
        if active_refs > 1:
            for pidx, quads in _PART_QUADS[int(pmode)]:
                r = 0 if ref4 is None else int(ref4[quads[0]])
                if active_refs == 2:    # te(v): one INVERTED bit
                    w.u(1 - r, 1)
                else:
                    w.ue(r)
        left_avail = mbx > 0
        left_inter = left_avail and bool(inter_mask[mby, mbx - 1])
        lq1 = ((int(mvq_coded[2 * mby, 2 * mbx - 1, 0]),
                int(mvq_coded[2 * mby, 2 * mbx - 1, 1]))
               if left_inter else (0, 0))
        lq3 = ((int(mvq_coded[2 * mby + 1, 2 * mbx - 1, 0]),
                int(mvq_coded[2 * mby + 1, 2 * mbx - 1, 1]))
               if left_inter else (0, 0))
        lr1 = (int(refq_coded[2 * mby, 2 * mbx - 1])
               if (left_inter and refq_coded is not None) else 0)
        lr3 = (int(refq_coded[2 * mby + 1, 2 * mbx - 1])
               if (left_inter and refq_coded is not None) else 0)
        for pidx, quads in _PART_QUADS[int(pmode)]:
            q0 = quads[0]
            pmv = (int(mv4[q0][0]), int(mv4[q0][1]))
            myref = 0 if ref4 is None else int(ref4[q0])
            mvp = _mvp_parts(pidx, int(pmode), left_avail,
                             left_inter, lq1, lq3, mv4,
                             myref=myref, left_r1=lr1, left_r3=lr3,
                             ownref=ref4)
            w.se(pmv[1] - int(mvp[1])).se(pmv[0] - int(mvp[0]))
        for q in range(4):     # 8x8-granular coded-(MV, ref) context
            mvq_coded[2 * mby + q // 2, 2 * mbx + q % 2] = (
                int(mv4[q][0]), int(mv4[q][1]))
            if refq_coded is not None:
                refq_coded[2 * mby + q // 2, 2 * mbx + q % 2] = (
                    0 if ref4 is None else int(ref4[q]))
        inter_mask[mby, mbx] = True
        mv_coded[mby, mbx] = mv2
        if dbi is not None:     # quadrant-granular dbi fields
            for q in range(4):
                dbi.mv[2 * mby + q // 2, 2 * mbx + q % 2] = (
                    int(mv4[q][0]), int(mv4[q][1]))
                dbi.ref[2 * mby + q // 2, 2 * mbx + q % 2] = (
                    0 if ref4 is None else int(ref4[q]))
    else:
        w.ue(0)                # mb_type: P_L0_16x16
        if active_refs > 1:
            # ref_idx_l0 as te(v): with 2 active refs, one INVERTED
            # bit (spec 9.1.1: the coded bit is !codeNum); >2 = ue(v)
            if active_refs == 2:
                w.u(1 - ref2, 1)
            else:
                w.ue(ref2)
        if dbi is not None:  # coded inter: real mv/ref; nnz4 below
            dbi.mv[mby, mbx] = mv2
            dbi.ref[mby, mbx] = ref2
        # mvd in quarter-pel, horizontal component first (spec 7.3.5.1
        # compIdx order)
        if inter_mask is not None:
            mvp = _mvp_16x16(mby, mbx, mv_coded, inter_mask, slice_top,
                             mb_w)
            w.se(mv2[1] - mvp[1]).se(mv2[0] - mvp[0])
            inter_mask[mby, mbx] = True
            mv_coded[mby, mbx] = mv2
        else:
            w.se(0).se(0)
    if cbp == 0:
        # searched MV != skip predictor but the residual quantized to
        # zero: a 5-field MB (type + mvd + cbp), no residual syntax
        w.ue(int(_CBP_INTER_CODENUM[0]))
        out["y"][y0:y0 + 16, x0:x0 + 16] = pred_y
        for name in ("cb", "cr"):
            out[name][cy0:cy0 + 8, cx0:cx0 + 8] = cdata[name][0]
        lnnz[nby0:nby0 + 4, nbx0:nbx0 + 4] = 0
        cbnnz[cny0:cny0 + 2, cnx0:cnx0 + 2] = 0
        crnnz[cny0:cny0 + 2, cnx0:cnx0 + 2] = 0
        return 0
    w.ue(int(_CBP_INTER_CODENUM[cbp]))  # coded_block_pattern
    w.se(0)                    # mb_qp_delta (cbp != 0)

    # luma blocks of coded quadrants (all 16 coeffs, no DC split)
    for bx, by in _BLOCK_SCAN:
        q = (1 if bx >= 2 else 0) + (2 if by >= 2 else 0)
        if not (cbp_luma >> q) & 1:
            lnnz[nby0 + by, nbx0 + bx] = 0
            continue
        t_ok = top_ok if by == 0 else True
        l_ok = left_ok if bx == 0 else True
        if t_ok and l_ok:
            nc = (int(lnnz[nby0 + by, nbx0 + bx - 1]) +
                  int(lnnz[nby0 + by - 1, nbx0 + bx]) + 1) >> 1
        elif l_ok:
            nc = int(lnnz[nby0 + by, nbx0 + bx - 1])
        elif t_ok:
            nc = int(lnnz[nby0 + by - 1, nbx0 + bx])
        else:
            nc = 0
        flat = lz[(bx, by)].reshape(16)
        tc = _write_residual_block(
            w, [int(flat[i]) for i in _ZIGZAG], nc)
        lnnz[nby0 + by, nbx0 + bx] = tc
        if dbi is not None:
            dbi.nnz4[mby * 4 + by, mbx * 4 + bx] = tc != 0
    # chroma DC
    if cbp_chroma:
        for name in ("cb", "cr"):
            czdc = cdata[name][2]
            _write_residual_block(
                w, [int(czdc[0, 0]), int(czdc[0, 1]),
                    int(czdc[1, 0]), int(czdc[1, 1])], -1)
    # chroma AC
    _write_chroma_ac(w, mby, mbx, cdata, cbp_chroma, cbnnz, crnnz,
                     top_ok, left_ok)

    # ---- reconstruction: pred + dequantized residual, clipped
    for by in range(4):
        for bx in range(4):
            q = (1 if bx >= 2 else 0) + (2 if by >= 2 else 0)
            p = pred_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            if not (cbp_luma >> q) & 1:
                out["y"][y0 + by * 4:y0 + by * 4 + 4,
                         x0 + bx * 4:x0 + bx * 4 + 4] = p
                continue
            d = _dequant4x4(lz[(bx, by)], qp)
            r = (_inv4x4(d) + 32) >> 6
            out["y"][y0 + by * 4:y0 + by * 4 + 4,
                     x0 + bx * 4:x0 + bx * 4 + 4] = np.clip(
                r + p, 0, 255)
    for name in ("cb", "cr"):
        pred, cacz, czdc = cdata[name]
        cdcd = _chroma_dc_dequant(_H2 @ czdc @ _H2, qpc)
        for by in range(2):
            for bx in range(2):
                d = _dequant4x4(cacz[(bx, by)], qpc)
                d[0, 0] = cdcd[by, bx]
                r = (_inv4x4(d) + 32) >> 6
                out[name][cy0 + by * 4:cy0 + by * 4 + 4,
                          cx0 + bx * 4:cx0 + bx * 4 + 4] = np.clip(
                    r + pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4],
                    0, 255)
    return 0


def _write_chroma_ac(w: _BitWriter, mby: int, mbx: int, cdata: dict,
                     cbp_chroma: int, cbnnz: np.ndarray,
                     crnnz: np.ndarray, top_ok: bool,
                     left_ok: bool) -> None:
    """Chroma AC residual blocks + nC bookkeeping (shared by the inter
    and intra-in-P paths; ``cdata[name][1]`` is the cacz dict)."""
    cny0, cnx0 = mby * 2 + 1, mbx * 2 + 1
    for name in ("cb", "cr"):
        cnnz = cbnnz if name == "cb" else crnnz
        cacz = cdata[name][1]
        if cbp_chroma == 2:
            for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
                t_ok = top_ok if by == 0 else True
                l_ok = left_ok if bx == 0 else True
                if t_ok and l_ok:
                    nc = (int(cnnz[cny0 + by, cnx0 + bx - 1]) +
                          int(cnnz[cny0 + by - 1, cnx0 + bx]) + 1) >> 1
                elif l_ok:
                    nc = int(cnnz[cny0 + by, cnx0 + bx - 1])
                elif t_ok:
                    nc = int(cnnz[cny0 + by - 1, cnx0 + bx])
                else:
                    nc = 0
                flat = cacz[(bx, by)].reshape(16)
                tc = _write_residual_block(
                    w, [int(flat[i]) for i in _ZIGZAG[1:]], nc)
                cnnz[cny0 + by, cnx0 + bx] = tc
        else:
            cnnz[cny0:cny0 + 2, cnx0:cnx0 + 2] = 0


def _write_intra_in_p(w: _BitWriter, mby: int, mbx: int, out: dict,
                      qp: int, qpc: int, skip_run: int, intra: dict,
                      lnnz: np.ndarray, cbnnz: np.ndarray,
                      crnnz: np.ndarray, top_ok: bool,
                      left_ok: bool) -> None:
    """Emit one I_16x16 macroblock inside a P slice (mb_type offset +5,
    spec 7.4.5) and write its reconstruction."""
    from opencv_opencl_tpu_torch.io.h264_cavlc import (
        _H4, _luma_dc_dequant)

    y0, x0 = mby * 16, mbx * 16
    cy0, cx0 = mby * 8, mbx * 8
    acz, zdc, cdata = intra["acz"], intra["zdc"], intra["cdata"]
    cbp_luma, cbp_chroma = intra["cbp_luma"], intra["cbp_chroma"]

    w.ue(skip_run)
    mb_type_i = (1 + intra["predmode"] + 4 * cbp_chroma
                 + 12 * (1 if cbp_luma else 0))
    w.ue(5 + mb_type_i)        # intra types follow the 5 P types
    w.ue(0)                    # intra_chroma_pred_mode: DC
    w.se(0)                    # mb_qp_delta (always present, I_16x16)

    nby0, nbx0 = mby * 4 + 1, mbx * 4 + 1
    if top_ok and left_ok:
        nc = (int(lnnz[nby0, nbx0 - 1]) + int(lnnz[nby0 - 1, nbx0]) +
              1) >> 1
    elif left_ok:
        nc = int(lnnz[nby0, nbx0 - 1])
    elif top_ok:
        nc = int(lnnz[nby0 - 1, nbx0])
    else:
        nc = 0
    flat = zdc.reshape(16)
    _write_residual_block(w, [int(flat[i]) for i in _ZIGZAG], nc)
    if cbp_luma:
        for bx, by in _BLOCK_SCAN:
            t_ok = top_ok if by == 0 else True
            l_ok = left_ok if bx == 0 else True
            if t_ok and l_ok:
                nc = (int(lnnz[nby0 + by, nbx0 + bx - 1]) +
                      int(lnnz[nby0 + by - 1, nbx0 + bx]) + 1) >> 1
            elif l_ok:
                nc = int(lnnz[nby0 + by, nbx0 + bx - 1])
            elif t_ok:
                nc = int(lnnz[nby0 + by - 1, nbx0 + bx])
            else:
                nc = 0
            flat = acz[(bx, by)].reshape(16)
            tc = _write_residual_block(
                w, [int(flat[i]) for i in _ZIGZAG[1:]], nc)
            lnnz[nby0 + by, nbx0 + bx] = tc
    else:
        lnnz[nby0:nby0 + 4, nbx0:nbx0 + 4] = 0
    if cbp_chroma:
        for name in ("cb", "cr"):
            czdc = cdata[name][2]
            _write_residual_block(
                w, [int(czdc[0, 0]), int(czdc[0, 1]),
                    int(czdc[1, 0]), int(czdc[1, 1])], -1)
    _write_chroma_ac(w, mby, mbx, cdata, cbp_chroma, cbnnz, crnnz,
                     top_ok, left_ok)

    # reconstruction (identical to the I-slice path); pred is a scalar
    # (DC) or a (16, 1) column (HORIZONTAL) — slice the block's rows
    pred = intra["pred"]
    dcd = _luma_dc_dequant(_H4 @ zdc @ _H4, qp)
    for by in range(4):
        for bx in range(4):
            d = _dequant4x4(acz[(bx, by)], qp)
            d[0, 0] = dcd[by, bx]
            r = (_inv4x4(d) + 32) >> 6
            p_blk = (pred if np.isscalar(pred)
                     else pred[by * 4:by * 4 + 4])
            out["y"][y0 + by * 4:y0 + by * 4 + 4,
                     x0 + bx * 4:x0 + bx * 4 + 4] = np.clip(
                r + p_blk, 0, 255)
    for name in ("cb", "cr"):
        cpred, cacz, czdc = cdata[name]
        cdcd = _chroma_dc_dequant(_H2 @ czdc @ _H2, qpc)
        for by in range(2):
            for bx in range(2):
                d = _dequant4x4(cacz[(bx, by)], qpc)
                d[0, 0] = cdcd[by, bx]
                r = (_inv4x4(d) + 32) >> 6
                out[name][cy0 + by * 4:cy0 + by * 4 + 4,
                          cx0 + bx * 4:cx0 + bx * 4 + 4] = np.clip(
                    r + cpred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4],
                    0, 255)


class GopCavlcEncoder:
    """Low-delay-P GOP encoder (io.encoder protocol): IDR every ``gop``
    frames, zero-motion P pictures in between — the stream shape of the
    reference's ``gop-mode=low-delay-p periodicity-idr=240`` VCU tuning
    (``OpenCVequalHist.cpp:313-315``).

    SPS/PPS ride ahead of every IDR only (receivers join at GOP
    boundaries).  Rate control works on a sliding full-GOP window of AU
    sizes rather than per frame: a lone IDR over the per-frame budget is
    *expected* in GOP coding, so the controller reacts to the windowed
    mean (the first window passes uncontrolled while it fills).

    This is the Python oracle path; the per-frame cost is the intra
    oracle's for IDR frames plus the numpy P loop — the production
    paths are the TPU level programs (``--encoder=tpu:gop=N``) and the
    native entropy stage they feed.
    """

    codec = "h264"

    def __init__(self, width: int, height: int, qp: int = 30,
                 gop: int = 30, bitrate_kbps: int | None = None,
                 fps: float = 30.0, slices: int = 1,
                 search: int = 0, halfpel: bool = False,
                 quarterpel: bool = False, fastsub: bool = False,
                 refs: int = 1, parts: bool = False,
                 deblock: bool = False, gdr: int = 0,
                 cpb_ms: int | None = None,
                 initial_delay_ms: int | None = None,
                 i4: bool = False, chromah: bool = False) -> None:
        from opencv_opencl_tpu_torch.io.h264_cavlc import (
            CavlcH264Encoder, build_pps_cavlc)

        if gop < 1:
            raise ValueError(f"gop must be >= 1, got {gop}")
        # GDR horizontal intra refresh (gdr-mode=horizontal,
        # OpenCVequalHist.cpp:313,325): no IDRs after the first frame;
        # instead an intra MB-row band marches down the picture every
        # ``gdr`` frames, each wave start carrying SPS+PPS+recovery
        # point SEI.  Zero-motion P keeps the clean-region invariant
        # for mid-stream joiners automatically (co-located prediction
        # never reads below the co-located row).
        self.gdr = int(gdr)
        if self.gdr:
            mb_h = -(-height // 16)
            if self.gdr < 1:
                raise ValueError(f"gdr must be >= 1, got {gdr}")
            if refs > 1:
                raise ValueError("gdr requires refs=1")
            if max(1, min(int(slices), mb_h)) != mb_h:
                raise ValueError("gdr requires one slice per MB row "
                                 f"(slices={mb_h} here)")
            self._gdr_period = min(self.gdr, mb_h)
            self._gdr_rows = -(-mb_h // self._gdr_period)
            gop = 1 << 30  # one IDR ever; refresh rides the wave
        self.search = int(search)
        if fastsub and (halfpel or quarterpel):
            raise ValueError("fastsub replaces halfpel/quarterpel "
                             "(it IS a quarter-pel mode)")
        self.subpel = (3 if fastsub
                       else 2 if quarterpel else (1 if halfpel else 0))
        if (halfpel or quarterpel or fastsub) and not search:
            raise ValueError("halfpel/quarterpel/fastsub require "
                             "search=R > 0")
        if search:
            # fastsub validates the full-pel stage's radius (its
            # refinement count is a constant 49)
            search_candidates_qpel(search, 0 if fastsub
                                   else self.subpel)
        if not 1 <= refs <= 4:
            raise ValueError(f"refs must be in [1, 4], got {refs}")
        if refs > 1:
            if not search:
                raise ValueError("refs > 1 requires search=R > 0")
            mb_h = -(-height // 16)
            if max(1, min(int(slices), mb_h)) != mb_h:
                raise ValueError("refs > 1 requires one slice per MB "
                                 f"row (slices={mb_h} here)")
        self.refs = int(refs)
        # sub-16x16 inter partitions (16x8 / 8x16 / 8x8 with
        # per-partition mvd): encode_frame_p_slices(parts=True).
        # Composition limits mirror its checks so misconfigurations
        # fail at construction, not mid-stream.
        self.parts = bool(parts)
        if self.parts:
            if not search:
                raise ValueError("parts requires search=R > 0")
            if fastsub:
                raise ValueError("parts does not compose with fastsub")
            if gdr:
                raise ValueError("parts requires no gdr")
            if refs > 1 and quarterpel:
                # key-packing bound (motion_search_parts_multi)
                search_candidates_qpel(min(search, 8), 2)
                if refs * (8 * search + 1) ** 2 > SEARCH_KEY_RADIX:
                    raise ValueError(
                        "quarter-pel parts with refs=2 needs "
                        f"search <= 7, got {search}")
            mb_h = -(-height // 16)
            if max(1, min(int(slices), mb_h)) != mb_h:
                raise ValueError("parts requires one slice per MB row "
                                 f"(slices={mb_h} here)")
        # in-loop deblocking (spec 8.7, the VCU's actual output mode —
        # omx deblocking defaults, OpenCVequalHist.cpp:313-315): the
        # stream signals idc=0 and every reference picture is the
        # FILTERED reconstruction (io.h264_deblock); intra prediction
        # within a frame still reads unfiltered samples (spec 8.3).
        # GDR+deblock: the P slices signal idc=2 (slice-local — every
        # MB row is its own slice, so no sample crosses the refresh
        # wave); the IDR keeps idc=0.
        self.deblock = bool(deblock)
        self._deblock_slice_local = bool(self.gdr and deblock)
        # Intra_4x4 / chroma HORIZONTAL on IDR frames (``i4`` /
        # ``chromah``): the P-frame intra candidate stays I_16x16 with
        # DC chroma (the raster-free mode decision the device GOP
        # program needs — ops/h264_levels.encode_p_levels)
        self.i4 = bool(i4)
        self.chromah = bool(chromah)
        # reuse the intra encoder's padding + geometry checks
        self._intra = CavlcH264Encoder(width, height, qp=qp,
                                       native="never", slices=slices)
        self.width, self.height = width, height
        self.qp = int(qp)
        self.gop = int(gop)
        self.slices = int(slices)
        self.bitrate_kbps = bitrate_kbps
        self.fps = fps
        # CPB/HRD hard constraint (cpb-size/initial-delay,
        # OpenCVequalHist.cpp:313-314): leaky-bucket ceiling enforced
        # by re-encoding over-budget frames at higher QP
        self._cpb = None
        if cpb_ms is None and initial_delay_ms is not None:
            raise ValueError("initdelay requires cpb")
        if cpb_ms is not None:
            from opencv_opencl_tpu_torch.io.h264_hrd import CpbModel

            if not bitrate_kbps:
                raise ValueError(
                    "cpb needs bitrate control (bitrate_kbps), not a "
                    "fixed qp")
            self._cpb = CpbModel(
                bitrate_kbps, cpb_ms,
                cpb_ms // 2 if initial_delay_ms is None
                else initial_delay_ms, fps)
        self._sps = build_sps_gop(
            width, height, refs=self.refs,
            hrd=None if self._cpb is None else self._cpb.params)
        self._pps = build_pps_cavlc()
        self._idr_pic_id = 0
        self._frame_num = 0
        self._recon = None
        self.frames = 0
        self._au_window: list[int] = []

    def _encode_at(self, padded, w16: int, h16: int, qp: int):
        """Encode the current frame at ``qp`` WITHOUT committing any
        encoder state (the CPB loop may retry at a higher QP).
        Returns (au, recon, dbi, is_idr)."""
        from opencv_opencl_tpu_torch.io.h264_cavlc import (
            encode_frame_cavlc_slices)
        from opencv_opencl_tpu_torch.io.h264_pcm import _START4

        dbi = None
        is_idr = self.frames % self.gop == 0
        if is_idr:
            nals, recon = encode_frame_cavlc_slices(
                padded, w16, h16, qp, idr_pic_id=self._idr_pic_id,
                slices=self.slices, return_recon=True,
                deblock=self.deblock, i4=self.i4,
                chromah=self.chromah)
            au = (_START4 + self._sps + _START4 + self._pps +
                  b"".join(_START4 + bytes(n) for n in nals))
        else:
            refarg = (self._ref_list[:self.refs] if self.refs > 1
                      else self._recon)
            if self.deblock:
                from opencv_opencl_tpu_torch.io.h264_deblock import DeblockInfo

                dbi = DeblockInfo(h16 // 16, w16 // 16,
                                  parts=self.parts)
            band = None
            prefix = b""
            if self.gdr:
                m = (self.frames - 1) % self._gdr_period
                band = (m * self._gdr_rows,
                        min((m + 1) * self._gdr_rows, h16 // 16))
                if m == 0:
                    # wave start: a mid-stream joiner needs parameter
                    # sets + the recovery point marker
                    prefix = (_START4 + self._sps + _START4 + self._pps
                              + _START4 + build_recovery_point_sei(
                                  self._gdr_period - 1))
            nals, recon = encode_frame_p_slices(
                padded, refarg, w16, h16, qp,
                frame_num=self._frame_num, slices=self.slices,
                return_recon=True, search=self.search,
                subpel=self.subpel, deblock=self.deblock,
                deblock_info=dbi, force_intra_rows=band,
                slice_local=self._deblock_slice_local,
                parts=self.parts)
            au = prefix + b"".join(_START4 + bytes(n) for n in nals)
        return au, recon, dbi, is_idr

    def encode(self, nv12: np.ndarray) -> list[bytes]:
        rows = self.height * 3 // 2
        arr = np.asarray(nv12, dtype=np.uint8).reshape(rows, self.width)
        padded, w16, h16 = self._intra._pad(arr)
        qp = self.qp
        while True:
            au, recon, dbi, is_idr = self._encode_at(padded, w16, h16,
                                                     qp)
            if self._cpb is None or qp >= 51:
                break
            budget = self._cpb.budget_bits()
            if 8 * len(au) <= budget:
                break
            qp = self._intra._cpb_bump(qp, 8 * len(au), budget)
        if self._cpb is not None:
            self._cpb.add_frame(8 * len(au))
            self.qp = qp  # the forced QP carries forward
        # ---- commit
        if is_idr:
            self._idr_pic_id ^= 1
            self._frame_num = 1
            self._ref_list = []  # IDR flushes the DPB
        else:
            self._frame_num = (self._frame_num + 1) % 16
        if self.deblock:
            from opencv_opencl_tpu_torch.io.h264_deblock import deblock_picture

            # the reference chain (and the decoder's display picture)
            # is the FILTERED reconstruction; dbi=None == all-intra
            # IDR.  GDR P pictures filter slice-locally (idc=2); the
            # IDR's slices signal idc=0, so it filters normally.
            recon = deblock_picture(
                *recon, qp, dbi,
                slice_local_rows=(self._deblock_slice_local
                                  and not is_idr))
        self._recon = recon
        self._ref_list = ([recon] + getattr(self, "_ref_list", [])
                          )[:self.refs]
        self.frames += 1
        if self.bitrate_kbps:
            self._rate_control(len(au))
        return [au]

    def _rate_control(self, used: int) -> None:
        _gop_rate_control(self, used)  # shared sliding-window control

    def flush(self) -> list[bytes]:
        return []

    def close(self) -> None:
        pass


def encode_frame_p_from_levels(mode: np.ndarray, zdc: np.ndarray,
                               acz: np.ndarray, czdc: np.ndarray,
                               cacz: np.ndarray, qp: int,
                               frame_num: int,
                               mv: np.ndarray | None = None,
                               ref: np.ndarray | None = None,
                               active_refs: int = 1,
                               deblock: bool = False,
                               slice_local: bool = False,
                               pmode: np.ndarray | None = None
                               ) -> list[bytes]:
    """Entropy-code one P frame from PLevelArrays-layout arrays
    (ops/h264_levels.encode_p_levels) into one slice NAL per MB row —
    the TPU program's slice granularity.  Byte-identical to
    ``encode_frame_p_slices(..., slices=mb_h)``
    (tests/test_h264_inter_tpu.py); this is the CPU stage of the TPU
    GOP path.

    ``mv`` is the (mb_h, mb_w, 2) (dy, dx) QUARTER-pel field from the
    device motion search (None == all-zero).  With one slice per MB
    row the
    8.4.1.3 predictor collapses to the left-only rule: mvp = the left
    MB's MV when it is inter (P_Skip MBs carry (0, 0) — skip is
    restricted to the zero predictor), (0, 0) after an intra MB or at
    the row start.

    ``pmode`` (the partition configuration, encode_p_levels parts=1):
    per-MB partition mode in {0: 16x16, 1: 16x8, 2: 8x16, 3: 8x8} and
    ``mv`` is the quadrant-major (mb_h, mb_w, 4, 2) field; mvd uses
    the :func:`_mvp_parts` predictor collapse."""
    mb_h, mb_w = mode.shape[:2]
    nals = []
    for mby in range(mb_h):
        w = _BitWriter()
        _slice_head_p(w, qp, frame_num, first_mb=mby * mb_w,
                      active_refs=active_refs, deblock=deblock,
                      slice_local=slice_local)
        lnnz = np.zeros((4, mb_w * 4 + 1), dtype=np.int64)
        cbnnz = np.zeros((2, mb_w * 2 + 1), dtype=np.int64)
        crnnz = np.zeros_like(cbnnz)
        skip_run = 0
        left_mv = None  # (dy, dx) of the left MB when inter, else None
        # parts context: the left MB's right-edge quadrant MVs + refs
        left_inter, lq1, lq3 = False, (0, 0), (0, 0)
        lr1 = lr3 = 0
        for mbx in range(mb_w):
            m = int(mode[mby, mbx])
            nbx0 = mbx * 4 + 1
            cnx0 = mbx * 2 + 1
            left_ok = mbx > 0
            if m == 0:
                skip_run += 1
                left_mv = (0, 0)
                left_inter, lq1, lq3 = True, (0, 0), (0, 0)
                lr1 = lr3 = 0
                lnnz[:, nbx0:nbx0 + 4] = 0
                cbnnz[:, cnx0:cnx0 + 2] = 0
                crnnz[:, cnx0:cnx0 + 2] = 0
                continue
            a = acz[mby, mbx]            # (16, 16) [by*4+bx][raster]
            ca = cacz[mby, mbx]          # (2, 4, 16)
            cd = czdc[mby, mbx]          # (2, 4)
            cbp_chroma = 2 if np.any(ca) else (1 if np.any(cd) else 0)
            w.ue(skip_run)
            skip_run = 0
            if m in (2, 3):
                left_mv = None
                left_inter = False
                # I_16x16 inside the P slice (mb_type offset +5);
                # mode 3 = HORIZONTAL prediction, 2 = DC
                cbp_luma = bool(np.any(a))
                w.ue(5 + 1 + (1 if m == 3 else 2) + 4 * cbp_chroma +
                     12 * (1 if cbp_luma else 0))
                w.ue(0)          # intra_chroma_pred_mode: DC
                w.se(0)          # mb_qp_delta
                nc = int(lnnz[0, nbx0 - 1]) if left_ok else 0
                dcflat = zdc[mby, mbx]
                _write_residual_block(
                    w, [int(dcflat[i]) for i in _ZIGZAG], nc)
                if cbp_luma:
                    for bx, by in _BLOCK_SCAN:
                        l_ok = left_ok if bx == 0 else True
                        if by == 0:
                            nc = (int(lnnz[0, nbx0 + bx - 1])
                                  if l_ok else 0)
                        else:
                            na = (int(lnnz[by, nbx0 + bx - 1])
                                  if l_ok else None)
                            nb = int(lnnz[by - 1, nbx0 + bx])
                            nc = ((na + nb + 1) >> 1
                                  if na is not None else nb)
                        flat = a[by * 4 + bx]
                        tc = _write_residual_block(
                            w, [int(flat[i]) for i in _ZIGZAG[1:]], nc)
                        lnnz[by, nbx0 + bx] = tc
                else:
                    lnnz[:, nbx0:nbx0 + 4] = 0
            else:
                # P_L0_16x16; full 4x4 residual blocks
                cbp_luma_bits = 0
                for by in range(4):
                    for bx in range(4):
                        if np.any(a[by * 4 + bx]):
                            q = (1 if bx >= 2 else 0) + \
                                (2 if by >= 2 else 0)
                            cbp_luma_bits |= 1 << q
                cbp = cbp_luma_bits | (cbp_chroma << 4)
                if pmode is not None:
                    # partitioned MB: mb_type = pmode, P_8x8 adds four
                    # sub_mb_type 0, per-partition te(v) ref_idx
                    # (refs > 1), one mvd per partition against the
                    # reference-aware predictor collapse (_mvp_parts)
                    pm = int(pmode[mby, mbx])
                    m4 = mv[mby, mbx]                       # (4, 2)
                    r4 = (ref[mby, mbx] if (active_refs > 1
                                            and ref is not None)
                          else None)
                    w.ue(pm)
                    if pm == 3:
                        for _ in range(4):
                            w.ue(0)          # sub_mb_type: P_L0_8x8
                    if active_refs > 1:
                        for pidx, quads in _PART_QUADS[pm]:
                            r = 0 if r4 is None else int(r4[quads[0]])
                            if active_refs == 2:
                                w.u(1 - r, 1)
                            else:
                                w.ue(r)
                    for pidx, quads in _PART_QUADS[pm]:
                        q0 = quads[0]
                        pmv = (int(m4[q0][0]), int(m4[q0][1]))
                        myref = 0 if r4 is None else int(r4[q0])
                        mvp = _mvp_parts(pidx, pm, left_ok,
                                         left_inter, lq1, lq3, m4,
                                         myref=myref, left_r1=lr1,
                                         left_r3=lr3, ownref=r4)
                        w.se(pmv[1] - int(mvp[1])).se(
                            pmv[0] - int(mvp[0]))
                    left_inter = True
                    lq1 = (int(m4[1][0]), int(m4[1][1]))
                    lq3 = (int(m4[3][0]), int(m4[3][1]))
                    lr1 = 0 if r4 is None else int(r4[1])
                    lr3 = 0 if r4 is None else int(r4[3])
                else:
                    w.ue(0)
                    if active_refs > 1:
                        r2 = (int(ref[mby, mbx]) if ref is not None
                              else 0)
                        if active_refs == 2:
                            w.u(1 - r2, 1)  # te(v): one inverted bit
                        else:
                            w.ue(r2)
                    dy, dx = ((int(mv[mby, mbx, 0]),
                               int(mv[mby, mbx, 1]))
                              if mv is not None else (0, 0))
                    mvp = left_mv if left_mv is not None else (0, 0)
                    w.se(dx - mvp[1]).se(dy - mvp[0])
                    left_mv = (dy, dx)
                w.ue(int(_CBP_INTER_CODENUM[cbp]))
                if cbp:
                    w.se(0)    # mb_qp_delta (only when cbp != 0)
                for bx, by in _BLOCK_SCAN:
                    q = (1 if bx >= 2 else 0) + (2 if by >= 2 else 0)
                    if not (cbp_luma_bits >> q) & 1:
                        lnnz[by, nbx0 + bx] = 0
                        continue
                    l_ok = left_ok if bx == 0 else True
                    if by == 0:
                        nc = int(lnnz[0, nbx0 + bx - 1]) if l_ok else 0
                    else:
                        na = (int(lnnz[by, nbx0 + bx - 1])
                              if l_ok else None)
                        nb = int(lnnz[by - 1, nbx0 + bx])
                        nc = (na + nb + 1) >> 1 if na is not None else nb
                    flat = a[by * 4 + bx]
                    tc = _write_residual_block(
                        w, [int(flat[i]) for i in _ZIGZAG], nc)
                    lnnz[by, nbx0 + bx] = tc
            if cbp_chroma:
                for comp in range(2):
                    _write_residual_block(
                        w, [int(v) for v in cd[comp]], -1)
            for comp in range(2):
                cnnz = cbnnz if comp == 0 else crnnz
                if cbp_chroma == 2:
                    for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
                        l_ok = left_ok if bx == 0 else True
                        if by == 0:
                            nc = (int(cnnz[0, cnx0 + bx - 1])
                                  if l_ok else 0)
                        else:
                            na = (int(cnnz[by, cnx0 + bx - 1])
                                  if l_ok else None)
                            nb = int(cnnz[by - 1, cnx0 + bx])
                            nc = ((na + nb + 1) >> 1
                                  if na is not None else nb)
                        flat = ca[comp, by * 2 + bx]
                        tc = _write_residual_block(
                            w, [int(flat[i]) for i in _ZIGZAG[1:]], nc)
                        cnnz[by, cnx0 + bx] = tc
                else:
                    cnnz[:, cnx0:cnx0 + 2] = 0
        if skip_run:
            w.ue(skip_run)
        w.trailing()
        nals.append(bytes(
            _escape(np.frombuffer(w.bytes(), dtype=np.uint8))))
    return nals


def _gop_rate_control(enc, used: int) -> None:
    """Sliding full-GOP-window proportional QP control shared by the
    GOP encoders: a lone IDR over the per-frame budget is EXPECTED, so
    react only to the windowed mean (first window passes uncontrolled
    while it fills)."""
    # GDR streams have no GOP; their homogeneous cost period is the
    # refresh wave (one intra band per frame), so control over that
    win = enc._gdr_period if getattr(enc, "gdr", 0) else enc.gop
    enc._au_window.append(used)
    if len(enc._au_window) > win:
        enc._au_window.pop(0)
    if len(enc._au_window) < win:
        return
    mean = sum(enc._au_window) / len(enc._au_window)
    target = enc.bitrate_kbps * 1000 / 8 / enc.fps
    if mean > 1.15 * target or mean < 0.85 * target:
        import math

        delta = round(6 * math.log2(mean / target))
        enc.qp = min(51, max(10, enc.qp + min(6, max(-3, delta))))



class CudaGopEncoder:
    """Low-delay-P GOP encoder with the pixel arithmetic on the card and the
    reference pictures in device memory (io.encoder protocol;
    ``--encoder=tpu:gop=N`` / ``tpu:gdr=N``; the JAX package's
    ``TpuGopEncoder``).

    Per frame: at a GOP start H1 with the full reconstruction
    (ops/h264_levels.encode_levels: the split grids ``levels_split_kernel``,
    ``levels_chain_kernel`` and ``levels_intra_kernel``); otherwise, with
    ``search``, ``subpel_planes_kernel`` and ``motion_search_kernel``, then
    H2 (the same three grids with the inter candidate: the per-MB skip /
    inter / intra decision);
    ``deblock_kernel`` then filters the new reference in place.  Only the
    levels (one int16 buffer a frame, with the mode, MV and reference
    fields) come down to the host, which does the entropy coding (the
    native ``cavlc_entropy_rows_p`` rows, or ``encode_frame_p_from_levels``
    where the library does not build).  The reconstruction chain never
    leaves the card.  Streams are byte-identical to
    ``GopCavlcEncoder(slices=mb_h)``.

    It runs on the card unless ``device="cpu"`` (the kernels' plain
    versions, for the tests); with no device and no card it raises.

    ``overlap=True`` adds the depth-1 pipeline of ``CudaCavlcEncoder``: the
    card computes frame N while the host entropy-codes frame N-1 (one frame
    of latency, bytes unchanged; ``flush`` drains the tail).  ``cpb_ms``
    re-encodes a frame over the leaky-bucket budget at a higher QP from a
    snapshot of the chain: the kernels never write a reference picture in
    place, so the snapshot stays valid.

    ``parts=True`` adds the sub-16x16 partitions (16x8, 8x16, 8x8):
    ``parts_search_kernel`` in place of ``motion_search_kernel``, the
    partition modes and the quadrant fields in the level buffer, the
    filter's boundary strengths a quadrant; it needs ``search`` and does
    not compose with ``fastsub``, ``gdr`` or ``cpb`` (as the reference).
    ``bitpack=True`` packs every MB's CAVLC bits on the card
    (``pack_i_kernel`` for IDR frames, ``pack_p_kernel`` for P frames);
    the host fetches the words (``nw_mb`` a MB), the bit counts and the
    mode row and writes the slice headers and trailing skip runs.  A frame
    where an MB overflows the ``nw_mb`` words goes through the host entropy
    path from its levels, fetched then (byte-identical; counted in
    ``_bits_overflows``).
    """

    codec = "h264"

    def __init__(self, width: int, height: int, qp: int = 30,
                 gop: int = 30, bitrate_kbps: int | None = None,
                 fps: float = 30.0, native: str = "auto",
                 threads: int = 0, overlap: bool = False,
                 search: int = 0, halfpel: bool = False,
                 quarterpel: bool = False, fastsub: bool = False,
                 refs: int = 1, parts: bool = False,
                 deblock: bool = False, gdr: int = 0,
                 bitpack: bool = False, nw_mb: int = 64,
                 cpb_ms: int | None = None,
                 initial_delay_ms: int | None = None,
                 i4: bool = False, chromah: bool = False,
                 device=None) -> None:
        import torch

        from opencv_opencl_tpu_torch.io.h264_cavlc import CudaCavlcEncoder

        if gop < 1:
            raise ValueError(f"gop must be >= 1, got {gop}")
        # Intra_4x4 / chroma HORIZONTAL on IDR frames (the P-frame intra
        # candidate stays I_16x16 with DC chroma)
        self.i4 = bool(i4)
        self.chromah = bool(chromah)
        # GDR horizontal intra refresh: the wave band rides into the P
        # kernel as two ints
        self.gdr = int(gdr)
        if self.gdr:
            if refs > 1:
                raise ValueError("gdr requires refs=1")
            mb_h = -(-height // 16)
            self._gdr_period = min(self.gdr, mb_h)
            self._gdr_rows = -(-mb_h // self._gdr_period)
            gop = 1 << 30  # one IDR ever; refresh rides the wave
        self.search = int(search)
        if fastsub and (halfpel or quarterpel):
            raise ValueError("fastsub replaces halfpel/quarterpel "
                             "(it IS a quarter-pel mode)")
        self.subpel = (3 if fastsub
                       else 2 if quarterpel else (1 if halfpel else 0))
        if (halfpel or quarterpel or fastsub) and not search:
            raise ValueError("halfpel/quarterpel/fastsub require "
                             "search=R > 0")
        if search:
            search_candidates_qpel(search, 0 if fastsub else self.subpel)
        if not 1 <= refs <= 2:
            raise ValueError(
                f"TPU GOP refs must be 1 or 2, got {refs}")
        if refs > 1 and not search:
            raise ValueError("refs > 1 requires search=R > 0")
        self.refs = int(refs)
        # sub-16x16 inter partitions (ops/h264_levels parts=1): the level
        # buffer carries the partition modes and the quadrant fields
        self.parts = bool(parts)
        if self.parts:
            if not search:
                raise ValueError("parts requires search=R > 0")
            if fastsub:
                raise ValueError("parts does not compose with fastsub")
            if gdr:
                raise ValueError("parts requires no gdr")
            if refs > 1 and quarterpel and (
                    refs * (8 * search + 1) ** 2 > SEARCH_KEY_RADIX):
                raise ValueError(
                    "quarter-pel parts with refs=2 needs search <= 7, "
                    f"got {search}")
            if cpb_ms is not None:
                raise ValueError("parts does not compose with cpb")
        if cpb_ms is None and initial_delay_ms is not None:
            raise ValueError("initdelay requires cpb")
        if cpb_ms is not None:
            if not bitrate_kbps:
                raise ValueError(
                    "cpb needs bitrate control (bitrate_kbps), not a "
                    "fixed qp")
            if overlap:
                raise ValueError(
                    "cpb does not compose with overlap (the CPB "
                    "re-encode loop is synchronous per frame)")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaGopEncoder runs on the card and torch.cuda.is_available() "
                "is false; device='cpu' runs the kernels' plain versions")
        # the intra machinery (padding, native/Python entropy, parameter
        # sets) is the intra device encoder's, with the GOP SPS
        self._intra = CudaCavlcEncoder(width, height, qp=qp, native=native,
                                       threads=threads, deblock=deblock,
                                       device=self.device)
        self.width, self.height = width, height
        self.qp = int(qp)
        self.gop = int(gop)
        self.bitrate_kbps = bitrate_kbps
        self.fps = fps
        self.frames = 0
        self._frame_num = 0
        self._recon = None
        self._ref_list: list = []
        self._au_window: list[int] = []
        self._overlap = bool(overlap)
        self._pending = None
        self._cpb = None
        if cpb_ms is not None:
            from opencv_opencl_tpu_torch.io.h264_hrd import CpbModel

            self._cpb = CpbModel(
                bitrate_kbps, cpb_ms,
                cpb_ms // 2 if initial_delay_ms is None
                else initial_delay_ms, fps)
        self._intra._sps = build_sps_gop(
            width, height, refs=self.refs,
            hrd=None if self._cpb is None else self._cpb.params)
        # in-loop deblocking: every reference picture is the filtered
        # reconstruction, filtered on the card; GDR + deblock filters P
        # pictures slice-locally (idc=2), the IDR keeps idc=0
        self.deblock = bool(deblock)
        self._deblock_slice_local = bool(self.gdr and deblock)
        # the device bit packer (ops/h264_bitpack.py): IDR frames pack on
        # pack_i_kernel, P frames on pack_p_kernel; the host fetches the
        # words, the bit counts and the mode row (the P slice's trailing
        # skip run), and the levels only where an MB overflowed nw_mb words
        # (that frame is coded on the host entropy path, counted in
        # _bits_overflows)
        self._bitpack = bool(bitpack)
        self._nw_mb = int(nw_mb)
        self._bits_overflows = 0
        # P frames since the last IDR of encode_from_packed's stream
        self._since_idr = 0
        self._card: dict = {}      # the card's buffers, by geometry
        self._slots: list[dict] = []
        self._flip = 0

    # ------------------------------------------------------------ card --

    def _buffers(self, rows: int, w16: int, h16: int) -> dict:
        """The per-geometry device buffers and the two pinned slots
        (upload, levels, event), made at the first frame."""
        import torch

        from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kl

        key = (rows, w16)
        if self._card.get("key") != key:
            mb_h, mb_w = h16 // 16, w16 // 16
            dev = self.device
            words = max(kl.level_words(mb_h, mb_w, self.i4, self.chromah),
                        kl.p_level_words(mb_h, mb_w, self.parts))
            self._card = {
                "key": key,
                "frame": torch.empty((rows, w16), dtype=torch.uint8, device=dev),
                "intra": torch.empty(kl.level_words(mb_h, mb_w, self.i4, self.chromah),
                                     dtype=torch.int16, device=dev),
                "p": torch.empty(kl.p_level_words(mb_h, mb_w, self.parts),
                                 dtype=torch.int16, device=dev),
                "pred": (torch.empty((h16, w16), dtype=torch.uint8, device=dev),
                         torch.empty((h16 // 2, w16 // 2), dtype=torch.uint8, device=dev),
                         torch.empty((h16 // 2, w16 // 2), dtype=torch.uint8, device=dev)),
                # the all-intra metadata of an IDR picture's filter
                "idr_intra": torch.ones((mb_h, mb_w), dtype=torch.uint8, device=dev),
                "idr_nnz": torch.zeros((4 * mb_h, 4 * mb_w), dtype=torch.uint8, device=dev),
            }
            self._slots = [{"frame": torch.empty((rows, w16), dtype=torch.uint8,
                                                 pin_memory=True),
                            "levels": torch.empty(words, dtype=torch.int16,
                                                  pin_memory=True),
                            "event": None} for _ in range(2)]
            if self._bitpack:
                # a frame's levels stay on the card until it is coded: a
                # level buffer of each kind a slot
                for slot in self._slots:
                    slot.update(
                        intra_dev=torch.empty_like(self._card["intra"]),
                        p_dev=torch.empty_like(self._card["p"]),
                        words_dev=torch.empty((mb_h, mb_w, self._nw_mb),
                                              dtype=torch.uint32, device=dev),
                        nbits_dev=torch.empty((mb_h, mb_w), dtype=torch.int32, device=dev),
                        words=torch.empty((mb_h, mb_w, self._nw_mb), dtype=torch.uint32,
                                          pin_memory=True),
                        nbits=torch.empty((mb_h, mb_w), dtype=torch.int32, pin_memory=True),
                        mode=torch.empty((mb_h, mb_w), dtype=torch.int16, pin_memory=True))
        return self._card

    def _upload(self, padded: np.ndarray, h16: int, w16: int):
        """The padded frame on the device: (y, cb, cr) views and, on the
        card, the pinned slot this frame's levels come back into."""
        import torch

        if self.device.type != "cuda":
            frame = torch.from_numpy(np.array(padded, copy=True)).to(self.device)
            slot = None
        else:
            card = self._buffers(padded.shape[0], w16, h16)
            slot = self._slots[self._flip]
            self._flip ^= 1
            if slot["event"] is not None:
                slot["event"].synchronize()   # its upload and copy are done
            np.copyto(slot["frame"].numpy(), padded)
            frame = card["frame"]
            frame.copy_(slot["frame"], non_blocking=True)
        uv = frame[h16:].view(h16 // 2, w16 // 2, 2)
        return frame[:h16], uv[:, :, 0], uv[:, :, 1], slot

    def _download(self, slot, flat, split):
        """Start the levels' copy into the slot's pinned buffer: (event,
        the levels by name as host arrays, valid once the event has
        completed)."""
        import torch

        n = flat.numel()
        slot["levels"][:n].copy_(flat, non_blocking=True)
        slot["event"] = torch.cuda.Event()
        slot["event"].record(torch.cuda.current_stream(self.device))
        return slot["event"], split(slot["levels"].numpy()[:n])

    def _download_bits(self, slot, flat, split, mode=None):
        """Start the copy of the slot's packed words and bit counts (and the
        P frame's ``mode`` row) into its pinned buffers: (event, the host
        views, and ``levels``, which fetches the levels in ``flat``)."""
        import torch

        slot["words"].copy_(slot["words_dev"], non_blocking=True)
        slot["nbits"].copy_(slot["nbits_dev"], non_blocking=True)
        if mode is not None:
            slot["mode"].copy_(mode, non_blocking=True)
        slot["event"] = torch.cuda.Event()
        slot["event"].record(torch.cuda.current_stream(self.device))
        n = flat.numel()

        def fetch():
            # an MB overflowed the cap: the levels come down after all
            slot["levels"][:n].copy_(flat)
            return split(slot["levels"].numpy()[:n])

        return slot["event"], {"words": slot["words"].numpy(),
                               "nbits": slot["nbits"].numpy(),
                               "mode": slot["mode"].numpy(), "levels": fetch}

    def _host_bits(self, words, nbits, host: dict, mode=None):
        """The CPU path's handle with the packed bits."""
        return None, {"words": words.numpy(), "nbits": nbits.numpy(),
                      "mode": None if mode is None else mode.numpy(),
                      "levels": lambda: host}

    def _deblocked(self, recon, qp: int, intra, nnz4, mv=None, ref=None,
                   slice_local: bool = False):
        """The filtered reference: in place on the card (the recon is the
        frame's own, fresh), a new picture on the CPU."""
        from opencv_opencl_tpu_torch.ops import h264_deblock
        from opencv_opencl_tpu_torch.ops.cuda import h264_deblock as kd

        if self.device.type == "cuda":
            kd.deblock_into(*recon, qp, intra, nnz4, mv, ref, slice_local=slice_local)
            return recon
        import torch

        mb_h, mb_w = intra.shape
        if mv is None:
            mv = torch.zeros((mb_h, mb_w, 2), dtype=torch.int16)
        if ref is None:
            ref = torch.zeros(mv.shape[:2], dtype=torch.int16)
        return h264_deblock.deblock_planes_plain(*recon, qp, intra, nnz4, mv, ref,
                                                 slice_local=slice_local)

    # --------------------------------------------------------- encoding --

    def _dispatch(self, nv12: np.ndarray, qp_override: int | None = None):
        """Launch one frame's kernels and start its levels' copy; returns
        the pending tuple (kind, levels handle, number, qp, active
        references, prefix).  ``qp_override`` serves the CPB loop."""
        from opencv_opencl_tpu_torch.ops import h264_deblock
        from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as kb
        from opencv_opencl_tpu_torch.ops.cuda import h264_inter as ki
        from opencv_opencl_tpu_torch.ops.cuda import h264_levels as kl

        rows = self.height * 3 // 2
        arr = np.asarray(nv12, dtype=np.uint8).reshape(rows, self.width)
        padded, w16, h16 = self._intra._pad(arr)
        mb_h, mb_w = h16 // 16, w16 // 16
        y, cb, cr, slot = self._upload(padded, h16, w16)
        qp = self.qp if qp_override is None else qp_override
        card = self.device.type == "cuda"
        prefix = b""
        if self.frames % self.gop == 0:
            if card:
                out = slot["intra_dev"] if self._bitpack else self._card["intra"]
                recon = kl.intra_levels(y, cb, cr, qp, out, full_recon=True,
                                        i4=self.i4, chromah=self.chromah)

                def split(a):
                    return kl.split_levels(a, mb_h, mb_w, self.i4, self.chromah)

                if self._bitpack:
                    v = split(out)
                    kb.pack_i_into(v["zdc"], v["acz"], v["czdc"], v["cacz"], v["imode"],
                                   slot["words_dev"], slot["nbits_dev"], v.get("i4modes"),
                                   v.get("cmode"))
                    handle = self._download_bits(slot, out, split)
                else:
                    handle = self._download(slot, out, split)
                intra, nnz4 = self._card["idr_intra"], self._card["idr_nnz"]
            else:
                import torch

                lv, ry, rcb, rcr, imode, *extra = kl.encode_levels(
                    y, cb, cr, qp, full_recon=True, i4=self.i4,
                    chromah=self.chromah)
                recon = (ry, rcb, rcr)
                names = ["i4modes"] * self.i4 + ["cmode"] * self.chromah
                host = {**{k: a.numpy() for k, a in zip(lv._fields, lv)},
                        "imode": imode.numpy(),
                        **{k: a.numpy() for k, a in zip(names, extra)}}
                handle = (None, host)
                if self._bitpack:
                    ex = dict(zip(names, extra))
                    handle = self._host_bits(*kb.pack_i_mbs(
                        *lv, imode, self._nw_mb, ex.get("i4modes"), ex.get("cmode")), host)
                intra = torch.ones((mb_h, mb_w), dtype=torch.bool)
                nnz4 = torch.zeros((4 * mb_h, 4 * mb_w), dtype=torch.bool)
            recon = tuple(recon)
            if self.deblock:
                recon = self._deblocked(recon, qp, intra, nnz4)
            self._recon = recon
            self._ref_list = [recon]
            num = self._intra._idr_pic_id
            self._intra._idr_pic_id ^= 1
            self._frame_num = 1
            pending = ("i", handle, num, qp, 1, b"")
        else:
            two = self.refs > 1 and len(self._ref_list) >= 2
            refs = self._ref_list[:2] if two else [self._recon]
            active = 2 if two else 1
            band = None
            if self.gdr:
                m = (self.frames - 1) % self._gdr_period
                band = (m * self._gdr_rows, min((m + 1) * self._gdr_rows, mb_h))
                if m == 0:
                    prefix = (_START4 + self._intra._sps + _START4 +
                              self._intra._pps + _START4 +
                              build_recovery_point_sei(self._gdr_period - 1))
            if card:
                out = slot["p_dev"] if self._bitpack else self._card["p"]
                fields = kl.split_p_levels(out, mb_h, mb_w, self.parts)
                pred = refs[0]
                if self.parts:
                    pred = self._card["pred"]
                    ki.parts_search_into(y, refs, self.search, self.subpel, qp,
                                         fields["pmode"], fields["mv"],
                                         fields["ref"] if two else None, *pred)
                elif self.search:
                    pred = self._card["pred"]
                    ki.search_into(y, refs, self.search, self.subpel,
                                   None if band is None else band[0],
                                   fields["mv"], fields["ref"] if two else None, *pred)
                recon = kl.p_levels_into(y, cb, cr, *pred, qp, out,
                                         motion=self.search > 0, two_refs=two,
                                         band=band, parts=self.parts)
                mode, acz = fields["mode"], fields["acz"]
                mv = fields["mv"] if self.search else None
                ref = fields["ref"] if two else None

                def split(a):
                    return kl.split_p_levels(a, mb_h, mb_w, self.parts)

                if self._bitpack:
                    kb.pack_p_into(*self._pack_p_args(fields, mv, ref, active),
                                   slot["words_dev"], slot["nbits_dev"],
                                   **self._pack_p_parts(fields, ref))
                    handle = self._download_bits(slot, out, split, mode)
                else:
                    handle = self._download(slot, out, split)
            else:
                second = refs[1] if two else (None, None, None)
                plv = kl.encode_p_levels(y, cb, cr, *refs[0], qp, self.search,
                                         self.subpel, *second, gdr_band=band,
                                         parts=int(self.parts))
                recon = (plv.recon_y, plv.recon_cb, plv.recon_cr)
                mode, acz, mv, ref = plv.mode, plv.acz, plv.mv, plv.ref
                fields = dict(zip(("mode", "zdc", "acz", "czdc", "cacz", "mv", "ref",
                                   "pmode"),
                                  (plv.mode, plv.zdc, plv.acz, plv.czdc, plv.cacz,
                                   plv.mv, plv.ref, plv.pmode)))
                host = {name: None if a is None else a.numpy()
                        for name, a in fields.items()}
                handle = (None, host)
                if self._bitpack:
                    handle = self._host_bits(*kb.pack_p_mbs(
                        *self._pack_p_args(fields, mv, ref, active), self._nw_mb,
                        **self._pack_p_parts(fields, ref)), host, mode)
            if self.deblock:
                if self.parts:
                    # the quadrant fields, one an 8x8 block (bS inside a
                    # partitioned MB follows its partitions' motion)
                    mv = h264_deblock.block_grid(mv)
                    ref = None if ref is None else h264_deblock.block_grid(ref)
                recon = self._deblocked(recon, qp, mode >= 2, h264_deblock.nnz4_grid(acz),
                                        mv, ref, slice_local=self._deblock_slice_local)
            self._recon = recon
            self._ref_list = ([recon] + self._ref_list)[:self.refs]
            pending = ("p", handle, self._frame_num, qp, active, prefix)
            self._frame_num = (self._frame_num + 1) % 16
        self.frames += 1
        return pending

    def _pack_p_args(self, fields: dict, mv, ref, active: int) -> tuple:
        """pack_p_mbs's positional levels, field and reference arguments."""
        return (fields["mode"], fields["zdc"], fields["acz"], fields["czdc"],
                fields["cacz"], None if self.parts else mv, None if self.parts else ref,
                active)

    def _pack_p_parts(self, fields: dict, ref) -> dict:
        """pack_p_mbs's partition arguments (none without ``parts``)."""
        if not self.parts:
            return {}
        return dict(pmode=fields["pmode"], mv4=fields["mv"], ref4=ref)

    def _p_bits_nals(self, parts: dict, qp: int, num: int,
                     active_refs: int) -> list[bytes] | None:
        """One P slice NAL per MB row from the device-packed MB bit strings:
        the host writes the slice headers and the trailing skip run (from the
        mode row), concatenates and escapes.  None when an MB overflowed the
        cap."""
        from opencv_opencl_tpu_torch.ops.h264_bitpack import assemble_slices_from_bits

        nbits, mode = parts["nbits"], parts["mode"]
        if int(nbits.max(initial=0)) > 32 * self._nw_mb:
            return None
        mb_w = nbits.shape[1]

        def header_fn(mby):
            w = _BitWriter()
            _slice_head_p(w, qp, num, first_mb=mby * mb_w, active_refs=active_refs,
                          deblock=self.deblock, slice_local=self._deblock_slice_local)
            return w

        def tail_fn(mby):
            run = 0
            for mbx in range(mb_w - 1, -1, -1):
                if mode[mby, mbx] != 0:
                    break
                run += 1
            if not run:
                return None
            w = _BitWriter()
            w.ue(run)
            return w

        return assemble_slices_from_bits(parts["words"], nbits, header_fn, tail_fn)

    def _p_entropy_nals(self, fields: dict, qp: int, num: int,
                        active_refs: int) -> list[bytes]:
        """P-frame entropy stage: the native C++ rows where the library
        builds, the Python oracle otherwise (with ``parts`` both take the
        partition modes and the quadrant fields)."""
        mode, zdc, acz, czdc, cacz = (fields[k] for k in
                                      ("mode", "zdc", "acz", "czdc", "cacz"))
        mv = fields["mv"] if self.search else None
        ref = fields["ref"] if active_refs > 1 else None
        pmode = fields["pmode"] if self.parts else None
        if self._intra._native:
            from opencv_opencl_tpu_torch import native

            if hasattr(native._load(), "fp_cavlc_entropy_rows_p"):
                kw = (dict(pmode=pmode, mv4=mv, ref4=ref, mv=None, ref=None)
                      if self.parts else dict(mv=mv, ref=ref))
                return native.cavlc_entropy_rows_p(
                    mode, zdc, acz, czdc, cacz, qp, num,
                    threads=self._intra._threads,
                    workspace=self._intra._workspace,
                    active_refs=active_refs, deblock=self.deblock,
                    slice_local=self._deblock_slice_local, **kw)
        return encode_frame_p_from_levels(
            mode, zdc, acz, czdc, cacz, qp, num, mv=mv, ref=ref,
            active_refs=active_refs, deblock=self.deblock,
            slice_local=self._deblock_slice_local, pmode=pmode)

    def _assemble(self, kind: str, handle, num: int, qp: int,
                  active_refs: int = 1, prefix: bytes = b"",
                  do_rc: bool = True) -> bytes:
        from opencv_opencl_tpu_torch.io.h264_cavlc import intra_bits_nals

        event, parts = handle
        if event is not None:
            event.synchronize()
        nals = None
        if "words" in parts:
            nals = (intra_bits_nals(parts["words"], parts["nbits"], num, qp, self._nw_mb,
                                    deblock=self.deblock) if kind == "i"
                    else self._p_bits_nals(parts, qp, num, active_refs))
            if nals is None:
                # an MB overflowed the cap: the host entropy path
                self._bits_overflows += 1
                parts = parts["levels"]()
        if kind == "i":
            if nals is None:
                nals = self._intra._entropy_nals((None, parts), num, qp)
            au = (_START4 + self._intra._sps + _START4 + self._intra._pps +
                  b"".join(_START4 + bytes(n) for n in nals))
        else:
            if nals is None:
                nals = self._p_entropy_nals(parts, qp, num, active_refs)
            # GDR wave starts carry SPS + PPS + the recovery point SEI
            au = prefix + b"".join(_START4 + bytes(n) for n in nals)
        if do_rc and self.bitrate_kbps:
            _gop_rate_control(self, len(au))
        return au

    def encode(self, nv12: np.ndarray) -> list[bytes]:
        if self._cpb is not None:
            # synchronous CPB loop: snapshot the chain, dispatch and
            # entropy-code, retry at a higher QP while the AU exceeds the
            # leaky-bucket budget
            snap = (self._recon, list(self._ref_list), self._frame_num,
                    self.frames, self._intra._idr_pic_id)
            qp = self.qp
            while True:
                au = self._assemble(*self._dispatch(nv12, qp_override=qp),
                                    do_rc=False)
                if qp >= 51:
                    break
                budget = self._cpb.budget_bits()
                if 8 * len(au) <= budget:
                    break
                (self._recon, self._ref_list, self._frame_num,
                 self.frames, self._intra._idr_pic_id) = snap
                snap = (snap[0], list(snap[1])) + snap[2:]
                qp = self._intra._cpb_bump(qp, 8 * len(au), budget)
            self._cpb.add_frame(8 * len(au))
            self.qp = qp  # the forced QP carries forward
            if self.bitrate_kbps:
                _gop_rate_control(self, len(au))
            return [au]
        pending = self._dispatch(nv12)
        if not self._overlap:
            return [self._assemble(*pending)]
        prev, self._pending = self._pending, pending
        if prev is None:
            return []
        return [self._assemble(*prev)]

    def flush(self) -> list[bytes]:
        prev, self._pending = self._pending, None
        if prev is None:
            return []
        return [self._assemble(*prev)]

    def close(self) -> None:
        pass

    # ------------------------------------------------------ fused GOP --
    # relay --fused-encode: the device side is
    # models/fused_encode.build_enhance_gop_fn; the encoder makes its first
    # reference pictures and assembles AUs from the packed levels that come
    # down

    def initial_recon(self) -> tuple:
        """Zero reference pictures on ``self.device`` to seed the fused GOP
        chain (frame 0 is an IDR, so the P frames never read them): 3
        planes, or 6 with two references."""
        import torch

        w16 = -(-self.width // 16) * 16
        h16 = -(-self.height // 16) * 16
        shapes = ((h16, w16), (h16 // 2, w16 // 2), (h16 // 2, w16 // 2))
        return tuple(torch.zeros(s, dtype=torch.uint8, device=self.device)
                     for s in shapes * self.refs)

    def encode_from_packed(self, packed: np.ndarray) -> list[bytes]:
        """Assemble one access unit from the packed level tensor of one
        frame of the fused GOP step (``GOP_PACKED_LANES`` = 409 + the mode
        lane, whose negative values mark an IDR frame and carry the per-MB
        intra pred mode: -1 DC, -2 HORIZONTAL; 412 adds the two MV lanes
        of the search, 413 the reference lane of two references, 419 / 423
        the partition lanes; with ``bitpack`` the bits lanes follow).  Must
        be called in stream order: frame_num and idr_pic_id advance a call,
        as the device chain's frame index does."""
        from opencv_opencl_tpu_torch.io.h264_cavlc import intra_bits_nals
        from opencv_opencl_tpu_torch.ops.h264_levels import unpack_levels_host

        packed = np.asarray(packed)
        base = ((423 if self.refs > 1 else 419) if self.parts
                else 413 if self.refs > 1
                else (412 if self.search else 410))
        bits = None
        if self._bitpack and packed.shape[-1] == base + 1 + 2 * self._nw_mb:
            bits = _split_bits_lanes(packed[:, :, base:])
            packed = packed[:, :, :base]
        if packed.shape[-1] not in (410, 412, 413, 419, 423):
            raise ValueError(
                f"fused GOP packed levels have {packed.shape[-1]} lanes, "
                "expected 410 (zero motion), 412 (motion search), 413 "
                "(two references), 419 (partitions) or 423 "
                "(partitions x two references)")
        mode = packed[:, :, 409]
        qp = int(packed[0, 0, 408])       # in-band qp lane (pack_levels)
        fields = {"mode": mode, "pmode": None}
        if packed.shape[-1] in (419, 423):  # parts: 8 quadrant-MV lanes +
            mbh, mbw = mode.shape           # the partition-mode lane
            fields["mv"] = packed[:, :, 410:418].reshape(mbh, mbw, 4, 2)
            fields["pmode"] = packed[:, :, 418]
            # + 4 per-quadrant reference lanes at two references
            fields["ref"] = (packed[:, :, 419:423] if packed.shape[-1] == 423
                             else None)
        else:
            fields["mv"] = packed[:, :, 410:412] if packed.shape[-1] >= 412 else None
            fields["ref"] = packed[:, :, 412] if packed.shape[-1] == 413 else None
        self.frames += 1
        nals = None
        if mode[0, 0] <= -1:  # IDR frame marker (-1 DC / -2 HORIZONTAL)
            num = self._intra._idr_pic_id
            self._intra._idr_pic_id ^= 1
            self._frame_num = 1
            self._since_idr = 0
            if bits is not None:
                nals = intra_bits_nals(*bits, num, qp, self._nw_mb,
                                       deblock=self.deblock)
            if nals is None:
                if bits is not None:
                    self._bits_overflows += 1
                lv, qp = unpack_levels_host(packed[:, :, :409])
                nals = self._intra._entropy_nals(
                    (None, {**lv._asdict(),
                            "imode": np.where(mode == -2, 1, 2).astype(np.int16)}),
                    num, qp)
            au = (_START4 + self._intra._sps + _START4 + self._intra._pps +
                  b"".join(_START4 + bytes(n) for n in nals))
        else:
            # active references follow the device chain: one for the first
            # P after each IDR, then the configured count (counted apart
            # from frame_num, which wraps mod 16)
            self._since_idr += 1
            active = min(self._since_idr, self.refs)
            prefix = b""
            if self.gdr and (self._since_idr - 1) % self._gdr_period == 0:
                # wave start: parameter sets + recovery point marker for
                # mid-stream joiners (as _dispatch's GDR prefix)
                prefix = (_START4 + self._intra._sps + _START4 +
                          self._intra._pps + _START4 +
                          build_recovery_point_sei(self._gdr_period - 1))
            if bits is not None:
                nals = self._p_bits_nals({"words": bits[0], "nbits": bits[1],
                                          "mode": mode},
                                         qp, self._frame_num, active)
            if nals is None:
                if bits is not None:
                    self._bits_overflows += 1
                lv, qp = unpack_levels_host(packed[:, :, :409])
                nals = self._p_entropy_nals({**fields, **lv._asdict()}, qp,
                                            self._frame_num, active)
            self._frame_num = (self._frame_num + 1) % 16
            au = prefix + b"".join(_START4 + bytes(n) for n in nals)
        if self.bitrate_kbps:
            _gop_rate_control(self, len(au))
        return [au]


def _split_bits_lanes(lanes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host inverse of models.fused_encode._bits_lanes: lane 0 is the
    per-MB bit count, the remaining 2*nw int16 lanes are the little-endian
    halves of the packed uint32 words (a contiguous view, no copy beyond
    the contiguify)."""
    nbits = lanes[:, :, 0].astype(np.int64)
    words = np.ascontiguousarray(lanes[:, :, 1:]).view(np.uint32)
    return words, nbits

