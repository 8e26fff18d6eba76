"""Fused enhance + H.264 level computation: one device step a batch.

Counterpart of ``opencv_opencl_tpu/models/fused_encode.py``.  The relay's
device-encoder path (``--sink=rtp+h264:// --encoder=tpu[...]``) would
otherwise bring every enhanced frame down to the host and send it back up
to the encoder: ~25 MB a 4K frame across PCIe, plus a host padding pass and
a copy into pinned memory.  Here the frames stay on the card as pixels from
the enhancement to the levels; only the quantized levels (and, with
``bitpack``, the packed CAVLC bits) come down, as one int16 tensor a batch
that the feeder retires like a frame batch.

- the enhancement is the relay's own (``models.enhancer.make_enhance_y``:
  K1-K3 for CLAHE, K1 and K4 for histeq), so the fused stream is
  byte-identical to enhance-then-encode at equal qp;
- the level kernels need 16-aligned planes: Y and the de-interleaved
  chroma are edge-replicated on the card, as the host encoder's ``_pad``
  does;
- one slice per MB row makes MB rows independent, so the N frames of an
  intra batch stack on the MB-row axis and one launch of H1 (the split
  grids of ``csrc/h264_levels.cu``) covers the batch (a 4K frame needs no
  padding, 2160 = 135 x 16);
- the GOP step runs its frames one after another (the JAX package's
  ``lax.scan``), each an IDR (H1 with the full reconstruction) or a P
  frame (``subpel_planes_kernel``, the search, then H2: the split grids
  with the inter candidate), with the in-loop filter (``deblock_kernel``)
  and the bit packers (``pack_i_kernel``, ``pack_p_kernel``) as
  configured; the reference pictures stay on the card between batches.

The packed tensor has the JAX package's lane layout (MB-major: the 408
levels, the qp, the mode lane, the motion lanes, then the bits lanes), not
the kernels' segment-major level buffers, so that the encoders'
``encode_from_packed`` reads what the JAX package's reads.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_opencl_tpu_torch.core.frames import ChromaPolicy, FrameSpec
from opencv_opencl_tpu_torch.models.enhancer import (
    EnhancerConfig, _check_batch, make_enhance_y)
from opencv_opencl_tpu_torch.ops import h264_deblock
from opencv_opencl_tpu_torch.ops.h264_bitpack import pack_i_mbs, pack_p_mbs
from opencv_opencl_tpu_torch.ops.h264_levels import (
    LevelArrays, encode_levels, encode_p_levels, pack_levels)

__all__ = ["build_enhance_levels_fn", "build_enhance_gop_fn", "make_gop_levels",
           "GOP_PACKED_LANES", "GOP_PACKED_LANES_MV",
           "GOP_PACKED_LANES_MREF", "GOP_PACKED_LANES_PARTS",
           "GOP_PACKED_LANES_PARTS_MREF"]

# GOP packing = the intra packing (408 levels + qp) + a mode lane:
# per-MB 0/1/2/3 (P_Skip / P_L0_16x16 / I_16x16 DC / HORIZONTAL) on P
# frames, -1 (DC) or -2 (HORIZONTAL) on IDR frames (the frame-type marker
# the host dispatches on).  With motion search, two more lanes carry the
# per-MB (dy, dx) MV field (412 total); two references add the per-MB ref
# lane (413).  The host side dispatches on the lane count.
GOP_PACKED_LANES = 410
GOP_PACKED_LANES_MV = 412
GOP_PACKED_LANES_MREF = 413
# partition configuration: 8 quadrant-MV lanes + the pmode lane
# (+ 4 per-quadrant reference lanes at two references)
GOP_PACKED_LANES_PARTS = 419
GOP_PACKED_LANES_PARTS_MREF = 423


def _device(device, who: str) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the card and torch.cuda.is_available() is false; "
            "device='cpu' runs the kernels' plain versions")
    return dev


def _refuse_ref_frame(cfg: EnhancerConfig) -> None:
    if cfg.use_ref_frame:
        raise ValueError(
            "fused encode does not support the ref-frame streaming "
            "modes (their histogram state lives outside the batch fn)")


def _edge_fill(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` (N, h, w[, 2]) into the top-left of ``dst`` (N, H, W[, 2]),
    the last row and column replicated into the rest (numpy's
    ``mode="edge"`` pad)."""
    h, w = src.shape[1:3]
    dst[:, :h, :w] = src
    dst[:, h:, :w] = src[:, h - 1:h]
    dst[:, :, w:] = dst[:, :, w - 1:w]


def _make_planes(cfg: EnhancerConfig, spec: FrameSpec, device: torch.device):
    """``planes(nv12_batch) -> (y, c)``: the enhanced Y as (N, h16, w16)
    and the chroma as (N, h16/2, w16/2, 2) (Cb, Cr interleaved), both
    16-aligned by edge replication and contiguous on ``device``."""
    h, w = spec.height, spec.width
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    enhance_y, _ = make_enhance_y(cfg, spec)

    def planes(nv12_batch):
        t = (nv12_batch if isinstance(nv12_batch, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(nv12_batch)))
        t = t.to(device)
        _check_batch(t, spec)
        n = t.shape[0]
        y = torch.empty((n, h16, w16), dtype=torch.uint8, device=device)
        if (h16, w16) == (h, w):
            enhance_y(t[:, :h], y)
        else:
            _edge_fill(y, enhance_y(t[:, :h], torch.empty(
                (n, h, w), dtype=torch.uint8, device=device)))
        if cfg.chroma == ChromaPolicy.GRAY:
            c = torch.full((n, h16 // 2, w16 // 2, 2), 128, dtype=torch.uint8,
                           device=device)
        else:
            c = torch.empty((n, h16 // 2, w16 // 2, 2), dtype=torch.uint8,
                            device=device)
            _edge_fill(c, t[:, h:].reshape(n, h // 2, w // 2, 2))
        return y, c

    return planes


def _bits_lanes(words: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Fold packed CAVLC bit strings into int16 lanes: one bit-count lane,
    then the two little-endian int16 halves of each uint32 word in memory
    order (the host inverse is a contiguous uint32 view,
    ``io.h264_inter._split_bits_lanes``)."""
    mbh, mbw, nw = words.shape
    halves = words.contiguous().view(torch.int16).reshape(mbh, mbw, 2 * nw)
    return torch.cat([nbits.to(torch.int16)[:, :, None], halves], -1)


def build_enhance_levels_fn(cfg: EnhancerConfig, spec: FrameSpec,
                            bitpack: int = 0, device=None):
    """Returns ``fn(nv12_batch: uint8 (N, H*3/2, W), qp: int) -> int16
    (N, mb_h, mb_w, 410)`` on ``device`` (None: the card): enhancement,
    then the quantized CAVLC levels of the whole batch in one launch of
    H1 (the split grids), packed MB-major with the in-band qp
    (``ops.h264_levels.pack_levels``) and the intra pred-mode lane.
    ``bitpack=nw`` appends each MB's CAVLC bit string packed on the card
    (``pack_i_kernel``) as 1 + 2*nw lanes; the stacked frames' MB rows stay
    independent slices, so the batch packs in one launch too.
    ``nv12_batch`` is a numpy array or a tensor; it is read, not written."""
    _refuse_ref_frame(cfg)
    dev = _device(device, "build_enhance_levels_fn")
    h, w = spec.height, spec.width
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    mbh, mbw = h16 // 16, w16 // 16
    planes = _make_planes(cfg, spec, dev)
    nw_mb = int(bitpack)

    def fn(nv12_batch, qp):
        qp = int(qp)
        y, c = planes(nv12_batch)
        n = y.shape[0]
        cbcr = c.view(n * h16 // 2, w16 // 2, 2)
        lv, imode = encode_levels(y.view(n * h16, w16), cbcr[..., 0],
                                  cbcr[..., 1], qp)
        packed = torch.cat([pack_levels(lv, qp),
                            imode.to(torch.int16)[:, :, None]], -1)
        if nw_mb:
            packed = torch.cat([packed, _bits_lanes(*pack_i_mbs(
                lv.zdc, lv.acz, lv.czdc, lv.cacz, imode, nw_mb=nw_mb))], -1)
        return packed.reshape(n, mbh, mbw, -1)

    return fn


def make_gop_levels(mbh: int, mbw: int, dev: torch.device, search: int = 0,
                    subpel: int = 0, refs: int = 1, deblock: bool = False,
                    gdr: int = 0, bitpack: int = 0, parts: bool = False):
    """The level stage of the GOP step on 16-aligned planes of ``mbh`` x
    ``mbw`` MBs on ``dev``: ``(do_i, do_p)``.  ``do_i(y, cb, cr, qp) ->
    (packed, recon)`` codes an IDR picture, ``do_p(y, cb, cr, qp, idx, cur,
    old) -> (packed, recon)`` a P picture from the reference pictures
    ``cur`` (and ``old`` with two references, else None); ``packed`` is the
    (mbh, mbw, L) int16 lanes of :func:`build_enhance_gop_fn`, ``recon``
    the new reference picture (y, cb, cr).  The options are
    :func:`build_enhance_gop_fn`'s, unchecked.  One slice per MB row makes
    the rows independent, so the geometry may be a band of a frame with
    halo rows (``parallel/sharded_encode.BandedCudaGopEncoder``)."""
    # GDR horizontal intra refresh: the band of frame idx, as the encoder
    # computes it
    gdr_period = min(int(gdr), mbh) if gdr else 0
    gdr_rows = -(-mbh // gdr_period) if gdr else 0
    nw_mb = int(bitpack)
    # the all-intra metadata of an IDR picture's filter
    idr_info = (torch.ones((mbh, mbw), dtype=torch.bool, device=dev),
                torch.zeros((4 * mbh, 4 * mbw), dtype=torch.bool, device=dev),
                torch.zeros((mbh, mbw, 2), dtype=torch.int16, device=dev),
                torch.zeros((mbh, mbw), dtype=torch.int16, device=dev))

    def zeros(*lanes):
        return torch.zeros((mbh, mbw, *lanes), dtype=torch.int16, device=dev)

    def pack_gop(lv: LevelArrays, qp: int, mode, mv=None, ref=None,
                 pmode=None):
        lanes = [pack_levels(lv, qp), mode.to(torch.int16)[:, :, None]]
        if parts:
            # 8 quadrant-MV lanes + the partition-mode lane (IDR frames
            # pack zeros; the mode lane marks them); with refs > 1, 4
            # per-quadrant reference lanes follow
            lanes.append(zeros(8) if mv is None
                         else mv.to(torch.int16).reshape(mbh, mbw, 8))
            lanes.append(zeros(1) if pmode is None
                         else pmode.to(torch.int16)[:, :, None])
            if refs > 1:
                lanes.append(zeros(4) if ref is None else ref.to(torch.int16))
            return torch.cat(lanes, -1)
        if search:
            lanes.append(zeros(2) if mv is None else mv.to(torch.int16))
        if refs > 1:
            lanes.append(zeros(1) if ref is None
                         else ref.to(torch.int16)[:, :, None])
        return torch.cat(lanes, -1)

    def deblock_p(plv, qp: int):
        """The in-loop filter of a P picture (GDR P slices slice-local)."""
        nnz4 = h264_deblock.nnz4_grid(plv.acz)
        if parts:
            # quadrant-granular bS fields (per-8x8 motion)
            mvd = h264_deblock.block_grid(plv.mv)
            refd = (torch.zeros((2 * mbh, 2 * mbw), dtype=torch.int16,
                                device=dev)
                    if plv.ref is None else h264_deblock.block_grid(plv.ref))
        else:
            mvd = zeros(2) if plv.mv is None else plv.mv
            refd = zeros() if plv.ref is None else plv.ref
        return h264_deblock.deblock_planes(
            plv.recon_y, plv.recon_cb, plv.recon_cr, qp, plv.mode >= 2, nnz4,
            mvd, refd, slice_local=bool(gdr))

    def do_i(yf, cbf, crf, qp: int):
        lv, ry, rcb, rcr, imode = encode_levels(yf, cbf, crf, qp,
                                                full_recon=True)
        rec = (ry, rcb, rcr)
        if deblock:
            rec = h264_deblock.deblock_planes(*rec, qp, *idr_info)
        # IDR marker doubles as the intra pred mode:
        # -1 = I_16x16 DC, -2 = I_16x16 HORIZONTAL
        mode = torch.where(imode == 1, -2, -1).to(torch.int16)
        out = pack_gop(lv, qp, mode)
        if nw_mb:
            out = torch.cat([out, _bits_lanes(*pack_i_mbs(
                lv.zdc, lv.acz, lv.czdc, lv.cacz, imode, nw_mb=nw_mb))], -1)
        return out, tuple(rec)

    def do_p(yf, cbf, crf, qp: int, idx: int, cur, old):
        """One P frame: from ``cur`` alone (``old`` None), or from both."""
        band = None
        if gdr:
            m = (idx - 1) % gdr_period
            band = (m * gdr_rows, min((m + 1) * gdr_rows, mbh))
        two = old is not None
        plv = encode_p_levels(yf, cbf, crf, *cur, qp, search, subpel,
                              *(old if two else (None, None, None)),
                              gdr_band=band, parts=int(parts))
        lv = LevelArrays(plv.zdc, plv.acz, plv.czdc, plv.cacz)
        rec = ((plv.recon_y, plv.recon_cb, plv.recon_cr) if not deblock
               else tuple(deblock_p(plv, qp)))
        out = pack_gop(lv, qp, plv.mode, plv.mv, plv.ref if two else None,
                       pmode=plv.pmode)
        if nw_mb:
            pk = (dict(pmode=plv.pmode, mv4=plv.mv, ref4=plv.ref) if parts
                  else {})
            out = torch.cat([out, _bits_lanes(*pack_p_mbs(
                plv.mode, plv.zdc, plv.acz, plv.czdc, plv.cacz,
                None if parts else plv.mv,
                None if parts or not two else plv.ref,
                2 if two else 1, nw_mb=nw_mb, **pk))], -1)
        return out, rec

    return do_i, do_p


def build_enhance_gop_fn(cfg: EnhancerConfig, spec: FrameSpec, gop: int,
                         search: int = 0, subpel: int = 0, refs: int = 1,
                         deblock: bool = False, gdr: int = 0,
                         bitpack: int = 0, parts: bool = False, device=None):
    """Fused enhance + low-delay-P GOP encode on ``device`` (None: the
    card): returns ``fn(nv12_batch: uint8 (N, H*3/2, W), qp: int, idx0:
    int, *recon) -> (int16 (N, mb_h, mb_w, L), *recon')``.  ``recon`` is
    the reference pictures, 3 planes (y, cb, cr), or 6 with ``refs=2``
    (the newest first); they stay on the card from batch to batch, and the
    encoder's ``initial_recon`` makes the first ones.  Frame ``idx0 + i``
    is an IDR where ``(idx0 + i) % gop == 0``, else a P frame predicted
    from the reference pictures (the frame right after each IDR from one).
    L = 410 lanes, 412 with ``search`` (the MV lanes), 413 with ``refs=2``
    (the reference lane), 419 / 423 with ``parts``; ``bitpack=nw`` appends
    1 + 2*nw lanes of packed bits.  ``gdr`` runs the refresh band of frame
    ``idx`` (``gop`` is then the one-IDR-ever value of the encoder).

    The chain advances once a frame fed through ``fn``: the caller must
    not pad batches with repeated frames (the relay's ``--fused-encode``
    sets ``pad_batches=False`` for GOP encoders)."""
    _refuse_ref_frame(cfg)
    if gop < 2:
        raise ValueError("fused GOP needs gop >= 2 (gop=1 is the "
                         "all-IDR fused path: build_enhance_levels_fn)")
    if refs not in (1, 2):
        raise ValueError(f"fused GOP refs must be 1 or 2, got {refs}")
    if refs > 1 and not search:
        raise ValueError("fused refs=2 requires search=R > 0")
    if gdr and refs > 1:
        raise ValueError("fused gdr requires refs=1")
    if parts:
        # same composition limits as CudaGopEncoder(parts=True)
        if not search:
            raise ValueError("fused parts requires search=R > 0")
        if subpel == 3:
            raise ValueError("parts does not compose with fastsub")
        if gdr:
            raise ValueError("fused parts requires no gdr")
        if refs > 1 and subpel == 2 and (
                refs * (8 * search + 1) ** 2 > 8192):
            raise ValueError(
                "quarter-pel parts with refs=2 needs search <= 7, "
                f"got {search}")
    dev = _device(device, "build_enhance_gop_fn")
    h16, w16 = -(-spec.height // 16) * 16, -(-spec.width // 16) * 16
    planes = _make_planes(cfg, spec, dev)
    do_i, do_p = make_gop_levels(h16 // 16, w16 // 16, dev, search=search,
                                 subpel=subpel, refs=refs, deblock=deblock,
                                 gdr=gdr, bitpack=bitpack, parts=parts)

    def fn(nv12_batch, qp, idx0, ry, rcb, rcr, oy=None, ocb=None, ocr=None):
        qp = int(qp)
        y, c = planes(nv12_batch)
        cur = (ry, rcb, rcr)
        old = (oy, ocb, ocr) if refs > 1 else None
        outs = []
        for i in range(y.shape[0]):
            idx = int(idx0) + i
            yf, cbf, crf = y[i], c[i, :, :, 0], c[i, :, :, 1]
            if idx % gop == 0:
                out, rec = do_i(yf, cbf, crf, qp)
                # IDR flushes the DPB: the second slot is a dummy (the
                # next frame's single-reference branch never reads it)
                cur, old = rec, (rec if refs > 1 else None)
                outs.append(out)
                continue
            # with refs=2 the frame right after each IDR predicts from
            # one picture
            two = refs > 1 and idx % gop != 1
            out, rec = do_p(yf, cbf, crf, qp, idx, cur, old if two else None)
            cur, old = rec, (cur if refs > 1 else None)
            outs.append(out)
        return (torch.stack(outs), *cur) + (tuple(old) if refs > 1 else ())

    return fn
