"""The plain reference of the fused CLAHE + low-delay-P GOP step: the
enhancement (:mod:`.clahe`), the 16-aligned planes, then each frame an IDR
(:func:`.h264_levels.encode_levels_plain` with the full reconstruction) or a
P frame from the previous reconstruction (:func:`.h264_levels.
encode_p_levels_plain`), each filtered in the loop
(:func:`.h264_deblock.deblock_planes_plain`), and the lanes the step hands
down: per MB the 408 levels, the qp, the mode (-1 / -2 an IDR's DC /
HORIZONTAL, else 0-3) and, with a search, the motion vector.

It works out again everything the port's ``build_enhance_gop_fn`` derives
and carries, from the input frames alone: one reference picture, no
refresh band, no partitions, no packed bits (the configuration's options;
others raise).
"""

from __future__ import annotations

import torch

from gpubench.reference import clahe, h264_deblock, h264_levels


def _edge_fill(dst: torch.Tensor, src: torch.Tensor) -> None:
    h, w = src.shape[:2]
    dst[:h, :w] = src
    dst[h:, :w] = src[h - 1:h]
    dst[:, w:] = dst[:, w - 1:w]


def planes(nv12: torch.Tensor, plan: clahe.Plan, blend_dtype=torch.float32):
    """The enhanced luma and the passthrough chroma of uint8 (N, 3h/2, w)
    frames as lists of 16-aligned (y, cb, cr) planes."""
    n, _, w = nv12.shape
    h = plan.height
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    ys = clahe.clahe(nv12[:, :h], plan, blend_dtype)
    out = []
    for i in range(n):
        y = torch.empty((h16, w16), dtype=torch.uint8, device=nv12.device)
        _edge_fill(y, ys[i])
        c = torch.empty((h16 // 2, w16 // 2, 2), dtype=torch.uint8, device=nv12.device)
        _edge_fill(c, nv12[i, h:].reshape(h // 2, w // 2, 2))
        out.append((y, c[..., 0].contiguous(), c[..., 1].contiguous()))
    return out


def encode(nv12: torch.Tensor, plan: clahe.Plan, qp: int, idx0: int, gop: int,
           search: int, subpel: int, deblock: bool, recon, blend_dtype=torch.float32):
    """(int16 (N, mb_h, mb_w, L) lanes, the reconstruction after the last
    frame) of frames ``idx0 ...`` from ``recon``, the picture before them
    (unused when the first is an IDR)."""
    outs = []
    cur = recon
    for i, (y, cb, cr) in enumerate(planes(nv12, plan, blend_dtype)):
        mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
        dev = y.device
        if (idx0 + i) % gop == 0:
            lv, ry, rcb, rcr, imode = h264_levels.encode_levels_plain(y, cb, cr, qp)
            rec = (ry, rcb, rcr)
            if deblock:
                rec = h264_deblock.deblock_planes_plain(
                    *rec, qp, torch.ones((mbh, mbw), dtype=torch.bool, device=dev),
                    torch.zeros((4 * mbh, 4 * mbw), dtype=torch.bool, device=dev),
                    torch.zeros((mbh, mbw, 2), dtype=torch.int16, device=dev),
                    torch.zeros((mbh, mbw), dtype=torch.int16, device=dev))
            mode = torch.where(imode == 1, -2, -1).to(torch.int16)
            mv = torch.zeros((mbh, mbw, 2), dtype=torch.int16, device=dev)
        else:
            plv = h264_levels.encode_p_levels_plain(y, cb, cr, *cur, qp, search, subpel)
            lv = h264_levels.LevelArrays(plv.zdc, plv.acz, plv.czdc, plv.cacz)
            rec = (plv.recon_y, plv.recon_cb, plv.recon_cr)
            if deblock:
                mvd = (torch.zeros((mbh, mbw, 2), dtype=torch.int16, device=dev)
                       if plv.mv is None else plv.mv)
                rec = h264_deblock.deblock_planes_plain(
                    *rec, qp, plv.mode >= 2, h264_deblock.nnz4_grid(plv.acz), mvd,
                    torch.zeros((mbh, mbw), dtype=torch.int16, device=dev))
            mode, mv = plv.mode, plv.mv
        lanes = [h264_levels.pack_levels(lv, qp), mode.to(torch.int16)[:, :, None]]
        if search:
            lanes.append(mv.to(torch.int16))
        outs.append(torch.cat(lanes, -1))
        cur = tuple(rec)
    return torch.stack(outs), cur
