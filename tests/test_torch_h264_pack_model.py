"""Models of H7 ``pack_i_kernel``'s and H8 ``pack_p_kernel``'s design
(``csrc/h264_bitpack.cu``) in Python, held to the JAX package's
``pack_i_mbs`` and ``pack_p_mbs`` (words and bit counts, tolerance 0).

The models do what a warp of the kernels does, in the same order: each walks
a run of MBs of one row (``ops/cuda/h264_bitpack.pack_plan``), first
reading the MB left of its run for the left context (its nonzero counts;
H7 its Intra_4x4 modes and type; H8 its mode and fields); gives lane k
piece k (0 the header, 1 the luma DC, 2-17 the luma blocks in bitstream
order, 18-19 chroma DC, 20-27 chroma AC); codes a residual block from its
nonzero mask (the trailing ones from its top three bits, then the levels
and the runs by walking its bits down, each token chosen without a
branch); places the pieces by an exclusive scan of their lengths; and
builds each output word from the pieces that cover it, the first found by
a binary search over the starts.  H7 builds the 16 mode tokens on lanes
0-15 and places them by a scan of their lengths.  H8 finds the last coded
MB left of its run by ballots of 32 columns moving left and carries it;
neither reads nor codes a skipped MB; builds lane 0's header from the
MB's fields and the left MB's (the left vector for P_16x16, the
reference-aware predictors of the partitions); and gates inter luma
blocks by quadrant, 16 coefficients, intra-in-P ones by any luma, 15 and
the DC piece.  Random dense and sparse levels (up to the 12-bit escape,
also under skipped MBs), Intra_4x4 MBs with chroma HORIZONTAL among
I_16x16 ones, P frames with every mode, partition mode and reference, skip
runs across runs' starts and a row with no coded MB, runs of 1, 3 and 16
MBs, and caps of 3 and 64 words (MBs over the cap keep their true bit
count).  The JAX packers run op by op (no ``jax.jit``), at 3 x 7 MBs, so
that the P packer reuses the I packer's compiled ops; H8's model also runs
on rows of 40 MBs (runs of 16, 16 and 8; a skip run of 35 that takes two
ballots), held there to the port's plain P packer, which
``tests/test_torch_h264_bitpack.py`` holds to the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from opencv_opencl_tpu.ops import h264_bitpack as jax_bitpack
from opencv_opencl_tpu_torch.ops import h264_bitpack as bitpack
from opencv_opencl_tpu_torch.ops.cuda import h264_bitpack as packer

VLC = [int(v) for v in bitpack.vlc_table()]
OFF = bitpack.VLC_OFFSETS
ZIG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
MB_H, MB_W = 3, 7


def z_of(bx, by):
    return (bx & 1) | ((by & 1) << 1) | ((bx & 2) << 1) | ((by & 2) << 2)


class Writer:
    """The kernel's RegBits: MSB-first tokens, a word stored when 32 bits
    are in."""

    def __init__(self):
        self.acc, self.n, self.pos, self.words = 0, 0, 0, []

    def put(self, v, length):
        v, length = int(v), int(length)
        v &= (1 << length) - 1
        self.acc = ((self.acc << length) | v) & ((1 << 64) - 1)
        self.n += length
        self.pos += length
        if self.n >= 32:
            self.n -= 32
            self.words.append((self.acc >> self.n) & 0xffffffff)

    def ue(self, v):
        code = v + 1
        self.put(code, 2 * code.bit_length() - 1)

    def flush(self):
        if self.n:
            self.words.append((self.acc << (32 - self.n)) & 0xffffffff)


def top_bit(m):
    return m.bit_length() - 1


def block(b, lv, nc, cdc, max_coeffs):
    """block_regs: the nonzero, trailing-one and sign masks; the trailing
    ones from the mask's top three bits; the other levels and the runs by
    walking its bits down."""
    nzm = sum(1 << p for p in range(16) if lv[p])
    ones = sum(1 << p for p in range(16) if abs(lv[p]) == 1)
    neg = sum(1 << p for p in range(16) if lv[p] < 0)
    total = bin(nzm).count("1")
    t1s, signs, rest, run1 = 0, 0, nzm, True
    for _ in range(3):
        p = top_bit(rest)
        run1 = run1 and rest != 0 and (ones >> p) & 1
        if run1:
            t1s += 1
            signs = (signs << 1) | ((neg >> p) & 1)
            rest ^= 1 << p
    if cdc:
        b.put(VLC[OFF["cdc_code"] + total * 4 + t1s], VLC[OFF["cdc_len"] + total * 4 + t1s])
    elif nc >= 8:
        b.put(3 if total == 0 else ((total - 1) << 2) | t1s, 6)
    else:
        k = ((0 if nc < 2 else 1 if nc < 4 else 2) * 17 + total) * 4 + t1s
        b.put(VLC[OFF["ct_code"] + k], VLC[OFF["ct_len"] + k])
    b.put(signs, t1s)
    sl, r = (1 if total > 10 and t1s < 3 else 0), t1s
    while rest:
        p = top_bit(rest)
        rest ^= 1 << p
        c = lv[p]
        lc = 2 * c - 2 if c > 0 else -2 * c - 1
        if r == t1s and t1s < 3:
            lc -= 2
        prefix = lc >> sl
        esc = (lc >= 30) if sl == 0 else (prefix >= 15)
        plain = ((16 | (lc - 14)) if lc >= 14 else 1) if sl == 0 else (1 << sl) | (lc & ((1 << sl) - 1))
        length = (19 if lc >= 14 else lc + 1) if sl == 0 else prefix + 1 + sl
        b.put((1 << 12) | (lc - (30 if sl == 0 else 15 << sl)) if esc else plain,
              28 if esc else length)
        sl2 = 1 if sl == 0 else sl
        if abs(c) > (3 << (sl2 - 1)) and sl2 < 6:
            sl2 += 1
        sl = sl2
        r += 1
    if 0 < total < max_coeffs:
        top = top_bit(nzm)
        tz = top + 1 - total
        if cdc:
            k = min(total, 3) * 4 + min(max(tz, 0), 3)
            b.put(VLC[OFF["tzc_code"] + k], VLC[OFF["tzc_len"] + k])
        else:
            k = min(total, 15) * 16 + min(max(tz, 0), 15)
            b.put(VLC[OFF["tz_code"] + k], VLC[OFF["tz_len"] + k])
        zl, prev, rest, r = tz, top, nzm ^ (1 << top), 0
        while rest and zl > 0 and r < 14:
            p = top_bit(rest)
            rest ^= 1 << p
            run = min(max(prev - p - 1, 0), 14)
            k = min(zl, 7) * 15 + run
            b.put(VLC[OFF["rb_code"] + k], VLC[OFF["rb_len"] + k])
            zl -= run
            prev, r = p, r + 1


def lane_role(lane):
    """PieceRole: kind, (bx, by), the luma or chroma block, the left MB's
    block beside it."""
    if lane == 1:
        return 1, 0, 0, 0, 3, 0
    if 2 <= lane < 18:
        i = lane - 2
        bx, by = (i & 1) | ((i >> 1) & 2), ((i >> 1) & 1) | ((i >> 2) & 2)
        return 2, bx, by, by * 4 + bx, by * 4 + 3, 0
    if 20 <= lane < 28:
        comp, cb = (lane - 20) >> 2, (lane - 20) & 3
        return 4, cb & 1, cb >> 1, comp * 4 + cb, comp * 4 + (cb >> 1) * 2 + 1, comp
    return (0 if lane == 0 else 3 if lane < 20 else 5), 0, 0, 0, 0, lane - 18


def residual(b, lane, levels, counts, left_counts, at_edge, full):
    """Lane ``lane``'s residual piece (1-27) of one MB into ``b``: its
    block's nC from the MB's counts and the left MB's beside it, then its
    tokens; ``full`` luma blocks carry 16 coefficients (else 15 and the DC
    piece)."""
    zdc, acz, czdc, cacz = levels
    kind, bx, by, own, lft, comp = lane_role(lane)
    cnt, ccnt = counts
    lcnt, lccnt = left_counts
    counts, lcounts, w = (ccnt, lccnt, 2) if kind == 4 else (cnt, lcnt, 4)
    if kind in (1, 3):
        nc = 0 if at_edge else lcnt[3]
    else:
        l = counts[own - 1] if bx > 0 else (0 if at_edge else lcounts[lft])
        t = counts[own - w] if by > 0 else 0
        nc = l if by == 0 else t if (bx == 0 and at_edge) else (l + t + 1) >> 1
    if kind == 1:
        seq, cdc, mx = [int(zdc[ZIG[k]]) for k in range(16)], False, 16
    elif kind == 2 and full:
        seq, cdc, mx = [int(acz[own][ZIG[k]]) for k in range(16)], False, 16
    elif kind == 3:
        seq, cdc, mx = [int(v) for v in czdc[comp]] + [0] * 12, True, 4
    else:
        src = acz[own] if kind == 2 else cacz[comp][own - 4 * comp]
        seq, cdc, mx = [int(src[ZIG[k + 1]]) for k in range(15)] + [0], False, 15
    block(b, seq, nc, cdc, mx)


def mb_pieces(lv, mb, left, at_edge, i4sel, i4modes, cmode, imode):
    """The 32 lanes' pieces of one MB; ``left`` the left MB's (counts,
    modes, Intra_4x4)."""
    zdc, acz, czdc, cacz = (a[mb] for a in lv)
    cnt = (acz != 0).sum(-1)                       # luma blocks, raster
    ccnt = (cacz != 0).sum(-1).reshape(8)          # chroma blocks comp * 4 + blk
    lcnt, lccnt, lmodes, l_i4 = left
    quad = [int((cnt.reshape(4, 4)[2 * (q >> 1):2 * (q >> 1) + 2,
                                   2 * (q & 1):2 * (q & 1) + 2] > 0).any()) for q in range(4)]
    any_luma = int(cnt.sum() > 0)
    cbp_chroma = 2 if ccnt.sum() else 1 if (czdc != 0).any() else 0
    i4 = i4sel is not None and bool(i4sel[mb])
    cm = int(cmode[mb]) if cmode is not None else 0
    # the mode tokens: lane z's, placed by a scan of their lengths
    zm = [int(v) for v in i4modes[mb]] if i4modes is not None else [2] * 16
    toks, end = 0, 0
    for z in range(16):
        bx, by = (z & 1) | ((z >> 1) & 2), ((z >> 1) & 1) | ((z >> 2) & 2)
        predm = 2
        if by > 0:
            top = zm[z_of(bx, by - 1)]
            if bx > 0:
                predm = min(zm[z_of(bx - 1, by)], top)
            elif not at_edge:
                predm = min(lmodes[z_of(3, by)] if l_i4 else 2, top)
        m = zm[z]
        val, n = (1, 1) if m == predm else (m if m < predm else m - 1, 4)
        end += n
        toks |= val << (64 - end)
    pieces = []
    for lane in range(32):
        b = Writer()
        kind, bx, by, own, lft, comp = lane_role(lane)
        if kind == 0:
            if i4:
                b.put(1, 1)
                b.put(toks >> (64 - end), end) if end <= 32 else (
                    b.put(toks >> 32, 32), b.put((toks & 0xffffffff) >> (64 - end), end - 32))
                b.ue(cm)
                cbp4 = quad[0] | quad[1] << 1 | quad[2] << 2 | quad[3] << 3 | cbp_chroma << 4
                b.ue(VLC[OFF["cbp_intra"] + cbp4])
                if cbp4:
                    b.put(1, 1)
            else:
                b.ue(1 + int(imode[mb]) + 4 * cbp_chroma + 12 * any_luma)
                b.ue(cm)
                b.put(1, 1)
        elif kind < 5:
            on = {1: not i4, 2: quad[(bx >> 1) + 2 * (by >> 1)] if i4 else any_luma,
                  3: cbp_chroma >= 1, 4: cbp_chroma == 2}[kind]
            if on:
                residual(b, lane, (zdc, acz, czdc, cacz), (cnt, ccnt), (lcnt, lccnt), at_edge,
                         full=i4)
        b.flush()
        pieces.append(b)
    return pieces, (cnt, ccnt, zm, i4)


def place(pieces, nw):
    """The exclusive scan of the lengths; each output word from the pieces
    that cover it, the first by a binary search over the starts."""
    lens = [p.pos for p in pieces]
    st = np.cumsum([0] + lens[:-1]).tolist()
    total = sum(lens)
    words = []
    for j in range(nw):
        lo, hi, out = 32 * j, 32 * j + 32, 0
        if lo < total:
            k = 0
            for step in (16, 8, 4, 2, 1):
                if k + step < 32 and st[k + step] <= lo:
                    k += step
            while k < 28 and st[k] < hi:
                end = st[k + 1] if k < 31 else total
                a, e = max(lo, st[k]), min(hi, end)
                if e > a:
                    pw = pieces[k].words + [0, 0]
                    off, n = a - st[k], e - a
                    two = (pw[off >> 5] << 32) | pw[(off >> 5) + 1]
                    v = ((two << (off & 31)) >> 32 & 0xffffffff) >> (32 - n)
                    out |= v << (hi - e)
                k += 1
        words.append(out & 0xffffffff)
    return words, total


def model_pack_i(zdc, acz, czdc, cacz, imode, nw, i4modes=None, cmode=None, run=16):
    lv = (zdc, acz, czdc, cacz)
    mb_h, mb_w = zdc.shape[:2]
    i4sel = (imode == 0) if i4modes is not None else None
    plan = packer.pack_plan(mb_h, mb_w, run)
    words = np.zeros((mb_h, mb_w, nw), np.int64)
    nbits = np.zeros((mb_h, mb_w), np.int64)
    for gw in range(plan["warps"]):
        y, x0 = divmod(gw, plan["runs"])
        x0 *= plan["run"]
        left = (np.zeros(16, int), np.zeros(8, int), [2] * 16, False)
        for x in range(max(x0 - 1, 0), min(mb_w, x0 + plan["run"])):
            pieces, here = mb_pieces(lv, (y, x), left, x == 0, i4sel, i4modes, cmode, imode)
            left = here
            if x < x0:
                continue                     # the MB left of the run: counts only
            words[y, x], nbits[y, x] = place(pieces, nw)
    return words, nbits


def random_levels(seed, dense, i4):
    rng = np.random.default_rng(seed)

    def draw(shape):
        mag = rng.choice([1, 2, 3, 40, 2063], size=shape, p=[0.5, 0.2, 0.15, 0.1, 0.05])
        a = (mag * rng.choice([-1, 1], size=shape)).astype(np.int16)
        a[rng.random(shape) < (0.3 if dense else 0.8)] = 0
        a[rng.random(shape[:3]) < 0.3] = 0
        return a

    zdc, acz = draw((MB_H, MB_W, 16)), draw((MB_H, MB_W, 16, 16))
    czdc, cacz = draw((MB_H, MB_W, 2, 4)), draw((MB_H, MB_W, 2, 4, 16))
    cacz[..., 0] = 0
    imode = rng.integers(1, 3, (MB_H, MB_W)).astype(np.int16)
    i4modes = cmode = None
    if i4:
        imode[rng.random((MB_H, MB_W)) < 0.5] = 0
        i4modes = rng.integers(0, 9, (MB_H, MB_W, 16)).astype(np.int16)
        i4modes[imode != 0] = 2
        cmode = rng.integers(0, 4, (MB_H, MB_W)).astype(np.int16)
    acz[(imode != 0)] *= (np.arange(16) > 0).astype(np.int16)
    zdc[imode == 0] = 0
    return zdc, acz, czdc, cacz, imode, i4modes, cmode


_JAX: dict = {}


def jax_packed(levels, key, nw):
    """The JAX packer's words and counts, once a case and cap."""
    if (key, nw) not in _JAX:
        zdc, acz, czdc, cacz, imode, i4modes, cmode = levels
        _JAX[key, nw] = tuple(np.asarray(a) for a in jax_bitpack.pack_i_mbs(
            *map(jnp.asarray, (zdc, acz, czdc, cacz, imode)), nw_mb=nw,
            i4modes=None if i4modes is None else jnp.asarray(i4modes),
            cmode=None if cmode is None else jnp.asarray(cmode)))
    return _JAX[key, nw]


@pytest.mark.parametrize("run", [1, 3, 16])
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("i4", [False, True], ids=["i16", "i4_chromah"])
def test_pack_i_model_equals_jax(i4, dense, run):
    levels = random_levels(3 + dense + 2 * i4, dense, i4)
    for nw in (64, 3):
        got_w, got_n = model_pack_i(*levels[:5], nw, *levels[5:], run)
        want_w, want_n = jax_packed(levels, (i4, dense), nw)
        assert np.array_equal(got_n, np.asarray(want_n)), nw
        assert np.array_equal(got_w, np.asarray(want_w).astype(np.int64)), nw
        if nw == 3:
            assert (got_n > 96).any()        # MBs over the cap keep their true count


@pytest.mark.parametrize("mb_w", [1, 15, 16, 17, 40, 240])
def test_pack_plan(mb_w):
    for mb_h in (1, 3, 135):
        plan = packer.pack_plan(mb_h, mb_w)
        run, runs = plan["run"], plan["runs"]
        assert 1 <= run <= min(packer.PACK_RUN, mb_w)
        assert (runs - 1) * run < mb_w <= runs * run           # the runs cover the row once
        assert plan["warps"] == mb_h * runs
        blocks, threads = plan["grid"]
        assert threads == 32 * packer.PACK_WARPS
        assert (blocks - 1) * packer.PACK_WARPS < plan["warps"] <= blocks * packer.PACK_WARPS


def test_pack_i_entries_launch_only_on_the_card():
    """pack_i_into and its floor refuse CPU levels; pack_i_mbs takes the
    plain version for them: no launch is counted."""
    import torch

    zdc, acz, czdc, cacz, imode, i4modes, cmode = map(
        lambda a: None if a is None else torch.from_numpy(a), random_levels(9, False, True))
    words = torch.zeros((MB_H, MB_W, 8), dtype=torch.uint32)
    nbits = torch.zeros((MB_H, MB_W), dtype=torch.int32)
    packer.reset_launch_counts()
    for fn in (packer.pack_i_into, packer.pack_i_floor_into):
        with pytest.raises(ValueError, match="CUDA"):
            fn(zdc, acz, czdc, cacz, imode, words, nbits, i4modes, cmode)
    got = packer.pack_i_mbs(zdc, acz, czdc, cacz, imode, 8, i4modes, cmode)
    want = bitpack.pack_i_mbs_plain(zdc, acz, czdc, cacz, imode, 8, i4modes, cmode)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert packer.launch_counts() == {"pack_i_mbs": 0, "pack_p_mbs": 0}


# ------------------------------------------------------------------ H8 ----

def se(b, v):
    b.ue(2 * v - 1 if v > 0 else -2 * v)


def mvp_general(amv, aref, aav, bmv, bref, bav, cmv, cref, cav, myref):
    """The kernel's mvp_general: the copy rule, the exactly-one-refIdx-match
    rule, else the component median."""
    ea, eb, ec = ((m if av else (0, 0)) for m, av in ((amv, aav), (bmv, bav), (cmv, cav)))
    ear, ebr, ecr = (r if av else -1 for r, av in ((aref, aav), (bref, bav), (cref, cav)))
    ma, mb, mc = ear == myref, ebr == myref, ecr == myref
    if not bav and not cav and aav:
        return tuple(ea)
    if ma + mb + mc == 1:
        return tuple(ea if ma else eb if mb else ec)
    return tuple(max(min(a, b), min(max(a, b), c)) for a, b, c in zip(ea, eb, ec))


def p_fields(md, mb, mv, ref, pmode):
    """The int16 a lane of an inter MB's fields: quadrant q's vector on lanes
    2q, 2q + 1 and its reference on 8 + q, pmode on 12 (P_16x16: the vector
    on 0-1, the reference on 8); an intra MB's none."""
    f = [0] * 32
    if md != 1:
        return f
    if pmode is not None:
        f[:8] = [int(v) for v in mv[mb].reshape(8)]
        f[8:12] = [int(v) for v in ref[mb]] if ref is not None else [0] * 4
        f[12] = int(pmode[mb])
    else:
        f[:2] = [int(v) for v in mv[mb]] if mv is not None else [0, 0]
        f[8] = int(ref[mb]) if ref is not None else 0
    return f


def p_header(b, md, skip_run, cbp, any_luma, cbp_chroma, f, prev_md, pf, at_edge, parts,
             active):
    """Lane 0's piece: the skip run, then the intra-in-P or the inter
    header from the MB's fields ``f`` and the left MB's ``pf``."""
    b.ue(skip_run)
    if md >= 2:
        b.ue(5 + 1 + (1 if md == 3 else 2) + 4 * cbp_chroma + 12 * any_luma)
        b.put(1, 1)
        b.put(1, 1)
        return
    own = [(f[2 * q], f[2 * q + 1]) for q in range(4)]
    ownr = f[8:12]
    if not parts:
        li = prev_md == 1 and not at_edge
        b.put(1, 1)
        if active == 2:
            b.put(1 - ownr[0], 1)
        se(b, own[0][1] - (pf[1] if li else 0))
        se(b, own[0][0] - (pf[0] if li else 0))
    else:
        left_ok = not at_edge
        li = left_ok and prev_md <= 1
        a1, a3 = (pf[2], pf[3]), (pf[6], pf[7])
        a1r, a3r = (pf[9], pf[11]) if li else (-1, -1)
        pm = f[12]
        nparts = 1 if pm == 0 else 4 if pm == 3 else 2
        rep = [0, 2 if pm == 1 else 1, 2, 3]
        z2 = (0, 0)
        b.ue(pm)
        if pm == 3:
            b.put(15, 4)
        if active == 2:
            for p in range(nparts):
                b.put(1 - ownr[rep[p]], 1)
        for p in range(nparts):
            q = rep[p]
            myref = ownr[q]
            if p == 0:
                mvp = mvp_general(a1, a1r, left_ok, z2, -1, False, z2, -1, False, myref)
            elif p == 1:
                if pm == 1:
                    mvp = (a3 if left_ok and a3r == myref else
                           mvp_general(a3, a3r, left_ok, own[0], ownr[0], True, a1, a1r,
                                       left_ok, myref))
                else:
                    mvp = own[0]
            elif p == 2:
                mvp = mvp_general(a3, a3r, left_ok, own[0], ownr[0], True, own[1], ownr[1],
                                  True, myref)
            else:
                mvp = mvp_general(own[2], ownr[2], True, own[1], ownr[1], True, own[0],
                                  ownr[0], True, myref)
            se(b, own[q][1] - mvp[1])
            se(b, own[q][0] - mvp[0])
    b.ue(VLC[OFF["cbp_inter"] + cbp])
    if cbp:
        b.put(1, 1)


def model_pack_p(mode, zdc, acz, czdc, cacz, mv, ref, active, nw, pmode=None, run=16):
    """H8's warp: a run of MBs of a row from the MB left of it (which only
    gives the left context); the last coded MB left of the run by ballots of
    mode != 0 over 32 columns moving left, then carried; a skipped MB
    neither read nor coded."""
    mb_h, mb_w = mode.shape
    plan = packer.pack_plan(mb_h, mb_w, run)
    words = np.zeros((mb_h, mb_w, nw), np.int64)
    nbits = np.zeros((mb_h, mb_w), np.int64)
    zero = (np.zeros(16, int), np.zeros(8, int))
    for gw in range(plan["warps"]):
        y, x0 = divmod(gw, plan["runs"])
        x0 *= plan["run"]
        last, c = -1, x0 - 1
        while c >= 0:
            ballot = [c - lane >= 0 and mode[y, c - lane] != 0 for lane in range(32)]
            if any(ballot):
                last = c - ballot.index(True)
                break
            c -= 32
        prev_counts, prev_md, pf = zero, 0, [0] * 32
        for x in range(max(x0 - 1, 0), min(mb_w, x0 + plan["run"])):
            md = int(mode[y, x])
            if md == 0:
                prev_counts, prev_md, pf = zero, 0, [0] * 32
                continue                      # zero words, no bits
            f = p_fields(md, (y, x), mv, ref, pmode)
            levels = tuple(a[y, x] for a in (zdc, acz, czdc, cacz))
            cnt = (levels[1] != 0).sum(-1)
            ccnt = (levels[3] != 0).sum(-1).reshape(8)
            if x < x0:
                prev_counts, prev_md, pf = (cnt, ccnt), md, f
                continue
            quad = [int((cnt.reshape(4, 4)[2 * (q >> 1):2 * (q >> 1) + 2,
                                           2 * (q & 1):2 * (q & 1) + 2] > 0).any())
                    for q in range(4)]
            any_luma = int(cnt.sum() > 0)
            cbp_chroma = 2 if ccnt.sum() else 1 if (levels[2] != 0).any() else 0
            cbp = quad[0] | quad[1] << 1 | quad[2] << 2 | quad[3] << 3 | cbp_chroma << 4
            intra = md >= 2
            pieces = []
            for lane in range(32):
                b = Writer()
                kind, bx, by = lane_role(lane)[:3]
                if kind == 0:
                    p_header(b, md, x - 1 - last, cbp, any_luma, cbp_chroma, f, prev_md, pf,
                             x == 0, pmode is not None, active)
                elif kind < 5:
                    on = {1: intra, 2: any_luma if intra else quad[(bx >> 1) + 2 * (by >> 1)],
                          3: cbp_chroma >= 1, 4: cbp_chroma == 2}[kind]
                    if on:
                        residual(b, lane, levels, (cnt, ccnt), prev_counts, x == 0,
                                 full=not intra)
                b.flush()
                pieces.append(b)
            words[y, x], nbits[y, x] = place(pieces, nw)
            last, prev_counts, prev_md, pf = x, (cnt, ccnt), md, f
    return words, nbits


def p_frame(seed, mb_w=MB_W):
    """A P frame's fields at 3 x ``mb_w`` MBs from the port's
    ``synthetic_p_fields`` (levels nonzero under skipped MBs too): row 0 of
    random modes (skip, inter, intra DC and HORIZONTAL), row 1 coded MBs
    at its start and its last two columns and a skip run between them
    across the start of a run, row 2 no coded MB; the inter MBs' partition
    modes in turn 0, 1, 2, 3."""
    rng = np.random.default_rng(seed)
    lead = 3 if mb_w >= 40 else 1
    mode = np.zeros((3, mb_w), np.int16)
    mode[0] = rng.choice([0, 0, 1, 1, 1, 2, 3], mb_w)
    mode[1, :lead] = rng.choice([1, 2, 3], lead)
    mode[1, -2:] = (1, 3)
    f = bitpack.synthetic_p_fields(rng, 3, mb_w, mode=mode)
    f["pmode"][mode == 1] = np.arange(int((mode == 1).sum())) % 4
    return tuple(f[k] for k in ("mode", "zdc", "acz", "czdc", "cacz")), f


# (mv, ref, active references) of P_16x16; (ref4, active references) of parts
P_LAYOUTS = {"p16_zero_motion": (False, False, 1), "p16_mv": (True, False, 1),
             "p16_two_refs": (True, True, 2), "parts_one_ref": (False, 1),
             "parts_two_refs": (True, 2)}


def p_args(layout, mb_w=MB_W):
    """pack_p_mbs's arguments and keywords for one of P_LAYOUTS."""
    lv, f = p_frame(11, mb_w)
    if layout.startswith("parts"):
        with_ref, active = P_LAYOUTS[layout]
        return (*lv, None, None, active), dict(pmode=f["pmode"], mv4=f["mv4"],
                                               ref4=f["ref4"] if with_ref else None)
    with_mv, with_ref, active = P_LAYOUTS[layout]
    return (*lv, f["mv"] if with_mv else None, f["ref"] if with_ref else None, active), {}


def jax_packed_p(layout, nw):
    """The JAX P packer's words and counts at a cap of ``nw`` words: its
    output at 64 words, once a layout, cut to the cap (an MB's words are
    the first 32 * cap bits of its string at any cap; its count is its
    true count)."""
    if layout not in _JAX:
        args, kw = p_args(layout)
        j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
        _JAX[layout] = tuple(np.asarray(a) for a in jax_bitpack.pack_p_mbs(
            *map(j, args[:7]), args[7], nw_mb=64, **{k: j(v) for k, v in kw.items()}))
    words, nbits = _JAX[layout]
    return words[..., :nw], nbits


def plain_packed_p(layout, nw):
    """The port's plain P packer's words and counts on rows of 40 MBs."""
    import torch

    if (layout, 40) not in _JAX:
        args, kw = p_args(layout, 40)
        t = lambda a: a if a is None or isinstance(a, int) else torch.from_numpy(a)  # noqa: E731
        _JAX[layout, 40] = tuple(a.numpy() for a in bitpack.pack_p_mbs_plain(
            *map(t, args), 64, **{k: t(v) for k, v in kw.items()}))
    words, nbits = _JAX[layout, 40]
    return words[..., :nw], nbits


@pytest.mark.parametrize("mb_w", [MB_W, 40])
def test_p_frame_holds_the_runs_the_design_must_meet(mb_w):
    """The fields above: every mode, a skip run across a run's start, a row
    with no coded MB, levels under skipped MBs, every partition mode; on
    rows of 40 a skip run of 35 whose last coded MB lies two ballots back."""
    (mode, _, acz, *_), f = p_frame(11, mb_w)
    assert set(np.unique(mode)) == {0, 1, 2, 3}
    lead = 3 if mb_w >= 40 else 1
    assert (mode[2] == 0).all() and (mode[1, lead:-2] == 0).all()
    assert (acz[mode == 0] != 0).any()
    assert set(np.unique(f["pmode"][mode == 1])) == {0, 1, 2, 3}
    if mb_w == 40:
        assert packer.pack_plan(3, 40, 16)["runs"] == 3 and mb_w - 2 - lead > 32


def check_model_p(layout, run, mb_w, want):
    args, kw = p_args(layout, mb_w)
    if kw:
        args = (*args[:5], kw["mv4"], kw["ref4"], args[7])    # the quadrant fields
    for nw in (64, 3):
        got_w, got_n = model_pack_p(*args, nw, pmode=kw.get("pmode"), run=run)
        want_w, want_n = want(layout, nw)
        assert np.array_equal(got_n, np.asarray(want_n)), nw
        assert np.array_equal(got_w, np.asarray(want_w).astype(np.int64)), nw
        if nw == 3:
            assert (got_n > 96).any()        # MBs over the cap keep their true count


@pytest.mark.parametrize("run", [1, 3, 16])
@pytest.mark.parametrize("layout", list(P_LAYOUTS))
def test_pack_p_model_equals_jax(layout, run):
    check_model_p(layout, run, MB_W, jax_packed_p)


@pytest.mark.parametrize("run", [1, 3, 16])
@pytest.mark.parametrize("layout", list(P_LAYOUTS))
def test_pack_p_model_on_rows_of_40_equals_plain(layout, run):
    check_model_p(layout, run, 40, plain_packed_p)


def test_pack_p_entries_launch_only_on_the_card():
    """pack_p_into and its floor refuse CPU levels; pack_p_mbs takes the
    plain version for them: no launch is counted."""
    import torch

    args, kw = p_args("parts_two_refs")
    t = lambda a: a if a is None or isinstance(a, int) else torch.from_numpy(a)  # noqa: E731
    args, kw = [t(a) for a in args], {k: t(v) for k, v in kw.items()}
    words = torch.zeros((MB_H, MB_W, 8), dtype=torch.uint32)
    nbits = torch.zeros((MB_H, MB_W), dtype=torch.int32)
    packer.reset_launch_counts()
    for fn in (packer.pack_p_into, packer.pack_p_floor_into):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, words, nbits, **kw)
    got = packer.pack_p_mbs(*args, 8, **kw)
    want = bitpack.pack_p_mbs_plain(*args, 8, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert packer.launch_counts() == {"pack_i_mbs": 0, "pack_p_mbs": 0}


def test_outputs_take_any_word_count():
    """No packer keeps an MB's words in shared memory: the wrappers take any
    nw_mb from 1, as the JAX package does."""
    import torch

    for nw in (1, 64, 2048):
        packer._outputs(torch.zeros((2, 3, nw), dtype=torch.uint32),
                        torch.zeros((2, 3), dtype=torch.int32), 2, 3, nw,
                        torch.device("cpu"))
    with pytest.raises(ValueError, match="at least 1"):
        packer._outputs(torch.zeros((2, 3, 0), dtype=torch.uint32),
                        torch.zeros((2, 3), dtype=torch.int32), 2, 3, 0, torch.device("cpu"))
