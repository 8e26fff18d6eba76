// H7 pack_i_kernel and H8 pack_p_kernel: the CAVLC bit strings of every
// macroblock (MB) of an H.264 intra frame and of a P frame, one slice per MB
// row, from the level buffers of H1 intra_levels_kernel and H2
// p_levels_kernel, on Hopper.
//
// H7 replaces opencv_opencl_tpu/ops/h264_bitpack.py:347 pack_i_mbs and H8
// :548 pack_p_mbs, XLA programs (no Pallas kernels).  Their plain PyTorch
// versions are pack_i_mbs_plain and pack_p_mbs_plain in
// opencv_opencl_tpu_torch/ops/h264_bitpack.py, the wrappers pack_i_mbs and
// pack_p_mbs in opencv_opencl_tpu_torch/ops/cuda/h264_bitpack.py.
//
// What they compute, for each MB: the MB header (I: mb_type, with
// Intra_4x4 the 16 prediction modes against the one-row-slice predicted
// mode, intra_chroma_pred_mode, coded_block_pattern and mb_qp_delta; P:
// mb_skip_run, mb_type, P_8x8's sub_mb_types, te(v) ref_idx with two active
// references, the mvds against the left-MB predictor or, with the
// partition modes, each partition's reference-aware predictor of spec
// 8.4.1.3 as the JAX _mvp_general_vec collapses it, cbp, mb_qp_delta), then
// the residual blocks (spec 9.2: coeff_token with nC from the left MB and
// the blocks above within the MB, the trailing-one signs, the levels with
// suffixLength and the escapes, total_zeros, run_before) gated by the cbp,
// in the bitstream's order: luma DC, the 16 luma blocks, the two chroma DC
// and the eight chroma AC blocks.  The words are MSB-first uint32, capped at
// nw_mb a MB: an MB over the cap reports its true bit count with its first
// 32 * nw_mb bits; a skipped MB reports 0 bits.  The bits equal the JAX
// functions' token for token: the same tokens (value, length) in the same
// order, so the same bit strings.
//
// Bound: bytes.  At 4K (135 x 240 MBs) H7 reads H1's 818 bytes a MB of
// int16 levels (26.5 MB) and writes 64 words and a count a MB (8.3 MB):
// about 35 MB, 0.0104 ms at 3.35 TB/s; H8 reads H2's 824 bytes a MB (844
// with the partition fields, ~27.5 MB) and writes the same, 0.0107 ms.
// Both are a warp per MB that counts the nonzero levels of the MB's 16 luma
// and 8 chroma blocks and of the left MB's blocks beside it, from which
// every lane derives the cbp and its block's nC; then lane k writes piece k
// (0 the header, 1 the luma DC, 2..17 the luma blocks in bitstream order,
// 18..19 chroma DC, 20..27 chroma AC); an exclusive warp scan of the piece
// lengths places the pieces.
//
// H7 (pack_i_kernel): a warp walks a run of MBs of one row (the wrapper's
// pack_plan: 16 at 4K), four warps a block, the VLC table staged into
// shared memory once a block.  An MB's levels are loaded once, in 16-byte
// units (a lane a unit of acz; 16 lanes cacz, the rest zdc and czdc), into
// a per-warp copy in shared memory; the counts come from the registers
// (the halves of a block on two lanes, a shuffle), the left MB's from the
// previous MB of the run (the run starts one MB early, counting only).  The
// 16 Intra_4x4 mode tokens are a lane's each (lanes 0-15, against the
// predicted mode from shuffles), placed by a scan of their lengths and
// OR-reduced into 64 bits for lane 0's header.  A residual lane reads its
// block (two 16-byte loads), orders it by the zigzag in registers and
// codes it in three unrolled passes over the 16 positions (the trailing
// ones, the levels with their suffixLength, total_zeros and the runs),
// writing tokens through a 64-bit register that stores each full word into
// its piece in shared memory: no zeroed buffer, no read-modify-write.  Each
// lane then builds output words lane, lane + 32, ... from the pieces that
// cover them (the first by a binary search over the starts) and stores
// them: no atomics.  pack_i_kernel<true> is its read-and-store floor (the
// same loads and stores, no tokens).
//
// H8 (pack_p_kernel), not yet redesigned: four MBs a block of 128 threads,
// the VLC table staged a block; each lane reads its block's levels from
// device memory in residual_piece, writes piece k into a zeroed bit buffer
// in shared memory, and the lanes OR their words into the MB's output words
// (atomicOr: two pieces may share a word), which the warp then stores.
//
// All arithmetic is int32 / uint32 and exact; `>>` of a signed int is
// arithmetic.  The launchers are extern "C", launch on the stream they are
// given, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // MBs a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPieceWords = 21;           // NW_BLOCK words and the writer's spill
// the VLC table's layout (ops/h264_bitpack.VLC_OFFSETS)
constexpr int kCtLen = 0, kCtCode = 204, kCdcLen = 408, kCdcCode = 428;
constexpr int kTzLen = 448, kTzCode = 704, kTzcLen = 960, kTzcCode = 976;
constexpr int kRbLen = 992, kRbCode = 1112, kCbpInter = 1232, kCbpIntra = 1280;
constexpr int kVlcSize = 1328;

__constant__ int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// the luma blocks' bitstream order as raster indices by * 4 + bx
__constant__ int kLumaScan[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// an MSB-first bit writer over zeroed words
struct Bits {
    uint32_t* w;
    int pos;
    __device__ void put(uint32_t v, int len) {
        if (len <= 0) return;
        v &= len >= 32 ? 0xffffffffu : ((1u << len) - 1u);
        const int wi = pos >> 5, off = pos & 31;
        const unsigned long long x = (unsigned long long)v << (64 - len - off);
        w[wi] |= (uint32_t)(x >> 32);
        w[wi + 1] |= (uint32_t)x;
        pos += len;
    }
    // Exp-Golomb ue(v), v < 2^15 (one token of at most 31 bits)
    __device__ void ue(int v) {
        const unsigned code = (unsigned)v + 1u;
        const int nbits = 32 - __clz(code);
        put(code, 2 * nbits - 1);
    }
    __device__ void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
};

// one residual block (spec 9.2): `lv` its C coefficients in scan order (low
// to high frequency), `nc` its nC (unused for chroma DC, `cdc`)
__device__ void block_bits(Bits& b, const int* lv, int C, int nc, bool cdc,
                           int max_coeffs, const int* vlc) {
    int vr[16], pr[16], total = 0;
    for (int p = C - 1; p >= 0; --p)
        if (lv[p] != 0) {
            vr[total] = lv[p];
            pr[total] = p;
            ++total;
        }
    int t1s = 0;
    while (t1s < 3 && t1s < total && abs(vr[t1s]) == 1) ++t1s;
    // coeff_token
    if (cdc) {
        b.put(vlc[kCdcCode + total * 4 + t1s], vlc[kCdcLen + total * 4 + t1s]);
    } else if (nc >= 8) {
        b.put(total == 0 ? 3 : ((total - 1) << 2) | t1s, 6);
    } else {
        const int k = ((nc < 2 ? 0 : nc < 4 ? 1 : 2) * 17 + total) * 4 + t1s;
        b.put(vlc[kCtCode + k], vlc[kCtLen + k]);
    }
    // the trailing-one signs, high frequency first, 1 negative
    unsigned signs = 0;
    for (int j = 0; j < t1s; ++j) signs = (signs << 1) | (vr[j] < 0 ? 1u : 0u);
    b.put(signs, t1s);
    // the other levels
    int sl = (total > 10 && t1s < 3) ? 1 : 0;
    for (int r = t1s; r < total; ++r) {
        const int c = vr[r];
        int lc = c > 0 ? 2 * c - 2 : -2 * c - 1;
        if (r == t1s && t1s < 3) lc -= 2;
        const int prefix = lc >> sl;
        const bool esc = sl == 0 ? lc >= 30 : prefix >= 15;
        if (esc) {
            b.put((1u << 12) | (unsigned)(lc - (sl == 0 ? 30 : 15 << sl)), 28);
        } else if (sl == 0) {
            if (lc >= 14) b.put((1u << 4) | (unsigned)(lc - 14), 19);
            else b.put(1u, lc + 1);
        } else {
            b.put((1u << sl) | (unsigned)(lc & ((1 << sl) - 1)), prefix + 1 + sl);
        }
        int sl2 = sl == 0 ? 1 : sl;
        if (abs(c) > (3 << (sl2 - 1)) && sl2 < 6) ++sl2;
        sl = sl2;
    }
    // total_zeros and run_before
    if (total > 0 && total < max_coeffs) {
        const int tz = pr[0] + 1 - total;
        if (cdc) {
            const int k = min(total, 3) * 4 + min(max(tz, 0), 3);
            b.put(vlc[kTzcCode + k], vlc[kTzcLen + k]);
        } else {
            const int k = min(total, 15) * 16 + min(max(tz, 0), 15);
            b.put(vlc[kTzCode + k], vlc[kTzLen + k]);
        }
        int zl = tz;
        for (int r = 0; r < min(C - 1, 14) && r <= total - 2 && zl > 0; ++r) {
            const int run = min(max(pr[r] - pr[r + 1] - 1, 0), 14);
            const int k = min(zl, 7) * 15 + run;
            b.put(vlc[kRbCode + k], vlc[kRbLen + k]);
            zl -= run;
        }
    }
}

// nC of block (bx, by) of a w x w grid of blocks (luma 4, chroma 2), from
// the MB's counts `own` (raster) and the left MB's column beside it `left`
// (0 at the picture's left edge): left only in the top row (the row above
// is another slice), else the rounded mean, or the top alone at the
// picture's left edge
__device__ __forceinline__ int nc_of(const int* own, const int* left, int w, int bx,
                                     int by, bool at_edge) {
    const int l = bx > 0 ? own[by * w + bx - 1] : left[by];
    if (by == 0) return l;
    const int t = own[(by - 1) * w + bx];
    return (bx == 0 && at_edge) ? t : (l + t + 1) >> 1;
}

__device__ __forceinline__ int count_nz(const int16_t* p, int n) {
    int c = 0;
    for (int i = 0; i < n; ++i) c += p[i] != 0;
    return c;
}

// the per-warp state of one MB
struct Mb {
    int nnz[16], lnnz[4], cnnz[8], lcnnz[4], cdc_any;
};

struct Levels {
    const int16_t *zdc, *acz, *czdc, *cacz;
};

// the residual piece of lane `lane` (1..27), gated; `i16` selects the 15+DC
// luma shape, `g_luma[q]` gates luma blocks by 8x8 quadrant
__device__ void residual_piece(Bits& b, int lane, long long mb, const Levels& L,
                               const Mb& s, bool dc_on, bool i16, const int* g_luma,
                               int cbp_chroma, bool at_edge, const int* vlc) {
    int lv[16];
    if (lane == 1) {
        if (!dc_on) return;
        for (int k = 0; k < 16; ++k) lv[k] = L.zdc[mb * 16 + kZigzag[k]];
        block_bits(b, lv, 16, s.lnnz[0], false, 16, vlc);
    } else if (lane < 18) {
        const int blk = kLumaScan[lane - 2], bx = blk & 3, by = blk >> 2;
        if (!g_luma[(bx >> 1) + 2 * (by >> 1)]) return;
        const int16_t* src = L.acz + (mb * 16 + blk) * 16;
        const int nc = nc_of(s.nnz, s.lnnz, 4, bx, by, at_edge);
        if (i16) {
            for (int k = 0; k < 15; ++k) lv[k] = src[kZigzag[k + 1]];
            block_bits(b, lv, 15, nc, false, 15, vlc);
        } else {
            for (int k = 0; k < 16; ++k) lv[k] = src[kZigzag[k]];
            block_bits(b, lv, 16, nc, false, 16, vlc);
        }
    } else if (lane < 20) {
        if (cbp_chroma < 1) return;
        const int comp = lane - 18;
        for (int k = 0; k < 4; ++k) lv[k] = L.czdc[mb * 8 + comp * 4 + k];
        block_bits(b, lv, 4, 0, true, 4, vlc);
    } else if (lane < 28) {
        if (cbp_chroma != 2) return;
        const int comp = (lane - 20) >> 2, blk = (lane - 20) & 3;
        const int16_t* src = L.cacz + ((mb * 2 + comp) * 4 + blk) * 16;
        for (int k = 0; k < 15; ++k) lv[k] = src[kZigzag[k + 1]];
        const int nc = nc_of(s.cnnz + 4 * comp, s.lcnnz + 2 * comp, 2, blk & 1, blk >> 1,
                             at_edge);
        block_bits(b, lv, 15, nc, false, 15, vlc);
    }
}

// phase 1: the nonzero counts of the MB's blocks and of the left MB's
// bordering ones (zero where `coded` says the MB is skipped)
__device__ void count_blocks(Mb& s, int lane, long long mb, bool left_ok, const Levels& L,
                             bool coded, bool left_coded) {
    if (lane < 16) {
        s.nnz[lane] = coded ? count_nz(L.acz + (mb * 16 + lane) * 16, 16) : 0;
    } else if (lane < 24) {
        const int k = lane - 16;
        s.cnnz[k] = coded ? count_nz(L.cacz + (mb * 8 + k) * 16, 16) : 0;
    } else if (lane < 28) {
        const int by = lane - 24;
        s.lnnz[by] = (left_ok && left_coded)
            ? count_nz(L.acz + ((mb - 1) * 16 + by * 4 + 3) * 16, 16) : 0;
    } else {
        const int k = lane - 28, comp = k >> 1, by = k & 1;
        s.lcnnz[k] = (left_ok && left_coded)
            ? count_nz(L.cacz + (((mb - 1) * 2 + comp) * 4 + by * 2 + 1) * 16, 16) : 0;
    }
    if (lane == 0) s.cdc_any = coded && count_nz(L.czdc + mb * 8, 8) > 0;
}

// the MB's summary from the counts: cbp luma (any), its 8x8 quadrants, cbp
// chroma
__device__ void summary(const Mb& s, int* quad, int& any_luma, int& cbp_chroma) {
    any_luma = 0;
    for (int q = 0; q < 4; ++q) {
        const int b0 = (q >> 1) * 8 + (q & 1) * 2;   // the quadrant's top-left block
        quad[q] = (s.nnz[b0] | s.nnz[b0 + 1] | s.nnz[b0 + 4] | s.nnz[b0 + 5]) != 0;
        any_luma |= quad[q];
    }
    int cac = 0;
    for (int k = 0; k < 8; ++k) cac |= s.cnnz[k];
    cbp_chroma = cac ? 2 : s.cdc_any ? 1 : 0;
}

// phase 3: place the pieces (an exclusive scan of their lengths), OR them
// into the MB's words, store; returns nothing, writes nbits
__device__ void place(uint32_t (*piece)[kPieceWords], uint32_t* out, int lane, int len,
                      int nw, long long mb, uint32_t* __restrict__ words,
                      int* __restrict__ nbits) {
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
    }
    const int start = incl - len;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    for (int k = lane; k < nw; k += 32) out[k] = 0u;
    __syncwarp();
    for (int j = 0; 32 * j < len; ++j) {
        const uint32_t w = piece[lane][j];
        const int bit = start + 32 * j, wi = bit >> 5, off = bit & 31;
        if (wi < nw) atomicOr(out + wi, w >> off);
        if (off && wi + 1 < nw) atomicOr(out + wi + 1, w << (32 - off));
    }
    __syncwarp();
    for (int k = lane; k < nw; k += 32) words[mb * nw + k] = out[k];
    if (lane == 0) nbits[mb] = total;
}

__device__ __forceinline__ void stage_vlc(int* dst, const int* __restrict__ vlc) {
    for (int i = threadIdx.x; i < kVlcSize; i += kThreads) dst[i] = vlc[i];
}

// ---------------------------------------------------------------------------
// H7's design: a warp walks a run of MBs of one row (ops/cuda/h264_bitpack
// .pack_plan), kPackWarps warps a block, the VLC table staged once a block.
constexpr int kPackWarps = 4;
constexpr int kPackThreads = 32 * kPackWarps;
constexpr int kPieceStride = 23;   // words of a lane's piece (21) and the reader's spill, odd
// a warp's MB in shared memory, in 16-byte units: acz (32), cacz (16), zdc
// (2), czdc (1)
constexpr int kUnitCacz = 32, kUnitZdc = 48, kUnitCzdc = 50, kUnits = 51;
constexpr unsigned kFull = 0xffffffffu;
// the zigzag scan (kZigzag) as nibbles, folded at compile time in unrolled loops
__host__ __device__ constexpr int zig(int k) { return (int)((0xfeb7adc963258410ull >> (4 * k)) & 15); }
// the z-scan index of luma block (bx, by)
__device__ __forceinline__ int z_index(int bx, int by) {
    return (bx & 1) | ((by & 1) << 1) | ((bx & 2) << 1) | ((by & 2) << 2);
}

// an MSB-first bit writer in a register that stores each full word to `w`
struct RegBits {
    uint32_t* w;
    unsigned long long acc;
    int n, pos, wi;
    __device__ void put(uint32_t v, int len) {
        v &= len >= 32 ? 0xffffffffu : ((1u << len) - 1u);
        acc = (acc << len) | v;
        n += len;
        pos += len;
        if (n >= 32) {
            n -= 32;
            w[wi++] = (uint32_t)(acc >> n);
        }
    }
    __device__ void ue(int v) {
        const unsigned code = (unsigned)v + 1u;
        const int nbits = 32 - __clz(code);
        put(code, 2 * nbits - 1);
    }
    __device__ void flush() {
        if (n > 0) w[wi++] = (uint32_t)(acc << (32 - n));
    }
};

// one residual block (spec 9.2), block_bits's tokens: `lv` its levels in
// scan order (zeros past its C coefficients) in registers, `src` the same
// levels in shared memory, position p at src[raster(p)]; the trailing ones
// from the top three bits of the nonzero mask, then the other levels and
// the runs by walking the mask's bits down, each token's value and length
// chosen without a branch
template <class Raster>
__device__ void block_regs(RegBits& b, const int (&lv)[16], const int16_t* src, Raster raster,
                           int nc, bool cdc, int max_coeffs, const int* vlc) {
    unsigned nzm = 0, ones = 0, neg = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
        nzm |= (unsigned)(lv[p] != 0) << p;
        ones |= (unsigned)(abs(lv[p]) == 1) << p;
        neg |= (unsigned)(lv[p] < 0) << p;
    }
    const int total = __popc(nzm);
    // the trailing ones and their signs, high frequency first
    int t1s = 0;
    unsigned signs = 0, rest = nzm;
    bool run1 = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int p = 31 - __clz(rest);
        run1 = run1 && rest != 0 && ((ones >> p) & 1);
        if (run1) {
            ++t1s;
            signs = (signs << 1) | ((neg >> p) & 1);
            rest ^= 1u << p;
        }
    }
    if (cdc) {
        b.put(vlc[kCdcCode + total * 4 + t1s], vlc[kCdcLen + total * 4 + t1s]);
    } else if (nc >= 8) {
        b.put(total == 0 ? 3 : ((total - 1) << 2) | t1s, 6);
    } else {
        const int k = ((nc < 2 ? 0 : nc < 4 ? 1 : 2) * 17 + total) * 4 + t1s;
        b.put(vlc[kCtCode + k], vlc[kCtLen + k]);
    }
    b.put(signs, t1s);
    // the other levels, r their index among the nonzero ones
    int sl = (total > 10 && t1s < 3) ? 1 : 0;
    for (int r = t1s; rest != 0; ++r) {
        const int p = 31 - __clz(rest);
        rest ^= 1u << p;
        const int c = src[raster(p)];
        int lc = c > 0 ? 2 * c - 2 : -2 * c - 1;
        if (r == t1s && t1s < 3) lc -= 2;
        const int prefix = lc >> sl;
        const bool esc = sl == 0 ? lc >= 30 : prefix >= 15;
        const unsigned plain0 = lc >= 14 ? (1u << 4) | (unsigned)(lc - 14) : 1u;
        const unsigned plain = sl == 0 ? plain0 : (1u << sl) | (unsigned)(lc & ((1 << sl) - 1));
        const int len0 = lc >= 14 ? 19 : lc + 1;
        b.put(esc ? (1u << 12) | (unsigned)(lc - (sl == 0 ? 30 : 15 << sl)) : plain,
              esc ? 28 : sl == 0 ? len0 : prefix + 1 + sl);
        int sl2 = sl == 0 ? 1 : sl;
        if (abs(c) > (3 << (sl2 - 1)) && sl2 < 6) ++sl2;
        sl = sl2;
    }
    // total_zeros, then run_before below each nonzero level but the last
    if (total > 0 && total < max_coeffs) {
        const int top = 31 - __clz(nzm);
        const int tz = top + 1 - total;
        if (cdc) {
            const int k = min(total, 3) * 4 + min(max(tz, 0), 3);
            b.put(vlc[kTzcCode + k], vlc[kTzcLen + k]);
        } else {
            const int k = min(total, 15) * 16 + min(max(tz, 0), 15);
            b.put(vlc[kTzCode + k], vlc[kTzLen + k]);
        }
        int zl = tz, prev = top;
        rest = nzm ^ (1u << top);
        for (int r = 0; rest != 0 && zl > 0 && r < 14; ++r) {
            const int p = 31 - __clz(rest);
            rest ^= 1u << p;
            const int run = min(max(prev - p - 1, 0), 14);
            const int k = min(zl, 7) * 15 + run;
            b.put(vlc[kRbCode + k], vlc[kRbLen + k]);
            zl -= run;
            prev = p;
        }
    }
}

// 16 int16 of two 16-byte units
__device__ __forceinline__ void unpack16(uint4 a, uint4 c, int* r) {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        r[2 * k] = (int)(short)(w[k] & 0xffffu);
        r[2 * k + 1] = (int)(w[k]) >> 16;
    }
}

// a unit of 8 int16 levels from device memory (16-byte loads where `vec`)
__device__ __forceinline__ uint4 load_unit(const int16_t* __restrict__ p, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        w[k] = ((uint32_t)(uint16_t)p[2 * k]) | ((uint32_t)(uint16_t)p[2 * k + 1] << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int nz8(uint4 u) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) c += ((w[k] & 0xffffu) != 0) + ((w[k] >> 16) != 0);
    return c;
}

// a lane's piece (0 the header, 1 the luma DC, 2..17 the luma blocks in
// bitstream order, 18..19 chroma DC, 20..27 chroma AC, 28..31 none) and
// its block's place: the units it reads, its grid (4 luma, 2 chroma), its
// (bx, by), the index of its block, the left MB's block beside it and the
// block above in their grids' count lanes
struct PieceRole {
    int kind, u0, u1, bx, by, quad, left, above, comp;
    __device__ explicit PieceRole(int lane) {
        kind = lane == 0 ? 0 : lane == 1 ? 1 : lane < 18 ? 2 : lane < 20 ? 3 : lane < 28 ? 4 : 5;
        bx = by = comp = 0;
        int blk = 0;
        if (kind == 2) {
            // kLumaScan: bitstream order -> raster
            const int i = lane - 2;
            bx = (i & 1) | ((i >> 1) & 2);
            by = ((i >> 1) & 1) | ((i >> 2) & 2);
            blk = by * 4 + bx;
            u0 = 2 * blk;
            left = bx > 0 ? blk - 1 : by * 4 + 3;
            above = blk - 4;
        } else if (kind == 4) {
            comp = (lane - 20) >> 2;
            const int cb = (lane - 20) & 3;
            bx = cb & 1;
            by = cb >> 1;
            blk = comp * 4 + cb;
            u0 = kUnitCacz + 2 * blk;
            left = bx > 0 ? blk - 1 : comp * 4 + by * 2 + 1;
            above = blk - 2;
        } else if (kind == 1) {
            u0 = kUnitZdc;
            left = 3;          // the left MB's block (0, 3)
            above = 0;
        } else {
            u0 = kind == 3 ? kUnitCzdc : 0;
            left = above = 0;
            comp = lane - 18;
        }
        u1 = kind == 3 ? u0 : u0 + 1;
        quad = (bx >> 1) + 2 * (by >> 1);
    }
};

// H7.  With kFloor the same loads and stores and no tokens (zero words and
// counts): the kernel's read-and-store floor
template <bool kFloor>
__global__ void __launch_bounds__(kPackThreads)
pack_i_kernel(Levels L, const int16_t* __restrict__ imode,
              const int16_t* __restrict__ i4modes, const int16_t* __restrict__ cmode,
              int mb_h, int mb_w, int run, const int* __restrict__ vlc_g, int nw, int vec,
              uint32_t* __restrict__ words, int* __restrict__ nbits) {
    __shared__ int vlc[kVlcSize];
    __shared__ uint4 mbl[kPackWarps][kUnits];
    __shared__ uint32_t piece[kPackWarps][32 * kPieceStride];
    __shared__ int starts[kPackWarps][32];
    for (int i = threadIdx.x; i < kVlcSize; i += kPackThreads) vlc[i] = vlc_g[i];
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int runs = (mb_w + run - 1) / run;
    const long long gw = (long long)blockIdx.x * kPackWarps + warp;
    if (gw >= (long long)mb_h * runs) return;        // the whole warp
    const int mby = (int)(gw / runs), x0 = (int)(gw % runs) * run;
    const int x1 = min(mb_w, x0 + run);
    const PieceRole role(lane);
    uint4* sm = mbl[warp];
    uint32_t* mine = piece[warp] + lane * kPieceStride;
    int* st = starts[warp];
    // the previous MB's counts (lane 2b: luma block b in bits 0-7, chroma
    // block b in 8-15), Intra_4x4 modes (lane z: mode z) and its type
    int prevc = 0, prevm = 2;
    bool prev_i4 = false;
    // from the MB left of the run: its counts and modes, no tokens
    for (int mbx = x0 > 0 ? x0 - 1 : 0; mbx < x1; ++mbx) {
        const long long mb = (long long)mby * mb_w + mbx;
        const bool warm = mbx < x0;
        // ---- the MB's levels, loaded once: 16-byte units into shared memory
        const uint4 ua = load_unit(L.acz + mb * 256 + 8 * lane, vec);
        const uint4 uc = lane < 16 ? load_unit(L.cacz + mb * 128 + 8 * lane, vec)
                                   : lane < 18 ? load_unit(L.zdc + mb * 16 + 8 * (lane - 16), vec)
                                   : lane == 18 ? load_unit(L.czdc + mb * 8, vec)
                                                : make_uint4(0, 0, 0, 0);
        const int md = imode[mb];
        const bool i4 = i4modes != nullptr && md == 0;
        const int zmode = i4modes != nullptr ? i4modes[mb * 16 + (lane & 15)] : 2;
        const int cm = cmode != nullptr ? cmode[mb] : 0;
        sm[lane] = ua;
        if (lane < 19) sm[lane < 16 ? kUnitCacz + lane : kUnitZdc + lane - 16] = uc;
        __syncwarp();
        if (kFloor) {
            if (!warm) {
                for (int j = lane; j < nw; j += 32) {
                    const uint4 u = sm[j % kUnits];
                    words[mb * nw + j] = u.x ^ u.y ^ u.z ^ u.w ^ (uint32_t)(md + zmode + cm);
                }
                if (lane == 0) nbits[mb] = 0;
            }
            __syncwarp();
            continue;
        }
        // ---- the nonzero counts of the MB's blocks from the registers
        int cl = nz8(ua), cc = lane < 16 ? nz8(uc) : 0;
        cl += __shfl_xor_sync(kFull, cl, 1);
        cc += __shfl_xor_sync(kFull, cc, 1);
        const int cnt = cl | (cc << 8);
        const unsigned lmask = __ballot_sync(kFull, cl > 0) & 0x55555555u;   // bit 2b: block b
        const unsigned cmask = __ballot_sync(kFull, lane < 16 && cc > 0);
        const bool cdc_any = __ballot_sync(kFull, lane == 18 && nz8(uc) > 0) != 0;
        const int cbp_chroma = cmask ? 2 : cdc_any ? 1 : 0;
        const int any_luma = lmask != 0;
        int q4 = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int b0 = (q >> 1) * 8 + (q & 1) * 2;
            const unsigned qm = (1u << (2 * b0)) | (1u << (2 * b0 + 2)) | (1u << (2 * b0 + 8))
                                | (1u << (2 * b0 + 10));
            q4 |= ((lmask & qm) != 0) << q;
        }
        // ---- the Intra_4x4 mode tokens, lane z of 0-15 sub-block z's
        // against the one-row-slice predicted mode
        const int z = lane & 15;
        const int zbx = (z & 1) | ((z >> 1) & 2), zby = ((z >> 1) & 1) | ((z >> 2) & 2);
        const int top = __shfl_sync(kFull, zmode, z_index(zbx, zby - 1));
        const int lft = __shfl_sync(kFull, zmode, z_index(zbx - 1, zby));
        const int lft_mb = __shfl_sync(kFull, prevm, z_index(3, zby));
        int predm = 2;
        if (zby > 0) {
            if (zbx > 0) predm = min(lft, top);
            else if (mbx > 0) predm = min(prev_i4 ? lft_mb : 2, top);
        }
        const bool hit = zmode == predm;
        const int tlen = lane < 16 ? (hit ? 1 : 4) : 0;
        const unsigned tval = hit ? 1u : (unsigned)(zmode < predm ? zmode : zmode - 1);
        int tend = tlen;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
            const int t = __shfl_up_sync(kFull, tend, o);
            if ((lane & 15) >= o) tend += t;
        }
        const int mlen = __shfl_sync(kFull, tend, 15);
        const unsigned long long tok =
            tlen ? (unsigned long long)tval << (64 - tend) : 0ull;
        const unsigned mhi = __reduce_or_sync(kFull, (unsigned)(tok >> 32));
        const unsigned mlo = __reduce_or_sync(kFull, (unsigned)tok);
        if (warm) {
            prevc = cnt;
            prevm = zmode;
            prev_i4 = i4;
            __syncwarp();
            continue;
        }
        // ---- the lane's neighbours' counts: nC
        const int left_c = __shfl_sync(kFull, cnt, 2 * role.left);
        const int above_c = __shfl_sync(kFull, cnt, 2 * max(role.above, 0));
        const int leftmb_c = __shfl_sync(kFull, prevc, 2 * role.left);
        const int sh = role.kind == 4 ? 8 : 0;
        const bool at_edge = mbx == 0;
        const int lcount = (role.bx > 0 ? left_c : at_edge ? 0 : leftmb_c) >> sh & 255;
        const int tcount = (above_c >> sh) & 255;
        const int nc = role.by == 0 ? lcount
                       : (role.bx == 0 && at_edge) ? tcount : (lcount + tcount + 1) >> 1;
        // ---- the piece
        RegBits b{mine, 0ull, 0, 0, 0};
        if (role.kind == 0) {
            if (i4) {
                b.put(1u, 1);                              // mb_type I_NxN, ue(0)
                if (mlen > 32) {
                    b.put(mhi, 32);
                    b.put(mlo >> (64 - mlen), mlen - 32);
                } else {
                    b.put(mhi >> (32 - mlen), mlen);
                }
                b.ue(cm);
                const int cbp4 = q4 | (cbp_chroma << 4);
                b.ue(vlc[kCbpIntra + cbp4]);
                if (cbp4 != 0) b.put(1u, 1);               // mb_qp_delta se(0)
            } else {
                b.ue(1 + md + 4 * cbp_chroma + 12 * any_luma);
                b.ue(cm);
                b.put(1u, 1);
            }
        } else if (role.kind < 5) {
            const bool on = role.kind == 1 ? !i4
                            : role.kind == 2 ? (i4 ? (q4 >> role.quad) & 1 : any_luma)
                            : role.kind == 3 ? cbp_chroma >= 1 : cbp_chroma == 2;
            if (on) {
                int r[16], lv[16];
                unpack16(sm[role.u0], sm[role.u1], r);
                const bool full = role.kind == 1 || (role.kind == 2 && i4);
                const bool cdc = role.kind == 3;
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    const int ac = k < 15 ? r[zig(k + 1)] : 0;
                    const int dc = k < 4 ? (role.comp ? r[4 + k] : r[k]) : 0;
                    lv[k] = cdc ? dc : full ? r[zig(k)] : ac;
                }
                // scan position p's raster index in the lane's units
                const int first = cdc ? 4 * role.comp : full ? 0 : 1;
                const auto raster = [cdc, first](int p) { return cdc ? first + p : zig(p + first); };
                block_regs(b, lv, reinterpret_cast<const int16_t*>(sm + role.u0), raster, nc, cdc,
                           cdc ? 4 : full ? 16 : 15, vlc);
            }
        }
        b.flush();
        // ---- the pieces' places: a warp scan of their lengths; each lane
        // then builds output words lane, lane + 32, ... from the pieces
        // that cover them
        int incl = b.pos;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += t;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        st[lane] = incl - b.pos;
        __syncwarp();
        for (int j = lane; j < nw; j += 32) {
            const int lo = 32 * j, hi = lo + 32;
            uint32_t out = 0;
            if (lo < total) {
                // the last piece that starts at or before bit lo
                int k = 0;
#pragma unroll
                for (int step = 16; step > 0; step >>= 1)
                    if (k + step < 32 && st[k + step] <= lo) k += step;
                for (; k < 28 && st[k] < hi; ++k) {
                    const int end = k < 31 ? st[k + 1] : total;
                    const int a = max(lo, st[k]), e = min(hi, end);
                    if (e <= a) continue;
                    const uint32_t* pb = piece[warp] + k * kPieceStride;
                    const int off = a - st[k], n = e - a;
                    const unsigned long long two =
                        ((unsigned long long)pb[off >> 5] << 32) | pb[(off >> 5) + 1];
                    const uint32_t v = (uint32_t)((two << (off & 31)) >> 32) >> (32 - n);
                    out |= v << (hi - e);
                }
            }
            words[mb * nw + j] = out;
        }
        if (lane == 0) nbits[mb] = total;
        prevc = cnt;
        prevm = zmode;
        prev_i4 = i4;
        __syncwarp();
    }
}

// spec 8.4.1.3.1's general process as the JAX _mvp_general_vec collapses it
// (the copy rule, the exactly-one-refIdx-match rule, the component median)
__device__ void mvp_general(const int* amv, int aref, bool aav, const int* bmv, int bref,
                            bool bav, const int* cmv, int cref, bool cav, int myref,
                            int* out) {
    int ea[2], eb[2], ec[2];
    for (int k = 0; k < 2; ++k) {
        ea[k] = aav ? amv[k] : 0;
        eb[k] = bav ? bmv[k] : 0;
        ec[k] = cav ? cmv[k] : 0;
    }
    const int ear = aav ? aref : -1, ebr = bav ? bref : -1, ecr = cav ? cref : -1;
    const bool ma = ear == myref, mb = ebr == myref, mc = ecr == myref;
    const int nm = ma + mb + mc;
    for (int k = 0; k < 2; ++k) {
        if (!bav && !cav && aav) out[k] = ea[k];
        else if (nm == 1) out[k] = ma ? ea[k] : mb ? eb[k] : ec[k];
        else out[k] = max(min(ea[k], eb[k]), min(max(ea[k], eb[k]), ec[k]));
    }
}

__global__ void __launch_bounds__(kThreads)
pack_p_kernel(Levels L, const int16_t* __restrict__ mode, const int16_t* __restrict__ mv,
              const int16_t* __restrict__ ref, const int16_t* __restrict__ pmode,
              int active_refs, int mb_h, int mb_w, const int* __restrict__ vlc_g, int nw,
              uint32_t* __restrict__ words, int* __restrict__ nbits) {
    __shared__ int vlc[kVlcSize];
    __shared__ Mb ms[kWarps];
    __shared__ uint32_t piece[kWarps][32][kPieceWords];
    extern __shared__ uint32_t outs[];
    stage_vlc(vlc, vlc_g);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long mb = (long long)blockIdx.x * kWarps + warp;
    if (mb >= (long long)mb_h * mb_w) return;
    const int mbx = (int)(mb % mb_w);
    const int md = mode[mb];
    const bool coded = md != 0, intra = md >= 2;
    const int lmd = mbx > 0 ? mode[mb - 1] : 0;
    Mb& s = ms[warp];
    count_blocks(s, lane, mb, mbx > 0, L, coded, lmd != 0);
    __syncwarp();
    int quad[4], any_luma, cbp_chroma;
    summary(s, quad, any_luma, cbp_chroma);

    uint32_t* buf = piece[warp][lane];
    for (int j = 0; j < kPieceWords; ++j) buf[j] = 0u;
    Bits b{buf, 0};
    if (!coded) {
        // a skipped MB: no bits
    } else if (lane == 0) {
        int prev = mbx - 1;
        while (prev >= 0 && mode[mb - (mbx - prev)] == 0) --prev;
        b.ue(mbx - prev - 1);                                  // mb_skip_run
        const int cbp = quad[0] | (quad[1] << 1) | (quad[2] << 2) | (quad[3] << 3)
                        | (cbp_chroma << 4);
        if (intra) {
            b.ue(5 + 1 + (md == 3 ? 1 : 2) + 4 * cbp_chroma + 12 * any_luma);
            b.put(1u, 1);                                      // intra_chroma_pred_mode
            b.put(1u, 1);                                      // mb_qp_delta
        } else if (pmode == nullptr) {
            int mvd[2];
            for (int k = 0; k < 2; ++k) {
                const int own = mv != nullptr ? mv[2 * mb + k] : 0;
                const int left = (lmd == 1 && mv != nullptr) ? mv[2 * (mb - 1) + k] : 0;
                mvd[k] = own - left;
            }
            b.put(1u, 1);                                      // P_L0_16x16, ue(0)
            if (active_refs == 2) b.put((unsigned)(1 - (ref != nullptr ? ref[mb] : 0)), 1);
            b.se(mvd[1]);
            b.se(mvd[0]);
            b.ue(vlc[kCbpInter + cbp]);
            if (cbp != 0) b.put(1u, 1);
        } else {
            const int pm = pmode[mb];
            int own[4][2], ownr[4];
            for (int q = 0; q < 4; ++q) {
                own[q][0] = mv[8 * mb + 2 * q];
                own[q][1] = mv[8 * mb + 2 * q + 1];
                ownr[q] = ref != nullptr ? ref[4 * mb + q] : 0;
            }
            // the left MB's quadrants 1 and 3 (a skipped left MB carries
            // (0, 0) on reference 0; an intra one is no inter neighbour)
            const bool left_ok = mbx > 0, li = left_ok && (lmd == 1 || lmd == 0);
            int a1[2] = {0, 0}, a3[2] = {0, 0}, a1r = -1, a3r = -1;
            if (li) {
                const bool sk = lmd == 0;
                for (int k = 0; k < 2; ++k) {
                    a1[k] = sk ? 0 : mv[8 * (mb - 1) + 2 + k];
                    a3[k] = sk ? 0 : mv[8 * (mb - 1) + 6 + k];
                }
                a1r = sk ? 0 : (ref != nullptr ? ref[4 * (mb - 1) + 1] : 0);
                a3r = sk ? 0 : (ref != nullptr ? ref[4 * (mb - 1) + 3] : 0);
            }
            const int nparts = pm == 0 ? 1 : pm == 3 ? 4 : 2;
            // each partition's representative quadrant
            const int rep[4] = {0, pm == 1 ? 2 : 1, 2, 3};
            const int z2[2] = {0, 0};
            int mvd[4][2];
            for (int p = 0; p < nparts; ++p) {
                const int q = rep[p], myref = ownr[q];
                int mvp[2];
                if (p == 0) {
                    mvp_general(a1, a1r, left_ok, z2, -1, false, z2, -1, false, myref, mvp);
                } else if (p == 1) {
                    if (pm == 1) {
                        if (left_ok && a3r == myref) {
                            mvp[0] = a3[0];
                            mvp[1] = a3[1];
                        } else {
                            mvp_general(a3, a3r, left_ok, own[0], ownr[0], true, a1, a1r,
                                        left_ok, myref, mvp);
                        }
                    } else {
                        mvp[0] = own[0][0];
                        mvp[1] = own[0][1];
                    }
                } else if (p == 2) {
                    mvp_general(a3, a3r, left_ok, own[0], ownr[0], true, own[1], ownr[1],
                                true, myref, mvp);
                } else {
                    mvp_general(own[2], ownr[2], true, own[1], ownr[1], true, own[0],
                                ownr[0], true, myref, mvp);
                }
                mvd[p][0] = own[q][0] - mvp[0];
                mvd[p][1] = own[q][1] - mvp[1];
            }
            b.ue(pm);                                          // mb_type
            if (pm == 3)
                for (int k = 0; k < 4; ++k) b.put(1u, 1);      // sub_mb_type 8x8
            if (active_refs == 2)
                for (int p = 0; p < nparts; ++p) b.put((unsigned)(1 - ownr[rep[p]]), 1);
            for (int p = 0; p < nparts; ++p) {
                b.se(mvd[p][1]);
                b.se(mvd[p][0]);
            }
            b.ue(vlc[kCbpInter + cbp]);
            if (cbp != 0) b.put(1u, 1);
        }
    } else {
        const int g_i16[4] = {any_luma, any_luma, any_luma, any_luma};
        residual_piece(b, lane, mb, L, s, intra, intra, intra ? g_i16 : quad, cbp_chroma,
                       mbx == 0, vlc);
    }
    __syncwarp();
    place(piece[warp], outs + warp * nw, lane, lane < 28 ? b.pos : 0, nw, mb, words, nbits);
}

}  // namespace

// `run`: the MBs of a row a warp walks (ops/cuda/h264_bitpack.pack_plan);
// `floor`: launch the read-and-store floor instead (no tokens, zero counts)
extern "C" int pack_i_launch(const int16_t* zdc, const int16_t* acz, const int16_t* czdc,
                             const int16_t* cacz, const int16_t* imode,
                             const int16_t* i4modes, const int16_t* cmode, int mb_h,
                             int mb_w, const int* vlc, int nw, int run, int floor,
                             uint32_t* words, int* nbits, void* stream) {
    const long long n = (long long)mb_h * mb_w;
    if (n <= 0) return (int)cudaGetLastError();
    if (run < 1) return (int)cudaErrorInvalidValue;
    const Levels L{zdc, acz, czdc, cacz};
    const long long warps = (long long)mb_h * ((mb_w + run - 1) / run);
    const unsigned blocks = (unsigned)((warps + kPackWarps - 1) / kPackWarps);
    const int vec = (((uintptr_t)zdc | (uintptr_t)acz | (uintptr_t)czdc | (uintptr_t)cacz) & 15) == 0;
    if (floor)
        pack_i_kernel<true><<<blocks, kPackThreads, 0, (cudaStream_t)stream>>>(
            L, imode, i4modes, cmode, mb_h, mb_w, run, vlc, nw, vec, words, nbits);
    else
        pack_i_kernel<false><<<blocks, kPackThreads, 0, (cudaStream_t)stream>>>(
            L, imode, i4modes, cmode, mb_h, mb_w, run, vlc, nw, vec, words, nbits);
    return (int)cudaGetLastError();
}

extern "C" int pack_p_launch(const int16_t* mode, const int16_t* zdc, const int16_t* acz,
                             const int16_t* czdc, const int16_t* cacz, const int16_t* mv,
                             const int16_t* ref, const int16_t* pmode, int active_refs,
                             int mb_h, int mb_w, const int* vlc, int nw, uint32_t* words,
                             int* nbits, void* stream) {
    const long long n = (long long)mb_h * mb_w;
    if (n > 0) {
        const Levels L{zdc, acz, czdc, cacz};
        const size_t smem = sizeof(uint32_t) * kWarps * nw;
        pack_p_kernel<<<(unsigned)((n + kWarps - 1) / kWarps), kThreads, smem,
                        (cudaStream_t)stream>>>(L, mode, mv, ref, pmode, active_refs, mb_h,
                                                mb_w, vlc, nw, words, nbits);
    }
    return (int)cudaGetLastError();
}
