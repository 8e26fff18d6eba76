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
// What really bounds this simple design is the serial token loop of a
// lane (up to 34 tokens a block, data-dependent branches) and the
// divergence between the lanes of a warp.  Design: one warp per MB, four
// MBs a block of 128 threads.  The lanes first count the nonzero levels of
// the MB's 16 luma and 8 chroma blocks and of the left MB's blocks that
// border it (shared memory), from which every lane derives the cbp and
// its block's nC; then lane k writes piece k (0 the header, 1 the luma DC,
// 2..17 the luma blocks, 18..19 chroma DC, 20..27 chroma AC) into its own
// bit buffer in shared memory; an exclusive warp scan of the piece lengths
// places the pieces, and the lanes OR their words, shifted, into the MB's
// output words in shared memory (atomicOr: two pieces may share a word),
// which the warp then stores.  The VLC tables come once a launch from the
// device table the wrapper uploads (built on the host from the port's
// io/h264_cavlc.py dicts) into shared memory.  Several MBs a warp and
// fewer branches are for a later change.
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
// the z-scan index of raster block [by * 4 + bx], and the reverse (the
// same permutation)
__constant__ int kZOfRaster[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

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

__global__ void __launch_bounds__(kThreads)
pack_i_kernel(Levels L, const int16_t* __restrict__ imode,
              const int16_t* __restrict__ i4modes, const int16_t* __restrict__ cmode,
              int mb_h, int mb_w, const int* __restrict__ vlc_g, int nw,
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
    Mb& s = ms[warp];
    count_blocks(s, lane, mb, mbx > 0, L, true, true);
    __syncwarp();
    int quad[4], any_luma, cbp_chroma;
    summary(s, quad, any_luma, cbp_chroma);
    const bool i4 = i4modes != nullptr && imode[mb] == 0;

    uint32_t* buf = piece[warp][lane];
    for (int j = 0; j < kPieceWords; ++j) buf[j] = 0u;
    Bits b{buf, 0};
    if (lane == 0) {
        const int cm = cmode != nullptr ? cmode[mb] : 0;
        if (i4) {
            const int16_t* zm = i4modes + mb * 16;
            const bool left_i4 = mbx > 0 && imode[mb - 1] == 0;
            b.put(1u, 1);                              // mb_type I_NxN, ue(0)
            for (int z = 0; z < 16; ++z) {
                const int r = kZOfRaster[z], bx = r & 3, by = r >> 2;   // z -> raster
                int predm = 2;
                if (by > 0) {
                    const int top = zm[kZOfRaster[(by - 1) * 4 + bx]];
                    if (bx > 0) {
                        predm = min(zm[kZOfRaster[by * 4 + bx - 1]], top);
                    } else if (mbx > 0) {
                        const int la = left_i4 ? i4modes[(mb - 1) * 16 + kZOfRaster[by * 4 + 3]]
                                               : 2;
                        predm = min(la, top);
                    }
                }
                const int m = zm[z];
                if (m == predm) b.put(1u, 1);
                else b.put((unsigned)(m < predm ? m : m - 1), 4);
            }
            b.ue(cm);
            const int cbp4 = quad[0] | (quad[1] << 1) | (quad[2] << 2) | (quad[3] << 3)
                             | (cbp_chroma << 4);
            b.ue(vlc[kCbpIntra + cbp4]);
            if (cbp4 != 0) b.put(1u, 1);               // mb_qp_delta se(0)
        } else {
            b.ue(1 + imode[mb] + 4 * cbp_chroma + 12 * any_luma);
            b.ue(cm);
            b.put(1u, 1);
        }
    } else {
        const int g_i16[4] = {any_luma, any_luma, any_luma, any_luma};
        residual_piece(b, lane, mb, L, s, !i4, !i4, i4 ? quad : g_i16, cbp_chroma, mbx == 0,
                       vlc);
    }
    __syncwarp();
    place(piece[warp], outs + warp * nw, lane, lane < 28 ? b.pos : 0, nw, mb, words, nbits);
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

extern "C" int pack_i_launch(const int16_t* zdc, const int16_t* acz, const int16_t* czdc,
                             const int16_t* cacz, const int16_t* imode,
                             const int16_t* i4modes, const int16_t* cmode, int mb_h,
                             int mb_w, const int* vlc, int nw, uint32_t* words, int* nbits,
                             void* stream) {
    const long long n = (long long)mb_h * mb_w;
    if (n > 0) {
        const Levels L{zdc, acz, czdc, cacz};
        const size_t smem = sizeof(uint32_t) * kWarps * nw;
        pack_i_kernel<<<(unsigned)((n + kWarps - 1) / kWarps), kThreads, smem,
                        (cudaStream_t)stream>>>(L, imode, i4modes, cmode, mb_h, mb_w, vlc,
                                                nw, words, nbits);
    }
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
