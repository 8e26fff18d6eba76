// H1 intra_levels_kernel and H2 p_levels_kernel: the quantized CAVLC levels,
// the mode decisions and the reconstruction of one H.264 intra frame (H1)
// or P frame (H2), one slice per macroblock (MB) row, on Hopper.
//
// H1 replaces opencv_opencl_tpu/ops/h264_levels.py:279 encode_levels, H2
// :1487 encode_p_levels (after the motion search): XLA lax.scans over the MB
// columns, vectorised over the MB rows, no Pallas kernel.  Their plain
// PyTorch versions are encode_levels_plain and p_levels_plain in
// opencv_opencl_tpu_torch/ops/h264_levels.py, the wrappers encode_levels /
// intra_levels and encode_p_levels / p_levels_into in
// opencv_opencl_tpu_torch/ops/cuda/h264_levels.py.
//
// What they compute, for each MB: the I_16x16 DC and HORIZONTAL candidates
// (4x4 forward core transforms, the luma DC Hadamard, quantization), the
// cheaper by the CAVLC cost proxy (HORIZONTAL only with a left MB and a
// strictly lower cost); the chroma DC candidate and, in H1 with `chromah`,
// the chroma HORIZONTAL one (+2, strict); in H2 also the inter candidate
// against the motion-compensated prediction (full 4x4 luma blocks, DC
// included, no Hadamard; the inter rounding offset, a sixth) and the
// decision in the oracle's order: P_Skip where the inter levels are all zero
// and the MB's (mv, ref) is ((0, 0), 0) (with the partition modes: pmode 0
// and quadrant 0 at ((0, 0), 0)), else intra where cost_i + INTRA_BIAS <
// cost_p, else inter; the rows of a GDR band are intra regardless of cost and
// never skip.  Then the chosen levels and the reconstruction, whose right
// column is the next MB's left edge.  H1 with `i4` adds the Intra_4x4 trial
// (16 sub-blocks in z-order, up to 9 modes each) where it is strictly
// cheaper.  One slice per MB row means the top neighbour is never
// available: MB rows are independent, and along a row an MB needs only the
// reconstructed right column (16 luma + 2x8 chroma pixels) of the MB to its
// left (with `i4` also that MB's bx=3 modes).  All arithmetic is int32 and
// bit-exact with the JAX functions (and the host oracle): the mode
// decisions are part of the stream, each with its strict `<`, and a left
// shift of a signed value is written as a product (`x * (1 << k)`; `<<` of
// a negative int is undefined in C++17); `>>` of a signed int is arithmetic,
// as in XLA.
//
// Bound: bytes.  At 4K (3840x2160, 135 x 240 MBs) H1 reads 12,441,600 bytes
// of NV12 and writes 818 bytes a MB of int16 levels and imode (26.5 MB):
// about 39 MB, 0.012 ms at 3.35 TB/s; H2 also reads the prediction (12.4 MB)
// and writes the reconstruction (12.4 MB): about 64 MB, 0.019 ms; H1 with
// `i4` is bound by its operations (the nine modes of 16 sub-blocks an MB:
// 0.0285 ms at 67 TOP/s).  What bounds a direct design is the dependent
// chain of 240 MBs along a row (with `i4`, 3,840 sub-blocks).
//
// Design (the default and `chromah` H1, and H2): three launches on one
// stream, with a scratch of kRecWords int32 a MB that the wrapper allocates.
// The carried edge changes only a few numbers of an MB.  The forward
// transform is linear, so T(src - pred) = T(src) - T(pred), and both intra
// predictions are constant along a row of a 4x4 block: T(pred) is zero
// outside column v = 0 (DC prediction: outside the DC).  So every level
// with v != 0, the AC levels of the DC candidate, 12 of the 16 luma DC
// Hadamard outputs of either candidate (the other 4 are its column j = 0),
// and the chroma AC levels of the DC candidate are the same whatever the
// left MB is, and so are their costs.
//   A  levels_split_kernel, a warp an MB, a lane a 4x4 block (16 luma, 8
//      chroma): the source's transforms, the levels and summed costs that
//      do not depend on the edge, the inputs of the few that do (the v = 0
//      coefficients, the DC Hadamard column), and for the next edge of an
//      intra MB the parts of the inverse transform of its right blocks'
//      column 3 that the edge does not change; in H2 the inter candidate
//      whole, written straight into the outputs (levels, reconstruction; a
//      skip's levels are zero and its reconstruction the prediction, which
//      is what an all-zero inter MB gives), its cost, the skip decision and
//      its right column.
//   B  levels_chain_kernel, a warp an MB row walking its columns with the
//      edge in registers, a lane an edge sample (lanes 0-15 luma rows, 16-31
//      the chroma rows of cb then cr) and, by its place in a group of four,
//      a coefficient row u: the edge's transform (the group's CF), the
//      changed levels requantized (a HORIZONTAL lane quantizes its (u, 0)
//      coefficient in each block of its block row), the DC Hadamard's
//      changed outputs, the costs summed by warp reductions, the decision,
//      the mode written and, for an intra MB, the edge it was decided with;
//      then the next edge: the inter one from A, or each lane's sample of
//      the intra reconstruction's right column from the bx = 3 (chroma:
//      bx = 1) blocks' inverse transform, whose row pass is linear in the
//      changed coefficient.  A P_Skip MB (decided in A) only passes its
//      prediction's column on.  Shuffles and registers, no barrier; every
//      lane runs the same instructions (a lane's own constants, no switch
//      on its index); the records come into a ring in shared memory by
//      cp.async three MBs ahead.  One warp a block, so that the rows spread
//      over the SMs: the step's latency is what counts.
//   C  levels_intra_kernel, a warp an MB again: each intra MB's levels and
//      reconstruction (H1: with full_recon) recomputed from its source and
//      the edge B stored, written over A's.
// H1 with `i4` is the same three grids (the I4 instances) over a longer
// record: A also stores each luma block's T(src) (int16) and the cost of
// its quantized coefficients but the DC, which are the Intra_4x4 DC mode's
// (its prediction is constant: T(pred) is 16 dc at (0, 0) alone).  B runs,
// after each MB's I_16x16 and chroma step, the Intra_4x4 trial along the
// chain: 16 sub-blocks in z-order, 3,840 dependent steps a 4K MB row.  A
// step is a warp, no barrier: lane (g, r), g = lane / 4, holds mode
// kI4Modes[g] (0, 1, 3..8; the DC mode is every group's second candidate)
// and coefficient row r.  It predicts its pixel row r from the neighbours
// in a per-warp shared copy of the MB's reconstruction so far (column 0
// the left MB's right column, row 0 zeros for the top, which is another
// slice), by a table of up to three taps a pixel (kI4Pred, the spec's
// 8.3.1.2 as the plain version's _I4_TABLES); transforms the row (CF), and
// the columns by 16 shuffles in its group of four; requantizes T(src) -
// T(pred) in its row; the group's cost by two shuffles; the winner is the
// warp's least cost * 16 + mode (__reduce_min_sync: the first least in mode
// order, the strict `<` of the oracle's loop).  The winner's group
// reconstructs its block (the inverse row pass in a lane, the column pass
// by 16 shuffles) into the shared copy, and stores its levels (and, with
// full_recon, pixels) straight into the outputs; after the 16th the MB's
// decision (cost_i4 < the I_16x16 cost, strict), its modes, and the next
// left edge, lm4 and the left MB's Intra_4x4 flag, carried in registers.
// C leaves the luma of an Intra_4x4 MB as B wrote it (zdc 0).
//
// The launchers are extern "C", launch on the stream they are given, do not
// synchronise, allocate nothing, and return cudaGetLastError().  The device
// helpers the kernels share are in h264_common.cuh.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "h264_common.cuh"

namespace {

constexpr int kIntraBias = 8;     // io.h264_inter._INTRA_BIAS
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The split design (H1 without i4, H2).  The scratch record of an MB, in
// int32 words (ops/cuda/h264_levels.LEVEL_RECORD_WORDS).  A lane of B reads
// its words with 16-byte loads: its quantization inputs (one int4; chroma
// lanes half of one), its block row's edge words (two) and the MB's
// uniform words (two, and H2's inter words).  Luma block (by, bx),
// coefficient (u, v); chroma component comp, block (cby, cbx); a "block
// row" is luma by (0-3) or chroma 4 + comp*2 + cby.
constexpr int kRecWords = 188;
// luma [by][u][4]: u >= 1: T(src)[u][0] of the blocks bx = 0..3; u = 0:
// H4(the DCs of T(src))[by][0], 0, 0, 0
constexpr int kQ = 0;
// chroma [comp][cby][u][2]: u >= 1: T(src)[u][0] of the blocks cbx = 0, 1;
// u = 0: H2(the DCs of T(src))[cby][0], 0
constexpr int kQc = 64;
// [block row][8], its right block (luma bx = 3, chroma cbx = 1): the row
// pass of column 3 without d[u][0] (u = 0..3); the DC candidate's d[u][0]
// (u = 1..3); the DC inverse Hadamard at (by, 3) (chroma (cby, 1)) without
// the column j = 0
constexpr int kE = 96;
// H4(DCs)[0][0]; the DC candidate's luma DC levels [i][0], i = 1..3; the
// costs without the levels the edge changes: DC candidate, HORIZONTAL,
// chroma DC candidate, chroma HORIZONTAL
constexpr int kU = 160;
constexpr int kP = 168;       // H2: the inter cost, P_Skip
constexpr int kEdgeP = 172;   // H2: the inter (or skip) MB's right column, 32 bytes
constexpr int kUsed = 180;    // the left edge an intra MB was decided with, 32 bytes
constexpr int kSplitWarps = 4;   // MBs (a warp each) a block of A and C
// the I4 record's words after kRecWords: each luma block's (raster by * 4 +
// bx) T(src)[u][v] as int16 pairs, 8 words a block; then each block's
// summed level costs of its quantized coefficients but the DC
constexpr int kI4T = kRecWords;
constexpr int kI4Cost = kI4T + 128;
constexpr int kRecWordsI4 = kI4Cost + 16;    // ops/cuda/h264_levels.I4_RECORD_WORDS
template <bool I4>
constexpr int kStride = I4 ? kRecWordsI4 : kRecWords;

// The Intra_4x4 trial (B with I4).  The modes of the lanes' groups (the DC
// mode, 2, is every group's second candidate)
__constant__ int kI4Modes[8] = {0, 1, 3, 4, 5, 6, 7, 8};
// the predictor of mode m at pixel y * 4 + x: three taps (bits 6k..6k+3 the
// neighbour, 0 the corner, 1-8 the top row t8 with the top-right, 9-12 the
// left column; bits 6k+4, 6k+5 its weight), the rounding (bits 18, 19) and
// the shift (20, 21): ops/h264_levels._I4_TABLES; mode 2 is not in it
__constant__ int kI4Pred[9][16] = {
    {0x11, 0x12, 0x13, 0x14, 0x11, 0x12, 0x13, 0x14, 0x11, 0x12, 0x13, 0x14, 0x11, 0x12,
     0x13, 0x14},
    {0x19, 0x19, 0x19, 0x19, 0x1a, 0x1a, 0x1a, 0x1a, 0x1b, 0x1b, 0x1b, 0x1b, 0x1c, 0x1c,
     0x1c, 0x1c},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0x293891, 0x2948d2, 0x295913, 0x296954, 0x2948d2, 0x295913, 0x296954, 0x297995,
     0x295913, 0x296954, 0x297995, 0x2989d6, 0x296954, 0x297995, 0x2989d6, 0x280e17},
    {0x299811, 0x292850, 0x293891, 0x2948d2, 0x29aa50, 0x299811, 0x292850, 0x293891,
     0x29ba99, 0x29aa50, 0x299811, 0x292850, 0x29cada, 0x29ba99, 0x29aa50, 0x299811},
    {0x140450, 0x140491, 0x1404d2, 0x140513, 0x291819, 0x292850, 0x293891, 0x2948d2,
     0x290a5a, 0x140450, 0x140491, 0x1404d2, 0x299a9b, 0x291819, 0x292850, 0x293891},
    {0x140650, 0x291819, 0x290852, 0x291893, 0x140699, 0x29aa50, 0x140650, 0x291819,
     0x1406da, 0x29ba99, 0x140699, 0x29aa50, 0x14071b, 0x29cada, 0x1406da, 0x29ba99},
    {0x140491, 0x1404d2, 0x140513, 0x140554, 0x293891, 0x2948d2, 0x295913, 0x296954,
     0x1404d2, 0x140513, 0x140554, 0x140595, 0x2948d2, 0x295913, 0x296954, 0x297995},
    {0x140699, 0x29ba99, 0x1406da, 0x29cada, 0x1406da, 0x29cada, 0x14071b, 0x280f1b,
     0x14071b, 0x280f1b, 0x1c, 0x1c, 0x1c, 0x1c, 0x1c, 0x1c},
};
// the Intra_4x4 trial's wavefront: sub-block (bx, by) needs (bx - 1, by),
// (bx, by - 1), (bx + 1, by - 1) and (bx - 1, by - 1), so step t = bx + 2 by
// holds one or two of them; the z indices step by step
// (0 | 1 | 4 2 | 5 3 | 6 8 | 7 9 | 12 10 | 13 11 | 14 | 15) as nibbles
__host__ __device__ constexpr int wave_size(int t) { return t >= 2 && t < 8 ? 2 : 1; }
__host__ __device__ constexpr int wave_z(int t, int i) {
    return (int)((0xfebdac9786352410ull >> (4 * ((t < 2 ? t : t < 8 ? 2 * t - 2 : t + 6) + i)))
                 & 15);
}
// the per-warp copy of the MB's luma reconstruction: pixel (y, x) at
// (y + 1) * kBufS + x + 1; row 0 zeros (no top), column 0 the left edge
constexpr int kBufS = 17;
constexpr int kNoMode = 0x7fffffff;   // the key of a mode that is not available

// the forward core transform CF in place
__device__ __forceinline__ void cf4(int& a, int& b, int& c, int& d) {
    const int s0 = a + d, s1 = b + c, s2 = b - c, s3 = a - d;
    a = s0 + s1;
    b = 2 * s3 + s2;
    c = s0 - s1;
    d = s3 - 2 * s2;
}

// the forward transform of a 4x4 raster x[y*4+x] into t[u*4+v], in place
__device__ __forceinline__ void fwd16(int* t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) cf4(t[r * 4], t[r * 4 + 1], t[r * 4 + 2], t[r * 4 + 3]);
#pragma unroll
    for (int v = 0; v < 4; ++v) cf4(t[v], t[4 + v], t[8 + v], t[12 + v]);
}

// one pass of the spec 8.5.12.3 inverse core transform in place
__device__ __forceinline__ void inv4(int& a, int& b, int& c, int& d) {
    const int e0 = a + c, e1 = a - c, e2 = (b >> 1) - d, e3 = b + (d >> 1);
    a = e0 + e3;
    b = e1 + e2;
    c = e1 - e2;
    d = e0 - e3;
}

// the rounded residual r[y*4+x] of the dequantized block d[u*4+v], in place:
// rows first, then columns
__device__ __forceinline__ void inv16(int* d) {
#pragma unroll
    for (int u = 0; u < 4; ++u) inv4(d[u * 4], d[u * 4 + 1], d[u * 4 + 2], d[u * 4 + 3]);
#pragma unroll
    for (int x = 0; x < 4; ++x) inv4(d[x], d[4 + x], d[8 + x], d[12 + x]);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = (d[i] + 32) >> 6;
}

// H4 @ X @ H4 over each group of 16 lanes, lane i*4 + j holding X[i][j]:
// the result's (i, j)
__device__ __forceinline__ int had4_lanes(int x, int lane) {
    const int i = (lane >> 2) & 3, j = lane & 3;
    int s = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) s += h4(j, c) * __shfl_sync(kFull, x, (lane & ~3) + c);
    int r = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) r += h4(i, q) * __shfl_sync(kFull, s, (lane & ~15) + q * 4 + j);
    return r;
}

// H2 @ X @ H2 over each group of 4 lanes, lane i*2 + j holding X[i][j]
__device__ __forceinline__ int had2_lanes(int x, int lane) {
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __shfl_sync(kFull, x, (lane & ~3) + k);
    return hadamard2(v, (lane >> 1) & 1, lane & 1);
}

// four pixels of a row: one 32-bit load where the address allows it
__device__ __forceinline__ void load4(const uint8_t* p, long long step, bool word, int* dst) {
    if (word && step == 1) {
        const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = (w >> (8 * c)) & 255;
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = p[c * step];
    }
}

__device__ __forceinline__ void store4(uint8_t* p, const int* v) {
    *reinterpret_cast<uint32_t*>(p) =
        (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) | ((uint32_t)v[3] << 24);
}

// 16 int16 levels: two 16-byte stores where `out` is 16-byte aligned
__device__ __forceinline__ void store16(int16_t* dst, const int* v, bool vec) {
    if (vec) {
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            w[k] = ((uint32_t)v[2 * k] & 0xffffu) | ((uint32_t)v[2 * k + 1] << 16);
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) dst[k] = (int16_t)v[k];
    }
}

// a lane's part of A and C: lane b < 16 luma block b = (by, bx), lanes
// 16..23 chroma block (comp, cby, cbx), lanes 24..31 zeros through the
// shuffles; the block's plane, quantizer and dequantization constants
struct BlockRole {
    bool luma, chroma;
    int by, bx, comp, cby, cbx;
    int mf0, mf1, mf2, v0, v1, v2, f, qb;
    __device__ BlockRole(int lane, const Plan& p) {
        luma = lane < 16;
        chroma = lane >= 16 && lane < 24;
        by = (lane >> 2) & 3;
        bx = lane & 3;
        comp = (lane >> 2) & 1;
        cby = (lane >> 1) & 1;
        cbx = lane & 1;
        const int qsh = 1 << ((luma ? p.qp : p.qpc) / 6);
        mf0 = luma ? p.mf_y[0] : p.mf_c[0];
        mf1 = luma ? p.mf_y[1] : p.mf_c[1];
        mf2 = luma ? p.mf_y[2] : p.mf_c[2];
        v0 = (luma ? p.v_y[0] : p.v_c[0]) * qsh;
        v1 = (luma ? p.v_y[1] : p.v_c[1]) * qsh;
        v2 = (luma ? p.v_y[2] : p.v_c[2]) * qsh;
        f = luma ? p.f_y : p.f_c;
        qb = luma ? p.qbits : p.qbits_c;
    }
    __device__ int mf(int cls) const { return cls == 0 ? mf0 : cls == 1 ? mf1 : mf2; }
    __device__ int v(int cls) const { return cls == 0 ? v0 : cls == 1 ? v1 : v2; }
};

// the lane's 4x4 block of a frame (luma, or a chroma plane of pixel
// stride `cs`), zeros on the idle lanes
__device__ __forceinline__ void load_block(const BlockRole& b, const uint8_t* y, long long y_rs,
                                           const uint8_t* cb, long long cb_rs, long long cb_cs,
                                           const uint8_t* cr, long long cr_rs, long long cr_cs,
                                           int mby, int mbx, bool word_y, int* s) {
    const uint8_t* src = nullptr;
    long long rs = 0, cs = 1;
    if (b.luma) {
        src = y + (long long)(mby * 16 + b.by * 4) * y_rs + mbx * 16 + b.bx * 4;
        rs = y_rs;
    } else if (b.chroma) {
        rs = b.comp ? cr_rs : cb_rs;
        cs = b.comp ? cr_cs : cb_cs;
        src = (b.comp ? cr : cb) + (long long)(mby * 8 + b.cby * 4) * rs
              + (long long)(mbx * 8 + b.cbx * 4) * cs;
    }
    if (src != nullptr) {
#pragma unroll
        for (int r = 0; r < 4; ++r) load4(src + r * rs, cs, b.luma && word_y, s + 4 * r);
    } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = 0;
    }
}

// where the lane's block lies in a contiguous plane of the MB grid (the
// prediction, the reconstruction), and its row stride
template <class T>
__device__ __forceinline__ T* plane_at(const BlockRole& b, T* y, T* cb, T* cr, int mb_w,
                                       int mby, int mbx, long long& rs) {
    rs = b.luma ? (long long)mb_w * 16 : (long long)mb_w * 8;
    if (b.luma) return y + (mby * 16 + b.by * 4) * rs + mbx * 16 + b.bx * 4;
    return (b.comp ? cr : cb) + (mby * 8 + b.cby * 4) * rs + mbx * 8 + b.cbx * 4;
}

// the lane's levels: its DC (luma zdc, chroma czdc) and its 16 AC slots
__device__ __forceinline__ void store_levels(const BlockRole& b, long long mb, int lane,
                                             int dc, const int* lev, bool vec,
                                             int16_t* zdc_out, int16_t* acz_out,
                                             int16_t* czdc_out, int16_t* cacz_out) {
    const int blk = b.cby * 2 + b.cbx;
    if (b.luma) {
        zdc_out[mb * 16 + lane] = (int16_t)dc;
        store16(acz_out + mb * 256 + lane * 16, lev, vec);
    } else if (b.chroma) {
        czdc_out[mb * 8 + b.comp * 4 + blk] = (int16_t)dc;
        store16(cacz_out + mb * 128 + b.comp * 64 + blk * 16, lev, vec);
    }
}

// A: a warp an MB (BlockRole's lanes); with I4 (H1 with i4) also the
// Intra_4x4 words of the record
template <bool P, bool I4 = false>
__global__ void __launch_bounds__(32 * kSplitWarps)
levels_split_kernel(const uint8_t* __restrict__ y, long long y_rs,
                    const uint8_t* __restrict__ cb, long long cb_rs, long long cb_cs,
                    const uint8_t* __restrict__ cr, long long cr_rs, long long cr_cs,
                    const uint8_t* __restrict__ py_, const uint8_t* __restrict__ pcb,
                    const uint8_t* __restrict__ pcr, int mb_h, int mb_w, Plan p,
                    int word_y, int word_p, int vec, const int16_t* __restrict__ mv,
                    const int16_t* __restrict__ ref, const int16_t* __restrict__ pmode,
                    int band_lo, int band_hi, int* __restrict__ rec,
                    int16_t* __restrict__ zdc_out, int16_t* __restrict__ acz_out,
                    int16_t* __restrict__ czdc_out, int16_t* __restrict__ cacz_out,
                    uint8_t* __restrict__ ry, uint8_t* __restrict__ rcb,
                    uint8_t* __restrict__ rcr) {
    const int lane = threadIdx.x & 31;
    const long long mb = (long long)blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
    if (mb >= (long long)mb_h * mb_w) return;     // the whole warp
    const int mby = (int)(mb / mb_w), mbx = (int)(mb % mb_w);
    int* R = rec + mb * kStride<I4>;
    const BlockRole b(lane, p);

    int s[16], t[16];
    load_block(b, y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, mby, mbx, word_y, s);
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = s[i];
    fwd16(t);

    // the intra AC levels (either candidate's where v != 0; the DC
    // candidate's at v = 0) and their costs
    int lev[16], cost_all = 0, cost_v = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int q = k ? quant(t[k], b.mf(pos_class(k >> 2, k & 3)), b.f, b.qb) : 0;
        lev[k] = q;
        cost_all += level_cost(q);
        if (k & 3) cost_v += level_cost(q);
    }
    // the DC Hadamards: luma lanes (i, j) = (by, bx), chroma (cby, cbx)
    const int ht = had4_lanes(t[0], lane), htc = had2_lanes(t[0], lane);
    const int zs = quant(b.luma ? ht >> 1 : htc, b.mf0, 2 * b.f, b.qb + 1);
    int fa = 0, fb = 0;
    if (b.luma) {
        fa = cost_all + (lane ? level_cost(zs) : 0);
        fb = cost_v + (b.bx ? level_cost(zs) : 0);
    } else if (b.chroma) {
        fa = cost_all + (b.cbx ? level_cost(zs) : 0);
        fb = cost_v + (b.cbx ? level_cost(zs) : 0);
    }
    const int fd = __reduce_add_sync(kFull, b.luma ? fa : 0);
    const int fh = __reduce_add_sync(kFull, b.luma ? fb : 0);
    const int fcd = __reduce_add_sync(kFull, b.luma ? 0 : fa);
    const int fch = __reduce_add_sync(kFull, b.luma ? 0 : fb);
    // the DC inverse Hadamards at the right blocks without the column j = 0:
    // luma at (by, 3) over j >= 1, chroma at (cby, 1) over j = 1
    int w = (b.luma && b.bx) ? h4(3, b.bx) * zs : 0;
    w += __shfl_xor_sync(kFull, w, 1);
    w += __shfl_xor_sync(kFull, w, 2);
    int ih = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) ih += h4(b.by, r) * __shfl_sync(kFull, w, r * 4);
    const int cz0 = __shfl_sync(kFull, zs, (lane & ~3) | 1);
    const int cz1 = __shfl_sync(kFull, zs, (lane & ~3) | 3);
    const int cih = -(cz0 + (b.cby ? -cz1 : cz1));

    // the right block's column 3 of the inverse transform without d[u][0]
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = lev[k] * b.v(pos_class(k >> 2, k & 3));
    int* E = R + kE + (b.luma ? b.by : 4 + b.comp * 2 + b.cby) * 8;
    if (b.luma) {
#pragma unroll
        for (int u = 1; u < 4; ++u) R[kQ + b.by * 16 + u * 4 + b.bx] = t[u * 4];
        R[kQ + b.by * 16 + b.bx] = b.bx ? 0 : ht;
        if (b.bx == 0) {
            E[7] = ih;
            if (b.by) R[kU + b.by] = zs;
            else R[kU] = ht;
        }
    } else if (b.chroma) {
#pragma unroll
        for (int u = 1; u < 4; ++u) R[kQc + (b.comp * 2 + b.cby) * 8 + u * 2 + b.cbx] = t[u * 4];
        R[kQc + (b.comp * 2 + b.cby) * 8 + b.cbx] = b.cbx ? 0 : htc;
        if (b.cbx == 0) E[7] = cih;
    }
    if ((b.luma && b.bx == 3) || (b.chroma && b.cbx)) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            E[u] = d[u * 4 + 2] - d[u * 4 + 1] - (d[u * 4 + 3] >> 1);
            if (u) E[3 + u] = d[u * 4];
        }
    }
    if (lane == 0) {
        R[kU + 4] = fd;
        R[kU + 5] = fh;
        R[kU + 6] = fcd;
        R[kU + 7] = fch;
    }
    if (I4 && b.luma) {
        // the block's T(src) and the cost of its levels but the DC: the
        // i4 quantizer is the AC one at every position
        uint32_t wt[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            wt[k] = ((uint32_t)t[2 * k] & 0xffffu) | ((uint32_t)t[2 * k + 1] << 16);
        int4* T4 = reinterpret_cast<int4*>(R + kI4T + lane * 8);
        T4[0] = make_int4((int)wt[0], (int)wt[1], (int)wt[2], (int)wt[3]);
        T4[1] = make_int4((int)wt[4], (int)wt[5], (int)wt[6], (int)wt[7]);
        R[kI4Cost + lane] = cost_all;
    }
    if (!P) return;

    // ---- H2: the inter candidate whole
    int pr[16];
    long long rs;
    const uint8_t* pred = plane_at(b, py_, pcb, pcr, mb_w, mby, mbx, rs);
    if (b.luma || b.chroma) {
#pragma unroll
        for (int r = 0; r < 4; ++r) load4(pred + r * rs, 1, word_p, pr + 4 * r);
    } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) pr[i] = 0;
    }
    const int f_p = (1 << b.qb) / 6;
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = s[i] - pr[i];
    fwd16(t);
    int cp = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int q = (k || b.luma) ? quant(t[k], b.mf(pos_class(k >> 2, k & 3)), f_p, b.qb) : 0;
        lev[k] = q;
        cp += level_cost(q);
    }
    const int czp = quant(had2_lanes(t[0], lane), b.mf0, 2 * f_p, b.qb + 1);
    if (b.chroma) cp += level_cost(czp);
    cp = __reduce_add_sync(kFull, cp);
    const int cdc = chroma_dc_dequant(had2_lanes(czp, lane), p);
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = lev[k] * b.v(pos_class(k >> 2, k & 3));
    if (!b.luma) d[0] = cdc;
    inv16(d);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = clamp255(d[i] + pr[i]);
    store_levels(b, mb, lane, b.luma ? 0 : czp, lev, vec, zdc_out, acz_out, czdc_out, cacz_out);
    uint8_t* dst = plane_at(b, ry, rcb, rcr, mb_w, mby, mbx, rs);
    uint8_t* edge = reinterpret_cast<uint8_t*>(R + kEdgeP);
    if (b.luma || b.chroma) {
#pragma unroll
        for (int r = 0; r < 4; ++r) store4(dst + r * rs, d + 4 * r);
    }
    if ((b.luma && b.bx == 3) || (b.chroma && b.cbx)) {
        const int e0 = b.luma ? b.by * 4 : 16 + b.comp * 8 + b.cby * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r) edge[e0 + r] = (uint8_t)d[r * 4 + 3];
    }
    if (lane == 0) {
        // with parts (pmode given) the fields hold four quadrants a MB and
        // P_Skip needs the whole-MB hypothesis: pmode 0, quadrant 0 at zero
        const int fq = pmode != nullptr ? 4 : 1;
        const bool mvz = mv == nullptr ||
            ((pmode == nullptr || pmode[mb] == 0) && mv[2 * fq * mb] == 0
             && mv[2 * fq * mb + 1] == 0 && (ref == nullptr || ref[fq * mb] == 0));
        const bool inband = mby >= band_lo && mby < band_hi;
        R[kP] = cp;
        R[kP + 1] = cp == 0 && mvz && !inband;
    }
}

// B's ring: the records it reads (the words before kUsed; with I4 then the
// Intra_4x4 words, from kI4T) are copied into shared memory with cp.async
// kRing - 1 MBs ahead of the chain
constexpr int kChainWords = kUsed;
constexpr int kRing = 4;
template <bool I4>
constexpr int kSlot = I4 ? kChainWords + (kRecWordsI4 - kI4T) : kChainWords;

template <bool I4>
__device__ __forceinline__ void chain_fetch(int* slot, const int* __restrict__ R, int lane) {
    for (int c = lane; c < kSlot<I4> / 4; c += 32) {
        const int w = 4 * c;
        __pipeline_memcpy_async(slot + w, R + (w < kChainWords ? w : w - kChainWords + kI4T),
                                16);
    }
}

// what a lane of B reads of an MB's record
struct ChainWords {
    int4 q, e0, e1, u0, u1;
    int cp, skip, ep;
};

__device__ __forceinline__ void chain_load(const int* __restrict__ R, int lane, bool P,
                                           ChainWords& w) {
    const bool luma = lane < 16;
    // a chroma lane's two words are half of an int4 (two lanes a load)
    w.q = *reinterpret_cast<const int4*>(R + (luma ? kQ + lane * 4 : kQc + ((lane - 16) >> 1) * 4));
    if (!luma) w.q = (lane & 1) ? make_int4(w.q.z, w.q.w, 0, 0) : make_int4(w.q.x, w.q.y, 0, 0);
    const int4* E = reinterpret_cast<const int4*>(R + kE + (lane >> 2) * 8);
    w.e0 = E[0];
    w.e1 = E[1];
    w.u0 = reinterpret_cast<const int4*>(R + kU)[0];
    w.u1 = reinterpret_cast<const int4*>(R + kU)[1];
    if (P) {
        const int2 pw = *reinterpret_cast<const int2*>(R + kP);
        w.cp = pw.x;
        w.skip = pw.y;
        w.ep = reinterpret_cast<const uint8_t*>(R + kEdgeP)[lane];
    } else {
        w.cp = w.skip = w.ep = 0;
    }
}

// B: a warp an MB row.  Lane l < 16: luma row l, block row by = l >> 2;
// lane 16 + comp*8 + cby*4 + u: chroma row cby*4 + u of component comp.  Its
// place u = l & 3 in its group of four is the coefficient row it
// requantizes (u = 0: the DC Hadamard's column j = 0) and the row of the
// next edge it computes.  Every lane runs one path: four quantizations
// with its own constants, the sums by warp reductions.
template <bool P, bool I4 = false>
__global__ void __launch_bounds__(32)
levels_chain_kernel(int mb_w, Plan p, int chromah, int band_lo, int band_hi,
                    int* __restrict__ rec, int16_t* __restrict__ mode_out,
                    int16_t* __restrict__ cmode_out, int16_t* __restrict__ acz_out,
                    int16_t* __restrict__ i4m_out, uint8_t* __restrict__ ry, int vec) {
    const int lane = threadIdx.x, mby = blockIdx.x;
    const bool luma = lane < 16;
    const int u = lane & 3, by = (lane >> 2) & 3, cby = (lane >> 2) & 1;
    const int gb = luma ? 0 : (lane & ~7);   // the first lane of its plane (component)
    const int sgn = cby ? -1 : 1;            // a chroma lane's Hadamard row i = cby
    const bool inband = mby >= band_lo && mby < band_hi;
    const bool hq_lane = luma || chromah;    // its HORIZONTAL levels count
    // the lane's quantizer: u >= 1 its (u, 0) coefficients, u = 0 DC levels
    const int ucls = (u & 1) ? 2 : 0;        // pos_class(u, 0)
    const int mfq = u ? (luma ? (ucls ? p.mf_y[2] : p.mf_y[0]) : (ucls ? p.mf_c[2] : p.mf_c[0]))
                      : (luma ? p.mf_y[0] : p.mf_c[0]);
    const int fq = (u ? 1 : 2) * (luma ? p.f_y : p.f_c);
    const int qb = (luma ? p.qbits : p.qbits_c) + (u ? 0 : 1);
    const int qsh = 1 << ((luma ? p.qp : p.qpc) / 6);
    const int vq1 = (luma ? p.v_y[2] : p.v_c[2]) * qsh, vq2 = (luma ? p.v_y[0] : p.v_c[0]) * qsh;
    // the lane's row u of CF and of the inverse pass, and its block row's
    // row of H4, as numbers: a `switch` on a lane's own index diverges
    const int cf0 = u == 3 ? 1 : u == 1 ? 2 : 1, cf1 = u == 0 ? 1 : u == 1 ? 1 : u == 2 ? -1 : -2;
    const int cf2 = u == 0 ? 1 : u == 1 ? -1 : u == 2 ? -1 : 2, cf3 = u == 0 ? 1 : u == 1 ? -2 : u == 2 ? 1 : -1;
    const bool outer = u == 0 || u == 3;     // the inverse pass: e0 +- e3, else e1 +- e2
    const int isgn = u < 2 ? 1 : -1;
    int hs[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) hs[r] = h4(by, r);

    __shared__ __align__(16) int ring[kRing][kSlot<I4>];
    int edge = 0;
    const long long row = (long long)mby * mb_w;
    for (int i = 0; i < kRing - 1; ++i) {
        if (i < mb_w) chain_fetch<I4>(ring[i], rec + (row + i) * kStride<I4>, lane);
        __pipeline_commit();
    }
    // the Intra_4x4 trial's lane: the group's mode and its pixel and
    // coefficient row r = u; the taps of its four pixels as offsets in ybuf
    // from the sub-block's origin (with the top-right, and with p[3, -1]
    // in its place), weights, roundings, shifts; its row's quantizer
    __shared__ int ybuf[I4 ? 17 * kBufS : 1];
    const int pm = I4 ? kI4Modes[lane >> 2] : 0;
    int tap[4][3], tapn[4][3], tw[4][3], trnd[4], tshf[4], mfr[4], vqr[4];
    uint64_t lm4 = 0x2222;       // the left MB's bx = 3 modes (by = 0..3), 2 if I_16x16
    if (I4) {
        for (int i = lane; i < 17 * kBufS; i += 32) ybuf[i] = 0;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int word = kI4Pred[pm][u * 4 + x];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int nb = (word >> (6 * k)) & 15;
                tw[x][k] = (word >> (6 * k + 4)) & 3;
                tap[x][k] = nb == 0 ? -kBufS - 1 : nb <= 8 ? -kBufS + nb - 1 : (nb - 9) * kBufS - 1;
                tapn[x][k] = (nb >= 5 && nb <= 8) ? -kBufS + 3 : tap[x][k];
            }
            trnd[x] = (word >> 18) & 3;
            tshf[x] = (word >> 20) & 3;
            // (selects: a run-time index into the plan would copy it to the stack)
            const int cls = pos_class(u, x);
            mfr[x] = cls == 0 ? p.mf_y[0] : cls == 1 ? p.mf_y[1] : p.mf_y[2];
            vqr[x] = (cls == 0 ? p.v_y[0] : cls == 1 ? p.v_y[1] : p.v_y[2]) * (1 << (p.qp / 6));
        }
        __syncwarp();
    }
    for (int mbx = 0; mbx < mb_w; ++mbx) {
        const long long mb = row + mbx;
        int* R = rec + mb * kStride<I4>;
        // the slot of MB mbx - 1, whose words every lane holds by now
        __syncwarp();
        if (mbx + kRing - 1 < mb_w)
            chain_fetch<I4>(ring[(mbx + kRing - 1) % kRing], R + (kRing - 1) * kStride<I4>,
                            lane);
        __pipeline_commit();
        __pipeline_wait_prior(kRing - 1);
        __syncwarp();
        ChainWords w;
        chain_load(ring[mbx % kRing], lane, P, w);
        if (P && w.skip) {
            // P_Skip does not depend on the edge (A decided it): its
            // reconstruction, the prediction, is the next edge
            if (lane == 0) mode_out[mb] = 0;
            edge = w.ep;
            continue;
        }
        const bool left_ok = mbx > 0;
        // the group's four edge samples (a block row), their sum and CF
        int x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = __shfl_sync(kFull, edge, (lane & ~3) + i);
        const int s4 = x[0] + x[1] + x[2] + x[3];
        const int a = cf0 * x[0] + cf1 * x[1] + cf2 * x[2] + cf3 * x[3];
        const int s16 = __reduce_add_sync(kFull, luma ? edge : 0);
        const int pd = left_ok ? (s16 + 8) >> 4 : 128;
        const int vh = left_ok ? (s4 + 2) >> 2 : 128;
        const int v0 = __shfl_sync(kFull, vh, lane & ~7), v1 = __shfl_sync(kFull, vh, (lane & ~7) + 4);
        int a0[4];    // the block rows' CF DCs of the lane's plane
#pragma unroll
        for (int r = 0; r < 4; ++r)
            a0[r] = __shfl_sync(kFull, a, luma ? 4 * r : gb + 4 * (r & 1));
        int hg = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) hg += hs[r] * a0[r];
        // the lane's four quantizations: u >= 1 the HORIZONTAL candidate's
        // (u, 0) levels of its block row; u = 0 its DC Hadamard column (luma
        // zh[by], chroma czh[cby]) and the DC candidate's (luma zd[0][0],
        // chroma czd[cby][0])
        const int dc0 = luma ? (w.q.x - 16 * hg) >> 1 : w.q.x - 8 * (a0[0] + sgn * a0[1]);
        const int dc1 = luma ? (w.u0.x - 256 * pd) >> 1 : w.q.x - 32 * (v0 + sgn * v1);
        const int q0 = quant(u ? w.q.x - 4 * a : dc0, mfq, fq, qb);
        const int q1 = quant(u ? w.q.y - 4 * a : dc1, mfq, fq, qb);
        const int q2 = quant((u && luma) ? w.q.z - 4 * a : 0, mfq, fq, qb);
        const int q3 = quant((u && luma) ? w.q.w - 4 * a : 0, mfq, fq, qb);
        const int hcost = level_cost(q0) + (u ? level_cost(q1) + level_cost(q2) + level_cost(q3) : 0);
        // the next edge for each candidate is gathered now, the decision
        // after: the gathers do not wait for the sums
        const int qlast = luma ? q3 : q1;
        int zc[4], hq[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            zc[r] = __shfl_sync(kFull, q0, luma ? 4 * r : gb + 4 * (r & 1));
            if (r) hq[r] = __shfl_sync(kFull, qlast, luma ? by * 4 + r : gb + cby * 4 + r);
        }
        const int czd0 = __shfl_sync(kFull, q1, gb), czd1 = __shfl_sync(kFull, q1, gb + 4);
        const int zd0 = __shfl_sync(kFull, q1, 0);
        const int cost_h = w.u1.y + __reduce_add_sync(kFull, luma ? hcost : 0);
        const int cost_d = w.u1.x + level_cost(zd0);
        const int cost_cdc = w.u1.z + __reduce_add_sync(kFull, (!luma && !u) ? level_cost(q1) : 0);
        const int cost_chh = w.u1.w + __reduce_add_sync(kFull, (!luma && hq_lane) ? hcost : 0);
        const bool use_h = left_ok && cost_h < cost_d;
        const bool use_ch = chromah && left_ok && cost_chh + 2 < cost_cdc;
        bool intra = true;
        int mode = use_h ? 1 : 2;
        if (P) {
            const int cost_i = (use_h ? cost_h : cost_d) + cost_cdc + kIntraBias;
            intra = cost_i < w.cp || inband;
            mode = intra ? (use_h ? 3 : 2) : 1;
        }
        if (lane == 0 && !I4) {
            mode_out[mb] = (int16_t)mode;
            if (chromah) cmode_out[mb] = (int16_t)use_ch;
        }
        if (intra) reinterpret_cast<uint8_t*>(R + kUsed)[lane] = (uint8_t)edge;

        // the intra reconstruction's right column at this lane's row u
        const bool hor = luma ? use_h : use_ch;
        int ih = w.e1.w;
        if (luma) {
            const int zd[4] = {zd0, w.u0.y, w.u0.z, w.u0.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) ih += hs[r] * (hor ? zc[r] : zd[r]);
        } else {
            ih += hor ? zc[0] + sgn * zc[1] : czd0 + sgn * czd1;
        }
        const int h0 = (luma ? luma_dc_dequant(ih, p) : chroma_dc_dequant(ih, p)) + w.e0.x;
        const int h1 = w.e0.y + (hor ? hq[1] * vq1 : w.e1.x);
        const int h2 = w.e0.z + (hor ? hq[2] * vq2 : w.e1.y);
        const int h3 = w.e0.w + (hor ? hq[3] * vq1 : w.e1.z);
        const int e_a = outer ? h0 + h2 : h0 - h2;
        const int e_b = outer ? h1 + (h3 >> 1) : (h1 >> 1) - h3;
        const int res = (e_a + isgn * e_b + 32) >> 6;
        const int pred = hor ? edge : luma ? pd : (cby ? v1 : v0);
        edge = intra ? clamp255(res + pred) : w.ep;
        if (!I4) continue;

        // ---- the Intra_4x4 trial: the 16 sub-blocks in 10 wavefront steps
        // (wave_z), two at once where neither is the other's neighbour
        const int* S = ring[mbx % kRing] + kChainWords;   // the slot's Intra_4x4 words
        const int grp = lane >> 2;
        uint64_t zm = 0;         // the chosen modes, 4 bits a sub-block (z-order)
        int cost_i4 = 0;
#pragma unroll
        for (int t = 0; t < 10; ++t) {
            const int nz = wave_size(t);
            int zs[2], base[2], blk[2], dc[2], pr[2][4], q[2][4], qa[2][4], lc[2], qd[2];
            bool tr[2], noleft[2];
            // the DC mode's prediction, the lane's mode's pixel row u, the
            // source's row u: T(src)[u][0..3]
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (i >= nz) continue;
                const int z = wave_z(t, i), zbx = scan_bx(z), zby = scan_by(z);
                zs[i] = z;
                blk[i] = zby * 4 + zbx;
                base[i] = (zby * 4 + 1) * kBufS + zbx * 4 + 1;
                // the above-right block is not decoded yet: p[3, -1] for t8[4..7]
                tr[i] = !(zbx == 3 || (zbx == 1 && (zby == 1 || zby == 3)));
                noleft[i] = zbx == 0 && !left_ok;
                int ls = 0, ts = 0;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    ls += ybuf[base[i] + k * kBufS - 1];
                    ts += ybuf[base[i] - kBufS + k];
                }
                dc[i] = zby == 0 ? (noleft[i] ? 128 : (ls + 2) >> 2)
                                 : (noleft[i] ? (ts + 2) >> 2 : (ts + ls + 4) >> 3);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    int acc = trnd[j];
#pragma unroll
                    for (int k = 0; k < 3; ++k)
                        acc += tw[j][k] * ybuf[base[i] + (tr[i] ? tap[j][k] : tapn[j][k])];
                    pr[i][j] = acc >> tshf[j];
                }
                const int2 tw2 = *reinterpret_cast<const int2*>(S + blk[i] * 8 + u * 2);
                const int ts4[4] = {(int)(short)(tw2.x & 0xffff), tw2.x >> 16,
                                    (int)(short)(tw2.y & 0xffff), tw2.y >> 16};
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    q[i][v] = ts4[v];
                    qa[i][v] = quant(ts4[v], mfr[v], p.f_y, p.qbits);
                }
                qd[i] = quant((int)(short)(S[blk[i] * 8] & 0xffff) - 16 * dc[i], p.mf_y[0],
                              p.f_y, p.qbits);
            }
            // the row's CF, the column CF over the group's four rows, the
            // levels of T(src) - T(pred) and the group's cost
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (i >= nz) continue;
                int pc[4] = {pr[i][0], pr[i][1], pr[i][2], pr[i][3]};
                cf4(pc[0], pc[1], pc[2], pc[3]);
                lc[i] = 0;
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    int tp = 0;
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int cfk = k == 0 ? cf0 : k == 1 ? cf1 : k == 2 ? cf2 : cf3;
                        tp += cfk * __shfl_sync(kFull, pc[v], (lane & ~3) + k);
                    }
                    q[i][v] = quant(q[i][v] - tp, mfr[v], p.f_y, p.qbits);
                    lc[i] += level_cost(q[i][v]);
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (i >= nz) continue;
                lc[i] += __shfl_xor_sync(kFull, lc[i], 1);
                lc[i] += __shfl_xor_sync(kFull, lc[i], 2);
            }
            // the predicted mode (spec 8.3.1.1; the top MB row is another
            // slice) from the modes chosen so far and the left MB's; the
            // winner: the warp's least key, the DC mode the groups' second
            // candidate (T(src) less 16 dc at (0, 0), A's cost of the rest)
            int bm[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (i >= nz) continue;
                const int z = zs[i], zbx = scan_bx(z), zby = scan_by(z);
                int predm = 2;
                if (zby > 0) {
                    const int mB = (int)(zm >> (4 * z_of(zbx, zby - 1))) & 15;
                    if (zbx > 0) predm = min((int)(zm >> (4 * z_of(zbx - 1, zby))) & 15, mB);
                    else if (left_ok) predm = min((int)(lm4 >> (4 * zby)) & 15, mB);
                }
                const bool valid = (zby > 0 || pm == 1 || pm == 8)
                                   && !(noleft[i] && (pm == 1 || pm == 8 || pm == 4 || pm == 5
                                                      || pm == 6));
                const int key_p = valid ? (lc[i] + (predm == pm ? 1 : 4)) * 16 + pm : kNoMode;
                const int key_d = (S[kI4Cost - kI4T + blk[i]] + level_cost(qd[i])
                                   + (predm == 2 ? 1 : 4)) * 16 + 2;
                const int best = __reduce_min_sync(kFull, min(key_p, key_d));
                bm[i] = best & 15;
                cost_i4 += best >> 4;
                zm |= (uint64_t)bm[i] << (4 * z);
            }
            // the winner's group (the DC mode: group 0's second candidate)
            // reconstructs the block: the row pass in a lane, the column
            // pass over the group; stores its levels and pixels
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (i >= nz) continue;
                const int z = zs[i], zbx = scan_bx(z), zby = scan_by(z);
                const bool dcw = bm[i] == 2;
                const int gs = dcw ? 0 : bm[i] < 2 ? bm[i] : bm[i] - 1;
                int d[4];
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    q[i][v] = dcw ? ((u == 0 && v == 0) ? qd[i] : qa[i][v]) : q[i][v];
                    d[v] = q[i][v] * vqr[v];
                }
                inv4(d[0], d[1], d[2], d[3]);
                int rc[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int g0 = __shfl_sync(kFull, d[j], gs * 4);
                    const int g1 = __shfl_sync(kFull, d[j], gs * 4 + 1);
                    const int g2 = __shfl_sync(kFull, d[j], gs * 4 + 2);
                    const int g3 = __shfl_sync(kFull, d[j], gs * 4 + 3);
                    const int e0 = g0 + g2, e1 = g0 - g2, e2 = (g1 >> 1) - g3, e3 = g1 + (g3 >> 1);
                    const int val = (outer ? e0 : e1) + isgn * (outer ? e3 : e2);
                    rc[j] = clamp255(((val + 32) >> 6) + (dcw ? dc[i] : pr[i][j]));
                }
                if (grp == gs) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) ybuf[base[i] + u * kBufS + j] = rc[j];
                    int16_t* lv = acz_out + mb * 256 + blk[i] * 16 + u * 4;
                    if (vec) {
                        *reinterpret_cast<uint2*>(lv) = make_uint2(
                            ((uint32_t)q[i][0] & 0xffffu) | ((uint32_t)q[i][1] << 16),
                            ((uint32_t)q[i][2] & 0xffffu) | ((uint32_t)q[i][3] << 16));
                    } else {
#pragma unroll
                        for (int v = 0; v < 4; ++v) lv[v] = (int16_t)q[i][v];
                    }
                    if (ry != nullptr)
                        store4(ry + ((long long)mby * 16 + zby * 4 + u) * ((long long)mb_w * 16)
                               + mbx * 16 + zbx * 4, rc);
                }
            }
            __syncwarp();
        }
        // the MB's decision (strict), its outputs; the next left edge, the
        // left MB's bx = 3 modes (2 for an I_16x16 MB)
        const bool use_i4 = cost_i4 < (use_h ? cost_h : cost_d);
        if (lane == 0) {
            mode_out[mb] = (int16_t)(use_i4 ? 0 : use_h ? 1 : 2);
            if (chromah) cmode_out[mb] = (int16_t)use_ch;
        }
        if (lane < 16) {
            i4m_out[mb * 16 + lane] = (int16_t)(use_i4 ? (int)(zm >> (4 * lane)) & 15 : 2);
            if (use_i4) edge = ybuf[(lane + 1) * kBufS + 16];
            ybuf[(lane + 1) * kBufS] = edge;
        }
        lm4 = use_i4 ? ((zm >> 20) & 15) | ((zm >> 28) & 15) << 4 | ((zm >> 52) & 15) << 8
                           | ((zm >> 60) & 15) << 12
                     : 0x2222;
        __syncwarp();
    }
}

// C: a warp an MB, BlockRole's lanes: each intra MB's levels and, where
// `ry` is given, its reconstruction, from its source and the edge B stored;
// with I4 an Intra_4x4 MB's luma is B's (its zdc zeros)
template <bool P, bool I4 = false>
__global__ void __launch_bounds__(32 * kSplitWarps)
levels_intra_kernel(const uint8_t* __restrict__ y, long long y_rs,
                    const uint8_t* __restrict__ cb, long long cb_rs, long long cb_cs,
                    const uint8_t* __restrict__ cr, long long cr_rs, long long cr_cs,
                    int mb_h, int mb_w, Plan p, int word_y, int vec,
                    const int* __restrict__ rec, const int16_t* __restrict__ mode_in,
                    const int16_t* __restrict__ cmode_in, int16_t* __restrict__ zdc_out,
                    int16_t* __restrict__ acz_out, int16_t* __restrict__ czdc_out,
                    int16_t* __restrict__ cacz_out, uint8_t* __restrict__ ry,
                    uint8_t* __restrict__ rcb, uint8_t* __restrict__ rcr) {
    const int lane = threadIdx.x & 31;
    const long long mb = (long long)blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
    if (mb >= (long long)mb_h * mb_w) return;
    const int m = mode_in[mb];
    if (P && m < 2) return;                        // inter or skip: A wrote it
    const int mby = (int)(mb / mb_w), mbx = (int)(mb % mb_w);
    const BlockRole b(lane, p);
    // the prediction from the left edge this MB was decided with
    const uint32_t* E = reinterpret_cast<const uint32_t*>(rec + mb * kStride<I4> + kUsed);
    const bool keep = I4 && m == 0 && b.luma;    // an Intra_4x4 MB's luma lane
    const bool hor = b.luma ? (P ? m == 3 : m == 1)
                            : (!P && cmode_in != nullptr && cmode_in[mb] != 0);
    const uint32_t rows = E[b.luma ? b.by : 4 + b.comp * 2 + b.cby];
    const int sum = b.luma ? (int)(__vsadu4(E[0], 0u) + __vsadu4(E[1], 0u) + __vsadu4(E[2], 0u)
                                   + __vsadu4(E[3], 0u))
                           : (int)__vsadu4(rows, 0u);
    const int dc = mbx == 0 ? 128 : b.luma ? (sum + 8) >> 4 : (sum + 2) >> 2;
    int s[16], pr[16], t[16];
    load_block(b, y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, mby, mbx, word_y, s);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        pr[i] = (b.luma || b.chroma) ? (hor ? (int)((rows >> (8 * (i >> 2))) & 255) : dc) : 0;
        t[i] = s[i] - pr[i];
    }
    fwd16(t);
    int lev[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
        lev[k] = k ? quant(t[k], b.mf(pos_class(k >> 2, k & 3)), b.f, b.qb) : 0;
    const int zl = quant(had4_lanes(t[0], lane) >> 1, b.mf0, 2 * b.f, b.qb + 1);
    const int zc = quant(had2_lanes(t[0], lane), b.mf0, 2 * b.f, b.qb + 1);
    const int z = b.luma ? zl : zc;
    if (keep) zdc_out[mb * 16 + lane] = 0;
    else store_levels(b, mb, lane, z, lev, vec, zdc_out, acz_out, czdc_out, cacz_out);
    if (ry == nullptr) return;                     // the whole grid
    const int dl = luma_dc_dequant(had4_lanes(z, lane), p);
    const int dcc = chroma_dc_dequant(had2_lanes(z, lane), p);
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = lev[k] * b.v(pos_class(k >> 2, k & 3));
    d[0] = b.luma ? dl : dcc;
    inv16(d);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = clamp255(d[i] + pr[i]);
    long long rs;
    uint8_t* dst = plane_at(b, ry, rcb, rcr, mb_w, mby, mbx, rs);
    if ((b.luma && !keep) || b.chroma) {
#pragma unroll
        for (int r = 0; r < 4; ++r) store4(dst + r * rs, d + 4 * r);
    }
}

}  // namespace

namespace {

Plan plan_of(const int* plan) {
    Plan p;
    p.qp = plan[0];
    p.qpc = plan[1];
    p.qbits = plan[2];
    p.qbits_c = plan[3];
    p.f_y = plan[4];
    p.f_c = plan[5];
    for (int i = 0; i < 3; ++i) {
        p.mf_y[i] = plan[6 + i];
        p.mf_c[i] = plan[9 + i];
        p.v_y[i] = plan[12 + i];
        p.v_c[i] = plan[15 + i];
    }
    return p;
}

bool word_aligned(const void* p, long long rs) {
    return ((uintptr_t)p & 3) == 0 && (rs & 3) == 0;
}

}  // namespace

// `scratch`: record_words int32 a MB (kRecWords, with i4 kRecWordsI4; else
// cudaErrorInvalidValue)
extern "C" int intra_levels_launch(const uint8_t* y, long long y_rs,
                                   const uint8_t* cb, long long cb_rs,
                                   long long cb_cs, const uint8_t* cr,
                                   long long cr_rs, long long cr_cs, int mb_h,
                                   int mb_w, const int* plan, int i4, int chromah,
                                   int16_t* out, uint8_t* ry, uint8_t* rcb,
                                   uint8_t* rcr, int* scratch, int record_words,
                                   void* stream) {
    const Plan p = plan_of(plan);
    const cudaStream_t s = (cudaStream_t)stream;
    // the segments of ops/cuda/h264_levels.level_layout
    const long long n = (long long)mb_h * mb_w;
    int16_t* i4m = i4 ? out + 409 * n : nullptr;
    int16_t* cmode = chromah ? out + (i4 ? 425 : 409) * n : nullptr;
    if (mb_h <= 0 || mb_w <= 0) return (int)cudaGetLastError();
    if (scratch == nullptr || record_words != (i4 ? kRecWordsI4 : kRecWords))
        return (int)cudaErrorInvalidValue;
    const int blocks = (int)((n + kSplitWarps - 1) / kSplitWarps);
    const int word_y = word_aligned(y, y_rs), vec = ((uintptr_t)out & 15) == 0;
    if (i4) {
        levels_split_kernel<false, true><<<blocks, 32 * kSplitWarps, 0, s>>>(
            y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, nullptr, nullptr, nullptr, mb_h,
            mb_w, p, word_y, 0, vec, nullptr, nullptr, nullptr, 0, 0, scratch, nullptr,
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
        levels_chain_kernel<false, true><<<mb_h, 32, 0, s>>>(
            mb_w, p, chromah, 0, 0, scratch, out + 408 * n, cmode, out + 16 * n, i4m, ry, vec);
        levels_intra_kernel<false, true><<<blocks, 32 * kSplitWarps, 0, s>>>(
            y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, mb_h, mb_w, p, word_y, vec,
            scratch, out + 408 * n, cmode, out, out + 16 * n, out + 272 * n, out + 280 * n,
            ry, rcb, rcr);
        return (int)cudaGetLastError();
    }
    levels_split_kernel<false><<<blocks, 32 * kSplitWarps, 0, s>>>(
        y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, nullptr, nullptr, nullptr, mb_h,
        mb_w, p, word_y, 0, vec, nullptr, nullptr, nullptr, 0, 0, scratch, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
    levels_chain_kernel<false><<<mb_h, 32, 0, s>>>(mb_w, p, chromah, 0, 0, scratch,
                                                    out + 408 * n, cmode, nullptr, nullptr,
                                                    nullptr, 0);
    levels_intra_kernel<false><<<blocks, 32 * kSplitWarps, 0, s>>>(
        y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, mb_h, mb_w, p, word_y, vec,
        scratch, out + 408 * n, cmode, out, out + 16 * n, out + 272 * n, out + 280 * n,
        ry, rcb, rcr);
    return (int)cudaGetLastError();
}

extern "C" int p_levels_launch(const uint8_t* y, long long y_rs, const uint8_t* cb,
                               long long cb_rs, long long cb_cs, const uint8_t* cr,
                               long long cr_rs, long long cr_cs, const uint8_t* py,
                               const uint8_t* pcb, const uint8_t* pcr, int mb_h,
                               int mb_w, const int* plan, int motion, int two_refs,
                               int parts, int band_lo, int band_hi, int16_t* out,
                               uint8_t* ry, uint8_t* rcb, uint8_t* rcr, int* scratch,
                               int record_words, void* stream) {
    const Plan p = plan_of(plan);
    const cudaStream_t s = (cudaStream_t)stream;
    // the segments of ops/cuda/h264_levels.p_level_layout: mv (2 a MB, 8
    // with parts), ref (1, 4) and with parts pmode
    const long long n = (long long)mb_h * mb_w;
    const int16_t* mv = motion ? out + 409 * n : nullptr;
    const int16_t* ref = two_refs ? out + (parts ? 417 : 411) * n : nullptr;
    const int16_t* pmode = parts ? out + 421 * n : nullptr;
    if (mb_h <= 0 || mb_w <= 0) return (int)cudaGetLastError();
    if (scratch == nullptr || record_words != kRecWords) return (int)cudaErrorInvalidValue;
    const int blocks = (int)((n + kSplitWarps - 1) / kSplitWarps);
    const int word_y = word_aligned(y, y_rs), vec = ((uintptr_t)out & 15) == 0;
    const int word_p = word_aligned(py, 0) && word_aligned(pcb, 0) && word_aligned(pcr, 0);
    levels_split_kernel<true><<<blocks, 32 * kSplitWarps, 0, s>>>(
        y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, py, pcb, pcr, mb_h, mb_w, p,
        word_y, word_p, vec, mv, ref, pmode, band_lo, band_hi, scratch, out,
        out + 16 * n, out + 272 * n, out + 280 * n, ry, rcb, rcr);
    levels_chain_kernel<true><<<mb_h, 32, 0, s>>>(mb_w, p, 0, band_lo, band_hi,
                                                   scratch, out + 408 * n, nullptr, nullptr,
                                                   nullptr, nullptr, 0);
    levels_intra_kernel<true><<<blocks, 32 * kSplitWarps, 0, s>>>(
        y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, mb_h, mb_w, p, word_y, vec,
        scratch, out + 408 * n, nullptr, out, out + 16 * n, out + 272 * n,
        out + 280 * n, ry, rcb, rcr);
    return (int)cudaGetLastError();
}
