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
// What they compute, for each MB: the MB header (I: mb_type, with Intra_4x4
// the 16 prediction modes against the one-row-slice predicted mode,
// intra_chroma_pred_mode, coded_block_pattern and mb_qp_delta; P:
// mb_skip_run, mb_type, P_8x8's sub_mb_types, te(v) ref_idx with two active
// references, the mvds against the left-MB predictor or, with the partition
// modes, each partition's reference-aware predictor of spec 8.4.1.3 as the
// JAX _mvp_general_vec collapses it, cbp, mb_qp_delta), then the residual
// blocks (spec 9.2: coeff_token with nC from the left MB and the blocks above
// within the MB, the trailing-one signs, the levels with suffixLength and the
// escapes, total_zeros, run_before) gated by the cbp, in the bitstream's
// order: luma DC, the 16 luma blocks, the two chroma DC and the eight chroma
// AC blocks.  The words are MSB-first uint32, capped at nw_mb a MB: an MB over
// the cap reports its true bit count with its first 32 * nw_mb bits; a
// skipped MB reports 0 bits and zero words.  The bits equal the JAX functions'
// token for token: the same tokens (value, length) in the same order, so the
// same bit strings.
//
// Bound: bytes.  At 4K (135 x 240 MBs) H7 reads H1's 818 bytes a MB of int16
// levels (26.5 MB) and writes 64 words and a count a MB (8.3 MB): about 35
// MB, 0.0104 ms at 3.35 TB/s; H8 reads H2's 824 bytes a MB (844 with the
// partition fields, ~27.5 MB) and writes the same, 0.0107 ms.  What holds both
// far above that is each MB's chain of dependent steps on one warp: the
// counts, then 28 pieces of data-dependent tokens on 28 lanes (a warp only as
// fast as its longest piece), then the placement of the pieces; with few
// warps a scheduler that chain's latency is not hidden. Their read-and-store
// floors (below) take a small part of either time.
//
// One design serves both.  A warp walks a run of MBs of one row (the wrapper's
// pack_plan: H7 16 MBs, H8 PACK_P_RUN), four warps a block, the VLC table
// staged into shared memory once a block.  The run starts one MB early: that
// MB only gives the left context (its nonzero counts; H7 its Intra_4x4 modes
// and type; H8 its mode and its vector or its quadrants 1 and 3 with their
// references), and each later MB's left context is the previous MB's, carried
// in registers.  An MB's levels are loaded once, in 16-byte units (a lane a
// unit of acz; 16 lanes cacz, the rest zdc and czdc), into a per-warp copy in
// shared memory; the counts come from the registers (the halves of a block on
// two lanes, a shuffle; mb_counts, mb_cbp, lane_nc).  Lane k writes piece k
// (0 the header, 1 the luma DC, 2..17 the luma blocks in bitstream order, 18..19
// chroma DC, 20..27 chroma AC): a residual lane (residual_piece) reads its
// block (two 16-byte units), orders it by the zigzag in registers and codes
// it from its nonzero mask (block_regs: the trailing ones from the mask's top
// three bits, then the levels and the runs by walking its bits down, each
// token chosen without a branch), writing tokens through a 64-bit register
// that stores each full word into its piece in shared memory: no zeroed
// buffer, no read-modify-write.  place_words then places the pieces by an
// exclusive warp scan of their lengths, and each lane builds output words
// lane, lane + 32, ... from the non-empty pieces that cover them (the first
// by a binary search over the starts; the rest from a ballot of the non-empty
// ones, since a P MB's cbp leaves most of its pieces empty) and stores them:
// no atomics, and no copy of the words in shared memory, so nw_mb is not
// bounded.  kFloor instances are the kernels' read-and-store floors (the same
// loads and stores, no tokens).
//
// H7 (pack_i_kernel): the 16 Intra_4x4 mode tokens are a lane's each (lanes
// 0-15, against the predicted mode from shuffles), placed by a scan of their
// lengths and OR-reduced into 64 bits for lane 0's header.
//
// H8 (pack_p_kernel): runs of PACK_P_RUN MBs, far shorter than H7's, so that
// a P frame's lighter MBs still leave enough warps in flight to hide the
// chain (runs of 16 were slower than the warp per MB it replaced).
// mb_skip_run without a serial walk.  The warp carries the column of the last
// coded MB along its run; at the run's start it finds the last coded MB left
// of it by ballots of mode != 0 over 32 columns at a time, moving left (at 4K
// at most 8 ballots, and more than one only after a skip run of 32 MBs).  A
// skipped MB's counts are zero by the contract, so its levels are not loaded:
// the warp stores zero words and a zero count. An inter MB's fields (its
// vector and reference, or its quadrants' vectors, references and pmode) are
// loaded once, a lane an int16, and reach lane 0 by shuffles; lane 0 writes
// the header (the skip run, mb_type, the sub_mb_types and refs, the mvds
// against mvp_general, cbp, mb_qp_delta) through the same register writer, up
// to eight se(v) mvds (more than 64 bits: the writer stores each full word to
// the lane's piece).  Inter luma blocks are 16 coefficients gated by their 8x8
// quadrant; an intra MB keeps the I_16x16 shape (lane 1's DC piece, 15
// coefficients a luma block, gated by any_luma).
//

// All arithmetic is int32 / uint32 and exact; `>>` of a signed int is
// arithmetic.  The launchers are extern "C", launch on the stream they are
// given, do not synchronise, allocate nothing, and return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the VLC table's layout (ops/h264_bitpack.VLC_OFFSETS)
constexpr int kCtLen = 0, kCtCode = 204, kCdcLen = 408, kCdcCode = 428;
constexpr int kTzLen = 448, kTzCode = 704, kTzcLen = 960, kTzcCode = 976;
constexpr int kRbLen = 992, kRbCode = 1112, kCbpInter = 1232, kCbpIntra = 1280;
constexpr int kVlcSize = 1328;

struct Levels {
    const int16_t *zdc, *acz, *czdc, *cacz;
};

// a warp walks a run of MBs of one row (ops/cuda/h264_bitpack.pack_plan),
// kPackWarps warps a block, the VLC table staged once a block
constexpr int kPackWarps = 4;
constexpr int kPackThreads = 32 * kPackWarps;
constexpr int kPieceStride = 23;   // words of a lane's piece (21) and the reader's spill, odd
// a warp's MB in shared memory, in 16-byte units: acz (32), cacz (16), zdc
// (2), czdc (1)
constexpr int kUnitCacz = 32, kUnitZdc = 48, kUnitCzdc = 50, kUnits = 51;
constexpr unsigned kFull = 0xffffffffu;
// the zigzag scan as nibbles, folded at compile time in unrolled loops
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
    // se(v), |v| < 2^14: mapped without shifting a negative value
    __device__ void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
    __device__ void flush() {
        if (n > 0) w[wi++] = (uint32_t)(acc << (32 - n));
    }
};

// one residual block (spec 9.2), the JAX block_tokens' tokens: `lv` its levels in
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
            // the luma blocks' bitstream order -> raster by * 4 + bx
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

// the nonzero counts of an MB's blocks from its units in registers (a luma
// block's halves on lanes 2b and 2b + 1, a chroma block's on lanes 0-15):
// lane 2b holds luma block b's in bits 0-7 and chroma block b's in 8-15
__device__ __forceinline__ int mb_counts(uint4 ua, uint4 uc, int lane) {
    int cl = nz8(ua), cc = lane < 16 ? nz8(uc) : 0;
    cl += __shfl_xor_sync(kFull, cl, 1);
    cc += __shfl_xor_sync(kFull, cc, 1);
    return cl | (cc << 8);
}

// an MB's coded_block_pattern from its counts: chroma (0 none, 1 DC only,
// 2 AC), any luma block coded, the coded 8x8 luma quadrants (bit q)
struct Cbp {
    int chroma, any_luma, q4;
};

__device__ __forceinline__ Cbp mb_cbp(int cnt, uint4 uc, int lane) {
    const unsigned lmask = __ballot_sync(kFull, (cnt & 255) > 0) & 0x55555555u;   // bit 2b: block b
    const unsigned cmask = __ballot_sync(kFull, lane < 16 && (cnt >> 8) > 0);
    const bool cdc_any = __ballot_sync(kFull, lane == 18 && nz8(uc) > 0) != 0;
    int q4 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int b0 = (q >> 1) * 8 + (q & 1) * 2;
        const unsigned qm = (1u << (2 * b0)) | (1u << (2 * b0 + 2)) | (1u << (2 * b0 + 8))
                            | (1u << (2 * b0 + 10));
        q4 |= ((lmask & qm) != 0) << q;
    }
    return {cmask ? 2 : cdc_any ? 1 : 0, lmask != 0, q4};
}

// the nC of the lane's block from the MB's counts and the left MB's
// (`prevc`; none at the picture's left edge)
__device__ __forceinline__ int lane_nc(const PieceRole& role, int cnt, int prevc, bool at_edge) {
    const int left_c = __shfl_sync(kFull, cnt, 2 * role.left);
    const int above_c = __shfl_sync(kFull, cnt, 2 * max(role.above, 0));
    const int leftmb_c = __shfl_sync(kFull, prevc, 2 * role.left);
    const int sh = role.kind == 4 ? 8 : 0;
    const int lcount = (role.bx > 0 ? left_c : at_edge ? 0 : leftmb_c) >> sh & 255;
    const int tcount = (above_c >> sh) & 255;
    return role.by == 0 ? lcount
           : (role.bx == 0 && at_edge) ? tcount : (lcount + tcount + 1) >> 1;
}

// the lane's residual piece (kinds 1-4) from the MB's units `sm`, gated by
// the cbp: with `full_luma` the luma blocks carry 16 coefficients, each
// gated by its quadrant (Intra_4x4, inter); without, the DC piece and 15
// coefficients a luma block, gated by any luma (I_16x16)
__device__ __forceinline__ void residual_piece(RegBits& b, const PieceRole& role, const uint4* sm,
                                               int nc, bool full_luma, Cbp cbp, const int* vlc) {
    const bool on = role.kind == 1 ? !full_luma
                    : role.kind == 2 ? (full_luma ? (cbp.q4 >> role.quad) & 1 : cbp.any_luma)
                    : role.kind == 3 ? cbp.chroma >= 1
                    : role.kind == 4 && cbp.chroma == 2;
    if (!on) return;
    int r[16], lv[16];
    unpack16(sm[role.u0], sm[role.u1], r);
    const bool full = role.kind == 1 || (role.kind == 2 && full_luma);
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

// the pieces' places: an exclusive warp scan of the lanes' piece lengths
// `len` (pieces of `kPieceStride` words from `pieces`, 28 at most); each lane
// then builds output words lane, lane + 32, ... of the MB's `nw` from the
// non-empty pieces that cover them (the first by a binary search over the
// starts `st`) and stores them to `out`: no atomics; lane 0 stores the bit
// count to `nb`
__device__ __forceinline__ void place_words(const uint32_t* pieces, int* st, int lane, int len,
                                            int nw, uint32_t* __restrict__ out,
                                            int* __restrict__ nb) {
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    st[lane] = incl - len;
    // the pieces that hold bits: the word loops skip the others
    const unsigned ne = __ballot_sync(kFull, len > 0);
    __syncwarp();
    for (int j = lane; j < nw; j += 32) {
        const int lo = 32 * j, hi = lo + 32;
        uint32_t w = 0;
        if (lo < total) {
            // the last piece that starts at or before bit lo
            int k = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1)
                if (k + step < 32 && st[k + step] <= lo) k += step;
            for (unsigned m = ne & (kFull << k); m != 0; m &= m - 1) {
                k = __ffs(m) - 1;
                if (st[k] >= hi) break;
                const int end = st[k + 1];
                const int a = max(lo, st[k]), e = min(hi, end);
                const uint32_t* pb = pieces + k * kPieceStride;
                const int off = a - st[k], n = e - a;
                const unsigned long long two =
                    ((unsigned long long)pb[off >> 5] << 32) | pb[(off >> 5) + 1];
                const uint32_t v = (uint32_t)((two << (off & 31)) >> 32) >> (32 - n);
                w |= v << (hi - e);
            }
        }
        out[j] = w;
    }
    if (lane == 0) *nb = total;
}

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
        const int cnt = mb_counts(ua, uc, lane);
        const Cbp cbp = mb_cbp(cnt, uc, lane);
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
        const bool at_edge = mbx == 0;
        const int nc = lane_nc(role, cnt, prevc, at_edge);
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
                const int cbp4 = cbp.q4 | (cbp.chroma << 4);
                b.ue(vlc[kCbpIntra + cbp4]);
                if (cbp4 != 0) b.put(1u, 1);               // mb_qp_delta se(0)
            } else {
                b.ue(1 + md + 4 * cbp.chroma + 12 * cbp.any_luma);
                b.ue(cm);
                b.put(1u, 1);
            }
        } else {
            residual_piece(b, role, sm, nc, i4, cbp, vlc);
        }
        b.flush();
        place_words(piece[warp], st, lane, b.pos, nw, words + mb * nw, nbits + mb);
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

// H8.  With kFloor the same loads and stores and no tokens (the words of a
// coded MB no bit string, every count zero): the kernel's read-and-store
// floor
template <bool kFloor>
__global__ void __launch_bounds__(kPackThreads)
pack_p_kernel(Levels L, const int16_t* __restrict__ mode, const int16_t* __restrict__ mv,
              const int16_t* __restrict__ ref, const int16_t* __restrict__ pmode,
              int active_refs, int mb_h, int mb_w, int run, const int* __restrict__ vlc_g,
              int nw, int vec, uint32_t* __restrict__ words, int* __restrict__ nbits) {
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
    const long long row = (long long)mby * mb_w;
    const bool parts = pmode != nullptr;
    const PieceRole role(lane);
    uint4* sm = mbl[warp];
    uint32_t* mine = piece[warp] + lane * kPieceStride;
    int* st = starts[warp];
    // the column of the last coded MB left of the run: ballots of mode != 0
    // over 32 columns at a time, moving left (-1: none in the row)
    int last = -1;
    for (int c = x0 - 1; c >= 0; c -= 32) {
        const int col = c - lane;
        const unsigned coded = __ballot_sync(kFull, col >= 0 && mode[row + col] != 0);
        if (coded) {
            last = c - (__ffs(coded) - 1);
            break;
        }
    }
    // the previous MB's counts (lane 2b: luma block b in bits 0-7, chroma
    // block b in 8-15; zero where it was skipped), mode and fields (lane k
    // its field k, below)
    int prevc = 0, prevmd = 0, prevf = 0;
    // from the MB left of the run: its counts, mode and fields, no tokens
    for (int mbx = x0 > 0 ? x0 - 1 : 0; mbx < x1; ++mbx) {
        const long long mb = row + mbx;
        const bool warm = mbx < x0;
        const int md = mode[mb];
        if (md == 0) {
            // skipped: its counts are zero whatever its levels hold, so they
            // are not read; no bits, zero words
            if (!warm) {
                for (int j = lane; j < nw; j += 32) words[mb * nw + j] = 0u;
                if (lane == 0) nbits[mb] = 0;
            }
            prevc = prevmd = prevf = 0;
            continue;
        }
        // an inter MB's fields, an int16 a lane: the vector (dy, dx) of
        // each quadrant q on lanes 2q, 2q + 1 and its reference on lane 8 +
        // q, pmode on lane 12 (P_16x16: the MB's vector on lanes 0-1, its
        // reference on lane 8); an intra MB's fields are read by no header
        int fv = 0;
        if (md == 1) {
            if (parts)
                fv = lane < 8 ? mv[mb * 8 + lane]
                     : lane < 12 ? (ref != nullptr ? ref[mb * 4 + lane - 8] : 0)
                     : lane == 12 ? pmode[mb] : 0;
            else
                fv = lane < 2 ? (mv != nullptr ? mv[mb * 2 + lane] : 0)
                     : lane == 8 && ref != nullptr ? ref[mb] : 0;
        }
        // ---- the MB's levels, loaded once: 16-byte units into shared memory
        const uint4 ua = load_unit(L.acz + mb * 256 + 8 * lane, vec);
        const uint4 uc = lane < 16 ? load_unit(L.cacz + mb * 128 + 8 * lane, vec)
                                   : lane < 18 ? load_unit(L.zdc + mb * 16 + 8 * (lane - 16), vec)
                                   : lane == 18 ? load_unit(L.czdc + mb * 8, vec)
                                                : make_uint4(0, 0, 0, 0);
        sm[lane] = ua;
        if (lane < 19) sm[lane < 16 ? kUnitCacz + lane : kUnitZdc + lane - 16] = uc;
        __syncwarp();
        if (kFloor) {
            if (!warm) {
                for (int j = lane; j < nw; j += 32) {
                    const uint4 u = sm[j % kUnits];
                    words[mb * nw + j] = u.x ^ u.y ^ u.z ^ u.w ^ (uint32_t)(md + fv + last);
                }
                if (lane == 0) nbits[mb] = 0;
            }
            last = mbx;
            __syncwarp();
            continue;
        }
        // ---- the nonzero counts of the MB's blocks from the registers
        const int cnt = mb_counts(ua, uc, lane);
        if (warm) {
            prevc = cnt;
            prevmd = md;
            prevf = fv;
            __syncwarp();
            continue;
        }
        const Cbp cbp = mb_cbp(cnt, uc, lane);
        const bool intra = md >= 2, at_edge = mbx == 0;
        // ---- the header's fields from their lanes (every lane shuffles):
        // the MB's vectors and references; the left MB's vector (P_16x16)
        // or its quadrants 1 and 3 with their references (parts)
        int own[4][2] = {}, ownr[4] = {}, pm = 0;
        int a1[2] = {0, 0}, a3[2] = {0, 0}, a1r = 0, a3r = 0;
        if (!intra) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (q > 0 && !parts) break;
                own[q][0] = __shfl_sync(kFull, fv, 2 * q);
                own[q][1] = __shfl_sync(kFull, fv, 2 * q + 1);
                ownr[q] = __shfl_sync(kFull, fv, 8 + q);
            }
            const int l1 = parts ? 2 : 0;
            a1[0] = __shfl_sync(kFull, prevf, l1);
            a1[1] = __shfl_sync(kFull, prevf, l1 + 1);
            if (parts) {
                pm = __shfl_sync(kFull, fv, 12);
                a3[0] = __shfl_sync(kFull, prevf, 6);
                a3[1] = __shfl_sync(kFull, prevf, 7);
                a1r = __shfl_sync(kFull, prevf, 9);
                a3r = __shfl_sync(kFull, prevf, 11);
            }
        }
        const int nc = lane_nc(role, cnt, prevc, at_edge);
        // ---- the piece
        RegBits b{mine, 0ull, 0, 0, 0};
        if (role.kind == 0) {
            b.ue(mbx - 1 - last);                              // mb_skip_run
            const int cbp4 = cbp.q4 | (cbp.chroma << 4);
            if (intra) {
                b.ue(5 + 1 + (md == 3 ? 1 : 2) + 4 * cbp.chroma + 12 * cbp.any_luma);
                b.put(1u, 1);                                  // intra_chroma_pred_mode
                b.put(1u, 1);                                  // mb_qp_delta
            } else {
                if (!parts) {
                    // against the left MB's vector when it is inter (a
                    // skipped one carries (0, 0), an intra one resets)
                    const bool li = prevmd == 1 && !at_edge;
                    b.put(1u, 1);                              // P_L0_16x16, ue(0)
                    if (active_refs == 2) b.put((unsigned)(1 - ownr[0]), 1);
                    b.se(own[0][1] - (li ? a1[1] : 0));
                    b.se(own[0][0] - (li ? a1[0] : 0));
                } else {
                    // the left MB's quadrants 1 and 3 (a skipped left MB
                    // carries (0, 0) on reference 0; an intra one is no
                    // inter neighbour)
                    const bool left_ok = !at_edge, li = left_ok && prevmd <= 1;
                    if (!li) a1r = a3r = -1;
                    const int nparts = pm == 0 ? 1 : pm == 3 ? 4 : 2;
                    // each partition's representative quadrant: 0, then 2
                    // (16x8) or 1, then 2 and 3 (8x8)
                    const int q1 = pm == 1 ? 2 : 1;
                    const int z2[2] = {0, 0};
                    b.ue(pm);                                  // mb_type
                    if (pm == 3) b.put(15u, 4);                // sub_mb_type 8x8, four ue(0)
                    if (active_refs == 2) {
                        b.put((unsigned)(1 - ownr[0]), 1);
                        if (nparts > 1) b.put((unsigned)(1 - (q1 == 2 ? ownr[2] : ownr[1])), 1);
                        if (nparts > 2) {
                            b.put((unsigned)(1 - ownr[2]), 1);
                            b.put((unsigned)(1 - ownr[3]), 1);
                        }
                    }
                    // the mvds against each partition's predictor (the
                    // arrays indexed by constants only: no local memory)
                    int mvp[2];
                    mvp_general(a1, a1r, left_ok, z2, -1, false, z2, -1, false, ownr[0], mvp);
                    b.se(own[0][1] - mvp[1]);
                    b.se(own[0][0] - mvp[0]);
                    if (nparts > 1) {
                        if (pm == 1) {
                            if (left_ok && a3r == ownr[2]) {
                                mvp[0] = a3[0];
                                mvp[1] = a3[1];
                            } else {
                                mvp_general(a3, a3r, left_ok, own[0], ownr[0], true, a1, a1r,
                                            left_ok, ownr[2], mvp);
                            }
                            b.se(own[2][1] - mvp[1]);
                            b.se(own[2][0] - mvp[0]);
                        } else {
                            b.se(own[1][1] - own[0][1]);
                            b.se(own[1][0] - own[0][0]);
                        }
                    }
                    if (nparts > 2) {
                        mvp_general(a3, a3r, left_ok, own[0], ownr[0], true, own[1], ownr[1],
                                    true, ownr[2], mvp);
                        b.se(own[2][1] - mvp[1]);
                        b.se(own[2][0] - mvp[0]);
                        mvp_general(own[2], ownr[2], true, own[1], ownr[1], true, own[0],
                                    ownr[0], true, ownr[3], mvp);
                        b.se(own[3][1] - mvp[1]);
                        b.se(own[3][0] - mvp[0]);
                    }
                }
                b.ue(vlc[kCbpInter + cbp4]);
                if (cbp4 != 0) b.put(1u, 1);                    // mb_qp_delta
            }
        } else {
            residual_piece(b, role, sm, nc, !intra, cbp, vlc);
        }
        b.flush();
        place_words(piece[warp], st, lane, b.pos, nw, words + mb * nw, nbits + mb);
        last = mbx;
        prevc = cnt;
        prevmd = md;
        prevf = fv;
        __syncwarp();
    }
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

// `run` and `floor` as pack_i_launch's; `pmode` non-null: the partition
// layout (`mv` the quadrant vectors, `ref` the quadrant references)
extern "C" int pack_p_launch(const int16_t* mode, const int16_t* zdc, const int16_t* acz,
                             const int16_t* czdc, const int16_t* cacz, const int16_t* mv,
                             const int16_t* ref, const int16_t* pmode, int active_refs,
                             int mb_h, int mb_w, const int* vlc, int nw, int run, int floor,
                             uint32_t* words, int* nbits, void* stream) {
    const long long n = (long long)mb_h * mb_w;
    if (n <= 0) return (int)cudaGetLastError();
    if (run < 1 || (pmode != nullptr && mv == nullptr)) return (int)cudaErrorInvalidValue;
    const Levels L{zdc, acz, czdc, cacz};
    const long long warps = (long long)mb_h * ((mb_w + run - 1) / run);
    const unsigned blocks = (unsigned)((warps + kPackWarps - 1) / kPackWarps);
    const int vec = (((uintptr_t)zdc | (uintptr_t)acz | (uintptr_t)czdc | (uintptr_t)cacz) & 15) == 0;
    if (floor)
        pack_p_kernel<true><<<blocks, kPackThreads, 0, (cudaStream_t)stream>>>(
            L, mode, mv, ref, pmode, active_refs, mb_h, mb_w, run, vlc, nw, vec, words, nbits);
    else
        pack_p_kernel<false><<<blocks, kPackThreads, 0, (cudaStream_t)stream>>>(
            L, mode, mv, ref, pmode, active_refs, mb_h, mb_w, run, vlc, nw, vec, words, nbits);
    return (int)cudaGetLastError();
}
