// H5 deblock_kernel: the H.264 in-loop deblocking filter (spec 8.7) over one
// reconstructed picture, in place, on Hopper.
//
// Replaces opencv_opencl_tpu/ops/h264_deblock.py:226 deblock_planes with
// :59 bs_grids, an XLA lax.scan over the 2 * (mb_h - 1) + mb_w
// anti-diagonals of the macroblock (MB) grid: no Pallas kernel.  Its plain
// PyTorch version is deblock_planes_plain in
// opencv_opencl_tpu_torch/ops/h264_deblock.py, the wrappers deblock_planes
// and deblock_into in opencv_opencl_tpu_torch/ops/cuda/h264_deblock.py.
//
// What it computes: for each MB in raster order, its four vertical luma
// edges left to right, then its four horizontal ones top to bottom (chroma:
// edges 0 and 2 of each direction, a luma segment covering two chroma
// lines), each 4-sample segment with the boundary strength of spec 8.7.2.1
// derived from the MB metadata: 4 on an MB edge with an intra side, 3
// inside one, 2 where either 4x4 block has coded levels, 1 where the
// references differ or a motion vector component differs by 4 quarter
// samples or more, else 0 (the vectors and references one a MB, or with the
// partition modes one an 8x8 block, :59 bs_grids's g = 2, so that the
// edges inside a partitioned MB get their motion-driven bS); the picture
// border is never filtered, and with slice_local neither are the horizontal
// MB edges (one slice per MB row, disable_deblocking_filter_idc=2).  The
// filter itself is spec 8.7.2.3 / 8.7.2.4 with alpha, beta and tC0 of the
// picture QP (luma) and of its chroma QP from the table (chroma).
// `(q0 - p0) << 2` is written as a product: `<<` of a negative int is
// undefined in C++17.
//
// The order: MB (i, j) needs MB (i, j - 1) filtered (the same row), MB
// (i - 1, j) and the vertical edges of MB (i - 1, j + 1), whose writes
// reach the top-left halo this MB's top edges read.  MB (i, j)'s vertical
// edges need only its own row; its horizontal edges need the row above to
// have taken MB j + 1's vertical edges.  So a row can run one MB behind the
// row above: about mb_w + mb_h - 1 steps of one MB (374 at 4K), with T the
// time a step takes and L the handoff from one row to the next paid once a
// row.
//
// Design: two launches.  deblock_bs_kernel, a thread per MB over the whole
// picture, writes every MB's 32 boundary strengths as nibbles into one
// uint4 (bs_words in ops/h264_deblock.py is its plain version), so that no
// bS is derived on the wavefront's critical path.  deblock_kernel then runs
// the wavefront cooperatively (every block resident): a block owns a band
// of `rows` MB rows (4 at 4K, ops/cuda/h264_deblock.deblock_plan; fewer
// rows a block spread the rows over more SMs), a warp one row.  Lanes 0-15
// take the MB's 16 luma lines, lanes 16-31 its 16 chroma lines (8 a plane):
// a chroma line filters as a luma line whose ap and aq are false and whose
// tC is tC0 + 1, so every lane runs the same branch-free code on one line,
// all four edges of it in registers, for the vertical edges its row and for
// the horizontal ones its column; a warp vote skips the arithmetic of an
// edge that changes no line of the warp.  A patch a row in shared memory
// (the previous MB's 16 columns beside the current one's, written a word at
// a time) turns rows into columns and carries the left MB's columns.  The
// MB's own samples, which no other row writes before this MB, are
// prefetched two MBs ahead in 16- and 8-byte loads, with its bS word.  Each
// sample is written to the plane once, by the row that finalises it: the
// MB's top rows after its horizontal edges, the left MB's rows 0-11 right
// after this MB's vertical edges, in 16- and 8-byte stores.  The left MB's
// bottom rows (4 luma, 2 chroma) go to the row below through a ring of 8 MB
// slots in shared memory with produced / consumed counters; between bands,
// through two more warps a block: one copies the band's last ring to a seam
// in device memory (released at gpu scope once a batch of slots is there),
// the other the previous band's seam into its first ring (acquired), so
// that no compute warp ever waits on device memory.  Every wait traps after
// seconds, so that a fault fails the launch rather than hanging the card.
// With filter = 0 the launch does everything but the edge arithmetic: the
// wavefront's own floor.
//
// Bound: bytes.  At 4K it reads and writes the three planes (12.4 MB each
// way) and reads the metadata (0.6 MB): about 25 MB, 0.0077 ms at 3.35
// TB/s.  The wavefront's floor (filter = 0) is what this schedule costs
// without the filter; it is measured beside the kernel.
//
// The launcher is extern "C", launches on the stream it is given, does not
// synchronise, allocates nothing, and returns the launch's error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
    int al, bl, tl[3], ac, bc, tc[3];
};

constexpr int kRing = 8;                    // MB slots a ring holds
constexpr int kSlotY = 64;                  // a slot: 4 luma rows x 16
constexpr int kSlot = kSlotY + 32;          // and 2 planes x 2 chroma rows x 8
constexpr int kPitchY = 36;                 // luma patch: 20 rows x 32 columns
constexpr int kPitchC = 20;                 // chroma patch: 2 x 10 rows x 16
constexpr int kPatch = 20 * kPitchY + 2 * 10 * kPitchC;
constexpr long long kStuck = 20000000000LL; // clock cycles before a wait traps

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// the dynamic shared memory of a block of `rows` MB rows: the produced /
// consumed counters and the rows + 1 rings (ring k feeds local row k), then
// a patch a row
__host__ __device__ constexpr int shared_bytes(int rows) {
    return align16(8 * (rows + 1)) + (rows + 1) * kRing * kSlot + rows * kPatch;
}

__device__ __forceinline__ int clip3(int lo, int hi, int x) { return max(lo, min(hi, x)); }

// the boundary strength of the edge between 4x4 blocks p and q (block
// coordinates (row, col) on the (4 mb_h, 4 mb_w) grid); mb_edge: the edge is
// an MB edge; quad: mv and ref are one an 8x8 block on the (2 mb_h, 2 mb_w)
// grid (the partition modes' quadrant fields), else one a MB
__device__ int bs_of(int pr, int pc, int qr, int qc, bool mb_edge, int mb_w,
                     const uint8_t* intra, const uint8_t* nnz4, const int16_t* mv,
                     const int16_t* ref, int quad) {
    const int pm = (pr >> 2) * mb_w + (pc >> 2), qm = (qr >> 2) * mb_w + (qc >> 2);
    if (intra[pm] || intra[qm]) return mb_edge ? 4 : 3;
    const int w4 = 4 * mb_w;
    if (nnz4[pr * w4 + pc] || nnz4[qr * w4 + qc]) return 2;
    const int pf = quad ? (pr >> 1) * 2 * mb_w + (pc >> 1) : pm;
    const int qf = quad ? (qr >> 1) * 2 * mb_w + (qc >> 1) : qm;
    if (ref != nullptr && ref[pf] != ref[qf]) return 1;
    if (mv != nullptr && (abs(mv[2 * pf] - mv[2 * qf]) >= 4
                          || abs(mv[2 * pf + 1] - mv[2 * qf + 1]) >= 4))
        return 1;
    return 0;
}

// an MB's boundary strengths as nibbles: x, y the vertical edges (nibble s *
// 4 + e: the edge left of 4x4 block column e in block row s), z, w the
// horizontal ones (s * 4 + e: the edge above block row e in block column s)
__global__ void __launch_bounds__(256)
deblock_bs_kernel(int mb_h, int mb_w, const uint8_t* __restrict__ intra,
                  const uint8_t* __restrict__ nnz4, const int16_t* __restrict__ mv,
                  const int16_t* __restrict__ ref, int quad, int slice_local,
                  uint4* __restrict__ bs) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= mb_h * mb_w) return;
    const int i = m / mb_w, j = m - i * mb_w;
    unsigned v[2] = {0u, 0u}, h[2] = {0u, 0u};
    for (int s = 0; s < 4; ++s)
        for (int e = 0; e < 4; ++e) {
            const int n = s * 4 + e;
            const int br = 4 * i + s, bc = 4 * j + e;
            const unsigned bv = bc == 0 ? 0u
                : (unsigned)bs_of(br, bc - 1, br, bc, e == 0, mb_w, intra, nnz4, mv, ref, quad);
            const int hr = 4 * i + e, hc = 4 * j + s;
            const unsigned bh = (hr == 0 || (slice_local && e == 0)) ? 0u
                : (unsigned)bs_of(hr - 1, hc, hr, hc, e == 0, mb_w, intra, nnz4, mv, ref, quad);
            v[n >> 3] |= bv << ((n & 7) * 4);
            h[n >> 3] |= bh << ((n & 7) * 4);
        }
    bs[m] = make_uint4(v[0], v[1], h[0], h[1]);
}

// the four nibbles (edges 0..3) of segment s of one direction
__device__ __forceinline__ unsigned seg_bits(unsigned lo, unsigned hi, int s) {
    return ((s < 2 ? lo : hi) >> ((s & 1) * 16)) & 0xffffu;
}

// the filter parameters of a lane's line: luma or chroma
struct Line {
    int alpha, beta, t0, t1, t2;
    bool chroma;
};

// one line across an edge, v[0..7] = p3 p2 p1 p0 q0 q1 q2 q3 in registers,
// branch-free but for the strong filter; a chroma line is p1 p0 q0 q1 at
// v[2..5] and filters as a luma line whose ap and aq are false and whose
// tC is tC0 + 1 (spec 8.7.2.3: then only p0 and q0 change, and the strong
// filter's p0 / q0 are the chroma ones).  The strong filter only on an MB
// edge (inside an MB bS is at most 3).
template <bool kMbEdge>
__device__ __forceinline__ void line_edge(int* v, int bs, const Line& ln) {
    const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
    const int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
    const bool act = bs > 0 && abs(p0 - q0) < ln.alpha && abs(p1 - p0) < ln.beta
                     && abs(q1 - q0) < ln.beta;
    if (!__any_sync(0xffffffffu, act)) return;      // no line of the warp changes
    const bool ap = !ln.chroma && abs(p2 - p0) < ln.beta;
    const bool aq = !ln.chroma && abs(q2 - q0) < ln.beta;
    const int tc0 = bs == 1 ? ln.t0 : bs == 2 ? ln.t1 : ln.t2;
    const int tc = tc0 + (ln.chroma ? 1 : ap + aq);
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const int avg = (p0 + q0 + 1) >> 1;
    int np0 = clip3(0, 255, p0 + delta), nq0 = clip3(0, 255, q0 - delta);
    int np1 = ap ? p1 + clip3(-tc0, tc0, (p2 + avg - p1 * 2) >> 1) : p1;
    int nq1 = aq ? q1 + clip3(-tc0, tc0, (q2 + avg - q1 * 2) >> 1) : q1;
    int np2 = p2, nq2 = q2;
    if (kMbEdge && bs == 4) {
        const bool small = abs(p0 - q0) < ((ln.alpha >> 2) + 2);
        const bool sp = ap && small, sq = aq && small;
        np0 = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3 : (2 * p1 + p0 + q1 + 2) >> 2;
        np1 = sp ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
        np2 = sp ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
        nq0 = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3 : (2 * q1 + q0 + p1 + 2) >> 2;
        nq1 = sq ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
        nq2 = sq ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
    }
    if (act) {
        v[1] = np2; v[2] = np1; v[3] = np0;
        v[4] = nq0; v[5] = nq1; v[6] = nq2;
    }
}

// a line's four edges (v[0..19]: 4 samples before the MB, its 16; a chroma
// line 2 before and its 8 at v[2..11], its edges the first two), `bits` the
// four bS nibbles
__device__ __forceinline__ void filter_line(int* v, unsigned bits, const Line& ln) {
    line_edge<true>(v, bits & 15, ln);
    line_edge<false>(v + 4, (bits >> 4) & 15, ln);
    line_edge<false>(v + 8, (bits >> 8) & 15, ln);
    line_edge<false>(v + 12, (bits >> 12) & 15, ln);
}

__device__ __forceinline__ void unpack4(unsigned w, int* v) {
    v[0] = w & 255; v[1] = (w >> 8) & 255; v[2] = (w >> 16) & 255; v[3] = w >> 24;
}

__device__ __forceinline__ uint32_t pack4(const int* v) {
    return (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16)
           | ((uint32_t)v[3] << 24);
}

__device__ __forceinline__ void trap_if_stuck(long long t0) {
    if (clock64() - t0 > kStuck) __trap();
}

// wait until a shared counter reaches `need` (volatile reads, then a block
// fence: what the producer wrote before its count is visible)
__device__ __forceinline__ void wait_count(const volatile int* f, int need) {
    if (*f < need) {
        const long long t0 = clock64();
        while (*f < need) trap_if_stuck(t0);
    }
    __threadfence_block();
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// the block's two io warps.  The import warp copies the previous band's
// seam (its last row's bottom slots, in device memory, acquired) into ring
// 0; the export warp copies ring `rows` (this band's last row's bottom
// slots) out to this band's seam and releases it.  A seam: 4 luma rows x
// W, then 2 planes x 2 chroma rows x W / 2.  Lane 0 reads the counters, so
// that the warp agrees on them; a lane moves one of a slot's 8 parts (4
// luma rows of 16 bytes, 4 chroma rows of 8), 4 slots a pass.
__device__ void io_warp(bool export_, int rows, int mb_w, int lane, volatile int* prod,
                        volatile int* cons, uint8_t* rings, uint8_t* seam, int* seam_flag) {
    const int W = 16 * mb_w, cw = 8 * mb_w;
    const long long seam_bytes = 6LL * W;
    const int b = blockIdx.x;
    if (export_ ? b + 1 >= (int)gridDim.x : b == 0) return;
    uint8_t* band = seam + (export_ ? b : b - 1) * seam_bytes;
    uint8_t* ring = rings + (export_ ? rows : 0) * kRing * kSlot;
    const int part = lane & 7, sub = lane >> 3;
    int done = 0;
    long long t0 = clock64();
    while (done < mb_w) {
        int end = 0;
        if (lane == 0)
            end = export_ ? prod[rows]
                          : min(min(ld_acquire(seam_flag + b - 1), cons[0] + kRing), mb_w);
        end = __shfl_sync(0xffffffffu, end, 0);
        if (end <= done) {
            __nanosleep(20);
            trap_if_stuck(t0);
            continue;
        }
        __threadfence_block();
        for (int s = done + sub; s < end; s += 4) {
            uint8_t* slot = ring + (s % kRing) * kSlot;
            uint8_t* unit = part < 4 ? band + (long long)part * W + 16 * s
                : band + 4LL * W + (long long)(part - 4) * cw + 8 * s;
            uint8_t* at = part < 4 ? slot + 16 * part : slot + kSlotY + (part - 4) * 8;
            if (export_) {
                if (part < 4) *(uint4*)unit = *(const uint4*)at;
                else *(uint2*)unit = *(const uint2*)at;
            } else {
                if (part < 4) *(uint4*)at = __ldcg((const uint4*)unit);
                else *(uint2*)at = __ldcg((const uint2*)unit);
            }
        }
        if (export_) {
            __threadfence();
            __syncwarp();
            if (lane == 0) {
                cons[rows] = end;
                st_release(seam_flag + b, end);
            }
        } else {
            __threadfence_block();
            __syncwarp();
            if (lane == 0) prod[0] = end;
        }
        done = end;
        t0 = clock64();
    }
}

__global__ void __launch_bounds__(32 * 18)
deblock_kernel(uint8_t* y, uint8_t* cb, uint8_t* cr, int mb_h, int mb_w,
               const uint4* __restrict__ bs, Params prm, int rows, uint8_t* seam,
               int* seam_flag, int filter) {
    extern __shared__ __align__(16) uint8_t smem[];
    volatile int* prod = (volatile int*)smem;
    volatile int* cons = prod + rows + 1;
    uint8_t* rings = smem + align16(8 * (rows + 1));
    uint8_t* patches = rings + (rows + 1) * kRing * kSlot;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int k = threadIdx.x; k <= rows; k += blockDim.x) {
        prod[k] = 0;
        cons[k] = 0;
    }
    __syncthreads();
    if (warp >= rows) {
        io_warp(warp > rows, rows, mb_w, lane, prod, cons, rings, seam, seam_flag);
        return;
    }
    const int k = warp;                     // the warp's local row
    const int i = blockIdx.x * rows + k;
    if (i >= mb_h) return;
    const int W = 16 * mb_w, cw = 8 * mb_w;
    const bool chroma = lane >= 16;         // lanes 16-31 take the chroma lines
    const int l = lane & 15, cpl = l >> 3, c8 = l & 7;
    const bool top = i > 0, bottom = i == mb_h - 1;
    uint8_t* py = patches + k * kPatch;     // luma patch: rows -4..15, 32 columns
    uint8_t* pc = py + 20 * kPitchY;        // chroma: 2 planes x rows -2..7 x 16
    uint8_t* ring_top = rings + k * kRing * kSlot;
    uint8_t* ring_bot = rings + (k + 1) * kRing * kSlot;
    uint8_t* const cplane = cpl ? cr : cb;
    const Line ln = chroma ? Line{prm.ac, prm.bc, prm.tc[0], prm.tc[1], prm.tc[2], true}
                           : Line{prm.al, prm.bl, prm.tl[0], prm.tl[1], prm.tl[2], false};
    // the lane's line of a row: luma row l, or chroma row c8 of plane cpl
    uint8_t* const prow = chroma ? pc + (cpl * 10 + 2 + c8) * kPitchC : py + (4 + l) * kPitchY;
    // a luma lane's bS nibbles are its segment's; a chroma lane's edges 0
    // and 1 are luma edges 0 and 2 of its segment, its edges 2 and 3 none
    auto bits_of = [&](unsigned lo, unsigned hi) -> unsigned {
        const unsigned b = seg_bits(lo, hi, chroma ? c8 >> 1 : l >> 2);
        return chroma ? (b & 15) | ((b >> 4) & 0xf0) : b;
    };
    // the lane's own row of MB jj (16 luma or 8 chroma samples), and its bS
    auto load = [&](int jj, uint4& a, uint4& s) {
        if (jj >= 0 && jj < mb_w) {
            if (chroma) {
                const uint2 c = __ldcg((const uint2*)(cplane + (long long)(8 * i + c8) * cw + 8 * jj));
                a = make_uint4(c.x, c.y, 0, 0);
            } else {
                a = __ldcg((const uint4*)(y + (long long)(16 * i + l) * W + 16 * jj));
            }
            s = __ldg(bs + (long long)i * mb_w + jj);
        }
    };
    // MB jj's row (in the patch's half h) out: luma rows 0-11 and chroma
    // rows 0-5 to the planes, the bottom rows to the row below's ring, or to
    // the planes in the picture's last row
    auto out = [&](int jj, int h) {
        uint8_t* slot = ring_bot + (jj % kRing) * kSlot;
        if (chroma) {
            const uint32_t* src = (const uint32_t*)(prow + 8 * h);
            const uint2 w = make_uint2(src[0], src[1]);
            if (c8 < 6 || bottom)
                *(uint2*)(cplane + (long long)(8 * i + c8) * cw + 8 * jj) = w;
            else
                *(uint2*)(slot + kSlotY + cpl * 16 + (c8 - 6) * 8) = w;
        } else {
            const uint32_t* src = (const uint32_t*)(prow + 16 * h);
            const uint4 w = make_uint4(src[0], src[1], src[2], src[3]);
            if (l < 12 || bottom)
                *(uint4*)(y + (long long)(16 * i + l) * W + 16 * jj) = w;
            else
                *(uint4*)(slot + 16 * (l - 12)) = w;
        }
    };
    uint4 ya = make_uint4(0, 0, 0, 0), yb = ya, sa = ya, sb = ya;
    load(0, ya, sa);
    load(1, yb, sb);
    for (int j = 0; j < mb_w; ++j) {
        const uint4 yd = ya, sd = sa;
        ya = yb; sa = sb;
        load(j + 2, yb, sb);
        const int cur = (j & 1) * 16, ccur = (j & 1) * 8;

        // ---- the vertical edges: the lane's row, the left MB's last
        // columns before the MB's own (word k of a luma row holds columns
        // 4k..4k+3, the left MB's last four are word cur / 4 - 1 (mod 8); its
        // last two chroma columns the top half of word ccur / 4 - 1 (mod 4))
        int v[20];
        uint32_t* row = (uint32_t*)prow;
        const int w0 = chroma ? ((ccur >> 2) + 3) & 3 : ((cur >> 2) + 7) & 7;
        const uint32_t carry = row[w0];
        unpack4(carry, v);
        if (chroma) {
            // the left MB's columns 6, 7 are bytes 2, 3 of the word
            unpack4(yd.x, v + 4); unpack4(yd.y, v + 8);
#pragma unroll
            for (int q = 12; q < 20; ++q) v[q] = 0;
        } else {
            unpack4(yd.x, v + 4); unpack4(yd.y, v + 8); unpack4(yd.z, v + 12); unpack4(yd.w, v + 16);
        }
        if (filter) filter_line(v, bits_of(sd.x, sd.y), ln);
        if (chroma) {
            row[w0] = (carry & 0xffffu) | ((uint32_t)v[2] << 16) | ((uint32_t)v[3] << 24);
            row[ccur >> 2] = pack4(v + 4);
            row[(ccur >> 2) + 1] = pack4(v + 8);
        } else {
#pragma unroll
            for (int q = 0; q < 5; ++q) row[(w0 + q) & 7] = pack4(v + 4 * q);
        }
        __syncwarp();

        // ---- the left MB is final but for its bottom rows, which the row
        // below reads from now on
        if (j > 0) {
            if (!bottom) wait_count(cons + k + 1, j - kRing);
            out(j - 1, (j - 1) & 1);
            __threadfence_block();
        }
        __syncwarp();
        if (j > 0 && !bottom && lane == 0) prod[k + 1] = j;

        // ---- the horizontal edges: the lane's column, the row above's last
        // rows (its ring's slot j) first
        const uint8_t* slot = ring_top + (j % kRing) * kSlot;
        if (top) wait_count(prod + k, j + 1);
        if (chroma) {
            v[0] = v[1] = 0;
            v[2] = top ? slot[kSlotY + cpl * 16 + c8] : 0;
            v[3] = top ? slot[kSlotY + cpl * 16 + 8 + c8] : 0;
#pragma unroll
            for (int q = 0; q < 8; ++q) v[4 + q] = pc[(cpl * 10 + 2 + q) * kPitchC + ccur + c8];
#pragma unroll
            for (int q = 12; q < 20; ++q) v[q] = 0;
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = top ? slot[16 * q + l] : 0;
#pragma unroll
            for (int q = 0; q < 16; ++q) v[4 + q] = py[(4 + q) * kPitchY + cur + l];
        }
        if (filter) filter_line(v, bits_of(sd.z, sd.w), ln);
        if (chroma) {
#pragma unroll
            for (int q = 0; q < 8; ++q)
                pc[(cpl * 10 + 2 + q) * kPitchC + ccur + c8] = (uint8_t)v[4 + q];
            if (top) {
                cplane[(long long)(8 * i - 2) * cw + 8 * j + c8] = (uint8_t)v[2];
                cplane[(long long)(8 * i - 1) * cw + 8 * j + c8] = (uint8_t)v[3];
            }
        } else {
#pragma unroll
            for (int q = 0; q < 16; ++q) py[(4 + q) * kPitchY + cur + l] = (uint8_t)v[4 + q];
            if (top) {
                // the top rows are final now
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    y[(long long)(16 * i - 4 + q) * W + 16 * j + l] = (uint8_t)v[q];
            }
        }
        __syncwarp();
        if (top && lane == 0) cons[k] = j + 1;

        // ---- at the row's end this MB is final too
        if (j == mb_w - 1) {
            if (!bottom) wait_count(cons + k + 1, j - kRing + 1);
            out(j, j & 1);
            __threadfence_block();
            __syncwarp();
            if (!bottom && lane == 0) prod[k + 1] = mb_w;
        }
    }
}

}  // namespace

extern "C" int deblock_launch(uint8_t* y, uint8_t* cb, uint8_t* cr, int mb_h, int mb_w,
                              const uint8_t* intra, const uint8_t* nnz4,
                              const int16_t* mv, const int16_t* ref, int quad,
                              const int* params, int slice_local, int rows, int shared,
                              uint4* bs, uint8_t* seam, int* seam_flag, int filter,
                              void* stream) {
    Params prm;
    prm.al = params[0];
    prm.bl = params[1];
    prm.ac = params[5];
    prm.bc = params[6];
    for (int k = 0; k < 3; ++k) {
        prm.tl[k] = params[2 + k];
        prm.tc[k] = params[7 + k];
    }
    if (mb_h <= 0 || mb_w <= 0) return (int)cudaGetLastError();
    // the block layout is the wrapper's plan (ops/cuda/h264_deblock.py
    // deblock_plan): refuse a plan this kernel does not lay out the same way
    // (16 rows at most: a warp a row and the two io warps in 576 threads)
    if (rows < 1 || rows > 16 || shared != shared_bytes(rows))
        return (int)cudaErrorInvalidValue;
    const int n = mb_h * mb_w;
    deblock_bs_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        mb_h, mb_w, intra, nnz4, mv, ref, quad, slice_local, bs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (shared > 48 * 1024) {
        err = cudaFuncSetAttribute((const void*)deblock_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
        if (err != cudaSuccess) return (int)err;
    }
    const uint4* bsc = bs;
    void* args[] = {&y, &cb, &cr, &mb_h, &mb_w, &bsc, &prm, &rows, &seam, &seam_flag,
                    &filter};
    err = cudaLaunchCooperativeKernel((const void*)deblock_kernel,
                                      dim3((mb_h + rows - 1) / rows), dim3(32 * (rows + 2)),
                                      args, (size_t)shared, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
