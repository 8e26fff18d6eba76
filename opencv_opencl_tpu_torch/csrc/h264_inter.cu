// H3 subpel_planes_kernel, H4 motion_search_kernel and H6
// parts_search_kernel: the sub-sample planes of a reference picture, the
// per-macroblock (MB) motion search with motion compensation, and its
// sub-16x16 partition variant, for the P frames of the H.264 device GOP
// encoder, on Hopper.
//
// H3 replaces opencv_opencl_tpu/ops/h264_levels.py:703 _base_planes_jax
// with :733 halfpel_planes_jax and :738 quarterpel_planes_jax; H4 replaces
// :838 motion_search_mc, :958 motion_search_mc_fast, :1086
// motion_search_mc_fast_multi and :1399 motion_search_mc_multi.  They are
// XLA programs, no Pallas kernels.  The plain PyTorch versions are
// subpel_planes_plain and motion_search_plain in
// opencv_opencl_tpu_torch/ops/h264_levels.py, the wrappers subpel_planes,
// motion_search and search_into in
// opencv_opencl_tpu_torch/ops/cuda/h264_inter.py.
//
// H3: spec 8.4.2.2.1 over the edge-extended reference (every sample
// coordinate clamped into the picture, as a decoder clamps): G, the 6-tap
// halves b (horizontal) and h (vertical), each Clip1((x + 16) >> 5), and j,
// the horizontal 6-tap of the UNROUNDED vertical sums, Clip1((j1 + 512) >>
// 10); with 16 planes the 12 quarter positions are rounding averages of G,
// b, h, j and the neighbours G right and below, h right (m) and b below (s).
// Planes of 1 (G alone), 4 ([G, b, h, j]) or 16 ((fy, fx) raster), each
// (H + 2m) x (W + 2m), uint8.  Bound: bytes.  At 4K with margin 9 it reads
// 8.3 MB and writes 16 planes of 2178 x 3858 (134 MB): about 143 MB, 0.043
// ms at 3.35 TB/s.  Design: one thread per output position, a block of
// 32 x 8 positions with the clamped reference tile it reads (14 x 38
// samples) in shared memory; a thread recomputes the 6-taps its averages
// need (cheaper than a second pass).
//
// H4: for each MB the least key sad * 8192 + candidate index over the
// candidates (quarter-pel (dy, dx), in the oracle's order), references
// searched in turn with the earlier kept on equal keys; a candidate that
// the GDR clean-region rule excludes gets the key 2^31 - 1.  With the 49
// fastsub offsets (offs) a second stage refines around the full-pel winner
// on the winner's reference.  Then the MB's luma prediction from the
// winner's plane and its 8x8 chroma with the spec 8.4.2.2.2 bilinear (mvC
// = mv in 1/8 samples: integer part mv >> 3, arithmetic, fraction mv & 7,
// coordinates clamped).  SADs are exact integer sums.  Bound: operations.
// fastsub at search 8 on a 4K frame: 338 candidates x 8,294,400 pixels x 3
// operations (difference, absolute value, sum) = 8.4 G, 0.125 ms at 67 T
// operations/s; exhaustive quarter-pel at search 4 (1,089 candidates)
// 27 G, 0.40 ms.  Design: a block of 256 threads takes `mbs` MBs of one MB
// row (ops/cuda/h264_inter.search_plan_of: 5 for fastsub at search 8, 6
// for the quarter-pel lattice at search 4) and stages once, in shared
// memory, the current MBs and the window every candidate of the first stage
// reads: each (reference, sub-sample plane) the lattice uses, rows
// -search..15+search around the MB row and columns -search..16 mbs-1+search,
// as the 16-byte units of the stack that hold them (cp.async; the stack's
// rows have no alignment, so a row starts `lead` bytes into its first unit).
// The candidates are cut into tiles (search_tiles): one plane, one integer
// dx and up to 8 integer dy in a column.  A thread takes a tile, holds its
// MB as 64 packed words in registers, reads each window row once as 5
// aligned words shifted into 4 (__funnelshift_r) and adds it to the SAD of
// every candidate of the tile that row overlaps, 4 bytes at a time
// (__vsadu4).  Each tile's least (key << 1 | reference) goes to its MB by one
// shared atomicMin: the key carries its index, so the result does not
// depend on the order of evaluation.  fastsub then stages 16 planes x 17
// rows x 17 bytes (3 units a row) around each MB's full-pel winner and runs
// its 49 offsets as 28 tiles of one or two dy (refine_tiles).
//
// H6 replaces :1197 motion_search_mc_parts (with :800 _sad_quad_fields), two
// XLA fori_loops over the candidates (:1295, :1378); its plain version is
// motion_search_parts_plain / parts_stack_plain, the wrappers
// motion_search_parts and parts_search_into.  For each MB, over the
// candidates of every reference in ref-major order (flat index i = r * n +
// idx): nine least keys sad * 8192 + i, for the four 8x8 quadrants, the two
// 16x8 and the two 8x16 halves and the whole MB; then the partition mode,
// the least of cost_f = kf / 8192, cost_h = kh0 / 8192 + kh1 / 8192 + lam,
// cost_v alike and cost_q = the four quadrants' + 3 lam (lam =
// PART_LAMBDA[clip(qp, 0, 51)]) with a strict < in the order 16x8, 8x16,
// 8x8; each quadrant takes its partition's winner (a 16x8 MB's quadrants
// their row's half, an 8x16 MB's their column's), its 8x8 luma from the
// winner's plane and its 4x4 chroma with the bilinear at the winner's
// vector on the winner's reference.  The whole-MB SAD is at most 65,280, so
// a key stays below 2^31 while nrefs * n <= 8192 (the wrapper refuses
// more).  Bound: operations, as H4: full-pel search 8 (289 candidates) on
// a 4K frame 289 x 8,294,400 x 3 = 7.2 G, 0.107 ms at 67 T operations/s;
// half-pel search 8 or quarter-pel search 4 (1,089) 27.1 G, 0.404 ms.
// Design: one block of 256 threads per MB with the current MB in shared
// memory; warp w takes candidates w, w + 8, ...; lanes 8q..8q+7 sum
// quadrant q's 64 differences (a row of 8 a lane), a segmented shuffle
// reduce gives the four quadrant SADs in every lane, and each warp keeps
// the nine keys; one block reduce ends the sweep (the keys carry i, which
// carries the reference, so a plain key compare is the oracle's order and
// the result does not depend on the order of evaluation).  What bounds it:
// the byte loads and int32 sums of 256 threads a MB and the 8-way warp
// split; H4's staged window and packed SADs are for a later change.
//
// All arithmetic is int32 and exact; `>>` of a signed int is arithmetic.
// The launchers are extern "C", launch on the stream they are given, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ H3 ----

constexpr int kTileX = 32, kTileY = 8;
// the reference tile a block reads: two samples before its first output
// and three (plus one for the neighbour right / below) after its last
constexpr int kSx = kTileX + 6, kSy = kTileY + 6;

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int clip255(int x) { return max(0, min(255, x)); }

__global__ void __launch_bounds__(kTileX * kTileY)
subpel_planes_kernel(const uint8_t* __restrict__ ref, int H, int W, int margin,
                     int nplanes, uint8_t* __restrict__ out) {
    __shared__ int t[kSy][kSx];
    const int oh = H + 2 * margin, ow = W + 2 * margin;
    const int r0 = blockIdx.y * kTileY, c0 = blockIdx.x * kTileX;
    const int tid = threadIdx.y * kTileX + threadIdx.x;
    // t[ty][tx] = ref[clamp(r0 - margin - 2 + ty), clamp(c0 - margin - 2 + tx)]
    for (int i = tid; i < kSy * kSx; i += kTileX * kTileY) {
        const int ty = i / kSx, tx = i % kSx;
        const int ry = min(max(r0 - margin - 2 + ty, 0), H - 1);
        const int rx = min(max(c0 - margin - 2 + tx, 0), W - 1);
        t[ty][tx] = ref[(long long)ry * W + rx];
    }
    __syncthreads();
    const int yy = threadIdx.y, xx = threadIdx.x;
    const int r = r0 + yy, c = c0 + xx;
    if (r >= oh || c >= ow) return;
    const long long plane = (long long)oh * ow;
    uint8_t* o = out + (long long)r * ow + c;
    // the sample (r, c) of the extended plane is t[yy + 2][xx + 2]
    const int G = t[yy + 2][xx + 2];
    if (nplanes == 1) {
        o[0] = (uint8_t)G;
        return;
    }
    // b at row offset dy: the 6-tap along the row
#define BH(dy) clip255((tap6(t[yy + 2 + (dy)][xx], t[yy + 2 + (dy)][xx + 1],          \
                             t[yy + 2 + (dy)][xx + 2], t[yy + 2 + (dy)][xx + 3],      \
                             t[yy + 2 + (dy)][xx + 4], t[yy + 2 + (dy)][xx + 5]) + 16) >> 5)
    // the unrounded vertical 6-tap at column offset dx
#define V1(dx) tap6(t[yy][xx + 2 + (dx)], t[yy + 1][xx + 2 + (dx)],                  \
                    t[yy + 2][xx + 2 + (dx)], t[yy + 3][xx + 2 + (dx)],              \
                    t[yy + 4][xx + 2 + (dx)], t[yy + 5][xx + 2 + (dx)])
    const int B = BH(0);
    const int v0 = V1(0), v1 = V1(1);
    const int Hh = clip255((v0 + 16) >> 5);
    const int J = clip255((tap6(V1(-2), V1(-1), v0, v1, V1(2), V1(3)) + 512) >> 10);
    if (nplanes == 4) {
        o[0] = (uint8_t)G;
        o[plane] = (uint8_t)B;
        o[2 * plane] = (uint8_t)Hh;
        o[3 * plane] = (uint8_t)J;
        return;
    }
    const int Gr = t[yy + 2][xx + 3], Gd = t[yy + 3][xx + 2];
    const int m = clip255((v1 + 16) >> 5);   // h one column right
    const int s = BH(1);                      // b one row below
#undef BH
#undef V1
    const int q[16] = {G, (G + B + 1) >> 1, B, (Gr + B + 1) >> 1,
                       (G + Hh + 1) >> 1, (B + Hh + 1) >> 1, (B + J + 1) >> 1,
                       (B + m + 1) >> 1,
                       Hh, (Hh + J + 1) >> 1, J, (J + m + 1) >> 1,
                       (Gd + Hh + 1) >> 1, (Hh + s + 1) >> 1, (J + s + 1) >> 1,
                       (m + s + 1) >> 1};
#pragma unroll
    for (int p = 0; p < 16; ++p) o[p * plane] = (uint8_t)q[p];
}

// ------------------------------------------------------------------ H4 ----

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 8192;                 // io.h264_inter.SEARCH_KEY_RADIX
constexpr int kBadKey = 0x7fffffff;          // io.h264_inter._BAD_KEY
__constant__ int kRowExt[4] = {0, 3, 3, 4};  // io.h264_inter._MC_ROW_EXT
constexpr int kTileRows = 8;                 // dy values a first-stage tile holds
constexpr int kRefineRows = 17, kRefinePitch = 48;  // a fastsub plane window
constexpr int kRefineMb = 16 * kRefineRows * kRefinePitch;
constexpr int kMbInfo = 32;                  // a MB's keys and winner in shared memory

// a window row: the 16-byte units of the stack that hold its 16 mbs + 2
// search bytes, which start `lead` (0..15) bytes into the first, and 5
// words read from any of its columns
__host__ __device__ constexpr int window_pitch(int mbs, int search) {
    return (16 * mbs + 2 * search + 34 + 15) & ~15;
}

// the dynamic shared memory of a block of `mbs` MBs: the current MBs (256
// bytes each), their keys and winners, then the larger of the first
// stage's window (every slot's rows -search..15+search around the MB row,
// columns -search..16 mbs-1+search) and fastsub's (16 planes x 17 rows of
// 48 bytes around each MB's full-pel winner)
__host__ __device__ constexpr int search_shared(int mbs, int search, int nslots, int refine) {
    return (256 + kMbInfo) * mbs
           + (refine && mbs * kRefineMb > nslots * (2 * search + 16) * window_pitch(mbs, search)
              ? mbs * kRefineMb : nslots * (2 * search + 16) * window_pitch(mbs, search));
}

__device__ __forceinline__ int plane_of(int fy, int fx, int nplanes) {
    return nplanes == 16 ? fy * 4 + fx : nplanes == 4 ? (fy >> 1) * 2 + (fx >> 1) : 0;
}

struct Search {
    const uint8_t* stack;   // (nrefs * nplanes, hp, wp)
    long long plane;        // hp * wp
    int wp, nplanes, margin;
};

// the GDR clean-region rule: an MB row above the wave must not read at or
// below it, the interpolation's reach included
__device__ __forceinline__ bool excluded(int mby, int qy_total, int frac_y,
                                         int clean_rows) {
    return clean_rows >= 0 && mby < clean_rows
           && 16 * mby + 15 + (qy_total >> 2) + kRowExt[frac_y] > 16 * clean_rows - 1;
}

// the SADs of the current MB (64 packed words in registers, row r in
// cur[4r..4r+3]) against DY candidates one row apart: candidate d reads
// window rows d..d+15 from byte column `col` of `win` (rows of `pitch`
// bytes, row R's bytes starting (lead + R * step) % 16 into it, as the
// stack's 16-byte units were copied).  A window row is read once, as 5
// aligned words shifted into 4 (__funnelshift_r), and serves every
// candidate it overlaps; candidates past `cnt` sum garbage that the caller
// drops
template <int DY>
__device__ __forceinline__ void tile_sads(const uint8_t* win, int pitch, int col,
                                          unsigned lead, unsigned step, int cnt,
                                          const uint32_t* cur, unsigned* sad) {
#pragma unroll
    for (int d = 0; d < DY; ++d) sad[d] = 0;
    uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0;
    unsigned sh = 0;
#pragma unroll
    for (int R = 0; R < DY + 15; ++R) {
        if (R < cnt + 15) {
            const unsigned c = col + ((lead + R * step) & 15);
            const uint32_t* row = (const uint32_t*)(win + R * pitch) + (c >> 2);
            a0 = row[0]; a1 = row[1]; a2 = row[2]; a3 = row[3]; a4 = row[4];
            sh = (c & 3) * 8;
        }
        const uint32_t b0 = __funnelshift_r(a0, a1, sh), b1 = __funnelshift_r(a1, a2, sh);
        const uint32_t b2 = __funnelshift_r(a2, a3, sh), b3 = __funnelshift_r(a3, a4, sh);
#pragma unroll
        for (int d = 0; d < DY; ++d) {
            const int r = R - d;
            if (r >= 0 && r < 16)
                sad[d] += __vsadu4(cur[4 * r], b0) + __vsadu4(cur[4 * r + 1], b1)
                          + __vsadu4(cur[4 * r + 2], b2) + __vsadu4(cur[4 * r + 3], b3);
        }
    }
}

// copy the 16-byte units of the stack that hold `width` bytes from `src`
// into `dst` (16-aligned), asynchronously; the bytes start src % 16 into it
__device__ __forceinline__ void stage_row(uint8_t* dst, const uint8_t* src, int width, int c) {
    const uint8_t* unit = (const uint8_t*)((uintptr_t)src & ~(uintptr_t)15);
    if (16 * c < (int)((uintptr_t)src & 15) + width)
        __pipeline_memcpy_async(dst + 16 * c, unit + 16 * c, 16);
}

__device__ __forceinline__ void load_cur(const uint8_t* curs, int m, uint32_t* cur) {
    const uint4* src = (const uint4*)(curs + 256 * m);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
        const uint4 w = src[q];
        cur[4 * q] = w.x; cur[4 * q + 1] = w.y; cur[4 * q + 2] = w.z; cur[4 * q + 3] = w.w;
    }
}

// row r of fastsub's window of plane f around the full-pel winner w
// (reference, dy, dx at w[2..4]) of MB (mby, mbx): its first byte, at
// column -1 and row r - 1 of the winner's block
__device__ __forceinline__ const uint8_t* refine_row(const Search& s, const int* w, int mby,
                                                     int mbx, int f, int r) {
    return s.stack + (w[2] * 16 + f) * s.plane
           + (long long)(s.margin + 16 * mby + (w[3] >> 2) - 1 + r) * s.wp
           + s.margin + 16 * mbx + (w[4] >> 2) - 1;
}

// a tile: (window slot, fy * 4 + fx, first integer dy, ax * 16 + count)
__device__ __forceinline__ void tile_fields(int4 t, int& cnt, int& ax, int& fy, int& fx) {
    cnt = t.w & 15;
    ax = (t.w - cnt) / 16;
    fy = t.y >> 2;
    fx = t.y & 3;
}

__global__ void __launch_bounds__(kThreads, 2)
motion_search_kernel(const uint8_t* __restrict__ y, long long y_rs, Search s,
                     int search, const int* __restrict__ slot_planes, int nslots,
                     const int4* __restrict__ tiles, int ntiles,
                     const int16_t* __restrict__ inv, const int* __restrict__ cands,
                     const int4* __restrict__ rtiles, int nrtiles,
                     const int16_t* __restrict__ rinv, const int* __restrict__ offs,
                     int mbs, int clean_rows,
                     const uint8_t* __restrict__ cb0, const uint8_t* __restrict__ cr0,
                     const uint8_t* __restrict__ cb1, const uint8_t* __restrict__ cr1,
                     int16_t* __restrict__ mv_out, int16_t* __restrict__ ref_out,
                     uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_cb,
                     uint8_t* __restrict__ pred_cr) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* curs = smem;                                  // mbs x 256
    int* info = (int*)(smem + 256 * mbs);                  // mbs x 8
    uint8_t* win = smem + (256 + kMbInfo) * mbs;
    const int tid = threadIdx.x;
    const int mby = blockIdx.y, mbx0 = blockIdx.x * mbs;
    const int mb_w = (s.wp - 2 * s.margin) / 16, mb_h = gridDim.y;
    const int kb = min(mbs, mb_w - mbx0);                  // this block's MBs
    const int W = 16 * mb_w;
    const int pitch = window_pitch(mbs, search), rows = 2 * search + 16;
    const int slot_bytes = rows * pitch;

    // ---- the current MBs and every slot's window, staged once
    for (int q = tid; q < 256 * kb; q += kThreads) {
        const int m = q >> 8, py = (q >> 4) & 15, px = q & 15;
        curs[q] = y[(long long)(16 * mby + py) * y_rs + 16 * (mbx0 + m) + px];
    }
    if (tid < kb) {
        info[8 * tid] = -1;        // the first stage's least (key << 1 | ref)
        info[8 * tid + 1] = -1;    // fastsub's least key
    }
    const int width = 16 * kb + 2 * search, units = pitch / 16;
    const long long row0 = (long long)(s.margin + 16 * mby - search) * s.wp
                           + s.margin + 16 * mbx0 - search;
    const unsigned step = (unsigned)(s.wp & 15);
    for (int q = tid; q < nslots * rows * units; q += kThreads) {
        const int c = q % units, rr = q / units, r = rr % rows, slot = rr / rows;
        stage_row(win + slot * slot_bytes + r * pitch,
                  s.stack + slot_planes[slot] * s.plane + row0 + (long long)r * s.wp, width, c);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // ---- the first stage: a thread a tile of up to 8 candidates (dy one
    // row apart), one atomic least a tile; the key carries its index and
    // (key << 1 | ref) the earlier reference on equal keys, so the order of
    // evaluation does not matter
    uint32_t cur[64];
    int have = -1;
    for (int q = tid; q < kb * ntiles; q += kThreads) {
        const int m = q / ntiles;
        const int4 t = __ldg(tiles + (q - m * ntiles));
        if (m != have) {
            load_cur(curs, m, cur);
            have = m;
        }
        int cnt, ax, fy, fx;
        tile_fields(t, cnt, ax, fy, fx);
        unsigned sad[kTileRows];
        const unsigned lead = (unsigned)((uintptr_t)(s.stack + slot_planes[t.x] * s.plane + row0
                                                     + (long long)(t.z + search) * s.wp) & 15);
        tile_sads<kTileRows>(win + t.x * slot_bytes + (t.z + search) * pitch, pitch,
                             16 * m + ax + search, lead, step, cnt, cur, sad);
        const int r = slot_planes[t.x] / s.nplanes;
        unsigned best = 0xffffffffu;
#pragma unroll
        for (int d = 0; d < kTileRows; ++d) {
            if (d < cnt) {
                const int qy = 4 * (t.z + d) + fy, qx = 4 * ax + fx;
                const int idx = inv[(qy + 4 * search) * (8 * search + 1) + qx + 4 * search];
                const unsigned key = excluded(mby, qy, fy, clean_rows)
                    ? (unsigned)kBadKey : sad[d] * kRadix + idx;
                best = min(best, key * 2u + r);
            }
        }
        atomicMin((unsigned*)&info[8 * m], best);
    }
    __syncthreads();
    if (tid < kb) {
        const unsigned best = (unsigned)info[8 * tid];
        const int idx = (best >> 1) & (kRadix - 1);
        info[8 * tid + 2] = best & 1;
        info[8 * tid + 3] = cands[2 * idx];
        info[8 * tid + 4] = cands[2 * idx + 1];
    }
    __syncthreads();

    // ---- fastsub: the 49 quarter-pel offsets around each MB's full-pel
    // winner on its reference, from 16 planes x 17 rows x 17 bytes staged
    // around it
    if (rtiles != nullptr) {
        constexpr int kUnits = kRefinePitch / 16;
        for (int q = tid; q < kb * 16 * kRefineRows * kUnits; q += kThreads) {
            const int c = q % kUnits, rr = q / kUnits;
            const int r = rr % kRefineRows, f = (rr / kRefineRows) & 15;
            const int m = rr / (kRefineRows * 16);
            stage_row(win + rr * kRefinePitch, refine_row(s, info + 8 * m, mby, mbx0 + m, f, r),
                      17, c);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        for (int q = tid; q < kb * nrtiles; q += kThreads) {
            const int m = q / nrtiles;
            const int4 t = __ldg(rtiles + (q - m * nrtiles));
            if (m != have) {
                load_cur(curs, m, cur);
                have = m;
            }
            int cnt, ax, fy, fx;
            tile_fields(t, cnt, ax, fy, fx);
            unsigned sad[2];
            const unsigned lead =
                (unsigned)((uintptr_t)refine_row(s, info + 8 * m, mby, mbx0 + m, t.x, t.z + 1)
                           & 15);
            tile_sads<2>(win + m * kRefineMb + t.x * kRefineRows * kRefinePitch
                         + (t.z + 1) * kRefinePitch, kRefinePitch, ax + 1, lead, step, cnt, cur,
                         sad);
            const int vy = info[8 * m + 3];
            unsigned best = 0xffffffffu;
#pragma unroll
            for (int d = 0; d < 2; ++d) {
                if (d < cnt) {
                    const int oy = 4 * (t.z + d) + fy, ox = 4 * ax + fx;
                    const int j = rinv[(oy + 3) * 7 + ox + 3];
                    best = min(best, excluded(mby, vy + oy, fy, clean_rows)
                                         ? (unsigned)kBadKey : sad[d] * kRadix + j);
                }
            }
            atomicMin((unsigned*)&info[8 * m + 1], best);
        }
        __syncthreads();
        if (tid < kb) {
            const int j = (unsigned)info[8 * tid + 1] & (kRadix - 1);
            info[8 * tid + 3] += offs[2 * j];
            info[8 * tid + 4] += offs[2 * j + 1];
        }
        __syncthreads();
    }

    // ---- the winners out, and each MB's motion-compensated prediction
    if (tid < kb) {
        const long long mb = (long long)mby * mb_w + mbx0 + tid;
        mv_out[2 * mb] = (int16_t)info[8 * tid + 3];
        mv_out[2 * mb + 1] = (int16_t)info[8 * tid + 4];
        if (ref_out != nullptr) ref_out[mb] = (int16_t)info[8 * tid + 2];
    }
    for (int q = tid; q < 256 * kb; q += kThreads) {
        const int m = q >> 8, py = (q >> 4) & 15, px = q & 15;
        const int* w = info + 8 * m;
        const int r = w[2], dy = w[3], dx = w[4];
        const int p = r * s.nplanes + plane_of(dy & 3, dx & 3, s.nplanes);
        pred_y[(long long)(16 * mby + py) * W + 16 * (mbx0 + m) + px] =
            s.stack[p * s.plane + (long long)(s.margin + 16 * mby + py + (dy >> 2)) * s.wp
                    + s.margin + 16 * (mbx0 + m) + px + (dx >> 2)];
    }
    for (int q = tid; q < 128 * kb; q += kThreads) {
        const int m = q >> 7, comp = (q >> 6) & 1, cy = (q >> 3) & 7, cx = q & 7;
        const int* w = info + 8 * m;
        const int r = w[2], dy = w[3], dx = w[4];
        const int ch = mb_h * 8, cw = mb_w * 8;
        const uint8_t* src = comp ? (r ? cr1 : cr0) : (r ? cb1 : cb0);
        const int fy = dy & 7, fx = dx & 7;
        const int rr = 8 * mby + cy + (dy >> 3), cc = 8 * (mbx0 + m) + cx + (dx >> 3);
        const int ra = min(max(rr, 0), ch - 1), rb = min(max(rr + 1, 0), ch - 1);
        const int ca = min(max(cc, 0), cw - 1), cb_ = min(max(cc + 1, 0), cw - 1);
        const int v = ((8 - fx) * (8 - fy) * src[(long long)ra * cw + ca]
                       + fx * (8 - fy) * src[(long long)ra * cw + cb_]
                       + (8 - fx) * fy * src[(long long)rb * cw + ca]
                       + fx * fy * src[(long long)rb * cw + cb_] + 32) >> 6;
        (comp ? pred_cr : pred_cb)[(long long)(8 * mby + cy) * cw + 8 * (mbx0 + m) + cx] =
            (uint8_t)v;
    }
}

// ------------------------------------------------------------------ H6 ----

// the key of hypothesis j of the nine: quadrants 0..3 (tl, tr, bl, br), the
// 16x8 halves 4 (top) and 5 (bottom), the 8x16 halves 6 (left) and 7
// (right), the whole MB 8
__global__ void __launch_bounds__(kThreads)
parts_search_kernel(const uint8_t* __restrict__ y, long long y_rs, Search s,
                    int nrefs, const int* __restrict__ cands, int n, int lam,
                    const uint8_t* __restrict__ cb0, const uint8_t* __restrict__ cr0,
                    const uint8_t* __restrict__ cb1, const uint8_t* __restrict__ cr1,
                    int16_t* __restrict__ pmode_out, int16_t* __restrict__ mv_out,
                    int16_t* __restrict__ ref_out, uint8_t* __restrict__ pred_y,
                    uint8_t* __restrict__ pred_cb, uint8_t* __restrict__ pred_cr) {
    __shared__ int cur[256];
    __shared__ int wkey[kWarps][9];
    __shared__ int key[9];
    __shared__ int win[4][3];   // each quadrant's winner: ref, dy, dx
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int mbx = blockIdx.x, mby = blockIdx.y, mb_w = gridDim.x;
    const int W = mb_w * 16;
    cur[tid] = y[(long long)(16 * mby + (tid >> 4)) * y_rs + 16 * mbx + (tid & 15)];
    __syncthreads();

    // ---- the candidates of every reference: lanes 8q..8q+7 sum quadrant
    // q's rows, 8 pixels a lane; the halves and the whole MB are sums of
    // the quadrants'
    const int quad = lane >> 3;
    const int row = (quad >> 1) * 8 + (lane & 7), col = (quad & 1) * 8;
    int k[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) k[j] = kBadKey;
    for (int i = warp; i < nrefs * n; i += kWarps) {
        const int r = i / n, idx = i - r * n;
        const int qy = cands[2 * idx], qx = cands[2 * idx + 1];
        const int p = r * s.nplanes + plane_of(qy & 3, qx & 3, s.nplanes);
        const uint8_t* src = s.stack + p * s.plane
            + (long long)(s.margin + 16 * mby + row + (qy >> 2)) * s.wp
            + s.margin + 16 * mbx + col + (qx >> 2);
        const int* c = cur + row * 16 + col;
        int sad = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) sad += abs(c[j] - (int)src[j]);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) sad += __shfl_xor_sync(0xffffffffu, sad, o);
        const int q0 = __shfl_sync(0xffffffffu, sad, 0);
        const int q1 = __shfl_sync(0xffffffffu, sad, 8);
        const int q2 = __shfl_sync(0xffffffffu, sad, 16);
        const int q3 = __shfl_sync(0xffffffffu, sad, 24);
        const int sads[9] = {q0, q1, q2, q3, q0 + q1, q2 + q3, q0 + q2, q1 + q3,
                             q0 + q1 + q2 + q3};
#pragma unroll
        for (int j = 0; j < 9; ++j) k[j] = min(k[j], sads[j] * kRadix + i);
    }
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < 9; ++j) wkey[warp][j] = k[j];
    }
    __syncthreads();
    if (tid < 9) {
        int m = wkey[0][tid];
        for (int w = 1; w < kWarps; ++w) m = min(m, wkey[w][tid]);
        key[tid] = m;
    }
    __syncthreads();

    // ---- the partition decision (strict < in the order 16x8, 8x16, 8x8:
    // ties keep the coarser mode), each quadrant's winner out
    const long long mb = (long long)mby * mb_w + mbx;
    if (tid == 0) {
        const int cost_f = key[8] / kRadix;
        const int cost_h = key[4] / kRadix + key[5] / kRadix + lam;
        const int cost_v = key[6] / kRadix + key[7] / kRadix + lam;
        const int cost_q = key[0] / kRadix + key[1] / kRadix + key[2] / kRadix
                           + key[3] / kRadix + 3 * lam;
        int pmode = 0, best = cost_f;
        if (cost_h < best) { pmode = 1; best = cost_h; }
        if (cost_v < best) { pmode = 2; best = cost_v; }
        if (cost_q < best) { pmode = 3; best = cost_q; }
        pmode_out[mb] = (int16_t)pmode;
        for (int q = 0; q < 4; ++q) {
            // a 16x8 MB's quadrants take their row's half, an 8x16 MB's
            // their column's
            const int kk = pmode == 0 ? key[8] : pmode == 1 ? key[4 + (q >> 1)]
                         : pmode == 2 ? key[6 + (q & 1)] : key[q];
            const int i = kk & (kRadix - 1);
            const int r = i / n, idx = i - r * n;
            win[q][0] = r;
            win[q][1] = cands[2 * idx];
            win[q][2] = cands[2 * idx + 1];
            mv_out[8 * mb + 2 * q] = (int16_t)win[q][1];
            mv_out[8 * mb + 2 * q + 1] = (int16_t)win[q][2];
            if (ref_out != nullptr) ref_out[4 * mb + q] = (int16_t)r;
        }
    }
    __syncthreads();

    // ---- the prediction: each 8x8 luma quadrant from its winner's plane,
    // each 4x4 chroma quadrant with the bilinear at its winner's vector
    {
        const int py = tid >> 4, px = tid & 15;
        const int q = (py >> 3) * 2 + (px >> 3);
        const int r = win[q][0], dy = win[q][1], dx = win[q][2];
        const int p = r * s.nplanes + plane_of(dy & 3, dx & 3, s.nplanes);
        pred_y[(long long)(16 * mby + py) * W + 16 * mbx + px] =
            s.stack[p * s.plane + (long long)(s.margin + 16 * mby + py + (dy >> 2)) * s.wp
                    + s.margin + 16 * mbx + px + (dx >> 2)];
    }
    if (tid < 128) {
        const int comp = tid >> 6, cy = (tid >> 3) & 7, cx = tid & 7;
        const int q = (cy >> 2) * 2 + (cx >> 2);
        const int r = win[q][0], dy = win[q][1], dx = win[q][2];
        const int ch = gridDim.y * 8, cw = mb_w * 8;
        const uint8_t* src = comp ? (r ? cr1 : cr0) : (r ? cb1 : cb0);
        const int fy = dy & 7, fx = dx & 7;
        const int rr = 8 * mby + cy + (dy >> 3), cc = 8 * mbx + cx + (dx >> 3);
        const int ra = min(max(rr, 0), ch - 1), rb = min(max(rr + 1, 0), ch - 1);
        const int ca = min(max(cc, 0), cw - 1), cb_ = min(max(cc + 1, 0), cw - 1);
        const int v = ((8 - fx) * (8 - fy) * src[(long long)ra * cw + ca]
                       + fx * (8 - fy) * src[(long long)ra * cw + cb_]
                       + (8 - fx) * fy * src[(long long)rb * cw + ca]
                       + fx * fy * src[(long long)rb * cw + cb_] + 32) >> 6;
        (comp ? pred_cr : pred_cb)[(long long)(8 * mby + cy) * cw + 8 * mbx + cx] =
            (uint8_t)v;
    }
}

}  // namespace

extern "C" int subpel_planes_launch(const uint8_t* ref, int H, int W, int margin,
                                    int nplanes, uint8_t* out, void* stream) {
    const int oh = H + 2 * margin, ow = W + 2 * margin;
    if (H > 0 && W > 0) {
        const dim3 grid((ow + kTileX - 1) / kTileX, (oh + kTileY - 1) / kTileY);
        subpel_planes_kernel<<<grid, dim3(kTileX, kTileY), 0, (cudaStream_t)stream>>>(
            ref, H, W, margin, nplanes, out);
    }
    return (int)cudaGetLastError();
}

extern "C" int motion_search_launch(const uint8_t* y, long long y_rs, int mb_h, int mb_w,
                                    const uint8_t* stack, int nplanes, int margin,
                                    int search, const int* slot_planes, int nslots,
                                    const int* tiles, int ntiles, const int16_t* inv,
                                    const int* cands, const int* rtiles, int nrtiles,
                                    const int16_t* rinv, const int* offs, int mbs, int shared,
                                    int clean_rows, const uint8_t* cb0, const uint8_t* cr0,
                                    const uint8_t* cb1, const uint8_t* cr1,
                                    int16_t* mv, int16_t* ref, uint8_t* pred_y,
                                    uint8_t* pred_cb, uint8_t* pred_cr, void* stream) {
    // the block layout is the wrapper's plan (ops/cuda/h264_inter.py
    // search_plan_of): refuse a plan this kernel does not lay out the same way
    if (mbs < 1 || shared != search_shared(mbs, search, nslots, rtiles != nullptr))
        return (int)cudaErrorInvalidValue;
    Search s;
    s.stack = stack;
    s.wp = mb_w * 16 + 2 * margin;
    s.plane = (long long)(mb_h * 16 + 2 * margin) * s.wp;
    s.nplanes = nplanes;
    s.margin = margin;
    if (mb_h <= 0 || mb_w <= 0) return (int)cudaGetLastError();
    if (shared > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            (const void*)motion_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            shared);
        if (err != cudaSuccess) return (int)err;
    }
    motion_search_kernel<<<dim3((mb_w + mbs - 1) / mbs, mb_h), kThreads, shared,
                           (cudaStream_t)stream>>>(
        y, y_rs, s, search, slot_planes, nslots,
        (const int4*)tiles, ntiles, inv, cands, (const int4*)rtiles, nrtiles, rinv, offs, mbs,
        clean_rows, cb0, cr0, cb1, cr1, mv, ref, pred_y, pred_cb, pred_cr);
    return (int)cudaGetLastError();
}

extern "C" int parts_search_launch(const uint8_t* y, long long y_rs, int mb_h, int mb_w,
                                   const uint8_t* stack, int nplanes, int margin,
                                   int nrefs, const int* cands, int n, int lam,
                                   const uint8_t* cb0, const uint8_t* cr0,
                                   const uint8_t* cb1, const uint8_t* cr1,
                                   int16_t* pmode, int16_t* mv, int16_t* ref,
                                   uint8_t* pred_y, uint8_t* pred_cb, uint8_t* pred_cr,
                                   void* stream) {
    Search s;
    s.stack = stack;
    s.wp = mb_w * 16 + 2 * margin;
    s.plane = (long long)(mb_h * 16 + 2 * margin) * s.wp;
    s.nplanes = nplanes;
    s.margin = margin;
    if (mb_h > 0 && mb_w > 0)
        parts_search_kernel<<<dim3(mb_w, mb_h), kThreads, 0, (cudaStream_t)stream>>>(
            y, y_rs, s, nrefs, cands, n, lam, cb0, cr0, cb1, cr1, pmode, mv, ref,
            pred_y, pred_cb, pred_cr);
    return (int)cudaGetLastError();
}
