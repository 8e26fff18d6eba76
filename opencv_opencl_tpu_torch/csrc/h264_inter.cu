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
// ms at 3.35 TB/s; the arithmetic (~80 operations a position) is far below.
// What bounds it is the stores: a plane row is W + 2m bytes (3858 at 4K),
// no multiple of 4, and each plane starts at its own byte alignment.
// Design (subpel_planes_kernel<NP>, NP the plane count; ops/cuda/
// h264_inter.planes_plan): a block of 256 threads computes the base planes
// of 8 rows x 512 columns of positions in separable passes.  A thread a
// column stages the clamped reference's 13 rows of it (all its loads in
// flight at once) and computes from them in registers every unrounded
// vertical sum once; then a warp a row, a lane a run of 16 positions,
// slides b's and j's horizontal 6-taps over 21 staged samples and 21
// vertical sums and writes b, h and j to shared memory as 16-byte words.
// The block owns 496 of the 512 columns (7 rows with 16 planes, whose
// averages read the row below and the column right; else 8) and stores a
// warp a (plane, row): lane u the u-th 16-byte unit of the flat plane that
// lies wholly in the row and starts in those columns (31 lanes, 496
// contiguous bytes a store), each unit the __vavgu4 of two operands known
// at compile time (a switch on the plane, the same across the warp; a
// direct plane is one operand), read as two aligned 16-byte words shifted
// into place; the bytes before a row's first unit and after its last are
// written singly, by the block whose columns hold them.  Every byte is
// written once.  subpel_floor_kernel<NP> is the same grid and the same
// stores with every plane written from G, no filter arithmetic: what the
// stores alone cost.
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
// What bounded its first design (a block a MB, byte loads from L2, 8
// int sums a lane a candidate) was the loads and the instructions a byte.
// Design: H4's (ops/cuda/h264_inter.parts_plan_of): a block of 256 threads
// takes `mbs` MBs of one MB row and stages the current MBs and every
// (reference, plane) slot's window once with cp.async; a thread takes a
// tile of search_tiles (one plane, one integer dx, up to 8 dy: with 32 sums
// and the MB's 64 words, 128 registers and no spill), holds its MB as 64
// packed words and reads each window row once as 5 words shifted into 4,
// adding __vsadu4 into four quadrant sums a candidate (rows 0-7 and 8-15,
// words 0-1 and 2-3; tile_sads<kTileRows, true>); the halves and the whole
// MB are sums of the quadrants.  Each tile's nine least keys are combined over the lanes of
// its warp that hold the same MB (__match_any_sync, __reduce_min_sync) and
// go to the MB by nine shared atomicMins: the keys carry their index, so
// the result does not depend on the order of evaluation (H6 has no GDR
// rule).  Then a thread a MB decides, and the block predicts its MBs'
// quadrants.
//
// All arithmetic is int32 and exact; `>>` of a signed int is arithmetic.
// The launchers are extern "C", launch on the stream they are given, do not
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ H3 ----

constexpr int kPlaneThreads = 256, kPlaneWarps = kPlaneThreads / 32;
// the base planes a block computes (rows x columns of positions), the
// columns whose 16-byte units it stores (31 units: a warp's lanes store a
// row's), and the run of positions a thread computes (a warp a row)
constexpr int kBaseRows = 8, kBaseCols = 512, kOwnCols = kBaseCols - 16, kRun = 16;
constexpr int kUnits = kOwnCols / 16;
// the staged reference: two samples before the first position and three
// after the last, each way; rows of kPitch bytes (16-byte aligned, read as
// 16-byte words)
constexpr int kStageRows = kBaseRows + 5, kStageCols = kBaseCols + 5;
constexpr int kPitch = kBaseCols + 16;

// the rows a block owns: with 16 planes the averages read the row below
__host__ __device__ constexpr int own_rows(int nplanes) {
    return nplanes == 16 ? kBaseRows - 1 : kBaseRows;
}

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int clip255(int x) { return max(0, min(255, x)); }

// the operands of the planes: 0 G, 1 b, 2 h, 3 j, then 4 G one column
// right (Gr), 5 h one column right (m), 6 G one row below (Gd) and 7 b one
// row below (s); each is read from the staged reference (source -1, at its
// +2 offsets) or from base plane b, h or j (source 0, 1, 2), at a row and
// column offset
__host__ __device__ constexpr int op_src(int op) {
    return op == 1 || op == 7 ? 0 : op == 2 || op == 5 ? 1 : op == 3 ? 2 : -1;
}
__host__ __device__ constexpr int op_dy(int op) { return op >= 6 ? 1 : 0; }
__host__ __device__ constexpr int op_dc(int op) { return op == 4 || op == 5 ? 1 : 0; }
// plane fy * 4 + fx of 16 is the rounding average of two operands (a
// direct plane averages one with itself); 4 planes are 0, 2, 8 and 10 of
// them, 1 plane is plane 0
constexpr int8_t kPlaneOps[16][2] = {
    {0, 0}, {0, 1}, {1, 1}, {4, 1}, {0, 2}, {1, 2}, {1, 3}, {1, 5},
    {2, 2}, {2, 3}, {3, 3}, {3, 5}, {6, 2}, {2, 7}, {3, 7}, {5, 7}};

struct PlaneTiles {
    uint8_t stage[kStageRows][kPitch];
    int16_t vsum[kBaseRows][kPitch];             // unrounded vertical 6-taps
    uint8_t base[3][kBaseRows][kPitch];          // b, h, j
};

// the row (16-byte aligned) of operand OP at position row y, and the column
// that holds position column c
template <int OP>
__device__ __forceinline__ const uint8_t* operand_row(const PlaneTiles& t, int y, int& c) {
    c += op_dc(OP) + (op_src(OP) < 0 ? 2 : 0);
    if constexpr (op_src(OP) < 0) return t.stage[y + 2 + op_dy(OP)];
    else return t.base[op_src(OP)][y + op_dy(OP)];
}

// 16 bytes from column c of a 16-byte aligned row: the two 16-byte words
// that hold them, the 5 words from c's picked by two selects and shifted
// into 4 (a warp's lanes share c % 16)
__device__ __forceinline__ uint4 load16(const uint8_t* row, int c) {
    const uint4* q = (const uint4*)(row + (c & ~15));
    const uint4 a = q[0], b = q[1];
    const bool h8 = c & 8, h4 = c & 4;
    const uint32_t x0 = h8 ? a.z : a.x, x1 = h8 ? a.w : a.y, x2 = h8 ? b.x : a.z;
    const uint32_t x3 = h8 ? b.y : a.w, x4 = h8 ? b.z : b.x, x5 = h8 ? b.w : b.y;
    const uint32_t w0 = h4 ? x1 : x0, w1 = h4 ? x2 : x1, w2 = h4 ? x3 : x2;
    const uint32_t w3 = h4 ? x4 : x3, w4 = h4 ? x5 : x4;
    const unsigned sh = (c & 3) * 8;
    return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                      __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// the rounding average of operands A and B (A itself where they are one)
// at row y over 16 bytes from column c, or at one byte
template <int A, int B>
__device__ __forceinline__ uint4 avg16(const PlaneTiles& t, int y, int c) {
    int ca = c;
    const uint8_t* ra = operand_row<A>(t, y, ca);
    const uint4 a = load16(ra, ca);
    if constexpr (A == B) {
        return a;
    } else {
        int cb = c;
        const uint8_t* rb = operand_row<B>(t, y, cb);
        const uint4 b = load16(rb, cb);
        return make_uint4(__vavgu4(a.x, b.x), __vavgu4(a.y, b.y), __vavgu4(a.z, b.z),
                          __vavgu4(a.w, b.w));
    }
}

template <int A, int B>
__device__ __forceinline__ uint8_t avg1(const PlaneTiles& t, int y, int c) {
    int ca = c, cb = c;
    const uint8_t* ra = operand_row<A>(t, y, ca);
    const uint8_t* rb = operand_row<B>(t, y, cb);
    return (uint8_t)((ra[ca] + rb[cb] + 1) >> 1);
}

// the table entry of plane p of NP (with FLOOR, G for every plane)
template <int NP, bool FLOOR>
__device__ __forceinline__ int plane_entry(int p) {
    return FLOOR || NP == 1 ? 0 : NP == 4 ? (p >> 1) * 8 + (p & 1) * 2 : p;
}

// RET(e) for plane p's table entry e, each case with its operands known at
// compile time (p is the same across a warp: the switch does not diverge)
#define PLANE_CASES(RET)                                                                 \
    switch (plane_entry<NP, FLOOR>(p)) {                                                 \
        case 0: RET(0); case 1: RET(1); case 2: RET(2); case 3: RET(3);                  \
        case 4: RET(4); case 5: RET(5); case 6: RET(6); case 7: RET(7);                  \
        case 8: RET(8); case 9: RET(9); case 10: RET(10); case 11: RET(11);              \
        case 12: RET(12); case 13: RET(13); case 14: RET(14); default: RET(15);          \
    }

// plane p's 16 bytes at row y, columns c..c+15 of the block's positions
template <int NP, bool FLOOR>
__device__ __forceinline__ uint4 plane_unit(const PlaneTiles& t, int p, int y, int c) {
#define RET(e) return avg16<kPlaneOps[e][0], kPlaneOps[e][1]>(t, y, c)
    PLANE_CASES(RET)
#undef RET
}

// plane p's byte at row y, column c of the block's positions
template <int NP, bool FLOOR>
__device__ __forceinline__ uint8_t plane_byte(const PlaneTiles& t, int p, int y, int c) {
#define RET(e) return avg1<kPlaneOps[e][0], kPlaneOps[e][1]>(t, y, c)
    PLANE_CASES(RET)
#undef RET
}

#undef PLANE_CASES

template <int NP, bool FLOOR>
__device__ __forceinline__ void planes_body(const uint8_t* __restrict__ ref, int H, int W,
                                            int margin, uint8_t* __restrict__ out) {
    __shared__ __align__(16) PlaneTiles t;
    constexpr int kRows = own_rows(NP);
    const int oh = H + 2 * margin, ow = W + 2 * margin;
    const int r0 = blockIdx.y * kRows, c0 = blockIdx.x * kOwnCols;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // ---- the clamped reference tile, t.stage[ty][x] = ref[clamp(r0 -
    // margin - 2 + ty), clamp(c0 - margin - 2 + x)], a thread a column (its
    // 13 loads in flight at once); from the column in registers, every
    // unrounded vertical sum once: vsum[y][x], the 6-tap of rows y..y+5
    {
        long long rowoff[kStageRows];
#pragma unroll
        for (int ty = 0; ty < kStageRows; ++ty)
            rowoff[ty] = (long long)min(max(r0 - margin - 2 + ty, 0), H - 1) * W;
        for (int x = tid; x < kStageCols; x += kPlaneThreads) {
            const int rx = min(max(c0 - margin - 2 + x, 0), W - 1);
            int v[kStageRows];
#pragma unroll
            for (int ty = 0; ty < kStageRows; ++ty) v[ty] = ref[rowoff[ty] + rx];
#pragma unroll
            for (int ty = 0; ty < kStageRows; ++ty) t.stage[ty][x] = (uint8_t)v[ty];
            if (NP > 1 && !FLOOR) {
#pragma unroll
                for (int y = 0; y < kBaseRows; ++y)
                    t.vsum[y][x] = (int16_t)tap6(v[y], v[y + 1], v[y + 2], v[y + 3], v[y + 4],
                                                 v[y + 5]);
            }
        }
    }
    __syncthreads();

    if (NP > 1 && !FLOOR) {
        // ---- b, h and j over a run of 16 positions of one row (a warp a
        // row, 32 runs): position x is stage column x + 2; b the horizontal 6-tap of
        // stage columns x..x+5, h the vertical sum at x + 2, j the 6-tap of
        // vsum x..x+5, from 21 staged samples and 21 vertical sums
        for (int y = warp; y < kBaseRows; y += kPlaneWarps) {
            const int x0 = lane * kRun;
            int g[kRun + 5], v[kRun + 5];
            const uint4* gq = (const uint4*)&t.stage[y + 2][x0];
            const uint4* vq = (const uint4*)&t.vsum[y][x0];
            const uint4 ga = gq[0], gb = gq[1];
            const uint32_t gw[6] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y};
#pragma unroll
            for (int k = 0; k < kRun + 5; ++k) g[k] = (gw[k >> 2] >> (8 * (k & 3))) & 255;
            const uint4 va = vq[0], vb = vq[1], vc = vq[2];
            const uint32_t vw[11] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w,
                                     vc.x, vc.y, vc.z};
#pragma unroll
            for (int k = 0; k < kRun + 5; ++k)
                v[k] = (k & 1) ? (int)(int16_t)(vw[k >> 1] >> 16)
                               : (int)(int16_t)(vw[k >> 1] & 0xffffu);
            uint32_t wb[4] = {0, 0, 0, 0}, wh[4] = {0, 0, 0, 0}, wj[4] = {0, 0, 0, 0};
#pragma unroll
            for (int k = 0; k < kRun; ++k) {
                const int b = clip255((tap6(g[k], g[k + 1], g[k + 2], g[k + 3], g[k + 4],
                                            g[k + 5]) + 16) >> 5);
                const int h = clip255((v[k + 2] + 16) >> 5);
                const int j = clip255((tap6(v[k], v[k + 1], v[k + 2], v[k + 3], v[k + 4],
                                            v[k + 5]) + 512) >> 10);
                wb[k >> 2] |= (uint32_t)b << (8 * (k & 3));
                wh[k >> 2] |= (uint32_t)h << (8 * (k & 3));
                wj[k >> 2] |= (uint32_t)j << (8 * (k & 3));
            }
            *(uint4*)&t.base[0][y][x0] = make_uint4(wb[0], wb[1], wb[2], wb[3]);
            *(uint4*)&t.base[1][y][x0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
            *(uint4*)&t.base[2][y][x0] = make_uint4(wj[0], wj[1], wj[2], wj[3]);
        }
        __syncthreads();
    }

    // ---- the stores, a warp a (plane, row): lane u stores the row's u-th
    // 16-byte unit of the flat plane that lies wholly in the row and starts
    // in this block's columns; then the bytes before the row's first unit
    // (lanes 0-15, in the first block) and after its last (lanes 16-31, in
    // the block whose columns hold them)
    const long long plane = (long long)oh * ow;
    for (int q = warp; q < NP * kRows; q += kPlaneWarps) {
        const int p = q / kRows, y = q - p * kRows;
        if (r0 + y >= oh) continue;
        uint8_t* row = out + p * plane + (long long)(r0 + y) * ow;
        const int hb = min((int)((0u - (unsigned)(uintptr_t)row) & 15u), ow);
        const int nu = (ow - hb) >> 4, tail = hb + 16 * nu;
        const int u = (c0 > hb ? (c0 - hb + 15) >> 4 : 0) + lane;
        const int c = hb + 16 * u;
        if (lane < kUnits && u < nu && c < c0 + kOwnCols)
            *(uint4*)(row + c) = plane_unit<NP, FLOOR>(t, p, y, c - c0);
        const bool first = c0 == 0, last = tail >= c0 && tail < c0 + kOwnCols;
        if (first || last) {
            const int cb = lane < 16 ? (first && lane < hb ? lane : -1)
                                     : (last && tail + lane - 16 < ow ? tail + lane - 16 : -1);
            if (cb >= 0) row[cb] = plane_byte<NP, FLOOR>(t, p, y, cb - c0);
        }
    }
}

template <int NP>
__global__ void __launch_bounds__(kPlaneThreads)
subpel_planes_kernel(const uint8_t* __restrict__ ref, int H, int W, int margin,
                     uint8_t* __restrict__ out) {
    planes_body<NP, false>(ref, H, W, margin, out);
}

template <int NP>
__global__ void __launch_bounds__(kPlaneThreads)
subpel_floor_kernel(const uint8_t* __restrict__ ref, int H, int W, int margin,
                    uint8_t* __restrict__ out) {
    planes_body<NP, true>(ref, H, W, margin, out);
}

// ------------------------------------------------------------------ H4 ----

constexpr int kThreads = 256;
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
// drops.  sad[d] is candidate d's SAD; with QUAD, sad[4 d + q] is its
// quadrant q's (0 rows 0-7 x words 0-1, 1 rows 0-7 x words 2-3, 2 and 3 the
// same of rows 8-15)
template <int DY, bool QUAD = false>
__device__ __forceinline__ void tile_sads(const uint8_t* win, int pitch, int col,
                                          unsigned lead, unsigned step, int cnt,
                                          const uint32_t* cur, unsigned* sad) {
#pragma unroll
    for (int d = 0; d < (QUAD ? 4 * DY : DY); ++d) sad[d] = 0;
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
            if (r >= 0 && r < 16) {
                if constexpr (QUAD) {
                    unsigned* q = sad + 4 * d + 2 * (r >> 3);
                    q[0] += __vsadu4(cur[4 * r], b0) + __vsadu4(cur[4 * r + 1], b1);
                    q[1] += __vsadu4(cur[4 * r + 2], b2) + __vsadu4(cur[4 * r + 3], b3);
                } else {
                    sad[d] += __vsadu4(cur[4 * r], b0) + __vsadu4(cur[4 * r + 1], b1)
                              + __vsadu4(cur[4 * r + 2], b2) + __vsadu4(cur[4 * r + 3], b3);
                }
            }
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

// a block's current MBs (256 bytes each, raster) and every slot's window
// (rows -search..15+search around the MB row, columns -search..16 kb-1+search,
// as the stack's 16-byte units that hold them, from `row0`), copied
// asynchronously: the caller commits and waits
__device__ __forceinline__ void stage_search(const uint8_t* y, long long y_rs, const Search& s,
                                             int search, const int* slot_planes, int nslots,
                                             int mby, int mbx0, int kb, int pitch,
                                             long long row0, uint8_t* curs, uint8_t* win) {
    const int tid = threadIdx.x;
    for (int q = tid; q < 256 * kb; q += kThreads) {
        const int m = q >> 8, py = (q >> 4) & 15, px = q & 15;
        curs[q] = y[(long long)(16 * mby + py) * y_rs + 16 * (mbx0 + m) + px];
    }
    const int rows = 2 * search + 16, width = 16 * kb + 2 * search, units = pitch / 16;
    for (int q = tid; q < nslots * rows * units; q += kThreads) {
        const int c = q % units, rr = q / units, r = rr % rows, slot = rr / rows;
        stage_row(win + slot * rows * pitch + r * pitch,
                  s.stack + slot_planes[slot] * s.plane + row0 + (long long)r * s.wp, width, c);
    }
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
    const long long row0 = (long long)(s.margin + 16 * mby - search) * s.wp
                           + s.margin + 16 * mbx0 - search;
    const unsigned step = (unsigned)(s.wp & 15);
    stage_search(y, y_rs, s, search, slot_planes, nslots, mby, mbx0, kb, pitch, row0, curs,
                 win);
    if (tid < kb) {
        info[8 * tid] = -1;        // the first stage's least (key << 1 | ref)
        info[8 * tid + 1] = -1;    // fastsub's least key
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

// a MB's ints in shared memory: its nine least keys (hypothesis j: the
// quadrants 0..3 (tl, tr, bl, br), the 16x8 halves 4 (top) and 5 (bottom),
// the 8x16 halves 6 (left) and 7 (right), the whole MB 8), then each
// quadrant's winner (reference, dy, dx) at 9 + 3 q
constexpr int kPartsInfo = 24;

// the dynamic shared memory of a block of `mbs` MBs: the current MBs, their
// keys and winners, every slot's window (as H4's first stage)
__host__ __device__ constexpr int parts_shared(int mbs, int search, int nslots) {
    return (256 + 4 * kPartsInfo) * mbs + nslots * (2 * search + 16) * window_pitch(mbs, search);
}

__global__ void __launch_bounds__(kThreads, 2)
parts_search_kernel(const uint8_t* __restrict__ y, long long y_rs, Search s, int search,
                    const int* __restrict__ slot_planes, int nslots,
                    const int4* __restrict__ tiles, int ntiles,
                    const int16_t* __restrict__ inv, const int* __restrict__ cands, int n,
                    int mbs, int lam,
                    const uint8_t* __restrict__ cb0, const uint8_t* __restrict__ cr0,
                    const uint8_t* __restrict__ cb1, const uint8_t* __restrict__ cr1,
                    int16_t* __restrict__ pmode_out, int16_t* __restrict__ mv_out,
                    int16_t* __restrict__ ref_out, uint8_t* __restrict__ pred_y,
                    uint8_t* __restrict__ pred_cb, uint8_t* __restrict__ pred_cr) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* curs = smem;                                  // mbs x 256
    int* info = (int*)(smem + 256 * mbs);                  // mbs x kPartsInfo
    uint8_t* win = smem + (256 + 4 * kPartsInfo) * mbs;
    const int tid = threadIdx.x, lane = tid & 31;
    const int mby = blockIdx.y, mbx0 = blockIdx.x * mbs;
    const int mb_w = (s.wp - 2 * s.margin) / 16, mb_h = gridDim.y;
    const int kb = min(mbs, mb_w - mbx0);                  // this block's MBs
    const int W = 16 * mb_w;
    const int pitch = window_pitch(mbs, search);
    const int slot_bytes = (2 * search + 16) * pitch;

    // ---- the current MBs and every slot's window, staged once
    const long long row0 = (long long)(s.margin + 16 * mby - search) * s.wp
                           + s.margin + 16 * mbx0 - search;
    const unsigned step = (unsigned)(s.wp & 15);
    stage_search(y, y_rs, s, search, slot_planes, nslots, mby, mbx0, kb, pitch, row0, curs,
                 win);
    for (int q = tid; q < 9 * kb; q += kThreads) info[kPartsInfo * (q / 9) + q % 9] = kBadKey;
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // ---- the sweep: a thread a tile of up to 8 candidates, four quadrant
    // SADs each; the tile's nine least keys sad * 8192 + r * n + idx, then
    // the least over the lanes of the warp that hold the same MB, one
    // shared atomicMin each.  Every lane of a warp runs the same rounds.
    uint32_t cur[64];
    int have = -1;
    const int items = kb * ntiles;
    for (int q0 = tid - lane; q0 < items; q0 += kThreads) {
        const int q = q0 + lane;
        const int m = q < items ? q / ntiles : -1;
        unsigned k[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) k[j] = (unsigned)kBadKey;
        if (m >= 0) {
            const int4 t = __ldg(tiles + (q - m * ntiles));
            if (m != have) {
                load_cur(curs, m, cur);
                have = m;
            }
            int cnt, ax, fy, fx;
            tile_fields(t, cnt, ax, fy, fx);
            unsigned sad[4 * kTileRows];
            const unsigned lead = (unsigned)((uintptr_t)(s.stack + slot_planes[t.x] * s.plane
                                                         + row0 + (long long)(t.z + search) * s.wp)
                                             & 15);
            tile_sads<kTileRows, true>(win + t.x * slot_bytes + (t.z + search) * pitch, pitch,
                                16 * m + ax + search, lead, step, cnt, cur, sad);
            const unsigned base = (unsigned)(slot_planes[t.x] / s.nplanes * n);
#pragma unroll
            for (int d = 0; d < kTileRows; ++d) {
                if (d < cnt) {
                    const int qy = 4 * (t.z + d) + fy, qx = 4 * ax + fx;
                    const unsigned i =
                        base + inv[(qy + 4 * search) * (8 * search + 1) + qx + 4 * search];
                    const unsigned q0s = sad[4 * d], q1s = sad[4 * d + 1];
                    const unsigned q2s = sad[4 * d + 2], q3s = sad[4 * d + 3];
                    const unsigned sums[9] = {q0s, q1s, q2s, q3s, q0s + q1s, q2s + q3s,
                                              q0s + q2s, q1s + q3s, q0s + q1s + q2s + q3s};
#pragma unroll
                    for (int j = 0; j < 9; ++j) k[j] = min(k[j], sums[j] * kRadix + i);
                }
            }
        }
        const unsigned same = __match_any_sync(0xffffffffu, m);
#pragma unroll
        for (int j = 0; j < 9; ++j) k[j] = __reduce_min_sync(same, k[j]);
        if (m >= 0 && lane == __ffs(same) - 1) {
#pragma unroll
            for (int j = 0; j < 9; ++j) atomicMin((unsigned*)&info[kPartsInfo * m + j], k[j]);
        }
    }
    __syncthreads();

    // ---- the partition decision (strict < in the order 16x8, 8x16, 8x8:
    // ties keep the coarser mode), each quadrant's winner out
    if (tid < kb) {
        int* key = info + kPartsInfo * tid;
        const long long mb = (long long)mby * mb_w + mbx0 + tid;
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
            int* w = key + 9 + 3 * q;
            w[0] = r;
            w[1] = cands[2 * idx];
            w[2] = cands[2 * idx + 1];
            mv_out[8 * mb + 2 * q] = (int16_t)w[1];
            mv_out[8 * mb + 2 * q + 1] = (int16_t)w[2];
            if (ref_out != nullptr) ref_out[4 * mb + q] = (int16_t)r;
        }
    }
    __syncthreads();

    // ---- the prediction: each 8x8 luma quadrant from its winner's plane,
    // each 4x4 chroma quadrant with the bilinear at its winner's vector
    for (int q = tid; q < 256 * kb; q += kThreads) {
        const int m = q >> 8, py = (q >> 4) & 15, px = q & 15;
        const int* w = info + kPartsInfo * m + 9 + 3 * ((py >> 3) * 2 + (px >> 3));
        const int r = w[0], dy = w[1], dx = w[2];
        const int p = r * s.nplanes + plane_of(dy & 3, dx & 3, s.nplanes);
        pred_y[(long long)(16 * mby + py) * W + 16 * (mbx0 + m) + px] =
            s.stack[p * s.plane + (long long)(s.margin + 16 * mby + py + (dy >> 2)) * s.wp
                    + s.margin + 16 * (mbx0 + m) + px + (dx >> 2)];
    }
    for (int q = tid; q < 128 * kb; q += kThreads) {
        const int m = q >> 7, comp = (q >> 6) & 1, cy = (q >> 3) & 7, cx = q & 7;
        const int* w = info + kPartsInfo * m + 9 + 3 * ((cy >> 2) * 2 + (cx >> 2));
        const int r = w[0], dy = w[1], dx = w[2];
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

template <bool FLOOR>
int planes_launch(const uint8_t* ref, int H, int W, int margin, int nplanes, uint8_t* out,
                  void* stream) {
    if (nplanes != 1 && nplanes != 4 && nplanes != 16) return (int)cudaErrorInvalidValue;
    const int oh = H + 2 * margin, ow = W + 2 * margin;
    if (H > 0 && W > 0) {
        const dim3 grid((ow + kOwnCols - 1) / kOwnCols,
                        (oh + own_rows(nplanes) - 1) / own_rows(nplanes));
        auto kernel = nplanes == 1 ? (FLOOR ? subpel_floor_kernel<1> : subpel_planes_kernel<1>)
                    : nplanes == 4 ? (FLOOR ? subpel_floor_kernel<4> : subpel_planes_kernel<4>)
                    : (FLOOR ? subpel_floor_kernel<16> : subpel_planes_kernel<16>);
        kernel<<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(ref, H, W, margin, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int subpel_planes_launch(const uint8_t* ref, int H, int W, int margin,
                                    int nplanes, uint8_t* out, void* stream) {
    return planes_launch<false>(ref, H, W, margin, nplanes, out, stream);
}

extern "C" int subpel_floor_launch(const uint8_t* ref, int H, int W, int margin,
                                   int nplanes, uint8_t* out, void* stream) {
    return planes_launch<true>(ref, H, W, margin, nplanes, out, stream);
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
                                   const uint8_t* stack, int nplanes, int margin, int search,
                                   const int* slot_planes, int nslots, const int* tiles,
                                   int ntiles, const int16_t* inv, const int* cands,
                                   int n, int mbs, int shared, int lam,
                                   const uint8_t* cb0, const uint8_t* cr0,
                                   const uint8_t* cb1, const uint8_t* cr1,
                                   int16_t* pmode, int16_t* mv, int16_t* ref,
                                   uint8_t* pred_y, uint8_t* pred_cb, uint8_t* pred_cr,
                                   void* stream) {
    // the block layout is the wrapper's plan (ops/cuda/h264_inter.py
    // parts_plan_of): refuse a plan this kernel does not lay out the same way
    if (mbs < 1 || shared != parts_shared(mbs, search, nslots))
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
            (const void*)parts_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            shared);
        if (err != cudaSuccess) return (int)err;
    }
    parts_search_kernel<<<dim3((mb_w + mbs - 1) / mbs, mb_h), kThreads, shared,
                          (cudaStream_t)stream>>>(
        y, y_rs, s, search, slot_planes, nslots, (const int4*)tiles, ntiles, inv, cands, n,
        mbs, lam, cb0, cr0, cb1, cr1, pmode, mv, ref, pred_y, pred_cb, pred_cr);
    return (int)cudaGetLastError();
}
