// CLAHE on Hopper: the kernels of the NV12 CLAHE steps.
//
//   K1 tile_hist_kernel   per-tile 256-bin histograms of the reflect-101
//                         extended Y plane (optionally every rowstep-th row)
//   K2 build_luts_kernel  OpenCV clip + redistribution, int32 inclusive scan,
//                         LUT = clip(rint(cdf * lut_scale), 0, 255)
//   K3 interp_kernel      bilinear blend of the four neighbouring tile LUTs,
//                         in OpenCV's mul-then-add f32 order, on whole
//                         frames or on a band of rows that starts at a
//                         global row; the same kernel is K5 (the sharded
//                         step's band) and K3v1 (the TPU package's
//                         variant 1 of K3)
//   K7 interp_hist_kernel K3's blend with the previous frame's LUTs plus
//                         K1's histograms of the frame it reads, in one pass
//                         (the streaming step, tile-divisible geometry)
//   K10                   K1's tile_hist_kernel<batch_rows> on an already
//                         extended, tile-divisible frame, where every tile
//                         is interior: batch_rows 16-byte loads in flight
//                         (experiments.py tile_histograms_radix_batched)
//
// Each kernel computes exactly what its TPU kernel in
// opencv_opencl_tpu/ops/pallas/natural.py computes, and what the plain
// PyTorch versions in opencv_opencl_tpu_torch/ops/cuda/natural.py compute.
// None follows the TPU kernel's structure: the one-hot and radix-16 MXU
// dots, the bf16 LUT pack and the (8, 128) alignment padding answered TPU
// constraints and have no counterpart here.
//
// Every launcher is extern "C", launches on the stream it is given, does
// not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;

// cv::borderInterpolate(BORDER_REFLECT_101) for an index past the end:
// mirror without repeating the edge, periodic with period 2n-2 when the pad
// exceeds the dimension (core/golden.py reflect101_indices).
__device__ __forceinline__ int reflect101(int i, int n) {
    if (i < n) return i;
    if (n == 1) return 0;
    const int period = 2 * n - 2;
    const int j = i % period;
    return j < n ? j : period - j;
}

// ----------------------------------------------------------------- K1 ----
// Replaces natural.py tile_histograms_radix / _tile_hist_radix_kernel.
// Bound: the read of the Y plane (8.3 MB per 4K frame), then one
// shared-memory atomic per pixel.  Design: one block per (frame, tile, slice
// of the tile's rows), so a 4K batch of 4 (256 tiles) still fills the 132
// SMs; each warp counts into its own 256 int32 bins in shared memory (8 KB a
// block: the 8 warps of a block do not contend for one histogram), and at
// the end the block folds the 8 histograms and adds each non-zero bin to the
// zeroed global (N, T, 256) histogram with one global atomic.
//
// Two ways to read a tile, chosen per block:
// - the 16-byte path, for a tile whose rows and columns all lie inside the
//   frame (tile row ty < inner_rows, tile column tx < inner_cols: no
//   reflect-101 index math) when the launch is `vec` (the base, both strides
//   and tile_w are multiples of 16, decided by the wrapper).  The slice's
//   (row, 16-byte unit) pairs are walked as one flattened index with a
//   running counter (a 4K tile row is 30 units, so one warp per row would
//   leave lanes idle), and each thread issues R uint4 loads before it
//   counts any of them (the template argument: K1 launches 4);
// - the byte path, for border tiles and unaligned input: one byte per thread
//   and step, padded positions mapped to their source with reflect-101
//   index math, so the extended frame is never materialised.
//
// A launch covers the tile rows [ty0, ty0 + gridDim.x / (tiles_x * slices))
// of the plan and reads a slab of the frame whose first row is frame row
// slab_row0 (the sharded step: a rank holds only the rows its band reads);
// the whole-frame call is ty0 = 0, slab_row0 = 0.  The wrapper checks that
// every source row of the launch lies inside the slab.
//
// K10: the same kernel replaces experiments.py tile_histograms_radix_batched
// / _tile_hist_radixn_kernel (and _tile_hist_radix8_kernel), K1's contract
// on a frame that is already extended to whole tiles.  On the TPU
// batch_rows is the number of rows per MXU dot of radix-16 one-hots; here it
// is R, the 16-byte loads a thread keeps in flight before it counts them.
// The counts do not depend on it.  The launch (natural.batched_hist_args)
// takes the frame as its own extension: height and width are the tile
// multiples, so every tile is interior and reflect101 returns at once on the
// byte path, which a tile width or a view that 16 does not divide takes.  On
// an NVIDIA H100 80GB HBM3 (700 W) a 4K b4 call reads K1's time with 2 and 4
// loads (0.0215 ms structured, 0.0247 random) and 4-5% more with 8, at 61
// registers against 40: the shared atomics bound it, not the loads
// (scripts/torch_kernel_turns.py).
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void count_bytes(int* mine, uint32_t w) {
    atomicAdd(&mine[w & 0xffu], 1);
    atomicAdd(&mine[(w >> 8) & 0xffu], 1);
    atomicAdd(&mine[(w >> 16) & 0xffu], 1);
    atomicAdd(&mine[w >> 24], 1);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
tile_hist_kernel(const uint8_t* __restrict__ y, int height, int width,
                 long long frame_stride, long long row_stride,
                 int tiles_x, int tile_h, int tile_w, int rowstep,
                 int slices, int ty0, int slab_row0, int inner_rows,
                 int inner_cols, int vec, int* __restrict__ out) {
    __shared__ int bins[kWarps][kBins];
    int* flat = &bins[0][0];
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) flat[i] = 0;
    __syncthreads();

    const int num_tiles = gridDim.x / slices;
    const int tile = blockIdx.x / slices;
    const int slice = blockIdx.x % slices;
    const int frame = blockIdx.y;
    const int ty = ty0 + tile / tiles_x;
    const int tx = tile % tiles_x;
    int* mine = bins[threadIdx.x >> 5];

    // sampled rows of this tile: ty*tile_h + k*rowstep, k in [k0, k1)
    const int rows = tile_h / rowstep;
    const int k0 = (int)((long long)rows * slice / slices);
    const int k1 = (int)((long long)rows * (slice + 1) / slices);
    const uint8_t* base = y + frame * frame_stride;
    const int col0 = tx * tile_w;

    if (vec && ty < inner_rows && tx < inner_cols) {
        const uint8_t* tile0 = base
            + (long long)(ty * tile_h + k0 * rowstep - slab_row0) * row_stride
            + col0;
        const long long step = (long long)rowstep * row_stride;
        const int units = tile_w >> 4;
        const int nk = k1 - k0;
        // (k, u) is the thread's flattened (row, unit) position; one division
        // here, a running counter after
        int k = (int)threadIdx.x / units;
        int u = (int)threadIdx.x % units;
        const int step_k = kThreads / units;
        const int step_u = kThreads % units;
        while (k < nk) {
            uint4 q[R];
            int loaded = 0;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if (k < nk) {
                    q[j] = __ldg(reinterpret_cast<const uint4*>(tile0 + k * step) + u);
                    loaded = j + 1;
                }
                k += step_k;
                u += step_u;
                if (u >= units) {
                    u -= units;
                    ++k;
                }
            }
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if (j < loaded) {
                    count_bytes(mine, q[j].x);
                    count_bytes(mine, q[j].y);
                    count_bytes(mine, q[j].z);
                    count_bytes(mine, q[j].w);
                }
            }
        }
    } else {
        // walk the (row, column) pairs of the slice with a running counter:
        // no per-pixel division
        int k = k0 + (int)threadIdx.x / tile_w;
        int c = (int)threadIdx.x % tile_w;
        const int step_rows = kThreads / tile_w;
        const int step_cols = kThreads % tile_w;
        while (k < k1) {
            const int r = reflect101(ty * tile_h + k * rowstep, height) - slab_row0;
            const int x = reflect101(col0 + c, width);
            atomicAdd(&mine[base[r * row_stride + x]], 1);
            k += step_rows;
            c += step_cols;
            if (c >= tile_w) {
                c -= tile_w;
                ++k;
            }
        }
    }
    __syncthreads();

    int* dst = out + ((long long)frame * num_tiles + tile) * kBins;
    for (int b = threadIdx.x; b < kBins; b += kThreads) {
        int v = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += bins[w][b];
        if (v) atomicAdd(&dst[b], v * rowstep);
    }
}

// ----------------------------------------------------------------- K2 ----
// Replaces natural.py build_lut_pack_pallas / _lut_pack_kernel (without its
// bf16 interpolation pack: K3 reads the (T, 256) LUTs by direct index).
// Bound: launch latency; the work is 256 integers per tile (320 KB in and
// out at 4K b4, 0.1 us at the HBM rate).  Design: one warp per (frame, tile)
// row, kLutWarps warps a block, no shared memory and no barrier.  Lane l owns
// the 8 bins [8l, 8l + 8): two int4 loads, so the warp reads the row's 1 KB
// in one coalesced pass.  The excess is summed in registers and reduced with
// one __shfl_xor_sync butterfly, so every lane holds the total; each bin's
// share and bump follow from its index as in ops/clahe.py _clip_histograms.
// The CDF is a lane-local inclusive prefix over the 8 bins plus one warp
// inclusive scan of the lanes' totals, exact in any order (int32).  Each
// bin then takes one rounded f32 multiply and round half to even, and the
// lane stores its 8 LUT bytes as one uint2.  With `clips` set (auto-CLAHE,
// the counterpart of ops/auto_clahe.py _luts_with_traced_clip), the clip is
// per frame and lives on the device: row r belongs to frame r / tiles and
// takes clips[that frame] in place of the host `clip`.  On an NVIDIA H100
// 80GB HBM3 (700 W) a 4K b4 call takes 1.83 us of device time, an empty
// kernel with its grid 0.84, the block-per-row form it replaced 2.07
// (torch.profiler, scripts/torch_kernel_turns.py).
constexpr int kLutWarps = 4;
constexpr int kLutBins = kBins / 32;      // bins a lane owns

__device__ __forceinline__ int warp_inclusive_scan(int v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v += u;
    }
    return v;
}

__global__ void __launch_bounds__(kLutWarps * 32)
build_luts_kernel(const int* __restrict__ hists, int rows, int clip,
                  const int* __restrict__ clips, int tiles, float lut_scale,
                  uint8_t* __restrict__ luts) {
    // a warp's lanes share its row, so a whole warp leaves here or none
    const int row = blockIdx.x * kLutWarps + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int lane = threadIdx.x & 31;
    const int4* src = reinterpret_cast<const int4*>(hists + (long long)row * kBins)
                      + 2 * lane;
    const int4 q0 = __ldg(src);
    const int4 q1 = __ldg(src + 1);
    int h[kLutBins] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    if (clips != nullptr) clip = __ldg(&clips[row / tiles]);

    if (clip > 0) {
        // the excess is shared as excess // 256 to every bin, the residual
        // one count at a time with stride max(256 // residual, 1) from bin 0
        int excess = 0;
#pragma unroll
        for (int j = 0; j < kLutBins; ++j) excess += h[j] > clip ? h[j] - clip : 0;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            excess += __shfl_xor_sync(0xffffffffu, excess, s);
        const int redist = excess / kBins;
        const int residual = excess - kBins * redist;
        const int step = max(kBins / max(residual, 1), 1);
#pragma unroll
        for (int j = 0; j < kLutBins; ++j) {
            const int bin = kLutBins * lane + j;
            const int bump = (bin % step == 0 && bin / step < residual) ? 1 : 0;
            h[j] = min(h[j], clip) + redist + bump;
        }
    }

#pragma unroll
    for (int j = 1; j < kLutBins; ++j) h[j] += h[j - 1];
    const int before = warp_inclusive_scan(h[kLutBins - 1]) - h[kLutBins - 1];
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < kLutBins; ++j) {
        // int -> f32 is exact below 2^24; one rounded f32 multiply, then
        // round half to even like jnp.rint / cvRound
        const int v = __float2int_rn(__fmul_rn(__int2float_rn(before + h[j]),
                                               lut_scale));
        word[j >> 2] |= (uint32_t)min(max(v, 0), 255) << (8 * (j & 3));
    }
    reinterpret_cast<uint2*>(luts + (long long)row * kBins)[lane] =
        make_uint2(word[0], word[1]);
}

// Does nothing: launched like K2, it gives the card's floor for a launch
__global__ void launch_floor_kernel() {}

// ------------------------------------------------------- K3, K5, K3v1 ----
// Replaces natural.py clahe_interpolate_natural (variant 2) /
// _natural_interp_kernel_v2 (K3), and the one Pallas body
// _natural_interp_kernel behind clahe_interpolate_natural_band (K5, the
// sharded step's band) and clahe_interpolate_natural(variant=1) (K3v1): the
// three compute the same blend, and here they are one kernel with three
// entry points.  The input and output hold the rows [row0, row0 + rows) of
// the plan's frames (row0 = 0 for whole frames); the row tables (row pair,
// ya) and the ranges are indexed by global row, the frames at row - row0.
// Bound: the read and write of the Y plane (2
// bytes per pixel, 66 MB for a 4K batch of 4); after it, one shared-memory
// gather per pixel (its bank is the pixel's value mod 32, so lanes
// conflict).  A design for Hopper; nothing of the TPU kernel's one-hot dots
// carries over:
// - Grid: one block per (range of rows, frame).  The wrapper's table
//   `ranges` holds each block's [start, end) global rows, and every range
//   lies inside one row pair of the PackSpec (the rows between two tile
//   centres), so a block needs only that pair's LUTs.  A band's first range
//   starts at row0, which may lie inside a pair.
// - Staging: the block builds its row pair's interleaved pack in shared
//   memory: for column group g (the columns between two tile centres) and
//   value v, the uchar4 (l11, l12, l21, l22) at g*256 + v, (tiles_x + 1) KB
//   in all (9 KB at 8x8).  A thread reads one 32-bit word (four values) of
//   each of the four LUTs and transposes the 4x4 bytes with __byte_perm into
//   four pack words, stored as one uint4.  A pack larger than
//   kStaticSmemLimit is not staged: each pixel then reads its four LUT bytes
//   through __ldg.
// - 16-byte frame I/O when the launch is `vec` (both bases and all four
//   strides multiples of 16; the wrapper decides): a thread maps 16
//   consecutive pixels in each of two neighbouring rows, two uint4 loads in
//   flight, 32 blends, two uint4 stores.  The block's (two rows, unit)
//   positions are one flattened index walked with a running counter.  The
//   columns past a row's last whole unit (width % 16), and every column of a
//   launch that is not `vec`, take the byte path, one pixel per thread and
//   step.
// - Column tables: the two rows of a unit share their 16 group ids and xa,
//   read four at a time as int4 and float4 from unit-major copies of the
//   plan's tables (PackSpec.unit_tables), so the lanes of a warp, which map
//   consecutive units, read consecutive 16-byte pieces (from the plan's own
//   tables they would stride 64 bytes apart and touch four times the lines).
//   At 1080p a group boundary falls inside a unit, so the group is per pixel.
// - Per pixel: one 32-bit shared load of the pack word, its four bytes to
//   f32 exactly (no I2F), blend4 (blend.cuh).  Per row: ya.
// Each pixel is read and then written by the same thread and depends only on
// itself and the LUTs, so `out` may alias `y` (the in-place NV12 step).  On
// an NVIDIA H100 80GB HBM3 (700 W) a 4K b4 batch takes 0.049 ms and a 2x2
// mesh's band (two frames, rows [1080, 2160)) 0.018, where the pack kernel
// it replaced for K5 took 0.033 (scripts/torch_kernel_turns.py).

// The row pair's LUTs seen by one block: la and lb are the frame's LUTs of
// its two tile rows; pack is the staged interleaved pack, or null
struct PairLuts {
    const uint32_t* pack;
    const uint8_t* la;
    const uint8_t* lb;
    int tiles_x;

    __device__ __forceinline__ uint32_t word(int g, int v) const {
        if (pack != nullptr) return pack[g * kBins + v];
        const int ca = max(g - 1, 0) * kBins + v;
        const int cb = min(g, tiles_x - 1) * kBins + v;
        return (uint32_t)__ldg(la + ca) | (uint32_t)__ldg(la + cb) << 8
               | (uint32_t)__ldg(lb + ca) << 16 | (uint32_t)__ldg(lb + cb) << 24;
    }

    __device__ __forceinline__ uint32_t blend(int v, int g, float fx, float fy,
                                              float fy1) const {
        return blend_word(word(g, v), fx, fy, fy1);
    }
};

// Stage the interleaved pack of `groups` column groups from g_first on, of
// the row pair whose tile rows' LUTs are la and lb, into dst: for group
// g_first + j and value v, the uchar4 (l11, l12, l21, l22) at j*256 + v.  A
// thread reads one 32-bit word (four values) of each of the four LUTs and
// transposes them into four pack words, stored as one uint4.  The LUTs must
// be 4-byte aligned; the caller synchronises.
__device__ __forceinline__ void stage_pack(uint4* dst, const uint8_t* la,
                                           const uint8_t* lb, int tiles_x,
                                           int g_first, int groups) {
    const int words = groups * (kBins / 4);
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
        const int g = g_first + i / (kBins / 4);
        const int v = (i % (kBins / 4)) * 4;
        const int ca = max(g - 1, 0) * kBins + v;
        const int cb = min(g, tiles_x - 1) * kBins + v;
        dst[i] = interleave4(
            __ldg(reinterpret_cast<const uint32_t*>(la + ca)),
            __ldg(reinterpret_cast<const uint32_t*>(la + cb)),
            __ldg(reinterpret_cast<const uint32_t*>(lb + ca)),
            __ldg(reinterpret_cast<const uint32_t*>(lb + cb)));
    }
}

// 16 pixels from column 16*u on in two rows, a and b, which share the
// columns' tables: g4 and x4 point at unit u of the unit-major tables, whose
// four int4 / float4 of a unit lie `units` entries apart.  Luts is PairLuts
// (K3) or ColumnLuts (K7): anything with blend(v, g, fx, fy, fy1).
template <class Luts>
__device__ __forceinline__ void blend_units(const Luts& luts, uint4 a,
                                            uint4 b, const int4* __restrict__ g4,
                                            const float4* __restrict__ x4,
                                            int units, float fya, float fyb,
                                            uint4& out_a, uint4& out_b) {
    const uint32_t in_a[4] = {a.x, a.y, a.z, a.w};
    const uint32_t in_b[4] = {b.x, b.y, b.z, b.w};
    const float fya1 = __fsub_rn(1.0f, fya);
    const float fyb1 = __fsub_rn(1.0f, fyb);
    uint32_t res_a[4], res_b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int4 g = __ldg(g4 + j * units);
        const float4 fx = __ldg(x4 + j * units);
        const uint32_t wa = in_a[j];
        const uint32_t wb = in_b[j];
        res_a[j] = luts.blend(wa & 0xffu, g.x, fx.x, fya, fya1)
                   | luts.blend((wa >> 8) & 0xffu, g.y, fx.y, fya, fya1) << 8
                   | luts.blend((wa >> 16) & 0xffu, g.z, fx.z, fya, fya1) << 16
                   | luts.blend(wa >> 24, g.w, fx.w, fya, fya1) << 24;
        res_b[j] = luts.blend(wb & 0xffu, g.x, fx.x, fyb, fyb1)
                   | luts.blend((wb >> 8) & 0xffu, g.y, fx.y, fyb, fyb1) << 8
                   | luts.blend((wb >> 16) & 0xffu, g.z, fx.z, fyb, fyb1) << 16
                   | luts.blend(wb >> 24, g.w, fx.w, fyb, fyb1) << 24;
    }
    out_a = make_uint4(res_a[0], res_a[1], res_a[2], res_a[3]);
    out_b = make_uint4(res_b[0], res_b[1], res_b[2], res_b[3]);
}

__global__ void __launch_bounds__(kThreads)
interp_kernel(const uint8_t* y, long long y_frame_stride,
              long long y_row_stride, const uint8_t* __restrict__ luts,
              int width, int tiles_y, int tiles_x,
              const int2* __restrict__ ranges, const int* __restrict__ rp_of_r,
              const float* __restrict__ ya, const int* __restrict__ g_of_c,
              const float* __restrict__ xa, const int4* __restrict__ g_units,
              const float4* __restrict__ xa_units, uint8_t* out,
              long long out_frame_stride, long long out_row_stride, int vec,
              int staged, int row0) {
    extern __shared__ __align__(16) uint32_t pack[];
    const int frame = blockIdx.y;
    const int2 range = __ldg(&ranges[blockIdx.x]);
    const int rp = __ldg(&rp_of_r[range.x]);
    const uint8_t* lut = luts + (long long)frame * tiles_y * tiles_x * kBins;
    PairLuts pair{nullptr, lut + max(rp - 1, 0) * tiles_x * kBins,
                  lut + min(rp, tiles_y - 1) * tiles_x * kBins, tiles_x};
    if (staged) {
        stage_pack(reinterpret_cast<uint4*>(pack), pair.la, pair.lb, tiles_x, 0,
                   tiles_x + 1);
        __syncthreads();
        pair.pack = pack;
    }

    const int rows = range.y - range.x;
    const uint8_t* src = y + frame * y_frame_stride
                         + (long long)(range.x - row0) * y_row_stride;
    uint8_t* dst = out + frame * out_frame_stride
                   + (long long)(range.x - row0) * out_row_stride;
    const int units = vec ? width >> 4 : 0;
    if (units > 0) {
        // (p, u) is the thread's flattened position: unit u of rows 2p and
        // 2p + 1; one division here, a running counter after
        const int doubles = (rows + 1) >> 1;
        int p = (int)threadIdx.x / units;
        int u = (int)threadIdx.x % units;
        const int step_p = kThreads / units;
        const int step_u = kThreads % units;
        while (p < doubles) {
            const int r = 2 * p;
            const bool two = r + 1 < rows;
            const uint8_t* s = src + r * y_row_stride + 16 * u;
            const uint4 a = *reinterpret_cast<const uint4*>(s);
            uint4 b = make_uint4(0, 0, 0, 0);
            if (two) b = *reinterpret_cast<const uint4*>(s + y_row_stride);
            const float fya = __ldg(&ya[range.x + r]);
            const float fyb = two ? __ldg(&ya[range.x + r + 1]) : 0.0f;
            uint4 out_a, out_b;
            blend_units(pair, a, b, g_units + u, xa_units + u, units, fya, fyb,
                        out_a, out_b);
            uint8_t* d = dst + r * out_row_stride + 16 * u;
            *reinterpret_cast<uint4*>(d) = out_a;
            if (two) *reinterpret_cast<uint4*>(d + out_row_stride) = out_b;
            p += step_p;
            u += step_u;
            if (u >= units) {
                u -= units;
                ++p;
            }
        }
    }
    // the byte path: columns [16 * units, width) of every row
    const int c0 = units * 16;
    const int cols = width - c0;
    if (cols > 0) {
        int r = (int)threadIdx.x / cols;
        int c = (int)threadIdx.x % cols;
        const int step_r = kThreads / cols;
        const int step_c = kThreads % cols;
        while (r < rows) {
            const int col = c0 + c;
            const float fy = __ldg(&ya[range.x + r]);
            dst[r * out_row_stride + col] = (uint8_t)pair.blend(
                src[r * y_row_stride + col], __ldg(&g_of_c[col]),
                __ldg(&xa[col]), fy, __fsub_rn(1.0f, fy));
            r += step_r;
            c += step_c;
            if (c >= cols) {
                c -= cols;
                ++r;
            }
        }
    }
}

// ----------------------------------------------------------------- K7 ----
// Replaces experiments.py clahe_interp_and_hist_natural /
// _natural_interp_hist_kernel: the streaming step maps frame N with the
// LUTs built from frame N-1 and, in the same pass, counts frame N's tile
// histograms, so the frame is read once for both outputs where K3 then K1
// read it twice.  Bound: the read and write of the Y plane (2 bytes per
// pixel; 16.6 MB per 4K frame), then one shared atomic per pixel.  The step
// launches it on one frame at a time (frame i's LUTs come from frame i-1's
// histograms), so a frame has to fill the card on its own.  Design: K3's
// blend and K1's counting in one block:
// - Grid: one block per (range of rows, tile column, frame).  The wrapper's
//   table `ranges` cuts the rows at every row pair of the PackSpec and at
//   every tile row (PackSpec.row_ranges with tile_h), so a block's pixels
//   all count into one tile's histogram, and its columns, those of one tile
//   column tx, lie in column groups tx and tx + 1 only.
// - Staging: those two groups' interleaved pack of the row pair (2 KB, built
//   by stage_pack as K3 builds its whole pack) in place of the frame's LUTs.
// - 16-byte frame I/O when the launch is `vec` (both bases, all four strides
//   and tile_w multiples of 16, so a unit never straddles a tile column;
//   the wrapper decides): a thread takes 16 pixels of each of two rows,
//   issues both loads, counts the 32 input bytes from the registers, blends
//   them with K3's blend_units and the unit-major column tables
//   (PackSpec.unit_tables; at 1080p a group boundary falls inside a unit, so
//   the group is per pixel), and stores both units.  Every other launch
//   takes the byte path, one pixel per thread and step.
// - Counting: K1's per-warp bins (8 x 1 KB) from the input value in the
//   register, before the store, so `out` may alias `y`; at the end the block
//   folds the warps' bins and adds each non-zero bin to the zeroed (N, T,
//   256) output with one global atomic.
// Tile-divisible geometry only, the TPU kernel's contract: every row and
// column is real, so there is no reflect-101 padding to count.  On an
// NVIDIA H100 80GB HBM3 (700 W) a 4K frame takes 0.021 ms, 0.020 without the
// atomics and 0.012 without the blend: the blend bounds it now
// (scripts/torch_kernel_turns.py on copies of this kernel).

// The two staged column groups of one tile column: group g of the block
// lies at (g - g0) * 256 in the pack
struct ColumnLuts {
    const uint32_t* pack;
    int g0;

    __device__ __forceinline__ uint32_t blend(int v, int g, float fx, float fy,
                                              float fy1) const {
        return blend_word(pack[(g - g0) * kBins + v], fx, fy, fy1);
    }
};

__global__ void __launch_bounds__(kThreads)
interp_hist_kernel(const uint8_t* y, long long y_frame_stride,
                   long long y_row_stride, const uint8_t* __restrict__ luts,
                   int width, int tiles_y, int tiles_x, int tile_h, int tile_w,
                   const int2* __restrict__ ranges,
                   const int* __restrict__ rp_of_r,
                   const float* __restrict__ ya, const int* __restrict__ g_of_c,
                   const float* __restrict__ xa, const int4* __restrict__ g_units,
                   const float4* __restrict__ xa_units, uint8_t* out,
                   long long out_frame_stride, long long out_row_stride,
                   int vec, int* __restrict__ hists) {
    __shared__ int bins[kWarps][kBins];
    __shared__ __align__(16) uint4 pack[2 * kBins / 4];
    int* flat = &bins[0][0];
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) flat[i] = 0;

    const int frame = blockIdx.z;
    const int tx = blockIdx.y;
    const int2 range = __ldg(&ranges[blockIdx.x]);
    const int rp = __ldg(&rp_of_r[range.x]);
    const int num_tiles = tiles_y * tiles_x;
    const uint8_t* lut = luts + (long long)frame * num_tiles * kBins;
    stage_pack(pack, lut + max(rp - 1, 0) * tiles_x * kBins,
               lut + min(rp, tiles_y - 1) * tiles_x * kBins, tiles_x, tx, 2);
    __syncthreads();
    const ColumnLuts column{reinterpret_cast<const uint32_t*>(pack), tx};
    int* mine = bins[threadIdx.x >> 5];

    const int rows = range.y - range.x;
    const int c0 = tx * tile_w;
    const uint8_t* src = y + frame * y_frame_stride
                         + (long long)range.x * y_row_stride + c0;
    uint8_t* dst = out + frame * out_frame_stride
                   + (long long)range.x * out_row_stride + c0;
    if (vec) {
        // (p, u) is the thread's flattened position: unit u of the tile
        // column in rows 2p and 2p + 1; one division here, a running
        // counter after
        const int units = tile_w >> 4;
        const int u0 = c0 >> 4;
        const int doubles = (rows + 1) >> 1;
        int p = (int)threadIdx.x / units;
        int u = (int)threadIdx.x % units;
        const int step_p = kThreads / units;
        const int step_u = kThreads % units;
        while (p < doubles) {
            const int r = 2 * p;
            const bool two = r + 1 < rows;
            const uint8_t* s = src + r * y_row_stride + 16 * u;
            const uint4 a = *reinterpret_cast<const uint4*>(s);
            uint4 b = make_uint4(0, 0, 0, 0);
            if (two) b = *reinterpret_cast<const uint4*>(s + y_row_stride);
            count_bytes(mine, a.x);
            count_bytes(mine, a.y);
            count_bytes(mine, a.z);
            count_bytes(mine, a.w);
            if (two) {
                count_bytes(mine, b.x);
                count_bytes(mine, b.y);
                count_bytes(mine, b.z);
                count_bytes(mine, b.w);
            }
            const float fya = __ldg(&ya[range.x + r]);
            const float fyb = two ? __ldg(&ya[range.x + r + 1]) : 0.0f;
            uint4 out_a, out_b;
            blend_units(column, a, b, g_units + u0 + u, xa_units + u0 + u,
                        width >> 4, fya, fyb, out_a, out_b);
            uint8_t* d = dst + r * out_row_stride + 16 * u;
            *reinterpret_cast<uint4*>(d) = out_a;
            if (two) *reinterpret_cast<uint4*>(d + out_row_stride) = out_b;
            p += step_p;
            u += step_u;
            if (u >= units) {
                u -= units;
                ++p;
            }
        }
    } else {
        int r = (int)threadIdx.x / tile_w;
        int c = (int)threadIdx.x % tile_w;
        const int step_r = kThreads / tile_w;
        const int step_c = kThreads % tile_w;
        while (r < rows) {
            const int v = src[r * y_row_stride + c];
            atomicAdd(&mine[v], 1);
            const float fy = __ldg(&ya[range.x + r]);
            dst[r * out_row_stride + c] = (uint8_t)column.blend(
                v, __ldg(&g_of_c[c0 + c]), __ldg(&xa[c0 + c]), fy,
                __fsub_rn(1.0f, fy));
            r += step_r;
            c += step_c;
            if (c >= tile_w) {
                c -= tile_w;
                ++r;
            }
        }
    }
    __syncthreads();

    int* dst_hist = hists + ((long long)frame * num_tiles
                             + (range.x / tile_h) * tiles_x + tx) * kBins;
    for (int b = threadIdx.x; b < kBins; b += kThreads) {
        int v = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += bins[w][b];
        if (v) atomicAdd(&dst_hist[b], v);
    }
}

}  // namespace

// Shared memory a block may use without opting in to more.
constexpr int kStaticSmemLimit = 48 * 1024;

// tile_rows tile rows from ty0 on; y is the slab that starts at frame row
// slab_row0 (see the kernel); loads is the kernel's R, 2, 4 or 8 (K1 takes
// 4, K10 its batch_rows).  vec (the 16-byte path) is the wrapper's choice; a
// launch that claims it on a base, stride or tile width that 16 does not
// divide, or asks for other loads, is refused with cudaErrorInvalidValue.
extern "C" int tile_hist_launch(const uint8_t* y, int frames, int height,
                                int width, long long frame_stride,
                                long long row_stride, int tile_rows,
                                int tiles_x, int tile_h, int tile_w,
                                int rowstep, int slices, int ty0,
                                int slab_row0, int inner_rows, int inner_cols,
                                int vec, int loads, int* out, void* stream) {
    if (vec && (reinterpret_cast<uintptr_t>(y) % 16 || frame_stride % 16
                || row_stride % 16 || tile_w % 16))
        return (int)cudaErrorInvalidValue;
    decltype(&tile_hist_kernel<4>) kernel;
    switch (loads) {
    case 2: kernel = tile_hist_kernel<2>; break;
    case 4: kernel = tile_hist_kernel<4>; break;
    case 8: kernel = tile_hist_kernel<8>; break;
    default: return (int)cudaErrorInvalidValue;
    }
    dim3 grid(tile_rows * tiles_x * slices, frames);
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, height, width, frame_stride, row_stride, tiles_x, tile_h, tile_w,
        rowstep, slices, ty0, slab_row0, inner_rows, inner_cols, vec, out);
    return (int)cudaGetLastError();
}

// clips: nullptr for one host clip for every row, else one int32 clip per
// frame of `tiles` rows (rows / tiles of them; the wrapper checks it).  The
// histograms must be 16-byte aligned and the LUTs 8-byte aligned (a lane
// reads its bins as two int4 and stores its LUT bytes as one uint2); a
// launch on others is refused with cudaErrorInvalidValue.
extern "C" int build_luts_launch(const int* hists, int rows, int clip,
                                 const int* clips, int tiles,
                                 float lut_scale, uint8_t* luts,
                                 void* stream) {
    if (reinterpret_cast<uintptr_t>(hists) % 16
        || reinterpret_cast<uintptr_t>(luts) % 8)
        return (int)cudaErrorInvalidValue;
    const int blocks = (rows + kLutWarps - 1) / kLutWarps;
    build_luts_kernel<<<blocks, kLutWarps * 32, 0, (cudaStream_t)stream>>>(
        hists, rows, clip, clips, tiles, lut_scale, luts);
    return (int)cudaGetLastError();
}

// K2's grid for `rows` LUT rows, of empty blocks: the floor of a launch
extern "C" int launch_floor_launch(int rows, void* stream) {
    const int blocks = (rows + kLutWarps - 1) / kLutWarps;
    launch_floor_kernel<<<blocks, kLutWarps * 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// ranges: blocks (start, end) global rows, each inside one row pair of
// rp_of_r and inside [row0, row0 + the rows of y and out); the pack of
// (tiles_x + 1) KB is staged when it fits in the shared memory a block gets
// without opting in to more.  vec (the 16-byte path) is
// the wrapper's choice; a launch that claims it on a base or stride that 16
// does not divide is refused with cudaErrorInvalidValue.
extern "C" int interp_launch(const uint8_t* y, long long y_frame_stride,
                             long long y_row_stride, const uint8_t* luts,
                             int frames, int width, int tiles_y, int tiles_x,
                             const int* ranges, int blocks,
                             const int* rp_of_r, const float* ya,
                             const int* g_of_c, const float* xa,
                             const int* g_units, const float* xa_units,
                             uint8_t* out,
                             long long out_frame_stride,
                             long long out_row_stride, int vec, int row0,
                             void* stream) {
    if (vec && (reinterpret_cast<uintptr_t>(y) % 16
                || reinterpret_cast<uintptr_t>(out) % 16
                || y_frame_stride % 16 || y_row_stride % 16
                || out_frame_stride % 16 || out_row_stride % 16))
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(luts) % 4) return (int)cudaErrorInvalidValue;
    const int pack_bytes = (tiles_x + 1) * kBins * 4;
    const int staged = pack_bytes <= kStaticSmemLimit ? 1 : 0;
    dim3 grid(blocks, frames);
    interp_kernel<<<grid, kThreads, staged ? pack_bytes : 0,
                    (cudaStream_t)stream>>>(
        y, y_frame_stride, y_row_stride, luts, width, tiles_y, tiles_x,
        reinterpret_cast<const int2*>(ranges), rp_of_r, ya, g_of_c, xa,
        reinterpret_cast<const int4*>(g_units),
        reinterpret_cast<const float4*>(xa_units), out, out_frame_stride,
        out_row_stride, vec, staged, row0);
    return (int)cudaGetLastError();
}

// ranges: blocks (start, end) rows, each inside one row pair of rp_of_r
// and one tile row; the grid is ranges x tiles_x x frames.  vec (the
// 16-byte path) is the wrapper's choice; a launch that claims it on a base,
// stride or tile width that 16 does not divide is refused with
// cudaErrorInvalidValue.
extern "C" int interp_hist_launch(const uint8_t* y, long long y_frame_stride,
                                  long long y_row_stride, const uint8_t* luts,
                                  int frames, int width, int tiles_y,
                                  int tiles_x, int tile_h, int tile_w,
                                  const int* ranges, int blocks,
                                  const int* rp_of_r, const float* ya,
                                  const int* g_of_c, const float* xa,
                                  const int* g_units, const float* xa_units,
                                  uint8_t* out, long long out_frame_stride,
                                  long long out_row_stride, int vec,
                                  int* hists, void* stream) {
    if (vec && (reinterpret_cast<uintptr_t>(y) % 16
                || reinterpret_cast<uintptr_t>(out) % 16
                || y_frame_stride % 16 || y_row_stride % 16
                || out_frame_stride % 16 || out_row_stride % 16
                || tile_w % 16))
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(luts) % 4) return (int)cudaErrorInvalidValue;
    dim3 grid(blocks, tiles_x, frames);
    interp_hist_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, y_frame_stride, y_row_stride, luts, width, tiles_y, tiles_x, tile_h,
        tile_w, reinterpret_cast<const int2*>(ranges), rp_of_r, ya, g_of_c, xa,
        reinterpret_cast<const int4*>(g_units),
        reinterpret_cast<const float4*>(xa_units), out, out_frame_stride,
        out_row_stride, vec, hists);
    return (int)cudaGetLastError();
}
