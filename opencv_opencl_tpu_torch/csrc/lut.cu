// The kernels of opencv_opencl_tpu/ops/pallas/lut_kernels.py on Hopper:
//
//   K4 apply_lut_kernel          out[f, r, c] = luts[f, y[f, r, c]]
//   K6 interp_cells_kernel       CLAHE's bilinear blend of four tile LUTs,
//                                one block per (frame, cell, row chunk),
//                                16-byte units of two rows a thread; on a
//                                band of rows at a global row it is K9, and
//                                on whole frames it is also K6r (the radix
//                                variant)
//
// K8 (tile_histograms_pallas, the tile histograms of an already extended
// frame) has no kernel here: lut.py launches natural.cu's tile_hist_kernel<4>.
//
// Their plain PyTorch versions are in opencv_opencl_tpu_torch/ops/cuda/lut.py.
// Every launcher is extern "C", launches on the stream it is given, does
// not synchronise, allocates nothing, and returns cudaGetLastError().
//
// ----------------------------------------------------------------- K4 ----
// Replaces opencv_opencl_tpu/ops/pallas/lut_kernels.py apply_lut_pallas /
// _apply_lut_kernel, which maps through a one-hot MXU dot because a gather
// lowers badly on a TPU.  On Hopper a LUT read from shared memory is the
// natural form, and the same kernel takes a batch with one LUT per frame.
// Its plain PyTorch version is apply_lut_ref in
// opencv_opencl_tpu_torch/ops/cuda/lut.py.
//
// Bound: the read and write of the frames, 2 bytes per pixel (66.4 MB for
// a 4K batch of 4, 19.8 us at 3.35 TB/s).  Design: one block per (band of
// rows, frame) stages its frame's 256-byte LUT in shared memory; each warp
// takes one row at a time and its lanes map 16-byte units (16 pixels, one
// 128-bit load and store each, 512 contiguous bytes per warp step), with
// single bytes for the unaligned head and the tail of the row, and for a
// whole row whose source and destination are not equally aligned.  Rows
// and frames are taken by stride, so the Y rows of an NV12 batch are mapped
// in place: each pixel is read by the thread that then writes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// four pixels packed in a 32-bit word, each through the LUT
__device__ __forceinline__ uint32_t map4(uint32_t w, const uint8_t* lut) {
    return (uint32_t)lut[w & 0xffu]
           | ((uint32_t)lut[(w >> 8) & 0xffu] << 8)
           | ((uint32_t)lut[(w >> 16) & 0xffu] << 16)
           | ((uint32_t)lut[w >> 24] << 24);
}

__global__ void __launch_bounds__(kThreads)
apply_lut_kernel(const uint8_t* y, long long y_frame_stride,
                 long long y_row_stride, const uint8_t* __restrict__ luts,
                 int height, int width, uint8_t* out,
                 long long out_frame_stride, long long out_row_stride,
                 int rows_per_block) {
    __shared__ uint8_t lut[kBins];
    const int frame = blockIdx.y;
    for (int i = threadIdx.x; i < kBins; i += blockDim.x)
        lut[i] = luts[(long long)frame * kBins + i];
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(r0 + rows_per_block, height);
    for (int r = r0 + warp; r < r1; r += kWarps) {
        const uint8_t* src = y + frame * y_frame_stride + r * y_row_stride;
        uint8_t* dst = out + frame * out_frame_stride + r * out_row_stride;
        // [0, head) bytes, then nvec 16-byte units, then bytes to the end
        int head = width;
        int nvec = 0;
        if (((reinterpret_cast<uintptr_t>(src)
              ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
            head = min((int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15),
                       width);
            nvec = (width - head) >> 4;
        }
        for (int c = lane; c < head; c += 32) dst[c] = lut[src[c]];
        const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
        uint4* vdst = reinterpret_cast<uint4*>(dst + head);
        for (int v = lane; v < nvec; v += 32) {
            uint4 q = vsrc[v];
            q.x = map4(q.x, lut);
            q.y = map4(q.y, lut);
            q.z = map4(q.z, lut);
            q.w = map4(q.w, lut);
            vdst[v] = q;
        }
        for (int c = head + (nvec << 4) + lane; c < width; c += 32)
            dst[c] = lut[src[c]];
    }
}

// ----------------------------------------------------------------- K6 ----
// Replaces lut_kernels.py clahe_interpolate_pallas / _interp_kernel
// (radix=False).  The TPU embeds the frame in a padded grid of uniform
// cells, the regions between tile centres where the same four tile LUTs
// apply, so that each block gets one constant (4, 256) bf16 LUT pack for a
// one-hot MXU dot.  Here the embedding copy is dropped: one block per
// (row chunk of a cell, cell column, frame) maps the chunk's pixels, clipped
// to the frame, straight from the frame.  Cell (cy, cx) covers the frame
// rows [cy*tile_h - pad_top, (cy+1)*tile_h - pad_top) and the columns
// likewise with pad_left; make_interp_spec only gives a spec where that
// reproduces the plan's per-pixel tile indices, so its four LUTs
// (cell_lut_idx, in l11, l12, l21, l22 order) are those K3 reads there.
// Bound: the read and write of the frames (2 bytes per pixel, 66.4 MB for
// a 4K batch of 4).  Design, K3's for Hopper on K6's grid:
// - Staging: the block interleaves its cell's four LUTs into 256 uchar4
//   words (1 KB; interleave4, as K3 builds its pack), so a pixel's four
//   entries are one 32-bit shared load.
// - Columns: each row's columns of the cell fall in three parts, from the
//   wrapper's table `col_parts` (InterpSpec.column_parts: c0, a, b, c1 per
//   cell column): head bytes [c0, a) up to the first 16-byte boundary,
//   whole 16-byte units [a, b), tail bytes [b, c1).  When the launch is
//   `vec` (both bases and all four strides multiples of 16; the wrapper
//   decides), a thread maps one unit in each of two neighbouring rows: both
//   loads issued before either store, 32 blends with xa read four at a time
//   as float4 from a unit-major copy of the plan's xa (InterpSpec.unit_xa),
//   two uint4 stores.  At 4K the cell columns start at 240 + 480k, so there
//   are no head or tail bytes; at 1080p at 120 + 240k, so each cell has 8 of
//   each.  The head and tail bytes, and every column of a launch that is not
//   `vec`, take the byte path, one pixel per thread and step.
// - Per pixel: one 32-bit shared load, its four bytes to f32 exactly (no
//   I2F), blend4 (blend.cuh), K3's blend bit for bit.  Per row: ya.
// Each pixel is read and then written by one thread, so `out` may alias `y`.
// On an NVIDIA H100 80GB HBM3 (700 W) a 4K batch of 4 takes 0.047 ms, 0.031
// without the blend (scripts/torch_kernel_turns.py on a copy of it).
//
// K9: the same kernel replaces clahe_interpolate_pallas_band, as the JAX
// package has one body (_interp_kernel) behind both.  `y` and `out` then hold
// a band of the frame whose first row is global row row0; the launch covers
// the cell rows from cy0 on that the band touches, each block clips its
// chunk to the band's rows [row0, row_end) as well, and `ya` and the cell row
// are taken at the global row.  The TPU version embeds the band in a
// cell-aligned copy with dynamic slices of zero-padded tables around the
// kernel; none of that is needed here.  K6 is row0 = 0, cy0 = 0, row_end =
// height.
//
// K6r: the same kernel, on whole frames, replaces
// clahe_interpolate_pallas(radix=True) / _interp_kernel_radix.  The TPU
// variant re-lays the cell's four LUTs as a (4*16, 16) pack so that a
// pixel's value v = 16*hi + lo selects its entries with two 16-wide
// one-hots around an MXU dot, where K6's body needs one 256-wide one-hot: an
// answer to an expensive gather.  On Hopper that answer is the interleaved
// pack in shared memory that this kernel already stages, one 32-bit load
// per pixel, so the radix variant takes it as it is (0.0464 ms at 4K b4 on
// an NVIDIA H100 80GB HBM3, 700 W, where its own kernel, one byte a thread
// and step, took 0.0911; scripts/torch_kernel_turns.py).
constexpr int kLutWords = kBins / 4;    // 32-bit words per LUT
static_assert(kThreads >= kLutWords, "one staging word of each LUT per thread");

// the four pixels of one input word w, each blended from its pack word
__device__ __forceinline__ uint32_t blend_pixels4(const uint32_t* pack,
                                                  uint32_t w, float4 fx,
                                                  float fy, float fy1) {
    return blend_word(pack[w & 0xffu], fx.x, fy, fy1)
           | blend_word(pack[(w >> 8) & 0xffu], fx.y, fy, fy1) << 8
           | blend_word(pack[(w >> 16) & 0xffu], fx.z, fy, fy1) << 16
           | blend_word(pack[w >> 24], fx.w, fy, fy1) << 24;
}

__global__ void __launch_bounds__(kThreads)
interp_cells_kernel(const uint8_t* y, long long y_frame_stride,
                    long long y_row_stride, const uint8_t* __restrict__ luts,
                    int num_tiles, const int* __restrict__ cell_lut_idx,
                    int cells_x, int tile_h, int pad_top, int rows_per_block,
                    int chunks, int row0, int row_end, int cy0,
                    const int4* __restrict__ col_parts,
                    const float* __restrict__ ya, const float* __restrict__ xa,
                    const float4* __restrict__ xa_units, int units,
                    uint8_t* out, long long out_frame_stride,
                    long long out_row_stride, int vec) {
    __shared__ __align__(16) uint4 pack4[kLutWords];
    const int cy = cy0 + blockIdx.x / chunks;
    const int chunk = blockIdx.x % chunks;
    const int cx = blockIdx.y;
    const int frame = blockIdx.z;

    // the chunk's rows, in frame coordinates, clipped to the band and the
    // frame (the border cells are half outside it); the cell's columns
    const int g0 = cy * tile_h + chunk * rows_per_block;
    const int r0 = max(g0 - pad_top, row0);
    const int r1 = min(min(g0 + rows_per_block, (cy + 1) * tile_h) - pad_top,
                       row_end);
    const int4 cols = __ldg(&col_parts[cx]);
    const int c0 = cols.x, c1 = cols.w;
    if (r0 >= r1 || c0 >= c1) return;  // the same for every thread

    if (threadIdx.x < kLutWords) {
        // word i (values 4i..4i+3) of each of the cell's four LUTs
        const int i = threadIdx.x;
        const int* four = cell_lut_idx + (cy * cells_x + cx) * 4;
        const uint32_t* frame_luts = reinterpret_cast<const uint32_t*>(
            luts + (long long)frame * num_tiles * kBins);
        auto word = [&](int k) {
            return __ldg(&frame_luts[__ldg(&four[k]) * kLutWords + i]);
        };
        pack4[i] = interleave4(word(0), word(1), word(2), word(3));
    }
    __syncthreads();
    const uint32_t* pack = reinterpret_cast<const uint32_t*>(pack4);

    const int rows = r1 - r0;
    const uint8_t* src = y + frame * y_frame_stride
                         + (long long)(r0 - row0) * y_row_stride;
    uint8_t* dst = out + frame * out_frame_stride
                   + (long long)(r0 - row0) * out_row_stride;
    // a launch that is not vec maps every column as a head byte
    const int a = vec ? cols.y : c1;
    const int b = vec ? cols.z : c1;
    const int nu = (b - a) >> 4;
    if (nu > 0) {
        // (p, u) is the thread's flattened position: unit u of the cell in
        // rows 2p and 2p + 1; one division here, a running counter after
        const int doubles = (rows + 1) >> 1;
        int p = (int)threadIdx.x / nu;
        int u = (int)threadIdx.x % nu;
        const int step_p = kThreads / nu;
        const int step_u = kThreads % nu;
        while (p < doubles) {
            const int r = 2 * p;
            const bool two = r + 1 < rows;
            const uint8_t* s = src + r * y_row_stride + a + 16 * u;
            const uint4 qa = *reinterpret_cast<const uint4*>(s);
            uint4 qb = make_uint4(0, 0, 0, 0);
            if (two) qb = *reinterpret_cast<const uint4*>(s + y_row_stride);
            const float fya = __ldg(&ya[r0 + r]);
            const float fyb = two ? __ldg(&ya[r0 + r + 1]) : 0.0f;
            const float fya1 = __fsub_rn(1.0f, fya);
            const float fyb1 = __fsub_rn(1.0f, fyb);
            // the unit's columns 4j..4j+3: input word j of each row, xa at
            // x4[j * units]
            const uint32_t in_a[4] = {qa.x, qa.y, qa.z, qa.w};
            const uint32_t in_b[4] = {qb.x, qb.y, qb.z, qb.w};
            const float4* x4 = xa_units + (a >> 4) + u;
            uint32_t res_a[4], res_b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float4 fx = __ldg(x4 + j * units);
                res_a[j] = blend_pixels4(pack, in_a[j], fx, fya, fya1);
                res_b[j] = blend_pixels4(pack, in_b[j], fx, fyb, fyb1);
            }
            const uint4 out_a = make_uint4(res_a[0], res_a[1], res_a[2], res_a[3]);
            const uint4 out_b = make_uint4(res_b[0], res_b[1], res_b[2], res_b[3]);
            uint8_t* d = dst + r * out_row_stride + a + 16 * u;
            *reinterpret_cast<uint4*>(d) = out_a;
            if (two) *reinterpret_cast<uint4*>(d + out_row_stride) = out_b;
            p += step_p;
            u += step_u;
            if (u >= nu) {
                u -= nu;
                ++p;
            }
        }
    }
    // the byte path: the head [c0, a) and the tail [b, c1) of every row,
    // (row, k) walked with a running counter
    const int head = a - c0;
    const int edge = head + (c1 - b);
    if (edge > 0) {
        int r = (int)threadIdx.x / edge;
        int k = (int)threadIdx.x % edge;
        const int step_r = kThreads / edge;
        const int step_k = kThreads % edge;
        while (r < rows) {
            const int col = k < head ? c0 + k : b + (k - head);
            const float fy = __ldg(&ya[r0 + r]);
            dst[r * out_row_stride + col] = (uint8_t)blend_word(
                pack[src[r * y_row_stride + col]], __ldg(&xa[col]), fy,
                __fsub_rn(1.0f, fy));
            r += step_r;
            k += step_k;
            if (k >= edge) {
                k -= edge;
                ++r;
            }
        }
    }
}

}  // namespace

extern "C" int apply_lut_launch(const uint8_t* y, long long y_frame_stride,
                                long long y_row_stride, const uint8_t* luts,
                                int frames, int height, int width,
                                uint8_t* out, long long out_frame_stride,
                                long long out_row_stride, int rows_per_block,
                                void* stream) {
    dim3 grid((height + rows_per_block - 1) / rows_per_block, frames);
    apply_lut_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, y_frame_stride, y_row_stride, luts, height, width, out,
        out_frame_stride, out_row_stride, rows_per_block);
    return (int)cudaGetLastError();
}

// y and out hold band_rows rows from global row row0 on (the whole frame:
// row0 = 0, band_rows = height); rows at or beyond height are not written.
// col_parts: (cells_x, 4) int32, each cell column's (c0, a, b, c1) with a and
// b multiples of 16; xa_units: (4, units, 4) f32, units = width / 16.  vec
// (the 16-byte path) is the wrapper's choice; a launch that claims it on a
// base or stride that 16 does not divide is refused with
// cudaErrorInvalidValue.
extern "C" int interp_cells_launch(const uint8_t* y, long long y_frame_stride,
                                   long long y_row_stride, const uint8_t* luts,
                                   int frames, int num_tiles,
                                   const int* cell_lut_idx, int cells_x,
                                   int height, int tile_h, int pad_top,
                                   int rows_per_block, int row0,
                                   int band_rows, const int* col_parts,
                                   const float* ya, const float* xa,
                                   const float* xa_units, int units,
                                   uint8_t* out, long long out_frame_stride,
                                   long long out_row_stride, int vec,
                                   void* stream) {
    if (vec && (reinterpret_cast<uintptr_t>(y) % 16
                || reinterpret_cast<uintptr_t>(out) % 16
                || y_frame_stride % 16 || y_row_stride % 16
                || out_frame_stride % 16 || out_row_stride % 16))
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(luts) % 4) return (int)cudaErrorInvalidValue;
    const int row_end = row0 + band_rows < height ? row0 + band_rows : height;
    if (row_end <= row0) return 0;
    const int chunks = (tile_h + rows_per_block - 1) / rows_per_block;
    const int cy0 = (row0 + pad_top) / tile_h;
    const int cy1 = (row_end - 1 + pad_top) / tile_h;
    dim3 grid((cy1 - cy0 + 1) * chunks, cells_x, frames);
    interp_cells_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, y_frame_stride, y_row_stride, luts, num_tiles, cell_lut_idx,
        cells_x, tile_h, pad_top, rows_per_block, chunks, row0, row_end, cy0,
        reinterpret_cast<const int4*>(col_parts), ya, xa,
        reinterpret_cast<const float4*>(xa_units), units, out,
        out_frame_stride, out_row_stride, vec);
    return (int)cudaGetLastError();
}
