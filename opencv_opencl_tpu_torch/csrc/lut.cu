// Global equalizeHist on Hopper: K4, the 256-entry LUT map.
//
//   K4 apply_lut_kernel   out[f, r, c] = luts[f, y[f, r, c]]
//
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
//
// The launcher is extern "C", launches on the stream it is given, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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
