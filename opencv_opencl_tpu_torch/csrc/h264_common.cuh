// Device helpers of the H.264 level kernels (csrc/h264_levels.cu: H1 and
// H2): the quantizer plan, the coefficient position class, the DC
// Hadamards and dequantizations, quantization, the CAVLC cost proxy and
// the z-scan of the luma blocks.  Every function is exact int32
// arithmetic, bit for bit the JAX package's
// (opencv_opencl_tpu/ops/h264_levels.py) and the host oracle's; a left
// shift of a signed value is written as a product (`<<` of a negative int
// is undefined in C++17) and `>>` of a signed int is arithmetic, as in XLA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClamp = 2063;      // the 12-bit CAVLC level escape

// the quantizer constants of one QP, computed on the host from the tables
// (ops/cuda/h264_levels.plan_words): mf and v by position class
struct Plan {
    int qp, qpc, qbits, qbits_c, f_y, f_c;
    int mf_y[3], mf_c[3], v_y[3], v_c[3];
};

// coefficient position class: 0 both even, 1 both odd, 2 mixed
__device__ __forceinline__ int pos_class(int u, int v) {
    return ((u | v) & 1) == 0 ? 0 : ((u & v) & 1) ? 1 : 2;
}

// sign(w) * ((|w| * mf + f) >> qbits), clamped to the escape range
__device__ __forceinline__ int quant(int w, int mf, int f, int qbits) {
    const int q = (abs(w) * mf + f) >> qbits;
    const int s = (w > 0) - (w < 0);
    return max(-kClamp, min(kClamp, s * q));
}

// the CAVLC bit-cost proxy of one level: 2|l| + (l != 0)
__device__ __forceinline__ int level_cost(int l) {
    const int a = abs(l);
    return 2 * a + (a != 0);
}

__device__ __forceinline__ int clamp255(int x) { return max(0, min(255, x)); }

// entry (i, r) of the Hadamard H4: rows (1,1,1,1), (1,1,-1,-1),
// (1,-1,-1,1), (1,-1,1,-1): -1 where the bits of r under row i's mask
// (0, 2, 3, 1) have odd parity; no branch, so lanes with different rows
// do not diverge
__device__ __forceinline__ int h4(int i, int r) {
    return 1 - 2 * (__popc(r & ((0x1320 >> (4 * i)) & 3)) & 1);
}

// entry (i, j) of H2 @ x @ H2 for the 2x2 raster x
__device__ __forceinline__ int hadamard2(const int* x, int i, int j) {
    return x[0] + (j ? -x[1] : x[1]) + (i ? -x[2] : x[2])
           + ((i ^ j) ? -x[3] : x[3]);
}

// spec 8.5.10, the luma DC dequantization
__device__ __forceinline__ int luma_dc_dequant(int c, const Plan& p) {
    const int ls = 16 * p.v_y[0];
    const int k = p.qp / 6;
    if (p.qp >= 36) return (c * ls) * (1 << (k - 6));
    return (c * ls + (1 << (5 - k))) >> (6 - k);
}

// spec 8.5.11.2, the chroma DC dequantization
__device__ __forceinline__ int chroma_dc_dequant(int c, const Plan& p) {
    return ((c * (16 * p.v_c[0])) * (1 << (p.qpc / 6))) >> 5;
}

// the z-scan of the 4x4 luma blocks of a MB: block z is (bx, by)
__device__ __forceinline__ int scan_bx(int z) { return (z & 1) | ((z >> 1) & 2); }
__device__ __forceinline__ int scan_by(int z) { return ((z >> 1) & 1) | ((z >> 2) & 2); }
__device__ __forceinline__ int z_of(int bx, int by) {
    return (bx & 1) | ((by & 1) << 1) | ((bx & 2) << 1) | ((by & 2) << 2);
}

}  // namespace
