// Device helpers of the H.264 level kernels (csrc/h264_levels.cu: H1
// intra_levels_kernel, H2 p_levels_kernel): the quantizer plan, the 4x4
// forward and inverse core transforms, the DC Hadamards and dequantizations,
// quantization, the CAVLC cost proxy, the Intra_4x4 predictors and a warp
// sum.  Every function is exact int32 arithmetic, bit for bit the JAX
// package's (opencv_opencl_tpu/ops/h264_levels.py) and the host oracle's;
// a left shift of a signed value is written as a product (`<<` of a
// negative int is undefined in C++17) and `>>` of a signed int is
// arithmetic, as in XLA.

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

// output k of the forward core transform CF on (x0, x1, x2, x3):
// rows (1,1,1,1), (2,1,-1,-2), (1,-1,-1,1), (1,-2,2,-1)
__device__ __forceinline__ int cf_pick(int x0, int x1, int x2, int x3, int k) {
    const int s0 = x0 + x3, s1 = x1 + x2, s2 = x1 - x2, s3 = x0 - x3;
    switch (k) {
        case 0: return s0 + s1;
        case 1: return 2 * s3 + s2;
        case 2: return s0 - s1;
        default: return s3 - 2 * s2;
    }
}

// coefficient (u, v) of the forward transform of the 4x4 block at `res`,
// rows `rs` apart (exact integer sums: the order does not matter)
__device__ __forceinline__ int fwd_coef(const int* res, int rs, int u, int v) {
    int c[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
        const int* r = res + y * rs;
        c[y] = cf_pick(r[0], r[1], r[2], r[3], v);
    }
    return cf_pick(c[0], c[1], c[2], c[3], u);
}

// output k of one pass of the spec 8.5.12.3 inverse core transform
__device__ __forceinline__ int inv_pick(int d0, int d1, int d2, int d3, int k) {
    const int e0 = d0 + d2, e1 = d0 - d2;
    const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
    switch (k) {
        case 0: return e0 + e3;
        case 1: return e1 + e2;
        case 2: return e1 - e2;
        default: return e0 - e3;
    }
}

// the rounded residual ((x + 32) >> 6) at (yy, xx) of the inverse transform
// of the dequantized 4x4 block `d` (raster): rows first, then columns
__device__ __forceinline__ int inv_pixel(const int* d, int yy, int xx) {
    int h[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
        h[u] = inv_pick(d[u * 4], d[u * 4 + 1], d[u * 4 + 2], d[u * 4 + 3], xx);
    return (inv_pick(h[0], h[1], h[2], h[3], yy) + 32) >> 6;
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

// entry (i, j) of H4 @ x @ H4 for the 4x4 raster x
__device__ __forceinline__ int hadamard4(const int* x, int i, int j) {
    int s = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s += h4(i, r) * h4(j, c) * x[r * 4 + c];
    return s;
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

// spec 8.3.1.2 Intra_4x4 prediction of mode m (not 2) at (yy, xx) from the
// top row t8 (p[0..7, -1], top-right substituted), the left column l4 and
// the corner c
__device__ int i4_pred(int m, int yy, int xx, const int* t8, const int* l4,
                       int c) {
#define T(i) ((i) < 0 ? c : t8[(i)])
#define L(i) ((i) < 0 ? c : l4[(i)])
    switch (m) {
        case 0: return T(xx);
        case 1: return L(yy);
        case 3:
            if (xx == 3 && yy == 3) return (T(6) + 3 * T(7) + 2) >> 2;
            return (T(xx + yy) + 2 * T(xx + yy + 1) + T(xx + yy + 2) + 2) >> 2;
        case 4:
            if (xx > yy)
                return (T(xx - yy - 2) + 2 * T(xx - yy - 1) + T(xx - yy) + 2) >> 2;
            if (xx < yy)
                return (L(yy - xx - 2) + 2 * L(yy - xx - 1) + L(yy - xx) + 2) >> 2;
            return (T(0) + 2 * c + L(0) + 2) >> 2;
        case 5: {
            const int z = 2 * xx - yy, i = xx - (yy >> 1);
            if (z >= 0 && (z & 1) == 0) return (T(i - 1) + T(i) + 1) >> 1;
            if (z >= 0) return (T(i - 2) + 2 * T(i - 1) + T(i) + 2) >> 2;
            if (z == -1) return (L(0) + 2 * c + T(0) + 2) >> 2;
            return (L(yy - 2 * xx - 1) + 2 * L(yy - 2 * xx - 2)
                    + L(yy - 2 * xx - 3) + 2) >> 2;
        }
        case 6: {
            const int z = 2 * yy - xx, i = yy - (xx >> 1);
            if (z >= 0 && (z & 1) == 0) return (L(i - 1) + L(i) + 1) >> 1;
            if (z >= 0) return (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2;
            if (z == -1) return (L(0) + 2 * c + T(0) + 2) >> 2;
            return (T(xx - 2 * yy - 1) + 2 * T(xx - 2 * yy - 2)
                    + T(xx - 2 * yy - 3) + 2) >> 2;
        }
        case 7: {
            const int i = xx + (yy >> 1);
            if ((yy & 1) == 0) return (T(i) + T(i + 1) + 1) >> 1;
            return (T(i) + 2 * T(i + 1) + T(i + 2) + 2) >> 2;
        }
        default: {  // 8
            const int z = xx + 2 * yy, i = yy + (xx >> 1);
            if (z < 5 && (z & 1) == 0) return (L(i) + L(i + 1) + 1) >> 1;
            if (z < 5) return (L(i) + 2 * L(i + 1) + L(i + 2) + 2) >> 2;
            if (z == 5) return (L(2) + 3 * L(3) + 2) >> 2;
            return L(3);
        }
    }
#undef T
#undef L
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

}  // namespace
