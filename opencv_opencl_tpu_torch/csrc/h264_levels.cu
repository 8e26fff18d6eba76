// H1 intra_levels_kernel: the quantized CAVLC levels of one H.264 intra
// frame, one slice per macroblock (MB) row, on Hopper.  H2 p_levels_kernel,
// those of a P frame, is at the end of the file.
//
// Replaces opencv_opencl_tpu/ops/h264_levels.py:279 encode_levels, an XLA
// lax.scan over the MB columns (:631), vectorised over the MB rows: no
// Pallas kernel.  Its plain PyTorch version is encode_levels_plain in
// opencv_opencl_tpu_torch/ops/h264_levels.py, the wrapper encode_levels in
// opencv_opencl_tpu_torch/ops/cuda/h264_levels.py.
//
// What it computes, for each MB: the I_16x16 DC and HORIZONTAL candidates
// (4x4 forward core transforms, luma DC Hadamard, quantization), the cheaper
// by the CAVLC cost proxy; with `i4`, the Intra_4x4 trial (16 sub-blocks in
// z-order, up to 9 modes each) in its place where it is strictly cheaper;
// the chroma DC candidate and, with `chromah`, the chroma HORIZONTAL one;
// then the reconstruction, whose right column is the next MB's left edge.
// One slice per MB row means the top neighbour is never available: MB rows
// are independent, and along a row each MB needs only the reconstructed
// right edge (16 luma + 2x8 chroma pixels) of the MB to its left and, with
// `i4`, that MB's bx=3 modes.  All arithmetic is int32 and bit-exact with
// the JAX function (and the host oracle): the mode decisions are part of
// the stream, each with its strict `<`, and a left shift of a signed value
// is written as a product (`x * (1 << k)`; `<<` of a negative int is
// undefined in C++17); `>>` of a signed int is arithmetic, as in XLA.
//
// Bound: bytes.  At 4K (3840x2160, 135 x 240 MBs) it reads 12,441,600 bytes
// of NV12 and writes 818 bytes a MB of int16 levels and imode (26.5 MB), 34
// more with `i4` and `chromah`: about 39 MB, 0.012 ms at 3.35 TB/s.  What
// really bounds this simple kernel is the dependent chain of 240 steps
// along a row.  Design: one block of 256 threads per MB row (135 blocks at
// 4K, about one per SM) walks its columns with the carried edges, `lm4` and
// `lis4` in shared memory; threads work over pixels and coefficients, with
// __syncthreads between stages, costs summed with warp shuffles; the
// Intra_4x4 sub-blocks go one after another, each with its candidate modes
// evaluated in parallel (16 threads a mode) and the first minimum in mode
// order taken; the outputs are written straight into their
// (mb_h, mb_w, ...) layouts.  Several frames a launch, more MB rows a block
// and fewer barriers are for a later change.
//
// The launchers are extern "C", launch on the stream they are given, do not
// synchronise, allocate nothing, and return cudaGetLastError().  The device
// helpers both kernels use are in h264_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "h264_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 30;     // the cost of a mode that is not available

__global__ void __launch_bounds__(kThreads)
intra_levels_kernel(const uint8_t* __restrict__ y, long long y_rs,
                    const uint8_t* __restrict__ cb, long long cb_rs,
                    long long cb_cs, const uint8_t* __restrict__ cr,
                    long long cr_rs, long long cr_cs, int mb_w, Plan p, int i4,
                    int chromah, int16_t* __restrict__ zdc_out,
                    int16_t* __restrict__ acz_out, int16_t* __restrict__ czdc_out,
                    int16_t* __restrict__ cacz_out, int16_t* __restrict__ imode_out,
                    int16_t* __restrict__ i4m_out, int16_t* __restrict__ cmode_out,
                    uint8_t* __restrict__ ry, uint8_t* __restrict__ rcb,
                    uint8_t* __restrict__ rcr) {
    // the MB's sources: luma 16x16 raster, chroma cb then cr 8x8 rasters
    __shared__ int ys[256];
    __shared__ int cs[128];
    // the carry: the left MB's reconstructed right columns (cb 0..7, cr
    // 8..15), its bx=3 Intra_4x4 modes and whether it was Intra_4x4
    __shared__ int yedge[16], cedge[16], lm4[4], lis4;
    // residuals of the DC [0] and HORIZONTAL [1] predictions
    __shared__ int res[2][256], cres[2][128];
    // the blocks' DC coefficients and the quantized DC levels
    __shared__ int wdc[2][16], cwdc[2][2][4], zdcs[2][16], czdcs[2][2][4];
    __shared__ int red[kWarps][3];
    // the chosen I_16x16 and chroma levels, dequantized, and the recon
    __shared__ int acs[256], cacs[128], dq[256], cdq[128], yrec[256], crec[128];
    // Intra_4x4: the MB's recon so far, per mode the prediction, residual
    // and levels of the current sub-block, the costs, the chosen levels
    // (block raster, coefficient raster) and modes (z-order)
    __shared__ int mbrec[256], i4pred[9][16], i4res[9][16], i4q[9][16];
    __shared__ int i4cost[9], i4lev[256], zmode[16], cost_i4;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int mby = blockIdx.x;
    // luma roles: pixel (py, px) and block b = py, coefficient k = px
    const int py = tid >> 4, px = tid & 15;
    const int b = tid >> 4, k = tid & 15, u = k >> 2, v = k & 3;
    const int bby = b >> 2, bbx = b & 3;
    // chroma roles: candidate, comp, pixel (cpr, cpc); block and coefficient
    const int ccand = tid >> 7, ct = tid & 127, comp = ct >> 6;
    const int cpr = (ct & 63) >> 3, cpc = ct & 7;
    const int cblk = (ct >> 4) & 3, ck = ct & 15;
    const int qsh = 1 << (p.qp / 6), qsh_c = 1 << (p.qpc / 6);
    const long long row0 = (long long)mby * 16, crow0 = (long long)mby * 8;

    if (tid < 16) {
        yedge[tid] = 0;
        cedge[tid] = 0;
    }
    if (tid < 4) lm4[tid] = 2;
    if (tid == 0) lis4 = 0;

    for (int mbx = 0; mbx < mb_w; ++mbx) {
        const bool left_ok = mbx > 0;
        ys[tid] = y[(row0 + py) * y_rs + mbx * 16 + px];
        if (tid < 128) {
            const uint8_t* src = comp ? cr : cb;
            const long long rs = comp ? cr_rs : cb_rs, cs_ = comp ? cr_cs : cb_cs;
            cs[tid] = src[(crow0 + cpr) * rs + (long long)(mbx * 8 + cpc) * cs_];
        }
        __syncthreads();

        // ---- residuals of the candidates (the edges are the left MB's)
        int ysum = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) ysum += yedge[i];
        const int pd = left_ok ? (ysum + 8) >> 4 : 128;
        res[0][tid] = ys[tid] - pd;
        res[1][tid] = ys[tid] - yedge[py];
        const int* ce = cedge + comp * 8;
        const int half = cpr >> 2;
        const int cdc = left_ok
            ? (ce[4 * half] + ce[4 * half + 1] + ce[4 * half + 2] + ce[4 * half + 3] + 2) >> 2
            : 128;
        if (tid < 128) {
            cres[0][tid] = cs[tid] - cdc;
            cres[1][tid] = cs[tid] - ce[cpr];
        }
        __syncthreads();

        // ---- forward transforms and AC quantization
        const int cls = pos_class(u, v);
        const int t_d = fwd_coef(res[0] + bby * 64 + bbx * 4, 16, u, v);
        const int t_h = fwd_coef(res[1] + bby * 64 + bbx * 4, 16, u, v);
        const int q_d = k ? quant(t_d, p.mf_y[cls], p.f_y, p.qbits) : 0;
        const int q_h = k ? quant(t_h, p.mf_y[cls], p.f_y, p.qbits) : 0;
        if (k == 0) {
            wdc[0][b] = t_d;
            wdc[1][b] = t_h;
        }
        const bool cact = ccand == 0 || chromah;
        int cq = 0;
        if (cact) {
            const int* o = cres[ccand] + comp * 64 + (cblk >> 1) * 32 + (cblk & 1) * 4;
            const int cu = ck >> 2, cv = ck & 3;
            const int tc = fwd_coef(o, 8, cu, cv);
            cq = ck ? quant(tc, p.mf_c[pos_class(cu, cv)], p.f_c, p.qbits_c) : 0;
            if (ck == 0) cwdc[ccand][comp][cblk] = tc;
        }
        __syncthreads();

        // ---- the DC Hadamards and their quantization
        if (tid < 32) {
            const int cand = tid >> 4, idx = tid & 15;
            const int s = hadamard4(wdc[cand], idx >> 2, idx & 3) >> 1;
            zdcs[cand][idx] = quant(s, p.mf_y[0], 2 * p.f_y, p.qbits + 1);
        } else if (tid < 48) {
            const int q = tid - 32, cand = q >> 3, cc = (q >> 2) & 1, idx = q & 3;
            const int s = hadamard2(cwdc[cand][cc], idx >> 1, idx & 1);
            czdcs[cand][cc][idx] = quant(s, p.mf_c[0], 2 * p.f_c, p.qbits_c + 1);
        }
        __syncthreads();

        // ---- the costs of the candidates, summed over the block
        int c_d = level_cost(q_d), c_h = level_cost(q_h), c_c = level_cost(cq);
        if (tid < 16) {
            c_d += level_cost(zdcs[0][tid]);
            c_h += level_cost(zdcs[1][tid]);
        }
        if (ct < 8 && cact) c_c += level_cost(czdcs[ccand][ct >> 2][ct & 3]);
        c_d = warp_sum(c_d);
        c_h = warp_sum(c_h);
        c_c = warp_sum(c_c);
        if (lane == 0) {
            red[warp][0] = c_d;
            red[warp][1] = c_h;
            red[warp][2] = c_c;
        }
        __syncthreads();
        int cost_d = 0, cost_h = 0, cost_cdc = 0, cost_chh = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            cost_d += red[w][0];
            cost_h += red[w][1];
            if (w < kWarps / 2) cost_cdc += red[w][2];
            else cost_chh += red[w][2];
        }
        const bool use_h = left_ok && cost_h < cost_d;
        const bool use_ch = chromah && left_ok && cost_chh + 2 < cost_cdc;

        // ---- Intra_4x4: the sub-blocks in z-order, the modes of each in
        // parallel (mode m on threads 16m..16m+15)
        bool use_i4 = false;
        if (i4) {
            if (tid == 0) cost_i4 = 0;
            const int m = tid >> 4, pp = tid & 15, yy = pp >> 2, xx = pp & 3;
            for (int z = 0; z < 16; ++z) {
                const int zbx = scan_bx(z), zby = scan_by(z);
                const bool cand = tid < 144 && (zby > 0 || m == 1 || m == 2 || m == 8);
                if (cand) {
                    int l4[4], t8[8], c0 = 0;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        l4[i] = zbx > 0 ? mbrec[(zby * 4 + i) * 16 + zbx * 4 - 1]
                                        : yedge[zby * 4 + i];
                    if (zby > 0) {
                        const int* top = mbrec + (zby * 4 - 1) * 16 + zbx * 4;
                        // the above-right block is not decoded yet: p[3, -1]
                        const bool tr = !(zbx == 3 || (zbx == 1 && (zby == 1 || zby == 3)));
#pragma unroll
                        for (int i = 0; i < 4; ++i) t8[i] = top[i];
#pragma unroll
                        for (int i = 4; i < 8; ++i) t8[i] = tr ? top[i] : top[3];
                        c0 = zbx > 0 ? top[-1] : yedge[zby * 4 - 1];
                    } else {
#pragma unroll
                        for (int i = 0; i < 8; ++i) t8[i] = 0;
                    }
                    int pr;
                    if (m == 2) {
                        const int ls = l4[0] + l4[1] + l4[2] + l4[3];
                        const int ts = t8[0] + t8[1] + t8[2] + t8[3];
                        if (zby == 0)
                            pr = (zbx == 0 && !left_ok) ? 128 : (ls + 2) >> 2;
                        else
                            pr = (zbx == 0 && !left_ok) ? (ts + 2) >> 2 : (ts + ls + 4) >> 3;
                    } else {
                        pr = i4_pred(m, yy, xx, t8, l4, c0);
                    }
                    i4pred[m][pp] = pr;
                    i4res[m][pp] = ys[(zby * 4 + yy) * 16 + zbx * 4 + xx] - pr;
                }
                __syncthreads();
                int lc = 0;
                if (cand) {
                    const int q = quant(fwd_coef(i4res[m], 4, yy, xx),
                                        p.mf_y[pos_class(yy, xx)], p.f_y, p.qbits);
                    i4q[m][pp] = q;
                    lc = level_cost(q);
                }
                // the sum over each mode's 16 lanes
#pragma unroll
                for (int o = 8; o > 0; o >>= 1) lc += __shfl_xor_sync(0xffffffffu, lc, o);
                if (tid < 144 && pp == 0) {
                    // predicted mode (spec 8.3.1.1; the top MB row is
                    // another slice)
                    int predm = 2;
                    if (zby > 0) {
                        const int mB = zmode[z_of(zbx, zby - 1)];
                        if (zbx > 0) predm = min(zmode[z_of(zbx - 1, zby)], mB);
                        else if (left_ok) predm = min(lis4 ? lm4[zby] : 2, mB);
                    }
                    const bool valid = !(zbx == 0 && !left_ok
                                         && (m == 1 || m == 8 || m == 4 || m == 5 || m == 6));
                    i4cost[m] = (cand && valid) ? lc + (predm == m ? 1 : 4) : kBig;
                }
                __syncthreads();
                if (tid < 16) {
                    // the first minimum in mode order, then this pixel of
                    // the sub-block's reconstruction
                    int best = 0, bc = kBig;
                    for (int mm = 0; mm < 9; ++mm)
                        if (i4cost[mm] < bc) {
                            bc = i4cost[mm];
                            best = mm;
                        }
                    i4lev[(zby * 4 + zbx) * 16 + tid] = i4q[best][tid];
                    int d[16];
#pragma unroll
                    for (int kk = 0; kk < 16; ++kk)
                        d[kk] = i4q[best][kk] * p.v_y[pos_class(kk >> 2, kk & 3)] * qsh;
                    mbrec[(zby * 4 + yy) * 16 + zbx * 4 + xx] =
                        clamp255(inv_pixel(d, yy, xx) + i4pred[best][tid]);
                    if (tid == 0) {
                        zmode[z] = best;
                        cost_i4 += bc;
                    }
                }
                __syncthreads();
            }
            use_i4 = cost_i4 < (use_h ? cost_h : cost_d);
        }

        // ---- the chosen levels, dequantized; the DC dequantizations
        const int lq = use_h ? q_h : q_d;
        acs[tid] = lq;
        if (k) dq[tid] = lq * p.v_y[cls] * qsh;
        if (tid < 16) {
            dq[tid * 16] = luma_dc_dequant(hadamard4(zdcs[use_h], tid >> 2, tid & 3), p);
        } else if (tid < 24) {
            const int q = tid - 16, cc = q >> 2, idx = q & 3;
            cdq[cc * 64 + idx * 16] =
                chroma_dc_dequant(hadamard2(czdcs[use_ch][cc], idx >> 1, idx & 1), p);
        }
        if (ccand == (use_ch ? 1 : 0)) {
            cacs[ct] = cq;
            if (ck) cdq[ct] = cq * p.v_c[pos_class(ck >> 2, ck & 3)] * qsh_c;
        }
        __syncthreads();

        // ---- the reconstruction, a pixel a thread
        const int lpred = use_h ? yedge[py] : pd;
        const int lrec = clamp255(
            inv_pixel(dq + ((py >> 2) * 4 + (px >> 2)) * 16, py & 3, px & 3) + lpred);
        yrec[tid] = use_i4 ? mbrec[tid] : lrec;
        if (tid < 128) {
            const int cpred = use_ch ? ce[cpr] : cdc;
            crec[tid] = clamp255(
                inv_pixel(cdq + comp * 64 + ((cpr >> 2) * 2 + (cpc >> 2)) * 16,
                          cpr & 3, cpc & 3) + cpred);
        }
        __syncthreads();

        // ---- the outputs, in their (mb_h, mb_w, ...) layouts, and the carry
        const long long mb = (long long)mby * mb_w + mbx;
        if (tid < 16) zdc_out[mb * 16 + tid] = (int16_t)(use_i4 ? 0 : zdcs[use_h][tid]);
        acz_out[mb * 256 + tid] = (int16_t)(use_i4 ? i4lev[tid] : acs[tid]);
        if (tid < 8) czdc_out[mb * 8 + tid] = (int16_t)czdcs[use_ch][tid >> 2][tid & 3];
        if (tid < 128) cacz_out[mb * 128 + tid] = (int16_t)cacs[tid];
        if (tid == 0) imode_out[mb] = (int16_t)(use_i4 ? 0 : (use_h ? 1 : 2));
        if (i4 && tid < 16) i4m_out[mb * 16 + tid] = (int16_t)(use_i4 ? zmode[tid] : 2);
        if (chromah && tid == 0) cmode_out[mb] = (int16_t)(use_ch ? 1 : 0);
        if (ry != nullptr) {
            ry[(row0 + py) * ((long long)mb_w * 16) + mbx * 16 + px] = (uint8_t)yrec[tid];
            if (tid < 128)
                (comp ? rcr : rcb)[(crow0 + cpr) * ((long long)mb_w * 8) + mbx * 8 + cpc] =
                    (uint8_t)crec[tid];
        }
        if (tid < 16) {
            yedge[tid] = yrec[tid * 16 + 15];
        } else if (tid < 32) {
            const int q = tid - 16;
            cedge[q] = crec[(q >> 3) * 64 + (q & 7) * 8 + 7];
        }
        if (i4 && tid < 4) lm4[tid] = use_i4 ? zmode[z_of(3, tid)] : 2;
        if (i4 && tid == 0) lis4 = use_i4;
    }
}


// ---------------------------------------------------------------------------
// H2 p_levels_kernel: the levels, mode decisions and reconstruction of one P
// frame, one slice per MB row.
//
// Replaces opencv_opencl_tpu/ops/h264_levels.py:1487 encode_p_levels, an XLA
// lax.scan over the MB columns (:1785) after the motion search: no Pallas
// kernel.  Its plain PyTorch version is p_levels_plain in
// opencv_opencl_tpu_torch/ops/h264_levels.py (encode_p_levels_plain with the
// search), the wrapper encode_p_levels / p_levels_into in
// opencv_opencl_tpu_torch/ops/cuda/h264_levels.py.
//
// For each MB: the I_16x16 DC and HORIZONTAL candidates with DC chroma (the
// intra rounding offset, a third) and the inter candidate against the
// motion-compensated prediction (full 4x4 luma blocks, DC included, no
// Hadamard; the inter offset, a sixth, chroma too); the decision in the
// oracle's order: P_Skip where the inter levels are all zero and the MB's
// (mv, ref) is ((0, 0), 0) (with the partition modes: the MB is 16x16 and
// quadrant 0's (mv, ref) is ((0, 0), 0), :1543-1548), else intra where
// cost_i + INTRA_BIAS < cost_p
// (I_16x16 HORIZONTAL where left_ok and cost_h < cost_d), else inter; the
// rows of a GDR band are intra regardless of cost and never skip.  The
// chosen mode's levels and reconstruction are written; the reconstruction's
// right column is the next MB's left edge (the intra candidate predicts from
// the left MB's recon in the mode that MB chose).
//
// Bound: bytes.  At 4K it reads the source (12.4 MB of NV12) and the
// prediction (12.4 MB) and writes 818 bytes a MB of int16 levels and mode
// (26.5 MB) and the reconstruction (12.4 MB): about 64 MB, 0.019 ms at
// 3.35 TB/s.  What really bounds this simple kernel is the dependent chain
// of 240 columns along a row.  Design: H1's, one block of 256 threads per MB
// row walking its columns with the carried right columns (16 luma, 2 x 8
// chroma) in shared memory, threads over pixels and coefficients, costs
// summed with warp shuffles, the outputs written straight into their
// (mb_h, mb_w, ...) layouts.
constexpr int kIntraBias = 8;     // io.h264_inter._INTRA_BIAS

__global__ void __launch_bounds__(kThreads)
p_levels_kernel(const uint8_t* __restrict__ y, long long y_rs,
                const uint8_t* __restrict__ cb, long long cb_rs, long long cb_cs,
                const uint8_t* __restrict__ cr, long long cr_rs, long long cr_cs,
                const uint8_t* __restrict__ py_, const uint8_t* __restrict__ pcb,
                const uint8_t* __restrict__ pcr, int mb_w, Plan p,
                const int16_t* __restrict__ mv, const int16_t* __restrict__ ref,
                const int16_t* __restrict__ pmode, int band_lo, int band_hi,
                int16_t* __restrict__ zdc_out,
                int16_t* __restrict__ acz_out, int16_t* __restrict__ czdc_out,
                int16_t* __restrict__ cacz_out, int16_t* __restrict__ mode_out,
                uint8_t* __restrict__ ry, uint8_t* __restrict__ rcb,
                uint8_t* __restrict__ rcr) {
    // the MB's source and prediction: luma 16x16, chroma cb then cr 8x8
    __shared__ int ys[256], cs[128], ps[256], pcs[128];
    // the carry: the left MB's reconstructed right columns (cb 0..7, cr 8..15)
    __shared__ int yedge[16], cedge[16];
    // luma residuals of DC [0], HORIZONTAL [1] and inter [2]; chroma of
    // intra DC [0] and inter [1]
    __shared__ int res[3][256], cres[2][128];
    __shared__ int wdc[2][16], zdcs[2][16], cwdc[2][2][4], czdcs[2][2][4];
    __shared__ int red[kWarps][5];
    __shared__ int dq[256], cdq[128], yrec[256], crec[128];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int mby = blockIdx.x;
    const int py = tid >> 4, px = tid & 15;
    const int b = tid >> 4, k = tid & 15, u = k >> 2, v = k & 3;
    const int bby = b >> 2, bbx = b & 3;
    // chroma roles: candidate (0 intra, 1 inter), comp, pixel; block, coef
    const int ccand = tid >> 7, ct = tid & 127, comp = ct >> 6;
    const int cpr = (ct & 63) >> 3, cpc = ct & 7;
    const int cblk = (ct >> 4) & 3, ck = ct & 15;
    const int qsh = 1 << (p.qp / 6), qsh_c = 1 << (p.qpc / 6);
    const int f_y_p = (1 << p.qbits) / 6, f_c_p = (1 << p.qbits_c) / 6;
    const long long row0 = (long long)mby * 16, crow0 = (long long)mby * 8;
    const long long yw = (long long)mb_w * 16, cw = (long long)mb_w * 8;
    const bool inband = mby >= band_lo && mby < band_hi;

    if (tid < 16) {
        yedge[tid] = 0;
        cedge[tid] = 0;
    }

    for (int mbx = 0; mbx < mb_w; ++mbx) {
        const bool left_ok = mbx > 0;
        const long long mb = (long long)mby * mb_w + mbx;
        ys[tid] = y[(row0 + py) * y_rs + mbx * 16 + px];
        ps[tid] = py_[(row0 + py) * yw + mbx * 16 + px];
        if (tid < 128) {
            const uint8_t* src = comp ? cr : cb;
            const long long rs = comp ? cr_rs : cb_rs, cs_ = comp ? cr_cs : cb_cs;
            cs[tid] = src[(crow0 + cpr) * rs + (long long)(mbx * 8 + cpc) * cs_];
            pcs[tid] = (comp ? pcr : pcb)[(crow0 + cpr) * cw + mbx * 8 + cpc];
        }
        __syncthreads();

        // ---- residuals of the candidates (the edges are the left MB's)
        int ysum = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) ysum += yedge[i];
        const int pd = left_ok ? (ysum + 8) >> 4 : 128;
        res[0][tid] = ys[tid] - pd;
        res[1][tid] = ys[tid] - yedge[py];
        res[2][tid] = ys[tid] - ps[tid];
        const int* ce = cedge + comp * 8;
        const int half = cpr >> 2;
        const int cdc = left_ok
            ? (ce[4 * half] + ce[4 * half + 1] + ce[4 * half + 2] + ce[4 * half + 3] + 2) >> 2
            : 128;
        if (tid < 128) {
            cres[0][tid] = cs[tid] - cdc;
            cres[1][tid] = cs[tid] - pcs[tid];
        }
        __syncthreads();

        // ---- forward transforms and quantization
        const int cls = pos_class(u, v);
        const int t_d = fwd_coef(res[0] + bby * 64 + bbx * 4, 16, u, v);
        const int t_h = fwd_coef(res[1] + bby * 64 + bbx * 4, 16, u, v);
        const int t_p = fwd_coef(res[2] + bby * 64 + bbx * 4, 16, u, v);
        const int q_d = k ? quant(t_d, p.mf_y[cls], p.f_y, p.qbits) : 0;
        const int q_h = k ? quant(t_h, p.mf_y[cls], p.f_y, p.qbits) : 0;
        const int q_p = quant(t_p, p.mf_y[cls], f_y_p, p.qbits);
        if (k == 0) {
            wdc[0][b] = t_d;
            wdc[1][b] = t_h;
        }
        const int f_cand = ccand ? f_c_p : p.f_c;
        const int cu = ck >> 2, cv = ck & 3;
        const int tc = fwd_coef(cres[ccand] + comp * 64 + (cblk >> 1) * 32 + (cblk & 1) * 4,
                                8, cu, cv);
        const int cq = ck ? quant(tc, p.mf_c[pos_class(cu, cv)], f_cand, p.qbits_c) : 0;
        if (ck == 0) cwdc[ccand][comp][cblk] = tc;
        __syncthreads();

        // ---- the DC Hadamards and their quantization
        if (tid < 32) {
            const int cand = tid >> 4, idx = tid & 15;
            const int s = hadamard4(wdc[cand], idx >> 2, idx & 3) >> 1;
            zdcs[cand][idx] = quant(s, p.mf_y[0], 2 * p.f_y, p.qbits + 1);
        } else if (tid < 48) {
            const int q = tid - 32, cand = q >> 3, cc = (q >> 2) & 1, idx = q & 3;
            const int s = hadamard2(cwdc[cand][cc], idx >> 1, idx & 1);
            czdcs[cand][cc][idx] =
                quant(s, p.mf_c[0], 2 * (cand ? f_c_p : p.f_c), p.qbits_c + 1);
        }
        __syncthreads();

        // ---- the costs of the candidates, summed over the block
        int c_d = level_cost(q_d), c_h = level_cost(q_h), c_p = level_cost(q_p);
        int c_c = level_cost(cq);
        if (tid < 16) {
            c_d += level_cost(zdcs[0][tid]);
            c_h += level_cost(zdcs[1][tid]);
        }
        if (ct < 8) c_c += level_cost(czdcs[ccand][ct >> 2][ct & 3]);
        c_d = warp_sum(c_d);
        c_h = warp_sum(c_h);
        c_p = warp_sum(c_p);
        c_c = warp_sum(c_c);
        if (lane == 0) {
            red[warp][0] = c_d;
            red[warp][1] = c_h;
            red[warp][2] = c_p;
            red[warp][3] = c_c;
        }
        __syncthreads();
        int cost_d = 0, cost_h = 0, cost_lp = 0, cost_ci = 0, cost_cp = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            cost_d += red[w][0];
            cost_h += red[w][1];
            cost_lp += red[w][2];
            if (w < kWarps / 2) cost_ci += red[w][3];
            else cost_cp += red[w][3];
        }
        const bool use_h = left_ok && cost_h < cost_d;
        const int cost_i = (use_h ? cost_h : cost_d) + cost_ci + kIntraBias;
        const int cost_p = cost_lp + cost_cp;
        // with parts (pmode given) the fields hold four quadrants a MB and
        // P_Skip needs the whole-MB hypothesis: pmode 0, quadrant 0 at zero
        const int fq = pmode != nullptr ? 4 : 1;
        const bool mvz = mv == nullptr ||
            ((pmode == nullptr || pmode[mb] == 0) && mv[2 * fq * mb] == 0
             && mv[2 * fq * mb + 1] == 0 && (ref == nullptr || ref[fq * mb] == 0));
        const bool skip = cost_p == 0 && mvz && !inband;
        const bool intra = (!skip && cost_i < cost_p) || inband;
        const int mode = skip ? 0 : intra ? (use_h ? 3 : 2) : 1;
        const int csel = intra ? 0 : 1;   // the chosen chroma candidate

        // ---- the chosen levels, dequantized
        const int lq = intra ? (use_h ? q_h : q_d) : q_p;
        if (intra) {
            if (k) dq[tid] = lq * p.v_y[cls] * qsh;
            if (tid < 16)
                dq[tid * 16] = luma_dc_dequant(hadamard4(zdcs[use_h], tid >> 2, tid & 3), p);
        } else {
            dq[tid] = lq * p.v_y[cls] * qsh;
        }
        if (tid >= 16 && tid < 24) {
            const int q = tid - 16, cc = q >> 2, idx = q & 3;
            cdq[cc * 64 + idx * 16] =
                chroma_dc_dequant(hadamard2(czdcs[csel][cc], idx >> 1, idx & 1), p);
        }
        if (ccand == csel && ck) cdq[ct] = cq * p.v_c[pos_class(ck >> 2, ck & 3)] * qsh_c;
        __syncthreads();

        // ---- the reconstruction, a pixel a thread
        const int lpred = intra ? (use_h ? yedge[py] : pd) : ps[tid];
        yrec[tid] = skip ? ps[tid]
                         : clamp255(inv_pixel(dq + ((py >> 2) * 4 + (px >> 2)) * 16,
                                              py & 3, px & 3) + lpred);
        if (tid < 128) {
            const int cpred = intra ? cdc : pcs[tid];
            crec[tid] = skip ? pcs[tid]
                             : clamp255(inv_pixel(cdq + comp * 64
                                                  + ((cpr >> 2) * 2 + (cpc >> 2)) * 16,
                                                  cpr & 3, cpc & 3) + cpred);
        }
        // ---- the chosen levels, in their (mb_h, mb_w, ...) layouts
        if (tid < 16) zdc_out[mb * 16 + tid] = (int16_t)(intra ? zdcs[use_h][tid] : 0);
        acz_out[mb * 256 + tid] = (int16_t)(skip ? 0 : lq);
        if (tid < 8)
            czdc_out[mb * 8 + tid] = (int16_t)(skip ? 0 : czdcs[csel][tid >> 2][tid & 3]);
        if (ccand == csel) cacz_out[mb * 128 + ct] = (int16_t)(skip ? 0 : cq);
        if (tid == 0) mode_out[mb] = (int16_t)mode;
        __syncthreads();

        // ---- the reconstruction out, and the carry
        ry[(row0 + py) * yw + mbx * 16 + px] = (uint8_t)yrec[tid];
        if (tid < 128)
            (comp ? rcr : rcb)[(crow0 + cpr) * cw + mbx * 8 + cpc] = (uint8_t)crec[tid];
        if (tid < 16) {
            yedge[tid] = yrec[tid * 16 + 15];
        } else if (tid < 32) {
            const int q = tid - 16;
            cedge[q] = crec[(q >> 3) * 64 + (q & 7) * 8 + 7];
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int intra_levels_launch(const uint8_t* y, long long y_rs,
                                   const uint8_t* cb, long long cb_rs,
                                   long long cb_cs, const uint8_t* cr,
                                   long long cr_rs, long long cr_cs, int mb_h,
                                   int mb_w, const int* plan, int i4, int chromah,
                                   int16_t* out, uint8_t* ry, uint8_t* rcb,
                                   uint8_t* rcr, void* stream) {
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
    // the segments of ops/cuda/h264_levels.level_layout
    const long long n = (long long)mb_h * mb_w;
    int16_t* i4m = i4 ? out + 409 * n : nullptr;
    int16_t* cmode = chromah ? out + (i4 ? 425 : 409) * n : nullptr;
    if (mb_h > 0 && mb_w > 0)
        intra_levels_kernel<<<mb_h, kThreads, 0, (cudaStream_t)stream>>>(
            y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, mb_w, p, i4, chromah,
            out, out + 16 * n, out + 272 * n, out + 280 * n, out + 408 * n, i4m,
            cmode, ry, rcb, rcr);
    return (int)cudaGetLastError();
}

extern "C" int p_levels_launch(const uint8_t* y, long long y_rs, const uint8_t* cb,
                               long long cb_rs, long long cb_cs, const uint8_t* cr,
                               long long cr_rs, long long cr_cs, const uint8_t* py,
                               const uint8_t* pcb, const uint8_t* pcr, int mb_h,
                               int mb_w, const int* plan, int motion, int two_refs,
                               int parts, int band_lo, int band_hi, int16_t* out,
                               uint8_t* ry,
                               uint8_t* rcb, uint8_t* rcr, void* stream) {
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
    // the segments of ops/cuda/h264_levels.p_level_layout: mv (2 a MB, 8
    // with parts), ref (1, 4) and with parts pmode
    const long long n = (long long)mb_h * mb_w;
    const int16_t* mv = motion ? out + 409 * n : nullptr;
    const int16_t* ref = two_refs ? out + (parts ? 417 : 411) * n : nullptr;
    const int16_t* pmode = parts ? out + 421 * n : nullptr;
    if (mb_h > 0 && mb_w > 0)
        p_levels_kernel<<<mb_h, kThreads, 0, (cudaStream_t)stream>>>(
            y, y_rs, cb, cb_rs, cb_cs, cr, cr_rs, cr_cs, py, pcb, pcr, mb_w, p, mv,
            ref, pmode, band_lo, band_hi, out, out + 16 * n, out + 272 * n, out + 280 * n,
            out + 408 * n, ry, rcb, rcr);
    return (int)cudaGetLastError();
}
