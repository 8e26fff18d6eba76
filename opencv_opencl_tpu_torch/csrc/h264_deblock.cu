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
// derived here from the MB metadata: 4 on an MB edge with an intra side, 3
// inside one, 2 where either 4x4 block has coded levels, 1 where the
// references differ or a motion vector component differs by 4 quarter
// samples or more, else 0 (the vectors and references one a MB, or with the
// partition modes one an 8x8 block, :59 bs_grids's g = 2, so that the
// edges inside a partitioned MB get their motion-driven bS); the picture
// border is never filtered, and with
// slice_local neither are the horizontal MB edges (one slice per MB row,
// disable_deblocking_filter_idc=2).  The filter itself is spec 8.7.2.3 /
// 8.7.2.4 with alpha, beta and tC0 of the picture QP (luma) and of its
// chroma QP from the table (chroma).  `(q0 - p0) << 2` is written as a
// product: `<<` of a negative int is undefined in C++17.
//
// The order: MB (i, j) needs MB (i, j - 1) filtered (the same row), MB
// (i - 1, j) and the vertical edges of MB (i - 1, j + 1), whose writes
// reach the top-left halo this MB's top edges read.  Design: a wavefront
// in one launch, one warp per MB row walking its columns, and a progress
// counter a row in device memory; row i filters MB j once row i - 1 has
// finished MB j + 1 (the JAX schedule's lag of two MBs a row).  The launch
// is cooperative, so that every row's block is resident and no block waits
// on one that was never scheduled.  A MB's 20 x 20 luma and two 10 x 10
// chroma patches go to shared memory (loaded around L1, which is not
// coherent between SMs), its edges run one after another with a lane per
// line across the edge (16 luma, 16 chroma), and the patch goes back.  A
// wait that lasts seconds traps, so that a fault fails the launch rather
// than hanging the card.
//
// Bound: bytes.  At 4K it reads and writes the three planes (12.4 MB each
// way) and reads the metadata (0.6 MB): about 25 MB, 0.0074 ms at 3.35
// TB/s.  What really bounds this simple kernel is the wavefront of 508
// dependent steps.  More than one MB a step per row and a faster wavefront
// are for a later change.
//
// The launcher is extern "C", launches on the stream it is given, does not
// synchronise, allocates nothing, and returns the launch's error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
    int al, bl, tl[3], ac, bc, tc[3];
};

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

// filter one line across an edge: v[0..7] = p3 p2 p1 p0 q0 q1 q2 q3
// (luma) or v[0..3] = p1 p0 q0 q1 (chroma), `step` apart, in place
__device__ void filter_line(int* v, int step, int bs, bool chroma, int alpha,
                            int beta, const int* tc0v) {
    if (bs <= 0) return;
    if (chroma) {
        const int p1 = v[0], p0 = v[step], q0 = v[2 * step], q1 = v[3 * step];
        if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta)) return;
        if (bs == 4) {
            v[step] = (2 * p1 + p0 + q1 + 2) >> 2;
            v[2 * step] = (2 * q1 + q0 + p1 + 2) >> 2;
        } else {
            const int tc = tc0v[clip3(1, 3, bs) - 1] + 1;
            const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
            v[step] = clip3(0, 255, p0 + delta);
            v[2 * step] = clip3(0, 255, q0 - delta);
        }
        return;
    }
    const int p3 = v[0], p2 = v[step], p1 = v[2 * step], p0 = v[3 * step];
    const int q0 = v[4 * step], q1 = v[5 * step], q2 = v[6 * step], q3 = v[7 * step];
    if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta)) return;
    const bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
    if (bs == 4) {
        const bool small = abs(p0 - q0) < ((alpha >> 2) + 2);
        if (ap && small) {
            v[3 * step] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
            v[2 * step] = (p2 + p1 + p0 + q0 + 2) >> 2;
            v[step] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        } else {
            v[3 * step] = (2 * p1 + p0 + q1 + 2) >> 2;
        }
        if (aq && small) {
            v[4 * step] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
            v[5 * step] = (q2 + q1 + q0 + p0 + 2) >> 2;
            v[6 * step] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
        } else {
            v[4 * step] = (2 * q1 + q0 + p1 + 2) >> 2;
        }
        return;
    }
    const int tc0 = tc0v[clip3(1, 3, bs) - 1];
    const int tc = tc0 + ap + aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    v[3 * step] = clip3(0, 255, p0 + delta);
    v[4 * step] = clip3(0, 255, q0 - delta);
    const int avg = (p0 + q0 + 1) >> 1;
    if (ap) v[2 * step] = p1 + clip3(-tc0, tc0, (p2 + avg - p1 * 2) >> 1);
    if (aq) v[5 * step] = q1 + clip3(-tc0, tc0, (q2 + avg - q1 * 2) >> 1);
}

__global__ void __launch_bounds__(32)
deblock_kernel(uint8_t* y, uint8_t* cb, uint8_t* cr, int mb_h, int mb_w,
               const uint8_t* __restrict__ intra, const uint8_t* __restrict__ nnz4,
               const int16_t* __restrict__ mv, const int16_t* __restrict__ ref,
               int quad, Params prm, int slice_local, int* progress) {
    // the MB's patches: luma rows/cols -4..15 around its origin, chroma -2..7
    __shared__ int ly[20][20], lc[2][10][10];
    __shared__ int bsv[4][4], bsh[4][4];   // [segment][edge], [edge][segment]
    const int lane = threadIdx.x;
    const int i = blockIdx.x;
    const int W = mb_w * 16, H = mb_h * 16, cw = mb_w * 8, ch = mb_h * 8;
    volatile int* prog = progress;
    for (int j = 0; j < mb_w; ++j) {
        // ---- wait until row i - 1 has finished MB j + 1
        if (i > 0 && lane == 0) {
            const int need = min(j + 2, mb_w);
            const long long t0 = clock64();
            while (prog[i - 1] < need) {
                __nanosleep(64);
                if (clock64() - t0 > 20000000000LL) __trap();
            }
        }
        __syncwarp();
        __threadfence();

        // ---- the patches, around L1
        for (int k = lane; k < 400; k += 32) {
            const int r = 16 * i - 4 + k / 20, c = 16 * j - 4 + k % 20;
            ly[k / 20][k % 20] = (r >= 0 && c >= 0 && r < H && c < W)
                ? (int)__ldcg(y + (long long)r * W + c) : 0;
        }
        for (int k = lane; k < 200; k += 32) {
            const int pl = k / 100, kk = k % 100;
            const int r = 8 * i - 2 + kk / 10, c = 8 * j - 2 + kk % 10;
            const uint8_t* src = pl ? cr : cb;
            lc[pl][kk / 10][kk % 10] = (r >= 0 && c >= 0 && r < ch && c < cw)
                ? (int)__ldcg(src + (long long)r * cw + c) : 0;
        }
        // ---- the boundary strengths: lanes 0..15 the vertical edges,
        // 16..31 the horizontal ones
        {
            const int q = lane & 15, e = q & 3, sg = q >> 2;
            if (lane < 16) {
                const int br = 4 * i + sg, bc = 4 * j + e;
                bsv[sg][e] = bc == 0 ? 0
                    : bs_of(br, bc - 1, br, bc, e == 0, mb_w, intra, nnz4, mv, ref, quad);
            } else {
                const int br = 4 * i + e, bc = 4 * j + sg;
                bsh[e][sg] = (br == 0 || (slice_local && e == 0)) ? 0
                    : bs_of(br - 1, bc, br, bc, e == 0, mb_w, intra, nnz4, mv, ref, quad);
            }
        }
        __syncwarp();

        // ---- the vertical edges, then the horizontal ones; lanes 0..15 a
        // luma line each, 16..31 a chroma line (edges 0 and 2 only)
        for (int e = 0; e < 4; ++e) {
            if (lane < 16) {
                filter_line(&ly[4 + lane][4 * e], 1, bsv[lane >> 2][e], false,
                            prm.al, prm.bl, prm.tl);
            } else if ((e & 1) == 0) {
                const int pl = (lane - 16) >> 3, r = (lane - 16) & 7;
                filter_line(&lc[pl][2 + r][2 * e], 1, bsv[r >> 1][e], true,
                            prm.ac, prm.bc, prm.tc);
            }
            __syncwarp();
        }
        for (int e = 0; e < 4; ++e) {
            if (lane < 16) {
                filter_line(&ly[4 * e][4 + lane], 20, bsh[e][lane >> 2], false,
                            prm.al, prm.bl, prm.tl);
            } else if ((e & 1) == 0) {
                const int pl = (lane - 16) >> 3, c = (lane - 16) & 7;
                filter_line(&lc[pl][2 * e][2 + c], 10, bsh[e][c >> 1], true,
                            prm.ac, prm.bc, prm.tc);
            }
            __syncwarp();
        }

        // ---- the patches back (the never-written first row and column
        // stay), then the progress
        for (int k = lane; k < 400; k += 32) {
            const int pr = k / 20, pc = k % 20;
            const int r = 16 * i - 4 + pr, c = 16 * j - 4 + pc;
            if (pr > 0 && pc > 0 && r >= 0 && c >= 0 && r < H && c < W)
                __stcg(y + (long long)r * W + c, (uint8_t)ly[pr][pc]);
        }
        for (int k = lane; k < 200; k += 32) {
            const int pl = k / 100, kk = k % 100, pr = kk / 10, pc = kk % 10;
            const int r = 8 * i - 2 + pr, c = 8 * j - 2 + pc;
            if (pr > 0 && pc > 0 && r >= 0 && c >= 0 && r < ch && c < cw)
                __stcg((pl ? cr : cb) + (long long)r * cw + c, (uint8_t)lc[pl][pr][pc]);
        }
        __threadfence();
        __syncwarp();
        if (lane == 0) atomicExch(progress + i, j + 1);
    }
}

}  // namespace

extern "C" int deblock_launch(uint8_t* y, uint8_t* cb, uint8_t* cr, int mb_h, int mb_w,
                              const uint8_t* intra, const uint8_t* nnz4,
                              const int16_t* mv, const int16_t* ref, int quad,
                              const int* params, int slice_local, int* progress,
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
    void* args[] = {&y, &cb, &cr, &mb_h, &mb_w, &intra, &nnz4, &mv, &ref, &quad, &prm,
                    &slice_local, &progress};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)deblock_kernel, dim3(mb_h), dim3(32), args, 0, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
