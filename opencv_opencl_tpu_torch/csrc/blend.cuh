// The bilinear blend of four tile-LUT values at one pixel, shared by K3 and
// K7 (natural.cu) and K6 (lut.cu), so that the three are equal bit for bit.
//
// OpenCV's mul-then-add order: r1 = l11*(1-fx) + l12*fx, r2 = l21*(1-fx) +
// l22*fx, res = r1*fy1 + r2*fy, every product rounded to f32 before its add.
// __fmul_rn/__fadd_rn keep it so: nvcc (--fmad=true is the default) would
// otherwise contract a*b+c into an FMA and flip exact ties by 1 LSB.  Then
// round half to even (jnp.rint, cvRound) and clamp to [0, 255].
#pragma once

#include <stdint.h>

static __device__ __forceinline__ uint8_t blend4(float l11, float l12,
                                                 float l21, float l22,
                                                 float fx, float fy,
                                                 float fy1) {
    const float fx1 = __fsub_rn(1.0f, fx);
    const float top = __fadd_rn(__fmul_rn(l11, fx1), __fmul_rn(l12, fx));
    const float bot = __fadd_rn(__fmul_rn(l21, fx1), __fmul_rn(l22, fx));
    const float res = __fadd_rn(__fmul_rn(top, fy1), __fmul_rn(bot, fy));
    return (uint8_t)min(max(__float2int_rn(res), 0), 255);
}
