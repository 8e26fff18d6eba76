// The bilinear blend of four tile-LUT values at one pixel, shared by K3
// (also K5 and K3v1) and K7 (natural.cu) and K6, K6r and K9 (lut.cu), so that
// they are equal bit for bit; and the interleaved LUT pack word that K3, K6
// and K7 stage.
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

// byte i of w as an f32, exactly: the byte becomes the low mantissa bits of
// 2^23, which is then subtracted (two full-rate instructions where I2F runs
// at a quarter of the rate)
static __device__ __forceinline__ float byte_to_float(uint32_t w, int i) {
    return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)),
                     8388608.0f);
}

// blend4 of one pack word: its bytes are (l11, l12, l21, l22) from the low
// byte up
static __device__ __forceinline__ uint32_t blend_word(uint32_t q, float fx,
                                                      float fy, float fy1) {
    return blend4(byte_to_float(q, 0), byte_to_float(q, 1),
                  byte_to_float(q, 2), byte_to_float(q, 3), fx, fy, fy1);
}

// Four 32-bit words of the four LUTs (l11, l12, l21, l22), each holding the
// entries of values v..v+3, transposed into the four pack words of those
// values: word k is (a_k, b_k, c_k, d_k), the uchar4 a pixel of value v + k
// reads with one 32-bit load.
static __device__ __forceinline__ uint4 interleave4(uint32_t a, uint32_t b,
                                                    uint32_t c, uint32_t d) {
    // [a0 b0 a1 b1], [c0 d0 c1 d1], [a2 b2 a3 b3], [c2 d2 c3 d3]
    const uint32_t ab_lo = __byte_perm(a, b, 0x5140);
    const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
    const uint32_t ab_hi = __byte_perm(a, b, 0x7362);
    const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
    return make_uint4(__byte_perm(ab_lo, cd_lo, 0x5410),
                      __byte_perm(ab_lo, cd_lo, 0x7632),
                      __byte_perm(ab_hi, cd_hi, 0x5410),
                      __byte_perm(ab_hi, cd_hi, 0x7632));
}
