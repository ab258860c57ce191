// s8 tensor-core helpers for the int8 kernel (sm_90a): the s8 wgmma of
// one n128 tile with A from registers and B from shared memory, and the
// quantize step that feeds it (one value, and 8 at once).
//
// wgmma_s8_n128: the warpgroup's 64 x 128 s32 sums d (wgmma's
// accumulator fragment: warp w, lane l holds rows 16 w + l / 4 (+8) and,
// for each n8 tile j, columns 8 j + 2 (l % 4) (+1) in d[4 j .. 4 j + 3])
// plus a (64 x 32 s8: each warp's 16 rows, mma.sync m16n8k32's A
// fragment, which mma_sm90.cuh's ldmatrix_x4 loads with lane l
// addressing row (l % 8) + 8 ((l / 8) % 2) at byte 16 (l / 16)) times b
// (128 x 32 s8, K-major core matrices in shared memory, descriptor
// desc).  scale_d 0 drops d's old values.  Asynchronous: bracket it
// with wgmma_sm90.cuh's wgmma_fence / wgmma_commit / wgmma_wait.
// Included by int8_conv.cu (Q1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void wgmma_s8_n128(int d[64], const unsigned a[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// s8 of v / xs: IEEE division, round half to even, clamped to +-127
// (cvt.rni saturates beyond the int range, so the clamp still holds)
__device__ __forceinline__ int quantize_s8(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return min(max(q, -127), 127);
}

// four s8 values in one word, the first in the low byte
__device__ __forceinline__ unsigned pack_s8x4(int a, int b, int c, int d) {
  return (unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
         ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24);
}

// quantize_s8 of 8 values at once, 8 bytes packed (the first in the low
// byte).  Each integer is first taken from p = v * inv, inv = 1 / xs
// correctly rounded: p is within 3 * 2^-24 of v / xs relatively (< 2.3e-5
// for |v / xs| < 128), and so is the IEEE quotient rn(v / xs), so both
// round (half to even, then clamp) to the same integer unless a .5 tie
// lies within 1e-4 of p.  If one does for any of the 8, all 8 come from
// quantize_s8's IEEE division.  p + M - M (M = 1.5 * 2^23) is p rounded
// to an integer for |p| < 2^22; far beyond, both clamp to +-127 (inf and
// NaN are never near a tie and convert as quantize_s8 converts them).
__device__ __forceinline__ uint2 quantize8_s8(const float v[8], float xs,
                                              float inv) {
  constexpr float M = 12582912.0f;
  int q[8];
  bool tie = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p = __fmul_rn(v[j], inv);
    const float f = __fsub_rn(p, __fsub_rn(__fadd_rn(p, M), M));
    tie |= fabsf(__fsub_rn(fabsf(f), 0.5f)) < 1e-4f;
    q[j] = min(max(__float2int_rn(p), -127), 127);
  }
  if (tie) {
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = quantize_s8(v[j], xs);
  }
  return make_uint2(pack_s8x4(q[0], q[1], q[2], q[3]),
                    pack_s8x4(q[4], q[5], q[6], q[7]));
}

}  // namespace
