// s8 fragment helpers for the int8 tensor-core kernel (sm_90a):
// mma.sync.m16n8k32 with s8 operands and s32 sums, and the quantize step
// that feeds it.  The fragments are loaded with mma_sm90.cuh's
// ldmatrix_x4 (a b16 ldmatrix row is 16 s8 values): for A, 16 rows of 32
// s8 with lane l addressing row (l % 8) + 8 ((l / 8) % 2) at byte 16 (l
// / 16); for B stored [n][k], lane l addresses n = (l % 8) + 8 (l / 16)
// at byte 16 ((l / 8) % 2), and registers 0-1 / 2-3 are the two n8 tiles.
// Included by int8_conv.cu (Q1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// c += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 sums
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // namespace
