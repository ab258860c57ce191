// Fragment helpers for the tensor-core kernels (sm_90a): cp.async,
// ldmatrix, stmatrix / movmatrix and mma.sync.m16n8k16 with bf16
// operands and f32 sums.  Included by winograd.cu (K6), conv3x3.cu (K5),
// convres_fwd.cu (K2), convres_bwd.cu (K3, through convres_sm90.cuh),
// attention_block.cu (K1a, K1b), probe_cmajor_conv.cu (P4),
// int8_conv.cu (Q1), probe_attention.cu (P1) and probe_convres.cu (P3),
// so that they use one copy of each.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// stores four 8 x 8 b16 matrices, the inverse of ldmatrix_x4: register j
// holds matrix j in its fragment layout, and lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4(void* p, const unsigned r[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// stores four 8 x 8 b16 matrices transposed: register j holds matrix j
// in ldmatrix_x4's fragment layout (thread t: row t / 4, columns
// 2 (t % 4) and 2 (t % 4) + 1), and lane l gives the address of row l % 8
// of its transpose in matrix l / 8; so ldmatrix_x4 then
// stmatrix_x4_trans transposes 8 x 8 blocks of shared memory
__device__ __forceinline__ void stmatrix_x4_trans(void* p, const unsigned r[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
      ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// the transpose of an 8 x 8 b16 matrix held in ldmatrix_x4's fragment
// layout (thread t: row t / 4, columns 2 (t % 4) and 2 (t % 4) + 1, the
// first in the low half): afterwards thread t holds the same places of
// the transpose
__device__ __forceinline__ unsigned movmatrix_trans(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(a));
  return d;
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
