// Hopper (sm_90a) helpers for warp-specialised tensor-core kernels:
// mbarriers, the bulk copy engine (cp.async.bulk, completion counted on
// an mbarrier), TMA tensor boxes and their host-side tensor maps, named
// barriers, setmaxnreg, a compiler barrier, and wgmma's fence / commit /
// wait and its shared-memory matrix descriptor.  Included by int8_conv.cu (Q1).
#pragma once

#include <cuda.h>           // CUtensorMap
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // smem_addr

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// the barriers' initialisation, visible to the bulk copies (async proxy)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also has the phase wait for `bytes` of bulk copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spins until the phase of `bar` with this parity has completed (a new
// barrier counts the phase before its first, parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared
// by the bulk copy engine, completion counted on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of a 4-d tensor map at coordinates c0..c3 (innermost first;
// out of bounds reads 0) -> shared (128-byte aligned), completion
// counted on `bar`; `map` lies in kernel parameter space
// (__grid_constant__)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// host: a 4-d tensor map over `base` (16-byte aligned; dims innermost
// first, contiguous, each stride a multiple of 16 bytes), box `box`, no
// swizzle, zeros out of bounds; false where the CUDA driver refuses it
inline bool make_tensor_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                               int elem, const void* base,
                               const cuuint64_t dims[4],
                               const cuuint32_t box[4]) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || !fn)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t strides[3] = {dims[0] * elem, dims[0] * dims[1] * elem,
                                 dims[0] * dims[1] * dims[2] * elem};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// named barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the registers a thread of this warpgroup may hold from here on
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// orders the warpgroup's register and shared-memory writes before the
// wgmma that follow it
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of r across the
// wgmma that use it (it cannot see their asynchronous access)
__device__ __forceinline__ void wgmma_fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// a compiler-only barrier: no memory access or address computation
// moves across it (keeps an unrolled epilogue from hoisting the loads of
// every iteration into registers beside the sums)
__device__ __forceinline__ void compiler_barrier() {
  asm volatile("" ::: "memory");
}

// descriptor of a K-major operand in shared memory without swizzle:
// core matrices of 8 rows x 16 bytes (128 contiguous bytes), `lbo`
// bytes from one to the next along K, `sbo` bytes from one 8-row group
// to the next along M or N
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

}  // namespace
