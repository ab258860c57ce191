// Write-path sweep for Hopper (sm_90a): identity copies of x (B, N, C).
//
// Replaces the TPU kernels of scripts/probe_attention_writeback.py:
//   _copy_kernel (:38, pallas_call :60)    -> copy_kernel
//   _manual_kernel (:72, pallas_call :111) -> copy_async_kernel
//
// What it computes: y = x, byte for byte; y may be x (the probe's
// "alias" variant, input_output_aliases {0: 0}).  Block k of the grid
// copies the k-th run of tn tokens (tn * C elements, contiguous).
//
// What bounds it on an H100: bytes alone.  At the probe's default (B =
// 96, 128^2 tokens, C = 128, bf16) a copy reads 402.7 MB and writes as
// much: 0.240 ms at 3.35 TB/s.
//
// What this design does about it:
//   copy_kernel: every thread moves 16-byte words, four loads in flight
//   before their four stores, neighbouring threads on neighbouring
//   words.  The grid is (N / tn, B), or flat (B * N / tn): the same
//   blocks in another numbering, as a Hopper grid has no order.  The
//   TPU's dimension semantics ("parallel" / "arbitrary") have no
//   counterpart: blocks always run in parallel and in no order.
//   copy_async_kernel: one thread drives the copy engine (TMA).  It
//   loads STAGE bytes at a time into one of two shared-memory stages
//   with cp.async.bulk, completion counted on the stage's mbarrier, and
//   writes each stage out with an asynchronous bulk store
//   (cp.async.bulk ... bulk_group, commit_group).  Before a stage is
//   loaded again it waits (wait_group.read) until the store that last
//   read it has read it, so the next load overlaps the current store:
//   the counterpart of the probe's hand double-buffered output.  Sizes
//   and addresses are multiples of 16 bytes, as bulk copies need.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int STAGE = 32768;      // bytes of one stage of copy_async_kernel

// Block k copies words [k * tile_words, (k + 1) * tile_words).
__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint4* x, uint4* y, long long tile_words, int flat) {
  const long long k = flat ? (long long)blockIdx.x
                           : (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const uint4* src = x + k * tile_words;
  uint4* dst = y + k * tile_words;
  for (long long i = threadIdx.x; i < tile_words; i += UNROLL * THREADS) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * THREADS < tile_words) v[u] = src[i + u * THREADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * THREADS < tile_words) dst[i + u * THREADS] = v[u];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// bytes from global src into shared dst, completion on mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// bytes from shared src to global dst, as one bulk group
__device__ __forceinline__ void bulk_store(char* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Grid (N / tn, B) of one warp each; lane 0 copies the block's
// tile_bytes through two shared stages.
__global__ void __launch_bounds__(32)
copy_async_kernel(const char* x, char* y, long long tile_bytes) {
  extern __shared__ __align__(128) char buf[];   // 2 x STAGE
  __shared__ __align__(8) uint64_t bars[2];
  if (threadIdx.x != 0) return;
  const long long k = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const char* src = x + k * tile_bytes;
  char* dst = y + k * tile_bytes;
  const uint32_t bar[2] = {smem_addr(&bars[0]), smem_addr(&bars[1])};
  const uint32_t stage[2] = {smem_addr(buf), smem_addr(buf + STAGE)};
  for (int s = 0; s < 2; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar[s]) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const long long nchunks = (tile_bytes + STAGE - 1) / STAGE;
  auto size = [&](long long c) {
    return (uint32_t)min((long long)STAGE, tile_bytes - c * STAGE);
  };
  bulk_load(stage[0], src, size(0), bar[0]);
  for (long long c = 0; c < nchunks; ++c) {
    const int s = (int)(c & 1);
    if (c + 1 < nchunks) {
      // stage 1 - s was last read by the store of chunk c - 1
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bulk_load(stage[1 - s], src + (c + 1) * STAGE, size(c + 1), bar[1 - s]);
    }
    while (!mbar_try_wait(bar[s], (uint32_t)((c >> 1) & 1))) {
    }
    bulk_store(dst + c * STAGE, stage[s], size(c));
  }
  // every store written before the block (and its shared memory) ends
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

bool bad_tiles(int B, long long N, int C, int elem, int tn) {
  return B < 1 || N < 1 || C < 1 || tn < 1 || N % tn ||
         ((long long)tn * C * elem) % 16;
}

}  // namespace

extern "C" {

// y = x for x (B, N, C) of elem-byte elements, 16-byte aligned; y may
// be x.  Block tiles of tn tokens, tn * C * elem a multiple of 16;
// flat: a 1-D grid (B * N / tn) in place of (N / tn, B).
int probe_copy(const void* x, void* y, int B, long long N, int C, int elem, int tn,
               int flat, void* stream) {
  if (bad_tiles(B, N, C, elem, tn)) return (int)cudaErrorInvalidValue;
  const long long nt = N / tn, words = (long long)tn * C * elem / 16;
  const dim3 grid = flat ? dim3((unsigned)(nt * B)) : dim3((unsigned)nt, B);
  copy_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)y, words, flat);
  return (int)cudaGetLastError();
}

// y = x as probe_copy, y not x, through copy_async_kernel.
int probe_copy_async(const void* x, void* y, int B, long long N, int C, int elem,
                     int tn, void* stream) {
  if (bad_tiles(B, N, C, elem, tn) || x == y) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      copy_async_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * STAGE);
  if (err != cudaSuccess) return (int)err;
  copy_async_kernel<<<dim3((unsigned)(N / tn), B), 32, 2 * STAGE,
                      (cudaStream_t)stream>>>((const char*)x, (char*)y,
                                              (long long)tn * C * elem);
  return (int)cudaGetLastError();
}

}  // extern "C"
