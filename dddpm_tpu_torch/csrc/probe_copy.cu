// Write-path sweep for Hopper (sm_90a): identity copies of x (B, N, C).
//
// Replaces the TPU kernels of scripts/probe_attention_writeback.py:
//   _copy_kernel (:38, pallas_call :60)    -> copy_kernel
//   _manual_kernel (:72, pallas_call :111) -> copy_async_kernel
//
// What it computes: y = x, byte for byte; y may be x (the probe's
// "alias" variant, input_output_aliases {0: 0}), in tiles of tn tokens
// (tn * C elements, contiguous).
//
// What bounds it on an H100: bytes alone.  At the probe's default (B =
// 96, 128^2 tokens, C = 128, bf16) a copy reads 402.7 MB and writes as
// much: 0.240 ms at 3.35 TB/s.
//
// What this design does about it:
//   copy_kernel: the copy is cut into chunks of CHUNK 16-byte words
//   (32 KB, UNROLL = 8 a thread) that never straddle two tiles of tn
//   tokens (a tile's tail is a part-chunk).  The grid is sized to the
//   card, not to the tiles: whole waves of the blocks the SMs hold at
//   once (several a SM), as many waves as leave each block one chunk or
//   two, block k taking every gridDim-th chunk from chunk k on; so every
//   tile is split evenly over the blocks whatever tn is, and no SM
//   carries a tail alone.  Each thread keeps its 8 16-byte loads in
//   flight before its 8 stores, streamed (st.global.cs): nothing reads
//   the bytes again.  The 2-D grid (G / B, B) splits each sample's tiles
//   among its row of blocks; the flat grid (G) splits all the tiles: the
//   same chunks in another numbering, as a Hopper grid has no order.
//   The TPU's dimension semantics ("parallel" / "arbitrary") have no
//   counterpart: blocks always run in parallel and in no order.  (The
//   first design, block k copying tile k whole, left 1.45 waves of 2 MB
//   blocks on 132 SMs at the default, 16 KB in flight a block.  On an
//   H100 80GB HBM3, 700 W, one resident set of blocks each walking many
//   chunks was slower than these waves, and so was the loads' own
//   streaming hint, ld.global.nc.L1::no_allocate.)
//   copy_async_kernel: one thread a block drives the copy engine (TMA),
//   on a persistent grid (as many one-warp blocks as fit on the SMs)
//   that splits the bytes evenly: block k takes every gridDim.x-th chunk
//   from chunk k on, a chunk being STAGE bytes of one tile or the tile's
//   tail (tiles of tn tokens stay the unit the chunks are cut from), so
//   that the grid reads and writes one window of memory at a time
//   (split into one contiguous run a block it was slower on an H100
//   80GB HBM3, 700 W).  It loads a chunk at a time into a ring of
//   STAGES shared-memory stages with cp.async.bulk, completion on the
//   stage's mbarrier, and writes each stage out with an asynchronous
//   bulk store (cp.async.bulk ... bulk_group, commit_group): the
//   counterpart of the probe's hand-buffered output.  A stage is loaded
//   again once its store has read it (wait_group.read READING), so
//   READING stores and STAGES - READING loads stay in flight.  Both
//   carry an L2 evict-first hint: nothing reads the bytes again.  Sizes
//   and addresses are multiples of 16 bytes, as bulk copies need.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;
constexpr int CHUNK = UNROLL * THREADS;   // 16-byte words a chunk (32 KB)
// copy_async_kernel: a ring of STAGES stages of STAGE bytes; a stage is
// loaded again while the READING newest stores may still be reading
// theirs, so STAGES - READING loads are in flight
constexpr int STAGE = 16384;
constexpr int STAGES = 6;
constexpr int READING = 2;

// 16 bytes to global memory, streamed (evict first)
__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1,%2,%3,%4};\n"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// Copies the chunks of `tiles` tiles of tile_words words from x to y:
// chunk g is words [part * CHUNK, min(tile_words, (part + 1) * CHUNK))
// of tile g / per_tile, part = g % per_tile.  Block row blockIdx.y takes
// tiles [blockIdx.y * tiles, (blockIdx.y + 1) * tiles) (the 2-D grid: a
// sample a row; flat, one row for them all), and its block k every
// gridDim.x-th chunk of them from chunk k on.
__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint4* x, uint4* y, long long tile_words, long long tiles) {
  const long long per_tile = (tile_words + CHUNK - 1) / CHUNK;
  const long long base = (long long)blockIdx.y * tiles * tile_words;
  const long long total = per_tile * tiles;
  for (long long g = blockIdx.x; g < total; g += gridDim.x) {
    const long long part = g % per_tile;
    const long long off = base + g / per_tile * tile_words + part * CHUNK;
    const long long size = min((long long)CHUNK, tile_words - part * CHUNK);
    const uint4* src = x + off;
    uint4* dst = y + off;
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < size) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < size) st_stream(dst + i, v[u]);
    }
  }
}

// blocks of `kernel` resident on the card at once (threads a block,
// dynamic shared memory), or a negative CUDA error
int resident_blocks(const void* kernel, int threads, int smem) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return sms * per_sm;
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

// bytes from global src into shared dst, completion on mbarrier bar,
// with L2 cache policy pol
__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(pol) : "memory");
}

// bytes from shared src to global dst, as one bulk group, with L2 cache
// policy pol
__device__ __forceinline__ void bulk_store(char* dst, uint32_t src, uint32_t bytes,
                                           uint64_t pol) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n"
      :: "l"(dst), "r"(src), "r"(bytes), "l"(pol) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Chunk g of the copy: its byte offset and size.  Chunks are STAGE bytes
// of one tile, the tile's tail a part-chunk; per_tile chunks a tile.
__device__ __forceinline__ void chunk_at(long long g, long long tile_bytes,
                                         long long per_tile, long long& offset,
                                         uint32_t& size) {
  const long long part = g % per_tile;
  offset = g / per_tile * tile_bytes + part * STAGE;
  size = (uint32_t)min((long long)STAGE, tile_bytes - part * STAGE);
}

// A persistent grid of one warp a block (as many as fit on the SMs);
// lane 0 of block k copies chunks k, k + gridDim.x, k + 2 gridDim.x, ...
// The copy is cut into chunks of at most STAGE bytes that never straddle
// two tiles of tile_bytes (the tail of a tile is a part-chunk), and the
// blocks split the chunks, not the tiles, so every block moves the same
// bytes to within one chunk, and the blocks together walk the copy from
// its start to its end (a window of gridDim.x chunks at a time).
__global__ void __launch_bounds__(32)
copy_async_kernel(const char* x, char* y, long long tile_bytes, long long ntiles) {
  extern __shared__ __align__(128) char buf[];   // STAGES x STAGE
  __shared__ __align__(8) uint64_t bars[STAGES];
  if (threadIdx.x != 0) return;
  const long long per_tile = (tile_bytes + STAGE - 1) / STAGE;
  const long long total = per_tile * ntiles;
  const long long n = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  for (int s = 0; s < STAGES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&bars[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  uint64_t policy;   // streamed once: first out of L2, both ways
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));

  // the block's chunk i is chunk blockIdx.x + i gridDim.x of the copy
  auto load = [&](long long i) {
    const int s = (int)(i % STAGES);
    long long offset;
    uint32_t size;
    chunk_at(blockIdx.x + i * (long long)gridDim.x, tile_bytes, per_tile, offset, size);
    bulk_load(smem_addr(buf + s * STAGE), x + offset, size, smem_addr(&bars[s]), policy);
  };

  for (long long i = 0; i < n && i < STAGES; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    const int s = (int)(i % STAGES);
    while (!mbar_try_wait(smem_addr(&bars[s]), (uint32_t)((i / STAGES) & 1))) {
    }
    long long offset;
    uint32_t size;
    chunk_at(blockIdx.x + i * (long long)gridDim.x, tile_bytes, per_tile, offset, size);
    bulk_store(y + offset, smem_addr(buf + s * STAGE), size, policy);
    // refill the stage of chunk i - READING with chunk i - READING +
    // STAGES once that chunk's store has read it; the READING newest
    // stores may still be reading theirs
    const long long j = i - READING + STAGES;
    if (j >= STAGES && j < n) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(READING) : "memory");
      load(j);
    }
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
// be x.  Tiles of tn tokens, tn * C * elem
// a multiple of 16; flat: one row of blocks splits all B * N / tn
// tiles, in place of a row of blocks a sample.
int probe_copy(const void* x, void* y, int B, long long N, int C, int elem, int tn,
               int flat, void* stream) {
  if (bad_tiles(B, N, C, elem, tn)) return (int)cudaErrorInvalidValue;
  static int cap = 0;   // blocks resident on the card at once
  if (cap == 0) cap = resident_blocks((const void*)copy_kernel, THREADS, 0);
  if (cap < 0) {
    const int err = -cap;
    cap = 0;
    return err;
  }
  const long long nt = N / tn, words = (long long)tn * C * elem / 16;
  const long long rows = flat ? 1 : B;
  const long long chunks = (words + CHUNK - 1) / CHUNK * nt * B;
  // whole waves of the card's resident blocks, as many as leave each
  // block a chunk or two (never more blocks than chunks), split evenly
  // over the rows of the grid
  const long long waves = std::max(1LL, chunks / cap);
  const long long per_row =
      std::max(1LL, std::min(chunks / rows, waves * cap / rows));
  const dim3 grid((unsigned)per_row, (unsigned)rows);
  copy_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)y, words, flat ? nt * B : nt);
  return (int)cudaGetLastError();
}

// y = x as probe_copy, y not x, through copy_async_kernel.
int probe_copy_async(const void* x, void* y, int B, long long N, int C, int elem,
                     int tn, void* stream) {
  if (bad_tiles(B, N, C, elem, tn) || x == y) return (int)cudaErrorInvalidValue;
  static int grid_cap = 0;   // blocks resident on the card at once
  if (grid_cap == 0)
    grid_cap = resident_blocks((const void*)copy_async_kernel, 32, STAGES * STAGE);
  if (grid_cap < 0) {
    const int err = -grid_cap;
    grid_cap = 0;
    return err;
  }
  const long long tile_bytes = (long long)tn * C * elem, ntiles = B * (N / tn);
  const long long chunks = (tile_bytes + STAGE - 1) / STAGE * ntiles;
  const int grid = (int)(chunks < grid_cap ? chunks : grid_cap);
  copy_async_kernel<<<grid, 32, STAGES * STAGE, (cudaStream_t)stream>>>(
      (const char*)x, (char*)y, tile_bytes, ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
