// Fused ConvResBlock forward for Hopper (sm_90a), its bf16 products on
// the tensor cores (mma.sync, bf16 operands, f32 sums).
//
// Replaces the TPU kernel dddpm_tpu/ops/pallas/convres.py:_fwd_kernel,
// reached from fused_convres_block -> _fused_forward.
//
// What it computes, on x (B, H, W, CIO) NHWC with CM = 32 mid channels:
//   m0 = mish(x)
//   m1 = mish(m0 @ w1 + b1)                1x1, CIO -> CM
//   m2 = mish(conv3x3(m1, w2) + b2)        SAME, zero padding of m1
//   m3 = mish(conv3x3(m2, w3) + b3)        SAME, zero padding of m2
//   o  = m3 @ w4 + b4 (+ x)                1x1, CM -> CIO
//   y  = o | nearest 2x upsample of o ('up') | 2x2 mean of o ('down')
// m0..m3 and o are rounded to the activation type; 'down' pools the
// rounded o in f32.  m1 and m2 are exactly zero outside the image: the
// conv's zero padding applies to its input, and mish(bias) is not zero.
//
// What bounds it on an H100: at 256^2, CIO 64, no scaling, B = 8 it
// moves 67 MB (0.020 ms at 3.35 TB/s) and does 5.9 GFLOP (0.006 ms at
// the bf16 peak): the bytes, at 45 FLOP a byte.  But it also takes ~260
// mish a pixel (m0 over the band, m1, m2, m3, with the halos), ~10
// instructions each with an ex2 and a rcp, and mma.sync reaches well
// under the tensor-core peak, with a tile's halo adding ~28% to the
// products.  Measured (probes/convres_ablation.py, H100 80GB HBM3,
// 700 W): the products run at about mma.sync's rate, and the mish's
// time adds to theirs rather than overlapping it, so the two together
// bound the kernel, several times its byte bound.
//
// What this design does about it (bf16): an implicit GEMM per tile of
// TH x 16 output pixels of one sample, four products chained through
// shared memory on mma.sync.m16n8k16, M = pixels, each lane's ldmatrix
// row address its own pixel, so that a 3x3 tap is a constant offset:
//   G1 on the tile grown by 2 ((TH+4) x 20 px): m0 . w1, m0 = mish(x)
//      taken on the A fragments in registers; + b1, mish, zero outside
//      the image, round -> m1 (80-byte pixel rows);
//   G2 on the tile grown by 1: K = 9 taps x 32 over m1 -> m2;
//   G3 on the tile: the same over m2; + b3, mish, round: m3 stays in
//      registers, its accumulator fragments being G4's A fragments;
//   G4: m3 . w4 + b4 (+ x), round -> o, staged in shared memory.
// All four weights live in shared memory for the block's life (bf16,
// 80-byte rows; w4 and the band (CIO + 8) x 2 bytes a row: no ldmatrix
// bank conflicts).  The grid is persistent, one 640-thread block an SM
// (~224 KB of shared memory at CIO 64), walking every gridDim-th tile,
// the columns fastest, so that neighbouring tiles run at once and the
// halos come from L2.  A tile's products wait on the mish before them
// and its mish on the products before them, so the block runs two
// tiles at once, in two groups of its own buffers (band, staging, m1,
// m2) and warps, which keeps the SM busy while a group waits on its
// barriers or its write-out (faster on the card than one group of 16
// consumer warps).  A group is warp-specialised:
//   - 8 consumer warps run G1-G4 with their bias + mish epilogues in
//     registers, each warp up to two m16 tiles at once (B fragments
//     loaded once for both, the next step's fragments before this
//     step's products);
//   - 2 producer warps load the next tile's raw x band (16-byte
//     cp.async, zero-filled outside the image) as soon as G1 is done
//     with the band, copy its raw x at the tile's pixels into the
//     staging buffer (the residual, which G4 adds o to in place), and
//     write the tile's o out of it as 16-byte rows: 'up' each pixel as
//     a 2x2 block of them, 'down' the 2x2 quads pooled in f32;
//   - named barriers hand the band and the staging buffer over, so the
//     consumers never wait on a global load or store, only on the
//     write-out of their previous tile (the other group runs then).
// Tiles: 8 x 16 px at CIO 32 and 64, 4 x 16 at CIO 128 (8 x 16 would
// need ~325 KB).  H and W need not be multiples of the tile: the band is
// zero-filled, m1 and m2 masked and the stores skipped outside the
// image.  x and y must be 16-byte aligned (the wrapper raises
// otherwise).
//
// float32 is on no default path and keeps the kernel's first design,
// selected by the dtype argument (not a fallback): FMA loops, one warp
// a pixel, one lane a channel, f32 weights and intermediates in shared
// memory, no rounding.
//
// CONVRES_SKIP (a -D define, 0 by default) compiles parts of the bf16
// kernel out, by bit: 1 the products (mma), 2 the mish (identity), 4 the
// producers' global traffic (the band loads and the stores of o).  Only
// the ablation probe (probes/convres_ablation.py) sets it; its kernels
// compute garbage.  The fragment helpers (gemm32, act2, ...) are
// csrc/convres_sm90.cuh's, shared with K3.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convres_sm90.cuh"  // bf16, CM, MS, SKIP, pack2, act, act2, gemm32(_n)
#include "mish_sm90.cuh"     // mish (ex2 + rcp)
#include "mma_sm90.cuh"      // cp_async16, ldmatrix_x4(_trans), mma_bf16

namespace {

// ---------------------------------------------------------------------
// float32: the FMA kernel
// ---------------------------------------------------------------------

namespace f32 {

constexpr int TH = 8;         // output rows per tile
constexpr int TW = 32;        // output columns per tile
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int W1 = TW + 4, H1 = TH + 4;   // m1 region (2-pixel halo)
constexpr int W2 = TW + 2, H2 = TH + 2;   // m2 region (1-pixel halo)

// 3x3 conv at one pixel for output channel `lane`: src is a CM-channel
// region of row width `sw`, (r, c) the top-left of the 3x3 window.
__device__ __forceinline__ float conv3x3_at(const float* src, int sw, int r,
                                            int c, const float* w, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* s = src + ((r + ky) * sw + c + kx) * CM;
      const float* wk = w + (ky * 3 + kx) * CM * CM + lane;
#pragma unroll 8
      for (int ic = 0; ic < CM; ++ic) acc = fmaf(s[ic], wk[ic * CM], acc);
    }
  return acc;
}

}  // namespace f32

// scale: 0 none, 1 'up' (2x nearest), 2 'down' (2x2 mean).
template <int CIO>
__global__ void __launch_bounds__(f32::THREADS)
convres_fwd_fma_kernel(const float* x, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* b3, const float* w4, const float* b4,
                       float* y, int H, int W, int residual, int scale) {
  constexpr int TH = f32::TH, TW = f32::TW, THREADS = f32::THREADS;
  constexpr int NWARPS = f32::NWARPS, W1 = f32::W1, H1 = f32::H1;
  constexpr int W2 = f32::W2, H2 = f32::H2;
  using f32::conv3x3_at;
  constexpr int NI = CIO / 32;   // in/out channels per lane
  extern __shared__ float smem[];
  float* w1s = smem;                   // CIO x CM
  float* w2s = w1s + CIO * CM;         // 9 x CM x CM
  float* w3s = w2s + 9 * CM * CM;      // 9 x CM x CM
  float* w4s = w3s + 9 * CM * CM;      // CM x CIO
  float* m1s = w4s + CM * CIO;         // H1 x W1 x CM
  float* m2s = m1s + H1 * W1 * CM;     // H2 x W2 x CM

  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xb = x + (size_t)bi * H * W * CIO;

  for (int i = threadIdx.x; i < CIO * CM; i += THREADS) {
    w1s[i] = w1[i];
    w4s[i] = w4[i];
  }
  for (int i = threadIdx.x; i < 9 * CM * CM; i += THREADS) {
    w2s[i] = w2[i];
    w3s[i] = w3[i];
  }
  __syncthreads();

  // m1 on the tile grown by 2: zero outside the image
  for (int p = warp; p < H1 * W1; p += NWARPS) {
    const int gr = r0 - 2 + p / W1, gc = c0 - 2 + p % W1;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      const float* xp = xb + ((size_t)gr * W + gc) * CIO;
      float m0[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) m0[i] = mish(xp[lane + 32 * i]);
      float acc = b1[lane];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll 8
        for (int k = 0; k < 32; ++k)
          acc = fmaf(__shfl_sync(0xffffffffu, m0[i], k),
                     w1s[(32 * i + k) * CM + lane], acc);
      v = mish(acc);
    }
    m1s[p * CM + lane] = v;
  }
  __syncthreads();

  // m2 on the tile grown by 1: zero outside the image
  for (int p = warp; p < H2 * W2; p += NWARPS) {
    const int pr = p / W2, pc = p % W2;
    const int gr = r0 - 1 + pr, gc = c0 - 1 + pc;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = mish(b2[lane] + conv3x3_at(m1s, W1, pr, pc, w2s, lane));
    m2s[p * CM + lane] = v;
  }
  __syncthreads();

  // m3 and the output projection at one pixel: o[i] holds channel lane+32i
  auto out_at = [&](int pr, int pc, float (&o)[NI]) {
    const float m3 = mish(b3[lane] + conv3x3_at(m2s, W2, pr, pc, w3s, lane));
    const float* xp = xb + ((size_t)(r0 + pr) * W + c0 + pc) * CIO;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int co = lane + 32 * i;
      o[i] = b4[co] + (residual ? xp[co] : 0.f);
    }
#pragma unroll 8
    for (int k = 0; k < CM; ++k) {
      const float a = __shfl_sync(0xffffffffu, m3, k);
#pragma unroll
      for (int i = 0; i < NI; ++i) o[i] = fmaf(a, w4s[k * CIO + lane + 32 * i], o[i]);
    }
  };

  if (scale == 2) {
    const int Ho = H / 2, Wo = W / 2;
    float* yb = y + (size_t)bi * Ho * Wo * CIO;
    for (int q = warp; q < (TH / 2) * (TW / 2); q += NWARPS) {
      const int qr = q / (TW / 2), qc = q % (TW / 2);
      if (r0 + 2 * qr >= H || c0 + 2 * qc >= W) continue;
      float sum[NI] = {};
      for (int s = 0; s < 4; ++s) {
        float o[NI];
        out_at(2 * qr + s / 2, 2 * qc + s % 2, o);
#pragma unroll
        for (int i = 0; i < NI; ++i) sum[i] += o[i];
      }
      float* yp = yb + ((size_t)(r0 / 2 + qr) * Wo + c0 / 2 + qc) * CIO;
#pragma unroll
      for (int i = 0; i < NI; ++i) yp[lane + 32 * i] = sum[i] * 0.25f;
    }
    return;
  }
  for (int p = warp; p < TH * TW; p += NWARPS) {
    const int pr = p / TW, pc = p % TW;
    const int gr = r0 + pr, gc = c0 + pc;
    if (gr >= H || gc >= W) continue;
    float o[NI];
    out_at(pr, pc, o);
    if (scale == 1) {
      float* yb = y + (size_t)bi * (2 * H) * (2 * W) * CIO;
      for (int s = 0; s < 4; ++s) {
        float* yp = yb + ((size_t)(2 * gr + s / 2) * (2 * W) + 2 * gc + s % 2) * CIO;
#pragma unroll
        for (int i = 0; i < NI; ++i) yp[lane + 32 * i] = o[i];
      }
    } else {
      float* yp = y + (((size_t)bi * H + gr) * W + gc) * CIO;
#pragma unroll
      for (int i = 0; i < NI; ++i) yp[lane + 32 * i] = o[i];
    }
  }
}

template <int CIO>
int launch_fma(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* w3, const void* b3, const void* w4,
               const void* b4, void* y, int B, int H, int W, int residual,
               int scale, cudaStream_t stream) {
  const int smem = (2 * CIO * CM + 2 * 9 * CM * CM + f32::H1 * f32::W1 * CM +
                    f32::H2 * f32::W2 * CM) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      convres_fwd_fma_kernel<CIO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + f32::TW - 1) / f32::TW, (H + f32::TH - 1) / f32::TH, B);
  convres_fwd_fma_kernel<CIO><<<grid, f32::THREADS, smem, stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (const float*)w3, (const float*)b3, (const float*)w4,
      (const float*)b4, (float*)y, H, W, residual, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bfloat16: the tensor cores
// ---------------------------------------------------------------------

constexpr int TW = 16;          // output columns a tile: one m16 tile a row
constexpr int GROUPS = 2;       // tiles in flight a block, one a group
constexpr int NCW = 8;          // consumer warps a group: G1-G4
constexpr int NPW = 2;          // producer warps a group: x in, o out
constexpr int GC = 32 * NCW, GP = 32 * NPW, GT = GC + GP;   // threads a group
constexpr int CONSUMERS = GROUPS * GC;
constexpr int THREADS = GROUPS * GT;
// named barriers of group g (0 is __syncthreads), at 1 + 5 g + the
// role: XFULL, its band holds tile k's raw x and its staging buffer the
// residual; BFREE, its consumers are done with the band (G1); YFULL,
// its staging buffer holds o; its producers' and its consumers' own
enum { XFULL = 0, BFREE = 1, YFULL = 2, PROD = 3, CONS = 4, NBAR = 5 };

// A tile of TH x TW output pixels at CIO in/out channels: its regions
// (R1, the tile grown by 2, for m1; R2, grown by 1, for m2; R3, the
// tile) and the block's shared memory, offsets in bf16 elements: the
// weights, the biases (f32), then a group's band, staging buffer, m1
// and m2 for each group.
template <int CIO, int TH_>
struct Tile {
  static constexpr int TH = TH_;
  static constexpr int H1 = TH + 4, W1 = TW + 4, N1 = H1 * W1;
  static constexpr int H2 = TH + 2, W2 = TW + 2, N2 = H2 * W2;
  static constexpr int N3 = TH * TW;
  static constexpr int M1 = (N1 + 15) / 16, M2 = (N2 + 15) / 16, M3 = N3 / 16;
  // bf16 a pixel of the x band and of the staged output, and a row of
  // w4: (CIO + 8) x 2 bytes, an odd multiple of 16
  static constexpr int XS = CIO + 8;
  static constexpr int O_W2 = CIO * MS;             // w1 first
  static constexpr int O_W3 = O_W2 + 9 * CM * MS;
  static constexpr int O_W4 = O_W3 + 9 * CM * MS;
  static constexpr int O_B = O_W4 + CM * XS;        // f32 b1 | b2 | b3 | b4
  static constexpr int O_G = O_B + (3 * CM + CIO) * 2;
  // a group's: band (R1 x XS), staging (R3 x XS), m1 (R1 x MS), m2
  static constexpr int G_Y = N1 * XS, G_M1 = G_Y + N3 * XS, G_M2 = G_M1 + N1 * MS;
  static constexpr int GSIZE = G_M2 + N2 * MS;
  static constexpr int SMEM = (O_G + GROUPS * GSIZE) * 2;
  static_assert(SMEM <= 227 * 1024, "shared memory");
  static_assert(M3 <= NCW && TH % 2 == 0, "a G3 m16 tile a warp at most");
  static_assert(O_G % 8 == 0 && GSIZE % 8 == 0, "16-byte aligned regions");
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// scale: 0 none, 1 'up' (2x nearest), 2 'down' (2x2 mean).
//
// The block runs two tiles at once, one a group (8 consumer warps, 2
// producer warps, its own band, staging buffer, m1 and m2), so that one
// group's SFU work (mish) runs beside the other's products; group g's
// k-th tile is tile blockIdx.x + (2 k + g) gridDim.x.  In a group, per
// tile k: the consumers wait for XFULL, run G1 (mish of the band on its
// A fragments), signal BFREE, run G2 and G3 + G4 (consumer barriers
// between, as each reads its neighbours' pixels of the one before) and
// signal YFULL; the producers, once BFREE, load tile k + 1's raw band
// (under G2-G4), once YFULL write tile k's o out, then copy tile k + 1's
// raw x at its own pixels into the staging buffer (the residual, which
// G4 adds o to in place) and signal XFULL.
template <int CIO, int TH>
__global__ void __launch_bounds__(THREADS, 1)
convres_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, const bf16* __restrict__ w3,
                   const float* __restrict__ b3, const bf16* __restrict__ w4,
                   const float* __restrict__ b4, bf16* __restrict__ y, int B,
                   int H, int W, int residual, int scale) {
  using S = Tile<CIO, TH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* const w1s = sm;             // [ci][co], CIO x MS
  bf16* const w2s = sm + S::O_W2;   // [tap * 32 + ci][co], 288 x MS
  bf16* const w3s = sm + S::O_W3;
  bf16* const w4s = sm + S::O_W4;   // [ci][co], 32 x XS
  float* const bs = reinterpret_cast<float*>(sm + S::O_B);   // b1 | b2 | b3 | b4

  // the weights and biases, once for the block's tiles
  for (int i = threadIdx.x; i < CIO * CM; i += THREADS) {
    w1s[(i / CM) * MS + i % CM] = w1[i];
    w4s[(i / CIO) * S::XS + i % CIO] = w4[i];
  }
  for (int i = threadIdx.x; i < 9 * CM * CM; i += THREADS) {
    w2s[(i / CM) * MS + i % CM] = w2[i];
    w3s[(i / CM) * MS + i % CM] = w3[i];
  }
  for (int i = threadIdx.x; i < CM; i += THREADS) {
    bs[i] = b1[i];
    bs[CM + i] = b2[i];
    bs[2 * CM + i] = b3[i];
  }
  for (int i = threadIdx.x; i < CIO; i += THREADS) bs[3 * CM + i] = b4[i];
  __syncthreads();

  // this thread's group and role: warps [0, CONSUMERS / 32) consume,
  // NCW a group; the rest produce, NPW a group
  const bool producer = threadIdx.x >= CONSUMERS;
  const int gi = producer ? (threadIdx.x - CONSUMERS) / GP : threadIdx.x / GC;
  const int bar0 = 1 + NBAR * gi;
  bf16* const band = sm + S::O_G + gi * S::GSIZE;   // N1 x XS: raw x
  bf16* const ys = band + S::G_Y;                   // N3 x XS: residual, then o
  bf16* const m1s = band + S::G_M1;                 // N1 x MS
  bf16* const m2s = band + S::G_M2;                 // N2 x MS

  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  // this group's tiles: blockIdx.x + (2 k + gi) gridDim.x for k < n, the
  // columns fastest over the grid, so that neighbouring tiles run at once
  const int first = (int)blockIdx.x + gi * (int)gridDim.x;
  const int n = ntiles > first ? (ntiles - first + GROUPS * (int)gridDim.x - 1) /
                                     (GROUPS * (int)gridDim.x)
                               : 0;
  auto tile_at = [&](int k, int& bi, int& r0, int& c0) {
    const int t = first + k * GROUPS * (int)gridDim.x;
    c0 = (t % tiles_w) * TW;
    r0 = ((t / tiles_w) % tiles_h) * TH;
    bi = t / (tiles_w * tiles_h);
  };

  constexpr int CH = CIO / 8;   // 16-byte pieces a pixel
  if (producer) {
    // ---- producers ----
    const int p = (threadIdx.x - CONSUMERS) % GP;
    // tile k's raw x band (R1), zero outside the image
    auto load = [&](int k) {
      int bi, r0, c0;
      tile_at(k, bi, r0, c0);
      const bf16* xb = x + (size_t)bi * H * W * CIO;
      for (int i = p; i < S::N1 * CH; i += GP) {
        const int px = i / CH, ch = i % CH;
        const int gr = r0 - 2 + px / S::W1, gc = c0 - 2 + px % S::W1;
        const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
        const bf16* src = in ? xb + ((size_t)gr * W + gc) * CIO + ch * 8 : x;
        if (!(SKIP & 4)) cp_async16(band + px * S::XS + ch * 8, src, in);
      }
      cp_async_commit();
    };
    // the landed band's raw x at the tile's own pixels into the staging
    // buffer: the residual
    auto residual_in = [&]() {
      for (int i = p; i < S::N3 * CH; i += GP) {
        const int px = i / CH, ch = i % CH;
        *reinterpret_cast<uint4*>(ys + px * S::XS + ch * 8) =
            *reinterpret_cast<const uint4*>(
                band + ((px / TW + 2) * S::W1 + px % TW + 2) * S::XS + ch * 8);
      }
    };
    // tile k's staged o to y, 16-byte pieces, the pieces of one output
    // row on neighbouring threads
    auto store = [&](int k) {
      int bi, r0, c0;
      tile_at(k, bi, r0, c0);
      if (scale == 0) {
        for (int i = p; i < S::N3 * CH; i += GP) {
          const int px = i / CH, ch = i % CH;
          const int gr = r0 + px / TW, gc = c0 + px % TW;
          if (gr < H && gc < W)
            *reinterpret_cast<uint4*>(y + (((size_t)bi * H + gr) * W + gc) * CIO + ch * 8) =
                *reinterpret_cast<const uint4*>(ys + px * S::XS + ch * 8);
        }
      } else if (scale == 1) {
        // (tile row, a, tile column, b, piece): output pixel (2 gr + a,
        // 2 gc + b) is o at (gr, gc)
        for (int i = p; i < 4 * S::N3 * CH; i += GP) {
          const int ch = i % CH, bb = (i / CH) & 1, j = (i / (2 * CH)) % TW;
          const int a = (i / (2 * CH * TW)) & 1, ii = i / (4 * CH * TW);
          const int gr = r0 + ii, gc = c0 + j;
          if (gr < H && gc < W)
            *reinterpret_cast<uint4*>(
                y + (((size_t)bi * 2 * H + 2 * gr + a) * 2 * W + 2 * gc + bb) * CIO + ch * 8) =
                *reinterpret_cast<const uint4*>(ys + (ii * TW + j) * S::XS + ch * 8);
        }
      } else {
        // the 2x2 quads of rounded o, summed in f32, x 0.25, rounded
        const int Ho = H / 2, Wo = W / 2;
        for (int i = p; i < S::N3 / 4 * CH; i += GP) {
          const int ch = i % CH, q = i / CH;
          const int qi = q / (TW / 2), qj = q % (TW / 2);
          if (r0 + 2 * qi >= H || c0 + 2 * qj >= W) continue;
          float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                ys + ((2 * qi + d / 2) * TW + 2 * qj + d % 2) * S::XS + ch * 8);
            const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
              s[2 * e] += f.x;
              s[2 * e + 1] += f.y;
            }
          }
          const uint4 o = make_uint4(pack2(s[0] * 0.25f, s[1] * 0.25f),
                                     pack2(s[2] * 0.25f, s[3] * 0.25f),
                                     pack2(s[4] * 0.25f, s[5] * 0.25f),
                                     pack2(s[6] * 0.25f, s[7] * 0.25f));
          *reinterpret_cast<uint4*>(
              y + (((size_t)bi * Ho + r0 / 2 + qi) * Wo + c0 / 2 + qj) * CIO + ch * 8) = o;
        }
      }
    };

    if (n > 0) {
      load(0);
      cp_async_wait_all();
      bar_sync(bar0 + PROD, GP);   // every producer's pieces are in
      if (residual) residual_in();
      bar_arrive(bar0 + XFULL, GT);
    }
    for (int k = 0; k < n; ++k) {   // the consumers run tile k
      if (k + 1 < n) {
        bar_sync(bar0 + BFREE, GT);
        load(k + 1);
      }
      bar_sync(bar0 + YFULL, GT);
      if (!(SKIP & 4)) store(k);
      if (k + 1 < n) {
        cp_async_wait_all();
        bar_sync(bar0 + PROD, GP);   // band k + 1 in, staging written out
        if (residual) residual_in();
        bar_arrive(bar0 + XFULL, GT);
      }
    }
    return;
  }

  // ---- consumers ----
  const int warp = (threadIdx.x % GC) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int la = lane & 15, lk = (lane >> 4) * 8;   // A row (pixel), k half
  for (int k = 0; k < n; ++k) {
    int bi, r0, c0;
    tile_at(k, bi, r0, c0);
    bar_sync(bar0 + XFULL, GT);

    // G1 on R1: m1 = mish(round(mish(x)) . w1 + b1), 0 outside the image
    for (int mt = warp; mt < S::M1; mt += 2 * NCW) {
      const bool two = mt + NCW < S::M1;
      const bf16* a_lane[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        a_lane[u] = band + min(16 * (mt + u * NCW) + la, S::N1 - 1) * S::XS + lk;
      float acc[2][4][4];
      gemm32<true, CIO / 16>(acc, a_lane, two, w1s, [](int s) { return 16 * s; }, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * (mt + u * NCW) + g + 8 * h;
          if (px >= S::N1) continue;
          const int gr = r0 - 2 + px / S::W1, gc = c0 - 2 + px % S::W1;
          const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = 8 * nt + 2 * tq;
            const unsigned v = pack2(act(acc[u][nt][2 * h] + bs[ch]),
                                     act(acc[u][nt][2 * h + 1] + bs[ch + 1]));
            *reinterpret_cast<unsigned*>(m1s + px * MS + ch) = in ? v : 0u;
          }
        }
      }
    }
    bar_sync(bar0 + CONS, GC);
    if (k + 1 < n) bar_arrive(bar0 + BFREE, GT);   // the band is read

    // G2 on R2: m2 = mish(conv3x3(m1) + b2), 0 outside the image
    for (int mt = warp; mt < S::M2; mt += 2 * NCW) {
      const bool two = mt + NCW < S::M2;
      const bf16* a_lane[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = min(16 * (mt + u * NCW) + la, S::N2 - 1);
        a_lane[u] = m1s + ((q / S::W2) * S::W1 + q % S::W2) * MS + lk;
      }
      float acc[2][4][4];
      // step s: tap s / 2 = (ky, kx), channels 16 (s % 2) on
      gemm32<false, 18>(acc, a_lane, two, w2s, [](int s) {
        const int t = s >> 1;
        return ((t / 3) * S::W1 + t % 3) * MS + 16 * (s & 1);
      }, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * (mt + u * NCW) + g + 8 * h;
          if (q >= S::N2) continue;
          const int gr = r0 - 1 + q / S::W2, gc = c0 - 1 + q % S::W2;
          const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = 8 * nt + 2 * tq;
            const unsigned v = pack2(act(acc[u][nt][2 * h] + bs[CM + ch]),
                                     act(acc[u][nt][2 * h + 1] + bs[CM + ch + 1]));
            *reinterpret_cast<unsigned*>(m2s + q * MS + ch) = in ? v : 0u;
          }
        }
      }
    }
    bar_sync(bar0 + CONS, GC);

    // G3 on the tile (m16 tile = tile row `warp`): m3 = mish(conv3x3(m2)
    // + b3), kept as G4's A fragments; G4: o = m3 . w4 + b4 (+ x)
    if (warp < S::M3) {
      const int row = warp;
      const bf16* a_lane[2] = {m2s + (row * S::W2 + la) * MS + lk, nullptr};
      float acc[2][4][4];
      gemm32_n<false, 18, 1>(acc, a_lane, w3s, [](int s) {
        const int t = s >> 1;
        return ((t / 3) * S::W2 + t % 3) * MS + 16 * (s & 1);
      }, lane);
      // the accumulator of n8 tiles 2 kc, 2 kc + 1 is the A fragment of
      // k16 step kc: rows g, g + 8, channels 16 kc + 2 tq (+ 8)
      unsigned a3[2][4];
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* c = acc[0][2 * kc + j];
          const int ch = 2 * CM + 16 * kc + 8 * j + 2 * tq;
          a3[kc][2 * j] = pack2(act(c[0] + bs[ch]), act(c[1] + bs[ch + 1]));
          a3[kc][2 * j + 1] = pack2(act(c[2] + bs[ch]), act(c[3] + bs[ch + 1]));
        }
      const bf16* w4_lane = w4s + la * S::XS + lk;
#pragma unroll
      for (int j = 0; j < CIO / 16; ++j) {   // 16 output channels at a time
        float o[2][4] = {};
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          unsigned b[4];
          ldmatrix_x4_trans(b, w4_lane + kc * 16 * S::XS + 16 * j);
          mma(o[0], a3[kc], b[0], b[1]);
          mma(o[1], a3[kc], b[2], b[3]);
        }
#pragma unroll
        for (int hn = 0; hn < 2; ++hn) {
          const int co = 16 * j + 8 * hn + 2 * tq;
          const float bo0 = bs[3 * CM + co], bo1 = bs[3 * CM + co + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = g + 8 * h;   // pixel (row, col) of the tile
            float v0 = o[hn][2 * h] + bo0, v1 = o[hn][2 * h + 1] + bo1;
            unsigned* dst = reinterpret_cast<unsigned*>(ys + (row * TW + col) * S::XS + co);
            if (residual) {   // the producers staged x here
              const float2 xf =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
              v0 += xf.x;
              v1 += xf.y;
            }
            *dst = pack2(v0, v1);
          }
        }
      }
    }
    bar_arrive(bar0 + YFULL, GT);
  }
}

template <int CIO, int TH>
int launch_tc(const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, const void* w3, const void* b3, const void* w4,
              const void* b4, void* y, int B, int H, int W, int residual,
              int scale, cudaStream_t stream) {
  using S = Tile<CIO, TH>;
  static int sms = 0;   // one block an SM
  if (sms == 0) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(convres_fwd_kernel<CIO, TH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const long long ntiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // as many blocks as SMs, never more than there are pairs of tiles
  const long long pairs = (ntiles + GROUPS - 1) / GROUPS;
  const int grid = (int)(pairs < sms ? pairs : sms);
  convres_fwd_kernel<CIO, TH><<<grid, THREADS, S::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)w4,
      (const float*)b4, (bf16*)y, B, H, W, residual, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, C) NHWC; w1 (C, 32);
// w2, w3 (3, 3, 32, 32) HWIO; w4 (32, C); all of x's type; b1, b2, b3
// (32) and b4 (C) float32.  y is (B, H, W, C), (B, 2H, 2W, C) for
// scale 1, (B, H/2, W/2, C) for scale 2 (H, W even).  C in {32, 64, 128}.
// bfloat16: x and y 16-byte aligned.
int convres_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* w3, const void* b3, const void* w4,
                const void* b4, void* y, int B, int H, int W, int C, int residual,
                int scale, int dtype, void* stream) {
  if (scale < 0 || scale > 2 || (scale == 2 && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  if ((long long)H * W * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (!aligned16(x) || !aligned16(y)) return (int)cudaErrorMisalignedAddress;
    switch (C) {
      case 32: return launch_tc<32, 8>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W,
                                       residual, scale, s);
      case 64: return launch_tc<64, 8>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W,
                                       residual, scale, s);
      case 128: return launch_tc<128, 4>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W,
                                         residual, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (C) {
    case 32: return launch_fma<32>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W,
                                   residual, scale, s);
    case 64: return launch_fma<64>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W,
                                   residual, scale, s);
    case 128: return launch_fma<128>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W,
                                     residual, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
