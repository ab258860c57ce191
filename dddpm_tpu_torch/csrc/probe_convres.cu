// Variants of the fused ConvResBlock forward for Hopper (sm_90a), each
// with one cost removed or changed, to see where K2's time goes.
//
// Replaces the TPU kernel of scripts/probe_convres_variants.py:
//   kernel in make_fwd (:94, pallas_call :150) -> probe_convres_kernel
//
// What it computes, on x (B, H, W, 64) NHWC bf16 with CM = 32 mid
// channels, residual on, no scaling (the probe's configuration):
//   m0 = mish(x)
//   m1 = mish(m0 @ w1 + b1)               1x1, 64 -> 32
//   m2 = mish(conv3x3(m1) + b2)           rows VALID over the halo,
//   m3 = mish(conv3x3(m2) + b3)           columns SAME (zero padding)
//   y  = m3 @ w4 + b4 + x                 1x1, 32 -> 64
// every mish output rounded to bf16.  Columns outside the image are
// zero for both 3x3 convs.  Rows outside the image of m1 and m2 are zero
// when masked; unmasked they hold what the formulas give with x = 0
// there (m1 = mish(b1), ...): the probe's nomask, wrong at the top and
// bottom borders by design.
//
// What bounds it on an H100: at the probe's default (B = 32, 256^2,
// cio 64) it moves 536.9 MB (0.160 ms at 3.35 TB/s) and does 94.5 GFLOP
// of products (0.096 ms at the bf16 peak): the bytes.  But, as in K2,
// the mish (~260 a pixel with the halos) and mma.sync's rate, which add
// up rather than overlap, bound it several times over.
//
// What this design does about it: it is K2's bf16 design (csrc/
// convres_fwd.cu: an implicit GEMM per tile of TH x 16 output pixels on
// mma.sync.m16n8k16, M = pixels; G1 on the tile grown by 2 with m0 =
// mish(x) taken on its A fragments, G2 and G3 as 9 taps x 32, G4 in
// registers from G3's fragments; weights resident as bf16 in 80-byte
// rows; a persistent grid of one block an SM whose producer warps load
// the x band by cp.async and write o out as 16-byte rows), with the
// fragment helpers of csrc/convres_sm90.cuh.  The variants are template
// parameters, each removing or changing, in that design's terms, the
// cost the TPU variant removed:
//   MASK     0 (base): m1 and m2 are computed at every halo row, then
//            each element of the epilogue is multiplied by its own 0/1
//            from its pixel's row (the probe's per-element iota mask).
//            1 (rowmask): one predicate a pixel selects zero at rows
//            (and columns) outside the image, K2's way: an m16 tile
//            straddles rows, so its products run over such pixels too,
//            as in K2.  2 (nomask): computed and kept at every row;
//            columns outside the image are zero in every variant.
//   IM2COL   true: for G2 and G3, a chunk of P pixels' 3x3 windows is
//            copied into an im2col stage of [P x 288] in shared memory
//            (592-byte rows), then each m16 tile's product reads
//            contiguous K = 288 rows of it with ldmatrix.  false
//            (ninedot): each lane's ldmatrix row address is its own
//            pixel, a tap a constant offset: K2's G2 and G3 exactly.
//   FAST     false: K2's f32 mish (mish_sm90.cuh: ex2 + rcp), rounded.
//            true (bf16mish): mish on packed bf16 pairs, each step
//            rounded to bf16 as the plain version's bf16 mish rounds
//            it: softplus, tanh and the product.  bf16x2 where sm_90
//            has the instruction: |v|, its scaling by log2(e) (fma.rn),
//            ex2.approx.ftz.bf16x2, tanh.approx.bf16x2 and the product
//            (fma.rn).  f32 only where it has none: softplus's log
//            (lg2.approx exists in f32 only), so its 1 + e, the log and
//            its add to max(v, 0) run in f32 and round once, as the
//            plain version's softplus rounds once.
//   TH       output rows a tile: 8 (K2's) or 16 (tile2x).
//
// Second changes that shared memory forces (an H100 block has 227 KB;
// K2's two groups at TH 8 take 224.3 KB), each read with its variant:
//   - IM2COL: the stage is carved from the group's x band, which is
//     idle from G2 on only if the next tile's band waits: the band goes
//     back to the producers after G3, not after G1 as in K2, so the next
//     band loads under G4 and the write-out, not under G2-G4.  The stage
//     holds P = 48 pixels at TH 8 (3 m16 tiles: every consumer warp
//     copies, three multiply) and P = 96 at TH 16 (6 of 16 warps).
//   - TH 16: one group a block (two need 408 KB), of 16 consumer and 4
//     producer warps (K2's 640 threads and ratio, one G3 m16 tile a
//     consumer warp), so the block no longer runs two tiles at once.
// 640 threads cap a thread at 96 registers (five warps share a quarter
// of the SM's register file), where K2 sits: to run the bf16 mish
// variants without spilling, the kernel holds fewer values across its
// tile loop than K2 (the group index is a constant where there is one
// group, an epilogue's pixel row and column are recomputed for each tile,
// and the A rows of a partial m16 tile are not clamped).  The bf16 mish
// also costs more than K2's: sm_90 runs ex2.approx.ftz.bf16x2 and
// tanh.approx.bf16x2 as one MUFU operation a half, so with softplus's
// lg2 it takes 3 MUFU operations an element against ex2 + rcp's 2.
// So base, rowmask and nomask share everything else; rowmask and
// bf16mish too; rowmask against ninedot reads the im2col stage with its
// late band; rowmask against tile2x reads TH 16 with one group and its
// larger P; kitchen (nomask + ninedot + bf16mish + TH 16) has the one
// group but no stage.
//
// H and W need not be multiples of the tile: the band is zero-filled,
// m1 and m2 masked and the stores skipped outside the image.  x and y
// must be 16-byte aligned.
//
// C interface: a plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convres_sm90.cuh"  // bf16, CM, MS, pack2, lo_f, hi_f, act, act2, Act2, gemm32(_n), mma
#include "mish_sm90.cuh"     // mish (ex2 + rcp)
#include "mma_sm90.cuh"      // cp_async16, ldmatrix_x4_trans

namespace {

constexpr int CIO = 64;            // in/out channels
constexpr int XS = CIO + 8;        // bf16 a pixel of the band and the staging buffer, a row of w4
constexpr int K9 = 9 * CM;         // depth of a 3x3 product
constexpr int SS = K9 + 8;         // bf16 a row of the im2col stage (592 bytes, an odd multiple of 16)
constexpr int TW = 16;             // output columns a tile: one m16 tile a row
enum { MASK_ELEM = 0, MASK_ROW = 1, MASK_NONE = 2 };
// named barriers of group g (0 is __syncthreads), at 1 + 5 g + the role,
// as K2's: XFULL, its band holds tile k's raw x and its staging buffer
// the residual; BFREE, its consumers are done with the band; YFULL, its
// staging buffer holds o; its producers' and its consumers' own
enum { XFULL = 0, BFREE = 1, YFULL = 2, PROD = 3, CONS = 4, NBAR = 5 };

// The block at TH rows a tile: 2 groups of 8 consumer and 2 producer
// warps at TH 8 (K2's), 1 group of 16 and 4 at TH 16; the regions of a
// tile (R1, the tile grown by 2, for m1; R2, grown by 1, for m2; R3, the
// tile) and the shared memory, offsets in bf16 elements: the weights,
// the biases (f32), then each group's band, staging buffer, m1 and m2.
template <int TH_>
struct Plan {
  static constexpr int TH = TH_;
  static constexpr int GROUPS = 16 / TH;
  static constexpr int NCW = TH, NPW = TH / 4;   // consumer, producer warps a group
  static constexpr int GC = 32 * NCW, GP = 32 * NPW, GT = GC + GP;
  static constexpr int CONSUMERS = GROUPS * GC, THREADS = GROUPS * GT;
  static constexpr int H1 = TH + 4, W1 = TW + 4, N1 = H1 * W1;
  static constexpr int H2 = TH + 2, W2 = TW + 2, N2 = H2 * W2;
  static constexpr int N3 = TH * TW;
  static constexpr int M1 = (N1 + 15) / 16, M2 = (N2 + 15) / 16, M3 = TH;
  // pixels of an im2col chunk: as many m16 tiles' rows as the band holds
  static constexpr int P = N1 * XS / SS / 16 * 16;
  static constexpr int O_W2 = CIO * MS;             // w1 first
  static constexpr int O_W3 = O_W2 + K9 * MS;
  static constexpr int O_W4 = O_W3 + K9 * MS;
  static constexpr int O_B = O_W4 + CM * XS;        // f32 b1 | b2 | b3 | b4
  static constexpr int O_G = O_B + (3 * CM + CIO) * 2;
  static constexpr int G_Y = N1 * XS, G_M1 = G_Y + N3 * XS, G_M2 = G_M1 + N1 * MS;
  static constexpr int GSIZE = G_M2 + N2 * MS;
  static constexpr int SMEM = (O_G + GROUPS * GSIZE) * 2;
  static_assert(THREADS == 640 && GROUPS * TH == 16, "K2's 640 threads a block");
  static_assert(SMEM <= 227 * 1024, "shared memory");
  static_assert(P >= 16 && P % 16 == 0, "whole m16 tiles a chunk");
  static_assert(O_G % 8 == 0 && GSIZE % 8 == 0, "16-byte aligned regions");
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned ex2_bf16x2(unsigned x) {
  unsigned y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ unsigned tanh_bf16x2(unsigned x) {
  unsigned y;
  asm("tanh.approx.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// a b + c on bf16 pairs, rounded once
__device__ __forceinline__ unsigned fma_bf16x2(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr unsigned NEG_ZERO2 = 0x80008000u;   // (-0, -0): a b + -0 is a b
constexpr unsigned NEG_LOG2E2 = 0xbfb9bfb9u;  // (-log2 e, -log2 e), rounded to bf16

// mish of a bf16 pair v, each step rounded to bf16 (softplus, tanh, the
// product), the plain version's bf16 mish: softplus(v) = max(v, 0) +
// ln(1 + e), e = exp(-|v|) = 2^(-|v| log2 e)
__device__ __forceinline__ unsigned mish2_bf16(unsigned v) {
  const unsigned e = ex2_bf16x2(fma_bf16x2(v & 0x7fff7fffu, NEG_LOG2E2, NEG_ZERO2));
  constexpr float LN2 = 0.693147181f;
  const unsigned sp = pack2(fmaxf(lo_f(v), 0.f) + lg2_approx(1.f + lo_f(e)) * LN2,
                            fmaxf(hi_f(v), 0.f) + lg2_approx(1.f + hi_f(e)) * LN2);
  return fma_bf16x2(v, tanh_bf16x2(sp), NEG_ZERO2);
}

// G1's A map: m0 = mish(x), bf16 pairs in and out
template <bool FAST>
struct M0 {
  __device__ __forceinline__ unsigned operator()(unsigned v) const {
    return FAST ? mish2_bf16(v) : act2(v);
  }
};

// the activation of a pair of sums (bias added), rounded to a bf16 pair;
// under MASK_ELEM each element times rowf, its pixel row's 0/1
template <int MASK, bool FAST>
__device__ __forceinline__ unsigned act_pair(float a, float b, float rowf) {
  if constexpr (FAST) {
    const unsigned v = mish2_bf16(pack2(a, b));
    return MASK == MASK_ELEM ? fma_bf16x2(v, pack2(rowf, rowf), NEG_ZERO2) : v;
  } else {
    float u = act(a), w = act(b);
    if (MASK == MASK_ELEM) {
      u *= rowf;
      w *= rowf;
    }
    return pack2(u, w);
  }
}

// In a group, per tile k, as K2's: the consumers wait for XFULL, run G1
// (mish of the band on its A fragments), G2 and G3 + G4 (consumer
// barriers between, as each reads its neighbours' pixels of the one
// before) and signal YFULL; they signal BFREE after G1, or, with IM2COL,
// after G3, the stage being the band.  The producers, once BFREE, load
// tile k + 1's raw band, once YFULL write tile k's o out, then copy tile
// k + 1's raw x at its own pixels into the staging buffer (the residual,
// which G4 adds o to in place) and signal XFULL.  Group g's k-th tile is
// tile blockIdx.x + (GROUPS k + g) gridDim.x.
template <int MASK, bool IM2COL, bool FAST, int TH>
__global__ void __launch_bounds__(Plan<TH>::THREADS, 1)
probe_convres_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, const bf16* __restrict__ w3,
                     const float* __restrict__ b3, const bf16* __restrict__ w4,
                     const float* __restrict__ b4, bf16* __restrict__ y, int B, int H,
                     int W) {
  using S = Plan<TH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* const w1s = sm;             // [ci][co], CIO x MS
  bf16* const w2s = sm + S::O_W2;   // [tap * 32 + ci][co], 288 x MS
  bf16* const w3s = sm + S::O_W3;
  bf16* const w4s = sm + S::O_W4;   // [ci][co], 32 x XS
  float* const bs = reinterpret_cast<float*>(sm + S::O_B);   // b1 | b2 | b3 | b4

  for (int i = threadIdx.x; i < CIO * CM; i += S::THREADS) {
    w1s[(i / CM) * MS + i % CM] = w1[i];
    w4s[(i / CIO) * XS + i % CIO] = w4[i];
  }
  for (int i = threadIdx.x; i < K9 * CM; i += S::THREADS) {
    w2s[(i / CM) * MS + i % CM] = w2[i];
    w3s[(i / CM) * MS + i % CM] = w3[i];
  }
  for (int i = threadIdx.x; i < CM; i += S::THREADS) {
    bs[i] = b1[i];
    bs[CM + i] = b2[i];
    bs[2 * CM + i] = b3[i];
  }
  for (int i = threadIdx.x; i < CIO; i += S::THREADS) bs[3 * CM + i] = b4[i];
  __syncthreads();

  const bool producer = threadIdx.x >= S::CONSUMERS;
  // this thread's group (0 where there is one: its barrier ids and
  // buffers are then constants)
  const int gi = S::GROUPS == 1 ? 0
                 : producer     ? (threadIdx.x - S::CONSUMERS) / S::GP
                                : threadIdx.x / S::GC;
  const int bar0 = 1 + NBAR * gi;
  bf16* const band = sm + S::O_G + gi * S::GSIZE;   // N1 x XS: raw x; with IM2COL the stage
  bf16* const ys = band + S::G_Y;                   // N3 x XS: residual, then o
  bf16* const m1s = band + S::G_M1;                 // N1 x MS
  bf16* const m2s = band + S::G_M2;                 // N2 x MS

  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  const int first = (int)blockIdx.x + gi * (int)gridDim.x;
  const int stride = S::GROUPS * (int)gridDim.x;
  const int n = ntiles > first ? (ntiles - first + stride - 1) / stride : 0;
  auto tile_at = [&](int k, int& bi, int& r0, int& c0) {
    const int t = first + k * stride;
    c0 = (t % tiles_w) * TW;
    r0 = ((t / tiles_w) % tiles_h) * TH;
    bi = t / (tiles_w * tiles_h);
  };

  constexpr int CH = CIO / 8;   // 16-byte pieces a pixel
  if (producer) {
    // ---- producers ----
    const int p = (threadIdx.x - S::CONSUMERS) % S::GP;
    auto load = [&](int k) {   // tile k's raw x band (R1), zero outside the image
      int bi, r0, c0;
      tile_at(k, bi, r0, c0);
      const bf16* xb = x + (size_t)bi * H * W * CIO;
      for (int i = p; i < S::N1 * CH; i += S::GP) {
        const int px = i / CH, ch = i % CH;
        const int gr = r0 - 2 + px / S::W1, gc = c0 - 2 + px % S::W1;
        const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
        const bf16* src = in ? xb + ((size_t)gr * W + gc) * CIO + ch * 8 : x;
        cp_async16(band + px * XS + ch * 8, src, in);
      }
      cp_async_commit();
    };
    auto residual_in = [&]() {   // the band's x at the tile's own pixels
      for (int i = p; i < S::N3 * CH; i += S::GP) {
        const int px = i / CH, ch = i % CH;
        *reinterpret_cast<uint4*>(ys + px * XS + ch * 8) = *reinterpret_cast<const uint4*>(
            band + ((px / TW + 2) * S::W1 + px % TW + 2) * XS + ch * 8);
      }
    };
    auto store = [&](int k) {   // tile k's staged o to y, 16-byte pieces
      int bi, r0, c0;
      tile_at(k, bi, r0, c0);
      for (int i = p; i < S::N3 * CH; i += S::GP) {
        const int px = i / CH, ch = i % CH;
        const int gr = r0 + px / TW, gc = c0 + px % TW;
        if (gr < H && gc < W)
          *reinterpret_cast<uint4*>(y + (((size_t)bi * H + gr) * W + gc) * CIO + ch * 8) =
              *reinterpret_cast<const uint4*>(ys + px * XS + ch * 8);
      }
    };
    if (n > 0) {
      load(0);
      cp_async_wait_all();
      bar_sync(bar0 + PROD, S::GP);
      residual_in();
      bar_arrive(bar0 + XFULL, S::GT);
    }
    for (int k = 0; k < n; ++k) {   // the consumers run tile k
      if (k + 1 < n) {
        bar_sync(bar0 + BFREE, S::GT);
        load(k + 1);
      }
      bar_sync(bar0 + YFULL, S::GT);
      store(k);
      if (k + 1 < n) {
        cp_async_wait_all();
        bar_sync(bar0 + PROD, S::GP);   // band k + 1 in, staging written out
        residual_in();
        bar_arrive(bar0 + XFULL, S::GT);
      }
    }
    return;
  }

  // ---- consumers ----
  const int ct = threadIdx.x % S::GC, warp = ct >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int la = lane & 15, lk = (lane >> 4) * 8;   // A row (pixel), k half
  int bi, r0, c0;

  // one m16 tile's sums, tile mt of a region rw pixels wide, np in all,
  // the tile grown by hr: + bias, act, mask, rounded, to m (rows of MS).
  // A pixel's row and column come from px + rw r0, unsigned: the tile
  // loop's own values, which the compiler recomputes for each tile
  // instead of hoisting them out of the loop and holding them for the
  // kernel's life (at 96 registers a thread, that spilled).
  auto to_m = [&](const float (&acc)[4][4], int mt, int np, int rw, int hr,
                  const float* bias, bf16* m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = 16 * mt + g + 8 * h;
      if (px >= np) continue;
      const unsigned q = (unsigned)px + (unsigned)rw * (unsigned)r0;
      const int gr = (int)(q / rw) - hr, gc = c0 - hr + (int)(q % rw);
      const bool row_in = gr >= 0 && gr < H;
      const bool keep = gc >= 0 && gc < W && (MASK != MASK_ROW || row_in);
      const float rowf = row_in ? 1.f : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = 8 * nt + 2 * tq;
        const unsigned v = act_pair<MASK, FAST>(acc[nt][2 * h] + bias[ch],
                                                acc[nt][2 * h + 1] + bias[ch + 1], rowf);
        *reinterpret_cast<unsigned*>(m + px * MS + ch) = keep ? v : 0u;
      }
    }
  };

  // G3's epilogue and G4 for tile row `row`: m3 = mish(sums + b3) kept as
  // G4's A fragments (the sums of n8 tiles 2 kc, 2 kc + 1 are the A
  // fragment of k16 step kc), o = m3 . w4 + b4 + the staged x, in place
  auto g34 = [&](const float (&acc)[4][4], int row) {
    unsigned a3[2][4];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* c = acc[2 * kc + j];
        const int ch = 2 * CM + 16 * kc + 8 * j + 2 * tq;
        a3[kc][2 * j] = act_pair<MASK_NONE, FAST>(c[0] + bs[ch], c[1] + bs[ch + 1], 1.f);
        a3[kc][2 * j + 1] = act_pair<MASK_NONE, FAST>(c[2] + bs[ch], c[3] + bs[ch + 1], 1.f);
      }
    const bf16* w4_lane = w4s + la * XS + lk;
#pragma unroll
    for (int j = 0; j < CIO / 16; ++j) {   // 16 output channels at a time
      float o[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        unsigned b[4];
        ldmatrix_x4_trans(b, w4_lane + kc * 16 * XS + 16 * j);
        mma(o[0], a3[kc], b[0], b[1]);
        mma(o[1], a3[kc], b[2], b[3]);
      }
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        const int co = 16 * j + 8 * hn + 2 * tq;
        const float bo0 = bs[3 * CM + co], bo1 = bs[3 * CM + co + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned* dst =
              reinterpret_cast<unsigned*>(ys + (row * TW + g + 8 * h) * XS + co);
          const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
          *dst = pack2(o[hn][2 * h] + bo0 + xf.x, o[hn][2 * h + 1] + bo1 + xf.y);
        }
      }
    }
  };

  // IM2COL: pixels q0 .. q0 + P of a region rw wide (np in all; rows past
  // it repeat the last) as rows of the stage: row q - q0 holds the 3x3
  // window of src (rows sw wide) whose top-left is (q / rw, q % rw), tap
  // by tap, 16 bytes a thread at a time
  auto im2col = [&](const bf16* src, int sw, int rw, int q0, int np) {
    for (int i = ct; i < S::P * 36; i += S::GC) {
      const int r = i / 36, t = (i % 36) >> 2, c8 = i & 3;
      const int q = min(q0 + r, np - 1);
      *reinterpret_cast<uint4*>(band + r * SS + t * CM + 8 * c8) =
          *reinterpret_cast<const uint4*>(
              src + ((q / rw + t / 3) * sw + q % rw + t % 3) * MS + 8 * c8);
    }
  };
  const bf16* const stage_lane[2] = {band + (16 * warp + la) * SS + lk, nullptr};
  const auto stage_off = [](int s) { return 16 * s; };

  for (int k = 0; k < n; ++k) {
    tile_at(k, bi, r0, c0);
    bar_sync(bar0 + XFULL, S::GT);

    // G1 on R1: m1 = mish(round(mish(x)) . w1 + b1), masked.  The A rows
    // of a last, partial m16 tile (of R1 here, of R2 in G2) are read past
    // the region, in the group's own shared memory, and their sums are
    // not stored; K2 clamps them, which costs the registers that the bf16
    // mish variants need to run without spilling.
    for (int mt = warp; mt < S::M1; mt += 2 * S::NCW) {
      const bool two = mt + S::NCW < S::M1;
      const bf16* a_lane[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) a_lane[u] = band + (16 * (mt + u * S::NCW) + la) * XS + lk;
      float acc[2][4][4];
      gemm32<true, CIO / 16>(acc, a_lane, two, w1s, [](int s) { return 16 * s; }, lane,
                             M0<FAST>());
      to_m(acc[0], mt, S::N1, S::W1, 2, bs, m1s);
      if (two) to_m(acc[1], mt + S::NCW, S::N1, S::W1, 2, bs, m1s);
    }
    bar_sync(bar0 + CONS, S::GC);
    if (!IM2COL && k + 1 < n) bar_arrive(bar0 + BFREE, S::GT);   // the band is read

    // G2 on R2: m2 = mish(conv3x3(m1) + b2), masked
    if constexpr (IM2COL) {
      for (int q0 = 0; q0 < S::N2; q0 += S::P) {
        im2col(m1s, S::W1, S::W2, q0, S::N2);
        bar_sync(bar0 + CONS, S::GC);
        const int mt = q0 / 16 + warp;
        if (warp < S::P / 16 && mt < S::M2) {
          float acc[2][4][4];
          gemm32_n<false, 18, 1>(acc, stage_lane, w2s, stage_off, lane);
          to_m(acc[0], mt, S::N2, S::W2, 1, bs + CM, m2s);
        }
        bar_sync(bar0 + CONS, S::GC);   // the stage is free; m2 complete
      }
    } else {
      for (int mt = warp; mt < S::M2; mt += 2 * S::NCW) {
        const bool two = mt + S::NCW < S::M2;
        const bf16* a_lane[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = 16 * (mt + u * S::NCW) + la;
          a_lane[u] = m1s + ((q / S::W2) * S::W1 + q % S::W2) * MS + lk;
        }
        float acc[2][4][4];
        // step s: tap s / 2 = (ky, kx), channels 16 (s % 2) on
        gemm32<false, 18>(acc, a_lane, two, w2s, [](int s) {
          const int t = s >> 1;
          return ((t / 3) * S::W1 + t % 3) * MS + 16 * (s & 1);
        }, lane);
        to_m(acc[0], mt, S::N2, S::W2, 1, bs + CM, m2s);
        if (two) to_m(acc[1], mt + S::NCW, S::N2, S::W2, 1, bs + CM, m2s);
      }
      bar_sync(bar0 + CONS, S::GC);
    }

    // G3 on the tile (m16 tile = tile row) and G4
    if constexpr (IM2COL) {
      for (int p0 = 0; p0 < S::N3; p0 += S::P) {
        im2col(m2s, S::W2, TW, p0, S::N3);
        bar_sync(bar0 + CONS, S::GC);
        const int row = p0 / 16 + warp;
        if (warp < S::P / 16 && row < S::M3) {
          float acc[2][4][4];
          gemm32_n<false, 18, 1>(acc, stage_lane, w3s, stage_off, lane);
          g34(acc[0], row);
        }
        bar_sync(bar0 + CONS, S::GC);
      }
      if (k + 1 < n) bar_arrive(bar0 + BFREE, S::GT);   // the stage (band) is free
    } else {
      const bf16* a_lane[2] = {m2s + (warp * S::W2 + la) * MS + lk, nullptr};
      float acc[2][4][4];
      gemm32_n<false, 18, 1>(acc, a_lane, w3s, [](int s) {
        const int t = s >> 1;
        return ((t / 3) * S::W2 + t % 3) * MS + 16 * (s & 1);
      }, lane);
      g34(acc[0], warp);
    }
    bar_arrive(bar0 + YFULL, S::GT);
  }
}

template <int MASK, bool IM2COL, bool FAST, int TH>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* w4,
           const void* b4, void* y, int B, int H, int W, cudaStream_t stream) {
  using S = Plan<TH>;
  auto kernel = probe_convres_kernel<MASK, IM2COL, FAST, TH>;
  static int sms = 0;   // one block an SM
  if (sms == 0) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 S::SMEM);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const long long ntiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // as many blocks as SMs, never more than there are tiles for their groups
  const long long need = (ntiles + S::GROUPS - 1) / S::GROUPS;
  const int grid = (int)(need < sms ? need : sms);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)w4,
      (const float*)b4, (bf16*)y, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 base, 1 rowmask, 2 nomask, 3 ninedot, 4 bf16mish, 5 tile2x,
// 6 kitchen (nomask + ninedot + bf16mish + tile2x).  x, y (B, H, W, 64)
// bf16, 16-byte aligned; w1 (64, 32), w2, w3 (3, 3, 32, 32), w4 (32, 64)
// bf16; b1, b2, b3 (32) and b4 (64) f32.
int probe_convres(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* w3, const void* b3, const void* w4,
                  const void* b4, void* y, int B, int H, int W, int variant,
                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || (long long)H * W * CIO >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x & 15) || ((uintptr_t)y & 15)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
#define DDDPM_PROBE_CONVRES(MASK, IM2COL, FAST, TH) \
  launch<MASK, IM2COL, FAST, TH>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W, s)
  switch (variant) {
    case 0: return DDDPM_PROBE_CONVRES(MASK_ELEM, true, false, 8);
    case 1: return DDDPM_PROBE_CONVRES(MASK_ROW, true, false, 8);
    case 2: return DDDPM_PROBE_CONVRES(MASK_NONE, true, false, 8);
    case 3: return DDDPM_PROBE_CONVRES(MASK_ROW, false, false, 8);
    case 4: return DDDPM_PROBE_CONVRES(MASK_ROW, true, true, 8);
    case 5: return DDDPM_PROBE_CONVRES(MASK_ROW, true, false, 16);
    case 6: return DDDPM_PROBE_CONVRES(MASK_NONE, false, true, 16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DDDPM_PROBE_CONVRES
}

}  // extern "C"
