// Attention-pass ceiling probe for Hopper (sm_90a): the pass-A and
// pass-B variants of the fused attention block, G samples a block.
//
// Replaces the TPU kernels of scripts/probe_attention_ceiling.py:
//   _ctx_kernel_var (:52, pallas_call :101) -> probe_ctx_kernel, then
//                                              probe_ctx_reduce
//   _out_kernel_var (:131, pallas_call :155) -> probe_out_kernel
//
// What it computes, on x (B, N, C) bf16 with hidden = 128:
//   pass A  ln = LN(x) (full, noexp) or x (noln, payload), LN in the
//              E[x^2] - E[x]^2 form of _layer_norm_mxu, rounded to bf16
//           kv = ln @ wkv (C x 256, f32 sums); k | v its halves
//           p  = exp(min(k, 60)) (full, noln), min(k, 60) (noexp), k
//              (payload)
//           s  = sum over tokens of p (not payload: s stays 0)
//           A  = p^T v over tokens, the FULL 128 x 128 product (the
//              probe has no head mask, unlike K1a), bf16 operands
//           ctx = A / max(s, 1), s indexed by A's row     (B, 128, 128)
//           dma: reads every byte of x and writes ctx = 0
//   pass B  y = x + ln @ weff[b] + b_out (full: ln = LN(x); noln: x)
//           dma: y = x
//
// What bounds it on an H100: at the probe's default (B = 96, 128^2
// tokens, C = 128) pass A reads 402.7 MB (0.120 ms at 3.35 TB/s) and
// does 154.6 GFLOP of products (0.156 ms at the bf16 peak): the
// operations, narrowly.  Pass B moves 805 MB (0.240 ms) for 51.5 GFLOP:
// the bytes.
//
// What this design does about it: the products run on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 sums), as the shipped K1a / K1b
// do (csrc/attention_block.cu), so each variant's time reads against
// theirs.  The grid stays (N / tn, B / G) with the probe's own tn, since
// G is what the probe measures; a block walks its G samples' token tiles
// as one stream of TS = 64-token sub-tiles, which a two-stage cp.async
// ring (load_sub) brings into shared memory one sub-tile ahead of the
// work, across the samples' boundaries.
//  * The LN's row sums (of x and of x^2) are mma.sync products with a
//    fragment of ones, as _layer_norm_mxu takes them on the TPU's MXU
//    (dot(x, ones)): a warp gets its rows' sums in the accumulator layout
//    at one mma a 16 x 16 block, where elementwise sums took ~6
//    instructions an element; the squares are bf16x2 products (at C <=
//    128 each rounded to bf16, as the probe's are) or, above, exact as a
//    bf16 pair hi + lo.
//  * Pass A: sixteen warps a block (one block an SM), so that the exps,
//    which run between block barriers, have four warps a scheduler.
//    W_kv stays in shared memory as bf16 for the block's life.  A
//    sub-tile is normalised in place: warp w sums the ksteps kq, kq + 4,
//    .. (kq = w / 4) of m16 tile w % 4, the four partial sums are added
//    in order through shared memory, and the warp normalises its
//    fragments (ldmatrix, rounded to bf16 once, stmatrix back).  kv = ln
//    @ W_kv, warp (r, c) = (w / 8, w % 8) forming rows 32 r .. 32 r + 31
//    of k's columns 16 c .. 16 c + 15 and of v's (128 + 16 c ..), so
//    every warp takes the same share of the exps; p = exp(min(k, 60)) and
//    s from the accumulator fragments; p | v written as bf16 over the
//    sub-tile once every warp has read it; then A += p^T v as a second
//    mma.sync product, p read transposed by ldmatrix.trans.  The full 128
//    x 128 A stays in registers across a tile's sub-tiles, one copy a
//    block: warp w owns its 32 x 32 slab (rows 32 (w / 4) .., columns 32
//    (w % 4) ..), 32 f32 a thread, and writes it as the partial of its
//    (sample, token tile); s is added over the two row halves in a fixed
//    order; probe_ctx_reduce sums the partials in tile order (no
//    atomics: runs repeat bit for bit).
//  * Pass B: eight warps a block (two blocks an SM at C = 128).  W_eff[b]
//    stays in shared memory as bf16 while the block's sub-tiles are of
//    sample b.  Each warp takes its rows' sums itself, then y = LN(x) @
//    W_eff[b] on mma.sync with LN applied to the A fragments of the raw x
//    as they load (warp w: rows 16 (w / 2) .., the (w % 2)-th half of the
//    columns), x and b_out are added in the epilogue over x in the
//    sub-tile, and y leaves from there as 16-byte rows (store_sub).
//  * The dma variants run the same ring with the full variants' threads
//    and shared memory (so the same blocks an SM): pass A folds every
//    16-byte word of each landed sub-tile into an XOR that it stores, so
//    no load can be dropped; pass B stores each landed sub-tile through
//    store_sub.  The floor is this design's own.
// The variant, G and pass B's width are template parameters, so a
// variant's removed work is gone from its code, not branched around.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // cp_async16, ldmatrix_x4(_trans), mma_bf16

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HIDDEN = 128;       // width of k and of v
constexpr int KV = 2 * HIDDEN;    // width of [Wk | Wv]
constexpr int TS = 64;            // tokens a sub-tile
constexpr int LDA = KV + 8;       // bf16 a row of W_kv and of a pass-A sub-tile (528 bytes)
constexpr int CTX_THREADS = 512;  // pass A: sixteen warps
constexpr int THREADS = 256;      // pass B and the reduce: eight warps
constexpr float K_CLAMP = 60.0f;
constexpr float LN_EPS = 1e-5f;

// pass-A variants, then pass-B variants (the Python wrapper's order)
enum { A_FULL = 0, A_NOEXP = 1, A_NOLN = 2, A_PAYLOAD = 3, A_DMA = 4 };
enum { B_FULL = 0, B_NOLN = 1, B_DMA = 2 };

// The sub-tile of `rows` tokens at src (row stride C) into dst (row
// stride ld) by 16-byte cp.async: TS rows, zero past rows, by the
// block's threads.  The caller commits and waits.  Every load of x, in
// every variant of both passes.
__device__ __forceinline__ void load_sub(bf16* dst, int ld, const bf16* src, int rows,
                                         int C) {
  const int per = C / 8;   // 16-byte words a row
  for (int i = threadIdx.x; i < TS * per; i += blockDim.x) {
    const int r = i / per, c = i - r * per;
    const bool ok = r < rows;
    cp_async16(dst + r * ld + 8 * c, ok ? src + (size_t)r * C + 8 * c : src, ok);
  }
}

// The rows x C block at src (row stride C) into dst (row stride ld) by
// 16-byte cp.async, by the block's threads; the caller commits and waits.
__device__ __forceinline__ void load_weights(bf16* dst, int ld, const bf16* src,
                                             int rows, int C) {
  const int per = C / 8;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = i - r * per;
    cp_async16(dst + r * ld + 8 * c, src + (size_t)r * C + 8 * c, true);
  }
}

// Rows < rows of the sub-tile at src (row stride ld) to dst (row stride
// C) as 16-byte words, by the block's threads.
__device__ __forceinline__ void store_sub(bf16* dst, const bf16* src, int ld, int rows,
                                          int C) {
  const int per = C / 8;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = i - r * per;
    *reinterpret_cast<uint4*>(dst + (size_t)r * C + 8 * c) =
        *reinterpret_cast<const uint4*>(src + r * ld + 8 * c);
  }
}

// Row sums of x and of x^2 over the ksteps ks0, ks0 + kstride, .. <
// ksteps of the m16 tile at A (row-major bf16, lda), added to s1 and s2
// (accumulator layout: registers 0, 1 of row grp, 2, 3 of row grp + 8,
// each the whole sum) on mma.sync with B all ones.  The squares: bf16x2
// products, each x^2 rounded to bf16 (the probe's at C <= 128), or with
// EXACT also the remainder x^2 - bf16(x^2), exact in bf16, so that hi +
// lo sums x^2 itself (the probe's f32 squares above 128).
template <bool EXACT>
__device__ __forceinline__ void frag_sums(const bf16* A, int lda, int ks0, int ksteps,
                                          int kstride, float (&s1)[4], float (&s2)[4]) {
  const int lane = threadIdx.x % 32, j8 = lane >> 3, r8 = lane & 7;
  constexpr unsigned ONES = 0x3F803F80u;   // bf16x2 (1, 1)
  for (int ks = ks0; ks < ksteps; ks += kstride) {
    unsigned a[4], hi[4];
    ldmatrix_x4(a, A + ((j8 & 1) * 8 + r8) * lda + 16 * ks + (j8 >> 1) * 8);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[r]);
      const __nv_bfloat162 h = __hmul2(v, v);
      hi[r] = *reinterpret_cast<const unsigned*>(&h);
    }
    mma_bf16(s1, a, ONES, ONES);
    mma_bf16(s2, hi, ONES, ONES);
    if constexpr (EXACT) {
      unsigned lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[r]);
        const __nv_bfloat162 l =
            __hfma2(v, v, __hneg2(*reinterpret_cast<const __nv_bfloat162*>(&hi[r])));
        lo[r] = *reinterpret_cast<const unsigned*>(&l);
      }
      mma_bf16(s2, lo, ONES, ONES);
    }
  }
}

// (mean, 1 / (std + eps)) of a row from its sums over C channels (ic = 1
// / C), the variance as _layer_norm_mxu takes it: max(E[x^2] - E[x]^2, 0)
__device__ __forceinline__ float2 ln_stats(float s1, float s2, float ic) {
  const float m = s1 * ic;
  return make_float2(m, __frcp_rn(__fsqrt_rn(fmaxf(s2 * ic - m * m, 0.f)) + LN_EPS));
}

// Pass A's LN, part 1: warp w's partial row sums of the sub-tile at sub
// (m16 tile w % 4, ksteps w / 4, w / 4 + 4, ..) into part (4 x TS x 2:
// by kstep class, row, x or x^2).
__device__ __forceinline__ void ln_partials(const bf16* sub, int C, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp & 3, kq = warp >> 2;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if (C <= 128)
    frag_sums<false>(sub + 16 * mt * LDA, LDA, kq, C / 16, 4, s1, s2);
  else
    frag_sums<true>(sub + 16 * mt * LDA, LDA, kq, C / 16, 4, s1, s2);
  if ((lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (kq * TS + 16 * mt + (lane >> 2) + 8 * h) * 2) =
          make_float2(s1[2 * h], s2[2 * h]);
}

// LN of an A fragment of raw x in place: rows grp and grp + 8 of its m16
// tile (mean m, 1 / (std + eps) ri), columns k, k + 1 (registers 0, 1)
// and k + 8, k + 9 (2, 3); g, b indexed by column.  Rounded to bf16 once.
__device__ __forceinline__ void ln_frag(unsigned (&a)[4], const float (&m)[2],
                                        const float (&ri)[2], const float* g,
                                        const float* b, int k) {
  const float2 g0 = *reinterpret_cast<const float2*>(g + k);
  const float2 g1 = *reinterpret_cast<const float2*>(g + k + 8);
  const float2 b0 = *reinterpret_cast<const float2*>(b + k);
  const float2 b1 = *reinterpret_cast<const float2*>(b + k + 8);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int h = q & 1;
    const float2 gg = q < 2 ? g0 : g1, bb = q < 2 ? b0 : b1;
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[q]));
    const __nv_bfloat162 o = __floats2bfloat162_rn((v.x - m[h]) * ri[h] * gg.x + bb.x,
                                                   (v.y - m[h]) * ri[h] * gg.y + bb.y);
    a[q] = *reinterpret_cast<const unsigned*>(&o);
  }
}

// Pass A's LN, part 2, after part 1's barrier: warp w adds its rows'
// four partial sums in order and normalises its fragments of the
// sub-tile at sub in place (ldmatrix, ln_frag, stmatrix).
__device__ __forceinline__ void ln_apply(bf16* sub, int C, const float* part,
                                         const float* gs, const float* bs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp & 3, kq = warp >> 2, j8 = lane >> 3, r8 = lane & 7;
  const float ic = 1.f / C;
  float m[2], ri[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * mt + (lane >> 2) + 8 * h;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(part + (k * TS + row) * 2);
      s1 += v.x;
      s2 += v.y;
    }
    const float2 st = ln_stats(s1, s2, ic);
    m[h] = st.x;
    ri[h] = st.y;
  }
  for (int ks = kq; ks < C / 16; ks += 4) {
    bf16* at = sub + (16 * mt + (j8 & 1) * 8 + r8) * LDA + 16 * ks + (j8 >> 1) * 8;
    unsigned a[4];
    ldmatrix_x4(a, at);
    ln_frag(a, m, ri, gs, bs, 16 * ks + 2 * (lane & 3));
    stmatrix_x4(at, a);
  }
}

// acc[i][j] += A[16 i .. 16 i + 15][k] * B[k][8 j .. 8 j + 7] over k < 16
// ksteps on mma.sync, i < MI, j < NJ (even).  A: row-major bf16 (lda)
// from the warp's first row; B: [k][n] bf16 (ldb), its n8 tiles j from
// Bm + 8 j on or, when SPLIT, those j >= NJ / 2 from Bm2 + 8 (j - NJ / 2)
// on.  LNF (MI = 1): A holds raw x, and ln_frag normalises each fragment
// as it loads (m, ri of the two rows the lane holds; g, b by A's column).
template <int MI, int NJ, bool LNF, bool SPLIT>
__device__ __forceinline__ void mma_rows(float (&acc)[MI][NJ][4], const bf16* A,
                                         int lda, const bf16* Bm, const bf16* Bm2,
                                         int ldb, int ksteps, const float (&m)[2],
                                         const float (&ri)[2], const float* g,
                                         const float* b) {
  const int lane = threadIdx.x % 32, j8 = lane >> 3, r8 = lane & 7;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 16;
    unsigned a[MI][4], bq[NJ / 2][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      ldmatrix_x4(a[i], A + (16 * i + (j8 & 1) * 8 + r8) * lda + k0 + (j8 >> 1) * 8);
      if constexpr (LNF) ln_frag(a[i], m, ri, g, b, k0 + 2 * (lane & 3));
    }
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j) {
      const bf16* bp = SPLIT && 4 * j >= NJ ? Bm2 + 16 * j - 4 * NJ : Bm + 16 * j;
      ldmatrix_x4_trans(bq[j], bp + (k0 + (j8 & 1) * 8 + r8) * ldb + (j8 >> 1) * 8);
    }
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j)
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(acc[i][2 * j], a[i], bq[j][0], bq[j][1]);
        mma_bf16(acc[i][2 * j + 1], a[i], bq[j][2], bq[j][3]);
      }
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// Pass A's shared memory, in bytes: the ring (2 x TS x LDA: x, LN(x) in
// place, then p | v), W_kv (C x LDA), g and b (C each), the LN's partial
// sums (4 x TS x 2), the second row half's s (HIDDEN; the dma's XOR
// reduce, a word a warp, there too).
__host__ __device__ constexpr int ctx_smem(int C) {
  return (2 * TS + C) * LDA * 2 + (2 * C + 8 * TS + HIDDEN) * 4;
}

// Pass A: grid (nt, B / G), CTX_THREADS threads; block (j, q) takes token
// tile j of samples q*G .. q*G+G-1, as a stream of G * ceil(tn / TS)
// sub-tiles.  Partials: part_a (B, nt, 128, 128), part_s (B, nt, 128);
// dma: part_s only, its first entry of each slot the XOR of the slot's
// words as a tiny finite float (exponent bits cleared), the other 127
// zero.
template <int V, int G>
__global__ void __launch_bounds__(CTX_THREADS, 1)
probe_ctx_kernel(const bf16* x, const float* g, const float* b, const bf16* wkv,
                 float* part_a, float* part_s, int N, int C, int tn) {
  constexpr bool LN = V == A_FULL || V == A_NOEXP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);           // 2 x TS x LDA
  bf16* w = ring + 2 * TS * LDA;                            // C x LDA
  float* gs = reinterpret_cast<float*>(w + C * LDA);        // C
  float* bs = gs + C;                                       // C
  float* part = bs + C;                                     // 4 x TS x 2
  float* red = part + 8 * TS;                               // HIDDEN
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3, j8 = lane >> 3, r8 = lane & 7;
  const int kr = warp >> 3, kc = warp & 7;                   // kv: rows 32 kr, columns 16 kc
  const int h0 = 32 * (warp >> 2), e0 = 32 * (warp & 3);    // this warp's slab of A
  const int j = blockIdx.x, nt = gridDim.x;
  const int nsub = (tn + TS - 1) / TS, nq = G * nsub;
  auto stage = [&](int q) { return ring + (q & 1) * TS * LDA; };
  // sub-tile q of the block's stream: u = q % nsub of sample q / nsub
  auto x_at = [&](int q) {
    const int gi = q / nsub, u = q - gi * nsub;
    return x + ((size_t)(blockIdx.y * G + gi) * N + (size_t)j * tn + (size_t)u * TS) * C;
  };
  auto rows_at = [&](int q) { return min(TS, tn - (q % nsub) * TS); };

  if constexpr (V != A_DMA) {   // W_kv, g, b for the block's life
    load_weights(w, LDA, wkv, C, KV);
    for (int i = threadIdx.x; i < C; i += CTX_THREADS) {
      gs[i] = g[i];
      bs[i] = b[i];
    }
  }
  load_sub(stage(0), LDA, x_at(0), rows_at(0), C);
  cp_async_commit();

  float acc_a[2][4][4], s_run[2][2];
  zero(acc_a);
#pragma unroll
  for (int t = 0; t < 2; ++t) s_run[t][0] = s_run[t][1] = 0.f;
  uint32_t hx = 0u;
  const float nom[2] = {0.f, 0.f};

  for (int q = 0; q < nq; ++q) {
    const int gi = q / nsub, u = q - gi * nsub, rows = rows_at(q);
    bf16* cur = stage(q);
    cp_async_wait_all();
    __syncthreads();   // sub-tile q landed; q - 1's work on the other stage done
    if (q + 1 < nq) load_sub(stage(q + 1), LDA, x_at(q + 1), rows_at(q + 1), C);
    cp_async_commit();
    if constexpr (V == A_DMA) {
      const int per = C / 8;
      for (int i = threadIdx.x; i < rows * per; i += CTX_THREADS) {
        const int r = i / per, c = i - r * per;
        const uint4 v = *reinterpret_cast<const uint4*>(cur + r * LDA + 8 * c);
        hx ^= v.x ^ v.y ^ v.z ^ v.w;
      }
    } else {
      if constexpr (LN) {
        ln_partials(cur, C, part);
        __syncthreads();   // the partial sums written
        ln_apply(cur, C, part, gs, bs);
        __syncthreads();   // the sub-tile normalised
      }
      // kv: n8 tiles 0, 1 of k (columns 16 kc ..), 2, 3 of v (128 + 16 kc ..)
      float acc[2][4][4];
      zero(acc);
      mma_rows<2, 4, false, true>(acc, cur + 32 * kr * LDA, LDA, w + 16 * kc,
                                  w + HIDDEN + 16 * kc, LDA, C / 16, nom, nom, gs, bs);
      __syncthreads();   // every warp has read the sub-tile: p | v overwrite it
      // p and s (k's tiles), v (v's tiles), rounded to bf16 over the
      // sub-tile; rows past `rows` 0
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 32 * kr + 16 * i + grp + 8 * h;
          const bool ok = row < rows;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float v0 = acc[i][t][2 * h], v1 = acc[i][t][2 * h + 1];
            if (t < 2 && V != A_PAYLOAD) {
              if (V == A_NOEXP) {
                v0 = fminf(v0, K_CLAMP);
                v1 = fminf(v1, K_CLAMP);
              } else {
                v0 = __expf(fminf(v0, K_CLAMP));
                v1 = __expf(fminf(v1, K_CLAMP));
              }
              if (ok) {
                s_run[t & 1][0] += v0;
                s_run[t & 1][1] += v1;
              }
            }
            if (!ok) v0 = v1 = 0.f;
            const int col = (t < 2 ? 0 : HIDDEN) + 16 * kc + 8 * (t & 1) + 2 * tig;
            *reinterpret_cast<__nv_bfloat162*>(cur + row * LDA + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      __syncthreads();   // p | v written
      // A += p^T v over the sub-tile's 64 tokens (rows past `rows` 0): p^T
      // read transposed (rows of A: p's columns h0 ..), v (columns of A:
      // 128 + e0 ..)
#pragma unroll
      for (int ks = 0; ks < TS / 16; ++ks) {
        const bf16* pt = cur + 16 * ks * LDA;
        unsigned a[2][4], bq[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4_trans(a[i], pt + ((j8 >> 1) * 8 + r8) * LDA + h0 + 16 * i +
                                      (j8 & 1) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          ldmatrix_x4_trans(bq[n], pt + ((j8 & 1) * 8 + r8) * LDA + HIDDEN + e0 +
                                       16 * n + (j8 >> 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc_a[i][2 * n], a[i], bq[n][0], bq[n][1]);
            mma_bf16(acc_a[i][2 * n + 1], a[i], bq[n][2], bq[n][3]);
          }
      }
    }
    if (u == nsub - 1) {   // the tile's partials, then the next tile's sums from 0
      const size_t slot = (size_t)(blockIdx.y * G + gi) * nt + j;
      float* ps = part_s + slot * HIDDEN;
      if constexpr (V == A_DMA) {
        uint32_t* hw = reinterpret_cast<uint32_t*>(red);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) hx ^= __shfl_xor_sync(0xffffffffu, hx, o);
        if (lane == 0) hw[warp] = hx;
        __syncthreads();
        if (threadIdx.x < HIDDEN) {
          float v = 0.f;
          if (threadIdx.x == 0) {
            uint32_t all = 0u;
            for (int k = 0; k < CTX_THREADS / 32; ++k) all ^= hw[k];
            v = __uint_as_float(all & 0x007fffffu);
          }
          ps[threadIdx.x] = v;
        }
        hx = 0u;
      } else {
        float* pa = part_a + slot * HIDDEN * HIDDEN;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(pa + (h0 + 16 * i + grp + 8 * h) * HIDDEN + e0 +
                                         8 * n + 2 * tig) =
                  make_float2(acc_a[i][n][2 * h], acc_a[i][n][2 * h + 1]);
        zero(acc_a);
        // s of k's columns 16 kc ..: over a column's lanes, then the
        // second row half's (kr = 1) added to the first's, in that order
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = s_run[t][c];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            s_run[t][c] = v;
          }
        const int col = 16 * kc + 2 * tig;
        if (kr == 1 && grp == 0)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int c = 0; c < 2; ++c) red[col + 8 * t + c] = s_run[t][c];
        __syncthreads();
        if (kr == 0 && grp == 0)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              ps[col + 8 * t + c] = s_run[t][c] + red[col + 8 * t + c];
#pragma unroll
        for (int t = 0; t < 2; ++t) s_run[t][0] = s_run[t][1] = 0.f;
      }
    }
  }
  cp_async_wait_all();   // no copy in flight at exit
}

// Pass A's reduce: grid (128*128 / THREADS, B), one output a thread:
// ctx = (sum_j A_j) / max(sum_j s_j, 1), j in tile order; A = 0 when
// has_a is 0 (the dma variant writes no A partials).
__global__ void __launch_bounds__(THREADS)
probe_ctx_reduce(const float* part_a, const float* part_s, float* ctx, int nt,
                 int has_a) {
  const int bi = blockIdx.y;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  const int r = idx / HIDDEN;
  float a = 0.f, s = 0.f;
  for (int j = 0; j < nt; ++j) {
    const size_t slot = (size_t)bi * nt + j;
    s += part_s[slot * HIDDEN + r];
    if (has_a) a += part_a[slot * HIDDEN * HIDDEN + idx];
  }
  ctx[(size_t)bi * HIDDEN * HIDDEN + idx] = a / fmaxf(s, 1.f);
}

// Pass B's shared memory at C = 16 NT, in bytes: the ring (2 x TS x (C +
// 8): x, then y in place), W_eff[b] (C x (C + 8)), g, b and b_out (C
// each).
__host__ __device__ constexpr int out_smem(int C) {
  return (2 * TS + C) * (C + 8) * 2 + 3 * C * 4;
}

// Pass B: grid (nt, B / G), THREADS threads, as pass A; C = 16 NT, warp
// w forming rows 16 (w / 2) .. of a sub-tile and the (w % 2)-th half of
// its C columns (NT n8 tiles).
template <int V, int G, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 8 ? 2 : 1)
probe_out_kernel(const bf16* x, const float* g, const float* b, const bf16* weff,
                 const float* b_out, bf16* y, int N, int tn) {
  constexpr int C = 16 * NT, LDX = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);           // 2 x TS x LDX
  bf16* w = ring + 2 * TS * LDX;                            // C x LDX
  float* gs = reinterpret_cast<float*>(w + C * LDX);        // C
  float* bs = gs + C;                                       // C
  float* bos = bs + C;                                      // C
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int j = blockIdx.x;
  const int nsub = (tn + TS - 1) / TS, nq = G * nsub;
  auto stage = [&](int q) { return ring + (q & 1) * TS * LDX; };
  auto base_at = [&](int q) {   // offset of sub-tile q of the block's stream
    const int gi = q / nsub, u = q - gi * nsub;
    return ((size_t)(blockIdx.y * G + gi) * N + (size_t)j * tn + (size_t)u * TS) * C;
  };
  auto rows_at = [&](int q) { return min(TS, tn - (q % nsub) * TS); };

  if constexpr (V != B_DMA) {
    for (int i = threadIdx.x; i < C; i += THREADS) {
      gs[i] = g[i];
      bs[i] = b[i];
      bos[i] = b_out[i];
    }
    load_weights(w, LDX, weff + (size_t)blockIdx.y * G * C * C, C, C);
  }
  load_sub(stage(0), LDX, x + base_at(0), rows_at(0), C);
  cp_async_commit();

  for (int q = 0; q < nq; ++q) {
    const int gi = q / nsub, u = q - gi * nsub, rows = rows_at(q);
    const size_t base = base_at(q);
    bf16* cur = stage(q);
    cp_async_wait_all();
    __syncthreads();   // sub-tile q landed; q - 1's work on the other stage done
    if (V != B_DMA && u == 0 && q > 0) {   // the next sample's W_eff
      load_weights(w, LDX, weff + (size_t)(blockIdx.y * G + gi) * C * C, C, C);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    if (q + 1 < nq) load_sub(stage(q + 1), LDX, x + base_at(q + 1), rows_at(q + 1), C);
    cp_async_commit();
    if constexpr (V != B_DMA) {
      float m[2] = {0.f, 0.f}, ri[2] = {0.f, 0.f};
      if constexpr (V == B_FULL) {   // the warp's rows' sums, then their statistics
        float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
        frag_sums<(C > 128)>(cur + 16 * wm * LDX, LDX, 0, C / 16, 1, s1, s2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 st = ln_stats(s1[2 * h], s2[2 * h], 1.f / C);
          m[h] = st.x;
          ri[h] = st.y;
        }
      }
      float acc[1][NT][4];
      zero(acc);
      mma_rows<1, NT, V == B_FULL, false>(acc, cur + 16 * wm * LDX, LDX,
                                          w + wn * (C / 2), nullptr, LDX, C / 16, m, ri,
                                          gs, bs);
      __syncthreads();   // every read of the sub-tile's x done: y overwrites it
      // y = x + (acc + b_out), every load of the pair before its store
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        const int c = wn * (C / 2) + 8 * jj + 2 * tig;
        const float2 bo = *reinterpret_cast<const float2*>(bos + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wm + grp + 8 * h;
          if (r >= rows) continue;
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(cur + r * LDX + c);
          const float2 f = __bfloat1622float2(*e);
          *e = __floats2bfloat162_rn(f.x + (acc[0][jj][2 * h] + bo.x),
                                     f.y + (acc[0][jj][2 * h + 1] + bo.y));
        }
      }
      __syncthreads();   // y formed in the sub-tile
    }
    store_sub(y + base, cur, LDX, rows, C);
  }
  cp_async_wait_all();   // no copy in flight at exit
}

template <int V, int G>
int ctx_launch(const void* x, const void* g, const void* b, const void* wkv,
               void* part_a, void* part_s, int B, int N, int C, int tn,
               cudaStream_t stream) {
  const int smem = ctx_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      probe_ctx_kernel<V, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_ctx_kernel<V, G><<<dim3(N / tn, B / G), CTX_THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)g, (const float*)b, (const bf16*)wkv,
      (float*)part_a, (float*)part_s, N, C, tn);
  return (int)cudaGetLastError();
}

template <int V>
int ctx_launch_g(int G, const void* x, const void* g, const void* b,
                 const void* wkv, void* part_a, void* part_s, int B, int N, int C,
                 int tn, cudaStream_t s) {
  switch (G) {
    case 1: return ctx_launch<V, 1>(x, g, b, wkv, part_a, part_s, B, N, C, tn, s);
    case 4: return ctx_launch<V, 4>(x, g, b, wkv, part_a, part_s, B, N, C, tn, s);
    case 8: return ctx_launch<V, 8>(x, g, b, wkv, part_a, part_s, B, N, C, tn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int V, int G, int NT>
int out_launch(const void* x, const void* g, const void* b, const void* weff,
               const void* b_out, void* y, int B, int N, int tn,
               cudaStream_t stream) {
  const int smem = out_smem(16 * NT);
  cudaError_t err = cudaFuncSetAttribute(
      probe_out_kernel<V, G, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_out_kernel<V, G, NT><<<dim3(N / tn, B / G), THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)g, (const float*)b, (const bf16*)weff,
      (const float*)b_out, (bf16*)y, N, tn);
  return (int)cudaGetLastError();
}

template <int V, int NT>
int out_launch_g(int G, const void* x, const void* g, const void* b,
                 const void* weff, const void* b_out, void* y, int B, int N,
                 int tn, cudaStream_t s) {
  switch (G) {
    case 1: return out_launch<V, 1, NT>(x, g, b, weff, b_out, y, B, N, tn, s);
    case 4: return out_launch<V, 4, NT>(x, g, b, weff, b_out, y, B, N, tn, s);
    case 8: return out_launch<V, 8, NT>(x, g, b, weff, b_out, y, B, N, tn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int V>
int out_launch_gc(int G, int C, const void* x, const void* g, const void* b,
                  const void* weff, const void* b_out, void* y, int B, int N,
                  int tn, cudaStream_t s) {
  switch (C) {
    case 128: return out_launch_g<V, 8>(G, x, g, b, weff, b_out, y, B, N, tn, s);
    case 256: return out_launch_g<V, 16>(G, x, g, b, weff, b_out, y, B, N, tn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int N, int tn, int group) {
  return B < 1 || N < 1 || tn < 1 || N % tn || B % group;
}

}  // namespace

extern "C" {

// Pass A of variant (0 full, 1 noexp, 2 noln, 3 payload, 4 dma) with
// `group` in {1, 4, 8} samples a block and token tiles of tn.  x (B, N,
// C) bf16, C % 32 == 0, C <= 256, N % tn == 0, B % group == 0; g, b (C)
// f32; wkv (C, 256) bf16; x and wkv 16-byte aligned; part_a (B, N/tn,
// 128, 128) and part_s (B, N/tn, 128) f32 scratch; ctx (B, 128, 128) f32.
int probe_attn_ctx(const void* x, const void* g, const void* b, const void* wkv,
                   void* part_a, void* part_s, void* ctx, int B, int N, int C,
                   int tn, int variant, int group, void* stream) {
  if (bad_shape(B, N, tn, group) || C % 32 || C < 32 || C > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (variant) {
    case A_FULL: err = ctx_launch_g<A_FULL>(group, x, g, b, wkv, part_a, part_s, B, N, C, tn, s); break;
    case A_NOEXP: err = ctx_launch_g<A_NOEXP>(group, x, g, b, wkv, part_a, part_s, B, N, C, tn, s); break;
    case A_NOLN: err = ctx_launch_g<A_NOLN>(group, x, g, b, wkv, part_a, part_s, B, N, C, tn, s); break;
    case A_PAYLOAD: err = ctx_launch_g<A_PAYLOAD>(group, x, g, b, wkv, part_a, part_s, B, N, C, tn, s); break;
    case A_DMA: err = ctx_launch_g<A_DMA>(group, x, g, b, wkv, part_a, part_s, B, N, C, tn, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  probe_ctx_reduce<<<dim3(HIDDEN * HIDDEN / THREADS, B), THREADS, 0, s>>>(
      (const float*)part_a, (const float*)part_s, (float*)ctx, N / tn,
      variant != A_DMA);
  return (int)cudaGetLastError();
}

// Pass B of variant (0 full, 1 noln, 2 dma) with `group` in {1, 4, 8}
// and token tiles of tn.  x, y (B, N, C) bf16, C in {128, 256}, y not
// x; weff (B, C, C) bf16; g, b, b_out (C) f32; x, weff and y 16-byte
// aligned.
int probe_attn_out(const void* x, const void* g, const void* b, const void* weff,
                   const void* b_out, void* y, int B, int N, int C, int tn,
                   int variant, int group, void* stream) {
  if (bad_shape(B, N, tn, group)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case B_FULL: return out_launch_gc<B_FULL>(group, C, x, g, b, weff, b_out, y, B, N, tn, s);
    case B_NOLN: return out_launch_gc<B_NOLN>(group, C, x, g, b, weff, b_out, y, B, N, tn, s);
    case B_DMA: return out_launch_gc<B_DMA>(group, C, x, g, b, weff, b_out, y, B, N, tn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
