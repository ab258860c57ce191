// Variants of the fused ConvResBlock forward for Hopper (sm_90a), each
// with one cost removed or changed, to see where the forward's time goes.
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
// The variants are template parameters, each removing or changing, in
// this kernel's own terms, the cost the TPU variant removed:
//   MASK     0 (base): m1 and m2 are computed at out-of-image rows too,
//            then multiplied per element by a 0/1 mask (the probe's
//            per-element iota mask).  1 (rowmask): one predicate a row;
//            out-of-image rows are written as zero and not computed
//            (K2's way).  2 (nomask): computed and kept.
//   IM2COL   true: per chunk of P pixels the 3x3 windows are copied into
//            an im2col tile in shared memory, then one product of depth
//            9 * CM a pixel.  false (ninedot): nine accumulated taps read
//            straight from the m1 or m2 tile (K2's conv3x3_at).
//   FAST     false: mish in f32 with the accurate expf, log1pf and
//            tanhf, rounded to bf16.  true (bf16mish): mish on bf16 data:
//            its input rounded to bf16, softplus, tanh and the product
//            each rounded to bf16, with the approximate transcendentals
//            (__expf, __logf, tanh.approx.f32) whose error bf16 mostly
//            hides.
//   TH       output rows a tile: 8 (K2's) or 16 (tile2x).
//
// What bounds it on an H100: at the probe's default (B = 32, 256^2,
// cio 64) it moves 536.9 MB (0.160 ms at 3.35 TB/s) and does 94.5 GFLOP
// of products (0.096 ms at the bf16 peak): the bytes.
//
// What this design does about it: it is K2's design (csrc/
// convres_fwd.cu), simple and exact, not fast: a block takes TH x 32
// output pixels of one sample; m1 (the tile grown by 2) and m2 (grown by
// 1) live in shared memory, so x is read once plus its halo and y
// written once; one warp a pixel, one lane a mid channel, FMA products in
// f32.  m1 and m2 are kept in bf16 (their values are bf16 already), so
// the 16-row tile and the im2col stage fit beside the f32 weights
// (at most 189 KB).  A 3x3 product reads 8 activations with one 16-byte
// shared load (dot8) and is one of two functions that are not inlined
// (taps9, row9), so every variant runs the same compiled product loop.
// With the loop inlined, ptxas scheduled each instantiation its own way
// (32 or 40 registers), and that moved a variant's time by up to ~36%
// either way on the H100, more than the cost the variant removes.
//
// C interface: a plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CIO = 64;             // in/out channels
constexpr int CM = 32;              // mid channels: one warp lane each
constexpr int NI = CIO / 32;        // in/out channels per lane
constexpr int K9 = 9 * CM;          // depth of a 3x3 product
constexpr int TW = 32;              // output columns a tile
constexpr int P = 32;               // pixels of one im2col chunk
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
enum { MASK_ELEM = 0, MASK_ROW = 1, MASK_NONE = 2 };

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rnd(float v) {   // round to bf16 and back
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float mish_f32(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // softplus
  return x * tanhf(sp);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// mish on bf16 data, each step rounded to bf16 as bf16 tensor arithmetic
// rounds it
__device__ __forceinline__ float mish_bf16(float x) {
  const float v = rnd(x);
  const float sp = rnd(fmaxf(v, 0.f) + __logf(1.f + __expf(-fabsf(v))));
  return rnd(v * rnd(tanh_approx(sp)));
}

template <bool FAST>
__device__ __forceinline__ float mish_c(float x) {
  return FAST ? mish_bf16(x) : rnd(mish_f32(x));
}

// acc + sum_j a[j] * w[j * CM] over the 8 bf16 values of one 16-byte
// word a, in order (element 2i is the low half of 32-bit word i)
__device__ __forceinline__ float dot8(uint4 a, const float* w, float acc) {
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(u[i] << 16), w[(2 * i) * CM], acc);
    acc = fmaf(__uint_as_float(u[i] & 0xffff0000u), w[(2 * i + 1) * CM], acc);
  }
  return acc;
}

// The two forms of a 3x3 product for output channel `lane` (w points at
// that lane's column): nine taps of a window whose rows are sw pixels
// apart (src its top-left), or one im2col row a.  Not inlined, so every
// variant runs the same compiled product loop.
__device__ __noinline__ float taps9(const bf16* src, int sw, const float* w) {
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const uint4* s = reinterpret_cast<const uint4*>(src + ((t / 3) * sw + t % 3) * CM);
#pragma unroll
    for (int c8 = 0; c8 < CM / 8; ++c8) acc = dot8(s[c8], w + (t * CM + 8 * c8) * CM, acc);
  }
  return acc;
}

__device__ __noinline__ float row9(const bf16* a, const float* w) {
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  float acc = 0.f;
#pragma unroll 4
  for (int k8 = 0; k8 < K9 / 8; ++k8) acc = dot8(a4[k8], w + 8 * k8 * CM, acc);
  return acc;
}

// For each pixel p < n of a region rw wide, at (pr, pc) = (p / rw, p %
// rw): when want(pr, pc), acc = the 3x3 product for output channel
// `lane` of src (CM channels, bf16, rows sw wide) over the window whose
// top-left is (pr, pc), with w (K9 x CM, f32, rows (ky, kx, ci)); then
// epi(p, pr, pc, want, acc).  Both callbacks are uniform over a warp.
// Both forms read the activations 8 at a time (16-byte shared loads)
// through the same dot8, so they differ only in the staging.
template <bool IM2COL, typename Want, typename Epi>
__device__ __forceinline__ void conv_region(const bf16* src, int sw, int n, int rw,
                                            const float* w, bf16* im, Want want,
                                            Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (!IM2COL) {
    for (int p = warp; p < n; p += NWARPS) {
      const int pr = p / rw, pc = p % rw;
      const bool on = want(pr, pc);
      const float acc = on ? taps9(src + (pr * sw + pc) * CM, sw, w + lane) : 0.f;
      epi(p, pr, pc, on, acc);
    }
  } else {
    constexpr int WORDS = CM / 2;   // bf16 pairs a pixel
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* im32 = reinterpret_cast<uint32_t*>(im);
    for (int p0 = 0; p0 < n; p0 += P) {
      __syncthreads();   // im free
      for (int i = threadIdx.x; i < P * 9 * WORDS; i += THREADS) {
        const int q = i / (9 * WORDS), k = i % (9 * WORDS);
        const int t = k / WORDS, c2 = k % WORDS, p = p0 + q;
        uint32_t v = 0u;
        if (p < n)
          v = s32[((p / rw + t / 3) * sw + p % rw + t % 3) * WORDS + c2];
        im32[i] = v;
      }
      __syncthreads();
      for (int q = warp; q < P && p0 + q < n; q += NWARPS) {
        const int p = p0 + q, pr = p / rw, pc = p % rw;
        const bool on = want(pr, pc);
        const float acc = on ? row9(im + q * K9, w + lane) : 0.f;
        epi(p, pr, pc, on, acc);
      }
    }
  }
}

template <int TH, bool IM2COL>
constexpr int smem_bytes() {
  return (2 * CIO * CM + 2 * K9 * CM) * (int)sizeof(float) +
         ((TH + 4) * (TW + 4) + (TH + 2) * (TW + 2) + (IM2COL ? P * 9 : 0)) * CM *
             (int)sizeof(bf16);
}

template <int MASK, bool IM2COL, bool FAST, int TH>
__global__ void __launch_bounds__(THREADS)
probe_convres_kernel(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                     const float* b2, const bf16* w3, const float* b3, const bf16* w4,
                     const float* b4, bf16* y, int H, int W) {
  constexpr int W1 = TW + 4, H1 = TH + 4;   // m1 region (2-pixel halo)
  constexpr int W2 = TW + 2, H2 = TH + 2;   // m2 region (1-pixel halo)
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                         // CIO x CM
  float* w2s = w1s + CIO * CM;               // K9 x CM
  float* w3s = w2s + K9 * CM;                // K9 x CM
  float* w4s = w3s + K9 * CM;                // CM x CIO
  bf16* m1s = reinterpret_cast<bf16*>(w4s + CM * CIO);   // H1 x W1 x CM
  bf16* m2s = m1s + H1 * W1 * CM;                         // H2 x W2 x CM
  bf16* im = m2s + H2 * W2 * CM;                          // P x K9

  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* xb = x + (size_t)bi * H * W * CIO;
  const float b1l = b1[lane], b2l = b2[lane], b3l = b3[lane];
  const auto in_rows = [&](int gr) { return gr >= 0 && gr < H; };

  for (int i = threadIdx.x; i < CIO * CM; i += THREADS) {
    w1s[i] = to_f(w1[i]);
    w4s[i] = to_f(w4[i]);
  }
  for (int i = threadIdx.x; i < K9 * CM; i += THREADS) {
    w2s[i] = to_f(w2[i]);
    w3s[i] = to_f(w3[i]);
  }
  __syncthreads();

  // m1 on the tile grown by 2; x reads as zero outside the image
  for (int p = warp; p < H1 * W1; p += NWARPS) {
    const int gr = r0 - 2 + p / W1, gc = c0 - 2 + p % W1;
    float v = 0.f;
    if (gc >= 0 && gc < W && (MASK != MASK_ROW || in_rows(gr))) {
      float m0[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        m0[i] = mish_c<FAST>(in_rows(gr) ? to_f(xb[((size_t)gr * W + gc) * CIO +
                                                   lane + 32 * i])
                                         : 0.f);
      float acc = b1l;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll 8
        for (int k = 0; k < 32; ++k)
          acc = fmaf(__shfl_sync(0xffffffffu, m0[i], k), w1s[(32 * i + k) * CM + lane],
                     acc);
      v = mish_c<FAST>(acc);
      if (MASK == MASK_ELEM) v *= in_rows(gr) ? 1.f : 0.f;
    }
    m1s[p * CM + lane] = __float2bfloat16(v);
  }
  __syncthreads();

  // m2 on the tile grown by 1
  conv_region<IM2COL>(
      m1s, W1, H2 * W2, W2, w2s, im,
      [&](int pr, int pc) {
        const int gr = r0 - 1 + pr, gc = c0 - 1 + pc;
        return gc >= 0 && gc < W && (MASK != MASK_ROW || in_rows(gr));
      },
      [&](int p, int pr, int, bool on, float acc) {
        float v = 0.f;
        if (on) {
          v = mish_c<FAST>(acc + b2l);
          if (MASK == MASK_ELEM) v *= in_rows(r0 - 1 + pr) ? 1.f : 0.f;
        }
        m2s[p * CM + lane] = __float2bfloat16(v);
      });
  __syncthreads();

  // m3 and the output projection with the residual
  conv_region<IM2COL>(
      m2s, W2, TH * TW, TW, w3s, im,
      [&](int pr, int pc) { return r0 + pr < H && c0 + pc < W; },
      [&](int, int pr, int pc, bool on, float acc) {
        if (!on) return;
        const float m3 = mish_c<FAST>(acc + b3l);
        const size_t at = (((size_t)bi * H + r0 + pr) * W + c0 + pc) * CIO;
        float o[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) o[i] = b4[lane + 32 * i];
#pragma unroll 8
        for (int k = 0; k < CM; ++k) {
          const float a = __shfl_sync(0xffffffffu, m3, k);
#pragma unroll
          for (int i = 0; i < NI; ++i) o[i] = fmaf(a, w4s[k * CIO + lane + 32 * i], o[i]);
        }
#pragma unroll
        for (int i = 0; i < NI; ++i)
          y[at + lane + 32 * i] = __float2bfloat16(o[i] + to_f(x[at + lane + 32 * i]));
      });
}

template <int MASK, bool IM2COL, bool FAST, int TH>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* w4,
           const void* b4, void* y, int B, int H, int W, cudaStream_t stream) {
  constexpr int smem = smem_bytes<TH, IM2COL>();
  auto kernel = probe_convres_kernel<MASK, IM2COL, FAST, TH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)w4,
      (const float*)b4, (bf16*)y, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 base, 1 rowmask, 2 nomask, 3 ninedot, 4 bf16mish, 5 tile2x,
// 6 kitchen (nomask + ninedot + bf16mish + tile2x).  x, y (B, H, W, 64)
// bf16; w1 (64, 32), w2, w3 (3, 3, 32, 32), w4 (32, 64) bf16; b1, b2,
// b3 (32) and b4 (64) f32.
int probe_convres(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* w3, const void* b3, const void* w4,
                  const void* b4, void* y, int B, int H, int W, int variant,
                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
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
