// Fused ConvResBlock forward for Hopper (sm_90a).
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
// Intermediates are rounded to the activation type where the plain
// version rounds them (the conv operands).
//
// What bounds it on an H100: at 256^2 with CIO 64 and no scaling one
// sample moves 16.8 MB and does 2.95 GFLOP (~176 FLOP/B), so the bound
// is memory bandwidth.
//
// What this design does about it: the whole bottleneck runs per tile of
// TH x TW output pixels of one sample, with every intermediate in
// shared memory, so x is read once (plus a 2-pixel halo) and y written
// once.  m1 is formed on the tile grown by 2 pixels each side and m2 by
// 1; at out-of-image positions both are set to exactly zero: the conv's
// zero padding applies to its input, and mish(bias) is not zero.  The
// products are FMA loops (one warp a pixel, one lane a channel), not
// tensor cores: this first version is simple and exact, not fast.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CM = 32;        // mid channels: one warp lane each
constexpr int TH = 8;         // output rows per tile
constexpr int TW = 32;        // output columns per tile
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int W1 = TW + 4, H1 = TH + 4;   // m1 region (2-pixel halo)
constexpr int W2 = TW + 2, H2 = TH + 2;   // m2 region (1-pixel halo)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float mish(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // softplus
  return x * tanhf(sp);
}

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

// scale: 0 none, 1 'up' (2x nearest), 2 'down' (2x2 mean).
template <typename T, int CIO>
__global__ void __launch_bounds__(THREADS)
convres_fwd_kernel(const T* x, const T* w1, const float* b1, const T* w2,
                   const float* b2, const T* w3, const float* b3, const T* w4,
                   const float* b4, T* y, int H, int W, int residual,
                   int scale) {
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
  const T* xb = x + (size_t)bi * H * W * CIO;

  for (int i = threadIdx.x; i < CIO * CM; i += THREADS) {
    w1s[i] = to_f(w1[i]);
    w4s[i] = to_f(w4[i]);
  }
  for (int i = threadIdx.x; i < 9 * CM * CM; i += THREADS) {
    w2s[i] = to_f(w2[i]);
    w3s[i] = to_f(w3[i]);
  }
  __syncthreads();

  // m1 on the tile grown by 2: zero outside the image
  for (int p = warp; p < H1 * W1; p += NWARPS) {
    const int gr = r0 - 2 + p / W1, gc = c0 - 2 + p % W1;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      const T* xp = xb + ((size_t)gr * W + gc) * CIO;
      float m0[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) m0[i] = rnd<T>(mish(to_f(xp[lane + 32 * i])));
      float acc = b1[lane];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll 8
        for (int k = 0; k < 32; ++k)
          acc = fmaf(__shfl_sync(0xffffffffu, m0[i], k),
                     w1s[(32 * i + k) * CM + lane], acc);
      v = rnd<T>(mish(acc));
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
      v = rnd<T>(mish(b2[lane] + conv3x3_at(m1s, W1, pr, pc, w2s, lane)));
    m2s[p * CM + lane] = v;
  }
  __syncthreads();

  // m3 and the output projection at one pixel: o[i] holds channel lane+32i
  auto out_at = [&](int pr, int pc, float (&o)[NI]) {
    const float m3 = rnd<T>(mish(b3[lane] + conv3x3_at(m2s, W2, pr, pc, w3s, lane)));
    const T* xp = xb + ((size_t)(r0 + pr) * W + c0 + pc) * CIO;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int co = lane + 32 * i;
      o[i] = b4[co] + (residual ? to_f(xp[co]) : 0.f);
    }
#pragma unroll 8
    for (int k = 0; k < CM; ++k) {
      const float a = __shfl_sync(0xffffffffu, m3, k);
#pragma unroll
      for (int i = 0; i < NI; ++i) o[i] = fmaf(a, w4s[k * CIO + lane + 32 * i], o[i]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) o[i] = rnd<T>(o[i]);
  };

  if (scale == 2) {
    const int Ho = H / 2, Wo = W / 2;
    T* yb = y + (size_t)bi * Ho * Wo * CIO;
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
      T* yp = yb + ((size_t)(r0 / 2 + qr) * Wo + c0 / 2 + qc) * CIO;
#pragma unroll
      for (int i = 0; i < NI; ++i) yp[lane + 32 * i] = from_f<T>(sum[i] * 0.25f);
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
      T* yb = y + (size_t)bi * (2 * H) * (2 * W) * CIO;
      for (int s = 0; s < 4; ++s) {
        T* yp = yb + ((size_t)(2 * gr + s / 2) * (2 * W) + 2 * gc + s % 2) * CIO;
#pragma unroll
        for (int i = 0; i < NI; ++i) yp[lane + 32 * i] = from_f<T>(o[i]);
      }
    } else {
      T* yp = y + (((size_t)bi * H + gr) * W + gc) * CIO;
#pragma unroll
      for (int i = 0; i < NI; ++i) yp[lane + 32 * i] = from_f<T>(o[i]);
    }
  }
}

template <typename T, int CIO>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* w4,
           const void* b4, void* y, int B, int H, int W, int residual,
           int scale, cudaStream_t stream) {
  const int smem = (2 * CIO * CM + 2 * 9 * CM * CM + H1 * W1 * CM + H2 * W2 * CM) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      convres_fwd_kernel<T, CIO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  convres_fwd_kernel<T, CIO><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2, (const float*)b2,
      (const T*)w3, (const float*)b3, (const T*)w4, (const float*)b4, (T*)y, H, W,
      residual, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cio(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* w3, const void* b3, const void* w4,
               const void* b4, void* y, int B, int H, int W, int C, int residual,
               int scale, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 32>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W, residual, scale, s);
    case 64: return launch<T, 64>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W, residual, scale, s);
    case 128: return launch<T, 128>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W, residual, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, C) NHWC; w1 (C, 32);
// w2, w3 (3, 3, 32, 32) HWIO; w4 (32, C); all of x's type; b1, b2, b3
// (32) and b4 (C) float32.  y is (B, H, W, C), (B, 2H, 2W, C) for
// scale 1, (B, H/2, W/2, C) for scale 2 (H, W even).  C in {32, 64, 128}.
int convres_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* w3, const void* b3, const void* w4,
                const void* b4, void* y, int B, int H, int W, int C, int residual,
                int scale, int dtype, void* stream) {
  if (scale < 0 || scale > 2 || (scale == 2 && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_cio<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W,
                                     C, residual, scale, (cudaStream_t)stream);
  return launch_cio<float>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, B, H, W, C,
                           residual, scale, (cudaStream_t)stream);
}

}  // extern "C"
