// Fused ConvResBlock backward for Hopper (sm_90a).
//
// Replaces the TPU kernel dddpm_tpu/ops/pallas/convres.py:_bwd_kernel,
// reached from fused_convres_block's custom VJP (_vjp_bwd ->
// _fused_backward).
//
// What it computes, on x (B, H, W, CIO) NHWC and dy (B, H, W, CIO), the
// block output's gradient already unscaled to x's H x W, CM = 32:
//   recompute   m0 = mish(x), p1 = m0 @ w1 + b1, m1 = mish(p1),
//               p2 = conv3x3(m1, w2) + b2, m2 = mish(p2),
//               p3 = conv3x3(m2, w3) + b3, m3 = mish(p3)
//               (m1, m2 exactly zero outside the image: SAME padding)
//   back        g3 = (dy @ w4^T) * mish'(p3)
//               g2 = conv3x3^T(g3, w3) * mish'(p2), zero outside the image
//               g1 = conv3x3^T(g2, w2) * mish'(p1)
//               dx = (g1 @ w1^T) * mish'(x) (+ dy when residual)
//   weights     dw4 = sum m3^T dy, dw3[k] = sum m2(P + off_k)^T g3(P),
//               dw2[k] = sum m1(P + off_k)^T g2(P), dw1 = sum m0^T g1,
//               db4..db1 = sums of dy, g3, g2, g1, over every pixel P.
// Operands are rounded to the activation type where the JAX kernel
// rounds them (m0..m3, g3..g1); every sum is float32 and the weight and
// bias gradients come out in float32.
//
// What bounds it on an H100: at 256^2, CIO 64, one sample reads x and dy
// and writes dx (25 MB in bf16) and does ~8.8 GFLOP (the first three
// convs recomputed, then the data and weight gradients of all four),
// ~350 FLOP/B, above the card's ~295 FLOP/B ridge: at the bf16
// tensor-core rate the bound is operations.  This first
// version runs its products as FMA loops on CUDA cores, so it is far
// from that bound; it is simple and exact.
//
// What this design does about it:
// - One block walks over output tiles of TH x TW pixels (a loop over
//   tiles takes the place of the TPU's sequential grid).  Each tile holds
//   every intermediate in shared memory: m1 on the tile grown by 4
//   pixels each side, m2 by 3, g3 by 2, g2 and mish'(p2) by 1, g1 and m3
//   on the tile itself.  x and dy are read from device memory with their
//   halos, dx is written once.
// - Weight gradients: the TPU kernel adds into resident float32 blocks
//   across its sequential grid.  Here each block keeps one float32
//   partial of all eight gradients in a workspace the wrapper allocates
//   (every element owned by one thread, so no atomics), adding each
//   tile's sums over its central pixels only (never its halo).  A second
//   kernel then sums the blocks' partials in block order: deterministic.
// - Transposed 3x3 convs read the same weights as the forward ones with
//   ci and co swapped and the taps mirrored; rows of the weights in
//   shared memory are padded to 33 floats so both orders are free of
//   bank conflicts.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CM = 32;        // mid channels: one warp lane each
constexpr int CMP = CM + 1;   // padded row of a weight matrix in smem
constexpr int TH = 8;         // central tile rows
constexpr int TW = 8;         // central tile columns
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// regions: the tile grown by k pixels each side
constexpr int H4 = TH + 8, W4 = TW + 8;   // m1
constexpr int H3 = TH + 6, W3 = TW + 6;   // m2 (p2)
constexpr int H2 = TH + 4, W2 = TW + 4;   // g3 (p3)
constexpr int H1 = TH + 2, W1 = TW + 2;   // mish'(p2), then g2
constexpr int NW33 = 9 * CM * CMP;        // a padded 3x3 weight

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

// t = tanh(softplus(x)); mish(x) = x t; mish'(x) = t + x s (1 - t^2)
__device__ __forceinline__ float tanh_softplus(float x) {
  return tanhf(fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))));
}
__device__ __forceinline__ float mish(float x) { return x * tanh_softplus(x); }
__device__ __forceinline__ float dmish_t(float x, float t) {
  const float s = 1.f / (1.f + expf(-x));
  return t + x * s * (1.f - t * t);
}
__device__ __forceinline__ float dmish(float x) { return dmish_t(x, tanh_softplus(x)); }

// 3x3 correlation at one pixel for output channel `lane`: src is a
// CM-channel region of row width sw, (r, c) the window's top-left;
// w is padded [k][ci][co] (row stride CMP).
__device__ __forceinline__ float conv_at(const float* src, int sw, int r, int c,
                                         const float* w, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* s = src + ((r + ky) * sw + c + kx) * CM;
      const float* wk = w + (ky * 3 + kx) * CM * CMP + lane;
#pragma unroll 8
      for (int ic = 0; ic < CM; ++ic) acc = fmaf(s[ic], wk[ic * CMP], acc);
    }
  return acc;
}

// The transposed conv at one pixel for input channel `lane`: the window
// (r, c)..(r+2, c+2) of src holds g at the pixel minus (ky-1, kx-1) for
// the mirrored tap; out[ci] = sum_k sum_co g[co] w[8-k][ci][co].
__device__ __forceinline__ float conv_t_at(const float* src, int sw, int r, int c,
                                           const float* w, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* s = src + ((r + ky) * sw + c + kx) * CM;
      const float* wk = w + (8 - (ky * 3 + kx)) * CM * CMP + lane * CMP;
#pragma unroll 8
      for (int co = 0; co < CM; ++co) acc = fmaf(s[co], wk[co], acc);
    }
  return acc;
}

template <int CIO>
struct Layout {   // float offsets of the eight gradients in one partial
  static constexpr int DW1 = 0;
  static constexpr int DB1 = DW1 + CIO * CM;
  static constexpr int DW2 = DB1 + CM;
  static constexpr int DB2 = DW2 + 9 * CM * CM;
  static constexpr int DW3 = DB2 + CM;
  static constexpr int DB3 = DW3 + 9 * CM * CM;
  static constexpr int DW4 = DB3 + CM;
  static constexpr int DB4 = DW4 + CM * CIO;
  static constexpr int N = DB4 + CIO;
};

template <int CIO>
constexpr int smem_floats() {
  return CIO * CMP + CM * (CIO + 1) + 2 * NW33 +
         (H4 * W4 + H3 * W3 + H2 * W2 + H1 * W1 + 2 * TH * TW) * CM;
}

// 3x3 weight-gradient sums of one tile: dw[k][ci][co] += m(P + off_k)[ci]
// g(P)[co] over the central pixels.  Thread (warp, lane) owns co = lane
// and rows ci = warp + 8 (j & 3) of tap k = j >> 2.  m's region has its
// window for central pixel (pr, pc) at top-left (pr + mo, pc + mo); g's
// region holds P at (pr + go, pc + go).  Warp 0 also sums db.
template <int mo, int go>
__device__ __forceinline__ void wgrad3x3(const float* ms, int mw, const float* gs,
                                         int gw, int nr, int nc, float* dw, float* db,
                                         int warp, int lane) {
  float acc[36];
#pragma unroll
  for (int j = 0; j < 36; ++j) acc[j] = 0.f;
  float accb = 0.f;
  for (int pr = 0; pr < nr; ++pr)
    for (int pc = 0; pc < nc; ++pc) {
      const float g = gs[((pr + go) * gw + pc + go) * CM + lane];
      accb += g;
#pragma unroll
      for (int j = 0; j < 36; ++j) {
        const int k = j >> 2, ci = warp + 8 * (j & 3);
        acc[j] = fmaf(ms[((pr + mo + k / 3) * mw + pc + mo + k % 3) * CM + ci], g, acc[j]);
      }
    }
#pragma unroll
  for (int j = 0; j < 36; ++j) {
    const int k = j >> 2, ci = warp + 8 * (j & 3);
    dw[(k * CM + ci) * CM + lane] += acc[j];
  }
  if (warp == 0) db[lane] += accb;
}

template <typename T, int CIO>
__global__ void __launch_bounds__(THREADS)
convres_bwd_kernel(const T* x, const T* dy, const T* w1, const float* b1, const T* w2,
                   const float* b2, const T* w3, const float* b3, const T* w4, T* dx,
                   float* part, int B, int H, int W, int residual) {
  using L = Layout<CIO>;
  constexpr int NI = CIO / 32;        // in/out channels per lane
  constexpr int NJ = CIO * CM / THREADS;   // dw1 / dw4 elements per thread
  constexpr int STEP = THREADS / CIO;      // co (dw1) or k (dw4) stride

  extern __shared__ float smem[];
  float* w1s = smem;                  // [ci][co], row stride CMP
  float* w4s = w1s + CIO * CMP;       // [k][co], row stride CIO + 1
  float* w2s = w4s + CM * (CIO + 1);  // [tap][ci][co], row stride CMP
  float* w3s = w2s + NW33;
  float* m1s = w3s + NW33;            // H4 x W4 x CM
  float* m2s = m1s + H4 * W4 * CM;    // H3 x W3 x CM
  float* g3s = m2s + H3 * W3 * CM;    // H2 x W2 x CM
  float* g2s = g3s + H2 * W2 * CM;    // H1 x W1 x CM: mish'(p2), then g2
  float* g1s = g2s + H1 * W1 * CM;    // TH x TW x CM: mish'(p1), then g1
  float* m3s = g1s + TH * TW * CM;    // TH x TW x CM

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* pb = part + (size_t)blockIdx.x * L::N;

  for (int i = tid; i < L::N; i += THREADS) pb[i] = 0.f;
  for (int i = tid; i < CIO * CM; i += THREADS) {
    const int r = i / CM, c = i % CM;
    w1s[r * CMP + c] = to_f(w1[i]);            // w1 (CIO, CM)
    const int k = i / CIO, co = i % CIO;
    w4s[k * (CIO + 1) + co] = to_f(w4[i]);     // w4 (CM, CIO)
  }
  for (int i = tid; i < 9 * CM * CM; i += THREADS) {
    const int row = i / CM, c = i % CM;
    w2s[row * CMP + c] = to_f(w2[i]);
    w3s[row * CMP + c] = to_f(w3[i]);
  }
  __syncthreads();

  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bi = tile / (tiles_h * tiles_w);
    const int r0 = (tile / tiles_w) % tiles_h * TH, c0 = tile % tiles_w * TW;
    const T* xb = x + (size_t)bi * H * W * CIO;
    const T* dyb = dy + (size_t)bi * H * W * CIO;
    T* dxb = dx + (size_t)bi * H * W * CIO;
    auto inside = [&](int gr, int gc) { return gr >= 0 && gr < H && gc >= 0 && gc < W; };

    // m1 on the tile grown by 4 (zero outside the image); mish'(p1) on
    // the central pixels
    for (int p = warp; p < H4 * W4; p += NWARPS) {
      const int pr = p / W4, pc = p % W4;
      const int gr = r0 - 4 + pr, gc = c0 - 4 + pc;
      float v = 0.f, d = 0.f;
      if (inside(gr, gc)) {
        const T* xp = xb + ((size_t)gr * W + gc) * CIO;
        float m0[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) m0[i] = rnd<T>(mish(to_f(xp[lane + 32 * i])));
        float acc = b1[lane];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll 8
          for (int k = 0; k < 32; ++k)
            acc = fmaf(__shfl_sync(0xffffffffu, m0[i], k), w1s[(32 * i + k) * CMP + lane],
                       acc);
        const float t = tanh_softplus(acc);
        v = rnd<T>(acc * t);
        d = dmish_t(acc, t);
      }
      m1s[p * CM + lane] = v;
      const int cr = pr - 4, cc = pc - 4;
      if (cr >= 0 && cr < TH && cc >= 0 && cc < TW) g1s[(cr * TW + cc) * CM + lane] = d;
    }
    __syncthreads();

    // m2 on the tile grown by 3 (zero outside); mish'(p2) grown by 1
    for (int p = warp; p < H3 * W3; p += NWARPS) {
      const int pr = p / W3, pc = p % W3;
      const int gr = r0 - 3 + pr, gc = c0 - 3 + pc;
      float v = 0.f, d = 0.f;
      if (inside(gr, gc)) {
        const float p2 = b2[lane] + conv_at(m1s, W4, pr, pc, w2s, lane);
        const float t = tanh_softplus(p2);
        v = rnd<T>(p2 * t);
        d = dmish_t(p2, t);
      }
      m2s[p * CM + lane] = v;
      const int qr = pr - 2, qc = pc - 2;
      if (qr >= 0 && qr < H1 && qc >= 0 && qc < W1) g2s[(qr * W1 + qc) * CM + lane] = d;
    }
    __syncthreads();

    // g3 on the tile grown by 2 (zero outside: dy's halo is zero there);
    // m3 on the central pixels
    for (int p = warp; p < H2 * W2; p += NWARPS) {
      const int pr = p / W2, pc = p % W2;
      const int gr = r0 - 2 + pr, gc = c0 - 2 + pc;
      float g = 0.f, m3 = 0.f;
      if (inside(gr, gc)) {
        const float p3 = b3[lane] + conv_at(m2s, W3, pr, pc, w3s, lane);
        const T* dp = dyb + ((size_t)gr * W + gc) * CIO;
        float dv[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) dv[i] = to_f(dp[lane + 32 * i]);
        float u3 = 0.f;   // (dy @ w4^T)[lane]
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll 8
          for (int k = 0; k < 32; ++k)
            u3 = fmaf(__shfl_sync(0xffffffffu, dv[i], k), w4s[lane * (CIO + 1) + 32 * i + k],
                      u3);
        const float t = tanh_softplus(p3);
        g = rnd<T>(u3 * dmish_t(p3, t));
        m3 = rnd<T>(p3 * t);
      }
      g3s[p * CM + lane] = g;
      const int cr = pr - 2, cc = pc - 2;
      if (cr >= 0 && cr < TH && cc >= 0 && cc < TW) m3s[(cr * TW + cc) * CM + lane] = m3;
    }
    __syncthreads();

    // g2 on the tile grown by 1, over mish'(p2) in place (zero outside)
    for (int p = warp; p < H1 * W1; p += NWARPS) {
      const int qr = p / W1, qc = p % W1;
      const int gr = r0 - 1 + qr, gc = c0 - 1 + qc;
      float g = 0.f;
      if (inside(gr, gc)) g = rnd<T>(conv_t_at(g3s, W2, qr, qc, w3s, lane) * g2s[p * CM + lane]);
      g2s[p * CM + lane] = g;
    }
    __syncthreads();

    // g1 on the central pixels, over mish'(p1) in place; then dx
    for (int p = warp; p < TH * TW; p += NWARPS) {
      const int pr = p / TW, pc = p % TW;
      const int gr = r0 + pr, gc = c0 + pc;
      float g1 = 0.f;
      if (inside(gr, gc)) {
        g1 = rnd<T>(conv_t_at(g2s, W1, pr, pc, w2s, lane) * g1s[p * CM + lane]);
        const T* xp = xb + ((size_t)gr * W + gc) * CIO;
        const T* dp = dyb + ((size_t)gr * W + gc) * CIO;
        T* op = dxb + ((size_t)gr * W + gc) * CIO;
        float u0[NI] = {};
#pragma unroll 8
        for (int k = 0; k < CM; ++k) {
          const float a = __shfl_sync(0xffffffffu, g1, k);
#pragma unroll
          for (int i = 0; i < NI; ++i) u0[i] = fmaf(a, w1s[(lane + 32 * i) * CMP + k], u0[i]);
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int ci = lane + 32 * i;
          float v = u0[i] * dmish(to_f(xp[ci]));
          if (residual) v += to_f(dp[ci]);
          op[ci] = from_f<T>(v);
        }
      }
      g1s[p * CM + lane] = g1;
    }
    __syncthreads();

    // weight and bias gradients over the tile's central pixels in the image
    const int nr = min(TH, H - r0), nc = min(TW, W - c0);
    {   // dw4 (CM, CIO), db4: thread owns co = tid % CIO, k = tid / CIO + STEP j
      const int co = tid % CIO, kb = tid / CIO;
      float acc[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
      float accb = 0.f;
      for (int pr = 0; pr < nr; ++pr)
        for (int pc = 0; pc < nc; ++pc) {
          const float d = to_f(dyb[((size_t)(r0 + pr) * W + c0 + pc) * CIO + co]);
          accb += d;
          const float* m3p = m3s + (pr * TW + pc) * CM;
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[j] = fmaf(m3p[kb + STEP * j], d, acc[j]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j) pb[L::DW4 + (kb + STEP * j) * CIO + co] += acc[j];
      if (kb == 0) pb[L::DB4 + co] += accb;
    }
    // dw3: m2 window of central (pr, pc) at (pr + 2, pc + 2) in m2's
    // region; g3 of (pr, pc) at (pr + 2, pc + 2) in g3's region
    wgrad3x3<2, 2>(m2s, W3, g3s, W2, nr, nc, pb + L::DW3, pb + L::DB3, warp, lane);
    // dw2: m1 window at (pr + 3, pc + 3); g2 at (pr + 1, pc + 1)
    wgrad3x3<3, 1>(m1s, W4, g2s, W1, nr, nc, pb + L::DW2, pb + L::DB2, warp, lane);
    {   // dw1 (CIO, CM), db1: thread owns ci = tid % CIO, co = tid / CIO + STEP j
      const int ci = tid % CIO, cb = tid / CIO;
      float acc[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
      float accb = 0.f;
      for (int pr = 0; pr < nr; ++pr)
        for (int pc = 0; pc < nc; ++pc) {
          const float m0 =
              rnd<T>(mish(to_f(xb[((size_t)(r0 + pr) * W + c0 + pc) * CIO + ci])));
          const float* g1p = g1s + (pr * TW + pc) * CM;
          if (tid < CM) accb += g1p[tid];
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[j] = fmaf(m0, g1p[cb + STEP * j], acc[j]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j) pb[L::DW1 + ci * CM + cb + STEP * j] += acc[j];
      if (tid < CM) pb[L::DB1 + tid] += accb;
    }
    __syncthreads();   // the next tile overwrites shared memory
  }
}

// out[e] = sum over blocks, in block order, of part[b][e]
__global__ void convres_bwd_reduce(const float* part, int nblk, int n, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * n + e];
  out[e] = s;
}

template <typename T, int CIO>
int launch(const void* x, const void* dy, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* w4, void* dx,
           void* part, void* out, int B, int H, int W, int residual, int nblk,
           cudaStream_t stream) {
  const int smem = smem_floats<CIO>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      convres_bwd_kernel<T, CIO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  convres_bwd_kernel<T, CIO><<<nblk, THREADS, smem, stream>>>(
      (const T*)x, (const T*)dy, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const T*)w3, (const float*)b3, (const T*)w4, (T*)dx,
      (float*)part, B, H, W, residual);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = Layout<CIO>::N;
  convres_bwd_reduce<<<(n + 255) / 256, 256, 0, stream>>>((const float*)part, nblk, n,
                                                         (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cio(const void* x, const void* dy, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* w3, const void* b3,
               const void* w4, void* dx, void* part, void* out, int B, int H, int W,
               int C, int residual, int nblk, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 32>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B, H, W, residual, nblk, s);
    case 64: return launch<T, 64>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B, H, W, residual, nblk, s);
    case 128: return launch<T, 128>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B, H, W, residual, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of one block's partial (and of `out`) for C in/out channels:
// dw1 (C, 32), db1 (32), dw2 (3, 3, 32, 32), db2, dw3, db3, dw4 (32, C),
// db4 (C), packed in that order.
int convres_bwd_partial_size(int C) {
  switch (C) {
    case 32: return Layout<32>::N;
    case 64: return Layout<64>::N;
    case 128: return Layout<128>::N;
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  x, dy, dx (B, H, W, C) NHWC; w1
// (C, 32); w2, w3 (3, 3, 32, 32) HWIO; w4 (32, C); all of x's type; b1,
// b2, b3 (32) float32.  part: nblk partials of float32 workspace; out:
// one float32 partial, the eight gradients.  C in {32, 64, 128}; nblk
// blocks walk over the 8x8 output tiles.
int convres_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* w3, const void* b3,
                const void* w4, void* dx, void* part, void* out, int B, int H, int W,
                int C, int residual, int nblk, int dtype, void* stream) {
  if (nblk < 1 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_cio<__nv_bfloat16>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B,
                                     H, W, C, residual, nblk, (cudaStream_t)stream);
  return launch_cio<float>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B, H, W, C,
                           residual, nblk, (cudaStream_t)stream);
}

}  // extern "C"
