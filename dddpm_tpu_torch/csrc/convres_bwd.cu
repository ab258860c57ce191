// Fused ConvResBlock backward for Hopper (sm_90a), its bf16 recompute and
// data-gradient products on the tensor cores (mma.sync, bf16 operands,
// f32 sums).
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
// rounds them (m0..m3, g3..g1); mish'(p) is taken of the f32 p; every
// sum is float32 and the weight and bias gradients come out in float32.
//
// What bounds it on an H100: at 256^2, CIO 64, one sample reads x and dy
// and writes dx (25 MB in bf16) and does ~8.8 GFLOP (the first three
// convs recomputed, then the data and weight gradients of all four),
// ~350 FLOP/B, above the card's ~295 FLOP/B ridge: at the bf16
// tensor-core rate the bound is operations.  This design runs all of
// them on mma.sync: the seven products of the recompute and the
// data-gradient chain (stage A), then the four weight-gradient sums (a
// third of the FLOP) and the four bias sums (stage B).
//
// What this design does about it (bf16): one block an SM walks over
// output tiles of TH x 16 pixels of one sample (8 x 16 at CIO 32 and 64,
// 4 x 16 at CIO 128), a loop over tiles in place of the TPU's sequential
// grid.  Each tile keeps every intermediate in shared memory, bf16 in
// 80-byte pixel rows (ldmatrix without bank conflicts) on regions that
// shrink by one pixel a side per 3x3: m1 on the tile grown by 4 (R4, 16
// x 24 at TH 8), m2 by 3 (R3), g3 by 2 (R2), g2 by 1 (R1), g1 on the
// tile; mish'(p2) on R1 and mish'(p1) on the tile stay f32.  The seven
// products are implicit GEMMs, M = pixels, each lane's ldmatrix row
// address its own pixel, so that a 3x3 tap is a constant offset:
//   G1 m0 . w1 on R4 (x band by cp.async, m0's mish on the A fragments)
//   G2 the 3x3 over m1 on R3, G3 the 3x3 over m2 on R2,
//   U3 dy . w4^T on R2 (dy band by cp.async), in G3's pass: g3 = U3 mish'(p3)
//   T2 conv3x3^T(g3, w3) on R1, T1 conv3x3^T(g2, w2) on the tile,
//   D  g1 . w1^T on the tile, N = CIO: dx = D mish'(x) (+ dy), stored.
// Every weight lives once in shared memory: the forward products read
// it as [k][n] by ldmatrix.trans, the transposed ones as [n][k] by
// ldmatrix, at the mirrored tap 8 - k for the 3x3s, so w1..w4 serve both
// directions.  The x band's room is taken over, once G1 has read it, by
// the dy band, g2 and m3; mish'(p1)'s and mish'(p2)'s, once T1 has read
// them, by m0 and g1 (m0 in dense rows of CIO, its 16-byte chunks
// XOR-swizzled by pixel).  Every warp runs every stage, with a barrier
// between stages.  Stage B's sums are implicit GEMMs too, M x N = 32 x
// 32 a warp's piece, depth the tile's pixels, one k-step of 16 a tile
// row: A^T (m) and B (g, dy) both [pixel][channel] rows read by
// ldmatrix.trans, a 3x3 tap again a constant offset into m's window.
// Warp w sums tap w of dw3 and dw2 in registers over all of the block's
// tiles; warps 0 .. 2 CIO / 32 - 1 each a 32-channel piece of dw4 or dw1,
// and the last warp db3 and db2, into the block's partial tile by tile;
// the biases are column sums, products of a ones fragment with the B
// fragments (db4's and db1's with their weight's).  Each block writes one
// float32 partial of all eight gradients (every element owned by one
// thread, no atomics), summed over the tile's pixels in the image only
// (every operand is 0 outside it), and convres_bwd_reduce sums the
// blocks' partials in block order: deterministic.
//
// float32 is on no default path and keeps the kernel's first design
// (namespace f32), selected by the dtype argument (not a fallback): 8 x 8
// tiles, FMA loops, one warp a pixel, one lane a channel, f32 weights
// and intermediates in shared memory.
//
// CONVRES_SKIP (a -D define, 0 by default; csrc/convres_sm90.cuh) compiles
// parts of the bf16 kernel out, by bit: 1 stage A's products (mma), 2
// mish and mish', 4 the global traffic (the x and dy bands, x at the
// tile, dx), 8 the whole of stage B (its mma weight and bias sums and
// their partial's updates).  Only the ablation probe
// (probes/convres_bwd_ablation.py) sets it; its kernels compute garbage.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().  bf16 x and dy must be 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convres_sm90.cuh"  // bf16, CM, MS, SKIP, pack2, act_dact, gemm32(_nb)
#include "mma_sm90.cuh"      // cp_async16, ldmatrix_x4_trans, mma_bf16


namespace {

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

// out[e] = sum over blocks, in block order, of part[b][e]
__global__ void convres_bwd_reduce(const float* part, int nblk, int n, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * n + e];
  out[e] = s;
}

// ---------------------------------------------------------------------
// float32: the FMA kernel (the first design)
// ---------------------------------------------------------------------

namespace f32 {

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

// the kernel is instantiated for float only (bf16 takes namespace tc)
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
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
convres_bwd_fma_kernel(const T* x, const T* dy, const T* w1, const float* b1, const T* w2,
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

template <typename T, int CIO>
int launch_fma(const void* x, const void* dy, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* w3, const void* b3,
               const void* w4, void* dx,
               void* part, int B, int H, int W, int residual, int nblk,
               cudaStream_t stream) {
  const int smem = smem_floats<CIO>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      convres_bwd_fma_kernel<T, CIO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  convres_bwd_fma_kernel<T, CIO><<<nblk, THREADS, smem, stream>>>(
      (const T*)x, (const T*)dy, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const T*)w3, (const float*)b3, (const T*)w4, (T*)dx,
      (float*)part, B, H, W, residual);
  return (int)cudaGetLastError();
}


}  // namespace f32

// ---------------------------------------------------------------------
// bfloat16: the tensor cores
// ---------------------------------------------------------------------

namespace tc {

constexpr int TW = 16;          // output columns a tile: one m16 tile a row
constexpr int NWARPS = 9;       // warp w sums tap w of dw2 and dw3
constexpr int THREADS = 32 * NWARPS;

// A tile of TH x TW output pixels at CIO in/out channels: its regions,
// the tile grown by 4 (R4), 3 (R3), 2 (R2), 1 (R1) and 0 (T), and the
// block's shared memory, offsets in bf16 elements: the weights, the
// biases (f32), then X (the x band on R4 for G1; afterwards the dy band
// on R2, g2 on R1 and m3 on T), m1 (R4), m2 (R3), g3 (R2), and F
// (f32 mish'(p1) on T, then mish'(p2) on R1; after T1, m0 on T in dense
// rows of CIO at its start, chunks swizzled by m0_chunk, and g1 on T at
// its end).
template <int CIO, int TH_>
struct Tile {
  static constexpr int TH = TH_;
  static constexpr int W4 = TW + 8, N4 = (TH + 8) * W4;
  static constexpr int W3 = TW + 6, N3 = (TH + 6) * W3;
  static constexpr int W2 = TW + 4, N2 = (TH + 4) * W2;
  static constexpr int W1 = TW + 2, N1 = (TH + 2) * W1;
  static constexpr int NT = TH * TW;
  static constexpr int M4 = (N4 + 15) / 16, M3 = (N3 + 15) / 16;
  static constexpr int M2 = (N2 + 15) / 16, M1 = (N1 + 15) / 16, MT = NT / 16;
  // bf16 a pixel of the x and dy bands and a row of w4: (CIO + 8) x 2
  // bytes, an odd multiple of 16
  static constexpr int XS = CIO + 8;
  static constexpr int O_W2 = CIO * MS;             // w1 first: [ci][co]
  static constexpr int O_W3 = O_W2 + 9 * CM * MS;   // [tap * 32 + ci][co]
  static constexpr int O_W4 = O_W3 + 9 * CM * MS;   // [cm][cio], XS a row
  static constexpr int O_B = O_W4 + CM * XS;        // f32 b1 | b2 | b3
  static constexpr int O_X = O_B + 3 * CM * 2;
  static constexpr int X_G2 = N2 * XS, X_M3 = X_G2 + N1 * MS;
  static constexpr int XSIZE = N4 * XS > X_M3 + NT * MS ? N4 * XS : X_M3 + NT * MS;
  static constexpr int O_M1 = O_X + XSIZE;
  static constexpr int O_M2 = O_M1 + N4 * MS;
  static constexpr int O_G3 = O_M2 + N3 * MS;
  static constexpr int O_F = O_G3 + N2 * MS;
  static constexpr int FSIZE = (NT + N1) * CM * 2;  // two bf16 a float
  static constexpr int F_G1 = FSIZE - NT * MS;
  static constexpr int SMEM = (O_F + FSIZE) * 2;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(NT * CIO <= F_G1 && F_G1 >= NT * CM * 2,
                "m0 and g1 fit beside each other, g1 past mish'(p1)");
  static_assert(O_X % 8 == 0 && XSIZE % 8 == 0 && O_F % 8 == 0 && F_G1 % 8 == 0 &&
                    X_G2 % 8 == 0 && X_M3 % 8 == 0,
                "16-byte aligned regions");
};

// float index of channel ch (even) of pixel px in a mish' array: the
// 8-channel blocks of a pixel swizzled by px % 4, so that the float2
// accesses of an epilogue (8 pixels x 4 channel pairs) miss no bank
// twice in a half-warp
__device__ __forceinline__ int dmi(int px, int ch) { return px * CM + (ch ^ ((px & 3) << 3)); }

// The 16-byte chunk of m0's dense rows (CH chunks a pixel) that holds
// chunk ch of pixel pt: XOR-swizzled by pixel, so that the 8 pixel rows
// an ldmatrix reads (8 pixels from a multiple of 8) fall in 8 bank groups
template <int CH>
__device__ __forceinline__ int m0_chunk(int pt, int ch) {
  static_assert(CH == 4 || CH % 8 == 0, "64-byte rows or whole 128-byte lines");
  return ch ^ (CH == 4 ? (pt >> 1) & 3 : pt & 7);
}

// Stage B's products: the weight sums are implicit GEMMs whose depth is
// pixels, one k-step of 16 a tile row, both operands [pixel][channel]
// rows read by ldmatrix.trans (the kernel gives each lane its rows).
//
// B's fragments of one k-step, 16 pixels x 32 channels from b (this
// lane's row address): n8 tiles 0, 1 in bf[0], 2, 3 (16 channels on) in bf[1]
__device__ __forceinline__ void wload_b(unsigned (&bf)[2][4], const bf16* b) {
  ldmatrix_x4_trans(bf[0], b);
  ldmatrix_x4_trans(bf[1], b + 16);
}

// acc[mt][nt] += A B over one k-step, M = N = 32: A^T's 16 pixels x 32
// channels at a0 (channels 0-15, this lane's row address) and a1
// (16-31), B's fragments bf
__device__ __forceinline__ void wsum(float (&acc)[2][4][4], const bf16* a0, const bf16* a1,
                                     const unsigned (&bf)[2][4]) {
  unsigned af[2][4];
  ldmatrix_x4_trans(af[0], a0);
  ldmatrix_x4_trans(af[1], a1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][2 * (nt & 1)], bf[nt >> 1][2 * (nt & 1) + 1]);
}

// s[nt] += the column sums of B (a ones fragment times B): every row of
// s the same, channel 8 nt + 2 (lane & 3) (+ 1) in s[nt][0] (s[nt][1])
__device__ __forceinline__ void wcolsum(float (&s)[4][4], const unsigned (&bf)[2][4]) {
  constexpr unsigned ONE2 = 0x3f803f80u;   // a bf16 pair of ones
  const unsigned ones[4] = {ONE2, ONE2, ONE2, ONE2};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    mma_bf16(s[nt], ones, bf[nt >> 1][2 * (nt & 1)], bf[nt >> 1][2 * (nt & 1) + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}
template <int M, int N>
__device__ __forceinline__ void zero(float (&a)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) zero(a[i]);
}

// p[r * ld + c] (+)= acc's element (r, c), r = 16 mt + row, c = 8 nt +
// col: the m16n8 layout, two floats (c, c + 1) a store
template <bool ADD>
__device__ __forceinline__ void wstore(float* p, int ld, const float (&acc)[2][4][4],
                                       int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* const q =
            reinterpret_cast<float2*>(p + (16 * mt + g + 8 * h) * ld + 8 * nt + 2 * tq);
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (ADD) {
          const float2 o = *q;
          v.x += o.x;
          v.y += o.y;
        }
        *q = v;
      }
}

// p[c] += column sums s (wcolsum's), 32 channels, from lanes 0-3
__device__ __forceinline__ void wstore_sum(float* p, const float (&s)[4][4], int lane) {
  if (lane >= 4) return;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float2* const q = reinterpret_cast<float2*>(p + 8 * nt + 2 * lane);
    const float2 o = *q;
    *q = make_float2(o.x + s[nt][0], o.y + s[nt][1]);
  }
}

// gemm32_nb over the weights seen transposed (B as [n][k] rows of MS):
// two m16 tiles where `two` (warp-uniform), else one
template <int KSTEPS, typename AOff, typename BOff>
__device__ __forceinline__ void gemm32t(float (&acc)[2][4][4], const bf16* const (&a_lane)[2],
                                        bool two, const bf16* w, AOff a_off, BOff b_off,
                                        int lane) {
  if (two)
    gemm32_nb<false, KSTEPS, 2, false, MS>(acc, a_lane, w, a_off, b_off, lane);
  else
    gemm32_nb<false, KSTEPS, 1, false, MS>(acc, a_lane, w, a_off, b_off, lane);
}

template <int CIO, int TH>
__global__ void __launch_bounds__(THREADS, 1)
convres_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w2, const float* __restrict__ b2,
                   const bf16* __restrict__ w3, const float* __restrict__ b3,
                   const bf16* __restrict__ w4, bf16* __restrict__ dx,
                   float* __restrict__ part, int B, int H, int W, int residual) {
  using S = Tile<CIO, TH>;
  using L = Layout<CIO>;
  constexpr int W4 = S::W4, W3 = S::W3, W2 = S::W2, W1 = S::W1, XS = S::XS;
  constexpr int CH = CIO / 8;   // 16-byte pieces a pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* const w1s = sm;
  bf16* const w2s = sm + S::O_W2;
  bf16* const w3s = sm + S::O_W3;
  bf16* const w4s = sm + S::O_W4;
  float* const bs = reinterpret_cast<float*>(sm + S::O_B);   // b1 | b2 | b3
  bf16* const band = sm + S::O_X;        // R4 x XS: raw x (G1)
  bf16* const dys = band;                // R2 x XS: raw dy (after G1)
  bf16* const g2s = band + S::X_G2;      // R1 x MS
  bf16* const m3s = band + S::X_M3;      // T x MS
  bf16* const m1s = sm + S::O_M1;        // R4 x MS
  bf16* const m2s = sm + S::O_M2;        // R3 x MS
  bf16* const g3s = sm + S::O_G3;        // R2 x MS
  float* const dm1 = reinterpret_cast<float*>(sm + S::O_F);   // T x CM (dmi)
  float* const dm2 = dm1 + S::NT * CM;                        // R1 x CM (dmi)
  bf16* const m0s = sm + S::O_F;         // T x CIO, after T1
  bf16* const g1s = sm + S::O_F + S::F_G1;   // T x MS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int la = lane & 15, lk = (lane >> 4) * 8;   // A row (pixel), k half
  float* const pb = part + (size_t)blockIdx.x * L::N;

  for (int i = tid; i < L::N; i += THREADS) pb[i] = 0.f;
  for (int i = tid; i < CIO * CM; i += THREADS) {
    w1s[(i / CM) * MS + i % CM] = w1[i];     // w1 (CIO, CM)
    w4s[(i / CIO) * XS + i % CIO] = w4[i];   // w4 (CM, CIO)
  }
  for (int i = tid; i < 9 * CM * CM; i += THREADS) {
    w2s[(i / CM) * MS + i % CM] = w2[i];
    w3s[(i / CM) * MS + i % CM] = w3[i];
  }
  for (int i = tid; i < CM; i += THREADS) {
    bs[i] = b1[i];
    bs[CM + i] = b2[i];
    bs[2 * CM + i] = b3[i];
  }
  __syncthreads();

  // dw3 and dw2 of tap `warp` (ci x co, m16n8 fragments), over every tile
  float a3[2][4][4], a2[2][4][4];
  zero(a3);
  zero(a2);

  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int c0 = (tile % tiles_w) * TW, r0 = ((tile / tiles_w) % tiles_h) * TH;
    const int bi = tile / (tiles_w * tiles_h);
    const bf16* const xb = x + (size_t)bi * H * W * CIO;
    const bf16* const dyb = dy + (size_t)bi * H * W * CIO;
    bf16* const dxb = dx + (size_t)bi * H * W * CIO;
    auto inside = [&](int gr, int gc) { return gr >= 0 && gr < H && gc >= 0 && gc < W; };
    // a band of CIO channels on the tile grown by `grow` (row width wd),
    // zero outside the image, into dst by 16-byte cp.async
    auto load_band = [&](bf16* dst, const bf16* src, int grow, int wd, int n) {
      for (int i = tid; i < n * CH; i += THREADS) {
        const int px = i / CH, ch = i % CH;
        const int gr = r0 - grow + px / wd, gc = c0 - grow + px % wd;
        const bool in = inside(gr, gc);
        const bf16* s = in ? src + ((size_t)gr * W + gc) * CIO + ch * 8 : src;
        if (!(SKIP & 4)) cp_async16(dst + px * XS + ch * 8, s, in);
      }
      cp_async_commit();
    };

    load_band(band, xb, 4, W4, S::N4);
    cp_async_wait_all();
    __syncthreads();

    // G1 on R4: m1 = mish(round(mish(x)) . w1 + b1), 0 outside the
    // image; mish'(p1) on the tile
    for (int mt = warp; mt < S::M4; mt += 2 * NWARPS) {
      const bool two = mt + NWARPS < S::M4;
      const bf16* a_lane[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        a_lane[u] = band + min(16 * (mt + u * NWARPS) + la, S::N4 - 1) * XS + lk;
      float acc[2][4][4];
      gemm32<true, CIO / 16>(acc, a_lane, two, w1s, [](int s) { return 16 * s; }, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * (mt + u * NWARPS) + g + 8 * h;
          if (px >= S::N4) continue;
          const int pr = px / W4, pc = px % W4;
          const bool in = inside(r0 - 4 + pr, c0 - 4 + pc);
          const bool central = pr >= 4 && pr < TH + 4 && pc >= 4 && pc < TW + 4;
          const int pt = (pr - 4) * TW + pc - 4;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = 8 * nt + 2 * tq;
            float m0_, d0, m1_, d1;
            act_dact(acc[u][nt][2 * h] + bs[ch], m0_, d0);
            act_dact(acc[u][nt][2 * h + 1] + bs[ch + 1], m1_, d1);
            *reinterpret_cast<unsigned*>(m1s + px * MS + ch) = in ? pack2(m0_, m1_) : 0u;
            if (central) *reinterpret_cast<float2*>(dm1 + dmi(pt, ch)) = make_float2(d0, d1);
          }
        }
      }
    }
    __syncthreads();
    load_band(dys, dyb, 2, W2, S::N2);   // over the x band, under G2

    // G2 on R3: m2 = mish(conv3x3(m1) + b2), 0 outside the image;
    // mish'(p2) on R1
    for (int mt = warp; mt < S::M3; mt += 2 * NWARPS) {
      const bool two = mt + NWARPS < S::M3;
      const bf16* a_lane[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = min(16 * (mt + u * NWARPS) + la, S::N3 - 1);
        a_lane[u] = m1s + ((q / W3) * W4 + q % W3) * MS + lk;
      }
      float acc[2][4][4];
      // step s: tap s / 2 = (ky, kx), channels 16 (s % 2) on
      gemm32<false, 18>(acc, a_lane, two, w2s, [](int s) {
        const int t = s >> 1;
        return ((t / 3) * W4 + t % 3) * MS + 16 * (s & 1);
      }, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * (mt + u * NWARPS) + g + 8 * h;
          if (q >= S::N3) continue;
          const int qr = q / W3, qc = q % W3;
          const bool in = inside(r0 - 3 + qr, c0 - 3 + qc);
          const bool in1 = qr >= 2 && qr < TH + 4 && qc >= 2 && qc < TW + 4;
          const int q1 = (qr - 2) * W1 + qc - 2;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = 8 * nt + 2 * tq;
            float m0_, d0, m1_, d1;
            act_dact(acc[u][nt][2 * h] + bs[CM + ch], m0_, d0);
            act_dact(acc[u][nt][2 * h + 1] + bs[CM + ch + 1], m1_, d1);
            *reinterpret_cast<unsigned*>(m2s + q * MS + ch) = in ? pack2(m0_, m1_) : 0u;
            if (in1) *reinterpret_cast<float2*>(dm2 + dmi(q1, ch)) = make_float2(d0, d1);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // G3 and U3 on R2: p3 = conv3x3(m2) + b3, u3 = dy . w4^T;
    // g3 = round(u3 mish'(p3)) (0 outside the image, where dy is), m3 =
    // round(mish(p3)) on the tile
    for (int mt = warp; mt < S::M2; mt += NWARPS) {
      const int q = min(16 * mt + la, S::N2 - 1);
      const bf16* a_c[2] = {m2s + ((q / W2) * W3 + q % W2) * MS + lk, nullptr};
      const bf16* a_u[2] = {dys + q * XS + lk, nullptr};
      float acc[2][4][4], accu[2][4][4];
      gemm32_n<false, 18, 1>(acc, a_c, w3s, [](int s) {
        const int t = s >> 1;
        return ((t / 3) * W3 + t % 3) * MS + 16 * (s & 1);
      }, lane);
      gemm32_nb<false, CIO / 16, 1, false, XS>(accu, a_u, w4s, [](int s) { return 16 * s; },
                                               [](int s) { return 16 * s; }, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q2 = 16 * mt + g + 8 * h;
        if (q2 >= S::N2) continue;
        const int qr = q2 / W2, qc = q2 % W2;
        const bool central = qr >= 2 && qr < TH + 2 && qc >= 2 && qc < TW + 2;
        const int pt = (qr - 2) * TW + qc - 2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int ch = 8 * nt + 2 * tq;
          float m0_, d0, m1_, d1;
          act_dact(acc[0][nt][2 * h] + bs[2 * CM + ch], m0_, d0);
          act_dact(acc[0][nt][2 * h + 1] + bs[2 * CM + ch + 1], m1_, d1);
          *reinterpret_cast<unsigned*>(g3s + q2 * MS + ch) =
              pack2(accu[0][nt][2 * h] * d0, accu[0][nt][2 * h + 1] * d1);
          if (central) *reinterpret_cast<unsigned*>(m3s + pt * MS + ch) = pack2(m0_, m1_);
        }
      }
    }
    __syncthreads();

    // T2 on R1: g2 = round(conv3x3^T(g3, w3) mish'(p2)), 0 outside the
    // image; window position t = (a, b) reads w3's tap 8 - t
    for (int mt = warp; mt < S::M1; mt += 2 * NWARPS) {
      const bool two = mt + NWARPS < S::M1;
      const bf16* a_lane[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = min(16 * (mt + u * NWARPS) + la, S::N1 - 1);
        a_lane[u] = g3s + ((q / W1) * W2 + q % W1) * MS + lk;
      }
      float acc[2][4][4];
      gemm32t<18>(acc, a_lane, two, w3s, [](int s) {
        const int t = s >> 1;
        return ((t / 3) * W2 + t % 3) * MS + 16 * (s & 1);
      }, [](int s) { return (8 - (s >> 1)) * CM * MS + 16 * (s & 1); }, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * (mt + u * NWARPS) + g + 8 * h;
          if (q >= S::N1) continue;
          const bool in = inside(r0 - 1 + q / W1, c0 - 1 + q % W1);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = 8 * nt + 2 * tq;
            const float2 d = *reinterpret_cast<const float2*>(dm2 + dmi(q, ch));
            *reinterpret_cast<unsigned*>(g2s + q * MS + ch) =
                in ? pack2(acc[u][nt][2 * h] * d.x, acc[u][nt][2 * h + 1] * d.y) : 0u;
          }
        }
      }
    }
    __syncthreads();

    // T1 on the tile (m16 tile = tile row): g1 = round(conv3x3^T(g2, w2)
    // mish'(p1)), 0 outside the image
    for (int mt = warp; mt < S::MT; mt += 2 * NWARPS) {
      const bool two = mt + NWARPS < S::MT;
      const bf16* a_lane[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        a_lane[u] = g2s + (min(mt + u * NWARPS, S::MT - 1) * W1 + la) * MS + lk;
      float acc[2][4][4];
      gemm32t<18>(acc, a_lane, two, w2s, [](int s) {
        const int t = s >> 1;
        return ((t / 3) * W1 + t % 3) * MS + 16 * (s & 1);
      }, [](int s) { return (8 - (s >> 1)) * CM * MS + 16 * (s & 1); }, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt + u * NWARPS, col = g + 8 * h, pt = row * TW + col;
          const bool in = inside(r0 + row, c0 + col);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = 8 * nt + 2 * tq;
            const float2 d = *reinterpret_cast<const float2*>(dm1 + dmi(pt, ch));
            *reinterpret_cast<unsigned*>(g1s + pt * MS + ch) =
                in ? pack2(acc[u][nt][2 * h] * d.x, acc[u][nt][2 * h + 1] * d.y) : 0u;
          }
        }
      }
    }
    __syncthreads();

    // m0 on the tile for dw1 (over mish'(p1), read by now): round(mish(x)),
    // 0 outside the image
    for (int i = tid; i < S::NT * CH; i += THREADS) {
      const int pt = i / CH, ch = i % CH;
      const int gr = r0 + pt / TW, gc = c0 + pt % TW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (inside(gr, gc) && !(SKIP & 4)) {
        v = *reinterpret_cast<const uint4*>(xb + ((size_t)gr * W + gc) * CIO + ch * 8);
        v = make_uint4(act2(v.x), act2(v.y), act2(v.z), act2(v.w));
      }
      *reinterpret_cast<uint4*>(m0s + pt * CIO + m0_chunk<CH>(pt, ch) * 8) = v;
    }
    // D on the tile, 32 output channels j at a time: dx = (g1 . w1^T)
    // mish'(x) (+ dy)
    for (int item = warp; item < S::MT * (CIO / 32); item += NWARPS) {
      const int row = item % S::MT, j = item / S::MT;
      const bf16* a_lane[2] = {g1s + (row * TW + la) * MS + lk, nullptr};
      float acc[2][4][4];
      gemm32_nb<false, 2, 1, false, MS>(acc, a_lane, w1s, [](int s) { return 16 * s; },
                                        [j](int s) { return j * 32 * MS + 16 * s; }, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = g + 8 * h, gr = r0 + row, gc = c0 + col;
        if (!inside(gr, gc)) continue;
        const size_t o = ((size_t)gr * W + gc) * CIO;
        const bf16* const dyp = dys + ((row + 2) * W2 + col + 2) * XS;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int ci = 32 * j + 8 * nt + 2 * tq;
          const unsigned xv = (SKIP & 4) ? 0u : *reinterpret_cast<const unsigned*>(xb + o + ci);
          float m_, d0, d1;
          act_dact(lo_f(xv), m_, d0);
          act_dact(hi_f(xv), m_, d1);
          float v0 = acc[0][nt][2 * h] * d0, v1 = acc[0][nt][2 * h + 1] * d1;
          if (residual) {
            const unsigned dv = *reinterpret_cast<const unsigned*>(dyp + ci);
            v0 += lo_f(dv);
            v1 += hi_f(dv);
          }
          if (!(SKIP & 4)) *reinterpret_cast<unsigned*>(dxb + o + ci) = pack2(v0, v1);
        }
      }
    }
    __syncthreads();

    // stage B, the weight and bias gradients over the tile's rows in the
    // image (every operand is 0 at a pixel outside it: m0, g1 and g2
    // masked, g3 and dy on dy's zero band), each a k-step of 16 pixels on
    // the tensor cores: every warp tap `warp` of dw3 and dw2; warp u < 2 NJ
    // 32 columns of dw4 (u < NJ, with db4's) or 32 rows of dw1 (with db1
    // at the first); the last warp db3 and db2
    if (!(SKIP & 8)) {
      const int nr = min(TH, H - r0);
      // this lane's ldmatrix.trans row: of A^T (M = its channels) pixel ap,
      // channel ac; of B (N = its channels) pixel bp, channel bc
      // (gemm32_nb's BT rows)
      const int ap = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) << 3;
      const int bp = lane & 15, bc = (lane >> 4) << 3;
      {   // dw3, dw2 of tap (ky, kx): m(P + off) at P + (ky, kx) in m's window
        const int ky = warp / 3, kx = warp % 3;
        const bf16* const m2a = m2s + ((2 + ky) * W3 + 2 + kx + ap) * MS + ac;
        const bf16* const g3b = g3s + (2 * W2 + 2 + bp) * MS + bc;
        const bf16* const m1a = m1s + ((3 + ky) * W4 + 3 + kx + ap) * MS + ac;
        const bf16* const g2b = g2s + (W1 + 1 + bp) * MS + bc;
        for (int pr = 0; pr < nr; ++pr) {
          unsigned b3[2][4], b2[2][4];
          wload_b(b3, g3b + pr * W2 * MS);
          wload_b(b2, g2b + pr * W1 * MS);
          wsum(a3, m2a + pr * W3 * MS, m2a + pr * W3 * MS + 16, b3);
          wsum(a2, m1a + pr * W4 * MS, m1a + pr * W4 * MS + 16, b2);
        }
      }
      constexpr int NJ = CIO / 32;
      static_assert(2 * NJ < NWARPS, "a warp for each dw4 and dw1 piece, one for db3, db2");
      if (warp < 2 * NJ) {
        // dw4 (CM, CIO) columns 32 j.. = sum m3^T dy, or dw1 (CIO, CM)
        // rows 32 j.. = sum m0^T g1
        const bool d4 = warp < NJ;
        const int j = d4 ? warp : warp - NJ;
        const bool sums = d4 || j == 0;   // db4's columns 32 j.., or db1
        float acc[2][4][4], s[4][4];
        zero(acc);
        zero(s);
        for (int pr = 0; pr < nr; ++pr) {
          unsigned bf[2][4];
          if (d4) {
            const bf16* const a = m3s + (pr * TW + ap) * MS + ac;
            wload_b(bf, dys + ((pr + 2) * W2 + 2 + bp) * XS + 32 * j + bc);
            wsum(acc, a, a + 16, bf);
          } else {
            const int pt = pr * TW + ap, c8 = 4 * j + (ac >> 3);
            wload_b(bf, g1s + (pr * TW + bp) * MS + bc);
            wsum(acc, m0s + pt * CIO + m0_chunk<CH>(pt, c8) * 8,
                 m0s + pt * CIO + m0_chunk<CH>(pt, c8 + 2) * 8, bf);
          }
          if (sums) wcolsum(s, bf);
        }
        if (d4) {
          wstore<true>(pb + L::DW4 + 32 * j, CIO, acc, lane);
          wstore_sum(pb + L::DB4 + 32 * j, s, lane);
        } else {
          wstore<true>(pb + L::DW1 + 32 * j * CM, CM, acc, lane);
          if (sums) wstore_sum(pb + L::DB1, s, lane);
        }
      } else if (warp == NWARPS - 1) {
        float s3[4][4], s2[4][4];
        zero(s3);
        zero(s2);
        for (int pr = 0; pr < nr; ++pr) {
          unsigned bf[2][4];
          wload_b(bf, g3s + ((pr + 2) * W2 + 2 + bp) * MS + bc);
          wcolsum(s3, bf);
          wload_b(bf, g2s + ((pr + 1) * W1 + 1 + bp) * MS + bc);
          wcolsum(s2, bf);
        }
        wstore_sum(pb + L::DB3, s3, lane);
        wstore_sum(pb + L::DB2, s2, lane);
      }
    }
    __syncthreads();   // the next tile's band overwrites X
  }

  // dw3, dw2 of tap `warp`: this warp's sums over the block's tiles
  wstore<false>(pb + L::DW3 + warp * CM * CM, CM, a3, lane);
  wstore<false>(pb + L::DW2 + warp * CM * CM, CM, a2, lane);
}

template <int CIO, int TH>
int launch(const void* x, const void* dy, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* w4, void* dx,
           void* part, int B, int H, int W, int residual, int nblk, cudaStream_t stream) {
  using S = Tile<CIO, TH>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        convres_bwd_kernel<CIO, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  convres_bwd_kernel<CIO, TH><<<nblk, THREADS, S::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)dy, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)w4, (bf16*)dx,
      (float*)part, B, H, W, residual);
  return (int)cudaGetLastError();
}

}  // namespace tc

// K3 on dtype T, then the in-order reduce of the blocks' partials
template <int CIO>
int launch_all(const void* x, const void* dy, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* w3, const void* b3,
               const void* w4, void* dx, void* part, void* out, int B, int H, int W,
               int residual, int nblk, int dtype, cudaStream_t stream) {
  constexpr int TH = CIO == 128 ? 4 : 8;   // the bf16 tile's rows
  const int err =
      dtype == 1
          ? tc::launch<CIO, TH>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, B, H, W,
                                residual, nblk, stream)
          : f32::launch_fma<float, CIO>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, B, H,
                                        W, residual, nblk, stream);
  if (err != 0) return err;
  const int n = Layout<CIO>::N;
  convres_bwd_reduce<<<(n + 255) / 256, 256, 0, stream>>>((const float*)part, nblk, n,
                                                         (float*)out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

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
// blocks walk over the output tiles.  bfloat16: x and dy 16-byte
// aligned.
int convres_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* w3, const void* b3,
                const void* w4, void* dx, void* part, void* out, int B, int H, int W,
                int C, int residual, int nblk, int dtype, void* stream) {
  if (nblk < 1 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if ((long long)H * W * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (!aligned16(x) || !aligned16(dy)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 32: return launch_all<32>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B, H,
                                   W, residual, nblk, dtype, s);
    case 64: return launch_all<64>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B, H,
                                   W, residual, nblk, dtype, s);
    case 128: return launch_all<128>(x, dy, w1, b1, w2, b2, w3, b3, w4, dx, part, out, B,
                                     H, W, residual, nblk, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
