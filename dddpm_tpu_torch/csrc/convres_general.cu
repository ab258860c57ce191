// The ConvResBlock's width-general route for Hopper (sm_90a): its forward
// (entry convres_fwd_general, K2 at every width but the tuned ones) and
// its backward (entry convres_bwd_general, K3 likewise), both dtypes.
//
// Replaces the TPU kernels dddpm_tpu/ops/pallas/convres.py:_fwd_kernel
// and _bwd_kernel at the widths where the tuned kernels (convres_fwd.cu,
// convres_bwd.cu: CM = 32 mid channels, CIO in {32, 64, 128}) do not
// apply: the JAX gate admits any CM and CIO that are multiples of 32
// (dddpm_tpu/models/resample.py:_fused_shape_ok), and a ConvResNet's
// block is ConvResBlock(d_chans / 2, d_chans, d_chans).
//
// What it computes, on x (B, H, W, CIO) NHWC, HWIO weights, f32 biases:
// what the tuned kernels compute (ops/convres.py: reference_impl and
// backward_reference):
//   forward   m0 = mish(x), m1 = mish(m0 @ w1 + b1),
//             m2 = mish(conv3x3(m1, w2) + b2), m3 = mish(conv3x3(m2, w3) + b3),
//             o = m3 @ w4 + b4 (+ x), y = o | 2x nearest ('up') | 2x2 mean ('down')
//   backward  g3 = (dy @ w4^T) mish'(p3), g2 = conv3x3^T(g3, w3) mish'(p2),
//             g1 = conv3x3^T(g2, w2) mish'(p1), dx = (g1 @ w1^T) mish'(x) (+ dy),
//             dw4 = sum m3^T dy, dw3[k] = sum m2(P + off_k)^T g3(P),
//             dw2[k] = sum m1(P + off_k)^T g2(P), dw1 = sum m0^T g1, and the
//             bias gradients: the sums of dy, g3, g2, g1 over every pixel
// m0..m3, o and g3..g1 are rounded to the activation type where the
// tuned kernels round them, mish' is taken of the f32 pre-activation,
// the SAME padding of each 3x3 is a zero of its input (m1, m2, g3, g2
// are zero outside the image), 'down' pools the rounded o in f32, and
// the weight and bias gradients come out in f32.
//
// What bounds it on an H100: at d_chans 128 (CM 64, CIO 128) a pixel
// takes 2 (2 CIO CM + 18 CM^2) = 180 kFLOP forward and about three
// times that backward, against 2 CIO activation values in and out: in
// bf16 ~700 FLOP a byte, above the ridge, so the products bound it.
//
// What this design does about it, simply (a right kernel first): the
// block is a chain of implicit GEMMs, one launch per conv, each
// intermediate (m1..m3, g3..g1 in the activation type, mish'(p1..p3) in
// f32) a whole tensor in device memory; a tile's 3x3 halo comes from
// there (L2), so no tile has to hold a halo of 2 (forward) or 4
// (backward) pixels and the CM x CM weights in shared memory, which is
// what fixes the tuned kernels to CM 32.  Every width is a runtime
// argument, in 32-channel steps:
//   conv_gemm   out[P, n] = epilogue(sum_t sum_k A(P + off_t)[k] B_t[k][n]):
//               a 64-pixel x 64-channel output tile a block, K walked in
//               slabs of one tap x 32 channels (the weights read a slab
//               at a time from L2, never held whole); A and B staged in
//               shared memory as f32, each of 256 threads 4 x 4 sums,
//               FMA on the CUDA cores.  B_t is w[t] ([k][n]) or, for the
//               data gradients, w[taps - 1 - t] read transposed.  The
//               prologue takes mish of A where A is x (m0); the epilogue
//               is the stage's: + b, mish, round (and mish' kept), or
//               + b (+ x) with the scaling, or x mish'(p), or x mish'(x)
//               + dy.  For 'down' the last conv walks the pixels quad
//               by quad, a thread's 4 pixels one 2x2 quad, so that it
//               pools the rounded o in registers.
//   conv_wgrad  the weight and bias gradients as one GEMM a weight,
//               rows (tap, k) of A(P + off_t) and a row of ones for the
//               bias, columns of g, K = the pixels, split into S chunks
//               of pixels (S fixed from the shapes: enough blocks for
//               the card, at most 64): each block writes its chunk's f32
//               partial, and convres_reduce sums the S partials in chunk
//               order.  Deterministic: no atomics, and the partials'
//               room is S x (taps K + 1) x N floats, bounded by S.
// The batch runs in chunks of samples of at most 2^19 pixels (or one
// sample), so that the intermediates take 2 x 2^19 x CM elements
// (forward), or 6 x 2^19 x CM and as many floats again in f32 (backward),
// whatever B is; the backward sums
// each chunk's weight gradients onto the last chunk's, in chunk order.
// There is no width ceiling: shared memory is 17 KB a block at any width.
// Not done: tensor cores (mma.sync or wgmma) for bf16, the intermediates
// kept on chip.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on the
// stream it is given, allocates nothing (the caller gives the scratch),
// does not synchronise and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take,
// cudaErrorMisalignedAddress for a pointer that is not 16-byte aligned).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mish_sm90.cuh"   // mish, mish_dmish (ex2 + rcp)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;        // output pixels (conv) or rows (wgrad) a block
constexpr int BN = 64;        // output channels a block
constexpr int BK = 32;        // K a slab: one tap x 32 channels, or 32 pixels
constexpr int PAD = 4;        // floats past a staged row (16-byte aligned rows)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 sums each
constexpr int WGRAD_BLOCKS = 512;   // the wgrad's blocks it aims at (fixed: same S on any card)
constexpr int MAX_CHUNKS = 64;
constexpr long long CHUNK_PIXELS = 1 << 19;   // pixels of a batch chunk

enum { EPI_MID = 0, EPI_OUT = 1, EPI_GRAD = 2, EPI_DX = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// 8 consecutive values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 consecutive values (8 or 16 bytes, aligned) as floats, and back
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

// One conv of the chain.  A is `in` (P = B H W pixels x K channels,
// NHWC); B_t is w[t] as [k][n] (trans 0: HWIO, K x N a tap) or
// w[taps - 1 - t] read as [n][k] (trans 1: the data gradient of an HWIO
// conv with N inputs and K outputs).  The epilogue, on v = the sum:
//   EPI_MID   v += bias; out = round(mish(v)); aux (if given) = mish'(v)
//   EPI_OUT   v += bias (+ add); out = round(v), at (2r + a, 2c + b) for
//             a, b in {0, 1} when scale is 1 ('up'); with `quad` (scale
//             2, 'down') the pixels come quad by quad (P = 4 q + d, d the
//             row-major place in 2x2 quad q) and out = round(0.25 (sum of
//             the quad's round(v), in f32)) at quad q
//   EPI_GRAD  out = round(v dmul)
//   EPI_DX    out = round(v mish'(xin) (+ add))
template <typename T>
struct ConvArgs {
  const T* in;
  const T* w;
  int taps, trans, K, N, pro, epi, scale, quad;
  const float* bias;
  const T* add;
  const float* dmul;
  const T* xin;
  T* out;
  float* aux;
  int B, H, W;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_gemm(const ConvArgs<T> a) {
  __shared__ __align__(16) float As[BK][BM + PAD];   // [k][pixel]
  __shared__ __align__(16) float Bs[BK][BN + PAD];   // [k][n]
  const int H = a.H, W = a.W, K = a.K, N = a.N;
  const long long P = (long long)a.B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // this thread's A piece: pixel m0 + lp, channels lc..lc + 7 of a slab
  const int lp = tid >> 2, lc = (tid & 3) * 8;
  const long long p = m0 + lp;
  const bool pin = p < P;
  int pb = 0, pr = 0, pc = 0;
  if (pin && a.quad) {
    const long long q = p >> 2;
    const int d = (int)(p & 3), Ho = H / 2, Wo = W / 2;
    pb = (int)(q / ((long long)Ho * Wo));
    pr = 2 * (int)((q / Wo) % Ho) + (d >> 1);
    pc = 2 * (int)(q % Wo) + (d & 1);
  } else if (pin) {
    pb = (int)(p / ((long long)H * W));
    pr = (int)((p / W) % H);
    pc = (int)(p % W);
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < a.taps; ++t) {
    const int dy = a.taps == 9 ? t / 3 - 1 : 0, dx = a.taps == 9 ? t % 3 - 1 : 0;
    const int sr = pr + dy, sc = pc + dx;
    const bool ain = pin && sr >= 0 && sr < H && sc >= 0 && sc < W;
    const T* arow = ain ? a.in + (((size_t)pb * H + sr) * W + sc) * K : a.in;
    const T* wt = a.w + (size_t)(a.trans ? a.taps - 1 - t : t) * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
      float v[8];
      if (ain) {
        load8(arow + k0 + lc, v);
        if (a.pro) {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = rnd<T>(mish(v[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) As[lc + j][lp] = v[j];
      float u[8];
      if (!a.trans) {   // 32 k rows x 64 n: row tid / 8, 8 n at (tid % 8) * 8
        const int kr = tid >> 3, nc = (tid & 7) * 8;
        if (n0 + nc < N) {
          load8(wt + (size_t)(k0 + kr) * N + n0 + nc, u);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) u[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[kr][nc + j] = u[j];
      } else {          // 64 n rows x 32 k: row tid / 4, 8 k at (tid % 4) * 8
        const int nr = tid >> 2, kc = (tid & 3) * 8;
        if (n0 + nr < N) {
          load8(wt + (size_t)(n0 + nr) * K + k0 + kc, u);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) u[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[kc + j][nr] = u[j];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: pixels m0 + 4 ty + i, channels n0 + 4 tx .. + 3
  const int n = n0 + tx * 4;
  if (n >= N) return;
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = a.bias[n + j];
  }
  if (a.quad) {   // EPI_OUT, 'down': this thread's 4 pixels are quad q
    if (m0 + ty * 4 >= P) return;
    const long long q = (m0 + ty * 4) >> 2;
    const int Ho = H / 2, Wo = W / 2;
    const int qb = (int)(q / ((long long)Ho * Wo));
    const int qr = (int)((q / Wo) % Ho), qc = (int)(q % Wo);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      if (a.add)
        load4(a.add + (((size_t)qb * H + 2 * qr + i / 2) * W + 2 * qc + i % 2) * N + n, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += rnd<T>(acc[i][j] + bias[j] + r[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] *= 0.25f;
    store4(a.out + (size_t)q * N + n, s);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long q = m0 + ty * 4 + i;
    if (q >= P) break;
    const size_t e = (size_t)q * N + n;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = acc[i][j];
    if (a.epi == EPI_MID) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float m;
        mish_dmish(v[j] + bias[j], m, d[j]);
        v[j] = m;
      }
      store4(a.out + e, v);
      if (a.aux) store4(a.aux + e, d);
    } else if (a.epi == EPI_OUT) {
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      if (a.add) load4(a.add + e, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = v[j] + bias[j] + r[j];
      if (a.scale == 1) {
        const int qb = (int)(q / ((long long)H * W));
        const int qr = (int)((q / W) % H), qc = (int)(q % W);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          store4(a.out + (((size_t)qb * 2 * H + 2 * qr + s / 2) * 2 * W + 2 * qc + s % 2) * N + n,
                 v);
      } else {
        store4(a.out + e, v);
      }
    } else if (a.epi == EPI_GRAD) {
      float d[4];
      load4(a.dmul + e, d);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] *= d[j];
      store4(a.out + e, v);
    } else {   // EPI_DX
      float xv[4], r[4] = {0.f, 0.f, 0.f, 0.f};
      load4(a.xin + e, xv);
      if (a.add) load4(a.add + e, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float m, d;
        mish_dmish(xv[j], m, d);
        v[j] = v[j] * d + r[j];
      }
      store4(a.out + e, v);
    }
  }
}

// The weight and bias gradients of one conv, for pixels [c0, c1) of
// chunk blockIdx.z:  part[z][r][n] = sum_P A_r(P) g(P)[n], rows r = t K
// + k (A_r(P) = in(P + off_t)[k], 0 outside the image; with `pro`,
// round(mish(in))) and, with `bias_row`, r = taps K (A_r = 1); with
// `accum`, added to what part holds.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_wgrad(const T* __restrict__ in, const T* __restrict__ g, float* __restrict__ part,
           int taps, int K, int N, int pro, int bias_row, int B, int H, int W,
           long long chunk, int accum) {
  __shared__ __align__(16) float As[BK][BM + PAD];   // [pixel][row]
  __shared__ __align__(16) float Gs[BK][BN + PAD];   // [pixel][n]
  const long long P = (long long)B * H * W;
  const int R = taps * K + (bias_row ? 1 : 0);
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long c0 = blockIdx.z * chunk;
  const long long c1 = c0 + chunk < P ? c0 + chunk : P;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // loads: A pixel tid / 8, rows r0 + (tid % 8) * 8 ..; g pixel tid / 8,
  // channels n0 + (tid % 8) * 8 ..
  const int lp = tid >> 3, l8 = (tid & 7) * 8;
  const int ra = r0 + l8;
  const int ta = ra < taps * K ? ra / K : 0, ka = ra < taps * K ? ra % K : 0;
  const int dy = taps == 9 ? ta / 3 - 1 : 0, dx = taps == 9 ? ta % 3 - 1 : 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long p0 = c0; p0 < c1; p0 += BK) {
    const long long p = p0 + lp;
    float v[8], u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = u[j] = 0.f;
    if (p < c1) {
      const int pb = (int)(p / ((long long)H * W));
      const int pr = (int)((p / W) % H), pc = (int)(p % W);
      if (ra < taps * K) {
        const int sr = pr + dy, sc = pc + dx;
        if (sr >= 0 && sr < H && sc >= 0 && sc < W) {
          load8(in + (((size_t)pb * H + sr) * W + sc) * K + ka, v);
          if (pro) {
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = rnd<T>(mish(v[j]));
          }
        }
      } else if (ra == taps * K && bias_row) {
        v[0] = 1.f;
      }
      if (n0 + l8 < N) load8(g + (size_t)p * N + n0 + l8, u);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      As[lp][l8 + j] = v[j];
      Gs[lp][l8 + j] = u[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 gv = *reinterpret_cast<const float4*>(&Gs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], gr[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* pz = part + (size_t)blockIdx.z * R * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= R) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) pz[(size_t)r * N + n] = accum ? pz[(size_t)r * N + n] + acc[i][j] : acc[i][j];
    }
  }
}

// out[e] = sum over chunks, in chunk order, of part[s][e] (with `accum`,
// added to out[e])
__global__ void convres_reduce(const float* __restrict__ part, int S, long long n,
                               float* __restrict__ out, int accum) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += part[(size_t)z * n + e];
  out[e] = accum ? out[e] + s : s;
}

// samples of a batch chunk: at most CHUNK_PIXELS pixels, at least one
int batch_chunk(int B, int H, int W) {
  const long long n = CHUNK_PIXELS / ((long long)H * W);
  return (int)(n < 1 ? 1 : n > B ? B : n);
}

template <typename T>
cudaError_t conv(const ConvArgs<T>& a, cudaStream_t stream) {
  const long long P = (long long)a.B * a.H * a.W;
  const long long mb = (P + BM - 1) / BM;
  if (mb > 0x7fffffff) return cudaErrorInvalidValue;
  conv_gemm<T><<<dim3((unsigned)mb, (a.N + BN - 1) / BN), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// the number of pixel chunks of a wgrad of R x N outputs over P pixels
int wgrad_chunks(long long P, int R, int N) {
  const long long tiles = (long long)((R + BM - 1) / BM) * ((N + BN - 1) / BN);
  long long s = (WGRAD_BLOCKS + tiles - 1) / tiles;
  const long long most = (P + 8 * BK - 1) / (8 * BK);   // at least 8 slabs a chunk
  if (s > most) s = most;
  if (s > MAX_CHUNKS) s = MAX_CHUNKS;
  return s < 1 ? 1 : (int)s;
}

// dW (taps K x N) and db (N) of one conv into out (taps K + 1 rows x N,
// f32; with accum, added to it), through part (at least S x that)
template <typename T>
cudaError_t wgrad(const T* in, const T* g, float* part, float* out, int taps, int K, int N,
                  int pro, int B, int H, int W, int accum, cudaStream_t stream) {
  const long long P = (long long)B * H * W;
  const int R = taps * K + 1;
  const int S = wgrad_chunks(P, R, N);
  long long chunk = (P + S - 1) / S;
  chunk = (chunk + BK - 1) / BK * BK;
  float* dst = S == 1 ? out : part;
  conv_wgrad<T><<<dim3((R + BM - 1) / BM, (N + BN - 1) / BN, S), THREADS, 0, stream>>>(
      in, g, dst, taps, K, N, pro, 1, B, H, W, chunk, S == 1 && accum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const long long n = (long long)R * N;
  convres_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, S, n, out, accum);
  return cudaGetLastError();
}

template <typename T>
ConvArgs<T> conv_args(const T* in, const T* w, int taps, int trans, int K, int N,
                      int B, int H, int W) {
  ConvArgs<T> a;
  a.in = in; a.w = w; a.taps = taps; a.trans = trans; a.K = K; a.N = N;
  a.pro = 0; a.epi = EPI_MID; a.scale = 0; a.quad = 0;
  a.bias = nullptr; a.add = nullptr; a.dmul = nullptr; a.xin = nullptr;
  a.out = nullptr; a.aux = nullptr;
  a.B = B; a.H = H; a.W = W;
  return a;
}

#define TRY(call)                                \
  do {                                           \
    const cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

// one batch chunk of the forward
template <typename T>
int forward(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
            const T* w3, const float* b3, const T* w4, const float* b4, T* y, T* ws,
            int B, int H, int W, int C, int CM, int residual, int scale,
            cudaStream_t stream) {
  const size_t pm = (size_t)B * H * W * CM;
  T* m1 = ws;            // m1, then m3
  T* m2 = ws + pm;
  ConvArgs<T> a = conv_args<T>(x, w1, 1, 0, C, CM, B, H, W);
  a.pro = 1;
  a.bias = b1;
  a.out = m1;
  TRY(conv(a, stream));
  a = conv_args<T>(m1, w2, 9, 0, CM, CM, B, H, W);
  a.bias = b2;
  a.out = m2;
  TRY(conv(a, stream));
  a = conv_args<T>(m2, w3, 9, 0, CM, CM, B, H, W);
  a.bias = b3;
  a.out = m1;
  TRY(conv(a, stream));
  a = conv_args<T>(m1, w4, 1, 0, CM, C, B, H, W);
  a.epi = EPI_OUT;
  a.bias = b4;
  a.add = residual ? x : nullptr;
  a.scale = scale == 1;
  a.quad = scale == 2;
  a.out = y;
  TRY(conv(a, stream));
  return 0;
}

// one batch chunk of the backward: its weight gradients added to grads
// with accum
template <typename T>
int backward(const T* x, const T* dy, const T* w1, const float* b1, const T* w2,
             const float* b2, const T* w3, const float* b3, const T* w4, T* dx,
             float* grads, T* ws, float* wsf, float* part, int B, int H, int W, int C,
             int CM, int residual, int accum, cudaStream_t stream) {
  const size_t pm = (size_t)B * H * W * CM;
  T* m1 = ws;
  T* m2 = ws + pm;
  T* m3 = ws + 2 * pm;
  T* g3 = ws + 3 * pm;
  T* g2 = ws + 4 * pm;
  T* g1 = ws + 5 * pm;
  float* d1 = wsf;   // mish'(p1), mish'(p2), mish'(p3)
  float* d2 = wsf + pm;
  float* d3 = wsf + 2 * pm;
  // the recompute: m1..m3 and mish'(p1..p3)
  ConvArgs<T> a = conv_args<T>(x, w1, 1, 0, C, CM, B, H, W);
  a.pro = 1; a.bias = b1; a.out = m1; a.aux = d1;
  TRY(conv(a, stream));
  a = conv_args<T>(m1, w2, 9, 0, CM, CM, B, H, W);
  a.bias = b2; a.out = m2; a.aux = d2;
  TRY(conv(a, stream));
  a = conv_args<T>(m2, w3, 9, 0, CM, CM, B, H, W);
  a.bias = b3; a.out = m3; a.aux = d3;
  TRY(conv(a, stream));
  // the data gradients
  a = conv_args<T>(dy, w4, 1, 1, C, CM, B, H, W);
  a.epi = EPI_GRAD; a.dmul = d3; a.out = g3;
  TRY(conv(a, stream));
  a = conv_args<T>(g3, w3, 9, 1, CM, CM, B, H, W);
  a.epi = EPI_GRAD; a.dmul = d2; a.out = g2;
  TRY(conv(a, stream));
  a = conv_args<T>(g2, w2, 9, 1, CM, CM, B, H, W);
  a.epi = EPI_GRAD; a.dmul = d1; a.out = g1;
  TRY(conv(a, stream));
  a = conv_args<T>(g1, w1, 1, 1, CM, C, B, H, W);
  a.epi = EPI_DX; a.xin = x; a.add = residual ? dy : nullptr; a.out = dx;
  TRY(conv(a, stream));
  // the weight and bias gradients, in the layout dw1 db1 dw2 db2 dw3 db3 dw4 db4
  float* o = grads;
  TRY(wgrad<T>(x, g1, part, o, 1, C, CM, 1, B, H, W, accum, stream));
  o += (size_t)(C + 1) * CM;
  TRY(wgrad<T>(m1, g2, part, o, 9, CM, CM, 0, B, H, W, accum, stream));
  o += (size_t)(9 * CM + 1) * CM;
  TRY(wgrad<T>(m2, g3, part, o, 9, CM, CM, 0, B, H, W, accum, stream));
  o += (size_t)(9 * CM + 1) * CM;
  TRY(wgrad<T>(m3, dy, part, o, 1, CM, C, 0, B, H, W, accum, stream));
  return 0;
}

template <typename T>
int forward_chunks(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
                   const T* w3, const float* b3, const T* w4, const float* b4, T* y, T* ws,
                   int B, int H, int W, int C, int CM, int residual, int scale,
                   cudaStream_t stream) {
  const int bc = batch_chunk(B, H, W);
  const size_t in_px = (size_t)H * W;
  const size_t out_px = scale == 1 ? 4 * in_px : scale == 2 ? in_px / 4 : in_px;
  for (int b0 = 0; b0 < B; b0 += bc) {
    const int err = forward<T>(x + b0 * in_px * C, w1, b1, w2, b2, w3, b3, w4, b4,
                               y + b0 * out_px * C, ws, B - b0 < bc ? B - b0 : bc, H, W, C,
                               CM, residual, scale, stream);
    if (err) return err;
  }
  return 0;
}

template <typename T>
int backward_chunks(const T* x, const T* dy, const T* w1, const float* b1, const T* w2,
                    const float* b2, const T* w3, const float* b3, const T* w4, T* dx,
                    float* grads, T* ws, float* wsf, float* part, int B, int H, int W,
                    int C, int CM, int residual, cudaStream_t stream) {
  const int bc = batch_chunk(B, H, W);
  const size_t px = (size_t)H * W * C;
  for (int b0 = 0; b0 < B; b0 += bc) {
    const int err = backward<T>(x + b0 * px, dy + b0 * px, w1, b1, w2, b2, w3, b3, w4,
                                dx + b0 * px, grads, ws, wsf, part,
                                B - b0 < bc ? B - b0 : bc, H, W, C, CM, residual, b0 > 0,
                                stream);
    if (err) return err;
  }
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool shape_ok(int B, int H, int W, int C, int CM) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 32 && CM >= 32 && C % 32 == 0 &&
         CM % 32 == 0;
}

}  // namespace

extern "C" {

// Samples of a batch chunk at H x W: the scratch below is sized for them.
int convres_general_samples(int B, int H, int W) { return batch_chunk(B, H, W); }

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, C) NHWC; w1 (C, CM); w2,
// w3 (3, 3, CM, CM) HWIO; w4 (CM, C); all of x's type; b1, b2, b3 (CM)
// and b4 (C) float32; C and CM multiples of 32.  y is (B, H, W, C), (B,
// 2H, 2W, C) for scale 1, (B, H/2, W/2, C) for scale 2 (H, W even);
// scratch holds 2 Bc H W CM elements of x's type (m1 and m2; m3 over
// m1), Bc = convres_general_samples(B, H, W).
// Every pointer 16-byte aligned.
int convres_fwd_general(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* w3, const void* b3, const void* w4,
                        const void* b4, void* y, void* scratch, int B, int H, int W,
                        int C, int CM, int residual, int scale, int dtype, void* stream) {
  if (!shape_ok(B, H, W, C, CM) || scale < 0 || scale > 2 ||
      (scale == 2 && (H % 2 || W % 2)) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, w1, b1, w2, b2, w3, b3, w4, b4, y, scratch};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return forward_chunks<bf16>((const bf16*)x, (const bf16*)w1, (const float*)b1,
                         (const bf16*)w2, (const float*)b2, (const bf16*)w3,
                         (const float*)b3, (const bf16*)w4, (const float*)b4, (bf16*)y,
                         (bf16*)scratch, B, H, W, C, CM, residual, scale, s);
  return forward_chunks<float>((const float*)x, (const float*)w1, (const float*)b1,
                        (const float*)w2, (const float*)b2, (const float*)w3,
                        (const float*)b3, (const float*)w4, (const float*)b4, (float*)y,
                        (float*)scratch, B, H, W, C, CM, residual, scale, s);
}

// The backward's scratch: `scratch` 6 Bc H W CM elements of x's type
// (m1..m3, g3..g1), `scratch_f32` 3 Bc H W CM floats (mish'(p1..p3)),
// Bc = convres_general_samples(B, H, W); `part` convres_bwd_general_part
// floats (the wgrads' partials).
long long convres_bwd_general_part(int B, int H, int W, int C, int CM) {
  const long long P = (long long)batch_chunk(B, H, W) * H * W;
  long long most = 0;
  const int rows[4] = {C + 1, 9 * CM + 1, 9 * CM + 1, CM + 1};
  const int cols[4] = {CM, CM, CM, C};
  for (int i = 0; i < 4; ++i) {
    const long long n = (long long)wgrad_chunks(P, rows[i], cols[i]) * rows[i] * cols[i];
    if (n > most) most = n;
  }
  return most;
}

// x, dy, dx (B, H, W, C); weights as for the forward (b4 is not read);
// grads: the eight gradients in float32, dw1 (C, CM), db1 (CM), dw2 (3,
// 3, CM, CM), db2, dw3, db3, dw4 (CM, C), db4 (C), one after another.
int convres_bwd_general(const void* x, const void* dy, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* w3, const void* b3,
                        const void* w4, void* dx, void* grads, void* scratch,
                        void* scratch_f32, void* part, int B, int H, int W, int C, int CM,
                        int residual, int dtype, void* stream) {
  if (!shape_ok(B, H, W, C, CM) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, dy, w1, b1, w2, b2, w3, b3, w4, dx, grads, scratch,
                        scratch_f32, part};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return backward_chunks<bf16>((const bf16*)x, (const bf16*)dy, (const bf16*)w1,
                          (const float*)b1, (const bf16*)w2, (const float*)b2,
                          (const bf16*)w3, (const float*)b3, (const bf16*)w4, (bf16*)dx,
                          (float*)grads, (bf16*)scratch, (float*)scratch_f32,
                          (float*)part, B, H, W, C, CM, residual, s);
  return backward_chunks<float>((const float*)x, (const float*)dy, (const float*)w1,
                         (const float*)b1, (const float*)w2, (const float*)b2,
                         (const float*)w3, (const float*)b3, (const float*)w4, (float*)dx,
                         (float*)grads, (float*)scratch, (float*)scratch_f32,
                         (float*)part, B, H, W, C, CM, residual, s);
}

}  // extern "C"
