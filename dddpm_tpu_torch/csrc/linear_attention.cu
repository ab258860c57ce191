// Linear attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of dddpm_tpu/ops/pallas/linear_attention.py:
// _ctx_kernel (entry lin_ctx) and _out_kernel (entry lin_out), reached
// from linear_attention -> _fused_forward.
//
// What it computes, on q, k, v (B, N, HD) with HD = heads x DH, DH a
// multiple of 32 (ops/linear_attention.py pads a narrower or ragged head
// with zero dimensions, which change no output it keeps):
//   p   = exp(k - m), m the max over tokens per channel (f32)
//   s   = sum over tokens of p                               (f32)
//   ctx = blockdiag over heads of (p^T v) / s, row d by s_d   (f32)
//   out = q @ round(ctx), f32 sums, rounded to q's type
// round() is to q's type: the TPU kernel casts ctx to q's type before
// its product.
//
// What bounds it on an H100: q, k and v are read once and out written
// once, 4 B N HD elements, for ~(4 + 4 DH) FLOPs a token per channel: at
// the x2 UNet's five attention sites (B = 8, HD = 128, DH = 32, bf16)
// 218 MB, ~65 us at 3.35 TB/s.  The bound is bytes.
//
// What this design does about it: the softmax never leaves the chip.
// On the TPU the token grid runs in order, so one running max m, sum s
// and accumulator A carry across it.  Here blocks run in no order, so
// each sample's tokens are split into chunks, one block each
// (lin_ctx_partial): a block walks its chunk's 64-token tiles with its
// own running max, rescaling s and A by exp(m_old - m_new) per tile, and
// writes its partial (m, s, A).  A second kernel (lin_ctx_reduce, a
// block a head of a sample) merges the partials in chunk order, each
// rescaled by exp(m_i - m) for the global max m, and writes ctx:
// deterministic, no atomics.  Only the heads' DH x DH diagonal blocks of A are formed
// (the TPU kernel forms all of A and masks it; the rest of ctx is zero
// in both), each as (DH / 32)^2 blocks of 32 x 32, one a thread block,
// so that any head width runs the same kernel.  The third kernel
// (lin_out) reads each q tile once a 32-column block of out and writes
// out once.  FMA loops, no tensor cores: simple and exact, not fast.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SB = 32;         // a block of A: 32 x 32 of one head
constexpr int TN = 64;         // tokens per tile
constexpr int THREADS = 256;
constexpr int EPT = SB * SB / THREADS;   // entries of A's block a thread (4)
constexpr int NG = THREADS / SB;         // token groups of a column reduction (8)

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

// grid (nchunks, B, heads x (DH / 32)^2).  Chunk c covers token tiles
// [c*tpc, (c+1)*tpc) of sample b; the block's 32 x 32 block of A is rows
// r0 .. r0 + 31 (k channels) by columns e0 .. e0 + 31 (v channels) of
// head h.  It writes that block of A and, when it is the row's first
// column block, the rows' running max m and sum s, all relative to its
// own m.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lin_ctx_partial(const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ part_m, float* __restrict__ part_s,
                float* __restrict__ part_a, int N, int HD, int DH, int tpc) {
  __shared__ float ks[TN * SB];   // k, then p
  __shared__ float vs[TN * SB];
  __shared__ float mrun[SB], srun[SB], alpha[SB];
  __shared__ float part[NG][SB];  // a column's max or sum over each token group
  const int nb = DH / SB;
  const int chunk = blockIdx.x, bi = blockIdx.y, nchunks = gridDim.x;
  const int h = blockIdx.z / (nb * nb), rb = (blockIdx.z / nb) % nb, cb = blockIdx.z % nb;
  const int kc0 = h * DH + rb * SB, vc0 = h * DH + cb * SB;   // first k, v channel
  const int t = threadIdx.x;
  const int dd = t / (SB / EPT);          // row of A's block
  const int e0 = (t % (SB / EPT)) * EPT;  // its columns
  const int rc = t % SB, rg = t / SB;     // column reductions: column, token group
  float acc[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) acc[q] = 0.f;
  if (t < SB) {
    mrun[t] = -INFINITY;
    srun[t] = 0.f;
  }

  const int ntiles = (N + TN - 1) / TN;
  const int tile_end = min(ntiles, (chunk + 1) * tpc);
  const size_t base = (size_t)bi * N * HD;
  for (int tile = chunk * tpc; tile < tile_end; ++tile) {
    const int n0 = tile * TN;
    const int rows = min(TN, N - n0);
    __syncthreads();
    for (int i = t; i < TN * SB; i += THREADS) {
      const int n = i / SB, c = i % SB;
      const bool in = n < rows;
      ks[i] = in ? to_f(k[base + (size_t)(n0 + n) * HD + kc0 + c]) : 0.f;
      vs[i] = in ? to_f(v[base + (size_t)(n0 + n) * HD + vc0 + c]) : 0.f;
    }
    __syncthreads();
    // the tile's column max: each of NG token groups, then the groups
    {
      float mt = -INFINITY;
      for (int n = rg; n < rows; n += NG) mt = fmaxf(mt, ks[n * SB + rc]);
      part[rg][rc] = mt;
    }
    __syncthreads();
    if (t < SB) {
      float mt = part[0][t];
#pragma unroll
      for (int g = 1; g < NG; ++g) mt = fmaxf(mt, part[g][t]);
      const float mnew = fmaxf(mrun[t], mt);
      alpha[t] = expf(mrun[t] - mnew);     // 0 on the first tile
      mrun[t] = mnew;
    }
    __syncthreads();
    for (int i = t; i < TN * SB; i += THREADS)
      ks[i] = i / SB < rows ? expf(ks[i] - mrun[i % SB]) : 0.f;
    __syncthreads();
    {   // the column sums of p, the same way (in group order)
      float ps = 0.f;
      for (int n = rg; n < rows; n += NG) ps += ks[n * SB + rc];
      part[rg][rc] = ps;
    }
    __syncthreads();
    if (t < SB) {
      float ps = part[0][t];
#pragma unroll
      for (int g = 1; g < NG; ++g) ps += part[g][t];
      srun[t] = srun[t] * alpha[t] + ps;
    }
    float pa[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) pa[q] = 0.f;
    for (int n = 0; n < rows; ++n) {
      const float p = ks[n * SB + dd];
      const float* vrow = vs + n * SB + e0;
#pragma unroll
      for (int q = 0; q < EPT; ++q) pa[q] = fmaf(p, vrow[q], pa[q]);
    }
    const float a = alpha[dd];
#pragma unroll
    for (int q = 0; q < EPT; ++q) acc[q] = acc[q] * a + pa[q];
  }
  __syncthreads();
  const size_t slot = (size_t)bi * nchunks + chunk;
  // part_a (B, nchunks, heads, DH, DH)
  float* pa_out = part_a + (slot * (HD / DH) + h) * DH * DH +
                  (size_t)(rb * SB + dd) * DH + cb * SB + e0;
#pragma unroll
  for (int q = 0; q < EPT; ++q) pa_out[q] = acc[q];
  if (t < SB && cb == 0) {
    part_m[slot * HD + kc0 + t] = mrun[t];
    part_s[slot * HD + kc0 + t] = srun[t];
  }
}

// grid (B, heads).  Merges the partials of head h of a sample in chunk
// order: m = max m_i, s = sum s_i exp(m_i - m), A = sum A_i exp(m_i - m)
// (row-wise), and writes the head's rows of ctx (HD x HD, f32): A / s on
// its diagonal block, 0 elsewhere.
__global__ void __launch_bounds__(THREADS)
lin_ctx_reduce(const float* __restrict__ part_m, const float* __restrict__ part_s,
               const float* __restrict__ part_a, float* __restrict__ ctx, int HD,
               int DH, int nchunks) {
  extern __shared__ float red[];   // mg (DH), sg (DH)
  float* mg = red;
  float* sg = red + DH;
  const int bi = blockIdx.x, h = blockIdx.y, heads = HD / DH;
  const size_t slot0 = (size_t)bi * nchunks;
  for (int d = threadIdx.x; d < DH; d += THREADS) {
    const int c = h * DH + d;
    float m = -INFINITY;
    for (int i = 0; i < nchunks; ++i) m = fmaxf(m, part_m[(slot0 + i) * HD + c]);
    float s = 0.f;
    for (int i = 0; i < nchunks; ++i)
      s += part_s[(slot0 + i) * HD + c] * expf(part_m[(slot0 + i) * HD + c] - m);
    mg[d] = m;
    sg[d] = s;
  }
  __syncthreads();
  float* rows = ctx + ((size_t)bi * HD + (size_t)h * DH) * HD;   // the head's DH rows
  for (int idx = threadIdx.x; idx < DH * DH; idx += THREADS) {
    const int d = idx / DH, e = idx % DH;
    float a = 0.f;
    for (int i = 0; i < nchunks; ++i)
      a += part_a[((slot0 + i) * heads + h) * DH * DH + idx] *
           expf(part_m[(slot0 + i) * HD + h * DH + d] - mg[d]);
    rows[(size_t)d * HD + h * DH + e] = a / sg[d];
  }
  for (int idx = threadIdx.x; idx < DH * HD; idx += THREADS) {
    const int c = idx % HD;
    if (c / DH != h) rows[idx] = 0.f;
  }
}

// grid (ntiles, B, heads x DH / 32).  out[n, e] = sum_d q[n, d]
// round(ctx)[d, e] over the head of e, for the block's 32 columns e of
// head h, d in 32-row steps; f32 sums, rounded to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lin_out(const T* __restrict__ q, const float* __restrict__ ctx, T* __restrict__ out,
        int N, int HD, int DH) {
  __shared__ float qs[TN * SB];   // 64 tokens x 32 d
  __shared__ float cs[SB * SB];   // 32 d x 32 e, rounded to T
  const int nb = DH / SB;
  const int n0 = blockIdx.x * TN, bi = blockIdx.y;
  const int h = blockIdx.z / nb, e0 = h * DH + (blockIdx.z % nb) * SB;
  const int rows = min(TN, N - n0);
  const int t = threadIdx.x, ty = t / 32, tx = t % 32;
  const size_t base = ((size_t)bi * N + n0) * HD;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int d0 = h * DH; d0 < (h + 1) * DH; d0 += SB) {
    __syncthreads();
    for (int i = t; i < TN * SB; i += THREADS)
      qs[i] = i / SB < rows ? to_f(q[base + (size_t)(i / SB) * HD + d0 + i % SB]) : 0.f;
    for (int i = t; i < SB * SB; i += THREADS)
      cs[i] = rnd<T>(ctx[(size_t)bi * HD * HD + (size_t)(d0 + i / SB) * HD + e0 + i % SB]);
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < SB; ++d) {
      const float c = cs[d * SB + tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(qs[(ty * 8 + i) * SB + d], c, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r < rows) out[base + (size_t)r * HD + e0 + tx] = from_f<T>(acc[i]);
  }
}

template <typename T>
int ctx_launch(const void* k, const void* v, void* part_m, void* part_s, void* part_a,
               void* ctx, int B, int N, int HD, int DH, int nchunks, int tpc,
               cudaStream_t stream) {
  const int nb = DH / SB;
  lin_ctx_partial<T><<<dim3(nchunks, B, (HD / DH) * nb * nb), THREADS, 0, stream>>>(
      (const T*)k, (const T*)v, (float*)part_m, (float*)part_s, (float*)part_a, N, HD,
      DH, tpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = 2 * DH * (int)sizeof(float);
  err = cudaFuncSetAttribute(lin_ctx_reduce, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  lin_ctx_reduce<<<dim3(B, HD / DH), THREADS, smem, stream>>>(
      (const float*)part_m, (const float*)part_s, (const float*)part_a, (float*)ctx, HD, DH,
      nchunks);
  return (int)cudaGetLastError();
}

template <typename T>
int out_launch(const void* q, const void* ctx, void* out, int B, int N, int HD, int DH,
               cudaStream_t stream) {
  lin_out<T><<<dim3((N + TN - 1) / TN, B, HD / SB), THREADS, 0, stream>>>(
      (const T*)q, (const float*)ctx, (T*)out, N, HD, DH);
  return (int)cudaGetLastError();
}

bool widths_ok(int HD, int DH) {
  return DH >= SB && DH % SB == 0 && HD >= DH && HD % DH == 0 && 2 * DH * 4 <= 227 * 1024;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  k, v (B, N, HD) of dtype, HD =
// heads x DH, DH a multiple of 32; part_m, part_s (B, nchunks, HD) f32;
// part_a (B, nchunks, heads, DH, DH) f32 (scratch); ctx (B, HD, HD) f32.
int lin_ctx(const void* k, const void* v, void* part_m, void* part_s,
            void* part_a, void* ctx, int B, int N, int HD, int DH, int nchunks,
            int tiles_per_chunk, int dtype, void* stream) {
  if (!widths_ok(HD, DH)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return ctx_launch<__nv_bfloat16>(k, v, part_m, part_s, part_a, ctx, B, N, HD, DH,
                                     nchunks, tiles_per_chunk, (cudaStream_t)stream);
  return ctx_launch<float>(k, v, part_m, part_s, part_a, ctx, B, N, HD, DH, nchunks,
                           tiles_per_chunk, (cudaStream_t)stream);
}

// q, out (B, N, HD) of dtype; ctx (B, HD, HD) f32; HD = heads x DH.
int lin_out(const void* q, const void* ctx, void* out, int B, int N, int HD, int DH,
            int dtype, void* stream) {
  if (!widths_ok(HD, DH)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return out_launch<__nv_bfloat16>(q, ctx, out, B, N, HD, DH, (cudaStream_t)stream);
  return out_launch<float>(q, ctx, out, B, N, HD, DH, (cudaStream_t)stream);
}

}  // extern "C"
