// Linear attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of dddpm_tpu/ops/pallas/linear_attention.py:
// _ctx_kernel (entry lin_ctx) and _out_kernel (entry lin_out), reached
// from linear_attention -> _fused_forward.
//
// What it computes, on q, k, v (B, N, HD) with HD = heads x 32:
//   p   = exp(k - m), m the max over tokens per channel (f32)
//   s   = sum over tokens of p                               (f32)
//   ctx = blockdiag over heads of (p^T v) / s, row d by s_d   (f32)
//   out = q @ round(ctx), f32 sums, rounded to q's type
// round() is to q's type: the TPU kernel casts ctx to q's type before
// its product.
//
// What bounds it on an H100: q, k and v are read once and out written
// once, 4 B N HD elements, for ~128 FLOPs a token per channel: at the
// x2 UNet's five attention sites (B = 8, HD = 128, bf16) 218 MB, ~65 us
// at 3.35 TB/s.  The bound is bytes.
//
// What this design does about it: the softmax never leaves the chip.
// On the TPU the token grid runs in order, so one running max m, sum s
// and accumulator A carry across it.  Here blocks run in no order, so
// each sample's tokens are split into chunks, one block each
// (lin_ctx_partial): a block walks its chunk's 64-token tiles with its
// own running max, rescaling s and A by exp(m_old - m_new) per tile, and
// writes its partial (m, s, A).  A second kernel (lin_ctx_reduce)
// merges the partials of a sample in chunk order, each rescaled by
// exp(m_i - m) for the global max m, and writes ctx: deterministic, no
// atomics.  Only the heads' 32 x 32 diagonal blocks of A are formed (the
// TPU kernel forms all of A and masks it; the rest of ctx is zero in
// both).  The third kernel (lin_out) reads each q tile once and writes
// out once.  FMA loops, no tensor cores: simple and exact, not fast.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DH = 32;         // dim_head
constexpr int TN = 64;         // tokens per tile
constexpr int THREADS = 256;

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

// grid (nchunks, B).  Chunk c covers token tiles [c*tpc, (c+1)*tpc) of
// sample b; it writes its running max m (HD), sum s (HD) and the heads'
// diagonal blocks of A (heads x 32 x 32), all relative to its own m.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
lin_ctx_partial(const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ part_m, float* __restrict__ part_s,
                float* __restrict__ part_a, int N, int tpc) {
  constexpr int HEADS = HD / DH;
  constexpr int TPR = THREADS / HD;   // threads per row d of A
  constexpr int EPT = DH / TPR;       // entries of the row per thread
  extern __shared__ float smem[];
  float* ks = smem;                   // TN x HD: k, then p
  float* vs = ks + TN * HD;           // TN x HD
  float* mrun = vs + TN * HD;         // HD running max
  float* srun = mrun + HD;            // HD running sum
  float* alpha = srun + HD;           // HD rescale of this tile
  const int chunk = blockIdx.x, bi = blockIdx.y, nchunks = gridDim.x;
  const int t = threadIdx.x;
  const int dd = t / TPR;                 // row of A (k channel)
  const int h = dd / DH;
  const int e0 = (t % TPR) * EPT;         // columns within the head
  float acc[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) acc[q] = 0.f;
  if (t < HD) {
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
    for (int i = t; i < TN * HD; i += THREADS) {
      const bool in = i / HD < rows;
      ks[i] = in ? to_f(k[base + (size_t)n0 * HD + i]) : 0.f;
      vs[i] = in ? to_f(v[base + (size_t)n0 * HD + i]) : 0.f;
    }
    __syncthreads();
    if (t < HD) {
      float mt = -INFINITY;
      for (int n = 0; n < rows; ++n) mt = fmaxf(mt, ks[n * HD + t]);
      const float mnew = fmaxf(mrun[t], mt);
      alpha[t] = expf(mrun[t] - mnew);     // 0 on the first tile
      mrun[t] = mnew;
    }
    __syncthreads();
    for (int i = t; i < TN * HD; i += THREADS)
      ks[i] = i / HD < rows ? expf(ks[i] - mrun[i % HD]) : 0.f;
    __syncthreads();
    if (t < HD) {
      float ps = 0.f;
      for (int n = 0; n < rows; ++n) ps += ks[n * HD + t];
      srun[t] = srun[t] * alpha[t] + ps;
    }
    float pa[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) pa[q] = 0.f;
    for (int n = 0; n < rows; ++n) {
      const float p = ks[n * HD + dd];
      const float* vrow = vs + n * HD + h * DH + e0;
#pragma unroll
      for (int q = 0; q < EPT; ++q) pa[q] = fmaf(p, vrow[q], pa[q]);
    }
    const float a = alpha[dd];
#pragma unroll
    for (int q = 0; q < EPT; ++q) acc[q] = acc[q] * a + pa[q];
  }
  __syncthreads();
  const size_t slot = (size_t)bi * nchunks + chunk;
  float* pa_out = part_a + slot * HEADS * DH * DH + (size_t)dd * DH + e0;
#pragma unroll
  for (int q = 0; q < EPT; ++q) pa_out[q] = acc[q];
  if (t < HD) {
    part_m[slot * HD + t] = mrun[t];
    part_s[slot * HD + t] = srun[t];
  }
}

// grid (B).  Merges a sample's partials in chunk order: m = max m_i,
// s = sum s_i exp(m_i - m), A = sum A_i exp(m_i - m) (row-wise), and
// writes ctx (HD x HD, f32) = blockdiag(A / s).
__global__ void __launch_bounds__(THREADS)
lin_ctx_reduce(const float* __restrict__ part_m, const float* __restrict__ part_s,
               const float* __restrict__ part_a, float* __restrict__ ctx, int HD,
               int nchunks) {
  __shared__ float mg[128], sg[128];
  const int bi = blockIdx.x, heads = HD / DH;
  const size_t slot0 = (size_t)bi * nchunks;
  for (int c = threadIdx.x; c < HD; c += THREADS) {
    float m = -INFINITY;
    for (int i = 0; i < nchunks; ++i) m = fmaxf(m, part_m[(slot0 + i) * HD + c]);
    float s = 0.f;
    for (int i = 0; i < nchunks; ++i)
      s += part_s[(slot0 + i) * HD + c] * expf(part_m[(slot0 + i) * HD + c] - m);
    mg[c] = m;
    sg[c] = s;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < HD * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    float val = 0.f;
    if (r / DH == c / DH) {
      float a = 0.f;
      for (int i = 0; i < nchunks; ++i)
        a += part_a[(slot0 + i) * heads * DH * DH + (size_t)r * DH + c % DH] *
             expf(part_m[(slot0 + i) * HD + r] - mg[r]);
      val = a / sg[r];
    }
    ctx[(size_t)bi * HD * HD + idx] = val;
  }
}

// grid (ntiles, B).  out[n, e] = sum_d q[n, d] round(ctx)[d, e] over the
// head of e, f32 sums, rounded to T.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
lin_out(const T* __restrict__ q, const float* __restrict__ ctx,
        T* __restrict__ out, int N) {
  constexpr int HEADS = HD / DH;
  extern __shared__ float smem[];
  float* qs = smem;              // TN x HD
  float* cs = qs + TN * HD;      // HEADS x 32 x 32, rounded to T
  const int n0 = blockIdx.x * TN, bi = blockIdx.y;
  const int rows = min(TN, N - n0);
  const int t = threadIdx.x, ty = t / 32, tx = t % 32;
  const size_t base = ((size_t)bi * N + n0) * HD;
  for (int i = t; i < TN * HD; i += THREADS)
    qs[i] = i / HD < rows ? to_f(q[base + i]) : 0.f;
  for (int i = t; i < HEADS * DH * DH; i += THREADS) {
    const int h = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    cs[i] = rnd<T>(ctx[(size_t)bi * HD * HD + (size_t)(h * DH + d) * HD + h * DH + e]);
  }
  __syncthreads();
  float acc[8][HEADS];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < HEADS; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
#pragma unroll
    for (int j = 0; j < HEADS; ++j) {
      const float c = cs[(j * DH + d) * DH + tx];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i][j] = fmaf(qs[(ty * 8 + i) * HD + j * DH + d], c, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < HEADS; ++j)
      out[base + (size_t)r * HD + j * DH + tx] = from_f<T>(acc[i][j]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int HD>
int ctx_launch(const void* k, const void* v, void* part_m, void* part_s,
               void* part_a, void* ctx, int B, int N, int nchunks, int tpc,
               cudaStream_t stream) {
  const int smem = (2 * TN * HD + 3 * HD) * (int)sizeof(float);
  cudaError_t err = allow_smem(lin_ctx_partial<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  lin_ctx_partial<T, HD><<<dim3(nchunks, B), THREADS, smem, stream>>>(
      (const T*)k, (const T*)v, (float*)part_m, (float*)part_s, (float*)part_a,
      N, tpc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lin_ctx_reduce<<<B, THREADS, 0, stream>>>(
      (const float*)part_m, (const float*)part_s, (const float*)part_a,
      (float*)ctx, HD, nchunks);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int out_launch(const void* q, const void* ctx, void* out, int B, int N,
               cudaStream_t stream) {
  const int smem = (TN * HD + (HD / DH) * DH * DH) * (int)sizeof(float);
  cudaError_t err = allow_smem(lin_out<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  lin_out<T, HD><<<dim3((N + TN - 1) / TN, B), THREADS, smem, stream>>>(
      (const T*)q, (const float*)ctx, (T*)out, N);
  return (int)cudaGetLastError();
}

template <typename T>
int ctx_launch_hd(const void* k, const void* v, void* part_m, void* part_s,
                  void* part_a, void* ctx, int B, int N, int HD, int nchunks,
                  int tpc, cudaStream_t stream) {
  switch (HD) {
    case 32: return ctx_launch<T, 32>(k, v, part_m, part_s, part_a, ctx, B, N,
                                      nchunks, tpc, stream);
    case 64: return ctx_launch<T, 64>(k, v, part_m, part_s, part_a, ctx, B, N,
                                      nchunks, tpc, stream);
    case 128: return ctx_launch<T, 128>(k, v, part_m, part_s, part_a, ctx, B, N,
                                        nchunks, tpc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int out_launch_hd(const void* q, const void* ctx, void* out, int B, int N,
                  int HD, cudaStream_t stream) {
  switch (HD) {
    case 32: return out_launch<T, 32>(q, ctx, out, B, N, stream);
    case 64: return out_launch<T, 64>(q, ctx, out, B, N, stream);
    case 128: return out_launch<T, 128>(q, ctx, out, B, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  k, v (B, N, HD) of dtype, HD in
// {32, 64, 128}; part_m, part_s (B, nchunks, HD) f32; part_a (B,
// nchunks, HD / 32, 32, 32) f32 (scratch); ctx (B, HD, HD) f32.
int lin_ctx(const void* k, const void* v, void* part_m, void* part_s,
            void* part_a, void* ctx, int B, int N, int HD, int nchunks,
            int tiles_per_chunk, int dtype, void* stream) {
  if (dtype == 1)
    return ctx_launch_hd<__nv_bfloat16>(k, v, part_m, part_s, part_a, ctx, B, N,
                                        HD, nchunks, tiles_per_chunk,
                                        (cudaStream_t)stream);
  return ctx_launch_hd<float>(k, v, part_m, part_s, part_a, ctx, B, N, HD,
                              nchunks, tiles_per_chunk, (cudaStream_t)stream);
}

// q, out (B, N, HD) of dtype; ctx (B, HD, HD) f32.
int lin_out(const void* q, const void* ctx, void* out, int B, int N, int HD,
            int dtype, void* stream) {
  if (dtype == 1)
    return out_launch_hd<__nv_bfloat16>(q, ctx, out, B, N, HD,
                                        (cudaStream_t)stream);
  return out_launch_hd<float>(q, ctx, out, B, N, HD, (cudaStream_t)stream);
}

}  // extern "C"
