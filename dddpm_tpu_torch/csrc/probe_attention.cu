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
// What this design does about it: nothing yet; it measures.  The
// products are the FMA tiles of the shipped kernels (csrc/
// attention_block.cu: 8 x NC outputs a thread, f32 sums, weights staged
// KC rows at a time), so each variant's time reads against K1a and K1b.
// The grid is (N / tn, B / G) with the probe's own tn; a block walks its
// G samples one after the other and each sample's tn tokens in
// sub-tiles of TN = 64.  Pass A keeps the whole 128 x 128 A of one
// sample in registers (an 8 x 8 block a thread) and writes it as a
// partial per (sample, token tile); probe_ctx_reduce sums the partials
// in tile order (no atomics, runs repeat bit for bit).  The variant and
// G are template parameters, so a variant's removed work is gone from
// its code, not branched around.  The dma variants use 16-byte loads;
// pass A's folds every loaded word into an XOR that it stores, so no
// load can be dropped.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HIDDEN = 128;       // width of k and of v
constexpr int KV = 2 * HIDDEN;    // width of [Wk | Wv]
constexpr int TN = 64;            // tokens per sub-tile
constexpr int KC = 32;            // weight rows staged in shared memory
constexpr int THREADS = 256;
constexpr float K_CLAMP = 60.0f;
constexpr float LN_EPS = 1e-5f;

// pass-A variants, then pass-B variants (the Python wrapper's order)
enum { A_FULL = 0, A_NOEXP = 1, A_NOLN = 2, A_PAYLOAD = 3, A_DMA = 4 };
enum { B_FULL = 0, B_NOLN = 1, B_DMA = 2 };

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rnd(float v) {   // round to bf16 and back
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One sub-tile of `rows` tokens into lns (TN x C f32), rows past `rows`
// zero.  With LN: (x - m) / (sqrt(max(E[x^2] - m^2, 0)) + eps) * g + b
// rounded to bf16, where at C <= 128 x^2 is rounded to bf16 before its
// sum (the probe's dot(x * x, ones)); without: x itself.
template <bool LN>
__device__ void stage_tile(const bf16* xt, int rows, int C, const float* g,
                           const float* b, float* lns) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, m = C / 32;
  for (int r = warp; r < TN; r += THREADS / 32) {
    if (r >= rows) {
      for (int c = lane; c < C; c += 32) lns[r * C + c] = 0.f;
      continue;
    }
    float v[8], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = i < m ? to_f(xt[(size_t)r * C + lane + 32 * i]) : 0.f;
      s1 += v[i];
      s2 += C <= 128 ? rnd(v[i] * v[i]) : v[i] * v[i];
    }
    float mean = 0.f, den = 1.f;
    if (LN) {
      mean = warp_sum(s1) / C;
      den = sqrtf(fmaxf(warp_sum(s2) / C - mean * mean, 0.f)) + LN_EPS;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < m) {
        const int c = lane + 32 * i;
        lns[r * C + c] = LN ? rnd((v[i] - mean) / den * g[c] + b[c]) : v[i];
      }
    }
  }
}

// acc[i][j] += sum_k A[(ty*8+i)*K + k] * W[k][tx + 32*j] over k < K, for
// the TN x (32*NC) output tile; A in shared memory, W (K x 32*NC, row
// major, bf16) staged KC rows at a time through Ws.  K % KC == 0.
template <int NC>
__device__ void gemm_tile(const float* A, int K, const bf16* W, float* Ws,
                          float (&acc)[8][NC]) {
  constexpr int NOUT = 32 * NC;
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * NOUT; i += THREADS)
      Ws[i] = to_f(W[(size_t)k0 * NOUT + i]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[8], w[NC];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty * 8 + i) * K + k0 + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) w[j] = Ws[kk * NOUT + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

// y = x over nv 16-byte words, four loads in flight a thread before
// their stores (x and y may alias, so the compiler would not hoist a
// load above the previous store by itself)
__device__ void copy_words(const uint4* x, uint4* y, size_t nv) {
  for (size_t i = threadIdx.x; i < nv; i += 4 * THREADS) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * THREADS < nv) v[u] = x[i + u * THREADS];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * THREADS < nv) y[i + u * THREADS] = v[u];
  }
}

// Pass A's dma: XOR of every 16-byte word of `count` bf16 values, folded
// into part_s[0] as a tiny finite float (exponent bits cleared); the
// other 127 entries are zero.  ctx = 0 / max(s, 1) = 0 whatever it is.
__device__ void dma_item(const bf16* xs, size_t count, float* ps) {
  __shared__ uint32_t hs[THREADS / 32];
  const uint4* src = reinterpret_cast<const uint4*>(xs);
  const size_t nv = count * sizeof(bf16) / 16;
  uint32_t h[4] = {0u, 0u, 0u, 0u};
  size_t i = threadIdx.x;
  for (; i + 3 * THREADS < nv; i += 4 * THREADS) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = src[i + u * THREADS];
#pragma unroll
    for (int u = 0; u < 4; ++u) h[u] ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  for (; i < nv; i += THREADS) {
    const uint4 v = src[i];
    h[0] ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  uint32_t hh = h[0] ^ h[1] ^ h[2] ^ h[3];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hh ^= __shfl_xor_sync(0xffffffffu, hh, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) hs[threadIdx.x / 32] = hh;
  __syncthreads();
  if (threadIdx.x < HIDDEN) {
    float v = 0.f;
    if (threadIdx.x == 0) {
      uint32_t all = 0u;
      for (int w = 0; w < THREADS / 32; ++w) all ^= hs[w];
      v = __uint_as_float(all & 0x007fffffu);
    }
    ps[threadIdx.x] = v;
  }
}

// Pass A, one sample's token tile of tn tokens: its partial A (128 x 128)
// into pa and partial s (128) into ps.
// smem: (TN*C + KC*KV + TN*KV) floats.
template <int V>
__device__ void ctx_item(const bf16* xs, int tn, int C, const float* g,
                         const float* b, const bf16* wkv, float* pa, float* ps,
                         float* smem) {
  float* lns = smem;              // TN x C
  float* ws = lns + TN * C;       // KC x KV
  float* kv = ws + KC * KV;       // TN x KV: p (unrounded) | v (rounded)
  const int t = threadIdx.x, ty = t / 32, tx = t % 32;
  const int ar = (t / 16) * 8, ac = (t % 16) * 8;   // this thread's 8 x 8 of A
  float acc_a[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_a[i][j] = 0.f;
  float acc_s = 0.f;

  for (int n0 = 0; n0 < tn; n0 += TN) {
    const int rows = min(TN, tn - n0);
    __syncthreads();   // lns and kv free
    stage_tile<V == A_FULL || V == A_NOEXP>(xs + (size_t)n0 * C, rows, C, g, b, lns);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    gemm_tile<8>(lns, C, wkv, ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 32 * j;
        const float a = acc[i][j];
        float v = 0.f;   // padding rows add nothing
        if (r < rows) {
          if (col >= HIDDEN) v = rnd(a);
          else if (V == A_PAYLOAD) v = a;
          else if (V == A_NOEXP) v = fminf(a, K_CLAMP);
          else v = expf(fminf(a, K_CLAMP));
        }
        kv[r * KV + col] = v;
      }
    }
    __syncthreads();
    if (V != A_PAYLOAD && t < HIDDEN)
      for (int n = 0; n < rows; ++n) acc_s += kv[n * KV + t];
    for (int n = 0; n < rows; ++n) {
      const float4* pr = reinterpret_cast<const float4*>(kv + n * KV + ar);
      const float4* vr = reinterpret_cast<const float4*>(kv + n * KV + HIDDEN + ac);
      const float4 p0 = pr[0], p1 = pr[1], v0 = vr[0], v1 = vr[1];
      const float p[8] = {rnd(p0.x), rnd(p0.y), rnd(p0.z), rnd(p0.w),
                          rnd(p1.x), rnd(p1.y), rnd(p1.z), rnd(p1.w)};
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_a[i][j] = fmaf(p[i], v[j], acc_a[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4* out = reinterpret_cast<float4*>(pa + (ar + i) * HIDDEN + ac);
    out[0] = make_float4(acc_a[i][0], acc_a[i][1], acc_a[i][2], acc_a[i][3]);
    out[1] = make_float4(acc_a[i][4], acc_a[i][5], acc_a[i][6], acc_a[i][7]);
  }
  if (t < HIDDEN) ps[t] = acc_s;
}

// Pass A: grid (nt, B / G); block (j, q) takes token tile j of samples
// q*G .. q*G+G-1.  Partials: part_a (B, nt, 128, 128), part_s (B, nt, 128).
template <int V, int G>
__global__ void __launch_bounds__(THREADS)
probe_ctx_kernel(const bf16* x, const float* g, const float* b, const bf16* wkv,
                 float* part_a, float* part_s, int N, int C, int tn) {
  extern __shared__ __align__(16) float smem[];
  const int j = blockIdx.x, nt = gridDim.x;
  for (int gi = 0; gi < G; ++gi) {
    const int bi = blockIdx.y * G + gi;
    const size_t slot = (size_t)bi * nt + j;
    const bf16* xs = x + ((size_t)bi * N + (size_t)j * tn) * C;
    if constexpr (V == A_DMA)
      dma_item(xs, (size_t)tn * C, part_s + slot * HIDDEN);
    else
      ctx_item<V>(xs, tn, C, g, b, wkv, part_a + slot * HIDDEN * HIDDEN,
                  part_s + slot * HIDDEN, smem);
  }
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

// Pass B, one sub-tile of `rows` tokens at xt: y = x + ln @ w + b_out.
// smem: (TN*C + KC*C) floats.
template <int V, int NC>
__device__ void out_tile(const bf16* xt, int rows, const float* g, const float* b,
                         const bf16* w, const float* b_out, bf16* yt,
                         float* smem) {
  constexpr int C = 32 * NC;
  float* lns = smem;            // TN x C
  float* ws = lns + TN * C;     // KC x C
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  __syncthreads();   // lns free
  stage_tile<V == B_FULL>(xt, rows, C, g, b, lns);
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  gemm_tile<NC>(lns, C, w, ws, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 32 * j;
      const size_t at = (size_t)r * C + col;
      yt[at] = __float2bfloat16(to_f(xt[at]) + (acc[i][j] + b_out[col]));
    }
  }
}

// Pass B: grid (nt, B / G), as pass A.  dma: y = x in 16-byte words,
// as P2's copy_kernel moves them (csrc/probe_copy.cu).
template <int V, int G, int NC>
__global__ void __launch_bounds__(THREADS)
probe_out_kernel(const bf16* x, const float* g, const float* b, const bf16* weff,
                 const float* b_out, bf16* y, int N, int tn) {
  constexpr int C = 32 * NC;
  extern __shared__ __align__(16) float smem[];
  const int j = blockIdx.x;
  for (int gi = 0; gi < G; ++gi) {
    const int bi = blockIdx.y * G + gi;
    const size_t base = ((size_t)bi * N + (size_t)j * tn) * C;
    if constexpr (V == B_DMA) {
      copy_words(reinterpret_cast<const uint4*>(x + base),
                 reinterpret_cast<uint4*>(y + base),
                 (size_t)tn * C * sizeof(bf16) / 16);
    } else {
      for (int n0 = 0; n0 < tn; n0 += TN)
        out_tile<V, NC>(x + base + (size_t)n0 * C, min(TN, tn - n0), g, b,
                        weff + (size_t)bi * C * C, b_out, y + base + (size_t)n0 * C,
                        smem);
    }
  }
}

template <int V, int G>
int ctx_launch(const void* x, const void* g, const void* b, const void* wkv,
               void* part_a, void* part_s, int B, int N, int C, int tn,
               cudaStream_t stream) {
  const int smem = V == A_DMA ? 0 : (TN * C + KC * KV + TN * KV) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_ctx_kernel<V, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_ctx_kernel<V, G><<<dim3(N / tn, B / G), THREADS, smem, stream>>>(
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

template <int V, int G, int NC>
int out_launch(const void* x, const void* g, const void* b, const void* weff,
               const void* b_out, void* y, int B, int N, int tn,
               cudaStream_t stream) {
  constexpr int C = 32 * NC;
  const int smem = V == B_DMA ? 0 : (TN * C + KC * C) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_out_kernel<V, G, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_out_kernel<V, G, NC><<<dim3(N / tn, B / G), THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)g, (const float*)b, (const bf16*)weff,
      (const float*)b_out, (bf16*)y, N, tn);
  return (int)cudaGetLastError();
}

template <int V, int NC>
int out_launch_g(int G, const void* x, const void* g, const void* b,
                 const void* weff, const void* b_out, void* y, int B, int N,
                 int tn, cudaStream_t s) {
  switch (G) {
    case 1: return out_launch<V, 1, NC>(x, g, b, weff, b_out, y, B, N, tn, s);
    case 4: return out_launch<V, 4, NC>(x, g, b, weff, b_out, y, B, N, tn, s);
    case 8: return out_launch<V, 8, NC>(x, g, b, weff, b_out, y, B, N, tn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int V>
int out_launch_gc(int G, int C, const void* x, const void* g, const void* b,
                  const void* weff, const void* b_out, void* y, int B, int N,
                  int tn, cudaStream_t s) {
  switch (C) {
    case 128: return out_launch_g<V, 4>(G, x, g, b, weff, b_out, y, B, N, tn, s);
    case 256: return out_launch_g<V, 8>(G, x, g, b, weff, b_out, y, B, N, tn, s);
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
// f32; wkv (C, 256) bf16; part_a (B, N/tn, 128, 128) and part_s (B,
// N/tn, 128) f32 scratch; ctx (B, 128, 128) f32.
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
// x; weff (B, C, C) bf16; g, b, b_out (C) f32.
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
