// Fused pre-norm linear-attention block for Hopper (sm_90a).
//
// Replaces the TPU kernels of dddpm_tpu/ops/pallas/attention_block.py:
//   _ctx_kernel (pass A) and _out_kernel (pass B), reached from
//   attention_block -> _fused_forward (the default two-pass route), and
//   _block_kernel_1p (K1c), reached from _fused_forward_1pass when
//   DDDPM_ATTN_ONE_PASS=1 (the one-pass route).
//
// What it computes, on x (B, N, C) tokens, hidden = 4 heads x 32:
//   pass A:  ln = LN(x)  (biased variance, eps added to the std)
//            kv = ln @ [Wk | Wv]              (f32 accumulation)
//            p  = exp(min(k, 60))             (no max subtraction)
//            A_h = p_h^T v_h, s = sum_tokens p   per sample, per head
//            ctx = blockdiag(A_h / s)          (B, 128, 128) f32
//   fold:    W_eff = Wq . ctx . Wout in f32, rounded to x's type (on the
//            two-pass route in PyTorch between the passes)
//   pass B:  y = x + ln @ W_eff[b] + b_out     (may write over x)
//
// What bounds it on an H100: at the 128^2 c128 site pass A reads 4.2 MB
// and does ~1.2 GFLOP per sample (near the bf16 ridge), pass B moves
// 8.4 MB for 0.54 GFLOP (bandwidth-bound).  The one-pass route needs x
// read once and y written once: at B = 8 over the x2 UNet's five sites
// 134 MB in bf16, ~40 us at 3.35 TB/s, against ~62 us for the two
// passes, which read x twice.
//
// What this design does about it: this first version is a simple,
// exact kernel, not a fast one.  The products are FMA tiles in shared
// memory (8 x NC outputs a thread, f32 accumulation), not tensor cores.
// Pass A spreads each sample's tokens over many blocks ("chunks"), so
// the 132 SMs have work even at B = 8; every chunk writes its partial
// per-head A and s, and a second small kernel sums the partials in a
// fixed order, so runs repeat bit for bit (no atomics).  Only the four
// 32x32 diagonal blocks of A are formed: the rest of ctx is zero.
// Pass B reads each token tile once, keeps LN in shared memory and
// writes y in the same pass; reading x and writing y per element in one
// thread makes the in-place form safe.
//
// The one-pass route (block_1p_kernel, K1c) runs the same item code in
// one cooperative launch.  The TPU kernel stashes a sample's x in VMEM
// between its phases; a block's 227 KB of shared memory cannot hold a
// sample (4 MB at 128^2 c128 in bf16), and blocks run in no order, so
// here the grid holds no more blocks than fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the wrapper raises if
// none fit) and walks the work items of four phases in grid strides,
// with a grid-wide barrier (cooperative_groups) between them: pass A's
// chunks, the in-order reduce per (sample, head), the W_eff fold per
// (sample, 16 rows) in f32, and pass B's tiles, which re-read x.  That
// re-read is the price of having no stash: at B = 8 the largest site's x
// (33.5 MB in bf16) fits the 50 MB L2, so it may be served from L2 if
// nothing evicts it in between (how much is not measured: the card's
// counters cannot be read here); in f32 (67 MB) it cannot be.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int HIDDEN = 128;       // heads * dim_head
constexpr int DH = 32;            // dim_head
constexpr int KV = 2 * HIDDEN;    // width of [Wk | Wv]
constexpr int TN = 64;            // tokens per tile
constexpr int KC = 32;            // weight rows staged in shared memory
constexpr int THREADS = 256;
constexpr int FOLD_ROWS = 16;     // W_eff rows a one-pass fold item forms
constexpr float K_CLAMP = 60.0f;
constexpr float LN_EPS = 1e-5f;

// The widths every kernel takes, C = 32 * NC for NC = 1 .. 8 (C % 32 == 0,
// C <= 256: ln_tile holds a token's C / 32 values a lane in 8 registers).
// Pass B and the one-pass kernel are instantiated for each.
#define DDDPM_WIDTHS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round to T's precision and back: where the reference casts to x.dtype
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LN of one token tile into lns (TN x C, f32 holding T-rounded values).
// Rows at or past `rows` (ragged last tile) are zero.  C % 32 == 0, C <= 256.
template <typename T>
__device__ void ln_tile(const T* xt, int rows, int C, const float* g,
                        const float* b, float* lns) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = C / 32;
  for (int r = warp; r < TN; r += THREADS / 32) {
    if (r >= rows) {
      for (int c = lane; c < C; c += 32) lns[r * C + c] = 0.f;
      continue;
    }
    float v[8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = i < m ? to_f(xt[(size_t)r * C + lane + 32 * i]) : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = i < m ? v[i] - mean : 0.f;
      q += d * d;
    }
    const float den = sqrtf(warp_sum(q) / C) + LN_EPS;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < m) {
        const int c = lane + 32 * i;
        lns[r * C + c] = rnd<T>((v[i] - mean) / den * g[c] + b[c]);
      }
    }
  }
}

// acc[i][j] += sum_k A[(ty*8+i)*K + k] * W[k][tx + 32*j] over k < K, for
// the TN x (32*NC) output tile; A in shared memory, W (K x 32*NC, row
// major, type T) staged KC rows at a time through Ws.  K % KC == 0.
template <typename T, int NC>
__device__ void gemm_tile(const float* A, int K, const T* W, float* Ws,
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

// Pass A, one chunk: chunk c of sample bi covers token tiles
// [c*tpc, (c+1)*tpc); it writes its per-head partial A (4 x 32 x 32)
// and partial s (128).  smem: (TN*C + KC*KV + TN*KV) floats.
template <typename T>
__device__ void ctx_partial_item(const T* x, const float* g, const float* b,
                                 const T* wkv, float* part_a, float* part_s,
                                 int N, int C, int tpc, int chunk, int bi,
                                 int nchunks, float* smem) {
  float* lns = smem;                 // TN x C
  float* ws = lns + TN * C;          // KC x KV
  float* kv = ws + KC * KV;          // TN x KV: p (unrounded) | v (rounded)
  const int t = threadIdx.x, ty = t / 32, tx = t % 32;
  // accumulator ownership: head h, row d, columns e0 .. e0+15
  const int h = t / 64, d = (t % 64) / 2, e0 = (t % 2) * 16;
  float acc_a[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) acc_a[q] = 0.f;
  float acc_s = 0.f;

  __syncthreads();   // smem free: the block may have used it just before
  const int ntiles = (N + TN - 1) / TN;
  const int tile_end = min(ntiles, (chunk + 1) * tpc);
  for (int tile = chunk * tpc; tile < tile_end; ++tile) {
    const int n0 = tile * TN;
    const int rows = min(TN, N - n0);
    ln_tile<T>(x + ((size_t)bi * N + n0) * C, rows, C, g, b, lns);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    gemm_tile<T, 8>(lns, C, wkv, ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 32 * j;
        float v = 0.f;   // padding rows add nothing to A or s
        if (r < rows)
          v = col < HIDDEN ? expf(fminf(acc[i][j], K_CLAMP)) : rnd<T>(acc[i][j]);
        kv[r * KV + col] = v;
      }
    }
    __syncthreads();
    for (int n = 0; n < TN; ++n) {
      const float p = rnd<T>(kv[n * KV + h * DH + d]);
      const float* vrow = kv + n * KV + HIDDEN + h * DH + e0;
#pragma unroll
      for (int q = 0; q < 16; ++q) acc_a[q] = fmaf(p, vrow[q], acc_a[q]);
    }
    if (t < HIDDEN)
      for (int n = 0; n < TN; ++n) acc_s += kv[n * KV + t];
    __syncthreads();
  }
  const size_t slot = (size_t)bi * nchunks + chunk;
  float* pa = part_a + (slot * 4 + h) * DH * DH + d * DH + e0;
#pragma unroll
  for (int q = 0; q < 16; ++q) pa[q] = acc_a[q];
  if (t < HIDDEN) part_s[slot * HIDDEN + t] = acc_s;
}

// Pass A, part 1: grid (nchunks, B), one chunk a block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ctx_partial_kernel(const T* x, const float* g, const float* b, const T* wkv,
                   float* part_a, float* part_s, int N, int C, int tpc) {
  extern __shared__ float smem[];
  ctx_partial_item<T>(x, g, b, wkv, part_a, part_s, N, C, tpc, blockIdx.x,
                      blockIdx.y, gridDim.x, smem);
}

// Pass A, part 2: grid (B).  Sums the chunks' partials in chunk order
// and writes ctx = blockdiag(A / s) (s indexed by the row, the k dim).
__global__ void __launch_bounds__(THREADS)
ctx_reduce_kernel(const float* part_a, const float* part_s, float* ctx,
                  int nchunks) {
  __shared__ float s[HIDDEN];
  const int bi = blockIdx.x;
  for (int c = threadIdx.x; c < HIDDEN; c += THREADS) {
    float acc = 0.f;
    for (int k = 0; k < nchunks; ++k)
      acc += part_s[((size_t)bi * nchunks + k) * HIDDEN + c];
    s[c] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < HIDDEN * HIDDEN; idx += THREADS) {
    const int r = idx / HIDDEN, c = idx % HIDDEN;
    float v = 0.f;
    if (r / DH == c / DH) {
      const int h = r / DH;
      float a = 0.f;
      for (int k = 0; k < nchunks; ++k)
        a += part_a[(((size_t)bi * nchunks + k) * 4 + h) * DH * DH +
                    (r % DH) * DH + c % DH];
      v = a / s[r];
    }
    ctx[(size_t)bi * HIDDEN * HIDDEN + idx] = v;
  }
}

// Pass B, one token tile: y = x + LN(x) @ weff + b_out for tile `tile`
// of sample bi (weff: that sample's C x C).  y may be x.
// smem: (TN*C + KC*C) floats.
template <typename T, int NC>
__device__ void out_tile(const T* x, const float* g, const float* b,
                         const T* weff, const float* b_out, T* y, int N,
                         int tile, int bi, float* smem) {
  constexpr int C = 32 * NC;
  float* lns = smem;            // TN x C
  float* ws = lns + TN * C;     // KC x C
  const int n0 = tile * TN;
  const int rows = min(TN, N - n0);
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const size_t base = ((size_t)bi * N + n0) * C;
  __syncthreads();   // smem free: the block may have used it just before
  ln_tile<T>(x + base, rows, C, g, b, lns);
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  gemm_tile<T, NC>(lns, C, weff, ws, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 32 * j;
      const size_t at = base + (size_t)r * C + col;
      y[at] = from_f<T>(to_f(x[at]) + acc[i][j] + b_out[col]);
    }
  }
}

// Pass B: grid (ntiles, B), one tile a block.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
out_kernel(const T* x, const float* g, const float* b, const T* weff,
           const float* b_out, T* y, int N) {
  constexpr int C = 32 * NC;
  extern __shared__ float smem[];
  out_tile<T, NC>(x, g, b, weff + (size_t)blockIdx.y * C * C, b_out, y, N,
                  blockIdx.x, blockIdx.y, smem);
}

// One-pass block, phase 1 item: sample bi, head h.  Sums the chunks'
// partials in chunk order and writes that head's diagonal block of
// ctx, A / s (s indexed by the row), into ctx4 (B, 4, 32, 32).
__device__ void reduce_head(const float* part_a, const float* part_s,
                            float* ctx4, int nchunks, int bi, int h,
                            float* smem) {
  float* s = smem;   // DH
  __syncthreads();
  if (threadIdx.x < DH) {
    float acc = 0.f;
    for (int k = 0; k < nchunks; ++k)
      acc += part_s[((size_t)bi * nchunks + k) * HIDDEN + h * DH + threadIdx.x];
    s[threadIdx.x] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < DH * DH; idx += THREADS) {
    float a = 0.f;
    for (int k = 0; k < nchunks; ++k)
      a += part_a[(((size_t)bi * nchunks + k) * 4 + h) * DH * DH + idx];
    ctx4[((size_t)bi * 4 + h) * DH * DH + idx] = a / s[idx / DH];
  }
}

// One-pass block, phase 2 item: rows r0 .. r0+FOLD_ROWS of sample bi's
// W_eff = (Wq . blockdiag(ctx)) . Wout in f32, rounded to T into weff
// (B, C, C).  wq (C, 128), wout (128, C) of type T.
template <typename T, int NC>
__device__ void fold_rows(const T* wq, const T* wout, const float* ctx4,
                          T* weff, int bi, int r0, float* smem) {
  constexpr int C = 32 * NC;
  float* t1 = smem;   // FOLD_ROWS x HIDDEN: Wq . ctx
  __syncthreads();
  for (int idx = threadIdx.x; idx < FOLD_ROWS * HIDDEN; idx += THREADS) {
    const int r = idx / HIDDEN, col = idx % HIDDEN, h = col / DH;
    const T* wrow = wq + (size_t)(r0 + r) * HIDDEN + h * DH;
    const float* cblk = ctx4 + ((size_t)bi * 4 + h) * DH * DH + col % DH;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) acc = fmaf(to_f(wrow[d]), cblk[d * DH], acc);
    t1[idx] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < FOLD_ROWS * C; idx += THREADS) {
    const int r = idx / C, f = idx % C;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < HIDDEN; ++k)
      acc = fmaf(t1[r * HIDDEN + k], to_f(wout[(size_t)k * C + f]), acc);
    weff[((size_t)bi * C + r0 + r) * C + f] = from_f<T>(acc);
  }
}

// The whole block in one cooperative launch: a grid of at most as many
// blocks as fit on the card at once, each walking the items of a phase
// in grid strides, with a grid-wide barrier between the phases.
//   phase 0: pass A's chunks (B x nchunks), partials to part_a, part_s
//   phase 1: the reduce, per (sample, head), into ctx4
//   phase 2: the W_eff fold, per (sample, FOLD_ROWS rows), into weff
//   phase 3: pass B's token tiles (B x ntiles), y = x + LN(x) W_eff + b_out
// y is written out of place, as JAX's one-pass kernel does not alias.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
block_1p_kernel(const T* x, const float* g, const float* b, const T* wkv,
                const T* wq, const T* wout, const float* b_out, float* part_a,
                float* part_s, float* ctx4, T* weff, T* y, int B, int N,
                int nchunks, int tpc) {
  constexpr int C = 32 * NC;
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  for (int it = blockIdx.x; it < B * nchunks; it += gridDim.x)
    ctx_partial_item<T>(x, g, b, wkv, part_a, part_s, N, C, tpc, it % nchunks,
                        it / nchunks, nchunks, smem);
  grid.sync();
  for (int it = blockIdx.x; it < B * 4; it += gridDim.x)
    reduce_head(part_a, part_s, ctx4, nchunks, it / 4, it % 4, smem);
  grid.sync();
  constexpr int FOLDS = C / FOLD_ROWS;
  for (int it = blockIdx.x; it < B * FOLDS; it += gridDim.x)
    fold_rows<T, NC>(wq, wout, ctx4, weff, it / FOLDS, (it % FOLDS) * FOLD_ROWS,
                     smem);
  grid.sync();
  const int ntiles = (N + TN - 1) / TN;
  for (int it = blockIdx.x; it < B * ntiles; it += gridDim.x) {
    const int bi = it / ntiles;
    out_tile<T, NC>(x, g, b, weff + (size_t)bi * C * C, b_out, y, N,
                    it % ntiles, bi, smem);
  }
}

// shared memory of the one-pass kernel: the largest phase's (pass A's)
constexpr int smem_1p(int C) {
  return (TN * C + KC * KV + TN * KV) * (int)sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int ctx_launch(const void* x, const void* g, const void* b, const void* wkv,
               void* part_a, void* part_s, void* ctx, int B, int N, int C,
               int nchunks, int tpc, cudaStream_t stream) {
  const int smem = (TN * C + KC * KV + TN * KV) * (int)sizeof(float);
  cudaError_t err = allow_smem(ctx_partial_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ctx_partial_kernel<T><<<dim3(nchunks, B), THREADS, smem, stream>>>(
      (const T*)x, (const float*)g, (const float*)b, (const T*)wkv,
      (float*)part_a, (float*)part_s, N, C, tpc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctx_reduce_kernel<<<B, THREADS, 0, stream>>>(
      (const float*)part_a, (const float*)part_s, (float*)ctx, nchunks);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int out_launch_nc(const void* x, const void* g, const void* b, const void* weff,
                  const void* b_out, void* y, int B, int N,
                  cudaStream_t stream) {
  constexpr int C = 32 * NC;
  const int smem = (TN * C + KC * C) * (int)sizeof(float);
  cudaError_t err = allow_smem(out_kernel<T, NC>, smem);
  if (err != cudaSuccess) return (int)err;
  out_kernel<T, NC><<<dim3((N + TN - 1) / TN, B), THREADS, smem, stream>>>(
      (const T*)x, (const float*)g, (const float*)b, (const T*)weff,
      (const float*)b_out, (T*)y, N);
  return (int)cudaGetLastError();
}

template <typename T>
int out_launch(const void* x, const void* g, const void* b, const void* weff,
               const void* b_out, void* y, int B, int N, int C,
               cudaStream_t stream) {
#define DDDPM_OUT(NC) \
  case 32 * NC: return out_launch_nc<T, NC>(x, g, b, weff, b_out, y, B, N, stream);
  switch (C) {
    DDDPM_WIDTHS(DDDPM_OUT)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DDDPM_OUT
}

// Blocks of block_1p_kernel<T, NC> that fit on the card at once, or a
// negative CUDA error code; 0 if the card cannot launch cooperatively.
template <typename T, int NC>
int resident_1p() {
  const int smem = smem_1p(32 * NC);
  cudaError_t err = allow_smem(block_1p_kernel<T, NC>, smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, block_1p_kernel<T, NC>, THREADS, smem)) != cudaSuccess)
    return -(int)err;
  return coop ? per_sm * sms : 0;
}

template <typename T, int NC>
int launch_1p(const void* x, const void* g, const void* b, const void* wkv,
              const void* wq, const void* wout, const void* b_out, void* part_a,
              void* part_s, void* ctx4, void* weff, void* y, int B, int N,
              int nchunks, int tpc, int grid, cudaStream_t stream) {
  const int resident = resident_1p<T, NC>();
  if (resident < 0) return -resident;
  // every block must be resident, or the grid barrier never opens
  if (grid < 1 || grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  const T *xp = (const T*)x, *wkvp = (const T*)wkv, *wqp = (const T*)wq,
          *woutp = (const T*)wout;
  const float *gp = (const float*)g, *bp = (const float*)b,
              *bop = (const float*)b_out;
  float *pap = (float*)part_a, *psp = (float*)part_s, *cp = (float*)ctx4;
  T *weffp = (T*)weff, *yp = (T*)y;
  void* args[] = {&xp,  &gp,    &bp, &wkvp, &wqp, &woutp, &bop,     &pap,
                  &psp, &cp, &weffp, &yp,   &B,   &N,     &nchunks, &tpc};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)block_1p_kernel<T, NC>, dim3(grid), dim3(THREADS), args,
      smem_1p(32 * NC), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int resident_1p_c(int C) {
#define DDDPM_RESIDENT(NC) \
  case 32 * NC: return resident_1p<T, NC>();
  switch (C) {
    DDDPM_WIDTHS(DDDPM_RESIDENT)
    default: return -(int)cudaErrorInvalidValue;
  }
#undef DDDPM_RESIDENT
}

template <typename T>
int launch_1p_c(const void* x, const void* g, const void* b, const void* wkv,
                const void* wq, const void* wout, const void* b_out, void* part_a,
                void* part_s, void* ctx4, void* weff, void* y, int B, int N, int C,
                int nchunks, int tpc, int grid, cudaStream_t stream) {
#define DDDPM_LAUNCH_1P(NC)                                                      \
  launch_1p<T, NC>(x, g, b, wkv, wq, wout, b_out, part_a, part_s, ctx4, weff, y, \
                   B, N, nchunks, tpc, grid, stream)
#define DDDPM_CASE_1P(NC) \
  case 32 * NC: return DDDPM_LAUNCH_1P(NC);
  switch (C) {
    DDDPM_WIDTHS(DDDPM_CASE_1P)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DDDPM_CASE_1P
#undef DDDPM_LAUNCH_1P
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Shapes: x (B, N, C); g, b (C) f32;
// wkv (C, 256) of x's type; part_a (B, nchunks, 4, 32, 32) f32;
// part_s (B, nchunks, 128) f32; ctx (B, 128, 128) f32.
int attn_ctx(const void* x, const void* g, const void* b, const void* wkv,
             void* part_a, void* part_s, void* ctx, int B, int N, int C,
             int nchunks, int tiles_per_chunk, int dtype, void* stream) {
  if (C % 32 || C > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return ctx_launch<__nv_bfloat16>(x, g, b, wkv, part_a, part_s, ctx, B, N, C,
                                     nchunks, tiles_per_chunk, (cudaStream_t)stream);
  return ctx_launch<float>(x, g, b, wkv, part_a, part_s, ctx, B, N, C, nchunks,
                           tiles_per_chunk, (cudaStream_t)stream);
}

// weff (B, C, C) of x's type; b_out (C) f32; y (B, N, C), may equal x.
int attn_out(const void* x, const void* g, const void* b, const void* weff,
             const void* b_out, void* y, int B, int N, int C, int dtype,
             void* stream) {
  if (dtype == 1)
    return out_launch<__nv_bfloat16>(x, g, b, weff, b_out, y, B, N, C,
                                     (cudaStream_t)stream);
  return out_launch<float>(x, g, b, weff, b_out, y, B, N, C, (cudaStream_t)stream);
}

// The number of blocks of the one-pass kernel for width C that fit on
// the card at once (the largest grid attn_1p takes), 0 if the card
// cannot launch cooperatively, or a negative CUDA error code.
int attn_1p_resident(int C, int dtype) {
  return dtype == 1 ? resident_1p_c<__nv_bfloat16>(C) : resident_1p_c<float>(C);
}

// The whole block in one cooperative launch of `grid` blocks (at most
// attn_1p_resident's).  x, y (B, N, C) of dtype, y not x; wkv (C, 256),
// wq (C, 128), wout (128, C) of dtype; g, b, b_out (C) f32; part_a
// (B, nchunks, 4, 32, 32), part_s (B, nchunks, 128), ctx4 (B, 4, 32, 32)
// f32 and weff (B, C, C) of dtype are scratch.
int attn_1p(const void* x, const void* g, const void* b, const void* wkv,
            const void* wq, const void* wout, const void* b_out, void* part_a,
            void* part_s, void* ctx4, void* weff, void* y, int B, int N, int C,
            int nchunks, int tiles_per_chunk, int grid, int dtype, void* stream) {
  if (dtype == 1)
    return launch_1p_c<__nv_bfloat16>(x, g, b, wkv, wq, wout, b_out, part_a,
                                      part_s, ctx4, weff, y, B, N, C, nchunks,
                                      tiles_per_chunk, grid, (cudaStream_t)stream);
  return launch_1p_c<float>(x, g, b, wkv, wq, wout, b_out, part_a, part_s, ctx4,
                            weff, y, B, N, C, nchunks, tiles_per_chunk, grid,
                            (cudaStream_t)stream);
}

}  // extern "C"
