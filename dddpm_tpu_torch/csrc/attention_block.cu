// Fused pre-norm linear-attention block for Hopper (sm_90a).
//
// Replaces the TPU kernels of dddpm_tpu/ops/pallas/attention_block.py:
//   _ctx_kernel (pass A) and _out_kernel (pass B), reached from
//   attention_block -> _fused_forward (the default two-pass route), and
//   _block_kernel_1p (K1c), reached from _fused_forward_1pass when
//   DDDPM_ATTN_ONE_PASS=1 (the one-pass route).
//
// What it computes, on x (B, N, C) tokens, any C >= 1, hidden = 4 heads
// x 32:
//   pass A:  ln = LN(x)  (biased variance, eps added to the std), rounded
//            to x's type
//            kv = ln @ [Wk | Wv]              (f32 accumulation)
//            p  = exp(min(k, 60))             (no max subtraction)
//            A_h = p_h^T v_h (p, v rounded to x's type), s = sum_tokens p
//            (f32) per sample, per head
//            ctx = blockdiag(A_h / s)          (B, 128, 128) f32
//   fold:    W_eff = Wq . ctx . Wout in f32, rounded to x's type (on the
//            two-pass route in PyTorch between the passes)
//   pass B:  y = x + ln @ W_eff[b] + b_out     (may write over x at C <= NS)
//
// What bounds it on an H100: at the 128^2 c128 site (B = 8) pass A reads
// 33.5 MB and does 8.6 GFLOP of products, ~10 us of memory against ~9 us
// of bf16 tensor-core time; pass B moves 67 MB for 4.3 GFLOP and is
// bandwidth-bound.  On the FMA pipes (67 TFLOP/s of f32) pass A's
// products alone need >= 128 us.
//
// Two routes:
//  * bf16, two passes (the default path): the products on the tensor
//    cores (mma.sync.m16n8k16, bf16 operands, f32 sums; ctx_mma_kernel,
//    out_mma_kernel).  A persistent grid of as many blocks as are resident
//    walks (sample, chunk) items of 64-token tiles; inside a block, warp
//    groups (pass A: two of four warps, pass B: four of two) take the
//    item's 16-token sub-tiles in turn, each at its own pace, synchronised
//    by named barriers among the group's warps only.  At C <= NS the
//    weights stay in shared memory (pass A: W_kv for the block's life;
//    pass B: W_eff[b] while the block's items are of sample b), and each
//    group's next sub-tile arrives by cp.async while it works on the
//    present one.  Pass A normalises the sub-tile in place (row
//    statistics in f32 from registers, rounded to bf16 once), forms kv in
//    registers, a warp a head (its k and v columns), takes exp, the clamp
//    and s there, writes its p and v to its own shared memory as bf16 and
//    sums A_h += p_h^T v_h over the sub-tile's rows as a second mma.sync
//    product (p read transposed by ldmatrix.trans), the sums staying in
//    registers across the item's sub-tiles; at the item's end the two
//    groups' sums are added in order and written as the item's partial A
//    and s, which ctx_reduce_kernel sums in chunk order, so runs repeat
//    bit for bit (no atomics).  Pass B keeps the raw x sub-tile (the
//    residual) and normalises the A fragments as it loads them, adds x
//    and b_out in the epilogue and stores y through shared memory as
//    16-byte rows.  Above NS channels the weights stream in K-slabs of
//    KS rows, double-buffered by cp.async beside the slab of raw x, the
//    groups in step, and the row statistics are read from x in device
//    memory; pass B then takes 64-token tiles in its output's column
//    slabs of NS and writes y directly (the wrapper never passes y == x
//    there: a later column slab still reads the tile's x).  C need not be
//    a multiple of 16: K is zero-padded to the product's depth in shared
//    memory, and rows past N are masked.  What bounds this design
//    (probes/attention_ablation.py): the operands' shared-memory traffic
//    of mma.sync (each warp re-reads its weight columns for every 16
//    rows), the LN and pass B's epilogue, not device memory.  The work
//    of one item of each pass is a __device__ function (ctx_mma_item,
//    out_mma_item) that the one-pass kernel calls too.
//  * float32: FMA tiles (8 x 8 outputs a thread, f32 sums), unchanged in
//    precision.  Row statistics first, then the normalised A operand
//    staged KC columns at a time (rounded to x's type) and the weights
//    KC rows at a time, outputs NS columns a slab, so shared memory does
//    not grow with C.
//
// The one-pass route (K1c) runs the whole block in one cooperative
// launch.  The TPU kernel stashes a sample's x in VMEM between its
// phases; a block's 227 KB of shared memory cannot hold a sample (4 MB
// at 128^2 c128 in bf16), and blocks run in no order, so here the grid
// holds no more blocks than fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the wrapper raises if
// none fit) and walks the work items of four phases in grid strides,
// with a grid-wide barrier (cooperative_groups) between them: pass A's
// chunks, the in-order reduce per (sample, head), the W_eff fold per
// (sample, 16 rows) in f32 on the FMA pipes (~0.15 GFLOP at the x2
// sites, B = 8), and pass B's tiles, which re-read x, last-read first,
// so that what L2 still holds of it (50 MB; a B = 8 batch of the x2
// sites' x is 4-34 MB) is read before it is evicted.  In bf16
// (block_1p_mma_kernel) passes A and B are the tensor-core items above,
// the same code as the two-pass kernels', with shared memory the larger
// of the two passes' and the two-pass route's rounding points (LN and p
// rounded to bf16, W_eff folded in f32 and rounded to bf16); in f32
// (block_1p_kernel) they are the FMA items.
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"  // cp_async16, ldmatrix_x4(_trans), mma_bf16

// ATTN_SKIP (a -D define, 0 by default) compiles parts of the bf16
// kernels out, by bit: 1 the row statistics and LN, 2 the kv / y products
// (mma), 4 pass A's exp and s (and pass B's epilogue: y = the tile's x),
// 8 pass A's A_h products, 16 the x tile loads.  Only the ablation probe
// sets it; its kernels compute garbage.
#ifndef ATTN_SKIP
#define ATTN_SKIP 0
#endif

// ATTN_BF16_FMA (a -D define, 0 by default): the bf16 entries launch the
// FMA kernels that f32 takes (ctx_partial_kernel, out_kernel) in place of
// the tensor-core ones, so the probe can time the two routes against
// each other; it computes what they compute.  Only the ablation probe
// sets it.
#ifndef ATTN_BF16_FMA
#define ATTN_BF16_FMA 0
#endif

// ATTN_1P_PHASES (a -D define, 4 by default): the bf16 one-pass kernel
// returns after its first ATTN_1P_PHASES phases (pass A, the reduce, the
// fold, pass B), so the probe can time each phase as a difference; it
// computes garbage below 4.  Only the ablation probe sets it.
#ifndef ATTN_1P_PHASES
#define ATTN_1P_PHASES 4
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int SKIP = ATTN_SKIP;
constexpr int PHASES_1P = ATTN_1P_PHASES;

typedef __nv_bfloat16 bf16;

constexpr int HIDDEN = 128;       // heads * dim_head
constexpr int DH = 32;            // dim_head
constexpr int KV = 2 * HIDDEN;    // width of [Wk | Wv]
constexpr int TN = 64;            // tokens per tile
constexpr int KC = 32;            // FMA route: K columns staged a slab
constexpr int NS = 256;           // output columns a slab; widest resident C
constexpr int THREADS = 256;
constexpr int FOLD_ROWS = 16;     // W_eff rows a one-pass fold item forms
constexpr float K_CLAMP = 60.0f;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
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

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Row statistics of a token tile of ROWS rows: mean and 1 / (std + eps)
// (biased variance, two passes over the row in f32) of rows < rows, 0 and
// 0 for the rows after them up to ROWS.  Element (r, c) at p[r * ld + c],
// in device or shared memory, any C.  Warp w takes rows ROWS / 8 w ..
// at once, 256 / ROWS lanes a row, so a row's sums close in a few
// shuffles.
template <int ROWS, typename T>
__device__ void row_stats(const T* p, size_t ld, int rows, int C, float* mean,
                          float* rinv) {
  constexpr int LPR = 32 / (ROWS / 8);   // lanes a row
  const int lane = threadIdx.x % 32, q = lane % LPR;
  const int r = (threadIdx.x / 32) * (ROWS / 8) + lane / LPR;
  const T* row = p + (r < rows ? r : 0) * ld;
  float s = 0.f;
  for (int c = q; c < C; c += LPR) s += to_f(row[c]);
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float m = s / C;
  float v = 0.f;
  for (int c = q; c < C; c += LPR) {
    const float d = to_f(row[c]) - m;
    v += d * d;
  }
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (q == 0) {
    mean[r] = r < rows ? m : 0.f;
    rinv[r] = r < rows ? 1.f / (sqrtf(v / C) + LN_EPS) : 0.f;
  }
}

// The statistics of one row of a bf16 tile in shared memory at C <= NS
// (16-byte aligned, zero past C), taken by the eight lanes of a lane
// group (q = lane % 8) from registers, each holding up to CPL 16-byte
// chunks of the row (chunk q + 8 i; 8 CPL >= ceil(C / 8)): (mean, 1 /
// (std + eps)) to the eight lanes, the variance from the deviations (the
// zeros past C in the last chunk taken back out).  WRITE (and valid):
// LN(x) (g, b by column, zero past C) is written over the row, rounded
// to bf16 once.  Every lane of the warp calls it (the sums close by
// shuffles).
template <int CPL, bool WRITE>
__device__ __forceinline__ float2 row_ln8(bf16* row, bool valid, int C,
                                          const float* g, const float* b) {
  const int q = threadIdx.x & 7, nch = (C + 7) / 8;
  uint4 v[CPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    v[i] = make_uint4(0, 0, 0, 0);
    if (q + 8 * i < nch) v[i] = *reinterpret_cast<const uint4*>(row + 8 * (q + 8 * i));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      s += f.x + f.y;
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float m = s / C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (q + 8 * i >= nch) break;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      var += (f.x - m) * (f.x - m) + (f.y - m) * (f.y - m);
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
  var -= (8 * nch - C) * m * m;   // the zeros past C, each (0 - m)^2
  const float ri = 1.f / (sqrtf(fmaxf(var, 0.f) / C) + LN_EPS);
  if (WRITE && valid) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int ch = q + 8 * i;
      if (ch >= nch) break;
      const float4* gp = reinterpret_cast<const float4*>(g + 8 * ch);
      const float4* bp = reinterpret_cast<const float4*>(b + 8 * ch);
      const float4 g0 = gp[0], g1 = gp[1], b0 = bp[0], b1 = bp[1];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[i]);
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn((f.x - m) * ri * gg[2 * e] + bb[2 * e],
                                     (f.y - m) * ri * gg[2 * e + 1] + bb[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(row + 8 * ch) = v[i];
    }
  }
  return make_float2(m, ri);
}

// named barrier among `threads` threads of the block (id >= 1: id 0 is
// __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------ FMA route

// acc[i][j] = sum_k ln[ty*8+i][k] * W[k][n0 + tx + 32j] over k < C, j <
// NJ: the TN x 32 NJ output slab at column n0 of LN(x tile) @ W (W: C x
// ldw of type T; columns >= ncols read as 0).  The normalised A operand
// is staged KC columns at a time into as (TN x KC f32, rounded to T), W
// KC rows at a time into ws (KC x NS f32); the ragged last slab and rows
// >= rows are zero.  mean, rinv: row_stats of the tile.
template <typename T, int NJ>
__device__ void gemm_ln_fma(const T* xt, int rows, int C, const float* g,
                            const float* b, const float* mean, const float* rinv,
                            const T* W, int ldw, int n0, int ncols, float* as,
                            float* ws, float (&acc)[8][NJ]) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < TN * KC; i += THREADS) {
      const int r = i / KC, c = k0 + i % KC;
      as[i] = (r < rows && c < C)
                  ? rnd<T>((to_f(xt[(size_t)r * C + c]) - mean[r]) * rinv[r] * g[c] + b[c])
                  : 0.f;
    }
    for (int i = threadIdx.x; i < KC * 32 * NJ; i += THREADS) {
      const int k = k0 + i / (32 * NJ), n = i % (32 * NJ);
      ws[(k - k0) * NS + n] =
          (k < C && n0 + n < ncols) ? to_f(W[(size_t)k * ldw + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[8], w[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(ty * 8 + i) * KC + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = ws[kk * NS + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

// shared memory of the FMA items, in floats
constexpr int FMA_OUT_SMEM = TN * KC + KC * NS + 2 * TN;
constexpr int FMA_CTX_SMEM = FMA_OUT_SMEM + TN * KV;

// Pass A, one chunk: chunk c of sample bi covers token tiles
// [c*tpc, (c+1)*tpc); it writes its per-head partial A (4 x 32 x 32)
// and partial s (128).  smem: FMA_CTX_SMEM floats.
template <typename T>
__device__ void ctx_partial_item(const T* x, const float* g, const float* b,
                                 const T* wkv, float* part_a, float* part_s,
                                 int N, int C, int tpc, int chunk, int bi,
                                 int nchunks, float* smem) {
  float* as = smem;                  // TN x KC
  float* ws = as + TN * KC;          // KC x NS
  float* mean = ws + KC * NS;        // TN
  float* rinv = mean + TN;           // TN
  float* kv = rinv + TN;             // TN x KV: p (unrounded) | v (rounded)
  const int t = threadIdx.x, ty = t / 32, tx = t % 32;
  // accumulator ownership: head h, row d, columns e0 .. e0+15
  const int h = t / 64, d = (t % 64) / 2, e0 = (t % 2) * 16;
  float acc_a[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) acc_a[q] = 0.f;
  float acc_s = 0.f;

  const int ntiles = (N + TN - 1) / TN;
  const int tile_end = min(ntiles, (chunk + 1) * tpc);
  for (int tile = chunk * tpc; tile < tile_end; ++tile) {
    const int n0 = tile * TN;
    const int rows = min(TN, N - n0);
    const T* xt = x + ((size_t)bi * N + n0) * C;
    __syncthreads();   // smem free: the block may have used it just before
    row_stats<TN>(xt, C, rows, C, mean, rinv);
    float acc[8][8];
    gemm_ln_fma<T, 8>(xt, rows, C, g, b, mean, rinv, wkv, KV, 0, KV, as, ws, acc);
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
  }
  const size_t slot = (size_t)bi * nchunks + chunk;
  float* pa = part_a + (slot * 4 + h) * DH * DH + d * DH + e0;
#pragma unroll
  for (int q = 0; q < 16; ++q) pa[q] = acc_a[q];
  if (t < HIDDEN) part_s[slot * HIDDEN + t] = acc_s;
}

// Pass A (FMA), part 1: grid (nchunks, B), one chunk a block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ctx_partial_kernel(const T* x, const float* g, const float* b, const T* wkv,
                   float* part_a, float* part_s, int N, int C, int tpc) {
  extern __shared__ float smem[];
  ctx_partial_item<T>(x, g, b, wkv, part_a, part_s, N, C, tpc, blockIdx.x,
                      blockIdx.y, gridDim.x, smem);
}

// Pass A, part 2 (both routes): grid (HIDDEN / 8, B).  Block (q, bi)
// sums the chunks' partials of ctx rows 8 q .. 8 q + 7 in chunk order, a
// thread a diagonal element, and writes those rows of ctx = blockdiag(A
// / s) (s indexed by the row, the k dim).
__global__ void __launch_bounds__(THREADS)
ctx_reduce_kernel(const float* part_a, const float* part_s, float* ctx,
                  int nchunks) {
  __shared__ float s[8], a[8 * DH];
  const int bi = blockIdx.y, r0 = 8 * blockIdx.x, h = r0 / DH, t = threadIdx.x;
  const size_t stride_a = 4 * DH * DH;
  if (t < 8) {
    float acc = 0.f;
    for (int k = 0; k < nchunks; ++k)
      acc += part_s[((size_t)bi * nchunks + k) * HIDDEN + r0 + t];
    s[t] = acc;
  }
  {
    const float* pa = part_a + (size_t)bi * nchunks * stride_a + h * DH * DH +
                      (r0 % DH + t / DH) * DH + t % DH;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < nchunks; ++k) acc += pa[k * stride_a];
    a[t] = acc;
  }
  __syncthreads();
  for (int idx = t; idx < 8 * HIDDEN; idx += THREADS) {
    const int r = idx / HIDDEN, c = idx % HIDDEN;
    ctx[((size_t)bi * HIDDEN + r0 + r) * HIDDEN + c] =
        c / DH == h ? a[r * DH + c % DH] / s[r] : 0.f;
  }
}

// Pass B (FMA), one output column slab of 32 NJ columns from c0 of one
// token tile (base: its first element; mean, rinv its row_stats).
template <typename T, int NJ>
__device__ void out_slab(const T* x, const float* g, const float* b,
                         const T* weff, const float* b_out, T* y, int rows,
                         int C, size_t base, int c0, const float* mean,
                         const float* rinv, float* as, float* ws) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  float acc[8][NJ];
  gemm_ln_fma<T, NJ>(x + base, rows, C, g, b, mean, rinv, weff, C, c0, C, as, ws,
                     acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = c0 + tx + 32 * j;
      if (col >= C) continue;
      const size_t at = base + (size_t)r * C + col;
      y[at] = from_f<T>(to_f(x[at]) + acc[i][j] + b_out[col]);
    }
  }
}

// Pass B (FMA), one token tile: y = x + LN(x) @ weff + b_out for tile
// `tile` of sample bi (weff: that sample's C x C), in output column slabs
// of NS, each formed 32 NJ columns wide (NJ < 0: the last one as narrow
// as it may be, in 32s, 64s or 128s).  y may be x when C <= NS: every
// read of the tile's x for the A operand precedes the barrier before the
// slab's products, and each output element's residual is read by the
// thread that writes it.  smem: FMA_OUT_SMEM floats.
template <typename T, int NJ>
__device__ void out_tile(const T* x, const float* g, const float* b,
                         const T* weff, const float* b_out, T* y, int N, int C,
                         int tile, int bi, float* smem) {
  float* as = smem;              // TN x KC
  float* ws = as + TN * KC;      // KC x NS
  float* mean = ws + KC * NS;    // TN
  float* rinv = mean + TN;       // TN
  const int n0 = tile * TN;
  const int rows = min(TN, N - n0);
  const size_t base = ((size_t)bi * N + n0) * C;
  __syncthreads();   // smem free: the block may have used it just before
  row_stats<TN>(x + base, C, rows, C, mean, rinv);
  for (int c0 = 0; c0 < C; c0 += NS) {
    if constexpr (NJ > 0) {
      out_slab<T, NJ>(x, g, b, weff, b_out, y, rows, C, base, c0, mean, rinv, as, ws);
    } else {
      const int nj = (min(NS, C - c0) + 31) / 32;
      if (nj <= 1)
        out_slab<T, 1>(x, g, b, weff, b_out, y, rows, C, base, c0, mean, rinv, as, ws);
      else if (nj <= 2)
        out_slab<T, 2>(x, g, b, weff, b_out, y, rows, C, base, c0, mean, rinv, as, ws);
      else if (nj <= 4)
        out_slab<T, 4>(x, g, b, weff, b_out, y, rows, C, base, c0, mean, rinv, as, ws);
      else
        out_slab<T, 8>(x, g, b, weff, b_out, y, rows, C, base, c0, mean, rinv, as, ws);
    }
  }
}

// Pass B (FMA): grid (ntiles, B), one tile a block, slabs NJ x 32 wide.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
out_kernel(const T* x, const float* g, const float* b, const T* weff,
           const float* b_out, T* y, int N, int C) {
  extern __shared__ float smem[];
  out_tile<T, NJ>(x, g, b, weff + (size_t)blockIdx.y * C * C, b_out, y, N, C,
                  blockIdx.x, blockIdx.y, smem);
}

// One-pass block, phase 1 item: sample bi, head h, rows r0 .. r0 + nr - 1
// of its block.  Sums the chunks' partials in chunk order (eight loads
// in flight) and writes those rows of the head's diagonal block of ctx,
// A / s (s indexed by the row), into ctx4 (B, 4, 32, 32).
__device__ void reduce_head(const float* part_a, const float* part_s,
                            float* ctx4, int nchunks, int bi, int h, int r0,
                            int nr, float* smem) {
  float* s = smem;   // nr
  __syncthreads();
  if (threadIdx.x < nr) {
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < nchunks; ++k)
      acc += part_s[((size_t)bi * nchunks + k) * HIDDEN + h * DH + r0 + threadIdx.x];
    s[threadIdx.x] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * DH; idx += THREADS) {
    float a = 0.f;
#pragma unroll 8
    for (int k = 0; k < nchunks; ++k)
      a += part_a[(((size_t)bi * nchunks + k) * 4 + h) * DH * DH + r0 * DH + idx];
    ctx4[((size_t)bi * 4 + h) * DH * DH + r0 * DH + idx] = a / s[idx / DH];
  }
}

// One-pass block, phase 2 item: rows r0 .. min(r0+FOLD_ROWS, C) of sample
// bi's W_eff = (Wq . blockdiag(ctx)) . Wout in f32, rounded to T into weff
// (B, C, C).  wq (C, 128), wout (128, C) of type T.  The sample's ctx
// blocks are staged in shared memory; then a thread forms a column f of
// the item's rows, each element of Wout's column read once for all of
// them (FOLD_ROWS sums in flight, t1 read four k at a time).  Every sum
// takes its terms in k order, one fmaf each.  smem: FOLD_SMEM floats.
constexpr int FOLD_SMEM = 4 * DH * DH + FOLD_ROWS * HIDDEN;

template <typename T>
__device__ void fold_rows(const T* wq, const T* wout, const float* ctx4,
                          T* weff, int C, int bi, int r0, float* smem) {
  float* cs = smem;                 // 4 x DH x DH: the sample's ctx blocks
  float* t1 = cs + 4 * DH * DH;     // FOLD_ROWS x HIDDEN: Wq . ctx, 0 past nr
  const int nr = min(FOLD_ROWS, C - r0);
  __syncthreads();
  const float4* c4 = reinterpret_cast<const float4*>(ctx4 + (size_t)bi * 4 * DH * DH);
  for (int i = threadIdx.x; i < DH * DH; i += THREADS)
    reinterpret_cast<float4*>(cs)[i] = c4[i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < FOLD_ROWS * HIDDEN; idx += THREADS) {
    const int r = idx / HIDDEN, col = idx % HIDDEN, h = col / DH;
    float acc = 0.f;
    if (r < nr) {
      const T* wrow = wq + (size_t)(r0 + r) * HIDDEN + h * DH;
      const float* cblk = cs + h * DH * DH + col % DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(to_f(wrow[d]), cblk[d * DH], acc);
    }
    t1[idx] = acc;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < C; f += THREADS) {
    float acc[FOLD_ROWS];
#pragma unroll
    for (int r = 0; r < FOLD_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int k = 0; k < HIDDEN; k += 4) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = to_f(wout[(size_t)(k + q) * C + f]);
#pragma unroll
      for (int r = 0; r < FOLD_ROWS; ++r) {
        const float4 t = *reinterpret_cast<const float4*>(t1 + r * HIDDEN + k);
        acc[r] = fmaf(t.x, w[0], acc[r]);
        acc[r] = fmaf(t.y, w[1], acc[r]);
        acc[r] = fmaf(t.z, w[2], acc[r]);
        acc[r] = fmaf(t.w, w[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < FOLD_ROWS; ++r)
      if (r < nr) weff[((size_t)bi * C + r0 + r) * C + f] = from_f<T>(acc[r]);
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
template <typename T>
__global__ void __launch_bounds__(THREADS)
block_1p_kernel(const T* x, const float* g, const float* b, const T* wkv,
                const T* wq, const T* wout, const float* b_out, float* part_a,
                float* part_s, float* ctx4, T* weff, T* y, int B, int N, int C,
                int nchunks, int tpc) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  for (int it = blockIdx.x; it < B * nchunks; it += gridDim.x)
    ctx_partial_item<T>(x, g, b, wkv, part_a, part_s, N, C, tpc, it % nchunks,
                        it / nchunks, nchunks, smem);
  grid.sync();
  for (int it = blockIdx.x; it < B * 4; it += gridDim.x)
    reduce_head(part_a, part_s, ctx4, nchunks, it / 4, it % 4, 0, DH, smem);
  grid.sync();
  const int folds = (C + FOLD_ROWS - 1) / FOLD_ROWS;
  for (int it = blockIdx.x; it < B * folds; it += gridDim.x)
    fold_rows<T>(wq, wout, ctx4, weff, C, it / folds, (it % folds) * FOLD_ROWS,
                 smem);
  grid.sync();
  const int ntiles = (N + TN - 1) / TN;
  for (int it = blockIdx.x; it < B * ntiles; it += gridDim.x) {
    const int bi = it / ntiles;
    out_tile<T, -1>(x, g, b, weff + (size_t)bi * C * C, b_out, y, N, C,
                    it % ntiles, bi, smem);
  }
}

// ------------------------------------------------- tensor-core route (bf16)

constexpr int LDKV = KV + 8;    // bf16 a row of W_kv and of p | v (528 bytes)
constexpr int KS = 64;          // K rows a slab when the weights stream (C > NS)
constexpr int LDS = KS + 8;     // bf16 a row of a raw x slab (144 bytes)
constexpr int LDN = NS + 8;     // bf16 a row of a W_eff slab (528 bytes)

// Copies the rows x cols block at src (row stride lds) into dst (row
// stride ldd) as an R x CP block, zero outside rows x cols.  vec: by
// 16-byte cp.async (src 16-byte aligned, lds, cols and CP multiples of
// 8; the caller commits and waits), else by element loads and stores;
// by the nthr threads tid = 0 .. nthr - 1 (by default the block's).
__device__ void load_block(bf16* dst, int ldd, const bf16* src, size_t lds,
                           int rows, int cols, int R, int CP, bool vec,
                           int tid = threadIdx.x, int nthr = THREADS) {
  // element or chunk i = r * per + c walked by (r, c) steps, one division
  const int per = vec ? CP / 8 : CP, w = vec ? 8 : 1;
  const int dr = nthr / per, dc = nthr % per;
  int r = tid / per, c = tid % per;
  for (; r < R; r += dr, c += dc) {
    if (c >= per) {
      c -= per;
      ++r;
      if (r >= R) break;
    }
    const bool ok = r < rows && c * w < cols;
    if (vec)
      cp_async16(dst + r * ldd + 8 * c, ok ? src + r * lds + 8 * c : src, ok);
    else
      dst[r * ldd + c] = ok ? src[r * lds + c] : __float2bfloat16(0.f);
  }
}

// n floats of v from index k0 into dst, zero at and past index C
__device__ void load_vec(float* dst, const float* v, int k0, int n, int C) {
  for (int i = threadIdx.x; i < n; i += THREADS)
    dst[i] = k0 + i < C ? v[k0 + i] : 0.f;
}

// LN of an A fragment of raw x in place: rows r and r + 8 of its m16
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
    const __nv_bfloat162 o = __floats2bfloat162_rn(
        (v.x - m[h]) * ri[h] * gg.x + bb.x, (v.y - m[h]) * ri[h] * gg.y + bb.y);
    a[q] = *reinterpret_cast<const unsigned*>(&o);
  }
}

// acc[i][j] += A[16 i .. 16 i + 15][k] * B[k][8 j .. 8 j + 7] over k <
// 16 ksteps on mma.sync, for j < nt (even, <= NT; a warp-uniform
// count).  A: row-major bf16 (lda), from the warp's first row.  B: [k][n]
// bf16 (ldb); its n8 tiles j < NT / 2 from Bm on and, when SPLIT, the
// others from Bm2 on (else on from Bm).  LNF: A holds raw x, and ln_frag
// normalises each fragment (m, ri of the rows the lane holds; g, b of A's
// columns, from its column 0).
template <int MT, int NT, bool LNF, bool SPLIT>
__device__ __forceinline__ void mma_k(float (&acc)[MT][NT][4], const bf16* A,
                                      int lda, const bf16* Bm, const bf16* Bm2,
                                      int ldb, int ksteps, int nt,
                                      const float (&m)[MT][2],
                                      const float (&ri)[MT][2], const float* g,
                                      const float* b) {
  const int lane = threadIdx.x % 32, j8 = lane >> 3, r8 = lane & 7;
  // the A fragments of step ks (normalised when LNF), loaded and
  // normalised while the products of step ks - 1 run
  auto load_a = [&](unsigned (&a)[MT][4], int k0) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      ldmatrix_x4(a[i], A + (16 * i + (j8 & 1) * 8 + r8) * lda + k0 + (j8 >> 1) * 8);
      if constexpr (LNF && !(SKIP & 1)) ln_frag(a[i], m[i], ri[i], g, b, k0 + 2 * (lane & 3));
    }
  };
  unsigned a[MT][4];
  if (ksteps > 0) load_a(a, 0);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 16;
    // every B fragment of the step first, then the products: the loads'
    // latencies overlap
    unsigned bq[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      const bf16* bp = SPLIT && j >= NT / 2 ? Bm2 + 8 * (j - NT / 2) : Bm + 8 * j;
      ldmatrix_x4_trans(bq[j / 2], bp + (k0 + (j8 & 1) * 8 + r8) * ldb + (j8 >> 1) * 8);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (SKIP & 2) {   // keep the operands live
          acc[i][j][0] += __uint_as_float(a[i][0] ^ bq[j / 2][0]);
          acc[i][j + 1][0] += __uint_as_float(a[i][1] ^ bq[j / 2][2]);
          continue;
        }
        mma_bf16(acc[i][j], a[i], bq[j / 2][0], bq[j / 2][1]);
        mma_bf16(acc[i][j + 1], a[i], bq[j / 2][2], bq[j / 2][3]);
      }
    }
    if (ks + 1 < ksteps) load_a(a, k0 + 16);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// mean and 1 / (std + eps) of the rows r0 + 16 i + lane / 4 (+ 8) a lane
// of a warp from r0 holds in its A fragments
template <int MT>
__device__ __forceinline__ void frag_stats(const float* mean, const float* rinv,
                                           int r0, float (&m)[MT][2],
                                           float (&ri)[MT][2]) {
  const int grp = (threadIdx.x % 32) >> 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[i][h] = mean[r0 + 16 * i + grp + 8 * h];
      ri[i][h] = rinv[r0 + 16 * i + grp + 8 * h];
    }
}

constexpr int TS = 16;     // tokens a warp group's sub-tile (C <= NS; pass A also above)
constexpr int LDP = 72;    // bf16 a row of a warp's p | v (its head's 32 + 32)

// Shared memory of pass A, in bytes.  C <= NS: W_kv (KP x LDKV), two x
// sub-tiles a warp group (2 x 2 x TS x (KP + 8): x, then LN(x) in place),
// p | v a warp (8 x TS x LDP; the item's partials are combined there), g
// and b (KP each), the s reduce (HIDDEN).  C > NS: two W_kv slabs (KS x
// LDKV), two raw x slabs (2 TS x LDS), p | v, two g and b slabs (KS each),
// mean, rinv (2 TS), the s reduce.
__host__ __device__ constexpr int ctx_smem(int C) {
  return C <= NS ? (round_up(C, 16) * LDKV + 4 * TS * (round_up(C, 16) + 8) +
                    8 * TS * LDP) * 2 + (2 * round_up(C, 16) + HIDDEN) * 4
                 : (2 * KS * LDKV + 4 * TS * LDS + 8 * TS * LDP) * 2 +
                       (4 * KS + 4 * TS + HIDDEN) * 4;
}

// Pass A's shared memory on the tensor cores (ctx_smem), carved.
struct CtxSmem {
  bf16 *w, *xg, *pv;
  float *gs, *bs, *mean, *rinv, *red;
};

template <bool WIDE>
__device__ __forceinline__ CtxSmem ctx_carve(unsigned char* smem_raw, int C) {
  const int KP = round_up(C, 16), LDX = KP + 8;
  CtxSmem s;
  s.mean = s.rinv = nullptr;
  if constexpr (!WIDE) {
    s.w = reinterpret_cast<bf16*>(smem_raw);   // KP x LDKV
    s.xg = s.w + KP * LDKV;                     // 2 groups x 2 x TS x LDX
    s.pv = s.xg + 4 * TS * LDX;                 // 8 warps x TS x LDP
    s.gs = reinterpret_cast<float*>(s.pv + 8 * TS * LDP);   // KP
    s.bs = s.gs + KP;                           // KP
  } else {
    s.w = reinterpret_cast<bf16*>(smem_raw);   // 2 x KS x LDKV
    s.xg = s.w + 2 * KS * LDKV;                // 2 x 2 TS x LDS
    s.pv = s.xg + 4 * TS * LDS;                // 8 warps x TS x LDP
    s.gs = reinterpret_cast<float*>(s.pv + 8 * TS * LDP);   // 2 x KS
    s.bs = s.gs + 2 * KS;                      // 2 x KS
    s.mean = s.bs + 2 * KS;                    // 2 TS
    s.rinv = s.mean + 2 * TS;                  // 2 TS
  }
  s.red = s.bs + (WIDE ? 2 * KS + 4 * TS : KP);   // HIDDEN
  return s;
}

// What a block of pass A loads once, before its first item: at C <= NS
// W_kv (by cp.async, waited for by the first item), g and b.
template <bool WIDE>
__device__ __forceinline__ void ctx_mma_setup(const CtxSmem& s, const bf16* wkv,
                                              const float* g, const float* b,
                                              int C, int vec) {
  if constexpr (!WIDE) {   // W_kv, g, b for the block's life
    const int KP = round_up(C, 16);
    load_block(s.w, LDKV, wkv, KV, C, KV, KP, KV, vec);
    cp_async_commit();
    load_vec(s.gs, g, 0, KP, C);
    load_vec(s.bs, b, 0, KP, C);
  }
}

// Pass A on the tensor cores (bf16), one item: (sample bi, chunk) = (item
// / nchunks, item % nchunks), the 64-token tiles [chunk * tpc, (chunk +
// 1) * tpc) of sample bi; it writes the item's partial A (4 x 32 x 32)
// and s (128).  The block's two warp groups (warps 0-3, 4-7) take the
// item's TS-token sub-tiles in turn (group gr: sub-tiles gr, gr + 2, ...),
// each at its own pace at C <= NS (named barriers; the weights are shared
// and read-only), in step above it (the weight slabs are shared).  Warp
// wh of a group forms kv's columns of head wh (k: 32 wh .., v: 128 + 32
// wh ..) for the sub-tile's rows, so every warp takes its share of the
// exps, then A_wh += p_wh^T v_wh over those rows (K = TS tokens) from its
// own p | v: no block-wide exchange between the products.  At the item's
// end the groups' partials are added in a fixed order.  CPL: 16-byte
// chunks of a row a lane holds in the LN (C <= 64 CPL).  Called by
// ctx_mma_kernel and by the one-pass block_1p_mma_kernel, after
// ctx_mma_setup.
template <bool WIDE, int CPL>
__device__ __forceinline__ void ctx_mma_item(const CtxSmem& s, const bf16* x,
                                             const float* g, const float* b,
                                             const bf16* wkv, float* part_a,
                                             float* part_s, int N, int C,
                                             int nchunks, int tpc, int item,
                                             int vec) {
  const int KP = round_up(C, 16), LDX = KP + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int gr = warp >> 2, wh = warp & 3, gtid = threadIdx.x & 127;
  const int j8 = lane >> 3, r8 = lane & 7;
  const int nsub = (N + TS - 1) / TS;
  bf16 *w = s.w, *xg = s.xg, *pv = s.pv;
  float *gs = s.gs, *bs = s.bs, *mean = s.mean, *rinv = s.rinv, *red = s.red;
  bf16* pvw = pv + warp * TS * LDP;
  const float nom[1][2] = {};
  {
    const int bi = item / nchunks, chunk = item % nchunks;
    const int u0 = chunk * tpc * (TN / TS), u1 = min(nsub, u0 + tpc * (TN / TS));
    const bf16* xsamp = x + (size_t)bi * N * C;
    float acc_a[2][4][4], s_run[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_a[i][j][q] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s_run[j][0] = s_run[j][1] = 0.f;
    if constexpr (!WIDE) {
      // the group's first sub-tile; every copy (W_kv's too) landed and seen
      if (u0 + gr < u1 && !(SKIP & 16))
        load_block(xg + 2 * gr * TS * LDX, LDX, xsamp + (size_t)(u0 + gr) * TS * C,
                   C, min(TS, N - (u0 + gr) * TS), C, TS, KP, vec, gtid, 128);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    for (int k = 0; u0 + 2 * k < u1; ++k) {
      const int u = u0 + gr + 2 * k;
      const int rows = u < u1 ? min(TS, N - u * TS) : 0;
      float acc[1][8][4];
      zero(acc);
      if constexpr (!WIDE) {
        if (rows == 0) break;   // the group's sub-tiles are done
        bf16* cur = xg + (2 * gr + (k & 1)) * TS * LDX;
        if (k > 0) {
          cp_async_wait_all();
          bar_sync(1 + gr, 128);   // sub-tile k landed; k - 1's products are done
        }
        if (u + 2 < u1 && !(SKIP & 16)) {
          load_block(xg + (2 * gr + ((k + 1) & 1)) * TS * LDX, LDX,
                     xsamp + (size_t)(u + 2) * TS * C, C, min(TS, N - (u + 2) * TS),
                     C, TS, KP, vec, gtid, 128);
          cp_async_commit();
        }
        if (!(SKIP & 1)) {   // LN in place: a warp's four rows, eight lanes a row
          const int r = 4 * wh + (lane >> 3);
          row_ln8<CPL, true>(cur + r * LDX, r < rows, C, gs, bs);
        }
        bar_sync(1 + gr, 128);
        mma_k<1, 8, false, true>(acc, cur, LDX, w + DH * wh, w + HIDDEN + DH * wh,
                                 LDKV, KP / 16, 8, nom, nom, gs, bs);
      } else {
        const bf16* xt = xsamp + (size_t)(rows > 0 ? u : u0) * TS * C;
        __syncthreads();   // mean, rinv free
        row_stats<2 * TS>(xsamp + (size_t)(u0 + 2 * k) * TS * C, C,
                          min(2 * TS, N - (u0 + 2 * k) * TS), C, mean, rinv);
        __syncthreads();
        float m[1][2], ri[1][2];
        frag_stats(mean, rinv, TS * gr, m, ri);
        const int nsl = (KP + KS - 1) / KS;
        auto stage = [&](int sl) {
          const int k0 = sl * KS, kn = min(KS, C - k0);
          load_block(xg + ((sl & 1) * 2 + gr) * TS * LDS, LDS, xt + k0, C, rows, kn,
                     TS, KS, vec, gtid, 128);
          load_block(w + (sl & 1) * KS * LDKV, LDKV, wkv + (size_t)k0 * KV, KV, kn,
                     KV, KS, KV, vec);
          cp_async_commit();
          load_vec(gs + (sl & 1) * KS, g, k0, KS, C);
          load_vec(bs + (sl & 1) * KS, b, k0, KS, C);
        };
        stage(0);
        for (int sl = 0; sl < nsl; ++sl) {
          cp_async_wait_all();
          __syncthreads();   // slab sl landed; slab sl - 1's products are done
          if (sl + 1 < nsl) stage(sl + 1);
          const bf16* ws = w + (sl & 1) * KS * LDKV;
          mma_k<1, 8, true, true>(acc, xg + ((sl & 1) * 2 + gr) * TS * LDS, LDS,
                                  ws + DH * wh, ws + HIDDEN + DH * wh, LDKV,
                                  min(KS, KP - sl * KS) / 16, 8, m, ri,
                                  gs + (sl & 1) * KS, bs + (sl & 1) * KS);
        }
      }
      // p = exp(min(k, K_CLAMP)) (s summed in f32) and v, rounded to bf16
      // into the warp's p | v; rows past N are 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = grp + 8 * h;
        const bool ok = row < rows;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = acc[0][j][2 * h], v1 = acc[0][j][2 * h + 1];
          if (j < 4 && !(SKIP & 4)) {
            v0 = ok ? __expf(fminf(v0, K_CLAMP)) : 0.f;
            v1 = ok ? __expf(fminf(v1, K_CLAMP)) : 0.f;
            s_run[j][0] += v0;
            s_run[j][1] += v1;
          } else if (!ok) {
            v0 = v1 = 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(pvw + row * LDP + 8 * j + 2 * tig) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
      // A_wh += p^T v over the sub-tile's rows: A = p^T read transposed
      if (!(SKIP & 8)) {
        unsigned a[2][4], bq[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4_trans(a[i], pvw + ((j8 >> 1) * 8 + r8) * LDP + 16 * i + (j8 & 1) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          ldmatrix_x4_trans(bq[n], pvw + ((j8 & 1) * 8 + r8) * LDP + DH + 16 * n +
                                       (j8 >> 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc_a[i][2 * n], a[i], bq[n][0], bq[n][1]);
            mma_bf16(acc_a[i][2 * n + 1], a[i], bq[n][2], bq[n][3]);
          }
      }
      __syncwarp();   // p | v read before the next sub-tile's are written
    }
    // the item's partials: the groups' sums added in order (group 0's,
    // then group 1's, through p | v's room); s over a column's lanes by
    // shuffles first
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = s_run[j][q];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        s_run[j][q] = v;
      }
    float* scr = reinterpret_cast<float*>(pv);   // 32 floats x 128 threads
    __syncthreads();   // every group's products are done with p | v
    if (gr == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) scr[(16 * i + 4 * j + q) * 128 + gtid] = acc_a[i][j][q];
      if (grp == 0)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) red[DH * wh + 8 * j + 2 * tig + q] = s_run[j][q];
    }
    __syncthreads();
    if (gr == 0) {
      const size_t slot = (size_t)bi * nchunks + chunk;
      float* pa = part_a + (slot * 4 + wh) * DH * DH;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(pa + (16 * i + grp + 8 * h) * DH + 8 * j + 2 * tig) =
                make_float2(acc_a[i][j][2 * h] + scr[(16 * i + 4 * j + 2 * h) * 128 + gtid],
                            acc_a[i][j][2 * h + 1] +
                                scr[(16 * i + 4 * j + 2 * h + 1) * 128 + gtid]);
      if (grp == 0)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = DH * wh + 8 * j + 2 * tig + q;
            part_s[slot * HIDDEN + col] = s_run[j][q] + red[col];
          }
    }
    __syncthreads();   // p | v's room free again
  }
}

// Pass A's items 0 .. items - 1 on the tensor cores, a block's in grid
// strides.
template <bool WIDE, int CPL>
__device__ __forceinline__ void ctx_mma_items(const bf16* x, const float* g,
                                              const float* b, const bf16* wkv,
                                              float* part_a, float* part_s, int N,
                                              int C, int nchunks, int tpc, int items,
                                              int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CtxSmem s = ctx_carve<WIDE>(smem_raw, C);
  ctx_mma_setup<WIDE>(s, wkv, g, b, C, vec);
  for (int item = blockIdx.x; item < items; item += gridDim.x)
    ctx_mma_item<WIDE, CPL>(s, x, g, b, wkv, part_a, part_s, N, C, nchunks, tpc,
                            item, vec);
  cp_async_wait_all();   // no copy in flight at exit (a block with no item)
}

// Pass A on the tensor cores (bf16), part 1.  A persistent grid; a block
// walks the items in grid strides (ctx_mma_item).
template <bool WIDE, int CPL>
__global__ void __launch_bounds__(THREADS, 2)
ctx_mma_kernel(const bf16* x, const float* g, const float* b, const bf16* wkv,
               float* part_a, float* part_s, int N, int C, int nchunks, int tpc,
               int items, int vec) {
  ctx_mma_items<WIDE, CPL>(x, g, b, wkv, part_a, part_s, N, C, nchunks, tpc, items,
                           vec);
}

// Shared memory of pass B, in bytes.  C <= NS: W_eff[b] (KP x NP + 8),
// two raw x sub-tiles a warp group (4 x 2 x TS x (KP + 8); y is formed in
// place there), g, b (KP each), b_out (NP), mean, rinv (4 x TS each); NP =
// C rounded up to 32.  C > NS: two W_eff slabs (KS x LDN), two raw x slabs
// (TN x LDS), two g and b slabs (KS each), mean, rinv (TN).
__host__ __device__ constexpr int out_smem(int C) {
  return C <= NS ? (round_up(C, 16) * (round_up(C, 32) + 8) +
                    8 * TS * (round_up(C, 16) + 8)) * 2 +
                       (2 * round_up(C, 16) + round_up(C, 32) + 8 * TS) * 4
                 : (2 * KS * LDN + 2 * TN * LDS) * 2 + (4 * KS + 2 * TN) * 4;
}

// Pass B's shared memory on the tensor cores (out_smem), carved.
struct OutSmem {
  bf16 *w, *xb;
  float *gs, *bs, *bos, *mean, *rinv;
};

template <bool WIDE>
__device__ __forceinline__ OutSmem out_carve(unsigned char* smem_raw, int C) {
  const int KP = round_up(C, 16), NP = round_up(C, 32);
  const int LDX = KP + 8, LDW = NP + 8;
  OutSmem s;
  s.bos = nullptr;
  if constexpr (!WIDE) {
    s.w = reinterpret_cast<bf16*>(smem_raw);       // KP x LDW
    s.xb = s.w + KP * LDW;                          // 4 x 2 x TS x LDX
    s.gs = reinterpret_cast<float*>(s.xb + 8 * TS * LDX);   // KP
    s.bs = s.gs + KP;                               // KP
    s.bos = s.bs + KP;                              // NP
    s.mean = s.bos + NP;                            // 4 x TS
  } else {
    s.w = reinterpret_cast<bf16*>(smem_raw);       // 2 x KS x LDN
    s.xb = s.w + 2 * KS * LDN;                      // 2 x TN x LDS
    s.gs = reinterpret_cast<float*>(s.xb + 2 * TN * LDS);   // 2 x KS
    s.bs = s.gs + 2 * KS;                           // 2 x KS
    s.mean = s.bs + 2 * KS;                         // TN
  }
  s.rinv = s.mean + (WIDE ? TN : 4 * TS);
  return s;
}

// What a block of pass B loads once, before its first item: at C <= NS
// g, b and b_out.
template <bool WIDE>
__device__ __forceinline__ void out_mma_setup(const OutSmem& s, const float* g,
                                              const float* b, const float* b_out,
                                              int C) {
  if constexpr (!WIDE) {
    const int KP = round_up(C, 16), NP = round_up(C, 32);
    load_vec(s.gs, g, 0, KP, C);
    load_vec(s.bs, b, 0, KP, C);
    load_vec(s.bos, b_out, 0, NP, C);
  }
}

// Pass B on the tensor cores (bf16), one item: y = x + LN(x) @ W_eff[b] +
// b_out over the item (sample, chunk) as pass A's.  C <= NS: W_eff[b]
// stays in shared memory while the block's items are of sample b
// (`loaded`: the sample whose W_eff is there, -1 before the first item);
// the block's four warp groups (warps 2 gr, 2 gr + 1) take the item's
// TS-token sub-tiles in turn, each at its own pace (named barriers), warp
// gw of a group forming the sub-tile's gw-th half of the columns rounded
// up to 32 (at most NT n8 tiles, C <= 4 NT), with LN taken on the A
// fragments of the raw x sub-tile; y may be x (each sub-tile is read
// whole before any of it is written).  C > NS: 64-token tiles, warp (wm,
// wn) = (warp / 2, warp % 2) forming rows 16 wm .. +15 and the wn-th half
// of each column slab of NS; y is not x.  Called by out_mma_kernel and
// by the one-pass block_1p_mma_kernel, after out_mma_setup.
template <bool WIDE, int NT>
__device__ __forceinline__ void out_mma_item(const OutSmem& s, const bf16* x,
                                             const float* g, const float* b,
                                             const bf16* weff, const float* b_out,
                                             bf16* y, int N, int C, int nchunks,
                                             int tpc, int item, int vec,
                                             int& loaded) {
  const int KP = round_up(C, 16), NP = round_up(C, 32);
  const int LDX = KP + 8, LDW = NP + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;   // C > NS; C <= NS: group wm, warp wn
  const int ntiles = (N + TN - 1) / TN;
  bf16 *w = s.w, *xb = s.xb;
  float *gs = s.gs, *bs = s.bs, *bos = s.bos, *mean = s.mean, *rinv = s.rinv;
  {
    const int bi = item / nchunks, chunk = item % nchunks;
    const int t0 = chunk * tpc, t1 = min(ntiles, t0 + tpc);
    const size_t sbase = (size_t)bi * N * C;
    const bf16* wb = weff + (size_t)bi * C * C;
    if constexpr (!WIDE) {
      const int gr = wm, gtid = threadIdx.x & 63;
      const int nsub = (N + TS - 1) / TS;
      const int u0 = t0 * (TN / TS), u1 = min(nsub, t1 * (TN / TS));
      float* gmean = mean + TS * gr;
      float* grinv = rinv + TS * gr;
      __syncthreads();   // the previous item is done with w and xb
      if (bi != loaded) {
        load_block(w, LDW, wb, C, C, C, KP, NP, vec);
        loaded = bi;
      }
      if (u0 + gr < u1 && !(SKIP & 16))
        load_block(xb + 2 * gr * TS * LDX, LDX, x + sbase + (size_t)(u0 + gr) * TS * C,
                   C, min(TS, N - (u0 + gr) * TS), C, TS, KP, vec, gtid, 64);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();   // W_eff[b] and the groups' first sub-tiles landed
      for (int k = 0;; ++k) {
        const int u = u0 + gr + 4 * k;
        if (u >= u1) break;
        const int rows = min(TS, N - u * TS);
        bf16* cur = xb + (2 * gr + (k & 1)) * TS * LDX;
        if (k > 0) {
          cp_async_wait_all();
          bar_sync(1 + gr, 64);   // sub-tile k landed; k - 1's stores are done
        }
        if (u + 4 < u1 && !(SKIP & 16)) {
          load_block(xb + (2 * gr + ((k + 1) & 1)) * TS * LDX, LDX,
                     x + sbase + (size_t)(u + 4) * TS * C, C, min(TS, N - (u + 4) * TS),
                     C, TS, KP, vec, gtid, 64);
          cp_async_commit();
        }
        if (!(SKIP & 1)) {   // row statistics: eight lanes a row, two rounds
#pragma unroll
          for (int rd = 0; rd < 2; ++rd) {
            const int r = 8 * rd + 4 * wn + (lane >> 3);
            const float2 st = row_ln8<NT / 4, false>(cur + r * LDX, r < rows, C, nullptr,
                                                   nullptr);
            if ((lane & 7) == 0) {
              gmean[r] = r < rows ? st.x : 0.f;
              grinv[r] = r < rows ? st.y : 0.f;
            }
          }
        }
        bar_sync(1 + gr, 64);
        float m[1][2], ri[1][2];
        frag_stats(gmean, grinv, 0, m, ri);
        float acc[1][NT][4];
        zero(acc);
        const int nt = NP / 16;
        mma_k<1, NT, true, false>(acc, cur, LDX, w + wn * (NP / 2), nullptr, LDW,
                                  KP / 16, nt, m, ri, gs, bs);
        bar_sync(1 + gr, 64);   // every read of the sub-tile's x done: y overwrites it
        // y = x + acc + b_out over x in the sub-tile; an even C takes pairs,
        // every load before any store
        const int c0 = wn * (NP / 2) + 2 * tig, r0 = grp;
        if (SKIP & 4) {
        } else if (C % 2 == 0) {
#pragma unroll
          for (int j0 = 0; j0 < NT; j0 += 4) {   // four n8 tiles at a time
            if (j0 >= nt) break;
            __nv_bfloat162 xv[4][2];
            float2 bo[4];
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j) {
              if (j >= nt) break;
              bo[j - j0] = *reinterpret_cast<const float2*>(bos + c0 + 8 * j);
#pragma unroll
              for (int h = 0; h < 2; ++h)
                xv[j - j0][h] = *reinterpret_cast<const __nv_bfloat162*>(
                    cur + (r0 + 8 * h) * LDX + c0 + 8 * j);
            }
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j) {
              if (j >= nt) break;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (r0 + 8 * h >= rows || c0 + 8 * j >= C) continue;
                const float2 f = __bfloat1622float2(xv[j - j0][h]);
                *reinterpret_cast<__nv_bfloat162*>(cur + (r0 + 8 * h) * LDX + c0 +
                                                   8 * j) =
                    __floats2bfloat162_rn(f.x + acc[0][j][2 * h] + bo[j - j0].x,
                                          f.y + acc[0][j][2 * h + 1] + bo[j - j0].y);
              }
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j >= nt) break;
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int row = r0 + 8 * h, col = c0 + 8 * j + q;
                if (row < rows && col < C) {
                  bf16& e = cur[row * LDX + col];
                  e = __float2bfloat16(to_f(e) + acc[0][j][2 * h + q] + bos[col]);
                }
              }
          }
        }
        bar_sync(1 + gr, 64);   // y formed: to device memory as 16-byte rows
        bf16* yt = y + sbase + (size_t)u * TS * C;
        {   // element or chunk i = r * per + c walked by (r, c) steps
          const int per = vec ? C / 8 : C, dr = 64 / per, dc = 64 % per;
          int r = gtid / per, c = gtid % per;
          for (; r < rows; r += dr, c += dc) {
            if (c >= per) {
              c -= per;
              if (++r >= rows) break;
            }
            if (vec)
              *reinterpret_cast<uint4*>(yt + (size_t)r * C + 8 * c) =
                  *reinterpret_cast<const uint4*>(cur + r * LDX + 8 * c);
            else
              yt[(size_t)r * C + c] = cur[r * LDX + c];
          }
        }
      }
    } else {
      for (int t = t0; t < t1; ++t) {
        const int rows = min(TN, N - t * TN);
        const bf16* xt = x + sbase + (size_t)t * TN * C;
        bf16* yt = y + sbase + (size_t)t * TN * C;
        __syncthreads();   // mean, rinv free
        row_stats<TN>(xt, C, rows, C, mean, rinv);
        __syncthreads();
        float m[1][2], ri[1][2];
        frag_stats(mean, rinv, 16 * wm, m, ri);
        const int nsl = (KP + KS - 1) / KS;
        for (int n0 = 0; n0 < C; n0 += NS) {
          const int ncols = min(NS, C - n0), np = round_up(ncols, 32);
          const int nt = np / 16;
          auto stage = [&](int s) {
            const int k0 = s * KS, kn = min(KS, C - k0);
            load_block(xb + (s & 1) * TN * LDS, LDS, xt + k0, C, rows, kn, TN, KS, vec);
            load_block(w + (s & 1) * KS * LDN, LDN, wb + (size_t)k0 * C + n0, C, kn,
                       ncols, KS, np, vec);
            cp_async_commit();
            load_vec(gs + (s & 1) * KS, g, k0, KS, C);
            load_vec(bs + (s & 1) * KS, b, k0, KS, C);
          };
          float acc[1][NT][4];
          zero(acc);
          __syncthreads();   // the previous column slab's products are done
          stage(0);
          for (int s = 0; s < nsl; ++s) {
            cp_async_wait_all();
            __syncthreads();   // slab s landed; slab s - 1's products are done
            if (s + 1 < nsl) stage(s + 1);
            mma_k<1, NT, true, false>(acc, xb + (s & 1) * TN * LDS + 16 * wm * LDS, LDS,
                               w + (s & 1) * KS * LDN + wn * (np / 2), nullptr, LDN,
                               min(KS, KP - s * KS) / 16, nt, m, ri,
                               gs + (s & 1) * KS, bs + (s & 1) * KS);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j >= nt) break;
            const int col = n0 + wn * (np / 2) + 8 * j + 2 * tig;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * wm + grp + 8 * h;
#pragma unroll
              for (int q = 0; q < 2; ++q)
                if (row < rows && col + q < C) {
                  const size_t at = (size_t)row * C + col + q;
                  yt[at] = __float2bfloat16(to_f(xt[at]) + acc[0][j][2 * h + q] +
                                            b_out[col + q]);
                }
            }
          }
        }
      }
    }
  }
}

// Pass B's items on the tensor cores, a block's in grid strides: from
// item blockIdx.x up, or (REVERSE) from item items - 1 - blockIdx.x down.
template <bool WIDE, int NT, bool REVERSE>
__device__ __forceinline__ void out_mma_items(const bf16* x, const float* g,
                                              const float* b, const bf16* weff,
                                              const float* b_out, bf16* y, int N,
                                              int C, int nchunks, int tpc, int items,
                                              int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const OutSmem s = out_carve<WIDE>(smem_raw, C);
  out_mma_setup<WIDE>(s, g, b, b_out, C);
  int loaded = -1;   // the sample whose W_eff is in w (C <= NS)
  if constexpr (REVERSE) {
    for (int item = items - 1 - blockIdx.x; item >= 0; item -= gridDim.x)
      out_mma_item<WIDE, NT>(s, x, g, b, weff, b_out, y, N, C, nchunks, tpc, item, vec,
                             loaded);
  } else {
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      out_mma_item<WIDE, NT>(s, x, g, b, weff, b_out, y, N, C, nchunks, tpc, item, vec,
                             loaded);
  }
  cp_async_wait_all();   // no copy in flight at exit (a block with no item)
}

// Pass B on the tensor cores (bf16).  A persistent grid; a block walks
// the items (sample, chunk) in grid strides as pass A's does
// (out_mma_item).
template <bool WIDE, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 8 ? 2 : 1)
out_mma_kernel(const bf16* x, const float* g, const float* b, const bf16* weff,
               const float* b_out, bf16* y, int N, int C, int nchunks, int tpc,
               int items, int vec) {
  out_mma_items<WIDE, NT, false>(x, g, b, weff, b_out, y, N, C, nchunks, tpc, items,
                                 vec);
}

// The one-pass kernel's first three phases are calls, not inlined, so
// that ptxas allocates each phase's registers apart from the others'
// (inlined into one body with pass B's, they spill at 128 registers a
// thread; pass B stays inline, where it has the kernel's registers to
// itself).  Pass A:
template <bool WIDE, int CPL>
__device__ __noinline__ void ctx_phase_1p(const bf16* x, const float* g,
                                          const float* b, const bf16* wkv,
                                          float* part_a, float* part_s, int N, int C,
                                          int nchunks, int tpc, int items, int vec) {
  ctx_mma_items<WIDE, CPL>(x, g, b, wkv, part_a, part_s, N, C, nchunks, tpc, items,
                           vec);
}

// The one-pass block on the tensor cores (bf16): pass A's and pass B's
// items through the same ctx_mma_item / out_mma_item as the two-pass
// kernels, in one cooperative launch of at most as many blocks as fit on
// the card at once, with a grid-wide barrier between the phases:
//   phase 0: pass A's items (B x nchunks), partials to part_a, part_s
//   phase 1: the reduce, per (sample, head, 8 rows), into ctx4
//            (reduce_head)
//   phase 2: the W_eff fold in f32, per (sample, FOLD_ROWS rows), rounded
//            to bf16 into weff (fold_rows)
//   phase 3: pass B's items, walked in the reverse of phase 0's order so
//            that the x a block read last in phase 0 is the first it
//            re-reads (the most likely to be in L2); y out of place, as
//            JAX's one-pass kernel does not alias.
// Shared memory: the largest any phase takes (block_1p_smem).
// The one-pass kernel's reduce: items of RQ rows of a head's block, one
// entry a thread.
__device__ __noinline__ void reduce_phase_1p(const float* part_a, const float* part_s,
                                             float* ctx4, int B, int nchunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RQ = THREADS / DH, QS = DH / RQ;
  for (int it = blockIdx.x; it < B * 4 * QS; it += gridDim.x)
    reduce_head(part_a, part_s, ctx4, nchunks, it / (4 * QS), (it / QS) % 4,
                (it % QS) * RQ, RQ, reinterpret_cast<float*>(smem_raw));
}

// The one-pass kernel's fold: items of FOLD_ROWS rows of a sample's W_eff.
__device__ __noinline__ void fold_phase_1p(const bf16* wq, const bf16* wout,
                                           const float* ctx4, bf16* weff, int B, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int folds = (C + FOLD_ROWS - 1) / FOLD_ROWS;
  for (int it = blockIdx.x; it < B * folds; it += gridDim.x)
    fold_rows<bf16>(wq, wout, ctx4, weff, C, it / folds, (it % folds) * FOLD_ROWS,
                    reinterpret_cast<float*>(smem_raw));
}

template <bool WIDE, int CPL, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 8 ? 2 : 1)
block_1p_mma_kernel(const bf16* x, const float* g, const float* b,
                    const bf16* wkv, const bf16* wq, const bf16* wout,
                    const float* b_out, float* part_a, float* part_s, float* ctx4,
                    bf16* weff, bf16* y, int B, int N, int C, int nchunks, int tpc,
                    int vec) {
  ctx_phase_1p<WIDE, CPL>(x, g, b, wkv, part_a, part_s, N, C, nchunks, tpc,
                          B * nchunks, vec);
  cg::this_grid().sync();
  if (PHASES_1P < 2) return;
  reduce_phase_1p(part_a, part_s, ctx4, B, nchunks);
  cg::this_grid().sync();
  if (PHASES_1P < 3) return;
  fold_phase_1p(wq, wout, ctx4, weff, B, C);
  cg::this_grid().sync();
  if (PHASES_1P < 4) return;
  out_mma_items<WIDE, NT, true>(x, g, b, weff, b_out, y, N, C, nchunks, tpc,
                                B * nchunks, vec);
}

// Shared memory of block_1p_mma_kernel, in bytes: the largest of pass
// A's, pass B's and the fold's (the reduce takes fewer).
__host__ __device__ constexpr int block_1p_smem(int C) {
  return imax(imax(ctx_smem(C), out_smem(C)), FOLD_SMEM * (int)sizeof(float));
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int ctx_launch_fma(const T* x, const float* g, const float* b, const T* wkv,
                   float* part_a, float* part_s, int B, int N, int C, int nchunks,
                   int tpc, cudaStream_t stream) {
  const int smem = FMA_CTX_SMEM * (int)sizeof(float);
  cudaError_t err = allow_smem(ctx_partial_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ctx_partial_kernel<T><<<dim3(nchunks, B), THREADS, smem, stream>>>(
      x, g, b, wkv, part_a, part_s, N, C, tpc);
  return (int)cudaGetLastError();
}

// grid (ceil(N / 64), B); the slabs' width: the fewest 32s, 64s or 128s
// that cover C, else NS
template <typename T>
int out_launch_fma(const T* x, const float* g, const float* b, const T* weff,
                   const float* b_out, T* y, int B, int N, int C,
                   cudaStream_t stream) {
  auto launch = [&](auto kernel) {
    const int smem = FMA_OUT_SMEM * (int)sizeof(float);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((N + TN - 1) / TN, B), THREADS, smem, stream>>>(x, g, b, weff,
                                                                  b_out, y, N, C);
    return (int)cudaGetLastError();
  };
  if (C <= 32) return launch(out_kernel<T, 1>);
  if (C <= 64) return launch(out_kernel<T, 2>);
  if (C <= 128) return launch(out_kernel<T, 4>);
  return launch(out_kernel<T, 8>);
}

// f(the pass-A kernel for width C): the fewest 16-byte chunks a lane
// that hold a row in the LN
template <typename F>
int with_ctx_kernel(int C, F f) {
  if (C > NS) return f(ctx_mma_kernel<true, 4>);
  if (C <= 64) return f(ctx_mma_kernel<false, 1>);
  if (C <= 128) return f(ctx_mma_kernel<false, 2>);
  return f(ctx_mma_kernel<false, 4>);
}

int ctx_launch_mma(const bf16* x, const float* g, const float* b, const bf16* wkv,
                   float* part_a, float* part_s, int B, int N, int C, int nchunks,
                   int tpc, int grid, int vec, cudaStream_t stream) {
  const int smem = ctx_smem(C);
  return with_ctx_kernel(C, [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, stream>>>(x, g, b, wkv, part_a, part_s, N, C,
                                           nchunks, tpc, B * nchunks, vec);
    return (int)cudaGetLastError();
  });
}

// f(the pass-B kernel for width C): the fewest n8 tiles a warp that
// cover its half of the columns
template <typename F>
int with_out_kernel(int C, F f) {
  if (C > NS) return f(out_mma_kernel<true, 16>);
  const int nt = round_up(C, 32) / 16;
  if (nt <= 4) return f(out_mma_kernel<false, 4>);
  if (nt <= 8) return f(out_mma_kernel<false, 8>);
  return f(out_mma_kernel<false, 16>);
}

int out_launch_mma(const bf16* x, const float* g, const float* b, const bf16* weff,
                   const float* b_out, bf16* y, int B, int N, int C, int nchunks,
                   int tpc, int grid, int vec, cudaStream_t stream) {
  const int smem = out_smem(C);
  return with_out_kernel(C, [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, stream>>>(x, g, b, weff, b_out, y, N, C, nchunks,
                                           tpc, B * nchunks, vec);
    return (int)cudaGetLastError();
  });
}

// blocks of kernel (THREADS threads, smem bytes) that fit on one SM, or a
// negative CUDA error code
template <typename K>
int per_sm(K kernel, int smem) {
  cudaError_t err = allow_smem(kernel, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Blocks of `kernel` (THREADS threads, smem bytes) that fit on the card
// at once, or a negative CUDA error code; 0 if the card cannot launch
// cooperatively.
template <typename K>
int resident(K kernel, int smem) {
  const int n = per_sm(kernel, smem);
  if (n < 0) return n;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
          cudaSuccess)
    return -(int)err;
  return coop ? n * sms : 0;
}

// Blocks of block_1p_kernel<T> (FMA) that fit on the card at once.
template <typename T>
int resident_1p() {
  return resident(block_1p_kernel<T>, FMA_CTX_SMEM * (int)sizeof(float));
}

// f(the one-pass tensor-core kernel for width C): pass A's CPL and pass
// B's NT as with_ctx_kernel and with_out_kernel pick them
template <typename F>
int with_1p_kernel(int C, F f) {
  if (C > NS) return f(block_1p_mma_kernel<true, 4, 16>);
  if (C <= 64) return f(block_1p_mma_kernel<false, 1, 4>);
  if (C <= 128) return f(block_1p_mma_kernel<false, 2, 8>);
  return f(block_1p_mma_kernel<false, 4, 16>);
}

// Blocks of the one-pass tensor-core kernel at width C that fit on the
// card at once.
int resident_1p_mma(int C) {
  return with_1p_kernel(C, [&](auto kernel) { return resident(kernel, block_1p_smem(C)); });
}

template <typename T>
int launch_1p(const void* x, const void* g, const void* b, const void* wkv,
              const void* wq, const void* wout, const void* b_out, void* part_a,
              void* part_s, void* ctx4, void* weff, void* y, int B, int N, int C,
              int nchunks, int tpc, int grid, cudaStream_t stream) {
  const int resident = resident_1p<T>();
  if (resident < 0) return -resident;
  // every block must be resident, or the grid barrier never opens
  if (grid < 1 || grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  const T *xp = (const T*)x, *wkvp = (const T*)wkv, *wqp = (const T*)wq,
          *woutp = (const T*)wout;
  const float *gp = (const float*)g, *bp = (const float*)b,
              *bop = (const float*)b_out;
  float *pap = (float*)part_a, *psp = (float*)part_s, *cp = (float*)ctx4;
  T *weffp = (T*)weff, *yp = (T*)y;
  void* args[] = {&xp,  &gp, &bp,    &wkvp, &wqp, &woutp, &bop, &pap,    &psp,
                  &cp,  &weffp, &yp, &B,    &N,   &C,     &nchunks, &tpc};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)block_1p_kernel<T>, dim3(grid), dim3(THREADS), args,
      FMA_CTX_SMEM * (int)sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// block_1p_mma_kernel on `grid` blocks; cudaLaunchCooperativeKernel
// refuses a grid larger than fits on the card at once.
int launch_1p_mma(const bf16* x, const float* g, const float* b, const bf16* wkv,
                  const bf16* wq, const bf16* wout, const float* b_out,
                  float* part_a, float* part_s, float* ctx4, bf16* weff, bf16* y,
                  int B, int N, int C, int nchunks, int tpc, int grid, int vec,
                  cudaStream_t stream) {
  const int smem = block_1p_smem(C);
  return with_1p_kernel(C, [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&x,    &g,  &b,    &wkv,   &wq,   &wout, &b_out,
                    &part_a, &part_s, &ctx4, &weff, &y,   &B,    &N,
                    &C,    &nchunks, &tpc, &vec};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS),
                                      args, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA: grid (nchunks, B); `grid` and `vec` unread),
// 1 = bfloat16 (tensor cores: a persistent grid of `grid` blocks over the
// B * nchunks items).  Shapes: x (B, N, C); g, b (C) f32; wkv (C, 256) of
// x's type; part_a (B, nchunks, 4, 32, 32) f32; part_s (B, nchunks, 128)
// f32; ctx (B, 128, 128) f32.  vec: x and wkv are 16-byte aligned and C %
// 8 == 0 (16-byte copies), else element copies.
int attn_ctx(const void* x, const void* g, const void* b, const void* wkv,
             void* part_a, void* part_s, void* ctx, int B, int N, int C,
             int nchunks, int tiles_per_chunk, int grid, int vec, int dtype,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (dtype == 1) {
    const bf16 *xp = (const bf16*)x, *wp = (const bf16*)wkv;
#if ATTN_BF16_FMA
    err = ctx_launch_fma(xp, (const float*)g, (const float*)b, wp, (float*)part_a,
                         (float*)part_s, B, N, C, nchunks, tiles_per_chunk, s);
#else
    err = ctx_launch_mma(xp, (const float*)g, (const float*)b, wp, (float*)part_a,
                         (float*)part_s, B, N, C, nchunks, tiles_per_chunk, grid,
                         vec, s);
#endif
  } else {
    err = ctx_launch_fma((const float*)x, (const float*)g, (const float*)b,
                         (const float*)wkv, (float*)part_a, (float*)part_s, B, N,
                         C, nchunks, tiles_per_chunk, s);
  }
  if (err != 0) return err;
  ctx_reduce_kernel<<<dim3(HIDDEN / 8, B), THREADS, 0, s>>>((const float*)part_a,
                                          (const float*)part_s, (float*)ctx,
                                          nchunks);
  return (int)cudaGetLastError();
}

// weff (B, C, C) of x's type; b_out (C) f32; y (B, N, C), may equal x
// when C <= 256.  dtype 0: FMA, grid (ceil(N / 64), B) (nchunks, tpc,
// grid, vec unread); 1: tensor cores, as attn_ctx (vec: x, weff and y
// 16-byte aligned and C % 8 == 0).
int attn_out(const void* x, const void* g, const void* b, const void* weff,
             const void* b_out, void* y, int B, int N, int C, int nchunks,
             int tiles_per_chunk, int grid, int vec, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    const bf16 *xp = (const bf16*)x, *wp = (const bf16*)weff;
#if ATTN_BF16_FMA
    return out_launch_fma(xp, (const float*)g, (const float*)b, wp,
                          (const float*)b_out, (bf16*)y, B, N, C, s);
#else
    return out_launch_mma(xp, (const float*)g, (const float*)b, wp,
                          (const float*)b_out, (bf16*)y, B, N, C, nchunks,
                          tiles_per_chunk, grid, vec, s);
#endif
  }
  return out_launch_fma((const float*)x, (const float*)g, (const float*)b,
                        (const float*)weff, (const float*)b_out, (float*)y, B, N,
                        C, s);
}

// Blocks of the tensor-core kernel of pass A (pass 0) or B (pass 1) at
// width C that fit on one SM, or a negative CUDA error code.
int attn_mma_per_sm(int pass, int C) {
  if (pass == 0)
    return with_ctx_kernel(C, [&](auto kernel) { return per_sm(kernel, ctx_smem(C)); });
  return with_out_kernel(C, [&](auto kernel) { return per_sm(kernel, out_smem(C)); });
}

// The number of blocks of the one-pass kernel for (C, dtype) that fit on
// the card at once (the largest grid attn_1p takes), 0 if the card cannot
// launch cooperatively, or a negative CUDA error code.
int attn_1p_resident(int C, int dtype) {
  if (dtype != 1) return resident_1p<float>();
#if ATTN_BF16_FMA
  return resident_1p<bf16>();
#else
  return resident_1p_mma(C);
#endif
}

// The whole block in one cooperative launch of `grid` blocks (at most
// attn_1p_resident's).  x, y (B, N, C) of dtype, y not x; wkv (C, 256),
// wq (C, 128), wout (128, C) of dtype; g, b, b_out (C) f32; part_a
// (B, nchunks, 4, 32, 32), part_s (B, nchunks, 128), ctx4 (B, 4, 32, 32)
// f32 and weff (B, C, C) of dtype are scratch.  dtype 0: FMA
// (block_1p_kernel; vec unread); 1: tensor cores (block_1p_mma_kernel;
// vec: x, wkv, weff and y 16-byte aligned and C % 8 == 0).
int attn_1p(const void* x, const void* g, const void* b, const void* wkv,
            const void* wq, const void* wout, const void* b_out, void* part_a,
            void* part_s, void* ctx4, void* weff, void* y, int B, int N, int C,
            int nchunks, int tiles_per_chunk, int grid, int vec, int dtype,
            void* stream) {
  if (dtype == 1) {
#if ATTN_BF16_FMA
    return launch_1p<bf16>(x, g, b, wkv, wq, wout, b_out, part_a, part_s, ctx4,
                           weff, y, B, N, C, nchunks, tiles_per_chunk, grid,
                           (cudaStream_t)stream);
#else
    return launch_1p_mma((const bf16*)x, (const float*)g, (const float*)b,
                         (const bf16*)wkv, (const bf16*)wq, (const bf16*)wout,
                         (const float*)b_out, (float*)part_a, (float*)part_s,
                         (float*)ctx4, (bf16*)weff, (bf16*)y, B, N, C, nchunks,
                         tiles_per_chunk, grid, vec, (cudaStream_t)stream);
#endif
  }
  return launch_1p<float>(x, g, b, wkv, wq, wout, b_out, part_a, part_s, ctx4,
                          weff, y, B, N, C, nchunks, tiles_per_chunk, grid,
                          (cudaStream_t)stream);
}

}  // extern "C"
