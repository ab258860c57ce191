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
// The softmax never leaves the chip.  On the TPU the token grid runs in
// order, so one running max m, sum s and accumulator A carry across it.
// Here blocks run in no order, so each sample's tokens are split into
// chunks (ops/linear_attention.py:_chunks, about two blocks an SM): a
// block walks its chunk with its own running max per k channel,
// rescaling s and A by exp(m_old - m_new) as the max grows, and writes
// its partial (m, s, A).  lin_ctx_reduce (a block a head of a sample)
// merges the partials in chunk order, each rescaled by exp(m_i - m) for
// the global max m, and writes ctx: deterministic, no atomics.  Only the
// heads' DH x DH diagonal blocks of A are formed (the TPU kernel forms
// all of A and masks it; the rest of ctx is zero in both), as 32 x 32
// blocks, so that any head width runs the same kernels.
//
// Two routes:
//  * bf16, on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//    sums).  lin_ctx_mma: a block takes whole HD-wide token rows of k and
//    v (HD x 2 contiguous bytes a row, by 16-byte cp.async into a ring of
//    two 64-token stages, one landing while the block works on the
//    other) for every head at once.  Per stage it takes each k
//    channel's max over the stage's tokens (eight row groups, then in
//    order), the rescale factor, p = exp(k - m) with s summed in f32, and
//    writes p as a bf16 pair, hi = bf16(p) and lo = bf16(p - hi), so that
//    hi + lo holds p to ~2^-16 and, v being exact in bf16, A keeps f32's
//    accuracy (the TPU kernel multiplies in f32).  Warp w forms one 32 x
//    32 block of A (A += hi^T v + lo^T v, p read transposed by
//    ldmatrix.trans); when the blocks are fewer than the warps, warps in
//    TG token groups take the stage's 16-token steps in turn and their
//    sums are added in a fixed order at the chunk's end.  More blocks of A
//    than warps: grid.z splits them (each block recomputes the stage's
//    p).  lin_out_mma: a block takes a run of 64-token tiles of one
//    sample, all HD columns, with the heads' diagonal ctx blocks rounded
//    to bf16 in shared memory for its life (as the TPU kernel casts ctx
//    to q's type); q tiles arrive by cp.async (two stages), so q is read
//    once; out = q . ctx on mma.sync with f32 sums, rounded to bf16,
//    staged in shared memory and stored as 16-byte rows.
//  * float32: FMA loops, exact (lin_ctx_partial, a block a 32 x 32 block
//    of A of one head for one chunk; lin_out, a block a 32-column block
//    of out for one tile).
//
// C interface: plain C entries, loaded with ctypes.  Each launches on
// the stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"  // cp_async16, ldmatrix_x4(_trans), mma_bf16

namespace {

typedef __nv_bfloat16 bf16;

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

// grid (B, heads, parts).  Merges the partials of head h of a sample in
// chunk order: m = max m_i, s = sum s_i exp(m_i - m), A = sum A_i exp(m_i
// - m) (row-wise), and writes the head's rows of ctx (HD x HD, f32): A /
// s on its diagonal block, 0 elsewhere.  Block p takes the entries p
// THREADS .. of the head's DH x DH block, one a thread, each summed with
// eight chunks' loads in flight, and zeroes the rows p, p + parts, ...
// outside the block.
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
#pragma unroll 8
    for (int i = 0; i < nchunks; ++i) m = fmaxf(m, part_m[(slot0 + i) * HD + c]);
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < nchunks; ++i)
      s += part_s[(slot0 + i) * HD + c] * expf(part_m[(slot0 + i) * HD + c] - m);
    mg[d] = m;
    sg[d] = s;
  }
  __syncthreads();
  float* rows = ctx + ((size_t)bi * HD + (size_t)h * DH) * HD;   // the head's DH rows
  const int idx = blockIdx.z * THREADS + threadIdx.x;
  if (idx < DH * DH) {
    const int d = idx / DH, e = idx % DH;
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < nchunks; ++i)
      a += part_a[((slot0 + i) * heads + h) * DH * DH + idx] *
           expf(part_m[(slot0 + i) * HD + h * DH + d] - mg[d]);
    rows[(size_t)d * HD + h * DH + e] = a / sg[d];
  }
  for (int d = blockIdx.z; d < DH; d += gridDim.z)
    for (int c = threadIdx.x; c < HD; c += THREADS)
      if (c / DH != h) rows[(size_t)d * HD + c] = 0.f;
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

// ------------------------------------------------ tensor-core route (bf16)

constexpr int WARPS = THREADS / 32;

__host__ __device__ constexpr int ldr(int HD) { return HD + 8; }   // bf16 a staged row

// The bf16 ctx kernel's shape: A blocks nb = heads x (DH / 32)^2, ab of
// them a thread block (grid.z = groups = ceil(nb / ab)), tg token groups
// of warps.
struct CtxShape {
  int nbh, nb, ab, groups, tg;
};

__host__ __device__ inline CtxShape ctx_shape(int HD, int DH) {
  CtxShape c;
  c.nbh = DH / SB;
  c.nb = (HD / DH) * c.nbh * c.nbh;
  c.ab = c.nb < WARPS ? c.nb : WARPS;
  c.groups = (c.nb + c.ab - 1) / c.ab;
  c.tg = 1;
  while (2 * c.tg * c.ab <= WARPS) c.tg *= 2;
  return c;
}

// Shared memory of lin_ctx_mma, in bytes, at TT tokens a stage: m, s,
// the rescale factors (HD each) and the row groups' column partials (8
// HD), f32; then the ring (two stages x k | v, TT x ldr bf16 each) and
// p's hi and lo (TT x ldr each), which the token groups' sums reuse at
// the end.
__host__ __device__ inline int ctx_mma_smem(int HD, int DH, int TT) {
  const CtxShape c = ctx_shape(HD, DH);
  const int tiles = 6 * TT * ldr(HD) * 2, comb = c.ab * SB * SB * 4;
  return 11 * HD * 4 + (tiles > comb ? tiles : comb);
}

// Copies the rows [r0, r0 + TT) of a (N, HD) bf16 matrix (rows at and
// past r1 zero) into dst (TT x ldr) by 16-byte cp.async, the block's
// threads.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int r1,
                                          int TT, int HD) {
  const int per = HD / 8;
  for (int i = threadIdx.x; i < TT * per; i += THREADS) {
    const int r = i / per, c = i % per;
    const bool ok = r0 + r < r1;
    cp_async16(dst + r * ldr(HD) + 8 * c, ok ? src + (size_t)(r0 + r) * HD + 8 * c : src,
               ok);
  }
}

// bf16 ctx partials, grid (nchunks, B, groups).  Block (chunk, bi, z)
// walks the tokens [chunk tpc TN, min(N, (chunk + 1) tpc TN)) of sample
// bi in TT-token stages, the next one in flight, and forms the
// A blocks z ab .. z ab + ab - 1 (block a: head a / nbh^2, k rows 32 ((a
// / nbh) % nbh) .., v columns 32 (a % nbh) .. of the head); warp w takes
// block w % ab in token group w / ab (warps at and past ab tg idle in the
// products).  It writes what lin_ctx_partial writes: its blocks of A and
// (z == 0) every channel's running max and sum, relative to its own max.
template <int TT>
__global__ void __launch_bounds__(THREADS, 2)
lin_ctx_mma(const bf16* __restrict__ k, const bf16* __restrict__ v,
            float* __restrict__ part_m, float* __restrict__ part_s,
            float* __restrict__ part_a, int N, int HD, int DH, int tpc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CtxShape cs = ctx_shape(HD, DH);
  const int LDR = ldr(HD);
  float* mrun = reinterpret_cast<float*>(smem_raw);   // HD
  float* srun = mrun + HD;                              // HD
  float* alpha = srun + HD;                             // HD
  float* red = alpha + HD;                              // 8 x HD
  bf16* ring = reinterpret_cast<bf16*>(red + 8 * HD);   // 2 x (k, v) x TT x LDR
  bf16* phi = ring + 4 * TT * LDR;                      // TT x LDR
  bf16* plo = phi + TT * LDR;                           // TT x LDR
  float* scr = reinterpret_cast<float*>(ring);          // ab x 32 x 32, at the end

  const int chunk = blockIdx.x, bi = blockIdx.y, nchunks = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3, j8 = lane >> 3, r8 = lane & 7;
  const int a_loc = warp % cs.ab, tgi = warp / cs.ab;
  const int a_glob = blockIdx.z * cs.ab + a_loc;
  const bool active = tgi < cs.tg && a_glob < cs.nb;
  const int h = a_glob / (cs.nbh * cs.nbh), rb = (a_glob / cs.nbh) % cs.nbh,
            cb = a_glob % cs.nbh;
  const int kc0 = h * DH + rb * SB, vc0 = h * DH + cb * SB;
  const int t0 = chunk * tpc * TN, t1 = min(N, (chunk + 1) * tpc * TN);
  const int nst = (t1 - t0 + TT - 1) / TT;
  const bf16* kb = k + (size_t)bi * N * HD;
  const bf16* vb = v + (size_t)bi * N * HD;

  for (int c = threadIdx.x; c < HD; c += THREADS) {
    mrun[c] = -INFINITY;
    srun[c] = 0.f;
  }
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // stage u into its half of the ring
  auto stage = [&](int u) {
    bf16* dst = ring + (u & 1) * 2 * TT * LDR;
    load_rows(dst, kb, t0 + u * TT, t1, TT, HD);
    load_rows(dst + TT * LDR, vb, t0 + u * TT, t1, TT, HD);
    cp_async_commit();
  };
  stage(0);
  const int pairs = HD / 2, rg = warp;
  for (int u = 0; u < nst; ++u) {
    const int n0 = t0 + u * TT, rows = min(TT, t1 - n0);
    const bf16* ks = ring + (u & 1) * 2 * TT * LDR;
    const bf16* vs = ks + TT * LDR;
    cp_async_wait_all();
    __syncthreads();   // stage u landed; stage u - 1's products are done
    if (u + 1 < nst) stage(u + 1);
    // each channel's max over the stage: each row group's (warp rg takes
    // rows rg, rg + 8, ...), then the groups' in order
    for (int pc = lane; pc < pairs; pc += 32) {
      // the max of bf16 values is one of them: taken on bf16 pairs
      __nv_bfloat162 mx = __float2bfloat162_rn(-INFINITY);
#pragma unroll
      for (int r = rg; r < TT; r += WARPS)
        if (r < rows)
          mx = __hmax2(mx, *reinterpret_cast<const __nv_bfloat162*>(ks + r * LDR + 2 * pc));
      *reinterpret_cast<float2*>(red + rg * HD + 2 * pc) = __bfloat1622float2(mx);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < HD; c += THREADS) {
      float mt = red[c];
#pragma unroll
      for (int g = 1; g < WARPS; ++g) mt = fmaxf(mt, red[g * HD + c]);
      const float mnew = fmaxf(mrun[c], mt);
      alpha[c] = __expf(mrun[c] - mnew);   // 0 on the first stage
      mrun[c] = mnew;
    }
    __syncthreads();
    // p = exp(k - m) as a bf16 pair (0 at rows past the chunk), and the
    // row group's partial of s in f32
    for (int pc = lane; pc < pairs; pc += 32) {
      const float2 m = *reinterpret_cast<const float2*>(mrun + 2 * pc);
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = rg; r < TT; r += WARPS) {
        float2 p = make_float2(0.f, 0.f);
        if (r < rows) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ks + r * LDR + 2 * pc));
          p = make_float2(__expf(f.x - m.x), __expf(f.y - m.y));
        }
        sum.x += p.x;
        sum.y += p.y;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p.x, p.y);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(phi + r * LDR + 2 * pc) = hi;
        *reinterpret_cast<__nv_bfloat162*>(plo + r * LDR + 2 * pc) =
            __floats2bfloat162_rn(p.x - hf.x, p.y - hf.y);
      }
      *reinterpret_cast<float2*>(red + rg * HD + 2 * pc) = sum;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < HD; c += THREADS) {
      float ps = red[c];
#pragma unroll
      for (int g = 1; g < WARPS; ++g) ps += red[g * HD + c];
      srun[c] = srun[c] * alpha[c] + ps;
    }
    if (active) {
      // A's rows (k channels) rescaled by the stage's factors, then A +=
      // hi^T v + lo^T v over the token group's 16-token steps
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float a0 = alpha[kc0 + 16 * i + grp], a1 = alpha[kc0 + 16 * i + grp + 8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j][0] *= a0;
          acc[i][j][1] *= a0;
          acc[i][j][2] *= a1;
          acc[i][j][3] *= a1;
        }
      }
      for (int st = tgi; st < TT / 16; st += cs.tg) {
        const int r0 = 16 * st;
        unsigned ah[2][4], al[2][4], bq[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int off = (r0 + (j8 >> 1) * 8 + r8) * LDR + kc0 + 16 * i + (j8 & 1) * 8;
          ldmatrix_x4_trans(ah[i], phi + off);
          ldmatrix_x4_trans(al[i], plo + off);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
          ldmatrix_x4_trans(bq[n], vs + (r0 + (j8 & 1) * 8 + r8) * LDR + vc0 + 16 * n +
                                       (j8 >> 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc[i][2 * n], ah[i], bq[n][0], bq[n][1]);
            mma_bf16(acc[i][2 * n + 1], ah[i], bq[n][2], bq[n][3]);
            mma_bf16(acc[i][2 * n], al[i], bq[n][0], bq[n][1]);
            mma_bf16(acc[i][2 * n + 1], al[i], bq[n][2], bq[n][3]);
          }
      }
    }
  }
  // the token groups' sums, added in group order through scr
  for (int g = 1; g < cs.tg; ++g) {
    __syncthreads();
    if (active && tgi == g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            scr[(a_loc * 32 + (i * 16 + j * 4 + q)) * 32 + lane] = acc[i][j][q];
    __syncthreads();
    if (active && tgi == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[i][j][q] += scr[(a_loc * 32 + (i * 16 + j * 4 + q)) * 32 + lane];
  }
  const size_t slot = (size_t)bi * nchunks + chunk;
  if (active && tgi == 0) {
    // part_a (B, nchunks, heads, DH, DH)
    float* pa = part_a + (slot * (HD / DH) + h) * DH * DH + (size_t)rb * SB * DH + cb * SB;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(pa + (16 * i + grp + 8 * hh) * DH + 8 * j + 2 * tig) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
  }
  if (blockIdx.z == 0)   // by the threads that last wrote them
    for (int c = threadIdx.x; c < HD; c += THREADS) {
      part_m[slot * HD + c] = mrun[c];
      part_s[slot * HD + c] = srun[c];
    }
}

// Shared memory of lin_out_mma, in bytes, at TM tokens a tile: the heads'
// ctx blocks (HD x (DH + 8) bf16), two q stages and the out stage (TM x
// ldr bf16 each).
__host__ __device__ inline int out_mma_smem(int HD, int DH, int TM) {
  return (HD * (DH + 8) + 3 * TM * ldr(HD)) * 2;
}

// bf16 out, grid (G, B): block (g, bi) takes the TM-token tiles [g tpb,
// min(ntiles, (g + 1) tpb)) of sample bi.  Warp w forms the units (m16
// row tile, 32-column chunk) w, w + 8, ... of a tile: out[n, e] = sum_d
// q[n, d] bf16(ctx)[d, e] over the head of e.
__global__ void __launch_bounds__(THREADS)
lin_out_mma(const bf16* __restrict__ q, const float* __restrict__ ctx,
            bf16* __restrict__ out, int N, int HD, int DH, int TM, int tpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDR = ldr(HD), LDC = DH + 8;
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);   // HD x LDC: head h's rows h DH ..
  bf16* qs = cs + HD * LDC;                         // 2 x TM x LDR
  bf16* os = qs + 2 * TM * LDR;                     // TM x LDR
  const int bi = blockIdx.y, ntiles = (N + TM - 1) / TM;
  const int tb0 = blockIdx.x * tpb, tb1 = min(ntiles, tb0 + tpb);
  if (tb0 >= tb1) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane >> 2, tig = lane & 3, j8 = lane >> 3, r8 = lane & 7;
  const bf16* qb = q + (size_t)bi * N * HD;
  bf16* ob = out + (size_t)bi * N * HD;

  load_rows(qs, qb, tb0 * TM, N, TM, HD);
  cp_async_commit();
  // the heads' diagonal blocks of ctx, rounded to bf16
  const float* cb = ctx + (size_t)bi * HD * HD;
  for (int i = threadIdx.x; i < HD * DH; i += THREADS) {
    const int r = i / DH, e = i % DH;
    cs[r * LDC + e] = __float2bfloat16(cb[(size_t)r * HD + (r / DH) * DH + e]);
  }
  const int mt = TM / 16, units = mt * (HD / SB);
  for (int t = tb0; t < tb1; ++t) {
    const int n0 = t * TM, rows = min(TM, N - n0);
    const bf16* qt = qs + ((t - tb0) & 1) * TM * LDR;
    cp_async_wait_all();
    __syncthreads();   // tile t landed; the previous tile's stores are done
    if (t + 1 < tb1) {
      load_rows(qs + ((t + 1 - tb0) & 1) * TM * LDR, qb, n0 + TM, N, TM, HD);
      cp_async_commit();
    }
    for (int un = warp; un < units; un += WARPS) {
      const int mi = un % mt, cc = un / mt;
      const int h = cc * SB / DH, e0 = cc * SB;   // e0: the unit's first column
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) acc[j][qq] = 0.f;
      for (int kk = 0; kk < DH; kk += 16) {
        unsigned a[4], bq[2][4];
        ldmatrix_x4(a, qt + (16 * mi + (j8 & 1) * 8 + r8) * LDR + h * DH + kk + (j8 >> 1) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          ldmatrix_x4_trans(bq[n], cs + (h * DH + kk + (j8 & 1) * 8 + r8) * LDC +
                                       (e0 - h * DH) + 16 * n + (j8 >> 1) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_bf16(acc[2 * n], a, bq[n][0], bq[n][1]);
          mma_bf16(acc[2 * n + 1], a, bq[n][2], bq[n][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<__nv_bfloat162*>(os + (16 * mi + grp + 8 * hh) * LDR + e0 +
                                             8 * j + 2 * tig) =
              __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
    __syncthreads();   // the tile's out is staged: to device memory as 16-byte rows
    const int per = HD / 8;
    for (int i = threadIdx.x; i < rows * per; i += THREADS) {
      const int r = i / per, c = i % per;
      *reinterpret_cast<uint4*>(ob + (size_t)(n0 + r) * HD + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * LDR + 8 * c);
    }
  }
  cp_async_wait_all();
}

// What a launch of a kernel asks of the driver, once per card: the
// dynamic shared memory it may take and the blocks of it an SM holds (at
// the small sites these calls would cost more host time than the kernels
// take on the card).
constexpr int MAX_CARDS = 64;
struct LaunchCache {
  int smem[MAX_CARDS] = {};       // the largest size allowed so far
  int per_sm_smem[MAX_CARDS] = {};
  int per_sm[MAX_CARDS] = {};     // blocks an SM holds at per_sm_smem bytes
  int sms[MAX_CARDS] = {};
};

// cudaFuncSetAttribute(kernel, max dynamic smem, bytes) unless the card
// already allows at least that much
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, LaunchCache& c, int dev) {
  if (dev < MAX_CARDS && c.smem[dev] >= bytes) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_CARDS) c.smem[dev] = bytes;
  return err;
}

// blocks of kernel (THREADS threads, smem bytes) on the whole card at once
template <typename K>
cudaError_t slots(K kernel, int smem, LaunchCache& c, int dev, int* out) {
  if (dev < MAX_CARDS && c.per_sm_smem[dev] == smem && c.sms[dev] > 0) {
    *out = c.per_sm[dev] * c.sms[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                                  smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_CARDS) {
    c.per_sm_smem[dev] = smem;
    c.per_sm[dev] = per_sm;
    c.sms[dev] = sms;
  }
  *out = per_sm * sms;
  return cudaSuccess;
}

LaunchCache ctx_cache[3], reduce_cache, out_cache;   // ctx: 64, 32, 16 tokens

// the most tokens a stage (from most, halved down to 16) for which
// smem(tokens) fits a block, or 0
template <typename F>
int fit_tokens(int most, F smem) {
  for (int tt = most; tt >= 16; tt /= 2)
    if (smem(tt) <= 227 * 1024) return tt;
  return 0;
}

int ctx_launch_mma(const bf16* k, const bf16* v, float* part_m, float* part_s,
                   float* part_a, float* ctx, int B, int N, int HD, int DH, int nchunks,
                   int tpc, cudaStream_t stream) {
  // 64-token stages unless shared memory takes fewer
  const int tt = fit_tokens(TN, [&](int t) { return ctx_mma_smem(HD, DH, t); });
  if (tt == 0) return (int)cudaErrorInvalidValue;
  const int smem = ctx_mma_smem(HD, DH, tt);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nchunks, B, ctx_shape(HD, DH).groups);
  auto launch = [&](auto kernel, LaunchCache& cache) {
    cudaError_t e = allow_smem(kernel, smem, cache, dev);
    if (e == cudaSuccess)
      kernel<<<grid, THREADS, smem, stream>>>(k, v, part_m, part_s, part_a, N, HD, DH, tpc);
    return e;
  };
  err = tt == 64 ? launch(lin_ctx_mma<64>, ctx_cache[0])
                 : tt == 32 ? launch(lin_ctx_mma<32>, ctx_cache[1])
                            : launch(lin_ctx_mma<16>, ctx_cache[2]);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rsmem = 2 * DH * (int)sizeof(float);
  err = allow_smem(lin_ctx_reduce, rsmem, reduce_cache, dev);
  if (err != cudaSuccess) return (int)err;
  lin_ctx_reduce<<<dim3(B, HD / DH, (DH * DH + THREADS - 1) / THREADS), THREADS, rsmem,
                   stream>>>(part_m, part_s, part_a, ctx, HD, DH, nchunks);
  return (int)cudaGetLastError();
}

// grid (G, B): as many blocks as fit on the card at once, shared out
// over the samples, each a run of tiles
int out_launch_mma(const bf16* q, const float* ctx, bf16* out, int B, int N, int HD,
                   int DH, cudaStream_t stream) {
  const int tm = fit_tokens(TN, [&](int t) { return out_mma_smem(HD, DH, t); });
  if (tm == 0) return (int)cudaErrorInvalidValue;
  const int smem = out_mma_smem(HD, DH, tm);
  int dev = 0, card = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_smem(lin_out_mma, smem, out_cache, dev);
  if (err == cudaSuccess) err = slots(lin_out_mma, smem, out_cache, dev, &card);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (N + tm - 1) / tm;
  const int want = min(ntiles, max(1, card / B));
  const int tpb = (ntiles + want - 1) / want;
  lin_out_mma<<<dim3((ntiles + tpb - 1) / tpb, B), THREADS, smem, stream>>>(
      q, ctx, out, N, HD, DH, tm, tpb);
  return (int)cudaGetLastError();
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
  lin_ctx_reduce<<<dim3(B, HD / DH, (DH * DH + THREADS - 1) / THREADS), THREADS, smem,
                   stream>>>((const float*)part_m, (const float*)part_s,
                             (const float*)part_a, (float*)ctx, HD, DH, nchunks);
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
    return ctx_launch_mma((const bf16*)k, (const bf16*)v, (float*)part_m,
                          (float*)part_s, (float*)part_a, (float*)ctx, B, N, HD, DH,
                          nchunks, tiles_per_chunk, (cudaStream_t)stream);
  return ctx_launch<float>(k, v, part_m, part_s, part_a, ctx, B, N, HD, DH, nchunks,
                           tiles_per_chunk, (cudaStream_t)stream);
}

// q, out (B, N, HD) of dtype; ctx (B, HD, HD) f32; HD = heads x DH.
int lin_out(const void* q, const void* ctx, void* out, int B, int N, int HD, int DH,
            int dtype, void* stream) {
  if (!widths_ok(HD, DH)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return out_launch_mma((const bf16*)q, (const float*)ctx, (bf16*)out, B, N, HD, DH,
                          (cudaStream_t)stream);
  return out_launch<float>(q, ctx, out, B, N, HD, DH, (cudaStream_t)stream);
}

}  // extern "C"
