// The ConvResBlock's width-general route for Hopper (sm_90a): its forward
// (entry convres_fwd_general, K2 at every width but the tuned ones) and
// its backward (entry convres_bwd_general, K3 likewise), both dtypes.
//
// Replaces the TPU kernels dddpm_tpu/ops/pallas/convres.py:_fwd_kernel
// (:250) and _bwd_kernel (:409), each the whole block in one kernel over
// row tiles of a lane-packed layout, its intermediates kept in VMEM, at
// the widths where the tuned kernels (convres_fwd.cu, convres_bwd.cu: CM
// = 32 mid channels, CIO in {32, 64, 128}) do not apply: the JAX gate
// admits any CM and CIO that are multiples of 32
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
// bf16 ~700 FLOP a byte, above the ridge, so the products bound the
// block.  As a chain of launches it also moves its intermediates through
// device memory (m1..m3 forward; m1..m3, g3..g1 and mish'(p1..p3) in f32
// backward), which at d_chans 128 puts a roofline of ~0.25-0.35 ms under
// the x2 decode, near its 0.24 ms operations bound.
//
// What this design does about it: the block is a chain of implicit
// GEMMs, one launch per conv, each intermediate a whole tensor in device
// memory; a tile's 3x3 halo comes from there (L2), so no tile has to
// hold a halo of 2 (forward) or 4 (backward) pixels and the CM x CM
// weights in shared memory, which is what fixes the tuned kernels to CM
// 32.  Every width is a runtime argument, in 32-channel steps.  bf16
// runs its products on the tensor cores (mma.sync.m16n8k16, bf16
// operands, f32 sums), its operands kept in bf16 in shared memory and
// filled by a cp.async ring, so that the copies of later slabs are in
// flight while a slab's products run; rows are padded (48, 80 and 144
// bytes), so that no ldmatrix meets a bank conflict.  What the chain
// moves from L2 into the SMs decides its speed, so each kernel is shaped
// to move little:
//   conv1x1_mma  a 1x1 conv, out[P, n] = epilogue(sum_k A(P)[k] B[k][n]):
//               a TM-pixel x TN-channel output tile a block of 4 warps,
//               each 64 pixels x 32 channels of it; K walked in slabs of
//               32 channels through a STAGES-deep ring.  A's slab rows are
//               pixel rows, zero past P; B is w ([k][n], read by
//               ldmatrix.trans) or, for the data gradients, w as [n][k]
//               (ldmatrix), zero past N.  The prologue (m0 =
//               round(mish(x)), the first 1x1 only) runs on A's slab in
//               shared memory once it lands, each thread on the pieces it
//               copied, so every element once a block.
//   conv3x3_mma  a 3x3 conv: a TH x TW tile of output pixels a block of
//               4 warps, each 4 tile rows x TN channels of it;
//               each stage of CK channels brings the tile's input with
//               its 1-pixel halo (zero outside the image: the SAME
//               padding) and the 9 taps' weights (w[t], or w[8 - t] as
//               [n][k] for the data gradients), and every tap reads the
//               one halo: tap (dy, dx)'s A fragment of 16 output pixels
//               is the halo shifted by (dy, dx), a constant offset from
//               the lane's row.  A slab read once a tap from L2 would
//               move ~9 / 1.3 times the halo's bytes, and the tile's 256
//               pixels share each stage's weights.
//   Both stage the tile's f32 sums over their ring after the products,
//   and the epilogue goes out in 16-byte pieces of 8 channels, each
//   group of pieces loading what it reads (x; x and dy; or mish') before
//   it stores: + b, mish, round (and mish' kept), or + b (+ x) with the
//   scaling, or x mish'(p), or x mish'(x) + dy.  For 'down' the last
//   conv walks the pixels quad by quad, so that a quad is 4 rows of the
//   staged tile, its rounded o summed in f32 in row order.
//   wgrad1x1_mma  a 1x1 conv's weight gradients, dW[k][n] = sum_P
//               A(P)[k] g(P)[n]: a WM-row x TN-column tile a block of 4
//               warps (32 x 32 each), K = the pixels in slabs of 32
//               through a STAGES-deep ring, both operands pixel-major in
//               their slabs and read by ldmatrix.trans; `pro` (mish of x,
//               for dw1) runs on the landed slab.
//   wgrad3x3_mma  a 3x3 conv's, dW[t K + k][n] = sum_P A(P + off_t)[k]
//               g(P)[n]: a block takes KT input channels x TN columns for
//               all 9 taps, K = g's pixels a TH x TW tile a stage, whose
//               halo of A (as conv3x3_mma's) all 9 taps read; a tile row's
//               16 pixels an mma.  A stage moves ~1 / 5 of the bytes of
//               slabs of A read once a tap.
//   Both take the bias gradient, the sum of g, by one more mma of g's
//   fragments against ones, in the first row tile's (or channel
//   slice's) blocks.
// f32 keeps the first design, its products FMA on the CUDA cores from
// operands widened in shared memory (conv_gemm and conv_wgrad: 64 x 64
// tiles of 256 threads, 4 x 4 sums a thread, the bias a row of ones).
// For both dtypes, the weight gradients' pixels (for a bf16 3x3, its
// pixel tiles) are split into S chunks (S fixed from the shapes: enough
// blocks for the card, at most 64): each
// block writes its chunk's f32 partial, and convres_reduce sums the S
// partials in chunk order.  Deterministic: no atomics, and the
// partials' room is S x (taps K + 1) x N floats, bounded by S.
// The batch runs in chunks of samples of at most 2^19 pixels (or one
// sample), so that the intermediates take 2 x 2^19 x CM elements
// (forward), or 6 x 2^19 x CM and as many floats again in f32 (backward),
// whatever B is; the backward sums
// each chunk's weight gradients onto the last chunk's, in chunk order.
// There is no width ceiling: a block's shared memory is the same at any
// width (bf16 60 KB a 1x1, 84 KB a 3x3, 36 KB a 1x1 wgrad, 102 KB a 3x3
// wgrad; f32 17 KB).
// Not done: wgmma with TMA boxes (the next step, as Q1 took it), or
// warp specialisation, so that a block's loads, products and epilogue
// overlap; the intermediates kept on chip (m3 and the last 1x1 in one
// kernel); the f32 route on the tensor cores.
//
// Measured (H100 80GB HBM3, 700 W; probes/convres_general_ablation.py at
// cm 64, cio 128): a B = 8, 256^2 forward takes 0.66 ms, and in each conv
// the loads, the products and the epilogue mostly run in turn, the
// co-resident blocks in step: a 3x3 takes 180 us, its loads alone 68,
// its products and epilogue without the loads 133, the epilogue alone 54
// (the products ~80 us, ~490 TFLOP/s).  Blocks that each walk several
// tiles with separate sums (persistent), and a 3-stage ring, measured no
// faster: the first for its lower occupancy.
//
// GENERAL_SKIP (a -D define, 0 by default) compiles parts of the bf16
// kernels out, by bit: 1 the products (mma), 2 the epilogue, 4 the
// global loads into the ring.  Only the ablation probe
// (probes/convres_general_ablation.py) sets it; its kernels compute
// garbage.
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
#include "mma_sm90.cuh"    // cp_async16, ldmatrix_x4(_trans), mma_bf16

#ifndef GENERAL_SKIP
#define GENERAL_SKIP 0
#endif

namespace {

typedef __nv_bfloat16 bf16;
constexpr int SKIP = GENERAL_SKIP;

// f32: the FMA kernels
constexpr int BM = 64;        // output pixels (conv) or rows (wgrad) a block
constexpr int BN = 64;        // output channels a block
constexpr int BK = 32;        // K a slab: one tap x 32 channels, or 32 pixels
constexpr int PAD = 4;        // floats past a staged row (16-byte aligned rows)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 sums each
constexpr int WGRAD_BLOCKS = 512;   // the wgrad's blocks it aims at (fixed: same S on any card)
constexpr int MAX_CHUNKS = 64;
constexpr long long CHUNK_PIXELS = 1 << 19;   // pixels of a batch chunk

// bf16: the tensor-core kernels
constexpr int TM = 128;          // conv1x1_mma: output pixels a block
constexpr int TN = 64;           // output channels (conv) or columns (wgrad) a block
constexpr int WM = 64;           // wgrad1x1_mma: rows a block (BM: the same S)
constexpr int TK = BK;           // a slab: one tap x 32 channels, or 32 pixels
constexpr int TTHREADS = 128;    // 4 warps, 2 x 2
constexpr int STAGES = 4;        // slabs in the cp.async ring
constexpr int AS = TK + 8;       // bf16 a row of a [pixel][k] or [n][k] slab (80 bytes)
constexpr int WS = TN + 8;       // bf16 a row of a [k][n] or [pixel][row] slab (144 bytes)
constexpr int CS = TN + 8;       // floats a row of a tile's staged sums (288 bytes)
// conv1x1_mma: STAGES slabs of A and B, then the staged sums over them
constexpr int A_SLAB = TM * AS;  // A's slab, [pixel][k]
constexpr int B_SLAB = TK * WS;  // B's, [k][n]
constexpr int CONV1_SMEM = STAGES * (A_SLAB + B_SLAB) * 2;      // bytes: 3 blocks an SM
// conv3x3_mma: a TH x TW tile of output pixels; a stage holds its halo
// and the 9 taps' weights for CK channels, in rows padded (48 and 144
// bytes) so that no ldmatrix meets a bank conflict; then the tile's
// staged sums over them (the larger of the two)
constexpr int TH = 16, TW = 16;  // one m16 tile a tile row
constexpr int TM3 = TH * TW;     // output pixels a tile (256)
constexpr int HC = TW + 2, HP = (TH + 2) * HC;   // halo columns, pixels (324)
constexpr int CK = 16;           // channels a stage: one mma k step a tap
constexpr int HS = CK + 8;       // bf16 a halo pixel (48 bytes)
constexpr int STAGES3 = 2;
constexpr int WT = CK * WS;      // bf16 a tap's weights, [k][n]
constexpr int H_SLAB = HP * HS, W_SLAB = 9 * WT;
constexpr int CONV3_SMEM = TM3 * CS * 4 > STAGES3 * (H_SLAB + W_SLAB) * 2
                               ? TM3 * CS * 4 : STAGES3 * (H_SLAB + W_SLAB) * 2;   // bytes
// wgrad3x3_mma: the same halo (KT channels) and g's TH x TW tile a stage
constexpr int KT = CK;           // input channels (rows of each tap's dW) a block
constexpr int G_SLAB = TM3 * WS; // g's tile, [pixel][n]
constexpr int WG3_SMEM = STAGES3 * (H_SLAB + G_SLAB) * 2;     // bytes: 2 blocks an SM
static_assert(WM == BM && TK == BK, "the wgrad's S and chunks are the f32 route's");
static_assert(TH == 4 * (TTHREADS / 32) && CK * 8 == TTHREADS && TN * 2 == TTHREADS, "tiles");
static_assert(TM * CS * 4 <= CONV1_SMEM && TM3 * CS * 4 <= CONV3_SMEM, "sums over the ring");
static_assert(3 * (CONV1_SMEM + 1024) <= 228 * 1024 && 2 * (CONV3_SMEM + 1024) <= 228 * 1024 &&
                  2 * (WG3_SMEM + 1024) <= 228 * 1024,
              "shared memory");
static_assert(TM3 * TN % (8 * TTHREADS) == 0 && TN == 16 * (TTHREADS / 32), "wgrad3x3 tiles");

enum { EPI_MID = 0, EPI_OUT = 1, EPI_GRAD = 2, EPI_DX = 3 };

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }

// 8 consecutive values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 4 consecutive values (16 bytes, aligned) as floats, and back
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// bf16 pairs: two floats rounded into one (the first in the low half),
// and back
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack8(const float v[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}
__device__ __forceinline__ void unpack8(const uint4 u, float v[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const float4 a, const float4 b, float v[8]) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// round(mish) of the 8 bf16 values of a 16-byte piece of shared memory,
// in place
__device__ __forceinline__ void mish8(bf16* p) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack2(mish(__uint_as_float(w[i] << 16)), mish(__uint_as_float(w[i] & 0xffff0000u)));
  *reinterpret_cast<uint4*>(p) = u;
}

// waits until at most N of this thread's newest cp.async groups are in
// flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a bf16 pair of 1.0: an mma A fragment of them times g's fragment sums
// g over the k16 step's pixels
constexpr unsigned ONE2 = 0x3f803f80u;

// two partial sums into part (added to what it holds with accum)
__device__ __forceinline__ void put2(float* p, float v0, float v1, int accum) {
  float2* d = reinterpret_cast<float2*>(p);
  if (accum) {
    const float2 o = *d;
    v0 += o.x;
    v1 += o.y;
  }
  *d = make_float2(v0, v1);
}

// pixel p's sample, row and column: p in row-major order, or with `quad`
// in the quad-by-quad order (p = 4 q + d, d the row-major place in 2x2
// quad q)
__device__ __forceinline__ void pixel_at(long long p, int quad, int H, int W, int& pb,
                                         int& pr, int& pc) {
  if (quad) {
    const long long q = p >> 2;
    const int d = (int)(p & 3), Ho = H / 2, Wo = W / 2;
    pb = (int)(q / ((long long)Ho * Wo));
    pr = 2 * (int)((q / Wo) % Ho) + (d >> 1);
    pc = 2 * (int)(q % Wo) + (d & 1);
  } else {
    pb = (int)(p / ((long long)H * W));
    pr = (int)((p / W) % H);
    pc = (int)(p % W);
  }
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

// conv_gemm on the CUDA cores (FMA), for f32: a BM x BN tile a block, the
// slabs widened to f32 in shared memory
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

// The weight and bias gradients of one conv on the CUDA cores (FMA), for
// f32, for pixels [c0, c1) of chunk blockIdx.z:  part[z][r][n] = sum_P A_r(P) g(P)[n], rows r = t K
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

// A warp's sums (m16 tiles mi, n8 tiles ni of mma_bf16's accumulator
// layout) into a tile staged in shared memory, Cs ([row][CS] floats):
// rows r0w + 16 mi + g (+ 8), columns c0w + 8 ni + 2 q4 (+ 1)
template <int NI>
__device__ __forceinline__ void stage_sums(float* Cs, const float (&acc)[4][NI][4], int r0w,
                                           int c0w, int lane) {
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Cs + (r0w + 16 * mi + g + 8 * h) * CS + c0w + 8 * ni + 2 * q4) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

// A tile's epilogue from its staged sums Cs (TMR rows), in 16-byte
// pieces: channels n .. n + 7 (n = n0 + 8 (tid % 8)) of tile rows tid / 8
// + ROWS j, with bias, then EPI_MID, EPI_OUT (no scaling
// or 'up'), EPI_GRAD or EPI_DX; pix(i) is tile row i's pixel (its place
// in `in`, -1 where it has none).  Each group of GROUP pieces loads what
// it reads (x; x and dy; or mish', into ld) before it stores, so that
// its loads are in flight together.
constexpr int ROWS = TTHREADS / 8;   // tile rows a pass of the block
template <int TMR, typename Pix>
__device__ __forceinline__ void epilogue(const ConvArgs<bf16>& a, const float* Cs, int n0,
                                         Pix pix) {
  constexpr int GROUP = 4;
  const int tid = threadIdx.x, c8 = (tid & 7) * 8, n = n0 + c8, N = a.N;
  if (n >= N) return;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = a.bias ? a.bias[n + j] : 0.f;
#pragma unroll
  for (int j0 = 0; j0 < TMR / ROWS; j0 += GROUP) {
    long long pk[GROUP];
    uint4 ld[GROUP][2];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      pk[k] = pix(tid / 8 + ROWS * (j0 + k));
      const long long e = pk[k] * N + n;
      ld[k][0] = ld[k][1] = make_uint4(0u, 0u, 0u, 0u);
      if (pk[k] < 0) continue;
      if (a.epi == EPI_GRAD) {
        ld[k][0] = *reinterpret_cast<const uint4*>(a.dmul + e);
        ld[k][1] = *reinterpret_cast<const uint4*>(a.dmul + e + 4);
      } else {
        if (a.epi == EPI_DX) ld[k][1] = *reinterpret_cast<const uint4*>(a.xin + e);
        if (a.add) ld[k][0] = *reinterpret_cast<const uint4*>(a.add + e);
      }
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      if (pk[k] < 0) continue;
      const long long e = pk[k] * N + n;
      const float* cs = Cs + (tid / 8 + ROWS * (j0 + k)) * CS + c8;
      float v[8];
      unpack8(*reinterpret_cast<const float4*>(cs), *reinterpret_cast<const float4*>(cs + 4), v);
      if (a.epi == EPI_MID && a.aux) {
        float d[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) mish_dmish(v[j] + bias[j], v[j], d[j]);
        *reinterpret_cast<uint4*>(a.out + e) = pack8(v);
        *reinterpret_cast<float4*>(a.aux + e) = make_float4(d[0], d[1], d[2], d[3]);
        *reinterpret_cast<float4*>(a.aux + e + 4) = make_float4(d[4], d[5], d[6], d[7]);
      } else if (a.epi == EPI_MID) {   // mish alone: the same bits as mish_dmish's
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = mish(v[j] + bias[j]);
        *reinterpret_cast<uint4*>(a.out + e) = pack8(v);
      } else if (a.epi == EPI_OUT) {
        float r[8];
        unpack8(ld[k][0], r);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = v[j] + bias[j] + r[j];
        const uint4 o = pack8(v);
        if (a.scale == 1) {   // 'up': the pixel's 2 x 2 of out
          int pb, pr, pc;
          pixel_at(pk[k], 0, a.H, a.W, pb, pr, pc);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const long long q =
                ((long long)pb * 2 * a.H + 2 * pr + u / 2) * 2 * a.W + 2 * pc + u % 2;
            *reinterpret_cast<uint4*>(a.out + q * N + n) = o;
          }
        } else {
          *reinterpret_cast<uint4*>(a.out + e) = o;
        }
      } else if (a.epi == EPI_GRAD) {
        const uint4 d0 = ld[k][0], d1 = ld[k][1];
        const float d[8] = {__uint_as_float(d0.x), __uint_as_float(d0.y), __uint_as_float(d0.z),
                            __uint_as_float(d0.w), __uint_as_float(d1.x), __uint_as_float(d1.y),
                            __uint_as_float(d1.z), __uint_as_float(d1.w)};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= d[j];
        *reinterpret_cast<uint4*>(a.out + e) = pack8(v);
      } else {   // EPI_DX
        float x[8], r[8];
        unpack8(ld[k][1], x);
        unpack8(ld[k][0], r);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float m, d;
          mish_dmish(x[j], m, d);
          v[j] = v[j] * d + r[j];
        }
        *reinterpret_cast<uint4*>(a.out + e) = pack8(v);
      }
    }
  }
}

// EPI_OUT with 'down' from the staged sums: tile rows 4 q .. 4 q + 3 are
// quad m0 / 4 + q (the pixels come quad by quad); pieces of 8 channels
// of a quad, the quad's 4 rounded values summed in f32 in row order
__device__ __forceinline__ void epilogue_down(const ConvArgs<bf16>& a, const float* Cs,
                                              long long m0, int n0, long long P) {
  const int tid = threadIdx.x, c8 = (tid & 7) * 8, n = n0 + c8, N = a.N;
  if (n >= N) return;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = a.bias ? a.bias[n + j] : 0.f;
#pragma unroll
  for (int j0 = 0; j0 < TM / 4 / ROWS; ++j0) {
    const int q = tid / 8 + ROWS * j0;
    const long long p = m0 + 4 * q;   // P is a multiple of 4: a quad is whole or absent
    if (p >= P) continue;
    uint4 ad[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      ad[d] = make_uint4(0u, 0u, 0u, 0u);
      if (a.add) {
        int pb, pr, pc;
        pixel_at(p + d, 1, a.H, a.W, pb, pr, pc);
        ad[d] = *reinterpret_cast<const uint4*>(
            a.add + (((long long)pb * a.H + pr) * a.W + pc) * N + n);
      }
    }
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float* cs = Cs + (4 * q + d) * CS + c8;
      float v[8], r[8];
      unpack8(*reinterpret_cast<const float4*>(cs), *reinterpret_cast<const float4*>(cs + 4), v);
      unpack8(ad[d], r);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] += round_bf16(v[j] + bias[j] + r[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] *= 0.25f;
    *reinterpret_cast<uint4*>(a.out + (p >> 2) * N + n) = pack8(s);
  }
}

// A 1x1 conv of the chain on the tensor cores (bf16): the same function,
// epilogues and rounding points as conv_gemm (taps 1).  Grid (P / TM, N
// / TN), TTHREADS threads, CONV1_SMEM bytes of dynamic shared memory:
// STAGES slabs of A ([pixel][k], AS a row) and of B ([k][n], WS a row;
// trans 0 only, see grad_weights), and after the products the staged
// sums.  Warp w takes tile pixels 64 (w & 1) .. + 63 and channels 32 (w
// >> 1) .. + 31: acc[mi][ni] its m16 tile mi and n8 tile ni.
__global__ void __launch_bounds__(TTHREADS, 3)
conv1x1_mma(const ConvArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const As = reinterpret_cast<bf16*>(smem_raw);   // STAGES x A_SLAB
  bf16* const Bs = As + STAGES * A_SLAB;                 // STAGES x B_SLAB
  const int H = a.H, W = a.W, K = a.K, N = a.N;
  const long long P = (long long)a.B * H * W;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;

  // this thread's A pieces: tile pixels tid / 4 + 32 j (j < 4), channels
  // ac .. ac + 7 of a slab; abase their element offset in `in` (-1 past P)
  const int ac = (tid & 3) * 8;
  long long abase[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long p = m0 + (tid >> 2) + 32 * j;
    abase[j] = -1;
    if (p < P) {
      int pb, pr, pc;
      pixel_at(p, a.quad, H, W, pb, pr, pc);
      abase[j] = (((long long)pb * H + pr) * W + pc) * K + ac;
    }
  }
  const int nslabs = K / TK;

  // slab s (channels s TK ..) into ring place s % STAGES
  auto load = [&](int s) {
    const int k0 = s * TK;
    bf16* as = As + (s % STAGES) * A_SLAB + (tid >> 2) * AS + ac;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = abase[j] >= 0;
      cp_async16(as + 32 * j * AS, ok ? a.in + abase[j] + k0 : a.in, ok);
    }
    bf16* bs = Bs + (s % STAGES) * B_SLAB;
#pragma unroll
    for (int j = 0; j < 2; ++j) {   // 32 k rows x 64 n: row i / 8, 8 n at (i % 8) * 8
      const int i = tid + TTHREADS * j, kr = i >> 3, nc = (i & 7) * 8;
      const bool ok = n0 + nc < N;
      cp_async16(bs + kr * WS + nc, ok ? a.w + (size_t)(k0 + kr) * N + n0 + nc : a.w, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  // a warp whose 32 channels lie past N (the last tile's, where N % TN is
  // 32) loads its share and runs no product
  const bool active = n0 + wn * 32 < N;
  // this lane's ldmatrix rows: A, pixel 64 wm + lane % 16 at k 8 (lane /
  // 16); B (ldmatrix.trans), k row lane % 16 at n 8 (lane / 16), as
  // gemm32_nb's (csrc/convres_sm90.cuh): registers 0, 1 the b0, b1 of one
  // n8 tile, 2, 3 of the next
  const int la = (wm * 64 + (lane & 15)) * AS + (lane >> 4) * 8;
  const int lb = (lane & 15) * WS + wn * 32 + (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslabs && !(SKIP & 4)) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslabs; ++s) {
    cp_async_wait<STAGES - 2>();   // slab s has landed (this thread's pieces)
    const int st = s % STAGES;
    if (a.pro) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mish8(As + st * A_SLAB + ((tid >> 2) + 32 * j) * AS + ac);
    }
    __syncthreads();   // slab s is in for every thread; slab s - 1 is read
    if (s + STAGES - 1 < nslabs && !(SKIP & 4)) load(s + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* as = As + st * A_SLAB + la;
    const bf16* bs = Bs + st * B_SLAB + lb;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      unsigned b[2][4];
      ldmatrix_x4_trans(b[0], bs + kk * 16 * WS);
      ldmatrix_x4_trans(b[1], bs + kk * 16 * WS + 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        unsigned af[4];
        ldmatrix_x4(af, as + mi * 16 * AS + kk * 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          if (!(SKIP & 1))
            mma_bf16(acc[mi][ni], af, b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the sums go there
  if (SKIP & 2) return;
  float* const Cs = reinterpret_cast<float*>(smem_raw);
  if (active) stage_sums(Cs, acc, wm * 64, wn * 32, lane);
  __syncthreads();
  if (a.quad)
    epilogue_down(a, Cs, m0, n0, P);
  else
    epilogue<TM>(a, Cs, n0, [&](int i) { return m0 + i < P ? m0 + i : -1LL; });
}

// A 3x3 conv of the chain on the tensor cores (bf16), EPI_MID or
// EPI_GRAD (no prologue, no scaling): a TH x TW tile of output pixels a
// block, whose input with its 1-pixel halo (HP pixels, zero outside the
// image) is staged once a stage of CK channels and read by all 9 taps:
// tap (dy, dx)'s A fragment of 16 output pixels (one tile row) is the
// halo shifted by (dy, dx), a constant offset from the lane's row.
// Grid (B x tile rows x tile columns, N / TN), TTHREADS threads,
// CONV3_SMEM bytes of dynamic shared memory: STAGES3 stages of the halo
// ([pixel][HS]) and of the 9 taps' B (WT each: w[t] as [k][n], WS a
// row; trans 0 only), and after the products the staged sums.  Warp w
// takes tile rows 4 w .. 4 w + 3 (one m16 tile each) and the TN channels
// (8 n8 tiles; 4 where the last 32 lie past N).
__global__ void __launch_bounds__(TTHREADS, 2)
conv3x3_mma(const ConvArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Hs = reinterpret_cast<bf16*>(smem_raw);   // STAGES3 x H_SLAB
  bf16* const Ws = Hs + STAGES3 * H_SLAB;                // STAGES3 x W_SLAB
  const int H = a.H, W = a.W, K = a.K, N = a.N;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int c0 = (int)(blockIdx.x % tiles_w) * TW;
  const int r0 = (int)(blockIdx.x / tiles_w % tiles_h) * TH;
  const int b = (int)(blockIdx.x / tiles_w / tiles_h);
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this thread's halo pieces: halo pixel (tid + TTHREADS j) / 2, 8
  // channels at its parity x 8; hpix the pixel's place in `in`, -1
  // outside the image (and past the halo)
  constexpr int HPIECES = (2 * HP + TTHREADS - 1) / TTHREADS;
  int hpix[HPIECES];
#pragma unroll
  for (int j = 0; j < HPIECES; ++j) {
    const int i = tid + TTHREADS * j, hp = i >> 1;
    const int gr = r0 - 1 + hp / HC, gc = c0 - 1 + hp % HC;
    hpix[j] = i < 2 * HP && gr >= 0 && gr < H && gc >= 0 && gc < W ? (b * H + gr) * W + gc : -1;
  }
  const int nslabs = K / CK;

  // stage s (channels s CK ..) into ring place s % STAGES3: the halo, and
  // each tap's CK x TN weights (thread tid: k row tid / 8, 8 n at (tid %
  // 8) 8)
  auto load = [&](int s) {
    const int k0 = s * CK;
    bf16* hs = Hs + (s % STAGES3) * H_SLAB;
#pragma unroll
    for (int j = 0; j < HPIECES; ++j) {
      const int i = tid + TTHREADS * j;
      const bool ok = hpix[j] >= 0;
      if (i < 2 * HP)
        cp_async16(hs + (i >> 1) * HS + (i & 1) * 8,
                   ok ? a.in + (long long)hpix[j] * K + k0 + (i & 1) * 8 : a.in, ok);
    }
    bf16* ws = Ws + (s % STAGES3) * W_SLAB;
    const int kr = tid >> 3, nc = (tid & 7) * 8;
    const bool ok = n0 + nc < N;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      cp_async16(ws + t * WT + kr * WS + nc,
                 ok ? a.w + ((size_t)t * K + k0 + kr) * N + n0 + nc : a.w, ok);
  };

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const bool half = n0 + TN / 2 >= N;   // the tile's last 32 channels lie past N
  // this lane's ldmatrix rows: A, halo pixel (4 w + mi + dy) HC + lane %
  // 16 + dx at k 8 (lane / 16); B, as in conv1x1_mma (q the 16-channel
  // group)
  const int la = (4 * warp * HC + (lane & 15)) * HS + (lane >> 4) * 8;
  const int lb = (lane & 15) * WS + (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < STAGES3 - 1; ++s) {
    if (s < nslabs && !(SKIP & 4)) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslabs; ++s) {
    cp_async_wait<STAGES3 - 2>();
    __syncthreads();   // stage s is in for every thread; stage s - 1 is read
    if (s + STAGES3 - 1 < nslabs && !(SKIP & 4)) load(s + STAGES3 - 1);
    cp_async_commit();
    const bf16* hs = Hs + (s % STAGES3) * H_SLAB + la;
    const bf16* ws = Ws + (s % STAGES3) * W_SLAB + lb;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
      unsigned bq[4][4];   // n8 tiles 2 q, 2 q + 1
#pragma unroll
      for (int q = 0; q < 4; ++q) ldmatrix_x4_trans(bq[q], ws + t * WT + q * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        unsigned af[4];
        ldmatrix_x4(af, hs + ((mi + dy) * HC + dx) * HS);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          if (!(SKIP & 1) && (ni < 4 || !half))
            mma_bf16(acc[mi][ni], af, bq[ni >> 1][2 * (ni & 1)], bq[ni >> 1][2 * (ni & 1) + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the sums go there
  if (SKIP & 2) return;
  float* const Cs = reinterpret_cast<float*>(smem_raw);
  stage_sums(Cs, acc, warp * 64, 0, lane);
  __syncthreads();
  epilogue<TM3>(a, Cs, n0, [&](int i) {
    const int r = r0 + i / TW, c = c0 + i % TW;
    return r < H && c < W ? ((long long)b * H + r) * W + c : -1LL;
  });
}

// A 1x1 conv's weight gradients on the tensor cores (bf16), for pixels
// [c0, c1) of chunk blockIdx.z: part[z][k][n] = sum_P A(P)[k] g(P)[n]
// (A = in, with `pro` round(mish(in))) for the rows k < K of this
// block's WM-row tile, and in the first row tile's blocks the bias row
// k = K, sum_P g(P)[n]; with `accum`, added to what part holds.
// STAGES slabs of TK pixels of A ([pixel][k]) and of g ([pixel][n]), WS
// a row.  Warp w takes rows 32 (w & 1) .. + 31 and columns 32 (w >> 1)
// .. + 31 of the tile.
__global__ void __launch_bounds__(TTHREADS)
wgrad1x1_mma(const bf16* __restrict__ in, const bf16* __restrict__ g,
             float* __restrict__ part, int K, int N, int pro, long long P, long long chunk,
             int accum) {
  __shared__ __align__(16) bf16 As[STAGES][TK][WS];   // [pixel][k]
  __shared__ __align__(16) bf16 Gs[STAGES][TK][WS];   // [pixel][n]
  const int r0 = blockIdx.x * WM, n0 = blockIdx.y * TN;
  const long long c0 = blockIdx.z * chunk;
  const long long c1 = c0 + chunk < P ? c0 + chunk : P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  // this thread's pieces: rows r0 + l8 .. + 7 of A and columns n0 + l8 ..
  // + 7 of g, at pixels p0 + lp + 16 j (j < 2) of slab p0
  const int lp = tid >> 3, l8 = (tid & 7) * 8;
  const bool ain = r0 + l8 < K, gin = n0 + l8 < N;
  const int nslabs = (int)((c1 - c0 + TK - 1) / TK);

  auto load = [&](int s) {
    const long long p0 = c0 + (long long)s * TK;
    const int st = s % STAGES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long p = p0 + lp + 16 * j;
      const bool aok = p < c1 && ain, gok = p < c1 && gin;
      cp_async16(&As[st][lp + 16 * j][l8], aok ? in + p * K + r0 + l8 : in, aok);
      cp_async16(&Gs[st][lp + 16 * j][l8], gok ? g + p * N + n0 + l8 : g, gok);
    }
  };

  float acc[2][4][4], accb[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[0][ni][e] = acc[1][ni][e] = 0.f;
      accb[ni][e] = 0.f;
    }
  // warps whose rows or columns all lie past the weight run no product;
  // the bias row's warps: those of rows 0 .. 31 in the first row tile
  const bool active = r0 + wm * 32 < K && n0 + wn * 32 < N;
  const bool bias_warp = blockIdx.x == 0 && wm == 0 && n0 + wn * 32 < N;
  const unsigned ones[4] = {ONE2, ONE2, ONE2, ONE2};
  // this lane's ldmatrix.trans rows: A, the x4 of gemm32_nb's [n][k] B
  // (registers a0..a3 of an m16 tile: rows 0-7 / 8-15 at pixels 0-7 /
  // 8-15); g, that of its [k][n] B
  const int lar = (lane & 7) + ((lane >> 4) << 3), lac = wm * 32 + ((lane >> 3) & 1) * 8;
  const int lgr = lane & 15, lgc = wn * 32 + (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslabs && !(SKIP & 4)) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslabs; ++s) {
    cp_async_wait<STAGES - 2>();
    const int st = s % STAGES;
    if (pro) {
#pragma unroll
      for (int j = 0; j < 2; ++j) mish8(&As[st][lp + 16 * j][l8]);
    }
    __syncthreads();
    if (s + STAGES - 1 < nslabs && !(SKIP & 4)) load(s + STAGES - 1);
    cp_async_commit();
    if (!active && !bias_warp) continue;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      unsigned b[2][4];
      ldmatrix_x4_trans(b[0], &Gs[st][kk * 16 + lgr][lgc]);
      ldmatrix_x4_trans(b[1], &Gs[st][kk * 16 + lgr][lgc + 16]);
      if (active) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          unsigned af[4];
          ldmatrix_x4_trans(af, &As[st][kk * 16 + lar][lac + mi * 16]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            if (!(SKIP & 1))
              mma_bf16(acc[mi][ni], af, b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
        }
      }
      if (bias_warp && !(SKIP & 1)) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(accb[ni], ones, b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
      }
    }
  }
  cp_async_wait<0>();
  if (SKIP & 2) return;
  // acc[mi][ni][2 h + c] is row r0 + 32 wm + 16 mi + g + 8 h, column n0 +
  // 32 wn + 8 ni + 2 q4 + c; every row of accb is the bias row
  const int gr = lane >> 2, q4 = lane & 3;
  float* pz = part + (size_t)blockIdx.z * (K + 1) * N;
  if (active) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * 32 + mi * 16 + gr + 8 * h;
        if (r >= K) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          put2(pz + (size_t)r * N + n0 + wn * 32 + ni * 8 + 2 * q4, acc[mi][ni][2 * h],
               acc[mi][ni][2 * h + 1], accum);
      }
  }
  if (bias_warp && gr == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      put2(pz + (size_t)K * N + n0 + wn * 32 + ni * 8 + 2 * q4, accb[ni][0], accb[ni][1], accum);
  }
}

// A 3x3 conv's weight gradients on the tensor cores (bf16), for the
// pixel tiles [t0, t1) of chunk blockIdx.z (TH x TW tiles of g's pixels,
// t0 = blockIdx.z per): part[z][t K + k][n] = sum_P in(P + off_t)[k]
// g(P)[n] for this block's KT channels k (blockIdx.x) and TN columns n
// (blockIdx.y), all 9 taps, and in the first channel slice's blocks the
// bias row 9 K, sum_P g(P)[n]; with `accum`, added to what part holds.
// A tile a stage through a STAGES3-deep ring: in's halo (HP pixels of
// KT channels, zero outside the image, [pixel][HS]) and g's tile (TM3
// pixels x TN, zero outside the image, [pixel][WS]); every tap reads
// the one halo, tap (dy, dx)'s A fragment of a tile row's 16 pixels the
// halo shifted by (dy, dx).  Warp w takes columns 16 w .. + 15: acc[t]
// [ni] tap t's 16 x 8 tile ni, K = the pixels, 16 (a tile row) an mma.
__global__ void __launch_bounds__(TTHREADS, 2)
wgrad3x3_mma(const bf16* __restrict__ in, const bf16* __restrict__ g,
             float* __restrict__ part, int K, int N, int B, int H, int W, int per,
             int accum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Hs = reinterpret_cast<bf16*>(smem_raw);   // STAGES3 x H_SLAB
  bf16* const Gs = Hs + STAGES3 * H_SLAB;                // STAGES3 x G_SLAB
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  const int k0 = blockIdx.x * KT, n0 = blockIdx.y * TN;
  const int t0 = blockIdx.z * per, t1 = t0 + per < ntiles ? t0 + per : ntiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool bias_block = blockIdx.x == 0;
  const unsigned ones[4] = {ONE2, ONE2, ONE2, ONE2};
  constexpr int HPIECES = (2 * HP + TTHREADS - 1) / TTHREADS;
  constexpr int GPIECES = TM3 * TN / 8 / TTHREADS;

  // tile t0 + s into ring place s % STAGES3: the halo (piece i: halo
  // pixel i / 2, 8 channels at its parity x 8) and g's tile (piece i:
  // pixel i / 8, 8 columns at (i % 8) 8)
  auto load = [&](int s) {
    const int t = t0 + s;
    const int c0 = t % tiles_w * TW, r0 = t / tiles_w % tiles_h * TH, b = t / tiles_w / tiles_h;
    bf16* hs = Hs + (s % STAGES3) * H_SLAB;
#pragma unroll
    for (int j = 0; j < HPIECES; ++j) {
      const int i = tid + TTHREADS * j, hp = i >> 1;
      const int gr = r0 - 1 + hp / HC, gc = c0 - 1 + hp % HC;
      const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
      if (i < 2 * HP)
        cp_async16(hs + hp * HS + (i & 1) * 8,
                   ok ? in + (((long long)b * H + gr) * W + gc) * K + k0 + (i & 1) * 8 : in, ok);
    }
    bf16* gs = Gs + (s % STAGES3) * G_SLAB;
#pragma unroll
    for (int j = 0; j < GPIECES; ++j) {
      const int i = tid + TTHREADS * j, px = i >> 3, nc = (i & 7) * 8;
      const int r = r0 + px / TW, c = c0 + px % TW;
      const bool ok = r < H && c < W && n0 + nc < N;
      cp_async16(gs + px * WS + nc,
                 ok ? g + (((long long)b * H + r) * W + c) * N + n0 + nc : g, ok);
    }
  };

  float acc[9][2][4], accb[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[t][ni][e] = 0.f;
      accb[ni][e] = 0.f;
    }
  // this lane's ldmatrix.trans rows: A, as wgrad1x1_mma's (halo pixels
  // 0-7 / 8-15 of the shifted tile row, channels 0-7 / 8-15); g, pixel
  // lane % 16 of the tile row, columns 16 w + 8 (lane / 16)
  const int la = ((lane & 7) + ((lane >> 4) << 3)) * HS + ((lane >> 3) & 1) * 8;
  const int lg = (lane & 15) * WS + 16 * warp + (lane >> 4) * 8;
  const int nst = t1 - t0;

#pragma unroll
  for (int s = 0; s < STAGES3 - 1; ++s) {
    if (s < nst && !(SKIP & 4)) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES3 - 2>();
    __syncthreads();   // tile s is in for every thread; tile s - 1 is read
    if (s + STAGES3 - 1 < nst && !(SKIP & 4)) load(s + STAGES3 - 1);
    cp_async_commit();
    if (n0 + 16 * warp >= N) continue;   // its columns lie past N
    const bf16* hs = Hs + (s % STAGES3) * H_SLAB + la;
    const bf16* gs = Gs + (s % STAGES3) * G_SLAB + lg;
    for (int row = 0; row < TH; ++row) {
      unsigned bg[4];   // b0, b1 of n8 tiles 0 and 1
      ldmatrix_x4_trans(bg, gs + row * TW * WS);
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        unsigned af[4];
        ldmatrix_x4_trans(af, hs + ((row + t / 3) * HC + t % 3) * HS);
        if (!(SKIP & 1)) {
          mma_bf16(acc[t][0], af, bg[0], bg[1]);
          mma_bf16(acc[t][1], af, bg[2], bg[3]);
        }
      }
      if (bias_block && !(SKIP & 1)) {
        mma_bf16(accb[0], ones, bg[0], bg[1]);
        mma_bf16(accb[1], ones, bg[2], bg[3]);
      }
    }
  }
  cp_async_wait<0>();
  if ((SKIP & 2) || n0 + 16 * warp >= N) return;
  // acc[t][ni][2 h + c] is row t K + k0 + g + 8 h, column n0 + 16 w + 8 ni
  // + 2 q4 + c; every row of accb is the bias row
  const int gr = lane >> 2, q4 = lane & 3;
  float* pz = part + (size_t)blockIdx.z * (9 * K + 1) * N + n0 + 16 * warp + 2 * q4;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        put2(pz + (size_t)(t * K + k0 + gr + 8 * h) * N + 8 * ni, acc[t][ni][2 * h],
             acc[t][ni][2 * h + 1], accum);
  if (bias_block && gr == 0) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      put2(pz + (size_t)9 * K * N + 8 * ni, accb[ni][0], accb[ni][1], accum);
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

// wt[t][k][n] = w[taps - 1 - t][n][k]: the B of a data-gradient conv
// (w's taps mirrored, each N x K tap transposed) laid out as [k][n]
__global__ void transpose_taps(const bf16* __restrict__ w, bf16* __restrict__ wt, int taps,
                               int K, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)taps * K * N) return;
  const int n = (int)(i % N), k = (int)(i / N % K), t = (int)(i / ((long long)K * N));
  wt[i] = w[((long long)(taps - 1 - t) * N + n) * K + k];
}

// The data-gradient conv of w (taps, K inputs, N outputs of the
// gradient) into a: f32 reads w transposed in conv_gemm (trans 1); bf16
// gets w transposed into `room` first, as [k][n], the only B the
// tensor-core kernels read (trans 0).  The launches are stream-ordered,
// so one room serves the chain's data gradients one after another.
cudaError_t grad_weights(ConvArgs<float>& a, const float* w, float*, cudaStream_t) {
  a.w = w;
  a.trans = 1;
  return cudaSuccess;
}
cudaError_t grad_weights(ConvArgs<bf16>& a, const bf16* w, float* room, cudaStream_t stream) {
  const long long n = (long long)a.taps * a.K * a.N;
  bf16* wt = reinterpret_cast<bf16*>(room);
  transpose_taps<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(w, wt, a.taps, a.K, a.N);
  a.w = wt;
  a.trans = 0;
  return cudaGetLastError();
}

// samples of a batch chunk: at most CHUNK_PIXELS pixels, at least one
int batch_chunk(int B, int H, int W) {
  const long long n = CHUNK_PIXELS / ((long long)H * W);
  return (int)(n < 1 ? 1 : n > B ? B : n);
}

// one conv: f32 on the FMA kernel, bf16 on the tensor cores
cudaError_t conv(const ConvArgs<float>& a, cudaStream_t stream) {
  const long long P = (long long)a.B * a.H * a.W;
  const long long mb = (P + BM - 1) / BM;
  if (mb > 0x7fffffff) return cudaErrorInvalidValue;
  conv_gemm<float><<<dim3((unsigned)mb, (a.N + BN - 1) / BN), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// lets `kernel` take `smem` bytes of dynamic shared memory, once a
// device: the attribute is kept with the function, and setting it at
// every launch costs host time the small launches notice
template <typename F>
cudaError_t allow_smem(F kernel, int smem, unsigned char (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return err;
}
unsigned char smem_set1[64], smem_set3[64], smem_setw3[64];

cudaError_t conv(const ConvArgs<bf16>& a, cudaStream_t stream) {
  const long long P = (long long)a.B * a.H * a.W;
  const unsigned ntn = (a.N + TN - 1) / TN;
  if (P > 0x7fffffff || a.trans) return cudaErrorInvalidValue;
  if (a.taps == 9) {
    if (a.pro || a.epi == EPI_OUT) return cudaErrorInvalidValue;
    const long long tiles = (long long)a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(conv3x3_mma, CONV3_SMEM, smem_set3);
    if (err != cudaSuccess) return err;
    conv3x3_mma<<<dim3((unsigned)tiles, ntn), TTHREADS, CONV3_SMEM, stream>>>(a);
    return cudaGetLastError();
  }
  const cudaError_t err = allow_smem(conv1x1_mma, CONV1_SMEM, smem_set1);
  if (err != cudaSuccess) return err;
  conv1x1_mma<<<dim3((unsigned)((P + TM - 1) / TM), ntn), TTHREADS, CONV1_SMEM, stream>>>(a);
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

// the chunks of a bf16 3x3 wgrad over `tiles` pixel tiles: enough
// blocks for the card (the same S on any card), at most MAX_CHUNKS, none
// empty
int wgrad3_chunks(long long tiles, int K, int N) {
  const long long blocks = (long long)(K / KT) * ((N + TN - 1) / TN);
  long long s = (WGRAD_BLOCKS + blocks - 1) / blocks;
  if (s > tiles) s = tiles;
  if (s > MAX_CHUNKS) s = MAX_CHUNKS;
  if (s < 1) s = 1;
  const long long per = (tiles + s - 1) / s;
  return (int)((tiles + per - 1) / per);
}

long long tiles3(int B, int H, int W) {
  return (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// S, the chunks of one conv's weight gradients: f32 and a bf16 1x1 split
// the pixels, a bf16 3x3 its pixel tiles
int wgrad_parts(const float*, int taps, int K, int N, int B, int H, int W) {
  return wgrad_chunks((long long)B * H * W, taps * K + 1, N);
}
int wgrad_parts(const bf16*, int taps, int K, int N, int B, int H, int W) {
  return taps == 9 ? wgrad3_chunks(tiles3(B, H, W), K, N)
                   : wgrad_chunks((long long)B * H * W, taps * K + 1, N);
}

// the wgrad kernel of x's type into dst's S partials: f32 the FMA kernel
// over S pixel chunks; bf16 a 1x1 wgrad1x1_mma over the same chunks, a
// 3x3 wgrad3x3_mma over S chunks of pixel tiles (the first row tile, or
// channel slice, takes the bias row, so neither has blocks for a tile
// of the bias row alone)
cudaError_t wgrad_launch(const float* in, const float* g, float* dst, int taps, int K, int N,
                         int pro, int B, int H, int W, int S, int accum, cudaStream_t stream) {
  const long long P = (long long)B * H * W;
  const int R = taps * K + 1;
  long long chunk = (P + S - 1) / S;
  chunk = (chunk + BK - 1) / BK * BK;
  conv_wgrad<float><<<dim3((R + BM - 1) / BM, (N + BN - 1) / BN, S), THREADS, 0, stream>>>(
      in, g, dst, taps, K, N, pro, 1, B, H, W, chunk, accum);
  return cudaGetLastError();
}
cudaError_t wgrad_launch(const bf16* in, const bf16* g, float* dst, int taps, int K, int N,
                         int pro, int B, int H, int W, int S, int accum, cudaStream_t stream) {
  const long long P = (long long)B * H * W;
  const unsigned ntn = (N + TN - 1) / TN;
  if (taps == 9) {
    const long long tiles = tiles3(B, H, W);
    if (pro || P > 0x7fffffff) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(wgrad3x3_mma, WG3_SMEM, smem_setw3);
    if (err != cudaSuccess) return err;
    wgrad3x3_mma<<<dim3(K / KT, ntn, S), TTHREADS, WG3_SMEM, stream>>>(
        in, g, dst, K, N, B, H, W, (int)((tiles + S - 1) / S), accum);
    return cudaGetLastError();
  }
  long long chunk = (P + S - 1) / S;
  chunk = (chunk + BK - 1) / BK * BK;
  wgrad1x1_mma<<<dim3((K + WM - 1) / WM, ntn, S), TTHREADS, 0, stream>>>(
      in, g, dst, K, N, pro, P, chunk, accum);
  return cudaGetLastError();
}

// dW (taps K x N) and db (N) of one conv into out (taps K + 1 rows x N,
// f32; with accum, added to it), through part (at least S x that)
template <typename T>
cudaError_t wgrad(const T* in, const T* g, float* part, float* out, int taps, int K, int N,
                  int pro, int B, int H, int W, int accum, cudaStream_t stream) {
  const int R = taps * K + 1;
  const int S = wgrad_parts(in, taps, K, N, B, H, W);
  float* dst = S == 1 ? out : part;
  cudaError_t err = wgrad_launch(in, g, dst, taps, K, N, pro, B, H, W, S, S == 1 && accum,
                                 stream);
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
  // the data gradients (their B laid out in part, free until the
  // weight gradients)
  a = conv_args<T>(dy, w4, 1, 1, C, CM, B, H, W);
  a.epi = EPI_GRAD; a.dmul = d3; a.out = g3;
  TRY(grad_weights(a, w4, part, stream));
  TRY(conv(a, stream));
  a = conv_args<T>(g3, w3, 9, 1, CM, CM, B, H, W);
  a.epi = EPI_GRAD; a.dmul = d2; a.out = g2;
  TRY(grad_weights(a, w3, part, stream));
  TRY(conv(a, stream));
  a = conv_args<T>(g2, w2, 9, 1, CM, CM, B, H, W);
  a.epi = EPI_GRAD; a.dmul = d1; a.out = g1;
  TRY(grad_weights(a, w2, part, stream));
  TRY(conv(a, stream));
  a = conv_args<T>(g1, w1, 1, 1, CM, C, B, H, W);
  a.epi = EPI_DX; a.xin = x; a.add = residual ? dy : nullptr; a.out = dx;
  TRY(grad_weights(a, w1, part, stream));
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
  const int bc = batch_chunk(B, H, W);
  const long long P = (long long)bc * H * W;
  long long most = 0;
  const int rows[4] = {C + 1, 9 * CM + 1, 9 * CM + 1, CM + 1};
  const int cols[4] = {CM, CM, CM, C};
  for (int i = 0; i < 4; ++i) {
    // either dtype's S: the pixel chunks, or for a bf16 3x3 the tile chunks
    long long s = wgrad_chunks(P, rows[i], cols[i]);
    if (i == 1 || i == 2) {
      const long long s3 = wgrad3_chunks(tiles3(bc, H, W), CM, CM);
      if (s3 > s) s = s3;
    }
    const long long n = s * rows[i] * cols[i];
    if (n > most) most = n;
  }
  // the room of a bf16 data gradient's B (9 CM CM or C CM bf16)
  const long long room = ((9LL * CM > C ? 9LL * CM : C) * CM + 1) / 2;
  return most > room ? most : room;
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
