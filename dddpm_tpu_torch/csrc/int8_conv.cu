// W8A8 3x3 convolution for Hopper (sm_90a) on the s8 tensor cores
// (wgmma m64n128k32, s8 operands, s32 sums): Q1.
//
// Replaces the product that dddpm_tpu/ops/quant.py:int8_conv (lines
// 93-106) leaves to XLA: lax.conv_general_dilated on s8 operands with
// preferred_element_type=int32, together with the quantize before it and
// the dequantize after it.  That is not a Pallas kernel, but PyTorch has
// no s8 x s8 -> s32 convolution on a CUDA tensor, so the port writes it.
//
// What it computes, on x (B, Cin, H, W) in f32 or bf16, each operand
// NCHW-contiguous (rows of a multiple of 16 bytes) or channels_last and
// 16-byte aligned, read as it lies; the packed s8 weights (see below),
// ws (Cout) f32 and amax, a device pointer to one f32; stride 1, SAME:
//   xs  = max(amax, 1e-12) / 127
//   xq  = clamp(round_half_even(x / xs), -127, 127)     IEEE division
//   acc = conv3x3(xq, w)                                exact s32 sums
//   y   = float(acc) * (xs * ws[c])                     the product first
// With a skip operand (the UNet's concat-free skip connection: the same
// shape as x, its own weights, ws and amax) its y_s is formed the same
// way and y = y + y_s in f32.  Then y is rounded to x's type once, and an
// optional bias (Cout, f32) is rounded to x's type and added, rounded
// again: the order of ops/quant.py:plain and of the JAX module.  Every
// float step that decides the bits is a correctly rounded intrinsic
// (__fdiv_rn, __frcp_rn, __fmul_rn, __fadd_rn, __float2int_rn: never
// contracted into an FMA; the quantize's integer comes from v * (1 / xs)
// only where that provably rounds as v / xs, mma_s8_sm90.cuh's
// quantize8_s8), and integer sums do not depend on their order, so the
// kernel equals its plain version bit for bit.  SAME padding is a zero
// in s8.  y is written NCHW-contiguous: the layout in which the Block's
// GroupNorm reads it without a copy.
//
// What bounds it on an H100: 2 * 9 * Cin * Cout s8 operations a pixel,
// against reading x once in its type and writing y once.  At 128^2, C =
// 128 in bf16 the two bounds are about equal; at C = 256 operations
// bound it.  Measured (probes/int8_ablation.py), y's stores take most of
// what is left above the products, then the fixed cost of the pipeline.
//
// What this design does about it: an implicit GEMM, M = a tile's 8 x 16
// band of output pixels, N = 128 or 256 output channels (all of Cout =
// 256 at one operand, so the band is quantized once), K = 9 taps x Cin,
// pipelined over 32-channel stages through a ring in shared memory.  A
// persistent grid (one 512-thread block an SM) walks the tiles.
//   - 8 producer warps (setmaxnreg 88 registers) in two warpgroups, each
//     filling every other stage.  One thread of the warpgroup asks the
//     TMA for the stage's box of x as it lies (NCHW: 32 channels x 10
//     rows x 32 (bf16) or 24 (f32) columns; NHWC: 10 x 18 pixels x 32
//     channels; 0 outside the image), the next stage's while the
//     warpgroup quantizes this one's (at N = 256 after it), and the bulk
//     copy engine for the stage's weights (9 taps x N x 32 s8); each
//     lands on an mbarrier.  All 128 threads then quantize the box from
//     shared memory into the stage's s8 band, pixels 48 bytes apart, so
//     the transposition of an NCHW operand happens where the quantize
//     touches every value.
//   - 8 consumer warps (setmaxnreg 168) are two warpgroups of 64 pixels
//     (4 band rows) x N.  Per stage and row of 3 taps, each warp loads
//     its 16 pixels' A fragments of the 3 taps with ldmatrix (a tap is a
//     constant offset into the band: nothing is built as im2col), then
//     issues the 3 x N / 128 wgmma (A from registers, B by descriptor:
//     the weights' K-major core matrices as the copy left them) and
//     waits for them; after the 9 taps it frees the stage on its `empty`
//     mbarrier.  With the skip operand the first operand's sums are
//     dequantized into f32 registers and the second's accumulated in s32
//     after them (N = 128 there).  The epilogue dequantizes a channel
//     pair at a time with the scales and bias staged in shared memory
//     and stores y NCHW from the fragments: in bf16 movmatrix transposes
//     each 8 x 8 (pixel, channel) block, so a lane stores 2 neighbouring
//     pixels of a channel in one word.
//   - At 128 -> 128 channels in bf16 (one operand) all the weights (144
//     KB) stay in shared memory for the block's life, copied once, and
//     the ring of 4 stages carries only bands; else 3 stages (2 at N =
//     256 or in f32) carry the weights too.
// Not done: y staged in shared memory and stored by TMA while the next
// tile's products run; clusters sharing a weight stage at C = 256.
//
// The weights come packed (ops/quant.py:prepare_weight): s8 (9, Kpad /
// 32, Npad / 8, 2, 8, 16), Kpad = Cin and Npad = Cout rounded up to 32
// and 128 (zero rows and columns): per tap and 32-channel slab, the
// 8-row x 16-byte core matrices of the wgmma B operand, so a tile's N
// rows of one tap and slab are one contiguous run of N x 32 bytes.
//
// Any width: Cin and Cout need not be multiples of anything.  The last
// 32-channel stage's box reaches past Cin, where the TMA fills zeros
// (within the tensor map's bounds, in either layout), which quantize to
// 0 and meet the packed weights' zero columns; y's stores, and the reads
// of ws and the bias, are masked past Cout.  An NHWC operand's pixel
// pitch, Cin x its element size, must be a multiple of 16 bytes (the
// TMA's stride rule); ops/quant.py:_readable pads the channels of a copy
// where it is not.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8_sm90.cuh"  // wgmma_s8_n128, quantize8_s8
#include "mma_sm90.cuh"     // ldmatrix_x4, movmatrix_trans
#include "wgmma_sm90.cuh"   // mbarriers, bulk copies, TMA, setmaxnreg, wgmma sync

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;            // output band: 8 rows x 16 columns
constexpr int BR = TH + 2, BC = TW + 2;   // with the halo: 10 x 18 pixels
constexpr int BPIX = BR * BC;
constexpr int KC = 32;                    // input channels a stage: one k32 step
constexpr int PSTR = KC + 16;             // bytes a band pixel
constexpr int BAND_BYTES = BPIX * PSTR;
constexpr int NPAD = 128;                 // the packed weights' row step
constexpr int CONSUMERS = 256;            // 2 warpgroups: the products
constexpr int PRODUCERS = 256;            // 2 warpgroups: the copies and the quantize
constexpr int PWG = 128;                  // a producer warpgroup: it fills every other stage
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int TASKS = BPIX * KC / 8;      // a stage's (pixel, 8 channels) quantize tasks
// registers a thread after setmaxnreg, adding up to the 128 of a
// 512-thread block: a consumer holds 128 sums (N = 256, or 64 sums and
// 64 f32 with the skip operand) and the 12 A registers of 3 taps
constexpr int PREG = 88, CREG = 256 - PREG;
constexpr int MAX_STAGES = 4;
// Q1_SKIP (probes/int8_ablation.py builds it; 0 ships) takes parts out
// to time the rest: 1 the products, 2 the quantize's arithmetic, 4 x's
// boxes, 8 the weights' copies, 16 y's stores
#ifndef Q1_SKIP
#define Q1_SKIP 0
#endif
constexpr int SKIP = Q1_SKIP;
constexpr int RES_BYTES = 9 * 128 * 128;  // resident weights: up to 128 -> 128 channels

// An NCHW box of T: the TMA wants its first column 16 bytes aligned, so
// it starts COL0 columns left of the band's output columns (one of them
// the halo) and spans COLS >= COL0 + 17 columns.
template <typename T>
struct NchwBox {
  static constexpr int COL0 = 16 / (int)sizeof(T);   // 8 in bf16, 4 in f32
  static constexpr int COLS = sizeof(T) == 2 ? 32 : 24;
};

// Shared memory: the raw buffers (RB a producer warpgroup: a stage's x
// box as the TMA left it, in x's type: NCHW [32 channels][10 rows][COLS
// columns from w0 - COL0], NHWC [10 rows][18 columns][32 channels]); the
// ring of stages, each its weights (9 taps x NB x 32 s8, wgmma's B) and
// its s8 band; then the dequantize scales.  At N = 256 in bf16 one raw
// buffer a warpgroup: its next box is asked for once it has quantized
// this one (the other warpgroup's stage is in flight meanwhile).
template <typename T, int NB, bool RES>
struct Cfg {
  static constexpr int RAW = KC * BR * NchwBox<T>::COLS * (int)sizeof(T);
  static constexpr int RAW_NHWC = BPIX * KC * (int)sizeof(T);
  static constexpr int WBYTES = RES ? 0 : 9 * NB * KC;   // a stage's weights
  static constexpr int STAGE = WBYTES + BAND_BYTES;
  static constexpr int STAGES = RES ? 4 : NB == 256 || sizeof(T) == 4 ? 2 : 3;
  static constexpr int RB = NB == 256 || RES ? 1 : 2;
  // + base alignment and, with RES, all the weights after the ring
  static constexpr int SMEM = 128 + 2 * RB * RAW + STAGES * STAGE + (RES ? RES_BYTES : 0);
  static_assert(RAW % 128 == 0 && RAW_NHWC <= RAW, "raw buffers");
  static_assert(SMEM + 3 * 256 * 4 <= 227 * 1024 - 128, "shared memory");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

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

// b rounded to the output's type, as a float
__device__ __forceinline__ float round_to(float b, const float*) { return b; }
__device__ __forceinline__ float round_to(float b, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(b));
}

// y rounded to the output's type, then + b (rounded to it) when there is
// a bias, rounded again
__device__ __forceinline__ void store1(float* p, float y, bool bias, float b) {
  *p = bias ? __fadd_rn(y, b) : y;
}

__device__ __forceinline__ bf16 round_bias(float y, bool bias, float b) {
  bf16 r = __float2bfloat16_rn(y);
  if (bias) r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), b));
  return r;
}

__device__ __forceinline__ void store1(bf16* p, float y, bool bias, float b) {
  *p = round_bias(y, bias, b);
}

// two bf16 in one word, the first in the low half
__device__ __forceinline__ unsigned pack_bf16x2(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

struct Operand {
  const void* x;
  int nchw;             // 1: x is NCHW-contiguous, 0: channels_last (NHWC)
  const int8_t* w;      // packed s8 weights
  const float* ws;
  const float* amax;
};

struct Args {
  Operand op[2];
  const float* bias;
  void* y;
  int B, H, W, Cin, Cout, Npad, ncol;
};

struct Tile {
  int b, h0, w0, n0;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int tile, int NB) {
  const int ntw = (a.W + TW - 1) / TW, nth = (a.H + TH - 1) / TH;
  Tile t;
  t.n0 = (tile % a.ncol) * NB;
  tile /= a.ncol;
  t.w0 = (tile % ntw) * TW;
  tile /= ntw;
  t.h0 = (tile % nth) * TH;
  t.b = tile / nth;
  return t;
}

__device__ __forceinline__ float act_scale(const float* amax) {
  return __fdiv_rn(fmaxf(__ldg(amax), 1e-12f), 127.0f);
}

// The quantize of a landed box into a stage's s8 band, pixels PSTR bytes
// apart (the box reads 0 outside the image): task i is (pixel, 8
// channels); NCHW lanes walk the pixels (neighbouring columns of one
// channel row), NHWC a pixel's channels.
template <typename T>
__device__ __forceinline__ void quantize_band(int nchw, float xs, float inv,
                                              const unsigned char* raw,
                                              unsigned char* band, int tid) {
  using X = NchwBox<T>;
  const T* rv = reinterpret_cast<const T*>(raw);
  for (int i = tid; i < TASKS; i += PWG) {
    const int pix = nchw ? i % BPIX : i >> 2;
    const int c8 = nchw ? i / BPIX : i & 3;
    float v[8];
    if (nchw) {
      // band column c is box column c - 1 + COL0
      const T* p = rv + (c8 * 8 * BR + pix / BC) * X::COLS + pix % BC - 1 + X::COL0;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = to_float(p[j * BR * X::COLS]);
    } else {
      load8(rv + pix * KC + c8 * 8, v);
    }
    *reinterpret_cast<uint2*>(band + pix * PSTR + c8 * 8) =
        SKIP & 2 ? make_uint2(__float_as_uint(v[0]), __float_as_uint(v[4]))
                 : quantize8_s8(v, xs, inv);
  }
}

// NB output channels a tile (NH = NB / 128 wgmma a tap); NOPS operands
// (1, or 2 with the skip operand, at NB = 128)
template <typename T, int NB, int NOPS, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
int8_conv_kernel(const __grid_constant__ Args args,
                 const __grid_constant__ CUtensorMap map0,
                 const __grid_constant__ CUtensorMap map1) {
  using C = Cfg<T, NB, RES>;
  constexpr int NH = NB / 128;
  static_assert(NOPS == 1 || NH == 1, "two operands take N = 128");
  static_assert(!RES || (NOPS == 1 && NB == 128), "resident weights: one operand, N = 128");
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES],
      rawbar[2][C::RB], wbar;
  unsigned char* raws = dyn + ((128 - (smem_addr(dyn) & 127)) & 127);
  unsigned char* smem = raws + 2 * C::RB * C::RAW;   // the ring
  unsigned char* wres = smem + C::STAGES * C::STAGE;  // RES: the weights
  const int nk = (args.Cin + KC - 1) / KC;
  const int ntiles = args.B * ((args.H + TH - 1) / TH) *
                     ((args.W + TW - 1) / TW) * args.ncol;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], PWG + !RES);       // its producer warpgroup (+ the copies)
      mbar_init(&empty[s], CONSUMERS / 32);  // every consumer warp
    }
    for (int b = 0; b < 2 * C::RB; ++b) mbar_init(&rawbar[b / C::RB][b % C::RB], 1);
    mbar_init(&wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producers: warpgroup pwg fills stages it = pwg, pwg + 2, ...;
    // the raw band of its next stage is in flight while it quantizes
    // this one's ----
    setmaxnreg_dec<PREG>();
    const int pwg = (threadIdx.x - CONSUMERS) / PWG, tid = threadIdx.x % PWG;
    const float xs0 = act_scale(args.op[0].amax);
    const float xs1 = NOPS == 2 ? act_scale(args.op[1].amax) : 1.f;
    const float inv0 = __frcp_rn(xs0), inv1 = __frcp_rn(xs1);
    unsigned char* raw = raws + pwg * C::RB * C::RAW;
    // stage it of this block: its tile, operand and slab; false past the end
    const int per_tile = NOPS * nk;
    auto stage_at = [&](int it, Tile& t, int& o, int& k) {
      const int tile = blockIdx.x + (it / per_tile) * gridDim.x;
      if (tile >= ntiles) return false;
      t = tile_at(args, tile, NB);
      o = (it % per_tile) / nk;
      k = it % nk;
      return true;
    };
    // one thread asks the TMA for the box of (t, o, k) into raw buffer b
    auto fetch = [&](const Tile& t, int o, int k, int b) {
      if (SKIP & 4) {
        mbar_arrive(&rawbar[pwg][b]);
        return;
      }
      const int nchw = o ? args.op[1].nchw : args.op[0].nchw;
      mbar_arrive_expect_tx(&rawbar[pwg][b], nchw ? C::RAW : C::RAW_NHWC);
      const CUtensorMap* map = o ? &map1 : &map0;
      if (nchw)
        tma_load_4d(raw + b * C::RAW, map, t.w0 - NchwBox<T>::COL0, t.h0 - 1, k * KC,
                    t.b, &rawbar[pwg][b]);
      else
        tma_load_4d(raw + b * C::RAW, map, k * KC, t.w0 - 1, t.h0 - 1, t.b,
                    &rawbar[pwg][b]);
    };
    // resident weights: all of them, once
    if (RES && pwg == 0 && tid == 0) {
      const unsigned bytes = SKIP & 8 ? 0u : 9u * nk * KC * args.Npad;
      mbar_arrive_expect_tx(&wbar, bytes);
      if (bytes) bulk_g2s(wres, args.op[0].w, bytes, &wbar);
    }
    Tile t, tn;
    int o, k, on, kn;
    bool have = stage_at(pwg, t, o, k);
    if (have && tid == 0) fetch(t, o, k, 0);
    for (int it = pwg, j = 0; have; it += 2, ++j) {
      const bool next = stage_at(it + 2, tn, on, kn);
      if (C::RB == 2 && next && tid == 0) fetch(tn, on, kn, (j + 1) & 1);
      const int s = it % C::STAGES;
      unsigned char* stage = smem + s * C::STAGE;
      mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
      if (!RES && tid == 0) {
        const int8_t* w = o ? args.op[1].w : args.op[0].w;
        mbar_arrive_expect_tx(&full[s], SKIP & 8 ? 0 : C::WBYTES);
#pragma unroll 1
        for (int tap = 0; tap < (SKIP & 8 ? 0 : 9); ++tap)
          bulk_g2s(stage + tap * NB * KC,
                   w + ((size_t)(tap * nk + k) * args.Npad + t.n0) * KC, NB * KC,
                   &full[s]);
      }
      const int b = j % C::RB;
      mbar_wait(&rawbar[pwg][b], (j / C::RB) & 1);   // stage it's box has landed
      quantize_band<T>(o ? args.op[1].nchw : args.op[0].nchw, o ? xs1 : xs0,
                       o ? inv1 : inv0, raw + b * C::RAW, stage + C::WBYTES, tid);
      mbar_arrive(&full[s]);
      bar_sync(1 + pwg, PWG);        // the raw buffer is free again
      if (C::RB == 1 && next && tid == 0) fetch(tn, on, kn, 0);
      t = tn;
      o = on;
      k = kn;
      have = next;
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<CREG>();
  // each operand's dequantize scales xs * ws[c] and the bias rounded to
  // y's type, for every padded channel, in shared memory after the ring
  float* scales = reinterpret_cast<float*>(wres + (RES ? RES_BYTES : 0));
  const int Npad = args.Npad;
  const bool has_bias = args.bias != nullptr;
  for (int n = threadIdx.x; n < Npad; n += CONSUMERS) {
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
      const float xs = act_scale(o ? args.op[1].amax : args.op[0].amax);
      const float* ws = o ? args.op[1].ws : args.op[0].ws;
      scales[o * Npad + n] = n < args.Cout ? __fmul_rn(xs, __ldg(ws + n)) : 0.f;
    }
    scales[NOPS * Npad + n] =
        has_bias && n < args.Cout ? round_to(__ldg(args.bias + n), (const T*)nullptr) : 0.f;
  }
  bar_sync(3, CONSUMERS);   // 1 and 2 are the producer warpgroups'
  const float* bias_r = scales + NOPS * Npad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;     // warpgroup, its warp
  const int g = lane >> 2, tig = lane & 3;
  // this warp's 16 pixels: band row 4 wg + wq; ldmatrix lane addresses
  const int a_row = 4 * wg + wq;
  const int a_col = (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 16 * (lane >> 4);
  const int H = args.H, W = args.W, Cout = args.Cout;
  const size_t ohw = (size_t)H * W;
  int acc[NH][64];
  float y[NOPS == 2 ? 64 : 1];
  if (RES) mbar_wait(&wbar, 0);
  // B of tap 0 and its step to the next tap: in the stage, or resident
  // (packed: tap-major, then 32-channel slab, then Npad rows of 32 bytes)
  const int tap_step = RES ? nk * Npad * KC : NB * KC;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile t = tile_at(args, tile, NB);
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          acc[h][i] = 0;
          wgmma_fence_operand(acc[h][i]);
        }
#pragma unroll 1
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(&full[s], (it / C::STAGES) & 1);
        const unsigned char* stage = smem + s * C::STAGE;
        const unsigned char* band = stage + C::WBYTES;
        const uint64_t desc =
            wgmma_desc(RES ? wres + (k * Npad + t.n0) * KC : stage, 128, 256);
        // the 9 taps as 3 rows of 3: A of one row in registers at a time
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          unsigned a[3][4];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            ldmatrix_x4(a[dx], band + ((a_row + dy) * BC + a_col + dx) * PSTR + a_k);
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int h = 0; h < NH; ++h)   // + the tap's n128 slab >> 4
              if (!(SKIP & 1))
                wgmma_s8_n128(acc[h], a[dx],
                              desc + (((3 * dy + dx) * tap_step + h * 128 * KC) >> 4), 1);
          wgmma_commit();
          wgmma_wait<0>();
        }
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int i = 0; i < 64; ++i) wgmma_fence_operand(acc[h][i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }

      // dequantize: float(acc) * (xs * ws[c]); the skip operand's is
      // added to the first's (held in y); after the last operand y is
      // stored NCHW, lanes g = 0..7 on 8 neighbouring pixels of a channel
      const float* sc = scales + o * Npad;
      const int oh = t.h0 + a_row;
      T* out = static_cast<T*>(args.y) + (size_t)t.b * Cout * ohw + (size_t)oh * W;
      // the tile's 16 columns and N channels all in y, W even: 4-byte stores
      const bool whole = t.w0 + TW <= W && t.n0 + NB <= Cout && W % 2 == 0;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = t.n0 + h * 128 + j * 8 + tig * 2;
          const float s2[2] = {sc[n], sc[n + 1]};
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = __fmul_rn(__int2float_rn(acc[h][j * 4 + i]), s2[i & 1]);
            if constexpr (NOPS == 2) {
              if (o == 0)
                y[j * 4 + i] = v[i];
              else
                v[i] = __fadd_rn(y[j * 4 + i], v[i]);
            }
          }
          if (o == NOPS - 1 && oh < H && !(SKIP & 16)) {
            bool done = false;
            if constexpr (sizeof(T) == 2) {
              if (whole) {
                // round per value, then movmatrix turns each 8 x 8
                // (pixel, channel) block into (channel, pixel): lane (g,
                // tig) then holds pixels 2 tig, 2 tig + 1 of channel g
                const bf16 r0 = round_bias(v[0], has_bias, bias_r[n]);
                const bf16 r1 = round_bias(v[1], has_bias, bias_r[n + 1]);
                const bf16 r2 = round_bias(v[2], has_bias, bias_r[n]);
                const bf16 r3 = round_bias(v[3], has_bias, bias_r[n + 1]);
                const unsigned lo = movmatrix_trans(pack_bf16x2(r0, r1));
                const unsigned hi = movmatrix_trans(pack_bf16x2(r2, r3));
                T* p = out + (n - 2 * tig + g) * ohw + t.w0 + 2 * tig;
                *reinterpret_cast<unsigned*>(p) = lo;
                *reinterpret_cast<unsigned*>(p + 8) = hi;
                done = true;
              }
            }
            if (!done) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = n + (i & 1), ow = t.w0 + g + 8 * (i >> 1);
                if (c < Cout && ow < W)
                  store1(out + c * ohw + ow, v[i], has_bias, bias_r[c]);
              }
            }
          }
          // one channel pair at a time: the next pairs' loads and
          // addresses are not hoisted into registers beside the sums
          compiler_barrier();
        }
    }
  }
}

template <typename T, int NB, int NOPS, bool RES = false>
cudaError_t launch(Args a, const CUtensorMap* maps, int sms, cudaStream_t stream) {
  using C = Cfg<T, NB, RES>;
  auto kernel = int8_conv_kernel<T, NB, NOPS, RES>;
  const int smem = C::SMEM + (NOPS + 1) * a.Npad * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  a.ncol = a.Npad / NB;
  const long tiles = (long)a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW) * a.ncol;
  kernel<<<(int)(tiles < sms ? tiles : sms), THREADS, smem, stream>>>(a, maps[0], maps[1]);
  return cudaGetLastError();
}

template <typename T, int NOPS>
cudaError_t dispatch(const Args& a, const CUtensorMap* maps, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if constexpr (NOPS == 1 && sizeof(T) == 2) {
    // C -> C at 128 channels or fewer: the weights stay in shared memory
    if (a.Npad == 128 && 9 * ((a.Cin + KC - 1) / KC * KC) * a.Npad <= RES_BYTES)
      return launch<T, 128, 1, true>(a, maps, sms, stream);
    // all of Cout = 256 in one tile unless that leaves SMs without a tile
    const long bands = (long)a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
    if (a.Npad % 256 == 0 && bands * (a.Npad / 256) >= sms &&
        Cfg<T, 256, false>::SMEM + 2 * a.Npad * (int)sizeof(float) <= 227 * 1024 - 128)
      return launch<T, 256, 1>(a, maps, sms, stream);
  }
  return launch<T, 128, NOPS>(a, maps, sms, stream);
}

}  // namespace

extern "C" int int8_conv(const void* x, const void* w, const void* ws,
                         const void* amax, const void* skip,
                         const void* w_s, const void* ws_s,
                         const void* amax_s, const void* bias, void* y,
                         int B, int H, int W, int Cin, int Cout, int dtype,
                         int x_nchw, int skip_nchw, void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  const bool two = skip != nullptr;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || (dtype != 0 && dtype != 1) ||
      (x_nchw | skip_nchw) & ~1 || ((x_nchw || (two && skip_nchw)) && W * es % 16) ||
      ((!x_nchw || (two && !skip_nchw)) && Cin * es % 16))
    return (int)cudaErrorInvalidValue;
  // the TMA's view of each operand: NCHW boxes of 32 (bf16) or 24 (f32)
  // columns x 10 rows x 32 channels, NHWC boxes of 32 channels x 18
  // columns x 10 rows
  CUtensorMap maps[2];
  const void* xs[2] = {x, skip};
  const int nchw[2] = {x_nchw, skip_nchw};
  for (int o = 0; o < (two ? 2 : 1); ++o) {
    const cuuint64_t dims_nchw[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)B};
    const cuuint64_t dims_nhwc[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint32_t box_nchw[4] = {(cuuint32_t)(es == 2 ? NchwBox<bf16>::COLS
                                                         : NchwBox<float>::COLS),
                                    BR, KC, 1};
    const cuuint32_t box_nhwc[4] = {KC, BC, BR, 1};
    if (!make_tensor_map_4d(&maps[o], dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            es, xs[o], nchw[o] ? dims_nchw : dims_nhwc,
                            nchw[o] ? box_nchw : box_nhwc))
      return (int)cudaErrorInvalidValue;
  }
  if (!two) maps[1] = maps[0];
  Args a;
  a.op[0] = {x, x_nchw, static_cast<const int8_t*>(w),
             static_cast<const float*>(ws), static_cast<const float*>(amax)};
  a.op[1] = {skip, skip_nchw, static_cast<const int8_t*>(w_s),
             static_cast<const float*>(ws_s), static_cast<const float*>(amax_s)};
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.Npad = (Cout + NPAD - 1) / NPAD * NPAD;
  a.ncol = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = two ? dispatch<bf16, 2>(a, maps, s) : dispatch<bf16, 1>(a, maps, s);
  else
    err = two ? dispatch<float, 2>(a, maps, s) : dispatch<float, 1>(a, maps, s);
  return (int)err;
}
