// Channel-major 3x3 conv for Hopper (sm_90a): does a channel-major
// layout suit a 32-channel 3x3 conv?  Products on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 sums).
//
// Replaces the TPU kernel of scripts/probe_cmajor_conv.py:
//   _kernel (:29, pallas_call :67) -> cmajor_conv_kernel
//
// What it computes: y = conv3x3(x, w), SAME zero padding, stride 1, no
// bias, on channel-major x (B, 32, H, W) bf16, with wmat (32, 9 * 32) in
// the probe's order (columns (ky, kx, ci)); products of bf16 values
// summed in f32, y (B, 32, H, W) rounded to bf16.
//
// What bounds it on an H100: at the probe's default (B = 32, 256^2) it
// moves 268.4 MB (0.080 ms at 3.35 TB/s) and does 38.7 GFLOP (0.039 ms
// at the bf16 peak): the bytes.  mma.sync reaches well under that peak,
// so the products weigh nearly as much, and the kernel is as fast as it
// overlaps the two.  On an H100 80GB HBM3 (700 W), with parts of this
// design compiled out, the products (with the transposes and the
// output staging) alone and the loads and stores alone each took well
// over half the time of the whole: they overlap only in part.
//
// What this design does about it: an implicit GEMM per tile of TH rows
// x TW columns of one sample, M = the tile's pixels, N = the 32 output
// channels, K = 9 taps x 32 input channels, as the TPU probe framed it
// (Y = Wmat . P).  One block an SM (a persistent grid) walks its tiles,
// every gridDim.x-th from blockIdx.x on, the columns fastest, so that
// neighbouring tiles run at once and a tile's halo rows come from L2.
// The block keeps wmat in shared memory for all its tiles (loaded
// once) and is warp-specialised, its roles handing two band buffers of
// each kind back and forth through named barriers (FULL, EMPTY):
//   - 12 producer warps load tile k + 2's band while transposing tile
//     k's.  The band: TH + 2 rows x TW + 16 columns (from 8 left of the
//     tile, so that every 16-byte piece of a row stays aligned) x 32
//     channels, channel-major as in x, by 16-byte cp.async, zero-filled
//     outside the image.  Where a row of x is not 16-byte aligned (W %
//     8 != 0, or x not 16-byte aligned) the same kernel fills it with
//     2-byte loads instead: slower, the same arithmetic.
//   - The kx shift: a tap moves the band by one pixel, 2 bytes, which
//     an ldmatrix row address (16-byte aligned) cannot do in a
//     channel-major band.  So the producers transpose each band once,
//     in shared memory, to pixel-major rows (32 channels, 80 bytes a
//     pixel): ldmatrix of 8 channels x 8 pixels then stmatrix.trans,
//     two instructions a warp for 256 values.  A tap's shift is then a
//     whole pixel row, and each lane's ldmatrix row address moves by
//     80 bytes: aligned for every kx, and 80 bytes (5 x 16) keep any 8
//     consecutive pixels on distinct banks.  (Three kx-shifted copies
//     would take three times the band's shared memory; warp shuffles
//     of the B fragments a shuffle per register per tap.)
//   - 4 consumer warps run the products and write y.  A warp owns 4
//     rows x 16 columns x 32 channels (64 f32 sums a thread).  Per 16
//     input channels and kx it loads the 6 band rows' A fragments once
//     and uses each for the up to 3 ky that read it: 12 ldmatrix.x4 for
//     48 mma.  wmat's rows (co, k contiguous) are the B operand as mma
//     wants it (k pairs per column), read by ldmatrix from a copy with
//     592-byte rows (37 x 16: no bank conflicts).
//   - The write-out: a consumer rounds its sums to bf16 and stores them
//     transposed (stmatrix.trans) into channel-major rows of its own
//     staging buffer, then writes them by 16-byte stores, each (channel,
//     row) 32 contiguous bytes; no barrier across warps.
//
// C interface: a plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"   // cp_async16, ldmatrix_x4, stmatrix_x4_trans, mma_bf16

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 32;             // input and output channels
constexpr int K = 9 * C;          // wmat's columns
constexpr int TH = 4;             // output rows a tile
constexpr int TW = 64;            // output columns a tile
// warp roles: a consumer owns the tile's TH rows x 16 columns x 32
// channels; the producers load and transpose the bands
constexpr int CONSUMERS = 32 * (TW / 16);
constexpr int PRODUCERS = 384;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int BR = TH + 2;        // band rows (1-row halo)
constexpr int BP = TW + 16;       // band columns, from 8 left of the tile
constexpr int NCH = BP / 8;       // 16-byte pieces of a band row
// 8 x 32 pieces of the band a producer warp transposes
constexpr int UNITS = (BR * NCH + PRODUCERS / 32 - 1) / (PRODUCERS / 32);
// channel-major band: a row of BP bf16; a channel's plane BR rows plus
// 16 bytes, an odd multiple of 16, so that 8 consecutive channels
// (ldmatrix rows) fall on distinct banks
constexpr int RAW_CI = BR * BP + 8;          // bf16 a channel
static_assert((BR * NCH) % 2 == 0, "RAW_CI / 8 must be odd");
constexpr int RAW = C * RAW_CI;              // bf16 a band
// pixel-major band: a pixel's 32 channels + 8, 80 bytes
constexpr int OP_PX = C + 8;
constexpr int OP_ROW = BP * OP_PX;           // bf16 a band row
constexpr int OP = BR * OP_ROW;              // bf16 a band
// wmat: 288 + 8 bf16 a row, 592 bytes
constexpr int W_ROW = K + 8;
// a consumer's output, channel-major: (TH, 32) rows of 16 bf16 + 8
// (48 bytes, an odd multiple of 16)
constexpr int Y_ROW = 24;
constexpr int YW = TH * C * Y_ROW;           // bf16 a consumer
// two bands of each kind: the producers fill one while the consumers
// read the other
constexpr int SMEM =
    (2 * RAW + 2 * OP + C * W_ROW + (CONSUMERS / 32) * YW) * (int)sizeof(bf16);
// named barriers (0 is __syncthreads): FULL + b, op band b is ready;
// EMPTY + b, the consumers are done with it; PROD, the producers' own
enum { FULL = 1, EMPTY = 3, PROD = 5 };

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The tile's band, channel-major, into raw, by the producers (p, their
// index): 16-byte cp.async when ALIGNED (zero-filled outside the image),
// one commit group; else 2-byte loads.
template <bool ALIGNED>
__device__ __forceinline__ void load_band(bf16* raw, const bf16* xb, int r0,
                                          int c0, int H, int W, int p) {
  if constexpr (ALIGNED) {
    for (int i = p; i < C * BR * NCH; i += PRODUCERS) {
      const int ci = i / (BR * NCH), rr = (i / NCH) % BR, j = i % NCH;
      const int gr = r0 - 1 + rr, gc = c0 - 8 + 8 * j;
      const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
      const bf16* src = in ? xb + ((size_t)ci * H + gr) * W + gc : xb;
      cp_async16(raw + ci * RAW_CI + rr * BP + 8 * j, src, in);
    }
    cp_async_commit();
  } else {
    for (int i = p; i < C * BR * BP; i += PRODUCERS) {
      const int ci = i / (BR * BP), rr = (i / BP) % BR, q = i % BP;
      const int gr = r0 - 1 + rr, gc = c0 - 8 + q;
      raw[ci * RAW_CI + rr * BP + q] =
          gr >= 0 && gr < H && gc >= 0 && gc < W
              ? xb[((size_t)ci * H + gr) * W + gc]
              : __float2bfloat16(0.f);
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 1)
cmajor_conv_kernel(const bf16* x, const bf16* wmat, bf16* y, int B, int H,
                   int W) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* raw = smem;                    // 2 x C x BR x BP (+ pad), channel-major
  bf16* op = raw + 2 * RAW;            // 2 x BR x BP x OP_PX, pixel-major
  bf16* ws = op + 2 * OP;              // C x W_ROW
  bf16* ys = ws + C * W_ROW;           // per consumer: TH x C x Y_ROW

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  // this block's tiles: blockIdx.x + k gridDim.x for k < n, the columns
  // fastest over the grid, so that neighbouring tiles run at once
  const int n = ntiles > (int)blockIdx.x
                    ? (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
                    : 0;
  auto tile_at = [&](int k, int& bi, int& r0, int& c0) {
    const int t = blockIdx.x + k * gridDim.x;
    c0 = (t % tiles_w) * TW;
    r0 = ((t / tiles_w) % tiles_h) * TH;
    bi = t / (tiles_w * tiles_h);
  };

  for (int i = threadIdx.x; i < C * K; i += THREADS)
    ws[(i / K) * W_ROW + i % K] = wmat[i];
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producers: the band of tile k + 2 loads while tile k is transposed
    // and tile k + 1's products run
    const int p = threadIdx.x - CONSUMERS, pw = p / 32;
    for (int k = 0; k < 2 && k < n; ++k) {
      int bi, r0, c0;
      tile_at(k, bi, r0, c0);
      load_band<ALIGNED>(raw + k * RAW, x + (size_t)bi * C * H * W, r0, c0, H, W, p);
    }
    for (int k = 0; k < n; ++k) {
      const int b = k & 1;
      if constexpr (ALIGNED) {
        if (k + 1 < n)
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        else
          cp_async_wait_all();
      }
      bar_sync(PROD, PRODUCERS);              // raw band b is in
      if (k >= 2) bar_sync(EMPTY + b, THREADS);   // op band b is free
      // transpose: 32 channels x 8 pixels a warp instruction, every
      // load of the warp's pieces before their stores
      const bf16* rb = raw + b * RAW;
      bf16* ob = op + b * OP;
      unsigned f[UNITS][4];
#pragma unroll
      for (int q = 0; q < UNITS; ++q) {
        const int u = pw + q * (PRODUCERS / 32);
        if (u < BR * NCH)
          ldmatrix_x4(f[q], rb + lane * RAW_CI + (u / NCH) * BP + 8 * (u % NCH));
      }
#pragma unroll
      for (int q = 0; q < UNITS; ++q) {
        const int u = pw + q * (PRODUCERS / 32);
        if (u < BR * NCH)
          stmatrix_x4_trans(ob + (u / NCH) * OP_ROW + (8 * (u % NCH) + lane % 8) * OP_PX +
                                8 * (lane / 8),
                            f[q]);
      }
      bar_arrive(FULL + b, THREADS);
      bar_sync(PROD, PRODUCERS);              // raw band b is read
      if (k + 2 < n) {
        int bi, r0, c0;
        tile_at(k + 2, bi, r0, c0);
        load_band<ALIGNED>(raw + b * RAW, x + (size_t)bi * C * H * W, r0, c0, H, W, p);
      }
    }
    return;
  }

  // consumers: warp w owns columns 16 w.. of the tile.  Its ldmatrix
  // rows: A (pixels x input channels), pixel 16 w + lane % 16 of the
  // tile, at tap kx band column that + 7 + kx, channels 8 (lane / 16)
  // on; B (input channels x output channels) from wmat's rows, output
  // channel lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2) on.
  const int a_off = (16 * warp + lane % 16 + 7) * OP_PX + 8 * (lane / 16);
  const bf16* b_lane = ws + (lane % 8 + 8 * (lane / 16)) * W_ROW + 8 * ((lane / 8) % 2);
  bf16* yw = ys + warp * YW;
  for (int k = 0; k < n; ++k) {
    const int b = k & 1;
    int bi, r0, c0;
    tile_at(k, bi, r0, c0);
    bar_sync(FULL + b, THREADS);
    const bf16* a_lane = op + b * OP + a_off;
    float acc[TH][4][4];
#pragma unroll
    for (int r = 0; r < TH; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        unsigned a[BR][4];
#pragma unroll
        for (int rr = 0; rr < BR; ++rr)
          ldmatrix_x4(a[rr], a_lane + rr * OP_ROW + kx * OP_PX + 16 * cb);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          unsigned bf[2][4];
          const bf16* bk = b_lane + (ky * 3 + kx) * C + 16 * cb;
          ldmatrix_x4(bf[0], bk);
          ldmatrix_x4(bf[1], bk + 16 * W_ROW);
#pragma unroll
          for (int r = 0; r < TH; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[r][j], a[r + ky], bf[j / 2][2 * (j % 2)],
                       bf[j / 2][2 * (j % 2) + 1]);
        }
      }
    }
    if (k + 2 < n) bar_arrive(EMPTY + b, THREADS);   // op band b is free

    // the sums as bf16, channel-major, in this warp's buffer: thread t
    // holds pixels t / 4 and t / 4 + 8 of its 16 at channels 2 (t % 4) +
    // {0, 1} of each n8 tile; stmatrix.trans writes them as rows of
    // channels; then 16-byte stores, each (row, channel) 32 bytes
#pragma unroll
    for (int r = 0; r < TH; ++r)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned f[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float* c = acc[r][2 * np + m / 2] + 2 * (m % 2);
          const __nv_bfloat162 v = __floats2bfloat162_rn(c[0], c[1]);
          f[m] = *reinterpret_cast<const unsigned*>(&v);
        }
        const int co = 16 * np + 8 * (lane / 16) + lane % 8;
        stmatrix_x4_trans(yw + (r * C + co) * Y_ROW + 8 * ((lane / 8) % 2), f);
      }
    __syncwarp();
    bf16* yb = y + (size_t)bi * C * H * W;
    const int gc0 = c0 + 16 * warp;
    if constexpr (ALIGNED) {
#pragma unroll
      for (int q = 0; q < TH * C * 2 / 32; ++q) {
        const int i = lane + 32 * q, r = i / (2 * C), co = (i / 2) % C, h = i % 2;
        const int gr = r0 + r, gc = gc0 + 8 * h;
        if (gr < H && gc < W)
          *reinterpret_cast<uint4*>(yb + ((size_t)co * H + gr) * W + gc) =
              *reinterpret_cast<const uint4*>(yw + (r * C + co) * Y_ROW + 8 * h);
      }
    } else {
      for (int i = lane; i < TH * C * 16; i += 32) {
        const int r = i / (C * 16), co = (i / 16) % C, q = i % 16;
        const int gr = r0 + r, gc = gc0 + q;
        if (gr < H && gc < W)
          yb[((size_t)co * H + gr) * W + gc] = yw[(r * C + co) * Y_ROW + q];
      }
    }
    __syncwarp();   // yw is read before the next tile's stmatrix
  }
}

template <bool ALIGNED>
int launch(const bf16* x, const bf16* wmat, bf16* y, int B, int H, int W,
           cudaStream_t stream) {
  static int grid_cap = 0;   // blocks resident on the card at once
  if (grid_cap == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cmajor_conv_kernel<ALIGNED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cmajor_conv_kernel<ALIGNED>, THREADS, SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap = sms * per_sm;
  }
  const long long ntiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(ntiles < grid_cap ? ntiles : grid_cap);
  cmajor_conv_kernel<ALIGNED><<<grid, THREADS, SMEM, stream>>>(x, wmat, y, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (B, 32, H, W) bf16, channel-major; wmat (32, 288) bf16, columns
// ordered (ky, kx, ci).
int probe_cmajor_conv(const void* x, const void* wmat, void* y, int B, int H, int W,
                      void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const bool aligned = W % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  return aligned ? launch<true>((const bf16*)x, (const bf16*)wmat, (bf16*)y, B, H, W,
                                (cudaStream_t)stream)
                 : launch<false>((const bf16*)x, (const bf16*)wmat, (bf16*)y, B, H, W,
                                 (cudaStream_t)stream);
}

}  // extern "C"
