// Channel-major 3x3 conv for Hopper (sm_90a): does a channel-major
// layout suit a 32-channel 3x3 conv?
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
// at the bf16 peak): the bytes.
//
// What this design does about it: a simple FMA kernel, not a fast one.
// A block takes TH x TW output pixels of one sample.  It stages the
// input band with its 1-pixel halo (zero outside the image) for all 32
// channels as bf16, and wmat transposed to (9 * 32, 32) in f32, in
// shared memory; x rows are read with neighbouring threads on
// neighbouring columns, which channel-major makes contiguous.  A thread
// owns one column and two rows and sums all 32 output channels (64 f32
// accumulators): per input value pair it reads 8 float4 weights, which
// every thread of the warp shares, for 64 FMAs.  y is written a channel
// plane at a time, again contiguous across the warp.
//
// C interface: a plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 32;             // input and output channels
constexpr int TW = 64;            // output columns a tile: one thread each
constexpr int TH = 8;             // output rows a tile
constexpr int RPT = 2;            // rows a thread
constexpr int THREADS = TW * TH / RPT;
constexpr int XW = TW + 2, XH = TH + 2;   // staged band with its halo

__global__ void __launch_bounds__(THREADS)
cmajor_conv_kernel(const bf16* x, const bf16* wmat, bf16* y, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                                     // 9*C x C: wt[k][co]
  bf16* xs = reinterpret_cast<bf16*>(wt + 9 * C * C);   // C x XH x XW

  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH, bi = blockIdx.z;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const bf16* xb = x + (size_t)bi * C * H * W;

  for (int i = threadIdx.x; i < 9 * C * C; i += THREADS) {
    const int co = i / (9 * C), k = i % (9 * C);
    wt[k * C + co] = __bfloat162float(wmat[i]);
  }
  for (int i = threadIdx.x; i < C * XH * XW; i += THREADS) {
    const int ci = i / (XH * XW), rr = (i / XW) % XH, cc = i % XW;
    const int gr = r0 - 1 + rr, gc = c0 - 1 + cc;
    xs[i] = gr >= 0 && gr < H && gc >= 0 && gc < W
                ? xb[((size_t)ci * H + gr) * W + gc]
                : __float2bfloat16(0.f);
  }
  __syncthreads();

  float acc[RPT][C];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int co = 0; co < C; ++co) acc[r][co] = 0.f;
  for (int ci = 0; ci < C; ++ci) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int ky = t / 3, kx = t % 3;
      float xv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        xv[r] = __bfloat162float(xs[(ci * XH + ty * RPT + r + ky) * XW + tx + kx]);
      const float4* wk = reinterpret_cast<const float4*>(wt + (t * C + ci) * C);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 w4 = wk[q];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[r][4 * q] = fmaf(xv[r], w4.x, acc[r][4 * q]);
          acc[r][4 * q + 1] = fmaf(xv[r], w4.y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(xv[r], w4.z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(xv[r], w4.w, acc[r][4 * q + 3]);
        }
      }
    }
  }
  const int gc = c0 + tx;
  if (gc >= W) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gr = r0 + ty * RPT + r;
    if (gr >= H) continue;
#pragma unroll
    for (int co = 0; co < C; ++co)
      y[(((size_t)bi * C + co) * H + gr) * W + gc] = __float2bfloat16(acc[r][co]);
  }
}

}  // namespace

extern "C" {

// x, y (B, 32, H, W) bf16, channel-major; wmat (32, 288) bf16, columns
// ordered (ky, kx, ci).
int probe_cmajor_conv(const void* x, const void* wmat, void* y, int B, int H, int W,
                      void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int smem = 9 * C * C * (int)sizeof(float) + C * XH * XW * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      cmajor_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cmajor_conv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wmat, (bf16*)y, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
