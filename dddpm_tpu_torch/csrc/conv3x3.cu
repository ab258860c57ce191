// Fused 3x3 convolution with a GroupNorm-fold / mish prologue for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dddpm_tpu/ops/pallas/conv3x3.py:_conv_kernel,
// reached from conv3x3_fused.
//
// What it computes, on x (B, H, W, Cin) NHWC, w (3, 3, Cin, Cout) HWIO
// of x's type and b (Cout) f32, stride 1:
//   mode 0:  a = x
//   mode 1:  a = round(mish(x))                               (f32 mish)
//   mode 2:  a = round(mish(x * scale + shift))               per (b, ci)
//   mode 3:  a = round(round(mish(x * scale + shift)) + post_bias)
//   y = round(conv3x3(a, w) + b), f32 sums; round() is to x's type.
// SAME padding is zero in operand space, after the prologue: a is zero
// outside the image, not prologue(0) (mish(shift) is not zero).
//
// What bounds it on an H100: 2 * 9 * Cin * Cout FLOPs a pixel.  At 128^2,
// Cin = Cout = 128, B = 8 that is 38.7 GFLOP, 39.1 us at the bf16
// tensor-core rate, against 67 MB of x and y in bf16 (20 us): the bound
// is operations at all three x2 seam shapes.
//
// What this design does about it: the prologue rides the operand load,
// so the normalised, activated tensor never makes a round trip through
// device memory (the point of the TPU kernel).  A block owns an 8 x 16
// band of output pixels and 64 output channels.  Per stage of 32 input
// channels it stages prologue(x) on the band with its 1-pixel halo
// (10 x 18 pixels, zero outside the image) and the 9 x 32 x 64 weight
// slab in shared memory as f32, then runs the 9 taps as FMA loops: each
// thread holds 8 pixels (one band column) x 4 output channels, reads a
// column of 10 band values once per horizontal tap and reuses it over
// the three vertical taps.  Each output pixel is written once.  No
// tensor cores yet: this first version is simple and exact, not fast.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;          // output rows of a block's band
constexpr int TW = 16;         // output columns of a block's band
constexpr int BR = TH + 2;     // band rows with the halo
constexpr int BC = TW + 2;     // band columns with the halo
constexpr int CK = 32;         // input channels per stage
constexpr int CKP = CK + 1;    // padded channel stride of the band
constexpr int CO = 64;         // output channels per block
constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = BR * BC * CKP + 9 * CK * CO;

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

__device__ __forceinline__ float mish(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // softplus
  return x * tanhf(sp);
}

// grid (band tiles, Cout / CO, B); block THREADS.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ scale,
               const float* __restrict__ shift, const float* __restrict__ pbias,
               T* __restrict__ y, int H, int W, int Cin, int Cout, int mode) {
  extern __shared__ float smem[];
  float* band = smem;                  // BR x BC x CKP: prologue(x)
  float* ws = band + BR * BC * CKP;    // 9 x CK x CO

  const int bands_w = (W + TW - 1) / TW;
  const int r0 = (blockIdx.x / bands_w) * TH;
  const int c0 = (blockIdx.x % bands_w) * TW;
  const int co0 = blockIdx.y * CO;
  const int bi = blockIdx.z;
  const int t = threadIdx.x;
  const int tx = t % 16;     // output channels co0 + tx + 16 j
  const int ty = t / 16;     // band column; rows 0..7
  const T* xb = x + (size_t)bi * H * W * Cin;

  float acc[TH][4];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
    __syncthreads();
    for (int idx = t; idx < BR * BC * CK; idx += THREADS) {
      const int ci = idx % CK, p = idx / CK;
      const int gr = r0 - 1 + p / BC, gc = c0 - 1 + p % BC;
      float v = 0.f;   // operand-space zero padding
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        v = to_f(xb[((size_t)gr * W + gc) * Cin + ci0 + ci]);
        if (mode == 1) {
          v = rnd<T>(mish(v));
        } else if (mode >= 2) {
          const int bc = bi * Cin + ci0 + ci;
          // multiply, then add, each rounded (no fused multiply-add), as
          // the plain version computes it
          v = rnd<T>(mish(__fadd_rn(__fmul_rn(v, scale[bc]), shift[bc])));
          if (mode == 3) v = rnd<T>(v + pbias[bc]);
        }
      }
      band[p * CKP + ci] = v;
    }
    for (int idx = t; idx < 9 * CK * CO; idx += THREADS) {
      const int co = idx % CO, ci = (idx / CO) % CK, tap = idx / (CO * CK);
      ws[idx] = to_f(w[((size_t)tap * Cin + ci0 + ci) * Cout + co0 + co]);
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float r[BR];
#pragma unroll
        for (int rr = 0; rr < BR; ++rr) r[rr] = band[(rr * BC + ty + dx) * CKP + ci];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* wrow = ws + ((dy * 3 + dx) * CK + ci) * CO + tx;
          float wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = wrow[16 * j];
#pragma unroll
          for (int i = 0; i < TH; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(r[i + dy], wv[j], acc[i][j]);
        }
      }
    }
  }

  const int col = c0 + ty;
  if (col >= W) return;
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int row = r0 + i;
    if (row >= H) break;
    T* yp = y + (((size_t)bi * H + row) * W + col) * Cout + co0 + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) yp[16 * j] = from_f<T>(acc[i][j] + bias[co0 + tx + 16 * j]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, const void* scale,
           const void* shift, const void* pbias, void* y, int B, int H, int W,
           int Cin, int Cout, int mode, cudaStream_t stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), Cout / CO, B);
  conv3x3_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w, (const float*)b, (const float*)scale,
      (const float*)shift, (const float*)pbias, (T*)y, H, W, Cin, Cout, mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, Cin) and w (3, 3, Cin,
// Cout) of dtype; b (Cout) f32; scale, shift, pbias (B, Cin) f32, read
// from mode 2 (scale, shift) and 3 (all three) on; y (B, H, W, Cout) of
// dtype.  Cin % 32 == 0, Cout % 64 == 0.
int conv3x3_fused(const void* x, const void* w, const void* b, const void* scale,
                  const void* shift, const void* pbias, void* y, int B, int H,
                  int W, int Cin, int Cout, int mode, int dtype, void* stream) {
  if (Cin % CK || Cout % CO || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  if (mode >= 2 && (!scale || !shift)) return (int)cudaErrorInvalidValue;
  if (mode == 3 && !pbias) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, scale, shift, pbias, y, B, H, W, Cin,
                                 Cout, mode, (cudaStream_t)stream);
  return launch<float>(x, w, b, scale, shift, pbias, y, B, H, W, Cin, Cout, mode,
                       (cudaStream_t)stream);
}

}  // extern "C"
