// Winograd F(2x2, 3x3) convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel dddpm_tpu/ops/pallas/winograd.py:
// _winograd_kernel, reached from conv3x3_winograd.
//
// What it computes, on x (B, H, W, Cin) NHWC with H and W even, the
// transformed weights U = G w G^T (16, Cin, Cout) in bf16 (made by the
// wrapper, as the JAX wrapper makes them) and b (Cout) f32:
//   d   = the 4x4 input tile of each 2x2 output tile, in f32, zero
//         outside the image, mish(d) when asked (not rounded)
//   V   = B^T d B (rows, then columns) in f32, rounded to bf16
//   M   = sum over Cin of V * U, per (xi, nu) of the 16, in f32
//   y   = A^T M A + b in f32, rounded to x's type
// The bf16 roundings of V and U are the TPU kernel's (its matrix unit
// takes bf16), kept whatever x's type is.
//
// What bounds it on an H100: Winograd's own products are 8 Cin Cout
// FLOPs a pixel (16 products of Cin x Cout per 2x2 tile).  At 128^2,
// Cin = Cout = 128, B = 8 that is 17.2 GFLOP (17.4 us at the bf16
// tensor-core rate) against 67 MB of x and y in bf16 (20.0 us): the
// bound is bytes there, operations at 64^2 c256.
//
// What this design does about it: as on the TPU, the transformed tiles
// (4x the input's volume, the reason a Winograd built from library
// calls loses to the direct conv) never touch device memory.  A block
// owns an 8 x 16 band of output pixels (4 x 8 Winograd tiles) and 32
// output channels.  Per stage of 16 input channels it stages the band
// with its halo (10 x 18 pixels) and the U slab in shared memory,
// transforms the 32 tiles into V there (one (tile, channel) a thread at
// a time), and runs the 16 products as FMA loops: each thread keeps 16
// f32 sums for 2 tiles x 2 output channels in registers, so the inverse
// transform runs in registers and y is written once.  This first
// version uses no tensor cores: it is simple and exact, not fast.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;             // output rows of a block's band
constexpr int TW = 16;            // output columns of a block's band
constexpr int NTR = TH / 2;       // Winograd tile rows
constexpr int NTC = TW / 2;       // Winograd tile columns
constexpr int TILES = NTR * NTC;  // 32
constexpr int BR = TH + 2;        // band rows with the halo
constexpr int BC = TW + 2;        // band columns with the halo
constexpr int CK = 16;            // input channels per stage
constexpr int CKP = CK + 1;       // padded channel stride of the band
constexpr int CO = 32;            // output channels per block
constexpr int VSTRIDE = 16 * TILES + 2;  // per channel in Vs: even, off 32
constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = BR * BC * CKP + CK * VSTRIDE + CK * 16 * CO;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float mish(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // softplus
  return x * tanhf(sp);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// grid (band tiles, Cout / CO, B); block THREADS.
template <typename T>
__global__ void __launch_bounds__(THREADS)
winograd_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ u,
                const float* __restrict__ bias, T* __restrict__ y, int H, int W,
                int Cin, int Cout, int apply_mish) {
  extern __shared__ float smem[];
  float* band = smem;                       // BR x BC x CKP
  float* vs = band + BR * BC * CKP;         // CK x VSTRIDE: [ci][xi][tile]
  float* us = vs + CK * VSTRIDE;            // CK x 16 x CO: [ci][xi][co]

  const int bands_w = (W + TW - 1) / TW;
  const int r0 = (blockIdx.x / bands_w) * TH;
  const int c0 = (blockIdx.x % bands_w) * TW;
  const int co0 = blockIdx.y * CO;
  const int bi = blockIdx.z;
  const int t = threadIdx.x;
  const int tp = t / 16;           // tiles 2tp, 2tp + 1
  const int cp = t % 16;           // output channels co0 + 2cp, + 1
  const T* xb = x + (size_t)bi * H * W * Cin;

  float acc[16][2][2];
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i) acc[q][i][0] = acc[q][i][1] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
    __syncthreads();
    // the band with its halo, zero outside the image
    for (int idx = t; idx < BR * BC * CK; idx += THREADS) {
      const int ci = idx % CK, p = idx / CK;
      const int gr = r0 - 1 + p / BC, gc = c0 - 1 + p % BC;
      float v = 0.f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        v = to_f(xb[((size_t)gr * W + gc) * Cin + ci0 + ci]);
        if (apply_mish) v = mish(v);
      }
      band[p * CKP + ci] = v;
    }
    // the U slab of this stage and block
    for (int idx = t; idx < 16 * CK * CO; idx += THREADS) {
      const int co = idx % CO, ci = (idx / CO) % CK, xi = idx / (CO * CK);
      us[(ci * 16 + xi) * CO + co] =
          __bfloat162float(u[((size_t)xi * Cin + ci0 + ci) * Cout + co0 + co]);
    }
    __syncthreads();
    // input transform: V = B^T d B for each (tile, channel)
    for (int idx = t; idx < TILES * CK; idx += THREADS) {
      const int ci = idx % CK, tile = idx / CK;
      const int m = tile / NTC, n = tile % NTC;
      float d[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d[i][j] = band[((2 * m + i) * BC + 2 * n + j) * CKP + ci];
      float r[4][4];   // rows first, as the TPU kernel
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[0][j] = d[0][j] - d[2][j];
        r[1][j] = d[1][j] + d[2][j];
        r[2][j] = d[2][j] - d[1][j];
        r[3][j] = d[1][j] - d[3][j];
      }
      float* vt = vs + ci * VSTRIDE + tile;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vt[(i * 4 + 0) * TILES] = bf16_round(r[i][0] - r[i][2]);
        vt[(i * 4 + 1) * TILES] = bf16_round(r[i][1] + r[i][2]);
        vt[(i * 4 + 2) * TILES] = bf16_round(r[i][2] - r[i][1]);
        vt[(i * 4 + 3) * TILES] = bf16_round(r[i][1] - r[i][3]);
      }
    }
    __syncthreads();
    // the 16 products: M[xi](tile, co) += V[xi](tile, ci) U[xi](ci, co)
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
      const float* vrow = vs + ci * VSTRIDE + 2 * tp;
      const float* urow = us + ci * 16 * CO + 2 * cp;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float2 vv = *reinterpret_cast<const float2*>(vrow + q * TILES);
        const float2 uu = *reinterpret_cast<const float2*>(urow + q * CO);
        acc[q][0][0] = fmaf(vv.x, uu.x, acc[q][0][0]);
        acc[q][0][1] = fmaf(vv.x, uu.y, acc[q][0][1]);
        acc[q][1][0] = fmaf(vv.y, uu.x, acc[q][1][0]);
        acc[q][1][1] = fmaf(vv.y, uu.y, acc[q][1][1]);
      }
    }
  }

  // inverse transform in registers: rows (A^T on xi), then columns
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tile = 2 * tp + i;
    const int orow = r0 + 2 * (tile / NTC), ocol = c0 + 2 * (tile % NTC);
    if (orow >= H || ocol >= W) continue;   // H, W even: whole tiles
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int co = co0 + 2 * cp + k;
      float z[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float m0 = acc[j][i][k], m1 = acc[4 + j][i][k];
        const float m2 = acc[8 + j][i][k], m3 = acc[12 + j][i][k];
        z[0][j] = m0 + m1 + m2;
        z[1][j] = m1 - m2 - m3;
      }
      const float bv = bias[co];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float y0 = z[p][0] + z[p][1] + z[p][2];
        const float y1 = z[p][1] - z[p][2] - z[p][3];
        T* yp = y + (((size_t)bi * H + orow + p) * W + ocol) * Cout + co;
        yp[0] = from_f<T>(y0 + bv);
        yp[Cout] = from_f<T>(y1 + bv);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* u, const void* b, void* y, int B, int H,
           int W, int Cin, int Cout, int apply_mish, cudaStream_t stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      winograd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), Cout / CO, B);
  winograd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const __nv_bfloat16*)u, (const float*)b, (T*)y, H, W, Cin,
      Cout, apply_mish);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, Cin) NHWC of dtype with
// H, W even; u (16, Cin, Cout) bf16; b (Cout) f32; y (B, H, W, Cout) of
// dtype.  Cin % 16 == 0, Cout % 32 == 0.
int winograd_conv(const void* x, const void* u, const void* b, void* y, int B,
                  int H, int W, int Cin, int Cout, int apply_mish, int dtype,
                  void* stream) {
  if (H % 2 || W % 2 || Cin % CK || Cout % CO) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, u, b, y, B, H, W, Cin, Cout, apply_mish,
                                 (cudaStream_t)stream);
  return launch<float>(x, u, b, y, B, H, W, Cin, Cout, apply_mish,
                       (cudaStream_t)stream);
}

}  // extern "C"
