// W8A8 3x3 convolution for Hopper (sm_90a) on the s8 tensor cores
// (mma.sync m16n8k32, s8 operands, s32 sums): Q1.
//
// Replaces the product that dddpm_tpu/ops/quant.py:int8_conv (lines
// 93-106) leaves to XLA: lax.conv_general_dilated on s8 operands with
// preferred_element_type=int32, together with the quantize before it and
// the dequantize after it.  That is not a Pallas kernel, but PyTorch has
// no s8 x s8 -> s32 convolution on a CUDA tensor, so the port writes it.
//
// What it computes, on x (B, H, W, Cin) NHWC in f32 or bf16, taps (9,
// Cout, Cin) s8 (tap-major, input channels contiguous), ws (Cout) f32 and
// amax, a device pointer to one f32, stride 1, SAME:
//   xs  = max(amax, 1e-12) / 127
//   xq  = clamp(round_half_even(x / xs), -127, 127)     IEEE division
//   acc = conv3x3(xq, taps)                             exact s32 sums
//   y   = float(acc) * (xs * ws[c])                     the product first
// With a skip operand (the UNet's concat-free skip connection: the same
// shape as x, its own taps, ws and amax) its y_s is formed the same way
// and y = y + y_s in f32.  Then y is rounded to x's type once, and an
// optional bias (Cout, f32) is rounded to x's type and added, rounded
// again: the order of ops/quant.py:plain and of the JAX module.  Every
// step is a correctly rounded IEEE operation (__fdiv_rn, __fmul_rn,
// __fadd_rn: never contracted into an FMA), and integer sums do not
// depend on their order, so the kernel equals its plain version bit for
// bit.  SAME padding is a zero in s8.
//
// What bounds it on an H100: 2 * 9 * Cin * Cout s8 operations a pixel,
// against reading x once in its type and writing y once.  At 128^2, C =
// 128, B = 8 in bf16 that is 38.7 GOP (19.5 us at the 1979 TOP/s s8
// peak) against 67 MB (20.0 us at 3.35 TB/s): the two bounds are equal
// there; at C = 256 operations bound it.
//
// What this design does about it (a simple kernel, first right): an
// implicit GEMM, M = a block's 8 x 16 band of output pixels, N = 64 or
// 128 output channels, K = 9 taps x Cin.  The block quantizes its input
// band (10 x 18 pixels with the halo, every input channel) into shared
// memory once per operand, as s8, so x is read about 1.4 times and
// quantized once a read; the 9 taps are then constant offsets into that
// band (ldmatrix takes each lane's pixel address), and nothing is built
// as im2col.  The s8 weights stream through a 4-deep ring of (tap, 32
// input channel) slabs by cp.async.  8 warps: 4 own two output rows
// (two m16 tiles) each, 2 own half of the block's output channels.  Band
// pixels are Cin + 16 bytes apart and slab rows 48 bytes apart, so each
// ldmatrix's 8 rows fall on distinct banks.  Where a launch with 128
// channels a block would give fewer than two blocks an SM, the blocks
// take 64.  Not done: wgmma, TMA, a persistent grid, overlapping the
// band's quantize with the products.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8_sm90.cuh"  // mma_s8, quantize_s8, pack_s8x4
#include "mma_sm90.cuh"     // cp_async16, ldmatrix_x4

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;            // output band: 8 rows x 16 columns
constexpr int BR = TH + 2, BC = TW + 2;   // with the halo: 10 x 18 pixels
constexpr int KC = 32;                    // input channels a slab: one k32 step
constexpr int WSTRIDE = KC + 16;          // bytes a slab row
constexpr int NSTAGE = 4;                 // slabs in flight
constexpr int THREADS = 256;              // 8 warps: 4 (rows) x 2 (channels)
constexpr int SMEM_MAX = 227 * 1024;

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

__device__ __forceinline__ void store2(float* p, float a, float b,
                                       const float* bias) {
  if (bias) {
    a = __fadd_rn(a, bias[0]);
    b = __fadd_rn(b, bias[1]);
  }
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b,
                                       const float* bias) {
  bf16 ra = __float2bfloat16_rn(a), rb = __float2bfloat16_rn(b);
  if (bias) {
    ra = __float2bfloat16_rn(__fadd_rn(
        __bfloat162float(ra), __bfloat162float(__float2bfloat16_rn(bias[0]))));
    rb = __float2bfloat16_rn(__fadd_rn(
        __bfloat162float(rb), __bfloat162float(__float2bfloat16_rn(bias[1]))));
  }
  __nv_bfloat162 v;
  v.x = ra;
  v.y = rb;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

struct Operand {
  const void* x;
  const int8_t* taps;
  const float* ws;
  const float* amax;
};

struct Args {
  Operand op[2];
  const float* bias;
  void* y;
  int B, H, W, Cin, Cout;
};

// WN output channels a warp (BN = 2 WN a block); NOPS operands (1, or 2
// with the skip operand)
template <typename T, int WN, int NOPS>
__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const Args args) {
  constexpr int BN = 2 * WN, NT = WN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = args.H, W = args.W, Cin = args.Cin, Cout = args.Cout;
  const int pstride = Cin + 16;             // bytes a band pixel
  unsigned char* band = smem;
  unsigned char* slabs = smem + BR * BC * pstride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int ntw = (W + TW - 1) / TW, nth = (H + TH - 1) / TH;
  const int tile = blockIdx.x;
  const int b = tile / (nth * ntw);
  const int h0 = ((tile / ntw) % nth) * TH, w0 = (tile % ntw) * TW;
  const int n0 = blockIdx.y * BN;
  const int nchunks = Cin / KC, nstages = 9 * nchunks;

  float y[2][NT][4];
  int acc[2][NT][4];

#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
    const Operand op = args.op[o];
    const T* x = static_cast<const T*>(op.x);
    const float xs = __fdiv_rn(fmaxf(__ldg(op.amax), 1e-12f), 127.0f);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][nt][i] = 0;

    // every warp is done with the last operand's band and slabs
    __syncthreads();

    auto load_slab = [&](int s) {
      if (s < nstages) {
        const int tap = s / nchunks, chunk = s - tap * nchunks;
        unsigned char* dst = slabs + (s % NSTAGE) * BN * WSTRIDE;
        for (int i = tid; i < BN * 2; i += THREADS) {
          const int row = i >> 1, half = i & 1, n = n0 + row;
          const int8_t* src = op.taps + ((size_t)tap * Cout + (n < Cout ? n : 0)) * Cin +
                              chunk * KC + half * 16;
          cp_async16(dst + row * WSTRIDE + half * 16, src, n < Cout);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) load_slab(s);

    // the input band, quantized as it is loaded; zero outside the image
    const int c8n = Cin / 8;
    for (int i = tid; i < BR * BC * c8n; i += THREADS) {
      const int pix = i / c8n, c8 = i - pix * c8n;
      const int r = pix / BC, c = pix - r * BC;
      const int ih = h0 - 1 + r, iw = w0 - 1 + c;
      uint2 packed = make_uint2(0u, 0u);
      if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
        float v[8];
        load8(x + (((size_t)b * H + ih) * W + iw) * Cin + c8 * 8, v);
        packed.x = pack_s8x4(quantize_s8(v[0], xs), quantize_s8(v[1], xs),
                             quantize_s8(v[2], xs), quantize_s8(v[3], xs));
        packed.y = pack_s8x4(quantize_s8(v[4], xs), quantize_s8(v[5], xs),
                             quantize_s8(v[6], xs), quantize_s8(v[7], xs));
      }
      *reinterpret_cast<uint2*>(band + pix * pstride + c8 * 8) = packed;
    }

    // lane offsets: A rows of an m16 tile, B rows of two n8 tiles
    const int a_col = (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 16 * (lane >> 4);
    const int b_row = wn * WN + (lane & 7) + 8 * (lane >> 4);
    const int b_k = 16 * ((lane >> 3) & 1);

    for (int s = 0; s < nstages; ++s) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 2) : "memory");
      // slab s (and, at s == 0, the band) is in; every warp is done with
      // slab s - 1, whose buffer the next load takes
      __syncthreads();
      load_slab(s + NSTAGE - 1);

      const int tap = s / nchunks, chunk = s - tap * nchunks;
      const int dy = tap / 3, dx = tap - dy * 3;
      const unsigned char* slab = slabs + (s % NSTAGE) * BN * WSTRIDE;
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int pix = (2 * wm + mi + dy) * BC + a_col + dx;
        ldmatrix_x4(a[mi], band + pix * pstride + chunk * KC + a_k);
      }
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        unsigned bf[4];
        ldmatrix_x4(bf, slab + (b_row + nj * 16) * WSTRIDE + b_k);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][2 * nj], a[mi], bf[0], bf[1]);
          mma_s8(acc[mi][2 * nj + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
    cp_async_wait_all();

    // dequantize: float(acc) * (xs * ws[c]); the skip operand's is added
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + wn * WN + nt * 8 + tig * 2;
      float sc[2] = {0.f, 0.f};
      if (n < Cout) {
        sc[0] = __fmul_rn(xs, __ldg(op.ws + n));
        sc[1] = __fmul_rn(xs, __ldg(op.ws + n + 1));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = __fmul_rn(__int2float_rn(acc[mi][nt][i]), sc[i & 1]);
          y[mi][nt][i] = o == 0 ? v : __fadd_rn(y[mi][nt][i], v);
        }
    }
  }

  T* out = static_cast<T*>(args.y);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int oh = h0 + 2 * wm + mi;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + g + 8 * half;
      if (oh >= H || ow >= W) continue;
      T* row = out + (((size_t)b * H + oh) * W + ow) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * WN + nt * 8 + tig * 2;
        if (n < Cout)
          store2(row + n, y[mi][nt][2 * half], y[mi][nt][2 * half + 1],
                 args.bias ? args.bias + n : nullptr);
      }
    }
  }
}

template <typename T, int WN, int NOPS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BN = 2 * WN;
  const int smem = BR * BC * (a.Cin + 16) + NSTAGE * BN * WSTRIDE;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = int8_conv_kernel<T, WN, NOPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  const dim3 grid(tiles, (a.Cout + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NOPS>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long tiles = (long)a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  // 128 channels a block unless that leaves fewer than two blocks an SM
  if (tiles * ((a.Cout + 127) / 128) >= 2L * sms) return launch<T, 64, NOPS>(a, stream);
  return launch<T, 32, NOPS>(a, stream);
}

}  // namespace

extern "C" int int8_conv(const void* x, const void* taps, const void* ws,
                         const void* amax, const void* skip,
                         const void* taps_s, const void* ws_s,
                         const void* amax_s, const void* bias, void* y,
                         int B, int H, int W, int Cin, int Cout, int dtype,
                         void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < KC || Cin % KC || Cout < 64 ||
      Cout % 64 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.op[0] = {x, static_cast<const int8_t*>(taps),
             static_cast<const float*>(ws), static_cast<const float*>(amax)};
  a.op[1] = {skip, static_cast<const int8_t*>(taps_s),
             static_cast<const float*>(ws_s), static_cast<const float*>(amax_s)};
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two = skip != nullptr;
  cudaError_t err;
  if (dtype == 1)
    err = two ? dispatch<bf16, 2>(a, s) : dispatch<bf16, 1>(a, s);
  else
    err = two ? dispatch<float, 2>(a, s) : dispatch<float, 1>(a, s);
  return (int)err;
}
