// Winograd F(2x2, 3x3) convolution for Hopper (sm_90a), its 16 products
// on the tensor cores (mma.sync, bf16 operands, f32 accumulators).
//
// Replaces the TPU kernel dddpm_tpu/ops/pallas/winograd.py:
// _winograd_kernel, reached from conv3x3_winograd.
//
// What it computes, on x (B, H, W, Cin) NHWC with H and W even, the
// transformed weights U = G w G^T (16, Cin, Cout) in bf16 (made per call
// by weights_kernel below, as the JAX wrapper makes them per call) and b
// (Cout) f32:
//   d   = the 4x4 input tile of each 2x2 output tile, in f32, zero
//         outside the image, mish(d) when asked (not rounded)
//   V   = B^T d B (rows, then columns) in f32, rounded to bf16
//   M   = sum over Cin of V * U, per (xi, nu) of the 16, in f32
//   y   = A^T M A + b in f32, rounded to x's type
// The bf16 roundings of V and U are the TPU kernel's (its matrix unit
// takes bf16), kept whatever x's type is.  They are exactly what a bf16
// mma with f32 accumulators takes, so only the order of the f32 sums
// differs from the plain version.
//
// What bounds it on an H100: Winograd's own products are 8 Cin Cout
// FLOPs a pixel (16 products of Cin x Cout per 2x2 tile).  At 128^2,
// Cin = Cout = 128, B = 8 that is 17.2 GFLOP (17.4 us at the bf16
// tensor-core rate) against 67 MB of x and y in bf16 (20.0 us): the
// bound is bytes there, operations at 64^2 c256.  Beside the products a
// block pays (b) the input transform, ~150 instructions per (tile,
// channel pair), amortised over the block's output channels, and (c) the
// U slab it reads from L2 per stage, amortised over its tiles.  Both
// want a large block, and the accumulators cap it: 16 f32 per (tile,
// output channel) if all 16 products stay in registers.
//
// What this design does about it: as on the TPU, the transformed tiles
// (4x the input's volume, the reason a Winograd built from library
// calls loses to the direct conv) never touch device memory.  A block of
// 16 warps owns NTR x NTC Winograd tiles (a 2NTR x 2NTC band of output
// pixels) and CO output channels, 64 x 64.  Warp w takes the
// products of one row xi = w / 4 of the 4 x 4 (xi, nu) grid for a warp
// tile of 32 tiles x 32 channels, and folds the columns of the output
// transform A^T M A into its accumulators as it goes (Z0 = M0 + M1 + M2,
// Z1 = M1 - M2 - M3 over nu: 6 mma for 4 products, a minus sign by
// flipping the sign bits of V's bf16 fragment, which is exact).  So a
// thread holds 64 f32 sums, not 128, and the block is 4x the tiles x
// channels that 16 sums each would allow.  At the end rows 1 and 2 of
// xi hand their sums to rows 0 and 3 through shared memory, which finish
// A^T over xi and write y once.  Per stage of CK = 16 input channels
// (one mma k step), with one barrier:
//   - cp.async brings U(s + 1) and the raw band of stage s + 2 with its
//     halo (zero-filled outside the image), double-buffered;
//   - the threads transform stage s + 1's band into V(s + 1), bf16, in
//     an [xi][tile][channel] layout whose 32-byte rows are swizzled so
//     that the 8 rows of each ldmatrix fall on distinct banks (mish
//     first, once per band element into an f32 copy, when asked);
//   - each warp runs stage s's products: 4 x (2 ldmatrix.x4 of V, 2
//     ldmatrix.x4.trans of U, 12 mma.sync.m16n8k16), 48 mma in all.
// Making V(s + 1) and the products of s between the same two barriers
// lets warps overlap the transform (ALU, shared loads) with the products
// (tensor cores).
//
// WINOGRAD_SKIP (a -D define, 0 by default) compiles parts of the stage
// loop out, by bit: 1 the products, 2 the next stage's transform, 4 the
// loads of the stages after the first.  Only the ablation probe
// (probes/winograd_ablation.py) sets it; its kernels compute garbage.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"   // cp_async16, ldmatrix_x4(_trans), mma_bf16

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CK = 16;               // input channels per stage
constexpr int THREADS = 512;         // 16 warps: 4 rows of (xi, nu) x 4
constexpr int FB_STRIDE = CK + 8;    // floats a pixel in the f32 band
#ifndef WINOGRAD_SKIP
#define WINOGRAD_SKIP 0
#endif
constexpr int SKIP = WINOGRAD_SKIP;

// V[xi][tile][ci] in shared memory: 32-byte rows, their two 16-byte
// halves swapped in rows 4-7 of every 8, so that the 8 rows of each
// ldmatrix fall on distinct banks
__device__ __forceinline__ int v_offset(int row, int ci) {
  return row * CK + (((ci >> 3) ^ ((row >> 2) & 1)) << 3) + (ci & 7);
}

// elements a pixel in the raw band: rows of 48 bytes (bf16) or 80 (f32),
// so that the transform's loads spread over the banks
template <typename T>
__host__ __device__ constexpr int raw_stride() {
  return sizeof(T) == 2 ? CK + 8 : CK + 4;
}

// A block's shape: NTR x NTC Winograd tiles and CO output channels, in
// warp tiles of 32 tiles x 32 channels, WM x WN of them per xi row.
template <int NTR_, int NTC_, int CO_>
struct Shape {
  static constexpr int NTR = NTR_, NTC = NTC_, CO = CO_;
  static constexpr int NT = NTR * NTC;                      // tiles
  static constexpr int BR = 2 * NTR + 2, BC = 2 * NTC + 2;  // band + halo
  static constexpr int WM = NT / 32, WN = CO / 32;          // warps a row
  static constexpr int U_STRIDE = CO + 8;                   // bf16 a U row
  static_assert(WM * WN == THREADS / 128, "4 warps of 32 tiles x 32 co");
  template <typename T>
  __host__ __device__ static constexpr int raw_bytes() {
    return BR * BC * raw_stride<T>() * (int)sizeof(T);
  }
  static constexpr int U_BYTES = 16 * CK * U_STRIDE * 2;
  static constexpr int FB_BYTES = BR * BC * FB_STRIDE * 4;
  static constexpr int V_BYTES = 16 * NT * CK * 2;
  template <typename T>
  __host__ __device__ static constexpr int smem() {
    return 2 * (raw_bytes<T>() + U_BYTES + V_BYTES) + FB_BYTES;
  }
  static_assert(smem<float>() <= 227 * 1024, "one block an SM");
  // the rows-1-and-2 hand-over at the end: 8 warps x 32 lanes x 64 f32
  static_assert(smem<bf16>() >= 8 * 32 * 64 * 4, "hand-over fits");
};

__device__ __forceinline__ float mish(float x) {
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // softplus
  return x * tanhf(sp);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// V = B^T d B for the block's (tile, channel pair) items from a band of
// `stride` elements a pixel: rows, then columns, in f32, rounded to bf16
template <typename S, typename E>
__device__ __forceinline__ void input_transform(const E* band, int stride,
                                                bf16* vs, int t) {
  for (int idx = t; idx < S::NT * (CK / 2); idx += THREADS) {
    const int c2 = idx % (CK / 2), m = idx / (CK / 2);
    const int tr = m / S::NTC, tc = m % S::NTC;
    const E* d0 = band + ((2 * tr) * S::BC + 2 * tc) * stride + 2 * c2;
    float2 r[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 e0 = load2(d0 + (0 * S::BC + j) * stride);
      const float2 e1 = load2(d0 + (1 * S::BC + j) * stride);
      const float2 e2 = load2(d0 + (2 * S::BC + j) * stride);
      const float2 e3 = load2(d0 + (3 * S::BC + j) * stride);
      r[0][j] = make_float2(e0.x - e2.x, e0.y - e2.y);
      r[1][j] = make_float2(e1.x + e2.x, e1.y + e2.y);
      r[2][j] = make_float2(e2.x - e1.x, e2.y - e1.y);
      r[3][j] = make_float2(e1.x - e3.x, e1.y - e3.y);
    }
    bf16* vt = vs + v_offset(m, 2 * c2);   // xi adds NT rows: same swizzle
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = r[i][0], b = r[i][1], c = r[i][2], d = r[i][3];
      store2(vt + (i * 4 + 0) * S::NT * CK, a.x - c.x, a.y - c.y);
      store2(vt + (i * 4 + 1) * S::NT * CK, b.x + c.x, b.y + c.y);
      store2(vt + (i * 4 + 2) * S::NT * CK, c.x - b.x, c.y - b.y);
      store2(vt + (i * 4 + 3) * S::NT * CK, b.x - d.x, b.y - d.y);
    }
  }
}

// grid (bands x Cout chunks, B); block THREADS.  The chunks of one band
// are neighbours in the grid, so its band is read from HBM about once.
//
// Warp w works on the (xi, nu) row xi = w / 4 (4 of the 16 products) for
// a warp tile of 32 tiles x 32 output channels, and folds the columns of
// the output transform into its accumulators as it goes:
//   Z0 = M[xi][0] + M[xi][1] + M[xi][2],  Z1 = M[xi][1] - M[xi][2] - M[xi][3]
// (6 mma for 4 products, the minus signs by negating V's bf16 fragment,
// which is exact), so a thread holds 2 x 32 f32 sums instead of 4 x 32.
// At the end rows 1 and 2 hand their Z to rows 0 and 3, which finish
// A^T over xi (y row 0 = Z[0] + Z[1] + Z[2], y row 1 = Z[1] - Z[2] - Z[3]).
template <typename S, typename T>
__global__ void __launch_bounds__(THREADS, 1)
winograd_kernel(const T* __restrict__ x, const bf16* __restrict__ u,
                const float* __restrict__ bias, T* __restrict__ y, int H,
                int W, int Cin, int Cout, int apply_mish) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RAW = S::template raw_bytes<T>();
  constexpr int RS = raw_stride<T>();
  unsigned char* const raw0 = smem;                         // 2 x RAW
  bf16* const us0 = reinterpret_cast<bf16*>(smem + 2 * RAW);   // 2 x U
  bf16* const vs0 = reinterpret_cast<bf16*>(          // 2 x V
      smem + 2 * RAW + 2 * S::U_BYTES);
  float* const fband = reinterpret_cast<float*>(
      smem + 2 * RAW + 2 * S::U_BYTES + 2 * S::V_BYTES);

  const int nco = (Cout + S::CO - 1) / S::CO;
  const int bands_w = (W + 2 * S::NTC - 1) / (2 * S::NTC);
  const int co0 = (blockIdx.x % nco) * S::CO;
  const int band = blockIdx.x / nco;
  const int r0 = (band / bands_w) * 2 * S::NTR;
  const int c0 = (band % bands_w) * 2 * S::NTC;
  const int bi = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int xr = warp >> 2, wq = warp & 3;   // xi row, warp tile
  const int wm = wq % S::WM, wn = wq / S::WM;
  const T* xb = x + (size_t)bi * H * W * Cin;

  // this thread's cp.async chunks, fixed over the stages: band chunk k
  // is pixel (t + k THREADS) / CH, its element offset from xb at input
  // channel 0 in boff[k] (-1 outside the image: zero-filled)
  constexpr int CH = CK * (int)sizeof(T) / 16;       // 16-byte chunks a pixel
  constexpr int NBAND = S::BR * S::BC * CH;
  constexpr int NB = (NBAND + THREADS - 1) / THREADS;
  int boff[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int idx = t + k * THREADS, p = idx / CH;
    const int gr = r0 - 1 + p / S::BC, gc = c0 - 1 + p % S::BC;
    const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
    boff[k] = in ? (gr * W + gc) * Cin + (idx % CH) * (16 / (int)sizeof(T)) : -1;
  }
  // U chunk k: row (xi, ci) = t / UCH + k UROWS of the slab, 8 channels
  constexpr int UCH = S::CO / 8;                     // chunks a U row
  constexpr int UROWS = THREADS / UCH;               // rows a pass
  constexpr int NU = 16 * CK / UROWS;
  static_assert(UROWS % CK == 0 && NU >= 1, "a pass covers whole xi");
  const int urow = t / UCH, uch = t % UCH;
  const bool uok = co0 + uch * 8 < Cout;
  const bf16* ubase =
      u + ((size_t)(urow / CK) * Cin + urow % CK) * Cout + co0 + uch * 8;
  const size_t ustep = (size_t)(UROWS / CK) * Cin * Cout;

  auto load_band = [&](int ci0, int buf) {
    unsigned char* raw = raw0 + buf * RAW;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int idx = t + k * THREADS;
      if (NBAND % THREADS == 0 || idx < NBAND)
        cp_async16(raw + ((idx / CH) * RS + (idx % CH) * (16 / (int)sizeof(T))) *
                             (int)sizeof(T),
                   boff[k] >= 0 ? xb + boff[k] + ci0 : xb, boff[k] >= 0);
    }
  };
  auto load_u = [&](int ci0, int buf) {
    bf16* us = us0 + buf * (S::U_BYTES / 2) + urow * S::U_STRIDE + uch * 8;
    const bf16* src = ubase + (size_t)ci0 * Cout;
#pragma unroll
    for (int k = 0; k < NU; ++k)
      cp_async16(us + k * UROWS * S::U_STRIDE, uok ? src + k * ustep : u, uok);
  };
  // stage s's V from its band (buffer s & 1), mish first when asked
  auto transform = [&](int s) {
    const T* rb = reinterpret_cast<const T*>(raw0 + (s & 1) * RAW);
    bf16* vs = vs0 + (s & 1) * (S::V_BYTES / 2);
    if (apply_mish) {
      for (int idx = t; idx < S::BR * S::BC * (CK / 2); idx += THREADS) {
        const int p = idx / (CK / 2), c2 = idx % (CK / 2);
        const float2 v = load2(rb + p * RS + 2 * c2);
        *reinterpret_cast<float2*>(fband + p * FB_STRIDE + 2 * c2) =
            make_float2(mish(v.x), mish(v.y));
      }
      __syncthreads();
      input_transform<S>(fband, FB_STRIDE, vs, t);
    } else {
      input_transform<S>(rb, RS, vs, t);
    }
  };

  // acc[z][mi][ni][e]: Z_z of tile wm*32 + 16mi + g (+8 for e >= 2),
  // channel co0 + wn*32 + 8ni + 2tq + (e & 1)
  float acc[2][2][4][4];
#pragma unroll
  for (int z = 0; z < 2; ++z)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[z][mi][ni][e] = 0.f;

  // The pipeline: iteration s runs stage s's products while it makes
  // stage s + 1's V (double-buffered, no barrier between the two, so
  // warps overlap them), and its loads bring U(s + 1) and band(s + 2).
  const int nst = Cin / CK;
  load_band(0, 0);
  load_u(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (nst > 1) load_band(CK, 1);
  cp_async_commit();
  transform(0);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_all();
    __syncthreads();   // V(s), U(s), band(s + 1) ready; iteration s - 1 done
    if (!(SKIP & 4) && s + 2 < nst) load_band((s + 2) * CK, s & 1);
    if (!(SKIP & 4) && s + 1 < nst) load_u((s + 1) * CK, (s + 1) & 1);
    cp_async_commit();
    if (!(SKIP & 2) && s + 1 < nst) transform(s + 1);
    if (SKIP & 1) continue;
    const int buf = s & 1;
    const bf16* vs = vs0 + buf * (S::V_BYTES / 2);

    // the products of row xr: M[xi](tile, co) = V[xi](tile, ci) U[xi](ci, co)
    const bf16* va = vs + v_offset(xr * 4 * S::NT + wm * 32 + (lane & 15),
                                   (lane >> 4) * 8);
    const bf16* vb = us0 + buf * (S::U_BYTES / 2) +
                     (xr * 4 * CK + (lane & 15)) * S::U_STRIDE + wn * 32 +
                     (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], va + (j * S::NT + 16 * mi) * CK);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        ldmatrix_x4_trans(b[nb], vb + j * CK * S::U_STRIDE + 16 * nb);
      if (j < 3) {   // Z0 += M[j]
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[0][mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)],
                     b[ni >> 1][2 * (ni & 1) + 1]);
      }
      if (j > 0) {   // Z1 += M[1] - M[2] - M[3]
        if (j > 1) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int r = 0; r < 4; ++r) a[mi][r] ^= 0x80008000u;
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[1][mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)],
                     b[ni >> 1][2 * (ni & 1) + 1]);
      }
    }
  }

  // rows 1 and 2 hand over their Z (shared memory is free now); rows 0
  // and 3 finish A^T over xi for output row 0 and 1 of every tile
  __syncthreads();
  float* const xch = reinterpret_cast<float*>(smem);
  if (xr == 1 || xr == 2) {
    float* dst = xch + (((xr - 1) * 4 + wq) * 64) * 32 + lane;
#pragma unroll
    for (int z = 0; z < 2; ++z)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[(((z * 2 + mi) * 4 + ni) * 4 + e) * 32] = acc[z][mi][ni][e];
  }
  __syncthreads();
  if (xr == 1 || xr == 2) return;
  const int p = xr == 0 ? 0 : 1;             // output row of the tile
  const float s1 = 1.f, s2 = p ? -1.f : 1.f;  // signs of Z[1], Z[2]
  const float* z1 = xch + (wq * 64) * 32 + lane;
  const float* z2 = xch + ((4 + wq) * 64) * 32 + lane;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = wm * 32 + 16 * mi + g + 8 * hh;
      const int orow = r0 + 2 * (m / S::NTC) + p, ocol = c0 + 2 * (m % S::NTC);
      if (orow >= H || ocol >= W) continue;   // H, W even: whole tiles
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = co0 + wn * 32 + 8 * ni + 2 * tq;
        if (co >= Cout) continue;
        float zz[2][2];   // [column fold][channel]: row p of A^T over xi
#pragma unroll
        for (int z = 0; z < 2; ++z)
#pragma unroll
          for (int ee = 0; ee < 2; ++ee) {
            const int e = 2 * hh + ee;
            const int k = (((z * 2 + mi) * 4 + ni) * 4 + e) * 32;
            // p = 0: Z[0] + Z[1] + Z[2];  p = 1: Z[1] - Z[2] - Z[3]
            zz[z][ee] = p ? s1 * z1[k] + s2 * z2[k] - acc[z][mi][ni][e]
                          : acc[z][mi][ni][e] + s1 * z1[k] + s2 * z2[k];
          }
        const float b0 = bias[co], b1 = bias[co + 1];
        T* yp = y + (((size_t)bi * H + orow) * W + ocol) * Cout + co;
        store2(yp, zz[0][0] + b0, zz[0][1] + b1);
        store2(yp + Cout, zz[1][0] + b0, zz[1][1] + b1);
      }
    }
}

template <typename S, typename T>
int launch(const void* x, const void* u, const void* b, void* y, int B, int H,
           int W, int Cin, int Cout, int apply_mish, cudaStream_t stream) {
  constexpr int smem = S::template smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      winograd_kernel<S, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = ((H + 2 * S::NTR - 1) / (2 * S::NTR)) *
                    ((W + 2 * S::NTC - 1) / (2 * S::NTC));
  const dim3 grid(bands * ((Cout + S::CO - 1) / S::CO), B);
  winograd_kernel<S, T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const bf16*)u, (const float*)b, (T*)y, H, W, Cin, Cout,
      apply_mish);
  return (int)cudaGetLastError();
}

// the tile shape: 64 Winograd tiles (a 16 x 16-pixel band) x 64 output
// channels a block
typedef Shape<8, 8, 64> Tile;

// U = G w G^T per (ci, co), in f32 (G's rows on w's rows first, then on
// its columns, as transform_weights sums them), rounded to bf16.  w (3,
// 3, Cin, Cout) of TW, u (16, Cin, Cout); n = Cin Cout, one thread each.
template <typename TW>
__global__ void weights_kernel(const TW* __restrict__ w, bf16* __restrict__ u,
                               int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t[4][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g0 = load1(w + (0 * 3 + c) * (size_t)n + i);
    const float g1 = load1(w + (1 * 3 + c) * (size_t)n + i);
    const float g2 = load1(w + (2 * 3 + c) * (size_t)n + i);
    t[0][c] = g0;
    t[1][c] = 0.5f * g0 + 0.5f * g1 + 0.5f * g2;
    t[2][c] = 0.5f * g0 - 0.5f * g1 + 0.5f * g2;
    t[3][c] = g2;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    bf16* ur = u + (size_t)(r * 4) * n + i;
    ur[0] = __float2bfloat16(t[r][0]);
    ur[n] = __float2bfloat16(0.5f * t[r][0] + 0.5f * t[r][1] + 0.5f * t[r][2]);
    ur[2 * (size_t)n] =
        __float2bfloat16(0.5f * t[r][0] - 0.5f * t[r][1] + 0.5f * t[r][2]);
    ur[3 * (size_t)n] = __float2bfloat16(t[r][2]);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, Cin) NHWC of dtype with
// H, W even; u (16, Cin, Cout) bf16; b (Cout) f32; y (B, H, W, Cout) of
// dtype.  Cin % 16 == 0, Cout % 32 == 0, H W Cin < 2^31.
int winograd_conv(const void* x, const void* u, const void* b, void* y, int B,
                  int H, int W, int Cin, int Cout, int apply_mish, int dtype,
                  void* stream) {
  if (H % 2 || W % 2 || Cin % CK || Cout % 32) return (int)cudaErrorInvalidValue;
  if ((long long)H * W * Cin >= (1LL << 31))   // offsets are 32-bit
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<Tile, bf16>(x, u, b, y, B, H, W, Cin, Cout, apply_mish,
                              (cudaStream_t)stream);
  return launch<Tile, float>(x, u, b, y, B, H, W, Cin, Cout, apply_mish,
                             (cudaStream_t)stream);
}

// U = G w G^T in bf16 for the entries above: w (3, 3, Cin, Cout) of
// dtype (0 = float32, 1 = bfloat16), u (16, Cin, Cout) bf16.
int winograd_weights(const void* w, void* u, int Cin, int Cout, int dtype,
                     void* stream) {
  const int n = Cin * Cout, threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (n == 0) return 0;
  if (dtype == 1)
    weights_kernel<bf16><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const bf16*)w, (bf16*)u, n);
  else
    weights_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)w, (bf16*)u, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
