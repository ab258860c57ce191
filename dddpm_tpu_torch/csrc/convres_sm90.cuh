// The ConvResBlock kernels' tensor-core helpers (sm_90a): bf16 pairs, the
// activation under CONVRES_SKIP, and a warp's implicit-GEMM pass over m16
// pixel tiles with N = 32 on mma.sync.m16n8k16.  Included by
// convres_fwd.cu (K2), convres_bwd.cu (K3) and probe_convres.cu (P3), so
// that they use one copy.
//
// CONVRES_SKIP (a -D define, 0 by default) compiles parts of a kernel
// out, by bit: 1 the products (mma), 2 mish and mish' (the identity and
// 1); each kernel gives its other bits their own meaning.  Only the
// ablation probes set it; their kernels compute garbage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mish_sm90.cuh"  // mish, mish_dmish (ex2 + rcp)
#include "mma_sm90.cuh"   // ldmatrix_x4(_trans), mma_bf16

#ifndef CONVRES_SKIP
#define CONVRES_SKIP 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CM = 32;          // mid channels
constexpr int MS = CM + 8;      // bf16 a row of m, g and the 3x3 weights (80 bytes)
constexpr int SKIP = CONVRES_SKIP;

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// the two floats of a bf16 pair (low half first)
__device__ __forceinline__ float lo_f(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// the kernels' activation: mish (the identity under SKIP & 2)
__device__ __forceinline__ float act(float v) { return (SKIP & 2) ? v : mish(v); }

// mish and mish' of v (v and 1 under SKIP & 2)
__device__ __forceinline__ void act_dact(float v, float& m, float& d) {
  if (SKIP & 2) {
    m = v;
    d = 1.f;
  } else {
    mish_dmish(v, m, d);
  }
}

// act of a bf16 pair, rounded back to a bf16 pair
__device__ __forceinline__ unsigned act2(unsigned v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack2(act(f.x), act(f.y));
}

// c += a b on the tensor cores (not under SKIP & 1)
__device__ __forceinline__ void mma(float c[4], const unsigned a[4], unsigned b0,
                                    unsigned b1) {
  if (!(SKIP & 1)) mma_bf16(c, a, b0, b1);
}

// The A map of a MISH pass: act2 of each bf16 pair (K2's and K3's m0).
// A pass may take another (P3's bf16 mish).
struct Act2 {
  __device__ __forceinline__ unsigned operator()(unsigned v) const { return act2(v); }
};

// One pass of a warp over NU m16 tiles (a_lane[0], and a_lane[1] where NU
// is 2), N = 32: acc[u][nt] = A . B over KSTEPS k16 steps.  a_lane[u] is
// this lane's A row address (its pixel, its k half) and a_off(s) the
// step's constant offset from it.  B is 32 columns of a bf16 matrix of
// BS-element rows, its step s at w + b_off(s): with BT its rows are k
// ([k][n], read by ldmatrix.trans: rows s * 16 ... + 16 of the forward
// weights), else its rows are n ([n][k], read by ldmatrix: the same
// weights seen transposed).  With MISH, the A fragments are amap(A):
// mish(A), rounded, by default (K2's m0).  The steps are unrolled, so
// that every offset is a constant, and the fragments of step s + 1 are
// loaded before step s's products are issued (the helpers' asm is
// volatile, so issue order is source order), so that the products wait
// on the sums alone.
template <bool MISH, int KSTEPS, int NU, bool BT, int BS, typename AOff, typename BOff,
          typename AMap = Act2>
__device__ __forceinline__ void gemm32_nb(float (&acc)[2][4][4],
                                          const bf16* const (&a_lane)[2],
                                          const bf16* w, AOff a_off, BOff b_off,
                                          int lane, AMap amap = AMap()) {
  static_assert(KSTEPS % 2 == 0, "steps in pairs");
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.f;
  // ldmatrix x4 row addresses: BT, lanes 0-15 k rows 0-15 at n 0, lanes
  // 16-31 the same at n 8; else lanes 0-7 n rows 0-7 at k 0, 8-15 the
  // same at k 8, 16-31 n rows 8-15.  Either way registers 0, 1 are the
  // b0, b1 of n8 tile 0 and registers 2, 3 those of n8 tile 1.
  const bf16* b_lane =
      BT ? w + (lane & 15) * BS + (lane >> 4) * 8
         : w + ((lane & 7) + ((lane >> 4) << 3)) * BS + ((lane >> 3) & 1) * 8;
  constexpr int B_HI = BT ? 16 : 16 * BS;   // n8 tiles 2, 3
  unsigned b[2][2][4], a[2][NU][4];   // [step parity]
  auto load = [&](int s, unsigned (&bs)[2][4], unsigned (&as)[NU][4]) {
    if (BT) {
      ldmatrix_x4_trans(bs[0], b_lane + b_off(s));
      ldmatrix_x4_trans(bs[1], b_lane + b_off(s) + B_HI);
    } else {
      ldmatrix_x4(bs[0], b_lane + b_off(s));
      ldmatrix_x4(bs[1], b_lane + b_off(s) + B_HI);
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) ldmatrix_x4(as[u], a_lane[u] + a_off(s));
  };
  auto mmas = [&](const unsigned (&bs)[2][4], unsigned (&as)[NU][4]) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if (MISH) {
#pragma unroll
        for (int r = 0; r < 4; ++r) as[u][r] = amap(as[u][r]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma(acc[u][nt], as[u], bs[nt / 2][2 * (nt % 2)], bs[nt / 2][2 * (nt % 2) + 1]);
    }
  };
  load(0, b[0], a[0]);
#pragma unroll
  for (int s = 0; s < KSTEPS; s += 2) {
    load(s + 1, b[1], a[1]);
    mmas(b[0], a[0]);
    if (s + 2 < KSTEPS) load(s + 2, b[0], a[0]);
    mmas(b[1], a[1]);
  }
}

// gemm32_nb over the forward weights: B's step s is rows [s * 16, s * 16
// + 16) of a [k][32] matrix of MS-element rows
template <bool MISH, int KSTEPS, int NU, typename AOff, typename AMap = Act2>
__device__ __forceinline__ void gemm32_n(float (&acc)[2][4][4],
                                         const bf16* const (&a_lane)[2],
                                         const bf16* w, AOff a_off, int lane,
                                         AMap amap = AMap()) {
  gemm32_nb<MISH, KSTEPS, NU, true, MS>(acc, a_lane, w, a_off,
                                        [](int s) { return s * 16 * MS; }, lane, amap);
}

// gemm32_n over two m16 tiles where `two` (warp-uniform), else one
template <bool MISH, int KSTEPS, typename AOff, typename AMap = Act2>
__device__ __forceinline__ void gemm32(float (&acc)[2][4][4], const bf16* const (&a_lane)[2],
                                       bool two, const bf16* w, AOff a_off, int lane,
                                       AMap amap = AMap()) {
  if (two)
    gemm32_n<MISH, KSTEPS, 2>(acc, a_lane, w, a_off, lane, amap);
  else
    gemm32_n<MISH, KSTEPS, 1>(acc, a_lane, w, a_off, lane, amap);
}

}  // namespace
