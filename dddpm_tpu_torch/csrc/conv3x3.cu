// Fused 3x3 convolution with a GroupNorm-fold / mish prologue for Hopper
// (sm_90a), its products on the tensor cores (mma.sync, bf16 operands,
// f32 sums).
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
// outside the image, not prologue(0) (mish(shift) is not zero).  The
// prologue rounds the multiply and then the add (no FMA), as the plain
// version does.
//
// What bounds it on an H100: 2 * 9 * Cin * Cout FLOPs a pixel.  At 128^2,
// Cin = Cout = 128, B = 8 that is 38.7 GFLOP, 39.1 us at the bf16
// tensor-core rate, against 67 MB of x and y in bf16 (20 us): the bound
// is operations at all three x2 seam shapes.  Beside the products a
// block pays (a) the prologue, ~20 instructions a band element, the
// halo included (1.27 x the block's pixels); (b) the weight slab it
// reads from L2 per stage, amortised over its pixels; (c) the shared-
// memory traffic of the fragments, ~0.2 ldmatrix.x4 an mma.
//
// What this design does about it: an implicit GEMM, M = the block's
// output pixels, N = its output channels, K = 9 taps x Cin, on
// mma.sync.m16n8k16.  Nothing is built as im2col: for tap (dy, dx) the A
// fragment of 16 output pixels (one band row) is the operand band
// shifted by (dy, dx); ldmatrix takes each lane's pixel row address, so
// the shift is a constant offset.  The band's pixels are 48 bytes
// apart, so the 8 rows of each ldmatrix fall on distinct banks whatever
// the shift.  The block is warp-specialised, 512 threads:
//   - 8 consumer warps own 4 output rows x 16 columns (64 px) x WCO
//     channels each and only run the products: per stage of CK = 16
//     input channels, per dx, the B fragments of its three taps
//     (ldmatrix.x4.trans of the weight slab), then the warp's 6 band
//     rows, each A fragment used by the up to three dy that read it;
//   - 8 producer warps issue the cp.async loads (the weight slab a stage
//     ahead into three buffers, the raw band with its halo two stages
//     ahead) and run the prologue into the double-buffered bf16 operand
//     band: f32 affine, mish (ex2 and rcp, no branch), the two roundings
//     as bf16x2 packs, 0 outside the image;
//   - named barriers hand each buffer over (FULL, EMPTY), so the
//     prologue's ALU work runs beside the tensor cores rather than
//     between their bursts, and no barrier spans the block in the loop;
//   - setmaxnreg gives the producers 88 registers and the consumers 168.
// The block is large because of the weight slab's L2 traffic: a 16 x 16
// band x 128 channels in 64 x 64 warp tiles (Big); where that gives
// fewer blocks than the card has SMs (32^2 c256 at B = 8) an 8 x 16 band
// in 64 x 32 tiles (Small).  With the identity prologue on bf16 the band
// goes by cp.async straight into the operand band (zero-filled outside
// the image).  The epilogue adds b in f32, rounds to x's type and stages
// the block's tile through shared memory for 16-byte stores.
//
// Measured (H100 80GB HBM3, 700 W, B = 8, bf16, the three x2 seams):
// with the seam's prologue the producers bound it, ~1.4 x its time with
// the identity prologue, which runs at about cuDNN's time.
//
// f32 x keeps f32 accuracy: each operand is split into bf16 hi + lo
// (a = hi + lo to ~2^-17) and each product runs as three mma, hi.hi +
// hi.lo + lo.hi (~2^-16 relative; the lo.lo term is dropped).  The f32
// instance takes the Small band with two slab buffers, its weights split
// by the producers as they load them.
//
// C interface: plain C entry, loaded with ctypes.  It launches on the
// stream it is given, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mish_sm90.cuh"  // mish (ex2 + rcp)
#include "mma_sm90.cuh"   // cp_async16, ldmatrix_x4(_trans), mma_bf16

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CK = 16;          // input channels per stage: one mma k step
constexpr int TW = 16;          // output columns of a band: one m16 tile a row
constexpr int PSTRIDE = CK + 8; // bf16 a pixel of the operand band
constexpr int CONSUMERS = 256;  // 8 warps: the products
constexpr int PRODUCERS = 256;  // 8 warps: the loads and the prologue
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers a thread after setmaxnreg, the two adding up to the 128 of
// a 512-thread block: the producers' prologue wants 88 for its
// elements to overlap; the consumers' 64 x 64 warp tiles fit in 168
// (128 sums, 24 for B fragments), with no spill
constexpr int PREG = 88, CREG = 256 - PREG;
constexpr int NBW = 2;   // 16-channel B blocks a consumer holds at once
// named barriers (0 is __syncthreads): FULL + b, the operands of buffer
// b are ready; EMPTY + b, the consumers are done with them; the
// producers' and the consumers' own
enum { FULL = 1, EMPTY = 3, PROD = 5, CONS = 6 };

// A block's shape: a TH x TW band of output pixels and CO output
// channels; its 8 consumer warps own 4 output rows (64 px) x WCO
// channels each.
template <int TH_, int CO_, int WCO_>
struct Shape {
  static constexpr int TH = TH_, CO = CO_, WCO = WCO_;
  static constexpr int BR = TH + 2, BC = TW + 2, NPIX = BR * BC;  // + halo
  static constexpr int WM = TH / 4, WN = CO / WCO;   // consumer warps
  static constexpr int NI = WCO / 8, NB = WCO / 16;  // n8 tiles, x4 B blocks
  static constexpr int WSTRIDE = CO + 8;   // bf16 a weight-slab row
  static constexpr int OSTRIDE = CO + 8;   // elements a staged output row
  static constexpr int OP = NPIX * PSTRIDE;   // bf16 of an operand plane
  static constexpr int WSL = 9 * CK * WSTRIDE;   // bf16 of one slab plane
  static constexpr int PRO = 3 * CK;       // f32 scale, shift, post_bias
  static_assert(32 * WM * WN == CONSUMERS && NB % NBW == 0, "8 consumers");
  // f32: hi and lo planes of the operand band and the weight slab
  template <typename T>
  __host__ __device__ static constexpr int planes() {
    return sizeof(T) == 4 ? 2 : 1;
  }
  template <typename T>
  __host__ __device__ static constexpr int raw_bytes() {
    return NPIX * CK * (int)sizeof(T);
  }
  // weight-slab buffers: bf16 three, so that a slab is loaded a stage
  // before its operand band is made; f32 (two planes) two
  template <typename T>
  __host__ __device__ static constexpr int wbufs() {
    return sizeof(T) == 4 ? 2 : 3;
  }
  template <typename T>
  __host__ __device__ static constexpr int smem() {
    return 2 * (raw_bytes<T>() + PRO * 4) +
           planes<T>() * (2 * OP + wbufs<T>() * WSL) * 2;
  }
  template <typename T>
  __host__ __device__ static constexpr bool fits() {
    return smem<T>() <= 227 * 1024 &&
           TH * TW * OSTRIDE * (int)sizeof(T) <= smem<T>();   // epilogue
  }
};

typedef Shape<16, 128, 64> Big;   // 256 px x 128 co, warp tiles 64 x 64
typedef Shape<8, 128, 32> Small;  // 128 px x 128 co, warp tiles 64 x 32
static_assert(Big::fits<bf16>() && Small::fits<bf16>() && Small::fits<float>(),
              "shared memory");

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}
// a barrier of one side (the producers' or the consumers')
__device__ __forceinline__ void bar_side(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}

// waits until at most N of this thread's newest cp.async groups are
// in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// operand band: pixel p's 16 channels at p * PSTRIDE, 48-byte rows, so
// that the 16-byte rows of any 8 consecutive pixels (an ldmatrix, at
// any tap shift) fall on distinct banks, and each lane's A address is
// one base plus a constant per tap
__device__ __forceinline__ int op_offset(int p, int c) { return p * PSTRIDE + c; }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void ldg8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// 4 values to bf16 at hi and their remainders v - hi at lo
__device__ __forceinline__ void store4_split(const float v[4], bf16* hi, bf16* lo) {
  uint2 h, l;
  h.x = pack2(v[0], v[1]);
  h.y = pack2(v[2], v[3]);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.y));
  l.x = pack2(v[0] - a.x, v[1] - a.y);
  l.y = pack2(v[2] - b.x, v[3] - b.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid (bands x Cout chunks, B); block THREADS.  The chunks of one band
// are neighbours in the grid, so its band is read from HBM about once.
//
// Warps 8-15 (producers), per stage s: once the consumers are done with
// stage s - 2, they load the weight slab of s + 1 (three buffers; f32,
// two: that of s) and the raw band of s + 1, run stage s's prologue from
// its raw band into the operand band, and signal FULL.  Warps 0-7
// (consumers) wait for FULL, run the stage's products and signal EMPTY.
template <typename S, typename T, bool ACT>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ scale,
               const float* __restrict__ shift, const float* __restrict__ pbias,
               T* __restrict__ y, int H, int W, int Cin, int Cout, int mode) {
  constexpr bool SPLIT = sizeof(T) == 4;   // f32: 3 mma a product
  constexpr int NP = SPLIT ? 2 : 1;        // operand planes
  constexpr int RAW = S::template raw_bytes<T>();
  constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  // bf16 with the identity prologue: the band is the operand as it is
  constexpr bool direct = !SPLIT && !ACT;
  constexpr int NWB = S::template wbufs<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const raw0 = smem;                       // 2 x RAW
  float* const pro0 = reinterpret_cast<float*>(smem + 2 * RAW);   // 2 x PRO
  bf16* const op0 = reinterpret_cast<bf16*>(pro0 + 2 * S::PRO);   // 2 x NP x OP
  bf16* const ws0 = op0 + 2 * NP * S::OP;                 // NWB x NP x WSL

  const int nco = (Cout + S::CO - 1) / S::CO;
  const int bands_w = (W + TW - 1) / TW;
  const int co0 = (blockIdx.x % nco) * S::CO;
  const int band = blockIdx.x / nco;
  const int r0 = (band / bands_w) * S::TH, c0 = (band % bands_w) * TW;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nst = Cin / CK;

  if (threadIdx.x >= CONSUMERS) {
    // ---- producers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREG));
    const int t = threadIdx.x - CONSUMERS;
    const T* xb = x + (size_t)bi * H * W * Cin;
    // the band of stage ci0 / CK with its halo, by cp.async into buffer
    // (ci0 / CK) & 1: the raw band (pixel-major, CK a pixel) and the
    // stage's scale, shift, post_bias; direct, the operand band
    // (zero-filled outside the image: operand zero)
    auto load_band = [&](int ci0) {
      constexpr int RCH = CK / EPC;   // chunks a pixel
      const int buf = (ci0 / CK) & 1;
      for (int idx = t; idx < S::NPIX * RCH; idx += PRODUCERS) {
        const int p = idx / RCH, ch = idx % RCH;
        const int gr = r0 - 1 + p / S::BC, gc = c0 - 1 + p % S::BC;
        const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
        const T* src = in ? xb + (gr * W + gc) * Cin + ci0 + ch * EPC : xb;
        void* d = direct
            ? static_cast<void*>(op0 + buf * S::OP + op_offset(p, ch * EPC))
            : static_cast<void*>(reinterpret_cast<T*>(raw0 + buf * RAW) +
                                 p * CK + ch * EPC);
        cp_async16(d, src, in);
      }
      // scale, shift, post_bias of the stage; those not given (mode 1:
      // all three, mode 2: post_bias) as 1, 0, 0, which leave the
      // operand as mode 1 and 2 define it
      if (ACT && t < 3 * (CK / 4)) {
        const int j = t / (CK / 4);
        float* d = pro0 + buf * S::PRO + 4 * t;
        if (j < (mode >= 2 ? mode : 0)) {
          const float* arr = j == 0 ? scale : j == 1 ? shift : pbias;
          cp_async16(d, arr + bi * Cin + ci0 + 4 * (t % (CK / 4)), true);
        } else {
          const float v = j == 0 ? 1.f : 0.f;
          *reinterpret_cast<float4*>(d) = make_float4(v, v, v, v);
        }
      }
    };
    // the weight slab w[tap][ci0 + k][co0 ..] into buffer (ci0 / CK) % NWB,
    // [tap * CK + k][co] rows of WSTRIDE; channels at or past Cout are
    // zero.  bf16 by cp.async; f32 loaded and split into the hi and lo
    // planes.
    auto load_w = [&](int ci0) {
      constexpr int WCH = S::CO / 8;   // 8-channel chunks a row
      bf16* dst = ws0 + ((ci0 / CK) % NWB) * NP * S::WSL;
      for (int idx = t; idx < 9 * CK * WCH; idx += PRODUCERS) {
        const int ch = idx % WCH, row = idx / WCH;
        const int co = co0 + ch * 8;
        const bool ok = co < Cout;
        const T* src = w + ((row / CK) * Cin + ci0 + row % CK) * Cout + co;
        bf16* d = dst + row * S::WSTRIDE + ch * 8;
        if constexpr (SPLIT) {
          float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (ok) ldg8(reinterpret_cast<const float*>(src), v);
          store4_split(v, d, d + S::WSL);
          store4_split(v + 4, d + 4, d + 4 + S::WSL);
        } else {
          cp_async16(d, ok ? src : w, ok);
        }
      }
    };
    // stage s's operand band from its raw band (buffer s & 1), in
    // 4-channel units.  With ACT, every mode is
    // round(round(mish(x * scale + shift)) + post_bias) (mode 1: scale 1,
    // shift 0, post_bias 0, exact; mode 2: post_bias 0, and round is
    // idempotent), so the code has no branch on the mode.
    auto prologue = [&](int s) {
      static_assert(PRODUCERS % (CK / 4) == 0, "a thread keeps its channels");
      const int c4 = (t % (CK / 4)) * 4;
      const T* rb = reinterpret_cast<const T*>(raw0 + (s & 1) * RAW) + c4;
      bf16* dst = op0 + (s & 1) * NP * S::OP + c4;
      float sc[4], sh[4], pb[4];
      if (ACT) {
        const float* pr = pro0 + (s & 1) * S::PRO + c4;
        load4(pr, sc);
        load4(pr + CK, sh);
        load4(pr + 2 * CK, pb);
      }
      for (int p = t / (CK / 4); p < S::NPIX; p += PRODUCERS / (CK / 4)) {
        const int gr = r0 - 1 + p / S::BC, gc = c0 - 1 + p % S::BC;
        const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
        float v[4];
        load4(rb + p * CK, v);
        bf16* d = dst + op_offset(p, 0);
        // multiply, then add, each rounded (no fused multiply-add), as the
        // plain version computes it
        if constexpr (SPLIT) {   // f32: no rounding, hi and lo planes
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ACT)
              v[j] = mish(__fadd_rn(__fmul_rn(v[j], sc[j]), sh[j])) + pb[j];
            v[j] = in ? v[j] : 0.f;   // operand zero
          }
          store4_split(v, d, d + S::OP);
        } else if constexpr (ACT) {   // bf16: each rounding packs two
          unsigned o[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * h;
            const float2 m = __bfloat1622float2(__floats2bfloat162_rn(
                mish(__fadd_rn(__fmul_rn(v[j], sc[j]), sh[j])),
                mish(__fadd_rn(__fmul_rn(v[j + 1], sc[j + 1]), sh[j + 1]))));
            const __nv_bfloat162 r =
                __floats2bfloat162_rn(m.x + pb[j], m.y + pb[j + 1]);
            o[h] = in ? *reinterpret_cast<const unsigned*>(&r) : 0u;   // operand zero
          }
          *reinterpret_cast<uint2*>(d) = make_uint2(o[0], o[1]);
        }
      }
    };

    // Per stage s two cp.async groups: what stage s needs that could not
    // be loaded before (direct: its band; with two slab buffers: its
    // slab), then what later stages need (the slab of s + 1 with three
    // slab buffers, the raw band of s + 1).  Waiting for all but the
    // newest group leaves only the latter in flight.
    if (!direct) load_band(0);
    if (NWB == 3) load_w(0);
    cp_async_commit();
    for (int s = 0; s < nst; ++s) {
      bar_side(PROD);   // the prologue of s - 1 is done: its raw buffer is free
      if (s >= 2) bar_sync(EMPTY + (s & 1));   // stage s - 2 consumed
      if (direct) load_band(s * CK);
      if (NWB == 2) load_w(s * CK);
      cp_async_commit();
      if (NWB == 3 && s + 1 < nst) load_w((s + 1) * CK);
      if (!direct && s + 1 < nst) load_band((s + 1) * CK);
      cp_async_commit();
      cp_async_wait<1>();
      bar_side(PROD);   // stage s's band and slab are in, for every producer
      if (!direct) prologue(s);
      bar_arrive(FULL + (s & 1));
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREG));
  const int t = threadIdx.x;
  const int wm = warp % S::WM, wn = warp / S::WM;
  // acc[mi][ni][e]: output row wm*4 + mi, column g (+8 for e >= 2) of
  // the band, channel co0 + wn*WCO + 8ni + 2tq + (e & 1)
  float acc[4][S::NI][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  // this lane's ldmatrix rows: A, its pixel in band row 0 at dx = 0 and
  // its channel half; B, its k row and 8-channel column of the slab
  const int la = op_offset(wm * 4 * S::BC + (lane & 15), (lane >> 4) * 8);
  const int lwb = (lane & 15) * S::WSTRIDE + wn * S::WCO + (lane >> 4) * 8;

  for (int s = 0; s < nst; ++s) {
    bar_sync(FULL + (s & 1));
    // stage s's 9 taps: per dx, the B fragments of its three taps (NBW
    // 16-channel blocks at a time), then the warp's 6 band rows R, each
    // A fragment used by the dy with mi = R - dy in 0..3 (output row
    // wm*4 + mi reads band row wm*4 + R)
    const bf16* ob = op0 + (s & 1) * NP * S::OP + la;
    const bf16* wb = ws0 + (s % NWB) * NP * S::WSL + lwb;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int gq = 0; gq < S::NB / NBW; ++gq) {
        unsigned b[NP][3][NBW][4];
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int j = 0; j < NBW; ++j)
              ldmatrix_x4_trans(b[pl][dy][j],
                                wb + pl * S::WSL +
                                    (dy * 3 + dx) * CK * S::WSTRIDE +
                                    16 * (gq * NBW + j));
#pragma unroll
        for (int R = 0; R < 6; ++R) {
          unsigned a[NP][4];
#pragma unroll
          for (int pl = 0; pl < NP; ++pl)
            ldmatrix_x4(a[pl], ob + pl * S::OP + (R * S::BC + dx) * PSTRIDE);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int mi = R - dy;
            if (mi < 0 || mi > 3) continue;
#pragma unroll
            for (int j = 0; j < NBW; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float* c = acc[mi][2 * (gq * NBW + j) + hh];
                const unsigned* bh = b[0][dy][j] + 2 * hh;
                mma_bf16(c, a[0], bh[0], bh[1]);
                if (SPLIT) {   // + hi.lo + lo.hi
                  const unsigned* bl = b[NP - 1][dy][j] + 2 * hh;
                  mma_bf16(c, a[0], bl[0], bl[1]);
                  mma_bf16(c, a[NP - 1], bh[0], bh[1]);
                }
              }
          }
        }
      }
    }
    if (s + 2 < nst) bar_arrive(EMPTY + (s & 1));
  }

  // + b in f32, rounded to T, staged as [px][co] rows of OSTRIDE, then
  // written in 16-byte chunks (the producers are done: every stage's
  // FULL has been waited for)
  bar_side(CONS);
  T* const os = reinterpret_cast<T*>(smem);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < S::NI; ++ni) {
    const int col = wn * S::WCO + 8 * ni + 2 * tq;
    const bool ok = co0 + col < Cout;   // Cout even: col + 1 too
    const float b0 = ok ? bias[co0 + col] : 0.f;
    const float b1 = ok ? bias[co0 + col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int px = (wm * 4 + mi) * TW + g + 8 * hh;
        store2(os + px * S::OSTRIDE + col, acc[mi][ni][2 * hh] + b0,
               acc[mi][ni][2 * hh + 1] + b1);
      }
  }
  bar_side(CONS);
  constexpr int OCH = S::CO / EPC;   // 16-byte chunks a staged row
  for (int idx = t; idx < S::TH * TW * OCH; idx += CONSUMERS) {
    const int px = idx / OCH, c = (idx % OCH) * EPC;
    const int orow = r0 + px / TW, ocol = c0 + px % TW;
    if (orow < H && ocol < W && co0 + c < Cout)
      *reinterpret_cast<uint4*>(y + (((size_t)bi * H + orow) * W + ocol) * Cout +
                                co0 + c) =
          *reinterpret_cast<const uint4*>(os + px * S::OSTRIDE + c);
  }
}

template <typename S>
int blocks(int B, int H, int W, int Cout) {
  return ((H + S::TH - 1) / S::TH) * ((W + TW - 1) / TW) *
         ((Cout + S::CO - 1) / S::CO) * B;
}

template <typename S, typename T, bool ACT>
int launch_act(const void* x, const void* w, const void* b, const void* scale,
               const void* shift, const void* pbias, void* y, int B, int H,
               int W, int Cin, int Cout, int mode, cudaStream_t stream) {
  constexpr int smem = S::template smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<S, T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks<S>(1, H, W, Cout), B);
  conv3x3_kernel<S, T, ACT><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w, (const float*)b, (const float*)scale,
      (const float*)shift, (const float*)pbias, (T*)y, H, W, Cin, Cout, mode);
  return (int)cudaGetLastError();
}

// the kernel with the prologue (modes 1-3) or without it (mode 0)
template <typename S, typename T>
int launch(const void* x, const void* w, const void* b, const void* scale,
           const void* shift, const void* pbias, void* y, int B, int H, int W,
           int Cin, int Cout, int mode, cudaStream_t stream) {
  return mode ? launch_act<S, T, true>(x, w, b, scale, shift, pbias, y, B, H,
                                       W, Cin, Cout, mode, stream)
              : launch_act<S, T, false>(x, w, b, scale, shift, pbias, y, B, H,
                                        W, Cin, Cout, mode, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, Cin) and w (3, 3, Cin,
// Cout) of dtype; b (Cout) f32; scale, shift, pbias (B, Cin) f32, read
// from mode 2 (scale, shift) and 3 (all three) on; y (B, H, W, Cout) of
// dtype.  Cin % 32 == 0, Cout % 64 == 0, H W Cin < 2^31; every array
// 16-byte aligned.
//
// The tile: bf16 takes Big (16 x 16 px x 128 co, 64 x 64 warp tiles)
// when that gives at least one block per SM, else Small (8 x 16 px x
// 128 co, 64 x 32 warp tiles), which doubles the blocks; f32 always
// takes Small.
int conv3x3_fused(const void* x, const void* w, const void* b, const void* scale,
                  const void* shift, const void* pbias, void* y, int B, int H,
                  int W, int Cin, int Cout, int mode, int dtype, void* stream) {
  if (Cin % 32 || Cout % 64 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  if (mode >= 2 && (!scale || !shift)) return (int)cudaErrorInvalidValue;
  if (mode == 3 && !pbias) return (int)cudaErrorInvalidValue;
  if ((long long)H * W * Cin >= (1LL << 31) ||   // offsets are 32-bit
      9LL * Cin * Cout >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(y) || !aligned16(scale) ||
      !aligned16(shift) || !aligned16(pbias))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 1)
    return launch<Small, float>(x, w, b, scale, shift, pbias, y, B, H, W, Cin,
                                Cout, mode, st);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks<Big>(B, H, W, Cout) >= sms)
    return launch<Big, bf16>(x, w, b, scale, shift, pbias, y, B, H, W, Cin,
                             Cout, mode, st);
  return launch<Small, bf16>(x, w, b, scale, shift, pbias, y, B, H, W, Cin,
                             Cout, mode, st);
}

}  // extern "C"
