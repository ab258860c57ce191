// mish and its derivative on the SFU (sm_90a): one ex2 and one rcp, no
// branch.  Included by conv3x3.cu (K5), convres_fwd.cu (K2),
// convres_bwd.cu (K3) and probe_convres.cu (P3), so that they use one
// copy.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// mish(x) = x tanh(softplus(x)) = x n / (n + 2), n = e^x (e^x + 2);
// x itself above 20, as softplus's threshold gives it.  No branch, so
// that a thread's elements run side by side.
__device__ __forceinline__ float mish(float x) {
  const float e = ex2_ftz(fminf(x, 20.f) * 1.44269504f);
  const float n = e * (e + 2.f);
  return x > 20.f ? x : x * n * rcp_ftz(n + 2.f);
}

// mish and mish' of x from one ex2 and one rcp.  With e = e^x, n = e (e +
// 2) and r = 1 / (n + 2): t = tanh(softplus(x)) = n r, sigmoid(x) = e /
// (1 + e) and 1 - t^2 = 4 (n + 1) r^2 = 4 (e + 1)^2 r^2, so
// mish'(x) = t + x sigmoid(x) (1 - t^2) = r (n + 4 x e (e + 1) r).
// Above 20 (x clamped there) mish' is 1 to f32 and mish is x.
__device__ __forceinline__ void mish_dmish(float x, float& m, float& d) {
  const float xc = fminf(x, 20.f);
  const float e = ex2_ftz(xc * 1.44269504f);
  const float n = e * (e + 2.f);
  const float r = rcp_ftz(n + 2.f);
  m = x > 20.f ? x : x * n * r;
  d = r * (n + 4.f * xc * e * (e + 1.f) * r);
}

}  // namespace
