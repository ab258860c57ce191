// mish on the SFU (sm_90a): one ex2 and one rcp, no branch.  Included by
// conv3x3.cu (K5) and convres_fwd.cu (K2), so that they use one copy.
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

}  // namespace
