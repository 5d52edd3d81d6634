// Max and min for the dt folds, the raw sensor's clamp and the smoothing
// rings of qgd2d.cu and qgd3d.cu: a NaN operand propagates, as in torch.max,
// torch.maximum, torch.clamp and the reference's jnp.max (fmaxf and fminf
// drop it, so a frame with a NaN cell kept a finite dt, and a ring dropped
// a NaN neighbour).
// On operands without a NaN they are fmaxf and fminf.
#pragma once

#include <cuda_runtime.h>

// (One instruction on the card: max.NaN / min.NaN, sm_80 and later.)
static __device__ __forceinline__ float nan_max(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a > b || a != a) ? a : b;
#endif
}

static __device__ __forceinline__ float nan_min(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a < b || a != a) ? a : b;
#endif
}
