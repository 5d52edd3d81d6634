// One fvc::smooth ring at a cell, shared by qgd2d.cu and qgd3d.cu:
//
//   f <- max(f, nb / maxRatio),  nb = max(f, its face neighbours),
//
// with max the NaN-propagating nan_max (nan_fold.cuh), as torch.maximum is,
// and nb / maxRatio the correctly rounded quotient, so every ring equals the
// plain PyTorch version's (a division by a tensor) bit for bit, NaN cells
// included.  A correctly
// rounded division costs a dozen instructions and a slow-path test; here it
// is a product by y = RN(1 / maxRatio) and one remainder correction:
//
//   q = RN(nb * y),  rem = fma(-q, maxRatio, nb),  q' = fma(rem, y, q).
//
// While nothing underflows, rem is the exact remainder nb - q * maxRatio and
// scaling nb by 2 scales q, rem and q' exactly, so one binade of nb decides
// every binade above the underflow range.  Below |nb| = SMOOTH_TINY the
// remainder can underflow and the ring divides (__fdiv_rn).  Whether q' is
// the correctly rounded quotient for a given maxRatio is not assumed:
// smooth_ring_check (qgd2d.cu) compares it with __fdiv_rn on every float of
// [1, 2), of the binade at SMOOTH_TINY, of the lowest normal binade, of the
// subnormals and of the top binade, and the step builders refuse a ratio
// with any mismatch.  Only maxRatio travels in the params structs, rounded
// to float32 once on the host; every kernel, the check's included, derives
// y from it with smooth_inverse.
#pragma once

#include <cuda_runtime.h>

#include "nan_fold.cuh"

// Below this |nb| the remainder may underflow: the ring divides.
#define SMOOTH_TINY 0x1p-96f

// y = RN(1 / r), the reciprocal the ring multiplies by.
static __device__ __forceinline__ float smooth_inverse(float r) {
  return __frcp_rn(r);
}

// nb / r, correctly rounded (y = smooth_inverse(r)).  GUARD = false only
// where every |nb| is known to be at least SMOOTH_TINY (a tile whose cells
// all are: the rings only raise them, and nb is at least the cell).
template <bool GUARD>
static __device__ __forceinline__ float smooth_div(float nb, float r,
                                                   float y) {
  if (GUARD && !(fabsf(nb) >= SMOOTH_TINY)) return __fdiv_rn(nb, r);
  const float q = __fmul_rn(nb, y);
  const float rem = __fmaf_rn(-q, r, nb);
  return __fmaf_rn(rem, y, q);
}

// The ring at a cell from its value f and nb (which includes f).
template <bool GUARD>
static __device__ __forceinline__ float smooth_ring(float f, float nb, float r,
                                                    float y) {
  return nan_max(f, smooth_div<GUARD>(nb, r, y));
}
