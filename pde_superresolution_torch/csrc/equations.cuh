// Equation forms shared by the fused kernels (device side).
//
// EQ selects the equation at compile time: 0 Burgers, 1 KdV, 2 KS (the
// codes of fused_kernels.EQUATION_CODES). v[] holds the stencil values of
// the equation's derivative orders in ascending order, so position, not
// order, picks the term:
//   Burgers  direct (1, 2)     conservative (0, 1)
//   KdV      direct (1, 3)     conservative (0, 2)
//   KS       direct (1, 2, 4)  conservative (0, 1, 3)
// The _rn intrinsics keep each operation rounded on its own, in the order
// of pde_superresolution_torch/equations.py, so nvcc does not contract
// them into fused multiply-adds the plain version does not have.
#pragma once

#include <cuda_runtime.h>

namespace pde {

constexpr int kMaxOrders = 3;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Flux J at a right face from the face reconstructions.
template <int EQ>
__device__ __forceinline__ float flux(const float* v, float eta) {
  const float sq = __fmul_rn(v[0], v[0]);
  if (EQ == 0) return __fsub_rn(__fmul_rn(0.5f, sq), __fmul_rn(eta, v[1]));
  if (EQ == 1) return __fadd_rn(__fmul_rn(3.0f, sq), v[1]);
  return __fadd_rn(__fadd_rn(__fmul_rn(0.5f, sq), v[1]), v[2]);
}

// Direct-form u_t from the point derivatives.
template <int EQ>
__device__ __forceinline__ float equation_of_motion(float u, const float* v, float eta) {
  if (EQ == 0) return __fadd_rn(__fmul_rn(-u, v[0]), __fmul_rn(eta, v[1]));
  if (EQ == 1) return __fsub_rn(__fmul_rn(__fmul_rn(-6.0f, u), v[0]), v[1]);
  return __fsub_rn(__fsub_rn(__fmul_rn(-u, v[0]), v[1]), v[2]);
}

// Conservative divergence -(F[j] - F[j-1]) / dx.
__device__ __forceinline__ float divergence(float right, float left, float dx) {
  return __fdiv_rn(-__fsub_rn(right, left), dx);
}

}  // namespace pde
