// fused_rk4, register form for any scheme: the taps taken at run time. See
// fused_rk4.cuh. Instantiated per equation in fused_rk4_scheme_kdv.cu and
// fused_rk4_scheme_ks.cu, so that nvcc compiles the two in parallel.

#pragma once

#include "fused_rk4.cuh"

namespace pde_rk4 {
namespace {

// sh[p] <- sh[p + 1]: every lane's values one point to the left, the last
// from the right neighbour's first
template <int P>
__device__ __forceinline__ void shift_left(float (&sh)[P], int right) {
  const float in = __shfl_sync(kFullMask, sh[0], right);
#pragma unroll
  for (int p = 0; p < P - 1; ++p) sh[p] = sh[p + 1];
  sh[P - 1] = in;
}

// sh[p] <- sh[p - 1], the first from the left neighbour's last
template <int P>
__device__ __forceinline__ void shift_right(float (&sh)[P], int left) {
  const float in = __shfl_sync(kFullMask, sh[P - 1], left);
#pragma unroll
  for (int p = P - 1; p > 0; --p) sh[p] = sh[p - 1];
  sh[0] = in;
}

template <int EQ, bool CONS, int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_rk4_scheme_kernel(const float* __restrict__ u_in, float* __restrict__ out,
                            const __grid_constant__ Scalars sc, int num_steps, int batch,
                            int warps_per_block) {
  const int lane = threadIdx.x & 31, lanes = sc.lanes;
  const long long b = (long long)blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  if (b >= batch) return;  // a whole warp: no shuffle waits for it
  const bool mine = lane < lanes;  // lanes beyond the ring shuffle along, store nothing
  const int right = ring(lane + 1, lanes), left = ring(lane - 1, lanes);
  const float* src = u_in + b * (lanes * P) + lane * P;

  float u0[P], ksum[P], s[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    u0[p] = mine ? src[p] : 0.f;
    s[p] = u0[p];
    ksum[p] = 0.f;
  }

  for (int step = 0; step < num_steps; ++step) {
#pragma unroll
    for (int stage = 0; stage < 4; ++stage) {
      float f[P];  // the flux (conservative) or u_t (direct), order by order
#pragma unroll
      for (int p = 0; p < P; ++p) f[p] = 0.f;
#pragma unroll
      for (int o = 0; o < kMaxOrders; ++o) {
        if (o < sc.orders) {  // uniform: the scheme is the launch's
          const int t0 = sc.tap0[o], n = sc.size[o];
          float sh[P], acc[P];  // sh[p]: the stage input at point p + the current tap
#pragma unroll
          for (int p = 0; p < P; ++p) {
            sh[p] = s[p];
            acc[p] = -0.f;  // -0 + x is x for every x: the first tap's product as it is
          }
          for (int i = 0; i > t0; --i) shift_right(sh, left);
          for (int i = 0; i < t0; ++i) shift_left(sh, right);
          for (int t = 0; t < n; ++t) {
            const float c = sc.coef[o][t0 + t + kReach];
#pragma unroll
            for (int p = 0; p < P; ++p) acc[p] = __fadd_rn(acc[p], __fmul_rn(c, sh[p]));
            if (t + 1 < n) shift_left(sh, right);
          }
#pragma unroll
          for (int p = 0; p < P; ++p) f[p] = fold<EQ, CONS>(o, f[p], acc[p], s[p]);
        }
      }
      float k[P];
      if (CONS) {
        const float face = __shfl_sync(kFullMask, f[P - 1], left);
#pragma unroll
        for (int p = 0; p < P; ++p) k[p] = pde::divergence(f[p], p == 0 ? face : f[p - 1], sc.dx);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) k[p] = f[p];
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
        s[p] = combine(stage, k[p], u0[p], ksum[p], sc.half_dt, sc.dt, sc.dt_sixth);
    }
  }
  if (mine) {
    float* dst = out + b * (lanes * P) + lane * P;
#pragma unroll
    for (int p = 0; p < P; ++p) dst[p] = u0[p];
  }
}

template <int EQ, bool CONS, int P>
struct Scheme {
  static int run(const Scalars& sc, const Launch& l) {
    const int blocks = (l.batch + l.warps - 1) / l.warps;
    fused_rk4_scheme_kernel<EQ, CONS, P><<<blocks, l.warps * 32, 0, l.stream>>>(
        l.u, l.out, sc, l.num_steps, l.batch, l.warps);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace pde_rk4
