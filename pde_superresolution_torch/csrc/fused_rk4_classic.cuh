// fused_rk4, register form for the classic schemes of accuracy order 2 (the
// tap layouts of fused_rk4.cuh's Layout compiled in). See fused_rk4.cuh.
// Instantiated per equation in fused_rk4_classic_kdv.cu and
// fused_rk4_classic_ks.cu, so that nvcc compiles the two in parallel.

#pragma once

#include "fused_rk4.cuh"

namespace pde_rk4 {
namespace {

template <int EQ, bool CONS, int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_rk4_kernel(const float* __restrict__ u_in, float* __restrict__ out, Scalars sc,
                     int num_steps, int batch, int warps_per_block) {
  constexpr Layout L = layout(EQ, CONS);
  constexpr int lo = L.lo(), hi = L.hi();
  constexpr int W = P + hi - lo;  // the window a lane's taps read
  const int lane = threadIdx.x & 31, lanes = sc.lanes;
  const long long b = (long long)blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  if (b >= batch) return;  // a whole warp: no barrier or shuffle waits for it
  const bool mine = lane < lanes;  // lanes beyond the ring shuffle along, store nothing
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
      // w[i] is the stage input at lane-relative point lo + i
      float w[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int q = lo + i;
        const int d = floor_div(q, P);
        const int e = q - d * P;
        w[i] = d == 0 ? s[e] : __shfl_sync(kFullMask, s[e], ring(lane + d, lanes));
      }
      float k[P];
      if (CONS) {
        float flux[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float v[kMaxOrders];
#pragma unroll
          for (int o = 0; o < L.orders; ++o) {
            float acc = __fmul_rn(sc.coef[o][L.tap0[o] + kReach], w[p + L.tap0[o] - lo]);
#pragma unroll
            for (int t = 1; t < L.size[o]; ++t)
              acc = __fadd_rn(acc, __fmul_rn(sc.coef[o][L.tap0[o] + t + kReach],
                                             w[p + L.tap0[o] + t - lo]));
            v[o] = acc;
          }
          flux[p] = pde::flux<EQ>(v, sc.eta);
        }
        const float left = __shfl_sync(kFullMask, flux[P - 1], ring(lane - 1, lanes));
#pragma unroll
        for (int p = 0; p < P; ++p)
          k[p] = pde::divergence(flux[p], p == 0 ? left : flux[p - 1], sc.dx);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float v[kMaxOrders];
#pragma unroll
          for (int o = 0; o < L.orders; ++o) {
            float acc = __fmul_rn(sc.coef[o][L.tap0[o] + kReach], w[p + L.tap0[o] - lo]);
#pragma unroll
            for (int t = 1; t < L.size[o]; ++t)
              acc = __fadd_rn(acc, __fmul_rn(sc.coef[o][L.tap0[o] + t + kReach],
                                             w[p + L.tap0[o] + t - lo]));
            v[o] = acc;
          }
          k[p] = pde::equation_of_motion<EQ>(s[p], v, sc.eta);
        }
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
struct Classic {
  static int run(const Scalars& sc, const Launch& l) {
    const int blocks = (l.batch + l.warps - 1) / l.warps;
    fused_rk4_kernel<EQ, CONS, P><<<blocks, l.warps * 32, 0, l.stream>>>(
        l.u, l.out, sc, l.num_steps, l.batch, l.warps);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace pde_rk4
