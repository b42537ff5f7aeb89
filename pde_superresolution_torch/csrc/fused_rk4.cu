// fused_rk4: num_steps whole RK4 steps of the fixed classic-stencil baseline
// scheme in one launch.
//
// Replaces make_fused_rk4 in pde_superresolution_tpu/ops/pallas_kernels.py
// (the pallas_call at line 374). Each RHS evaluation is, per derivative
// order, a tap sum of constant coefficients against periodic shifts of u,
// then the flux divergence (conservative form) or the equation of motion
// (direct form). Unforced equations only (KdV, KS), as the TPU kernel. The
// tap sums run in tap order with every product and sum rounded on its own
// (_rn, no contraction into FMAs), so the kernel equals its plain version
// (fused_kernels.fused_rk4_plain) bit for bit.
//
// What bounds it on the H100: instruction issue at large batch, and the
// latency of the chain of 4 x num_steps dependent stages at small batch.
// The state is read once and written once (8 bytes a point), microseconds at
// any batch. A stage costs each point 12 multiplies and 9 adds for the
// taps, each rounded on its own (KS conservative), a flux, an IEEE division
// by dx and the stage combine: about 40 instructions.
//
// Design: a warp owns a trajectory, and lane l holds the P = nx / 32
// consecutive points [l P, l P + P) in registers: the step's start value,
// the running k1 + 2 k2 + 2 k3 + k4 and the stage input. A tap's neighbour
// value beyond the lane's own points comes from lane l - 1 or l + 1 (or
// further where the reach exceeds P) through __shfl_sync; lane 0's left
// neighbour is lane 31, so the periodic wrap costs nothing. The left face of
// the conservative divergence is one more shuffle of the flux. No shared
// memory and no barrier: one stage follows the last through register data
// dependence alone, and warps never wait for each other. The tap layout of
// each classic scheme and P are template parameters, so every tap loop
// unrolls and each coefficient is a constant-bank operand of its multiply
// (the coefficients arrive by value in the kernel's parameters). Blocks are
// just packages of warps, sized in Python (fused_kernels.rk4_launch).

#include <cuda_runtime.h>

#include "equations.cuh"

namespace {

using pde::kMaxOrders;

constexpr int kMaxTaps = 16;  // fused_kernels.MAX_TAPS
constexpr int kMaxWarps = 8;  // fused_kernels.RK4_MAX_WARPS: warps per block
constexpr unsigned kFullMask = 0xffffffffu;

// The classic schemes of make_fused_rk4 (accuracy order 2), per equation
// and form: per order (ascending) the first tap and the number of taps.
struct Layout {
  int orders;
  int tap0[kMaxOrders];
  int size[kMaxOrders];
  __host__ __device__ constexpr int lo() const {
    int m = 0;
    for (int o = 0; o < orders; ++o) m = tap0[o] < m ? tap0[o] : m;
    return m;
  }
  __host__ __device__ constexpr int hi() const {
    int m = 0;
    for (int o = 0; o < orders; ++o) m = tap0[o] + size[o] - 1 > m ? tap0[o] + size[o] - 1 : m;
    return m;
  }
};

__host__ __device__ constexpr Layout layout(int eq, bool cons) {
  // KdV (1): conservative orders 0, 2; direct 1, 3. KS (2): conservative
  // 0, 1, 3; direct 1, 2, 4.
  return eq == 1 ? (cons ? Layout{2, {0, -1, 0}, {2, 4, 0}} : Layout{2, {-1, -2, 0}, {3, 5, 0}})
                 : (cons ? Layout{3, {0, -1, -2}, {2, 4, 6}} : Layout{3, {-1, -2, -3}, {3, 5, 7}});
}

__host__ __device__ constexpr int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

struct Scalars {
  float coef[kMaxOrders][kMaxTaps];
  float dx, eta, half_dt, dt, dt_sixth;
};

template <int EQ, bool CONS, int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_rk4_kernel(const float* __restrict__ u_in, float* __restrict__ out, Scalars sc,
                     int num_steps, int batch, int warps_per_block) {
  constexpr Layout L = layout(EQ, CONS);
  constexpr int lo = L.lo(), hi = L.hi();
  constexpr int W = P + hi - lo;  // the window a lane's taps read
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  if (b >= batch) return;  // a whole warp: no barrier or shuffle waits for it
  const float* src = u_in + b * (32 * P) + lane * P;

  float u0[P], ksum[P], s[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    u0[p] = src[p];
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
        w[i] = d == 0 ? s[e] : __shfl_sync(kFullMask, s[e], (lane + d) & 31);
      }
      float k[P];
      if (CONS) {
        float flux[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float v[kMaxOrders];
#pragma unroll
          for (int o = 0; o < L.orders; ++o) {
            float acc = __fmul_rn(sc.coef[o][0], w[p + L.tap0[o] - lo]);
#pragma unroll
            for (int t = 1; t < L.size[o]; ++t)
              acc = __fadd_rn(acc, __fmul_rn(sc.coef[o][t], w[p + L.tap0[o] + t - lo]));
            v[o] = acc;
          }
          flux[p] = pde::flux<EQ>(v, sc.eta);
        }
        const float left = __shfl_sync(kFullMask, flux[P - 1], (lane + 31) & 31);
#pragma unroll
        for (int p = 0; p < P; ++p)
          k[p] = pde::divergence(flux[p], p == 0 ? left : flux[p - 1], sc.dx);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float v[kMaxOrders];
#pragma unroll
          for (int o = 0; o < L.orders; ++o) {
            float acc = __fmul_rn(sc.coef[o][0], w[p + L.tap0[o] - lo]);
#pragma unroll
            for (int t = 1; t < L.size[o]; ++t)
              acc = __fadd_rn(acc, __fmul_rn(sc.coef[o][t], w[p + L.tap0[o] + t - lo]));
            v[o] = acc;
          }
          k[p] = pde::equation_of_motion<EQ>(s[p], v, sc.eta);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (stage == 0) {
          ksum[p] = k[p];
          s[p] = __fadd_rn(u0[p], __fmul_rn(sc.half_dt, k[p]));
        } else if (stage == 1) {
          ksum[p] = __fadd_rn(ksum[p], __fmul_rn(2.0f, k[p]));
          s[p] = __fadd_rn(u0[p], __fmul_rn(sc.half_dt, k[p]));
        } else if (stage == 2) {
          ksum[p] = __fadd_rn(ksum[p], __fmul_rn(2.0f, k[p]));
          s[p] = __fadd_rn(u0[p], __fmul_rn(sc.dt, k[p]));
        } else {
          ksum[p] = __fadd_rn(ksum[p], k[p]);
          u0[p] = __fadd_rn(u0[p], __fmul_rn(sc.dt_sixth, ksum[p]));
          s[p] = u0[p];
        }
      }
    }
  }
  float* dst = out + b * (32 * P) + lane * P;
#pragma unroll
  for (int p = 0; p < P; ++p) dst[p] = u0[p];
}

template <int EQ, bool CONS, int P>
int launch(const float* u, float* out, const Scalars& sc, int batch, int num_steps,
           int warps, cudaStream_t stream) {
  const int blocks = (batch + warps - 1) / warps;
  fused_rk4_kernel<EQ, CONS, P>
      <<<blocks, warps * 32, 0, stream>>>(u, out, sc, num_steps, batch, warps);
  return (int)cudaGetLastError();
}

// Points per lane that the kernel is built for: nx = 32 P
template <int EQ, bool CONS>
int dispatch(int points_per_lane, const float* u, float* out, const Scalars& sc, int batch,
             int num_steps, int warps, cudaStream_t s) {
  switch (points_per_lane) {
    case 2: return launch<EQ, CONS, 2>(u, out, sc, batch, num_steps, warps, s);
    case 3: return launch<EQ, CONS, 3>(u, out, sc, batch, num_steps, warps, s);
    case 4: return launch<EQ, CONS, 4>(u, out, sc, batch, num_steps, warps, s);
    case 5: return launch<EQ, CONS, 5>(u, out, sc, batch, num_steps, warps, s);
    case 8: return launch<EQ, CONS, 8>(u, out, sc, batch, num_steps, warps, s);
    case 32: return launch<EQ, CONS, 32>(u, out, sc, batch, num_steps, warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// meta: equation code, conservative, nx, warps per block, n_orders,
//       size[3], tap0[3] (checked against the compiled classic scheme).
// coefs: [3][16] floats, the orders' coefficients in tap order.
// scalars: dx, eta, dt/2, dt, dt/6.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape or scheme the kernel is not built for (fused_kernels.rk4_refusal
// says why before any launch). Burgers (code 0) is forced and refused.
extern "C" int pde_fused_rk4(const float* u, float* out, int batch, int num_steps,
                             const int* meta, const float* coefs, const float* scalars,
                             void* stream) {
  if (batch == 0) return 0;
  const int eq = meta[0], nx = meta[2], warps = meta[3];
  const bool cons = meta[1] != 0;
  if (eq != 1 && eq != 2) return (int)cudaErrorInvalidValue;
  const Layout want = layout(eq, cons);
  if (meta[4] != want.orders) return (int)cudaErrorInvalidValue;
  for (int o = 0; o < want.orders; ++o) {
    if (meta[5 + o] != want.size[o] || meta[8 + o] != want.tap0[o]) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (nx % 32 != 0 || warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  Scalars sc;
  for (int o = 0; o < kMaxOrders; ++o) {
    for (int t = 0; t < kMaxTaps; ++t) sc.coef[o][t] = coefs[o * kMaxTaps + t];
  }
  sc.dx = scalars[0];
  sc.eta = scalars[1];
  sc.half_dt = scalars[2];
  sc.dt = scalars[3];
  sc.dt_sixth = scalars[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = nx / 32;
  if (eq == 1) {
    return cons ? dispatch<1, true>(p, u, out, sc, batch, num_steps, warps, s)
                : dispatch<1, false>(p, u, out, sc, batch, num_steps, warps, s);
  }
  return cons ? dispatch<2, true>(p, u, out, sc, batch, num_steps, warps, s)
              : dispatch<2, false>(p, u, out, sc, batch, num_steps, warps, s);
}
