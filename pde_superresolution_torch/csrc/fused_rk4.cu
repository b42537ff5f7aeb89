// fused_rk4: num_steps whole RK4 steps of the fixed classic-stencil baseline
// scheme in one launch.
//
// Replaces make_fused_rk4 in pde_superresolution_tpu/ops/pallas_kernels.py
// (the pallas_call at line 374). Each RHS evaluation is, per derivative
// order, a tap sum of constant coefficients against periodic shifts of u,
// then the flux divergence (conservative form) or the equation of motion
// (direct form). Unforced equations only (KdV, KS), as the TPU kernel. The
// tap sums run in tap order with every product and sum rounded on its own
// (_rn), so the plain version (fused_kernels.fused_rk4_plain) can round at
// the same places.
//
// What bounds it on the H100: neither bytes nor operations. The state is
// read once and written once (8 bytes per point) and one RHS costs a few
// tens of flops per point, both microseconds at any batch the card holds;
// what takes the time is the chain of 4 x num_steps dependent stages, each
// closed by block-wide barriers, so the floor is the latency of one stage
// times their number, hidden only as far as the blocks resident on an SM
// overlap each other's stages.
//
// Design: one thread per grid point; a block holds `rows` whole
// trajectories (rows x nx threads, about 256, so that an nx = 128 grid does
// not leave an SM's threads mostly idle) and loops over all the steps. The
// stage input u and the face fluxes live in shared memory, the RK4 state
// (the step's start value and the running k1 + 2 k2 + 2 k3 + k4) in the
// point's registers, and the coefficients arrive by value in the kernel's
// parameters (constant memory). A periodic shift is modular indexing into
// the row's shared-memory segment.

#include <cuda_runtime.h>

#include "equations.cuh"

namespace {

using pde::kMaxOrders;

constexpr int kMaxTaps = 16;  // fused_kernels.MAX_TAPS

struct Scheme {
  int nx, rows, n_orders;
  int size[kMaxOrders], tap0[kMaxOrders];
  float coef[kMaxOrders][kMaxTaps];
  float dx, eta, half_dt, dt, dt_sixth;
  int num_steps, batch;
};

template <int EQ, bool CONS>
__global__ void __launch_bounds__(1024)
    fused_rk4_kernel(const float* __restrict__ u_in, float* __restrict__ u_out, Scheme sc) {
  extern __shared__ float smem[];
  const int nx = sc.nx;
  const int r = threadIdx.x / nx;  // the block's row (trajectory)
  const int j = threadIdx.x % nx;
  const long long b = (long long)blockIdx.x * sc.rows + r;
  const bool live = b < sc.batch;  // the last block may hold fewer rows
  float* s_u = smem + r * nx;                   // stage input [rows][nx]
  float* s_flux = smem + (sc.rows + r) * nx;    // face fluxes [rows][nx]

  float u0 = 0.f, ksum = 0.f;
  if (live) u0 = u_in[b * nx + j];
  s_u[j] = u0;
  __syncthreads();

  for (int step = 0; step < sc.num_steps; ++step) {
    for (int stage = 0; stage < 4; ++stage) {
      float v[kMaxOrders];
#pragma unroll
      for (int o = 0; o < kMaxOrders; ++o) {
        if (o < sc.n_orders) {
          int kk = pde::wrap(j + sc.tap0[o], nx);
          float acc = 0.f;
          for (int s = 0; s < sc.size[o]; ++s) {
            const float term = __fmul_rn(sc.coef[o][s], s_u[kk]);
            acc = s == 0 ? term : __fadd_rn(acc, term);
            kk = kk + 1 == nx ? 0 : kk + 1;
          }
          v[o] = acc;
        }
      }
      float k_val;
      if (CONS) {
        const float right = pde::flux<EQ>(v, sc.eta);
        s_flux[j] = right;
        __syncthreads();
        k_val = pde::divergence(right, s_flux[j == 0 ? nx - 1 : j - 1], sc.dx);
      } else {
        k_val = pde::equation_of_motion<EQ>(s_u[j], v, sc.eta);
        __syncthreads();  // every read of s_u for this stage done
      }
      float next;
      if (stage == 0) {
        ksum = k_val;
        next = __fadd_rn(u0, __fmul_rn(sc.half_dt, k_val));
      } else if (stage == 1) {
        ksum = __fadd_rn(ksum, __fmul_rn(2.0f, k_val));
        next = __fadd_rn(u0, __fmul_rn(sc.half_dt, k_val));
      } else if (stage == 2) {
        ksum = __fadd_rn(ksum, __fmul_rn(2.0f, k_val));
        next = __fadd_rn(u0, __fmul_rn(sc.dt, k_val));
      } else {
        ksum = __fadd_rn(ksum, k_val);
        u0 = __fadd_rn(u0, __fmul_rn(sc.dt_sixth, ksum));
        next = u0;
      }
      // conservative: the barrier above also ended this stage's reads of
      // s_u (they precede the flux store), so s_u may be overwritten; the
      // next stage's flux stores come after the barrier below
      s_u[j] = next;
      __syncthreads();
    }
  }
  if (live) u_out[b * nx + j] = u0;
}

template <int EQ, bool CONS>
int launch(const float* u, float* out, const Scheme& sc, cudaStream_t stream) {
  const int threads = sc.rows * sc.nx;
  const int blocks = (sc.batch + sc.rows - 1) / sc.rows;
  const int smem_bytes = (int)sizeof(float) * 2 * sc.rows * sc.nx;
  fused_rk4_kernel<EQ, CONS><<<blocks, threads, smem_bytes, stream>>>(u, out, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// meta: equation code, conservative, nx, rows (trajectories per block),
//       n_orders, size[3], tap0[3].
// coefs: [3][16] floats, the orders' coefficients in tap order.
// scalars: dx, eta, dt/2, dt, dt/6.
// Returns cudaGetLastError() after the launch. Burgers (code 0) is forced
// and refused.
extern "C" int pde_fused_rk4(const float* u, float* out, int batch, int num_steps,
                             const int* meta, const float* coefs, const float* scalars,
                             void* stream) {
  if (batch == 0) return 0;
  Scheme sc;
  sc.nx = meta[2];
  sc.rows = meta[3];
  sc.n_orders = meta[4];
  for (int o = 0; o < kMaxOrders; ++o) {
    sc.size[o] = meta[5 + o];
    sc.tap0[o] = meta[8 + o];
    if (sc.size[o] > kMaxTaps) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < kMaxTaps; ++s) sc.coef[o][s] = coefs[o * kMaxTaps + s];
  }
  sc.dx = scalars[0];
  sc.eta = scalars[1];
  sc.half_dt = scalars[2];
  sc.dt = scalars[3];
  sc.dt_sixth = scalars[4];
  sc.num_steps = num_steps;
  sc.batch = batch;
  if (sc.rows < 1 || sc.rows * sc.nx > 1024) return (int)cudaErrorInvalidValue;
  const bool cons = meta[1] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (meta[0]) {
    case 1:
      return cons ? launch<1, true>(u, out, sc, s) : launch<1, false>(u, out, sc, s);
    case 2:
      return cons ? launch<2, true>(u, out, sc, s) : launch<2, false>(u, out, sc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
