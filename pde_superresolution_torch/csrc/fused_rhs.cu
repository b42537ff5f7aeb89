// fused_rhs: one RHS evaluation of the learned stencil model.
//
// Replaces make_fused_rhs in pde_superresolution_tpu/ops/pallas_kernels.py
// (the pallas_call at line 249). From u [B, nx] and the model's per-point
// coefficients {order: [B, nx, S]} it forms, for each derivative order, the
// tap sum sum_s c[b, j, s] * u[b, (j + tap0 + s) mod nx], then either the
// flux J and the conservative divergence -(J[j] - J[j-1]) / dx or the
// equation of motion, and adds the forcing field f [B, nx] when given.
//
// What bounds it on the H100: memory. At B=256, nx=128 for KS (3 orders x 6
// taps) one call reads u and 18 coefficient arrays and writes u_t: 20
// float32 arrays of 131 KB, 2.6 MB, against some 60 flops per point, about
// 0.8 flop per byte, far below the card's float32 balance point.
//
// Design: one thread per output point (b, j) on a flat 1-D grid, so any B
// and nx work; neighbouring threads read neighbouring coefficient rows, so
// the loads coalesce. Taps index u modulo nx directly (L1 serves the reuse),
// with no roll buffers. The conservative divergence needs the left face
// J[j-1]: each thread recomputes it rather than staging J in shared memory
// behind a barrier. That doubles the tap arithmetic, which costs nothing in
// a memory-bound kernel, and the left face's coefficient row is the
// neighbouring thread's, so it comes from L1/L2 and is not read from DRAM a
// second time. The kernel stays a single pass with no limit on nx.
// The equation form (3 equations x direct/conservative) and the forcing add
// are compile-time switches.

#include <cuda_runtime.h>

#include "equations.cuh"

namespace {

using pde::kMaxOrders;

struct Stencils {
  const float* c[kMaxOrders];
  int size[kMaxOrders];
  int tap0[kMaxOrders];
  int n_orders;
};

// sum_s c_row[s] * u[(j + tap0 + s) mod nx], accumulated from s = 0 up.
__device__ __forceinline__ float tap_sum(const float* __restrict__ ub,
                                         const float* __restrict__ c_row,
                                         int size, int tap0, int j, int nx) {
  int k = pde::wrap(j + tap0, nx);
  float acc = __fmul_rn(c_row[0], ub[k]);
  for (int s = 1; s < size; ++s) {
    k = (k + 1 == nx) ? 0 : k + 1;
    acc = fmaf(c_row[s], ub[k], acc);
  }
  return acc;
}

__device__ __forceinline__ void stencil_values(const float* __restrict__ ub,
                                               const Stencils& st, long long point,
                                               int j, int nx, float* v) {
#pragma unroll
  for (int o = 0; o < kMaxOrders; ++o) {
    if (o < st.n_orders) {
      v[o] = tap_sum(ub, st.c[o] + point * st.size[o], st.size[o], st.tap0[o], j, nx);
    }
  }
}

template <int EQ, bool CONS, bool FORCED>
__global__ void fused_rhs_kernel(const float* __restrict__ u, Stencils st,
                                 const float* __restrict__ f, float* __restrict__ out,
                                 int batch, int nx, float dx, float eta) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * nx) return;
  const int b = (int)(idx / nx);
  const int j = (int)(idx - (long long)b * nx);
  const float* ub = u + (long long)b * nx;
  float v[kMaxOrders];
  stencil_values(ub, st, idx, j, nx, v);
  float result;
  if (CONS) {
    const int jl = j == 0 ? nx - 1 : j - 1;
    float vl[kMaxOrders];
    stencil_values(ub, st, (long long)b * nx + jl, jl, nx, vl);
    result = pde::divergence(pde::flux<EQ>(v, eta), pde::flux<EQ>(vl, eta), dx);
  } else {
    result = pde::equation_of_motion<EQ>(ub[j], v, eta);
  }
  if (FORCED) result = __fadd_rn(result, f[idx]);
  out[idx] = result;
}

template <int EQ, bool CONS, bool FORCED>
int launch(const float* u, const Stencils& st, const float* f, float* out, int batch,
           int nx, float dx, float eta, cudaStream_t stream) {
  const int threads = 256;
  const long long n = (long long)batch * nx;
  const long long blocks = (n + threads - 1) / threads;
  fused_rhs_kernel<EQ, CONS, FORCED>
      <<<(unsigned)blocks, threads, 0, stream>>>(u, st, f, out, batch, nx, dx, eta);
  return (int)cudaGetLastError();
}

template <int EQ>
int dispatch(bool cons, const float* u, const Stencils& st, const float* f, float* out,
             int batch, int nx, float dx, float eta, cudaStream_t stream) {
  if (cons) {
    return f ? launch<EQ, true, true>(u, st, f, out, batch, nx, dx, eta, stream)
             : launch<EQ, true, false>(u, st, f, out, batch, nx, dx, eta, stream);
  }
  return f ? launch<EQ, false, true>(u, st, f, out, batch, nx, dx, eta, stream)
           : launch<EQ, false, false>(u, st, f, out, batch, nx, dx, eta, stream);
}

}  // namespace

// meta: equation code, conservative, n_orders, size[3], tap0[3].
// f may be null (no forcing). Returns cudaGetLastError() after the launch.
extern "C" int pde_fused_rhs(const float* u, const float* c0, const float* c1,
                             const float* c2, const float* f, float* out, int batch,
                             int nx, const int* meta, float dx, float eta,
                             void* stream) {
  if ((long long)batch * nx == 0) return 0;
  Stencils st;
  st.c[0] = c0;
  st.c[1] = c1;
  st.c[2] = c2;
  st.n_orders = meta[2];
  for (int o = 0; o < kMaxOrders; ++o) {
    st.size[o] = meta[3 + o];
    st.tap0[o] = meta[6 + o];
  }
  const bool cons = meta[1] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (meta[0]) {
    case 0: return dispatch<0>(cons, u, st, f, out, batch, nx, dx, eta, s);
    case 1: return dispatch<1>(cons, u, st, f, out, batch, nx, dx, eta, s);
    case 2: return dispatch<2>(cons, u, st, f, out, batch, nx, dx, eta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pde_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
