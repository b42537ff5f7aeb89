// fused_rhs: one RHS evaluation of the learned stencil model.
//
// Replaces make_fused_rhs in pde_superresolution_tpu/ops/pallas_kernels.py
// (the pallas_call at line 249). From u [B, nx] and the model's per-point
// coefficients {order: [B, nx, S]} it forms, for each derivative order, the
// tap sum sum_s c[b, j, s] * u[b, (j + tap0 + s) mod nx], then either the
// flux J and the conservative divergence -(J[j] - J[j-1]) / dx or the
// equation of motion, and adds the forcing field f [B, nx] when given.
//
// What bounds it on the H100: memory at large batch, and the launch plus
// one round trip to device memory at small batch. At B=4096, nx=128 for KS
// (3 orders x 6 taps) one call reads u and 18 coefficient arrays and writes
// u_t: 20 float32 arrays of 2 MB, 42 MB, against some 60 flops per point,
// about 0.8 flop per byte, far below the card's float32 balance point.
//
// Design: a block covers `rows` whole trajectories (or, where one
// trajectory's inputs exceed the block's shared memory, a segment of one),
// one thread per point. For each order its coefficients [rows, nx, S] are
// one contiguous span, which the block's threads copy once into shared
// memory with cp.async, 16 bytes a thread, neighbouring threads from
// neighbouring addresses: no register holds the data, so every copy of a
// thread is in flight at once and the kernel needs 32 registers (16 blocks
// of 128 threads to an SM). A thread then reads its point's row in 16- or
// 8-byte loads, which fall on distinct banks (rows of 8 taps or a multiple
// are swizzled by 16-byte piece so that they do too). The u rows come in
// once, in coalesced loads, each value stored also into the periodic halo
// it belongs to, so the taps need no index wrap. Each face's flux is
// computed once, into shared memory, and the divergence reads J[j] and
// J[j-1] after one barrier (a segment computes the one face left of it
// beside). Python (rhs_launch) sizes the block: one trajectory of 128
// points, so that at B=256 every SM has loads in flight and at large batch
// 16 blocks share an SM, each in another phase. The tap sums keep their
// order and their fmaf, as before. The equation form (3 equations x direct
// or conservative) and the forcing add are compile-time switches.

#include <cuda_runtime.h>

#include <cstdint>

#include "equations.cuh"

namespace {

using pde::kMaxOrders;

struct Rhs {
  const float* c[kMaxOrders];
  int size[kMaxOrders];
  int tap0[kMaxOrders];
  int n_orders;
  int batch, nx;
  int rows;   // trajectories per block (1 when a trajectory is split)
  int seg;    // points of a trajectory per block: nx, or a segment of it
  int parts;  // blocks per trajectory
  int halo;   // periodic points on each side of a row's u window
  float dx, eta;
};

__device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

// Where 16-byte piece q of an order's coefficients lies in shared memory.
// With S a multiple of 8 a point's row is 2 or more pieces, and the 8
// threads of a quarter warp, reading piece k of 8 consecutive rows, would
// fall on 4 of the 8 bank groups; swapping the pieces of every odd group of
// 8 with their neighbours spreads them over all 8.
__device__ __forceinline__ int piece(int q, bool swizzle) {
  return swizzle ? q ^ ((q >> 3) & 1) : q;
}

// Asynchronous copies from device memory to shared memory (cp.async): no
// register holds the data, and a thread's copies are all in flight at once.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// sum_s c[p S + s] * w[s], accumulated from s = 0 up, the coefficients of
// point p read from shared memory in 16- or 8-byte loads where S allows
__device__ __forceinline__ float tap_sum(const float* region, int p, const float* w, int size) {
  float acc;
  const float* c = region + p * size;
  if ((size & 3) == 0) {
    const float4* c4 = reinterpret_cast<const float4*>(region);
    const int q0 = p * (size >> 2);
    const bool swizzle = (size & 7) == 0;
    float4 v = c4[piece(q0, swizzle)];
    acc = fmaf(v.w, w[3], fmaf(v.z, w[2], fmaf(v.y, w[1], __fmul_rn(v.x, w[0]))));
    for (int q = 1; q < (size >> 2); ++q) {
      v = c4[piece(q0 + q, swizzle)];
      const float* wq = w + 4 * q;
      acc = fmaf(v.w, wq[3], fmaf(v.z, wq[2], fmaf(v.y, wq[1], fmaf(v.x, wq[0], acc))));
    }
  } else if ((size & 1) == 0) {
    const float2* c2 = reinterpret_cast<const float2*>(c);
    float2 v = c2[0];
    acc = fmaf(v.y, w[1], __fmul_rn(v.x, w[0]));
    for (int q = 1; q < (size >> 1); ++q) {
      v = c2[q];
      acc = fmaf(v.y, w[2 * q + 1], fmaf(v.x, w[2 * q], acc));
    }
  } else {
    acc = __fmul_rn(c[0], w[0]);
    for (int s = 1; s < size; ++s) acc = fmaf(c[s], w[s], acc);
  }
  return acc;
}

template <int EQ, bool CONS, bool FORCED>
__global__ void __launch_bounds__(1024)
    fused_rhs_kernel(const float* __restrict__ u, Rhs st, const float* __restrict__ f,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int nx = st.nx, seg = st.seg, halo = st.halo;
  const int group = blockIdx.x / st.parts;
  const int j0 = (blockIdx.x - group * st.parts) * seg;
  const int b0 = group * st.rows;
  const int n_rows = min(st.rows, st.batch - b0);
  const int n_j = min(seg, nx - j0);
  const bool whole = seg == nx;
  const int window = seg + 2 * halo;
  const int x = threadIdx.x, r = threadIdx.y;
  const int tid = r * blockDim.x + x, threads = blockDim.x * blockDim.y;
  const int n_pts = whole ? n_rows * nx : n_j;
  const long long first = (long long)b0 * nx + j0;  // the block's first point
  float* s_u = smem;                        // [rows][seg + 2 halo]
  float* s_flux = s_u + st.rows * window;   // [rows][1 + seg]: left face first
  float* s_c = smem + align4(st.rows * (window + seg + 1));  // per order [rows seg][S]

  // the coefficient spans, as they lie in device memory, by cp.async: in
  // 16-byte pieces where the span starts on 16 bytes, else 4-byte ones
  const bool live = r < n_rows && x < n_j;
  const long long b = b0 + r;
  const long long idx = b * nx + j0 + x;
  float* c_order[kMaxOrders];
#pragma unroll
  for (int o = 0, off = 0; o < kMaxOrders; ++o) {
    c_order[o] = s_c + off;
    if (o < st.n_orders) {
      const int S = st.size[o];
      const float* src = st.c[o] + first * S;
      const int len = n_pts * S;
      const bool swizzle = (S & 7) == 0;
      int done = 0;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        done = len & ~3;
        for (int q = tid; 4 * q < done; q += threads) {
          copy16(c_order[o] + 4 * piece(q, swizzle), src + 4 * q);
        }
      }
      for (int e = done + tid; e < len; e += threads) {
        copy4(c_order[o] + 4 * piece(e >> 2, swizzle) + (e & 3), src + e);
      }
      off += align4(st.rows * seg * S);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  float forcing = 0.f;
  if (FORCED && live) forcing = __ldg(f + idx);
  // whole rows read each u value once and store it also into the halo
  // slots it belongs to; a segment reads its window with the wrap
  const bool copies = whole && halo <= nx;
  for (int i = x; r < n_rows && i < (copies ? nx : n_j + 2 * halo); i += blockDim.x) {
    float* w = s_u + r * window;
    const float v = __ldg(u + b * nx + (copies ? i : pde::wrap(j0 - halo + i, nx)));
    if (copies) {
      w[halo + i] = v;
      if (i < halo) w[halo + nx + i] = v;
      if (i >= nx - halo) w[i - nx + halo] = v;
    } else {
      w[i] = v;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float* w = s_u + r * window + halo + x;  // w[t]: u at the point's tap t
  float result = 0.f;
  if (live) {
    float v[kMaxOrders];
#pragma unroll
    for (int o = 0; o < kMaxOrders; ++o) {
      if (o < st.n_orders) {
        const int S = st.size[o];
        v[o] = tap_sum(c_order[o], r * seg + x, w + st.tap0[o], S);
      }
    }
    if (CONS) {
      const float J = pde::flux<EQ>(v, st.eta);
      s_flux[r * (seg + 1) + 1 + x] = J;
      if (whole && x == nx - 1) s_flux[r * (seg + 1)] = J;
    } else {
      result = pde::equation_of_motion<EQ>(w[0], v, st.eta);
    }
  }
  if (CONS) {
    if (!whole && tid == 0) {
      // a segment's left face: the flux at the point left of it, whose
      // coefficients no other thread of this block holds
      const int jl = j0 == 0 ? nx - 1 : j0 - 1;
      float v[kMaxOrders];
#pragma unroll
      for (int o = 0; o < kMaxOrders; ++o) {
        if (o < st.n_orders) {
          const int S = st.size[o];
          const float* c = st.c[o] + ((long long)b0 * nx + jl) * S;
          const float* wl = s_u + halo - 1 + st.tap0[o];
          float acc = __fmul_rn(c[0], wl[0]);
          for (int s = 1; s < S; ++s) acc = fmaf(c[s], wl[s], acc);
          v[o] = acc;
        }
      }
      s_flux[0] = pde::flux<EQ>(v, st.eta);
    }
    __syncthreads();
    if (live) {
      const float* J = s_flux + r * (seg + 1) + x;
      result = pde::divergence(J[1], J[0], st.dx);
    }
  }
  if (live) out[idx] = FORCED ? __fadd_rn(result, forcing) : result;
}

template <int EQ, bool CONS, bool FORCED>
int launch(const float* u, const Rhs& st, const float* f, float* out, int threads_x,
           int blocks, int shared_bytes, cudaStream_t stream) {
  fused_rhs_kernel<EQ, CONS, FORCED>
      <<<blocks, dim3(threads_x, st.rows), shared_bytes, stream>>>(u, st, f, out);
  return (int)cudaGetLastError();
}

template <int EQ>
int dispatch(bool cons, const float* u, const Rhs& st, const float* f, float* out,
             int threads_x, int blocks, int shared_bytes, cudaStream_t s) {
  if (cons) {
    return f ? launch<EQ, true, true>(u, st, f, out, threads_x, blocks, shared_bytes, s)
             : launch<EQ, true, false>(u, st, f, out, threads_x, blocks, shared_bytes, s);
  }
  return f ? launch<EQ, false, true>(u, st, f, out, threads_x, blocks, shared_bytes, s)
           : launch<EQ, false, false>(u, st, f, out, threads_x, blocks, shared_bytes, s);
}

}  // namespace

// meta: equation code, conservative, n_orders, size[3], tap0[3], then the
// geometry of fused_kernels.rhs_launch: rows, seg, parts, halo, threads_x,
// blocks, shared-memory bytes. f may be null (no forcing). Returns
// cudaGetLastError() after the launch.
extern "C" int pde_fused_rhs(const float* u, const float* c0, const float* c1,
                             const float* c2, const float* f, float* out, int batch,
                             int nx, const int* meta, float dx, float eta,
                             void* stream) {
  if ((long long)batch * nx == 0) return 0;
  Rhs st;
  st.c[0] = c0;
  st.c[1] = c1;
  st.c[2] = c2;
  st.n_orders = meta[2];
  for (int o = 0; o < kMaxOrders; ++o) {
    st.size[o] = meta[3 + o];
    st.tap0[o] = meta[6 + o];
  }
  st.batch = batch;
  st.nx = nx;
  st.rows = meta[9];
  st.seg = meta[10];
  st.parts = meta[11];
  st.halo = meta[12];
  st.dx = dx;
  st.eta = eta;
  const int threads_x = meta[13], blocks = meta[14], shared_bytes = meta[15];
  if (st.rows < 1 || st.seg < 1 || threads_x < st.seg || threads_x * st.rows > 1024 ||
      (st.rows > 1 && st.seg != nx) || (long long)st.parts * st.seg < nx) {
    return (int)cudaErrorInvalidValue;
  }
  const bool cons = meta[1] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (meta[0]) {
    case 0: return dispatch<0>(cons, u, st, f, out, threads_x, blocks, shared_bytes, s);
    case 1: return dispatch<1>(cons, u, st, f, out, threads_x, blocks, shared_bytes, s);
    case 2: return dispatch<2>(cons, u, st, f, out, threads_x, blocks, shared_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pde_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One block of one warp that does nothing: its event-timed launch is the
// floor under any kernel's time on the card.
extern "C" int pde_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
