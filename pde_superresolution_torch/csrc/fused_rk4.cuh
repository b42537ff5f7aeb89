// fused_rk4: num_steps whole RK4 steps of the fixed classic-stencil baseline
// scheme in one launch. Shared by fused_rk4.cu (the C entry and the rows
// form), fused_rk4_{classic,scheme}_{kdv,ks}.cu (the register forms) and
// fused_rk4_block_{classic,scheme}_{kdv,ks}.cu (the block form), one source
// per form and equation so that nvcc compiles them in parallel.
//
// Replaces make_fused_rk4 in pde_superresolution_tpu/ops/pallas_kernels.py
// (the pallas_call at line 374), which builds any classic scheme from
// accuracy_order/stencil_size and runs it at any nx % 128 == 0; this kernel
// takes every such scheme at every nx % 32 == 0. Each RHS
// evaluation is, per derivative order, a tap sum of constant coefficients
// against periodic shifts of u, then the flux divergence (conservative form)
// or the equation of motion (direct form). Unforced equations only (KdV,
// KS), as the TPU kernel. The tap sums run in tap order with every product
// and sum rounded on its own (_rn, no contraction into FMAs), so every form
// equals its plain version (fused_kernels.fused_rk4_plain) bit for bit.
//
// What bounds it on the H100: instruction issue at large batch, and the
// latency of the chain of 4 x num_steps dependent stages at small batch.
// The state is read once and written once (8 bytes a point), microseconds at
// any batch. A stage costs each point two rounded operations per tap, the
// flux or equation of motion, an IEEE division by dx for the conservative
// divergence and the stage combine.
//
// Four forms, chosen in Python (fused_kernels.rk4_launch) from nx and the
// scheme:
//  * register, classic (fused_rk4_classic.cuh): the four accuracy-order-2
//    tap layouts of make_fused_rk4's default (Layout below) compiled in. A
//    warp owns a trajectory, and lane l of the ring's L lanes holds the P
//    consecutive points [l P, l P + P) in registers: the step's start value,
//    the running k1 + 2 k2 + 2 k3 + k4 and the stage input. A tap's neighbour
//    value beyond the lane's own points comes from a neighbour lane through
//    __shfl_sync; lane 0's left neighbour is lane L - 1, so the periodic wrap
//    costs nothing. Every tap loop unrolls and each coefficient is a
//    constant-bank operand of its multiply. No shared memory and no barrier:
//    one stage follows the last through register data dependence alone.
//  * register, any scheme (fused_rk4_scheme.cuh): the same ownership, with the
//    taps taken at run time, up to 24 points a lane (nx <= 768: at 32 the
//    six rows of registers a lane holds spill). Per order the lane's P values are shifted to the
//    first tap (one register move per point and a shuffle per shift), then
//    one point at a time through the taps; each coefficient is read from
//    the kernel's parameters (__grid_constant__, a uniform constant load).
//    The tap loop runs as many times as the order has taps: no tap is
//    padded with a zero coefficient (0 x inf would be NaN where the plain
//    version gives inf).
//  * block (fused_rk4_block.cuh): above 1024 points (768 for a scheme whose
//    taps are taken at run time), and for the wide schemes past the rows
//    form's shared memory, the same ownership
//    widened to the warps of a block, or of a thread-block cluster of up to
//    16 blocks: the state in registers, P points a lane, neighbours inside a
//    warp by shuffles, only the warps' edges through shared memory (double
//    buffered, one cluster barrier a stage; a neighbour block's edges by
//    distributed shared memory). The classic layouts compiled in at
//    kBlockClassicPoints points a lane, any other scheme's taps at run time
//    at 4 or 8 (coefficients copied once into shared memory).
//  * rows (fused_rk4.cu): a wide scheme (more than kMaxTaps taps an order,
//    or a reach beyond kReach) whose rows fit a block (a reach beyond the
//    grid too: 80 taps on 32 points reach 40 points) keeps the stage input (with a periodic halo of the scheme's reach at
//    both ends, every periodic copy), the fluxes, the step's start value and
//    the k sum in shared memory, 16 nx + 8 halo bytes, a block a trajectory,
//    its taps at run time and its coefficients copied once into shared
//    memory; barriers separate the tap sums, the divergence and the stage
//    combine. On an H100 it ran 40 taps at nx 128 3.3x faster than the block
//    form's run-time taps. Past a block's shared memory the wide schemes take
//    the block form.
//
// Points per lane: the register forms are built for the P of dispatch_points.
// nx = 32 P' runs at the smallest P >= P' that divides nx, on L = nx / P
// lanes (17 to 32 of them); the other lanes of the warp shuffle along and
// store nothing. A point's arithmetic does not depend on P or L.

#pragma once

#include <cuda_runtime.h>

#include "equations.cuh"

namespace pde_rk4 {

using pde::kMaxOrders;

// the register forms' schemes, whose coefficients are kernel parameters (the
// block and rows forms take any other with its coefficients in global memory)
constexpr int kMaxTaps = 32;   // fused_kernels.MAX_TAPS
constexpr int kReach = 16;     // fused_kernels.RK4_REACH: taps lie in [-kReach, kReach]
constexpr int kSlots = 2 * kReach + 1;  // coefficient slots per order, by tap
constexpr int kMaxWarps = 8;   // fused_kernels.RK4_MAX_WARPS: warps per block
constexpr int kRowsThreads = 256;  // fused_kernels.RK4_ROWS_THREADS: the rows form's block
// the block form: warps a block at most (the kernels' thread bound, which
// leaves 128 registers a thread), blocks a cluster at most, the points a
// lane of its compiled-tap kernel and the most of its run-time-tap kernel
// (1, 2, 4 or 8)
constexpr int kBlockMaxWarps = 16;     // fused_kernels.RK4_BLOCK_MAX_WARPS
constexpr int kBlockMaxCluster = 16;   // fused_kernels.MAX_CLUSTER
constexpr int kBlockClassicPoints = 8;   // fused_kernels.RK4_BLOCK_CLASSIC_POINTS
constexpr int kBlockSchemePoints = 8;    // fused_kernels.RK4_BLOCK_SCHEME_POINTS
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

// The scheme and the step. coef[o][t + kReach] is order o's coefficient of
// tap t; slots outside the order's taps are never read.
struct Scalars {
  float coef[kMaxOrders][kSlots];
  int orders, tap0[kMaxOrders], size[kMaxOrders];
  int lanes;  // L: lanes of the ring in the register forms (nx = L P)
  float dx, eta, half_dt, dt, dt_sixth;
};

// i in [-n, 2 n) wrapped into [0, n)
__device__ __forceinline__ int ring(int i, int n) {
  return i >= n ? i - n : (i < 0 ? i + n : i);
}

// The flux (conservative) or u_t (direct) built up order by order from the
// tap sum v of order position o, in the operations and order of
// equations.cuh's flux and equation_of_motion (position, not order, picks
// the term).
template <int EQ, bool CONS>
__device__ __forceinline__ float fold(int o, float acc, float v, float u) {
  if (CONS) {
    if (o == 0) return __fmul_rn(EQ == 1 ? 3.0f : 0.5f, __fmul_rn(v, v));
    return __fadd_rn(acc, v);
  }
  if (o == 0) return EQ == 1 ? __fmul_rn(__fmul_rn(-6.0f, u), v) : __fmul_rn(-u, v);
  return __fsub_rn(acc, v);
}

// The RK4 stage combine, in the plain version's operations: from the stage's
// k, update the k sum and the step's start value and return the next stage
// input.
__device__ __forceinline__ float combine(int stage, float k, float& u0, float& ksum,
                                         float half_dt, float dt, float dt_sixth) {
  if (stage == 0) {
    ksum = k;
    return __fadd_rn(u0, __fmul_rn(half_dt, k));
  }
  if (stage == 1) {
    ksum = __fadd_rn(ksum, __fmul_rn(2.0f, k));
    return __fadd_rn(u0, __fmul_rn(half_dt, k));
  }
  if (stage == 2) {
    ksum = __fadd_rn(ksum, __fmul_rn(2.0f, k));
    return __fadd_rn(u0, __fmul_rn(dt, k));
  }
  ksum = __fadd_rn(ksum, k);
  u0 = __fadd_rn(u0, __fmul_rn(dt_sixth, ksum));
  return u0;
}

// The block form's geometry: a trajectory over `cluster` blocks of `warps`
// warps; its nx / P lanes `base` a warp, one more in the first `extra` warps
// of the trajectory; each warp's tail of `left` points and head of `right`
// points in its block's edge buffer.
struct Block {
  int nx, warps, cluster, base, extra, left, right;
};

struct Launch {
  const float* u;
  float* out;
  int batch, num_steps, warps;
  cudaStream_t stream;
};

// The register forms' launches (fused_rk4_classic_{kdv,ks}.cu,
// fused_rk4_scheme_{kdv,ks}.cu):
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a P
// they are not built for (the scheme form stops at kSchemeMaxPoints).
constexpr int kSchemeMaxPoints = 24;  // fused_kernels.RK4_SCHEME_MAX_POINTS
int launch_classic_kdv(bool cons, int points_per_lane, const Scalars& sc, const Launch& l);
int launch_classic_ks(bool cons, int points_per_lane, const Scalars& sc, const Launch& l);
int launch_scheme_kdv(bool cons, int points_per_lane, const Scalars& sc, const Launch& l);
int launch_scheme_ks(bool cons, int points_per_lane, const Scalars& sc, const Launch& l);

// The block form's launches (fused_rk4_block_{classic,scheme}_{kdv,ks}.cu):
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a P
// they are not built for. wide_coefs: every order's coefficients in tap
// order (the wide schemes), or null (the kernel parameters' Scalars.coef).
int launch_block_classic_kdv(bool cons, int points_per_lane, const Scalars& sc, const Block& g,
                             const Launch& l, const float* wide_coefs, int shared_bytes);
int launch_block_classic_ks(bool cons, int points_per_lane, const Scalars& sc, const Block& g,
                            const Launch& l, const float* wide_coefs, int shared_bytes);
int launch_block_scheme_kdv(bool cons, int points_per_lane, const Scalars& sc, const Block& g,
                            const Launch& l, const float* wide_coefs, int shared_bytes);
int launch_block_scheme_ks(bool cons, int points_per_lane, const Scalars& sc, const Block& g,
                           const Launch& l, const float* wide_coefs, int shared_bytes);

// Dispatch over the points per lane the register forms are built for
// (fused_kernels.RK4_POINTS_PER_LANE, up to MAX_P).
template <template <int, bool, int> class Kernel, int EQ, bool CONS, int MAX_P>
int dispatch_points(int p, const Scalars& sc, const Launch& l) {
  if (p > MAX_P) return (int)cudaErrorInvalidValue;
  switch (p) {
    case 1: return Kernel<EQ, CONS, 1>::run(sc, l);
    case 2: return Kernel<EQ, CONS, 2>::run(sc, l);
    case 3: return Kernel<EQ, CONS, 3>::run(sc, l);
    case 4: return Kernel<EQ, CONS, 4>::run(sc, l);
    case 5: return Kernel<EQ, CONS, 5>::run(sc, l);
    case 6: return Kernel<EQ, CONS, 6>::run(sc, l);
    case 8: return Kernel<EQ, CONS, 8>::run(sc, l);
    case 12: return Kernel<EQ, CONS, 12>::run(sc, l);
    case 16: return Kernel<EQ, CONS, 16>::run(sc, l);
    case 24: return Kernel<EQ, CONS, 24>::run(sc, l);
    case 32:
      if constexpr (MAX_P >= 32) {
        return Kernel<EQ, CONS, 32>::run(sc, l);
      } else {
        return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pde_rk4
