// fused_rk4, the block form: a trajectory too long for one warp (or a scheme
// too wide for the register forms) over the warps of a block, or of a
// thread-block cluster's blocks. See fused_rk4.cuh for the kernel's forms.
// Instantiated per equation and tap form in fused_rk4_block_{classic,scheme}_
// {kdv,ks}.cu, so that nvcc compiles the four in parallel.
//
// The state lives in registers, as in the register forms: warp g of the
// trajectory owns the consecutive points [a_g, a_g + n_g), its lane l the P
// points from a_g + l P (the step's start value, the k sum and the stage
// input). The trajectory's nx / P lanes are dealt out to the cluster's
// C x W warps evenly, `base` lanes each and one more in the first `extra`
// warps; block r of the cluster holds warps r W to r W + W - 1. Inside a warp
// a neighbour's values come by __shfl_sync. Across warps only the edges go
// through shared memory: each warp publishes its first `right` points (its
// head, read by its left neighbour) and its last `left` points (its tail,
// read by its right neighbour), `left` being the scheme's reach to the left
// and one point more, for the conservative divergence's left face, whose
// flux each lane computes itself. A warp's neighbours may lie in another
// block of the cluster: their edges are read from that block's shared memory
// (ld.shared::cluster). The edge buffer is double-buffered by stage, so one
// barrier a stage suffices: barrier.cluster.arrive after the edges are
// published, barrier.cluster.wait before they are read (a cluster of one
// block launches as a cluster too). A stage's writes to buffer b happen
// after the previous stage's barrier, which every warp passes only after its
// reads of buffer b two stages back.
//
// Two tap forms:
//  * compiled (fused_rk4_block_kernel): the classic layouts of Layout, P =
//    kBlockClassicPoints (8: on an H100 13-21% faster than 16 at nx 2048). The lane's window of stage inputs is assembled
//    once a stage (own registers, shuffles, and at the warp's ends the
//    neighbours' edges); the points whose taps stay inside the lane are
//    summed between the barrier's arrive and its wait.
//  * run time (fused_rk4_block_scheme_kernel): any scheme of any number of
//    taps and reach (within a warp's points), P = 4 or 8 (kBlockSchemePoints:
//    at 16 its register rows spill; at 2 ptxas kept an 8-byte stack frame). As fused_rk4_scheme.cuh, the lane's
//    values are shifted to the first tap and then through the taps, one
//    shuffle a shift, but the orders' taps are walked once, from the
//    leftmost to the rightmost, every order summing the taps it has (in tap
//    order; each order's coefficient of the next tap fetched a tap ahead,
//    its sums kept by a select where the tap is not its own), so the orders
//    share each shift. After the barrier each warp
//    copies its neighbours' edges into its own shared memory; the lane at
//    the warp's end takes the value shifted in from that copy, fetched a
//    shift ahead. The coefficients are copied once into shared memory (from
//    the kernel's parameters, or from global memory for the wide schemes).
//
// Both kernels name a minimum of one block an SM in their launch bounds:
// with the thread bound alone ptxas traded registers for occupancy and
// spilled (64 registers and an 8-byte frame at P = 8).
//
// Every product and sum is rounded on its own and summed in tap order, the
// first tap's product as it is, so both forms equal the plain version
// (fused_kernels.fused_rk4_plain) bit for bit, as the register forms do.

#pragma once

#include <cstdint>

#include "fused_rk4.cuh"

namespace pde_rk4 {
namespace {

// shared::cluster address of the shared::cta address `local` in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ float load_cluster(uint32_t address) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(address) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return (int)rank;
}

// A warp's place in its trajectory and its neighbours' edges. Edge buffer:
// [2 stages][W warps][right + left] floats in each block, a warp's head
// first, then its tail (the run-time-tap kernel lays a third [W][left +
// right] after it: each warp's copy of its neighbours' edges).
template <int P>
struct WarpEdges {
  int lanes;        // the warp's lanes (the rest of the warp shuffles along, stores nothing)
  int first;        // the warp's first point in the trajectory
  int points;       // lanes x P
  int left, right;  // tail and head lengths
  int stride;       // floats between the two buffers
  float* own;       // this warp's head in buffer 0
  uint32_t left_end;  // shared::cluster address just past the left neighbour's tail, buffer 0
  uint32_t right_head;  // shared::cluster address of the right neighbour's head, buffer 0

  __device__ WarpEdges(float* edges, const Block& g, int rank, int warp) {
    const int total = g.cluster * g.warps, w = rank * g.warps + warp;
    lanes = g.base + (w < g.extra);
    first = P * (w * g.base + (w < g.extra ? w : g.extra));
    points = lanes * P;
    left = g.left;
    right = g.right;
    const int e = left + right;
    stride = g.warps * e;
    own = edges + warp * e;
    const int wl = w == 0 ? total - 1 : w - 1, wr = w + 1 == total ? 0 : w + 1;
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(edges);
    left_end = map_rank(base + 4u * ((wl % g.warps) * e + e), wl / g.warps);
    right_head = map_rank(base + 4u * ((wr % g.warps) * e), wr / g.warps);
  }

  // the head and the tail of stage input s (lane `lane`'s P points) into buffer `buf`
  __device__ __forceinline__ void publish(const float (&s)[P], int lane, int buf) const {
    float* dst = own + buf * stride;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int x = lane * P + p, y = x - (points - left);
      if (x < right) dst[x] = s[p];
      if (y >= 0 && y < left) dst[right + y] = s[p];
    }
  }
  // the stage input at warp-relative point x, x in [-left, 0)
  __device__ __forceinline__ float before(int x, int buf) const {
    return load_cluster(left_end + 4u * (buf * stride + x));
  }
  // the stage input at warp-relative point points + x, x in [0, right)
  __device__ __forceinline__ float after(int x, int buf) const {
    return load_cluster(right_head + 4u * (buf * stride + x));
  }
};

// i clamped to an order's taps [0, n) (an order past the scheme's has n = 0
// and offset 0: it reads the first coefficient and sums nothing)
__device__ __forceinline__ int clamp_tap(int i, int n) {
  return i < 0 ? 0 : (i >= n ? (n > 0 ? n - 1 : 0) : i);
}

template <int P>
__device__ __forceinline__ void load_state(const float* src, bool mine, float (&u0)[P],
                                           float (&ksum)[P], float (&s)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    u0[p] = mine ? src[p] : 0.f;
    s[p] = u0[p];
    ksum[p] = 0.f;
  }
}

// The classic layout's flux (conservative) or u_t (direct) at computed point
// j (lane-relative j - c) from the lane's window w of stage inputs at
// lane-relative points [lo, lo + W): order by order the tap sums, in tap order.
template <int EQ, bool CONS, int W>
__device__ __forceinline__ float classic_point(const float (&w)[W], int j, const Scalars& sc) {
  constexpr Layout L = layout(EQ, CONS);
  constexpr int c = CONS ? 1 : 0, lo = L.lo() - c;
  float v[kMaxOrders];
#pragma unroll
  for (int o = 0; o < L.orders; ++o) {
    float acc = __fmul_rn(sc.coef[o][L.tap0[o] + kReach], w[j - c + L.tap0[o] - lo]);
#pragma unroll
    for (int t = 1; t < L.size[o]; ++t)
      acc = __fadd_rn(acc, __fmul_rn(sc.coef[o][L.tap0[o] + t + kReach],
                                     w[j - c + L.tap0[o] + t - lo]));
    v[o] = acc;
  }
  if constexpr (CONS) {
    return pde::flux<EQ>(v, sc.eta);
  } else {
    return pde::equation_of_motion<EQ>(w[j - lo], v, sc.eta);
  }
}

// The taps compiled in (the classic layouts), P points a lane.
template <int EQ, bool CONS, int P>
__global__ void __launch_bounds__(kBlockMaxWarps * 32, 1)
    fused_rk4_block_kernel(const float* __restrict__ u_in, float* __restrict__ out,
                           const __grid_constant__ Scalars sc, const __grid_constant__ Block g,
                           const float* __restrict__ wide_coefs, int num_steps) {
  extern __shared__ float edges[];
  constexpr Layout L = layout(EQ, CONS);
  constexpr int c = CONS ? 1 : 0;
  constexpr int Q = P + c;               // computed points: [-c, P)
  constexpr int lo = L.lo() - c, hi = L.hi();
  constexpr int W = P + hi - lo;          // the window: lane-relative points [lo, P + hi)
  const int lane = threadIdx.x & 31, rank = cluster_rank();
  const WarpEdges<P> ed(edges, g, rank, threadIdx.x >> 5);
  const bool mine = lane < ed.lanes;
  const long long b = blockIdx.x / g.cluster;
  const float* src = u_in + b * g.nx + ed.first + lane * P;

  float u0[P], ksum[P], s[P];
  load_state<P>(src, mine, u0, ksum, s);

  for (int step = 0; step < num_steps; ++step) {
#pragma unroll
    for (int stage = 0; stage < 4; ++stage) {
      const int buf = stage & 1;
#ifdef PDE_FAULT_RK4_SKIP_EDGES
      if (stage != 2)  // planted fault: the third stage reads the first stage's edges
#endif
        ed.publish(s, lane, buf);
      cluster_arrive();
      float w[W], f[Q];
#pragma unroll
      for (int i = 0; i < W; ++i) {  // the lane's own points
        const int q = lo + i;
        if (q >= 0 && q < P) w[i] = s[q];
      }
      // the points whose taps stay inside the lane, while the barrier fills
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (j - c + L.lo() >= 0 && j - c + L.hi() < P) f[j] = classic_point<EQ, CONS>(w, j, sc);
      }
      cluster_wait();
#pragma unroll
      for (int i = 0; i < W; ++i) {  // the other lanes' points, and past the warp's ends the edges
        const int q = lo + i;
        const int d = floor_div(q, P);
        const int e = q - d * P;
        if (d != 0) {
          const int from = lane + d;
          float v = __shfl_sync(kFullMask, s[e], from & 31);
          if (mine && from >= ed.lanes) v = ed.after((from - ed.lanes) * P + e, buf);
          if (mine && from < 0) v = ed.before(from * P + e, buf);
          w[i] = v;
        }
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (!(j - c + L.lo() >= 0 && j - c + L.hi() < P)) f[j] = classic_point<EQ, CONS>(w, j, sc);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float k = CONS ? pde::divergence(f[p + 1], f[p], sc.dx) : f[p];
        s[p] = combine(stage, k, u0[p], ksum[p], sc.half_dt, sc.dt, sc.dt_sixth);
      }
    }
  }
  if (mine) {
    float* dst = out + b * g.nx + ed.first + lane * P;
#pragma unroll
    for (int p = 0; p < P; ++p) dst[p] = u0[p];
  }
  cluster_arrive();  // no block leaves while another may still read its edges
  cluster_wait();
}

// The taps taken at run time, P points a lane.
template <int EQ, bool CONS, int P>
__global__ void __launch_bounds__(kBlockMaxWarps * 32, 1)
    fused_rk4_block_scheme_kernel(const float* __restrict__ u_in, float* __restrict__ out,
                                  const __grid_constant__ Scalars sc,
                                  const __grid_constant__ Block g,
                                  const float* __restrict__ wide_coefs, int num_steps) {
  extern __shared__ float edges[];
  constexpr int c = CONS ? 1 : 0;
  constexpr int Q = P + c;  // computed points: [-c, P)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, rank = cluster_rank();
  const WarpEdges<P> ed(edges, g, rank, warp);
  const bool mine = lane < ed.lanes;
  const bool last = lane == ed.lanes - 1;
  const long long b = blockIdx.x / g.cluster;
  const float* src = u_in + b * g.nx + ed.first + lane * P;

  // after the two edge buffers: each warp's copy of its neighbours' edges,
  // the left neighbour's tail then the right neighbour's head (halo[x],
  // halo = that copy + left: the stage input at warp-relative point x for
  // x < 0, at points + x for x >= 0); then every order's coefficients in
  // tap order, order after order, ordered before their first read by the
  // first barrier
  float* copy = edges + 2 * ed.stride + warp * (ed.left + ed.right);
  const float* halo = copy + ed.left;
  float* coefs = edges + 3 * ed.stride;
  int t0[kMaxOrders], n[kMaxOrders], offset[kMaxOrders];
  int taps = 0, first = 0, end = 0;  // the union of the orders' taps: [first, end]
#pragma unroll
  for (int o = 0; o < kMaxOrders; ++o) {
    t0[o] = o < sc.orders ? sc.tap0[o] : 0;
    n[o] = o < sc.orders ? sc.size[o] : 0;
    offset[o] = o < sc.orders ? taps : 0;
    taps += n[o];
    if (o < sc.orders) {
      first = o == 0 || t0[o] < first ? t0[o] : first;
      end = o == 0 || t0[o] + n[o] - 1 > end ? t0[o] + n[o] - 1 : end;
    }
  }
  for (int i = threadIdx.x; i < taps; i += blockDim.x) {
    int o = 0, start = 0;  // the order of coefficient i, and its first
#pragma unroll
    for (int k = 1; k < kMaxOrders; ++k) {
      if (k < sc.orders && i >= offset[k]) {
        o = k;
        start = offset[k];
      }
    }
    coefs[i] = wide_coefs ? wide_coefs[i] : sc.coef[o][sc.tap0[o] + (i - start) + kReach];
  }

  float u0[P], ksum[P], s[P];
  load_state<P>(src, mine, u0, ksum, s);

  for (int step = 0; step < num_steps; ++step) {
#pragma unroll
    for (int stage = 0; stage < 4; ++stage) {
      const int buf = stage & 1;
#ifdef PDE_FAULT_RK4_SKIP_EDGES
      if (stage != 2)  // planted fault: the third stage reads the first stage's edges
#endif
        ed.publish(s, lane, buf);
      cluster_arrive();
      cluster_wait();
      for (int i = lane; i < ed.left + ed.right; i += 32) {
        copy[i] = i < ed.left ? ed.before(i - ed.left, buf) : ed.after(i - ed.left, buf);
      }
      __syncwarp();
      // the point points + t shifted in at the warp's last lane: this
      // warp's own tail (t < 0) or the right neighbour's head
      const float* tail_end = ed.own + buf * ed.stride + ed.right + ed.left;

      // sh[j]: the stage input at lane-relative point j - c + t, t the
      // current tap; the orders' taps walked once, from first to end,
      // each order summing its own in tap order
      float sh[Q], acc[kMaxOrders][Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
#pragma unroll
        for (int o = 0; o < kMaxOrders; ++o) acc[o][j] = -0.f;  // -0 + x is x: the first tap's product as it is
        if (j >= c) sh[j] = s[j - c];
      }
      if (CONS) {  // point -1: the left lane's last, or the left neighbour's tail
        const float v = __shfl_sync(kFullMask, s[P - 1], (lane - 1) & 31);
        sh[0] = lane == 0 ? halo[-1] : v;
      }
      int t = 0;
      float ahead = lane == 0 && first < 0 ? halo[-1 - c] : 0.f;
      for (; t > first; --t) {  // one point to the right (t -> t - 1): the point
        // t - 1 - c from the left lane, or at the warp's first lane the halo
        float in = __shfl_sync(kFullMask, sh[P - 1], (lane - 1) & 31);
        if (lane == 0) in = ahead;
        if (lane == 0 && t - 1 > first) ahead = halo[t - 2 - c];
#pragma unroll
        for (int j = Q - 1; j > 0; --j) sh[j] = sh[j - 1];
        sh[0] = in;
      }
      for (; t < first; ++t) {  // the first tap right of the point
        float in = __shfl_sync(kFullMask, sh[c], (lane + 1) & 31);
        if (last) in = halo[t];
#pragma unroll
        for (int j = 0; j < Q - 1; ++j) sh[j] = sh[j + 1];
        sh[Q - 1] = in;
      }
      ahead = last && t < ed.right ? (t < 0 ? tail_end[t] : halo[t]) : 0.f;
      // each order's coefficient of tap t (of its nearest tap where t is not
      // one of its own, whose sums are then kept), fetched a tap ahead
      float cf[kMaxOrders];
#pragma unroll
      for (int o = 0; o < kMaxOrders; ++o) cf[o] = coefs[offset[o] + clamp_tap(t - t0[o], n[o])];
      for (;; ++t) {
        float cf_next[kMaxOrders];
#pragma unroll
        for (int o = 0; o < kMaxOrders; ++o) {
          cf_next[o] = coefs[offset[o] + clamp_tap(t + 1 - t0[o], n[o])];
          if (o < sc.orders) {  // uniform: the scheme is the launch's
            const bool on = t >= t0[o] && t < t0[o] + n[o];
#pragma unroll
            for (int j = 0; j < Q; ++j) {
              const float v = __fadd_rn(acc[o][j], __fmul_rn(cf[o], sh[j]));
              acc[o][j] = on ? v : acc[o][j];
            }
          }
        }
        if (t == end) break;
#pragma unroll
        for (int o = 0; o < kMaxOrders; ++o) cf[o] = cf_next[o];
        // one point to the left (t -> t + 1): the point P + t from the right
        // lane, or at the warp's last lane the one fetched a shift ahead
        float in = __shfl_sync(kFullMask, sh[c], (lane + 1) & 31);
        if (last) in = ahead;
        if (last && t + 1 < ed.right) ahead = t + 1 < 0 ? tail_end[t + 1] : halo[t + 1];
#pragma unroll
        for (int j = 0; j < Q - 1; ++j) sh[j] = sh[j + 1];
        sh[Q - 1] = in;
      }
      float f[Q];  // the flux (conservative) or u_t (direct), order by order
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        f[j] = 0.f;
#pragma unroll
        for (int o = 0; o < kMaxOrders; ++o) {
          if (o < sc.orders) f[j] = fold<EQ, CONS>(o, f[j], acc[o][j], CONS ? 0.f : s[j]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float k = CONS ? pde::divergence(f[p + 1], f[p], sc.dx) : f[p];
        s[p] = combine(stage, k, u0[p], ksum[p], sc.half_dt, sc.dt, sc.dt_sixth);
      }
    }
  }
  if (mine) {
    float* dst = out + b * g.nx + ed.first + lane * P;
#pragma unroll
    for (int p = 0; p < P; ++p) dst[p] = u0[p];
  }
  cluster_arrive();  // no block leaves while another may still read its edges
  cluster_wait();
}

// A cluster of g.cluster blocks of g.warps warps a trajectory.
template <typename Kernel>
int launch_block_kernel(Kernel kernel, const Scalars& sc, const Block& g, const Launch& l,
                        const float* wide_coefs, int shared_bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return (int)err;
  if (g.cluster > 8) {  // above the portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)l.batch * g.cluster, 1, 1);
  config.blockDim = dim3(g.warps * 32, 1, 1);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = l.stream;
  config.attrs = attr;
  config.numAttrs = 1;
  if (g.cluster > 1) {  // the cluster must fit the card's processing clusters at least once
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  }
  err = cudaLaunchKernelEx(&config, kernel, l.u, l.out, sc, g, wide_coefs, l.num_steps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int EQ, bool CONS, int P>
struct BlockClassic {
  static int run(const Scalars& sc, const Block& g, const Launch& l, const float* wide_coefs,
                 int shared_bytes) {
    return launch_block_kernel(fused_rk4_block_kernel<EQ, CONS, P>, sc, g, l, wide_coefs,
                               shared_bytes);
  }
};

template <int EQ, bool CONS, int P>
struct BlockScheme {
  static int run(const Scalars& sc, const Block& g, const Launch& l, const float* wide_coefs,
                 int shared_bytes) {
    return launch_block_kernel(fused_rk4_block_scheme_kernel<EQ, CONS, P>, sc, g, l, wide_coefs,
                               shared_bytes);
  }
};

// Dispatch over the points per lane the run-time-tap block form is built
// for: 4 and kBlockSchemePoints.
template <template <int, bool, int> class Form, int EQ, bool CONS>
int dispatch_block_points(int p, const Scalars& sc, const Block& g, const Launch& l,
                          const float* wide_coefs, int shared_bytes) {
  static_assert(kBlockSchemePoints == 8, "the cases below");
  switch (p) {
    case 4: return Form<EQ, CONS, 4>::run(sc, g, l, wide_coefs, shared_bytes);
    case 8: return Form<EQ, CONS, 8>::run(sc, g, l, wide_coefs, shared_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace pde_rk4
