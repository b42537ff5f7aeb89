// fused_rk4: the C entry, and the rows form for the wide schemes whose rows
// fit a block. See fused_rk4.cuh for the kernel's design and its four forms.

#include "fused_rk4.cuh"

namespace pde_rk4 {
namespace {

// A block owns a trajectory of nx points. Its rows in shared memory: the
// stage input with `halo` periodic points at both ends (the scheme's reach;
// every periodic copy is written, so a reach beyond nx wraps as often as it
// needs), the fluxes (or u_t), the step's start value and the k sum, then
// the scheme's coefficients, copied once from global memory (order after
// order, in tap order). The taps are taken at run time.
template <int EQ, bool CONS>
__global__ void __launch_bounds__(kRowsThreads)
    fused_rk4_rows_kernel(const float* __restrict__ u_in, float* __restrict__ out,
                          const __grid_constant__ Scalars sc,
                          const float* __restrict__ wide_coefs, int num_steps, int nx, int halo) {
  extern __shared__ float rows[];
  const long long b = blockIdx.x;
  float* s_u = rows + halo;              // [-halo, nx + halo)
  float* s_f = rows + nx + 2 * halo;     // [nx]
  float* s_u0 = s_f + nx;                // [nx]
  float* s_ksum = s_u0 + nx;             // [nx]
  float* s_coef = s_ksum + nx;           // every order's taps
  auto store_u = [&](int p, float v) {
    s_u[p] = v;
    if (p < halo) s_u[p + nx] = v;
    if (p >= nx - halo) s_u[p - nx] = v;
    if (halo > nx) {  // a reach beyond the grid: the further copies (every
      // reach within it takes the two tests above alone)
      for (int c = p + 2 * nx; c < nx + halo; c += nx) s_u[c] = v;
      for (int c = p - 2 * nx; c >= -halo; c -= nx) s_u[c] = v;
    }
  };
  int taps = 0;
  for (int o = 0; o < sc.orders; ++o) taps += sc.size[o];
  for (int i = threadIdx.x; i < taps; i += blockDim.x) s_coef[i] = wide_coefs[i];
  for (int p = threadIdx.x; p < nx; p += blockDim.x) {
    const float v = u_in[b * nx + p];
    store_u(p, v);
    s_u0[p] = v;
  }
  __syncthreads();

  for (int step = 0; step < num_steps; ++step) {
    for (int stage = 0; stage < 4; ++stage) {
      for (int p = threadIdx.x; p < nx; p += blockDim.x) {
        float f = 0.f;
        const float* c = s_coef;  // this order's first coefficient
        for (int o = 0; o < sc.orders; ++o) {
          const int t0 = sc.tap0[o], n = sc.size[o];
          const float* up = s_u + p + t0;  // taps reach into the halo
          float acc = -0.f;  // -0 + x is x for every x: the first tap's product as it is
          for (int t = 0; t < n; ++t) acc = __fadd_rn(acc, __fmul_rn(c[t], up[t]));
          f = fold<EQ, CONS>(o, f, acc, s_u[p]);
          c += n;
        }
        s_f[p] = f;
      }
      __syncthreads();  // every face flux written; every read of this stage's input done
      for (int p = threadIdx.x; p < nx; p += blockDim.x) {
        const float k =
            CONS ? pde::divergence(s_f[p], s_f[p == 0 ? nx - 1 : p - 1], sc.dx) : s_f[p];
        float u0 = s_u0[p], ksum = s_ksum[p];
        store_u(p, combine(stage, k, u0, ksum, sc.half_dt, sc.dt, sc.dt_sixth));
        s_u0[p] = u0;
        s_ksum[p] = ksum;
      }
      __syncthreads();  // the next stage's input complete
    }
  }
  for (int p = threadIdx.x; p < nx; p += blockDim.x) out[b * nx + p] = s_u0[p];
}

template <int EQ, bool CONS>
int launch_rows(const Scalars& sc, const Launch& l, const float* wide_coefs, int nx, int halo,
                int shared_bytes) {
  auto kernel = fused_rk4_rows_kernel<EQ, CONS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<l.batch, kRowsThreads, shared_bytes, l.stream>>>(l.u, l.out, sc, wide_coefs,
                                                             l.num_steps, nx, halo);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pde_rk4

// meta: equation code, conservative, nx, warps per block, n_orders, size[3],
//       tap0[3], form (0 register, 1 block, 2 rows), points per lane P,
//       lanes (register form: the ring's L, nx = L P; block form: a warp's
//       lanes, one more in the first nx / P % (warps x cluster) warps),
//       shared-memory bytes (block form: three edge buffers, 3 warps (left
//       + right) floats, and the coefficients; rows form: the rows and
//       the coefficients), halo (rows form: periodic
//       points at each end, at least every tap's reach), blocks a cluster
//       (block form), wide taps (1: the coefficients from wide_coefs), and
//       the block form's edges: the tail's points (the reach to the left and
//       one more) and the head's (the reach to the right).
// coefs: [3][33] floats, order o's coefficient of tap t at [o][t + 16], for
//        a scheme of at most 32 taps an order within 16 points.
// wide_coefs: device floats, every order's coefficients in tap order, order
//             after order (any other scheme, in the block or rows form), or null.
// scalars: dx, eta, dt/2, dt, dt/6.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape, scheme or geometry the kernel is not built for
// (fused_kernels.rk4_launch picks the form). Burgers (code 0) is forced and
// refused.
extern "C" int pde_fused_rk4(const float* u, float* out, int batch, int num_steps,
                             const int* meta, const float* coefs, const float* scalars,
                             const float* wide_coefs, void* stream) {
  using namespace pde_rk4;
  if (batch == 0) return 0;
  const int eq = meta[0], nx = meta[2], warps = meta[3], orders = meta[4];
  const int form = meta[11], points = meta[12], lanes = meta[13], shared_bytes = meta[14];
  const int halo = meta[15], cluster = meta[16], left = meta[18], right = meta[19];
  const bool cons = meta[1] != 0, wide = meta[17] != 0;
  if (eq != 1 && eq != 2) return (int)cudaErrorInvalidValue;
  const Layout classic = layout(eq, cons);
  if (orders != classic.orders) return (int)cudaErrorInvalidValue;
  Scalars sc;
  sc.orders = orders;
  bool is_classic = true;
  int lo = 0, hi = 0, taps = 0;
  for (int o = 0; o < kMaxOrders; ++o) {
    sc.size[o] = o < orders ? meta[5 + o] : 0;
    sc.tap0[o] = o < orders ? meta[8 + o] : 0;
    if (o >= orders) continue;
    const int first = sc.tap0[o], end = sc.tap0[o] + sc.size[o] - 1;
    if (sc.size[o] < 1 || (!wide && (sc.size[o] > kMaxTaps || first < -kReach || end > kReach)) ||
        (form == 2 && (-first > halo || end > halo))) {
      return (int)cudaErrorInvalidValue;
    }
    lo = first < lo ? first : lo;
    hi = end > hi ? end : hi;
    taps += sc.size[o];
    is_classic = is_classic && sc.size[o] == classic.size[o] && sc.tap0[o] == classic.tap0[o];
  }
  for (int o = 0; o < kMaxOrders; ++o) {
    for (int t = 0; t < kSlots; ++t) sc.coef[o][t] = coefs[o * kSlots + t];
  }
  sc.lanes = lanes;
  sc.dx = scalars[0];
  sc.eta = scalars[1];
  sc.half_dt = scalars[2];
  sc.dt = scalars[3];
  sc.dt_sixth = scalars[4];
  const Launch l = {u, out, batch, num_steps, warps, static_cast<cudaStream_t>(stream)};
  if (wide && wide_coefs == nullptr) return (int)cudaErrorInvalidValue;
  if (form == 1) {
    // the trajectory's nx / P lanes dealt out evenly to cluster x warps warps,
    // each holding at least the edges its neighbours read
    const int total = warps * cluster;
    if (points < 1 || nx % points || cluster < 1 || cluster > kBlockMaxCluster || warps < 1 ||
        warps > kBlockMaxWarps || left != 1 - lo || right != hi ||
        shared_bytes != 4 * (3 * warps * (left + right) + taps)) {
      return (int)cudaErrorInvalidValue;
    }
    const int all_lanes = nx / points, base = all_lanes / total, extra = all_lanes % total;
    if (lanes != base || base < 1 || base + (extra > 0) > 32 || base * points < left ||
        base * points < right) {
      return (int)cudaErrorInvalidValue;
    }
    const Block g = {nx, warps, cluster, base, extra, left, right};
    const float* c = wide ? wide_coefs : nullptr;
    if (is_classic && points == kBlockClassicPoints) {
      return eq == 1 ? launch_block_classic_kdv(cons, points, sc, g, l, c, shared_bytes)
                     : launch_block_classic_ks(cons, points, sc, g, l, c, shared_bytes);
    }
    return eq == 1 ? launch_block_scheme_kdv(cons, points, sc, g, l, c, shared_bytes)
                   : launch_block_scheme_ks(cons, points, sc, g, l, c, shared_bytes);
  }
  if (form == 2) {  // the wide schemes alone: their coefficients from wide_coefs
    if (!wide || halo < 0 || shared_bytes != 4 * (4 * nx + 2 * halo + taps)) {
      return (int)cudaErrorInvalidValue;
    }
    if (eq == 1) {
      return cons ? launch_rows<1, true>(sc, l, wide_coefs, nx, halo, shared_bytes)
                  : launch_rows<1, false>(sc, l, wide_coefs, nx, halo, shared_bytes);
    }
    return cons ? launch_rows<2, true>(sc, l, wide_coefs, nx, halo, shared_bytes)
                : launch_rows<2, false>(sc, l, wide_coefs, nx, halo, shared_bytes);
  }
  if (form != 0 || wide || lanes < 1 || lanes > 32 || points * lanes != nx || warps < 1 ||
      warps > kMaxWarps) {
    return (int)cudaErrorInvalidValue;
  }
  if (!is_classic) {
    return eq == 1 ? launch_scheme_kdv(cons, points, sc, l)
                   : launch_scheme_ks(cons, points, sc, l);
  }
  return eq == 1 ? launch_classic_kdv(cons, points, sc, l)
                 : launch_classic_ks(cons, points, sc, l);
}
