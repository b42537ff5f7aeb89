// fused_rk4: the C entry, and the block form for long grids and wide
// schemes. See fused_rk4.cuh for the kernel's design and its three forms.

#include "fused_rk4.cuh"

namespace pde_rk4 {
namespace {

// A block owns a trajectory of nx points. Its rows: the stage input with
// `halo` periodic points at both ends (the scheme's reach; every periodic
// copy is written, so a reach beyond nx wraps as often as it needs), the
// fluxes (or u_t), the step's start value and the k sum. They lie in shared
// memory or, where they do not fit a block (GLOBAL), in the wrapper's
// scratch, [batch][4 nx + 2 halo] floats, L2-resident, with the same
// barriers between stages (__syncthreads orders global memory for the
// block too). The taps are the scheme's, at run time: each coefficient from
// the kernel's parameters (up to kMaxTaps taps an order within kReach), or
// (WIDE) from global memory, order after order, in tap order.
template <int EQ, bool CONS, bool WIDE, bool GLOBAL>
__global__ void __launch_bounds__(kBlockThreads)
    fused_rk4_block_kernel(const float* __restrict__ u_in, float* __restrict__ out,
                           const __grid_constant__ Scalars sc,
                           const float* __restrict__ wide_coefs, float* scratch,
                           int num_steps, int nx, int halo) {
  extern __shared__ float shared_rows[];
  const long long b = blockIdx.x;
  float* rows = GLOBAL ? scratch + b * (4LL * nx + 2 * halo) : shared_rows;
  float* s_u = rows + halo;              // [-halo, nx + halo)
  float* s_f = rows + nx + 2 * halo;     // [nx]
  float* s_u0 = s_f + nx;                // [nx]
  float* s_ksum = s_u0 + nx;             // [nx]
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
        const float* wide_c = wide_coefs;  // WIDE: this order's first coefficient
        for (int o = 0; o < sc.orders; ++o) {
          const int t0 = sc.tap0[o], n = sc.size[o];
          const float* up = s_u + p + t0;  // taps reach into the halo
          float acc = -0.f;  // -0 + x is x for every x: the first tap's product as it is
          for (int t = 0; t < n; ++t) {
            const float c = WIDE ? __ldg(wide_c + t) : sc.coef[o][t0 + t + kReach];
            acc = __fadd_rn(acc, __fmul_rn(c, up[t]));
          }
          f = fold<EQ, CONS>(o, f, acc, s_u[p]);
          wide_c += n;
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

template <int EQ, bool CONS, bool WIDE, bool GLOBAL>
int launch_block(const Scalars& sc, const Launch& l, const float* wide_coefs, float* scratch,
                 int nx, int halo, int shared_bytes) {
  auto kernel = fused_rk4_block_kernel<EQ, CONS, WIDE, GLOBAL>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<l.batch, kBlockThreads, shared_bytes, l.stream>>>(l.u, l.out, sc, wide_coefs, scratch,
                                                              l.num_steps, nx, halo);
  return (int)cudaGetLastError();
}

template <int EQ, bool CONS>
int dispatch_block(bool wide, bool global, const Scalars& sc, const Launch& l,
                   const float* wide_coefs, float* scratch, int nx, int halo, int shared_bytes) {
  if (wide) {
    return global ? launch_block<EQ, CONS, true, true>(sc, l, wide_coefs, scratch, nx, halo, 0)
                  : launch_block<EQ, CONS, true, false>(sc, l, wide_coefs, scratch, nx, halo,
                                                        shared_bytes);
  }
  return global ? launch_block<EQ, CONS, false, true>(sc, l, wide_coefs, scratch, nx, halo, 0)
                : launch_block<EQ, CONS, false, false>(sc, l, wide_coefs, scratch, nx, halo,
                                                       shared_bytes);
}

}  // namespace
}  // namespace pde_rk4

// meta: equation code, conservative, nx, warps per block, n_orders, size[3],
//       tap0[3], form (0 register, 1 block), points per lane P and ring
//       lanes L (register form: nx = L P), shared-memory bytes (block form,
//       0 with its rows in global memory), halo (block form: periodic points
//       at each end, at least every tap's reach), rows in global memory (1)
//       or shared (0), wide taps (1: the coefficients from wide_coefs).
// coefs: [3][33] floats, order o's coefficient of tap t at [o][t + 16], for
//        a scheme of at most 32 taps an order within 16 points.
// wide_coefs: device floats, every order's coefficients in tap order, order
//             after order (the block form of any other scheme), or null.
// scratch: device floats [batch][4 nx + 2 halo] for rows in global memory, or null.
// scalars: dx, eta, dt/2, dt, dt/6.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or scheme the kernel is not built for (fused_kernels.rk4_launch
// picks the form). Burgers (code 0) is forced and refused.
extern "C" int pde_fused_rk4(const float* u, float* out, int batch, int num_steps,
                             const int* meta, const float* coefs, const float* scalars,
                             const float* wide_coefs, float* scratch, void* stream) {
  using namespace pde_rk4;
  if (batch == 0) return 0;
  const int eq = meta[0], nx = meta[2], warps = meta[3], orders = meta[4];
  const int form = meta[11], points = meta[12], lanes = meta[13], shared_bytes = meta[14];
  const int halo = meta[15];
  const bool cons = meta[1] != 0, global = meta[16] != 0, wide = meta[17] != 0;
  if (eq != 1 && eq != 2) return (int)cudaErrorInvalidValue;
  const Layout classic = layout(eq, cons);
  if (orders != classic.orders) return (int)cudaErrorInvalidValue;
  Scalars sc;
  sc.orders = orders;
  bool is_classic = true;
  for (int o = 0; o < kMaxOrders; ++o) {
    sc.size[o] = o < orders ? meta[5 + o] : 0;
    sc.tap0[o] = o < orders ? meta[8 + o] : 0;
    if (o >= orders) continue;
    const int lo = sc.tap0[o], hi = sc.tap0[o] + sc.size[o] - 1;
    if (sc.size[o] < 1 || (!wide && (sc.size[o] > kMaxTaps || lo < -kReach || hi > kReach)) ||
        (form == 1 && (-lo > halo || hi > halo))) {
      return (int)cudaErrorInvalidValue;
    }
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
  if (form == 1) {
    if (halo < 0 || (wide && wide_coefs == nullptr) || (global && scratch == nullptr) ||
        shared_bytes != (global ? 0 : 4 * (4 * nx + 2 * halo))) {
      return (int)cudaErrorInvalidValue;
    }
    if (eq == 1) {
      return cons ? dispatch_block<1, true>(wide, global, sc, l, wide_coefs, scratch, nx, halo,
                                            shared_bytes)
                  : dispatch_block<1, false>(wide, global, sc, l, wide_coefs, scratch, nx, halo,
                                             shared_bytes);
    }
    return cons ? dispatch_block<2, true>(wide, global, sc, l, wide_coefs, scratch, nx, halo,
                                          shared_bytes)
                : dispatch_block<2, false>(wide, global, sc, l, wide_coefs, scratch, nx, halo,
                                           shared_bytes);
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
