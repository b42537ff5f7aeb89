// fused_learned_rk4: num_steps whole RK4 steps of the learned model in one
// launch.
//
// Replaces make_fused_learned_rk4 in
// pde_superresolution_tpu/ops/pallas_kernels.py (the pallas_call at line
// 758). Each RHS evaluation runs the periodic conv tower, the merged 1x1
// heads, the block-diagonal constraint projection c = c0 + PN z (scale
// folded into PN), the stencil apply and the flux divergence (or equation of
// motion); all four RK4 stages of every step stay on chip. It computes what
// the TPU kernel computes: the tower's and the heads' matmul inputs, weights
// and activations alike (the first layer's u rows too), are rounded to
// bfloat16 with __float2bfloat16_rn, and every product and sum is float32.
// The projection is float32. The stencil apply reads the unrounded float32
// u.
//
// Forced equations (Burgers; the FORCED instantiations) add the forcing
// f = sum_m A_m sin(omega_m t + kappa_m x + phi_m) to every stage without a
// transcendental in the loop, as the TPU kernel does: the host packs, per
// trajectory, the amplitudes (the cell-average sinc factor folded in), the
// rotation (cos, sin)(omega_m dt/2) and the phase state (sin, cos) theta at
// the launch's start time for every term and point. Stage 1 uses the state
// as it is, one rotation gives the half-step value that stages 2 and 3
// share, a second rotation gives stage 4's, and the rotated state carries
// into the next step. The rotation is s' = s rc + c rs, c' = c rc - s rs from
// the old (s, c); products and sums are rounded one by one (_rn) and the sum
// over terms runs in term order, so the plain version can do the same.
//
// What bounds it on the H100: operations. One RHS costs about 10.8 k
// multiply-adds per grid point at the flagship tower (3 layers x 32 filters,
// kernel 5: 160 + 2 x 5120 tower, 256 heads, 144 projection, 18 stencil),
// 11.1 MFLOP per trajectory-step; the bytes are the state, read and written
// once, and some 44 KB of weights. Forcing adds, per point, 4 x terms
// multiply-adds for a step's three sums and 2 x 4 x terms for its two
// rotations (terms = 20), about 1% more, and 2 x terms x nx floats of phase
// state read once per launch.
//
// Design: one thread block per trajectory; a block of (filters / 8) x nx
// threads, where thread (g, j) computes output channels 8g .. 8g+7 of grid
// point j in each conv layer. The weights (bf16-rounded values stored as
// float32, each block transposed to [in][out] so a thread's 8 output
// channels are two float4 loads that broadcast across the warp), the stage
// input u [nx], the face fluxes [nx] and two activation buffers [filters][nx]
// live in shared memory for the whole launch: about 78 KB at the flagship,
// above the 48 KB default, so the launch raises the block's dynamic
// shared-memory limit. A periodic shift is modular indexing into shared
// memory. The threads of group 0 (one per grid point) then evaluate the
// heads, projection, stencil and divergence for their point and keep the
// RK4 state (the step's start value and the running k1 + 2 k2 + 2 k3 + k4)
// in registers. The tower uses scalar FMAs on the CUDA cores; the tensor
// cores (mma / wgmma on bf16) are later work.
//
// The forcing's phase state [2][terms][nx] lives in shared memory too (20 KB
// at 20 terms and nx = 128; about 99 KB per block with the rest, so two
// blocks still share an SM's 227 KB): 40 more live registers per thread do
// not fit beside the tower's accumulators under the 64 the block size
// allows. The threads of group 1, idle while group 0 evaluates the heads,
// rotate the state and sum the terms for their point (group 0 does it
// itself when the block has one group) and hand the value over in shared
// memory across the barrier that already separates the fluxes from the
// stage combine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "equations.cuh"

namespace {

using pde::kMaxOrders;

constexpr int kChannelsPerThread = 8;  // fused_kernels.CHANNELS_PER_THREAD
constexpr int kMaxFree = 24;           // fused_kernels.MAX_FREE
constexpr int kMaxLayers = 16;         // fused_kernels.MAX_LAYERS

// Forcing of a launch (device pointers): amp, rot_c, rot_s [batch][terms];
// sin0, cos0 [batch][terms][nx].
struct Forcing {
  const float *amp, *rot_c, *rot_s, *sin0, *cos0;
  int terms;
};

struct Config {
  int nx, channels, ksize, layers, n_free, n_rows, n_orders, n_weights;
  int size[kMaxOrders], tap0[kMaxOrders];
  // offsets (in floats) of the weight blocks in the packed buffer
  int w_off[kMaxLayers], b_off[kMaxLayers], hw_off, hb_off, c0_off, pn_off;
  float dx, eta, half_dt, dt, dt_sixth;
  int num_steps;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void fma8(float* acc, const float* w, float a) {
  const float4 w0 = reinterpret_cast<const float4*>(w)[0];
  const float4 w1 = reinterpret_cast<const float4*>(w)[1];
  acc[0] = fmaf(w0.x, a, acc[0]);
  acc[1] = fmaf(w0.y, a, acc[1]);
  acc[2] = fmaf(w0.z, a, acc[2]);
  acc[3] = fmaf(w0.w, a, acc[3]);
  acc[4] = fmaf(w1.x, a, acc[4]);
  acc[5] = fmaf(w1.y, a, acc[5]);
  acc[6] = fmaf(w1.z, a, acc[6]);
  acc[7] = fmaf(w1.w, a, acc[7]);
}

// Weight blocks (fused_kernels.pack_learned_rk4 lays them out and passes
// their offsets, each a multiple of 4 floats): per layer w [K*Cin][C] and
// b [C]; heads hw [C][F], hb [F]; c0 [S]; pn [S][F].
template <int EQ, bool CONS, bool FORCED>
__global__ void __launch_bounds__(1024)
    fused_learned_rk4_kernel(const float* __restrict__ u_in,
                             const float* __restrict__ weights,
                             float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(16) float smem[];
  const int nx = cfg.nx, C = cfg.channels, K = cfg.ksize, kh = (K - 1) / 2;
  const int F = cfg.n_free;
  float* s_w = smem;
  float* s_u = s_w + cfg.n_weights;  // stage input [nx]
  float* s_flux = s_u + nx;          // face fluxes [nx]
  float* s_h0 = s_flux + nx;         // activations [C][nx]
  float* s_h1 = s_h0 + C * nx;
  // forced only: this stage's forcing [nx], the per-term constants [terms]
  // each, the phase state [terms][nx] each
  const int T = FORCED ? fp.terms : 0;
  float* s_force = s_h1 + C * nx;
  float* s_amp = s_force + nx;
  float* s_rc = s_amp + T;
  float* s_rs = s_rc + T;
  float* s_sin = s_rs + T;
  float* s_cos = s_sin + T * nx;

  const int tid = threadIdx.x;
  const int j = tid % nx;
  const int co0 = (tid / nx) * kChannelsPerThread;
  const bool tail = tid < nx;  // group 0: one thread per grid point
  // the group that evaluates the forcing: group 1 where the block has one
  const bool forcer = FORCED && tid / nx == (blockDim.x >= 2 * nx ? 1 : 0);

  for (int i = tid; i < cfg.n_weights / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(s_w)[i] = reinterpret_cast<const float4*>(weights)[i];
  }
  const float* s_hw = s_w + cfg.hw_off;
  const float* s_hb = s_w + cfg.hb_off;
  const float* s_c0 = s_w + cfg.c0_off;
  const float* s_pn = s_w + cfg.pn_off;

  if (FORCED) {
    const size_t row = (size_t)blockIdx.x * T;
    for (int i = tid; i < T; i += blockDim.x) {
      s_amp[i] = fp.amp[row + i];
      s_rc[i] = fp.rot_c[row + i];
      s_rs[i] = fp.rot_s[row + i];
    }
    for (int i = tid; i < T * nx; i += blockDim.x) {
      s_sin[i] = fp.sin0[row * nx + i];
      s_cos[i] = fp.cos0[row * nx + i];
    }
  }

  float u0 = 0.f, ksum = 0.f;
  if (tail) {
    u0 = u_in[(size_t)blockIdx.x * nx + j];
    s_u[j] = u0;
  }
  __syncthreads();

  for (int step = 0; step < cfg.num_steps; ++step) {
    for (int stage = 0; stage < 4; ++stage) {
      // ---- conv tower: h_out[co][j] = bf16(relu(b + sum_{k,ci} w * h_in)) ----
      const float* h_in = s_u;
      float* h_out = s_h0;
      for (int l = 0; l < cfg.layers; ++l) {
        const float* w = s_w + cfg.w_off[l];
        const float* bias = s_w + cfg.b_off[l];
        float acc[kChannelsPerThread];
#pragma unroll
        for (int i = 0; i < kChannelsPerThread; ++i) acc[i] = 0.f;
        for (int k = 0; k < K; ++k) {
          const int jj = pde::wrap(j + k - kh, nx);
          if (l == 0) {
            fma8(acc, w + k * C + co0, bf16_round(h_in[jj]));
          } else {
            const float* w_k = w + k * C * C + co0;
            for (int ci = 0; ci < C; ++ci) {
              fma8(acc, w_k + ci * C, h_in[ci * nx + jj]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kChannelsPerThread; ++i) {
          float v = acc[i] + bias[co0 + i];
          v = v < 0.f ? 0.f : v;  // ReLU that keeps a NaN
          h_out[(co0 + i) * nx + j] = bf16_round(v);
        }
        __syncthreads();
        h_in = h_out;
        h_out = h_out == s_h0 ? s_h1 : s_h0;
      }

      // ---- forcing: stage 0 sums the state as it is; stages 1 and 3 first
      // rotate it by half a step; stage 2 keeps stage 1's value ----
      if (FORCED && forcer && stage != 2) {
        float f = 0.f;
        for (int m = 0; m < T; ++m) {
          float s = s_sin[m * nx + j];
          if (stage != 0) {
            const float c = s_cos[m * nx + j];
            const float rc = s_rc[m], rs = s_rs[m];
            const float rotated = __fadd_rn(__fmul_rn(s, rc), __fmul_rn(c, rs));
            s_cos[m * nx + j] = __fsub_rn(__fmul_rn(c, rc), __fmul_rn(s, rs));
            s_sin[m * nx + j] = rotated;
            s = rotated;
          }
          const float term = __fmul_rn(s_amp[m], s);
          f = m == 0 ? term : __fadd_rn(f, term);
        }
        s_force[j] = f;
      }

      // ---- heads, projection, stencil: one thread per grid point ----
      float k_val = 0.f;
      if (tail) {
        float z[kMaxFree];
#pragma unroll
        for (int f = 0; f < kMaxFree; ++f) z[f] = 0.f;
        for (int c = 0; c < C; ++c) {
          const float hv = h_in[c * nx + j];
#pragma unroll
          for (int f = 0; f < kMaxFree; ++f) {
            if (f < F) z[f] = fmaf(s_hw[c * F + f], hv, z[f]);
          }
        }
#pragma unroll
        for (int f = 0; f < kMaxFree; ++f) {
          if (f < F) z[f] = __fadd_rn(z[f], s_hb[f]);
        }
        float v[kMaxOrders];
        int row = 0;
#pragma unroll
        for (int o = 0; o < kMaxOrders; ++o) {
          if (o < cfg.n_orders) {
            int kk = pde::wrap(j + cfg.tap0[o], nx);
            float acc = 0.f;
            for (int s = 0; s < cfg.size[o]; ++s, ++row) {
              float p = 0.f;
#pragma unroll
              for (int f = 0; f < kMaxFree; ++f) {
                if (f < F) p = fmaf(s_pn[row * F + f], z[f], p);
              }
              const float c = __fadd_rn(s_c0[row], p);
              acc = s == 0 ? __fmul_rn(c, s_u[kk]) : fmaf(c, s_u[kk], acc);
              kk = kk + 1 == nx ? 0 : kk + 1;
            }
            v[o] = acc;
          }
        }
        if (CONS) {
          s_flux[j] = pde::flux<EQ>(v, cfg.eta);
        } else {
          k_val = pde::equation_of_motion<EQ>(s_u[j], v, cfg.eta);
        }
      }
      __syncthreads();  // fluxes complete; every read of s_u for this stage done

      // ---- RK4 stage combine ----
      if (tail) {
        if (CONS) k_val = pde::divergence(s_flux[j], s_flux[j == 0 ? nx - 1 : j - 1], cfg.dx);
        if (FORCED) k_val = __fadd_rn(k_val, s_force[j]);
        float next;
        if (stage == 0) {
          ksum = k_val;
          next = __fadd_rn(u0, __fmul_rn(cfg.half_dt, k_val));
        } else if (stage == 1) {
          ksum = __fadd_rn(ksum, __fmul_rn(2.0f, k_val));
          next = __fadd_rn(u0, __fmul_rn(cfg.half_dt, k_val));
        } else if (stage == 2) {
          ksum = __fadd_rn(ksum, __fmul_rn(2.0f, k_val));
          next = __fadd_rn(u0, __fmul_rn(cfg.dt, k_val));
        } else {
          ksum = __fadd_rn(ksum, k_val);
          u0 = __fadd_rn(u0, __fmul_rn(cfg.dt_sixth, ksum));
          next = u0;
        }
        s_u[j] = next;
      }
      __syncthreads();
    }
  }
  if (tail) u_out[(size_t)blockIdx.x * nx + j] = u0;
}

template <int EQ, bool CONS, bool FORCED>
int launch(const float* u, const float* weights, float* out, int batch, const Config& cfg,
           const Forcing& fp, int smem_bytes, cudaStream_t stream) {
  auto kernel = fused_learned_rk4_kernel<EQ, CONS, FORCED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int threads = cfg.channels / kChannelsPerThread * cfg.nx;
  kernel<<<batch, threads, smem_bytes, stream>>>(u, weights, out, cfg, fp);
  return (int)cudaGetLastError();
}

}  // namespace

// meta: equation code, conservative, nx, channels, ksize, layers, n_free,
//       n_rows, n_orders, size[3], tap0[3], forcing terms (0 if unforced).
// offsets: n_weights (floats in the buffer), then the blocks' offsets in
//          buffer order: w[0], b[0], ..., w[layers-1], b[layers-1], hw, hb,
//          c0, pn.
// scalars: dx, eta, dt/2, dt, dt/6.
// forcing: five device pointers amp, rot_c, rot_s [batch][terms], sin0, cos0
//          [batch][terms][nx]; read only when terms > 0. Burgers (code 0) is
//          forced and needs them; KdV and KS refuse them.
// Returns cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int pde_fused_learned_rk4(const float* u, const float* weights, float* out,
                                     int batch, int num_steps, const int* meta,
                                     const int* offsets, const float* scalars,
                                     const float* const* forcing, int smem_bytes,
                                     void* stream) {
  if (batch == 0) return 0;
  Config cfg;
  cfg.nx = meta[2];
  cfg.channels = meta[3];
  cfg.ksize = meta[4];
  cfg.layers = meta[5];
  cfg.n_free = meta[6];
  cfg.n_rows = meta[7];
  cfg.n_orders = meta[8];
  for (int o = 0; o < kMaxOrders; ++o) {
    cfg.size[o] = meta[9 + o];
    cfg.tap0[o] = meta[12 + o];
  }
  cfg.dx = scalars[0];
  cfg.eta = scalars[1];
  cfg.half_dt = scalars[2];
  cfg.dt = scalars[3];
  cfg.dt_sixth = scalars[4];
  cfg.num_steps = num_steps;
  if (cfg.layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  cfg.n_weights = offsets[0];
  const int* block = offsets + 1;
  for (int l = 0; l < cfg.layers; ++l) {
    cfg.w_off[l] = *block++;
    cfg.b_off[l] = *block++;
  }
  cfg.hw_off = *block++;
  cfg.hb_off = *block++;
  cfg.c0_off = *block++;
  cfg.pn_off = *block++;
  Forcing fp = {nullptr, nullptr, nullptr, nullptr, nullptr, meta[15]};
  int floats = cfg.n_weights + (2 * cfg.channels + 2) * cfg.nx;
  if (fp.terms > 0) {
    fp.amp = forcing[0];
    fp.rot_c = forcing[1];
    fp.rot_s = forcing[2];
    fp.sin0 = forcing[3];
    fp.cos0 = forcing[4];
    floats += cfg.nx + 3 * fp.terms + 2 * fp.terms * cfg.nx;
  }
  if (smem_bytes < (int)sizeof(float) * floats) return (int)cudaErrorInvalidValue;
  const bool cons = meta[1] != 0;
  const bool forced = fp.terms > 0;
  if (forced != (meta[0] == 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (meta[0]) {
    case 0:
      return cons ? launch<0, true, true>(u, weights, out, batch, cfg, fp, smem_bytes, s)
                  : launch<0, false, true>(u, weights, out, batch, cfg, fp, smem_bytes, s);
    case 1:
      return cons ? launch<1, true, false>(u, weights, out, batch, cfg, fp, smem_bytes, s)
                  : launch<1, false, false>(u, weights, out, batch, cfg, fp, smem_bytes, s);
    case 2:
      return cons ? launch<2, true, false>(u, weights, out, batch, cfg, fp, smem_bytes, s)
                  : launch<2, false, false>(u, weights, out, batch, cfg, fp, smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
