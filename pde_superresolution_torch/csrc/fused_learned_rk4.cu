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
// bfloat16 (round to nearest even), and every product and sum is float32.
// The projection is float32 FMA on the CUDA cores, neither bf16 nor TF32.
// The stencil apply reads the unrounded float32 u.
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
// 11.1 MFLOP per trajectory-step, 98% of it bf16 x bf16 products; the bytes
// are the state, read and written once, and some 24 KB of weights. Forcing
// adds about 1% more float32 work and 2 x terms x nx floats of phase state
// read once per launch. What the design runs into first is the SM's
// shared-memory bandwidth: at 32 channels a wgmma reads 3 KB for 16 cycles
// of tensor-core work.
//
// Design.
//  * Tensor cores. Tower layers >= 1 (98% of the work) are products [64
//    points] x [depth 16] x [channels] on wgmma.mma_async.m64n{16,32,64}k16
//    (bf16 in, float32 out), both operands read from shared memory by
//    descriptor, no swizzle. Activations are bf16 in one plane per 8
//    channels, a grid point's 8 channels = one 16-byte row, rows contiguous:
//    a 64-point tile is 8 core matrices 128 bytes apart, the two halves of a
//    depth step one plane apart. The input of conv tap k is the same tile
//    shifted by k - kh rows: the descriptor's start address moves by 16
//    bytes per row. There is no im2col stack; the periodic wrap is kh halo
//    rows at both ends of every plane, written with the rows they copy.
//    Weights are laid out by fused_kernels.pack_learned_rk4 as wgmma reads
//    them ([depth step][half][channel][8 values]), channels zero-padded to
//    16, 32, 64 or 128. Accumulators start from the bias.
//  * Layer 0 (one input channel) pads its K taps to one depth-16 step of
//    mma.sync.m16n8k16 and builds its A fragments from u. The heads are
//    mma.sync too: the last layer's accumulators, after ReLU and the bf16
//    round, are repacked in registers as their A fragments (the accumulator
//    layout of two neighbouring channel tiles is the m16k16 A layout), so
//    the heads read no activations from shared memory. ReLU is a packed
//    NaN-keeping max on the rounded pair; layers store their output with
//    stmatrix, one per 8 rows and 4 planes.
//  * A team of one warp group (128 threads) owns a trajectory. In each pair
//    of 64-point tiles a warp holds 16 rows of each through the tower and
//    the heads, then one grid point per lane through the projection, stencil
//    and flux, so the tail runs on every thread. The head outputs z pass
//    through a per-warp tile in shared memory (__syncwarp, no barrier). The
//    projection skips PN's zero blocks (exact: they add +0) and reads PN
//    transposed, 8 stencil rows per 16-byte pair; u carries 8 halo points at
//    both ends, so neither the stencil nor layer 0 wraps an index.
//  * A block holds up to 4 teams and one copy of the weights (about 24 KB).
//    Teams synchronize on their own named barrier (bar.sync id, 128), never
//    across the block: L - 1 barriers between tower layers (a layer reads
//    its neighbours' rows; a fence.proxy.async before them shows the stores
//    to wgmma), one after the fluxes, one after the stage combine. The host
//    picks teams per block from the batch so that small batches still fill
//    the SMs. A trajectory takes about 24 KB of shared memory at the
//    flagship (two activation buffers 17 KB, state, fluxes, RK4 sums, z
//    tile) plus 21 KB of float32 phase state when forced.
//  * Weights and the forcing pack are loaded once per launch with plain
//    16-byte and 4-byte loads. TMA and cp.async buy nothing here: a launch
//    reads about 1 KB per trajectory and runs for milliseconds.
//  * Towers of 65 to 128 filters (padded to 128, the "wide" form, NT = 16):
//    one layer's weights alone are 160 KB at kernel 5, so they do not stay in
//    shared memory. A block holds one team, and layer >= 1's weights pass
//    through a window of one conv tap's 128 x 128 slice (32 KB): per 64-point
//    tile and tap the team copies the slice from global memory (L2-resident:
//    330 KB for the whole tower), waits at its barrier and runs the tap's
//    eight wgmma.m64n128k16 from it. One tile at a time (64 accumulators a
//    thread), so lanes 16-31 idle through the projection and stencil. Layer
//    0's and the heads' fragments, the biases and the projection are read
//    from global memory where they lie. A simple form: the copies do not
//    overlap the products and each tile reads the slices again.
//  * -DPDE_MAX_TEAMS=n and -DPDE_PROFILE serve
//    scripts/probe_learned_rk4.py: other team counts, and cycles by phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "equations.cuh"

namespace {

using pde::kMaxOrders;

constexpr int kMaxLayers = 16;    // fused_kernels.MAX_LAYERS
#ifndef PDE_MAX_TEAMS
#define PDE_MAX_TEAMS 4
#endif
constexpr int kMaxTeams = PDE_MAX_TEAMS;  // fused_kernels.MAX_TEAMS: trajectories per block
constexpr int kTeamThreads = 128;         // one warp group owns a trajectory
constexpr int kPhases = 10;               // of the PDE_PROFILE build
constexpr int kHalo = 8;  // fused_kernels.U_HALO: periodic copies at both ends of u
// A forced trajectory holds 20 KB of phase state: no more than 4 fit a block
// at the flagship, and their kernel keeps the registers of a 512-thread block.
constexpr int kMaxTeamsForced = kMaxTeams < 4 ? kMaxTeams : 4;  // MAX_TEAMS_FORCED
constexpr int kWideNT = 16;  // 128 channels: the wide form (fused_kernels.WIDE_CHANNELS)

// Forcing of a launch (device pointers): amp, rot_c, rot_s [batch][terms];
// sin0, cos0 [batch][terms][nx].
struct Forcing {
  const float *amp, *rot_c, *rot_s, *sin0, *cos0;
  int terms;
};

struct Config {
  int eq, conservative, nx, ksize, layers, n_free, n_orders;
  int size[kMaxOrders], tap0[kMaxOrders];
  // the free dims (columns of PN) that belong to each order: first, count;
  // and where the order's rows start in the projection block (in floats)
  int free0[kMaxOrders], free_n[kMaxOrders], proj0[kMaxOrders];
  // offsets (in bytes, multiples of 128) of the blocks in the packed weights
  int w_off[kMaxLayers], b_off[kMaxLayers], hw_off, hb_off, proj_off;
  int weight_bytes;
  int team_bytes;  // shared memory of one team
  int batch, num_steps;
  float dx, eta, half_dt, dt, dt_sixth;
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared memory of one team, as fused_kernels.learned_rk4_launch counts it.
__host__ __device__ inline int team_bytes_needed(int nx, int channels, int ksize, int n_free,
                                                 int terms) {
  const int rows = round_up(nx, 64);
  const int plane_rows = rows + ksize;  // kh halo rows before and after, a dump row
  int bytes = 2 * (channels / 8) * plane_rows * 16  // two activation buffers
              + (4 * rows + 2 * kHalo) * 4          // u with halo, flux, step start, k sum
              + 4 * 32 * (n_free | 1) * 4;          // z staging, one tile per warp
  if (terms > 0) bytes += rows * 4 + 16 + 4 * terms * 4 + 2 * terms * nx * 4;
  return round_up(bytes, 16);
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stores 8 x 8 bf16 matrices held in the accumulator layout (thread 4 g + q:
// row g, columns 2 q and 2 q + 1): lane 8 m + j gives the address of row j of
// matrix m.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stmatrix_x2(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(r0),
               "r"(r1)
               : "memory");
}

// Shared-memory matrix descriptor of wgmma, no swizzle: 8 x 16-byte core
// matrices; lbo = bytes between core matrices along the depth, sbo = bytes
// between core matrices along the rows (M or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy stores to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins the accumulators between plain code and the asynchronous wgmma.
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[nt][i])::"memory");
}

// d += a b on the warp group: a [64 x 16] and b [16 x 8 NT] (stored [n][k])
// from shared memory by descriptor. Thread (warp w, g, q) holds d[nt][i] =
// D[16 w + g + 8 (i / 2)][8 nt + 2 q + i % 2], the layout of mma.m16n8.
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NT][4], uint64_t a, uint64_t b) {
  static_assert(NT == 2 || NT == 4 || NT == 8 || NT == 16, "channels 16, 32, 64 or 128");
  const int accumulate = 1;  // scale-d: d = a b + d
  if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
          "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
          "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (NT == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
          "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
          "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
          "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
          "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d += a b: a [16 x 16] row-major fragments, b [16 x 8] column-major.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Two floats rounded to bf16, then max(., 0) that keeps a NaN. Rounding to
// nearest is monotonic and keeps 0, so this is bf16(relu(.)).
__device__ __forceinline__ uint32_t relu_bf16(float lo, float hi) {
  const __nv_bfloat162 v =
      __hmax2_nan(__floats2bfloat162_rn(lo, hi), __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float flux_of(int eq, const float* v, float eta) {
  if (eq == 0) return pde::flux<0>(v, eta);
  if (eq == 1) return pde::flux<1>(v, eta);
  return pde::flux<2>(v, eta);
}

__device__ __forceinline__ float motion_of(int eq, float u, const float* v, float eta) {
  if (eq == 0) return pde::equation_of_motion<0>(u, v, eta);
  if (eq == 1) return pde::equation_of_motion<1>(u, v, eta);
  return pde::equation_of_motion<2>(u, v, eta);
}

// NT: 8-channel tiles of the padded tower width (channels = 8 NT).
// Weight blocks (fused_kernels.pack_learned_rk4 lays them out): layer 0's
// mma.sync B fragments of w [taps padded to 16][channels]; every later
// layer's w as wgmma reads it, per depth step of 16: [2 halves][channels][8
// depth values] bf16 (1 KB at 32 channels); after each, the float32 bias
// [channels]; the heads' mma.sync B fragments of hw [channels][F padded to
// 8], hb [F padded]; c0 [S]; pn [S][F], all float32.
template <int NT, bool FORCED>
__global__ void __launch_bounds__(kTeamThreads *
                                  (NT == kWideNT ? 1 : (FORCED ? kMaxTeamsForced : kMaxTeams)))
    fused_learned_rk4_kernel(const float* __restrict__ u_in,
                             const unsigned char* __restrict__ weights,
                             float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CS = NT / 2;  // depth-16 steps across the channels
  constexpr bool WIDE = NT == kWideNT;  // one team a block, layer >= 1's weights streamed
  constexpr int MT = WIDE ? 1 : 2;      // 64-point tiles per pass
  constexpr int SLICE = 128 * NT * NT;  // bytes of one conv tap's weights of a layer >= 1
  const int nx = cfg.nx, K = cfg.ksize, kh = (K - 1) / 2, F = cfg.n_free, L = cfg.layers;
  const int FT = (F + 7) / 8, z_stride = F | 1;  // odd: lanes on distinct banks
  const int tiles = (nx + 63) / 64, rows = 64 * tiles;
  // one plane per 8 channels: [kh halo rows, rows, kh halo rows, a dump row
  // for the rows beyond the grid] x 16 bytes
  const int plane_bytes = (rows + K) * 16, dump_row = rows + K - 1;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int team = tid / kTeamThreads;  // a warp group
  const int tt = tid - team * kTeamThreads, wt = tt >> 5;

  if constexpr (!WIDE) {
    for (int i = tid; i < cfg.weight_bytes / 16; i += blockDim.x) {
      reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(weights)[i];
    }
  }
  fence_proxy_async();  // wgmma reads the weights
  __syncthreads();      // the only block-wide barrier
  const long long traj = (long long)blockIdx.x * (blockDim.x / kTeamThreads) + team;
  if (traj >= cfg.batch) return;  // a ragged last block: whole teams leave

  // the weights read where they lie: shared memory, or global memory in the
  // wide form (whose shared weights are the window of layer >= 1's slices)
  const unsigned char* wts = WIDE ? weights : smem;
  const float* s_hb = reinterpret_cast<const float*>(wts + cfg.hb_off);
  const float* s_proj = reinterpret_cast<const float*>(wts + cfg.proj_off);

  unsigned char* base = smem + cfg.weight_bytes + team * cfg.team_bytes;
  unsigned char* act[2] = {base, base + NT * plane_bytes};  // bf16 [NT planes]
  // stage input, s_u[-kHalo .. nx + kHalo): periodic copies at both ends
  float* s_u = reinterpret_cast<float*>(base + 2 * NT * plane_bytes) + kHalo;
  float* s_flux = s_u + rows + kHalo;  // face fluxes, or u_t for a direct form
  float* s_u0 = s_flux + rows;  // the step's start value
  float* s_ksum = s_u0 + rows;  // running k1 + 2 k2 + 2 k3 + k4
  float* s_z = s_ksum + rows + wt * 32 * z_stride;  // this warp's z tile [32][F | 1]
  // forced only: this stage's forcing [rows], the per-term constants
  // (amplitude, rotation cos, rotation sin, 0) [terms], the phase state
  // [terms][nx] each
  const int T = FORCED ? fp.terms : 0;
  float* s_force = s_ksum + rows + 4 * 32 * z_stride;
  float4* __restrict__ s_term = reinterpret_cast<float4*>(
      base + round_up((int)(reinterpret_cast<unsigned char*>(s_force + rows) - base), 16));
  float* __restrict__ s_sin = reinterpret_cast<float*>(s_term + T);
  float* __restrict__ s_cos = s_sin + T * nx;

  auto team_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "n"(kTeamThreads) : "memory");
  };

  auto store_u = [&](int p, float v) {
    s_u[p] = v;
    if (p < kHalo) s_u[p + nx] = v;
    if (p >= nx - kHalo) s_u[p - nx] = v;
  };
  for (int p = tt; p < nx; p += kTeamThreads) {
    const float v = u_in[traj * nx + p];
    store_u(p, v);
    s_u0[p] = v;
  }
  if (FORCED) {
    const size_t row = (size_t)traj * T;
    for (int i = tt; i < T; i += kTeamThreads) {
      s_term[i] = make_float4(fp.amp[row + i], fp.rot_c[row + i], fp.rot_s[row + i], 0.f);
    }
    for (int i = tt; i < T * nx; i += kTeamThreads) {
      s_sin[i] = fp.sin0[row * nx + i];
      s_cos[i] = fp.cos0[row * nx + i];
    }
  }
  team_sync();

#ifdef PDE_PROFILE
  // cycles by phase, written over the first floats of each warp's 16 rows of
  // the output: for scripts/probe_learned_rk4.py --profile only
  long long prof[kPhases] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long last_clock = clock64();
#define PROF(i)                      \
  do {                               \
    const long long now = clock64(); \
    prof[i] += now - last_clock;     \
    last_clock = now;                \
  } while (0)
#else
#define PROF(i) \
  do {          \
  } while (0)
#endif
  for (int step = 0; step < cfg.num_steps; ++step) {
    for (int stage = 0; stage < 4; ++stage) {
      for (int l = 0; l < L; ++l) {
        const bool last = l == L - 1;
        unsigned char* out = act[l & 1];
        const unsigned char* in = act[(l & 1) ^ 1];
        const float* bias = reinterpret_cast<const float*>(wts + cfg.b_off[l]);

        // MT 64-point tiles at a time; in each, warp wt holds rows 16 wt ..
        // 16 wt + 15: acc[tile][channel tile][fragment].
        for (int tp = 0; tp < tiles; tp += MT) {
          const bool two = MT == 2 && tp + 1 < tiles;
          const int row0 = 64 * tp + 16 * wt;  // this warp's first row of tile tp
          float acc[MT][NT][4];  // start from the bias of channels 8 nt + 2 q, + 1
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 b = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * q);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              acc[mt][nt][0] = acc[mt][nt][2] = b.x;
              acc[mt][nt][1] = acc[mt][nt][3] = b.y;
            }
          }

          if (l == 0) {
            // mma.sync; A[point][tap] = bf16(u[point + tap - kh]), taps padded to 16
            const uint2* w = reinterpret_cast<const uint2*>(wts + cfg.w_off[0]) + lane;
            auto tap = [&](int row, int col) -> float {  // no branch: load, then select
              const float v = s_u[col < K ? row + col - kh : 0];
              return col < K ? v : 0.f;
            };
            for (int ks = 0; ks * 16 < K; ++ks) {
              uint32_t a[MT][4];
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const int r = row0 + 64 * mt + g;
                const int r0 = r < nx ? r : 0, r1 = r + 8 < nx ? r + 8 : 0;
                const int c = 16 * ks + 2 * q;
                a[mt][0] = pack_bf16(tap(r0, c), tap(r0, c + 1));
                a[mt][1] = pack_bf16(tap(r1, c), tap(r1, c + 1));
                a[mt][2] = pack_bf16(tap(r0, c + 8), tap(r0, c + 9));
                a[mt][3] = pack_bf16(tap(r1, c + 8), tap(r1, c + 9));
              }
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const uint2 b = w[(ks * NT + nt) * 32];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
              }
            }
          } else if constexpr (WIDE) {
            // As below, one conv tap's slice of the weights at a time through
            // the window at the start of shared memory (the team is the block).
            const uint64_t a = smem_desc(
                (uint32_t)__cvta_generic_to_shared(in) + 64 * tp * 16, plane_bytes, 128);
            const uint64_t b0 =
                smem_desc((uint32_t)__cvta_generic_to_shared(smem), 128 * NT, 128);
            const uint4* slice = reinterpret_cast<const uint4*>(weights + cfg.w_off[l]);
            for (int k = 0; k < K; ++k, slice += SLICE / 16) {
              team_sync();  // every warp's products of the last slice are done
              for (int i = tt; i < SLICE / 16; i += kTeamThreads) {
                reinterpret_cast<uint4*>(smem)[i] = slice[i];
              }
              fence_proxy_async();  // wgmma reads the window
              team_sync();
              fence_acc(acc[0]);
              wgmma_fence();
              uint64_t b = b0;
#pragma unroll
              for (int cs = 0; cs < CS; ++cs, b += 16 * NT) {
                wgmma_bf16<NT>(acc[0], a + (cs * (plane_bytes / 8) + k), b);
              }
              wgmma_commit();
              wgmma_wait();
              fence_acc(acc[0]);
            }
            PROF(2);
          } else {
            // wgmma, both operands from shared memory. Tap k reads the input
            // planes shifted by k - kh rows: the descriptor starts 16 bytes
            // further per row (row r lies at index r + kh).
            // The address field counts 16 bytes, so a step is an add.
            const uint64_t a = smem_desc(
                (uint32_t)__cvta_generic_to_shared(in) + 64 * tp * 16, plane_bytes, 128);
            uint64_t b = smem_desc((uint32_t)__cvta_generic_to_shared(smem + cfg.w_off[l]),
                                   128 * NT, 128);
            fence_acc(acc[0]);
            fence_acc(acc[1]);
            wgmma_fence();
            for (int k = 0; k < K; ++k) {
#pragma unroll
              for (int cs = 0; cs < CS; ++cs, b += 16 * NT) {
                const uint64_t a_k = a + (cs * (plane_bytes / 8) + k);
                wgmma_bf16<NT>(acc[0], a_k, b);
                if (two) wgmma_bf16<NT>(acc[1], a_k + 64, b);
              }
            }
            wgmma_commit();
            wgmma_wait();
            fence_acc(acc[0]);
            fence_acc(acc[1]);
            PROF(2);
          }
          if (l == 0) PROF(0);

          // ---- ReLU, bf16: lo = row g, hi = row g + 8 of the warp's 16
          // rows, channels 8 nt + 2 q and + 1 ----
          uint32_t lo[MT][NT], hi[MT][NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              lo[mt][nt] = relu_bf16(acc[mt][nt][0], acc[mt][nt][1]);
              hi[mt][nt] = relu_bf16(acc[mt][nt][2], acc[mt][nt][3]);
            }
          }

          if (!last) {
            // One stmatrix per 8 rows and up to 4 planes; rows beyond the
            // grid go to the plane's dump row. The first and last kh rows
            // also fill the halo at the other end (the periodic wrap).
            const uint32_t out_addr = (uint32_t)__cvta_generic_to_shared(out);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int first = row0 + 64 * mt + 8 * half;  // of these 8 rows
                const int r_lane = first + (lane & 7);
                const uint32_t row_addr =
                    out_addr + (r_lane < nx ? r_lane + kh : dump_row) * 16;
                const uint32_t* regs = half ? hi[mt] : lo[mt];
                if constexpr (NT == 2) {
                  stmatrix_x2(row_addr + ((lane >> 3) & 1) * plane_bytes, regs[0], regs[1]);
                } else {
#pragma unroll
                  for (int n0 = 0; n0 < NT; n0 += 4) {
                    stmatrix_x4(row_addr + (n0 + (lane >> 3)) * plane_bytes, regs[n0],
                                regs[n0 + 1], regs[n0 + 2], regs[n0 + 3]);
                  }
                }
                if (first < kh || first + 8 > nx - kh) {  // a few warps only
                  const int r = first + g;
                  const int copy = r < kh ? nx * 16 : (r >= nx - kh && r < nx ? -nx * 16 : 0);
                  if (copy) {
                    unsigned char* dst = out + (r + kh) * 16 + 4 * q + copy;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                      *reinterpret_cast<uint32_t*>(dst + nt * plane_bytes) = regs[nt];
                    }
                  }
                }
              }
            }
            if (l == 0) {
              PROF(1);
            } else {
              PROF(3);
            }
            continue;
          }
          PROF(3);

          // ---- heads (mma.sync): the last layer's output is already the A
          // fragments (channel tiles 2 cs and 2 cs + 1 make depth step cs) ----
          __syncwarp();  // the previous tile pair's readers of s_z are done
          const uint2* hw = reinterpret_cast<const uint2*>(wts + cfg.hw_off) + lane;
          for (int ft = 0; ft < FT; ++ft) {
            float z[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) z[mt][0] = z[mt][1] = z[mt][2] = z[mt][3] = 0.f;
#pragma unroll
            for (int cs = 0; cs < CS; ++cs) {
              const uint2 b = hw[(cs * FT + ft) * 32];
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const uint32_t a[4] = {lo[mt][2 * cs], hi[mt][2 * cs], lo[mt][2 * cs + 1],
                                       hi[mt][2 * cs + 1]};
                mma_bf16(z[mt], a, b);
              }
            }
            const int f = 8 * ft + 2 * q;
            const float hb0 = s_hb[f], hb1 = s_hb[f + 1];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              float* dst = s_z + (16 * mt + g) * z_stride + f;
              if (f < F) {
                dst[0] = __fadd_rn(z[mt][0], hb0);
                dst[8 * z_stride] = __fadd_rn(z[mt][2], hb0);
              }
              if (f + 1 < F) {  // the padded head columns are not kept
                dst[1] = __fadd_rn(z[mt][1], hb1);
                dst[8 * z_stride + 1] = __fadd_rn(z[mt][3], hb1);
              }
            }
          }
          __syncwarp();
          PROF(4);

          // ---- projection, stencil, flux: one grid point per lane (lanes
          // 0-15 the warp's rows of tile tp, lanes 16-31 of tile tp + 1; in
          // the wide form lanes 16-31 have no row) ----
          const int p = MT == 2 || lane < 16 ? row0 + 64 * (lane >> 4) + (lane & 15) : nx;
          const int pe = p < nx ? p : 0;  // padding lanes compute a value nobody reads
          const float* zp = s_z + lane * z_stride;
          float v[kMaxOrders];
#pragma unroll
          for (int o = 0; o < kMaxOrders; ++o) {
            if (o < cfg.n_orders) {
              // 8 stencil rows at a time: c = c0 + PN z over the order's own
              // free dims, in their order, then the tap sum in tap order
              const int size = cfg.size[o], count = cfg.free_n[o];
              const float* zo = zp + cfg.free0[o];
              const float* block = s_proj + cfg.proj0[o];
              const float* up = s_u + pe + cfg.tap0[o];  // taps reach into the halo
              float sum = 0.f;
              for (int s0 = 0; s0 < size; s0 += 8, block += 8 + 8 * count) {
                const float4* pn = reinterpret_cast<const float4*>(block + 8);
                float pr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
                for (int i = 0; i < count; ++i) {
                  const float zi = zo[i];
                  const float4 a = pn[2 * i], b = pn[2 * i + 1];
                  pr[0] = fmaf(a.x, zi, pr[0]);
                  pr[1] = fmaf(a.y, zi, pr[1]);
                  pr[2] = fmaf(a.z, zi, pr[2]);
                  pr[3] = fmaf(a.w, zi, pr[3]);
                  pr[4] = fmaf(b.x, zi, pr[4]);
                  pr[5] = fmaf(b.y, zi, pr[5]);
                  pr[6] = fmaf(b.z, zi, pr[6]);
                  pr[7] = fmaf(b.w, zi, pr[7]);
                }
                const float4 c0a = reinterpret_cast<const float4*>(block)[0];
                const float4 c0b = reinterpret_cast<const float4*>(block)[1];
                const float c0[8] = {c0a.x, c0a.y, c0a.z, c0a.w, c0b.x, c0b.y, c0b.z, c0b.w};
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  if (s0 + j < size) {
                    const float c = __fadd_rn(c0[j], pr[j]);
                    const float uv = up[s0 + j];
                    sum = s0 + j == 0 ? __fmul_rn(c, uv) : fmaf(c, uv, sum);
                  }
                }
              }
              v[o] = sum;
            }
          }
          const float k_val = cfg.conservative ? flux_of(cfg.eq, v, cfg.eta)
                                               : motion_of(cfg.eq, s_u[pe], v, cfg.eta);
          if (p < nx) s_flux[p] = k_val;
          PROF(5);
        }
        if (!last) {
          fence_proxy_async();  // the next layer's wgmma reads these stores
          team_sync();
          PROF(6);
        }
      }
      team_sync();  // fluxes complete; every read of s_u for this stage done
      PROF(7);

      // ---- forcing and RK4 stage combine ----
      for (int p = tt; p < nx; p += kTeamThreads) {
        float k_val = s_flux[p];
        if (cfg.conservative) {
          k_val = pde::divergence(k_val, s_flux[p == 0 ? nx - 1 : p - 1], cfg.dx);
        }
        if (FORCED) {
          // stage 0 sums the state as it is; stages 1 and 3 first rotate it
          // by half a step; stage 2 keeps stage 1's value
          if (stage != 2) {
            float f = 0.f;
#pragma unroll 4
            for (int m = 0; m < T; ++m) {
              const float4 term_m = s_term[m];  // amplitude, rotation cos, sin
              float s = s_sin[m * nx + p];
              if (stage != 0) {
                const float c = s_cos[m * nx + p];
                const float rc = term_m.y, rs = term_m.z;
                const float rotated = __fadd_rn(__fmul_rn(s, rc), __fmul_rn(c, rs));
                s_cos[m * nx + p] = __fsub_rn(__fmul_rn(c, rc), __fmul_rn(s, rs));
                s_sin[m * nx + p] = rotated;
                s = rotated;
              }
              const float term = __fmul_rn(term_m.x, s);
              f = m == 0 ? term : __fadd_rn(f, term);
            }
            s_force[p] = f;
          }
          k_val = __fadd_rn(k_val, s_force[p]);
        }
        float u0 = s_u0[p], next;
        if (stage == 0) {
          s_ksum[p] = k_val;
          next = __fadd_rn(u0, __fmul_rn(cfg.half_dt, k_val));
        } else if (stage == 1) {
          s_ksum[p] = __fadd_rn(s_ksum[p], __fmul_rn(2.0f, k_val));
          next = __fadd_rn(u0, __fmul_rn(cfg.half_dt, k_val));
        } else if (stage == 2) {
          s_ksum[p] = __fadd_rn(s_ksum[p], __fmul_rn(2.0f, k_val));
          next = __fadd_rn(u0, __fmul_rn(cfg.dt, k_val));
        } else {
          u0 = __fadd_rn(u0, __fmul_rn(cfg.dt_sixth, __fadd_rn(s_ksum[p], k_val)));
          s_u0[p] = u0;
          next = u0;
        }
        store_u(p, next);
      }
      PROF(8);
      team_sync();
      PROF(9);
    }
  }
  for (int p = tt; p < nx; p += kTeamThreads) u_out[traj * nx + p] = s_u0[p];
#ifdef PDE_PROFILE
  if (lane == 0) {
    for (int i = 0; i < kPhases; ++i) u_out[traj * nx + 16 * wt + i] = (float)prof[i];
  }
#endif
}

template <int NT, bool FORCED>
int launch(const float* u, const unsigned char* weights, float* out, const Config& cfg,
           const Forcing& fp, int teams, int smem_bytes, cudaStream_t stream) {
  auto kernel = fused_learned_rk4_kernel<NT, FORCED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (cfg.batch + teams - 1) / teams;
  kernel<<<blocks, kTeamThreads * teams, smem_bytes, stream>>>(u, weights, out, cfg, fp);
  return (int)cudaGetLastError();
}

template <int NT>
int dispatch(bool forced, const float* u, const unsigned char* weights, float* out,
           const Config& cfg, const Forcing& fp, int teams, int smem_bytes,
           cudaStream_t stream) {
  return forced ? launch<NT, true>(u, weights, out, cfg, fp, teams, smem_bytes, stream)
                : launch<NT, false>(u, weights, out, cfg, fp, teams, smem_bytes, stream);
}

}  // namespace

// meta: equation code, conservative, nx, channels (padded: 16, 32, 64 or 128),
//       ksize, layers, n_free, n_orders, size[3], tap0[3], free0[3],
//       free_n[3], proj0[3], forcing terms (0 if unforced), teams per block,
//       shared-memory bytes per team.
// offsets: the weights' bytes in shared memory (the whole buffer, or at 128
//          channels the window of one tap's slice, 32768), then the blocks'
//          byte offsets in buffer order: w[0], b[0], ..., w[layers-1], b[layers-1], hw, hb,
//          projection.
// scalars: dx, eta, dt/2, dt, dt/6.
// forcing: five device pointers amp, rot_c, rot_s [batch][terms], sin0, cos0
//          [batch][terms][nx]; read only when terms > 0. Burgers (code 0) is
//          forced and needs them; KdV and KS refuse them.
// Returns cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int pde_fused_learned_rk4(const float* u, const unsigned char* weights, float* out,
                                     int batch, int num_steps, const int* meta,
                                     const int* offsets, const float* scalars,
                                     const float* const* forcing, int smem_bytes,
                                     void* stream) {
  if (batch == 0) return 0;
  Config cfg;
  cfg.eq = meta[0];
  cfg.conservative = meta[1];
  cfg.nx = meta[2];
  const int channels = meta[3];
  cfg.ksize = meta[4];
  cfg.layers = meta[5];
  cfg.n_free = meta[6];
  cfg.n_orders = meta[7];
  for (int o = 0; o < kMaxOrders; ++o) {
    cfg.size[o] = meta[8 + o];
    cfg.tap0[o] = meta[11 + o];
    cfg.free0[o] = meta[14 + o];
    cfg.free_n[o] = meta[17 + o];
    cfg.proj0[o] = meta[20 + o];
  }
  Forcing fp = {nullptr, nullptr, nullptr, nullptr, nullptr, meta[23]};
  const int teams = meta[24];
  cfg.team_bytes = meta[25];
  cfg.batch = batch;
  cfg.num_steps = num_steps;
  cfg.dx = scalars[0];
  cfg.eta = scalars[1];
  cfg.half_dt = scalars[2];
  cfg.dt = scalars[3];
  cfg.dt_sixth = scalars[4];
  if (cfg.layers < 1 || cfg.layers > kMaxLayers || cfg.nx < 32) return (int)cudaErrorInvalidValue;
  if (teams < 1 || teams > (fp.terms > 0 ? kMaxTeamsForced : kMaxTeams)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = channels == 8 * kWideNT;
  cfg.weight_bytes = offsets[0];
  const int* block = offsets + 1;
  for (int l = 0; l < cfg.layers; ++l) {
    cfg.w_off[l] = *block++;
    cfg.b_off[l] = *block++;
  }
  cfg.hw_off = *block++;
  cfg.hb_off = *block++;
  cfg.proj_off = *block++;
  if (fp.terms > 0) {
    fp.amp = forcing[0];
    fp.rot_c = forcing[1];
    fp.rot_s = forcing[2];
    fp.sin0 = forcing[3];
    fp.cos0 = forcing[4];
  }
  if (wide && (teams != 1 || cfg.weight_bytes != 128 * kWideNT * kWideNT)) {
    return (int)cudaErrorInvalidValue;
  }
  if (cfg.weight_bytes % 16 || cfg.team_bytes % 16 ||
      cfg.team_bytes < team_bytes_needed(cfg.nx, channels, cfg.ksize, cfg.n_free, fp.terms) ||
      smem_bytes < cfg.weight_bytes + teams * cfg.team_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const bool forced = fp.terms > 0;
  if (forced != (cfg.eq == 0) || cfg.eq < 0 || cfg.eq > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 16:
      return dispatch<2>(forced, u, weights, out, cfg, fp, teams, smem_bytes, s);
    case 32:
      return dispatch<4>(forced, u, weights, out, cfg, fp, teams, smem_bytes, s);
    case 64:
      return dispatch<8>(forced, u, weights, out, cfg, fp, teams, smem_bytes, s);
    case 8 * kWideNT:
      return dispatch<kWideNT>(forced, u, weights, out, cfg, fp, teams, smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
