// fused_learned_rk4, the whole form below 128 channels: `teams` warp groups
// a block, each owning P whole trajectories (P > 1 at nx < 128: the packed
// rows of the design note in fused_learned_rk4.cuh; at 128 channels the
// whole form is the ring, fused_learned_rk4_wide.cu). Launched by
// pde_fused_learned_rk4 (fused_learned_rk4.cu) where one block holds whole
// trajectories (fused_kernels.learned_rk4_launch). It replaces
// make_fused_learned_rk4 (pde_superresolution_tpu/ops/pallas_kernels.py, the
// pallas_call at line 758). Each P is built from its own source
// (fused_learned_rk4.cu for P = 1, _p2.cu, _p4.cu, _p8.cu), so that nvcc
// compiles them in parallel.
#pragma once

#include "fused_learned_rk4.cuh"

namespace {

template <int NT, bool FORCED, int P>
__global__ void __launch_bounds__(kTeamThreads * (FORCED ? kMaxTeamsForced : kMaxTeams))
    fused_learned_rk4_kernel(const float* __restrict__ u_in,
                             const unsigned char* __restrict__ weights,
                             float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(128) unsigned char smem[];
  learned_rk4_body<NT, FORCED, false, false, 1, P>(smem, u_in, weights, u_out, cfg, fp);
}

template <int NT, bool FORCED, int P>
int launch(const float* u, const unsigned char* weights, float* out, const Config& cfg,
           const Forcing& fp, int teams, int smem_bytes, cudaStream_t stream) {
  auto kernel = fused_learned_rk4_kernel<NT, FORCED, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long slots = (cfg.batch + P - 1) / P;  // teams of P trajectories
  const int blocks = (int)((slots + teams - 1) / teams);
  kernel<<<blocks, kTeamThreads * teams, smem_bytes, stream>>>(u, weights, out, cfg, fp);
  return (int)cudaGetLastError();
}

template <int NT, int P>
int dispatch(bool forced, const float* u, const unsigned char* weights, float* out,
             const Config& cfg, const Forcing& fp, int teams, int smem_bytes,
             cudaStream_t stream) {
  return forced ? launch<NT, true, P>(u, weights, out, cfg, fp, teams, smem_bytes, stream)
                : launch<NT, false, P>(u, weights, out, cfg, fp, teams, smem_bytes, stream);
}

}  // namespace

namespace pde {

template <int P>
int launch_learned_rk4_whole(int channels, bool forced, const float* u,
                             const unsigned char* weights, float* out, const LearnedConfig& cfg,
                             const LearnedForcing& fp, int teams, int smem_bytes,
                             cudaStream_t stream) {
  switch (channels) {
    case 16:
      return dispatch<2, P>(forced, u, weights, out, cfg, fp, teams, smem_bytes, stream);
    case 32:
      return dispatch<4, P>(forced, u, weights, out, cfg, fp, teams, smem_bytes, stream);
    case 64:
      return dispatch<8, P>(forced, u, weights, out, cfg, fp, teams, smem_bytes, stream);
    default:
      return (int)cudaErrorInvalidValue;  // 128 channels: the ring; wider: the chunked form
  }
}

}  // namespace pde
