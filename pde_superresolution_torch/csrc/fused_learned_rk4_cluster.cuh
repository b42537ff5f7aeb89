// fused_learned_rk4, the split form: one trajectory over a thread-block
// cluster of cfg.cluster blocks, each block a segment of cfg.seg points run
// by G warp groups (128 threads each; 1, 2 or 4, at most 2 at 128 channels and
// above), halos by distributed shared memory (the design note in
// fused_learned_rk4.cuh); towers wider than 128 filters always take it, in
// chunks of 128 output channels (the chunked form). Launched by
// pde_fused_learned_rk4 (fused_learned_rk4.cu) where one block cannot hold a
// trajectory (fused_kernels.learned_rk4_launch). It replaces the same Pallas
// kernel, make_fused_learned_rk4 (pde_superresolution_tpu/ops/pallas_kernels.py,
// the pallas_call at line 758), at the grids its VMEM takes and one block's
// shared memory does not. Each G is built from its own source
// (fused_learned_rk4_cluster.cu for G = 1, _g2.cu, _g4.cu), so that
// nvcc compiles them in parallel.
#pragma once

#include "fused_learned_rk4.cuh"

namespace {

// CHUNKED: towers wider than 128 channels (NT = kWideNT a chunk); G warp
// groups a block, the thread bound.
template <int NT, bool FORCED, bool CHUNKED, int G>
__global__ void __launch_bounds__(kTeamThreads * G)
    fused_learned_rk4_cluster_kernel(const float* __restrict__ u_in,
                                     const unsigned char* __restrict__ weights,
                                     float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(128) unsigned char smem[];
  learned_rk4_body<NT, FORCED, true, CHUNKED, G>(smem, u_in, weights, u_out, cfg, fp);
}

// 2 groups below 128 channels: two blocks an SM, so 128 registers a thread
// (a bound of 2 x 128 threads alone let 32 channels take 132 and hold one
// block an SM). The bound names its minimum blocks only here: naming one
// block elsewhere made ptxas take more registers at one group.
template <int NT, bool FORCED>
__global__ void __launch_bounds__(2 * kTeamThreads, 2)
    fused_learned_rk4_cluster_kernel_2x2(const float* __restrict__ u_in,
                                         const unsigned char* __restrict__ weights,
                                         float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(128) unsigned char smem[];
  learned_rk4_body<NT, FORCED, true, false, 2>(smem, u_in, weights, u_out, cfg, fp);
}

template <int NT, bool FORCED, bool CHUNKED, int G>
int launch_cluster(const float* u, const unsigned char* weights, float* out, const Config& cfg,
                   const Forcing& fp, int smem_bytes, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (G == 2 && NT < kWideNT) {
      return fused_learned_rk4_cluster_kernel_2x2<NT, FORCED>;
    } else {
      return fused_learned_rk4_cluster_kernel<NT, FORCED, CHUNKED, G>;
    }
  }();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (cfg.cluster > 8) {  // above the portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)cfg.batch * cfg.cluster, 1, 1);
  config.blockDim = dim3(kTeamThreads * G, 1, 1);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // a cluster this large with this much shared memory a block must fit the
  // card's processing clusters at least once, or the launch would never run
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&config, kernel, u, weights, out, cfg, fp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NT, int G, bool CHUNKED = false>
int dispatch_cluster(bool forced, const float* u, const unsigned char* weights, float* out,
                     const Config& cfg, const Forcing& fp, int smem_bytes,
                     cudaStream_t stream) {
  return forced
             ? launch_cluster<NT, true, CHUNKED, G>(u, weights, out, cfg, fp, smem_bytes, stream)
             : launch_cluster<NT, false, CHUNKED, G>(u, weights, out, cfg, fp, smem_bytes, stream);
}

}  // namespace

namespace pde {

template <int G>
int launch_learned_rk4_cluster(int channels, bool forced, const float* u,
                               const unsigned char* weights, float* out,
                               const LearnedConfig& cfg, const LearnedForcing& fp,
                               int smem_bytes, cudaStream_t stream) {
  switch (channels) {
    case 16:
      return dispatch_cluster<2, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    case 32:
      return dispatch_cluster<4, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    case 64:
      return dispatch_cluster<8, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    default:
      break;
  }
  if constexpr (G <= kMaxGroupsWide) {  // 64 accumulators a thread: at most 2 groups
    if (channels == 8 * kWideNT) {
      return dispatch_cluster<kWideNT, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    }
    // wider: the chunked form (the entry checked that it streams)
    if (channels > 8 * kWideNT && channels % 16 == 0) {
      return dispatch_cluster<kWideNT, G, true>(forced, u, weights, out, cfg, fp, smem_bytes,
                                                stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pde
