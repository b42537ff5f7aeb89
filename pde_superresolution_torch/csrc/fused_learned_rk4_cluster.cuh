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
// shared memory does not.
//
// Two kernels a warp-group count: with the weights whole in every block
// (launch_learned_rk4_cluster: 16, 32 and 64 channels), and with layer >= 1's
// weights streamed through the ring (launch_learned_rk4_cluster_ring: every
// width, the chunked form included): the G groups and one producer warp
// (at 4 groups, block 0's thread 0), whose block-0 lane issues each slice
// once for the whole cluster, a cp.async.bulk multicast into a slot of
// every block. Each is built from its
// own source per G (fused_learned_rk4_cluster.cu for G = 1, _g2.cu, _g4.cu;
// fused_learned_rk4_cluster_ring.cu, _ring_g2.cu, _ring_g4.cu), so that nvcc
// compiles them in parallel.
#pragma once

#include "fused_learned_rk4.cuh"

namespace {

// The weights whole: G warp groups a block, the thread bound.
template <int NT, bool FORCED, int G>
__global__ void __launch_bounds__(kTeamThreads * G)
    fused_learned_rk4_cluster_kernel(const float* __restrict__ u_in,
                                     const unsigned char* __restrict__ weights,
                                     float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(128) unsigned char smem[];
  learned_rk4_body<NT, FORCED, true, false, G>(smem, u_in, weights, u_out, cfg, fp);
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

// The weights streamed through the ring: G warp groups and the producer
// warp (ring_threads). CHUNKED: towers wider than 128 channels (NT =
// kWideNT a chunk). At 4 groups no producer warp: ptxas gives a bound of
// 17 warps 96 registers a thread (an SM quadrant's 16,384 registers hold 5
// warps of 102), and the kernels spilled; there block 0's thread 0 issues.
// Two groups below 128 channels and a producer warp take 164-168 registers,
// one block an SM (a cap of 112 for two spilled, and 2 x 9 warps need 96).
template <int NT, bool FORCED, bool CHUNKED, int G>
__global__ void __launch_bounds__(ring_threads(G))
    fused_learned_rk4_cluster_ring_kernel(const float* __restrict__ u_in,
                                          const unsigned char* __restrict__ weights,
                                          float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(128) unsigned char smem[];
  learned_rk4_body<NT, FORCED, true, CHUNKED, G, 1, true>(smem, u_in, weights, u_out, cfg, fp);
}

// A cluster of cfg.cluster blocks a trajectory, `threads` a block.
template <typename Kernel>
int launch_cluster(Kernel kernel, int threads, const float* u, const unsigned char* weights,
                   float* out, const Config& cfg, const Forcing& fp, int smem_bytes,
                   cudaStream_t stream) {
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
  config.blockDim = dim3(threads, 1, 1);
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

template <int NT, bool FORCED, int G>
auto whole_kernel() {
  if constexpr (G == 2) {
    return fused_learned_rk4_cluster_kernel_2x2<NT, FORCED>;
  } else {
    return fused_learned_rk4_cluster_kernel<NT, FORCED, G>;
  }
}

template <int NT, int G>
int dispatch_whole(bool forced, const float* u, const unsigned char* weights, float* out,
                   const Config& cfg, const Forcing& fp, int smem_bytes, cudaStream_t stream) {
  const int threads = kTeamThreads * G;
  return forced ? launch_cluster(whole_kernel<NT, true, G>(), threads, u, weights, out, cfg, fp,
                                 smem_bytes, stream)
                : launch_cluster(whole_kernel<NT, false, G>(), threads, u, weights, out, cfg, fp,
                                 smem_bytes, stream);
}

template <int NT, int G, bool CHUNKED = false>
int dispatch_ring(bool forced, const float* u, const unsigned char* weights, float* out,
                  const Config& cfg, const Forcing& fp, int smem_bytes, cudaStream_t stream) {
  return forced ? launch_cluster(fused_learned_rk4_cluster_ring_kernel<NT, true, CHUNKED, G>,
                                 ring_threads(G), u, weights, out, cfg, fp, smem_bytes, stream)
                : launch_cluster(fused_learned_rk4_cluster_ring_kernel<NT, false, CHUNKED, G>,
                                 ring_threads(G), u, weights, out, cfg, fp, smem_bytes, stream);
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
      return dispatch_whole<2, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    case 32:
      return dispatch_whole<4, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    case 64:
      return dispatch_whole<8, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    default:  // 128 channels and wider stream their weights: the ring
      return (int)cudaErrorInvalidValue;
  }
}

template <int G>
int launch_learned_rk4_cluster_ring(int channels, bool forced, const float* u,
                                    const unsigned char* weights, float* out,
                                    const LearnedConfig& cfg, const LearnedForcing& fp,
                                    int smem_bytes, cudaStream_t stream) {
  switch (channels) {
    case 16:
      return dispatch_ring<2, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    case 32:
      return dispatch_ring<4, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    case 64:
      return dispatch_ring<8, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    default:
      break;
  }
  if constexpr (G <= kMaxGroupsWide) {  // 64 accumulators a thread: at most 2 groups
    if (channels == 8 * kWideNT) {
      return dispatch_ring<kWideNT, G>(forced, u, weights, out, cfg, fp, smem_bytes, stream);
    }
    // wider: the chunked form
    if (channels > 8 * kWideNT && channels % 16 == 0) {
      return dispatch_ring<kWideNT, G, true>(forced, u, weights, out, cfg, fp, smem_bytes,
                                             stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pde
