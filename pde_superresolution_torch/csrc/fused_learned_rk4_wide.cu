// fused_learned_rk4, the whole form at 128 channels (towers of 65 to 128
// filters, padded): kWideGroups warp groups on one trajectory a block and a
// producer warp, layer >= 1's weights through a ring of conv-tap slices fed
// by bulk copies, each slice copied once for a cluster of cfg.cluster
// blocks (a trajectory each) and shared by both groups (the design note in
// fused_learned_rk4.cuh).
// Launched by pde_fused_learned_rk4 (fused_learned_rk4.cu) where one block
// holds a trajectory beside the ring (fused_kernels.learned_rk4_launch). It
// replaces make_fused_learned_rk4 (pde_superresolution_tpu/ops/pallas_kernels.py,
// the pallas_call at line 758) at these widths.
#include "fused_learned_rk4.cuh"

namespace {

template <bool FORCED>
__global__ void __launch_bounds__(kRingThreads)
    fused_learned_rk4_wide_kernel(const float* __restrict__ u_in,
                                  const unsigned char* __restrict__ weights,
                                  float* __restrict__ u_out, Config cfg, Forcing fp) {
  extern __shared__ __align__(128) unsigned char smem[];
  learned_rk4_body<kWideNT, FORCED, false, false, kWideGroups, 1, true>(smem, u_in, weights,
                                                                       u_out, cfg, fp);
}

template <bool FORCED>
int launch_wide(const float* u, const unsigned char* weights, float* out, const Config& cfg,
                const Forcing& fp, int smem_bytes, cudaStream_t stream) {
  auto kernel = fused_learned_rk4_wide_kernel<FORCED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  // a block a trajectory, the last cluster's blocks past the batch empty
  config.gridDim = dim3((unsigned)round_up(cfg.batch, cfg.cluster), 1, 1);
  config.blockDim = dim3(kRingThreads, 1, 1);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // the cluster must fit the card's processing clusters at least once
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&config, kernel, u, weights, out, cfg, fp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

namespace pde {

int launch_learned_rk4_wide(bool forced, const float* u, const unsigned char* weights, float* out,
                            const LearnedConfig& cfg, const LearnedForcing& fp, int smem_bytes,
                            cudaStream_t stream) {
  return forced ? launch_wide<true>(u, weights, out, cfg, fp, smem_bytes, stream)
                : launch_wide<false>(u, weights, out, cfg, fp, smem_bytes, stream);
}

}  // namespace pde
