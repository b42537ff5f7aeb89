// fused_rk4's compiled-tap block form for KS (see fused_rk4_block.cuh).

#include "fused_rk4_block.cuh"

namespace pde_rk4 {

int launch_block_classic_ks(bool cons, int points_per_lane, const Scalars& sc, const Block& g,
                            const Launch& l, const float* wide_coefs, int shared_bytes) {
  if (points_per_lane != kBlockClassicPoints) return (int)cudaErrorInvalidValue;
  return cons ? BlockClassic<2, true, kBlockClassicPoints>::run(sc, g, l, wide_coefs, shared_bytes)
              : BlockClassic<2, false, kBlockClassicPoints>::run(sc, g, l, wide_coefs, shared_bytes);
}

}  // namespace pde_rk4
