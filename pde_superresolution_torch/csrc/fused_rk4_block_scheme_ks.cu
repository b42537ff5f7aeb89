// fused_rk4's run-time-tap block form for KS (see fused_rk4_block.cuh).

#include "fused_rk4_block.cuh"

namespace pde_rk4 {

int launch_block_scheme_ks(bool cons, int points_per_lane, const Scalars& sc, const Block& g,
                           const Launch& l, const float* wide_coefs, int shared_bytes) {
  return cons ? dispatch_block_points<BlockScheme, 2, true>(points_per_lane, sc, g, l, wide_coefs,
                                                           shared_bytes)
              : dispatch_block_points<BlockScheme, 2, false>(points_per_lane, sc, g, l, wide_coefs,
                                                            shared_bytes);
}

}  // namespace pde_rk4
