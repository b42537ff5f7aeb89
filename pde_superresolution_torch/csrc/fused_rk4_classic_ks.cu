// fused_rk4's classic register form for KS (see fused_rk4_classic.cuh).

#include "fused_rk4_classic.cuh"

namespace pde_rk4 {

int launch_classic_ks(bool cons, int points_per_lane, const Scalars& sc, const Launch& l) {
  return cons ? dispatch_points<Classic, 2, true, 32>(points_per_lane, sc, l)
              : dispatch_points<Classic, 2, false, 32>(points_per_lane, sc, l);
}

}  // namespace pde_rk4
