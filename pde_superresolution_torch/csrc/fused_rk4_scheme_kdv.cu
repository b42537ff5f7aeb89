// fused_rk4's run-time-tap register form for KdV (see fused_rk4_scheme.cuh).

#include "fused_rk4_scheme.cuh"

namespace pde_rk4 {

int launch_scheme_kdv(bool cons, int points_per_lane, const Scalars& sc, const Launch& l) {
  return cons ? dispatch_points<Scheme, 1, true, kSchemeMaxPoints>(points_per_lane, sc, l)
              : dispatch_points<Scheme, 1, false, kSchemeMaxPoints>(points_per_lane, sc, l);
}

}  // namespace pde_rk4
