// fused_learned_rk4, the whole form with 8 trajectories a warp group (the
// design note in fused_learned_rk4.cuh, the kernel in
// fused_learned_rk4_whole.cuh).
#include "fused_learned_rk4_whole.cuh"

template int pde::launch_learned_rk4_whole<8>(int, bool, const float*, const unsigned char*,
                                              float*, const pde::LearnedConfig&,
                                              const pde::LearnedForcing&, int, int, cudaStream_t);
