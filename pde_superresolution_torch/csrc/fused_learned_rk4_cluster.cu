// fused_learned_rk4, the split form with one warp group a block and the weights
// whole in every block (the design note in fused_learned_rk4.cuh, the
// kernel in fused_learned_rk4_cluster.cuh).
#include "fused_learned_rk4_cluster.cuh"

template int pde::launch_learned_rk4_cluster<1>(int, bool, const float*, const unsigned char*,
                                                float*, const pde::LearnedConfig&,
                                                const pde::LearnedForcing&, int, cudaStream_t);
