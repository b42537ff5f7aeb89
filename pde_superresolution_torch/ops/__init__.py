"""Hand-written CUDA kernels (``fused_kernels``) and their build (``_build``)."""
