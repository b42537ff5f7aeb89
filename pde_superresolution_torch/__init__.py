"""PyTorch/CUDA port of ``pde_superresolution_tpu`` for NVIDIA Hopper.

Learned data-driven discretizations of 1-D PDEs (Bar-Sinai et al., PNAS
2019): the conv-net stencil model, its equations and integrators, and
hand-written CUDA kernels for the hot loop. The port mirrors the JAX
package's module names and public layouts (``[batch, nx]`` fields,
``{order: [batch, nx, stencil]}`` coefficients) and imports nothing of it.

Layers, from the entry point down:
  models/stencil_net  StencilModel: rhs_fn, fused_rk4_fn
  models/conv_net     periodic conv tower (nn.Module, plain PyTorch)
  stencils            float64 constraint setup, projection, apply_stencil
  equations, grids    Burgers/KdV/KS, forcing, periodic grids
  integrate           RK4/RK3 loops, integrate, integrate_fused
  ops/fused_kernels   CUDA kernel wrappers with their plain twins
  csrc/               the CUDA C++ sources (sm_90a), built on first use
  convert             JAX checkpoint params -> this package's state dict

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
