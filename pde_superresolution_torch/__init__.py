"""PyTorch/CUDA port of ``pde_superresolution_tpu`` for NVIDIA Hopper.

Learned data-driven discretizations of 1-D PDEs (Bar-Sinai et al., PNAS
2019): the conv-net stencil model, its equations and integrators, and
hand-written CUDA kernels for the hot loop. The port mirrors the JAX
package's module names and public layouts (``[batch, nx]`` fields,
``{order: [batch, nx, stencil]}`` coefficients) and imports nothing of it.

Layers, from the entry points down:
  scripts/run_ensemble  the ensemble entry point (python -m ..., or torchrun
                      ... --data_parallel N)
  scripts/run_training  the training entry point (the same)
  scripts/run_evaluation, run_select, run_sweep  evaluation, seed selection
                      and the resample-factor sweep (python -m ...)
  scripts/create_training_data, run_export, run_analysis  HDF5 snapshots,
                      the serving artifact, the figures (python -m ...)
  export              torch.export artifacts of the plain route: ServedModel,
                      science_context
  evaluate            EvalResult, survival times, the exact-reference cache
  weno                the WENO5 Burgers baseline
  training/           config (TrainingConfig, --hparams), data (exact-solve
                      snapshots, labels, TrajectoryData, HDF5 snapshot
                      files in the JAX layout), losses (unrolled
                      loss, norms), loop (Adam, checkpoints, resume),
                      selection (train N seeds, keep the protocol winner)
  utils/              JSONL metrics and TensorBoard scalar events
  parallel/           torch.distributed: initialize_multihost, make_mesh
                      ("data" x "space" DeviceMesh), the ring halo exchange
                      (differentiable), the spatially sharded RHS; used by
                      fused_rk4_fn(mesh=), train(mesh=) and --data_parallel
  models/stencil_net  StencilModel: rhs_fn, fused_rk4_fn
  models/conv_net     periodic conv tower (nn.Module, plain PyTorch)
  stencils            float64 constraint setup, projection, apply_stencil
  equations, grids    Burgers/KdV/KS, forcing, spectral form, periodic grids
  integrate           RK4/RK3 loops, integrate, integrate_fused,
                      integrate_resumable (HDF5 store); the exact ETDRK4
                      solver (SpectralETDRK4, integrate_spectral,
                      exact_solve_sampled)
  ops/spectral        FFT derivatives and filters (torch.fft)
  ops/resample        block-mean and strided coarse-graining
  ops/fused_kernels   CUDA kernel wrappers with their plain twins:
                      fused_rhs (differentiable: plain-VJP backward),
                      fused_learned_rk4 (forced too), fused_rk4
  csrc/               the CUDA C++ sources (sm_90a), built on first use
  analysis            MAE curves, survival statistics, report, energy_spectrum
  convert             JAX checkpoint params -> this package's state dict;
                      the committed assets (ckpt_ks8, ckpt_burgers8, ckpt_kdv8);
                      load_checkpoint, the entry points' one loader

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
