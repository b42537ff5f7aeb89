#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build, check, run, time.

    python3 chip_smoke.py

Runs from the repository root on a machine with one NVIDIA H100 (sm_90a) and
``nvcc``. It imports no JAX. Phases, each printed as it ends:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. the kernels' build from ``pde_superresolution_torch/csrc`` (seconds,
     ptxas registers and spills); it fails if ptxas reports a stack frame or
     a spill for any instantiation of ``fused_rk4`` or ``fused_rhs``, or if
     their SASS holds local-memory loads or stores, or ``fused_rk4``'s a
     barrier;
  3. ``fused_rhs`` against its plain version: at the flagship (KS-8x
     checkpoint coefficients, B=256 and 4096, nx=128), in all six equation
     forms at a ragged shape (B=3, nx=96, forced for Burgers), and at
     nx=1024 (trajectories split into segments) against float64 sums;
  4. ``fused_learned_rk4`` against its plain version: one step of the KS-8x
     checkpoint from a standard-normal state (energy at every wavenumber,
     where the tower's output matters; kernel and plain version are also
     read against float64 sums), then 100 steps of it at B=256 and of a
     seeded conservative-KdV model; the KS-8x checks must also catch three
     faults planted in the weights (heads zeroed, the last tower layer
     skipped, layer 1's input channels reversed);
  5. the main path, 100 RK4 steps at B=256 from a seeded initial condition
     through ``integrate(model.rhs_fn(params))`` and
     ``integrate_fused(model.fused_rk4_fn(params, dt, 100))``, with the
     kernels' launch counts zeroed just before and read just after, checked
     against the plain path and against the port's float64 CPU path on a
     small batch;
  6. the launch floor (an empty kernel's launch, queued) and times (CUDA
     events, warm median of 7) at B=256 and B=4096: each
     kernel's device time and call time, its plain version, both routes,
     the ``rhs_fn`` route's device time (one RK4 step queued behind a
     device-side sleep, times 100) and its launches per RHS, and its device
     time by kernel (torch.profiler, which can drop records); and which
     tensor-core instructions the built ``fused_learned_rk4`` holds;
  7. forced ``fused_learned_rk4`` (Burgers-8x checkpoint, forcing evaluated
     in the kernel from t0 = 3.7) against its plain version: one step from a
     standard-normal state (which must catch the weight faults), one, 10
     and 100 steps from a seeded state at B=256, and one save interval at
     the ensemble's batch; the seeded state's limits must also catch three
     faults planted in the forcing (amplitudes zeroed, rotation angle
     halved, start time ignored); ``fused_rhs`` in the forced Burgers form
     at the ensemble's batch, checked and timed;
  8. ``fused_rk4`` (the fixed-stencil baseline) against its plain version
     and against ``integrate(PolynomialDifferentiator(...).rhs_fn())`` for KS
     and KdV, conservative and direct, at B=256, nx=128, at B=3, nx=96, at
     B=5, nx=1024 and at B=1037, nx=128 (the last block holds one warp);
  9. the ensemble path at full width, in-process through
     ``scripts.run_ensemble.main``: the Burgers-8x checkpoint, 10240
     trajectories, an exact-solver warm-up, 100 RK4 steps in 10 saves, by
     the fused route and by ``rhs_fn`` steps, then the KS-8x checkpoint by
     the fused route and a baseline leg of ``fused_rk4`` from the same
     warmed-up states; launch counts zeroed before and read after each;
 10. times of the fused RK4 kernels at B=256, 4096 and 10240 per 100
     steps (``fused_rk4`` also at 4 and 8 warps per block, and per stage for
     one trajectory alone), of the warm-up, and of both ensemble routes end
     to end;
 12. training at the KS-8x flagship recipe (``assets/ckpt_ks8.json``: batch
     128, unroll 8 snapshots of 0.05, 12 RK4 substeps each, 32 trajectories
     x 256 times after a warm-up of 44), only the optimizer steps cut: the
     dataset by ``generate_snapshots`` + ``build_training_data`` and the
     loss norms, timed; from the trained params, the gradients of the
     rollout's mean squared error by both routes (``fused_rhs`` forward and
     its plain backward against ``use_kernel=False``), held tightly, with a
     planted VJP scaled by 0.99 that must fail, the sign flips of the
     mean absolute error counted, and one directional derivative against a
     central difference; one train step's loss and gradients by
     ``compute_loss(use_kernel=True)`` against ``use_kernel=False``, with a
     planted gross backward fault; ``fused_rhs`` launches per step (384
     forward + 384 recomputed by the rematerialized backward); times of
     those train steps by route and of an eval step, the step's device-busy
     share, peak memory beside what was allocated before the step,
     ``fused_rhs`` at B=128 against its bound and the launch floor, and the
     backward twin's share; ``training.loop.train`` for 4 steps (kernel
     route, the recipe's three learning rates switching after steps 1 and
     2, eval and checkpoint every 2) with its launch count, then a run
     resumed from step 2 against it; ``train`` on 1024 trajectories of the
     large-ensemble pipeline, device- and host-resident, one step each;
     the phase's own seconds;
 13. evaluation at full width through ``scripts.run_evaluation``: the KS-8x
     checkpoint at its recipe's data protocol (32 members, ``ic_scale`` 0.1,
     warm-up 44, samples every 0.1 to a horizon of 10; the model and the
     matched-width baseline; no reference cache) with its ``fused_rhs``
     launches zeroed before and counted after (9200 predicted), then the
     Burgers-8x checkpoint (32 members, forced, horizon 3, eval keys 0 and
     1; model, 8-tap baseline and WENO) through ``main`` with an HDF5 output
     when ``h5py`` imports, else through ``evaluate_checkpoint``; each held,
     on the first 4 members of the same draw, against the port's CPU path
     (exact, trajectories, MAE, survival times with their flips counted),
     with a planted fault that must fail (KS: the order-1 head zeroed;
     Burgers: the forcing dropped from the model scheme); every model
     member finite and the KS model's survival median the horizon; times by
     layer (fine solve, each scheme, the model leg's host share), the whole
     evaluation, and ``fused_rhs`` at B=32 against its bound and the launch
     floor;
 14. seed selection through ``scripts.run_select`` at the KS-8x recipe (2
     seeds cut to 2 optimizer steps, 4 selection and 8 final members,
     horizon 1, warm-up 44), its winner's-curse fields and
     ``selection.json`` checked, and ``scripts.run_sweep`` (Burgers, factor
     8, 2 steps, 4 members, horizon 1), both with predicted ``fused_rhs``
     launches and their seconds;
 15. the serving export: ``scripts.run_export`` of the KS-8x checkpoint
     (``--num_steps`` 16, the CLI in a process of its own, meanwhile) and
     of the Burgers-8x one (4), with the export, save and load timed apart; each artifact loaded on the card and held at
     B=10240 against the live model's ``fused_rhs`` route and its plain
     route (RHS), and its advance against ``integrate`` of the plain route,
     with a planted fault (heads zeroed before the export) and TF32 left on,
     both of which must fail; no kernel of the port launched by a served
     call; ``run_ensemble --exported_dir`` on the Burgers-8x ensemble (10240
     trajectories, warm-up 1, 100 steps in 10 saves) against the live
     ``rhs_fn`` route, timed; ``run_evaluation --exported_dir`` at the
     Burgers-8x protocol (key 0, 32 members, horizon 3) against the live
     checkpoint's evaluation of the same draw; where ``h5py`` imports,
     ``run_ensemble --output_path`` at B=10240, cut at half and resumed, bit
     for bit the uninterrupted run (else one line says why it was skipped);
 16. the parallel layer at world size 1 over NCCL (``initialize_multihost``
     with no launcher, ``make_mesh()`` = {data: 1, space: 1}):
     ``fused_rk4_fn(mesh=)`` for the KS-8x checkpoint and the forced
     Burgers-8x one (from phase 9's warmed-up states and t0) at B=10240,
     100 steps, against the meshless advance, bit for bit; ``run_ensemble
     --data_parallel 1`` on the Burgers-8x ensemble by both routes, bit for
     bit phase 9's runs; ``sharded_model_rhs`` at KS-8x full width against
     both ``rhs_fn`` routes and ``sharded_baseline_rhs`` against the
     baseline's, with a planted swapped halo that must fail, and their ms
     per call; ``train(mesh=)`` at the KS-8x recipe cut to 2 steps (kernel
     route) against ``train()``; ``run_training --data_parallel 1`` for 2
     steps, whose checkpoint ``run_ensemble --data_parallel 1`` serves; each
     with its launch counts. The process group is destroyed at the phase's
     end. What world size 1 cannot show (the ring exchange, the average of
     gradients over ranks) the CPU tests hold over gloo;
 17. the port's bench, ``pde_superresolution_torch.bench.measure``, at
     reduced samples (3 blocks a card leg, 2 on the CPU, the train leg 3
     blocks of 2 steps a route), its JSON line printed: every number finite
     and positive, launches per call 1 ``fused_learned_rk4`` (fused legs)
     and 400 ``fused_rhs`` (``rhs_fn`` leg), 768 ``fused_rhs`` per
     kernel-route train step, every state finite; ``utils.profiling.trace``
     of one fused and one ``rhs_fn`` block, whose trace files must name
     ``fused_learned_rk4``, ``fused_rhs`` and cuDNN's convolutions;
     ``utils.debugging.checked`` on the fused route, the ``rhs_fn`` route
     and the ``fused_rk4`` baseline, each bit for bit the unchecked call
     and each catching a NaN planted in ``u0`` (naming ``fused_learned_rk4``
     and ``fused_rk4``), and on ``fused_rhs`` with a NaN in ``u`` only;
     ``debug_nans`` around one ``rhs_fn`` RK4 step and its backward, clean
     and with a planted NaN; the phase's own seconds;
 18. one ``{"kernels": [...]}`` line, then the card's line, then the result.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it also exits non-zero
when no CUDA device is present. ``training_phase``, ``evaluation_phase``,
``selection_phase``, ``serving_phase`` and ``bench_phase`` can be called on
their own once the kernels are built (``_build.build()``);
``parallel_phase`` needs phase 9's results.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
STEPS = 100  # RK4 steps per main-path call
BATCH = 256
THROUGHPUT_BATCH = 4096
SAMPLES = 7
LONG_SAMPLES = 3  # for calls of a second or so (the ensemble's batch)
ENSEMBLE = 10240  # trajectories of the ensemble path (run_ensemble's default)
ENSEMBLE_SAVES = 10
WARMUP_TIME = 1.0
FORCING_T0 = 3.7  # start time of the forced checks: a time after a warm-up
# The learned kernel sums each layer's 160 products on the tensor cores (16
# at a time, onto an accumulator that starts from the bias), the plain
# version in a float32 matmul, in another order. A pre-activation that lies
# near the middle of two bf16 values then rounds to the other one at a few
# points per thousand (the plain version also differs from a float64 sum of
# the same bf16 values, at a quarter as many points: phase 4 reads both), and
# from a standard-normal state one such flip moves its point and its
# neighbours by 1e-5 to 3e-4 of the increment. A fault is not sparse. So the
# one-step checks from N(0,1) are held in root mean square, relative to
# max|plain increment|, each limit near 10x the largest reading on an H100:
# kernel vs plain (phase 4) read 1.25e-6 (9.6e-5 at the worst point; 2.4e-7
# with the scalar kernel that summed in the matmul's order); the planted
# weight faults read 1.0e-2 to 2.6e-2. The bf16 tower route vs the float32
# one (phase 5), at the worst point, read 1.1e-3.
STEP_TOL = 1e-5
ROUTE_STEP_TOL = 1e-2
# The forced kernel against its plain version (phase 7), chosen the same way
# from readings on an H100. One step from N(0,1), root mean square of the
# increment: read 9.5e-7 (7.5e-5 at the worst point); there the tower decides
# the increment, so that check is held to the weight faults, which read
# 5.2e-2 to 5.7e-2. One step from the smooth seeded state, worst point of the
# increment: read 5.5e-6; the planted forcing faults read 1.5e-4 to 1.1e-1.
# One save interval (10 steps) from the same state, of max|u|: read 1.05e-6;
# faults 2.5e-4 to 6.4e-2. After 100 steps the trained Burgers model has
# steepened fronts, where single flipped bf16 roundings grow: read 1.6e-4;
# faults 1.1e-1 to 1.2.
# At the ensemble's batch the worst of 40 times as many trajectories after
# one save interval read 4.4e-6.
FORCED_STEP_TOL = 8e-6
FORCED_SMOOTH_STEP_TOL = 5e-5
FORCED_INTERVAL_TOL = 1e-5
FORCED_RUN_TOL = 2e-3
FORCED_ENSEMBLE_TOL = 4e-5
# The unforced kernel against its plain version at the ensemble's batch, from
# the warmed-up KS states (phase 9), of max|u|: one save interval read
# 8.1e-7; the ensemble's final state after 100 steps read 1.15e-6 (phase 4's
# planted weight faults read 9.3e-5 and more after 100 steps).
UNFORCED_ENSEMBLE_TOL = 8e-6
# The Burgers ensemble's two routes after 100 steps (phase 9), bf16 tower and
# rotated phases against float32 tower and a sine per stage: of max|u| at the
# worst of 1.3 M points (read 1.8e-3) and in root mean square (read 1.3e-4).
ROUTE_MAX_TOL = 2e-2
ROUTE_RMS_TOL = 1.5e-3
# Phase 12, training at the KS-8x flagship recipe (assets/ckpt_ks8.json:
# batch 128, unroll 8, 12 RK4 substeps per snapshot): only the number of
# optimizer steps is cut. The resumed run starts from the checkpoint at
# TRAIN_EVERY.
TRAIN_STEPS = 4
TRAIN_EVERY = 2
# The large-ensemble dataset of _train_on_trajectories: 624 MiB, large enough
# that host- and device-resident layouts differ in what they move. Its
# generation time is set by the recipe's warm-up (3520 serial ETDRK4 steps),
# not by the count: 32 trajectories take 6.3 s, 1024 take 10.4 s on an H100.
TRAJECTORIES = 1024
TRAJECTORY_STEPS = 1
# Kernel route against plain route from the trained params at B=128: the
# forward differs by the kernel's tap order and FMAs, the backward is the
# same plain VJP at those slightly different states.
# The backward is held tightly on a smooth function of the rollout, its
# states' mean squared error against the labels (reduced in float64): each
# leaf's gradient, of max|leaf|. A VJP scaled by 0.99 must fail this limit.
# The training loss itself is a mean absolute error, whose gradient
# sign(pred - label) flips wherever a rounding moves a state across its
# label: the script counts those flips between the two routes. The loss read
# 1.9e-7 relative on an H100 and its gradients 1.9e-3 of a leaf's max, so
# that limit only catches gross faults (a planted one must fail it).
SMOOTH_GRAD_TOL = 1e-3
TRAIN_LOSS_TOL = 2e-6
TRAIN_GRAD_TOL = 2e-2
# A central difference along a unit direction in parameter space (step
# FD_STEP) against the kernel route's gradient projected on it, relative. The
# function is the mean squared error of the rollout's states (reduced in
# float64), smooth but for the tower's ReLUs: the loss itself is a mean
# absolute error of small errors, so over any usable step it crosses many
# kinks and its difference quotient reads another slope (on an H100: -0.86
# against a gradient of -1.58 at a step of 1e-2). The mean squared error
# read 1.4e-3 there.
FD_STEP = 1e-2
FD_TOL = 1e-2
# A resumed run against the uninterrupted one, and the device-resident
# against the host-resident trajectory dataset: the same batches and
# updates, but cuDNN's weight gradients are not bitwise reproducible; Adam
# turns a difference into at most about lr per step. Of max|param| per leaf
# (on an H100, resumed at step 5 of 10: read 9.4e-5; after 3 steps of the
# trajectory pipeline: 2.6e-4).
RESUME_TOL = 1e-3
# Phase 13, evaluation. KS-8x at its recipe's data protocol
# (assets/ckpt_ks8.json: ic_scale 0.1, warm-up 44), sampled every 0.1; the
# zoo's horizon of 50 is cut to 10 to bound the script's time. Burgers-8x,
# forced, at run_evaluation's defaults (time_delta 0.1) to a horizon of 3,
# with two eval keys.
EVAL_MEMBERS = 32
KS_HORIZON = 10.0
BURGERS_HORIZON = 3.0
EVAL_DELTA = 0.1
COMPARE_MEMBERS = 4  # the card against the port's CPU path on the first members
# The card against the CPU path on the same members, of max|exact|: the
# fine solve (cuFFT against pocketfft, float32) and every scheme's
# trajectories and MAE. Each limit near 10x its reading on an H100. KS-8x:
# 44 time units of warm-up and 10 of chaos amplify float32 differences, so
# exact read 2.10e-4, model and baseline 1.88e-4; the planted faults read
# 3.9e-3 (order-1 head zeroed) and 3.9e-2 (order-3 head zeroed). Burgers-8x
# at horizon 3: exact 7.4e-6, model 5.2e-6, baseline 7.1e-6, WENO 3.6e-6;
# the forcing dropped from the model scheme read 0.87.
EVAL_TOLS = {
    "ks8": {"exact": 2e-3, "model": 1.5e-3, "baseline": 1.5e-3},
    "burgers8": {"exact": 7e-5, "model": 5e-5, "baseline": 7e-5, "weno": 3.5e-5},
}
# Phase 14: run_select at the KS-8x recipe and run_sweep, each cut to a few
# optimizer steps.
SELECT_STEPS = 2
SELECT_HORIZON = 1.0
SLEEP_CYCLES = 60_000_000  # about 30 ms of device-side sleep at H100 clocks
# Phase 15, the serving export. The artifact is the plain route, traced on the
# CPU and moved to the card; it runs cuDNN's float32 convolutions with TF32
# off. Of max|ref| at B=10240, on an H100. Against the live plain route (the
# ops it traced) the RHS and the advance read 0 (the limit is about one
# float32 ulp of the maximum); against the fused_rhs route the KS-8x RHS
# read 3.0e-5 (Burgers 3.8e-6), the kernel's tap order, held at phase 3's
# limit between the kernel and its plain version. TF32 left on and a planted fault (heads zeroed: 1.2e-4 for
# KS-8x, 2.1e-3 for Burgers-8x) must fail the plain check.
# (asset, run_export --num_steps): the first is exported in a process of its
# own while the second is exported, checked and served here
SERVE_EXPORTS = (("ckpt_ks8", 16), ("ckpt_burgers8", 4))
SERVE_RHS_TOL = 1e-4  # the served RHS against the live fused_rhs route
SERVE_PLAIN_TOL = 1e-7  # ... against the live plain route
SERVE_STEP_TOL = 1e-7  # served.advance against integrate of the live plain route
# the --exported_dir Burgers-8x ensemble's final state against the live rhs_fn
# route (read 4.8e-6 of max|u| after 100 steps), and run_evaluation
# --exported_dir's model trajectories against the live checkpoint's (read
# 2.8e-6 of max|exact|; the same survival statistics)
SERVE_ENSEMBLE_TOL = 5e-5
SERVE_EVAL_TOL = 3e-5
# Phase 16 (parallelism at world size 1). The sharded model RHS runs the
# tower VALID on a halo-padded block where the unsharded plain route pads
# each layer: the same values, though cuDNN may pick another algorithm for
# the longer input. Both RHS read 0 against their unsharded routes at
# KS-8x, B=10240 on an H100; the limits, of max|u_t|, leave a rounding.
SHARDED_PLAIN_TOL = 1e-6
SHARDED_BASE_TOL = 1e-6
PARALLEL_TRAIN_STEPS = 2
# train(mesh=) against train(), of a leaf's max, both with PyTorch's
# deterministic algorithms: without them two runs of train() alone differ
# (the weight gradients summed in another order; 9.4e-6 read after 2 steps)
PARALLEL_TRAIN_TOL = 1e-6
# Phase 17, the port's bench at reduced samples (the bench's defaults: 5
# blocks a leg, train 5 x 3 steps a route)
BENCH_SAMPLES = 3
BENCH_CPU_SAMPLES = 2
BENCH_TRAIN_BLOCKS = 3
BENCH_TRAIN_STEPS = 2
# words in the names of cuDNN's convolution kernels, as a trace shows them
CONV_KERNEL_WORDS = ("conv", "cudnn", "fprop", "implicit")
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def relative_error(got, want, rms: bool) -> float:
    """max|got - want| / max|want|, or with ``rms`` the root mean square of
    the difference over max|want|."""
    diff = got - want
    err = diff.square().mean().sqrt() if rms else diff.abs().max()
    return float(err) / float(want.abs().max())


def check(name: str, got, want, tol: float, rms: bool = False) -> float:
    """Max abs error; raises if the relative error (of the maximum, or with
    ``rms`` of the root mean square) exceeds ``tol`` x max|want| or if either
    side is not finite."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max())
    rel = relative_error(got, want, rms)
    verdict = "ok" if rel <= tol else "FAIL"
    log(f"  {name}: max abs err {err:.3e}, rel {'rms ' if rms else ''}{rel:.3e} (tolerance "
        f"{tol:.0e} of max|ref| {float(want.abs().max()):.4g}"
        + (f"; rel max {relative_error(got, want, False):.3e}, no limit" if rms else "")
        + f") {verdict}")
    if rel > tol:
        raise AssertionError(f"{name}: relative error {rel} > {tol}")
    return err


def check_catches(name: str, got, want, tol: float, rms: bool = False) -> None:
    """Raises unless ``got`` (from planted-fault weights) misses ``want`` by
    more than ``tol`` x max|want|, in the statistic of the check it tests: a
    check that passes a fault has no power."""
    rel = relative_error(got, want, rms)
    verdict = "caught" if rel > tol else "NOT CAUGHT"
    log(f"  planted fault, {name}: rel {'rms ' if rms else ''}err {rel:.3e} "
        f"(tolerance {tol:.0e}) {verdict}")
    if not rel > tol:
        raise AssertionError(f"planted fault {name} passes the {tol} check: {rel}")


def learned_rk4_float64(u, pack, dt: float, steps: int):
    """``fused_learned_rk4_plain`` with float64 weights, sums and state, the
    tower's and the heads' inputs still rounded to bf16 where the kernel
    rounds them."""
    import dataclasses

    from pde_superresolution_torch.ops import fused_kernels as fk

    exact = dataclasses.replace(pack, flat=pack.flat.double())
    return fk.fused_learned_rk4_plain(u.double(), exact, dt, steps)


def planted_faults(params: dict) -> dict:
    """{name: a copy of a tower model's state dict with one planted fault}."""
    import torch

    layers = sum(1 for k in params if k.startswith("tower.") and k.endswith(".weight"))
    last = f"tower.{layers - 1}"
    w = params[f"{last}.weight"]  # [C, C, K]
    identity = torch.zeros_like(w)
    identity[range(w.shape[0]), range(w.shape[0]), (w.shape[2] - 1) // 2] = 1.0
    return {
        "heads zeroed": {k: torch.zeros_like(v) if k.startswith("heads.") else v
                         for k, v in params.items()},
        "last tower layer skipped": {**params, f"{last}.weight": identity,
                                     f"{last}.bias": torch.zeros_like(params[f"{last}.bias"])},
        "layer 1 input channels reversed": {
            **params, "tower.1.weight": params["tower.1.weight"].flip(1).contiguous()},
    }


def tensor_core_line(library) -> str:
    """Which tensor-core instructions the built fused_learned_rk4 kernels
    hold: counts of HMMA (mma.sync) and of GMMA (wgmma) in the library's
    SASS, per kernel, read with the toolkit's cuobjdump."""
    from pde_superresolution_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return "tensor-core instructions: not read (no cuobjdump beside nvcc)"
    out = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        return f"tensor-core instructions: not read (cuobjdump exit code {out.returncode})"
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            # the mangled template arguments <NT, FORCED>: channels = 8 NT
            found = re.search(r"fused_learned_rk4_kernelILi(\d+)ELb(\d)EE", name)
            if found:
                name = (f"fused_learned_rk4<{8 * int(found.group(1))} channels, "
                        f"{'forced' if found.group(2) == '1' else 'unforced'}>")
        elif name and "fused_learned_rk4" in name:
            row = counts.setdefault(name, [0, 0, 0])
            row[0] += "HMMA" in line
            row[1] += "GMMA" in line
            row[2] += "LDSM" in line
    if not counts:
        return "tensor-core instructions: not read (no fused_learned_rk4 kernel in the SASS)"
    return "tensor-core instructions in SASS (HMMA = mma.sync, GMMA = wgmma, LDSM = ldmatrix): " + (
        "; ".join(f"{n}: {h} HMMA, {g} GMMA, {l} LDSM" for n, (h, g, l) in sorted(counts.items())))


def check_stencil_builds(build) -> None:
    """Raises if ptxas gave an instantiation of fused_rk4 or fused_rhs a
    stack frame or a spill, or if their SASS holds local-memory loads or
    stores (LDL, STL), or fused_rk4's a barrier (BAR)."""
    from pde_superresolution_torch.scripts.probe_stencil_kernels import ptxas_lines, sass_counts

    frames = [line for line in ptxas_lines(build) if "stack frame" in line]
    if not frames:
        log("    stack frames: not read (the library was built by an earlier process)")
    bad = [line for line in frames if not line.endswith(
        ": 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
    sass = sass_counts(build.library)
    log(f"    fused_rk4, fused_rhs: {len(frames)} instantiations read by ptxas, "
        f"{len(bad)} with a stack frame or a spill; in the SASS of {len(sass)} kernels: "
        + ", ".join(f"{op} {sum(row[op] for row in sass.values())}" for op in ("LDL", "STL"))
        + f", BAR in fused_rk4 {sum(r['BAR'] for n, r in sass.items() if 'fused_rk4' in n)}")
    if bad or any(row["LDL"] or row["STL"] or ("fused_rk4" in name and row["BAR"])
                  for name, row in sass.items()):
        raise AssertionError(f"stack frames, spills or barriers: {bad}, {sass}")


def time_ms(fn, inner: int = 1, queued: bool = False, samples: int = 0) -> float:
    """Median over ``samples`` (default SAMPLES) of the per-call time of ``inner`` back-to-back
    calls, on CUDA events, after one warm-up call.

    Unqueued, the events also count the host's dispatch whenever the host is
    slower than the card: that is the time a caller pays. ``queued`` first
    holds the card in a device-side sleep while the host queues the calls,
    so the events time the device's work alone; it logs when the host took
    longer to queue them than the sleep lasted (the time is then not the
    device's alone).
    """
    import torch

    fn()
    torch.cuda.synchronize()
    sleep_ms = 0.0
    if queued:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        end.record()
        end.synchronize()
        sleep_ms = start.elapsed_time(end)
    samples = []
    for _ in range(samples or SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host = time.perf_counter()
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - host)
        end.synchronize()
        if queued and host_ms > sleep_ms:
            log(f"    note: queuing took {host_ms:.2f} ms > the {sleep_ms:.2f} ms sleep")
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def launch_count(fn) -> tuple:
    """(kernel launches the host issued, kernel records on the device) in
    one call of ``fn``, from torch.profiler, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = sum(1 for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name)
    device = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    return host, device


def device_profile(fn, calls: int, warm_up: bool = True) -> dict:
    """{kernel name: device microseconds per call} over ``calls`` calls,
    from torch.profiler's CUDA activity (CUPTI), after one warm-up call
    unless ``warm_up`` is false. The host's operators are not recorded: at
    a train step's tens of thousands of them that took a minute."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm_up:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            per_kernel[evt.name] = (
                per_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us() / calls
            )
    return per_kernel


def perturbed_model(name, cons, size, device, nx, filters=32, layers=3, batch=3):
    """A seeded model with small non-zero heads and a seeded initial batch."""
    import torch

    from pde_superresolution_torch import equations
    from pde_superresolution_torch.grids import Grid
    from pde_superresolution_torch.models import ModelConfig, StencilModel

    eq = equations.from_name(name, conservative=cons)
    grid = Grid(8 * nx, eq.period).resample(8, conservative=cons)
    model = StencilModel(eq, grid, ModelConfig(num_layers=layers, filters=filters,
                                               stencil_size=size), device=device)
    gen = torch.Generator().manual_seed(SEED)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen).to(device)
              for k, v in model.init_params(gen).items()}
    u = eq.initial_conditions(gen, grid, (batch,), device)
    return model, params, u


def rhs_bound_ms(u, coeffs, f) -> float:
    """Least time for one fused RHS: each input read once and u_t written
    once at the HBM rate (the tap arithmetic, 2 flops per tap plus about 10
    per point, is far below the float32 rate)."""
    numel = u.numel() * (2 + (f is not None)) + sum(c.numel() for c in coeffs.values())
    flops = u.numel() * (2 * sum(c.shape[-1] for c in coeffs.values()) + 10)
    return 1e3 * max(4 * numel / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def learned_rk4_bound_ms(pack, batch: int, steps: int, terms: int = 0) -> float:
    """Least time for ``steps`` fused RK4 steps. Per grid point and RHS the
    tower (K*Cin*C per layer) and heads (C*F) multiply bf16-rounded inputs,
    at the bf16 tensor-core rate; the projection (S*F) and stencil (S) are
    float32, at the CUDA-core rate. Forcing with ``terms`` sinusoids adds,
    per point and step, three sums of ``terms`` multiply-adds (the step's
    start, middle and end) and two rotations of 4 products and 2 sums per
    term, float32. The bytes (state in and out, weights, and the forcing's
    pack of 3 + 2 nx floats per term and trajectory, once per launch) are
    far below either."""
    nx = pack.grid.size
    points = nx * batch * steps
    bf16_macs = sum(w.numel() for w, _ in pack.tower) + pack.head_w.numel()
    f32_macs = pack.pn.numel() + pack.pn.shape[0]
    ops_s = points * (
        4 * 2.0 * (bf16_macs / BF16_TENSOR_FLOPS + f32_macs / FP32_FLOPS)
        + (3 * 2 + 2 * 6) * terms / FP32_FLOPS)
    floats = 2 * batch * nx + pack.flat.numel() + batch * terms * (3 + 2 * nx)
    return 1e3 * max(ops_s, 4 * floats / HBM_BYTES_PER_S)


def baseline_rk4_bounds_ms(scheme, batch: int) -> tuple:
    """(bytes bound, operations bound) of ``scheme.num_steps`` fused baseline
    RK4 steps: the state read and written once; per point and stage two
    flops per tap, about 8 for the flux or equation of motion and its
    divergence and 4 for the stage combine, float32."""
    nx = scheme.grid.size
    taps = sum(len(t) for t in scheme.taps.values())
    flops = nx * batch * scheme.num_steps * 4 * (2 * taps + 12)
    return 1e3 * 8 * batch * nx / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS


def forcing_faults(forcing, fpack, pack_again) -> dict:
    """{name: a ForcingPack with one planted fault}; ``pack_again(t, dt_scale)``
    repacks the same forcing at another start time or step."""
    import torch

    halved = pack_again(FORCING_T0, 0.5)
    return {
        "amplitudes zeroed": fpack._replace(amplitude=torch.zeros_like(fpack.amplitude)),
        "rotation angle halved": fpack._replace(rot_cos=halved.rot_cos, rot_sin=halved.rot_sin),
        "start time ignored": pack_again(0.0, 1.0),
    }


def leaf_errors(got: dict, want: dict) -> dict:
    """{leaf: max|got - want| / max|want|} over a state dict; infinite where
    either side is not finite."""
    def rel(a, b):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        return err if err == err and err != float("inf") else float("inf")

    return {k: rel(got[k], want[k]) for k in want}


def training_phase(card: str, launch_floor_ms: float) -> dict:
    """Phase 12: the training path at the KS-8x flagship recipe. Returns the
    readings the report needs."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pde_superresolution_torch import convert
    from pde_superresolution_torch.grids import Grid
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.training import data as data_lib
    from pde_superresolution_torch.training import loop, losses
    from pde_superresolution_torch.training.config import TrainingConfig

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    model, params, stored = convert.load_asset("ckpt_ks8", device=device)
    config = TrainingConfig.from_json(json.dumps(stored))
    eq, grid = model.equation, model.grid
    fine = Grid(config.fine_size, eq.period)
    substeps = loop._substeps(config, model)
    unroll = config.num_time_steps
    rhs_per_step = 4 * substeps * unroll
    log(f"[12] training, {stored['equation']} conservative={eq.conservative}, fine "
        f"{config.fine_size} -> {grid.size}, batch {config.batch_size}, unroll {unroll} x "
        f"{substeps} substeps ({rhs_per_step} RHS per loss), {config.num_trajectories} "
        f"trajectories x {config.num_times} times, warm-up {config.warmup_time}; on {card}")

    # -- data and norms, as train() builds them
    torch.cuda.synchronize()
    start = time.perf_counter()
    snaps = data_lib.generate_snapshots(
        eq, fine, torch.Generator().manual_seed(config.data_seed),
        config.num_trajectories, config.num_times, config.time_delta,
        warmup_time=config.warmup_time, ic_scale=config.ic_scale, device=device)
    data = data_lib.build_training_data(eq, fine, snaps, config.resample_factor, unroll)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - start
    if not all(torch.isfinite(t).all() for t in (data.inputs, data.rollout, data.time_deriv_label)):
        raise AssertionError("training data are not finite")
    train_idx, eval_idx = loop._split_train_eval(data, config.frac_training, config.seed)
    train_set = loop._slice_batch(data, train_idx)
    eval_set = loop._slice_batch(data, eval_idx)
    start = time.perf_counter()
    norms = losses.compute_loss_norms(model, train_set, unroll, config.time_delta, substeps)
    torch.cuda.synchronize()
    norms_s = time.perf_counter() - start
    log(f"    data generation {data_s:.3f} s ({data.num_samples} samples; "
        f"{int(np.ceil(config.warmup_time / (config.time_delta / 4)))} warm-up ETDRK4 steps); "
        f"loss norms {norms_s:.3f} s (integrated {[round(x, 5) for x in norms.integrated]})")

    idx = np.random.RandomState(config.seed * 100003).randint(
        0, train_idx.size, size=config.batch_size)
    batch = loop._slice_batch(train_set, idx)
    labels = batch.rollout.transpose(0, 1).double()  # [K, B, nx], as the states
    tx = loop.make_optimizer(config)
    opt = tx.init(params)
    real_vjp = fk.fused_rhs_vjp

    def with_vjp(vjp, fn):
        fk.fused_rhs_vjp = vjp
        try:
            return fn()
        finally:
            fk.fused_rhs_vjp = real_vjp

    def timed(fn):
        """(fn(), ms on CUDA events around the call, the host's part included)."""
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, begin.elapsed_time(end)

    def train_step(use_kernel):
        """One train step, the update discarded: (loss, gradients)."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = losses.compute_loss(model, leaves, batch, norms, config.loss_weights,
                                      config.time_delta, unroll, substeps, use_kernel=use_kernel)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        tx.update(grads, opt, params)
        return loss.detach(), grads

    def rollout_value(p, use_kernel):
        states = losses.rollout_states(model.rhs_fn(p, use_kernel=use_kernel), batch.inputs,
                                       batch.t, config.time_delta, substeps, unroll)
        return 0.5 * (states.double() - labels).square().mean(), states.detach()

    def smooth_grads(use_kernel):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        value, states = rollout_value(leaves, use_kernel)
        return dict(zip(leaves, torch.autograd.grad(value, list(leaves.values())))), states

    # -- the backward held tightly, on a smooth function of the rollout
    smooth_k, states_k = smooth_grads(True)
    smooth_p, states_p = smooth_grads(False)
    errs = leaf_errors(smooth_k, smooth_p)
    smooth_err = max(errs.values())
    flips = int(((states_k.double() - labels).sign() != (states_p.double() - labels).sign()).sum())
    log(f"    rollout's mean squared error, kernel vs plain route, B={config.batch_size}: "
        f"gradients, worst leaf of its max {smooth_err:.3e} (tolerance {SMOOTH_GRAD_TOL:.0e}): "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    log(f"    states on the other side of their label between the routes: {flips} of "
        f"{labels.numel()} (sign flips of the mean absolute error's gradient); states differ "
        f"by {float((states_k - states_p).abs().max()):.3e} at most")
    if not smooth_err <= SMOOTH_GRAD_TOL:
        raise AssertionError(f"smooth gradients, kernel route against plain route: {errs}")
    scaled = lambda static, inputs, g, needs=None: real_vjp(static, inputs, 0.99 * g, needs)
    read = max(leaf_errors(with_vjp(scaled, lambda: smooth_grads(True)[0]), smooth_p).values())
    log(f"  planted backward fault, fused_rhs VJP scaled by 0.99: worst leaf {read:.3e} "
        f"(tolerance {SMOOTH_GRAD_TOL:.0e}) {'caught' if read > SMOOTH_GRAD_TOL else 'NOT CAUGHT'}")
    if not read > SMOOTH_GRAD_TOL:
        raise AssertionError(f"planted backward fault (VJP scaled by 0.99) passes: {read}")
    # one directional derivative of the kernel route against a central difference
    gen = torch.Generator().manual_seed(SEED)
    direction = {k: torch.randn(v.shape, generator=gen).to(device) for k, v in params.items()}
    norm = float(torch.sqrt(sum(d.square().sum() for d in direction.values())))
    projected = float(sum((g * direction[k]).sum() for k, g in smooth_k.items())) / norm
    with torch.no_grad():
        shifted = [float(rollout_value({k: params[k] + s * FD_STEP / norm * direction[k]
                                        for k in params}, True)[0]) for s in (1, -1)]
    fd = (shifted[0] - shifted[1]) / (2 * FD_STEP)
    fd_err = abs(fd - projected) / abs(projected)
    log(f"    directional derivative of the rollout's mean squared error, kernel route: gradient "
        f"{projected:.6g}, central difference (step {FD_STEP}) {fd:.6g}, rel {fd_err:.3e} "
        f"(tolerance {FD_TOL:.0e})")
    if not fd_err <= FD_TOL:
        raise AssertionError(f"directional derivative {projected} vs {fd}")

    # -- the training loss by both routes, timed, with launches and memory
    peak = {}
    fk.fused_rhs.launches = 0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (loss_k, grads_k), ms_k = timed(lambda: train_step(True))
    step_launches = fk.fused_rhs.launches
    peak["kernel"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (loss_p, grads_p), ms_p = timed(lambda: train_step(False))
    peak["plain"] = torch.cuda.max_memory_allocated()
    step_ms = {"kernel": ms_k, "plain": ms_p}
    log(f"    fused_rhs launches in one kernel-route train step: {step_launches} "
        f"(predicted {2 * rhs_per_step}: {rhs_per_step} forward + {rhs_per_step} recomputed "
        f"by the rematerialized backward)")
    if step_launches != 2 * rhs_per_step:
        raise AssertionError(f"fused_rhs launches per train step {step_launches}")
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = leaf_errors(grads_k, grads_p)
    worst = max(errs.values())
    log(f"    training loss, kernel vs plain route: {float(loss_k):.7g} vs {float(loss_p):.7g}, "
        f"rel {loss_err:.3e} (tolerance {TRAIN_LOSS_TOL:.0e}); gradients, worst leaf of its max "
        f"{worst:.3e} (tolerance {TRAIN_GRAD_TOL:.0e}): "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    if not (np.isfinite(float(loss_k)) and loss_err <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"kernel route against plain route: {loss_err}, {errs}")
    dropped = lambda static, inputs, g, needs=None: (
        *real_vjp(static, inputs, g, needs)[:-1], torch.zeros_like(inputs[-1]))
    # a non-finite gradient fails the check as well as a large one
    read = max(leaf_errors(with_vjp(dropped, lambda: train_step(True)[1]), grads_p).values())
    caught = not read <= TRAIN_GRAD_TOL
    log(f"  planted backward fault, gradient to the highest order's coefficients dropped: "
        f"worst leaf {read:.3e} (tolerance {TRAIN_GRAD_TOL:.0e}) "
        f"{'caught' if caught else 'NOT CAUGHT'}")
    if not caught:
        raise AssertionError(f"planted backward fault (highest order dropped) passes: {read}")

    # -- times
    def eval_step():
        with torch.no_grad():
            losses.compute_loss(model, params, eval_set, norms, config.loss_weights,
                                config.time_delta, unroll, substeps, use_kernel=True)

    eval_ms = time_ms(eval_step, samples=1)
    start = time.perf_counter()
    busy = sum(device_profile(lambda: train_step(True), 1, warm_up=False).values()) / 1e3
    profile_s = time.perf_counter() - start
    if not busy > 0:
        raise AssertionError("torch.profiler recorded no device time in a train step")
    u = batch.inputs.contiguous()
    coeffs = {d: c.contiguous() for d, c in model.coefficients(params, u).items()}
    with torch.no_grad():
        rhs_ms = time_ms(lambda: fk.fused_rhs(u, coeffs, None, eq, grid, model.taps), inner=10,
                         queued=True)
        rhs_call_ms = time_ms(lambda: fk.fused_rhs(u, coeffs, None, eq, grid, model.taps),
                              inner=10)
        rhs_plain_ms = time_ms(lambda: fk.fused_rhs_plain(u, coeffs, None, eq, grid, model.taps),
                               inner=10)
    rhs_bound = rhs_bound_ms(u, coeffs, None)
    static = (eq, grid, {d: model.taps[d] for d in sorted(model.taps)})
    inputs = (u, None, *(coeffs[d] for d in sorted(coeffs)))
    g_out = torch.randn(u.shape, generator=gen).to(device)
    vjp_ms = time_ms(lambda: fk.fused_rhs_vjp(static, inputs, g_out), inner=10)
    log(f"    train step (loss, gradients, Adam), B={config.batch_size}, one warm step each: "
        f"kernel route {step_ms['kernel']:.1f} ms, plain route {step_ms['plain']:.1f} ms; eval "
        f"step ({eval_set.num_samples} samples, kernel route, no grad) {eval_ms:.1f} ms")
    log(f"    kernel-route step: device busy {busy:.1f} ms of {step_ms['kernel']:.1f} "
        f"({100 * busy / step_ms['kernel']:.1f}%, torch.profiler, a lower bound; the profiled "
        f"step took {profile_s:.1f} s)")
    log(f"    peak memory of a step {peak['kernel'] / 2**20:.1f} MiB (plain route "
        f"{peak['plain'] / 2**20:.1f} MiB): {resident / 2**20:.1f} MiB allocated before it "
        f"(the dataset, its splits, the earlier phases' tensors), so the step's own "
        f"{(peak['kernel'] - resident) / 2**20:.1f} MiB (plain {(peak['plain'] - resident) / 2**20:.1f})")
    log(f"    fused_rhs at B={config.batch_size}: {1e3 * rhs_ms:.3f} us device (queued), "
        f"{1e3 * rhs_call_ms:.2f} us per wrapper call, plain {1e3 * rhs_plain_ms:.2f} us; bytes "
        f"bound {1e3 * rhs_bound:.3f} us, launch floor {1e3 * launch_floor_ms:.3f} us; "
        f"{2 * rhs_per_step} launches = {2 * rhs_per_step * rhs_call_ms:.1f} ms of the step "
        f"({100 * 2 * rhs_per_step * rhs_call_ms / step_ms['kernel']:.1f}%)")
    log(f"    the backward twin (fused_rhs_vjp, plain autograd) at B={config.batch_size}: "
        f"{1e3 * vjp_ms:.1f} us per call; {rhs_per_step} per step = "
        f"{rhs_per_step * vjp_ms:.1f} ms ({100 * rhs_per_step * vjp_ms / step_ms['kernel']:.1f}% "
        f"of the kernel-route step)")

    # -- train(): the entry point, a checkpoint, and a resume from its middle
    short = dataclasses.replace(
        config, learning_stops=(TRAIN_STEPS // 4, TRAIN_STEPS // 2, TRAIN_STEPS),
        eval_interval=TRAIN_EVERY, checkpoint_interval=TRAIN_EVERY)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        fk.fused_rhs.launches = 0
        start = time.perf_counter()
        _, trained, metrics = loop.train(short, dataset=data, checkpoint_dir=str(work / "a"),
                                         metrics_path=str(work / "a.jsonl"), device=device,
                                         use_kernel=True)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - start
        train_launches = fk.fused_rhs.launches
        evals = TRAIN_STEPS // TRAIN_EVERY
        want_launches = TRAIN_STEPS * 2 * rhs_per_step + evals * rhs_per_step
        saved = loop.checkpoint_steps(str(work / "a"))
        log(f"    train(): {TRAIN_STEPS} steps in {train_s:.2f} s (norms, {evals} evals and "
            f"{len(saved)} checkpoints included); eval_total {metrics['eval_total']:.6g}, "
            f"train_total {metrics['train_total']:.6g}; fused_rhs launches {train_launches} "
            f"(predicted {want_launches}); checkpoints at steps {saved}")
        with open(work / "a.jsonl") as f:
            walls = [json.loads(line)["wall_time"] for line in f]
        log(f"    train(): seconds from the end of its set-up (data on the device, split, norms) "
            f"to each eval's record: {walls}")
        if not (np.isfinite(metrics["eval_total"]) and saved == [TRAIN_EVERY, TRAIN_STEPS]
                and train_launches == want_launches):
            raise AssertionError(f"train(): {metrics}, {saved}, {train_launches}")
        _, loaded, _ = loop.load_model(str(work / "a"), device=device)
        if any(not torch.equal(loaded[k], trained[k]) for k in trained):
            raise AssertionError("load_model does not give the trained params back")
        shutil.copytree(work / "a" / str(TRAIN_EVERY), work / "b" / str(TRAIN_EVERY))
        start = time.perf_counter()
        _, resumed, metrics_b = loop.train(short, dataset=data, checkpoint_dir=str(work / "b"),
                                           device=device, use_kernel=True)
        resume_launches = fk.fused_rhs.launches - train_launches
        want_resume = ((TRAIN_STEPS - TRAIN_EVERY) * 2 * rhs_per_step
                       + (evals - 1) * rhs_per_step)
        train_launches += resume_launches
        resume_err = max(leaf_errors(resumed, trained).values())
        log(f"    resumed at step {TRAIN_EVERY} ({time.perf_counter() - start:.2f} s) against "
            f"uninterrupted: worst leaf {resume_err:.3e} "
            f"(tolerance {RESUME_TOL:.0e}); eval_total {metrics_b['eval_total']:.6g}; fused_rhs "
            f"launches {resume_launches} (predicted {want_resume})")
        if not (resume_err <= RESUME_TOL and resume_launches == want_resume):
            raise AssertionError(f"resumed run differs: {resume_err}, {resume_launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- the large-ensemble path, device- and host-resident
    torch.cuda.synchronize()
    start = time.perf_counter()
    trajectories = data_lib.build_trajectory_data(
        eq, fine, config.data_seed, TRAJECTORIES, config.num_times, config.time_delta,
        config.resample_factor, unroll, warmup_time=config.warmup_time,
        ic_scale=config.ic_scale, device=device)
    torch.cuda.synchronize()
    traj_data_s = time.perf_counter() - start
    host = data_lib.map_data(lambda a: a.cpu().numpy(), trajectories)
    tconfig = dataclasses.replace(
        config, num_trajectories=TRAJECTORIES, learning_rates=(config.learning_rates[0],),
        learning_stops=(TRAJECTORY_STEPS,), eval_interval=TRAJECTORY_STEPS)
    runs, traj_launches = {}, {}
    for name, dataset in (("device", trajectories), ("host", host)):
        fk.fused_rhs.launches = 0
        start = time.perf_counter()
        _, p, m = loop.train(tconfig, dataset=dataset, device=device, use_kernel=True)
        torch.cuda.synchronize()
        runs[name] = p
        traj_launches[name] = fk.fused_rhs.launches
        log(f"    trajectories, {name}-resident ({trajectories.nbytes() / 2**20:.0f} MiB): "
            f"{TRAJECTORY_STEPS} step(s) in {time.perf_counter() - start:.2f} s, eval_total "
            f"{m['eval_total']:.6g}, fused_rhs launches {fk.fused_rhs.launches}")
        if not np.isfinite(m["eval_total"]):
            raise AssertionError(f"trajectory training ({name}) not finite: {m}")
    host_err = max(leaf_errors(runs["host"], runs["device"]).values())
    log(f"    {TRAJECTORIES} trajectories generated in {traj_data_s:.2f} s; host-resident "
        f"against device-resident params: worst leaf {host_err:.3e} (tolerance {RESUME_TOL:.0e})")
    if not host_err <= RESUME_TOL:
        raise AssertionError(f"host- and device-resident runs differ: {host_err}")
    phase_s = time.perf_counter() - phase_start
    log(f"    phase 12 took {phase_s:.1f} s")
    return {
        "step_launches": step_launches, "train_launches": train_launches,
        "trajectory_launches": traj_launches["device"] + traj_launches["host"],
        "loss_err": loss_err, "grad_err": worst, "rhs_ms": rhs_ms, "rhs_call_ms": rhs_call_ms,
        "rhs_plain_ms": rhs_plain_ms, "rhs_bound_ms": rhs_bound, "step_ms": step_ms,
        "eval_ms": eval_ms, "vjp_ms": vjp_ms, "busy_ms": busy, "peak_bytes": peak,
        "data_s": data_s, "norms_s": norms_s, "smooth_grad_err": smooth_err, "phase_s": phase_s,
    }


def _keep_first(draw, count: int):
    """``evaluate._draw`` that keeps the first ``count`` members of the draw
    it makes (the card's run and the CPU's then hold the same members)."""
    def first(*args):
        u0, forcing = draw(*args)
        if forcing is not None:
            forcing = type(forcing)(*(leaf[:count].contiguous() for leaf in forcing))
        return u0[:count].contiguous(), forcing

    return first


class LayerTimes:
    """Host seconds (after a synchronize) of each exact fine solve and each
    scheme's integration inside ``evaluate``, recorded while it is entered:
    ``integrate.exact_solve_sampled`` and ``integrate.integrate`` are
    wrapped for that time (evaluate runs the schemes in their dict's
    order)."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        import torch

        from pde_superresolution_torch import integrate

        self._real = (integrate.exact_solve_sampled, integrate.integrate)

        def timed(fn, kind):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.records.append((kind, time.perf_counter() - start))
                return out
            return run

        integrate.exact_solve_sampled = timed(self._real[0], "exact")
        integrate.integrate = timed(self._real[1], "scheme")
        return self

    def __exit__(self, *exc):
        from pde_superresolution_torch import integrate

        integrate.exact_solve_sampled, integrate.integrate = self._real

    def by_layer(self, schemes) -> dict:
        """{layer: seconds summed over the eval keys}; the scheme records are
        matched to ``schemes`` in order."""
        out = {"exact": sum(t for kind, t in self.records if kind == "exact")}
        legs = [t for kind, t in self.records if kind == "scheme"]
        for i, name in enumerate(schemes):
            out[name] = sum(legs[i::len(schemes)])
        return out


def eval_schedule(model, time_delta: float) -> tuple:
    """(inner RK4 steps per save, coarse dt) as ``run_evaluation`` and
    ``evaluate`` choose them: the model's stable step only where it is
    tighter than the equation's."""
    import numpy as np

    eq_dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    model_dt = model.stable_time_step(u_scale=3.0)
    if model_dt < eq_dt:
        inner = max(1, int(np.ceil(time_delta / model_dt - 1e-9)))
    else:
        inner = max(1, int(np.ceil(time_delta / eq_dt)))
    return inner, time_delta / inner


def compare_evaluations(label: str, card, cpu, tols: dict, threshold: float = 0.8) -> dict:
    """Hold the card's evaluation (its first members) against the CPU path's
    on the same members: the times, ``exact``, and each scheme's
    trajectories and MAE, of max|exact|; survival times equal but for flips
    explained by the two sides' correlations (the distance of the CPU's
    correlation to the threshold at most the card's difference from it).
    Returns the readings and the flip counts."""
    import torch

    n = cpu.exact.shape[0]
    want_exact = cpu.exact.double()
    scale = float(want_exact.abs().max())

    def rel(got, want):
        got, want = got[:n].cpu().double(), want.cpu().double()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            return float("inf")
        return float((got - want).abs().max()) / scale

    if not torch.allclose(card.times.cpu(), cpu.times, rtol=1e-6, atol=0):
        raise AssertionError(f"{label}: times differ {card.times} {cpu.times}")
    readings = {"exact": rel(card.exact, cpu.exact)}
    flips = {}
    for name in cpu.trajectories:
        readings[name] = max(rel(card.trajectories[name], cpu.trajectories[name]),
                             rel(card.mae[name], cpu.mae[name]))
        got_c = card.correlation[name][:n].cpu().double()
        want_c = cpu.correlation[name].double()
        differ = card.survival_time[name][:n].cpu() != cpu.survival_time[name]
        explained = (want_c - threshold).abs().amin(-1) <= (got_c - want_c).abs().amax(-1)
        flips[name] = int(differ.sum())
        if (differ & ~explained).any():
            raise AssertionError(f"{label} {name}: survival flips not explained by the "
                                 f"correlations: {card.survival_time[name][:n]} vs "
                                 f"{cpu.survival_time[name]}")
    for key, value in readings.items():
        tol = tols[key]
        log(f"  {label}, card vs CPU, first {n} members, {key}"
            f"{'' if key == 'exact' else ' trajectories and MAE'}: rel {value:.3e} of max|exact| "
            f"{scale:.4g} (tolerance {tol:.0e}) {'ok' if value <= tol else 'FAIL'}")
    log(f"    survival times: flips (each explained by the correlations) {flips}")
    bad = {k: v for k, v in readings.items() if not v <= tols[k]}
    if bad:
        raise AssertionError(f"{label}: card against CPU path beyond the limits: {bad}")
    return {"readings": readings, "flips": flips}


def evaluation_phase(card: str, launch_floor_ms: float) -> dict:
    """Phase 13: evaluation at the KS-8x and Burgers-8x protocols. Returns
    the readings the report needs."""
    import shutil
    import tempfile

    import torch

    from pde_superresolution_torch import convert, equations
    from pde_superresolution_torch import evaluate as eval_lib
    from pde_superresolution_torch import integrate
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.scripts import run_evaluation

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    log(f"[13] evaluation through scripts.run_evaluation, {EVAL_MEMBERS} members; on {card}")
    protocols = {
        "ks8": ["--checkpoint_dir", "ckpt_ks8", "--num_samples", str(EVAL_MEMBERS),
                "--ic_scale", "0.1", "--warmup_time", "44", "--time_delta", str(EVAL_DELTA),
                "--time_max", str(KS_HORIZON), "--reference_cache_dir", ""],
        "burgers8": ["--checkpoint_dir", "ckpt_burgers8", "--num_samples", str(EVAL_MEMBERS),
                     "--time_delta", str(EVAL_DELTA), "--time_max", str(BURGERS_HORIZON),
                     "--seeds", "0,1", "--reference_cache_dir", ""],
    }
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    out = {}
    try:
        for label, flags in protocols.items():
            model, params, config = convert.load_checkpoint(flags[1], device=device)
            inner, dt = eval_schedule(model, EVAL_DELTA)
            horizon = KS_HORIZON if label == "ks8" else BURGERS_HORIZON
            saves = int(round(horizon / EVAL_DELTA))
            keys = 1 if label == "ks8" else 2
            predicted = keys * saves * inner * 4
            schemes = ["model", "baseline"] + (["weno"] if model.equation.name == "burgers" else [])
            log(f"  {label}: {config.equation}, fine {config.fine_size} -> {model.grid.size}, "
                f"stencil {model.config.stencil_size}; {saves} saves x {inner} RK4 steps of "
                f"{dt:.9g}; schemes {schemes}; predicted fused_rhs launches {keys} keys x "
                f"{saves} x {inner} x 4 = {predicted}")
            argv = flags + ["--output_path", str(work / f"{label}.h5")]
            fk.fused_rhs.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            with LayerTimes() as layers:
                if label == "burgers8" and has_h5py:
                    route = "run_evaluation.main, HDF5 written"
                    result = run_evaluation.main(argv)
                else:
                    route = ("run_evaluation.evaluate_checkpoint, no file" if label == "burgers8"
                             else "run_evaluation.evaluate_checkpoint")
                    result = run_evaluation.evaluate_checkpoint(
                        run_evaluation.build_parser().parse_args(argv))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = fk.fused_rhs.launches
            times = layers.by_layer(schemes)
            log(f"    {route}{' (h5py is not installed)' if label == 'burgers8' and not has_h5py else ''}"
                f": {seconds:.2f} s; fused_rhs launches {launches} (predicted {predicted})")
            if launches != predicted:
                raise AssertionError(f"{label}: fused_rhs launches {launches} != {predicted}")
            if label == "burgers8" and has_h5py:
                written = sorted(p.name for p in work.iterdir())
                loaded = eval_lib.load_eval_h5(str(work / "burgers8.key0.h5"))
                if written != ["burgers8.key0.h5", "burgers8.key1.h5"] or not torch.equal(
                        loaded.exact, result["results"][0].exact.cpu()):
                    raise AssertionError(f"HDF5 output: {written}")
            first = result["results"][result["seeds"][0]]
            for seed, res in result["results"].items():
                if res.exact.shape != (EVAL_MEMBERS, saves + 1, model.grid.size) or not all(
                        torch.isfinite(res.trajectories[s]).all() for s in ("model",)):
                    raise AssertionError(f"{label} key {seed}: shape {res.exact.shape} or a "
                                         "model member is not finite")
            log(f"    layers (s, summed over keys): " + ", ".join(
                f"{k} {v:.3f}" for k, v in times.items())
                + f"; the rest (loading, draw, metrics) {seconds - sum(times.values()):.3f}")
            log(f"    statistics: {json.dumps(result['per_key'])}")
            if label == "ks8":
                median = result["per_key"][result["seeds"][0]]["model"]["survival_median"]
                log(f"    KS-8x model survival median {median} of horizon {KS_HORIZON}")
                if abs(median - KS_HORIZON) > 1e-3:
                    raise AssertionError(f"KS-8x model survival median {median} != horizon")

            # -- the card against the CPU path, on the first members of the draw
            real_draw = eval_lib._draw
            eval_lib._draw = _keep_first(real_draw, COMPARE_MEMBERS)
            try:
                cpu_args = run_evaluation.build_parser().parse_args(argv + ["--device", "cpu"])
                cpu_args.seeds, cpu_args.seed = "", result["seeds"][0]
                start = time.perf_counter()
                cpu = run_evaluation.evaluate_checkpoint(cpu_args)["results"][cpu_args.seed]
                cpu_s = time.perf_counter() - start
            finally:
                eval_lib._draw = real_draw
            compared = compare_evaluations(label, first, cpu, EVAL_TOLS[label])
            log(f"    the CPU path on {COMPARE_MEMBERS} members took {cpu_s:.1f} s")
            # -- planted faults in the model scheme, run on the card from the
            # same coarse start; each must fail the model's limit
            u_start = first.exact[:COMPARE_MEMBERS, 0].contiguous()
            t0 = float(first.times[0])
            if label == "ks8":
                faults = {f"order-{d} head zeroed": model.rhs_fn(
                    {k: torch.zeros_like(v) if k.startswith(f"heads.{d}.") else v
                     for k, v in params.items()}) for d in (1, 3)}
            else:
                faults = {"forcing dropped from the model scheme": model.rhs_fn(params, None)}
            fault_reads = {}
            tol = EVAL_TOLS[label]["model"]
            for fault, rhs in faults.items():
                with torch.no_grad():
                    _, bad_traj = integrate.integrate(rhs, u_start, dt, saves * inner, inner,
                                                      t0=t0)
                read = fault_reads[fault] = float(
                    (bad_traj.transpose(0, 1).cpu().double()
                     - cpu.trajectories["model"].double()).abs().max()
                ) / float(cpu.exact.double().abs().max())
                log(f"  planted fault, {label}, {fault}: model trajectories rel {read:.3e} "
                    f"(tolerance {tol:.0e}) {'caught' if read > tol else 'NOT CAUGHT'}")
            if not all(read > tol for read in fault_reads.values()):
                raise AssertionError(f"a planted fault passes the {label} limit: {fault_reads}")

            # -- where the model leg's time goes: device time of one save
            # interval (torch.profiler, device activity only) against the leg's
            # host clock; fused_rhs at this batch against its bound
            u = first.exact[:, 0].contiguous()
            with torch.no_grad():
                busy = sum(device_profile(
                    lambda: integrate.integrate(model.rhs_fn(params), u, dt, inner, inner,
                                                t0=t0), 1).values()) / 1e3
                coeffs = {d: c.contiguous() for d, c in model.coefficients(params, u).items()}
                f = None
                if model.equation.forced:
                    # the forcing of the first key's draw, drawn again
                    gen = torch.Generator().manual_seed(result["seeds"][0])
                    fine = type(model.grid)(config.fine_size, model.equation.period)
                    _, forcing = real_draw(model.equation, fine, gen, EVAL_MEMBERS, 1.0, device)
                    x = torch.as_tensor(model.grid.x, dtype=torch.float32, device=device)
                    f = equations.forcing_term(forcing, x, t0, model.equation.period,
                                               model.grid.dx).contiguous()
                rhs_args = (u, coeffs, f, model.equation, model.grid, model.taps)
                rhs_ms = time_ms(lambda: fk.fused_rhs(*rhs_args), inner=100, queued=True)
                rhs_call_ms = time_ms(lambda: fk.fused_rhs(*rhs_args), inner=100)
                rhs_plain_ms = time_ms(lambda: fk.fused_rhs_plain(*rhs_args), inner=10)
            leg_busy_s = keys * saves * busy / 1e3
            host_share = 1 - leg_busy_s / times["model"]
            bound = rhs_bound_ms(u, coeffs, f)
            log(f"    model leg: {times['model']:.3f} s on the host clock, device busy "
                f"{leg_busy_s:.3f} s ({busy:.3f} ms per save interval of {4 * inner} RHS, "
                f"torch.profiler): host's share {100 * host_share:.1f}%; per RHS "
                f"{1e6 * times['model'] / (keys * saves * inner * 4):.1f} us")
            log(f"    fused_rhs at B={EVAL_MEMBERS}{' forced' if f is not None else ''}: "
                f"{1e3 * rhs_ms:.3f} us device (queued), {1e3 * rhs_call_ms:.2f} us per wrapper "
                f"call, plain {1e3 * rhs_plain_ms:.2f} us; bytes bound {1e3 * bound:.3f} us, "
                f"launch floor {1e3 * launch_floor_ms:.3f} us")
            out[label] = {
                "launches": launches, "seconds": seconds, "layers_s": times,
                "route": route, "host_share": host_share, "fault_reads": fault_reads,
                "rhs_ms": rhs_ms, "rhs_call_ms": rhs_call_ms, "rhs_plain_ms": rhs_plain_ms,
                "rhs_bound_ms": bound, **compared,
            }
            del result, first, cpu
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - phase_start
    log(f"    phase 13 took {out['phase_s']:.1f} s")
    return out


def selection_phase(card: str) -> dict:
    """Phase 14: run_select at the KS-8x recipe and run_sweep, cut to a few
    optimizer steps. Returns the launch counts and seconds."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pde_superresolution_torch import convert
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.scripts import run_select, run_sweep
    from pde_superresolution_torch.training import config as config_lib
    from pde_superresolution_torch.training import loop

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    recipe = json.loads((convert.ASSET_DIR / "ckpt_ks8.json").read_text())
    fields = {k: recipe[k] for k in ("equation", "conservative", "resample_factor", "fine_size",
                                     "num_trajectories", "num_times", "time_delta",
                                     "warmup_time", "ic_scale", "num_time_steps",
                                     "batch_size")}
    fields.update(recipe["model"])
    fields.update(learning_rates=recipe["learning_rates"][0], learning_stops=SELECT_STEPS,
                  eval_interval=SELECT_STEPS, checkpoint_interval=SELECT_STEPS)
    hparams = ",".join(f"{k}={v}" for k, v in fields.items())
    try:
        import h5py  # noqa: F401
        cache = "refs"
    except ImportError:
        cache = ""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_select_"))
    try:
        # predicted launches: the model scheme of three protocol evals
        # (two seeds' selection evals, the winner's final one)
        _, _, model = loop._model_for(config_lib.parse_hparams(hparams), device)
        inner, _ = eval_schedule(model, recipe["time_delta"])
        saves = int(round(SELECT_HORIZON / recipe["time_delta"]))
        predicted = 3 * saves * inner * 4
        log(f"[14] run_select at the KS-8x recipe, 2 seeds x {SELECT_STEPS} steps, 4 + 8 members, "
            f"horizon {SELECT_HORIZON}, warm-up 44, reference cache "
            f"{'in a temporary directory' if cache else 'off (no h5py)'}; predicted fused_rhs "
            f"launches 3 evals x {saves} saves x {inner} x 4 = {predicted}; on {card}")
        fk.fused_rhs.launches = 0
        start = time.perf_counter()
        summary = run_select.main([
            "--output_dir", str(work / "sel"), "--num_seeds", "2", "--hparams", hparams,
            "--select_samples", "4", "--final_samples", "8", "--eval_time_max",
            str(SELECT_HORIZON), "--eval_warmup", "44", "--reference_cache_dir",
            str(work / cache) if cache else ""])
        torch.cuda.synchronize()
        select_s = time.perf_counter() - start
        select_launches = fk.fused_rhs.launches
        with open(work / "sel" / "selection.json") as f:
            written = json.load(f)
        rows = written["rows"]
        log(f"    run_select: {select_s:.1f} s; fused_rhs launches {select_launches} (predicted "
            f"{predicted}); winner seed {summary['winner_seed']}, selection survival "
            f"{summary['selection_survival']}, final {summary['final_survival']}, bias "
            f"{written['selection_bias']}")
        sel, final = written["selection_score"], written["final_score"]
        if not (select_launches == predicted
                and sorted(written) == ["final_score", "rows", "selection_bias",
                                        "selection_score", "winner_checkpoint", "winner_seed"]
                and [r["seed"] for r in rows] == [0, 1]
                and summary["winner_seed"] == written["winner_seed"] in (0, 1)
                and sel["eval_seed"] == 12345 and final["eval_seed"] == 54321
                and sel["num_samples"] == 4 and final["num_samples"] == 8
                and written["selection_bias"] == (sel["model_survival_median"]
                                                  - final["model_survival_median"])
                and all(np.isfinite(r["eval_total"]) for r in rows)
                and loop.checkpoint_steps(written["winner_checkpoint"]) == [SELECT_STEPS]):
            raise AssertionError(f"run_select: {select_launches} launches, {written}")

        sweep_hparams = (f"learning_rates=1e-3,learning_stops={SELECT_STEPS},"
                         f"eval_interval={SELECT_STEPS}")
        _, _, model = loop._model_for(config_lib.parse_hparams(
            "equation=burgers,resample_factor=8", config_lib.parse_hparams(sweep_hparams)), device)
        inner, _ = eval_schedule(model, 0.1)
        predicted_sweep = int(round(SELECT_HORIZON / 0.1)) * inner * 4
        fk.fused_rhs.launches = 0
        start = time.perf_counter()
        records = run_sweep.main([
            "--equation", "burgers", "--factors", "8", "--hparams", sweep_hparams,
            "--num_eval_samples", "4", "--eval_time_max", str(SELECT_HORIZON),
            "--reference_cache_dir", ""])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - start
        sweep_launches = fk.fused_rhs.launches
        log(f"    run_sweep: {sweep_s:.1f} s; fused_rhs launches {sweep_launches} (predicted "
            f"{predicted_sweep}); {json.dumps(records)}")
        if not (sweep_launches == predicted_sweep and len(records) == 1
                and records[0]["factor"] == 8 and np.isfinite(records[0]["eval_total"])
                and records[0]["model_diverged"] == 0):
            raise AssertionError(f"run_sweep: {sweep_launches} launches, {records}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - phase_start
    log(f"    phase 14 took {phase_s:.1f} s")
    return {"select_launches": select_launches, "sweep_launches": sweep_launches,
            "select_s": select_s, "sweep_s": sweep_s, "phase_s": phase_s}


class _Cut(Exception):
    """Raised by a patched ``h5py.File.flush``: a run that dies mid-way."""


def serving_phase(card: str) -> dict:
    """Phase 15: the serving export. ``run_export`` at full width for the
    KS-8x and Burgers-8x checkpoints; each artifact on the card against the
    live model at B=ENSEMBLE, with planted faults; the ``--exported_dir``
    ensemble and evaluation against the live routes; the resumable HDF5
    route where ``h5py`` imports. Returns the readings the report needs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pde_superresolution_torch import convert, export, integrate
    from pde_superresolution_torch.device import resolve_device
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.scripts import run_ensemble, run_evaluation, run_export

    phase_start = time.perf_counter()
    device = resolve_device()  # cuda, as every entry point's default
    kernels = (fk.fused_rhs, fk.fused_learned_rk4, fk.fused_rk4)

    def zero_counts():
        for kernel in kernels:
            kernel.launches = 0

    def counts() -> dict:
        return {kernel.__name__: kernel.launches for kernel in kernels}

    log(f"[15] serving export through scripts.run_export (plain route traced on the CPU, "
        f"moved to cuda), B={ENSEMBLE}; on {card}")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    out = {"exports": {}}

    def check_artifact(name: str, steps: int, exported: dict, served) -> None:
        """The artifact on the card at B=ENSEMBLE against the live model,
        with its planted faults, and its times."""
        path = work / name
        sizes = {p.name: p.stat().st_size for p in sorted(path.iterdir())}
        log(f"  {name}, --num_steps {steps}: export {exported['export_s']:.2f} s, save "
            f"{exported['save_s']:.2f} s, load on cuda {exported['load_s']:.2f} s; bytes "
            f"{sizes}; run_export's own check (4 members against the live fused_rhs "
            f"route) {exported['kernel_rel_err']:.3e} of max|u_t| (limit "
            f"{run_export.KERNEL_REL_ERR:.0e}), against the plain route "
            f"{exported['max_abs_err']:.3e} (limit {run_export.MAX_ABS_ERR:.0e})")
        model, params, _ = convert.load_checkpoint(name, device=device)
        gen = torch.Generator().manual_seed(SEED)
        u = model.equation.initial_conditions(gen, model.grid, (ENSEMBLE,), device)
        forcing = model.equation.sample_forcing(gen, (ENSEMBLE,), device)
        t0 = 0.37
        t = torch.tensor(t0, device=device)
        with torch.no_grad():
            zero_counts()
            frozen = served.rhs_fn(forcing)(u, t)
            torch.cuda.synchronize()
            if any(counts().values()):
                raise AssertionError(f"the served RHS launched a kernel: {counts()}")
            live = model.rhs_fn(params, forcing)(u, t)  # the fused_rhs route
            plain = model.rhs_fn(params, forcing, use_kernel=False)(u, t)
        rhs_err = check(f"{name} served RHS vs the live fused_rhs route", frozen, live,
                        SERVE_RHS_TOL)
        plain_err = check(f"{name} served RHS vs the live plain route", frozen, plain,
                          SERVE_PLAIN_TOL)
        zeroed = {k: torch.zeros_like(v) if k.startswith("heads.") else v
                  for k, v in params.items()}
        export.export_and_save(model, zeroed, str(work / f"{name}_fault"))
        faulty = export.load_served_model(str(work / f"{name}_fault"))
        with torch.no_grad():
            bad = faulty.rhs_fn(forcing)(u, t)
            check_catches(f"{name}, heads zeroed before the export, vs the plain route",
                          bad, plain, SERVE_PLAIN_TOL)
            # the trained KS-8x heads move max|u_t| by about 1e-4 only, the
            # size of the kernel route's own difference: logged, no limit
            log(f"    heads zeroed, against the fused_rhs route: rel "
                f"{relative_error(bad, live, False):.3e} (no limit)")
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = served.rhs_fn(forcing)(u, t)
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            check_catches(f"{name}, TF32 left on (cudnn.allow_tf32 = True), vs the plain "
                          "route", tf32, plain, SERVE_PLAIN_TOL)
            log(f"    with TF32 on, against the fused_rhs route: rel "
                f"{relative_error(tf32, live, False):.3e} (no limit)")
            dt = served.meta["dt"]
            advanced, t_next = served.advance(u, t0, forcing)
            _, traj = integrate.integrate(model.rhs_fn(params, forcing, use_kernel=False),
                                          u, dt, steps, steps, t0=t0)
        step_err = check(f"{name} served advance ({steps} RK4 steps) vs integrate of the "
                         "live plain route", advanced, traj[-1], SERVE_STEP_TOL)
        if abs(t_next - (t0 + dt * steps)) > 1e-12:
            raise AssertionError(f"advance returned t = {t_next}")
        with torch.no_grad():
            timed = {
                "served_rhs_ms": lambda: served.rhs_fn(forcing)(u, t),
                "live_fused_rhs_route_ms": lambda: model.rhs_fn(params, forcing)(u, t),
                "live_plain_route_ms": lambda: model.rhs_fn(
                    params, forcing, use_kernel=False)(u, t),
                "served_advance_ms": lambda: served.advance(u, t0, forcing),
                "live_fused_rhs_route_steps_ms": lambda: integrate.integrate(
                    model.rhs_fn(params, forcing), u, dt, steps, steps, t0=t0),
            }
            times = {key: time_ms(fn, samples=LONG_SAMPLES) for key, fn in timed.items()}
        log(f"    times at B={ENSEMBLE} (CUDA events, host in the loop, median of "
            f"{LONG_SAMPLES}; {steps} steps for the advance rows): "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        out["exports"][name] = {
            "num_steps": steps, "bytes": sizes, "rhs_err": rhs_err, "plain_err": plain_err,
            "step_err": step_err, "check_err": exported["kernel_rel_err"],
            **{k: exported[k] for k in ("export_s", "save_s", "load_s")}, **times}
        del u, forcing, frozen, live, plain, bad, tf32, advanced, traj, served, faulty

    # Tracing is single-threaded host work, and the KS-8x advance of 16 steps
    # takes a minute or two on the card machine's CPU: that export runs in a
    # process of its own (the same CLI) while the Burgers-8x artifact is
    # exported and checked here and serves the ensemble and the evaluation.
    (side_name, side_steps), (name, steps) = SERVE_EXPORTS
    side = subprocess.Popen(
        [sys.executable, "-m", "pde_superresolution_torch.scripts.run_export",
         "--checkpoint_dir", side_name, "--output_dir", str(work / side_name),
         "--num_steps", str(side_steps)],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        exported = run_export.main(["--checkpoint_dir", name, "--output_dir", str(work / name),
                                    "--num_steps", str(steps)])
        check_artifact(name, steps, exported, exported.pop("served"))

        # -- run_ensemble --exported_dir, the Burgers-8x ensemble
        bpath = str(work / name)
        with open(Path(bpath) / "meta.json") as f:
            bdt = json.load(f)["stable_dt"]
        common = ["--num_trajectories", str(ENSEMBLE), "--warmup_time", str(WARMUP_TIME),
                  "--time_max", str((STEPS - 0.5) * bdt), "--num_saves", str(ENSEMBLE_SAVES),
                  "--seed", str(SEED)]
        runs = []
        for _ in range(2):  # the second run is warm
            zero_counts()
            runs.append(run_ensemble.main(["--exported_dir", bpath, *common]))
            torch.cuda.synchronize()
            if any(counts().values()):
                raise AssertionError(f"the served ensemble launched a kernel: {counts()}")
        served_run = runs[-1]
        zero_counts()
        live_run = run_ensemble.main(["--checkpoint_dir", "ckpt_burgers8", "--fused", "false",
                                      *common])
        torch.cuda.synchronize()
        if counts()["fused_rhs"] != 4 * STEPS:
            raise AssertionError(f"the live rhs_fn route's launches: {counts()}")
        if not (served_run["path"] == "frozen artifact, rhs_fn steps"
                and served_run["num_steps"] == STEPS and served_run["finite"] == ENSEMBLE
                and torch.equal(served_run["initial"], live_run["initial"])):
            raise AssertionError(f"served ensemble: {served_run['path']}, "
                                 f"{served_run['num_steps']} steps, {served_run['finite']} finite")
        ens_err = check("--exported_dir ensemble vs the live rhs_fn route, final state",
                        served_run["final"], live_run["final"], SERVE_ENSEMBLE_TOL)
        log(f"    --exported_dir ensemble, {ENSEMBLE} x {STEPS} steps: first run "
            f"{1e3 * runs[0]['elapsed_s']:.1f} ms, second {1e3 * served_run['elapsed_s']:.1f} ms "
            f"({served_run['traj_steps_per_s']:,.0f} traj-steps/s); the live rhs_fn route in "
            f"this run {1e3 * live_run['elapsed_s']:.1f} ms ({live_run['traj_steps_per_s']:,.0f}"
            f" traj-steps/s); PERF.md section 5, same card: fused 65.5-65.9 ms, rhs_fn 1625-1632 ms")
        out["ensemble"] = {"first_ms": 1e3 * runs[0]["elapsed_s"],
                           "ms": 1e3 * served_run["elapsed_s"],
                           "traj_steps_per_s": served_run["traj_steps_per_s"],
                           "live_rhs_fn_ms": 1e3 * live_run["elapsed_s"], "err": ens_err}

        # -- run_evaluation --exported_dir at the Burgers-8x protocol, key 0
        flags = ["--num_samples", str(EVAL_MEMBERS), "--time_delta", str(EVAL_DELTA),
                 "--time_max", str(BURGERS_HORIZON), "--seed", "0", "--reference_cache_dir", "",
                 "--output_path", str(work / "unused.h5")]
        parser = run_evaluation.build_parser()
        zero_counts()
        start = time.perf_counter()
        served_eval = run_evaluation.evaluate_checkpoint(
            parser.parse_args(["--exported_dir", bpath, *flags]))
        torch.cuda.synchronize()
        served_eval_s = time.perf_counter() - start
        if any(counts().values()):
            raise AssertionError(f"the served evaluation launched a kernel: {counts()}")
        start = time.perf_counter()
        live_eval = run_evaluation.evaluate_checkpoint(
            parser.parse_args(["--checkpoint_dir", "ckpt_burgers8", *flags]))
        torch.cuda.synchronize()
        live_eval_s = time.perf_counter() - start
        got, want = served_eval["results"][0], live_eval["results"][0]
        if not (torch.equal(got.exact, want.exact)
                and all(torch.equal(got.trajectories[s], want.trajectories[s])
                        for s in ("baseline", "weno"))):
            raise AssertionError("the served evaluation's exact or classic legs differ")
        scale = float(want.exact.abs().max())
        eval_err = float((got.trajectories["model"] - want.trajectories["model"]).abs().max())
        flips = int((got.survival_time["model"] != want.survival_time["model"]).sum())
        log(f"    run_evaluation --exported_dir, {EVAL_MEMBERS} members, horizon "
            f"{BURGERS_HORIZON}: {served_eval_s:.2f} s (the live checkpoint's "
            f"{live_eval_s:.2f} s); model trajectories vs the live fused_rhs route: rel "
            f"{eval_err / scale:.3e} of max|exact| (tolerance {SERVE_EVAL_TOL:.0e}); survival "
            f"flips {flips}; served {json.dumps(served_eval['per_key'][0]['model'])}, live "
            f"{json.dumps(live_eval['per_key'][0]['model'])}")
        def survival(evaluation):  # the printed statistics but the MAE
            return {scheme: {k: v for k, v in stats.items() if not k.startswith("mae_")}
                    for scheme, stats in evaluation["per_key"][0].items()}

        if eval_err / scale > SERVE_EVAL_TOL or flips or survival(served_eval) != survival(
                live_eval):
            raise AssertionError(f"served evaluation: {eval_err / scale}, {flips} flips, "
                                 f"{served_eval['per_key']} against {live_eval['per_key']}")
        out["evaluation"] = {"served_s": served_eval_s, "live_s": live_eval_s,
                             "err": eval_err / scale, "flips": flips}
        del served_eval, live_eval, got, want

        # -- the KS-8x artifact, exported meanwhile in its own process
        text, _ = side.communicate(timeout=900)
        lines = [line for line in text.splitlines() if line.startswith("{")]
        if side.returncode or not lines:
            raise AssertionError(f"run_export {side_name} in its own process: exit code "
                                 f"{side.returncode}\n{text[-4000:]}")
        start = time.perf_counter()
        served = export.load_served_model(str(work / side_name))
        log(f"  {side_name}: exported by run_export in its own process; loaded here on cuda "
            f"in {time.perf_counter() - start:.2f} s")
        check_artifact(side_name, side_steps, json.loads(lines[-1]), served)
        del served

        # -- run_ensemble --output_path: the resumable route, cut at half
        try:
            import h5py
        except ImportError:
            h5py = None
            log("    HDF5 leg skipped: h5py is not installed on this machine (an optional "
                "dependency of both packages; run_ensemble --output_path needs it)")
        out["resumable_launches"] = 0
        if h5py is not None:
            zero_counts()
            full = run_ensemble.main(["--checkpoint_dir", "ckpt_burgers8", "--output_path",
                                      str(work / "full.h5"), *common])
            torch.cuda.synchronize()
            out["resumable_launches"] = counts()["fused_rhs"]
            real_flush, flushes = h5py.File.flush, []

            def flush(self):
                real_flush(self)
                flushes.append(1)
                if len(flushes) == ENSEMBLE_SAVES // 2:
                    raise _Cut

            h5py.File.flush = flush
            try:
                run_ensemble.main(["--checkpoint_dir", "ckpt_burgers8", "--output_path",
                                   str(work / "cut.h5"), *common])
                raise AssertionError("the cut run was not cut")
            except _Cut:
                pass
            finally:
                h5py.File.flush = real_flush
            resumed = run_ensemble.main(["--checkpoint_dir", "ckpt_burgers8", "--output_path",
                                         str(work / "cut.h5"), *common])
            with h5py.File(work / "full.h5", "r") as a, h5py.File(work / "cut.h5", "r") as b:
                same_store = np.array_equal(a["u"][...], b["u"][...])
            log(f"    run_ensemble --output_path: {full['path']}, {1e3 * full['elapsed_s']:.1f} "
                f"ms, fused_rhs launches {out['resumable_launches']} (predicted {4 * STEPS}); "
                f"cut after {ENSEMBLE_SAVES // 2} saves and resumed in "
                f"{1e3 * resumed['elapsed_s']:.1f} ms; resumed equal to uninterrupted: "
                f"{torch.equal(resumed['final'], full['final']) and same_store}; equal to the "
                f"live rhs_fn route: {torch.equal(full['final'], live_run['final'])}")
            if not (out["resumable_launches"] == 4 * STEPS and same_store
                    and full["path"] == "resumable rhs_fn steps"
                    and torch.equal(resumed["final"], full["final"])
                    and torch.equal(full["final"], live_run["final"])):
                raise AssertionError("the resumable route")
    finally:
        if side.poll() is None:
            side.kill()
            side.communicate()
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - phase_start
    log(f"    phase 15 took {out['phase_s']:.1f} s")
    return out


def parallel_phase(card: str, ens: dict, burgers_dt: float, ks_dt: float) -> dict:
    """Phase 16: the parallel layer on the card, at world size 1 over NCCL.
    ``ens`` holds phase 9's ensemble results (its warmed-up states and final
    states, from the same seed). Returns the launch counts and readings the
    report needs."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from pde_superresolution_torch import convert, integrate, parallel
    from pde_superresolution_torch.grids import Grid
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.parallel import halo as halo_lib
    from pde_superresolution_torch.scripts import run_ensemble, run_training
    from pde_superresolution_torch.training import data as data_lib
    from pde_superresolution_torch.training import loop
    from pde_superresolution_torch.training.config import TrainingConfig

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    kernels = (fk.fused_rhs, fk.fused_learned_rk4, fk.fused_rk4)

    def zero_counts():
        for kernel in kernels:
            kernel.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {kernel.__name__: kernel.launches for kernel in kernels}

    out = {}
    parallel.initialize_multihost()  # cuda: NCCL; no launcher: world size 1
    try:
        mesh = parallel.make_mesh()
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log(f"[16] parallelism: backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, mesh {shape}; on {card}")
        if dist.get_backend() != "nccl" or shape != {"data": 1, "space": 1}:
            raise AssertionError(f"process group {dist.get_backend()}, mesh {shape}")

        # -- fused_rk4_fn(mesh=): the same kernel on the same batch, limit 0
        model, params, stored = convert.load_asset("ckpt_ks8", device=device)
        eq, grid = model.equation, model.grid
        warmed = ens["ks_fused"]["initial"]
        want = model.fused_rk4_fn(params, ks_dt, STEPS)(warmed)
        zero_counts()
        got = model.fused_rk4_fn(params, ks_dt, STEPS, mesh=mesh)(warmed)
        out["ks_mesh_launches"] = counts()["fused_learned_rk4"]
        check(f"ckpt_ks8 fused_rk4_fn(mesh=) B={ENSEMBLE}, {STEPS} steps vs meshless", got,
              want, 0.0)
        args = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", str(ENSEMBLE),
                "--warmup_time", str(WARMUP_TIME), "--time_max", str((STEPS - 0.5) * burgers_dt),
                "--num_saves", str(ENSEMBLE_SAVES), "--seed", str(SEED)]
        members = run_ensemble.setup(run_ensemble.build_parser().parse_args(args))
        bstart, bt0 = ens["burgers_fused"]["initial"], ens["burgers_fused"]["t0"]
        want = members.model.fused_rk4_fn(members.params, burgers_dt, STEPS,
                                          forcing=members.forcing, t0=bt0)(bstart)
        zero_counts()
        got = members.model.fused_rk4_fn(members.params, burgers_dt, STEPS,
                                         forcing=members.forcing, t0=bt0, mesh=mesh)(bstart)
        out["forced_mesh_launches"] = counts()["fused_learned_rk4"]
        check(f"ckpt_burgers8 forced fused_rk4_fn(mesh=) from t0={bt0:.4f}, B={ENSEMBLE}, "
              f"{STEPS} steps vs meshless", got, want, 0.0)
        log(f"    launches: ks8 {out['ks_mesh_launches']}, burgers8 {out['forced_mesh_launches']}")
        if out["ks_mesh_launches"] != 1 or out["forced_mesh_launches"] != 1:
            raise AssertionError("fused_rk4_fn(mesh=) did not launch its kernel once")
        del members

        # -- run_ensemble --data_parallel 1, both routes, against phase 9's runs
        for route, key, kernel, launches in (("true", "burgers_fused", "fused_learned_rk4",
                                              ENSEMBLE_SAVES),
                                             ("false", "burgers_rhs", "fused_rhs", 4 * STEPS)):
            zero_counts()
            result = run_ensemble.main(args + ["--fused", route, "--data_parallel", "1"])
            seen = counts()
            out[f"ensemble_{route}_launches"] = seen[kernel]
            out[f"ensemble_{route}_s"] = result["elapsed_s"]
            out[f"ensemble_{route}_rate"] = result["traj_steps_per_s"]
            log(f"    launches: {seen} (predicted {launches} {kernel}); {result['path']}; "
                f"{1e3 * result['elapsed_s']:.1f} ms, {result['traj_steps_per_s']:,.0f} "
                f"traj-steps/s (phase 9: {1e3 * ens[key]['elapsed_s']:.1f} ms)")
            check(f"burgers8 ensemble --fused {route} --data_parallel 1 vs phase 9", result["final"],
                  ens[key]["final"], 0.0)
            if seen[kernel] != launches or not result["path"].endswith(", dp=1"):
                raise AssertionError(f"--data_parallel 1 --fused {route}: {seen}, {result['path']}")

        # -- the sharded RHS at KS-8x full width, against both rhs_fn routes
        sharded = parallel.sharded_model_rhs(model, params, mesh)
        plain = model.rhs_fn(params, use_kernel=False)
        kernel_route = model.rhs_fn(params, use_kernel=True)
        base_sharded = parallel.sharded_baseline_rhs(eq, grid, mesh)
        base = integrate.PolynomialDifferentiator(eq, grid, device=device).rhs_fn()
        with torch.no_grad():
            got, want_plain, want_kernel = (f(warmed, 0.0) for f in (sharded, plain, kernel_route))
            out["sharded_plain_err"] = relative_error(got, want_plain, False)
            check(f"ckpt_ks8 sharded_model_rhs B={ENSEMBLE} vs plain rhs_fn", got, want_plain,
                  SHARDED_PLAIN_TOL)
            out["sharded_kernel_err"] = relative_error(got, want_kernel, False)
            check(f"ckpt_ks8 sharded_model_rhs B={ENSEMBLE} vs the fused_rhs route", got,
                  want_kernel, 1e-4)
            base_want = base(warmed, 0.0)
            out["sharded_base_err"] = relative_error(base_sharded(warmed, 0.0), base_want, False)
            check(f"sharded_baseline_rhs B={ENSEMBLE} vs PolynomialDifferentiator.rhs_fn",
                  base_sharded(warmed, 0.0), base_want, SHARDED_BASE_TOL)
            real_exchange = halo_lib.halo_exchange
            halo_lib.halo_exchange = lambda u, h, mesh: torch.cat([u[..., :h], u, u[..., -h:]], -1)
            try:
                swapped = sharded(warmed, 0.0)
            finally:
                halo_lib.halo_exchange = real_exchange
            check_catches("the halo's edges swapped", swapped, want_plain, SHARDED_PLAIN_TOL)
            for name, fn in (("sharded_model_rhs", sharded), ("rhs_fn plain", plain),
                             ("rhs_fn fused_rhs", kernel_route)):
                out[f"{name} ms"] = time_ms(lambda: fn(warmed, 0.0), samples=LONG_SAMPLES)
        log(f"    ms per RHS at B={ENSEMBLE} (CUDA events, host included, median of "
            f"{LONG_SAMPLES}): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()
                                               if k.endswith(" ms")))

        # -- training: train(mesh=) against train(), then the CLI
        config = TrainingConfig.from_json(json.dumps(stored))
        short = dataclasses.replace(
            config, learning_rates=config.learning_rates[:1],
            learning_stops=(PARALLEL_TRAIN_STEPS,), eval_interval=PARALLEL_TRAIN_STEPS,
            checkpoint_interval=PARALLEL_TRAIN_STEPS)
        fine = Grid(config.fine_size, eq.period)
        start = time.perf_counter()
        snaps = data_lib.generate_snapshots(
            eq, fine, torch.Generator().manual_seed(config.data_seed), config.num_trajectories,
            config.num_times, config.time_delta, warmup_time=config.warmup_time,
            ic_scale=config.ic_scale, device=device)
        data = data_lib.build_training_data(eq, fine, snaps, config.resample_factor,
                                            config.num_time_steps)
        del snaps
        torch.cuda.synchronize()
        data_s = time.perf_counter() - start
        trained_model = loop._model_for(short, device)[2]  # the model train() builds
        rhs_per_step = 4 * loop._substeps(short, trained_model) * config.num_time_steps
        want_launches = (2 * PARALLEL_TRAIN_STEPS + 1) * rhs_per_step
        runs = {}
        for name, kwargs, deterministic in (("mesh", {"mesh": mesh}, True),
                                            ("single", {}, True), ("again", {}, False)):
            zero_counts()
            start = time.perf_counter()
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                _, trained, metrics = loop.train(short, dataset=data, device=device,
                                                 use_kernel=True, **kwargs)
            finally:
                torch.use_deterministic_algorithms(False)
            seen = counts()
            runs[name] = (trained, metrics, time.perf_counter() - start, seen["fused_rhs"])
        out["train_launches"] = runs["mesh"][3]
        out["train_err"] = max(leaf_errors(runs["mesh"][0], runs["single"][0]).values())
        out["train_rerun_spread"] = max(leaf_errors(runs["again"][0], runs["single"][0]).values())
        log(f"    train(mesh=) and train(), KS-8x recipe cut to {PARALLEL_TRAIN_STEPS} steps, "
            f"kernel route, deterministic algorithms (data {data_s:.2f} s): {runs['mesh'][2]:.2f} s / "
            f"{runs['single'][2]:.2f} s; fused_rhs launches {runs['mesh'][3]} / "
            f"{runs['single'][3]} (predicted {want_launches}); eval_total "
            f"{runs['mesh'][1]['eval_total']:.6g} / {runs['single'][1]['eval_total']:.6g}; "
            f"worst leaf {out['train_err']:.3e} (tolerance {PARALLEL_TRAIN_TOL:.0e}); train() "
            f"again with the default algorithms ({runs['again'][2]:.2f} s): worst leaf "
            f"{out['train_rerun_spread']:.3e} from the first (no limit)")
        if not (out["train_err"] <= PARALLEL_TRAIN_TOL and runs["mesh"][3] == want_launches
                and np.isfinite(runs["mesh"][1]["eval_total"])):
            raise AssertionError("train(mesh=) against train()")
        del data, runs
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
        try:
            hparams = ",".join([
                f"equation={config.equation}", f"conservative={config.conservative}",
                f"resample_factor={config.resample_factor}", f"fine_size={config.fine_size}",
                f"num_trajectories={config.num_trajectories}", f"num_times={config.num_times}",
                f"time_delta={config.time_delta}", f"warmup_time={config.warmup_time}",
                f"ic_scale={config.ic_scale}", f"num_time_steps={config.num_time_steps}",
                f"batch_size={config.batch_size}", f"frac_training={config.frac_training}",
                f"num_layers={config.model.num_layers}", f"filters={config.model.filters}",
                f"kernel_size={config.model.kernel_size}",
                f"stencil_size={config.model.stencil_size}",
                f"learning_rates={config.learning_rates[0]}",
                f"learning_stops={PARALLEL_TRAIN_STEPS}",
                f"eval_interval={PARALLEL_TRAIN_STEPS}",
                f"checkpoint_interval={PARALLEL_TRAIN_STEPS}"])
            start = time.perf_counter()
            metrics = run_training.main(["--checkpoint_dir", str(work / "ckpt"), "--hparams",
                                         hparams, "--data_parallel", "1"])
            cli_s = time.perf_counter() - start
            zero_counts()
            served = run_ensemble.main([
                "--checkpoint_dir", str(work / "ckpt"), "--num_trajectories", str(ENSEMBLE),
                "--warmup_time", str(WARMUP_TIME),
                "--time_max", str((STEPS - 0.5) * trained_model.stable_time_step(u_scale=3.0)),
                "--num_saves", str(ENSEMBLE_SAVES), "--seed", str(SEED), "--fused", "true",
                "--data_parallel", "1"])
            out["trained_served_launches"] = counts()["fused_learned_rk4"]
            log(f"    run_training --data_parallel 1, {PARALLEL_TRAIN_STEPS} steps: {cli_s:.2f} s, "
                f"eval_total {metrics['eval_total']:.6g}, checkpoints "
                f"{loop.checkpoint_steps(str(work / 'ckpt'))}; run_ensemble --data_parallel 1 "
                f"on it: {served['path']}, {served['finite']}/{ENSEMBLE} finite, "
                f"fused_learned_rk4 launches {out['trained_served_launches']}")
            if not (np.isfinite(metrics["eval_total"])
                    and loop.checkpoint_steps(str(work / "ckpt")) == [PARALLEL_TRAIN_STEPS]
                    and served["finite"] == ENSEMBLE and served["num_steps"] == STEPS
                    and out["trained_served_launches"] == ENSEMBLE_SAVES):
                raise AssertionError("run_training --data_parallel 1 and its ensemble")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - phase_start
    log(f"    phase 16 took {out['phase_s']:.1f} s")
    return out


def _numbers(tree, path: str = ""):
    """(path, number) of every int or float in a JSON-like tree (bools and
    the train leg's echo of its overrides excluded)."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _numbers(value, f"{path}.{key}")
    elif isinstance(tree, list):
        for i, value in enumerate(tree):
            yield from _numbers(value, f"{path}[{i}]")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


def bench_phase(card: str) -> dict:
    """Phase 17: the port's bench (``pde_superresolution_torch.bench``) at
    reduced samples, ``utils.profiling.trace`` of a fused and an ``rhs_fn``
    block, and ``utils.debugging`` (``checked`` on the three kernel routes,
    ``debug_nans`` on an RK4 step and its backward), each with a planted
    fault that must be caught. Returns the launch counts and the bench's
    line."""
    import math
    import tempfile

    import torch

    from pde_superresolution_torch import bench, convert, integrate
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.utils import debugging, profiling

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    kernels = (fk.fused_rhs, fk.fused_learned_rk4, fk.fused_rk4)

    def zero_counts():
        for kernel in kernels:
            kernel.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {kernel.__name__: kernel.launches for kernel in kernels}

    log(f"[17] the port's bench ({BENCH_SAMPLES} blocks a card leg, {BENCH_CPU_SAMPLES} on the "
        f"CPU, train {BENCH_TRAIN_BLOCKS} x {BENCH_TRAIN_STEPS} steps a route), "
        f"profiling.trace, debugging; on {card}")
    out = {}
    # -- the bench, through its own functions
    zero_counts()
    result = bench.measure(device, samples=BENCH_SAMPLES, cpu_samples=BENCH_CPU_SAMPLES,
                           train_blocks=BENCH_TRAIN_BLOCKS, train_steps=BENCH_TRAIN_STEPS)
    out["launches"] = counts()
    out["bench"] = result
    log(json.dumps(result))
    detail = result["detail"]
    train = detail["train"]
    bad = [(k, v) for k, v in _numbers(result) if not (math.isfinite(v) and v >= 0)]
    bad += [(k, v) for k, v in _numbers({k: result[k] for k in ("value", "vs_baseline")})
            if not v > 0]
    for leg in ("rhs_fn", "fused", f"throughput_fused_b{bench.THROUGHPUT_BATCH}", "cpu"):
        bad += [(f"{leg}.{k}", v) for k, v in _numbers(
            {k: detail[leg][k] for k in ("median", "samples", "block_s")}) if not v > 0]
    for route in ("plain_route", "kernel_route"):
        bad += [(f"train.{route}.{k}", v) for k, v in _numbers(
            {k: train[route][k] for k in ("median", "samples")}) if not v > 0]
        share = train[route]["device_busy_share"]
        if not 0 < share <= 1:
            bad.append((f"train.{route}.device_busy_share", share))
    rhs_per_step = 2 * 4 * train["substeps"] * train["unroll"]  # forward + rematerialized
    want = {"rhs_fn": {"fused_rhs": 4.0 * bench.INNER_STEPS},
            "fused": {"fused_learned_rk4": 1.0},
            f"throughput_fused_b{bench.THROUGHPUT_BATCH}": {"fused_learned_rk4": 1.0},
            "cpu": {}}
    got = {leg: detail[leg]["launches_per_call"] for leg in want}
    want["train kernel route, per step"] = {"fused_rhs": float(rhs_per_step)}
    want["train plain route, per step"] = {}
    got["train kernel route, per step"] = train["kernel_route"]["launches_per_step"]
    got["train plain route, per step"] = train["plain_route"]["launches_per_step"]
    finite = [leg for leg in ("rhs_fn", "fused", f"throughput_fused_b{bench.THROUGHPUT_BATCH}",
                              "cpu") if not detail[leg]["finite"]]
    finite += [route for route in ("plain_route", "kernel_route") if not train[route]["finite"]]
    log(f"    launches per call {got} (predicted {want}); phase launches {out['launches']}; "
        f"non-finite legs {finite}; non-positive or non-finite numbers {bad}")
    if bad or got != want or finite:
        raise AssertionError("the bench's legs")

    # -- profiling.trace sees the kernels launched through ctypes
    traced = {}
    for route in ("fused", "rhs_fn"):
        fn, u = bench.build(fused=route == "fused", device=device)
        u = fn(u)
        torch.cuda.synchronize()
        repeats = detail[route]["repeats_per_block"]
        with tempfile.TemporaryDirectory() as logdir:
            start = time.perf_counter()
            with profiling.trace(logdir):
                for _ in range(repeats):
                    u = fn(u)
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - start
            files = [n for n in os.listdir(logdir) if n.endswith(".pt.trace.json")]
            events = bench.device_events(logdir)
        names = {}
        for name, _, _ in events:
            names[name] = names.get(name, 0) + 1
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        kernel = {"fused": "fused_learned_rk4", "rhs_fn": "fused_rhs"}[route]
        traced[route] = {
            "files": len(files), "wall_s": wall_s, "device_events": len(events),
            kernel: sum(n for name, n in names.items() if kernel in name),
            "convolutions": sum(n for name, n in names.items()
                                if any(w in name.lower() for w in CONV_KERNEL_WORDS)),
        }
        log(f"    trace of one {route} block ({repeats} calls): {json.dumps(traced[route])}; "
            f"most frequent {top}")
    if not (traced["fused"]["files"] == traced["rhs_fn"]["files"] == 1
            and traced["fused"]["fused_learned_rk4"] > 0 and traced["rhs_fn"]["fused_rhs"] > 0
            and traced["rhs_fn"]["convolutions"] > 0):
        raise AssertionError(f"the traces lack the port's kernels: {traced}")
    out["traced"] = traced

    # -- debugging.checked on the three kernel routes: bit for bit when clean,
    # a planted NaN caught (by the kernel that first outputs it, where the
    # route starts with one)
    model, params, _ = convert.load_asset("ckpt_ks8", device=device)
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    fused_fn, u0 = bench.build(fused=True, device=device, params=params)
    routes = {
        "fused": (fused_fn, "fused_learned_rk4"),
        "rhs_fn": (bench.build(device=device, params=params)[0], None),
        "baseline fused_rk4": (fk.make_fused_rk4(model.equation, model.grid, dt, STEPS),
                               "fused_rk4"),
    }
    poisoned = u0.clone()
    poisoned[3, 17] = float("nan")
    zero_counts()
    checked = {}
    for label, (fn, kernel) in routes.items():
        want_u = fn(u0)
        start = time.perf_counter()
        got_u = debugging.checked(fn)(u0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        try:
            debugging.checked(fn)(poisoned)
            caught = None
        except FloatingPointError as e:
            caught = str(e)
        checked[label] = {"bit_equal": torch.equal(got_u, want_u), "checked_s": seconds,
                          "planted_nan": caught}
        log(f"    checked {label}: bit for bit the unchecked call {checked[label]['bit_equal']} "
            f"({seconds:.3f} s checked); NaN planted in u0: {caught or 'NOT CAUGHT'}")
        named = caught is not None and (kernel is None or caught.endswith(f": {kernel}."))
        if not (checked[label]["bit_equal"] and named):
            raise AssertionError(f"checked on the {label} route: {checked[label]}")
    out["checked_launches"] = counts()
    coeffs = model.coefficients(params, u0)  # clean coefficients, a NaN in u only
    try:
        debugging.checked(fk.fused_rhs)(poisoned, coeffs, None, model.equation, model.grid,
                                        model.taps)
        caught = None
    except FloatingPointError as e:
        caught = str(e)
    log(f"    checked fused_rhs (clean coefficients, NaN in u): {caught or 'NOT CAUGHT'}")
    if caught != "nan generated by primitive: fused_rhs.":
        raise AssertionError(f"checked fused_rhs: {caught}")
    out["checked"] = checked

    # -- the wrappers' hook with no check in force: its host cost per launch
    nan = torch.full((1,), float("nan"), device=device)
    calls = 100_000
    start = time.perf_counter()
    for _ in range(calls):
        debugging.check_output("fused_rhs", nan)
    out["hook_inactive_us"] = 1e6 * (time.perf_counter() - start) / calls
    log(f"    debugging.check_output with no check in force: {out['hook_inactive_us']:.4f} us "
        f"per call (host)")

    # -- debug_nans around one rhs_fn RK4 step and its backward (autograd's
    # device thread runs the backward)
    rhs = model.rhs_fn(params)
    t0 = torch.zeros((), device=device)
    outcomes = {}
    for label, state, cotangent in (("clean step", u0, None), ("NaN in u", poisoned, None),
                                    ("clean backward", u0, torch.ones_like(u0)),
                                    ("NaN cotangent", u0, torch.full_like(u0, float("nan")))):
        leaves = {k: v.detach().requires_grad_(cotangent is not None) for k, v in params.items()}
        step_rhs = model.rhs_fn(leaves) if cotangent is not None else rhs
        try:
            with debugging.debug_nans():
                stepped = integrate.rk4_step(step_rhs, state, t0, dt)
                if cotangent is not None:
                    stepped.backward(cotangent)
                torch.cuda.synchronize()
            outcomes[label] = None
        except FloatingPointError as e:
            outcomes[label] = str(e)
    log(f"    debug_nans: {json.dumps(outcomes)}")
    if (outcomes["clean step"] or outcomes["clean backward"] or not outcomes["NaN in u"]
            or not outcomes["NaN cotangent"]):
        raise AssertionError(f"debug_nans: {outcomes}")
    out["debug_nans"] = outcomes
    out["phase_s"] = time.perf_counter() - phase_start
    log(f"    phase 17 took {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from pde_superresolution_torch import convert, equations, integrate
    from pde_superresolution_torch.ops import _build
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.scripts import run_ensemble

    device = torch.device("cuda")
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------------
    start = time.perf_counter()
    build = _build.build()
    _build.load_library()
    log(f"[2] kernels built in {time.perf_counter() - start:.1f} s "
        f"(nvcc {build.seconds:.1f} s) -> {build.library.name}")
    for source, text in sorted(build.logs.items()):
        report = dict.fromkeys(  # unique lines, in order
            line.strip() for line in text.splitlines()
            if "Used " in line or "spill" in line)
        for line in report:
            log(f"    {source}: {line}")
    check_stencil_builds(build)

    model, params, config = convert.load_asset("ckpt_ks8", device=device)
    eq, grid = model.equation, model.grid
    dt = eq.stable_time_step(grid, u_scale=3.0)
    gen = torch.Generator().manual_seed(SEED)
    u0 = eq.initial_conditions(gen, grid, (BATCH,), device)
    log(f"    model: ckpt_ks8 ({config['equation']} conservative={eq.conservative}, "
        f"nx={grid.size}, {model.config.num_layers}x{model.config.filters} tower, "
        f"stencil {model.config.stencil_size}), dt={dt}, B={BATCH}")

    # ---- 3. fused_rhs against its plain version -----------------------------
    # float32 on both sides, tap sums in other orders and with FMAs, then a
    # face difference over dx that cancels most of the sum: 1e-4 of max|u_t|
    rhs_tol = 1e-4
    log("[3] fused_rhs vs plain")
    coeffs = model.coefficients(params, u0)
    rhs_args = (eq, grid, model.taps)
    rhs_err = check(f"flagship B={BATCH} nx={grid.size}", fk.fused_rhs(u0, coeffs, None, *rhs_args),
                    fk.fused_rhs_plain(u0, coeffs, None, *rhs_args), rhs_tol)
    u_wide = eq.initial_conditions(torch.Generator().manual_seed(SEED + 2), grid,
                                   (THROUGHPUT_BATCH,), device)
    c_wide = model.coefficients(params, u_wide)
    rhs_err = max(rhs_err, check(
        f"flagship B={THROUGHPUT_BATCH} nx={grid.size}", fk.fused_rhs(u_wide, c_wide, None, *rhs_args),
        fk.fused_rhs_plain(u_wide, c_wide, None, *rhs_args), rhs_tol))
    del u_wide, c_wide
    for name, cons, size in [("burgers", True, 6), ("burgers", False, 5),
                             ("kdv", True, 6), ("kdv", False, 7),
                             ("ks", True, 6), ("ks", False, 7)]:
        m, p, u = perturbed_model(name, cons, size, device, nx=96)
        c = m.coefficients(p, u)
        f = torch.randn(u.shape, generator=gen).to(device) if m.equation.forced else None
        a = (m.equation, m.grid, m.taps)
        form = f"{name} {'conservative' if cons else 'direct'}"
        rhs_err = max(rhs_err, check(f"{form} B=3 nx=96{' forced' if f is not None else ''}",
                                     fk.fused_rhs(u, c, f, *a),
                                     fk.fused_rhs_plain(u, c, f, *a), rhs_tol))
    # nx=1024: each trajectory split into segments, each computing the face
    # left of it. dx is 8x smaller and the dx^-3 terms cancel: the plain
    # version itself is up to 1e-1 of max|u_t| away from float64 sums of the
    # same inputs, so the kernel is held to no more than twice its distance
    for name, cons, size in [("ks", True, 6), ("kdv", False, 7)]:
        m, p, u = perturbed_model(name, cons, size, device, nx=1024, batch=5)
        c = m.coefficients(p, u)
        a = (m.equation, m.grid, m.taps)
        got, want = fk.fused_rhs(u, c, None, *a), fk.fused_rhs_plain(u, c, None, *a)
        exact = fk.fused_rhs_plain(u.double(), {d: v.double() for d, v in c.items()}, None, *a)
        kernel_err, plain_err = (relative_error(x.double(), exact, False) for x in (got, want))
        verdict = "ok" if kernel_err <= 2 * plain_err + 1e-6 else "FAIL"
        log(f"  {name} {'conservative' if cons else 'direct'} B=5 nx=1024 "
            f"({fk.rhs_launch(5, 1024, m.taps).parts} segments): from float64 sums, kernel "
            f"{kernel_err:.3e}, plain {plain_err:.3e} of max|u_t| (limit twice the plain) {verdict}")
        if verdict != "ok":
            raise AssertionError(f"fused_rhs at nx=1024: {kernel_err} > 2 x {plain_err}")

    # ---- 4. fused_learned_rk4 against its plain version ---------------------
    # Both round the tower's inputs to bf16 at the same places and sum in
    # float32 in other orders, which flips single bf16 roundings (see
    # STEP_TOL). One step from a standard-normal state, compared on the
    # increment u(dt) - u(0) in root mean square, relative to the plain
    # increment's max: the tower's output moves it at every point. The
    # tolerance must fail each planted fault.
    log("[4] fused_learned_rk4 vs plain")
    pack = fk.pack_learned_rk4(params, eq, grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)
    rng = np.random.default_rng(SEED)
    u_rough = torch.from_numpy(rng.standard_normal((BATCH, grid.size)).astype(np.float32)).to(device)
    want_inc = fk.fused_learned_rk4_plain(u_rough, pack, dt, 1) - u_rough
    got_inc = fk.fused_learned_rk4(u_rough, pack, dt, 1) - u_rough
    rk4_err = check(f"ckpt_ks8 one step from N(0,1), B={BATCH}, increment",
                    got_inc, want_inc, STEP_TOL, rms=True)
    # which of the two is nearer to sums without rounding: the plain version
    # with float64 weights, matmuls and state, rounding to bf16 at the same
    # places (no limit: it says whose the differences are)
    exact_inc = (learned_rk4_float64(u_rough, pack, dt, 1) - u_rough.double())
    for side, inc in (("kernel", got_inc), ("plain version", want_inc)):
        log(f"    {side} vs float64 sums, one step from N(0,1): rel rms "
            f"{relative_error(inc.double(), exact_inc, True):.3e}, rel max "
            f"{relative_error(inc.double(), exact_inc, False):.3e}; points off by more than "
            f"1e-6 of the max: "
            f"{int(((inc.double() - exact_inc).abs() > 1e-6 * exact_inc.abs().max()).sum())}"
            f" of {inc.numel()}")
    faults = planted_faults(params)
    fault_packs = {name: fk.pack_learned_rk4(p, eq, grid, model.config.kernel_size,
                                             model.constraint_layers, model.taps)
                   for name, p in faults.items()}
    for name, bad in fault_packs.items():
        check_catches(f"{name}, one step", fk.fused_learned_rk4(u_rough, bad, dt, 1) - u_rough,
                      want_inc, STEP_TOL, rms=True)
    # 100 steps from the smooth seeded state: 1e-5 of max|u|, 2.3x the largest
    # reading on an H100 (5.1e-7 for KS, 4.4e-6 for the seeded KdV model); the
    # planted faults read 9.3e-5 to 5.2e-4
    rk4_tol = 1e-5
    want = fk.fused_learned_rk4_plain(u0, pack, dt, STEPS)
    rk4_err = max(rk4_err, check(f"ckpt_ks8 {STEPS} steps B={BATCH}",
                                 fk.fused_learned_rk4(u0, pack, dt, STEPS), want, rk4_tol))
    for name, bad in fault_packs.items():
        check_catches(f"{name}, {STEPS} steps", fk.fused_learned_rk4(u0, bad, dt, STEPS),
                      want, rk4_tol)
    m, p, u = perturbed_model("kdv", True, 6, device, nx=128, batch=BATCH)
    kdv_pack = fk.pack_learned_rk4(p, m.equation, m.grid, m.config.kernel_size,
                                   m.constraint_layers, m.taps)
    kdv_dt = m.equation.stable_time_step(m.grid, u_scale=3.0)
    rk4_err = max(rk4_err, check(
        f"kdv conservative seeded {STEPS} steps B={BATCH}",
        fk.fused_learned_rk4(0.3 * u, kdv_pack, kdv_dt, STEPS),
        fk.fused_learned_rk4_plain(0.3 * u, kdv_pack, kdv_dt, STEPS), rk4_tol))

    # ---- 5. the main path -----------------------------------------------------
    log(f"[5] main path: {STEPS} RK4 steps at B={BATCH}")
    fk.fused_rhs.launches = 0
    fk.fused_learned_rk4.launches = 0
    _, traj_rhs = integrate.integrate(model.rhs_fn(params), u0, dt, STEPS)
    _, traj_fused = integrate.integrate_fused(
        model.fused_rk4_fn(params, dt, STEPS), u0, dt, STEPS, save_every=STEPS)
    torch.cuda.synchronize()
    launches = {"fused_rhs": fk.fused_rhs.launches,
                "fused_learned_rk4": fk.fused_learned_rk4.launches}
    log(f"    launches: {launches}")
    if launches != {"fused_rhs": 4 * STEPS, "fused_learned_rk4": 1}:
        raise AssertionError(f"the main path did not run through the kernels: {launches}")
    if traj_rhs.shape != (STEPS + 1, BATCH, grid.size) or traj_fused.shape != (2, BATCH, grid.size):
        raise AssertionError(f"shapes {traj_rhs.shape}, {traj_fused.shape}")
    # the fused route's tower is bf16-rounded, the rhs_fn route's float32;
    # from the smooth seeded state that moves u by 6.7e-7 of max|u| after
    # 100 steps on an H100: 1e-5. From a standard-normal state, one step,
    # ROUTE_STEP_TOL:
    check("integrate_fused vs integrate(rhs_fn)", traj_fused[-1], traj_rhs[-1], 1e-5)
    check("one step from N(0,1), increment, fused vs rhs_fn route",
          model.fused_rk4_fn(params, dt, 1)(u_rough) - u_rough,
          integrate.rk4_step(model.rhs_fn(params), u_rough, 0.0, dt) - u_rough, ROUTE_STEP_TOL)
    _, traj_plain = integrate.integrate(model.rhs_fn(params, use_kernel=False), u0, dt, STEPS)
    check("integrate(rhs_fn) kernel vs plain path", traj_rhs[-1], traj_plain[-1], 1e-4)
    ref_model, ref_params, _ = convert.load_asset("ckpt_ks8", device="cpu")
    small = u0[:8].double().cpu()
    _, ref = integrate.integrate(
        ref_model.rhs_fn({k: v.double() for k, v in ref_params.items()}, use_kernel=False),
        small, dt, 20)
    _, got = integrate.integrate(model.rhs_fn(params), u0[:8].contiguous(), dt, 20)
    check("card rhs_fn vs CPU float64, B=8, 20 steps", got[-1].cpu().double(), ref[-1], 1e-5)

    # ---- 6. times -------------------------------------------------------------
    log(f"[6] times (ms, median of {SAMPLES}) on {card}")
    tensor_cores = tensor_core_line(build.library)
    log(f"    {tensor_cores}")
    if "not read" not in tensor_cores and " 0 HMMA, 0 GMMA" in tensor_cores:
        raise AssertionError("a fused_learned_rk4 kernel holds no tensor-core instruction")
    # the floor under any kernel's time: an empty kernel's launch, queued
    lib = _build.load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    code = lib.pde_empty_kernel(stream)
    if code:
        raise RuntimeError(f"empty kernel launch failed: {_build.error_string(code)}")
    launch_floor_ms = time_ms(lambda: lib.pde_empty_kernel(stream), inner=100, queued=True)
    log(f"    launch floor (an empty kernel, queued): {1e3 * launch_floor_ms:.3f} us per launch")
    times = {}
    for batch in (BATCH, THROUGHPUT_BATCH):
        u = u0 if batch == BATCH else eq.initial_conditions(gen, grid, (batch,), device)
        c = model.coefficients(params, u)
        rhs_kernel = lambda: fk.fused_rhs(u, c, None, *rhs_args)
        rhs_plain = lambda: fk.fused_rhs_plain(u, c, None, *rhs_args)
        path_kernel = lambda: integrate.integrate(model.rhs_fn(params), u, dt, STEPS, STEPS)
        path_plain = lambda: integrate.integrate(
            model.rhs_fn(params, use_kernel=False), u, dt, STEPS, STEPS)
        rk4_kernel = lambda: fk.fused_learned_rk4(u, pack, dt, STEPS)
        rk4_plain = lambda: fk.fused_learned_rk4_plain(u, pack, dt, STEPS)
        # "_ms": the kernel's device time (queued); "_call_ms": a wrapper
        # call as a caller pays it, host dispatch included; plain versions
        # and routes: call time
        row = {
            "fused_rhs_ms": time_ms(rhs_kernel, inner=100, queued=True),
            "fused_rhs_call_ms": time_ms(rhs_kernel, inner=100),
            "fused_rhs_plain_ms": time_ms(rhs_plain, inner=10),
            "fused_rhs_bound_ms": rhs_bound_ms(u, c, None),
            "rhs_fn_route_100_steps_ms": time_ms(path_kernel),
            "plain_route_100_steps_ms": time_ms(path_plain),
            "fused_learned_rk4_ms": time_ms(rk4_kernel, queued=True),
            "fused_learned_rk4_call_ms": time_ms(rk4_kernel),
            "fused_learned_rk4_plain_ms": time_ms(rk4_plain),
            "fused_learned_rk4_bound_ms": learned_rk4_bound_ms(pack, batch, STEPS),
        }
        # where the rhs_fn route's time goes: device time by kernel name over
        # one 100-step call (torch.profiler), against the call's event time.
        # The profiler can drop kernel records, so the sum is a lower bound.
        # the route's device time: one RK4 step queued behind a device-side
        # sleep (no host in it; the card's own gaps between kernels count as
        # busy), times STEPS. Launches: one RHS, host side and device side.
        rhs = model.rhs_fn(params)
        t0 = torch.zeros((), device=device)
        row["rhs_fn_route_device_ms"] = STEPS * time_ms(
            lambda: integrate.rk4_step(rhs, u, t0, dt), queued=True)
        row["rhs_fn_route_idle_share"] = (
            1 - row["rhs_fn_route_device_ms"] / row["rhs_fn_route_100_steps_ms"])
        host_launches, device_kernels = launch_count(lambda: rhs(u, t0))
        row["rhs_fn_launches_per_rhs"] = host_launches
        row["rhs_fn_device_kernels_per_rhs"] = device_kernels
        path = device_profile(path_kernel, 1)
        row["rhs_fn_route_profiled_device_ms"] = sum(path.values()) / 1e3  # a lower bound
        row["rhs_fn_route_profiled_fused_rhs_ms"] = sum(
            t for k, t in path.items() if "fused_rhs_kernel" in k) / 1e3
        times[batch] = row
        log(f"    B={batch}: " + json.dumps(row))
        for name, us in sorted(path.items(), key=lambda kv: -kv[1])[:8]:
            log(f"      rhs_fn route kernel {us / 1e3:9.3f} ms  {name[:110]}")

    # ---- 7. forced fused_learned_rk4 against its plain version ----------------
    # Kernel and plain version take the same ForcingPack and rotate and sum
    # it with the same separately rounded operations in the same order, so
    # the forcing adds no difference of its own: the limits follow phase 4's
    # scheme (about 10x the largest reading on an H100, see FORCED_*_TOL), and
    # each must fail three planted faults: in the weights from the rough
    # state, in the forcing from the seeded state.
    log("[7] forced fused_learned_rk4 vs plain (ckpt_burgers8)")
    bmodel, bparams, _ = convert.load_asset("ckpt_burgers8", device=device)
    beq, bgrid = bmodel.equation, bmodel.grid
    bdt = bmodel.stable_time_step(u_scale=3.0)  # run_ensemble's model-aware step
    bgen = torch.Generator().manual_seed(SEED + 1)
    bu0 = beq.initial_conditions(bgen, bgrid, (BATCH,), device)
    bforcing = beq.sample_forcing(bgen, (BATCH,), device)
    bpack = fk.pack_learned_rk4(bparams, beq, bgrid, bmodel.config.kernel_size,
                                bmodel.constraint_layers, bmodel.taps)
    terms = bforcing.amplitude.shape[-1]
    log(f"    model: ckpt_burgers8 (conservative={beq.conservative}, nx={bgrid.size}, "
        f"stencil {bmodel.config.stencil_size}, {terms} forcing terms), dt={bdt}, "
        f"t0={FORCING_T0}; launches at B={BATCH} and {ENSEMBLE}: "
        f"{fk.learned_rk4_launch(bpack, bgrid.size, terms, BATCH)}, "
        f"{fk.learned_rk4_launch(bpack, bgrid.size, terms, ENSEMBLE)}")

    def repack(t, dt_scale):
        return fk.pack_forcing(bforcing, t, beq, bgrid, dt_scale * bdt, BATCH)

    fpack = repack(FORCING_T0, 1.0)
    faults = forcing_faults(bforcing, fpack, repack)
    want_inc = fk.fused_learned_rk4_plain(u_rough, bpack, bdt, 1, fpack) - u_rough
    forced_err = check(
        f"one step from N(0,1), B={BATCH}, increment",
        fk.fused_learned_rk4(u_rough, bpack, bdt, 1, forcing=bforcing, t=FORCING_T0) - u_rough,
        want_inc, FORCED_STEP_TOL, rms=True)
    # from the rough state the tower decides the increment and the forcing is
    # a small part of it (halving the rotation angle moves it by 2.9e-6 in
    # root mean square): this check is held to faults in the weights
    for name, bad in planted_faults(bparams).items():
        bad_pack = fk.pack_learned_rk4(bad, beq, bgrid, bmodel.config.kernel_size,
                                       bmodel.constraint_layers, bmodel.taps)
        check_catches(f"{name}, one step from N(0,1)",
                      fk.fused_learned_rk4(u_rough, bad_pack, bdt, 1, forcing=fpack) - u_rough,
                      want_inc, FORCED_STEP_TOL, rms=True)
    # from the smooth seeded state the forcing is a large part of the
    # increment: this one is held to the faults in the forcing
    want_inc = fk.fused_learned_rk4_plain(bu0, bpack, bdt, 1, fpack) - bu0
    forced_err = max(forced_err, check(
        f"one step from the seeded state, B={BATCH}, increment",
        fk.fused_learned_rk4(bu0, bpack, bdt, 1, forcing=bforcing, t=FORCING_T0) - bu0,
        want_inc, FORCED_SMOOTH_STEP_TOL))
    for name, bad in faults.items():
        check_catches(f"{name}, one step from the seeded state",
                      fk.fused_learned_rk4(bu0, bpack, bdt, 1, forcing=bad) - bu0,
                      want_inc, FORCED_SMOOTH_STEP_TOL)
    interval = STEPS // ENSEMBLE_SAVES
    for steps, tol in ((interval, FORCED_INTERVAL_TOL), (STEPS, FORCED_RUN_TOL)):
        want = fk.fused_learned_rk4_plain(bu0, bpack, bdt, steps, fpack)
        forced_err = max(forced_err, check(
            f"{steps} steps B={BATCH}",
            fk.fused_learned_rk4(bu0, bpack, bdt, steps, forcing=bforcing, t=FORCING_T0),
            want, tol))
        for name, bad in faults.items():
            check_catches(f"{name}, {steps} steps",
                          fk.fused_learned_rk4(bu0, bpack, bdt, steps, forcing=bad), want, tol)
    # the ensemble's shapes: one save interval of the full batch
    eu0 = beq.initial_conditions(bgen, bgrid, (ENSEMBLE,), device)
    eforcing = beq.sample_forcing(bgen, (ENSEMBLE,), device)
    epack = fk.pack_forcing(eforcing, FORCING_T0, beq, bgrid, bdt, ENSEMBLE)
    forced_err = max(forced_err, check(
        f"{interval} steps B={ENSEMBLE}",
        fk.fused_learned_rk4(eu0, bpack, bdt, interval, forcing=epack),
        fk.fused_learned_rk4_plain(eu0, bpack, bdt, interval, epack), FORCED_ENSEMBLE_TOL))
    x32 = torch.as_tensor(bgrid.x, dtype=torch.float32, device=device)
    ef = equations.forcing_term(eforcing, x32, FORCING_T0, beq.period, bgrid.dx).contiguous()
    ecoeffs = bmodel.coefficients(bparams, eu0)
    brhs_args = (beq, bgrid, bmodel.taps)
    rhs_err = max(rhs_err, check(
        f"fused_rhs, forced Burgers form, B={ENSEMBLE} nx={bgrid.size}",
        fk.fused_rhs(eu0, ecoeffs, ef, *brhs_args),
        fk.fused_rhs_plain(eu0, ecoeffs, ef, *brhs_args), rhs_tol))
    # its 400 launches on the Burgers ensemble's rhs_fn route have this shape
    rhs_ensemble = {
        "ms": time_ms(lambda: fk.fused_rhs(eu0, ecoeffs, ef, *brhs_args), inner=100, queued=True),
        "plain_ms": time_ms(lambda: fk.fused_rhs_plain(eu0, ecoeffs, ef, *brhs_args), inner=10),
        "bound_ms": rhs_bound_ms(eu0, ecoeffs, ef),
    }
    log(f"    fused_rhs, forced Burgers form, B={ENSEMBLE}: {1e3 * rhs_ensemble['ms']:.3f} us "
        f"(plain version {rhs_ensemble['plain_ms']:.3f} ms; "
        f"bytes bound {1e3 * rhs_ensemble['bound_ms']:.3f} us, launch floor "
        f"{1e3 * launch_floor_ms:.3f} us); {fk.rhs_launch(ENSEMBLE, bgrid.size, bmodel.taps)}")
    del ecoeffs, ef, epack

    # ---- 8. fused_rk4 against its plain version --------------------------------
    # The same float32 operations in the same order, each rounded on its own
    # on both sides: 1e-6 of max|u| after 100 steps. Against integrate() with
    # the PolynomialDifferentiator's RHS, whose tap sums run in another
    # order: 1e-5.
    log("[8] fused_rk4 vs plain and vs integrate(PolynomialDifferentiator)")
    baseline_err = 0.0
    for name in ("ks", "kdv"):
        for cons in (True, False):
            for batch, nx in ((BATCH, 128), (3, 96), (5, 1024), (1037, 128)):
                period = equations.from_name(name).period * nx / 128  # the same dx
                e = equations.from_name(name, conservative=cons, period=period)
                g = type(grid)(nx, period)
                u = 0.3 * e.initial_conditions(gen, g, (batch,), device)
                step = e.stable_time_step(g)
                advance = fk.make_fused_rk4(e, g, step, STEPS)
                got = advance(u)
                form = f"{name} {'conservative' if cons else 'direct'} B={batch} nx={nx}"
                baseline_err = max(baseline_err, check(
                    f"{form}, {STEPS} steps", got, fk.fused_rk4_plain(u, advance.scheme), 1e-6))
                rhs = integrate.PolynomialDifferentiator(e, g, device=device).rhs_fn()
                _, ref = integrate.integrate(rhs, u, step, STEPS, STEPS)
                check(f"{form}, vs integrate", got, ref[-1], 1e-5)
    log(f"    fused_rk4 against its plain version, largest reading: {baseline_err:.3e}")

    # ---- 9. the ensemble path at full width ---------------------------------
    def ensemble(checkpoint, route, step):
        """One in-process run of the entry point, with the launch counts
        zeroed just before it and read just after."""
        fk.fused_rhs.launches = fk.fused_learned_rk4.launches = fk.fused_rk4.launches = 0
        result = run_ensemble.main([
            "--checkpoint_dir", checkpoint, "--num_trajectories", str(ENSEMBLE),
            "--warmup_time", str(WARMUP_TIME), "--time_max", str((STEPS - 0.5) * step),
            "--num_saves", str(ENSEMBLE_SAVES), "--seed", str(SEED), "--fused", route])
        torch.cuda.synchronize()
        counts = {"fused_rhs": fk.fused_rhs.launches,
                  "fused_learned_rk4": fk.fused_learned_rk4.launches}
        log(f"    launches: {counts}")
        if result["num_steps"] != STEPS or result["finite"] != ENSEMBLE:
            raise AssertionError(
                f"{checkpoint} {route}: {result['num_steps']} steps, "
                f"{result['finite']}/{ENSEMBLE} finite")
        if result["final"].shape != (ENSEMBLE, 128) or result["t0"] < WARMUP_TIME:
            raise AssertionError(f"shape {result['final'].shape}, t0 {result['t0']}")
        return result, counts

    log(f"[9] ensemble path: {ENSEMBLE} trajectories, warm-up {WARMUP_TIME}, {STEPS} RK4 "
        f"steps in {ENSEMBLE_SAVES} saves, through scripts.run_ensemble.main")
    ens = {}
    ens["burgers_fused"], counts = ensemble("ckpt_burgers8", "true", bdt)
    if counts != {"fused_rhs": 0, "fused_learned_rk4": ENSEMBLE_SAVES}:
        raise AssertionError(f"the fused route did not run through its kernel: {counts}")
    forced_launches = counts["fused_learned_rk4"]
    ens["burgers_rhs"], counts = ensemble("ckpt_burgers8", "false", bdt)
    if counts != {"fused_rhs": 4 * STEPS, "fused_learned_rk4": 0}:
        raise AssertionError(f"the rhs_fn route did not run through its kernel: {counts}")
    rhs_ensemble_launches = counts["fused_rhs"]
    # Same warmed-up states, same forcing. The fused route rounds the tower's
    # inputs to bf16 and carries the forcing's phase by rotation; the trained
    # Burgers model steepens fronts, where a small shift of a front is a
    # large difference at a point, so the maximum over 1.3 M points is held
    # to ROUTE_MAX_TOL of max|u| and the root mean square to ROUTE_RMS_TOL.
    a, b = ens["burgers_fused"]["final"], ens["burgers_rhs"]["final"]
    check("warmed-up start states equal", ens["burgers_fused"]["initial"],
          ens["burgers_rhs"]["initial"], 1e-6)
    route_err = check("Burgers ensemble, fused vs rhs_fn route, max", a, b, ROUTE_MAX_TOL)
    route_rms = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
    log(f"  Burgers ensemble, fused vs rhs_fn route, rms: rel {route_rms:.3e} "
        f"(tolerance {ROUTE_RMS_TOL:.1e})")
    if not route_rms <= ROUTE_RMS_TOL:
        raise AssertionError(f"routes differ by rms {route_rms} > {ROUTE_RMS_TOL}")
    ks_dt = model.stable_time_step(u_scale=3.0)
    ens["ks_fused"], counts = ensemble("ckpt_ks8", "true", ks_dt)
    if counts != {"fused_rhs": 0, "fused_learned_rk4": ENSEMBLE_SAVES}:
        raise AssertionError(f"the KS fused route did not run through its kernel: {counts}")
    unforced_ensemble_launches = counts["fused_learned_rk4"]
    # the unforced kernel at the ensemble's shapes, from the states the entry
    # point warmed up: one save interval (one launch of 10240 blocks) against
    # the plain version, and the entry point's own final state (10 launches)
    # against the plain version's 100 steps
    warmed = ens["ks_fused"]["initial"]
    rk4_err = max(rk4_err, check(
        f"ckpt_ks8 {interval} steps B={ENSEMBLE}",
        fk.fused_learned_rk4(warmed, pack, ks_dt, interval),
        fk.fused_learned_rk4_plain(warmed, pack, ks_dt, interval), UNFORCED_ENSEMBLE_TOL))
    rk4_err = max(rk4_err, check(
        f"ckpt_ks8 ensemble's final state, {STEPS} steps B={ENSEMBLE}",
        ens["ks_fused"]["final"],
        fk.fused_learned_rk4_plain(warmed, pack, ks_dt, STEPS), UNFORCED_ENSEMBLE_TOL))
    # the baseline leg: the fixed-stencil scheme from the same warmed-up
    # states, one fused_rk4 launch per save interval
    base_advance = fk.make_fused_rk4(eq, grid, ks_dt, interval)
    fk.fused_rk4.launches = 0
    start = time.perf_counter()
    _, base_traj = integrate.integrate_fused(
        lambda u, t: base_advance(u), warmed, ks_dt, STEPS, interval, t0=ens["ks_fused"]["t0"])
    torch.cuda.synchronize()
    base_elapsed = time.perf_counter() - start
    baseline_launches = fk.fused_rk4.launches
    log(f"    baseline leg: {baseline_launches} fused_rk4 launches, {base_elapsed:.3f} s")
    if baseline_launches != ENSEMBLE_SAVES or base_traj.shape != (ENSEMBLE_SAVES + 1, ENSEMBLE, 128):
        raise AssertionError(f"baseline leg: {baseline_launches} launches, {base_traj.shape}")
    whole = fk.make_fused_rk4(eq, grid, ks_dt, STEPS)
    baseline_err = max(baseline_err, check(
        f"baseline leg B={ENSEMBLE}, {STEPS} steps vs plain", base_traj[-1],
        fk.fused_rk4_plain(warmed, whole.scheme), 1e-6))
    gap = float((ens["ks_fused"]["final"] - base_traj[-1]).abs().max() / base_traj[-1].abs().max())
    log(f"    learned against baseline scheme after the same steps: {gap:.3e} of max|u| "
        "(two schemes, no limit)")

    # ---- 10. times of the new kernels -----------------------------------------
    log(f"[10] times (ms per {STEPS} steps, CUDA events, device time queued) on {card}")
    new_times = {}
    for batch in (BATCH, THROUGHPUT_BATCH, ENSEMBLE):
        samples = SAMPLES if batch == BATCH else LONG_SAMPLES
        u = eu0[:batch].contiguous()
        fp = fk.pack_forcing(
            type(eforcing)(*(leaf[:batch].contiguous() for leaf in eforcing)),
            FORCING_T0, beq, bgrid, bdt, batch)
        ks_u = warmed[:batch].contiguous()
        base = fk.make_fused_rk4(eq, grid, ks_dt, STEPS)
        bytes_ms, ops_ms = baseline_rk4_bounds_ms(base.scheme, batch)
        row = {
            "forced_rk4_ms": time_ms(
                lambda: fk.fused_learned_rk4(u, bpack, bdt, STEPS, forcing=fp),
                queued=True, samples=samples),
            "forced_rk4_with_pack_ms": time_ms(
                lambda: fk.fused_learned_rk4(u, bpack, bdt, STEPS, forcing=type(eforcing)(
                    *(leaf[:batch] for leaf in eforcing)), t=FORCING_T0), samples=samples),
            "forced_rk4_plain_ms": time_ms(
                lambda: fk.fused_learned_rk4_plain(u, bpack, bdt, STEPS, fp), samples=LONG_SAMPLES),
            "forced_rk4_bound_ms": learned_rk4_bound_ms(bpack, batch, STEPS, terms),
            "unforced_rk4_ms": time_ms(
                lambda: fk.fused_learned_rk4(ks_u, pack, ks_dt, STEPS), queued=True,
                samples=samples),
            "fused_rk4_ms": time_ms(lambda: base(ks_u), queued=True, samples=samples),
            "fused_rk4_call_ms": time_ms(lambda: base(ks_u), samples=samples),
            "fused_rk4_plain_ms": time_ms(
                lambda: fk.fused_rk4_plain(ks_u, base.scheme), samples=LONG_SAMPLES),
            "fused_rk4_bytes_bound_ms": bytes_ms,
            "fused_rk4_ops_bound_ms": ops_ms,
        }
        if batch == ENSEMBLE:  # 4 and 8 warps per block (rk4_launch takes 8)
            row["unforced_rk4_plain_ms"] = time_ms(
                lambda: fk.fused_learned_rk4_plain(ks_u, pack, ks_dt, STEPS), samples=LONG_SAMPLES)
            default = fk.RK4_MAX_WARPS
            for warps in (4, 8):
                fk.RK4_MAX_WARPS = warps
                row[f"fused_rk4_{warps}_warps_ms"] = time_ms(
                    lambda: base(ks_u), queued=True, samples=samples)
            fk.RK4_MAX_WARPS = default
        new_times[batch] = row
        log(f"    B={batch}: " + json.dumps(row))
    # the floor that binds fused_rk4 at small batch: 4 x STEPS dependent
    # stages. One trajectory alone (one warp on the card) shows the latency of
    # one stage with nothing to hide it.
    alone = fk.make_fused_rk4(eq, grid, ks_dt, 10 * STEPS)
    alone_ms = time_ms(lambda: alone(warmed[:1].contiguous()), queued=True)
    stage_us = 1e3 * alone_ms / (4 * 10 * STEPS)
    chain_ms = 4 * STEPS * stage_us / 1e3
    log(f"    fused_rk4, one warp alone: {stage_us:.4f} us per stage; "
        f"{4 * STEPS} dependent stages: {chain_ms:.4f} ms per {STEPS} steps")
    warm_dt = 0.2 * bgrid.dx
    warm_steps = int(np.ceil(WARMUP_TIME / warm_dt))
    warmup_ms = time_ms(lambda: integrate.integrate_spectral(
        beq, bgrid, eu0, warm_dt, warm_steps, save_every=warm_steps, forcing=eforcing),
        samples=LONG_SAMPLES)
    log(f"    integrate_spectral warm-up, Burgers, B={ENSEMBLE}, {warm_steps} ETDRK4 steps: "
        f"{warmup_ms:.2f} ms (the coefficients' set-up included)")
    # both ensemble routes end to end, a second (warm) run of each: the entry
    # point's own clock around its integration, host in the loop
    for key, checkpoint, route, step in (("burgers_fused", "ckpt_burgers8", "true", bdt),
                                         ("burgers_rhs", "ckpt_burgers8", "false", bdt),
                                         ("ks_fused", "ckpt_ks8", "true", ks_dt)):
        again, _ = ensemble(checkpoint, route, step)
        log(f"    ensemble {key}: first run {1e3 * ens[key]['elapsed_s']:.1f} ms, second "
            f"{1e3 * again['elapsed_s']:.1f} ms ({again['traj_steps_per_s']:,.0f} "
            f"traj-steps/s); warm-up {1e3 * again['warmup_s']:.1f} ms")
        ens[key + "_warm_ms"] = 1e3 * again["elapsed_s"]
    log(f"    baseline leg: {1e3 * base_elapsed:.1f} ms")

    # ---- 12. training --------------------------------------------------------
    training = training_phase(card, launch_floor_ms)

    # ---- 13. evaluation; 14. selection and the sweep ------------------------------
    evaluation = evaluation_phase(card, launch_floor_ms)
    selection = selection_phase(card)

    # ---- 15. the serving export -------------------------------------------------
    serving = serving_phase(card)

    # ---- 16. parallelism at world size 1 -------------------------------------------
    parallel = parallel_phase(card, ens, bdt, ks_dt)

    # ---- 17. the bench, profiling and debugging -------------------------------------
    tools = bench_phase(card)

    # ---- 18. report -----------------------------------------------------------
    flagship = times[BATCH]
    full = new_times[ENSEMBLE]
    kernels = [
        {
            "name": "fused_rhs",
            "route": "cuda",
            "source": "pde_superresolution_torch/csrc/fused_rhs.cu",
            "replaces": "pde_superresolution_tpu/ops/pallas_kernels.py:135",
            "launches": (launches["fused_rhs"] + rhs_ensemble_launches
                         + training["step_launches"] + training["train_launches"]
                         + training["trajectory_launches"] + evaluation["ks8"]["launches"]
                         + evaluation["burgers8"]["launches"] + selection["select_launches"]
                         + selection["sweep_launches"] + serving["resumable_launches"]
                         + parallel["ensemble_false_launches"] + parallel["train_launches"]
                         + tools["launches"]["fused_rhs"]),
            "launches_by_path": {"ks8 integrate(rhs_fn) B=256": launches["fused_rhs"],
                                 "burgers8 ensemble --fused false": rhs_ensemble_launches,
                                 "ks8 train step B=128 (kernel route)": training["step_launches"],
                                 f"ks8 train() {TRAIN_STEPS} steps + resume, kernel route":
                                     training["train_launches"],
                                 f"ks8 train() on {TRAJECTORIES} trajectories, device and host":
                                     training["trajectory_launches"],
                                 f"ks8 evaluation, {EVAL_MEMBERS} members, horizon {KS_HORIZON}":
                                     evaluation["ks8"]["launches"],
                                 f"burgers8 evaluation, 2 keys x {EVAL_MEMBERS} members":
                                     evaluation["burgers8"]["launches"],
                                 "ks8 run_select, 2 seeds": selection["select_launches"],
                                 "burgers8 run_sweep": selection["sweep_launches"],
                                 # only where h5py imports (the HDF5 leg)
                                 **({"burgers8 ensemble --output_path (resumable)":
                                     serving["resumable_launches"]}
                                    if serving["resumable_launches"] else {}),
                                 "burgers8 ensemble --fused false --data_parallel 1":
                                     parallel["ensemble_false_launches"],
                                 f"ks8 train(mesh=) {PARALLEL_TRAIN_STEPS} steps, kernel route":
                                     parallel["train_launches"],
                                 "bench: rhs_fn leg B=256, train leg kernel route B=128":
                                     tools["launches"]["fused_rhs"]},
            "shape": f"B={BATCH} nx={grid.size}",
            "max_abs_err": rhs_err,
            "ms": flagship["fused_rhs_ms"],
            "call_ms": flagship["fused_rhs_call_ms"],
            "plain_ms": flagship["fused_rhs_plain_ms"],
            "bound_ms": flagship["fused_rhs_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "ms_by_batch": {BATCH: flagship["fused_rhs_ms"],
                            THROUGHPUT_BATCH: times[THROUGHPUT_BATCH]["fused_rhs_ms"],
                            ENSEMBLE: rhs_ensemble["ms"]},
            "plain_ms_by_batch": {BATCH: flagship["fused_rhs_plain_ms"],
                                  THROUGHPUT_BATCH: times[THROUGHPUT_BATCH]["fused_rhs_plain_ms"],
                                  ENSEMBLE: rhs_ensemble["plain_ms"]},
            "bound_ms_by_batch": {BATCH: flagship["fused_rhs_bound_ms"],
                                  THROUGHPUT_BATCH: times[THROUGHPUT_BATCH]["fused_rhs_bound_ms"],
                                  ENSEMBLE: rhs_ensemble["bound_ms"]},
            "launch_floor_ms": launch_floor_ms,
            "training_b128": {"ms": training["rhs_ms"], "call_ms": training["rhs_call_ms"],
                              "plain_ms": training["rhs_plain_ms"],
                              "bound_ms": training["rhs_bound_ms"],
                              "backward_plain_vjp_call_ms": training["vjp_ms"],
                              "train_step_ms": training["step_ms"],
                              "loss_rel_err": training["loss_err"],
                              "grad_rel_err": training["grad_err"],
                              "smooth_grad_rel_err": training["smooth_grad_err"],
                              "phase_s": training["phase_s"]},
            "evaluation_b32": {
                label: {"ms": e["rhs_ms"], "call_ms": e["rhs_call_ms"],
                        "plain_ms": e["rhs_plain_ms"], "bound_ms": e["rhs_bound_ms"],
                        "evaluation_s": e["seconds"], "layers_s": e["layers_s"],
                        "model_leg_host_share": e["host_share"],
                        "card_vs_cpu": e["readings"], "survival_flips": e["flips"]}
                for label, e in evaluation.items() if label != "phase_s"},
            "selection_s": selection["select_s"], "sweep_s": selection["sweep_s"],
            # the served route launches no kernel: the artifact is the plain
            # route, held here against this kernel's route at B=ENSEMBLE
            "serving": {k: v for k, v in serving.items() if k != "resumable_launches"},
            "parallel": {k: v for k, v in parallel.items() if not k.endswith("launches")},
        },
        {
            "name": "fused_learned_rk4",
            "route": "cuda",
            "source": "pde_superresolution_torch/csrc/fused_learned_rk4.cu",
            "replaces": "pde_superresolution_tpu/ops/pallas_kernels.py:390",
            "launches": (launches["fused_learned_rk4"] + unforced_ensemble_launches
                         + parallel["ks_mesh_launches"] + parallel["trained_served_launches"]
                         + tools["launches"]["fused_learned_rk4"]),
            "launches_by_path": {"ks8 integrate_fused B=256": launches["fused_learned_rk4"],
                                 "ks8 ensemble --fused true": unforced_ensemble_launches,
                                 "ks8 fused_rk4_fn(mesh=) B=10240": parallel["ks_mesh_launches"],
                                 "run_training --data_parallel 1 checkpoint, run_ensemble "
                                 "--data_parallel 1": parallel["trained_served_launches"],
                                 "bench: fused legs B=256 and B=4096":
                                     tools["launches"]["fused_learned_rk4"]},
            "shape": f"B={BATCH} nx={grid.size}, {STEPS} steps",
            "max_abs_err": rk4_err,
            "ms": flagship["fused_learned_rk4_ms"],
            "call_ms": flagship["fused_learned_rk4_call_ms"],
            "plain_ms": flagship["fused_learned_rk4_plain_ms"],
            "bound_ms": flagship["fused_learned_rk4_bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "ms_by_batch": {BATCH: flagship["fused_learned_rk4_ms"],
                            THROUGHPUT_BATCH: times[THROUGHPUT_BATCH]["fused_learned_rk4_ms"],
                            ENSEMBLE: full["unforced_rk4_ms"]},
            "plain_ms_by_batch": {BATCH: flagship["fused_learned_rk4_plain_ms"],
                                  THROUGHPUT_BATCH: times[THROUGHPUT_BATCH][
                                      "fused_learned_rk4_plain_ms"],
                                  ENSEMBLE: full["unforced_rk4_plain_ms"]},
            "bench_fused_b256_steps_per_s": tools["bench"]["detail"]["fused"]["median"],
        },
        {
            "name": "fused_learned_rk4_forced",
            "route": "cuda",
            "source": "pde_superresolution_torch/csrc/fused_learned_rk4.cu",
            "replaces": "pde_superresolution_tpu/ops/pallas_kernels.py:595",
            "launches": (forced_launches + parallel["forced_mesh_launches"]
                         + parallel["ensemble_true_launches"]),
            "launches_by_path": {"burgers8 ensemble --fused true": forced_launches,
                                 "burgers8 fused_rk4_fn(mesh=) B=10240":
                                     parallel["forced_mesh_launches"],
                                 "burgers8 ensemble --fused true --data_parallel 1":
                                     parallel["ensemble_true_launches"]},
            "shape": f"B={ENSEMBLE} nx={bgrid.size}, {STEPS} steps, {terms} terms",
            "max_abs_err": forced_err,
            "ms": full["forced_rk4_ms"],
            "call_ms": full["forced_rk4_with_pack_ms"],
            "plain_ms": full["forced_rk4_plain_ms"],
            "bound_ms": full["forced_rk4_bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
        },
        {
            "name": "fused_rk4",
            "route": "cuda",
            "source": "pde_superresolution_torch/csrc/fused_rk4.cu",
            "replaces": "pde_superresolution_tpu/ops/pallas_kernels.py:304",
            "launches": baseline_launches + tools["checked_launches"]["fused_rk4"],
            "launches_by_path": {"ks8 ensemble baseline leg": baseline_launches,
                                 "debugging.checked baseline B=256":
                                     tools["checked_launches"]["fused_rk4"]},
            "shape": f"B={ENSEMBLE} nx={grid.size}, {STEPS} steps",
            "max_abs_err": baseline_err,
            "ms": full["fused_rk4_ms"],
            "call_ms": full["fused_rk4_call_ms"],
            "plain_ms": full["fused_rk4_plain_ms"],
            "bound_ms": max(full["fused_rk4_bytes_bound_ms"], full["fused_rk4_ops_bound_ms"]),
            "bound_by": ("bytes" if full["fused_rk4_bytes_bound_ms"]
                         > full["fused_rk4_ops_bound_ms"] else "operations"),
            "dependent_stage_chain_ms": chain_ms,
            "library_ms": None,
            "ms_by_batch": {b: row["fused_rk4_ms"] for b, row in new_times.items()},
        },
    ]
    if any(k["launches"] == 0 or 0 in k["launches_by_path"].values() for k in kernels):
        raise AssertionError(f"a kernel was not launched on its path: {kernels}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
