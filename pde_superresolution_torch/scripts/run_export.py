"""Freeze a trained checkpoint into a standalone serving artifact.

The counterpart of ``pde_superresolution_tpu/scripts/run_export.py``: the
checkpoint's plain RHS (and an optional ``--num_steps`` RK4 advance) is
traced with ``torch.export`` on the CPU and written to a directory that
``export.ServedModel`` loads without any model code, on the CPU or a CUDA
card. Then the artifact is loaded on ``--device`` (``cuda`` unless ``cpu``
is given) and its RHS is held against the live model's on 4 seeded
members, or it raises: against the live plain route (the route it traced)
at most 1e-5 apart, the JAX package's check; and against the live model's
default route, on the card its kernel route (``fused_rhs``), at most 1e-4
of max|u_t| apart, the port's limit between the kernel and its plain
version (its tap sums run in another order, and the face difference
cancels most of them). On the CPU both routes are the plain one.

Example:
  python -m pde_superresolution_torch.scripts.run_export \
      --checkpoint_dir ckpt_ks8 --output_dir /tmp/ks8_export --num_steps 16

Evaluate the frozen artifact like a live checkpoint with
``run_evaluation --exported_dir /tmp/ks8_export``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pde_superresolution_torch import convert
from pde_superresolution_torch import export as export_lib
from pde_superresolution_torch.device import resolve_device

MAX_ABS_ERR = 1e-5  # the served RHS against the live plain route
KERNEL_REL_ERR = 1e-4  # ... against the live fused_rhs route, of max|u_t|


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint_dir", required=True,
                        help="training checkpoint directory, asset name or path stem")
    parser.add_argument("--output_dir", required=True, help="artifact output directory")
    parser.add_argument("--num_steps", type=int, default=16,
                        help="RK4 steps in the exported advance (one call = num_steps "
                        "steps; 0 exports the per-step RHS only)")
    parser.add_argument("--dt", type=float, default=0.0,
                        help="RK4 step of the advance; 0 = the model-aware stable step "
                        "on the model grid")
    parser.add_argument("--platforms", default=",".join(export_lib.DEFAULT_PLATFORMS),
                        help="comma-separated device types the artifact may be served on, "
                        "a subset of cpu,cuda (a torch.export artifact has no TPU lowering)")
    parser.add_argument("--device", default=None,
                        help="where the artifact is loaded and checked: cuda (default) or "
                        "cpu; one of --platforms")
    return parser


def main(argv=None) -> dict:
    """Export, save, load and check; print the metadata with the checks'
    ``max_abs_err`` (plain route) and ``kernel_rel_err`` (default route)
    and the seconds of the export, the save and the load, and return them
    with the loaded model under ``served``."""
    args = build_parser().parse_args(argv)
    platforms = export_lib.check_platforms(args.platforms.split(","))
    device = resolve_device(args.device)
    if device.type not in platforms:
        raise ValueError(f"--device {device.type} is not in --platforms {args.platforms}: "
                         "the artifact is checked where it is loaded")
    model, params, config = convert.load_checkpoint(args.checkpoint_dir, device=device)
    start = time.perf_counter()
    meta, exported = export_lib.export_model(
        model, params, dt=args.dt or None, num_steps=args.num_steps, platforms=platforms,
        fine_size=config.fine_size, resample_factor=config.resample_factor,
        # provenance only: export_model serializes the live equation's
        # parameters itself
        extra_meta={"checkpoint_dir": args.checkpoint_dir,
                    "training_equation_params": config.equation_params},
    )
    export_s = time.perf_counter() - start
    start = time.perf_counter()
    export_lib.save_exported_model(args.output_dir, meta, exported)
    save_s = time.perf_counter() - start
    start = time.perf_counter()
    served = export_lib.load_served_model(args.output_dir, device=device)
    load_s = time.perf_counter() - start

    # the frozen graph against the live model, on 4 seeded members
    generator = torch.Generator().manual_seed(0)
    u = model.equation.initial_conditions(generator, model.grid, (4,), device)
    forcing = model.equation.sample_forcing(generator, (4,), device)
    with torch.no_grad():
        frozen = served.rhs_fn(forcing)(u, 0.0)
        plain = model.rhs_fn(params, forcing, use_kernel=False)(u, 0.0)
        live = model.rhs_fn(params, forcing)(u, 0.0)  # the fused_rhs route on a card
    err = float((plain - frozen).abs().max())
    rel = float((live - frozen).abs().max()) / float(live.abs().max())
    if not (np.isfinite(err) and np.isfinite(rel) and err <= MAX_ABS_ERR
            and rel <= KERNEL_REL_ERR):
        raise RuntimeError(f"exported RHS disagrees with live model: {err} against the plain "
                           f"route, {rel} of max|u_t| against the {model.device.type} default")
    out = {"output_dir": args.output_dir, "max_abs_err": err, "kernel_rel_err": rel,
           "export_s": export_s, "save_s": save_s, "load_s": load_s, **meta}
    print(json.dumps(out), flush=True)
    return {**out, "served": served}


if __name__ == "__main__":
    main(sys.argv[1:])
