"""Evaluate a trained model against exact + classical baselines.

The counterpart of ``pde_superresolution_tpu/scripts/run_evaluation.py``:
load a checkpoint, integrate the model, the matched-width classic baseline
and (Burgers) WENO5 from matched initial conditions beside the exact fine
solve, print MAE and survival statistics, and write the ``EvalResult`` as
HDF5 in the JAX package's layout.

Example:
  python -m pde_superresolution_torch.scripts.run_evaluation \
      --checkpoint_dir /tmp/ckpt --output_path /tmp/eval.h5 \
      --num_samples 16 --time_max 10

``--checkpoint_dir`` is a training checkpoint directory written by
``run_training``, a committed asset (``ckpt_ks8``, ...) or an exported
path stem (``convert.load_checkpoint``). The run is on ``cuda`` unless
``--device cpu`` is given; on the card the model's RHS is the ``fused_rhs``
kernel. ``--exported_dir`` evaluates a frozen ``run_export`` artifact
instead: its RHS is the model leg, ``export.science_context`` rebuilds the
equation and both grids, and its ``stable_dt`` sets the coarse step where
it is tighter than the equation's. Exactly one of the two is given.
Writing ``--output_path`` needs ``h5py``; ``evaluate_checkpoint`` runs
everything before the write.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from pde_superresolution_torch import convert, integrate, weno
from pde_superresolution_torch import evaluate as eval_lib
from pde_superresolution_torch import export as export_lib
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import StencilModel


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint_dir", default=None,
                        help="training checkpoint directory, asset name or path stem "
                        "(or use --exported_dir)")
    parser.add_argument("--exported_dir", default=None,
                        help="serving artifact from run_export; evaluates the frozen "
                        "graph (no model code or checkpoint needed)")
    parser.add_argument("--output_path", required=True, help="HDF5 output path")
    parser.add_argument("--num_samples", type=int, default=16,
                        help="ensemble size (matched ICs)")
    parser.add_argument("--time_max", type=float, default=10.0, help="evaluation horizon")
    parser.add_argument("--time_delta", type=float, default=0.1,
                        help="metric sampling interval")
    parser.add_argument("--warmup_time", type=float, default=0.0,
                        help="attractor warmup (KS: ~40)")
    parser.add_argument("--correlation_threshold", type=float, default=0.8,
                        help="survival-time correlation threshold")
    parser.add_argument("--mae_survival_threshold", type=float, default=0.0,
                        help="if > 0, ALSO report survival times under the "
                        "alternative MAE-threshold criterion (first time an "
                        "ensemble member's MAE exceeds this value)")
    parser.add_argument("--seed", type=int, default=0, help="evaluation seed")
    parser.add_argument("--seeds", default="",
                        help="comma-separated evaluation seeds for a MULTI-KEY "
                        "evaluation (overrides --seed): per-key lines plus a "
                        "POOLED median over all keys' members; each key's "
                        "EvalResult is saved to <output_path> with '.key<N>' "
                        "inserted before the extension")
    parser.add_argument("--ic_scale", type=float, default=1.0,
                        help="initial-condition amplitude")
    parser.add_argument("--baseline_stencil_size", type=int, default=0,
                        help="taps in the classic polynomial-baseline stencils; 0 "
                        "(default) = the model's own stencil width, so 'beats the "
                        "baseline' always means 'beats classic stencils of equal width'")
    parser.add_argument("--reference_cache_dir", default="auto",
                        help="content-keyed on-disk cache for the exact fine "
                        "reference solve (a hit is bit-identical to recomputing). "
                        "'auto' (default) = ~/.cache/pde_superresolution_torch/"
                        "exact_refs when h5py imports, else none; '' disables")
    parser.add_argument("--domain_factor", type=int, default=1,
                        help="evaluate the checkpoint on a domain this many times "
                        "LARGER than it was trained on (same dx); integer "
                        "forcing/IC wavenumber bands scale with the factor. "
                        "Checkpoints only: a frozen artifact's grid is baked in")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def _seeds(args: argparse.Namespace) -> list[int]:
    if not args.seeds:
        return [args.seed]
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"--seeds has duplicates: {args.seeds}")
    return seeds


def evaluate_checkpoint(
    args: argparse.Namespace,
    save: Optional[Callable[[str, eval_lib.EvalResult], None]] = None,
) -> dict:
    """The evaluation ``main`` runs, printing its lines; ``save(path,
    result)`` writes each key's result (``main`` passes
    ``evaluate.save_eval_h5``; None writes nothing).

    Returns ``{"seeds", "results": {seed: EvalResult}, "output_paths",
    "per_key": {seed: {scheme: stats}}, "pooled": {scheme: stats} (multi-key
    runs only)}``, the stats being the printed numbers.
    """
    seeds = _seeds(args)
    device = resolve_device(args.device)
    if args.exported_dir:
        served = export_lib.load_served_model(args.exported_dir, device=device)
        equation, fine, coarse = export_lib.science_context(served.meta)
        resample_factor = served.meta["resample_factor"]
        model_rhs = served.rhs_fn
        model_stencil_size = served.meta.get("stencil_size", 0)
        model_dt = served.meta.get("stable_dt")
    else:
        model, params, config = convert.load_checkpoint(args.checkpoint_dir, device=device)
        equation = model.equation
        resample_factor = config.resample_factor
        fine = Grid(config.fine_size, equation.period)
        coarse = model.grid
        if args.domain_factor > 1:
            # same physics in an N-times larger box, same dx: the trained
            # parameters apply unchanged (translation-invariant conv tower,
            # nx-independent constraint layer); the integer wavenumber bands
            # scale so physical forcing/IC wavelengths are unchanged
            n = args.domain_factor
            equation = dataclasses.replace(
                equation,
                period=n * equation.period,
                forcing_k_min=n * equation.forcing_k_min,
                forcing_k_max=n * equation.forcing_k_max,
                ic_k_min=n * equation.ic_k_min,
                ic_k_max=n * equation.ic_k_max,
            )
            fine = Grid(n * config.fine_size, equation.period)
            coarse = fine.resample(resample_factor, conservative=equation.conservative)
            model = StencilModel(equation, coarse, model.config, device=device)

        def model_rhs(forcing):
            return model.rhs_fn(params, forcing)

        model_stencil_size = model.config.stencil_size
        model_dt = model.stable_time_step(u_scale=3.0)

    baseline_size = args.baseline_stencil_size or model_stencil_size
    schemes = {
        "model": model_rhs,
        "baseline": lambda forcing: integrate.PolynomialDifferentiator(
            equation, coarse, stencil_size=baseline_size, device=device
        ).rhs_fn(forcing),
    }
    if equation.name == "burgers":
        schemes["weno"] = lambda forcing: weno.WENODifferentiator(
            equation, coarse, device=device
        ).rhs_fn(forcing)

    coarse_dt = eval_lib.model_coarse_dt(model_dt, equation, coarse)
    cache_dir = eval_lib.resolve_reference_cache_dir(args.reference_cache_dir)
    multi = len(seeds) > 1
    # per-member statistics pooled across eval keys: the pooled MEDIAN over
    # K x num_samples members is the multi-key statistic
    pooled_final = {name: [] for name in schemes}
    pooled_surv = {name: [] for name in schemes}
    pooled_surv_mae = {name: [] for name in schemes}
    out = {"seeds": seeds, "results": {}, "output_paths": [], "per_key": {}}
    for seed in seeds:
        result = eval_lib.evaluate(
            equation,
            fine,
            resample_factor,
            schemes,
            generator=torch.Generator().manual_seed(seed),
            num_samples=args.num_samples,
            time_max=args.time_max,
            time_delta=args.time_delta,
            warmup_time=args.warmup_time,
            correlation_threshold=args.correlation_threshold,
            ic_scale=args.ic_scale,
            coarse_dt=coarse_dt,
            reference_cache_dir=cache_dir,
            device=device,
        )
        out["results"][seed] = result
        if multi:
            root, ext = os.path.splitext(args.output_path)
            out_path = f"{root}.key{seed}{ext or '.h5'}"
        else:
            out_path = args.output_path
        if save is not None:
            save(out_path, result)
            out["output_paths"].append(out_path)
        rel_times = result.times - result.times[0]
        prefix = f"[key {seed}] " if multi else ""
        stats = out["per_key"][seed] = {}
        for name in schemes:
            final = eval_lib.as_numpy(result.mae[name])[:, -1]
            finite = np.isfinite(final)
            mae = float(final[finite].mean()) if finite.any() else float("nan")
            # the member MEDIAN is the robust long-horizon statistic: final-MAE
            # MEANS are tail-sensitive to which attractor trajectory a drifted
            # member is compared against
            mae_med = float(np.median(final[finite])) if finite.any() else float("nan")
            surv = eval_lib.as_numpy(result.survival_time[name])
            diverged = f" [{int((~finite).sum())}/{finite.size} diverged]" if (~finite).any() else ""
            pooled_final[name].append(final)
            pooled_surv[name].append(surv)
            stats[name] = {"mae_median": mae_med, "mae_mean": mae,
                           "diverged": int((~finite).sum()),
                           "survival_median": float(np.median(surv)),
                           "survival_mean": float(surv.mean())}
            extra = ""
            if args.mae_survival_threshold > 0:
                m = result.mae[name]
                m = torch.where(torch.isfinite(m), m, torch.full_like(m, float("inf")))
                s2 = eval_lib.as_numpy(eval_lib.survival_time_from_mae(
                    m, rel_times, args.mae_survival_threshold))
                pooled_surv_mae[name].append(s2)
                stats[name]["mae_survival_median"] = float(np.median(s2))
                extra = (
                    f" | MAE<{args.mae_survival_threshold:g} survival "
                    f"median {np.median(s2):.2f}"
                )
            print(
                f"{prefix}{name:>10}: final MAE median {mae_med:.4f} / "
                f"mean {mae:.4f}{diverged} | survival "
                f"median {np.median(surv):.2f} / mean {surv.mean():.2f} "
                f"(horizon {args.time_max}){extra}",
                flush=True,
            )
    if multi:
        out["pooled"] = {}
        for name in schemes:
            final = np.concatenate(pooled_final[name])
            finite = np.isfinite(final)
            mae_med = float(np.median(final[finite])) if finite.any() else float("nan")
            surv = np.concatenate(pooled_surv[name])
            per_key = ", ".join(f"{np.median(s):.2f}" for s in pooled_surv[name])
            diverged = (
                f" [{int((~finite).sum())}/{finite.size} diverged]"
                if (~finite).any() else ""
            )
            out["pooled"][name] = {"mae_median": mae_med, "diverged": int((~finite).sum()),
                                   "survival_median": float(np.median(surv)),
                                   "survival_mean": float(surv.mean()),
                                   "members": int(surv.size)}
            extra = ""
            if args.mae_survival_threshold > 0:
                s2 = np.concatenate(pooled_surv_mae[name])
                out["pooled"][name]["mae_survival_median"] = float(np.median(s2))
                extra = (
                    f" | MAE<{args.mae_survival_threshold:g} survival "
                    f"median {np.median(s2):.2f}"
                )
            print(
                f"POOLED {len(seeds)} keys {name:>10}: final MAE median "
                f"{mae_med:.4f}{diverged} | survival median "
                f"{np.median(surv):.2f} / mean {surv.mean():.2f} over "
                f"{surv.size} members (per-key medians: {per_key}){extra}",
                flush=True,
            )
    return out


def main(argv=None) -> dict:
    """Parse, evaluate and write each key's ``EvalResult`` (HDF5)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.checkpoint_dir) == bool(args.exported_dir):
        parser.error("pass exactly one of --checkpoint_dir / --exported_dir")
    if args.domain_factor > 1 and args.exported_dir:
        parser.error("--domain_factor needs a live checkpoint: a frozen artifact's "
                     "grid size (nx) is baked into the exported graph")
    try:
        _seeds(args)
    except ValueError as e:
        parser.error(str(e))
    return evaluate_checkpoint(args, save=eval_lib.save_eval_h5)


if __name__ == "__main__":
    main(sys.argv[1:])
