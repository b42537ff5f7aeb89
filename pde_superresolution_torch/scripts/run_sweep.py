"""Resample-factor sweep: the paper's headline figure as a CLI.

The counterpart of ``pde_superresolution_tpu/scripts/run_sweep.py``: trains
a learned discretization at each coarsening factor and evaluates it against
the exact solve, the polynomial baseline and (Burgers) WENO5, printing one
JSON record per factor (and writing them as JSONL with ``--output_path``).
The run is on ``cuda`` unless ``--device cpu`` is given.

Example:
  python -m pde_superresolution_torch.scripts.run_sweep \
      --equation burgers --factors 4,8,16,32 --output_path /tmp/sweep.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pde_superresolution_torch import evaluate as eval_lib
from pde_superresolution_torch import integrate, weno
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.training import config as config_lib
from pde_superresolution_torch.training import loop as loop_lib


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--equation", default="burgers", help="equation name")
    parser.add_argument("--factors", default="4,8,16,32",
                        help="comma-separated resample factors")
    parser.add_argument("--hparams", default="",
                        help="extra hparam overrides applied to every run")
    parser.add_argument("--output_path", default=None, help="optional JSONL results path")
    parser.add_argument("--num_eval_samples", type=int, default=16, help="eval ensemble size")
    parser.add_argument("--eval_time_max", type=float, default=3.0, help="eval horizon")
    parser.add_argument("--eval_warmup", type=float, default=0.0, help="eval warmup (KS: ~40)")
    parser.add_argument("--baseline_stencil_size", type=int, default=0,
                        help="taps in the classic polynomial-baseline stencils; 0 "
                        "(default) = the model's own stencil width")
    parser.add_argument("--reference_cache_dir", default="auto",
                        help="content-keyed cache for exact reference solves: sweep "
                        "rows sharing one (equation, protocol) reuse ONE fine solve "
                        "across resample factors. 'auto' = ~/.cache/"
                        "pde_superresolution_torch/exact_refs when h5py imports, "
                        "else none; '' disables")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def main(argv=None) -> list[dict]:
    """Train and evaluate each factor; returns the records."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    base = config_lib.parse_hparams(args.hparams)
    cache_dir = eval_lib.resolve_reference_cache_dir(args.reference_cache_dir)
    records = []
    for factor in [int(f) for f in args.factors.split(",") if f.strip()]:
        config = config_lib.parse_hparams(
            f"equation={args.equation},resample_factor={factor}", base
        )
        model, params, metrics = loop_lib.train(config, device=device)
        equation = model.equation
        fine = Grid(config.fine_size, equation.period)
        baseline_size = args.baseline_stencil_size or model.config.stencil_size
        schemes = {
            "model": lambda forcing, m=model, p=params: m.rhs_fn(p, forcing),
            "baseline": lambda forcing, m=model, s=baseline_size:
                integrate.PolynomialDifferentiator(
                    equation, m.grid, stencil_size=s, device=device
                ).rhs_fn(forcing),
        }
        if equation.name == "burgers":
            schemes["weno"] = lambda forcing, m=model: weno.WENODifferentiator(
                equation, m.grid, device=device
            ).rhs_fn(forcing)
        result = eval_lib.evaluate(
            equation,
            fine,
            factor,
            schemes,
            generator=torch.Generator().manual_seed(12345),
            num_samples=args.num_eval_samples,
            time_max=args.eval_time_max,
            time_delta=config.time_delta,
            warmup_time=args.eval_warmup,
            ic_scale=config.ic_scale,
            coarse_dt=eval_lib.model_coarse_dt(
                model.stable_time_step(u_scale=3.0), model.equation, model.grid),
            reference_cache_dir=cache_dir,
            device=device,
        )
        record = {
            "factor": factor,
            "eval_total": metrics.get("eval_total"),
            "baseline_stencil_size": baseline_size,
        }
        for name in schemes:
            final = eval_lib.as_numpy(result.mae[name])[:, -1]
            finite = np.isfinite(final)
            record[f"{name}_mae"] = float(final[finite].mean()) if finite.any() else None
            # the robust long-horizon statistic (means are tail-sensitive)
            record[f"{name}_mae_median"] = (
                float(np.median(final[finite])) if finite.any() else None
            )
            record[f"{name}_diverged"] = int((~finite).sum())
            record[f"{name}_survival_median"] = float(
                np.median(eval_lib.as_numpy(result.survival_time[name]))
            )
        records.append(record)
        print(json.dumps(record), flush=True)
    if args.output_path:
        with open(args.output_path, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
