"""Train N seeds of one recipe and keep the evaluation-protocol winner.

The counterpart of ``pde_superresolution_tpu/scripts/run_select.py``: train
``--num_seeds`` seeds of the ``--hparams`` recipe, score each with a cheap
``--select_samples``-member protocol eval, then re-score ONLY the winner at
the full ``--final_samples`` protocol with a FRESH eval seed and report both
numbers (``training/selection.py``, the selection-bias guard). Prints one
JSON line per seed, then a summary line. The run is on ``cuda`` unless
``--device cpu`` is given.

Example (KS-32x):
  python -m pde_superresolution_torch.scripts.run_select \
      --output_dir /tmp/sel_ks32 --num_seeds 8 \
      --hparams "equation=ks,conservative=true,resample_factor=32,..." \
      --eval_time_max 50 --eval_warmup 44
"""

from __future__ import annotations

import argparse
import json
import sys

from pde_superresolution_torch import evaluate as eval_lib
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.training import config as config_lib
from pde_superresolution_torch.training import selection


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output_dir", required=True,
                        help="root directory: per-seed checkpoints + scores + "
                        "selection.json (resumable: finished seeds are skipped)")
    parser.add_argument("--hparams", default="", help="recipe overrides applied to every seed")
    parser.add_argument("--num_seeds", type=int, default=8, help="training seeds 0..N-1")
    parser.add_argument("--seeds", default=None,
                        help="comma-separated training-seed list (overrides --num_seeds)")
    parser.add_argument("--select_samples", type=int, default=16,
                        help="ensemble size of the cheap per-seed selection eval")
    parser.add_argument("--final_samples", type=int, default=32,
                        help="ensemble size of the winner's fresh full-protocol eval")
    parser.add_argument("--select_eval_seed", type=int, default=12345,
                        help="seed of the selection protocol's draw")
    parser.add_argument("--final_eval_seed", type=int, default=54321,
                        help="seed of the winner's re-score; MUST differ from "
                        "--select_eval_seed (winner's-curse guard)")
    parser.add_argument("--eval_time_max", type=float, default=10.0, help="eval horizon")
    parser.add_argument("--eval_warmup", type=float, default=0.0, help="eval warmup (KS: ~44)")
    parser.add_argument("--baseline_stencil_size", type=int, default=0,
                        help="classic-baseline width; 0 = the model's own stencil width")
    parser.add_argument("--reference_cache_dir", default="auto",
                        help="content-keyed cache for exact reference solves: every "
                        "seed's selection eval reuses ONE fine solve. 'auto' = "
                        "~/.cache/pde_superresolution_torch/exact_refs when h5py "
                        "imports, else none; '' disables")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    """Run the selection; print the rows and the summary, return the summary."""
    args = build_parser().parse_args(argv)
    config = config_lib.parse_hparams(args.hparams)
    result = selection.select_checkpoint(
        config,
        args.num_seeds,
        args.output_dir,
        eval_time_max=args.eval_time_max,
        eval_warmup=args.eval_warmup,
        select_eval_seed=args.select_eval_seed,
        select_samples=args.select_samples,
        final_eval_seed=args.final_eval_seed,
        final_samples=args.final_samples,
        baseline_stencil_size=args.baseline_stencil_size,
        reference_cache_dir=eval_lib.resolve_reference_cache_dir(args.reference_cache_dir),
        seeds=(
            [int(s) for s in args.seeds.split(",") if s.strip()]
            if args.seeds is not None else None
        ),
        device=resolve_device(args.device),
    )
    for row in result.rows:
        print(json.dumps(row), flush=True)
    summary = {
        "winner_seed": result.winner_seed,
        "winner_checkpoint": result.winner_checkpoint,
        "selection_survival": result.selection_score["model_survival_median"],
        "final_survival": result.final_score["model_survival_median"],
        "final_mae_median": result.final_score["model_mae_median"],
        "final_diverged": result.final_score["model_diverged"],
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
