"""Seed selection: train N seeds, score by the evaluation protocol, keep the winner.

The counterpart of ``pde_superresolution_tpu/training/selection.py``.
Training stochasticity (init and batch order) can dominate model capacity
at hard coarsening corners, and the end-of-training eval loss is a weak
selector for long-horizon survival, so this loop trains several seeds of
one recipe and selects by the evaluation protocol itself. With a reference
cache (``evaluate``; needs ``h5py``) all seeds' selection evals share ONE
fine reference solve; without one, each computes it, with the same result.

Selection honesty (winner's curse): the winner is RE-SCORED at the full
protocol with a FRESH evaluation seed (disjoint trajectories from the
selection eval) and BOTH numbers are reported; their gap is
``selection_bias``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Optional, Sequence

import numpy as np
import torch

from pde_superresolution_torch import evaluate as eval_lib
from pde_superresolution_torch import integrate
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models.stencil_net import StencilModel
from pde_superresolution_torch.training import loop as loop_lib
from pde_superresolution_torch.training.config import TrainingConfig


def protocol_score(
    model: StencilModel,
    params: dict,
    config: TrainingConfig,
    *,
    eval_seed: int,
    num_samples: int,
    time_max: float,
    warmup_time: float = 0.0,
    baseline_stencil_size: int = 0,
    reference_cache_dir: Optional[str] = None,
    include_baseline: bool = True,
) -> dict:
    """Score (model, params) under the standard evaluation protocol, on the
    model's device.

    The protocol is the one run_sweep/run_evaluation run: matched ICs from
    a generator seeded ``eval_seed``, the exact fine reference, the model
    plus (by default) the matched-width classic baseline, survival by
    correlation 0.8 and final MAE. Returns a flat JSON-able row; MAE is
    reported both as the member MEDIAN and as the finite-member mean.
    """
    equation = model.equation
    device = model.device
    fine = Grid(config.fine_size, equation.period)
    schemes: dict = {"model": lambda forcing: model.rhs_fn(params, forcing)}
    if include_baseline:
        size = baseline_stencil_size or model.config.stencil_size
        schemes["baseline"] = (
            lambda forcing: integrate.PolynomialDifferentiator(
                equation, model.grid, stencil_size=size, device=device
            ).rhs_fn(forcing)
        )
    result = eval_lib.evaluate(
        equation,
        fine,
        config.resample_factor,
        schemes,
        generator=torch.Generator().manual_seed(eval_seed),
        num_samples=num_samples,
        time_max=time_max,
        time_delta=config.time_delta,
        warmup_time=warmup_time,
        ic_scale=config.ic_scale,
        coarse_dt=eval_lib.model_coarse_dt(
            model.stable_time_step(u_scale=3.0), model.equation, model.grid),
        reference_cache_dir=reference_cache_dir,
        device=device,
    )
    row: dict = {
        "eval_seed": int(eval_seed),
        "num_samples": int(num_samples),
        "time_max": float(time_max),
    }
    for name in schemes:
        final = eval_lib.as_numpy(result.mae[name])[:, -1]
        finite = np.isfinite(final)
        surv = eval_lib.as_numpy(result.survival_time[name])
        row[f"{name}_survival_median"] = float(np.median(surv))
        row[f"{name}_survival_mean"] = float(surv.mean())
        row[f"{name}_mae_median"] = (
            float(np.median(final[finite])) if finite.any() else None
        )
        row[f"{name}_mae"] = (
            float(final[finite].mean()) if finite.any() else None
        )
        row[f"{name}_diverged"] = int((~finite).sum())
    return row


def _rank_key(row: dict) -> tuple:
    """Sort key: best survival first; median MAE then divergence count break
    ties. Survival median is the protocol's headline metric."""
    mae = row.get("model_mae_median")
    return (
        -row["model_survival_median"],
        np.inf if mae is None else mae,
        row["model_diverged"],
    )


class SelectionResult(typing.NamedTuple):
    rows: list  # one selection-protocol score per seed (in seed order)
    winner_seed: int
    winner_checkpoint: str
    selection_score: dict  # winner's row under the SELECTION protocol
    final_score: dict  # winner re-scored at the full protocol, FRESH seed


def select_checkpoint(
    config: TrainingConfig,
    num_seeds: int,
    output_dir: str,
    *,
    eval_time_max: float,
    eval_warmup: float = 0.0,
    select_eval_seed: int = 12345,
    select_samples: int = 16,
    final_eval_seed: int = 54321,
    final_samples: int = 32,
    baseline_stencil_size: int = 0,
    reference_cache_dir: Optional[str] = None,
    seeds: Optional[Sequence[int]] = None,
    device=None,
) -> SelectionResult:
    """Train ``num_seeds`` seeds of one recipe on ``device`` (default
    ``cuda``); keep the protocol winner.

    Per seed s: train ``config`` with ``seed=s`` into ``{output_dir}/seed{s}``
    (resumable checkpoints; a finished seed's score is cached at
    ``seed{s}_score.json`` and re-invocations skip it), score with a cheap
    ``select_samples``-member protocol eval, rank by survival median (MAE
    median tie-break), then re-score ONLY the winner at the
    ``final_samples`` protocol with the FRESH ``final_eval_seed``. Writes
    ``{output_dir}/selection.json`` and returns a SelectionResult carrying
    both winner scores.

    The training data is held fixed across seeds (``config.data_seed`` is
    untouched): the selection isolates training stochasticity.
    """
    if final_eval_seed == select_eval_seed:
        raise ValueError(
            "final_eval_seed must differ from select_eval_seed: re-scoring "
            "the winner on the trajectories it was selected on inflates it "
            "by the selection bias (winner's curse)"
        )
    seed_list = list(seeds) if seeds is not None else list(range(num_seeds))
    if len(seed_list) < 2:
        raise ValueError(f"selection over {seed_list} seeds is vacuous")
    os.makedirs(output_dir, exist_ok=True)
    protocol = dict(
        time_max=eval_time_max,
        warmup_time=eval_warmup,
        baseline_stencil_size=baseline_stencil_size,
        reference_cache_dir=reference_cache_dir,
    )

    rows = []
    for s in seed_list:
        ckdir = os.path.join(output_dir, f"seed{s}")
        score_path = os.path.join(output_dir, f"seed{s}_score.json")
        if os.path.exists(score_path):
            with open(score_path) as f:
                row = json.load(f)
        else:
            cfg = dataclasses.replace(config, seed=s)
            model, params, metrics = loop_lib.train(
                cfg,
                checkpoint_dir=ckdir,
                metrics_path=os.path.join(ckdir, "metrics.jsonl"),
                device=device,
            )
            row = protocol_score(model, params, cfg, eval_seed=select_eval_seed,
                                 num_samples=select_samples, **protocol)
            row["seed"] = int(s)
            row["checkpoint_dir"] = ckdir
            # the weak selector, recorded so every selection run documents
            # the eval-loss-vs-protocol gap
            row["eval_total"] = metrics.get("eval_total")
            row["eval_rollout_finite_frac"] = metrics.get("eval_rollout_finite_frac")
            tmp = score_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(row, f)
            os.replace(tmp, score_path)
        rows.append(row)

    winner = min(rows, key=_rank_key)
    model, params, cfg = loop_lib.load_model(winner["checkpoint_dir"], device=device)
    final = protocol_score(model, params, cfg, eval_seed=final_eval_seed,
                           num_samples=final_samples, **protocol)
    summary = {
        "winner_seed": winner["seed"],
        "winner_checkpoint": winner["checkpoint_dir"],
        "selection_score": winner,
        "final_score": final,
        # the honesty gap: selection-protocol survival minus fresh-eval
        # survival; a large positive value means the selection overfit its
        # eval trajectories
        "selection_bias": (
            winner["model_survival_median"] - final["model_survival_median"]
        ),
        "rows": rows,
    }
    with open(os.path.join(output_dir, "selection.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return SelectionResult(
        rows=rows,
        winner_seed=winner["seed"],
        winner_checkpoint=winner["checkpoint_dir"],
        selection_score=winner,
        final_score=final,
    )
