"""The port's evaluation and selection entry points on the CPU: one loader
for every CLI (a checkpoint directory written by ``run_training`` is served
and evaluated), ``run_evaluation``'s options, seed selection and the sweep,
with their records' layouts held to the JAX package's."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models.stencil_net import StencilModel as JModel
from pde_superresolution_tpu.training import TrainingConfig as JTrainingConfig
from pde_superresolution_tpu.training import loop as jloop
from pde_superresolution_tpu.training import selection as jselection
from pde_superresolution_torch import convert
from pde_superresolution_torch import evaluate as teval
from pde_superresolution_torch.models import ModelConfig as TConfig
from pde_superresolution_torch.scripts import run_ensemble, run_evaluation, run_select, run_sweep
from pde_superresolution_torch.scripts import run_training
from pde_superresolution_torch.training import loop as tloop
from pde_superresolution_torch.training import selection as tselection
from pde_superresolution_torch.training.config import TrainingConfig

torch.set_num_threads(1)

# tests/test_torch_train_loop.py's CLI recipe
CLI_HPARAMS = ("equation=burgers,resample_factor=4,fine_size=64,num_trajectories=4,"
               "num_times=8,time_delta=0.1,num_layers=1,filters=4,stencil_size=4,"
               "num_time_steps=2,learning_rates=1e-3,learning_stops=3,batch_size=4,"
               "eval_interval=3,checkpoint_interval=3")
EVAL = ["--num_samples", "2", "--time_max", "0.3", "--time_delta", "0.1", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint directory written by the port's run_training."""
    ckpt = tmp_path_factory.mktemp("cli") / "ckpt"
    run_training.main(["--checkpoint_dir", str(ckpt), "--hparams", CLI_HPARAMS,
                       "--device", "cpu"])
    assert tloop.checkpoint_steps(str(ckpt)) == [3]
    return ckpt


def test_load_checkpoint_takes_directories_and_assets(trained):
    """One loader: a training directory (its latest step) and an asset name
    both give (model, params, TrainingConfig)."""
    model, params, config = convert.load_checkpoint(str(trained), device="cpu")
    _, want, _ = tloop.load_model(str(trained), device="cpu")
    assert isinstance(config, TrainingConfig) and config.fine_size == 64
    assert all(torch.equal(params[k], want[k]) for k in want)
    model, params, config = convert.load_checkpoint("ckpt_ks8", device="cpu")
    assert isinstance(config, TrainingConfig) and config.equation == "ks"
    assert model.grid.size == config.fine_size // config.resample_factor == 128


def test_trained_directory_is_served_and_evaluated(trained, tmp_path, capsys):
    """The repair: run_ensemble and run_evaluation take a directory the
    port's run_training wrote (run_ensemble took only assets before)."""
    result = run_ensemble.main(["--checkpoint_dir", str(trained), "--num_trajectories", "4",
                                "--time_max", "0.1", "--num_saves", "2", "--device", "cpu"])
    assert result["finite"] == 4 and result["nx"] == 16
    out = run_evaluation.main(["--checkpoint_dir", str(trained), "--output_path",
                               str(tmp_path / "eval.h5"), *EVAL,
                               "--baseline_stencil_size", "4", "--mae_survival_threshold", "0.5"])
    text = capsys.readouterr().out
    assert "MAE<0.5 survival" in text
    assert all(f"{name}: final MAE median" in text for name in ("model", "baseline", "weno"))
    assert os.path.exists(tmp_path / "eval.h5") and out["output_paths"] == [str(tmp_path / "eval.h5")]
    loaded = teval.load_eval_h5(str(tmp_path / "eval.h5"))
    result = out["results"][0]
    assert torch.equal(loaded.exact, result.exact) and loaded.exact.shape == (2, 4, 16)
    stats = out["per_key"][0]
    assert set(stats) == {"model", "baseline", "weno"}
    assert stats["model"]["survival_median"] == float(np.median(result.survival_time["model"]))
    assert "mae_survival_median" in stats["weno"]


def test_asset_multi_key_pooling(tmp_path, capsys):
    """--seeds 0,7 on a committed asset: per-key lines, a POOLED line over
    4 members, .key0/.key7 files and no plain output file."""
    out_path = tmp_path / "mk.h5"
    out = run_evaluation.main(["--checkpoint_dir", "ckpt_burgers8", "--output_path",
                               str(out_path), *EVAL, "--time_max", "0.2", "--seeds", "0,7",
                               "--reference_cache_dir", ""])
    text = capsys.readouterr().out
    assert "[key 0]" in text and "[key 7]" in text
    assert "POOLED 2 keys" in text and "over 4 members" in text and "per-key medians" in text
    assert (tmp_path / "mk.key0.h5").exists() and (tmp_path / "mk.key7.h5").exists()
    assert not out_path.exists()
    assert out["pooled"]["model"]["members"] == 4
    # the two keys drew different members
    assert not torch.equal(out["results"][0].exact, out["results"][7].exact)


def test_duplicate_seeds_refused(trained, tmp_path):
    with pytest.raises(SystemExit):
        run_evaluation.main(["--checkpoint_dir", str(trained), "--output_path",
                             str(tmp_path / "dup.h5"), "--seeds", "3,3", "--device", "cpu"])
    assert not (tmp_path / "dup.h5").exists()


def test_domain_factor(trained):
    """--domain_factor 2: the same dx on a twice larger box."""
    args = run_evaluation.build_parser().parse_args(
        ["--checkpoint_dir", str(trained), "--output_path", "unused.h5", *EVAL,
         "--domain_factor", "2", "--reference_cache_dir", ""])
    out = run_evaluation.evaluate_checkpoint(args)
    result = out["results"][0]
    assert result.exact.shape == (2, 4, 32) and out["output_paths"] == []
    assert all(torch.isfinite(t).all() for t in result.trajectories.values())


def test_reference_cache_gives_identical_statistics(trained, tmp_path, monkeypatch):
    """No cache against a cache directory (a miss, then a hit that runs no
    exact solve): bit-identical results and statistics."""
    def run(cache):
        args = run_evaluation.build_parser().parse_args(
            ["--checkpoint_dir", str(trained), "--output_path", "unused.h5", *EVAL,
             "--reference_cache_dir", cache])
        return run_evaluation.evaluate_checkpoint(args)

    plain = run("")
    miss = run(str(tmp_path / "refs"))
    assert len(os.listdir(tmp_path / "refs")) == 1
    from pde_superresolution_torch import integrate

    def refuse(*a, **k):
        raise AssertionError("exact solve on a cache hit")

    monkeypatch.setattr(integrate, "exact_solve_sampled", refuse)
    hit = run(str(tmp_path / "refs"))
    for other in (miss, hit):
        assert other["per_key"] == plain["per_key"]
        for name, traj in plain["results"][0].trajectories.items():
            assert torch.equal(other["results"][0].trajectories[name], traj)


def test_auto_cache_without_h5py_says_so(monkeypatch, capsys):
    """--reference_cache_dir auto without h5py: no cache, one printed line."""
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    assert teval.resolve_reference_cache_dir("auto") is None
    assert "reference cache: off" in capsys.readouterr().out
    assert teval.resolve_reference_cache_dir("some/dir") == "some/dir"
    assert teval.resolve_reference_cache_dir("") is None


# -- selection and the sweep --------------------------------------------------------------

# tests/test_selection.py's TINY recipe, cut to 2 steps
TINY_FIELDS = dict(
    equation="burgers", conservative=True, resample_factor=4, fine_size=64,
    num_trajectories=3, num_times=12, time_delta=0.1, num_time_steps=1,
    learning_rates=(1e-3,), learning_stops=(2,), batch_size=8, eval_interval=2,
    checkpoint_interval=2,
)
MODEL_FIELDS = dict(num_layers=1, filters=4, stencil_size=4)
TINY = TrainingConfig(model=TConfig(**MODEL_FIELDS), **TINY_FIELDS)
PROTOCOL = dict(eval_time_max=0.2, select_eval_seed=1, select_samples=2, final_eval_seed=2,
                final_samples=3)


@pytest.fixture(scope="module")
def selected(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("select") / "sel")
    return tselection.select_checkpoint(TINY, 2, out, device="cpu", **PROTOCOL), out


@pytest.fixture(scope="module")
def jax_selection_json(tmp_path_factory):
    """The JAX package's selection.json for the same protocol, its training
    replaced by the initial params (only the layout is compared)."""
    out = str(tmp_path_factory.mktemp("jselect") / "sel")
    config = JTrainingConfig(model=JConfig(**MODEL_FIELDS), **TINY_FIELDS)
    eq = jeq.from_name("burgers", conservative=True)
    coarse = JGrid(64, eq.period).resample(4, conservative=True)
    model = JModel(eq, coarse, config.model)

    def fake_train(cfg, checkpoint_dir=None, metrics_path=None, **_):
        os.makedirs(checkpoint_dir, exist_ok=True)
        return model, model.init_params(jax.random.PRNGKey(cfg.seed)), {
            "eval_total": 1.0, "eval_rollout_finite_frac": 1.0}

    def fake_load(path):
        seed = int(os.path.basename(path)[len("seed"):])
        return model, model.init_params(jax.random.PRNGKey(seed)), dataclasses.replace(
            config, seed=seed)

    patch = pytest.MonkeyPatch()
    patch.setattr(jloop, "train", fake_train)
    patch.setattr(jloop, "load_model", fake_load)
    try:
        jselection.select_checkpoint(config, 2, out, **PROTOCOL)
    finally:
        patch.undo()
    with open(os.path.join(out, "selection.json")) as f:
        return json.load(f)


def test_selection_layout_against_jax(selected, jax_selection_json):
    """selection.json, its rows and both scores carry the JAX package's keys;
    the winner is the protocol argmax and its re-score uses the fresh seed."""
    result, out = selected
    with open(os.path.join(out, "selection.json")) as f:
        summary = json.load(f)
    want = jax_selection_json
    assert sorted(summary) == sorted(want)
    for key in ("selection_score", "final_score"):
        assert sorted(summary[key]) == sorted(want[key]), key
    assert [sorted(r) for r in summary["rows"]] == [sorted(r) for r in want["rows"]]
    assert result.winner_seed == min(result.rows, key=tselection._rank_key)["seed"]
    assert result.winner_checkpoint == os.path.join(out, f"seed{result.winner_seed}")
    assert result.final_score["eval_seed"] == PROTOCOL["final_eval_seed"]
    assert result.final_score["num_samples"] == PROTOCOL["final_samples"]
    assert result.selection_score["eval_seed"] == PROTOCOL["select_eval_seed"]
    assert summary["selection_bias"] == (result.selection_score["model_survival_median"]
                                         - result.final_score["model_survival_median"])
    for s in (0, 1):
        assert tloop.checkpoint_steps(os.path.join(out, f"seed{s}")) == [2]
    _, _, cfg = tloop.load_model(result.winner_checkpoint, device="cpu")
    assert cfg.seed == result.winner_seed


def test_selection_rerun_reads_cached_scores(selected, monkeypatch):
    """A re-invocation reads seed{s}_score.json and trains nothing."""
    result, out = selected

    def refuse(*a, **k):
        raise AssertionError("a finished seed was trained again")

    monkeypatch.setattr(tloop, "train", refuse)
    again = tselection.select_checkpoint(TINY, 2, out, device="cpu", **PROTOCOL)
    assert again.winner_seed == result.winner_seed and again.rows == result.rows


def test_selection_refusals(tmp_path):
    with pytest.raises(ValueError, match="winner's curse"):
        tselection.select_checkpoint(TINY, 2, str(tmp_path), eval_time_max=0.2,
                                     select_eval_seed=7, final_eval_seed=7, device="cpu")
    with pytest.raises(ValueError, match="vacuous"):
        tselection.select_checkpoint(TINY, 1, str(tmp_path), eval_time_max=0.2, device="cpu")


def test_rank_key():
    rows = [
        {"seed": 0, "model_survival_median": 5.0, "model_mae_median": 0.1, "model_diverged": 0},
        {"seed": 1, "model_survival_median": 9.0, "model_mae_median": 0.9, "model_diverged": 2},
        {"seed": 2, "model_survival_median": 9.0, "model_mae_median": 0.2, "model_diverged": 0},
        {"seed": 3, "model_survival_median": 9.0, "model_mae_median": None, "model_diverged": 0},
    ]
    assert [r["seed"] for r in sorted(rows, key=tselection._rank_key)] == [2, 1, 3, 0]


SWEEP_HPARAMS = ("fine_size=64,num_trajectories=3,num_times=12,num_layers=1,filters=4,"
                 "stencil_size=4,num_time_steps=1,learning_rates=1e-3,learning_stops=2,"
                 "batch_size=8,eval_interval=2")


def test_run_select_cli(tmp_path, capsys):
    """run_select: one JSON line per seed, then the summary line."""
    summary = run_select.main(
        ["--output_dir", str(tmp_path / "sel"), "--num_seeds", "2", "--hparams",
         "equation=burgers,resample_factor=4," + SWEEP_HPARAMS, "--select_samples", "2",
         "--final_samples", "2", "--select_eval_seed", "1", "--final_eval_seed", "2",
         "--eval_time_max", "0.2", "--reference_cache_dir", "", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [row["seed"] for row in lines[:2]] == [0, 1] and lines[-1] == summary
    assert sorted(summary) == ["final_diverged", "final_mae_median", "final_survival",
                               "selection_survival", "winner_checkpoint", "winner_seed"]
    assert (tmp_path / "sel" / "selection.json").exists()


def test_run_sweep_record_layout(tmp_path):
    """run_sweep with one factor: the JSONL record holds the keys of the JAX
    package's record (pde_superresolution_tpu/scripts/run_sweep.py: factor,
    eval_total, baseline_stencil_size, then per scheme mae, mae_median,
    diverged and survival_median; Burgers has model, baseline and weno)."""
    records = run_sweep.main(["--equation", "burgers", "--factors", "4", "--hparams",
                              SWEEP_HPARAMS, "--num_eval_samples", "2", "--eval_time_max", "0.2",
                              "--output_path", str(tmp_path / "sweep.jsonl"),
                              "--reference_cache_dir", "", "--device", "cpu"])
    with open(tmp_path / "sweep.jsonl") as f:
        written = [json.loads(line) for line in f]
    assert written == records and len(records) == 1
    want = {"factor", "eval_total", "baseline_stencil_size"} | {
        f"{name}_{stat}" for name in ("model", "baseline", "weno")
        for stat in ("mae", "mae_median", "diverged", "survival_median")}
    assert set(records[0]) == want
    assert records[0]["factor"] == 4 and records[0]["baseline_stencil_size"] == 4
    assert np.isfinite(records[0]["eval_total"])
