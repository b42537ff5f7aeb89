"""The port's run_analysis on the CPU: the figures of an evaluation file
(one the JAX package wrote) and of sweep records, and the report text equal
to the JAX package's on the same file."""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import analysis as janalysis
from pde_superresolution_tpu import evaluate as jeval
from pde_superresolution_torch.scripts import run_analysis

torch.set_num_threads(1)

FIGURES = ["mae.png", "survival.png", "spectrum.png", "spacetime.png"]


def _jax_eval_file(path, nx=128, diverged=True):
    """A 4-member, 6-save Burgers-sized evaluation written by the JAX
    package, with a diverged model member (the coefficients figure then
    falls back to the exact state for it)."""
    rng = np.random.default_rng(0)
    times = (1.0 + 0.1 * np.arange(6)).astype(np.float32)
    x = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    exact = np.stack([[np.sin(x + 0.3 * m + 0.2 * t) for t in range(6)]
                      for m in range(4)]).astype(np.float32)
    groups = {g: {} for g in ("trajectories", "mae", "correlation", "survival_time")}
    for s in ("model", "baseline", "weno"):
        traj = exact + 0.05 * rng.standard_normal(exact.shape).astype(np.float32)
        groups["trajectories"][s] = traj
        groups["mae"][s] = np.abs(traj - exact).mean(-1)
        groups["correlation"][s] = rng.uniform(0.7, 1, (4, 6)).astype(np.float32)
        groups["survival_time"][s] = (0.1 * rng.integers(0, 6, 4)).astype(np.float32)
    if diverged:
        groups["trajectories"]["model"][0, 3:] = np.nan
        groups["mae"]["model"][0, 3:] = np.nan
    order = ("trajectories", "mae", "correlation", "survival_time")
    jeval.save_eval_h5(path, jeval.EvalResult(
        jnp.asarray(times), jnp.asarray(exact),
        *({k: jnp.asarray(v) for k, v in groups[g].items()} for g in order)))


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_figures_and_report_from_a_jax_written_file(tmp_path, capsys):
    """Every figure of JAX's run_analysis is written (coefficients.png from
    the Burgers-8x asset, whose diverged member falls back to the exact
    state), and the printed report is the JAX package's report of the same
    file, character for character."""
    path = str(tmp_path / "eval.h5")
    _jax_eval_file(path)
    out = tmp_path / "figs"
    paths = run_analysis.main(["--input_path", path, "--output_dir", str(out),
                               "--checkpoint_dir", "ckpt_burgers8", "--period", "6.283185"])
    assert [p.split("/")[-1] for p in paths] == FIGURES + ["coefficients.png"]
    assert all(_is_png(p) for p in paths)
    printed = capsys.readouterr().out
    want = janalysis.report(jeval.load_eval_h5(path))
    assert "[1 diverged]" in want
    assert printed.startswith(want + "\n")


def test_space_time_window_and_sample(tmp_path):
    path = str(tmp_path / "eval.h5")
    _jax_eval_file(path, diverged=False)
    paths = run_analysis.main(["--input_path", path, "--output_dir", str(tmp_path / "f"),
                               "--sample", "2", "--spacetime_window", "32", "--dpi", "60"])
    assert [p.split("/")[-1] for p in paths] == FIGURES and all(map(_is_png, paths))


def test_sweep_figures(tmp_path):
    """run_sweep's JSONL rows (a diverged row drawn hollow, a fully
    diverged scheme without an MAE point) give the two sweep figures."""
    rows = [{"factor": 4, "model_mae": 0.01, "model_survival_median": 9.0,
             "model_diverged": 0, "baseline_mae": 0.05, "baseline_survival_median": 4.0,
             "baseline_diverged": 1},
            {"factor": 8, "model_mae": 0.03, "model_survival_median": 7.0,
             "model_diverged": 0, "baseline_mae": None, "baseline_survival_median": 1.0,
             "baseline_diverged": 4}]
    jsonl = tmp_path / "sweep.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    paths = run_analysis.main(["--sweep_jsonl", str(jsonl), "--output_dir",
                               str(tmp_path / "s")])
    assert [p.split("/")[-1] for p in paths] == ["sweep_mae.png", "sweep_survival.png"]
    assert all(map(_is_png, paths))


def test_refusals(tmp_path):
    """Exactly one of --input_path and --sweep_jsonl; the coefficients
    figure refuses a checkpoint of another grid."""
    for args in ([], ["--input_path", "a.h5", "--sweep_jsonl", "b.jsonl"]):
        with pytest.raises(SystemExit):
            run_analysis.main([*args, "--output_dir", str(tmp_path)])
    path = str(tmp_path / "eval.h5")
    _jax_eval_file(path, nx=64)
    with pytest.raises(ValueError, match="does not match"):
        run_analysis.main(["--input_path", path, "--output_dir", str(tmp_path / "f"),
                           "--checkpoint_dir", "ckpt_burgers8"])
