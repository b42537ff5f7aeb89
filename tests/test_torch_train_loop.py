"""The port's optimizer and training loop against the JAX package's, and its
checkpoints, resume and CLI on the CPU."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch
import jax

from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.training import build_training_data as jbuild
from pde_superresolution_tpu.training import generate_snapshots as jgenerate
from pde_superresolution_tpu.training import loop as jloop
from pde_superresolution_tpu.training.config import TrainingConfig as JTrainingConfig
from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models.stencil_net import StencilModel as JModel
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.models import ModelConfig as TConfig
from pde_superresolution_torch.models.stencil_net import StencilModel as TModel
from pde_superresolution_torch.scripts import run_training
from pde_superresolution_torch.training import data as tdata
from pde_superresolution_torch.training import loop as tloop
from pde_superresolution_torch.training.config import TrainingConfig

torch.set_num_threads(1)

# tests/test_training.py's TINY recipe, in both packages
TINY_FIELDS = dict(
    equation="burgers", conservative=True, resample_factor=4, fine_size=64,
    num_trajectories=3, num_times=12, time_delta=0.1, num_time_steps=2,
    learning_rates=(1e-3,), learning_stops=(12,), batch_size=8, eval_interval=6,
    checkpoint_interval=6,
)
MODEL_FIELDS = dict(num_layers=2, filters=8, stencil_size=4)
TINY = TrainingConfig(model=TConfig(**MODEL_FIELDS), **TINY_FIELDS)
JTINY = JTrainingConfig(model=JConfig(**MODEL_FIELDS), **TINY_FIELDS)


def _jax_params(config):
    """The JAX package's initial params for ``config`` (numpy leaves)."""
    eq = jeq.from_name(config.equation, conservative=config.conservative)
    coarse = JGrid(config.fine_size, eq.period).resample(config.resample_factor,
                                                        conservative=config.conservative)
    model = JModel(eq, coarse, config.model)
    return jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(config.seed)))


def _tiny_dataset():
    """The TINY recipe's dataset from the JAX package's generator, as JAX
    TrainingData and as the port's."""
    eq = jeq.from_name("burgers", conservative=True)
    fine = JGrid(64, eq.period)
    snaps = jgenerate(eq, fine, jax.random.PRNGKey(0), num_trajectories=3, num_times=12,
                      time_delta=0.1)
    data = jbuild(eq, fine, snaps, 4, unroll_steps=2)
    t = lambda a: torch.from_numpy(np.array(a))
    ported = tdata.TrainingData(
        inputs=t(data.inputs), t=t(data.t),
        forcing=teq.ForcingParams(*(t(leaf) for leaf in data.forcing)),
        deriv_labels={d: t(v) for d, v in data.deriv_labels.items()},
        time_deriv_label=t(data.time_deriv_label), rollout=t(data.rollout),
        traj_ids=t(data.traj_ids))
    return data, ported


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# -- the optimizer --------------------------------------------------------------------


def test_optimizer_update_matches_optax():
    """Five updates from identical gradients against optax's
    apply_if_finite(chain(clip_by_global_norm(1), adam(join_schedules))):
    a plain step, a step whose norm triggers the clip, a non-finite
    gradient (skipped: params, moments and the schedule's count stay), the
    step that reaches the LR boundary at count 2, and one more. float32 in
    optax's order of operations: params within 1e-6 of their largest value
    plus 1e-9 (read at most 2.0e-7: a rounding, XLA's fused update against
    PyTorch's operation by operation)."""
    config = dataclasses.replace(JTINY, learning_rates=(1e-2, 1e-3), learning_stops=(2, 10))
    tree = _jax_params(config)
    tx_j = jloop.make_optimizer(config)
    state_j = tx_j.init(tree)
    tx_t = tloop.Optimizer(config.learning_rates, config.learning_stops, config.grad_clip_norm)
    params_t = convert.params_from_jax(tree, device="cpu")
    state_t = tx_t.init(params_t)
    rng = np.random.default_rng(0)
    scales = [1e-3, 5.0, None, 1e-2, 0.3]  # None: a NaN in one leaf
    counts = []
    for scale in scales:
        grads = jax.tree.map(
            lambda leaf: (scale or 1.0) * rng.standard_normal(leaf.shape).astype(np.float32)
            / np.sqrt(leaf.size), tree)
        if scale is None:
            grads["tower"][0][0][0, 0, 0] = np.nan
        updates, state_j = tx_j.update(grads, state_j, tree)
        tree = jax.tree.map(np.asarray, jax.tree.map(lambda p, u: p + u, tree, updates))
        before = {k: v.clone() for k, v in params_t.items()}
        state_before = state_t
        params_t, state_t = tx_t.update(convert.params_from_jax(grads, device="cpu"), state_t,
                                        params_t)
        want = convert.params_from_jax(tree, device="cpu")
        for k in want:
            err = float((params_t[k] - want[k]).abs().max())
            assert err <= 1e-6 * float(want[k].abs().max()) + 1e-9, (scale, k, err)
        if scale is None:
            assert all(torch.equal(params_t[k], before[k]) for k in before)
            assert state_t.count == state_before.count
            for moments, old in ((state_t.mu, state_before.mu), (state_t.nu, state_before.nu)):
                assert all(torch.equal(moments[k], old[k]) for k in old)
        counts.append(state_t.count)
    assert counts == [1, 2, 2, 3, 4]
    assert tx_t.learning_rate(1) == 1e-2 and tx_t.learning_rate(2) == 1e-3
    with pytest.raises(ValueError, match="align"):
        tloop.Optimizer((1e-3,), (1, 2), 1.0)


# -- the loop against JAX's --------------------------------------------------------


def test_tiny_training_matches_jax_and_draws_the_same_batches(tmp_path, monkeypatch):
    """The TINY recipe from JAX's initial params on the same dataset: the
    same split and batch indices at every step, and per-eval metrics within
    1e-4 relative at steps 6 and 12 (float32 on both sides, read at most
    5.4e-7 on the CPU; Adam can turn a gradient rounding into a step of up
    to lr, so the limit leaves room, and params are not compared)."""
    data_j, data_t = _tiny_dataset()
    drawn = {"jax": [], "torch": []}

    def recorder(lib, key):
        real = lib._slice_batch

        def slice_batch(dataset, idx):
            drawn[key].append(np.asarray(idx).copy())
            return real(dataset, idx)

        return slice_batch

    monkeypatch.setattr(jloop, "_slice_batch", recorder(jloop, "jax"))
    monkeypatch.setattr(tloop, "_slice_batch", recorder(tloop, "torch"))
    tree = _jax_params(JTINY)
    monkeypatch.setattr(TModel, "init_params",
                        lambda self, generator: convert.params_from_jax(tree, self.device))
    jloop.train(JTINY, dataset=data_j, metrics_path=str(tmp_path / "jax.jsonl"))
    tloop.train(TINY, dataset=data_t, metrics_path=str(tmp_path / "torch.jsonl"), device="cpu")
    assert len(drawn["torch"]) == len(drawn["jax"]) == 2 + 12
    for a, b in zip(drawn["torch"], drawn["jax"]):
        np.testing.assert_array_equal(a, b)
    want, got = _records(tmp_path / "jax.jsonl"), _records(tmp_path / "torch.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [6, 12]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key.startswith(("train_", "eval_")):
                assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]) + 1e-7, (g["step"], key)


def test_split_train_eval_matches_jax():
    """The by-trajectory split and the sample-level fallback draw JAX's
    indices."""
    data_j, data_t = _tiny_dataset()
    for a, b in zip(tloop._split_train_eval(data_t, 0.7, 3), jloop._split_train_eval(data_j, 0.7, 3)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.warns(UserWarning, match="traj_ids"):
        got = tloop._split_train_eval(data_t._replace(traj_ids=None), 0.5, 1)
    with pytest.warns(UserWarning, match="traj_ids"):
        want = jloop._split_train_eval(data_j._replace(traj_ids=None), 0.5, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- checkpoints and resume ------------------------------------------------------------


def test_resume_is_bitwise_with_rollout_noise_and_refuses_changed_configs(tmp_path):
    """An interrupted run resumed from its step-6 checkpoint ends with the
    uninterrupted run's params bit for bit (batches, rollout noise and
    updates are functions of (seed, step) and the saved state); a changed
    config is refused with its fields listed, a re-paced or extended one is
    taken; load_model gives the params back."""
    config = dataclasses.replace(TINY, rollout_noise=0.1)
    _, done, metrics = tloop.train(config, checkpoint_dir=str(tmp_path / "a"), device="cpu")
    assert tloop.checkpoint_steps(str(tmp_path / "a")) == [6, 12]
    shutil.copytree(tmp_path / "a" / "6", tmp_path / "b" / "6")
    _, resumed, again = tloop.train(config, checkpoint_dir=str(tmp_path / "b"), device="cpu")
    assert all(torch.equal(resumed[k], done[k]) for k in done)
    assert again["eval_total"] == metrics["eval_total"]
    _, loaded, loaded_config = tloop.load_model(str(tmp_path / "a"), device="cpu")
    assert all(torch.equal(loaded[k], done[k]) for k in done)
    assert loaded_config == config
    assert all(torch.equal(tloop.restore_params(str(tmp_path / "a"), device="cpu")[k], done[k])
               for k in done)
    with pytest.raises(ValueError, match="batch_size"):
        tloop.train(dataclasses.replace(config, batch_size=4),
                    checkpoint_dir=str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match="learning_stops"):
        tloop.train(dataclasses.replace(config, learning_rates=(1e-3, 1e-4),
                                        learning_stops=(6, 12)),
                    checkpoint_dir=str(tmp_path / "a"), device="cpu")
    longer = dataclasses.replace(config, learning_stops=(14,), eval_interval=2,
                                 checkpoint_interval=2)
    tloop.train(longer, checkpoint_dir=str(tmp_path / "a"), device="cpu")
    assert tloop.checkpoint_steps(str(tmp_path / "a")) == [6, 12, 14]
    with open(tmp_path / "a" / "14" / "state.json") as f:
        assert json.load(f)["step"] == 14
    with pytest.raises(FileNotFoundError):
        tloop.load_model(str(tmp_path / "empty"))


def test_checkpoints_keep_three_and_hold_the_jax_layout(tmp_path):
    """Only the newest three step directories stay; model.npz holds the JAX
    package's leaf names and layouts, model.json its config JSON."""
    config = dataclasses.replace(TINY, learning_stops=(4,), checkpoint_interval=1,
                                 eval_interval=4)
    _, params, _ = tloop.train(config, checkpoint_dir=str(tmp_path), device="cpu")
    assert tloop.checkpoint_steps(str(tmp_path)) == [2, 3, 4]
    tree = convert.jax_tree_from_npz(tmp_path / "4" / "model.npz")
    assert tree["tower"][0][0].shape == (5, 1, 8)  # [K, Cin, Co]
    assert sorted(tree["heads"]) == ["0", "1"]
    with open(tmp_path / "4" / "model.json") as f:
        assert TrainingConfig.from_json(f.read()) == config
    back = convert.params_from_jax(tree, device="cpu")
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_curriculum_phases_log_their_unroll(tmp_path):
    """A two-phase unroll curriculum trains each phase at its width (the
    norms computed once, at the final width) and logs it."""
    config = dataclasses.replace(TINY, unroll_curriculum=(1, 2), curriculum_stops=(6, 12))
    _, _, metrics = tloop.train(config, metrics_path=str(tmp_path / "m.jsonl"), device="cpu")
    records = _records(tmp_path / "m.jsonl")
    assert [(r["step"], r["unroll_steps"]) for r in records] == [(6, 1.0), (12, 2.0)]
    assert "eval_integrated_0" in records[0] and "eval_integrated_1" not in records[0]
    assert np.isfinite(metrics["eval_total"])


# -- the CLI ---------------------------------------------------------------------------

CLI_HPARAMS = ("equation=burgers,resample_factor=4,fine_size=64,num_trajectories=4,"
               "num_times=8,time_delta=0.1,num_layers=1,filters=4,stencil_size=4,"
               "num_time_steps=2,learning_rates=1e-3,learning_stops=3,batch_size=4,"
               "eval_interval=3,checkpoint_interval=3")


@pytest.mark.parametrize("extra", [[], ["--large_ensemble", "--host_data", "true",
                                        "--chunk_trajectories", "2"]])
def test_run_training_main_on_cpu(tmp_path, extra):
    """run_training.main at a tiny size: finite eval metrics, a checkpoint
    that load_model reads, JSONL metrics and TensorBoard events."""
    metrics = run_training.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--hparams",
                                 CLI_HPARAMS, "--tensorboard_dir", str(tmp_path / "tb"),
                                 "--device", "cpu", *extra])
    assert np.isfinite(metrics["eval_total"])
    model, params, config = tloop.load_model(str(tmp_path / "ckpt"), device="cpu")
    assert config.num_trajectories == 4 and model.grid.size == 16
    assert set(params) == set(model.init_params(torch.Generator().manual_seed(0)))
    assert _records(tmp_path / "ckpt" / "metrics.jsonl")[-1]["step"] == 3
    assert any((tmp_path / "tb").iterdir())


def test_run_training_refuses_host_data_without_large_ensemble(tmp_path):
    with pytest.raises(SystemExit):
        run_training.main(["--checkpoint_dir", str(tmp_path), "--host_data", "true",
                           "--device", "cpu"])
