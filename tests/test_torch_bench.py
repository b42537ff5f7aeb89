"""The port's bench (``pde_superresolution_torch.bench``) against the
repository's ``bench.py`` (the JAX package's) on the CPU: the same program
on the same numpy inputs, the JSON line, the train leg, and no CPU fallback."""

import json

import jax
import numpy as np
import pytest
import torch

import bench as jbench
from pde_superresolution_tpu.models import StencilModel as JStencilModel
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import bench, convert
from pde_superresolution_torch.training import loop
from pde_superresolution_torch.training.config import TrainingConfig, parse_hparams

torch.set_num_threads(1)

# a KS training run small enough for the CPU; every other field is the
# KS-8x recipe's (assets/ckpt_ks8.json)
TINY = ("fine_size=64,resample_factor=4,num_trajectories=4,num_times=8,time_delta=0.1,"
        "warmup_time=0,num_layers=1,filters=4,num_time_steps=2,batch_size=4,"
        "learning_rates=1e-3,learning_stops=3")


@pytest.mark.parametrize("weights", ["init_params_key0", "ckpt_ks8"])
def test_build_matches_jax_bench(monkeypatch, weights):
    """The port's ``build()`` program (100 RK4 steps of ``integrate(rhs_fn)``)
    against the root ``bench.build()`` (a ``lax.scan`` of ``rk4_step``, JAX
    on the CPU) at batch 4, from JAX's ``u0``, with JAX's weights carried
    across by ``convert.params_from_jax``: JAX's ``init_params(PRNGKey(0))``
    (zero heads: the classic stencils) or the trained ``ckpt_ks8``. Both in
    float32 over 100 steps: within 1e-4 of max|u| (read 4.4e-7 and 2.9e-7)."""
    if weights == "init_params_key0":
        captured = {}
        real = JStencilModel.init_params

        def init_params(self, key):
            captured["params"] = real(self, key)
            return captured["params"]

        monkeypatch.setattr(JStencilModel, "init_params", init_params)
    else:
        captured = {"params": load_model("artifacts/ckpt_ks8")[1]}
        monkeypatch.setattr(JStencilModel, "init_params", lambda self, key: captured["params"])
    many_steps, u0 = jbench.build(fused=False, use_pallas=False, batch=4)
    want = np.asarray(jax.jit(many_steps)(u0))
    program, _ = bench.build(batch=4, device="cpu",
                             params=convert.params_from_jax(captured["params"], "cpu"))
    got = program(torch.from_numpy(np.array(u0))).numpy()
    assert got.shape == want.shape == (4, 128) and np.isfinite(want).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


def test_main_on_the_cpu_prints_one_json_line(capsys):
    result = bench.main(["--device", "cpu", "--batch", "2", "--samples", "2",
                         "--train_blocks", "2", "--train_steps", "1", "--train_hparams", TINY])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(result))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["unit"] == "rk4_steps/s/chip" and line["vs_baseline"] is None
    detail = line["detail"]
    assert detail["device"] == "cpu" and "plain routes only" in detail["note"]
    assert not {"fused", "cpu", "chip_ref_matmul", "throughput_fused_b4096"} & set(detail)
    leg = detail["rhs_fn"]
    assert line["value"] == leg["median"] > 0 and len(leg["samples"]) == 2
    assert leg["launches_per_call"] == {} and leg["finite"]  # the CPU launches no kernel
    train = detail["train"]
    assert set(train) >= {"plain_route", "batch", "unroll", "substeps"}
    assert "kernel_route" not in train and train["plain_route"]["finite"]


def test_main_without_a_card_raises_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_train_leg_runs_both_routes():
    out = bench.train_leg("cpu", blocks=2, steps=1, hparams=TINY, routes=(False, True))
    assert (out["batch"], out["unroll"]) == (4, 2)
    for route in ("plain_route", "kernel_route"):
        leg = out[route]
        assert len(leg["samples"]) == 2 and leg["median"] > 0 and leg["finite"]
        assert leg["steps_per_block"] == 1 and "device_busy_share" not in leg


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prepared_steps_replay_train(use_kernel):
    """The bench's train step is ``train()``'s: the set-up of
    ``loop.prepare_run`` and the steps of ``loop._step_functions``, fed
    ``next_batch(step)``, end where ``train()`` ends after the same steps."""
    config = parse_hparams(TINY, base=TrainingConfig.from_json(
        (convert.ASSET_DIR / "ckpt_ks8.json").read_text()))
    _, want, _ = loop.train(config, device="cpu", use_kernel=use_kernel)
    equation, fine, model = loop._model_for(config, torch.device("cpu"))
    run = loop.prepare_run(config, equation, fine, model)
    state = run.state
    for unroll, end in config.curriculum_phases():
        step = loop._step_functions(config, model, run.tx, run.norms, run.substeps,
                                    use_kernel)(unroll)[0]
        while state.step < end:
            state, _ = step(state, run.next_batch(state.step))
    assert state.step == config.num_steps
    for k in want:
        assert torch.equal(state.params[k], want[k]), k
