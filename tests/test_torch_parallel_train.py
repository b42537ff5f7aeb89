"""Data-parallel (and data x space) training and the --data_parallel CLIs,
on the CPU over gloo.

``train(mesh=)`` runs in 4 real rank processes (``torch_parallel_worker``,
one spawn computing every case) and is held against the port's
single-process ``train`` on the same injected numpy dataset, as JAX's
``tests/test_parallel.py`` holds its DP runs against its single-device one,
with its tolerances. The CLIs run under ``torchrun --standalone`` with 2
ranks and are held against the run without the flag.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.training import build_training_data as jbuild
from pde_superresolution_tpu.training import generate_snapshots as jgenerate
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.scripts import run_ensemble, run_training
from pde_superresolution_torch.training import data as tdata
from pde_superresolution_torch.training import loop as tloop

import torch_parallel_worker as worker

torch.set_num_threads(1)

# rtol, atol on params and the eval_total difference: tests/test_parallel.py's
# DP-against-single-device bounds (:168-191, :525-551, :410-461)
PARAM_TOL = (1e-4, 1e-5)
EVAL_TOL = 1e-3


def _dataset(num_times, unroll):
    """A Burgers dataset (fine 128, 2 trajectories) from the JAX package's
    generator, as the port's TrainingData."""
    eq = jeq.from_name("burgers", conservative=True)
    fine = JGrid(128, eq.period)
    snaps = jgenerate(eq, fine, jax.random.PRNGKey(0), num_trajectories=2,
                      num_times=num_times, time_delta=0.1)
    data = jbuild(eq, fine, snaps, 4, unroll_steps=unroll)
    t = lambda a: torch.from_numpy(np.array(a))
    return tdata.TrainingData(
        inputs=t(data.inputs), t=t(data.t),
        forcing=teq.ForcingParams(*(t(leaf) for leaf in data.forcing)),
        deriv_labels={d: t(v) for d, v in data.deriv_labels.items()},
        time_deriv_label=t(data.time_deriv_label), rollout=t(data.rollout),
        traj_ids=t(data.traj_ids))


@pytest.fixture(scope="module")
def inputs():
    return {"dp": _dataset(32, 0), "noise": _dataset(34, 2)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return worker.spawn("train", 4, inputs, tmp_path_factory.mktemp("train4"))


@pytest.fixture(scope="module")
def single(inputs):
    """The same cases in this one process, without a mesh."""
    out = {}
    for name, (config, dataset, _) in worker.train_cases(inputs).items():
        _, params, metrics = tloop.train(config, dataset=dataset(), device="cpu")
        out[name] = (params, metrics)
    return out


def _close(got, want, rtol, atol):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


CASES = ["dp", "noise", "curriculum", "trajectories_host", "trajectories_device",
         "space", "space_rel", "space4"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_training_matches_single_process(ranks, single, case):
    """4 ranks against one process: params to rtol 1e-4, atol 1e-5, and
    eval_total within 1e-3. ``noise`` draws rollout noise (0.1 of the rms)
    at the global batch's shape; ``curriculum`` grows the unroll 1 -> 2;
    the trajectory cases gather batches on the host or the device; the
    space cases run on (data=2, space=2), the rollout through the halo
    exchange (``space_rel`` with the relative error form and noise)."""
    params, metrics = ranks[0][case]
    want_params, want_metrics = single[case]
    _close(params, want_params, *PARAM_TOL)
    assert abs(metrics["eval_total"] - want_metrics["eval_total"]) < EVAL_TOL


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree_bitwise(ranks, case):
    """Every rank applies the same averaged update (JAX :497-499)."""
    for other in ranks[1:]:
        for k, v in ranks[0][case][0].items():
            assert torch.equal(other[case][0][k], v), (case, k)
        assert other[case][1] == ranks[0][case][1]


def test_host_staged_equals_device_resident_under_mesh(ranks):
    """The host-staged dataset composes with DP: params as the
    device-resident DP run's to rtol 1e-5, atol 1e-6, eval_total within
    1e-4 (JAX :193-229)."""
    host, dev = ranks[0]["trajectories_host"], ranks[0]["trajectories_device"]
    _close(host[0], dev[0], 1e-5, 1e-6)
    assert abs(host[1]["eval_total"] - dev[1]["eval_total"]) < 1e-4


def test_refusals(ranks):
    """A batch the data axis does not divide, and an eval split smaller than
    it (JAX :292-300, :498-502)."""
    assert "batch_size 6 must be divisible by the mesh data axis (4)" in ranks[0]["refused/batch"]
    assert "eval split smaller than the mesh data axis" in ranks[0]["refused/eval"]


def test_kernel_route_refused_with_space_axis(ranks):
    """``train(mesh=(2, 2), use_kernel=True)`` raises on every rank:
    ``fused_rhs`` needs the whole periodic grid, and the rollout on a block
    runs the halo-exchange RHS."""
    for r in ranks:
        assert "use_kernel=True needs the whole grid" in r["refused/kernel_space"]


def test_compute_loss_refuses_kernel_on_a_space_split():
    """The same refusal at ``compute_loss``, before any collective."""
    from types import SimpleNamespace

    from pde_superresolution_torch.training import losses

    with pytest.raises(ValueError, match="space=2"):
        losses.compute_loss(None, None, SimpleNamespace(inputs=None, t=None, forcing=None),
                            None, None, 0.1, 1, use_kernel=True,
                            shard=SimpleNamespace(n_space=2))


# -- the CLIs ----------------------------------------------------------------------

ENSEMBLE_ARGS = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", "16",
                 "--time_max", "0.05", "--warmup_time", "0.1", "--num_saves", "2",
                 "--device", "cpu"]
CLI_HPARAMS = ("equation=burgers,resample_factor=4,fine_size=64,num_trajectories=4,"
               "num_times=8,time_delta=0.1,num_layers=1,filters=4,stencil_size=4,"
               "num_time_steps=2,learning_rates=1e-3,learning_stops=3,batch_size=4,"
               "eval_interval=3,checkpoint_interval=3")


def _torchrun(args, tmp_path, timeout=worker.SPAWN_TIMEOUT_S):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=worker.REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", *args], env=env, cwd=tmp_path, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def ensembles(tmp_path_factory):
    """run_ensemble without the flag, in this process: {route: (args,
    result)}; "exported" serves a frozen artifact of the same checkpoint."""
    from pde_superresolution_torch import export

    model, params, config = convert.load_checkpoint("ckpt_burgers8", device="cpu")
    served = str(tmp_path_factory.mktemp("served") / "burgers8")
    export.export_and_save(model, params, served, num_steps=2, fine_size=config.fine_size,
                           resample_factor=config.resample_factor)
    exported = ["--exported_dir", served] + ENSEMBLE_ARGS[2:]
    routes = {"true": ENSEMBLE_ARGS + ["--fused", "true"],
              "false": ENSEMBLE_ARGS + ["--fused", "false"], "exported": exported}
    return {route: (args, run_ensemble.main(args)) for route, args in routes.items()}


@pytest.mark.parametrize("route", ["true", "false", "exported"])
def test_run_ensemble_under_torchrun(tmp_path, ensembles, route):
    """run_ensemble --data_parallel 2 under torchrun, by the fused route,
    rhs_fn steps and a frozen artifact's RHS (--exported_dir): the same
    members (start states bit for bit), and the gathered final state equals
    the run without the flag: bit for bit on the fused route (the kernel's
    plain version on each rank's 8 rows); by RHS steps to 2e-6 of max|u|,
    because PyTorch's CPU convolution rounds a batch of 16 rows differently
    from one of 8 (7.2e-7 read; see test_torch_parallel.TestServedDP). The
    path ends ", dp=2" and rank 0 alone prints."""
    args, want = ensembles[route]
    save = tmp_path / "out.pt"
    stdout = _torchrun([os.path.join(worker.REPO, "tests", "torch_parallel_worker.py"),
                        "ensemble", *args, "--data_parallel", "2", "--save", str(save)],
                       tmp_path)
    got = torch.load(save)
    assert got["path"].endswith(", dp=2")
    assert stdout.count("trajectories x") == 1  # rank 0 alone prints
    torch.testing.assert_close(got["initial"], want["initial"], rtol=0, atol=0)
    if route == "true":
        torch.testing.assert_close(got["final"], want["final"], rtol=0, atol=0)
    else:
        assert float((got["final"] - want["final"]).abs().max()) <= 2e-6 * float(
            want["final"].abs().max())


def test_run_ensemble_data_parallel_1_without_torchrun(ensembles):
    """--data_parallel 1 runs in this process on a group of its own, which
    it destroys; bit for bit the run without the flag."""
    got = run_ensemble.main(ENSEMBLE_ARGS + ["--fused", "true", "--data_parallel", "1"])
    assert not torch.distributed.is_initialized()
    assert got["path"].endswith(", dp=1")
    assert torch.equal(got["final"], ensembles["true"][1]["final"])


def test_run_ensemble_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="not divisible by data_parallel=3"):
        run_ensemble.main(ENSEMBLE_ARGS + ["--data_parallel", "3"])


def test_run_ensemble_output_path_under_torchrun(tmp_path, ensembles):
    """--output_path with --data_parallel 2: rank 0 writes the gathered
    global batch, and the file holds what a single process writes (the same
    attrs; the saves to 2e-6 of max|u|, the rhs_fn route's CPU rounding
    above)."""
    h5py = pytest.importorskip("h5py")
    single_path, dp_path = tmp_path / "single.h5", tmp_path / "dp.h5"
    single_run = run_ensemble.main(ENSEMBLE_ARGS + ["--output_path", str(single_path)])
    dp_args = ["-m", "pde_superresolution_torch.scripts.run_ensemble", *ENSEMBLE_ARGS,
               "--output_path", str(dp_path), "--data_parallel", "2"]
    _torchrun(dp_args, tmp_path)
    with h5py.File(single_path) as a, h5py.File(dp_path) as b:
        want, got = np.asarray(a["u"]), np.asarray(b["u"])
        assert dict(a.attrs) == dict(b.attrs)
        attrs = dict(b.attrs)
    assert got.shape == want.shape == (3, 16, 128)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    # cut after the first save (its carry and time as the integrator kept
    # them) and run again: every rank resumes from rank 0's carry, and the
    # store ends bit for bit as the uninterrupted one
    t = torch.as_tensor(attrs["t0"], dtype=torch.float32)
    for _ in range(single_run["save_every"]):
        t = t + attrs["dt"]
    with h5py.File(dp_path, "a") as f:
        f["carry_u"][...] = f["u"][1]
        f["u"][2] = 0.0
        f.attrs["next"] = 2
        f.attrs["carry_t"] = float(t)
    _torchrun(dp_args, tmp_path)
    with h5py.File(dp_path) as b:
        np.testing.assert_array_equal(np.asarray(b["u"]), got)
        assert dict(b.attrs) == attrs


def _checkpoint(path):
    return convert.params_from_jax(convert.jax_tree_from_npz(path / "3" / "model.npz"), "cpu")


def test_run_training_under_torchrun(tmp_path):
    """run_training --data_parallel 2 under torchrun: the checkpoint equals
    the single-process one to rtol 1e-4, atol 1e-5, and only rank 0 wrote
    (one metrics line per eval, one event file)."""
    run_training.main(["--checkpoint_dir", str(tmp_path / "single"), "--hparams",
                       CLI_HPARAMS, "--device", "cpu"])
    _torchrun(["-m", "pde_superresolution_torch.scripts.run_training", "--checkpoint_dir",
               str(tmp_path / "dp"), "--hparams", CLI_HPARAMS, "--device", "cpu",
               "--tensorboard_dir", str(tmp_path / "tb"), "--data_parallel", "2"], tmp_path)
    _close(_checkpoint(tmp_path / "dp"), _checkpoint(tmp_path / "single"), *PARAM_TOL)
    with open(tmp_path / "dp" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [3]
    assert len(list((tmp_path / "tb").iterdir())) == 1


def test_run_training_data_parallel_1_without_torchrun(tmp_path):
    """--data_parallel 1 without torchrun: bit for bit the run without it."""
    run_training.main(["--checkpoint_dir", str(tmp_path / "a"), "--hparams", CLI_HPARAMS,
                       "--device", "cpu"])
    run_training.main(["--checkpoint_dir", str(tmp_path / "b"), "--hparams", CLI_HPARAMS,
                       "--device", "cpu", "--data_parallel", "1"])
    assert not torch.distributed.is_initialized()
    a, b = _checkpoint(tmp_path / "a"), _checkpoint(tmp_path / "b")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_evaluation_has_no_data_parallel():
    """JAX's run_evaluation defines no --data_parallel; nor does the port's."""
    from pde_superresolution_torch.scripts import run_evaluation

    assert "--data_parallel" not in run_evaluation.build_parser()._option_string_actions
