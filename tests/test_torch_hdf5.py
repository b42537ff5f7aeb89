"""The port's HDF5 interchange against the JAX package's, on the CPU.

Snapshot files round-trip between the packages in both layouts, the
resumable integrator agrees with ``integrate`` bit for bit and with JAX's
within float32 tolerance (and either package resumes a store either one
cut short),
and the CLIs that read or write HDF5 (``create_training_data``,
``run_training --input_path``, ``run_ensemble --output_path``) agree with
what the JAX package's code does on the same numpy inputs.
"""

import dataclasses
import json

import h5py
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models.stencil_net import StencilModel as JModel
from pde_superresolution_tpu.training import config as jconfig
from pde_superresolution_tpu.training import data as jdata
from pde_superresolution_tpu.training import loop as jloop
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models.stencil_net import StencilModel as TModel
from pde_superresolution_torch.scripts import create_training_data, run_ensemble, run_training
from pde_superresolution_torch.training import data as tdata
from pde_superresolution_torch.training import loop as tloop

torch.set_num_threads(1)


def _same_equation(eq_t, eq_j):
    return (eq_t.name == eq_j.name and eq_t.conservative == eq_j.conservative
            and teq.params_dict(eq_t) == jeq.params_dict(eq_j))


def _jax_snapshots(name, physics, num_traj=2, num_times=5, fine_size=64):
    eq = jeq.from_name(name, conservative=True, **physics)
    fine = JGrid(fine_size, eq.period)
    return jdata.generate_snapshots(eq, fine, jax.random.PRNGKey(0), num_traj, num_times,
                                    0.05, ic_scale=0.5), eq, fine


CASES = [("burgers", {}), ("ks", {}), ("burgers", {"eta": 0.02, "forcing_k_max": 9})]


@pytest.mark.parametrize("name,physics", CASES)
def test_snapshots_written_by_jax_load_in_the_port(tmp_path, name, physics):
    """A JAX-written 3-D file: equal arrays (snapshots, times, forcing), the
    same equation (non-default physics included) and fine grid."""
    snaps, eq_j, fine_j = _jax_snapshots(name, physics)
    path = str(tmp_path / "jax.h5")
    jdata.save_snapshots_h5(path, snaps, eq_j, fine_j)
    got, eq_t, fine_t = tdata.load_snapshots_h5(path)
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(snaps.u))
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(snaps.times))
    assert (got.forcing is None) == (snaps.forcing is None)
    if snaps.forcing is not None:
        for a, b in zip(got.forcing, snaps.forcing):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got.synthetic_times
    assert _same_equation(eq_t, eq_j)
    assert (fine_t.size, fine_t.period) == (fine_j.size, fine_j.period)


@pytest.mark.parametrize("name,physics", CASES)
def test_snapshots_written_by_the_port_load_in_jax(tmp_path, name, physics):
    """The other way round, and the port's own round trip."""
    snaps_j, _, _ = _jax_snapshots(name, physics)
    eq = teq.from_name(name, conservative=True, **physics)
    fine = Grid(64, eq.period)
    snaps = tdata.Snapshots(
        u=torch.from_numpy(np.array(snaps_j.u)), times=torch.from_numpy(np.array(snaps_j.times)),
        forcing=None if snaps_j.forcing is None else teq.ForcingParams(
            *(torch.from_numpy(np.array(leaf)) for leaf in snaps_j.forcing)))
    path = str(tmp_path / "port.h5")
    tdata.save_snapshots_h5(path, snaps, eq, fine)
    got, eq_j, fine_j = jdata.load_snapshots_h5(path)
    np.testing.assert_array_equal(np.asarray(got.u), snaps.u.numpy())
    np.testing.assert_array_equal(np.asarray(got.times), snaps.times.numpy())
    if snaps.forcing is not None:
        for a, b in zip(got.forcing, snaps.forcing):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert _same_equation(eq, eq_j) and fine_j.size == 64
    again, eq_again, _ = tdata.load_snapshots_h5(path)
    assert torch.equal(again.u, snaps.u) and eq_again == eq


def _write_2d(path, samples=12, nx=16, count=None, times="flat", spacing=None):
    """A 2-D [samples, x] file as another tool would write it."""
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.create_dataset("v", data=rng.standard_normal((samples, nx)).astype(np.float32))
        if times == "flat":
            per = samples // (count or 1)
            t = np.tile(np.arange(per) * 0.1, count or 1)
            if spacing is not None:
                t = t * np.repeat(spacing, per)
            f.create_dataset("times", data=t.astype(np.float32))
        if count:
            f.attrs["num_trajectories"] = count
        f.attrs["equation"] = "ks"
        f.attrs["conservative"] = True
        f.attrs["period"] = 64.0
        f.attrs["fine_size"] = nx


def _both(path, **kwargs):
    """The port's and the JAX package's loads of one file."""
    return tdata.load_snapshots_h5(path, **kwargs), jdata.load_snapshots_h5(path, **kwargs)


@pytest.mark.parametrize("count,argument", [(3, None), (None, 4), (2, 2)])
def test_2d_layout_splits_like_jax(tmp_path, count, argument):
    """The 2-D layout with the count as an attr or an argument: both
    packages split it into the same trajectories and one time window."""
    path = str(tmp_path / "2d.h5")
    _write_2d(path, count=count or argument)
    (got, eq_t, _), (want, eq_j, _) = _both(path, num_trajectories=argument)
    k = count or argument
    assert got.u.shape == tuple(want.u.shape) == (k, 12 // k, 16)
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(want.u))
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    assert _same_equation(eq_t, eq_j)


def test_2d_layout_without_a_count_warns_and_is_one_trajectory(tmp_path):
    path = str(tmp_path / "2d.h5")
    _write_2d(path, count=None)
    with pytest.warns(UserWarning, match="ONE contiguous trajectory"):
        got, _, _ = tdata.load_snapshots_h5(path)
    with pytest.warns(UserWarning, match="ONE contiguous trajectory"):
        want, _, _ = jdata.load_snapshots_h5(path)
    assert got.u.shape == tuple(want.u.shape) == (1, 12, 16)


def test_2d_layout_refusals_and_warnings_match_jax(tmp_path):
    """A count that does not divide, flat times with differing spacings
    (refused) and differing start times (a warning): as in JAX."""
    path = str(tmp_path / "2d.h5")
    _write_2d(path, count=3)
    for load in (tdata.load_snapshots_h5, jdata.load_snapshots_h5):
        with pytest.raises(ValueError, match="does not divide"):
            load(path, num_trajectories=5)
    _write_2d(path, count=3, spacing=np.array([1.0, 2.0, 1.0]))
    for load in (tdata.load_snapshots_h5, jdata.load_snapshots_h5):
        with pytest.raises(ValueError, match="shared time"):
            load(path)
    with h5py.File(path, "a") as f:
        # consecutive segments of one run (exact in float32)
        t = np.tile(np.arange(4) * 0.25, 3) + np.repeat([0.0, 4.0, 8.0], 4)
        f["times"][...] = t.astype(np.float32)
    for load in (tdata.load_snapshots_h5, jdata.load_snapshots_h5):
        with pytest.warns(UserWarning, match="differing start times"):
            snaps, _, _ = load(path)
        np.testing.assert_array_equal(np.asarray(snaps.times), np.arange(4) * 0.25)


def test_missing_times_are_synthesized_and_refused_for_unrolling(tmp_path):
    """Without a times dataset: arange times, marked synthetic in both
    packages, and unrolled-loss labels refused."""
    path = str(tmp_path / "2d.h5")
    _write_2d(path, count=3, times=None)
    (got, eq, fine), (want, _, _) = _both(path)
    assert got.synthetic_times and want.synthetic_times
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    with pytest.raises(ValueError, match="synthesized times"):
        tdata.build_training_data(eq, fine, got, 2, unroll_steps=1)


# -- the resumable integrator ---------------------------------------------------------


def _baseline(nx=64):
    """The classic KS baseline in both packages, and a seeded state."""
    eq_j, eq_t = jeq.from_name("ks", conservative=True), teq.from_name("ks", conservative=True)
    grid_j, grid_t = JGrid(nx, eq_j.period), Grid(nx, eq_t.period)
    u0 = np.asarray(eq_j.initial_conditions(jax.random.PRNGKey(1), grid_j, (3,)))
    rhs_j = jint.PolynomialDifferentiator(eq_j, grid_j).rhs_fn()
    rhs_t = tint.PolynomialDifferentiator(eq_t, grid_t, device="cpu").rhs_fn()
    dt = 0.5 * eq_t.stable_time_step(grid_t)
    return rhs_j, rhs_t, u0, dt


class _Cut(Exception):
    pass


def _cut_after(monkeypatch, flushes):
    """Make ``h5py.File.flush`` raise after ``flushes`` calls: a run that
    dies after that many completed saves."""
    real, calls = h5py.File.flush, []

    def flush(self):
        real(self)
        calls.append(1)
        if len(calls) == flushes:
            raise _Cut

    monkeypatch.setattr(h5py.File, "flush", flush)


def test_resumable_equals_integrate_and_jax(tmp_path):
    """Bit for bit the port's integrate (times and trajectory); within 1e-5
    of max|u| of the JAX package's resumable run; the store holds JAX's
    layout."""
    rhs_j, rhs_t, u0, dt = _baseline()
    store = str(tmp_path / "port.h5")
    times, traj = tint.integrate_resumable(rhs_t, torch.from_numpy(u0), dt, 12, 3, store, t0=0.5)
    want_times, want = tint.integrate(rhs_t, torch.from_numpy(u0), dt, 12, 3, t0=0.5)
    assert torch.equal(traj, want) and torch.equal(times, want_times)
    _, jtraj = jint.integrate_resumable(rhs_j, jnp.asarray(u0), dt, 12, 3,
                                        str(tmp_path / "jax.h5"), t0=0.5)
    jtraj = np.asarray(jtraj)
    assert np.abs(traj.numpy() - jtraj).max() <= 1e-5 * np.abs(jtraj).max()
    with h5py.File(store, "r") as f, h5py.File(tmp_path / "jax.h5", "r") as g:
        assert sorted(f) == sorted(g) == ["carry_u", "u"]
        assert sorted(f.attrs) == sorted(g.attrs)
        assert int(f.attrs["next"]) == int(g.attrs["next"]) == 5
        assert f.attrs["method"] == g.attrs["method"] == "rk4"


@pytest.mark.parametrize("writer,resumer", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_resume_after_a_cut(tmp_path, monkeypatch, writer, resumer):
    """A run cut after two completed saves by one package is resumed by the
    same or the other one: the saves already written stay as they are; the
    port resuming its own store equals an uninterrupted run bit for bit,
    and across the packages the result is within 1e-5 of max|u| of it."""
    rhs_j, rhs_t, u0, dt = _baseline()
    store = str(tmp_path / "cut.h5")
    run = {"port": lambda: tint.integrate_resumable(rhs_t, torch.from_numpy(u0), dt, 12, 3,
                                                    store, t0=0.5),
           "jax": lambda: jint.integrate_resumable(rhs_j, jnp.asarray(u0), dt, 12, 3, store,
                                                   t0=0.5)}
    _cut_after(monkeypatch, 2)
    with pytest.raises(_Cut):
        run[writer]()
    monkeypatch.undo()
    with h5py.File(store, "r") as f:
        assert int(f.attrs["next"]) == 3
        written = f["u"][:3]
    traj = np.asarray(run[resumer]()[1])
    _, want = tint.integrate(rhs_t, torch.from_numpy(u0), dt, 12, 3, t0=0.5)
    want = want.numpy()
    np.testing.assert_array_equal(traj[:3], written)
    if writer == resumer == "port":
        np.testing.assert_array_equal(traj, want)
    else:
        assert np.abs(traj - want).max() <= 1e-5 * np.abs(want).max()


def test_resume_guards(tmp_path):
    """A store written with another dt, t0, method or shape is refused."""
    _, rhs_t, u0, dt = _baseline()
    store = str(tmp_path / "s.h5")
    u = torch.from_numpy(u0)
    tint.integrate_resumable(rhs_t, u, dt, 6, 3, store)
    for kwargs, match in (({"dt": 2 * dt}, "dt="), ({"t0": 1.0}, "t0="),
                          ({"method": "rk3_ssp"}, "method="), ({"num_steps": 9}, "shape")):
        call = dict(dt=dt, num_steps=6, t0=0.0, method="rk4") | kwargs
        with pytest.raises(ValueError, match=match):
            tint.integrate_resumable(rhs_t, u, call["dt"], call["num_steps"], 3, store,
                                     t0=call["t0"], method=call["method"])
    with pytest.raises(ValueError, match="divisible"):
        tint.integrate_resumable(rhs_t, u, dt, 7, 3, str(tmp_path / "t.h5"))


# -- the CLIs -------------------------------------------------------------------------


@pytest.fixture
def inject(monkeypatch):
    """Both packages' samplers return these numpy members, whatever key or
    generator they are given (as ``tests/test_torch_evaluate.py`` does)."""

    def apply(u0, forcing):
        jf = None if forcing is None else jeq.ForcingParams(*(jnp.asarray(a) for a in forcing))
        monkeypatch.setattr(jeq.Equation, "initial_conditions",
                            lambda self, key, grid, batch_shape=(): jnp.asarray(u0))
        monkeypatch.setattr(jeq.Equation, "sample_forcing",
                            lambda self, key, batch_shape=(): jf if self.forced else None)
        monkeypatch.setattr(
            teq.Equation, "initial_conditions",
            lambda self, generator, grid, batch_shape=(), device=None:
                torch.from_numpy(u0).to(device))
        monkeypatch.setattr(
            teq.Equation, "sample_forcing",
            lambda self, generator, batch_shape=(), device=None: (
                teq.ForcingParams(*(torch.from_numpy(a).to(device) for a in forcing))
                if self.forced and forcing is not None else None))

    return apply


def test_create_training_data_matches_jax(tmp_path, inject):
    """The same numpy members through the port's create_training_data and
    through what the JAX script does (generate_snapshots +
    save_snapshots_h5): times within 1e-6, snapshots within 1e-5 of max|u|
    (both ETDRK4 in complex64, as in ``tests/test_torch_training_data.py``),
    forcing and attrs equal."""
    eq_j = jeq.from_name("burgers", conservative=True)
    fine_j = JGrid(128, eq_j.period)
    u0 = np.asarray(eq_j.initial_conditions(jax.random.PRNGKey(1), fine_j, (2,)))
    forcing = [np.asarray(leaf) for leaf in eq_j.sample_forcing(jax.random.PRNGKey(3), (2,))]
    inject(u0, forcing)
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    snaps = jdata.generate_snapshots(eq_j, fine_j, jax.random.PRNGKey(0), 2, 4, 0.05,
                                     warmup_time=0.1)
    jdata.save_snapshots_h5(jpath, snaps, eq_j, fine_j)
    out = create_training_data.main([
        "--output_path", tpath, "--equation", "burgers", "--fine_size", "128",
        "--num_trajectories", "2", "--num_times", "4", "--time_delta", "0.05",
        "--warmup_time", "0.1", "--device", "cpu"])
    assert out["shape"] == (2, 4, 128)
    with h5py.File(tpath, "r") as f, h5py.File(jpath, "r") as g:
        assert sorted(f) == sorted(g) and dict(f.attrs) == dict(g.attrs)
        np.testing.assert_allclose(f["times"][...], g["times"][...], rtol=1e-6)
        want = g["v"][...]
        assert np.abs(f["v"][...] - want).max() <= 1e-5 * np.abs(want).max()
        for name in g["forcing"]:
            np.testing.assert_array_equal(f["forcing"][name][...], g["forcing"][name][...])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


HPARAMS = ("resample_factor=4,num_layers=2,filters=8,stencil_size=4,num_time_steps=2,"
           "learning_rates=1e-3,learning_stops=2,batch_size=8,eval_interval=1,"
           "checkpoint_interval=2")


def test_run_training_input_path_matches_jax(tmp_path, monkeypatch):
    """run_training --input_path on a JAX-written file: the file's equation,
    fine grid and spacing replace the config's, as in JAX, and the metrics
    of the first steps equal the JAX package's training on the same file
    from the same initial parameters within 1e-4 relative (the tolerance of
    ``tests/test_torch_train_loop.py``)."""
    eq = jeq.from_name("burgers", conservative=True)
    fine = JGrid(64, eq.period)
    snaps = jdata.generate_snapshots(eq, fine, jax.random.PRNGKey(0), num_trajectories=3,
                                     num_times=12, time_delta=0.1)
    path = str(tmp_path / "snaps.h5")
    jdata.save_snapshots_h5(path, snaps, eq, fine)

    # what the JAX script does with --input_path
    config = jconfig.parse_hparams(HPARAMS.replace("stencil_size", "equation=ks,stencil_size"))
    loaded, eq_j, fine_j = jdata.load_snapshots_h5(path)
    config = dataclasses.replace(
        config, equation=eq_j.name, equation_params=jeq.params_dict(eq_j),
        conservative=eq_j.conservative, fine_size=fine_j.size,
        time_delta=float(loaded.times[1] - loaded.times[0]))
    coarse = fine_j.resample(config.resample_factor, conservative=config.conservative)
    tree = jax.tree.map(np.asarray, JModel(eq_j, coarse, config.model).init_params(
        jax.random.PRNGKey(config.seed)))
    dataset = jdata.build_training_data(eq_j, fine_j, loaded, config.resample_factor,
                                        unroll_steps=config.num_time_steps)
    jloop.train(config, dataset=dataset, metrics_path=str(tmp_path / "jax.jsonl"))

    monkeypatch.setattr(TModel, "init_params",
                        lambda self, generator: convert.params_from_jax(tree, self.device))
    run_training.main(["--input_path", path, "--checkpoint_dir", str(tmp_path / "ckpt"),
                       "--hparams", HPARAMS.replace("stencil_size", "equation=ks,stencil_size"),
                       "--device", "cpu"])
    _, _, written = tloop.load_model(str(tmp_path / "ckpt"), device="cpu")
    assert (written.equation, written.fine_size) == ("burgers", 64)
    assert written.time_delta == pytest.approx(0.1)
    want, got = _records(tmp_path / "jax.jsonl"), _records(tmp_path / "ckpt" / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        for key in w:
            if key.startswith(("train_", "eval_")):
                assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]) + 1e-7, (g["step"], key)


def test_run_training_refuses_large_ensemble_with_input_path(tmp_path):
    with pytest.raises(SystemExit):
        run_training.main(["--input_path", "x.h5", "--large_ensemble", "--checkpoint_dir",
                           str(tmp_path), "--device", "cpu"])


ENSEMBLE = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", "8", "--time_max",
            "0.05", "--warmup_time", "0.1", "--num_saves", "2", "--device", "cpu"]


def test_run_ensemble_output_path_is_resumable(tmp_path, monkeypatch, capsys):
    """--output_path takes the resumable rhs_fn route (--fused auto says
    so), writes every save, equals the --fused false run bit for bit, and a
    run cut after its first save resumes to the same result."""
    store = tmp_path / "ens.h5"
    got = run_ensemble.main([*ENSEMBLE, "--output_path", str(store)])
    assert got["path"] == "resumable rhs_fn steps"
    assert "route: resumable rhs_fn steps (auto: --output_path" in capsys.readouterr().out
    want = run_ensemble.main([*ENSEMBLE, "--fused", "false"])
    assert torch.equal(got["final"], want["final"])
    with h5py.File(store, "r") as f:
        assert f["u"].shape == (3, 8, 128) and int(f.attrs["next"]) == 3
        np.testing.assert_array_equal(f["u"][-1], want["final"].numpy())
    cut = tmp_path / "cut.h5"
    _cut_after(monkeypatch, 1)
    with pytest.raises(_Cut):
        run_ensemble.main([*ENSEMBLE, "--output_path", str(cut)])
    monkeypatch.undo()
    resumed = run_ensemble.main([*ENSEMBLE, "--output_path", str(cut)])
    assert torch.equal(resumed["final"], want["final"])


def test_run_ensemble_output_path_refuses_fused_true(tmp_path):
    with pytest.raises(ValueError, match="conflicts with --output_path"):
        run_ensemble.main([*ENSEMBLE, "--fused", "true", "--output_path",
                           str(tmp_path / "e.h5")])
