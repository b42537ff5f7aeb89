"""The port's serving export against the live model and the JAX package's.

A frozen ``torch.export`` artifact is held bit for bit against the live
model's plain route (the route it traces) on the CPU, and against the JAX
package's artifact of the same parameters on the same numpy inputs. The
cases are those of ``tests/test_export.py``; its ``TestParallel`` is
``tests/test_torch_parallel.py::TestServedDP``. Also: the constant cache is never filled
while tracing, the metadata matches JAX's, and both CLIs serve an artifact.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import export as jexport
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models import StencilModel as JModel
from pde_superresolution_tpu.training import loop as jloop
from pde_superresolution_torch import convert, export, integrate
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import ModelConfig, StencilModel
from pde_superresolution_torch.scripts import run_ensemble, run_evaluation, run_export

torch.set_num_threads(1)

BATCHES = [(1,), (3,), (8,)]


def _make_model(name, conservative=True, nx=128):
    """The same seeded non-zero parameters (so the learned path is exercised,
    not c0) for the port's model and for the JAX package's: (port model,
    port params, JAX model, JAX params)."""
    config = dict(num_layers=2, filters=8, stencil_size=6)
    eq_j = jeq.from_name(name, conservative=conservative)
    model_j = JModel(eq_j, JGrid(nx, eq_j.period), JConfig(**config))
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda leaf: (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32),
                        model_j.init_params(jax.random.PRNGKey(0)))
    eq = teq.from_name(name, conservative=conservative)
    model = StencilModel(eq, Grid(nx, eq.period), ModelConfig(**config), device="cpu")
    return model, convert.params_from_jax(tree, device="cpu"), model_j, tree


def _members(model, batch, seed=1):
    return model.equation.initial_conditions(torch.Generator().manual_seed(seed), model.grid,
                                             batch, "cpu")


def _forcing(model, batch, seed=3):
    return model.equation.sample_forcing(torch.Generator().manual_seed(seed), batch, "cpu")


@pytest.fixture(scope="module")
def ks_artifact(tmp_path_factory):
    model, params, model_j, tree = _make_model("ks")
    path = str(tmp_path_factory.mktemp("export") / "ks")
    meta = export.export_and_save(model, params, path, num_steps=4)
    return model, params, path, meta, model_j, tree, export.load_served_model(path, device="cpu")


@pytest.fixture(scope="module")
def burgers_artifact(tmp_path_factory):
    model, params, model_j, tree = _make_model("burgers")
    path = str(tmp_path_factory.mktemp("export") / "burgers")
    meta = export.export_and_save(model, params, path, num_steps=2)
    return model, params, path, meta, model_j, tree, export.load_served_model(path, device="cpu")


class TestRoundTrip:
    @pytest.mark.parametrize("batch", BATCHES)
    def test_rhs_matches_live_model(self, ks_artifact, batch):
        """Bit for bit the live plain route: the graph holds its ops."""
        model, params, *_, served = ks_artifact
        u = _members(model, batch)
        live = model.rhs_fn(params, use_kernel=False)(u, torch.tensor(0.3))
        assert torch.equal(served.rhs_fn()(u, 0.3), live)

    def test_symbolic_batch_serves_any_ensemble_size(self, ks_artifact):
        model, *_, served = ks_artifact
        rhs = served.rhs_fn()
        for batch in [(1,), (3,), (2, 5)]:
            u = _members(model, batch)
            assert rhs(u, 0.0).shape == u.shape
        # 1-D input round-trips through the symbolic batch dim
        u1 = _members(model, ())
        assert rhs(u1, 0.0).shape == u1.shape

    @pytest.mark.parametrize("batch", BATCHES)
    def test_step_artifact_matches_integrate(self, ks_artifact, batch):
        """The unrolled advance equals ``integrate`` of the plain route bit
        for bit, time carried the same way."""
        model, params, _, meta, _, _, served = ks_artifact
        u = _members(model, batch)
        _, traj = integrate.integrate(model.rhs_fn(params, use_kernel=False), u, meta["dt"],
                                      meta["num_steps"], save_every=meta["num_steps"], t0=0.3)
        got, t_next = served.advance(u, 0.3)
        assert torch.equal(got, traj[-1])
        assert t_next == pytest.approx(0.3 + meta["dt"] * meta["num_steps"])

    def test_plugs_into_integrate(self, ks_artifact):
        """A served model is a drop-in RHS for the library integrator."""
        model, _, _, meta, _, _, served = ks_artifact
        _, traj = integrate.integrate(served.rhs_fn(), _members(model, (2,)), meta["dt"], 8)
        assert bool(torch.isfinite(traj).all())
        assert served.rhs_fn().conservative == model.equation.conservative

    def test_rhs_and_advance_match_jax(self, ks_artifact, tmp_path):
        """The port's artifact against the JAX package's artifact of the same
        parameters, on the same numpy members: the RHS within 1e-4 of its
        maximum, the tolerance of ``tests/test_torch_model.py`` (the float32
        RHS of either package sits 2e-5 of max|u_t| from its float64
        evaluation), and the 4-step advance within 1e-5 of max|u|."""
        model, _, _, meta, model_j, tree, served = ks_artifact
        jpath = str(tmp_path / "jax")
        jexport.export_and_save(model_j, tree, jpath, num_steps=4, platforms=("cpu",))
        jserved = jexport.load_served_model(jpath)
        u = _members(model, (5,)).numpy()
        want = np.asarray(jserved.rhs_fn()(jnp.asarray(u), 0.3))
        got = served.rhs_fn()(torch.from_numpy(u), 0.3).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        want_u, want_t = jserved.advance(jnp.asarray(u), 0.3)
        got_u, got_t = served.advance(torch.from_numpy(u), 0.3)
        want_u = np.asarray(want_u)
        assert np.abs(got_u.numpy() - want_u).max() <= 1e-5 * np.abs(want_u).max()
        assert got_t == pytest.approx(float(want_t))


class TestForced:
    @pytest.mark.parametrize("batch", BATCHES)
    def test_forcing_is_a_call_argument(self, burgers_artifact, batch):
        """One artifact serves arbitrary forcing draws, bit for bit the live
        plain route, RHS and advance."""
        model, params, _, meta, _, _, served = burgers_artifact
        u = _members(model, batch)
        for seed in [3, 4]:
            f = _forcing(model, batch, seed)
            live = model.rhs_fn(params, f, use_kernel=False)
            assert torch.equal(served.rhs_fn(f)(u, 0.7), live(u, torch.tensor(0.7)))
            _, traj = integrate.integrate(live, u, meta["dt"], meta["num_steps"],
                                          save_every=meta["num_steps"], t0=0.7)
            assert torch.equal(served.advance(u, 0.7, f)[0], traj[-1])

    def test_rhs_matches_jax(self, burgers_artifact, tmp_path):
        """Forced: the port's artifact against JAX's on the same numpy members
        and forcing, within 1e-4 of the maximum (as above)."""
        model, _, _, _, model_j, tree, served = burgers_artifact
        jpath = str(tmp_path / "jax")
        jexport.export_and_save(model_j, tree, jpath, platforms=("cpu",))
        u = _members(model, (3,)).numpy()
        f = [leaf.numpy() for leaf in _forcing(model, (3,))]
        want = np.asarray(jexport.load_served_model(jpath).rhs_fn(
            jeq.ForcingParams(*map(jnp.asarray, f)))(jnp.asarray(u), 0.7))
        got = served.rhs_fn(
            teq.ForcingParams(*map(torch.from_numpy, f)))(torch.from_numpy(u), 0.7).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    def test_unbatched_forcing_broadcasts(self, burgers_artifact):
        model, params, *_, served = burgers_artifact
        u = _members(model, (3,))
        f = _forcing(model, ())  # [terms]
        live = model.rhs_fn(params, f, use_kernel=False)(u, torch.tensor(0.0))
        torch.testing.assert_close(served.rhs_fn(f)(u, 0.0), live, rtol=0, atol=2e-4)

    def test_forcing_required_and_rejected(self, burgers_artifact, ks_artifact):
        model, *_, served = burgers_artifact
        with pytest.raises(ValueError, match="requires forcing"):
            served.rhs_fn()(_members(model, (3,)), 0.0)
        ks_model, *_, ks_served = ks_artifact
        with pytest.raises(ValueError, match="does not take forcing"):
            ks_served.rhs_fn(_forcing(model, (3,)))(_members(ks_model, (3,)), 0.0)
        f = _forcing(model, (3,))
        with pytest.raises(ValueError, match="terms"):
            served.rhs_fn(teq.ForcingParams(*(leaf[:, :5] for leaf in f)))(
                _members(model, (3,)), 0.0)


class TestScienceContext:
    def test_reconstructs_conservative_grid_origin(self, ks_artifact):
        meta = dict(ks_artifact[-1].meta, fine_size=512, resample_factor=4, nx=128)
        equation, fine, coarse = export.science_context(meta)
        assert coarse.size == 128
        expected = fine.resample(4, conservative=True)
        assert coarse.origin == expected.origin != 0.0
        assert equation.conservative

    def test_inconsistent_metadata_raises(self, ks_artifact):
        meta = dict(ks_artifact[-1].meta, fine_size=512, resample_factor=8, nx=128)
        with pytest.raises(ValueError, match="inconsistent"):
            export.science_context(meta)

    def test_missing_science_keys_raise_clearly(self, ks_artifact):
        served = ks_artifact[-1]
        assert served.meta["fine_size"] is None
        with pytest.raises(ValueError, match="fine_size/resample_factor"):
            export.science_context(served.meta)

    def test_export_owns_equation_params(self, tmp_path):
        """A non-default-physics model's artifact rebuilds the same physics,
        also after the JSON round trip on disk."""
        eq = teq.from_name("burgers", conservative=True, eta=0.02, forcing_k_max=9)
        model = StencilModel(eq, Grid(64, eq.period),
                             ModelConfig(num_layers=2, filters=8, stencil_size=6), device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        meta = export.export_and_save(model, params, str(tmp_path / "eta"), num_steps=0,
                                      fine_size=256, resample_factor=4)
        assert meta["equation_params"]["eta"] == 0.02
        rebuilt, _, _ = export.science_context(meta)
        assert rebuilt.eta == 0.02 and rebuilt.forcing_k_max == 9 and rebuilt.conservative
        served = export.load_served_model(str(tmp_path / "eta"), device="cpu")
        assert export.science_context(served.meta)[0] == eq

    def test_export_model_science_kwargs_land_in_meta(self, tmp_path):
        model, params, *_ = _make_model("ks")
        meta = export.export_and_save(model, params, str(tmp_path / "sci"), num_steps=0,
                                      fine_size=model.grid.size * 4, resample_factor=4)
        assert meta["fine_size"] == model.grid.size * 4
        assert meta["resample_factor"] == 4
        assert meta["stencil_size"] == model.config.stencil_size
        assert export.science_context(meta)[2].size == model.grid.size

    def test_export_records_model_stable_dt(self, tmp_path):
        """The artifact carries the model-aware stable step, tighter than
        the equation's bound for a wide stencil."""
        eq = teq.from_name("ks", conservative=True)
        grid = Grid(256, eq.period).resample(2, conservative=True)  # dx=.5
        model = StencilModel(eq, grid, ModelConfig(num_layers=1, filters=4, stencil_size=12),
                             device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        meta = export.export_and_save(model, params, str(tmp_path / "wide"), num_steps=0,
                                      fine_size=256, resample_factor=2)
        assert meta["stable_dt"] == model.stable_time_step(u_scale=3.0)
        assert meta["stable_dt"] < eq.stable_time_step(grid, u_scale=3.0)

    @pytest.mark.parametrize("asset", ["ckpt_ks8", "ckpt_burgers8"])
    def test_jax_written_meta_gives_jax_grids(self, asset):
        """science_context on a meta.json the JAX package wrote: the same
        equation and both grids (the conservative half-cell origin
        included) as JAX's own science_context."""
        model_j, tree, config = jloop.load_model(os.path.join("artifacts", asset))
        meta, _ = jexport.export_model(model_j, tree, platforms=("cpu",),
                                       fine_size=config.fine_size,
                                       resample_factor=config.resample_factor)
        meta = json.loads(json.dumps(meta))  # as read from disk
        eq_j, fine_j, coarse_j = jexport.science_context(meta)
        eq, fine, coarse = export.science_context(meta)
        assert eq == teq.from_name(eq_j.name, conservative=eq_j.conservative,
                                   **jeq.params_dict(eq_j))
        for got, want in ((fine, fine_j), (coarse, coarse_j)):
            assert (got.size, got.period, got.origin) == (want.size, want.period, want.origin)


class TestValidation:
    def test_wrong_grid_size_raises(self, ks_artifact):
        served = ks_artifact[-1]
        with pytest.raises(ValueError, match="grid points"):
            served.rhs_fn()(torch.zeros(2, 64), 0.0)

    def test_missing_step_artifact_raises(self, tmp_path):
        model, params, *_ = _make_model("ks")
        path = str(tmp_path / "nostep")
        export.export_and_save(model, params, path, num_steps=0)
        served = export.load_served_model(path, device="cpu")
        with pytest.raises(ValueError, match="without a step function"):
            served.advance(torch.zeros(2, model.grid.size), 0.0)

    def test_newer_format_version_refused(self, tmp_path, ks_artifact):
        _, _, path, *_ = ks_artifact
        clone = str(tmp_path / "future")
        shutil.copytree(path, clone)
        meta_path = os.path.join(clone, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["format_version"] = export.FORMAT_VERSION + 1
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(ValueError, match="newer"):
            export.load_served_model(clone, device="cpu")

    def test_artifact_declares_cuda(self, ks_artifact):
        """The artifact is traced on the CPU and declares CUDA too: the
        loader moves it to the card (``move_to_device_pass``)."""
        meta, served = ks_artifact[3], ks_artifact[-1]
        assert meta["platforms"] == served.meta["platforms"] == ["cpu", "cuda"]

    def test_a_program_left_on_another_device_is_refused(self, ks_artifact, monkeypatch):
        """The loader checks every tensor and device argument of the moved
        graph: a pass that leaves one behind raises rather than running
        part of the graph elsewhere."""
        _, _, path, *_ = ks_artifact
        monkeypatch.setattr(export, "_devices_in", lambda node: [torch.device("meta")])
        with pytest.raises(RuntimeError, match="not moved to cpu"):
            export.load_served_model(path, device="cpu")

    def test_default_device_is_cuda(self, ks_artifact):
        """Like every entry point, the loader runs on cuda unless asked for
        the CPU; without a card that is an error, not a silent CPU run."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        _, _, path, *_ = ks_artifact
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.load_served_model(path)


# -- the constant cache and tracing ---------------------------------------------------


class _Direct(torch.nn.Module):
    """Traces a live model itself, as a caller of ``torch.export`` may."""

    def __init__(self, model, params):
        super().__init__()
        self.model, self.params = model, params

    def forward(self, u, t):
        return self.model.time_derivative(self.params, u, t)


@pytest.mark.parametrize("how", ["torch.export of the live model", "export_model"])
def test_live_model_after_export_equals_a_fresh_one(how):
    """A model whose first forward pass is traced still works eagerly
    afterwards, bit for bit a model that was never exported: the constant
    cache (``stencils._ConstantCache``) stores no tensor made while
    tracing."""
    model, params, *_ = _make_model("ks")
    fresh = StencilModel(model.equation, model.grid, model.config, device="cpu")
    u = _members(model, (3,))
    if how == "export_model":
        export.export_model(model, params)
    else:
        torch.export.export(_Direct(model, params), (u, torch.tensor(0.0)), strict=False)
    for layer in model.constraint_layers.values():
        assert all(type(v) is torch.Tensor for v in layer._cache._tensors.values())
    assert torch.equal(model.time_derivative(params, u, 0.0),
                       fresh.time_derivative(params, u, 0.0))


# -- metadata and the CLIs ---------------------------------------------------------------


def test_meta_matches_jax_for_the_same_checkpoint(tmp_path):
    """run_export's meta.json and the JAX package's for the same checkpoint
    (the committed KS-8x asset and the JAX checkpoint it was converted from)
    agree on every key but ``platforms`` and the provenance
    (``checkpoint_dir``): the same step, physics and geometry."""
    out = run_export.main(["--checkpoint_dir", "ckpt_ks8", "--output_dir",
                           str(tmp_path / "port"), "--num_steps", "2", "--device", "cpu"])
    assert out["max_abs_err"] == 0.0  # the plain route against itself on the CPU
    model_j, tree, config = jloop.load_model("artifacts/ckpt_ks8")
    want = jexport.export_and_save(
        model_j, tree, str(tmp_path / "jax"), num_steps=2, platforms=("cpu", "tpu"),
        fine_size=config.fine_size, resample_factor=config.resample_factor,
        extra_meta={"checkpoint_dir": "artifacts/ckpt_ks8",
                    "training_equation_params": config.equation_params})
    with open(tmp_path / "port" / "meta.json") as f:
        got = json.load(f)
    want = json.loads(json.dumps(want))
    assert sorted(got) == sorted(want)
    for key in want:
        if key not in ("platforms", "checkpoint_dir"):
            assert got[key] == want[key], key
    assert got["platforms"] == ["cpu", "cuda"] and got["checkpoint_dir"] == "ckpt_ks8"
    assert got["num_steps"] == 2 and got["dt"] == got["stable_dt"]


@pytest.fixture(scope="module")
def burgers8_export(tmp_path_factory):
    """The Burgers-8x asset exported through run_export (RHS only)."""
    path = str(tmp_path_factory.mktemp("cli") / "burgers8")
    run_export.main(["--checkpoint_dir", "ckpt_burgers8", "--output_dir", path,
                     "--num_steps", "0", "--device", "cpu"])
    return path


ENSEMBLE = ["--num_trajectories", "8", "--time_max", "0.05", "--warmup_time", "0.1",
            "--num_saves", "2", "--device", "cpu"]


def test_run_ensemble_serves_the_artifact_like_the_checkpoint(burgers8_export, capsys):
    """--exported_dir integrates the frozen RHS: bit for bit the checkpoint's
    --fused false run on the CPU (same members, same dt), and says so."""
    got = run_ensemble.main(["--exported_dir", burgers8_export, *ENSEMBLE])
    want = run_ensemble.main(["--checkpoint_dir", "ckpt_burgers8", "--fused", "false",
                              *ENSEMBLE])
    assert got["path"] == "frozen artifact, rhs_fn steps"
    assert "route: frozen artifact, rhs_fn steps (auto:" in capsys.readouterr().out
    assert got["dt"] == want["dt"] and got["t0"] == want["t0"]
    assert torch.equal(got["final"], want["final"])


def test_run_ensemble_exported_refusals(burgers8_export):
    with pytest.raises(ValueError, match="live model parameters"):
        run_ensemble.main(["--exported_dir", burgers8_export, "--fused", "true", *ENSEMBLE])
    with pytest.raises(ValueError, match="domain_factor"):
        run_ensemble.main(["--exported_dir", burgers8_export, "--domain_factor", "2",
                           *ENSEMBLE])
    for sources in ([], ["--exported_dir", burgers8_export, "--checkpoint_dir",
                         "ckpt_burgers8"]):
        with pytest.raises(SystemExit):
            run_ensemble.main([*sources, *ENSEMBLE])


def test_run_ensemble_exported_dt_from_meta(burgers8_export, tmp_path):
    """dt comes from meta["stable_dt"], the equation's bound where it is
    absent, and a value that is not positive is refused."""
    clone = tmp_path / "clone"
    shutil.copytree(burgers8_export, clone)
    with open(clone / "meta.json") as f:
        meta = json.load(f)
    for value, expect in ((None, "bound"), (0.0, "refused"), (0.5 * meta["stable_dt"], "meta")):
        changed = dict(meta)
        if value is None:
            del changed["stable_dt"]
        else:
            changed["stable_dt"] = value
        with open(clone / "meta.json", "w") as f:
            json.dump(changed, f)
        args = ["--exported_dir", str(clone), *ENSEMBLE]
        if expect == "refused":
            with pytest.raises(ValueError, match="stable_dt"):
                run_ensemble.main(args)
            continue
        equation, _, coarse = export.science_context(changed)
        want = (equation.stable_time_step(coarse, u_scale=3.0) if expect == "bound"
                else value)
        assert run_ensemble.main(args)["dt"] == want


def test_run_evaluation_serves_the_artifact_like_the_checkpoint(burgers8_export):
    """--exported_dir: the frozen RHS as the model leg, science_context's
    grids and the same coarse step: bit for bit the checkpoint's evaluation
    on the CPU, every scheme."""
    flags = ["--output_path", "unused.h5", "--num_samples", "2", "--time_max", "0.3",
             "--reference_cache_dir", "", "--device", "cpu"]
    parser = run_evaluation.build_parser()
    got = run_evaluation.evaluate_checkpoint(
        parser.parse_args(["--exported_dir", burgers8_export, *flags]))["results"][0]
    want = run_evaluation.evaluate_checkpoint(
        parser.parse_args(["--checkpoint_dir", "ckpt_burgers8", *flags]))["results"][0]
    assert torch.equal(got.times, want.times) and torch.equal(got.exact, want.exact)
    assert sorted(got.trajectories) == sorted(want.trajectories) == ["baseline", "model", "weno"]
    for name in want.trajectories:
        assert torch.equal(got.trajectories[name], want.trajectories[name]), name
        assert torch.equal(got.survival_time[name], want.survival_time[name]), name


def test_run_evaluation_exported_refusals(burgers8_export, tmp_path):
    flags = ["--output_path", str(tmp_path / "e.h5"), "--device", "cpu"]
    for args in (flags, ["--exported_dir", burgers8_export, "--checkpoint_dir",
                         "ckpt_burgers8", *flags],
                 ["--exported_dir", burgers8_export, "--domain_factor", "2", *flags]):
        with pytest.raises(SystemExit):
            run_evaluation.main(args)


class _Stop(Exception):
    pass


def test_run_evaluation_coarse_dt_from_meta(burgers8_export, tmp_path, monkeypatch):
    """An artifact's stable_dt sets the coarse step only where it is tighter
    than the equation's bound."""
    clone = tmp_path / "clone"
    shutil.copytree(burgers8_export, clone)
    with open(clone / "meta.json") as f:
        meta = json.load(f)
    equation, _, coarse = export.science_context(meta)
    bound = equation.stable_time_step(coarse, u_scale=3.0)
    seen = []

    def evaluate(*args, **kwargs):  # records the step and stops the run
        seen.append(kwargs["coarse_dt"])
        raise _Stop

    monkeypatch.setattr(run_evaluation.eval_lib, "evaluate", evaluate)
    for value, want in ((0.5 * bound, 0.5 * bound), (2 * bound, None)):
        with open(clone / "meta.json", "w") as f:
            json.dump(dict(meta, stable_dt=value), f)
        with pytest.raises(_Stop):
            run_evaluation.evaluate_checkpoint(run_evaluation.build_parser().parse_args(
                ["--exported_dir", str(clone), "--output_path", "x.h5", "--device", "cpu"]))
        assert seen[-1] == want


def test_run_export_check_fails_on_a_wrong_artifact(tmp_path, monkeypatch):
    """run_export's own check has power: a frozen RHS off by 1e-4 of itself
    (ten times its limit) raises."""
    real = export.ServedModel.rhs_fn

    def off(self, forcing=None):
        rhs = real(self, forcing)
        return lambda u, t: rhs(u, t) * (1 + 1e-4)

    monkeypatch.setattr(export.ServedModel, "rhs_fn", off)
    with pytest.raises(RuntimeError, match="disagrees with live model"):
        run_export.main(["--checkpoint_dir", "ckpt_burgers8", "--output_dir",
                         str(tmp_path / "x"), "--num_steps", "0", "--device", "cpu"])


# -- the platforms an artifact may be served on (JAX's lowering targets) ----------------


def test_platforms_round_trip_cpu_only(tmp_path):
    """``export_model(platforms=("cpu",))`` records the list in meta.json
    as the JAX package records its lowering targets, and the artifact
    serves on the CPU bit for bit the live plain route."""
    model, params, model_j, tree = _make_model("ks", nx=32)
    path = str(tmp_path / "cpu_only")
    meta = export.export_and_save(model, params, path, platforms=("cpu",))
    want = jexport.export_model(model_j, tree, platforms=("cpu",))[0]
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["platforms"] == meta["platforms"] == want["platforms"] == ["cpu"]
    served = export.ServedModel(path, device="cpu")
    u = _members(model, (3,))
    with torch.no_grad():
        live = model.rhs_fn(params, None, use_kernel=False)(u, 0.0)
    assert torch.equal(served.rhs_fn()(u, 0.0), live)


def test_served_model_refuses_an_unlisted_device(tmp_path):
    """An artifact exported for ``("cuda",)`` is refused on the CPU before
    any program is loaded, as a JAX artifact refuses a platform it was not
    lowered for."""
    model, params, _, _ = _make_model("ks", nx=32)
    path = str(tmp_path / "cuda_only")
    assert export.export_and_save(model, params, path, platforms=("cuda",))["platforms"] == [
        "cuda"]
    os.remove(os.path.join(path, "rhs.pt2"))  # the refusal comes before any load
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not for cpu"):
        export.ServedModel(path, device="cpu")


@pytest.mark.parametrize("platforms,match", [
    (("cpu", "tpu"), "no TPU lowering"), (("tpu",), "no TPU lowering"),
    (("cpu", "gpu"), "non-empty subset"), ((), "non-empty subset"),
])
def test_export_refuses_platforms(platforms, match):
    model, params, _, _ = _make_model("ks", nx=32)
    with pytest.raises(ValueError, match=match):
        export.export_model(model, params, platforms=platforms)


def test_run_export_platforms_flag(tmp_path):
    """``run_export --platforms cpu`` writes ``["cpu"]``; the JAX default
    ``cpu,tpu`` is refused by name, and so is a ``--device`` the list does
    not hold, before anything is exported."""
    path = tmp_path / "x"
    out = run_export.main(["--checkpoint_dir", "ckpt_burgers8", "--output_dir", str(path),
                           "--num_steps", "0", "--platforms", "cpu", "--device", "cpu"])
    assert out["platforms"] == ["cpu"] and out["max_abs_err"] == 0.0
    with open(path / "meta.json") as f:
        assert json.load(f)["platforms"] == ["cpu"]
    for platforms, match in (("cpu,tpu", "no TPU lowering"), ("cuda", "not in --platforms")):
        with pytest.raises(ValueError, match=match):
            run_export.main(["--checkpoint_dir", "ckpt_burgers8", "--output_dir",
                             str(tmp_path / "y"), "--num_steps", "0", "--platforms",
                             platforms, "--device", "cpu"])
    assert not (tmp_path / "y").exists()
