"""The port's evaluation harness against the JAX package's, and its own
behaviour (reference cache, survival criteria, family warnings, HDF5).

The two packages draw their members from different generators, so the
parity cases draw ``u0`` and the forcing once with numpy and hand the same
arrays to both: ``initial_conditions``/``sample_forcing`` are patched on
both ``Equation`` base classes for the test (pytest's ``monkeypatch``).
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import evaluate as jeval
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu import weno as jweno
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models.stencil_net import StencilModel as JModel
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import evaluate as teval
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch import weno as tweno
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.models import ModelConfig as TConfig
from pde_superresolution_torch.models.stencil_net import StencilModel as TModel

torch.set_num_threads(1)

THRESHOLD = 0.8
# a member's survival time may differ between the packages only where its
# correlation comes within this distance of the threshold at some save
NEAR_THRESHOLD = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- metric helpers ---------------------------------------------------------------


def test_metric_helpers_against_jax():
    """pearson_correlation within 1e-6 and both survival criteria equal, on
    random arrays with NaN entries, a constant (zero-variance) row and rows
    dead on arrival."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 9, 32)).astype(np.float32)
    b = (a + 0.7 * rng.standard_normal(a.shape)).astype(np.float32)
    a[1, 3, 5] = np.nan
    b[2, :, :] = 1.0  # zero variance: the 1e-12 floor of the denominator
    corr_j = np.asarray(jeval.pearson_correlation(jnp.asarray(a), jnp.asarray(b)))
    corr_t = teval.pearson_correlation(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(np.isnan(corr_t), np.isnan(corr_j))
    np.testing.assert_allclose(corr_t, corr_j, atol=1e-6)

    times = np.linspace(0.0, 2.0, 9).astype(np.float32)
    corr = rng.uniform(0.5, 1.0, (7, 9)).astype(np.float32)
    corr[0] = 0.95  # never dies
    corr[1, 0] = 0.1  # dead on arrival
    corr[2, 4] = np.nan  # a NaN kills (comparison is false)
    mae = rng.uniform(0.0, 0.5, (7, 9)).astype(np.float32)
    mae[3, 0] = 0.9  # dead on arrival
    mae[4, 2] = np.nan
    mae[5] = 0.01
    for threshold in (0.6, 0.8):
        want = np.asarray(jeval.survival_time_from_correlation(
            jnp.asarray(corr), jnp.asarray(times), threshold))
        got = teval.survival_time_from_correlation(
            torch.from_numpy(corr), torch.from_numpy(times), threshold).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jeval.survival_time_from_mae(jnp.asarray(mae), jnp.asarray(times), 0.3))
    got = teval.survival_time_from_mae(torch.from_numpy(mae), torch.from_numpy(times), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (7,) and got[3] == 0.0 and got[5] == times[-1]


def test_survival_time_cases():
    """tests/test_evaluate.py's cases: dies and stays dead, never dies, dead
    on arrival; the MAE criterion's threshold crossing."""
    times = torch.tensor([0.0, 1.0, 2.0, 3.0])
    for corr, want in (([1.0, 0.9, 0.5, 0.95], 1.0), ([1.0, 0.9, 0.85, 0.95], 3.0),
                       ([0.1, 0.9, 0.85, 0.95], 0.0)):
        got = teval.survival_time_from_correlation(torch.tensor([corr]), times, 0.8)
        assert got.tolist() == [want]
    mae = torch.tensor([[0.0, 0.1, 0.5, 0.2]])
    assert teval.survival_time_from_mae(mae, times, 0.3).tolist() == [1.0]
    assert teval.survival_time_from_mae(mae, times, 1.0).tolist() == [3.0]


# -- evaluate() against JAX on injected members --------------------------------------


@pytest.fixture
def inject(monkeypatch):
    """``inject(u0, forcing)``: both packages' equations return these numpy
    arrays (``forcing``: amplitude, omega, k, phi, or None) from their
    samplers, whatever key or generator they are given."""

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


def _smooth_members(rng, x, period, count):
    """float32 [count, nx]: a few random low sinusoids per member."""
    return np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / period + rng.uniform(0, 2 * np.pi))
            for k in (1, 2, 3))
        for _ in range(count)
    ]).astype(np.float32)


def _numpy_forcing(rng, count, terms=20):
    shape = (count, terms)
    sign = np.where(rng.uniform(size=shape) < 0.5, 1.0, -1.0)
    return [rng.uniform(-0.5, 0.5, shape).astype(np.float32),
            rng.uniform(-0.4, 0.4, shape).astype(np.float32),
            (rng.integers(3, 7, shape) * sign).astype(np.float32),
            rng.uniform(0, 2 * np.pi, shape).astype(np.float32)]


def _compare(got, want, limits):
    """``exact`` within 1e-5 of max|exact|; each scheme's trajectories and
    MAE within its limit (of max|exact|), its correlation within the same
    limit (absolute); survival times equal but for members whose
    correlation comes within NEAR_THRESHOLD of the threshold. Returns the
    number of such flips."""
    scale = float(np.abs(np.asarray(want.exact)).max())
    np.testing.assert_allclose(_np(got.times), np.asarray(want.times), rtol=1e-6, atol=1e-6)
    assert np.abs(_np(got.exact) - np.asarray(want.exact)).max() <= 1e-5 * scale
    assert sorted(got.trajectories) == sorted(want.trajectories)
    flips = 0
    for name, tol in limits.items():
        traj = _np(got.trajectories[name])
        assert np.isfinite(traj).all(), name
        assert np.abs(traj - np.asarray(want.trajectories[name])).max() <= tol * scale, name
        assert np.abs(_np(got.mae[name]) - np.asarray(want.mae[name])).max() <= tol * scale, name
        corr_j = np.asarray(want.correlation[name])
        assert np.abs(_np(got.correlation[name]) - corr_j).max() <= tol, name
        differ = _np(got.survival_time[name]) != np.asarray(want.survival_time[name])
        near = (np.abs(corr_j - THRESHOLD) <= NEAR_THRESHOLD).any(axis=-1)
        assert not (differ & ~near).any(), name
        flips += int(differ.sum())
    return flips


def test_burgers_forced_baseline_and_weno_against_jax(inject):
    """Conservative forced Burgers at 4x (fine 128, 3 members, 6 saves):
    the classic baseline and WENO, both within 1e-5 of max|u|."""
    eq_j = jeq.BurgersEquation(eta=0.05, conservative=True)
    eq_t = teq.BurgersEquation(eta=0.05, conservative=True)
    fine_j, fine_t = JGrid(128, eq_j.period), TGrid(128, eq_t.period)
    rng = np.random.default_rng(1)
    inject(_smooth_members(rng, fine_j.x, eq_j.period, 3), _numpy_forcing(rng, 3))
    coarse_j = fine_j.resample(4, conservative=True)
    coarse_t = fine_t.resample(4, conservative=True)
    want = jeval.evaluate(
        eq_j, fine_j, 4,
        {"baseline": lambda f: jint.PolynomialDifferentiator(eq_j, coarse_j).rhs_fn(f),
         "weno": lambda f: jweno.WENODifferentiator(eq_j, coarse_j).rhs_fn(f)},
        key=jax.random.PRNGKey(0), num_samples=3, time_max=0.5, time_delta=0.1)
    got = teval.evaluate(
        eq_t, fine_t, 4,
        {"baseline": lambda f: tint.PolynomialDifferentiator(eq_t, coarse_t, device="cpu").rhs_fn(f),
         "weno": lambda f: tweno.WENODifferentiator(eq_t, coarse_t, device="cpu").rhs_fn(f)},
        generator=torch.Generator().manual_seed(0), num_samples=3, time_max=0.5,
        time_delta=0.1, device="cpu")
    assert got.exact.shape == (3, 6, 32)
    assert _compare(got, want, {"baseline": 1e-5, "weno": 1e-5}) == 0  # no member near 0.8


def test_ks_warmup_baseline_against_jax(inject):
    """KS at 2x (fine 128) after an exact-solver warm-up of 2 time units,
    2 members, 5 saves: the baseline within 1e-5 of max|u|."""
    eq_j, eq_t = jeq.KSEquation(), teq.KSEquation()
    fine_j, fine_t = JGrid(128, eq_j.period), TGrid(128, eq_t.period)
    inject(_smooth_members(np.random.default_rng(2), fine_j.x, eq_j.period, 2), None)
    coarse_j, coarse_t = fine_j.resample(2), fine_t.resample(2)
    kwargs = dict(num_samples=2, time_max=1.0, time_delta=0.25, warmup_time=2.0, ic_scale=0.5)
    want = jeval.evaluate(
        eq_j, fine_j, 2,
        {"baseline": lambda f: jint.PolynomialDifferentiator(eq_j, coarse_j).rhs_fn(f)},
        key=jax.random.PRNGKey(0), **kwargs)
    got = teval.evaluate(
        eq_t, fine_t, 2,
        {"baseline": lambda f: tint.PolynomialDifferentiator(eq_t, coarse_t, device="cpu").rhs_fn(f)},
        generator=torch.Generator(), device="cpu", **kwargs)
    assert abs(float(got.times[0]) - 2.0) < 1e-6  # the evaluation starts after the warm-up
    assert _compare(got, want, {"baseline": 1e-5}) == 0


def test_seeded_model_against_jax(inject):
    """A seeded StencilModel (forced conservative Burgers at 4x, fine 128),
    its JAX params converted by ``convert.params_from_jax``: the model
    scheme within 1e-4 of max|u|, the baseline within 1e-5."""
    rng = np.random.default_rng(3)
    eq_j = jeq.BurgersEquation(eta=0.05, conservative=True)
    eq_t = teq.BurgersEquation(eta=0.05, conservative=True)
    fine_j, fine_t = JGrid(128, eq_j.period), TGrid(128, eq_t.period)
    coarse_j = fine_j.resample(4, conservative=True)
    coarse_t = fine_t.resample(4, conservative=True)
    fields = dict(num_layers=2, filters=8, stencil_size=4)
    model_j = JModel(eq_j, coarse_j, JConfig(**fields))
    tree = jax.tree.map(
        lambda leaf: np.asarray(leaf) + 0.02 * rng.standard_normal(leaf.shape).astype(np.float32),
        model_j.init_params(jax.random.PRNGKey(0)))
    model_t = TModel(eq_t, coarse_t, TConfig(**fields), device="cpu")
    params_t = convert.params_from_jax(tree, "cpu")
    inject(_smooth_members(rng, fine_j.x, eq_j.period, 2), _numpy_forcing(rng, 2))
    jtree = jax.tree.map(jnp.asarray, tree)
    want = jeval.evaluate(
        eq_j, fine_j, 4,
        {"model": lambda f: model_j.rhs_fn(jtree, f),
         "baseline": lambda f: jint.PolynomialDifferentiator(eq_j, coarse_j).rhs_fn(f)},
        key=jax.random.PRNGKey(0), num_samples=2, time_max=0.4, time_delta=0.1)
    got = teval.evaluate(
        eq_t, fine_t, 4,
        {"model": lambda f: model_t.rhs_fn(params_t, f),
         "baseline": lambda f: tint.PolynomialDifferentiator(eq_t, coarse_t, device="cpu").rhs_fn(f)},
        generator=torch.Generator(), num_samples=2, time_max=0.4, time_delta=0.1, device="cpu")
    assert _compare(got, want, {"model": 1e-4, "baseline": 1e-5}) == 0


# -- behaviour, ported from tests/test_evaluate.py -----------------------------------

BURGERS = teq.BurgersEquation(eta=0.05, conservative=True)


def _baseline(eq, fine, factor):
    coarse = fine.resample(factor, conservative=eq.conservative)
    return lambda forcing: tint.PolynomialDifferentiator(eq, coarse, device="cpu").rhs_fn(forcing)


def test_burgers_baseline_vs_garbage():
    """The baseline survives the horizon, a scrambling scheme dies first,
    and the matched ICs give MAE ~0 at t=0."""
    fine = TGrid(256, BURGERS.period)

    def garbage(forcing):
        # amplifies a spatially scrambled copy: decorrelates (a constant-in-x
        # blowup would not: Pearson is shift-invariant)
        rhs = lambda u, t: 20.0 * torch.roll(u, u.shape[-1] // 3, -1)
        rhs.conservative = True
        return rhs

    result = teval.evaluate(BURGERS, fine, 4, {"baseline": _baseline(BURGERS, fine, 4),
                                               "garbage": garbage},
                            generator=torch.Generator().manual_seed(0), num_samples=2,
                            time_max=1.0, time_delta=0.1, device="cpu")
    assert result.exact.shape == (2, 11, 64)
    assert result.mae["baseline"].shape == (2, 11)
    surv_b, surv_g = result.survival_time["baseline"], result.survival_time["garbage"]
    assert (surv_b >= 0.9).all(), surv_b
    assert (surv_g < surv_b).all(), (surv_g, surv_b)
    assert float(result.mae["baseline"][:, 0].max()) < 1e-5


def test_ks_warmup_lands_on_attractor():
    eq = teq.KSEquation()
    fine = TGrid(256, eq.period)
    result = teval.evaluate(eq, fine, 2, {"baseline": _baseline(eq, fine, 2)},
                            generator=torch.Generator().manual_seed(1), num_samples=2,
                            time_max=5.0, time_delta=0.5, warmup_time=40.0, ic_scale=0.1,
                            device="cpu")
    rms = float(torch.sqrt((result.exact[:, 0] ** 2).mean()))
    assert 0.5 < rms < 4.0, rms
    assert torch.isfinite(result.exact).all()
    np.testing.assert_allclose(result.correlation["baseline"][:, 0].numpy(), 1.0, atol=1e-3)


class TestReferenceCache:
    """Content-keyed cache for the exact fine reference solve."""

    def _evaluate(self, cache_dir, factor=4, seed=0, **kwargs):
        fine = TGrid(256, BURGERS.period)
        defaults = dict(num_samples=2, time_max=0.5, time_delta=0.1)
        defaults.update(kwargs)
        return teval.evaluate(BURGERS, fine, factor, {"baseline": _baseline(BURGERS, fine, factor)},
                              generator=torch.Generator().manual_seed(seed),
                              reference_cache_dir=cache_dir, device="cpu", **defaults)

    @staticmethod
    def _count_solves(monkeypatch, fail=False):
        calls = []
        orig = tint.exact_solve_sampled

        def counted(*a, **k):
            calls.append(1)
            if fail:
                raise AssertionError("the exact solve ran on a cache hit")
            return orig(*a, **k)

        monkeypatch.setattr(tint, "exact_solve_sampled", counted)
        return calls

    def test_hit_skips_solve_and_is_bit_identical(self, tmp_path, monkeypatch):
        cache = str(tmp_path / "refs")
        uncached = self._evaluate(None)
        assert not os.path.exists(cache)
        calls = self._count_solves(monkeypatch)
        first = self._evaluate(cache)
        assert len(calls) == 1  # miss: computed + stored
        monkeypatch.undo()
        self._count_solves(monkeypatch, fail=True)
        second = self._evaluate(cache)  # hit: the solver raises if called
        for result in (first, second):
            assert torch.equal(result.exact, uncached.exact)
            assert torch.equal(result.times, uncached.times)
            assert torch.equal(result.mae["baseline"], uncached.mae["baseline"])
            assert torch.equal(result.trajectories["baseline"], uncached.trajectories["baseline"])

    def test_fine_solve_shared_across_resample_factors(self, tmp_path, monkeypatch):
        """All factors reuse ONE fine solve (the factor is not in the key)."""
        cache = str(tmp_path / "refs")
        calls = self._count_solves(monkeypatch)
        r4 = self._evaluate(cache, factor=4)
        r8 = self._evaluate(cache, factor=8)
        assert len(calls) == 1
        assert r4.exact.shape[-1] == 64 and r8.exact.shape[-1] == 32
        assert len([f for f in os.listdir(cache) if f.endswith(".h5")]) == 1

    BASE = dict(equation=BURGERS, fine_grid=TGrid(256, BURGERS.period),
                generator_state=torch.Generator().manual_seed(0).get_state(), num_samples=2,
                time_delta=0.1, num_times=6, warmup_time=0.0, ic_scale=1.0, exact_dt_cap=None)

    def test_key_sensitivity(self):
        """Anything that changes a bit of the solve changes the key."""
        base = self.BASE
        h0, _ = teval._reference_cache_key(**base)
        variants = [
            {**base, "generator_state": torch.Generator().manual_seed(1).get_state()},
            {**base, "ic_scale": 0.5},
            {**base, "num_times": 7},
            {**base, "warmup_time": 1.0},
            {**base, "num_samples": 3},
            {**base, "exact_dt_cap": 0.01},
            {**base, "equation": dataclasses.replace(BURGERS, eta=0.02)},
            {**base, "fine_grid": TGrid(512, BURGERS.period)},
            {**base, "dtype": torch.float64},
        ]
        hashes = [teval._reference_cache_key(**v)[0] for v in variants]
        assert h0 not in hashes
        assert len(set(hashes)) == len(hashes)

    def test_key_tracks_solver_version_dtype_and_package(self, monkeypatch):
        """A solver-numerics change invalidates cached references; the key
        records the compute dtype and this package's own format tag, and the
        default directory is this package's."""
        h0, canonical = teval._reference_cache_key(**self.BASE)
        assert '"solver_version"' in canonical and '"float32"' in canonical
        assert f'"format": "{teval.CACHE_FORMAT}"' in canonical
        assert "pde_superresolution_torch" in teval.default_reference_cache_dir()
        monkeypatch.setattr(tint, "EXACT_SOLVER_VERSION", 2)
        assert teval._reference_cache_key(**self.BASE)[0] != h0

    def test_forcing_round_trips_through_cache(self, tmp_path):
        """A forced equation reloads the stored forcing draw, and the
        generator advances the same on a hit as on a miss."""
        cache = str(tmp_path / "refs")
        fine = TGrid(256, BURGERS.period)
        out = []
        for _ in range(2):
            gen = torch.Generator().manual_seed(3)
            out.append(teval._cached_exact_solve(cache, BURGERS, fine, gen, 2, 0.1, 4, 0.0, 1.0,
                                                 None, "cpu") + (gen.get_state(),))
        (times1, traj1, forcing1, state1), (times2, traj2, forcing2, state2) = out
        assert torch.equal(times1, times2) and torch.equal(traj1, traj2)
        assert torch.equal(state1, state2)
        assert forcing1 is not None and forcing2 is not None
        for a, b in zip(forcing1, forcing2):
            assert torch.equal(a, b)


class TestFamilyWarning:
    """evaluate() warns when a scheme's family tag disagrees with the
    coarse-graining family, or is missing."""

    @staticmethod
    def _run(eq_eval, schemes):
        fine = TGrid(64, eq_eval.period)
        return teval.evaluate(eq_eval, fine, 2, schemes,
                              generator=torch.Generator().manual_seed(0), num_samples=1,
                              time_max=0.1, time_delta=0.05, ic_scale=0.1, device="cpu")

    @staticmethod
    def _scheme(eq):
        fine = TGrid(64, eq.period)
        return {"s": _baseline(eq, fine, 2)}

    def test_mixed_family_warns(self):
        eq_cons = teq.from_name("ks", conservative=True)
        eq_fd = teq.from_name("ks", conservative=False)
        with pytest.warns(UserWarning, match="half a cell"):
            self._run(eq_cons, self._scheme(eq_fd))

    def test_matched_family_silent(self):
        eq = teq.from_name("ks", conservative=True)
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            self._run(eq, self._scheme(eq))

    def test_untagged_scheme_warns(self):
        eq = teq.from_name("ks", conservative=True)
        with pytest.warns(UserWarning, match="no .conservative family tag"):
            self._run(eq, {"raw": lambda f: (lambda u, t: -u)})

    def test_tagged_user_closure_silent(self):
        eq = teq.from_name("ks", conservative=True)

        def factory(forcing):
            rhs = lambda u, t: -u
            rhs.conservative = True
            return rhs

        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            self._run(eq, {"tagged": factory})


def test_mae_survival_from_an_evaluation():
    """The MAE criterion on an evaluation's own MAE: a threshold above every
    MAE survives the horizon, one below the first nonzero MAE dies at 0."""
    fine = TGrid(128, BURGERS.period)
    result = teval.evaluate(BURGERS, fine, 4, {"baseline": _baseline(BURGERS, fine, 4)},
                            generator=torch.Generator().manual_seed(5), num_samples=2,
                            time_max=0.5, time_delta=0.1, device="cpu")
    rel = result.times - result.times[0]
    mae = result.mae["baseline"]
    assert teval.survival_time_from_mae(mae, rel, float(mae.max()) + 1).tolist() == [
        float(rel[-1])] * 2
    assert teval.survival_time_from_mae(mae, rel, float(mae[:, 1].min()) / 2).tolist() == [0.0] * 2


# -- HDF5 interchange -------------------------------------------------------------------


def test_eval_h5_cross_loads_between_packages(tmp_path):
    """An EvalResult written by the port loads through the JAX package's
    load_eval_h5, and the reverse, array for array."""
    rng = np.random.default_rng(4)
    arrays = {
        "times": np.linspace(0.0, 1.0, 5).astype(np.float32),
        "exact": rng.standard_normal((3, 5, 16)).astype(np.float32),
    }
    groups = {
        "trajectories": {s: rng.standard_normal((3, 5, 16)).astype(np.float32)
                         for s in ("model", "baseline")},
        "mae": {s: rng.uniform(size=(3, 5)).astype(np.float32) for s in ("model", "baseline")},
        "correlation": {s: rng.uniform(size=(3, 5)).astype(np.float32)
                        for s in ("model", "baseline")},
        "survival_time": {s: rng.uniform(size=3).astype(np.float32) for s in ("model", "baseline")},
    }

    def build(result_type, convert_leaf):
        return result_type(
            convert_leaf(arrays["times"]), convert_leaf(arrays["exact"]),
            *({k: convert_leaf(v) for k, v in groups[g].items()} for g in
              ("trajectories", "mae", "correlation", "survival_time")))

    def check(result):
        np.testing.assert_array_equal(_np(result.times), arrays["times"])
        np.testing.assert_array_equal(_np(result.exact), arrays["exact"])
        for g, schemes in groups.items():
            got = getattr(result, g)
            assert sorted(got) == sorted(schemes)
            for s, want in schemes.items():
                np.testing.assert_array_equal(_np(got[s]), want)

    teval.save_eval_h5(str(tmp_path / "port.h5"), build(teval.EvalResult, torch.from_numpy))
    check(jeval.load_eval_h5(str(tmp_path / "port.h5")))
    jeval.save_eval_h5(str(tmp_path / "jax.h5"), build(jeval.EvalResult, jnp.asarray))
    loaded = teval.load_eval_h5(str(tmp_path / "jax.h5"))
    check(loaded)
    assert isinstance(loaded.exact, torch.Tensor)
