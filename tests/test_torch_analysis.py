"""The port's analysis helpers against the JAX package's, on one
EvalResult handed to both as numpy."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import analysis as janalysis
from pde_superresolution_tpu import evaluate as jeval
from pde_superresolution_torch import analysis as tanalysis
from pde_superresolution_torch import evaluate as teval

torch.set_num_threads(1)


def _arrays():
    """A 5-member, 7-save, 3-scheme evaluation with a diverged member."""
    rng = np.random.default_rng(0)
    times = (2.5 + 0.5 * np.arange(7)).astype(np.float32)
    exact = rng.standard_normal((5, 7, 16)).astype(np.float32)
    groups = {g: {} for g in ("trajectories", "mae", "correlation", "survival_time")}
    for s in ("model", "baseline", "weno"):
        groups["trajectories"][s] = (exact + 0.1 * rng.standard_normal(exact.shape)).astype(np.float32)
        groups["mae"][s] = rng.uniform(0, 1, (5, 7)).astype(np.float32)
        groups["correlation"][s] = rng.uniform(0.5, 1, (5, 7)).astype(np.float32)
        groups["survival_time"][s] = (0.5 * rng.integers(0, 7, 5)).astype(np.float32)
    groups["mae"]["baseline"][2, -1] = np.nan
    return times, exact, groups


def _results():
    times, exact, groups = _arrays()
    order = ("trajectories", "mae", "correlation", "survival_time")
    return (
        jeval.EvalResult(jnp.asarray(times), jnp.asarray(exact),
                         *({k: jnp.asarray(v) for k, v in groups[g].items()} for g in order)),
        teval.EvalResult(torch.from_numpy(times), torch.from_numpy(exact),
                         *({k: torch.from_numpy(v) for k, v in groups[g].items()} for g in order)),
        teval.EvalResult(times, exact, *(groups[g] for g in order)),
    )


@pytest.mark.parametrize("name", ["mae_curves", "survival_curves"])
def test_curves_against_jax(name):
    want_r, got_r, numpy_r = _results()
    want = getattr(janalysis, name)(want_r)
    for result in (got_r, numpy_r):
        got = getattr(tanalysis, name)(result)
        assert sorted(got) == sorted(want)
        for scheme, (t, curve) in want.items():
            np.testing.assert_array_equal(got[scheme][0], np.asarray(t))
            np.testing.assert_array_equal(got[scheme][1], np.asarray(curve))


def test_survival_summary_against_jax():
    want_r, got_r, numpy_r = _results()
    want = janalysis.survival_summary(want_r)
    assert tanalysis.survival_summary(got_r) == want
    assert tanalysis.survival_summary(numpy_r) == want


def test_report_text_against_jax():
    """The report's text is identical, the diverged member's note included."""
    want_r, got_r, numpy_r = _results()
    want = janalysis.report(want_r)
    assert "[1 diverged]" in want
    assert tanalysis.report(got_r) == want
    assert tanalysis.report(numpy_r) == want


def test_tests_fake_result():
    """tests/test_analysis.py's cases on the port."""
    times = torch.linspace(0.0, 1.0, 5)
    exact = torch.zeros((3, 5, 16))
    mae = {"m": torch.ones((3, 5)) * torch.tensor([0, 1, 2, 3, 4.0])}
    result = teval.EvalResult(times, exact, {"m": exact}, mae, {"m": torch.ones((3, 5))},
                              {"m": torch.tensor([1.0, 0.5, 0.75])})
    np.testing.assert_allclose(tanalysis.mae_curves(result)["m"][1], [0, 1, 2, 3, 4])
    s = tanalysis.survival_summary(result)["m"]
    assert s["median"] == 0.75 and s["min"] == 0.5 and s["max"] == 1.0
    t, frac = tanalysis.survival_curves(result)["m"]
    np.testing.assert_allclose(t, [0, 0.25, 0.5, 0.75, 1.0])
    np.testing.assert_allclose(frac, [1.0, 1.0, 1.0, 2 / 3, 1 / 3])
    text = tanalysis.report(result)
    assert "m" in text and "survival" in text
