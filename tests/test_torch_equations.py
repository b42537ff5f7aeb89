"""The port's equations against the JAX package, on shared numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.grids import Grid as TGrid

torch.set_num_threads(1)

FORMS = [(n, c) for n in ("burgers", "kdv", "ks") for c in (False, True)]


def _forcing(rng, batch, terms=5):
    return [
        rng.uniform(-0.5, 0.5, (batch, terms)).astype(np.float32),
        rng.uniform(-0.4, 0.4, (batch, terms)).astype(np.float32),
        (rng.integers(3, 7, (batch, terms)) * rng.choice([-1, 1], (batch, terms))
         ).astype(np.float32),
        rng.uniform(0, 2 * np.pi, (batch, terms)).astype(np.float32),
    ]


def test_grid_matches():
    for size, factor, cons in [(1024, 8, True), (256, 4, False), (96, 1, True)]:
        want = JGrid(size, 64.0).resample(factor, conservative=cons)
        got = TGrid(size, 64.0).resample(factor, conservative=cons)
        assert (got.size, got.period, got.origin, got.dx) == (
            want.size, want.period, want.origin, want.dx)
        np.testing.assert_array_equal(got.x, want.x)
    with pytest.raises(ValueError):
        TGrid(100, 1.0).resample(3)


@pytest.mark.parametrize("name,cons", FORMS)
def test_time_derivative_matches(name, cons):
    """Equation of motion or flux divergence plus the (cell-averaged, for
    conservative forms) forcing, on the same float32 inputs. The ops are the
    same elementwise float32 operations in the same order except the
    forcing's sum over 5 terms and libm's sin, so agreement is to a few ulps:
    rtol 1e-5, atol 1e-5 x max|u_t|."""
    rng = np.random.default_rng(2)
    eq_j = jeq.from_name(name, conservative=cons)
    eq_t = teq.from_name(name, conservative=cons)
    assert eq_t.derivative_orders == eq_j.derivative_orders
    grid_j = JGrid(256, eq_j.period).resample(4, conservative=cons)
    grid_t = TGrid(256, eq_t.period).resample(4, conservative=cons)
    u = rng.standard_normal((3, grid_j.size)).astype(np.float32)
    derivs = {d: rng.standard_normal(u.shape).astype(np.float32)
              for d in eq_j.derivative_orders}
    leaves = _forcing(rng, 3)
    t = np.float32(0.37)
    for forced in (False, True):
        fj = jeq.ForcingParams(*map(jnp.asarray, leaves)) if forced else None
        ft = teq.ForcingParams(*map(torch.from_numpy, leaves)) if forced else None
        want = np.asarray(eq_j.time_derivative(
            jnp.asarray(u), {d: jnp.asarray(v) for d, v in derivs.items()},
            grid_j, jnp.asarray(t), fj))
        got = eq_t.time_derivative(
            torch.from_numpy(u), {d: torch.from_numpy(v) for d, v in derivs.items()},
            grid_t, torch.tensor(t), ft).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cell_width", [None, 0.5])
def test_forcing_term_matches(cell_width):
    """Sum of 5 sinusoids on 64 points (sinc cell average when a width is
    given): float32 sin and a 5-term sum, so rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(3)
    leaves = _forcing(rng, 4)
    x = (np.arange(64) * 0.5 + 0.25).astype(np.float32)
    want = np.asarray(jeq.forcing_term(
        jeq.ForcingParams(*map(jnp.asarray, leaves)), jnp.asarray(x), 1.3, 32.0,
        cell_width))
    got = teq.forcing_term(
        teq.ForcingParams(*map(torch.from_numpy, leaves)), torch.from_numpy(x), 1.3,
        32.0, cell_width).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell_width", [None, 2 * np.pi / 128])
def test_forcing_term_batch_shaped_t(cell_width):
    """The cell-average sinc factor (kappa w / 2 up to 0.15 at 8x
    coarsening of Burgers) with a time per trajectory, ``t [batch]``: float32
    sin and sinc from two libraries and a 5-term sum, so rtol 1e-5, atol
    1e-6."""
    rng = np.random.default_rng(4)
    leaves = _forcing(rng, 4)
    x = (np.arange(128) * 2 * np.pi / 128 + 0.02).astype(np.float32)
    t = rng.uniform(0, 50, 4).astype(np.float32)
    want = np.asarray(jeq.forcing_term(
        jeq.ForcingParams(*map(jnp.asarray, leaves)), jnp.asarray(x), jnp.asarray(t),
        2 * np.pi, cell_width))
    got = teq.forcing_term(
        teq.ForcingParams(*map(torch.from_numpy, leaves)), torch.from_numpy(x),
        torch.from_numpy(t), 2 * np.pi, cell_width).numpy()
    assert got.shape == want.shape == (4, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["burgers", "kdv", "ks"])
def test_linear_symbol_matches(name):
    """Float64/complex128 numpy on both sides: equal."""
    k = 2 * np.pi * np.fft.rfftfreq(64, d=0.37)
    want = jeq.from_name(name).linear_symbol(k)
    got = teq.from_name(name).linear_symbol(k)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError):
        teq.Equation(period=1.0).linear_symbol(k)


@pytest.mark.parametrize("name", ["burgers", "kdv", "ks"])
@pytest.mark.parametrize("forced", [False, True])
def test_nonlinear_term_matches(name, forced):
    """-u u_x (times 6 for KdV), plus Burgers' point-value forcing when
    params are given (KdV and KS ignore them): the same float32 products,
    then a 5-term sum of libm sines, so rtol 1e-6 unforced and rtol 1e-5,
    atol 1e-6 forced."""
    rng = np.random.default_rng(5)
    eq_j, eq_t = jeq.from_name(name), teq.from_name(name)
    grid_j, grid_t = JGrid(64, eq_j.period), TGrid(64, eq_t.period)
    u = rng.standard_normal((3, 64)).astype(np.float32)
    u_x = rng.standard_normal((3, 64)).astype(np.float32)
    leaves = _forcing(rng, 3)
    fj = jeq.ForcingParams(*map(jnp.asarray, leaves)) if forced else None
    ft = teq.ForcingParams(*map(torch.from_numpy, leaves)) if forced else None
    want = np.asarray(eq_j.nonlinear_term(
        jnp.asarray(u), jnp.asarray(u_x), grid_j, jnp.float32(0.9), fj))
    got = eq_t.nonlinear_term(
        torch.from_numpy(u), torch.from_numpy(u_x), grid_t, torch.tensor(0.9), ft).numpy()
    if forced and name == "burgers":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,cons", FORMS)
def test_stable_time_step_and_params_equal(name, cons):
    eq_j = jeq.from_name(name, conservative=cons)
    eq_t = teq.from_name(name, conservative=cons)
    for size, factor in [(1024, 8), (512, 16), (256, 1)]:
        grid_j = JGrid(size, eq_j.period).resample(factor, conservative=cons)
        grid_t = TGrid(size, eq_t.period).resample(factor, conservative=cons)
        for u_scale in (2.0, 3.0):
            assert eq_t.stable_time_step(grid_t, u_scale) == (
                eq_j.stable_time_step(grid_j, u_scale))
    assert teq.params_dict(eq_t) == jeq.params_dict(eq_j)
    alias = teq.from_name(f"conservative_{name}")
    assert alias.conservative and alias.name == name


def test_from_name_rejects_unknown():
    with pytest.raises(ValueError, match="unknown equation"):
        teq.from_name("heat")


def test_initial_conditions_distribution():
    """Different stream from jax.random, so the distribution is tested: a
    sum of 10 modes with |A| <= 1 is bounded by 10; the sample is smooth
    (only wavenumbers 1..3, so the 4th and higher Fourier modes vanish);
    the same seed gives the same draw."""
    eq = teq.from_name("ks")
    grid = TGrid(128, eq.period)
    u = eq.initial_conditions(torch.Generator().manual_seed(0), grid, (64,),
                              device="cpu")
    assert u.shape == (64, 128) and u.dtype == torch.float32
    assert float(u.abs().max()) <= 10.0
    spectrum = np.abs(np.fft.rfft(u.numpy().astype(np.float64), axis=-1))
    assert spectrum[:, 4:].max() < 1e-3 * spectrum[:, 1:4].max()
    assert spectrum[:, 1:4].mean() > 1.0
    again = eq.initial_conditions(torch.Generator().manual_seed(0), grid, (64,),
                                  device="cpu")
    torch.testing.assert_close(u, again, rtol=0, atol=0)


def test_sample_forcing_distribution():
    eq = teq.from_name("burgers")
    f = eq.sample_forcing(torch.Generator().manual_seed(1), (4000,), device="cpu")
    assert f.amplitude.shape == (4000, 20)
    assert float(f.amplitude.abs().max()) <= 0.5
    assert float(f.omega.abs().max()) <= 0.4
    assert float(f.phi.min()) >= 0 and float(f.phi.max()) <= 2 * np.pi
    assert set(np.unique(np.abs(f.k.numpy())).tolist()) == {3.0, 4.0, 5.0, 6.0}
    assert abs(float((f.k > 0).float().mean()) - 0.5) < 0.01
    assert abs(float(f.amplitude.mean())) < 0.01
    assert teq.from_name("ks").sample_forcing(torch.Generator(), (2,), "cpu") is None


def test_default_device_needs_cuda():
    """Entry points default to cuda and raise, rather than fall back to the
    CPU, when no card is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    eq = teq.from_name("ks")
    with pytest.raises(RuntimeError, match="CUDA"):
        eq.initial_conditions(torch.Generator(), TGrid(16, eq.period), (2,))
