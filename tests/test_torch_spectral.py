"""The port's spectral ops, resampling, exact ETDRK4 solver and energy
spectrum against the JAX package on the CPU, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import analysis as janalysis
from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.ops import resample as jresample
from pde_superresolution_tpu.ops import spectral as jspectral
from pde_superresolution_torch import analysis as tanalysis
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.ops import resample as tresample
from pde_superresolution_torch.ops import spectral as tspectral

torch.set_num_threads(1)


def _field(shape, period, seed=0, modes=(1, 2, 5)):
    """Smooth periodic float32 rows: a few sinusoids with random phases."""
    rng = np.random.default_rng(seed)
    x = np.arange(shape[-1]) * period / shape[-1]
    u = sum(
        rng.uniform(-1, 1, shape[:-1] + (1,))
        * np.sin(2 * np.pi * k * x / period + rng.uniform(0, 2 * np.pi, shape[:-1] + (1,)))
        for k in modes
    )
    return u.astype(np.float32)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("size,period", [(64, 2 * np.pi), (33, 32.0)])
def test_wavenumbers(size, period):
    np.testing.assert_array_equal(tspectral.wavenumbers(size, period),
                                  jspectral.wavenumbers(size, period))


def _derivative_tol(size, order, top_mode=5):
    """Two float32 FFT libraries leave rounding noise of about 1e-7 max|u|
    in every mode; the symbol (ik)^order amplifies the noise at the Nyquist
    mode by (k_nyquist / k_signal)^order relative to the signal's own
    derivative. 4e-7 times that factor is 5 to 8 times the readings (5e-7,
    2.4e-6, 1.3e-5, 8.0e-5 for orders 1 to 4 at 64 points)."""
    return 4e-7 * ((size // 2) / top_mode) ** order


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [64, 33])
def test_spectral_derivative(order, size):
    u = _field((3, size), 32.0)
    want = jspectral.spectral_derivative(jnp.asarray(u), order, 32.0)
    got = tspectral.spectral_derivative(torch.from_numpy(u), order, 32.0)
    assert got.dtype == torch.float32
    _close(got, want, _derivative_tol(size, order))


def test_spectral_derivative_axis():
    u = _field((4, 64), 10.0).T.copy()  # [64, 4], differentiate axis 0
    want = jspectral.spectral_derivative(jnp.asarray(u), 1, 10.0, axis=0)
    got = tspectral.spectral_derivative(torch.from_numpy(u), 1, 10.0, axis=0)
    assert got.shape == (64, 4)
    _close(got, want, _derivative_tol(64, 1))


@pytest.mark.parametrize("order,offset_cells", [(0, 0.5), (1, 0.5), (2, 3.0), (3, -0.5)])
def test_spectral_derivative_at_offset(order, offset_cells):
    """As above with the shift factor exp(ik offset), of modulus 1: the same
    tolerance (readings 1.6e-7 to 1.5e-5 for orders 0 to 3)."""
    size, period = 64, 32.0
    offset = offset_cells * period / size
    u = _field((2, size), period, seed=1)
    want = jspectral.spectral_derivative_at_offset(jnp.asarray(u), order, period, offset)
    got = tspectral.spectral_derivative_at_offset(torch.from_numpy(u), order, period, offset)
    _close(got, want, _derivative_tol(size, order))


@pytest.mark.parametrize("cutoff", [0.5, 0.25])
def test_smoothing_filter(cutoff):
    """A multiplier of at most 1: 2e-6 of max|u|."""
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, 64)).astype(np.float32)
    want = jspectral.smoothing_filter(jnp.asarray(u), 2 * np.pi, cutoff)
    got = tspectral.smoothing_filter(torch.from_numpy(u), 2 * np.pi, cutoff)
    _close(got, want, 2e-6)
    got0 = tspectral.smoothing_filter(torch.from_numpy(u.T.copy()), 2 * np.pi, cutoff, axis=0)
    _close(got0.T, want, 2e-6)


@pytest.mark.parametrize("name", ["mean", "subsample"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_resample(name, axis):
    """Means of 8 float32 values in possibly another order: 1e-6 relative;
    subsampling is exact."""
    rng = np.random.default_rng(3)
    u = rng.standard_normal((16, 64)).astype(np.float32)
    want = np.asarray(jresample.RESAMPLE_FUNCS[name](jnp.asarray(u), 8, axis=axis))
    got = tresample.RESAMPLE_FUNCS[name](torch.from_numpy(u), 8, axis=axis).numpy()
    assert got.shape == want.shape
    if name == "subsample":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    same = tresample.RESAMPLE_FUNCS[name](torch.from_numpy(u), 1)
    np.testing.assert_array_equal(same.numpy(), u)
    with pytest.raises(ValueError, match="divisible"):
        tresample.RESAMPLE_FUNCS[name](torch.from_numpy(u), 5, axis=axis)


def _numpy_forcing(rng, batch, terms=20, k_min=3, k_max=6):
    """ForcingParams leaves as float32 numpy, in the samplers' ranges."""
    shape = (batch, terms)
    return (
        rng.uniform(-0.5, 0.5, shape).astype(np.float32),
        rng.uniform(-0.4, 0.4, shape).astype(np.float32),
        (rng.integers(k_min, k_max + 1, shape) * rng.choice([-1.0, 1.0], shape)).astype(np.float32),
        rng.uniform(0, 2 * np.pi, shape).astype(np.float32),
    )


@pytest.mark.parametrize("name,t0", [("ks", 0.0), ("kdv", 0.0), ("burgers", 1.3)])
def test_integrate_spectral(name, t0):
    """20 ETDRK4 steps with 2 saves, port against JAX, from the same state
    and (Burgers) the same forcing at a nonzero start time. The coefficients
    are the same complex128 numpy values cast to complex64; the FFTs differ
    in their float32 rounding, which the steps carry along: 1e-5 of max|u|
    (measured 3e-7 to 7e-7; each side is 4e-7 to 1.1e-6 from the port's
    float64 run). The first save is irfft(rfft(u0)) on both sides. The times
    are the same float32 arithmetic."""
    eq_j, eq_t = jeq.from_name(name), teq.from_name(name)
    grid_j, grid_t = JGrid(64, eq_j.period), TGrid(64, eq_t.period)
    u = 0.5 * _field((4, 64), eq_j.period, seed=4, modes=(1, 2, 3))
    forcing_j = forcing_t = None
    if eq_j.forced:
        leaves = _numpy_forcing(np.random.default_rng(5), 4)
        forcing_j = jeq.ForcingParams(*(jnp.asarray(a) for a in leaves))
        forcing_t = teq.ForcingParams(*(torch.from_numpy(a) for a in leaves))
    dt = 0.2 * grid_j.dx
    times_j, want = jint.integrate_spectral(
        eq_j, grid_j, jnp.asarray(u), dt, 20, save_every=10, t0=t0, forcing=forcing_j)
    times_t, got = tint.integrate_spectral(
        eq_t, grid_t, torch.from_numpy(u), dt, 20, save_every=10, t0=t0, forcing=forcing_t)
    assert got.shape == np.asarray(want).shape == (3, 4, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(times_t.numpy(), np.asarray(times_j), rtol=1e-6)
    _close(got[0], u, 1e-6)
    _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tint.integrate_spectral(eq_t, grid_t, torch.from_numpy(u), dt, 20, save_every=3)


@pytest.mark.parametrize("name,cons", [("burgers", True), ("kdv", False), ("ks", True)])
def test_spectral_differentiator_rhs(name, cons):
    """The spectral scheme's RHS (always the direct form), forced for
    Burgers at t = 0.7: float32 FFT derivatives up to the equation's highest
    order (2, 3, 4), whose Nyquist noise dominates as in
    test_spectral_derivative: 1e-5, 5e-5 and 1e-4 of max|u_t| (readings
    1.1e-6, 1.1e-5, 2.1e-5). The family tag is the original equation's."""
    eq_j, eq_t = jeq.from_name(name, conservative=cons), teq.from_name(name, conservative=cons)
    grid_j, grid_t = JGrid(64, eq_j.period), TGrid(64, eq_t.period)
    u = _field((3, 64), eq_j.period, seed=6, modes=(1, 2, 3))
    forcing_j = forcing_t = None
    if eq_j.forced:
        leaves = _numpy_forcing(np.random.default_rng(7), 3)
        forcing_j = jeq.ForcingParams(*(jnp.asarray(a) for a in leaves))
        forcing_t = teq.ForcingParams(*(torch.from_numpy(a) for a in leaves))
    rhs_j = jint.SpectralDifferentiator(eq_j, grid_j).rhs_fn(forcing_j)
    rhs_t = tint.SpectralDifferentiator(eq_t, grid_t, device="cpu").rhs_fn(forcing_t)
    assert rhs_t.conservative == cons
    want = rhs_j(jnp.asarray(u), jnp.float32(0.7))
    got = rhs_t(torch.from_numpy(u), torch.tensor(0.7))
    _close(got, want, {"burgers": 1e-5, "kdv": 5e-5, "ks": 1e-4}[name])


def test_energy_spectrum():
    """numpy on both sides: equal to float64 rounding."""
    u = _field((5, 3, 64), 64.0, seed=8)
    k_j, e_j = janalysis.energy_spectrum(u, 64.0)
    k_t, e_t = tanalysis.energy_spectrum(u, 64.0)
    np.testing.assert_array_equal(k_t, k_j)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-12)
    assert e_t.shape == (33,) and np.argmax(e_t) in (1, 2, 5)
