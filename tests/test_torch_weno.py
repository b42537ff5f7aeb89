"""The port's WENO5 Burgers baseline against the JAX package's, and the
properties of tests/test_weno.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import weno as jweno
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch import weno as tweno
from pde_superresolution_torch.grids import Grid as TGrid

torch.set_num_threads(1)

# float32 on both sides, the same roll-based operations in the same order
TOL = 1e-6


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["reconstruct_left", "reconstruct_right", "burgers_flux"])
def test_reconstructions_against_jax(name):
    """Each function on the same numpy input, within 1e-6 of max|output|."""
    f = _field(0, (3, 64))
    want = np.asarray(getattr(jweno, name)(jnp.asarray(f)))
    got = getattr(tweno, name)(torch.from_numpy(f)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("conservative,forced,t", [
    (True, False, 0.0), (False, False, 0.0), (True, True, 1.3), (False, True, 0.7)])
def test_rhs_against_jax(conservative, forced, t):
    """WENODifferentiator.rhs_fn, unforced and forced (cell-averaged forcing
    when conservative) at t != 0, within 1e-6 of max|u_t|."""
    eq_j = jeq.BurgersEquation(eta=0.02, conservative=conservative)
    eq_t = teq.BurgersEquation(eta=0.02, conservative=conservative)
    grid_j = JGrid(256, eq_j.period).resample(4, conservative=conservative)
    grid_t = TGrid(256, eq_t.period).resample(4, conservative=conservative)
    u = _field(1, (4, 64))
    forcing_j = forcing_t = None
    if forced:
        rng = np.random.default_rng(2)
        shape = (4, 20)
        leaves = [rng.uniform(-0.5, 0.5, shape), rng.uniform(-0.4, 0.4, shape),
                  rng.integers(3, 7, shape) * np.where(rng.uniform(size=shape) < 0.5, 1, -1),
                  rng.uniform(0, 2 * np.pi, shape)]
        leaves = [np.asarray(a, dtype=np.float32) for a in leaves]
        forcing_j = jeq.ForcingParams(*(jnp.asarray(a) for a in leaves))
        forcing_t = teq.ForcingParams(*(torch.from_numpy(a) for a in leaves))
    want = np.asarray(jweno.WENODifferentiator(eq_j, grid_j).rhs_fn(forcing_j)(jnp.asarray(u), t))
    rhs = tweno.WENODifferentiator(eq_t, grid_t, device="cpu").rhs_fn(forcing_t)
    assert rhs.conservative is True
    got = rhs(torch.from_numpy(u), torch.tensor(t)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_smooth_flux_difference_is_fifth_order():
    """(h_{j+1/2} - h_{j-1/2}) / dx approximates f'(x_j) at 5th order."""
    errs = []
    for n in (32, 64):
        x = np.arange(n) * 2 * np.pi / n
        h = tweno.reconstruct_left(torch.from_numpy(np.sin(x))).numpy()
        deriv = (h - np.roll(h, 1)) * n / (2 * np.pi)
        errs.append(np.abs(deriv - np.cos(x)).max())
    assert np.log2(errs[0] / errs[1]) > 4.0, errs


def test_left_right_mirror_symmetry():
    f = torch.from_numpy(_field(0, (32,)))
    left = tweno.reconstruct_left(f).numpy()
    right_via_flip = np.roll(tweno.reconstruct_left(f.flip(0)).numpy()[::-1], -1)
    right = tweno.reconstruct_right(f).numpy()
    np.testing.assert_allclose(right, right_via_flip, rtol=1e-5, atol=1e-6)
    assert not np.allclose(left, right)


def test_no_overshoot_at_step():
    f = torch.from_numpy(np.where(np.arange(64) < 32, 1.0, 0.0).astype(np.float32))
    got = tweno.reconstruct_left(f).numpy()
    assert got.min() > -0.01 and got.max() < 1.01


def test_matches_spectral_on_smooth():
    eq = teq.BurgersEquation(eta=0.1)
    grid = TGrid(128, eq.period)
    u = torch.from_numpy((0.5 * np.sin(grid.x)).astype(np.float32))
    ut_weno = tweno.WENODifferentiator(eq, grid, device="cpu").rhs_fn()(u, 0.0)
    ut_spec = tint.SpectralDifferentiator(eq, grid, device="cpu").rhs_fn()(u, 0.0)
    np.testing.assert_allclose(ut_weno.numpy(), ut_spec.numpy(), atol=5e-3)


def test_shock_stays_monotone():
    """A steepening sine with tiny viscosity: no blowup, total variation
    does not grow."""
    eq = teq.BurgersEquation(eta=1e-4)
    grid = TGrid(64, eq.period)
    u0 = torch.from_numpy(np.sin(grid.x).astype(np.float32))
    rhs = tweno.WENODifferentiator(eq, grid, device="cpu").rhs_fn()
    _, traj = tint.integrate(rhs, u0, 0.3 * grid.dx, 100, method="rk3_ssp")
    final = traj[-1].numpy()
    assert np.isfinite(final).all()
    tv0 = np.abs(np.diff(u0.numpy(), append=u0.numpy()[0])).sum()
    tv1 = np.abs(np.diff(final, append=final[0])).sum()
    assert tv1 < tv0 * 1.05, (tv0, tv1)


def test_conserves_mass_without_forcing():
    eq = teq.BurgersEquation(eta=0.01)
    grid = TGrid(64, eq.period)
    ut = tweno.WENODifferentiator(eq, grid, device="cpu").rhs_fn()(
        torch.from_numpy(_field(1, (64,))), 0.0)
    assert abs(float(ut.mean())) < 1e-5


def test_rejects_non_burgers():
    eq = teq.KSEquation()
    with pytest.raises(ValueError, match="Burgers only"):
        tweno.WENODifferentiator(eq, TGrid(64, eq.period), device="cpu")
