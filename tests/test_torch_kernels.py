"""The fused kernels' plain versions against the JAX Pallas kernels (interpret
mode on the CPU), and the wrappers' checks. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models import StencilModel as JModel
from pde_superresolution_tpu.ops import pallas_kernels as pk
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.models import ModelConfig as TConfig
from pde_superresolution_torch.models import StencilModel as TModel
from pde_superresolution_torch.ops import fused_kernels as fk

torch.set_num_threads(1)

BATCH, NX = 8, 128  # the Pallas kernels need batch % 8 == 0 and nx % 128 == 0


def _pair(name, cons, size, seed=0):
    rng = np.random.default_rng(seed)
    eq_j = jeq.from_name(name, conservative=cons)
    grid_j = JGrid(8 * NX, eq_j.period).resample(8, conservative=cons)
    model_j = JModel(eq_j, grid_j, JConfig(num_layers=2, filters=8, stencil_size=size))
    tree = jax.tree.map(
        lambda leaf: np.asarray(leaf)
        + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32),
        model_j.init_params(jax.random.PRNGKey(0)),
    )
    eq_t = teq.from_name(name, conservative=cons)
    grid_t = TGrid(8 * NX, eq_t.period).resample(8, conservative=cons)
    model_t = TModel(eq_t, grid_t, TConfig(num_layers=2, filters=8, stencil_size=size),
                     device="cpu")
    x = grid_j.x
    u = np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / eq_j.period
                                        + rng.uniform(0, 2 * np.pi))
            for k in (1, 2, 3))
        for _ in range(BATCH)
    ]).astype(np.float32)
    return model_j, tree, model_t, convert.params_from_jax(tree, "cpu"), u


FORMS = [("burgers", True, 6), ("burgers", False, 5), ("kdv", True, 6),
         ("kdv", False, 7), ("ks", True, 6), ("ks", False, 7)]


@pytest.mark.parametrize("name,cons,size", FORMS)
def test_fused_rhs_plain_matches_pallas(name, cons, size):
    """fused_rhs_plain against make_fused_rhs(interpret=True) on the same
    float32 coefficients (taken from the JAX model) and, for Burgers, the
    same forcing field: tap sums of <= 7 products in possibly other orders,
    then a face difference divided by dx that cancels most of the sum
    (measured 4e-5 of max|u_t| for conservative KdV), so within 1e-4 of
    max|u_t|."""
    model_j, tree, model_t, _, u = _pair(name, cons, size)
    coeffs = model_j.coefficients(tree, jnp.asarray(u))
    forced = name == "burgers"
    f = np.random.default_rng(9).standard_normal(u.shape).astype(np.float32)
    offsets_map = {d: l.offsets for d, l in model_j.constraint_layers.items()}
    rhs_j = pk.make_fused_rhs(model_j.equation, model_j.grid, offsets_map,
                              model_j._shift, forced=forced, interpret=True)
    want = np.asarray(rhs_j(jnp.asarray(u), coeffs, jnp.asarray(f) if forced else None))
    got = fk.fused_rhs(
        torch.from_numpy(u),
        {d: torch.from_numpy(np.array(c)) for d, c in coeffs.items()},
        torch.from_numpy(f) if forced else None,
        model_t.equation, model_t.grid, model_t.taps,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def flagship():
    model_j, params_j, _ = load_model("artifacts/ckpt_ks8")
    model_t, params_t, _ = convert.load_asset("ckpt_ks8", device="cpu")
    return model_j, params_j, model_t, params_t


def _check_learned_rk4(model_j, params_j, model_t, params_t, u, steps=3):
    dt = model_j.equation.stable_time_step(model_j.grid, u_scale=3.0)
    adv = model_j.fused_rk4_fn(params_j, dt, steps, batch_tile=8, interpret=True)
    want = np.asarray(adv(jnp.asarray(u)))
    got = model_t.fused_rk4_fn(params_t, dt, steps)(torch.from_numpy(u)).numpy()
    return np.abs(got - want).max() / np.abs(want).max()


def test_fused_learned_rk4_plain_matches_pallas_flagship(flagship):
    """fused_learned_rk4_plain (bf16-rounded tower inputs, float32 sums)
    against the Pallas kernel in interpret mode, which rounds at the same
    places: 3 RK4 steps of the KS-8x checkpoint. Tolerance 1e-4 relative to
    max|u|; measured 6.6e-8 on the CPU. A float32 difference in the sums can flip
    one bf16 rounding, which is why the bound is not a few ulps."""
    model_j, params_j, model_t, params_t = flagship
    rng = np.random.default_rng(11)
    x = model_j.grid.x
    u = np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / 64 + rng.uniform(0, 6.3))
            for k in (1, 2, 3))
        for _ in range(BATCH)
    ]).astype(np.float32)
    assert _check_learned_rk4(model_j, params_j, model_t, params_t, u) < 1e-4


@pytest.mark.parametrize("name,cons,size", [("kdv", True, 6), ("ks", False, 7)])
def test_fused_learned_rk4_plain_matches_pallas(name, cons, size):
    """The same comparison for a small perturbed model (2 layers x 8
    filters): tolerance 1e-4 relative to max|u|."""
    model_j, tree, model_t, params_t, u = _pair(name, cons, size)
    assert _check_learned_rk4(model_j, tree, model_t, params_t, 0.3 * u) < 1e-4


def _ks_inputs():
    eq = teq.from_name("ks", conservative=True)
    grid = TGrid(8 * NX, eq.period).resample(8, conservative=True)
    model = TModel(eq, grid, TConfig(num_layers=1, filters=8, stencil_size=6),
                   device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    u = eq.initial_conditions(torch.Generator().manual_seed(1), grid, (2,), "cpu")
    return model, params, u, model.coefficients(params, u)


def test_fused_rhs_wrapper_checks():
    model, _, u, coeffs = _ks_inputs()
    args = (model.equation, model.grid, model.taps)
    before = fk.fused_rhs.launches
    fk.fused_rhs(u, coeffs, None, *args)
    assert fk.fused_rhs.launches == before  # the CPU runs the plain version
    with pytest.raises(TypeError, match="float32"):
        fk.fused_rhs(u.double(), coeffs, None, *args)
    with pytest.raises(ValueError, match="shape"):
        fk.fused_rhs(u, {**coeffs, 0: coeffs[0][:, :, :5].contiguous()}, None, *args)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fused_rhs(u, {**coeffs, 1: coeffs[1].transpose(0, 1).contiguous()
                         .transpose(0, 1)}, None, *args)
    with pytest.raises(ValueError, match="needs orders"):
        fk.fused_rhs(u, {d: coeffs[d] for d in (0, 1)}, None, model.equation,
                     model.grid, {d: model.taps[d] for d in (0, 1)})
    with pytest.raises(ValueError, match="forward only"):
        fk.fused_rhs(u.clone().requires_grad_(), coeffs, None, *args)
    with pytest.raises(ValueError, match="shape"):
        fk.fused_rhs(u, coeffs, torch.zeros(3, NX), *args)


def test_fused_learned_rk4_wrapper_checks():
    model, params, u, _ = _ks_inputs()
    advance = model.fused_rk4_fn(params, 1e-3, 2)
    before = fk.fused_learned_rk4.launches
    advance(u)
    assert fk.fused_learned_rk4.launches == before
    forcing = teq.from_name("burgers").sample_forcing(
        torch.Generator().manual_seed(0), (2,), "cpu")
    with pytest.raises(NotImplementedError, match="forced fused learned RK4"):
        model.fused_rk4_fn(params, 1e-3, 2, forcing=forcing)(u)
    with pytest.raises(ValueError, match="forward only"):
        advance(u.clone().requires_grad_())
    with pytest.raises(TypeError, match="float32"):
        advance(u.double())
    with pytest.raises(ValueError, match=r"\[batch, nx\]"):
        advance(u[0])
    burgers = TModel(teq.from_name("burgers", conservative=True),
                     TGrid(NX, 2 * np.pi), TConfig(stencil_size=6), device="cpu")
    with pytest.raises(ValueError, match="forced"):
        burgers.fused_rk4_fn(burgers.init_params(torch.Generator()), 1e-3, 1)


def test_pack_rejects_even_kernel():
    eq = teq.from_name("ks", conservative=True)
    model = TModel(eq, TGrid(NX, eq.period),
                   TConfig(num_layers=1, filters=8, kernel_size=4, stencil_size=6),
                   device="cpu")
    with pytest.raises(ValueError, match="odd"):
        model.fused_rk4_fn(model.init_params(torch.Generator()), 1e-3, 1)
