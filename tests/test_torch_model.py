"""The port's StencilModel against the JAX package's (use_pallas=False)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models import StencilModel as JModel
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import convert, integrate as tint
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.models import ModelConfig as TConfig
from pde_superresolution_torch.models import StencilModel as TModel

torch.set_num_threads(1)

CASES = [  # (equation, conservative, stencil size)
    ("ks", True, 6), ("ks", False, 7), ("kdv", True, 6), ("burgers", False, 5),
]


def _pair(name, cons, size, seed=0, **config):
    """The same small model in both packages with perturbed (non-zero head)
    params drawn with numpy, and a smooth batch of fields."""
    rng = np.random.default_rng(seed)
    eq_j = jeq.from_name(name, conservative=cons)
    grid_j = JGrid(512, eq_j.period).resample(8, conservative=cons)
    model_j = JModel(eq_j, grid_j, JConfig(num_layers=2, filters=8,
                                           stencil_size=size, **config))
    tree = jax.tree.map(
        lambda leaf: np.asarray(leaf)
        + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32),
        model_j.init_params(jax.random.PRNGKey(0)),
    )
    eq_t = teq.from_name(name, conservative=cons)
    model_t = TModel(eq_t, TGrid(512, eq_t.period).resample(8, conservative=cons),
                     TConfig(num_layers=2, filters=8, stencil_size=size, **config),
                     device="cpu")
    params_t = convert.params_from_jax(tree, device="cpu")
    x = grid_j.x
    u = np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / eq_j.period
                                        + rng.uniform(0, 2 * np.pi))
            for k in (1, 2, 3))
        for _ in range(4)
    ]).astype(np.float32)
    return model_j, tree, model_t, params_t, u


@pytest.mark.parametrize("name,cons,size", CASES)
def test_coefficients_match(name, cons, size):
    """Tower (float32 convs, full precision on the JAX CPU path) and the
    float32 projection: same operations, other summation orders, so
    agreement to rtol 1e-5 of each coefficient order's largest value."""
    model_j, tree, model_t, params_t, u = _pair(name, cons, size)
    want = model_j.coefficients(tree, jnp.asarray(u))
    got = model_t.coefficients(params_t, torch.from_numpy(u))
    assert sorted(got) == sorted(want)
    for d in want:
        w = np.asarray(want[d])
        assert got[d].shape == w.shape
        np.testing.assert_allclose(got[d].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name,cons,size", CASES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_rhs_fn_matches(name, cons, size, use_kernel):
    """rhs_fn on the CPU, plain path and the kernel wrapper's plain version:
    within 1e-4 of max|u_t|. Two float32 implementations of a stencil RHS
    whose high-order terms cancel cannot be held tighter (the JAX float32
    RHS itself sits 2e-5 of max|u_t| from its float64 evaluation)."""
    model_j, tree, model_t, params_t, u = _pair(name, cons, size)
    forcing_j = forcing_t = None
    if model_j.equation.forced:
        rng = np.random.default_rng(5)
        leaves = [rng.uniform(-0.5, 0.5, (4, 6)), rng.uniform(-0.4, 0.4, (4, 6)),
                  rng.integers(3, 7, (4, 6)) * 1.0, rng.uniform(0, 6.28, (4, 6))]
        leaves = [np.asarray(x, np.float32) for x in leaves]
        forcing_j = jeq.ForcingParams(*map(jnp.asarray, leaves))
        forcing_t = teq.ForcingParams(*map(torch.from_numpy, leaves))
    t = 0.25
    want = np.asarray(model_j.rhs_fn(tree, forcing_j, use_pallas=False)(
        jnp.asarray(u), jnp.float32(t)))
    rhs = model_t.rhs_fn(params_t, forcing_t, use_kernel=use_kernel)
    assert rhs.conservative == cons
    got = rhs(torch.from_numpy(u), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_bfloat16_tower_matches():
    """tower_dtype='bfloat16': activations and weights in bf16 on both
    sides; bf16 keeps 8 bits, and the two frameworks may round the conv
    sums at other points, so agreement is to 2e-2 of max|c|."""
    model_j, tree, model_t, params_t, u = _pair("ks", True, 6,
                                                tower_dtype="bfloat16")
    want = model_j.coefficients(tree, jnp.asarray(u))
    got = model_t.coefficients(params_t, torch.from_numpy(u))
    for d in want:
        w = np.asarray(want[d])
        assert got[d].dtype == torch.float32
        np.testing.assert_allclose(got[d].numpy(), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max())


@pytest.mark.parametrize("name,cons,size", CASES + [("ks", True, 12)])
def test_linear_stability_bound_matches(name, cons, size):
    """The same float32 jvp of the classic scheme, FFT and bisection in
    float64: the bound agrees to 1e-6 relative; stable_time_step too."""
    model_j, _, model_t, _, _ = _pair(name, cons, size)
    want = model_j.linear_stability_bound()
    assert model_t.linear_stability_bound() == pytest.approx(want, rel=1e-6)
    assert model_t.stable_time_step(u_scale=3.0) == pytest.approx(
        model_j.stable_time_step(u_scale=3.0), rel=1e-6)


def test_fresh_model_is_the_classic_baseline():
    """Zero-initialized heads: the learned RHS equals the polynomial
    baseline's exactly in structure (same stencils), to float32 rounding."""
    eq = teq.from_name("ks", conservative=True)
    grid = TGrid(512, eq.period).resample(8, conservative=True)
    model = TModel(eq, grid, TConfig(num_layers=2, filters=8, stencil_size=6),
                   device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    assert params["tower.0.weight"].shape == (8, 1, 5)
    assert float(params["heads.3.weight"].abs().max()) == 0.0
    u = eq.initial_conditions(torch.Generator().manual_seed(1), grid, (4,), "cpu")
    base = tint.PolynomialDifferentiator(eq, grid, stencil_size=6, device="cpu")
    want = base.rhs_fn()(u, 0.0)
    got = model.rhs_fn(params)(u, 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.fixture(scope="module")
def flagship():
    model_j, params_j, _ = load_model("artifacts/ckpt_ks8")
    model_t, params_t, _ = convert.load_asset("ckpt_ks8", device="cpu")
    return model_j, params_j, model_t, params_t


def test_flagship_rhs_matches(flagship):
    """The KS-8x checkpoint's RHS (trained heads) on 8 smooth fields of
    amplitude about 3: within 1e-4 of max|u_t| (see test_rhs_fn_matches)."""
    model_j, params_j, model_t, params_t = flagship
    rng = np.random.default_rng(7)
    x = model_j.grid.x
    u = np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / 64 + rng.uniform(0, 6.3))
            for k in (1, 2, 3))
        for _ in range(8)
    ]).astype(np.float32)
    want = np.asarray(model_j.rhs_fn(params_j, use_pallas=False)(jnp.asarray(u), 0.0))
    for use_kernel in (False, True):
        got = model_t.rhs_fn(params_t, use_kernel=use_kernel)(torch.from_numpy(u), 0.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    eq = teq.from_name("ks", conservative=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(eq, TGrid(128, eq.period))
