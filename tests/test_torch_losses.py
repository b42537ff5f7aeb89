"""The port's training losses against the JAX package's, on the same inputs.

Data come from the JAX package's generator (numpy snapshots), params from a
JAX init perturbed with numpy draws (non-zero heads), and both packages get
the same numpy arrays. Gradients are compared in the port's layout
(``convert.params_from_jax`` of JAX's gradient tree).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models.stencil_net import StencilModel as JModel
from pde_superresolution_tpu.training import build_training_data as jbuild
from pde_superresolution_tpu.training import generate_snapshots as jgenerate
from pde_superresolution_tpu.training import losses as jlosses
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.models import ModelConfig as TConfig
from pde_superresolution_torch.models import StencilModel as TModel
from pde_superresolution_torch.ops import fused_kernels as fk
from pde_superresolution_torch.training import data as tdata
from pde_superresolution_torch.training import losses as tlosses

torch.set_num_threads(1)

DT = 0.05
# KdV's exact solve at the fine grid of 128 points blows up from the unit
# amplitude within 0.3 time units; half the amplitude stays smooth
IC_SCALE = {"kdv": 0.5}


def to_torch_data(data):
    """A JAX TrainingData as the port's, through numpy."""
    t = lambda a: torch.from_numpy(np.array(a))
    forcing = None
    if data.forcing is not None:
        forcing = teq.ForcingParams(*(t(leaf) for leaf in data.forcing))
    return tdata.TrainingData(
        inputs=t(data.inputs), t=t(data.t), forcing=forcing,
        deriv_labels={d: t(v) for d, v in data.deriv_labels.items()},
        time_deriv_label=t(data.time_deriv_label), rollout=t(data.rollout),
        traj_ids=t(data.traj_ids),
    )


def _case(name, cons, size, unroll=2, seed=0, fine_size=128, factor=4, scale=0.1):
    """(JAX model, params tree, JAX data, port model, port params, port data,
    substeps) for a small model with perturbed params on generated data."""
    rng = np.random.default_rng(seed)
    eq_j = jeq.from_name(name, conservative=cons)
    fine_j = JGrid(fine_size, eq_j.period)
    snaps = jgenerate(eq_j, fine_j, jax.random.PRNGKey(seed), num_trajectories=3,
                      num_times=5 + unroll, time_delta=DT, ic_scale=IC_SCALE.get(name, 1.0))
    data_j = jbuild(eq_j, fine_j, snaps, factor, unroll_steps=unroll)
    config = dict(num_layers=2, filters=8, stencil_size=size)
    model_j = JModel(eq_j, fine_j.resample(factor, conservative=cons), JConfig(**config))
    tree = jax.tree.map(
        lambda leaf: np.asarray(leaf) + scale * rng.standard_normal(leaf.shape).astype(np.float32),
        model_j.init_params(jax.random.PRNGKey(seed)),
    )
    eq_t = teq.from_name(name, conservative=cons)
    model_t = TModel(eq_t, TGrid(fine_size, eq_t.period).resample(factor, conservative=cons),
                     TConfig(**config), device="cpu")
    substeps = max(1, int(np.ceil(DT / model_j.stable_time_step(u_scale=3.0))))
    return (model_j, tree, data_j, model_t, convert.params_from_jax(tree, device="cpu"),
            to_torch_data(data_j), substeps)


def _torch_value_and_grad(fn, params):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    value, aux = fn(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), aux, dict(zip(leaves, grads))


def _assert_grads_close(got: dict, tree_grads, tol: float):
    want = convert.params_from_jax(jax.tree.map(np.asarray, tree_grads), device="cpu")
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= tol * scale, (k, err, scale)


# -- the divergence guard ---------------------------------------------------------


def test_divergence_guard_value_and_gradient_match_jax():
    """Exactly JAX's clip(nan_to_num(x)) and its gradient: 1 inside, 0
    outside and at replaced values, 0.5 at a finite value on a bound (where
    jnp.clip's max/min split the tie; torch.clamp alone would pass 1)."""
    clip = tlosses.ROLLOUT_CLIP
    x = np.array([0.5, -99.99, clip, -clip, 150.0, -150.0, np.nan, np.inf, -np.inf],
                 np.float32)
    w = np.arange(1, x.size + 1, dtype=np.float32)

    def guard_j(v):
        v = jnp.nan_to_num(v, nan=clip, posinf=clip, neginf=-clip)
        return jnp.clip(v, -clip, clip)

    want_value = np.asarray(guard_j(x))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(w * guard_j(v)))(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tlosses.divergence_guard(xt, clip)
    (grad,) = torch.autograd.grad((torch.from_numpy(w) * got).sum(), xt)
    np.testing.assert_array_equal(got.detach().numpy(), want_value)
    np.testing.assert_array_equal(grad.numpy(), want_grad)
    assert want_grad[2] == 0.5 * w[2] and want_grad[3] == 0.5 * w[3]


# -- rollout_states -----------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rollout_states_values_and_gradients_match_jax(use_kernel):
    """A stable rollout (KS conservative, 2 snapshots): states within 1e-5 of
    max|u| and the gradient of a weighted sum of the states within 1e-4 of
    each leaf's largest value (float32 on both sides, other summation
    orders in the convolutions and sums)."""
    model_j, tree, data_j, model_t, params_t, data_t, substeps = _case("ks", True, 6)
    w = np.random.default_rng(3).standard_normal((2,) + data_j.inputs.shape).astype(np.float32)

    def total_j(p):
        states = jlosses.rollout_states(model_j.rhs_fn(p), data_j.inputs, data_j.t, DT,
                                        substeps, 2)
        return jnp.sum(w * states), states

    (_, want_states), want_grads = jax.value_and_grad(total_j, has_aux=True)(tree)

    def total_t(p):
        states = tlosses.rollout_states(model_t.rhs_fn(p, use_kernel=use_kernel),
                                        data_t.inputs, data_t.t, DT, substeps, 2)
        return (torch.from_numpy(w) * states).sum(), states

    _, got_states, got_grads = _torch_value_and_grad(total_t, params_t)
    want_states = np.asarray(want_states)
    assert np.abs(got_states.detach().numpy() - want_states).max() <= 1e-5 * np.abs(want_states).max()
    _assert_grads_close(got_grads, want_grads, 1e-4)


def _unstable_case():
    """tests/test_training.py's guard case: KS at resample 2, dt 0.1 in one
    inner step, far beyond the fourth-derivative CFL limit."""
    eq_j = jeq.from_name("ks", conservative=True)
    fine = JGrid(256, eq_j.period)
    snaps = jgenerate(eq_j, fine, jax.random.PRNGKey(0), num_trajectories=3, num_times=8,
                      time_delta=0.1)
    data_j = jbuild(eq_j, fine, snaps, resample_factor=2, unroll_steps=2)
    config = dict(num_layers=1, filters=4, stencil_size=6)
    model_j = JModel(eq_j, fine.resample(2), JConfig(**config))
    tree = model_j.init_params(jax.random.PRNGKey(0))
    eq_t = teq.from_name("ks", conservative=True)
    model_t = TModel(eq_t, TGrid(256, eq_t.period).resample(2), TConfig(**config), device="cpu")
    params_t = convert.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    return model_j, tree, data_j, model_t, params_t, to_torch_data(data_j)


def test_unstable_rollout_guard_against_jax():
    """The unstable case: every member overshoots to inf/NaN within a step
    and is pinned by the guard. Both packages report a finite loss, the same
    finite fraction (0) and finite gradients. They do not agree to float
    tolerance, and cannot: which points overflow, and with which sign, is
    decided by float rounding in a blow-up, so the pinned states differ.
    Measured on the CPU: loss 3.0 (JAX) against 3.0398 (port), both with
    JAX's norms, and gradients within 6% of each leaf's largest value; the
    stated limits are 5% and 15%. The guard itself, including its gradient
    at the bounds, is exact (the test above)."""
    model_j, tree, data_j, model_t, params_t, data_t = _unstable_case()
    norms = jlosses.compute_loss_norms(model_j, data_j, 2, 0.1, substeps=1)
    (loss_j, parts_j), grads_j = jax.value_and_grad(
        lambda p: jlosses.compute_loss(model_j, p, data_j, norms, jlosses.LossWeights(),
                                       dt=0.1, unroll_steps=2, substeps=1),
        has_aux=True)(tree)
    loss_t, parts_t, grads_t = _torch_value_and_grad(
        lambda p: tlosses.compute_loss(model_t, p, data_t, norms, tlosses.LossWeights(),
                                       dt=0.1, unroll_steps=2, substeps=1), params_t)
    assert np.isfinite(float(loss_j)) and np.isfinite(float(loss_t))
    assert float(parts_t["rollout_finite_frac"]) == float(parts_j["rollout_finite_frac"]) == 0.0
    assert abs(float(loss_t) - float(loss_j)) <= 5e-2 * abs(float(loss_j))
    assert all(torch.isfinite(g).all() for g in grads_t.values())
    _assert_grads_close(grads_t, grads_j, 0.15)


# -- norms and the loss ---------------------------------------------------------


def test_compute_loss_norms_match_jax():
    """Host floats: the baseline MAEs within 1e-5 relative; the quantile
    floors (np.quantile on both sides) within 1e-6 of their label's largest
    value: a floor is the 10% quantile of errors some 1e-4 of the label, and
    each error carries the label's float32 rounding (read: 2e-3 of the floor
    itself, 6e-7 of the time label's largest value)."""
    model_j, _, data_j, model_t, _, data_t, substeps = _case("burgers", True, 6)
    want = jlosses.compute_loss_norms(model_j, data_j, 2, DT, substeps)
    got = tlosses.compute_loss_norms(model_t, data_t, 2, DT, substeps)
    close = lambda a, b, tol: abs(a - b) <= tol * abs(b)
    near = lambda a, b, label: abs(a - b) <= 1e-6 * float(label.abs().max())
    assert set(got.derivs) == set(want.derivs)
    for d in want.derivs:
        assert close(got.derivs[d], want.derivs[d], 1e-5)
        assert near(got.deriv_floors[d], want.deriv_floors[d], data_t.deriv_labels[d])
    assert close(got.time_deriv, want.time_deriv, 1e-5)
    assert near(got.time_floor, want.time_floor, data_t.time_deriv_label)
    assert len(got.integrated) == len(want.integrated) == 2
    for a, b in zip(got.integrated, want.integrated):
        assert close(a, b, 1e-5)
    for a, b in zip(got.integrated_floors, want.integrated_floors):
        assert near(a, b, data_t.rollout)
    assert tlosses.truncate_norms(got, 1).integrated == got.integrated[:1]
    with pytest.raises(ValueError, match="truncate"):
        tlosses.truncate_norms(got, 3)


LOSS_CASES = [  # (equation, conservative, stencil, unroll, relative_error)
    ("ks", True, 6, 2, 0.0),
    ("ks", True, 6, 2, 0.5),
    ("ks", True, 6, 0, 0.0),
    ("burgers", True, 6, 2, 0.0),
    ("kdv", False, 7, 2, 0.0),
    ("kdv", False, 7, 0, 0.5),
]


@pytest.mark.parametrize("name,cons,size,unroll,rel", LOSS_CASES)
def test_compute_loss_value_and_grad_match_jax(name, cons, size, unroll, rel):
    """One step's loss, every part and every gradient leaf against
    jax.value_and_grad with the same norms. float32 on both sides: the loss
    and parts within 1e-5 relative, each gradient leaf within 1e-4 of its
    largest value (other summation orders in the tower and the means). The
    relative-error form divides by the baseline's pointwise error, floored
    at its 10% quantile: where that error is some 1e-5 of the field, the
    field's float32 rounding moves the quotient by 1e-3 of itself (read on
    the CPU: 4.0e-4 on a derivative part, 3.7e-3 on the integrated part,
    4.3e-3 of a gradient leaf), so with relative_error > 0 the parts and
    the loss are held to 1e-2 relative and the gradients to 1e-2 of each
    leaf."""
    model_j, tree, data_j, model_t, params_t, data_t, substeps = _case(name, cons, size, unroll)
    weights_j = jlosses.LossWeights(absolute_error=1.0 - rel / 2, relative_error=rel)
    weights_t = tlosses.LossWeights(absolute_error=1.0 - rel / 2, relative_error=rel)
    norms = jlosses.compute_loss_norms(model_j, data_j, unroll, DT, substeps)
    (loss_j, parts_j), grads_j = jax.value_and_grad(
        lambda p: jlosses.compute_loss(model_j, p, data_j, norms, weights_j, dt=DT,
                                       unroll_steps=unroll, substeps=substeps),
        has_aux=True)(tree)
    loss_t, parts_t, grads_t = _torch_value_and_grad(
        lambda p: tlosses.compute_loss(model_t, p, data_t, norms, weights_t, dt=DT,
                                       unroll_steps=unroll, substeps=substeps), params_t)
    tol, grad_tol = (1e-2, 1e-2) if rel > 0 else (1e-5, 1e-4)
    assert set(parts_t) == set(parts_j)
    for k in parts_j:
        assert abs(float(parts_t[k]) - float(parts_j[k])) <= tol * abs(float(parts_j[k])), k
    assert abs(float(loss_t) - float(loss_j)) <= tol * abs(float(loss_j))
    _assert_grads_close(grads_t, grads_j, grad_tol)


@pytest.mark.parametrize("name,cons,size", [("ks", True, 6), ("burgers", True, 6)])
def test_compute_loss_kernel_route_equals_plain_route(name, cons, size):
    """use_kernel=True runs the fused_rhs Function (its plain forward on the
    CPU, the plain VJP backward) and must equal use_kernel=False: the same
    operations, so equal to 1e-6 relative (loss) and 1e-6 of each leaf."""
    _, _, data_j, model_t, params_t, data_t, substeps = _case(name, cons, size, 2)
    norms = tlosses.compute_loss_norms(model_t, data_t, 2, DT, substeps)
    runs = [
        _torch_value_and_grad(
            lambda p: tlosses.compute_loss(model_t, p, data_t, norms, tlosses.LossWeights(),
                                           dt=DT, unroll_steps=2, substeps=substeps,
                                           use_kernel=k), params_t)
        for k in (True, False)
    ]
    (loss_k, _, grads_k), (loss_p, _, grads_p) = runs
    assert abs(float(loss_k) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    for k in grads_p:
        assert float((grads_k[k] - grads_p[k]).abs().max()) <= 1e-6 * float(grads_p[k].abs().max())


def test_compute_loss_rollout_noise_is_seeded():
    """Rollout noise from a seeded generator: the same seed gives the same
    loss, another seed another one, and no generator means no noise."""
    _, _, _, model_t, params_t, data_t, substeps = _case("ks", True, 6)
    norms = tlosses.compute_loss_norms(model_t, data_t, 2, DT, substeps)

    def loss(generator):
        return float(tlosses.compute_loss(
            model_t, params_t, data_t, norms, tlosses.LossWeights(), dt=DT, unroll_steps=2,
            substeps=substeps, rollout_noise=0.1, noise_generator=generator)[0])

    seeded = lambda s: torch.Generator().manual_seed(s)
    assert loss(seeded(1)) == loss(seeded(1)) != loss(seeded(2))
    clean = float(tlosses.compute_loss(model_t, params_t, data_t, norms, tlosses.LossWeights(),
                                       dt=DT, unroll_steps=2, substeps=substeps)[0])
    assert loss(None) == clean != loss(seeded(1))


# -- the fused_rhs Function -------------------------------------------------------


@pytest.mark.parametrize("name,cons,size,forced", [
    ("ks", True, 6, False), ("burgers", True, 6, True), ("kdv", False, 7, False),
])
def test_fused_rhs_backward_gradcheck(name, cons, size, forced):
    """The Function's backward (fused_rhs_vjp, the plain version's VJP)
    against finite differences in float64 (torch.autograd.gradcheck; the
    Function's CPU forward takes any dtype, the public wrapper float32
    only), with gradients to u, every order's coefficients and f."""
    eq = teq.from_name(name, conservative=cons)
    grid = TGrid(8 * 16, eq.period).resample(8, conservative=cons)
    model = TModel(eq, grid, TConfig(num_layers=1, filters=4, stencil_size=size), device="cpu")
    gen = torch.Generator().manual_seed(0)
    u = eq.initial_conditions(gen, grid, (2,), "cpu").double().requires_grad_()
    orders = sorted(model.taps)
    coeffs = [(torch.randn(2, grid.size, len(model.taps[d]), generator=gen, dtype=torch.float64)
               / grid.dx ** d).requires_grad_() for d in orders]
    f = (torch.randn(2, grid.size, generator=gen, dtype=torch.float64).requires_grad_()
         if forced else None)
    static = (eq, grid, {d: model.taps[d] for d in orders})
    assert torch.autograd.gradcheck(
        lambda u, f, *c: fk._FusedRhs.apply(static, u, f, *c), (u, f, *coeffs),
        eps=1e-6, atol=1e-5, rtol=1e-4)


def test_fused_rhs_under_grad_counts_forward_launches_only():
    """The wrapper returns a differentiable tensor for inputs that require
    grad; its backward launches nothing (the counter counts kernel
    launches, and the CPU launches none)."""
    eq = teq.from_name("ks", conservative=True)
    grid = TGrid(8 * 16, eq.period).resample(8, conservative=True)
    model = TModel(eq, grid, TConfig(num_layers=1, filters=4, stencil_size=6), device="cpu")
    params = {k: v.requires_grad_() for k, v in
              model.init_params(torch.Generator().manual_seed(0)).items()}
    u = eq.initial_conditions(torch.Generator().manual_seed(1), grid, (2,), "cpu")
    before = fk.fused_rhs.launches
    out = model.rhs_fn(params, use_kernel=True)(u, 0.0)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert all(p.grad is not None for p in params.values())
    assert fk.fused_rhs.launches == before
