"""The fused kernels' plain versions against the JAX Pallas kernels (interpret
mode on the CPU), and the wrappers' checks. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.models import ModelConfig as JConfig
from pde_superresolution_tpu.models import StencilModel as JModel
from pde_superresolution_tpu.ops import pallas_kernels as pk
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.models import ModelConfig as TConfig
from pde_superresolution_torch.models import StencilModel as TModel
from pde_superresolution_torch.ops import fused_kernels as fk

torch.set_num_threads(1)

BATCH, NX = 8, 128  # the Pallas kernels need batch % 8 == 0 and nx % 128 == 0


def _pair(name, cons, size, seed=0, filters=8, nx=NX, kernel_size=5):
    rng = np.random.default_rng(seed)
    eq_j = jeq.from_name(name, conservative=cons)
    grid_j = JGrid(8 * nx, eq_j.period).resample(8, conservative=cons)
    model_j = JModel(eq_j, grid_j, JConfig(num_layers=2, filters=filters, stencil_size=size,
                                           kernel_size=kernel_size))
    tree = jax.tree.map(
        lambda leaf: np.asarray(leaf)
        + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32),
        model_j.init_params(jax.random.PRNGKey(0)),
    )
    eq_t = teq.from_name(name, conservative=cons)
    grid_t = TGrid(8 * nx, eq_t.period).resample(8, conservative=cons)
    model_t = TModel(eq_t, grid_t, TConfig(num_layers=2, filters=filters, stencil_size=size,
                                           kernel_size=kernel_size), device="cpu")
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


@pytest.mark.parametrize("name,cons,size", [("ks", True, 6), ("kdv", False, 7)])
def test_fused_learned_rk4_plain_matches_pallas_128_filters(name, cons, size):
    """A tower of 128 filters (2 layers; the width the card's streamed form
    takes): the plain version against make_fused_learned_rk4(interpret=True),
    2 RK4 steps, weights through convert.params_from_jax. The same
    tolerance, 1e-4 of max|u|: a layer sums 640 bf16 products in float32,
    in other orders on the two sides, which can flip single bf16 roundings
    of the next layer's inputs. The kernel takes this width at nx = 128."""
    model_j, tree, model_t, params_t, u = _pair(name, cons, size, filters=128)
    assert _check_learned_rk4(model_j, tree, model_t, params_t, 0.3 * u, steps=2) < 1e-4
    pack = _pack(model_t, params_t)
    assert pack.padded_channels == 128 and fk.learned_rk4_refusal(pack, NX, 0) is None


@pytest.mark.parametrize("filters,name,cons,size", [(192, "ks", True, 6), (256, "kdv", False, 7)])
def test_fused_learned_rk4_plain_matches_pallas_wide(filters, name, cons, size):
    """Towers of 192 and 256 filters (2 layers; widths the card's chunked
    form takes, in output chunks of 128 channels): the plain version against
    make_fused_learned_rk4(interpret=True), 2 RK4 steps, at the 128-filter
    test's tolerance, 1e-4 of max|u| (a layer sums 960 and 1280 bf16
    products, in other orders on the two sides). The kernel takes these
    widths at nx = 128 in the split form, the weights streamed."""
    model_j, tree, model_t, params_t, u = _pair(name, cons, size, filters=filters)
    assert _check_learned_rk4(model_j, tree, model_t, params_t, 0.3 * u, steps=2) < 1e-4
    pack = _pack(model_t, params_t)
    assert pack.padded_channels == filters and fk.learned_rk4_refusal(pack, NX, 0) is None
    _check_split(pack, NX, 0, fk.learned_rk4_launch(pack, NX, 0, BATCH), BATCH)


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
    # differentiable (the training slice): the backward is the plain VJP
    assert fk.fused_rhs(u.clone().requires_grad_(), coeffs, None, *args).grad_fn is not None
    assert fk.fused_rhs(u, coeffs, None, *args).grad_fn is None
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
    # forcing for an unforced equation raises at the call, as in JAX
    with pytest.raises(ValueError, match="unforced"):
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


def _numpy_forcing(seed, batch, terms=20):
    rng = np.random.default_rng(seed)
    shape = (batch, terms)
    return (
        rng.uniform(-0.5, 0.5, shape).astype(np.float32),
        rng.uniform(-0.4, 0.4, shape).astype(np.float32),
        (rng.integers(3, 7, shape) * rng.choice([-1.0, 1.0], shape)).astype(np.float32),
        rng.uniform(0, 2 * np.pi, shape).astype(np.float32),
    )


T0 = 3.7  # a start time after a warm-up: omega t0 is up to 1.5 rad


@pytest.mark.parametrize("cons,size", [(True, 6), (False, 5)])
def test_forced_learned_rk4_plain_matches_pallas(cons, size):
    """Burgers with the forcing evaluated inside the step, from t0 = 3.7:
    fused_learned_rk4_plain (rotated phase state, sum over 20 terms in term
    order) against the Pallas kernel in interpret mode on the same numpy
    ForcingParams, 3 RK4 steps of a small perturbed model. Both pack
    theta0 = omega t0 + kappa x + phi and its sin and cos in float32; the sums
    over terms run in another order. 1e-4 of max|u|, as for the unforced
    kernel (measured 7.7e-8; without the forcing 3.3e-2). The port's own
    rhs_fn + rk4_step (float32 tower, forcing from sin at each stage's time)
    bounds it at 2e-3, the JAX package's bound for its kernel against a
    float32 tower (measured 7.3e-6)."""
    model_j, tree, model_t, params_t, u = _pair("burgers", cons, size)
    leaves = _numpy_forcing(21, BATCH)
    forcing_j = jeq.ForcingParams(*(jnp.asarray(a) for a in leaves))
    forcing_t = teq.ForcingParams(*(torch.from_numpy(a) for a in leaves))
    dt = model_j.equation.stable_time_step(model_j.grid, u_scale=3.0)
    adv_j = model_j.fused_rk4_fn(tree, dt, 3, batch_tile=8, interpret=True,
                                 forcing=forcing_j, t0=T0)
    want = np.asarray(adv_j(jnp.asarray(u)))
    got = model_t.fused_rk4_fn(params_t, dt, 3, forcing=forcing_t, t0=T0)(
        torch.from_numpy(u)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    # the forcing matters at this tolerance: without it the state differs
    unforced = fk.fused_learned_rk4_plain(
        torch.from_numpy(u), model_t.fused_rk4_fn(params_t, dt, 3, forcing=forcing_t).pack,
        dt, 3).numpy()
    assert np.abs(unforced - want).max() / np.abs(want).max() > 1e-3
    rhs = model_t.rhs_fn(params_t, forcing_t, use_kernel=False)
    ref, t = torch.from_numpy(u), torch.tensor(T0)
    for _ in range(3):
        ref = tint.rk4_step(rhs, ref, t, dt)
        t = t + dt
    assert np.abs(got - ref.numpy()).max() / np.abs(ref.numpy()).max() < 2e-3


def test_forced_learned_rk4_plain_matches_pallas_long_grid():
    """Forced Burgers at nx 1536, a grid the card's kernel splits over a
    cluster of blocks (one block holds 640 points at the flagship's width):
    fused_learned_rk4_plain against make_fused_learned_rk4(interpret=True),
    batch tile 8, 2 RK4 steps from t0 = 3.7, on the same numpy forcing;
    1e-4 of max|u|, as at nx 128."""
    model_j, tree, model_t, params_t, u = _pair("burgers", True, 6, nx=1536)
    leaves = _numpy_forcing(25, BATCH)
    forcing_j = jeq.ForcingParams(*(jnp.asarray(a) for a in leaves))
    forcing_t = teq.ForcingParams(*(torch.from_numpy(a) for a in leaves))
    dt = model_j.equation.stable_time_step(model_j.grid, u_scale=3.0)
    adv_j = model_j.fused_rk4_fn(tree, dt, 2, batch_tile=8, interpret=True,
                                 forcing=forcing_j, t0=T0)
    want = np.asarray(adv_j(jnp.asarray(u)))
    advance = model_t.fused_rk4_fn(params_t, dt, 2, forcing=forcing_t, t0=T0)
    got = advance(torch.from_numpy(u)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    assert fk.learned_rk4_launch(advance.pack, 1536, 20, BATCH).split


@pytest.mark.parametrize("size,kernel_size", [(6, 19), (18, 5)])
def test_learned_rk4_plain_matches_pallas_long_reach(size, kernel_size):
    """A KS tower of kernel size 19 (reach 9; layer 0's taps fill two
    depth steps of 16 on the card) and a KS model of stencil size 18 (taps
    reaching 9 points), which the card's kernel refused before its halo was
    sized from the pack: the plain version against the Pallas kernel in
    interpret mode (batch tile 8, 2 steps, nx 128), 1e-4 of max|u|."""
    model_j, tree, model_t, params_t, u = _pair("ks", True, size, kernel_size=kernel_size)
    assert _check_learned_rk4(model_j, tree, model_t, params_t, 0.3 * u, steps=2) < 1e-4
    pack = _pack(model_t, params_t)
    assert fk.learned_rk4_reach(pack) == 9 and fk.learned_rk4_refusal(pack, NX) is None


def test_fused_rk4_fn_advance_honours_t():
    """advance(u, t) starts the forcing's phase at t (default: the closure's
    t0), as the JAX advance does; integrate_fused hands every save interval
    its own start time, so two intervals equal one call of twice the steps
    to rounding (1e-6 of max|u|, measured 7.7e-8: the phase state is rebuilt
    from sin and cos at the interval's start instead of rotated there)."""
    _, _, model, params, u = _pair("burgers", True, 6)
    leaves = _numpy_forcing(22, BATCH)
    forcing = teq.ForcingParams(*(torch.from_numpy(a) for a in leaves))
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    u = torch.from_numpy(u)
    at_zero = model.fused_rk4_fn(params, dt, 2, forcing=forcing)
    at_t0 = model.fused_rk4_fn(params, dt, 2, forcing=forcing, t0=T0)
    torch.testing.assert_close(at_zero(u, T0), at_t0(u), rtol=0, atol=0)
    torch.testing.assert_close(at_zero(u, torch.tensor(T0)), at_t0(u), rtol=0, atol=0)
    assert float((at_zero(u) - at_t0(u)).abs().max()) > 1e-4
    _, traj = tint.integrate_fused(at_zero, u, dt, 4, 2, t0=T0)
    whole = model.fused_rk4_fn(params, dt, 4, forcing=forcing, t0=T0)(u)
    assert float((traj[-1] - whole).abs().max() / whole.abs().max()) < 1e-6


def test_pack_forcing_matches_forcing_term_and_checks():
    """The pack's amplitude x sin0 summed over terms is forcing_term at t0
    (cell-averaged for a conservative scheme); one rotation is the forcing
    half a step later, to float32 rounding of the phase and the angle
    addition (atol 1e-5 on values of order 1; measured 4.1e-6 and 4.7e-6).
    Leaves that are not float32 tensors of a broadcastable shape raise."""
    eq = teq.from_name("burgers", conservative=True)
    grid = TGrid(8 * NX, eq.period).resample(8, conservative=True)
    leaves = [torch.from_numpy(a) for a in _numpy_forcing(23, 4)]
    forcing = teq.ForcingParams(*leaves)
    dt = 0.01
    fp = fk.pack_forcing(forcing, T0, eq, grid, dt, 4)
    assert fp.sin0.shape == fp.cos0.shape == (4, 20, NX) and fp.amplitude.shape == (4, 20)
    x = torch.as_tensor(grid.x, dtype=torch.float32)
    want = teq.forcing_term(forcing, x, T0, eq.period, grid.dx)
    torch.testing.assert_close(fk._force(fp, fp.sin0), want, rtol=0, atol=1e-5)
    s1, _ = fk._rotate(fp, fp.sin0, fp.cos0)
    want_half = teq.forcing_term(forcing, x, T0 + dt / 2, eq.period, grid.dx)
    torch.testing.assert_close(fk._force(fp, s1), want_half, rtol=0, atol=1e-5)
    shared = teq.ForcingParams(*(leaf[:1] for leaf in leaves))  # [1, terms] broadcasts
    torch.testing.assert_close(
        fk.pack_forcing(shared, T0, eq, grid, dt, 4).sin0[3], fp.sin0[0], rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32"):
        fk.pack_forcing(forcing._replace(omega=leaves[1].double()), T0, eq, grid, dt, 4)
    with pytest.raises(ValueError, match="broadcast"):
        fk.pack_forcing(forcing, T0, eq, grid, dt, 5)


def test_forced_wrapper_checks():
    _, _, model, params, u = _pair("burgers", True, 6)
    u = torch.from_numpy(u)
    forcing = teq.ForcingParams(*(torch.from_numpy(a) for a in _numpy_forcing(24, BATCH)))
    advance = model.fused_rk4_fn(params, 1e-3, 1, forcing=forcing)
    before = fk.fused_learned_rk4.launches
    advance(u)
    assert fk.fused_learned_rk4.launches == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="forcing required"):
        fk.fused_learned_rk4(u, advance.pack, 1e-3, 1)
    fp = fk.pack_forcing(forcing, 0.0, model.equation, model.grid, 1e-3, BATCH)
    torch.testing.assert_close(
        fk.fused_learned_rk4(u, advance.pack, 1e-3, 1, forcing=fp), advance(u), rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        fk.fused_learned_rk4(u[:4].contiguous(), advance.pack, 1e-3, 1, forcing=fp)
    with pytest.raises(ValueError, match="broadcast"):
        advance(u[:5].contiguous())
    assert fk.learned_rk4_refusal(advance.pack, NX, 20) is None
    # 2048 forced points are more than one block holds: split, not refused
    assert fk.learned_rk4_refusal(advance.pack, 2048, 20) is None
    assert fk.learned_rk4_launch(advance.pack, 2048, 20, BATCH).split
    # 16 points (Burgers-64x's grid), which the kernel refused before it
    # packed short grids, are taken, 8 trajectories a team; 15 are refused
    assert fk.learned_rk4_refusal(advance.pack, 16, 20) is None
    assert fk.learned_rk4_launch(advance.pack, 16, 20, 10240).per_team == 8
    assert fk.learned_rk4_refusal(advance.pack, 15, 20) == "nx=15 < 16"
    launch = fk.learned_rk4_launch(advance.pack, NX, 20, BATCH)
    # 8 filters pad to 16: 2 planes of nx + 4 halo rows + a dump row; u with 8
    # halo points at each end; the z row: F | 1 floats
    z_row = advance.pack.n_free | 1
    one = (2 * 2 * (NX + 5) * 16 + 4 * (4 * NX + 16) + 4 * 32 * z_row * 4
           + 4 * (NX + 4 + 80 + 40 * NX))
    one = -(-one // 128) * 128
    assert launch[:5] == (1, 128, one, advance.pack.blob.numel() + one, BATCH)
    assert not launch.split and launch.segment == NX
    # a byte less than the whole weights and one trajectory: a cluster shares
    # it, as the split form's rule ranks its launches
    limit = launch.shared_bytes - 1
    short = fk.learned_rk4_launch(advance.pack, NX, 20, BATCH, shared_limit=limit)
    _check_split(advance.pack, NX, 20, short, BATCH, limit=limit)
    # a byte less than the whole weights and a segment of 16 blocks: the
    # blocks and warp groups the rule ranks first beside a ring of conv tap
    # slices, streamed
    tight = advance.pack.blob.numel() + fk._team_bytes(advance.pack, NX // 16, 20) - 1
    streamed = fk.learned_rk4_launch(advance.pack, NX, 20, BATCH, shared_limit=tight)
    _check_split(advance.pack, NX, 20, streamed, BATCH, limit=tight)
    assert streamed.stream
    assert fk.learned_rk4_refusal(advance.pack, NX, 20,
                                  shared_limit=short.shared_bytes - 1) is None
    # less than a ring of one slot of a conv tap's slice, its barriers and a
    # segment of 16 blocks
    least = (fk._window_bytes(advance.pack) + fk._team_bytes(advance.pack, NX // 16, 20)
             + fk.RING_CONTROL_BYTES)
    assert "shared memory" in fk.learned_rk4_refusal(advance.pack, NX, 20,
                                                     shared_limit=least - 1)
    assert fk.learned_rk4_refusal(advance.pack, NX, 20, shared_limit=least) is None


@pytest.mark.parametrize("name,cons", [("ks", True), ("kdv", False), ("kdv", True),
                                       ("ks", False)])
def test_fused_rk4_plain_matches_pallas(name, cons):
    """The fixed-stencil baseline, 10 RK4 steps: fused_rk4_plain against
    make_fused_rk4(interpret=True), the same float32 tap sums in the same
    order from the same float64 coefficients: 2e-6 of max|u| (measured
    2.0e-7). Against the port's PolynomialDifferentiator + integrate, whose tap
    sums run in another order: the JAX package's own bound for that pair,
    rtol 2e-4 and atol 1e-5."""
    eq_j, eq_t = jeq.from_name(name, conservative=cons), teq.from_name(name, conservative=cons)
    grid_j, grid_t = JGrid(NX, eq_j.period), TGrid(NX, eq_t.period)
    rng = np.random.default_rng(31)
    x = grid_j.x
    u = 0.3 * np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / eq_j.period
                                        + rng.uniform(0, 2 * np.pi)) for k in (1, 2, 3))
        for _ in range(BATCH)
    ]).astype(np.float32)
    dt = eq_j.stable_time_step(grid_j)
    want = np.asarray(pk.make_fused_rk4(eq_j, grid_j, dt, 10, interpret=True)(jnp.asarray(u)))
    advance = fk.make_fused_rk4(eq_t, grid_t, dt, 10)
    before = fk.fused_rk4.launches
    got = advance(torch.from_numpy(u)).numpy()
    assert fk.fused_rk4.launches == before  # the CPU runs the plain version
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
    rhs = tint.PolynomialDifferentiator(eq_t, grid_t, device="cpu").rhs_fn()
    _, traj = tint.integrate(rhs, torch.from_numpy(u), dt, 10, 10)
    np.testing.assert_allclose(got, traj[-1].numpy(), rtol=2e-4, atol=1e-5)


RK4_SCHEMES = [{"accuracy_order": 4}, {"accuracy_order": 6}, {"stencil_size": 8},
               {"stencil_size": 16}, {"stencil_size": 18}, {"stencil_size": 32}]
RK4_FORMS = [("ks", True), ("ks", False), ("kdv", True), ("kdv", False)]
RUN_CONDITIONING = 4


@pytest.mark.parametrize("nx,scheme", [(NX, kw) for kw in RK4_SCHEMES]
                         + [(512, {"accuracy_order": 4}), (512, {"stencil_size": 16}),
                            (NX, {"stencil_size": 40}), (512, {"stencil_size": 48})])
@pytest.mark.parametrize("name,cons", RK4_FORMS)
def test_fused_rk4_schemes_match_pallas(name, cons, nx, scheme):
    """Every scheme the JAX factory builds from accuracy_order or
    stencil_size (beyond MAX_TAPS = 32 taps an order too: 40 and 48, which
    the card's block form takes with its coefficients in global memory), and nx = 512: the
    port's plain version against make_fused_rk4(interpret=True), 10 RK4
    steps at a quarter of the classic scheme's stable step (a wider stencil's
    symbol is larger). Limit: 2e-6 of max|u|, as the classic scheme's
    test, or RUN_CONDITIONING times the JAX run's own distance from float64
    sums of the same scheme where that is larger: the collocated KdV
    third derivative on an even stencil of 8 to 32 points amplifies one
    rounding to 1e-5 - 1e-4 of max|u| in 10 steps on either side (read:
    both 1.1e-5 - 1.4e-4 from float64, 1.8e-5 - 2.5e-4 from each other)."""
    eq_j, eq_t = jeq.from_name(name, conservative=cons), teq.from_name(name, conservative=cons)
    grid_j, grid_t = JGrid(nx, eq_j.period), TGrid(nx, eq_t.period)
    rng = np.random.default_rng(31)
    x = grid_j.x
    u = 0.3 * np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / eq_j.period
                                        + rng.uniform(0, 2 * np.pi)) for k in (1, 2, 3))
        for _ in range(BATCH)
    ]).astype(np.float32)
    dt = eq_j.stable_time_step(grid_j) / 4
    want = np.asarray(pk.make_fused_rk4(eq_j, grid_j, dt, 10, interpret=True, **scheme)(
        jnp.asarray(u)))
    advance = fk.make_fused_rk4(eq_t, grid_t, dt, 10, **scheme)
    got = advance(torch.from_numpy(u)).numpy()
    exact = fk.fused_rk4_plain(torch.from_numpy(u).double(), advance.scheme).numpy()
    scale = np.abs(exact).max()
    tol = max(2e-6, RUN_CONDITIONING * np.abs(want - exact).max() / scale)
    assert np.isfinite(got).all() and np.abs(got - want).max() / scale <= tol
    assert fk.rk4_refusal(advance.scheme, nx) is None
    size = scheme.get("stencil_size")
    assert size is None or all(len(t) == size for t in advance.scheme.taps.values())


def test_fused_rk4_options_and_checks():
    """accuracy_order and stencil_size reach the coefficients as in the JAX
    factory; forced equations and wrong inputs raise."""
    eq_j, eq_t = jeq.from_name("ks", conservative=True), teq.from_name("ks", conservative=True)
    grid_j, grid_t = JGrid(NX, eq_j.period), TGrid(NX, eq_t.period)
    u = (0.2 * np.sin(2 * np.pi * grid_j.x / eq_j.period))[None].repeat(BATCH, 0).astype(np.float32)
    dt = eq_j.stable_time_step(grid_j)
    for kwargs in ({"accuracy_order": 4}, {"stencil_size": 6}):
        want = np.asarray(pk.make_fused_rk4(eq_j, grid_j, dt, 2, interpret=True, **kwargs)(
            jnp.asarray(u)))
        advance = fk.make_fused_rk4(eq_t, grid_t, dt, 2, **kwargs)
        got = advance(torch.from_numpy(u)).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
    assert len(advance.scheme.taps[0]) == 6 and advance.scheme.num_steps == 2
    burgers = teq.from_name("burgers")
    with pytest.raises(ValueError, match="unforced"):
        fk.make_fused_rk4(burgers, TGrid(NX, burgers.period), 0.01, 5)
    u_t = torch.from_numpy(u)
    with pytest.raises(TypeError, match="float32"):
        advance(u_t.double())
    with pytest.raises(ValueError, match=r"\[batch, nx\]"):
        advance(u_t[0])
    with pytest.raises(ValueError, match="grid"):
        advance(u_t[:, :64].contiguous())
    with pytest.raises(ValueError, match="forward only"):
        advance(u_t.clone().requires_grad_())
    assert len(fk.make_fused_rk4(eq_t, grid_t, dt, 1, stencil_size=32).scheme.taps[3]) == 32
    # more than 32 taps: built (it raised "34 taps > kernel limit 32" before
    # the block form took such schemes), the rows form while its rows fit a
    # block (the block form's rows in shared memory before the block form
    # moved to registers), the block form past that or with a cluster given
    wide = fk.make_fused_rk4(eq_t, grid_t, dt, 1, stencil_size=34).scheme
    assert len(wide.taps[3]) == 34 and fk.rk4_wide(wide.taps) and fk.rk4_refusal(wide, NX) is None
    assert fk.rk4_launch(BATCH, NX, False, wide.taps).form == "rows"
    assert fk.rk4_launch(BATCH, NX, False, wide.taps, cluster=1).form == "block"
    assert fk.rk4_launch(BATCH, 16384, False, wide.taps).form == "block"


def test_pack_rejects_even_kernel():
    eq = teq.from_name("ks", conservative=True)
    model = TModel(eq, TGrid(NX, eq.period),
                   TConfig(num_layers=1, filters=8, kernel_size=4, stencil_size=6),
                   device="cpu")
    with pytest.raises(ValueError, match="odd"):
        model.fused_rk4_fn(model.init_params(torch.Generator()), 1e-3, 1)


def _torch_model(filters, layers=3, name="ks", cons=True, size=6, nx=NX, seed=0,
                 kernel_size=5):
    eq = teq.from_name(name, conservative=cons)
    grid = TGrid(8 * nx, eq.period).resample(8, conservative=cons)
    model = TModel(eq, grid, TConfig(num_layers=layers, filters=filters, stencil_size=size,
                                     kernel_size=kernel_size), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
              for k, v in model.init_params(gen).items()}
    return model, params


def _pack(model, params):
    return fk.pack_learned_rk4(params, model.equation, model.grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)


def _check_split(pack, nx, terms, launch, batch=None, cluster=None, groups=None,
                 limit=232448):
    """What every split launch keeps, whichever blocks and warp groups the
    rule ranks first: 1, 2 or 4 groups (1 or 2 at 128 channels and above,
    whose 64 accumulators a thread leave registers for two) of 128 threads,
    the weights streamed at and above 128 channels, segments of ceil(nx /
    blocks) points that cover nx with every block holding points, a block's
    shared bytes (the weights whole, or the ring's slots of one slice each;
    the segment's layout; 512 (F | 1) bytes of z tiles for each group after
    the first; the ring's 128 bytes of barriers) within ``limit``, and
    ``cluster`` and ``groups`` as asked. A block that streams holds a ring
    of as many slots of a slice as fit, up to 4 (fewer only where that fits
    more blocks an SM), and a producer warp of 32 threads beside 1 or 2
    groups (4 issue from their first thread); its cluster holds one
    trajectory."""
    wide = pack.padded_channels >= 128
    assert launch.split and launch.teams == 1 and launch.multicast == 1
    assert launch.groups in ((1, 2) if wide else (1, 2, 4))
    # a producer warp beside 1 or 2 streaming groups; 4 issue from a thread
    assert launch.threads == 128 * launch.groups + (
        32 if launch.stream and launch.groups < 4 else 0)
    assert launch.stream or not wide
    assert launch.segment == -(-nx // launch.cluster)
    assert (launch.cluster - 1) * launch.segment < nx <= launch.cluster * launch.segment
    assert launch.team_bytes == fk._team_bytes(pack, launch.segment, terms)
    fixed = launch.team_bytes + (launch.groups - 1) * 512 * (pack.n_free | 1)
    if launch.stream:
        slot = 2 * min(pack.padded_channels, 128) ** 2
        most = min(4, (limit - fixed - 128) // slot)
        assert 1 <= launch.slots <= most
        assert launch.shared_bytes == launch.slots * slot + fixed + 128 <= limit
        if launch.slots < most:  # fewer slots than fit: they fit more blocks an SM
            fuller = launch._replace(slots=most, shared_bytes=most * slot + fixed + 128)
            assert (fk.split_occupancy(launch, wide, limit)[0]
                    > fk.split_occupancy(fuller, wide, limit)[0])
    else:
        assert launch.slots == 0 and launch.shared_bytes == pack.blob.numel() + fixed <= limit
    if batch is not None:
        assert launch.blocks == launch.cluster * batch
    if cluster is not None:
        assert launch.cluster == -(-nx // -(-nx // cluster))
    if groups is not None:
        assert launch.groups == groups


def _read_wgmma(raw, depth, n):
    """The matrix B [depth, n] that wgmma sees through a descriptor without
    swizzle at the block's start, 16 n bytes between the two halves of a
    depth step and 128 bytes between core matrices: the 16 bytes of row
    ``j`` of core matrix (half, n // 8) hold B[16 step + 8 half + 0..7,
    8 (n // 8) + j]; a depth step takes 32 n bytes."""
    values = raw.view(torch.bfloat16).float()
    b = torch.full((depth, n), float("nan"))
    for step in range(depth // 16):
        for half in range(2):
            for col in range(n):
                start = (step * 32 * n + half * 16 * n + (col // 8) * 128 + (col % 8) * 16) // 2
                b[16 * step + 8 * half: 16 * step + 8 * half + 8, col] = values[start: start + 8]
    return b


def _read_fragments(raw, depth, n):
    """The matrix B [depth, n] that mma.sync.m16n8k16 sees when lane
    ``4 g + q`` loads the 8 bytes at ``((step * tiles + tile) * 32 + lane) *
    8`` as its B operand: register r, half e is B[16 step + 2 q + 8 r + e,
    8 tile + g] (PTX ISA, the .bf16 B fragment of m16n8k16)."""
    values = raw.view(torch.bfloat16).float()
    tiles = n // 8
    b = torch.full((depth, n), float("nan"))
    for step in range(depth // 16):
        for tile in range(tiles):
            for lane in range(32):
                g, q = lane // 4, lane % 4
                for r in range(2):
                    for e in range(2):
                        b[16 * step + 2 * q + 8 * r + e, 8 * tile + g] = values[
                            ((step * tiles + tile) * 32 + lane) * 4 + 2 * r + e]
    return b


PACK_CASES = [(8, 2, "ks", True, 6), (16, 2, "burgers", True, 8), (32, 3, "ks", True, 6),
              (16, 3, "kdv", False, 7), (24, 2, "burgers", False, 5), (40, 1, "ks", False, 7)]


@pytest.mark.parametrize("filters,layers,name,cons,size", PACK_CASES)
def test_pack_blob_reads_back(filters, layers, name, cons, size):
    """The kernel's buffer, read as the kernel reads it, holds the values of
    the plain version's views (exactly: both are the same bf16 or float32
    numbers) in the leading corner of each zero-padded block; every block
    starts at a multiple of 128 bytes; pn is zero outside each order's
    free_ranges columns, which alone the projection block holds. Layer 0 and
    the heads feed mma.sync, the later layers wgmma."""
    _check_blob_reads_back(filters, layers, name, cons, size)


@pytest.mark.parametrize("filters,layers,name,cons,size,kernel_size", [
    (16, 2, "ks", True, 6, 19), (8, 3, "burgers", False, 5, 21), (32, 17, "ks", True, 6, 5),
])
def test_pack_blob_reads_back_long_kernels_and_deep_towers(filters, layers, name, cons, size,
                                                           kernel_size):
    """The same read-back where the kernel once refused the tower: conv
    kernels of 19 and 21 taps (layer 0's fragments over two depth steps of
    16), and 17 layers, whose later layers lie at the fixed stride the
    kernel computes their offsets from (K x channels^2 bf16, then the bias
    rounded up to 128 bytes)."""
    pack = _check_blob_reads_back(filters, layers, name, cons, size, kernel_size)
    cp, k = pack.padded_channels, pack.kernel_size
    w_bytes, stride = 2 * k * cp * cp, 2 * k * cp * cp + -(-4 * cp // 128) * 128
    for l in range(1, layers):
        assert pack.blob_offsets[2 * l] == pack.blob_offsets[2] + (l - 1) * stride
        assert pack.blob_offsets[2 * l + 1] == pack.blob_offsets[2 * l] + w_bytes


def _check_blob_reads_back(filters, layers, name, cons, size, kernel_size=5):
    model, params = _torch_model(filters, layers, name, cons, size, kernel_size=kernel_size)
    pack = _pack(model, params)
    c, cp, k, f = pack.channels, pack.padded_channels, pack.kernel_size, pack.n_free
    fp = -(-f // 8) * 8
    assert c == filters and cp == {8: 16, 16: 16, 24: 32, 32: 32, 40: 64}.get(
        filters, -(-filters // 16) * 16)
    assert k == kernel_size
    assert all(o % 128 == 0 for o in pack.blob_offsets) and pack.blob.numel() % 128 == 0
    assert pack.blob.dtype == torch.uint8 and len(pack.blob_offsets) == 2 * layers + 3
    # the output columns: whole chunks of 128 above 128 channels (the chunked form)
    out_p = cp if cp <= 128 else -(-cp // 128) * 128
    n = min(out_p, 128)  # the columns of one output chunk

    def block(i, nbytes, start=0):
        return pack.blob[pack.blob_offsets[i] + start: pack.blob_offsets[i] + start + nbytes]

    for l, (w, b) in enumerate(pack.tower):
        if l == 0:
            depth = -(-k // 16) * 16
            got = _read_fragments(block(0, 2 * depth * out_p), depth, out_p)
            want = torch.zeros(depth, out_p)
            want[:k, :c] = w.t()
        else:  # the slice [cp, n] of each output chunk and conv tap, in that order
            got = torch.full((k, cp, out_p), float("nan"))
            for chunk in range(out_p // n):
                for t in range(k):
                    start = 2 * cp * n * (chunk * k + t)
                    got[t, :, chunk * n: chunk * n + n] = _read_wgmma(
                        block(2 * l, 2 * cp * n, start), cp, n)
            want = torch.zeros(k, cp, out_p)  # [tap][ci][co], from the views' k * c + ci
            want[:, :c, :c] = w.t().reshape(k, c, c)
        assert torch.equal(got, want), f"layer {l}"
        bias = block(2 * l + 1, 4 * out_p).view(torch.float32)
        assert torch.equal(bias[:c], b) and not bias[c:].any()
    got = _read_fragments(block(2 * layers, 2 * cp * fp), cp, fp)
    want = torch.zeros(cp, fp)
    want[:c, :f] = pack.head_w.t()
    assert torch.equal(got, want)
    hb = block(2 * layers + 1, 4 * fp).view(torch.float32)
    assert torch.equal(hb[:f], pack.head_b) and not hb[f:].any()
    # the projection block: per order and block of 8 rows, c0 [8] then the
    # rows' own columns of pn, transposed [count, 8]; rebuilt here into c0 and
    # a dense pn, which must equal the views (so pn is zero elsewhere)
    proj = pack.blob[pack.blob_offsets[2 * layers + 2]:].view(torch.float32)
    c0, pn = torch.zeros(pack.n_rows), torch.zeros(pack.n_rows, f)
    row = 0
    for (first, count, start), taps in zip(pack.free_ranges, pack.taps.values()):
        assert start % 8 == 0
        for r in range(0, len(taps), 8):
            n = min(8, len(taps) - r)
            chunk = proj[start: start + 8 + 8 * count]
            c0[row + r: row + r + n] = chunk[:n]
            assert not chunk[n:8].any()
            part = chunk[8:].view(count, 8)
            pn[row + r: row + r + n, first: first + count] = part[:, :n].t()
            assert not part[:, n:].any()
            start += 8 + 8 * count
        row += len(taps)
    assert torch.equal(c0, pack.c0) and torch.equal(pn, pack.pn) and pn.any()
    assert row == pack.n_rows
    return pack


@pytest.mark.parametrize("filters,layers,name,cons,size", [
    (136, 2, "ks", True, 6), (200, 3, "burgers", True, 8), (256, 2, "kdv", False, 7),
])
def test_pack_blob_reads_back_chunked(filters, layers, name, cons, size):
    """The same read-back above 128 filters (the chunked form): channels
    padded to a multiple of 16 (144, 208, 256), the output columns of every
    layer, and its bias, to whole chunks of 128; a later layer's weights one
    [channels, 128] slice per output chunk and conv tap, in that order, each
    as wgmma reads it, so that the kernel's slice of one chunk, tap and 128
    input channels (or the rest), which one bulk copy brings into a slot of
    its ring, lies contiguous at ((chunk K + tap) channels / 16 + first
    depth step) x 4096 bytes; the layers at the fixed
    stride the kernel computes (K x channels x chunks' columns bf16, then the
    bias rounded up to 128 bytes)."""
    pack = _check_blob_reads_back(filters, layers, name, cons, size)
    cp, k = pack.padded_channels, pack.kernel_size
    out_p = -(-cp // 128) * 128
    w_bytes = 2 * k * cp * out_p
    assert pack.blob_offsets[1] == 2 * 16 * out_p  # layer 0's fragments: 16 taps x out_p
    for l in range(1, layers):
        assert pack.blob_offsets[2 * l] == pack.blob_offsets[2] + (l - 1) * (
            w_bytes + -(-4 * out_p // 128) * 128)
        assert pack.blob_offsets[2 * l + 1] == pack.blob_offsets[2 * l] + w_bytes


@pytest.mark.parametrize("filters,layers,name,cons,size", PACK_CASES[:4])
def test_channel_padding_leaves_plain_bit_equal(filters, layers, name, cons, size):
    """Zero filters added to the state dict change nothing: the plain version
    gives the same bits (a zero channel adds exact zeros to every float32
    sum), and a model that is already as wide as the kernel's padded width
    packs to the same kernel buffer, byte for byte."""
    model, params = _torch_model(filters, layers, name, cons, size)
    pack = _pack(model, params)
    cp = pack.padded_channels
    wide = {}
    for key, v in params.items():
        shape = list(v.shape)
        if key.startswith("tower."):
            shape[0] = cp
            if v.dim() == 3 and not key.startswith("tower.0."):
                shape[1] = cp
        elif key.endswith(".weight"):  # heads [F_d, C, 1]
            shape[1] = cp
        wide[key] = fk._pad_to(v, *shape)
    wide_pack = _pack(model, wide)
    assert wide_pack.channels == cp == wide_pack.padded_channels
    assert torch.equal(wide_pack.blob, pack.blob)
    assert wide_pack.blob_offsets == pack.blob_offsets
    u = torch.from_numpy(np.random.default_rng(5).standard_normal((4, NX)).astype(np.float32))
    forcing = None
    if model.equation.forced:
        leaves = [torch.from_numpy(a) for a in _numpy_forcing(6, 4)]
        forcing = fk.pack_forcing(teq.ForcingParams(*leaves), T0, model.equation, model.grid,
                                  1e-3, 4)
    got = fk.fused_learned_rk4_plain(u, wide_pack, 1e-3, 2, forcing)
    want = fk.fused_learned_rk4_plain(u, pack, 1e-3, 2, forcing)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def geometry_packs():
    return {filters: _pack(*_torch_model(filters)) for filters in (8, 16, 32)}


@pytest.mark.parametrize("batch", [3, 256, 10240])
@pytest.mark.parametrize("terms", [0, 20])
@pytest.mark.parametrize("nx", [96, 128, 1024])
@pytest.mark.parametrize("filters", [8, 16, 32])
def test_learned_rk4_launch_geometry(geometry_packs, filters, nx, terms, batch):
    """What Python decides before a launch, for a 3-layer tower with 8 free
    dims: where the weights and one trajectory exceed the block's shared
    memory (here: nx = 1024 forced, 40 x 1024 floats of phase state beside
    the activations), which the kernel refused before the split form, a
    cluster shares the trajectory beside the whole weights, in the blocks
    and warp groups the split form's rule ranks first; otherwise the block fits the limit and 512 threads,
    every trajectory has a team, and the launch has at least 132 blocks
    whenever the batch has 132 trajectories."""
    pack = geometry_packs[filters]
    refusal = fk.learned_rk4_refusal(pack, nx, terms)
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    assert refusal is None

    def team_bytes(points):
        rows = -(-points // 64) * 64
        n = (2 * (pack.padded_channels // 8) * (rows + 5) * 16 + 16 * rows + 64
             + 4 * 32 * 9 * 4 + (4 * rows + 16 + 16 * terms + 8 * terms * points if terms else 0))
        return -(-n // 128) * 128

    if nx == 1024 and terms:
        assert pack.blob.numel() + team_bytes(nx) > 232448
        _check_split(pack, nx, terms, launch, batch)
        assert not launch.stream and launch.team_bytes == team_bytes(launch.segment)
        return
    assert launch.team_bytes == team_bytes(nx)
    assert not launch.split and (launch.cluster, launch.segment) == (1, nx)
    assert 1 <= launch.teams <= fk.MAX_TEAMS and launch.threads == 128 * launch.teams
    assert launch.threads <= 512
    assert launch.shared_bytes == pack.blob.numel() + launch.teams * launch.team_bytes <= 232448
    assert launch.blocks * launch.teams >= batch > (launch.blocks - 1) * launch.teams
    assert launch.blocks >= min(batch, 132)
    if batch == 10240:  # a large batch shares the weights as far as the memory allows
        fit = (232448 - pack.blob.numel()) // launch.team_bytes
        assert launch.teams == min(fk.MAX_TEAMS, fit)


def _packed_team_bytes(pack, nx, terms, per_team):
    """A team's shared bytes counted here from the layout: P nx rows rounded
    up to 64 with the conv's 4 halo rows of each trajectory and a dump row
    in each of two bf16 buffers; u with 8 halo points of each trajectory a
    side, fluxes, step start, k sum; one [32, F | 1] z tile per warp; forced,
    the forcing row, 16 bytes of alignment, 16 bytes of constants per term
    and trajectory, (sin, cos) per term and row."""
    rows = -(-nx * per_team // 64) * 64
    n = (2 * (pack.padded_channels // 8) * (rows + 4 * per_team + 1) * 16
         + 4 * (4 * rows + 16 * per_team) + 4 * 32 * (pack.n_free | 1) * 4)
    if terms:
        n += 4 * rows + 16 + 16 * terms * per_team + 8 * terms * nx * per_team
    return -(-n // 128) * 128


@pytest.mark.parametrize("batch", [256, 263, 525, 1037, 4096, 4097, 10239, 10240])
@pytest.mark.parametrize("terms", [0, 20])
@pytest.mark.parametrize("nx", [16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("filters", [8, 32])
def test_learned_rk4_packed_launch_geometry(geometry_packs, filters, nx, terms, batch):
    """The whole form on short grids packs P trajectories a team: the most
    of 1, 2, 4, 8 whose P nx points fit two 64-row tiles (8 at nx 16, 4 at
    32, 2 at 48 and 64, 1 from 96), as long as ceil(batch / P) teams are at
    least the 132 SMs (at nx 32: P = 4 from B = 525, 2 from 263, 1 at 256).
    The team's bytes follow the packed layout (``_packed_team_bytes``, the
    rule of ``team_bytes_needed``); every trajectory has a slot, the last
    team and block ragged; ``per_team=1`` gives the unpacked launch, which
    every batch took before."""
    pack = geometry_packs[filters]
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    most = max(p for p in (1, 2, 4, 8) if p * nx <= 128 or p == 1)
    want = max(p for p in (1, 2, 4, 8) if p <= most and (p == 1 or -(-batch // p) >= 132))
    assert fk.learned_rk4_refusal(pack, nx, terms) is None
    assert fk.most_per_team(pack, nx) == most
    assert not launch.split and launch.per_team == want and launch.segment == nx
    assert launch.team_bytes == _packed_team_bytes(pack, nx, terms, want)
    assert launch.team_bytes == fk._team_bytes(pack, nx, terms, want)
    slots = -(-batch // want)
    fit = (232448 - pack.blob.numel()) // launch.team_bytes
    assert launch.teams == min(4, fit, max(1, slots // 132)) >= 1
    assert launch.threads == 128 * launch.teams
    assert launch.shared_bytes == pack.blob.numel() + launch.teams * launch.team_bytes <= 232448
    assert launch.blocks == -(-slots // launch.teams)
    assert launch.blocks * launch.teams * want >= batch > (launch.blocks - 1) * launch.teams * want
    assert slots >= 132 or want == 1
    unpacked = fk.learned_rk4_launch(pack, nx, terms, batch, per_team=1)
    assert unpacked.per_team == 1 and unpacked.team_bytes == _packed_team_bytes(pack, nx, terms, 1)
    assert unpacked.teams == min(4, (232448 - pack.blob.numel()) // unpacked.team_bytes,
                                 max(1, batch // 132))
    assert unpacked.blocks == -(-batch // unpacked.teams)
    for p in (2, 4, 8):
        if p <= most:
            forced_p = fk.learned_rk4_launch(pack, nx, terms, batch, per_team=p)
            assert forced_p.per_team == p
            assert forced_p.team_bytes == _packed_team_bytes(pack, nx, terms, p)
        else:
            with pytest.raises(ValueError, match=f"per_team={p}"):
                fk.learned_rk4_launch(pack, nx, terms, batch, per_team=p)


def test_learned_rk4_per_team_refusals():
    """``per_team`` forces the packing of the whole form and raises outside
    it: a count not in 1, 2, 4, 8; more than two 64-row tiles of points; 128
    filters (one trajectory a block); beside ``cluster`` or ``groups``
    (the split form, one segment a block); a team that does not fit beside
    the weights. The split form takes nx >= 32, the whole form nx >= 16: at
    16 to 31 points a shape only the split form holds (a conv kernel wider
    than the grid) is refused. The CPU's plain version ignores per_team."""
    model, params = _torch_model(8, nx=32)
    pack = _pack(model, params)
    for bad in (0, 3, 16):
        with pytest.raises(ValueError, match=f"per_team={bad}"):
            fk.learned_rk4_launch(pack, 32, 0, 10240, per_team=bad)
    with pytest.raises(ValueError, match="per_team=8: the whole form packs"):
        fk.learned_rk4_launch(pack, 32, 0, 10240, per_team=8)
    with pytest.raises(ValueError, match="force the split form"):
        fk.learned_rk4_launch(pack, 32, 0, 10240, cluster=1, per_team=2)
    with pytest.raises(ValueError, match="force the split form"):
        fk.learned_rk4_launch(pack, 32, 0, 10240, groups=2, per_team=4)
    assert fk.learned_rk4_launch(pack, 32, 0, 10240, cluster=1, per_team=1).split
    wide = _pack(*_torch_model(128, layers=1, nx=32))
    assert fk.most_per_team(wide, 32) == 1
    assert fk.learned_rk4_launch(wide, 32, 0, 10240).per_team == 1
    with pytest.raises(ValueError, match="per_team=2"):
        fk.learned_rk4_launch(wide, 32, 0, 10240, per_team=2)
    # room for one unpacked team: the packed ones do not fit, so P = 1
    limit = pack.blob.numel() + fk._team_bytes(pack, 32, 0)
    assert fk._team_bytes(pack, 32, 0, 2) > fk._team_bytes(pack, 32, 0)
    assert fk.learned_rk4_launch(pack, 32, 0, 10240, shared_limit=limit)[:5] == (
        1, 128, fk._team_bytes(pack, 32, 0), limit, 10240)
    with pytest.raises(ValueError, match="do not fit a team"):
        fk.learned_rk4_launch(pack, 32, 0, 10240, shared_limit=limit, per_team=4)
    reach = _pack(*_torch_model(8, layers=1, nx=32, kernel_size=35))
    assert fk.learned_rk4_refusal(reach, 24) == "nx=24 < 32 in the split form"
    assert fk.learned_rk4_refusal(reach, 32) is None
    assert fk.learned_rk4_refusal(pack, 16) is None
    assert fk.learned_rk4_refusal(pack, 8) == "nx=8 < 16"
    u = torch.from_numpy(np.random.default_rng(2).standard_normal((6, 32)).astype(np.float32))
    assert torch.equal(fk.fused_learned_rk4(u, pack, 1e-4, 2, per_team=4),
                       fk.fused_learned_rk4_plain(u, pack, 1e-4, 2))


def test_learned_rk4_refuses_wide_and_deep():
    """More than 128 filters, which the kernel refused before its chunked
    form ("136 filters > kernel limit 128"), are taken, in the split form
    beside the ring of slices of the streamed weights; a tower of 17
    layers and a conv kernel of 19 (reach 9), which the kernel refused
    before the split form (its layer offsets were a table of 16, its halo 8
    points), are taken, the deep tower's 164 KB of weights whole beside two
    trajectories at nx 128, split at nx 2048 as the split form's rule ranks
    its launches, and streamed through the ring beside a segment when 2
    blocks are asked for; a grid no cluster of 16 blocks holds is refused
    with the bytes it needs."""
    model, params = _torch_model(136, layers=1)
    pack = _pack(model, params)
    assert pack.padded_channels == 144 and fk.learned_rk4_refusal(pack, NX) is None
    _check_split(pack, NX, 0, fk.learned_rk4_launch(pack, NX, 0, 10240), 10240)
    u = torch.zeros(2, NX)
    assert fk.fused_learned_rk4(u, pack, 1e-3, 1).shape == u.shape  # the CPU's plain version
    deep = _pack(*_torch_model(32, layers=17))
    assert deep.num_layers == 17 and fk.learned_rk4_refusal(deep, NX) is None
    launch = fk.learned_rk4_launch(deep, NX, 0, 10240)
    assert not launch.split and launch.teams == 2
    assert launch.shared_bytes == deep.blob.numel() + 2 * launch.team_bytes <= 232448
    assert deep.blob.numel() > 160 * 1024
    _check_split(deep, 2048, 0, fk.learned_rk4_launch(deep, 2048, 0, 10240), 10240)
    assert fk.learned_rk4_refusal(deep, 2048) is None
    launch = fk.learned_rk4_launch(deep, 2048, 0, 10240, cluster=2)
    assert launch.split and launch.stream and launch.segment == 1024 and launch.slots >= 1
    assert launch.shared_bytes == (launch.slots * fk._window_bytes(deep) + launch.team_bytes
                                   + (launch.groups - 1) * fk._group_bytes(deep)
                                   + fk.RING_CONTROL_BYTES) <= 232448
    wide = _pack(*_torch_model(8, layers=1, kernel_size=19))
    assert fk.learned_rk4_reach(wide) == 9 and fk.learned_rk4_halo(wide) == 9
    assert fk.learned_rk4_refusal(wide, NX) is None
    assert fk.learned_rk4_launch(wide, NX).team_bytes == fk._team_bytes(wide, NX, 0)
    huge = 16 * 2048
    launch = fk.learned_rk4_launch(deep, huge, 20)
    assert launch.teams == 0 and (launch.cluster, launch.segment) == (16, 2048)
    assert fk.learned_rk4_refusal(deep, huge, 20) == (
        f"needs {launch.shared_bytes} bytes of shared memory per block split over 16 blocks "
        "(2048 points each) > the limit of 232448")


def test_learned_rk4_reach_beyond_the_grid_takes_the_cluster_form():
    """A block of whole trajectories writes each halo as one periodic copy,
    which takes a reach up to nx and a conv kernel up to nx + 1 wide; past
    that (kernel 35 on 32 points) the cluster form runs the trajectory,
    whose halos wrap modulo nx, here in a cluster of one block; the plain
    version wraps any reach with its rolls."""
    model, params = _torch_model(8, layers=1, nx=32, kernel_size=35)
    pack = _pack(model, params)
    assert fk.learned_rk4_halo(pack) == 17 and fk.learned_rk4_refusal(pack, 32) is None
    launch = fk.learned_rk4_launch(pack, 32, 0, 10240)
    assert launch.split and (launch.cluster, launch.segment) == (1, 32)
    assert not fk.learned_rk4_launch(pack, 64, 0, 10240).split
    u = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 32)).astype(np.float32))
    assert torch.isfinite(fk.fused_learned_rk4(u, pack, 1e-4, 1)).all()


def test_widen_params_keeps_the_model():
    """convert.widen_params (chip_smoke.py phase 11's 128-filter towers):
    the state dict's values stay in the leading corner; with no noise the
    new channels are zeros and the plain version gives the same result
    (within 1e-4 of max|u|, the learned kernel's parity limit: the CPU's
    matmul blocks a 640-deep sum otherwise than a 160-deep one, which can
    flip a bf16 rounding of the next layer's inputs); with
    noise every new entry is drawn (non-zero) and the same seed draws the
    same tower."""
    model, params = _torch_model(32, layers=3)
    wide = convert.widen_params(params, 128, 11, 0.0)
    for key, value in params.items():
        assert torch.equal(wide[key][tuple(slice(n) for n in value.shape)], value)
    assert wide["tower.1.weight"].shape == (128, 128, 5) and wide["tower.0.weight"].shape == (
        128, 1, 5) and wide["heads.0.weight"].shape[1] == 128
    u = torch.from_numpy(np.random.default_rng(4).standard_normal((4, NX)).astype(np.float32))
    pack, wide_pack = _pack(model, params), _pack(model, wide)
    assert wide_pack.padded_channels == 128
    want = fk.fused_learned_rk4_plain(u, pack, 1e-3, 2)
    torch.testing.assert_close(fk.fused_learned_rk4_plain(u, wide_pack, 1e-3, 2), want,
                               rtol=0, atol=1e-4 * float(want.abs().max()))
    noisy = convert.widen_params(params, 128, 11, 0.02)
    assert noisy["tower.1.weight"][32:].ne(0).all() and noisy["tower.2.bias"][32:].ne(0).all()
    assert all(torch.equal(noisy[k], v) for k, v in
               convert.widen_params(params, 128, 11, 0.02).items())


@pytest.fixture(scope="module")
def wide_packs():
    return {(filters, name): _pack(*_torch_model(filters, name=name, cons=True, size=size))
            for filters in (65, 72, 128) for name, size in (("ks", 6), ("burgers", 8))}


def _ring_team_bytes(pack, nx, terms):
    """A trajectory's shared bytes at 128 channels, counted here from the
    layout (``team_bytes_needed``'s rule): nx rows rounded up to 64 with the
    conv's K - 1 halo rows and a dump row in each of two bf16 buffers of 16
    planes; u with the halo's points a side, fluxes, step start, k sum; one
    [32, F | 1] z tile per warp; forced, the forcing row, 16 bytes of
    alignment, 16 bytes of constants per term, (sin, cos) per term and
    point."""
    rows = -(-nx // 64) * 64
    n = (2 * 16 * (rows + pack.kernel_size) * 16 + 4 * (4 * rows + 2 * fk.learned_rk4_halo(pack))
         + 4 * 32 * (pack.n_free | 1) * 4)
    if terms:
        n += 4 * rows + 16 + 16 * terms + 8 * terms * nx
    return -(-n // 128) * 128


@pytest.mark.parametrize("batch", [1, 3, 256, 10239, 10240])
@pytest.mark.parametrize("nx", [32, 64, 96, 128, 160, 256, 512])
@pytest.mark.parametrize("filters,name", [(65, "ks"), (72, "ks"), (128, "ks"), (128, "burgers")])
def test_learned_rk4_launch_geometry_128_filters(wide_packs, filters, name, nx, batch):
    """Towers of 65 to 128 filters pad to 128, where a block holds one
    trajectory run by two warp groups and a producer warp (288 threads)
    beside a ring of conv tap slices of
    128 x 128 bf16 (32 KB each; the whole buffer is 330 KB, which stays in
    global memory): as many slots as fit beside the trajectory, its second
    group's z tiles and 128 bytes of barriers, up to RING_SLOTS (4; 3 forced
    at nx 128, 2 unforced at nx 256, 1 forced), in clusters of WIDE_CLUSTER
    blocks (2, or 1 for a batch of one), a block a trajectory and the last
    cluster's blocks past an odd batch empty; taken at nx 32 to 256, forced
    (20 terms) or not; at nx = 512 one trajectory's activations alone
    exceed the block's shared memory, which the kernel refused before the
    split form: a cluster shares it beside a ring of slices (each copied
    once for the cluster), in the blocks and warp groups the split form's
    rule ranks first. The buffer lays each layer's slices one after the
    other."""
    pack = wide_packs[(filters, name)]
    terms = 20 if name == "burgers" else 0
    assert pack.padded_channels == fk.WIDE_CHANNELS == 128 and pack.channels == filters
    refusal = fk.learned_rk4_refusal(pack, nx, terms)
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    assert refusal is None and launch.stream
    if nx == 512:
        assert 2 * 128 * 128 + fk._team_bytes(pack, nx, terms) > 232448
        _check_split(pack, nx, terms, launch, batch)
        assert launch.slots >= 1 and launch.multicast == 1
        return
    team = _ring_team_bytes(pack, nx, terms)
    fixed = team + 512 * (pack.n_free | 1) + 128
    slots = min(4, (232448 - fixed) // (2 * 128 * 128))
    assert launch.team_bytes == fk._team_bytes(pack, nx, terms) == team
    assert not launch.split and launch.segment == nx and launch.cluster == 1
    assert (launch.teams, launch.groups, launch.threads, launch.per_team) == (1, 2, 288, 1)
    assert launch.slots == slots >= 1
    assert launch.shared_bytes == slots * 2 * 128 * 128 + fixed <= 232448
    assert launch.multicast == min(2, batch)
    assert launch.blocks == -(-batch // launch.multicast) * launch.multicast
    assert launch.blocks - launch.multicast < batch <= launch.blocks
    for l in range(1, pack.num_layers):  # K slices of 32 KB, each on 16 bytes
        assert pack.blob_offsets[2 * l + 1] - pack.blob_offsets[2 * l] == (
            pack.kernel_size * 2 * 128 * 128)
        assert pack.blob_offsets[2 * l] % 16 == 0


def _cuh_constant(name):
    """An integer constant of csrc/fused_learned_rk4.cuh (``constexpr int
    name = value;``)."""
    import re
    from pde_superresolution_torch.ops import _build

    text = (_build.SOURCE_DIR / "fused_learned_rk4.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("terms", [0, 20])
@pytest.mark.parametrize("nx", [16, 32, 64, 100, 128, 192, 256, 320])
def test_learned_rk4_ring_bytes_count_alike(wide_packs, nx, terms):
    """The host and the kernel count the ring's shared memory alike: the
    constants fused_kernels names after the kernel's (two warp groups, at
    most 5 slots, 128 bytes of barriers, at most 8 blocks a cluster) are
    the .cuh's; ``_team_bytes`` is the layout's count
    (``team_bytes_needed``); ``_ring_bytes`` is what the C entry asks of a
    block (the slots, the team, group 1's z tiles, the control bytes) and
    the launch's; the control bytes hold a full and an empty barrier of 8
    bytes a slot; the rule clamps its constants to the kernel's limits."""
    assert (fk.WIDE_GROUPS, fk.MAX_RING_SLOTS, fk.RING_CONTROL_BYTES, fk.MAX_WIDE_CLUSTER) == (
        _cuh_constant("kWideGroups"), _cuh_constant("kMaxRingSlots"),
        _cuh_constant("kRingControlBytes"), _cuh_constant("kMaxWideCluster"))
    assert 2 * 8 * fk.MAX_RING_SLOTS <= fk.RING_CONTROL_BYTES
    pack = wide_packs[(128, "burgers" if terms else "ks")]
    team = fk._team_bytes(pack, nx, terms)
    assert team == _ring_team_bytes(pack, nx, terms) and team % 16 == 0
    for slots in range(fk.MAX_RING_SLOTS + 1):
        assert fk._ring_bytes(pack, nx, terms, slots) == (
            slots * fk._window_bytes(pack) + team
            + (fk.WIDE_GROUPS - 1) * fk._group_bytes(pack) + fk.RING_CONTROL_BYTES)
    launch = fk.learned_rk4_launch(pack, nx, terms, 10240)
    if launch.split:  # the ring does not fit: one slot beside the trajectory exceeds the limit
        assert fk._ring_bytes(pack, nx, terms, 1) > fk.MAX_SHARED_BYTES
        return
    assert launch.shared_bytes == fk._ring_bytes(pack, nx, terms, launch.slots)
    assert fk._ring_bytes(pack, nx, terms, launch.slots + 1) > fk.MAX_SHARED_BYTES or (
        launch.slots == fk.RING_SLOTS)
    saved = fk.RING_SLOTS, fk.WIDE_CLUSTER
    try:
        fk.RING_SLOTS, fk.WIDE_CLUSTER = 99, 99
        clamped = fk.learned_rk4_launch(pack, nx, terms, 10240)
        assert clamped.slots <= fk.MAX_RING_SLOTS and clamped.multicast == fk.MAX_WIDE_CLUSTER
        assert clamped.shared_bytes <= fk.MAX_SHARED_BYTES
    finally:
        fk.RING_SLOTS, fk.WIDE_CLUSTER = saved


@pytest.fixture(scope="module")
def ring_split_packs():
    """3-layer KS towers at 64, 128 and 256 filters (a chunked form)."""
    return {filters: _pack(*_torch_model(filters, name="ks", size=6)) for filters in (64, 128, 256)}


@pytest.mark.parametrize("terms", [0, 20])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("nx", [512, 1024, 2048])
@pytest.mark.parametrize("filters", [64, 128, 256])
def test_learned_rk4_split_ring_bytes_count_alike(ring_split_packs, filters, nx, cluster, groups,
                                                  terms):
    """The host and the kernel count a split block's ring alike: the
    kernel's z tiles of a later warp group (``group_z_bytes``) are
    ``_group_bytes``; ``_ring_bytes`` of a segment is what the C entry asks
    of a streamed split block (the slots, the segment's layout, the later
    groups' z tiles, kRingControlBytes) and the launch's, and the ring's
    barriers, which the kernel lays after the layout and the z tiles (a full
    and an empty barrier of 8 bytes a slot, up to kMaxRingSlots), end within
    it; a forced cluster and group count that streams (always at 128
    filters and above) takes as many slots as fit beside its segment, up to
    RING_SLOTS, or fewer only where that fits more blocks an SM."""
    import re
    from pde_superresolution_torch.ops import _build

    text = (_build.SOURCE_DIR / "fused_learned_rk4.cuh").read_text()
    assert re.search(r"group_z_bytes\(int n_free\) \{ return 4 \* 32 \* \(n_free \| 1\) \* 4; \}",
                     text)
    assert (fk.RING_CONTROL_BYTES, fk.MAX_RING_SLOTS) == (
        _cuh_constant("kRingControlBytes"), _cuh_constant("kMaxRingSlots"))
    pack = ring_split_packs[filters]
    launch = fk.learned_rk4_launch(pack, nx, terms, 10240, cluster=cluster, groups=groups)
    if not launch.stream or not launch.teams:
        assert filters < 128 or not launch.teams
        return
    seg = launch.segment
    assert fk._group_bytes(pack) == 4 * 32 * (pack.n_free | 1) * 4
    for slots in range(fk.MAX_RING_SLOTS + 1):
        assert fk._ring_bytes(pack, seg, terms, slots, groups) == (
            slots * fk._window_bytes(pack) + fk._team_bytes(pack, seg, terms)
            + (groups - 1) * fk._group_bytes(pack) + fk.RING_CONTROL_BYTES)
    assert launch.shared_bytes == fk._ring_bytes(pack, seg, terms, launch.slots, groups)
    barriers = (launch.slots * fk._window_bytes(pack) + launch.team_bytes
                + (groups - 1) * fk._group_bytes(pack))
    assert barriers % 8 == 0
    assert barriers + 2 * 8 * fk.MAX_RING_SLOTS <= launch.shared_bytes <= fk.MAX_SHARED_BYTES
    _check_split(pack, nx, terms, launch, 10240, cluster, groups)


@pytest.fixture(scope="module")
def split_packs():
    """3-layer towers at the flagship's kernel: KS (unforced, stencil 6)
    and Burgers (forced, stencil 8) at 32, 64 and 128 filters."""
    return {(filters, name): _pack(*_torch_model(filters, name=name, size=size))
            for filters in (32, 64, 128) for name, size in (("ks", 6), ("burgers", 8))}


# The rule's choice at a few shapes of the 3-layer towers (filters, name,
# nx): (blocks, warp groups, streamed); 32 filters at nx 1280 and 2048 are
# the recorded shapes' (RECORDED_SPLIT) at this tower. 64 filters at nx 1024
# took 6 blocks of 2 groups beside one window (16 busy warps an SM) before
# the split form streamed through the ring, whose 2-group blocks below 128
# filters hold a producer warp and 168 registers, one block an SM; the rule
# ranks 3 of 4 groups first now (PERF.md §6).
SPLIT_PINS = {(32, "ks", 2048): (2, 4, False), (32, "burgers", 1280): (5, 2, False),
              (32, "burgers", 2048): (8, 2, False), (64, "burgers", 1024): (3, 4, True),
              (128, "ks", 1024): (4, 2, True)}


@pytest.mark.parametrize("groups", [None, 2])
@pytest.mark.parametrize("cluster", [None, 3])
@pytest.mark.parametrize("nx", [256, 1024, 1280, 2048, 3000, 4096])
@pytest.mark.parametrize("filters,name", [(32, "ks"), (32, "burgers"), (64, "ks"),
                                          (64, "burgers"), (128, "ks"), (128, "burgers")])
def test_learned_rk4_split_launch_geometry(split_packs, filters, name, nx, cluster, groups):
    """The split form's launch: where a block holds the trajectory (and no
    cluster or warp-group count is asked for) the launch is the
    whole-trajectory form's, as before the split form; past that, a launch
    that keeps what every split launch keeps (_check_split: segments that
    cover nx exactly, the last one ragged, every block within 232448 bytes,
    1, 2 or 4 warp groups of 128 threads, at most 2 at 128 filters,
    ``batch x cluster`` blocks), and at the shapes of SPLIT_PINS the rule's
    recorded choice. ``cluster=3`` and ``groups=2`` force the split form
    also where one block holds the trajectory (the card tests hold the forms
    against each other that way) and are honoured; three blocks are
    refused, naming their segments, where they are too few."""
    pack = split_packs[(filters, name)]
    terms = 20 if name == "burgers" else 0
    batch, limit = 10240, 232448
    launch = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster, groups=groups)
    refusal = fk.learned_rk4_refusal(pack, nx, terms, cluster=cluster, groups=groups)
    if cluster is not None and refusal is not None:  # three blocks are too few here
        assert launch.teams == 0 and launch.shared_bytes > limit
        assert f"split over 3 blocks ({-(-nx // 3)} points each)" in refusal
        assert fk.learned_rk4_refusal(pack, nx, terms) is None
        return
    assert refusal is None
    wide = pack.padded_channels == 128
    whole = 2 * 128 * 128 if wide else pack.blob.numel()
    one = fk._team_bytes(pack, nx, terms)
    if cluster is None and groups is None and whole + one <= limit:  # the whole form, unchanged
        if wide:  # the ring: two groups beside as many slots as fit, clusters of two blocks
            slots = min(4, (limit - fk._ring_bytes(pack, nx, terms, 0)) // whole)
            assert launch == (1, 288, one, fk._ring_bytes(pack, nx, terms, slots), batch, False,
                              1, nx, True, 2, 1, slots, 2)
            return
        teams = min(4, (limit - whole) // one, batch // 132)
        assert launch == (teams, 128 * teams, one, whole + teams * one, -(-batch // teams),
                          False, 1, nx, False, 1, 1, 0, 1)
        return
    _check_split(pack, nx, terms, launch, batch, cluster, groups, limit)
    assert launch.cluster <= fk.MAX_CLUSTER
    if cluster is None and groups is None and (filters, name, nx) in SPLIT_PINS:
        assert (launch.cluster, launch.groups, launch.stream) == SPLIT_PINS[(filters, name, nx)]


# The split form's launches at the shapes PERF.md records (trained
# checkpoints on run_ensemble --domain_factor grids, B=10240): (checkpoint,
# filters (0: its own), nx, blocks, warp groups, streamed), each the
# fastest of a sweep of every cluster size and warp-group count on an H100
# (PERF.md).
RECORDED_SPLIT = [
    ("ckpt_burgers8", 0, 1280, 5, 2, False), ("ckpt_ks8", 0, 2048, 2, 4, False),
    ("ckpt_burgers8", 0, 2048, 8, 2, False), ("ckpt_kdv16_f64", 0, 1024, 2, 4, True),
    ("ckpt_ks8", 128, 1024, 4, 2, True),
]


@pytest.mark.parametrize("checkpoint,filters,nx,blocks,groups,stream", RECORDED_SPLIT)
def test_learned_rk4_split_choice_at_recorded_shapes(tmp_path, checkpoint, filters, nx, blocks,
                                                     groups, stream):
    """The rule's launch at each shape PERF.md records is the one the sweep
    found fastest (the rule counts what an SM holds from the shapes alone,
    so the CPU decides as the card does)."""
    from pde_superresolution_torch.scripts import probe_learned_rk4

    model, params = probe_learned_rk4.load_case(checkpoint, filters, nx, torch.device("cpu"),
                                                tmp_path)
    pack = _pack(model, params)
    terms = 20 if model.equation.forced else 0
    launch = fk.learned_rk4_launch(pack, nx, terms, 10240)
    _check_split(pack, nx, terms, launch, 10240)
    assert (launch.cluster, launch.groups, launch.stream) == (blocks, groups, stream)


@pytest.mark.parametrize("filters,cluster,groups", [
    (32, 0, None), (32, 17, None), (32, None, 0), (32, None, 5), (32, 2, 5), (32, None, 3),
    (64, 2, 3), (128, None, 3), (128, 4, 3), (128, None, 4), (256, None, 3)])
def test_learned_rk4_split_refuses_out_of_range(filters, cluster, groups):
    """``cluster`` outside 1..16 and ``groups`` other than 1, 2 or 4 (1 or 2
    at 128 filters and above, whose kernels hold 64 accumulators a thread;
    no kernel has 3) raise,
    in learned_rk4_launch, learned_rk4_refusal and the wrapper on the card;
    the CPU's plain version has no blocks and ignores them."""
    pack = _pack(*_torch_model(filters, layers=1))
    for call in (lambda: fk.learned_rk4_launch(pack, NX, 0, 16, cluster=cluster, groups=groups),
                 lambda: fk.learned_rk4_refusal(pack, NX, 0, cluster=cluster, groups=groups)):
        with pytest.raises(ValueError, match="cluster=|groups="):
            call()
    u = torch.zeros(2, NX)
    assert fk.fused_learned_rk4(u, pack, 1e-3, 1, cluster=cluster, groups=groups).shape == u.shape


def _jax_vmem_bytes(pack, nx, terms, batch_tile=8):
    """The VMEM that make_fused_learned_rk4 asks for a batch tile of
    ``batch_tile`` trajectories (pde_superresolution_tpu/ops/pallas_kernels.py
    :741-755: every live lane tile at 1.5x, on a 16 MiB floor; n_taps is the
    union of the conv's and the stencils' taps, weights[0].shape[0] the
    tower's width, 7 forcing rows a term); it refuses more than
    PHYSICAL_VMEM_BYTES (128 MiB)."""
    kh = pack.kernel_size // 2
    n_taps = len(set(range(-kh, kh + 1)).union(*[set(t) for t in pack.taps.values()]))
    channels, k = pack.channels, pack.kernel_size
    bytes_per_lane = (4 * (n_taps + 3 * channels + pack.n_rows + pack.n_free + 8)
                      + 2 * (2 * k * channels) + 4 * 7 * terms)
    return int(16 * 1024 * 1024 + 1.5 * bytes_per_lane * nx * batch_tile)


@pytest.mark.parametrize("filters,name,size,kernel_size,layers,jax_most", [
    (32, "ks", 6, 5, 3, 8192), (64, "ks", 6, 5, 3, 4352), (128, "ks", 6, 5, 3, 2176),
    (32, "burgers", 8, 5, 3, 5504), (64, "burgers", 8, 5, 3, 3456),
    (128, "burgers", 8, 5, 3, 1920), (32, "ks", 6, 19, 3, 3200), (32, "ks", 18, 5, 3, 6400),
    (32, "ks", 6, 5, 17, 8192), (32, "burgers", 8, 5, 17, 5504),
    (192, "ks", 6, 5, 3, 1536), (256, "ks", 6, 5, 3, 1152), (512, "ks", 6, 5, 3, 512),
    (1024, "ks", 6, 5, 3, 256), (2384, "ks", 6, 5, 1, 128), (256, "burgers", 8, 5, 3, 1024),
    (2304, "burgers", 8, 5, 1, 128),
])
def test_learned_rk4_takes_what_jax_takes(filters, name, size, kernel_size, layers, jax_most):
    """The port's domain against the Pallas kernel's: at a batch tile of 8
    (the smallest its tiling takes) JAX's VMEM estimate admits nx up to
    ``jax_most`` (multiples of 128); learned_rk4_refusal takes every one of
    them, at 32 to 2384 filters, forced (Burgers, 20 terms) and not, at
    a conv kernel of 19 (reach 9), a stencil of 18 taps (reach 9) and 17
    layers (whose weights the split form streams where no cluster of 16
    holds them whole: JAX's estimate does not grow with depth); each split
    launch is the one the split form's rule ranks first, in at most 16
    blocks. The widest towers have one layer: neither estimate grows with depth, and
    the chunked form's launch does not read the weights."""
    pack = _pack(*_torch_model(filters, layers, name, True, size, kernel_size=kernel_size))
    terms = 20 if name == "burgers" else 0
    jax_takes = [nx for nx in range(128, 4 * jax_most, 128)
                 if _jax_vmem_bytes(pack, nx, terms) <= pk.PHYSICAL_VMEM_BYTES]
    assert max(jax_takes) == jax_most and len(jax_takes) == jax_most // 128
    refused = {nx: fk.learned_rk4_refusal(pack, nx, terms) for nx in jax_takes}
    assert all(reason is None for reason in refused.values()), refused
    launches = [fk.learned_rk4_launch(pack, nx, terms, 10240) for nx in jax_takes]
    assert max(launch.cluster for launch in launches) <= fk.MAX_CLUSTER
    for nx, launch in zip(jax_takes, launches):
        if launch.split:
            _check_split(pack, nx, terms, launch, 10240)
    if pack.padded_channels > fk.WIDE_CHANNELS:
        assert all(launch.split and launch.stream for launch in launches)


@pytest.mark.parametrize("name,size,terms", [("ks", 6, 0), ("burgers", 8, 20)])
@pytest.mark.parametrize("filters", [16, 32, 64, 128, 256, 1024])
def test_learned_rk4_ring_takes_what_the_window_took(filters, name, size, terms):
    """The streamed launches' ring against the window they replaced: near
    the longest grid each tower takes (and below it), the refusal takes
    every nx that a launch of the weights whole, or of one window of a
    slice beside a segment of up to 16 blocks, took, save where each such
    launch left less of the block's 232448 bytes free than the ring's 128
    bytes of barriers (the window's bytes and a segment's layout are
    multiples of 128, so only a launch that filled the block exactly)."""
    pack = _pack(*_torch_model(filters, name=name, size=size))
    wide, limit = pack.padded_channels >= 128, 232448
    groups = 512 * (pack.n_free | 1)

    def window_took(nx):  # the least bytes of each form: 16 blocks, one group
        team = fk._team_bytes(pack, -(-nx // 16), terms)
        whole = not wide and pack.blob.numel() + team <= limit
        return whole, fk._window_bytes(pack) + team

    longest = max(nx for nx in range(32, 1 << 16, 32)
                  if window_took(nx)[0] or window_took(nx)[1] <= limit)
    edge = 0
    for nx in range(max(32, longest - 600), longest + 48):
        whole, streamed = window_took(nx)
        took = whole or streamed <= limit
        takes = fk.learned_rk4_refusal(pack, nx, terms) is None
        if took and not takes:  # the barriers did not fit beside a full block
            assert not whole and streamed > limit - fk.RING_CONTROL_BYTES
            edge += 1
        else:
            assert takes == took
    assert edge <= 16  # at most the nx of one segment's length
    assert groups % 128 == 0 and fk._window_bytes(pack) % 128 == 0


@pytest.mark.parametrize("name,size,terms", [("ks", 6, 0), ("burgers", 8, 20)])
@pytest.mark.parametrize("filters", [129, 136, 192, 256, 384, 512, 768, 1024, 1536, 2304, 2384])
def test_learned_rk4_chunked_launch_geometry(filters, name, size, terms):
    """The chunked form's launch at every nx JAX's tile-8 VMEM estimate
    admits (KS-8x shapes unforced, Burgers-8x forced; nothing at 2384
    filters forced): a cluster of at most 16 blocks of 1 or 2 warp groups
    (128 threads each) and a producer warp (32), the segments of ceil(nx /
    blocks) points covering nx, the blocks and groups the split form's rule
    ranks first; each block holds a ring of as many 32 KB slots as fit
    beside its segment, up to 4 (a slot takes one slice of the weights: 128
    output channels of a chunk from 128 input channels of one conv tap, the
    tap's last slice the rest), 128 bytes of the ring's barriers and its
    segment, within 232448 bytes: two bf16 activation buffers of channels /
    8 planes of (the segment rounded up to 8) + K rows, one 64-row tile of
    one plane of slack, the four float32 rows, the z tiles and, forced, the
    phase state. The same at a batch of 8, 256 and 10240."""
    pack = _pack(*_torch_model(filters, 1, name, True, size))
    cp = pack.padded_channels
    assert cp == -(-filters // 16) * 16 and fk._window_bytes(pack) == 32 * 1024
    admitted = [nx for nx in range(128, 4096, 128)
                if _jax_vmem_bytes(pack, nx, terms) <= pk.PHYSICAL_VMEM_BYTES]
    assert bool(admitted) == (name == "ks" or filters <= 2304)

    def team_bytes(points):
        rows = -(-points // 8) * 8
        n = (2 * (cp // 8) * (rows + 5) * 16 + 64 * 16 + 4 * (4 * rows + 2 * 8)
             + 4 * 32 * (pack.n_free | 1) * 4
             + (4 * rows + 16 + 16 * terms + 8 * terms * points if terms else 0))
        return -(-n // 128) * 128

    for nx, batch in [(nx, batch) for nx in admitted for batch in (8, 256, 10240)]:
        launch = fk.learned_rk4_launch(pack, nx, terms, batch)
        c, g, seg = launch.cluster, launch.groups, launch.segment
        assert fk.learned_rk4_refusal(pack, nx, terms) is None
        assert launch.split and launch.stream and launch.teams == 1 and launch.multicast == 1
        assert 1 <= g <= fk.MAX_GROUPS_WIDE == 2 and launch.threads == 128 * g + 32
        assert 1 <= c <= fk.MAX_CLUSTER and seg == -(-nx // c) and (c - 1) * seg < nx
        assert launch.team_bytes == team_bytes(seg) == fk._team_bytes(pack, seg, terms)
        fixed = launch.team_bytes + (g - 1) * 512 * (pack.n_free | 1) + 128
        most = min(4, (232448 - fixed) // (32 * 1024))
        assert launch.slots == most >= 1  # one block an SM at this width: every slot that fits
        assert launch.shared_bytes == launch.slots * 32 * 1024 + fixed <= 232448
        _check_split(pack, nx, terms, launch, batch)


@pytest.mark.parametrize("batch", [3, 256, 1037, 4096, 10240])
def test_rk4_launch_geometry(batch):
    """A warp per trajectory: the blocks' warps cover the batch with one
    block at most partly empty, at most RK4_MAX_WARPS warps a block, and at
    least 132 blocks whenever the batch has 132 trajectories."""
    eq = teq.from_name("ks", conservative=True)
    scheme = fk.make_fused_rk4(eq, TGrid(NX, eq.period), 1e-3, 1).scheme
    launch = fk.rk4_launch(batch, NX, True, scheme.taps)
    assert launch.threads == 32 * launch.warps and 1 <= launch.warps <= fk.RK4_MAX_WARPS
    assert launch.blocks * launch.warps >= batch > (launch.blocks - 1) * launch.warps
    assert launch.blocks >= min(batch, fk.NUM_SMS)
    assert launch.warps == {3: 1, 256: 1, 1037: 7, 4096: 8, 10240: 8}[batch]


def _entry_takes(launch, nx, taps, wide, classic):
    """What pde_fused_rk4 (csrc/fused_rk4.cu) checks of a launch before it
    starts a kernel, and which P its kernels are built for, in Python: True
    where the C entry takes it."""
    if launch.form == "registers":
        return (not wide and 1 <= launch.lanes <= 32 and launch.points * launch.lanes == nx
                and 1 <= launch.warps <= fk.RK4_MAX_WARPS
                and launch.points in fk.RK4_POINTS_PER_LANE)
    if launch.form == "rows":
        reach = fk.rk4_reach(taps)
        return wide and launch.halo >= reach and launch.shared_bytes == 4 * (
            4 * nx + 2 * launch.halo + sum(len(t) for t in taps.values()))
    lo = min(0, min(t[0] for t in taps.values()))
    hi = max(0, max(t[-1] for t in taps.values()))
    total = launch.warps * launch.cluster
    lanes = nx // launch.points
    base, extra = divmod(lanes, total)
    built = fk.RK4_BLOCK_POINTS + ((fk.RK4_BLOCK_CLASSIC_POINTS,) if classic else ())
    return (launch.points in built and nx % launch.points == 0
            and 1 <= launch.cluster <= fk.MAX_CLUSTER
            and 1 <= launch.warps <= fk.RK4_BLOCK_MAX_WARPS
            and (launch.left, launch.right) == (1 - lo, hi)
            and launch.shared_bytes == 4 * (3 * launch.warps * (launch.left + launch.right)
                                            + sum(len(t) for t in taps.values()))
            and (launch.lanes, launch.extra) == (base, extra) and base >= 1
            and base + (extra > 0) <= 32 and base * launch.points >= max(hi, 1 - lo))


def _check_block(launch, nx, taps, batch):
    """The block form's geometry: its warps cover nx exactly, in order, none
    holding fewer points than the edges it publishes (the reach), each
    block's segment at least that long too; blocks of at most
    RK4_BLOCK_MAX_WARPS warps whose registers (RK4_BLOCK_REGISTERS a thread,
    ptxas' bound at that thread count) fit an SM's 65,536; a cluster of at
    most 16 blocks a trajectory, 8 unless a block would need more than 16
    warps (16 blocks at P = 8 past 32,768 points); shared memory within the
    48 KB that needs no opt-in."""
    spans = fk.rk4_warp_spans(launch)
    assert len(spans) == launch.warps * launch.cluster and launch.blocks == batch * launch.cluster
    assert [a for a, _ in spans] == list(np.cumsum([0] + [n for _, n in spans[:-1]]))
    assert sum(n for _, n in spans) == nx
    need = max(launch.left, launch.right, fk.rk4_reach(taps))
    assert min(n for _, n in spans) >= need
    segments = [sum(n for _, n in spans[r * launch.warps:(r + 1) * launch.warps])
                for r in range(launch.cluster)]
    assert sum(segments) == nx and min(segments) >= need
    assert launch.threads == 32 * launch.warps <= 32 * fk.RK4_BLOCK_MAX_WARPS
    assert launch.threads * fk.RK4_BLOCK_REGISTERS <= 65536
    fewest = -(-nx // (32 * launch.points))  # warps of 32 lanes
    assert launch.cluster <= fk.PORTABLE_CLUSTER or -(-fewest // 8) > fk.RK4_BLOCK_MAX_WARPS
    assert launch.shared_bytes <= 49152


@pytest.mark.parametrize("nx", [32, 64, 96, 100, 128, 160, 224, 256, 352, 512, 544, 1024,
                                1056, 2048, 4096, 14496, 14528, 16384, 65536,
                                8192, 32288, 65504])
@pytest.mark.parametrize("name,cons", [("ks", True), ("ks", False), ("kdv", True),
                                       ("kdv", False)])
def test_rk4_refusal(name, cons, nx):
    """The kernel takes every scheme make_fused_rk4 builds at every nx that
    is a multiple of 32: in registers up to 1024 points (P points a lane on
    nx / P lanes, P the smallest built that fits), over the warps of a block
    above (P = 8 points a lane, 1056 and 2048 points in one block of up to 8
    warps), and of a cluster of blocks past 2048 points (nx 16384 on 8
    blocks of 8 warps, 32288 = 32 x 1009 on 8 of 16, 65504 = 32 x 2047 and
    65,536 on 16 of 16; the first two deal their lanes out unevenly). No global scratch at any nx
    (rows in global memory past nx 14496 before). It says why it takes
    nothing else. A scheme shifted 16 points to the right (reach 19, once
    refused) takes the rows form while its rows fit a block, the block form
    past that (and wherever a cluster is given). The CPU path (the plain
    version) still takes every shape."""
    period = teq.from_name(name).period * nx / 128
    eq = teq.from_name(name, conservative=cons, period=period)
    grid = TGrid(nx, period)
    scheme = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid), 1).scheme
    assert {d: (t[0], len(t)) for d, t in scheme.taps.items()} == fk.RK4_LAYOUTS[(name, cons)]
    assert fk.rk4_is_classic(scheme)
    refusal = fk.rk4_refusal(scheme, nx)
    launch = fk.rk4_launch(256, nx, True, scheme.taps) if nx % 32 == 0 else None
    if nx % 32:
        assert refusal == f"nx={nx} is not a multiple of 32 (the JAX kernel takes multiples of 128)"
    else:
        assert refusal is None
    if launch is not None:  # taps at run time: in registers up to 24 points a lane
        assert fk.rk4_launch(256, nx, False, scheme.taps).form == (
            "registers" if nx <= 768 else "block")
    if launch is not None and nx <= 1024:
        assert launch.form == "registers" and launch.points * launch.lanes == nx
        assert 17 <= launch.lanes <= 32 and launch.points in fk.RK4_POINTS_PER_LANE
        assert launch.points == min(p for p in fk.RK4_POINTS_PER_LANE
                                    if 32 * p >= nx and nx % p == 0)
    elif launch is not None:
        assert launch.form == "block" and launch.points == fk.RK4_BLOCK_CLASSIC_POINTS
        # edges of the scheme's own reach (and one point more on the left)
        assert launch.right == fk.rk4_reach(scheme.taps) <= 3 and launch.left <= 4
        # blocks of up to 8 warps over up to 8 blocks, then of up to 16
        assert launch.cluster == {1056: 1, 2048: 1, 4096: 2, 8192: 4, 14496: 8, 14528: 8,
                                  16384: 8, 32288: 8, 65504: 16, 65536: 16}[nx]
        assert launch.warps == {1056: 5, 2048: 8, 4096: 8, 8192: 8, 14496: 8, 14528: 8,
                                16384: 8, 32288: 16, 65504: 16, 65536: 16}[nx]
        _check_block(launch, nx, scheme.taps, 256)
        assert _entry_takes(launch, nx, scheme.taps, False, True)
    for kwargs in ({"accuracy_order": 4}, {"accuracy_order": 6}, {"stencil_size": 16}):
        wide = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid), 1, **kwargs).scheme
        assert not fk.rk4_is_classic(wide) and fk.rk4_refusal(wide, nx) == refusal
    far = dataclasses.replace(scheme, taps={d: tuple(t + 16 for t in taps)
                                            for d, taps in scheme.taps.items()})
    assert fk.rk4_refusal(far, nx) == refusal and fk.rk4_wide(far.taps)
    if launch is not None:  # wide: its rows in shared memory while they fit a block
        wide_launch = fk.rk4_launch(256, nx, False, far.taps)
        assert wide_launch.form == ("rows" if nx <= 14496 else "block")
        assert _entry_takes(wide_launch, nx, far.taps, True, False)
        block = fk._rk4_block(256, nx, far.taps, None)  # the block form's own launch
        assert block.form == "block" and (block.left, block.right) == (1, fk.rk4_reach(far.taps))
        assert _entry_takes(block, nx, far.taps, True, False)
    u = torch.zeros(2, nx)
    assert fk.fused_rk4(u, scheme).shape == (2, nx)  # the CPU's plain version


@pytest.mark.parametrize("name,cons", [("ks", True), ("ks", False), ("kdv", True),
                                       ("kdv", False)])
def test_rk4_takes_every_scheme_and_grid(name, cons):
    """Every scheme make_fused_rk4 builds from stencil_size up to 48 (and
    accuracy orders 2 to 10) at every nx that is a multiple of 32 up to
    65,536: rk4_refusal takes it, and rk4_launch gives a launch the C entry
    takes (``_entry_takes``): registers within 32 taps an order and 16
    points of reach; a wider scheme in the rows form while its rows and
    coefficients fit a block's 232,448 bytes, past that in the block form;
    else the block form, whose warps cover nx exactly and hold at least the
    scheme's reach each (``_check_block``). The block form's own launch
    (``_rk4_block``, what ``cluster=`` forces) takes each wide scheme too
    wherever a warp holds its reach (48 taps reach 24 points, and the one
    warp on a grid of 32 holds them). Nothing takes a global scratch, and nothing the kernel took
    before (every such shape) is refused."""
    eq = teq.from_name(name, conservative=cons)
    grid = TGrid(NX, eq.period)
    dt = eq.stable_time_step(grid)
    schemes = [fk.make_fused_rk4(eq, grid, dt, 1, stencil_size=size).scheme  # staggered: even
               for size in range(max(eq.derivative_orders) + 1, 49) if not cons or size % 2 == 0]
    schemes += [fk.make_fused_rk4(eq, grid, dt, 1, accuracy_order=order).scheme
                for order in (2, 4, 6, 8, 10)]
    assert max(len(t) for sc in schemes for t in sc.taps.values()) == 48
    forms = set()
    for scheme in schemes:
        reach, wide = fk.rk4_reach(scheme.taps), fk.rk4_wide(scheme.taps)
        assert wide == (max(len(t) for t in scheme.taps.values()) > 32 or reach > 16)
        classic = fk.rk4_is_classic(scheme)
        for nx in range(32, 65536 + 1, 32):
            assert fk.rk4_refusal(scheme, nx) is None
            launch = fk.rk4_launch(7, nx, classic, scheme.taps)
            forms.add(launch.form)
            assert _entry_takes(launch, nx, scheme.taps, wide, classic)
            if launch.form == "registers":
                assert not wide and nx <= (1024 if classic else 768)
                continue
            assert wide or nx > (1024 if classic else 768)
            if launch.form == "rows":
                assert wide and launch.halo == reach and launch.blocks == 7
                assert launch.shared_bytes <= fk.MAX_SHARED_BYTES
                if nx % 1024 == 0 or nx == 32:  # the block form's own launch
                    forced = fk._rk4_block(7, nx, scheme.taps, None)
                    assert forced.form == "block" and _entry_takes(forced, nx, scheme.taps,
                                                                   wide, classic)
                    _check_block(forced, nx, scheme.taps, 7)
                continue
            assert not wide or 4 * (4 * nx + 2 * reach + sum(map(len, scheme.taps.values()))) \
                > fk.MAX_SHARED_BYTES
            if nx % 4096 == 0 or nx in (1056, 14528, 32288):
                _check_block(launch, nx, scheme.taps, 7)
    assert forms == {"registers", "block", "rows"}


def _block_input(launch, nx, seed=5):
    """A trajectory of ``nx`` distinct values, and the heads and tails its
    warps publish (fused_rk4_block.cuh's WarpEdges: the first ``right``
    points, the last ``left``), in trajectory order."""
    u = torch.from_numpy(np.random.default_rng(seed).permutation(nx).astype(np.float32))
    spans = fk.rk4_warp_spans(launch)
    heads = [u[a:a + launch.right] for a, n in spans]
    tails = [u[a + n - launch.left:a + n] for a, n in spans]
    return u, spans, heads, tails


def _neighbour_value(launch, spans, heads, tails, g, lane, q):
    """What lane ``lane`` of warp ``g`` holds for its lane-relative point q
    in the block form: its own point, another lane's by shuffle, or past the
    warp's ends a neighbour's edge (fused_rk4_block.cuh: WarpEdges.before
    and after)."""
    p = launch.points
    a, n = spans[g]
    lanes = n // p
    d, e = divmod(q, p)
    src = lane + d
    if 0 <= src < lanes:
        return ("lane", a + src * p + e)
    total = len(spans)
    if src >= lanes:
        return ("head", heads[(g + 1) % total][(src - lanes) * p + e])
    return ("tail", tails[(g - 1) % total][launch.left + src * p + e])


@pytest.mark.parametrize("nx,scheme,cluster", [
    (1056, {}, None), (2048, {}, None), (16384, {}, None), (16384, {}, 16), (32288, {}, None),
    (2048, {"stencil_size": 48}, 1), (128, {"stencil_size": 40}, 1),
    (64, {"stencil_size": 80}, 1), (96, {"accuracy_order": 4}, 1), (2048, {}, 2)])
@pytest.mark.parametrize("name,cons", [("ks", True), ("kdv", False)])
def test_rk4_block_windows_match_roll(name, cons, nx, scheme, cluster):
    """The block form's index arithmetic, in Python as the kernel computes
    it: each lane's window of the stage input, from its own points, the
    other lanes' (shuffles) and, past the warp's ends, the neighbour warps'
    published heads and tails (their own block's or, across the cluster,
    another's), equals torch.roll's at every point and offset the taps
    read (the conservative form one more to the left). The run-time-tap
    kernel's shifts take their values from the same places: every shift to
    the right at the warp's first lane from the left neighbour's tail, every
    shift to the left at the last lane from the right neighbour's head (tap
    t >= 0) or the warp's own tail (t < 0); each equals torch.roll's too."""
    period = teq.from_name(name).period * nx / 128
    eq = teq.from_name(name, conservative=cons, period=period)
    taps = fk.make_fused_rk4(eq, TGrid(nx, period), 1e-4, 1, **scheme).scheme.taps
    launch = fk.rk4_launch(3, nx, not scheme, taps, cluster)
    assert launch.form == "block" and (cluster is None or launch.cluster == cluster)
    assert _entry_takes(launch, nx, taps, fk.rk4_wide(taps), not scheme)
    u, spans, heads, tails = _block_input(launch, nx)
    lo = min(t[0] for t in taps.values()) - cons
    hi = max(t[-1] for t in taps.values())
    p = launch.points
    for g, (a, n) in enumerate(spans):
        for lane in range(n // p):
            for q in range(min(lo, 0), p + max(hi, 0)):
                where, value = _neighbour_value(launch, spans, heads, tails, g, lane, q)
                got = u[value] if where == "lane" else value
                assert got == torch.roll(u, -(a + lane * p + q))[0]
        # the last lane's shifts to the left past the warp's end: point n + t
        for t in range(min(lo, 0), max(hi, 0)):
            edge = tails[g][launch.left + t] if t < 0 else heads[(g + 1) % len(spans)][t]
            assert edge == u[(a + n + t) % nx]
        # the first lane's shifts to the right: point t - 1 - c, from the left tail
        for t in range(0, min(lo, 0) + cons, -1):
            assert tails[(g - 1) % len(spans)][launch.left + t - 1 - cons] == \
                u[(a + t - 1 - cons) % nx]


RHS_TAPS = {  # the KS-8x checkpoint's (3 orders of 6) and the Burgers-8x one's (2 of 8)
    "ks8": {0: list(range(-2, 4)), 1: list(range(-2, 4)), 3: list(range(-2, 4))},
    "burgers8": {0: list(range(-3, 5)), 1: list(range(-3, 5))},
}


@pytest.mark.parametrize("batch", [3, 256, 4096, 10240])
@pytest.mark.parametrize("nx", [32, 96, 128, 1024, 4096])
@pytest.mark.parametrize("model", sorted(RHS_TAPS))
def test_rhs_launch_geometry(model, nx, batch):
    """One thread per point: the blocks cover every point once (whole
    trajectories, or one trajectory's segments of a multiple of 32 points
    where a whole one does not fit), within 1024 threads and the 48 KB of
    shared memory that need no opt-in (under the card's 227 KB), which hold
    the u windows with a halo as wide as the taps reach (one more for a
    segment's left face), the fluxes, and each order's coefficients as they
    lie in device memory, every block of floats on 16 bytes; at least 132
    blocks whenever the batch has 132 trajectories."""
    taps = RHS_TAPS[model]
    launch = fk.rhs_launch(batch, nx, taps)
    assert launch.halo == max(1 - min(t[0] for t in taps.values()),
                              max(t[-1] for t in taps.values()))
    def align4(n):
        return -(-n // 4) * 4

    points = launch.rows * launch.seg
    assert launch.shared_bytes == 4 * (
        align4(launch.rows * (launch.seg + 2 * launch.halo) + launch.rows * (launch.seg + 1))
        + sum(align4(points * len(t)) for t in taps.values()))
    assert launch.shared_bytes <= fk.RHS_SHARED_BYTES < 232448
    assert launch.seg <= launch.threads_x <= launch.seg + 31 and launch.threads_x % 32 == 0
    assert launch.rows * launch.threads_x <= 1024
    assert launch.parts * launch.seg >= nx > (launch.parts - 1) * launch.seg
    groups = launch.blocks // launch.parts
    assert launch.blocks == groups * launch.parts
    assert groups * launch.rows >= batch > (groups - 1) * launch.rows
    assert launch.blocks >= min(batch, fk.NUM_SMS)
    if launch.parts == 1:
        assert launch.seg == nx and launch.rows * nx <= max(nx, fk.RHS_BLOCK_POINTS)
    else:
        assert launch.rows == 1 and launch.seg % 32 == 0
        assert launch.seg == fk.MAX_THREADS or fk._rhs_shared_bytes(1, launch.seg + 32, launch.halo, [len(t) for t in taps.values()]) \
            > fk.RHS_SHARED_BYTES
    if nx == 128:
        assert launch.rows == 1 and launch.blocks == batch
    if nx == 32:
        assert launch.rows == max(1, min(4, batch // fk.NUM_SMS))
