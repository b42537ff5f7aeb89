"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present. On a machine with
one (and without JAX, so without the repo's JAX conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import ModelConfig, StencilModel
from pde_superresolution_torch.ops import fused_kernels as fk

pytestmark = pytest.mark.gpu

# fused_learned_rk4 against its plain version (see the test's docstring).
# The tensor cores sum a layer's products in another order than the plain
# version's float32 matmul, so a few activations per thousand points round
# to the other bf16 neighbour; each moves its point and its neighbours by up
# to 2e-4 of the increment. On an H100 one step from N(0,1) read, of the
# increment's maximum, 2.3e-8 to 3.1e-6 in root mean square and 1.7e-7 to
# 1.8e-4 at the worst point (the plain version differs from a float64 sum
# of the same bf16 values too: chip_smoke.py reads both); 10 steps from a
# smooth state read 8.3e-8 to 1.6e-6 of max|u| (`pytest -rP` prints the readings).
STEP_RMS_TOL = 3e-5
STEP_MAX_TOL = 1.5e-3
RUN_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_step_close(got_inc, want_inc):
    """One step's increment within both limits; prints the readings (shown
    by ``pytest -rP``)."""
    scale = float(want_inc.abs().max())
    diff = got_inc - want_inc
    rms, worst = float(diff.square().mean().sqrt()) / scale, float(diff.abs().max()) / scale
    print(f"one step, of the increment's max: rms {rms:.3e}, worst point {worst:.3e}")
    assert rms <= STEP_RMS_TOL and worst <= STEP_MAX_TOL


def _assert_run_close(got, want, tol):
    worst = float((got - want).abs().max() / want.abs().max())
    print(f"10 steps, of max|u|: worst point {worst:.3e}")
    assert worst <= tol


def _model(name, cons, size, device, nx=96, filters=8, layers=2, seed=0, batch=3):
    eq = teq.from_name(name, conservative=cons)
    grid = Grid(8 * nx, eq.period).resample(8, conservative=cons)
    model = StencilModel(eq, grid, ModelConfig(num_layers=layers, filters=filters,
                                               stencil_size=size), device=device)
    gen = torch.Generator().manual_seed(seed)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen).to(device)
              for k, v in model.init_params(gen).items()}
    u = eq.initial_conditions(gen, grid, (batch,), device)
    return model, params, u


@pytest.mark.parametrize("name,cons,size", [
    ("burgers", True, 6), ("burgers", False, 5), ("kdv", True, 6),
    ("kdv", False, 7), ("ks", True, 6), ("ks", False, 7), ("burgers", True, 8),
])
@pytest.mark.parametrize("batch,nx", [(3, 96), (256, 128), (4096, 128), (10240, 128),
                                      (1001, 32), (5, 1024)])
def test_fused_rhs_matches_plain(cuda, name, cons, size, batch, nx):
    """All six equation forms, and stencils of 5 to 8 taps (8, as the
    Burgers-8x checkpoint has, lays the coefficients out swizzled in shared
    memory), at a ragged shape (B=3, nx=96), the main paths' batches at
    nx=128 (one trajectory per block) and B=1001 at nx=32 (four
    trajectories per block, the last block holding one), forced for
    Burgers: float32 on both sides, tap sums in another order and with FMAs,
    then a face difference over dx that cancels most of the sum (measured
    1.7e-5 of max|u_t| for conservative KS on an H100), so within 1e-4 of
    max|u_t|. At nx=1024 (a trajectory split into segments, each computing
    the face left of it) dx is 8 times smaller and the cancellation of the
    dx^-3 terms leaves the plain version itself 1e-3 away from float64 sums
    of the same inputs, so there the kernel is held to be no further from
    those sums than twice the plain version's distance."""
    model, params, u = _model(name, cons, size, cuda, nx=nx, batch=batch)
    coeffs = model.coefficients(params, u)
    f = torch.randn(u.shape, device=cuda) if model.equation.forced else None
    args = (model.equation, model.grid, model.taps)
    want = fk.fused_rhs_plain(u, coeffs, f, *args)
    before = fk.fused_rhs.launches
    got = fk.fused_rhs(u, coeffs, f, *args)
    torch.cuda.synchronize()
    assert fk.fused_rhs.launches == before + 1
    exact = fk.fused_rhs_plain(u.double(), {d: c.double() for d, c in coeffs.items()},
                               None if f is None else f.double(), *args)
    scale = float(exact.abs().max())
    kernel_err = float((got.double() - exact).abs().max()) / scale
    plain_err = float((want.double() - exact).abs().max()) / scale
    worst = float((got - want).abs().max() / want.abs().max())
    print(f"of max|u_t|: worst point {worst:.3e}; from float64 sums: kernel {kernel_err:.3e}, "
          f"plain {plain_err:.3e}; {fk.rhs_launch(batch, nx, model.taps)}")
    assert kernel_err <= 2 * plain_err + 1e-6
    if nx <= 128:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("name,cons,size,nx", [
    ("ks", True, 6, 128), ("kdv", True, 6, 64), ("ks", False, 7, 96),
    ("ks", True, 6, 160), ("kdv", False, 7, 1024),
])
def test_fused_learned_rk4_matches_plain(cuda, name, cons, size, nx):
    """The kernel and the plain version round the tower's inputs to bf16 at
    the same places and sum in float32 in other orders, which can flip
    single bf16 roundings. One step from a standard-normal state, where the
    tower's output moves every point, compared on the increment u(dt) -
    u(0): within STEP_RMS_TOL of its max in root mean square and
    STEP_MAX_TOL at the worst point. Then 10 steps from the seeded smooth
    state: within RUN_TOL of max|u|. All sit near 10x the largest reading
    on an H100 and below what a wrong tower gives (chip_smoke.py plants
    such faults). nx = 160 is an odd number of 64-point tiles, the last half
    empty; nx = 1024 walks eight pairs of tiles."""
    model, params, u = _model(name, cons, size, cuda, nx=nx, filters=16)
    u = 0.3 * u
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    pack = fk.pack_learned_rk4(params, model.equation, model.grid,
                               model.config.kernel_size, model.constraint_layers,
                               model.taps)
    rough = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, nx)).astype(np.float32)).to(cuda)
    want_inc = fk.fused_learned_rk4_plain(rough, pack, dt, 1) - rough
    want = fk.fused_learned_rk4_plain(u, pack, dt, 10)
    before = fk.fused_learned_rk4.launches
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1) - rough
    got = fk.fused_learned_rk4(u, pack, dt, 10)
    torch.cuda.synchronize()
    assert fk.fused_learned_rk4.launches == before + 2
    _assert_step_close(got_inc, want_inc)
    _assert_run_close(got, want, RUN_TOL)


def test_flagship_rhs_fn_on_card_matches_cpu(cuda):
    """The KS-8x checkpoint's rhs_fn through the kernel on the card against
    the port's plain path on the CPU in float64: within 1e-4 of max|u_t|."""
    model, params, _ = convert.load_asset("ckpt_ks8", device=cuda)
    ref_model, ref_params, _ = convert.load_asset("ckpt_ks8", device="cpu")
    rng = np.random.default_rng(0)
    u = rng.standard_normal((4, model.grid.size)).astype(np.float32)
    got = model.rhs_fn(params)(torch.from_numpy(u).to(cuda), 0.0).cpu()
    want = ref_model.rhs_fn({k: v.double() for k, v in ref_params.items()},
                            use_kernel=False)(torch.from_numpy(u).double(), 0.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("cons,size,nx,filters", [
    (True, 6, 128, 16), (False, 5, 96, 16), (True, 8, 96, 8),
])
def test_forced_learned_rk4_matches_plain(cuda, cons, size, nx, filters):
    """Burgers with in-kernel forcing from t0 = 3.7 against the plain
    version on the same ForcingPack: both rotate the phase state with
    separately rounded products and sum the 20 terms in term order, so the
    forcing adds no difference of its own and the limits are the unforced
    kernel's (STEP_RMS_TOL and STEP_MAX_TOL on one step's increment from a
    standard-normal state, RUN_TOL after 10 steps). 8 filters pad to the
    16-channel instantiation; nx = 96 leaves the second 64-point tile half
    empty. A pack whose start time is ignored must fail both limits."""
    model, params, u = _model("burgers", cons, size, cuda, nx=nx, filters=filters)
    gen = torch.Generator().manual_seed(1)
    forcing = model.equation.sample_forcing(gen, (8,), cuda)
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    pack = fk.pack_learned_rk4(params, model.equation, model.grid,
                               model.config.kernel_size, model.constraint_layers,
                               model.taps)
    rough = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, nx)).astype(np.float32)).to(cuda)
    smooth = model.equation.initial_conditions(gen, model.grid, (8,), cuda)
    fp = fk.pack_forcing(forcing, 3.7, model.equation, model.grid, dt, 8)
    want_inc = fk.fused_learned_rk4_plain(rough, pack, dt, 1, fp) - rough
    want = fk.fused_learned_rk4_plain(smooth, pack, dt, 10, fp)
    before = fk.fused_learned_rk4.launches
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=forcing, t=3.7) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    stale = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=forcing, t=0.0)
    torch.cuda.synchronize()
    assert fk.fused_learned_rk4.launches == before + 3
    _assert_step_close(got_inc, want_inc)
    _assert_run_close(got, want, RUN_TOL)
    assert float((stale - want).abs().max()) > 100 * RUN_TOL * float(want.abs().max())


@pytest.mark.parametrize("name,cons,size,filters,layers,batch", [
    ("ks", True, 6, 32, 3, 530), ("burgers", True, 8, 32, 3, 397),
    ("kdv", False, 7, 32, 3, 265), ("ks", True, 6, 64, 2, 7),
])
def test_learned_rk4_flagship_width_ragged_blocks(cuda, name, cons, size, filters, layers, batch):
    """The flagship tower's width (3 layers x 32 filters, nx = 128) at
    batches that are no multiple of the trajectories per block: 530 = 132 x
    4 + 2 (the last block holds 2 of 4), 397 = 132 x 3 + 1 (forced), 265 =
    132 x 2 + 1; and the widest instantiation, 64 filters, one per block.
    Limits as in test_fused_learned_rk4_matches_plain; every trajectory is
    compared, so a team that read or wrote
    another's rows would show."""
    model, params, _ = _model(name, cons, size, cuda, nx=128, filters=filters, layers=layers)
    gen = torch.Generator().manual_seed(3)
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    pack = fk.pack_learned_rk4(params, model.equation, model.grid,
                               model.config.kernel_size, model.constraint_layers,
                               model.taps)
    fp, terms = None, 0
    if model.equation.forced:
        forcing = model.equation.sample_forcing(gen, (batch,), cuda)
        fp = fk.pack_forcing(forcing, 3.7, model.equation, model.grid, dt, batch)
        terms = fp.amplitude.shape[-1]
    launch = fk.learned_rk4_launch(pack, 128, terms, batch)
    assert launch.teams == max(1, min(batch // 132, 4))
    assert launch.teams == 1 or batch % launch.teams
    rough = torch.from_numpy(
        np.random.default_rng(0).standard_normal((batch, 128)).astype(np.float32)).to(cuda)
    smooth = 0.3 * model.equation.initial_conditions(gen, model.grid, (batch,), cuda)
    want_inc = fk.fused_learned_rk4_plain(rough, pack, dt, 1, fp) - rough
    want = fk.fused_learned_rk4_plain(smooth, pack, dt, 10, fp)
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    torch.cuda.synchronize()
    _assert_step_close(got_inc, want_inc)
    _assert_run_close(got, want, RUN_TOL)


@pytest.mark.parametrize("name,cons", [("ks", True), ("ks", False), ("kdv", True),
                                       ("kdv", False)])
@pytest.mark.parametrize("batch,nx", [(3, 96), (256, 128), (5, 1024), (1037, 128),
                                      (10240, 128), (7, 160)])
def test_fused_rk4_matches_plain(cuda, name, cons, batch, nx):
    """The fixed-stencil baseline kernel against its plain version, 20 RK4
    steps: the same float32 operations in the same order, each rounded on
    its own, so equal to a few ulps: 1e-6 of max|u| (read 0 on an H100).
    A warp owns a trajectory, nx / 32 points a lane (3, 4, 5 and 32 here);
    B=1037 runs 7 warps per block, the last block holding one."""
    period = teq.from_name(name).period * nx / 128  # the same dx at every nx
    eq = teq.from_name(name, conservative=cons, period=period)
    grid = Grid(nx, period)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (batch,), cuda)
    advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid), 20)
    want = fk.fused_rk4_plain(u, advance.scheme)
    before = fk.fused_rk4.launches
    got = advance(u)
    torch.cuda.synchronize()
    assert fk.fused_rk4.launches == before + 1
    print(f"of max|u|: worst point {float((got - want).abs().max() / want.abs().max()):.3e}; "
          f"{fk.rk4_launch(batch)}")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def test_fused_rk4_refuses_on_card(cuda):
    """On the card the wrapper raises rk4_refusal's reason for a grid that is
    no multiple of 32, and for a scheme the kernel is not built for, before
    any launch; the CPU runs both in the plain version."""
    eq = teq.from_name("ks", conservative=True, period=teq.from_name("ks").period * 100 / 128)
    grid = Grid(100, eq.period)
    advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid), 2)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (4,), cuda)
    before = fk.fused_rk4.launches
    with pytest.raises(ValueError, match="nx=100 is not a multiple of 32"):
        advance(u)
    grid = Grid(128, teq.from_name("ks").period)
    eq = teq.from_name("ks", conservative=True)
    wide = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid), 2, accuracy_order=4)
    with pytest.raises(ValueError, match="not the classic scheme"):
        wide(torch.zeros(4, 128, device=cuda))
    assert fk.fused_rk4.launches == before
    assert advance(u.cpu()).shape == (4, 100)


def test_run_ensemble_routes_on_card(cuda):
    """The ensemble entry point on the card, 64 Burgers trajectories with a
    warm-up: --fused auto takes the kernel (one launch per save), --fused
    false takes rhs_fn steps (four fused_rhs launches per step), and the two
    final states agree to the bf16 tower's effect (2e-3 of max|u|, the JAX
    package's bound for its kernel against a float32 tower)."""
    from pde_superresolution_torch.scripts import run_ensemble

    args = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", "64",
            "--time_max", "0.1", "--warmup_time", "0.2", "--num_saves", "3"]
    fk.fused_learned_rk4.launches = fk.fused_rhs.launches = 0
    fused = run_ensemble.main(args)
    assert fused["path"] == "fused kernel" and fused["reason"].startswith("auto: cuda")
    assert (fk.fused_learned_rk4.launches, fk.fused_rhs.launches) == (3, 0)
    steps = run_ensemble.main(args + ["--fused", "false"])
    assert steps["path"] == "rhs_fn steps"
    assert fk.fused_rhs.launches == 4 * steps["num_steps"]
    assert fused["finite"] == steps["finite"] == 64
    torch.testing.assert_close(fused["final"], steps["final"], rtol=0,
                               atol=2e-3 * float(steps["final"].abs().max()))


# The fused_rhs Function on the card: the forward is the kernel, the
# backward the plain VJP at the kernel's inputs, so gradients differ from the
# plain route only through the forward's tap order and FMAs (1e-6 of max|u_t|
# per RHS). Of each leaf's largest value: after one RHS; after a short
# rematerialized rollout, of its states' mean squared error (smooth); and of
# the training loss, a mean absolute error whose sign(pred - label) flips
# where a rounding moves a state across its label (read 2.6e-3 on an H100).
RHS_GRAD_TOL = 1e-4
ROLLOUT_GRAD_TOL = 3e-3
LOSS_GRAD_TOL = 2e-2


@pytest.mark.parametrize("name,cons,size", [("ks", True, 6), ("burgers", True, 6),
                                            ("kdv", False, 7), ("ks", False, 7)])
def test_fused_rhs_gradients_match_plain_route(cuda, name, cons, size):
    """Gradients of a weighted sum of one RHS with respect to the params and
    u, kernel route against plain route (per-sample times and forcing for
    Burgers); the backward launches nothing."""
    model, params, u = _model(name, cons, size, cuda, nx=128, batch=64)
    gen = torch.Generator().manual_seed(1)
    forcing = model.equation.sample_forcing(gen, (64,), cuda)
    t = torch.rand(64, generator=gen).to(cuda)
    w = torch.randn(u.shape, generator=gen).to(cuda)
    grads = {}
    for use_kernel in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        x = u.clone().requires_grad_()
        out = model.rhs_fn(leaves, forcing, use_kernel=use_kernel)(x, t)
        before = fk.fused_rhs.launches
        g = torch.autograd.grad((w * out).sum(), [x, *leaves.values()])
        assert fk.fused_rhs.launches == before
        grads[use_kernel] = dict(zip(["u", *leaves], g))
    worst = max(float((grads[True][k] - grads[False][k]).abs().max())
                / float(grads[False][k].abs().max()) for k in grads[False])
    print(f"one RHS, worst gradient leaf of its max: {worst:.3e}")
    assert worst <= RHS_GRAD_TOL


def test_training_loss_routes_agree_on_card(cuda):
    """compute_loss at B=128 with a 2-snapshot rollout of 12 substeps (the
    recipe's: fewer are beyond the model's stable step) from the KS-8x
    checkpoint: the kernel route's loss and gradients against the plain
    route's, and 2 x 96 fused_rhs launches (forward and recompute); the
    gradients of the rollout's mean squared error by both routes."""
    from pde_superresolution_torch.training import data as tdata
    from pde_superresolution_torch.training import losses as tlosses

    model, params, _ = convert.load_asset("ckpt_ks8", device=cuda)
    eq = model.equation
    fine = Grid(1024, eq.period)
    snaps = tdata.generate_snapshots(eq, fine, torch.Generator().manual_seed(0), 16, 10, 0.05,
                                     warmup_time=10.0, ic_scale=0.1, device=cuda)
    data = tdata.build_training_data(eq, fine, snaps, 8, unroll_steps=2)
    norms = tlosses.compute_loss_norms(model, data, 2, 0.05, substeps=12)
    results = {}
    for use_kernel in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        before = fk.fused_rhs.launches
        loss, _ = tlosses.compute_loss(model, leaves, data, norms, tlosses.LossWeights(), 0.05,
                                       2, 12, use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        results[use_kernel] = (float(loss), dict(zip(leaves, grads)),
                               fk.fused_rhs.launches - before)
    assert results[True][2] == 2 * 2 * 12 * 4 and results[False][2] == 0
    loss_err = abs(results[True][0] - results[False][0]) / abs(results[False][0])
    worst = max(float((results[True][1][k] - results[False][1][k]).abs().max())
                / float(results[False][1][k].abs().max()) for k in params)
    labels = data.rollout.transpose(0, 1).double()
    smooth = {}
    for use_kernel in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        states = tlosses.rollout_states(model.rhs_fn(leaves, use_kernel=use_kernel), data.inputs,
                                        data.t, 0.05, 12, 2)
        value = 0.5 * (states.double() - labels).square().mean()
        smooth[use_kernel] = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
    smooth_worst = max(float((smooth[True][k] - smooth[False][k]).abs().max())
                       / float(smooth[False][k].abs().max()) for k in params)
    print(f"loss rel {loss_err:.3e}, worst gradient leaf of its max {worst:.3e}; "
          f"rollout's mean squared error, worst gradient leaf {smooth_worst:.3e}")
    assert loss_err <= 1e-5 and worst <= LOSS_GRAD_TOL and smooth_worst <= ROLLOUT_GRAD_TOL


# -- the serving export and the HDF5 route on the card ----------------------------------


@pytest.mark.parametrize("name", ["ks", "burgers"])
def test_served_model_matches_live_on_card(cuda, tmp_path, name):
    """An artifact traced on the CPU and loaded on the card: the TF32 pins
    of a live model are set, no kernel of the port is launched, the RHS
    equals the live plain route to 1e-7 of max|u_t| (read 0 on an H100) and
    the fused_rhs route to 1e-4 (read 3.4e-5 for KS, 3.5e-6 for Burgers:
    the kernel's tap order, phase 3's limit), and the advance equals
    integrate of the plain route to 1e-7 of max|u| (read 0; ``pytest -rP``
    prints the readings)."""
    from pde_superresolution_torch import export, integrate

    model, params, _ = _model(name, True, 6, cuda, nx=128, batch=3)
    export.export_and_save(model, params, str(tmp_path / "a"), num_steps=2)
    torch.backends.cudnn.allow_tf32 = True
    served = export.load_served_model(str(tmp_path / "a"))
    assert served.device.type == "cuda" and not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(1)
    u = model.equation.initial_conditions(gen, model.grid, (256,), cuda)
    f = model.equation.sample_forcing(gen, (256,), cuda)
    t = torch.tensor(0.3, device=cuda)
    before = (fk.fused_rhs.launches, fk.fused_learned_rk4.launches, fk.fused_rk4.launches)
    with torch.no_grad():
        got = served.rhs_fn(f)(u, t)
        adv, _ = served.advance(u, 0.3, f)
        assert (fk.fused_rhs.launches, fk.fused_learned_rk4.launches,
                fk.fused_rk4.launches) == before
        plain = model.rhs_fn(params, f, use_kernel=False)(u, t)
        kernel = model.rhs_fn(params, f)(u, t)
        _, traj = integrate.integrate(model.rhs_fn(params, f, use_kernel=False), u,
                                      served.meta["dt"], 2, 2, t0=0.3)
    reads = [float((got - ref).abs().max() / ref.abs().max()) for ref in (plain, kernel)]
    step = float((adv - traj[-1]).abs().max() / traj[-1].abs().max())
    print(f"{name}: served vs plain {reads[0]:.3e}, vs fused_rhs {reads[1]:.3e}, advance {step:.3e}")
    assert reads[0] <= 1e-7 and reads[1] <= 1e-4 and step <= 1e-7


def test_exported_dir_through_both_clis_on_card(cuda, tmp_path):
    """run_export on the card, then --exported_dir through run_ensemble and
    run_evaluation: no kernel launched, and the results within float32
    rounding of the live checkpoint's (the fused_rhs route): ensemble final
    states within 5e-6 of max|u| (read 3.6e-7 on an H100), evaluation model
    trajectories within 2e-5 of max|exact| (read 1.9e-6), the same survival
    statistics."""
    from pde_superresolution_torch.scripts import run_ensemble, run_evaluation, run_export

    path = str(tmp_path / "b8")
    out = run_export.main(["--checkpoint_dir", "ckpt_burgers8", "--output_dir", path,
                           "--num_steps", "0"])
    assert out["max_abs_err"] <= run_export.MAX_ABS_ERR
    assert out["kernel_rel_err"] <= run_export.KERNEL_REL_ERR
    args = ["--num_trajectories", "64", "--time_max", "0.1", "--warmup_time", "0.2",
            "--num_saves", "3"]
    fk.fused_rhs.launches = 0
    served = run_ensemble.main(["--exported_dir", path, *args])
    assert served["path"] == "frozen artifact, rhs_fn steps" and fk.fused_rhs.launches == 0
    live = run_ensemble.main(["--checkpoint_dir", "ckpt_burgers8", "--fused", "false", *args])
    ens = float((served["final"] - live["final"]).abs().max() / live["final"].abs().max())
    flags = ["--num_samples", "8", "--time_max", "0.5", "--reference_cache_dir", "",
             "--output_path", str(tmp_path / "e.h5")]
    parser = run_evaluation.build_parser()
    got = run_evaluation.evaluate_checkpoint(parser.parse_args(["--exported_dir", path, *flags]))
    want = run_evaluation.evaluate_checkpoint(
        parser.parse_args(["--checkpoint_dir", "ckpt_burgers8", *flags]))
    g, w = got["results"][0], want["results"][0]
    ev = float((g.trajectories["model"] - w.trajectories["model"]).abs().max()
               / w.exact.abs().max())
    print(f"ensemble {ens:.3e}, evaluation {ev:.3e}")
    assert ens <= 5e-6 and ev <= 2e-5
    assert got["per_key"][0]["model"]["survival_median"] == \
        want["per_key"][0]["model"]["survival_median"]


def test_resumable_route_on_card(cuda, tmp_path):
    """run_ensemble --output_path on the card (h5py needed): the rhs_fn
    route with a fused_rhs launch per RHS, and a run cut after its first
    save resumes bit for bit to the uninterrupted result."""
    h5py = pytest.importorskip("h5py")
    from pde_superresolution_torch.scripts import run_ensemble

    args = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", "256", "--time_max",
            "0.1", "--warmup_time", "0.2", "--num_saves", "3"]
    fk.fused_rhs.launches = 0
    full = run_ensemble.main([*args, "--output_path", str(tmp_path / "full.h5")])
    assert full["path"] == "resumable rhs_fn steps"
    assert fk.fused_rhs.launches == 4 * full["num_steps"]
    real_flush = h5py.File.flush

    class Cut(Exception):
        pass

    def flush(self):
        real_flush(self)
        raise Cut

    h5py.File.flush = flush
    try:
        with pytest.raises(Cut):
            run_ensemble.main([*args, "--output_path", str(tmp_path / "cut.h5")])
    finally:
        h5py.File.flush = real_flush
    resumed = run_ensemble.main([*args, "--output_path", str(tmp_path / "cut.h5")])
    assert torch.equal(resumed["final"], full["final"])


@pytest.mark.parametrize("kernel", ["fused_rhs", "fused_learned_rk4", "fused_rk4"])
def test_checked_sees_each_kernel_on_card(cuda, kernel):
    """``debugging.checked`` on a kernel launched through ctypes (no dispatch
    mode sees it): a clean call bit for bit the unchecked one, and a NaN in
    ``u`` caught by the kernel's own output check, which names it."""
    from pde_superresolution_torch.utils import debugging

    model, params, u = _model("ks", True, 6, cuda, nx=128, batch=8)
    if kernel == "fused_rhs":
        coeffs = model.coefficients(params, u)
        fn = lambda v: fk.fused_rhs(v, coeffs, None, model.equation, model.grid, model.taps)
    elif kernel == "fused_learned_rk4":
        fn = model.fused_rk4_fn(params, 1e-3, 4)
    else:
        fn = fk.make_fused_rk4(model.equation, model.grid, 1e-3, 4)
    assert torch.equal(debugging.checked(fn)(u), fn(u))
    bad = u.clone()
    bad[2, 7] = float("nan")
    with pytest.raises(FloatingPointError, match=rf"^nan generated by primitive: {kernel}\.$"):
        debugging.checked(fn)(bad)


def test_trace_and_debug_nans_on_card(cuda, tmp_path):
    """``profiling.trace`` records the kernels launched through ctypes, and
    ``debug_nans`` reaches a backward that autograd runs on its device
    thread."""
    from pde_superresolution_torch import bench
    from pde_superresolution_torch.utils import debugging, profiling

    model, params, u = _model("ks", True, 6, cuda, nx=128, batch=8)
    with profiling.trace(str(tmp_path)):
        model.fused_rk4_fn(params, 1e-3, 2)(u)
        model.rhs_fn(params)(u, 0.0)
        torch.cuda.synchronize()
    names = " ".join(name for name, _, _ in bench.device_events(str(tmp_path)))
    assert "fused_learned_rk4" in names and "fused_rhs" in names
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    out = model.rhs_fn(leaves)(u, 0.0)
    with debugging.debug_nans(), pytest.raises(FloatingPointError, match="encountered in"):
        out.backward(torch.full_like(out, float("nan")))
