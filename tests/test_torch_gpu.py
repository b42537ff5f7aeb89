"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present. On a machine with
one (and without JAX, so without the repo's JAX conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import dataclasses

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
# At the zoo's nx = 32 with 10 taps (dx four times the flagship's) the plain
# version itself is 2.4e-5 to 2.9e-5 of max|u| from float64 sums after 10
# steps (its third-derivative taps of order dx^-3 cancel in the face
# difference): there a run is held to RUN_CONDITIONING times that distance
# where it exceeds RUN_TOL (the kernel read 3.7e-5 and 3.8e-5, 1.5x).
RUN_CONDITIONING = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# At 65-128 filters (padded to 128) a layer sums 640 bf16 products, four
# times the flagship's 160, and the seeded towers' activations are large, so
# more roundings flip: one step from N(0,1) read 2.7e-6 to 3.1e-5 in root
# mean square and 3.1e-4 to 2.3e-3 at the worst point on an H100 (the runs
# as narrower towers'). A planted fault reads about 1e-2 in root mean
# square (chip_smoke.py phase 11).
WIDE_STEP_RMS_TOL = 1e-4
WIDE_STEP_MAX_TOL = 1e-2


def _assert_step_close(got_inc, want_inc, rms_tol=STEP_RMS_TOL, max_tol=STEP_MAX_TOL,
                       exact_inc=None):
    """One step's increment within both limits; prints the readings (shown
    by ``pytest -rP``). With ``exact_inc`` (the plain version's increment
    with float64 sums) each limit is at least RUN_CONDITIONING times the
    plain version's own distance from it in the same statistic."""
    scale = float(want_inc.abs().max())
    diff = got_inc - want_inc
    rms, worst = float(diff.square().mean().sqrt()) / scale, float(diff.abs().max()) / scale
    print(f"one step, of the increment's max: rms {rms:.3e}, worst point {worst:.3e}")
    if exact_inc is not None:
        own = want_inc.double() - exact_inc
        own_rms = float(own.square().mean().sqrt()) / scale
        own_worst = float(own.abs().max()) / scale
        kernel = got_inc.double() - exact_inc
        print(f"plain version vs float64 sums: rms {own_rms:.3e}, worst point {own_worst:.3e}; "
              f"kernel: rms {float(kernel.square().mean().sqrt()) / scale:.3e}, worst point "
              f"{float(kernel.abs().max()) / scale:.3e}")
        rms_tol = max(rms_tol, RUN_CONDITIONING * own_rms)
        max_tol = max(max_tol, RUN_CONDITIONING * own_worst)
    assert rms <= rms_tol and worst <= max_tol


def _assert_run_close(got, want, tol, exact=None):
    """``got`` within ``tol`` of max|u| at the worst point, or within
    RUN_CONDITIONING times ``want``'s own distance from ``exact`` (the
    plain version with float64 sums) where that is larger."""
    worst = float((got - want).abs().max() / want.abs().max())
    if exact is not None:
        plain = float((want.double() - exact).abs().max() / exact.abs().max())
        print(f"plain version vs float64 sums, of max|u|: worst point {plain:.3e}")
        tol = max(tol, RUN_CONDITIONING * plain)
    print(f"10 steps, of max|u|: worst point {worst:.3e} (limit {tol:.3e})")
    assert worst <= tol


def _model(name, cons, size, device, nx=96, filters=8, layers=2, seed=0, batch=3,
           kernel_size=5):
    eq = teq.from_name(name, conservative=cons)
    grid = Grid(8 * nx, eq.period).resample(8, conservative=cons)
    model = StencilModel(eq, grid, ModelConfig(num_layers=layers, filters=filters,
                                               stencil_size=size, kernel_size=kernel_size),
                         device=device)
    gen = torch.Generator().manual_seed(seed)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen).to(device)
              for k, v in model.init_params(gen).items()}
    u = eq.initial_conditions(gen, grid, (batch,), device)
    return model, params, u


@pytest.mark.parametrize("name,cons,size", [
    ("burgers", True, 6), ("burgers", False, 5), ("kdv", True, 6),
    ("kdv", False, 7), ("ks", True, 6), ("ks", False, 7), ("burgers", True, 8),
    ("ks", True, 10), ("kdv", True, 10),
])
@pytest.mark.parametrize("batch,nx", [(3, 96), (256, 128), (4096, 128), (10240, 128),
                                      (1001, 32), (5, 1024), (32, 16), (10240, 16),
                                      (32, 32), (10240, 32)])
def test_fused_rhs_matches_plain(cuda, name, cons, size, batch, nx):
    """All six equation forms, and stencils of 5 to 10 taps (8, as the
    Burgers-8x and -64x checkpoints have, lays the coefficients out swizzled
    in shared memory; 10, as KS-32x and KdV-16x have, reaches 5 points), at
    a ragged shape (B=3, nx=96), the main paths' batches at nx=128 (one
    trajectory per block) and B=1001 at nx=32 (four trajectories per block,
    the last block holding one), the zoo's evaluation (B=32) and ensemble
    (B=10240) batches at nx=32 (four rows a block, a halo of 5 for 10 taps)
    and nx=16 (Burgers-64x: a 16-point row in 32 lanes, 8 rows a block, a
    halo of 4 on a 16-point ring), forced for Burgers: float32 on both
    sides, tap sums in another order and with FMAs, then a face
    difference over dx that cancels most of the sum (measured
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
    ("ks", True, 6, 160), ("kdv", False, 7, 1024), ("ks", True, 10, 32),
    ("kdv", True, 10, 32),
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
    empty; nx = 1024 walks eight pairs of tiles; nx = 32 (KS-32x, KdV-16x)
    fills half of its one tile, wraps the halo of 8 around a 32-point ring
    and reaches 5 points with 10 taps."""
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


@pytest.mark.parametrize("name,cons,size,filters,layers,batch,nx", [
    ("ks", True, 6, 32, 3, 530, 128), ("burgers", True, 8, 32, 3, 397, 128),
    ("kdv", False, 7, 32, 3, 265, 128), ("ks", True, 6, 64, 2, 7, 128),
    ("ks", True, 10, 32, 3, 530, 32), ("kdv", True, 10, 32, 3, 530, 32),
    ("kdv", True, 10, 64, 3, 530, 32), ("ks", True, 8, 32, 3, 397, 64),
    ("burgers", True, 8, 32, 3, 1061, 16),
])
def test_learned_rk4_flagship_width_ragged_blocks(cuda, name, cons, size, filters, layers,
                                                  batch, nx):
    """The flagship tower's width (3 layers x 32 filters, nx = 128) at
    batches that are no multiple of the trajectories per block: 530 = 132 x
    4 + 2 (the last block holds 2 of 4), 397 = 132 x 3 + 1 (forced), 265 =
    132 x 2 + 1; and the widest instantiation that shares a block, 64
    filters, one per block.
    Then the zoo's shapes, packed P trajectories a team: KS-32x and KdV-16x
    (nx = 32, 10 taps) at 32 filters and at 64 (the KdV-16x f64 model), 530
    = 132 x 4 + 2 in 133 teams of 4, the last holding 2; KS-16x (nx = 64, 8
    taps), 397 in 199 teams of 2, the last holding 1; Burgers-64x's forced
    16 points, 1061 in 133 teams of 8, the last holding 5. Limits as in
    test_fused_learned_rk4_matches_plain, the run's with RUN_CONDITIONING
    for the unforced cases and for the forced one at nx 16 (its dx eight
    times the flagship's: the kernel read 2.9e-5 of max|u| after 10 steps
    on an H100, bit for bit its unpacked launch, which the plain version's
    own distance from float64 sums bounds as at KdV-16x's nx 32); every
    trajectory is compared, so a team that read or wrote another's rows, or
    another trajectory's, would show."""
    model, params, _ = _model(name, cons, size, cuda, nx=nx, filters=filters, layers=layers)
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
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    assert launch.per_team == {128: 1, 64: 2, 32: 4, 16: 8}[nx]
    assert launch.teams == max(1, min(-(-batch // launch.per_team) // 132, 4))
    assert launch.teams * launch.per_team == 1 or batch % (launch.teams * launch.per_team)
    rough = torch.from_numpy(
        np.random.default_rng(0).standard_normal((batch, nx)).astype(np.float32)).to(cuda)
    smooth = 0.3 * model.equation.initial_conditions(gen, model.grid, (batch,), cuda)
    want_inc = fk.fused_learned_rk4_plain(rough, pack, dt, 1, fp) - rough
    want = fk.fused_learned_rk4_plain(smooth, pack, dt, 10, fp)
    exact = None
    if fp is None or nx < 32:
        fp64 = None if fp is None else fk.ForcingPack(*(leaf.double() for leaf in fp))
        exact = fk.fused_learned_rk4_plain(
            smooth.double(), dataclasses.replace(pack, flat=pack.flat.double()), dt, 10, fp64)
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    torch.cuda.synchronize()
    _assert_step_close(got_inc, want_inc)
    _assert_run_close(got, want, RUN_TOL, exact)


RK4_SCHEMES = [{}, {"accuracy_order": 4}, {"accuracy_order": 6}, {"stencil_size": 8},
               {"stencil_size": 16}, {"stencil_size": 32}]


@pytest.mark.parametrize("scheme", RK4_SCHEMES)
@pytest.mark.parametrize("name,cons", [("ks", True), ("ks", False), ("kdv", True),
                                       ("kdv", False)])
@pytest.mark.parametrize("batch,nx", [(3, 96), (256, 128), (5, 1024), (1037, 128),
                                      (10240, 128), (7, 160), (3, 32), (256, 512),
                                      (1037, 2048)])
def test_fused_rk4_matches_plain(cuda, name, cons, batch, nx, scheme):
    """The fixed-stencil baseline kernel against its plain version: the
    same float32 operations in the same order, each rounded on its own, so
    bit for bit. Every scheme make_fused_rk4 builds: the default (accuracy
    order 2, its taps compiled in; 20 RK4 steps) and accuracy orders 4 and
    6, stencil sizes 8, 16 and 32 (taps at run time, 32 reaching 16 points:
    half the ring at nx = 32; 10 steps at a quarter of
    the classic scheme's stable step: KdV's third derivative on an even
    collocated stencil grows an odd-even mode, past float32 within 20 steps
    at nx = 2048), from the same dx at every nx. Up to 1024 points (768 for
    taps at run time) a warp owns a trajectory, P points a lane on nx / P
    lanes (P = 3, 4, 8, 16, 32 and 1 here; nx = 160 runs 8 points on 20
    lanes); B=1037 runs 7 warps per block, the last block holding one;
    above, the block form (the warps of a block, their edges through shared
    memory, one cluster barrier a stage): nx = 2048 (4 warps of 16 points a
    lane, B=1037), and nx = 1024 with taps at run time (2 warps)."""
    period = teq.from_name(name).period * nx / 128  # the same dx at every nx
    eq = teq.from_name(name, conservative=cons, period=period)
    grid = Grid(nx, period)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (batch,), cuda)
    advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid) / (4 if scheme else 1),
                                10 if scheme else 20, **scheme)
    assert fk.rk4_is_classic(advance.scheme) == (not scheme)
    want = fk.fused_rk4_plain(u, advance.scheme)
    before = fk.fused_rk4.launches
    got = advance(u)
    torch.cuda.synchronize()
    assert fk.fused_rk4.launches == before + 1
    print(f"of max|u|: worst point {float((got - want).abs().max() / want.abs().max()):.3e}; "
          f"{fk.rk4_launch(batch, nx, not scheme, advance.scheme.taps)}")
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_rk4_refuses_on_card(cuda):
    """On the card the wrapper raises rk4_refusal's reason for a grid that is
    no multiple of 32 before any launch (the CPU runs it in the plain
    version); a scheme of accuracy order 4, which the kernel once refused,
    runs and equals its plain version bit for bit."""
    eq = teq.from_name("ks", conservative=True, period=teq.from_name("ks").period * 100 / 128)
    grid = Grid(100, eq.period)
    advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid), 2)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (4,), cuda)
    before = fk.fused_rk4.launches
    with pytest.raises(ValueError, match="nx=100 is not a multiple of 32"):
        advance(u)
    assert fk.fused_rk4.launches == before
    assert advance(u.cpu()).shape == (4, 100)
    grid = Grid(128, teq.from_name("ks").period)
    eq = teq.from_name("ks", conservative=True)
    wide = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid) / 4, 2, accuracy_order=4)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (4,), cuda)
    assert fk.rk4_refusal(wide.scheme, 128) is None
    torch.testing.assert_close(wide(u), fk.fused_rk4_plain(u, wide.scheme), rtol=0, atol=0)
    assert fk.fused_rk4.launches == before + 1


RK4_FORMS = [("ks", True), ("ks", False), ("kdv", True), ("kdv", False)]
# chip_smoke.py phase 8 held these four cases in every form until they moved
# here (each fused_rk4 check runs in one of the two places)
RK4_WIDE_CASES = [(5, 32, {"stencil_size": 80}), (5, 14528, {}), (3, 65536, {}),
                  (3, 16384, {"stencil_size": 48})]


@pytest.mark.parametrize("name,cons,batch,nx,scheme", [
    ("ks", True, 37, 128, {"stencil_size": 40}), ("kdv", False, 37, 128, {"stencil_size": 40}),
    ("kdv", False, 3, 16384, {}),
] + [form + case for form in RK4_FORMS for case in RK4_WIDE_CASES])
def test_fused_rk4_wide_schemes_and_long_grids_match_plain(cuda, name, cons, batch, nx, scheme):
    """fused_rk4 where it once refused: schemes of more than 32 taps an
    order (40, 48 and 80, their coefficients copied into shared memory) in
    the rows form while their rows fit a block (80 taps on 32 points reach
    40, so the halo holds more than one periodic copy), past that (48 taps
    at nx 16384) in the block form, and grids past one block (nx 14528 and
    more: over a cluster of 2 to 16 blocks) in the block form. Bit for bit
    the plain version (20 steps of the classic scheme, 10 of the others at
    a quarter of its stable step); RK4_WIDE_CASES in all four forms."""
    period = teq.from_name(name).period * nx / 128  # the same dx at every nx
    eq = teq.from_name(name, conservative=cons, period=period)
    grid = Grid(nx, period)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (batch,), cuda)
    advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid) / (4 if scheme else 1),
                                10 if scheme else 20, **scheme)
    launch = fk.rk4_launch(batch, nx, fk.rk4_is_classic(advance.scheme), advance.scheme.taps)
    print(launch)
    assert launch.form == ("rows" if scheme and nx < 14528 else "block")
    assert (launch.cluster > 1) == (nx >= 14528)
    assert fk.rk4_wide(advance.scheme.taps) == bool(scheme)
    want = fk.fused_rk4_plain(u, advance.scheme)
    before = fk.fused_rk4.launches
    got = advance(u)
    torch.cuda.synchronize()
    assert fk.fused_rk4.launches == before + 1
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# the block form forced over each cluster size it can take at the long grids
# (the rule picks 8 blocks at nx 16384, 16 at 65,536, 4 at 8192), and over
# one block at the register forms' grids (taps at run time)
RK4_CLUSTER_CASES = ([(16384, {}, c) for c in (4, 8, 16)] + [(8192, {}, c) for c in (2, 8)]
                     + [(65536, {}, 16)]
                     + [(16384, {"stencil_size": 48}, 16), (2048, {}, 2), (2048, {}, 16),
                        (128, {"accuracy_order": 4}, 1), (512, {"stencil_size": 16}, 1),
                        (1024, {"accuracy_order": 4}, 4), (128, {"stencil_size": 40}, 1),
                        (32, {"stencil_size": 48}, 1)])


@pytest.mark.parametrize("nx,scheme,cluster", RK4_CLUSTER_CASES)
@pytest.mark.parametrize("name,cons", [("ks", True), ("kdv", False)])
def test_fused_rk4_block_clusters_match_plain(cuda, name, cons, nx, scheme, cluster):
    """The block form forced over ``cluster`` blocks a trajectory (the
    warps' edges across blocks by distributed shared memory): bit for bit
    the plain version at every cluster size it takes at nx 16384 (4 to 16:
    two blocks would need 32 warps), 8192 (2 and 8) and 65,536 (16), with 48 taps, on
    2048 points over 2 and 16 blocks (16 warps of 8 lanes), over one block
    where the register forms run (taps at run time at nx 128, 512, and nx
    1024 over 4 blocks) and where the rows form runs (40 taps at nx 128, 48
    on 32 points: one warp of 8 lanes). B=1037 at nx <= 2048 (no multiple of any
    block count's warps), B=3 above; 20 steps of the classic scheme, 10 of
    the others at a quarter of its stable step."""
    batch = 1037 if nx <= 2048 else 3
    period = teq.from_name(name).period * nx / 128  # the same dx at every nx
    eq = teq.from_name(name, conservative=cons, period=period)
    grid = Grid(nx, period)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (batch,), cuda)
    advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid) / (4 if scheme else 1),
                                10 if scheme else 20, **scheme)
    launch = fk.rk4_launch(batch, nx, fk.rk4_is_classic(advance.scheme), advance.scheme.taps,
                           cluster)
    print(launch)
    assert launch.form == "block" and launch.cluster == cluster
    want = fk.fused_rk4_plain(u, advance.scheme)
    before = fk.fused_rk4.launches
    got = fk.fused_rk4(u, advance.scheme, cluster=cluster)
    torch.cuda.synchronize()
    assert fk.fused_rk4.launches == before + 1
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_rk4_block_entry_refuses_geometry(cuda, monkeypatch):
    """The C entry refuses a block-form launch it is not built for
    (cudaErrorInvalidValue, no launch): points a lane outside 1, 2, 4, 8,
    16; edges other than the scheme's reach; more than 16 warps a block; a
    cluster of 17; lanes a warp other than the even deal; warps holding
    fewer points than the edges they publish (62 taps on 32 points over 2
    blocks: 16 points a warp against a tail of 31)."""
    runs = []
    for nx, scheme in ((2048, {}), (32, {"stencil_size": 62})):
        eq = teq.from_name("ks", conservative=True, period=teq.from_name("ks").period * nx / 128)
        grid = Grid(nx, eq.period)
        advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid) / 4, 2, **scheme)
        u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (4,), cuda)
        runs.append((advance, u, fk._rk4_block(4, nx, advance.scheme.taps, None)))
    (long, u_long, good), (short, u_short, whole) = runs
    assert whole.form == "block" and whole.cluster == 1 and whole.left == 31
    torch.testing.assert_close(short(u_short), fk.fused_rk4_plain(u_short, short.scheme),
                               rtol=0, atol=0)
    split = whole._replace(cluster=2, lanes=whole.lanes // 2, blocks=8)
    bad = [(long, u_long, good._replace(points=3)),
           (long, u_long, good._replace(left=good.left + 1)),
           (long, u_long, good._replace(warps=32, threads=1024)),
           (long, u_long, good._replace(cluster=17)),
           (long, u_long, good._replace(lanes=good.lanes - 1)),
           (short, u_short, split)]
    with pytest.raises(ValueError, match="does not take nx=32 over a cluster of 2"):
        fk.rk4_launch(4, 32, False, short.scheme.taps, 2)
    before = fk.fused_rk4.launches
    for advance, u, launch in bad:
        monkeypatch.setattr(fk, "rk4_launch", lambda *args, launch=launch: launch)
        with pytest.raises(RuntimeError, match=r"fused_rk4 launch failed: invalid argument"):
            advance(u)
    assert fk.fused_rk4.launches == before


def test_fused_rk4_block_planted_fault_is_caught(cuda):
    """The block form's checks have power: the kernels built with
    -DPDE_FAULT_RK4_SKIP_EDGES (the third stage of every step skips
    publishing its edges, so it reads the first stage's) give another
    result than the same launch built without it, 20 steps from a smooth
    state (the stale edges move it by 5.8e-6 of max|u| at nx 2048 on an
    H100; the checks hold the form bit for bit, so any difference fails
    them): the compiled taps at nx 2048 (one block) and 16384 (a cluster of
    8), the run-time taps at 2048 and 16384 with 48 taps. The launches
    without the fault equal the plain version bit for bit (the tests
    above)."""
    from pde_superresolution_torch.ops import _build

    cases, clean = ((2048, {}), (16384, {}), (2048, {"accuracy_order": 4}),
                    (16384, {"stencil_size": 48})), []
    for nx, scheme in cases:
        period = teq.from_name("ks").period * nx / 128
        eq = teq.from_name("ks", conservative=True, period=period)
        grid = Grid(nx, period)
        u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (6,), cuda)
        advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid) / (4 if scheme else 1),
                                    20, **scheme)
        assert fk.rk4_launch(6, nx, not scheme, advance.scheme.taps).form == "block"
        clean.append((advance, u, advance(u)))
    flags = list(_build.NVCC_FLAGS)
    _build.NVCC_FLAGS.append("-DPDE_FAULT_RK4_SKIP_EDGES")
    _build.build.cache_clear()
    _build.load_library.cache_clear()
    try:
        for (nx, scheme), (advance, u, want) in zip(cases, clean):
            faulty = advance(u)
            torch.cuda.synchronize()
            diff = float((faulty - want).abs().nan_to_num(nan=float("inf")).max())
            print(f"nx {nx} {scheme or 'classic'}: the planted fault's max abs diff {diff:.3e}")
            assert diff > 0 and not torch.equal(faulty, want)
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build.build.cache_clear()
        _build.load_library.cache_clear()


@pytest.mark.parametrize("name,cons", RK4_FORMS)
@pytest.mark.parametrize("nx", [32, 512, 2048])
def test_fused_rk4_widest_register_scheme_matches_plain_and_integrate(cuda, name, cons, nx):
    """The widest scheme the register forms take (stencil size 32: 32 taps
    an order reaching 16 points; half the ring at nx = 32, run-time taps in
    registers at 512, the block form's periodic copies at 2048) at B=1037
    (no multiple of the warps a block), 10 steps at a quarter of the classic
    scheme's stable step from the same dx at every nx: bit for bit the plain
    version, and, where PolynomialDifferentiator builds the same scheme (a
    conservative form; it makes a direct form's collocated stencil odd),
    within 1e-5 of max|u| of ``integrate`` over its rhs_fn (chip_smoke.py
    phase 8 held this until it moved here)."""
    from pde_superresolution_torch import integrate

    scheme = {"stencil_size": 32}
    period = teq.from_name(name).period * nx / 128  # the same dx at every nx
    eq = teq.from_name(name, conservative=cons, period=period)
    grid = Grid(nx, period)
    u = 0.3 * eq.initial_conditions(torch.Generator().manual_seed(2), grid, (1037,), cuda)
    advance = fk.make_fused_rk4(eq, grid, eq.stable_time_step(grid) / 4, 10, **scheme)
    want = fk.fused_rk4_plain(u, advance.scheme)
    before = fk.fused_rk4.launches
    got = advance(u)
    torch.cuda.synchronize()
    assert fk.fused_rk4.launches == before + 1
    print(fk.rk4_launch(1037, nx, False, advance.scheme.taps))
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if cons:
        differentiator = integrate.PolynomialDifferentiator(eq, grid, device=cuda, **scheme)
        _, ref = integrate.integrate(differentiator.rhs_fn(), u, advance.scheme.dt, 10, 10)
        err = float((got - ref[-1]).abs().max() / ref[-1].abs().max())
        print(f"against integrate, of max|u|: {err:.3e}")
        assert err <= 1e-5


@pytest.mark.parametrize("name,cons,size,nx,filters", [
    ("ks", True, 6, 128, 128), ("kdv", False, 7, 64, 128), ("ks", True, 10, 32, 128),
    ("ks", False, 7, 256, 72), ("kdv", True, 6, 160, 128), ("burgers", True, 8, 128, 128),
    ("burgers", False, 5, 256, 96),
])
def test_learned_rk4_128_filters_matches_plain(cuda, name, cons, size, nx, filters):
    """Towers of 65 to 128 filters (padded to 128): a block holds one
    trajectory, run by two warp groups, each layer's weights reaching it a
    conv tap's slice at a time through the ring (clusters of two blocks
    sharing each slice's copy; the last block of B=397 runs empty). One
    step's increment from N(0,1) within WIDE_STEP_RMS_TOL and
    WIDE_STEP_MAX_TOL; 10 steps from a smooth state as in
    test_fused_learned_rk4_matches_plain (RUN_TOL, with RUN_CONDITIONING
    against float64 sums where unforced), 3 layers,
    batches that are no multiple of anything (530, 397). Burgers runs
    forced from t0 = 3.7; nx = 160 and 256 walk three and four single
    tiles."""
    batch = 397 if name == "burgers" else 530
    model, params, _ = _model(name, cons, size, cuda, nx=nx, filters=filters, layers=3)
    gen = torch.Generator().manual_seed(3)
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    pack = fk.pack_learned_rk4(params, model.equation, model.grid,
                               model.config.kernel_size, model.constraint_layers,
                               model.taps)
    assert pack.padded_channels == 128
    fp, terms = None, 0
    if model.equation.forced:
        forcing = model.equation.sample_forcing(gen, (batch,), cuda)
        fp = fk.pack_forcing(forcing, 3.7, model.equation, model.grid, dt, batch)
        terms = fp.amplitude.shape[-1]
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    assert (launch.teams, launch.groups, launch.multicast) == (1, 2, 2) and launch.slots >= 1
    assert launch.blocks == batch + batch % 2 and not launch.split
    rough = torch.from_numpy(
        np.random.default_rng(0).standard_normal((batch, nx)).astype(np.float32)).to(cuda)
    smooth = 0.3 * model.equation.initial_conditions(gen, model.grid, (batch,), cuda)
    want_inc = fk.fused_learned_rk4_plain(rough, pack, dt, 1, fp) - rough
    want = fk.fused_learned_rk4_plain(smooth, pack, dt, 10, fp)
    exact = None
    if fp is None:
        exact = fk.fused_learned_rk4_plain(
            smooth.double(), dataclasses.replace(pack, flat=pack.flat.double()), dt, 10)
    before = fk.fused_learned_rk4.launches
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    torch.cuda.synchronize()
    assert fk.fused_learned_rk4.launches == before + 2
    _assert_step_close(got_inc, want_inc, WIDE_STEP_RMS_TOL, WIDE_STEP_MAX_TOL)
    _assert_run_close(got, want, RUN_TOL, exact)


# test_learned_rk4_128_filters_matches_plain's shapes
WIDE_SHAPES = [
    ("ks", True, 6, 128, 128), ("kdv", False, 7, 64, 128), ("ks", True, 10, 32, 128),
    ("ks", False, 7, 256, 72), ("kdv", True, 6, 160, 128), ("burgers", True, 8, 128, 128),
    ("burgers", False, 5, 256, 96),
]


def _ring_against_split(cuda, name, cons, size, nx, filters, batch, **rule):
    """The ring's launch (with the rule's constants ``rule`` set, e.g.
    RING_SLOTS and WIDE_CLUSTER) against the split form's launch of one
    block and one warp group on the same inputs (another kernel: its own
    ring beside the segment, one group walking every tile, the same products
    in the same order), one step from N(0,1) and 10 steps from a smooth
    state: bit for bit."""
    pack, dt, fp, rough, smooth = _split_inputs(name, cons, size, filters, nx, batch, cuda)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    saved = {key: getattr(fk, key) for key in rule}
    try:
        for key, value in rule.items():
            setattr(fk, key, value)
        launch = fk.learned_rk4_launch(pack, nx, terms, batch)
        assert not launch.split and launch.slots >= 1 and launch.groups == 2
        before = fk.fused_learned_rk4.launches
        for u, steps in ((rough, 1), (smooth, 10)):
            got = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp)
            single = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp, cluster=1, groups=1)
            torch.cuda.synchronize()
            print(f"{launch}: {steps} steps, max abs diff to the split form's one block "
                  f"{float((got - single).abs().nan_to_num(nan=float('inf')).max()):.3e}")
            torch.testing.assert_close(got, single, rtol=0, atol=0, equal_nan=True)
        assert fk.fused_learned_rk4.launches == before + 4
    finally:
        for key, value in saved.items():
            setattr(fk, key, value)
    return launch


# every shape at B 3, 397 and 530; B=10239 at the KS-8x and Burgers-8x shapes
RING_CASES = [shape + (batch,) for shape in WIDE_SHAPES for batch in (3, 397, 530)] + [
    shape + (10239,) for shape in WIDE_SHAPES if shape[3] == 128 and shape[0] != "kdv"]


@pytest.mark.parametrize("name,cons,size,nx,filters,batch", RING_CASES)
def test_learned_rk4_ring_bit_for_bit(cuda, name, cons, size, nx, filters, batch):
    """The whole form at 65-128 filters (the ring: two warp groups on a
    trajectory, each conv tap's slice copied once for a cluster of two
    blocks into a ring of slots) gives the split form's one-block,
    one-group result bit for bit, forced (Burgers) and not, nx 32 to 256
    (one to four tiles, so a group without a pass), odd batches (3, 397,
    10239: the last cluster's second block holds no trajectory)."""
    _ring_against_split(cuda, name, cons, size, nx, filters, batch)


# (name, cons, size, nx, slots): every ring size up to the most that fits
# beside the trajectory (4 at KS nx 128, 2 at forced Burgers nx 160, 5 at
# KS nx 32)
RING_SIZES = [("ks", True, 6, 128, slots) for slots in (1, 2, 3, 4)] + [
    ("burgers", True, 8, 160, slots) for slots in (1, 2)] + [("ks", True, 6, 32, 5)]


@pytest.mark.parametrize("share", [1, 2, 4, 8])
@pytest.mark.parametrize("name,cons,size,nx,slots", RING_SIZES)
def test_learned_rk4_ring_slots_and_clusters_bit_for_bit(cuda, name, cons, size, nx, slots,
                                                         share):
    """Every ring size the kernel takes beside the trajectory, and clusters
    of 1 to 8 blocks sharing each copy, give the same bits as the split
    form's one block (B=37: the last cluster ragged but at one and
    37 = 4 x 9 + 1 = 8 x 4 + 5)."""
    batch = 37
    launch = _ring_against_split(cuda, name, cons, size, nx, 128, batch, RING_SLOTS=slots,
                                 WIDE_CLUSTER=share)
    assert (launch.slots, launch.multicast) == (slots, share)
    assert launch.blocks == -(-batch // share) * share


def test_learned_rk4_ring_planted_fault_is_caught(cuda):
    """The checks above have power: the kernels built with
    -DPDE_FAULT_RING_WRONG_SLOT (every slice lands in the slot after its
    own, its barrier the right one) give another result than the same
    launch built without it: the whole form's ring at the KS-8x and
    Burgers-8x shapes (nx 128, 4 and 3 slots) and the split form's at 32
    filters on nx 2048 over 3 blocks (4 slots), one step from N(0,1) by
    more than 1e-3 of max|u|, 10 steps from a smooth state not bit for bit
    (the seeded towers move a 0.3-scaled state little: 2.3e-4 there). The
    launches without the fault give the weights whole or the split form's
    one block and one group their bits (the tests above)."""
    from pde_superresolution_torch.ops import _build

    batch, clean = 6, {}
    # (name, size, filters, nx, the ring's launch)
    cases = (("ks", 6, 128, 128, {}), ("burgers", 8, 128, 128, {}),
             ("burgers", 8, 32, 2048, {"cluster": 3}))
    for name, size, filters, nx, ring in cases:
        pack, dt, fp, rough, smooth = _split_inputs(name, True, size, filters, nx, batch, cuda)
        terms = 0 if fp is None else fp.amplitude.shape[-1]
        assert fk.learned_rk4_launch(pack, nx, terms, batch, **ring).slots >= 2
        clean[name, filters] = (pack, dt, fp, [
            (u, steps, fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp, **ring))
            for u, steps in ((rough, 1), (smooth, 10))])
    flags = list(_build.NVCC_FLAGS)
    _build.NVCC_FLAGS.append("-DPDE_FAULT_RING_WRONG_SLOT")
    _build.build.cache_clear()
    _build.load_library.cache_clear()
    try:
        for name, size, filters, nx, ring in cases:
            pack, dt, fp, runs = clean[name, filters]
            for u, steps, want in runs:
                faulty = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp, **ring)
                torch.cuda.synchronize()
                # a stale slice's rows may blow up: a NaN counts as a difference
                diff = float((faulty - want).abs().nan_to_num(nan=float("inf")).max())
                print(f"{name} {filters} filters nx {nx}, {steps} steps: the planted fault's "
                      f"max abs diff {diff:.3e}")
                assert not torch.equal(faulty, want)
                assert steps > 1 or diff > 1e-3 * float(want.abs().max())
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build.build.cache_clear()
        _build.load_library.cache_clear()


def _split_inputs(name, cons, size, filters, nx, batch, cuda, layers=3, kernel_size=5):
    """A seeded model's pack and step, a standard-normal and a smooth state
    of ``batch`` trajectories, and for Burgers a ForcingPack from t0 = 3.7."""
    model, params, _ = _model(name, cons, size, cuda, nx=nx, filters=filters, layers=layers,
                              kernel_size=kernel_size)
    gen = torch.Generator().manual_seed(3)
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    pack = fk.pack_learned_rk4(params, model.equation, model.grid,
                               model.config.kernel_size, model.constraint_layers,
                               model.taps)
    fp = None
    if model.equation.forced:
        forcing = model.equation.sample_forcing(gen, (batch,), cuda)
        fp = fk.pack_forcing(forcing, 3.7, model.equation, model.grid, dt, batch)
    rough = torch.from_numpy(
        np.random.default_rng(0).standard_normal((batch, nx)).astype(np.float32)).to(cuda)
    smooth = 0.3 * model.equation.initial_conditions(gen, model.grid, (batch,), cuda)
    return pack, dt, fp, rough, smooth


def _assert_split_close_to_plain(pack, dt, fp, rough, smooth, got_inc, got, wide=False,
                                 conditioned=False):
    """One step's increment and 10 steps against the plain version, with the
    limits of the whole-trajectory forms at the same width (``wide``: the
    128-filter form's). ``conditioned``: also no more than RUN_CONDITIONING
    times the plain version's own distance from float64 sums (unforced)."""
    want_inc = fk.fused_learned_rk4_plain(rough, pack, dt, 1, fp) - rough
    want = fk.fused_learned_rk4_plain(smooth, pack, dt, 10, fp)
    exact = exact_inc = None
    if fp is None:
        pack64 = dataclasses.replace(pack, flat=pack.flat.double())
        exact = fk.fused_learned_rk4_plain(smooth.double(), pack64, dt, 10)
        if conditioned:
            exact_inc = (fk.fused_learned_rk4_plain(rough.double(), pack64, dt, 1)
                         - rough.double())
    limits = (WIDE_STEP_RMS_TOL, WIDE_STEP_MAX_TOL) if wide else (STEP_RMS_TOL, STEP_MAX_TOL)
    _assert_step_close(got_inc, want_inc, *limits, exact_inc=exact_inc)
    _assert_run_close(got, want, RUN_TOL, exact)


@pytest.mark.parametrize("name,cons,size,filters,nx,cluster", [
    ("ks", True, 6, 32, 256, 2), ("kdv", False, 7, 32, 200, 3),
    ("burgers", True, 8, 32, 256, 3), ("ks", False, 7, 64, 256, 4),
    ("burgers", False, 5, 64, 256, 2), ("ks", True, 6, 128, 192, 3),
    ("burgers", True, 6, 128, 128, 2), ("ks", True, 6, 32, 128, 1),
    ("kdv", True, 6, 32, 1024, 16),
])
def test_learned_rk4_split_matches_one_block(cuda, name, cons, size, filters, nx, cluster):
    """The split form (a trajectory over a cluster of ``cluster`` blocks,
    halos by distributed shared memory), forced on at a shape one block
    holds, against the one-block form on the same inputs: every row sums
    the same products in the same wgmma order, so bit for bit, one step from
    N(0,1) and 10 steps from a smooth state. This is what catches a wrong
    halo exchange. 32, 64 and 128 filters, forced (Burgers, 20 terms) and
    not; ragged segments (nx 200 over 3 blocks: 67, 67, 66; nx 256 over 3:
    86, 86, 84); a cluster of one (every halo from itself) and of 16 (above
    the portable 8). Both against the plain version at the whole forms'
    limits."""
    batch = 37
    pack, dt, fp, rough, smooth = _split_inputs(name, cons, size, filters, nx, batch, cuda)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    one = fk.learned_rk4_launch(pack, nx, terms, batch)
    split = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster)
    assert not one.split and split.split and split.cluster == cluster
    print(f"one block: {one}; split: {split}")
    before = fk.fused_learned_rk4.launches
    whole_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    whole = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp, cluster=cluster) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp, cluster=cluster)
    torch.cuda.synchronize()
    assert fk.fused_learned_rk4.launches == before + 4
    torch.testing.assert_close(got_inc, whole_inc, rtol=0, atol=0)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    _assert_split_close_to_plain(pack, dt, fp, rough, smooth, got_inc, got,
                                 wide=filters > 64)


# test_learned_rk4_split_matches_one_block's shapes, and a streamed one at
# 32 filters (Burgers-8x's shapes at nx 2048 over 3 blocks: the segment does
# not fit beside the whole weights), with every warp-group count the split
# form takes at that width (at 128 filters the weights always stream)
SPLIT_SHAPES = [
    ("ks", True, 6, 32, 256, 2), ("kdv", False, 7, 32, 200, 3),
    ("burgers", True, 8, 32, 256, 3), ("ks", False, 7, 64, 256, 4),
    ("burgers", False, 5, 64, 256, 2), ("ks", True, 6, 128, 192, 3),
    ("burgers", True, 6, 128, 128, 2), ("ks", True, 6, 32, 128, 1),
    ("kdv", True, 6, 32, 1024, 16), ("burgers", True, 8, 32, 2048, 3),
]
SPLIT_GROUP_CASES = [shape + (groups,) for shape in SPLIT_SHAPES for groups in fk.GROUP_COUNTS
                     if groups <= (fk.MAX_GROUPS_WIDE if shape[3] >= fk.WIDE_CHANNELS
                                   else fk.MAX_GROUPS) and (shape[4] < 2048 or groups <= 2)]


@pytest.mark.parametrize("name,cons,size,filters,nx,cluster,groups", SPLIT_GROUP_CASES)
def test_learned_rk4_split_groups_bit_for_bit(cuda, name, cons, size, filters, nx, cluster,
                                              groups):
    """The split form with ``groups`` warp groups a block on one segment,
    forced over ``cluster`` blocks (the weights whole or streamed, as the
    rule ranks them), against the same cluster with one group and against
    the one-block form (where one block holds the trajectory; at nx 2048
    the launch the rule takes, the weights whole, against forced segments
    that stream them), bit for bit, one step from N(0,1) and
    10 steps from a smooth state: the groups take the segment's tile passes
    in turn and every row runs the same products in the same order. Forced
    (Burgers) and not, 32 to 128 filters, ragged segments, a cluster of one
    and of 16, groups with no pass (16 blocks of 64 points have one pass)."""
    batch = 11
    pack, dt, fp, rough, smooth = _split_inputs(name, cons, size, filters, nx, batch, cuda)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    launch = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster, groups=groups)
    one = fk.learned_rk4_launch(pack, nx, terms, batch)
    print(f"{launch}; against {one}")
    assert launch.split and (launch.cluster, launch.groups) == (cluster, groups)
    assert launch.threads == 128 * groups + (32 if launch.stream and groups < 4 else 0)
    before = fk.fused_learned_rk4.launches
    for u, steps in ((rough, 1), (smooth, 10)):
        got = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp, cluster=cluster, groups=groups)
        single = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp, cluster=cluster, groups=1)
        whole = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp)
        torch.cuda.synchronize()
        print(f"{steps} steps: max abs diff to one group {float((got - single).abs().max()):.3e}"
              f", to {'one block' if not one.split else 'the chosen launch'} "
              f"{float((got - whole).abs().max()):.3e}")
        torch.testing.assert_close(got, single, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(got, whole, rtol=0, atol=0, equal_nan=True)
    assert fk.fused_learned_rk4.launches == before + 6


def test_learned_rk4_split_groups_planted_fault_is_caught(cuda):
    """The check above has power: the kernels built with
    -DPDE_FAULT_SKIP_LAST_PASS (a split block's last warp group skips its
    last pass of tiles, and still meets its barriers) give another result
    with 2 warp groups than with one at KS-8x-like shapes (nx 1024 over 2
    blocks: group 1 owns tile pairs 1 and 3 of each segment; one block also
    holds it) and with the weights streamed (128 filters, nx 512 over 2
    blocks: group 1 owns tiles 1 and 3), while one group, which the fault
    leaves alone, still equals the one-block form where one block holds the
    trajectory."""
    from pde_superresolution_torch.ops import _build

    flags = list(_build.NVCC_FLAGS)
    _build.NVCC_FLAGS.append("-DPDE_FAULT_SKIP_LAST_PASS")
    _build.build.cache_clear()
    _build.load_library.cache_clear()
    try:
        for filters, nx in ((32, 1024), (128, 512)):
            batch = 5
            pack, dt, _, rough, smooth = _split_inputs("ks", True, 6, filters, nx, batch, cuda)
            for u, steps in ((rough, 1), (smooth, 10)):
                faulty = fk.fused_learned_rk4(u, pack, dt, steps, cluster=2, groups=2)
                single = fk.fused_learned_rk4(u, pack, dt, steps, cluster=2, groups=1)
                torch.cuda.synchronize()
                # the rows the fault leaves stale may blow up: a NaN counts as a difference
                diff = float((faulty - single).abs().nan_to_num(nan=float("inf")).max())
                print(f"{filters} filters nx {nx}, {steps} steps: the planted fault's max abs "
                      f"diff {diff:.3e}")
                assert not torch.equal(faulty, single) and diff > 1e-3 * float(single.abs().max())
                if fk.learned_rk4_launch(pack, nx, 0, batch).split:
                    continue  # one block does not hold it
                whole = fk.fused_learned_rk4(u, pack, dt, steps)
                torch.testing.assert_close(single, whole, rtol=0, atol=0)
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build.build.cache_clear()
        _build.load_library.cache_clear()


@pytest.mark.parametrize("filters,groups", [(32, 0), (32, 3), (32, 5), (128, 3), (128, 4)])
def test_learned_rk4_entry_refuses_groups_out_of_range(cuda, monkeypatch, filters, groups):
    """The C entry checks the split form's warp groups itself: a launch
    handed 0, 3 (no kernel has 3) or 5 groups (3 or 4 at 128 filters, whose
    kernels are bounded to 256 threads) past the wrapper's own checks is
    refused with
    cudaErrorInvalidValue before anything runs."""
    batch, nx = 3, 256
    pack, dt, fp, rough, _ = _split_inputs("ks", True, 6, filters, nx, batch, cuda)
    good = fk.learned_rk4_launch(pack, nx, 0, batch, cluster=2, groups=1)
    bad = good._replace(groups=groups, threads=128 * groups,
                        shared_bytes=good.shared_bytes + max(0, groups - 1) * fk._group_bytes(pack))
    monkeypatch.setattr(fk, "learned_rk4_launch", lambda *a, **k: bad)
    before = fk.fused_learned_rk4.launches
    with pytest.raises(RuntimeError, match=r"fused_learned_rk4 launch failed: invalid argument"):
        fk.fused_learned_rk4(rough, pack, dt, 1, cluster=2)
    assert fk.fused_learned_rk4.launches == before


@pytest.mark.parametrize("per_team,nx,split", [(3, 32, False), (8, 32, False),
                                               (16, 16, False), (2, 32, True)])
def test_learned_rk4_entry_refuses_per_team_out_of_range(cuda, monkeypatch, per_team, nx,
                                                         split):
    """The C entry checks the trajectories a team itself: a launch handed 3
    (no kernel has 3), 8 at nx 32 (256 rows, past a team's two tiles), 16,
    or 2 in the split form, past the wrapper's own checks, is refused with
    cudaErrorInvalidValue before anything runs."""
    batch = 1061
    model, params, _ = _model("ks", True, 6, cuda, nx=nx, filters=32)
    pack = fk.pack_learned_rk4(params, model.equation, model.grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)
    dt = model.equation.stable_time_step(model.grid, u_scale=3.0)
    rough = torch.zeros(batch, nx, device=cuda)
    good = fk.learned_rk4_launch(pack, nx, 0, batch, cluster=1 if split else None)
    bad = good._replace(per_team=per_team)
    monkeypatch.setattr(fk, "learned_rk4_launch", lambda *a, **k: bad)
    before = fk.fused_learned_rk4.launches
    with pytest.raises(RuntimeError, match=r"fused_learned_rk4 launch failed: invalid argument"):
        fk.fused_learned_rk4(rough, pack, dt, 1)
    assert fk.fused_learned_rk4.launches == before


# The zoo's short-grid models (nx < 128: the launch packs 2, 4 or 8
# trajectories a team from a batch of 132 teams or more)
PACKED_ZOO = ["ckpt_ks16", "ckpt_ks32", "ks32_select_seed0", "ckpt_kdv8", "ckpt_kdv16",
              "ckpt_kdv16_f64", "kdv16_select_seed7", "ckpt_burgers64"]


@pytest.mark.parametrize("batch", [256, 4097, 10239, 10240])
@pytest.mark.parametrize("checkpoint", PACKED_ZOO)
def test_learned_rk4_packed_bit_for_bit_at_zoo_shapes(cuda, checkpoint, batch):
    """Packing P trajectories a team changes which rows a warp holds, not
    what a row computes: each row runs P = 1's products and sums in the same
    order. So at each zoo model's own grid, with its trained weights (and
    its members' forcing, for Burgers), the packed launch (the launch's own
    P, and the most its grid takes, forced at B=256, whose launch keeps P =
    1) gives the unpacked one's bits (per_team=1): one step from N(0,1) and
    20 steps from a smooth state at the KdV protocols' ic_scale of 0.5,
    ragged last teams (4097, 10239) and blocks included. A member that blows
    up gives NaN in each (KdV-16x and Burgers-64x lose a few at full scale);
    at least 99% stay finite, so the bits compared are numbers."""
    model, params, _ = convert.load_asset(checkpoint, device=cuda)
    eq, grid = model.equation, model.grid
    pack = fk.pack_learned_rk4(params, eq, grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)
    dt = model.stable_time_step(u_scale=3.0)
    gen = torch.Generator().manual_seed(4)
    fp, terms = None, 0
    if eq.forced:
        fp = fk.pack_forcing(eq.sample_forcing(gen, (batch,), cuda), 3.7, eq, grid, dt, batch)
        terms = fp.amplitude.shape[-1]
    rough = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (batch, grid.size)).astype(np.float32)).to(cuda)
    smooth = 0.5 * eq.initial_conditions(gen, grid, (batch,), cuda)
    most = fk.most_per_team(pack, grid.size)
    launch = fk.learned_rk4_launch(pack, grid.size, terms, batch)
    assert most > 1 and launch.per_team == (1 if batch == 256 else most)
    runs = {}
    for per_team in (1, None, most):
        runs[per_team] = [fk.fused_learned_rk4(v, pack, dt, steps, forcing=fp, per_team=per_team)
                          for v, steps in ((rough, 1), (smooth, 20))]
    torch.cuda.synchronize()
    print(f"{checkpoint} B={batch}: {launch}")
    for per_team in (None, most):
        for got, want in zip(runs[per_team], runs[1]):
            assert torch.equal(got.nan_to_num(nan=7.0), want.nan_to_num(nan=7.0))
    finite = int(torch.isfinite(runs[1][1]).all(-1).sum())
    print(f"{finite} of {batch} members finite after 20 steps")
    assert finite >= 0.99 * batch


@pytest.mark.parametrize("name,cons,size,filters,nx,cluster,groups,stream", [
    ("ks", True, 6, 32, 2048, 2, 4, False), ("burgers", True, 8, 32, 1280, 5, 2, False),
    ("burgers", True, 8, 32, 2048, 8, 2, False), ("ks", True, 6, 64, 1024, 2, 4, True),
    ("burgers", True, 8, 64, 1280, 3, 4, True), ("ks", True, 6, 128, 1024, 4, 2, True),
    ("burgers", True, 6, 128, 1000, 4, 2, True),
])
def test_learned_rk4_long_grids_match_plain(cuda, name, cons, size, filters, nx, cluster,
                                            groups, stream):
    """Grids one block cannot hold take the split form at the (blocks, warp
    groups, weights whole or streamed) the split form's rule ranks first
    (fk._split_rank): the KS-8x tower at nx 2048 (2 blocks of 4 groups), the
    Burgers-8x shapes at nx 1280 (run_ensemble --domain_factor 10: 5 blocks
    of 256 points, 2 groups) and 2048 (8 of 256), 64 filters at nx 1024 and
    1280 (the weights streamed beside segments that 4 groups share: more
    busy warps than any cluster beside the whole weights), 128 filters at nx
    1024 and 1000 (segments of 250). Against the plain version at the whole
    forms' limits."""
    batch = 19
    pack, dt, fp, rough, smooth = _split_inputs(name, cons, size, filters, nx, batch, cuda)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    print(launch)
    assert launch.split and (launch.cluster, launch.groups, launch.stream) == (cluster, groups,
                                                                                stream)
    assert fk.learned_rk4_refusal(pack, nx, terms) is None
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    torch.cuda.synchronize()
    _assert_split_close_to_plain(pack, dt, fp, rough, smooth, got_inc, got,
                                 wide=filters > 64)


@pytest.mark.parametrize("checkpoint,factor,cluster,stream,other", [
    ("ckpt_kdv16_f64", 32, 2, True, 3), ("ckpt_burgers8", 16, 8, False, 3),
])
def test_learned_rk4_long_grids_trained_match_plain(cuda, checkpoint, factor, cluster, stream,
                                                    other):
    """Trained towers where one block cannot hold the trajectory, built as
    run_ensemble --domain_factor builds them: KdV-16x f64 (64 filters,
    stencil 10) at nx 1024, two blocks of 512 points of 4 warp groups with
    the weights streamed, and Burgers-8x at nx 2048, 8 blocks of 256 points
    beside the whole weights. A seeded 64-filter KdV
    tower of stencil 10 is no model of the equation: at nx 1024 it blows up
    within 10 steps from a smooth state, in the plain version and in
    float64 sums as in the kernel. ``other`` blocks (a segment beside the
    whole weights where the launch streams them, and the other way round)
    give the same result bit for bit. Against the plain version at the whole forms' limits, or
    RUN_CONDITIONING times the plain version's own distance from float64
    sums where that is larger (KdV's third derivative amplifies single bf16
    flips)."""
    from pde_superresolution_torch.scripts import run_ensemble

    batch = 19
    ens = run_ensemble.setup(run_ensemble.build_parser().parse_args(
        ["--checkpoint_dir", checkpoint, "--num_trajectories", str(batch),
         "--domain_factor", str(factor), "--device", str(cuda)]))
    model, nx = ens.model, ens.model.grid.size
    dt = model.stable_time_step(u_scale=3.0)
    pack = fk.pack_learned_rk4(ens.params, model.equation, model.grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)
    gen = torch.Generator().manual_seed(3)
    fp = None
    if model.equation.forced:
        fp = fk.pack_forcing(ens.forcing, 3.7, model.equation, model.grid, dt, batch)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    print(launch)
    assert launch.split and (launch.cluster, launch.stream) == (cluster, stream)
    assert fk.learned_rk4_launch(pack, nx, terms, batch, cluster=other).stream != stream
    rough = torch.from_numpy(
        np.random.default_rng(0).standard_normal((batch, nx)).astype(np.float32)).to(cuda)
    smooth = 0.3 * model.equation.initial_conditions(gen, model.grid, (batch,), cuda)
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    other_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp, cluster=other) - rough
    other_run = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp, cluster=other)
    torch.cuda.synchronize()
    torch.testing.assert_close(other_inc, got_inc, rtol=0, atol=0)
    torch.testing.assert_close(other_run, got, rtol=0, atol=0)
    _assert_split_close_to_plain(pack, dt, fp, rough, smooth, got_inc, got, conditioned=True)


@pytest.mark.parametrize("name,cons,size,kernel_size,layers,nx,cluster", [
    ("ks", True, 6, 19, 3, 128, 2), ("ks", True, 6, 21, 3, 256, 3),
    ("ks", True, 18, 5, 3, 128, 2), ("burgers", True, 20, 5, 3, 128, 2),
    ("ks", True, 6, 5, 17, 128, 2), ("ks", True, 6, 5, 17, 1024, 2),
    ("ks", True, 6, 35, 3, 32, None),
])
def test_learned_rk4_reach_and_depth_match_plain(cuda, name, cons, size, kernel_size, layers,
                                                 nx, cluster):
    """Reaches above 8 points and towers deeper than 16 layers: conv kernels
    of 19 and 21 (reach 9 and 10; layer 0 runs two depth steps of 16),
    stencils of 18 and 20 taps (reach 9 and 10; Burgers forced), and 17
    layers x 32 filters, whose 164 KB of weights stay whole beside the
    trajectories at nx 128 and beside segments of 342 points over three
    blocks at nx 1024 (streamed a tap at a time over the two blocks
    forced). A conv kernel of 35 on 32
    points is wider than the grid's single periodic copy takes, so the
    cluster form runs it, its halo wrapping modulo nx. The whole form against the
    split form bit for bit (``cluster`` forced), and both against the plain
    version at the 128-filter form's limits where a layer sums over 500
    products (kernel 19 and 21) or the roundings of 17 layers compound, or
    at RUN_CONDITIONING times the plain version's own distance from float64
    sums where that is larger: the 18-tap stencil's projection and the
    deep tower amplify single bf16 flips (on an H100 the seeded models read
    1.4e-4 of the increment in root mean square on one step from N(0,1))."""
    batch = 23
    pack, dt, fp, rough, smooth = _split_inputs(name, cons, size, 32, nx, batch, cuda,
                                                layers=layers, kernel_size=kernel_size)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    assert fk.learned_rk4_reach(pack) >= (9 if layers == 3 else 2)
    assert fk.learned_rk4_refusal(pack, nx, terms) is None
    print(fk.learned_rk4_launch(pack, nx, terms, batch))
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp)
    if cluster is not None:
        split_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp, cluster=cluster) - rough
        split = fk.fused_learned_rk4(smooth, pack, dt, 10, forcing=fp, cluster=cluster)
        torch.cuda.synchronize()
        torch.testing.assert_close(split_inc, got_inc, rtol=0, atol=0)
        torch.testing.assert_close(split, got, rtol=0, atol=0)
    torch.cuda.synchronize()
    _assert_split_close_to_plain(pack, dt, fp, rough, smooth, got_inc, got,
                                 wide=layers > 3 or kernel_size > 5, conditioned=True)


# Towers of 129 to 2384 filters (the chunked form) sum K x C bf16 products a
# layer, up to 11,920 at 2384 filters against the 128-filter form's 640, so
# more of the next layer's bf16 inputs round the other way between the
# tensor cores' order of summation and the plain version's float32 matmul.
# Seeded towers this wide are no models: their increments from N(0,1) reach
# 1e20 and past float32 within a step. So these tests widen the trained
# checkpoints (convert.widen_params, the new weights N(0, (0.02
# sqrt(128 / filters))^2), as chip_smoke.py's phases 11 and 19 do); on an
# H100 one step from N(0,1) then read 4.0e-6 to 2.7e-5 of the increment's
# maximum in root mean square, the plain version 2.2e-6 to 1.4e-5 from
# float64 sums. Held to the 128-filter form's limits, or RUN_CONDITIONING
# times the plain version's own distance from float64 sums of the same
# bf16 values (forced too) where that is larger.
def _widened_inputs(checkpoint, filters, factor, batch, cuda, tmp_path):
    """A trained checkpoint widened to ``filters`` on a grid ``factor``
    times its own (run_ensemble --domain_factor): its pack and step, a
    standard-normal and a smooth state (the seeded members, scaled by 0.3)
    of ``batch`` trajectories, and for Burgers a ForcingPack from t0 = 3.7
    of the members' forcing."""
    import json

    from pde_superresolution_torch.scripts import run_ensemble

    _, trained, config = convert.load_asset(checkpoint, device=cuda)
    stem = tmp_path / f"{checkpoint}_{filters}"
    stem.with_suffix(".json").write_text(
        json.dumps({**config, "model": {**config["model"], "filters": filters}}))
    noise = 0.02 * min(1.0, (128 / filters) ** 0.5)
    np.savez(stem.with_suffix(".npz"), **convert.npz_arrays_from_params(
        convert.widen_params(trained, filters, 11, noise)))
    ens = run_ensemble.setup(run_ensemble.build_parser().parse_args(
        ["--checkpoint_dir", str(stem), "--num_trajectories", str(batch),
         "--domain_factor", str(factor), "--device", str(cuda)]))
    model = ens.model
    dt = model.stable_time_step(u_scale=3.0)
    pack = fk.pack_learned_rk4(ens.params, model.equation, model.grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)
    fp = None
    if ens.forcing is not None:
        fp = fk.pack_forcing(ens.forcing, 3.7, model.equation, model.grid, dt, batch)
    rough = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, model.grid.size)).astype(np.float32)).to(cuda)
    return pack, dt, fp, rough, 0.3 * ens.u0


@pytest.mark.parametrize("checkpoint,filters,factor,batch,steps", [
    ("ckpt_ks8", 136, 1, 5, 10), ("ckpt_kdv8", 200, 1, 3, 10), ("ckpt_burgers8", 256, 1, 4, 10),
    ("ckpt_ks8", 256, 9, 2, 10), ("ckpt_burgers8", 256, 8, 2, 10), ("ckpt_ks8", 512, 4, 2, 10),
    ("ckpt_ks8", 1024, 2, 2, 10), ("ckpt_burgers8", 1024, 2, 1, 10),
    ("ckpt_ks8", 2384, 1, 1, 4), ("ckpt_burgers8", 2304, 1, 1, 4),
])
def test_learned_rk4_chunked_matches_plain(cuda, tmp_path, checkpoint, filters, factor, batch,
                                           steps):
    """Towers wider than 128 filters (the chunked form: the split form in
    output chunks of 128 channels, the weights streamed a slice of one
    chunk, conv tap and 128 input channels at a time): ragged last chunks
    (136 and 200 filters pad to 144 and 208: chunks of 128 and 16 or 80
    channels), and the widest grids JAX's VMEM estimate admits at 256
    (1152 points; 1024 forced), 512, 1024, 2304 (forced) and 2384 filters,
    over up to 16 blocks of 8 points. One step from N(0,1) and ``steps``
    from a smooth state against the plain version (the limits above)."""
    pack, dt, fp, rough, smooth = _widened_inputs(checkpoint, filters, factor, batch, cuda,
                                                  tmp_path)
    nx = pack.grid.size
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    launch = fk.learned_rk4_launch(pack, nx, terms, batch)
    print(launch)
    assert pack.padded_channels == -(-filters // 16) * 16 and fk.learned_rk4_refusal(
        pack, nx, terms) is None
    assert launch.split and launch.stream and launch.cluster <= fk.MAX_CLUSTER
    before = fk.fused_learned_rk4.launches
    got_inc = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp) - rough
    got = fk.fused_learned_rk4(smooth, pack, dt, steps, forcing=fp)
    torch.cuda.synchronize()
    assert fk.fused_learned_rk4.launches == before + 2
    exact_pack = dataclasses.replace(pack, flat=pack.flat.double())
    fp64 = None if fp is None else fk.ForcingPack(*(leaf.double() for leaf in fp))
    want_inc = fk.fused_learned_rk4_plain(rough, pack, dt, 1, fp) - rough
    exact_inc = (fk.fused_learned_rk4_plain(rough.double(), exact_pack, dt, 1, fp64)
                 - rough.double())
    _assert_step_close(got_inc, want_inc, WIDE_STEP_RMS_TOL, WIDE_STEP_MAX_TOL,
                       exact_inc=exact_inc)
    want = fk.fused_learned_rk4_plain(smooth, pack, dt, steps, fp)
    exact = fk.fused_learned_rk4_plain(smooth.double(), exact_pack, dt, steps, fp64)
    _assert_run_close(got, want, RUN_TOL, exact)


@pytest.mark.parametrize("name,cons,size,filters,nx,cluster", [
    ("ks", True, 6, 256, 128, 3), ("burgers", True, 8, 136, 128, 2),
    ("kdv", False, 7, 200, 128, 4),
])
def test_learned_rk4_chunked_shared_shapes_bit_for_bit(cuda, name, cons, size, filters, nx,
                                                       cluster):
    """The chunked form where other forms take the same function, bit for
    bit: a 128-filter tower widened with zero channels to ``filters`` (its
    new output chunk or the ragged rest adds exact zeros, and the heads sum
    the chunks' products after the first chunk's) against the 128-filter
    form's one-block run, and the chunked form forced over ``cluster``
    blocks against its own launch (one block at nx 128), one step from N(0,1)
    and 10 steps from a smooth state."""
    batch = 9
    pack, dt, fp, rough, smooth = _split_inputs(name, cons, size, 128, nx, batch, cuda)
    model, params, _ = _model(name, cons, size, cuda, nx=nx, filters=128, layers=3)
    wide_pack = fk.pack_learned_rk4(convert.widen_params(params, filters, 0, 0.0),
                                    model.equation, model.grid, model.config.kernel_size,
                                    model.constraint_layers, model.taps)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    assert not fk.learned_rk4_launch(pack, nx, terms, batch).split
    assert fk.learned_rk4_launch(wide_pack, nx, terms, batch).cluster == 1
    for u, steps in ((rough, 1), (smooth, 10)):
        narrow = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp)
        chunked = fk.fused_learned_rk4(u, wide_pack, dt, steps, forcing=fp)
        split = fk.fused_learned_rk4(u, wide_pack, dt, steps, forcing=fp, cluster=cluster)
        torch.cuda.synchronize()
        print(f"{steps} steps: max abs diff to 128 filters "
              f"{float((chunked - narrow).abs().max()):.3e}, over {cluster} blocks "
              f"{float((split - chunked).abs().max()):.3e}")
        torch.testing.assert_close(chunked, narrow, rtol=0, atol=0)
        torch.testing.assert_close(split, chunked, rtol=0, atol=0)


# Split launches that stream their weights through the ring, each against a
# launch of the same function that holds the weights otherwise: (name, cons,
# size, filters, nx, cluster, reference): 32 filters at Burgers-8x's nx 2048
# over 3 blocks (the rule keeps the weights whole over 8: "whole"); 256
# filters, a 128-filter tower widened with zero channels, over 2 blocks (the
# chunked form; the 128-filter tower's whole ring: "narrow"); 128 filters at
# nx 1024 over 16 blocks (C = 16, the ring's mask of 16 bits; the same
# function over 4 blocks of 1 group: "cluster 4").
SPLIT_RING_SHAPES = [
    ("burgers", True, 8, 32, 2048, 3, "whole"), ("ks", True, 6, 256, 128, 2, "narrow"),
    ("kdv", False, 7, 200, 128, 4, "narrow"), ("ks", True, 6, 128, 1024, 16, "cluster 4"),
]


@pytest.mark.parametrize("name,cons,size,filters,nx,cluster,reference", SPLIT_RING_SHAPES)
def test_learned_rk4_split_ring_slots_bit_for_bit(cuda, name, cons, size, filters, nx, cluster,
                                                  reference):
    """The split form's ring at every size from one slot to the most that
    fit beside the segment (RING_SLOTS set to each, up to MAX_RING_SLOTS),
    each slice multicast to every block of the trajectory's cluster: below
    128 channels, in the chunked form (a ragged last chunk at 200 filters)
    and over 16 blocks, an odd batch (5), bit for bit the reference launch,
    one step from N(0,1) and 10 steps from a smooth state: every row runs
    the same products in the same order whatever the slots and blocks."""
    batch = 5
    narrow_pack, dt, fp, rough, smooth = _split_inputs(
        name, cons, size, min(filters, 128), nx, batch, cuda)
    pack = narrow_pack
    if filters > 128:
        model, params, _ = _model(name, cons, size, cuda, nx=nx, filters=128, layers=3)
        pack = fk.pack_learned_rk4(convert.widen_params(params, filters, 0, 0.0), model.equation,
                                   model.grid, model.config.kernel_size, model.constraint_layers,
                                   model.taps)
    terms = 0 if fp is None else fp.amplitude.shape[-1]
    wants = []
    for u, steps in ((rough, 1), (smooth, 10)):
        if reference == "narrow":
            wants.append(fk.fused_learned_rk4(u, narrow_pack, dt, steps, forcing=fp))
        elif reference == "whole":
            assert not fk.learned_rk4_launch(pack, nx, terms, batch).stream
            wants.append(fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp))
        else:
            wants.append(fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp, cluster=4, groups=1))
    saved = fk.RING_SLOTS
    sizes = []
    try:
        for slots in range(1, fk.MAX_RING_SLOTS + 1):
            fk.RING_SLOTS = slots
            launch = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster)
            assert launch.split and launch.stream and launch.cluster == cluster
            if launch.slots < slots:
                break  # no more fit beside the segment
            sizes.append(slots)
            for (u, steps), want in zip(((rough, 1), (smooth, 10)), wants):
                got = fk.fused_learned_rk4(u, pack, dt, steps, forcing=fp, cluster=cluster)
                torch.cuda.synchronize()
                print(f"{launch}: {steps} steps, max abs diff to the {reference} launch "
                      f"{float((got - want).abs().nan_to_num(nan=float('inf')).max()):.3e}")
                torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    finally:
        fk.RING_SLOTS = saved
    print(f"slots {sizes}")
    assert sizes[0] == 1 and len(sizes) >= 2


def test_learned_rk4_split_ring_mask_fault_is_caught(cuda):
    """The split ring's check has power against a slice that misses a block:
    built with -DPDE_FAULT_RING_MASK_SHORT (each slice multicast to every
    block of the cluster but the last) the launch of 32 filters at nx 2048
    over 3 blocks fails (that block's wait for the slice runs out, the kernel
    traps: a short PDE_RING_WAIT_CYCLES) or gives another result than the
    weights whole. In a child process: a trap leaves its CUDA context
    unusable."""
    import subprocess
    import sys
    import textwrap

    child = textwrap.dedent("""
        import sys
        import torch
        sys.path.insert(0, "tests")
        from pde_superresolution_torch.ops import _build
        from pde_superresolution_torch.ops import fused_kernels as fk
        import test_torch_gpu as t
        _build.NVCC_FLAGS += ["-DPDE_FAULT_RING_MASK_SHORT", "-DPDE_RING_WAIT_CYCLES=(1ll<<28)"]
        cuda = torch.device("cuda")
        pack, dt, fp, rough, _ = t._split_inputs("burgers", True, 8, 32, 2048, 3, cuda)
        whole = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp)
        torch.cuda.synchronize()
        try:
            faulty = fk.fused_learned_rk4(rough, pack, dt, 1, forcing=fp, cluster=3)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print("caught: the launch failed:", str(e).splitlines()[0])
        else:
            print("caught: another result" if not torch.equal(faulty, whole)
                  else "missed: the same bits")
    """)
    run = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                         timeout=900)
    print(run.stdout[-2000:], run.stderr[-2000:])
    assert "caught:" in run.stdout and "missed" not in run.stdout


def test_run_ensemble_split_and_refusal_on_card(cuda):
    """run_ensemble on the Burgers-8x checkpoint at --domain_factor 10 (nx
    1280, more than one block holds with its 20-term phase state) takes the
    kernel at --fused auto, split over 5 blocks, one launch per save, every
    member finite; --fused true is refused on the card only beyond 16
    blocks (nx 11,392 at --domain_factor 89), with the refusal's reason
    and before any launch."""
    from pde_superresolution_torch.scripts import run_ensemble

    args = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", "64",
            "--time_max", "0.05", "--warmup_time", "0.1", "--num_saves", "2"]
    fk.fused_learned_rk4.launches = fk.fused_rhs.launches = 0
    result = run_ensemble.main(args + ["--domain_factor", "10"])
    assert result["path"] == "fused kernel" and result["nx"] == 1280
    assert "clusters of 5 blocks" in result["reason"]
    assert (fk.fused_learned_rk4.launches, fk.fused_rhs.launches) == (2, 0)
    assert result["finite"] == 64
    with pytest.raises(ValueError, match=r"^--fused true, but the kernel cannot take this "
                                         r"shape: needs \d+ bytes of shared memory per block "
                                         r"split over 16 blocks"):
        run_ensemble.main(args + ["--domain_factor", "89", "--fused", "true"])
    assert fk.fused_learned_rk4.launches == 2


def test_run_ensemble_takes_the_kernel_at_256_filters_on_card(cuda, tmp_path):
    """run_ensemble --fused auto on the KS-8x checkpoint widened to 256
    filters (convert.widen_params) takes the kernel's chunked form (before,
    rhs_fn steps: "256 filters > kernel limit 128"), one launch per save,
    every member finite."""
    import json

    from pde_superresolution_torch.scripts import run_ensemble

    _, trained, config = convert.load_asset("ckpt_ks8", device=cuda)
    stem = tmp_path / "ks8_256_filters"
    stem.with_suffix(".json").write_text(
        json.dumps({**config, "model": {**config["model"], "filters": 256}}))
    np.savez(stem.with_suffix(".npz"),
             **convert.npz_arrays_from_params(convert.widen_params(trained, 256, 11, 0.02)))
    fk.fused_learned_rk4.launches = fk.fused_rhs.launches = 0
    result = run_ensemble.main(["--checkpoint_dir", str(stem), "--num_trajectories", "64",
                                "--time_max", "0.05", "--warmup_time", "0.1",
                                "--num_saves", "2"])
    print(result["reason"])
    assert result["path"] == "fused kernel" and "a conv tap's weights at a time" in result["reason"]
    assert (fk.fused_learned_rk4.launches, fk.fused_rhs.launches) == (2, 0)
    assert result["finite"] == 64


def test_run_ensemble_burgers64_takes_the_kernel_on_card(cuda, capsys):
    """Burgers-64x's 16 points, which the learned kernel refused before it
    packed short grids (nx=16 < 32; rhs_fn steps), take the kernel at
    --fused auto: one launch per save, no fused_rhs, 8 trajectories a team
    at 1061 members (133 teams, the last holding 5); the members that stay
    finite (a member near the model's stability edge blows up by both
    routes: 1 of 1061 on an H100) are the same by both routes, at least
    99%, and 90% of them end within 2e-3 of max|u| of --fused false's (the
    JAX package's bound for its kernel against a float32 tower) at every
    point. A few members near the edge amplify the bf16 tower's difference
    from the float32 route on 16 points (45 of 16,960 values differed by up
    to 0.29 on an H100), so the run is held at the quantile
    chip_smoke.hold_run uses."""
    from pde_superresolution_torch.scripts import run_ensemble

    args = ["--checkpoint_dir", "ckpt_burgers64", "--num_trajectories", "1061",
            "--time_max", "0.2", "--warmup_time", "0.2", "--num_saves", "2"]
    fk.fused_learned_rk4.launches = fk.fused_rhs.launches = 0
    fused = run_ensemble.main(args)
    assert fused["path"] == "fused kernel" and fused["reason"].startswith("auto: cuda")
    assert "warp groups of 8 trajectories" in fused["reason"]
    assert "route: fused kernel" in capsys.readouterr().out
    assert (fk.fused_learned_rk4.launches, fk.fused_rhs.launches) == (2, 0)
    steps = run_ensemble.main(args + ["--fused", "false"])
    assert steps["path"] == "rhs_fn steps" and fused["nx"] == 16
    live = torch.isfinite(fused["final"]).all(-1) & torch.isfinite(steps["final"]).all(-1)
    assert fused["finite"] == steps["finite"] == int(live.sum()) >= 0.99 * 1061
    worst = ((fused["final"][live] - steps["final"][live]).abs().amax(-1)
             / float(steps["final"][live].abs().max()))
    print(f"of max|u|, each member's worst point: 90% quantile "
          f"{float(worst.quantile(0.9)):.3e}, max {float(worst.max()):.3e}")
    assert float(worst.quantile(0.9)) <= 2e-3


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
