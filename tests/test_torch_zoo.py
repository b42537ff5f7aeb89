"""The committed model zoo (``convert.asset_names()``) in the port against
the JAX package's checkpoints under ``artifacts/``: a rollout, the fused
kernel's plain version, the kernels' launch geometry at the zoo's shapes,
the ensemble entry point's route, and ``evaluate`` on shared members.

The zoo's coarse grids run from 128 points down to 16 (Burgers at 64x),
with stencils of 8 and 10 taps and towers of 32 or 64 filters. Inputs are
made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import evaluate as jeval
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu import weno as jweno
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import evaluate as teval
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch import weno as tweno
from pde_superresolution_torch.grids import Grid as TGrid
from pde_superresolution_torch.ops import fused_kernels as fk
from pde_superresolution_torch.scripts import run_ensemble
from test_torch_evaluate import _compare, _numpy_forcing, _smooth_members, inject  # noqa: F401

torch.set_num_threads(1)

# asset -> its JAX checkpoint directory
ZOO = {
    "ckpt_ks8_u16s8": "artifacts/ckpt_ks8_u16s8",
    "ckpt_ks16": "artifacts/ckpt_ks16",
    "ckpt_ks32": "artifacts/ckpt_ks32",
    "ks32_select_seed0": "artifacts/r5_ks32_select/seed0",
    "ckpt_kdv16": "artifacts/ckpt_kdv16",
    "ckpt_kdv16_f64": "artifacts/ckpt_kdv16_f64",
    "kdv16_select_seed7": "artifacts/r5_kdv16_select/seed7",
    "ckpt_burgers64": "artifacts/ckpt_burgers64",
}


@pytest.fixture(scope="module")
def jax_models():
    return {}


def _pair(name, jax_models):
    if name not in jax_models:
        jax_models[name] = load_model(ZOO[name])
    model_j, params_j, _ = jax_models[name]
    model_t, params_t, config = convert.load_asset(name, device="cpu")
    return model_j, params_j, model_t, params_t, config


def _state(model, config, count=4, seed=5):
    """float32 [count, nx]: a few low sinusoids per member at the
    checkpoint's initial-condition scale, and numpy forcing leaves for a
    forced equation (else None)."""
    rng = np.random.default_rng(seed)
    u = config["ic_scale"] * _smooth_members(rng, model.grid.x, model.equation.period, count)
    forcing = _numpy_forcing(rng, count) if model.equation.forced else None
    return u.astype(np.float32), forcing


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# 20 RK4 steps at the model's stable step, of max|u|: float32 on both sides,
# RHS sums in other orders (tests/test_torch_convert.py holds one RHS); read
# 1.8e-7 to 1.0e-6 on the CPU
ROLLOUT_TOL = 1e-5


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_rollout_matches_jax(jax_models, name):
    """20 RK4 steps of ``integrate(rhs_fn)`` (the fused_rhs route; its plain
    version on the CPU) against JAX's ``integrate(rhs_fn(use_pallas=False))``
    from the same numpy state and forcing, within ROLLOUT_TOL of max|u|."""
    model_j, params_j, model_t, params_t, config = _pair(name, jax_models)
    u, forcing = _state(model_t, config)
    dt = model_t.stable_time_step(u_scale=3.0)
    fj = ft = None
    if forcing is not None:
        fj = jeq.ForcingParams(*(jnp.asarray(a) for a in forcing))
        ft = teq.ForcingParams(*(torch.from_numpy(a) for a in forcing))
    _, want = jint.integrate(model_j.rhs_fn(params_j, fj, use_pallas=False), jnp.asarray(u),
                             dt, 20, 20, t0=0.5)
    _, got = tint.integrate(model_t.rhs_fn(params_t, ft, use_kernel=True), torch.from_numpy(u),
                            dt, 20, 20, t0=0.5)
    assert got.shape == (2, 4, model_t.grid.size) and np.isfinite(got.numpy()).all()
    err = _rel(got[-1].numpy(), np.asarray(want)[-1])
    print(f"{name}: 20 steps of {dt:.6g}, of max|u|: {err:.3e}")
    assert err < ROLLOUT_TOL


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_fused_plain_matches_rhs_fn_route(name):
    """``fused_rk4_fn`` (the fused kernel's plain version on the CPU: the
    tower's inputs rounded to bf16, forcing by rotated phases) against
    ``integrate(rhs_fn)`` in float32 over 20 steps from the same state: 2e-3
    of max|u|, the JAX package's bound for its kernel against a float32
    tower (also tests/test_torch_integrate.py). The plain version takes
    every shape, Burgers-64x's 16 points too, which the card refuses."""
    model, params, config = convert.load_asset(name, device="cpu")
    u, forcing = _state(model, config)
    ft = None if forcing is None else teq.ForcingParams(*(torch.from_numpy(a) for a in forcing))
    dt = model.stable_time_step(u_scale=3.0)
    u0 = torch.from_numpy(u)
    _, want = tint.integrate(model.rhs_fn(params, ft), u0, dt, 20, 10, t0=0.5)
    _, got = tint.integrate_fused(model.fused_rk4_fn(params, dt, 10, forcing=ft, t0=0.5), u0,
                                  dt, 20, 10, t0=0.5)
    err = float((got - want).abs().max() / want.abs().max())
    print(f"{name}: fused plain version vs rhs_fn route after 20 steps, of max|u|: {err:.3e}")
    assert got.shape == want.shape == (3, 4, model.grid.size) and err < 2e-3


# The launches the card makes at the zoo's shapes (fused_kernels decides them
# in Python): fused_rhs at the evaluation's batch (32) and the ensemble's
# (10240) as (rows, threads_x, halo, shared bytes, blocks); fused_learned_rk4
# at 10240 unpacked (per_team=1, every launch before the kernel packed short
# grids) as (teams, bytes a team, weight bytes, shared bytes), and as the
# launch packs it (trajectories a team, teams a block, bytes a team, shared
# bytes, blocks).
GEOMETRY = {
    "ckpt_ks8_u16s8": ((1, 128, 4, 13360, 32), (1, 128, 4, 13360, 10240),
                       (4, 26880, 23680, 131200), (1, 4, 26880, 131200, 2560)),
    "ckpt_ks16": ((1, 64, 4, 6704, 32), (2, 64, 4, 13392, 5120), (4, 17664, 23680, 94336),
                  (2, 4, 27392, 133248, 1280)),
    "ckpt_ks32": ((1, 32, 5, 4144, 32), (4, 32, 5, 16560, 2560), (4, 20736, 25088, 108032),
                  (4, 4, 31616, 151552, 640)),
    "ks32_select_seed0": ((1, 32, 5, 4144, 32), (4, 32, 5, 16560, 2560),
                          (4, 20736, 25088, 108032), (4, 4, 31616, 151552, 640)),
    "ckpt_kdv16": ((1, 32, 5, 2864, 32), (4, 32, 5, 11440, 2560), (4, 17664, 24064, 94720),
                   (4, 4, 28544, 138240, 640)),
    "ckpt_kdv16_f64": ((1, 32, 5, 2864, 32), (4, 32, 5, 11440, 2560),
                       (4, 26496, 87936, 193920), (4, 3, 47104, 229248, 854)),
    "kdv16_select_seed7": ((1, 32, 5, 2864, 32), (4, 32, 5, 11440, 2560),
                           (4, 17664, 24064, 94720), (4, 4, 28544, 138240, 640)),
    "ckpt_burgers64": ((1, 32, 4, 1200, 32), (8, 32, 4, 9504, 1280), (4, 17792, 23424, 94592),
                       (8, 4, 51456, 229248, 320)),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_launch_geometry(name):
    """Each model's launches at the zoo's shapes, as predicted: a 16-point
    Burgers trajectory in a 32-lane row, 8 rows a block at B=10240; 10-tap
    rows at nx=32 with a halo of 5, 4 a block; unpacked, the 64-filter
    KdV-16x tower with 4 teams in 193920 of the 232448 bytes of a block.
    Packed, the learned kernel fills a team's 128 rows: 2 trajectories at nx
    64, 4 at 32, 8 at Burgers-64x's 16 points, which it refused before it
    packed (JAX's kernel refuses them: nx % 128), and 3 teams of 4 KdV-16x
    f64 trajectories, 4 of 8 Burgers-64x ones, in 229248 bytes; nx 128 is
    not packed. At B=256 every model keeps the unpacked launch."""
    model, params, config = convert.load_asset(name, device="cpu")
    nx = model.grid.size
    rhs_32, rhs_ensemble, learned, packed = GEOMETRY[name]
    for batch, want in ((32, rhs_32), (10240, rhs_ensemble)):
        launch = fk.rhs_launch(batch, nx, model.taps)
        assert (launch.rows, launch.threads_x, launch.halo, launch.shared_bytes,
                launch.blocks) == want
        assert launch.seg == nx and launch.parts == 1
    pack = fk.pack_learned_rk4(params, model.equation, model.grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)
    terms = 20 if model.equation.forced else 0
    assert fk.learned_rk4_refusal(pack, nx, terms) is None
    launch = fk.learned_rk4_launch(pack, nx, terms, 10240, per_team=1)
    assert (launch.teams, launch.team_bytes, pack.blob.numel(), launch.shared_bytes) == learned
    assert launch.shared_bytes <= fk.MAX_SHARED_BYTES and launch.blocks == 2560
    launch = fk.learned_rk4_launch(pack, nx, terms, 10240)
    assert (launch.per_team, launch.teams, launch.team_bytes, launch.shared_bytes,
            launch.blocks) == packed
    assert launch.shared_bytes <= fk.MAX_SHARED_BYTES and not launch.split
    assert fk.learned_rk4_launch(pack, nx, terms, 256) == fk.learned_rk4_launch(
        pack, nx, terms, 256, per_team=1)
    reach = max(abs(t) for taps in pack.taps.values() for t in taps)
    assert pack.padded_channels == config["model"]["filters"] and reach <= fk.U_HALO


def test_burgers64_ensemble_route(capsys):
    """run_ensemble on Burgers-64x: the learned kernel takes its 16 points
    (it refused them, nx=16 < 32, before it packed short grids), so --fused
    true runs the fused route (on the CPU the kernel's plain version) and
    holds rhs_fn's final state within 2e-3 of max|u| (the plain version's
    bound against the float32 route); --fused auto takes rhs_fn steps on the
    CPU and prints why (the card's kernel route is tests/test_torch_gpu.py's)."""
    args = ["--checkpoint_dir", "ckpt_burgers64", "--num_trajectories", "8", "--time_max",
            "0.2", "--warmup_time", "0.1", "--num_saves", "2", "--device", "cpu"]
    fused = run_ensemble.main(args + ["--fused", "true"])
    assert fused["path"].startswith("fused kernel") and fused["reason"] == "--fused true"
    result = run_ensemble.main(args)
    assert result["path"] == "rhs_fn steps" and result["reason"] == "auto: device is cpu"
    assert result["nx"] == fused["nx"] == 16 and result["finite"] == fused["finite"] == 8
    assert torch.equal(fused["initial"], result["initial"])
    err = float((fused["final"] - result["final"]).abs().max() / result["final"].abs().max())
    assert err < 2e-3
    assert "route: rhs_fn steps (auto: device is cpu)" in capsys.readouterr().out


# (horizon, time_delta, extra evaluate kwargs) of the evaluate parity cases:
# the checkpoints' protocols (KdV ic_scale 0.5 is in the injected state) cut
# short, no warm-up (the members are injected)
EVAL_CASES = {"ckpt_ks32": (1.0, 0.25), "ckpt_kdv16_f64": (0.5, 0.05),
              "ckpt_burgers64": (0.5, 0.1)}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_zoo_evaluate_matches_jax(inject, jax_models, name):
    """``evaluate`` with the model, the matched-width classic baseline and,
    for Burgers, WENO5, on 2 injected members (numpy state and forcing at
    the fine grid) against JAX's ``evaluate``: exact within 1e-5 of
    max|exact|, the model within 1e-4 and the classic schemes within 1e-5
    (tests/test_torch_evaluate.py's limits), survival times equal but for
    members near the threshold."""
    model_j, params_j, model_t, params_t, config = _pair(name, jax_models)
    horizon, delta = EVAL_CASES[name]
    eq_j, eq_t = model_j.equation, model_t.equation
    fine_j = JGrid(config["fine_size"], eq_j.period)
    fine_t = TGrid(config["fine_size"], eq_t.period)
    factor = config["resample_factor"]
    rng = np.random.default_rng(7)
    u0 = (config["ic_scale"] * _smooth_members(rng, fine_j.x, eq_j.period, 2)).astype(np.float32)
    inject(u0, _numpy_forcing(rng, 2) if eq_t.forced else None)
    size = model_t.config.stencil_size
    jtree = jax.tree.map(jnp.asarray, params_j)
    schemes_j = {
        "model": lambda f: model_j.rhs_fn(jtree, f, use_pallas=False),
        "baseline": lambda f: jint.PolynomialDifferentiator(
            eq_j, model_j.grid, stencil_size=size).rhs_fn(f),
    }
    schemes_t = {
        "model": lambda f: model_t.rhs_fn(params_t, f),
        "baseline": lambda f: tint.PolynomialDifferentiator(
            eq_t, model_t.grid, stencil_size=size, device="cpu").rhs_fn(f),
    }
    limits = {"model": 1e-4, "baseline": 1e-5}
    if eq_t.forced:
        schemes_j["weno"] = lambda f: jweno.WENODifferentiator(eq_j, model_j.grid).rhs_fn(f)
        schemes_t["weno"] = lambda f: tweno.WENODifferentiator(
            eq_t, model_t.grid, device="cpu").rhs_fn(f)
        limits["weno"] = 1e-5
    dt = model_t.stable_time_step(u_scale=3.0)
    kwargs = dict(num_samples=2, time_max=horizon, time_delta=delta,
                  coarse_dt=teval.model_coarse_dt(dt, eq_t, model_t.grid))
    want = jeval.evaluate(eq_j, fine_j, factor, schemes_j, key=jax.random.PRNGKey(0), **kwargs)
    got = teval.evaluate(eq_t, fine_t, factor, schemes_t, generator=torch.Generator(),
                         device="cpu", **kwargs)
    saves = int(round(horizon / delta))
    assert got.exact.shape == (2, saves + 1, model_t.grid.size)
    _compare(got, want, limits)


# RESULTS.md's per-key survival medians of the selected KdV-16x seed (keys 0,
# 1, 2; JAX on a TPU, whose default matmul precision is bf16)
SEED7_RESULTS = [8.95, 9.50, 9.95]


@pytest.mark.parametrize("members", ["port", "jax"])
def test_seed7_protocol_on_the_ports_members(inject, jax_models, members):
    """The selected KdV-16x seed at RESULTS.md's multi-key protocol (keys 0,
    1 and 2, 32 members each, ic_scale 0.5, horizon 10, the model scheme),
    on the members the port draws from those keys (``port``:
    ``torch.Generator``, injected into both packages) or on the JAX
    package's own members of those keys (``jax``: JAX's ``evaluate`` draws
    them from ``PRNGKey(key)``, the port evaluates the committed copy
    through ``probe_zoo.JaxMembers``): JAX's ``evaluate`` and the port's
    give the same survival time member by member (but for members whose
    correlation comes within NEAR_THRESHOLD of 0.8), so the same per-key
    and pooled medians. So a pooled median away from RESULTS.md's is a
    property of the members drawn, or of the TPU's precision, not of the
    port's numerics."""
    import contextlib

    from pde_superresolution_torch.scripts import probe_zoo
    from test_torch_evaluate import NEAR_THRESHOLD, THRESHOLD

    model_j, params_j, model_t, params_t, config = _pair("kdv16_select_seed7", jax_models)
    fine_j = JGrid(config["fine_size"], model_j.equation.period)
    fine_t = TGrid(config["fine_size"], model_t.equation.period)
    jtree = jax.tree.map(jnp.asarray, params_j)
    kwargs = dict(num_samples=32, time_max=10.0, time_delta=0.1)
    # the port's draws, all made before the first injection replaces the sampler
    port_draws = {seed: teval._draw(model_t.equation, fine_t, torch.Generator().manual_seed(seed),
                                    32, config["ic_scale"], "cpu")[0].numpy() for seed in (0, 1, 2)}
    medians, pooled = {"jax": [], "port": []}, {"jax": [], "port": []}
    for seed in (0, 1, 2):
        draws = contextlib.nullcontext()
        if members == "port":
            inject(port_draws[seed], None)
        else:
            draws = probe_zoo.JaxMembers("kdv16_select_seed7", [seed])
        want = jeval.evaluate(model_j.equation, fine_j, config["resample_factor"],
                              {"model": lambda f: model_j.rhs_fn(jtree, f, use_pallas=False)},
                              key=jax.random.PRNGKey(seed), ic_scale=config["ic_scale"]
                              if members == "jax" else 1.0, **kwargs)
        with draws:
            got = teval.evaluate(model_t.equation, fine_t, config["resample_factor"],
                                 {"model": lambda f: model_t.rhs_fn(params_t, f)},
                                 generator=torch.Generator().manual_seed(seed), device="cpu",
                                 ic_scale=config["ic_scale"] if members == "jax" else 1.0,
                                 **kwargs)
        # the same members: the coarse initial states, block means in float32
        np.testing.assert_allclose(got.exact[:, 0].numpy(), np.asarray(want.exact)[:, 0],
                                   rtol=0, atol=1e-6)
        surv_j = np.asarray(want.survival_time["model"])
        surv_t = got.survival_time["model"].numpy()
        near = (np.abs(np.asarray(want.correlation["model"]) - THRESHOLD)
                <= NEAR_THRESHOLD).any(axis=-1)
        assert not ((surv_t != surv_j) & ~near).any(), (seed, surv_t, surv_j)
        for side, surv in (("jax", surv_j), ("port", surv_t)):
            medians[side].append(float(np.median(surv)))
            pooled[side].append(surv)
    pooled = {side: float(np.median(np.concatenate(s))) for side, s in pooled.items()}
    print(f"{members} members: survival medians per key {medians}, pooled {pooled}; "
          f"RESULTS.md per key {SEED7_RESULTS}")
    assert medians["jax"] == medians["port"] and pooled["jax"] == pooled["port"]


def test_probe_zoo_rehearsal_on_cpu(capsys):
    """scripts/probe_zoo.py, cut to 2 members and a horizon of 0.2 on the
    CPU for Burgers-64x: the protocol's three keys pooled for the model, the
    matched-width baseline and WENO5, seconds by layer, one JSON line per
    model and no launch (the CPU runs the kernels' plain versions)."""
    import json

    from pde_superresolution_torch.scripts import probe_zoo

    rows = probe_zoo.main(["--models", "ckpt_burgers64", "--num_samples", "2",
                           "--max_horizon", "0.2", "--device", "cpu"])
    assert len(rows) == 1
    row = rows[0]
    assert row["seeds"] == [0, 1, 2] and row["horizon"] == 0.2 and row["card"] == "cpu"
    assert sorted(row["pooled"]) == ["baseline", "model", "weno"]
    assert all(p["members"] == 6 for p in row["pooled"].values())
    assert all(len(v) == 3 for v in row["per_key_survival_median"].values())
    assert sorted(row["layers_s"]) == ["baseline", "exact", "model", "weno"]
    assert row["fused_rhs_launches"] == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == [json.loads(json.dumps(row))]
    with pytest.raises(SystemExit):
        probe_zoo.main(["--models", "ckpt_nothing", "--device", "cpu"])


# -- the JAX package's members (tools/export_jax_members.py) -----------------------------


@pytest.mark.parametrize("stem,key", [("ks_1024", 54321), ("kdv_512", 12345),
                                      ("burgers_1024", 2)])
def test_committed_members_are_jaxs_draw(stem, key):
    """The committed members of one key per equation are, bit for bit, what
    JAX's ``evaluate`` draws from that key on the CPU: ``split`` the key,
    the initial conditions (before ic_scale) from the first half and the
    forcing from the second, 32 members."""
    from pde_superresolution_torch.scripts import probe_zoo

    equation_name, fine_size = stem.split("_")
    equation = jeq.from_name(equation_name, conservative=True)
    k_ic, k_f = jax.random.split(jax.random.PRNGKey(key))
    want = {"u0": equation.initial_conditions(k_ic, JGrid(int(fine_size), equation.period),
                                              (32,))}
    forcing = equation.sample_forcing(k_f, (32,))
    if forcing is not None:
        want.update(forcing._asdict())
    with np.load(probe_zoo.members_dir() / f"{stem}.npz") as data:
        for name, value in want.items():
            got = data[f"{name}/{key}"]
            assert got.dtype == np.float32 and got.shape[0] == 32
            np.testing.assert_array_equal(got, np.asarray(value, np.float32))


def test_members_tool_writes_the_committed_files(tmp_path):
    """``tools/export_jax_members.py`` run afresh writes, for every eval key
    of ``probe_zoo.ZOO``, the arrays that are committed, and no member file
    is taken for a model by ``convert.asset_names()``."""
    import importlib.util

    from pde_superresolution_torch.scripts import probe_zoo

    spec = importlib.util.spec_from_file_location(
        "export_jax_members", convert.ASSET_DIR.parents[1] / "tools" / "export_jax_members.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main([str(tmp_path)])
    committed = sorted(p.name for p in probe_zoo.members_dir().glob("*.npz"))
    assert sorted(p.name for p in tmp_path.iterdir()) == committed == [
        "burgers_1024.npz", "kdv_512.npz", "ks_1024.npz"]
    for name in committed:
        with np.load(tmp_path / name) as fresh, np.load(probe_zoo.members_dir() / name) as kept:
            assert sorted(fresh.files) == sorted(kept.files)
            for array in kept.files:
                np.testing.assert_array_equal(fresh[array], kept[array])
    for name, seeds, _ in probe_zoo.ZOO:
        probe_zoo.JaxMembers(name, [int(s) for s in seeds.split(",")])
    assert len(convert.asset_names()) == 11 and "members" not in convert.asset_names()


def test_probe_zoo_jax_members_rehearsal_on_cpu():
    """``probe_zoo --members jax`` for Burgers-64x at 2 members and a
    horizon of 0.2 on the CPU: the row says ``"members": "jax"``, and its
    exact fine solve starts from JAX's first 2 members of each key (the
    port's own draw differs); a key without committed members is refused
    by the model's name before anything runs."""
    from pde_superresolution_torch import evaluate
    from pde_superresolution_torch.scripts import probe_zoo

    starts = []
    real = tint.exact_solve_sampled

    def record(equation, grid, u0, *args, **kwargs):
        starts.append(u0.numpy().copy())
        return real(equation, grid, u0, *args, **kwargs)

    tint.exact_solve_sampled = record
    try:
        rows = probe_zoo.main(["--models", "ckpt_burgers64", "--num_samples", "2",
                               "--max_horizon", "0.2", "--device", "cpu", "--members", "jax"])
    finally:
        tint.exact_solve_sampled = real
    assert evaluate._draw.__name__ == "_draw"  # restored
    (row,) = rows
    assert row["members"] == "jax" and row["num_samples"] == 2 and row["seeds"] == [0, 1, 2]
    assert all(p["members"] == 6 for p in row["pooled"].values())
    assert sorted(row["model_members"]) == ["0", "1", "2"]
    assert all(len(m["survival"]) == len(m["margin"]) == 2 for m in row["model_members"].values())
    with np.load(probe_zoo.members_dir() / "burgers_1024.npz") as data:
        for key, u0 in zip((0, 1, 2), starts):
            np.testing.assert_array_equal(u0, data[f"u0/{key}"][:2])
    with pytest.raises(ValueError, match=r"ckpt_burgers64: no committed JAX members for eval "
                                         r"keys \[7\]"):
        probe_zoo.evaluate_model("ckpt_burgers64", "0,7", ["--time_max", "3"], 2, 0.2, "cpu",
                                 members="jax")


def test_member_margins():
    """The closest a member's correlation comes to 0.8 up to and including
    its first sample below it: later samples do not count."""
    from pde_superresolution_torch.scripts import probe_zoo

    corr = torch.tensor([[1.0, 0.9, 0.85, 0.95], [1.0, 0.81, 0.7, 0.8],
                         [0.95, 0.79, 0.8, 0.8], [0.5, 0.8, 0.8, 0.8]])
    want = torch.tensor([0.05, 0.01, 0.01, 0.3])
    torch.testing.assert_close(probe_zoo.member_margins(corr), want, rtol=0, atol=1e-6)
