"""The port's ensemble entry point (scripts.run_ensemble.main) on the CPU
against the same chain assembled from JAX functions, with the port's own
initial conditions and forcing handed over as numpy."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import analysis as janalysis
from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch.ops import fused_kernels as fk
from pde_superresolution_torch.scripts import run_ensemble

torch.set_num_threads(1)

ARGS = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", "16",
        "--time_max", "0.05", "--warmup_time", "0.1", "--num_saves", "2",
        "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX script's chain (exact-solver warm-up, then integrate with
    rhs_fn at the model-aware dt) on the port's seeded ensemble."""
    ensemble = run_ensemble.setup(run_ensemble.build_parser().parse_args(ARGS))
    model, params, _ = load_model("artifacts/ckpt_burgers8")
    equation, coarse = model.equation, model.grid
    u0 = jnp.asarray(ensemble.u0.numpy())
    forcing = jeq.ForcingParams(*(jnp.asarray(leaf.numpy()) for leaf in ensemble.forcing))
    dt_w = 0.2 * coarse.dx
    steps_w = int(np.ceil(0.1 / dt_w))
    _, warm = jint.integrate_spectral(
        equation, coarse, u0, dt_w, steps_w, save_every=steps_w, forcing=forcing)
    t0 = steps_w * dt_w
    dt = model.stable_time_step(u_scale=3.0)
    num_steps = int(np.ceil(0.05 / dt))
    save_every = max(1, num_steps // 2)
    num_steps = save_every * 2
    times, traj = jint.integrate(
        model.rhs_fn(params, forcing, use_pallas=False), warm[-1], dt, num_steps,
        save_every, t0=t0)
    return {"warm": np.asarray(warm[-1]), "final": np.asarray(traj[-1]),
            "times": np.asarray(times), "t0": t0, "dt": dt, "num_steps": num_steps,
            "period": equation.period}


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_rhs_route_matches_jax_chain(jax_chain, capsys):
    """--fused false on the CPU: warm-up (11 ETDRK4 steps), then 8 RK4 steps
    of rhs_fn with forcing, whose phase continues from the warm-up's end.
    The warmed state within 1e-5 of max|u| (as integrate_spectral's own
    test; measured 1.7e-7) and the final state within 1e-5 (float32 towers
    in other summation orders; measured 4.8e-7). The report holds what the
    JAX script prints."""
    result = run_ensemble.main(ARGS + ["--fused", "false"])
    assert result["path"] == "rhs_fn steps" and result["reason"] == "--fused false"
    assert result["num_steps"] == jax_chain["num_steps"] and result["nx"] == 128
    assert result["dt"] == jax_chain["dt"]
    assert result["t0"] == pytest.approx(jax_chain["t0"], rel=1e-12) and result["t0"] > 0.1
    np.testing.assert_allclose(result["times"].numpy(), jax_chain["times"], rtol=1e-6)
    assert result["t_start"] == pytest.approx(jax_chain["t0"], rel=1e-6)
    assert _rel(result["initial"].numpy(), jax_chain["warm"]) < 1e-5
    assert _rel(result["final"].numpy(), jax_chain["final"]) < 1e-5
    assert result["finite"] == result["num_trajectories"] == 16
    assert result["final_rms"] == pytest.approx(
        float(np.sqrt((jax_chain["final"] ** 2).mean())), rel=1e-5)
    k, spectrum = janalysis.energy_spectrum(jax_chain["final"], jax_chain["period"])
    assert result["spectrum_peak_k"] == k[np.argmax(spectrum[1:]) + 1]
    assert result["traj_steps_per_s"] == pytest.approx(
        16 * result["num_steps"] / result["elapsed_s"])
    out = capsys.readouterr().out
    assert "route: rhs_fn steps (--fused false)" in out
    assert f"16 trajectories x {result['num_steps']} RK4 steps (nx=128)" in out
    assert "warmup handoff at t0=0.1079" in out and "finite: 16/16" in out


def test_fused_true_on_cpu_takes_plain_version(jax_chain, capsys):
    """--fused true --device cpu runs the fused kernel's plain version
    (bf16-rounded tower, forcing by rotated phases from the warm-up's end):
    within 2e-3 of the JAX chain, the JAX package's bound for its kernel
    against a float32 tower (measured 6.6e-4: the trained Burgers model's
    steep fronts feel the bf16 rounding), and no kernel launch."""
    from pde_superresolution_torch.ops import fused_kernels as fk

    before = (fk.fused_learned_rk4.launches, fk.fused_rhs.launches)
    result = run_ensemble.main(ARGS + ["--fused", "true"])
    assert (fk.fused_learned_rk4.launches, fk.fused_rhs.launches) == before
    assert result["path"] == "fused kernel's plain version"
    assert _rel(result["final"].numpy(), jax_chain["final"]) < 2e-3
    assert "route: fused kernel's plain version (--fused true)" in capsys.readouterr().out


def test_auto_decides_from_device_and_shape(capsys):
    """--fused auto on the CPU takes the rhs_fn route and says why, before
    anything runs; on a CUDA device the same shapes take the kernel."""
    args = run_ensemble.build_parser().parse_args(ARGS)
    assert args.fused == "auto"
    ensemble = run_ensemble.setup(args)
    pack = ensemble.model.fused_rk4_fn(ensemble.params, 1e-3, 1, forcing=ensemble.forcing).pack
    assert run_ensemble.choose_route("auto", ensemble, pack) == (
        False, "auto: device is cpu")
    assert run_ensemble.choose_route("false", ensemble, pack) == (False, "--fused false")
    assert run_ensemble.choose_route("true", ensemble, pack) == (True, "--fused true")
    ensemble.model.device = torch.device("meta")  # any non-CUDA device
    assert run_ensemble.choose_route("auto", ensemble, pack)[1] == "auto: device is meta"
    result = run_ensemble.main(ARGS[:6] + ["--num_saves", "1", "--device", "cpu"])
    assert result["path"] == "rhs_fn steps" and result["t0"] == 0.0
    assert "route: rhs_fn steps (auto: device is cpu)" in capsys.readouterr().out


def test_defaults_match_the_jax_script():
    args = run_ensemble.build_parser().parse_args(["--checkpoint_dir", "ckpt_ks8"])
    assert (args.num_trajectories, args.time_max, args.warmup_time, args.seed,
            args.ic_scale, args.num_saves, args.fused, args.domain_factor, args.device) == (
        10240, 10.0, 0.0, 0, 1.0, 10, "auto", 1, None)
    assert (args.output_path, args.exported_dir) == (None, None)
    args = run_ensemble.build_parser().parse_args(["--exported_dir", "x", "--output_path", "y"])
    assert (args.checkpoint_dir, args.exported_dir, args.output_path) == (None, "x", "y")
    with pytest.raises(SystemExit):  # exactly one of --checkpoint_dir / --exported_dir
        run_ensemble.main([])


def test_domain_factor_builds_larger_grid():
    """--domain_factor 2: twice the period and points at the same dx, and
    wavenumber bands scaled so the physical wavelengths stay, as the JAX
    script builds them; the unforced KS model runs on it."""
    base = run_ensemble.setup(run_ensemble.build_parser().parse_args(ARGS))
    args = run_ensemble.build_parser().parse_args(ARGS + ["--domain_factor", "2"])
    wide = run_ensemble.setup(args)
    assert wide.coarse.size == 2 * base.coarse.size == 256
    assert wide.coarse.dx == pytest.approx(base.coarse.dx, rel=1e-15)
    assert wide.coarse.origin == pytest.approx(base.coarse.origin, rel=1e-12)
    assert wide.equation.period == 2 * base.equation.period
    assert (wide.equation.forcing_k_min, wide.equation.forcing_k_max,
            wide.equation.ic_k_min, wide.equation.ic_k_max) == (6, 12, 2, 6)
    assert wide.model.grid == wide.coarse and wide.u0.shape == (16, 256)
    assert float(wide.forcing.k.abs().min()) >= 6
    assert wide.model.stable_time_step(u_scale=3.0) == pytest.approx(
        base.model.stable_time_step(u_scale=3.0), rel=1e-6)
    result = run_ensemble.main(
        ["--checkpoint_dir", "ckpt_ks8", "--num_trajectories", "4", "--time_max", "0.02",
         "--warmup_time", "0.5", "--num_saves", "2", "--domain_factor", "2",
         "--fused", "true", "--device", "cpu"])
    assert result["nx"] == 256 and result["finite"] == 4 and result["t0"] == 0.5


def test_fused_true_raises_on_unsupported_shape():
    """At --domain_factor 6 one trajectory's 768 points with their 20-term
    phase state (160 bytes a point) and activations exceed a block's shared
    memory, which the kernel refused before its split form: now a cluster
    shares it, 3 blocks of 256 points and 2 warp groups each, as 5 such
    blocks share --domain_factor 10 (1280 points); at 3 (384 points) one
    block holds it. --fused true raises, before anything
    runs, only where no cluster of 16 blocks holds a trajectory:
    --domain_factor 89 (11,392 points, segments of 712)."""
    with pytest.raises(ValueError, match=(
            r"^--fused true, but the kernel cannot take this shape: needs \d+ bytes of "
            r"shared memory per block split over 16 blocks \(712 points each\) > the limit "
            r"of 232448$")):
        run_ensemble.main(ARGS + ["--fused", "true", "--domain_factor", "89"])
    parse = run_ensemble.build_parser().parse_args
    for factor, split, cluster in ((3, False, 1), (6, True, 3), (10, True, 5)):
        ensemble = run_ensemble.setup(parse(ARGS + ["--domain_factor", str(factor)]))
        pack = ensemble.model.fused_rk4_fn(ensemble.params, 1e-3, 1, forcing=ensemble.forcing).pack
        nx = ensemble.coarse.size
        assert nx == 128 * factor and fk.learned_rk4_refusal(pack, nx, 20) is None
        launch = fk.learned_rk4_launch(pack, nx, 20, 10240)
        assert (launch.split, launch.cluster, launch.stream) == (split, cluster, False)


def test_route_takes_the_kernel_at_domain_factor_10(monkeypatch):
    """--fused auto on a card whose blocks opt in to 232448 bytes of shared
    memory (the H100's) takes the kernel for the Burgers-8x checkpoint at
    --domain_factor 10 (1280 points), split over clusters of 5 blocks of 256
    points, 2 warp groups each, beside the whole weights, and says so; on a
    card that gave a block a third of that it would take 7 blocks of 2
    groups with the weights streamed a conv tap at a time (16 busy warps an
    SM against 12 for 10 blocks beside the whole weights); with less than
    the whole weights and a 16th of the grid, it streams them too; below
    what 16 blocks need, rhs_fn steps with the refusal's reason."""
    import types

    ensemble = run_ensemble.setup(run_ensemble.build_parser().parse_args(
        ARGS + ["--domain_factor", "10"]))
    pack = ensemble.model.fused_rk4_fn(ensemble.params, 1e-3, 1, forcing=ensemble.forcing).pack
    ensemble.model.device = torch.device("cuda")
    limit = {"optin": 232448}
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: types.SimpleNamespace(
        shared_memory_per_block_optin=limit["optin"]))
    launch = fk.learned_rk4_launch(pack, 1280, 20, 16)
    assert run_ensemble.choose_route("auto", ensemble, pack) == (True, (
        "auto: cuda, a trajectory split over clusters of 5 blocks of 256 points (80 blocks, "
        f"2 warp groups each), the weights and a segment in {launch.shared_bytes} bytes of "
        "shared memory per block fit"))
    limit["optin"] = 232448 // 3
    fused, reason = run_ensemble.choose_route("auto", ensemble, pack)
    assert fused and "clusters of 7 blocks of 183 points (112 blocks, 2 warp groups" in reason
    assert "a conv tap's weights at a time" in reason
    limit["optin"] = pack.blob.numel() + fk._team_bytes(pack, 1280 // 16, 20) - 1
    fused, reason = run_ensemble.choose_route("auto", ensemble, pack)
    assert fused and "a conv tap's weights at a time" in reason
    launch = fk.learned_rk4_launch(pack, 1280, 20, 16, shared_limit=limit["optin"])
    assert launch.stream and launch.cluster > 2
    limit["optin"] = 8192
    fused, reason = run_ensemble.choose_route("auto", ensemble, pack)
    assert not fused and reason.startswith("auto: needs ") and "split over 16 blocks" in reason


def test_route_takes_the_kernel_at_256_filters(monkeypatch, tmp_path):
    """--fused auto on a card whose blocks opt in to 232448 bytes of shared
    memory (the H100's) takes the kernel for the KS-8x checkpoint widened to
    256 filters (convert.widen_params), which it refused before ("256
    filters > kernel limit 128"): the chunked form, a cluster of one block
    per trajectory holding its 128 points (two 64-row tiles, one for each of
    its 2 warp groups) beside a ring of slices of the streamed weights,
    and says so; with less than one slot of that ring, its barriers and a
    16th of the grid, rhs_fn steps with the refusal's reason."""
    import json
    import types

    from pde_superresolution_torch import convert

    _, trained, config = convert.load_asset("ckpt_ks8", device="cpu")
    stem = tmp_path / "ks8_256_filters"
    stem.with_suffix(".json").write_text(
        json.dumps({**config, "model": {**config["model"], "filters": 256}}))
    np.savez(stem.with_suffix(".npz"),
             **convert.npz_arrays_from_params(convert.widen_params(trained, 256, 11, 0.02)))
    ensemble = run_ensemble.setup(run_ensemble.build_parser().parse_args(
        ["--checkpoint_dir", str(stem), "--num_trajectories", "16", "--device", "cpu"]))
    pack = ensemble.model.fused_rk4_fn(ensemble.params, 1e-3, 1).pack
    assert (pack.channels, pack.padded_channels) == (256, 256)
    ensemble.model.device = torch.device("cuda")
    limit = {"optin": 232448}
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: types.SimpleNamespace(
        shared_memory_per_block_optin=limit["optin"]))
    launch = fk.learned_rk4_launch(pack, 128, 0, 16)
    assert launch.split and launch.stream and (launch.cluster, launch.groups) == (1, 2)
    assert run_ensemble.choose_route("auto", ensemble, pack) == (True, (
        f"auto: cuda, a trajectory split over clusters of {launch.cluster} blocks of "
        f"{launch.segment} points ({16 * launch.cluster} blocks, {launch.groups} warp groups "
        f"each), a conv tap's weights at a time and a segment in {launch.shared_bytes} bytes "
        "of shared memory per block fit"))
    # the least a block of the ring takes: one slot, its barriers and a 16th
    # of the grid, one warp group
    limit["optin"] = fk._ring_bytes(pack, 128 // 16, 0, 1, 1) - 1
    fused, reason = run_ensemble.choose_route("auto", ensemble, pack)
    assert not fused and reason.startswith("auto: needs ") and "split over 16 blocks" in reason


def test_ic_scale_and_seed():
    parse = run_ensemble.build_parser().parse_args
    a = run_ensemble.setup(parse(ARGS))
    b = run_ensemble.setup(parse(ARGS + ["--ic_scale", "0.5"]))
    c = run_ensemble.setup(parse(ARGS[:-4] + ["--seed", "4", "--device", "cpu"]))
    torch.testing.assert_close(b.u0, 0.5 * a.u0, rtol=0, atol=0)
    assert float((a.u0 - c.u0).abs().max()) > 0.1
    again = run_ensemble.setup(parse(ARGS))
    torch.testing.assert_close(again.u0, a.u0, rtol=0, atol=0)
    torch.testing.assert_close(again.forcing.phi, a.forcing.phi, rtol=0, atol=0)
