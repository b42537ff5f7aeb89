"""The port's integrators against the JAX package, and the slice as a whole:
the KS-8x checkpoint integrated with rhs_fn, port against JAX on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu import integrate as jint
from pde_superresolution_tpu.grids import Grid as JGrid
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq
from pde_superresolution_torch import integrate as tint
from pde_superresolution_torch.grids import Grid as TGrid

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _baseline_pair(name, cons):
    eq_j = jeq.from_name(name, conservative=cons)
    eq_t = teq.from_name(name, conservative=cons)
    grid_j = JGrid(64, eq_j.period)
    grid_t = TGrid(64, eq_t.period)
    rng = np.random.default_rng(4)
    x = grid_j.x
    u = np.stack([
        0.5 * np.sin(2 * np.pi * x / eq_j.period + rng.uniform(0, 6.3))
        + 0.3 * np.sin(4 * np.pi * x / eq_j.period + rng.uniform(0, 6.3))
        for _ in range(3)
    ]).astype(np.float32)
    rhs_j = jint.PolynomialDifferentiator(eq_j, grid_j).rhs_fn()
    rhs_t = tint.PolynomialDifferentiator(eq_t, grid_t, device="cpu").rhs_fn()
    return eq_j, grid_j, rhs_j, rhs_t, u


@pytest.mark.parametrize("method", ["rk4", "rk3_ssp"])
@pytest.mark.parametrize("name,cons", [("ks", True), ("kdv", False), ("burgers", True)])
def test_step_matches(method, name, cons):
    """One step of the classic baseline scheme: the same float32 elementwise
    operations in the same order, differing only in the tap sums' order, so
    rtol 1e-6 with atol 1e-6 x max|u|."""
    eq_j, grid_j, rhs_j, rhs_t, u = _baseline_pair(name, cons)
    dt = eq_j.stable_time_step(grid_j)
    want = np.asarray(jint.STEP_FUNCS[method](rhs_j, jnp.asarray(u), jnp.float32(0.1), dt))
    got = tint.STEP_FUNCS[method](rhs_t, torch.from_numpy(u), torch.tensor(0.1), dt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("save_every", [1, 5])
def test_integrate_matches(save_every):
    """integrate's times and trajectory over 10 steps of the KS baseline:
    rounding differences grow over the steps, so 1e-5 relative to max|u|;
    the times are the same float32 arithmetic (rtol 1e-6)."""
    eq_j, grid_j, rhs_j, rhs_t, u = _baseline_pair("ks", True)
    dt = eq_j.stable_time_step(grid_j)
    times_j, traj_j = jint.integrate(rhs_j, jnp.asarray(u), dt, 10, save_every, t0=0.5)
    times_t, traj_t = tint.integrate(rhs_t, torch.from_numpy(u), dt, 10, save_every,
                                     t0=0.5)
    assert traj_t.shape == traj_j.shape and times_t.shape == times_j.shape
    np.testing.assert_allclose(times_t.numpy(), np.asarray(times_j), rtol=1e-6)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(traj_j)).max())
    with pytest.raises(ValueError, match="divisible"):
        tint.integrate(rhs_t, torch.from_numpy(u), dt, 10, 3)


@pytest.fixture(scope="module")
def flagship():
    model_j, params_j, _ = load_model("artifacts/ckpt_ks8")
    model_t, params_t, _ = convert.load_asset("ckpt_ks8", device="cpu")
    rng = np.random.default_rng(13)
    x = model_j.grid.x
    u = np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / 64 + rng.uniform(0, 6.3))
            for k in (1, 2, 3))
        for _ in range(8)
    ]).astype(np.float32)
    dt = model_j.equation.stable_time_step(model_j.grid, u_scale=3.0)
    return model_j, params_j, model_t, params_t, u, dt


def test_flagship_rollout_matches(flagship):
    """The slice end to end: the KS-8x checkpoint, batch 8, 20 RK4 steps of
    integrate(rhs_fn) in the port (through the fused-RHS wrapper's plain
    version) against the JAX CPU path. Within 1e-5 relative to max|u|
    (float32 against float64 measured 1.3e-7)."""
    model_j, params_j, model_t, params_t, u, dt = flagship
    _, want = jint.integrate(model_j.rhs_fn(params_j, use_pallas=False),
                             jnp.asarray(u), dt, 20)
    want = np.asarray(want)
    _, got = tint.integrate(model_t.rhs_fn(params_t, use_kernel=True),
                            torch.from_numpy(u), dt, 20)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5


def test_integrate_fused_matches_integrate(flagship):
    """integrate_fused (one fused_rk4_fn advance per save interval) against
    integrate with rhs_fn: the fused path's tower is rounded to bf16, so
    4 steps agree to 2e-3 relative to max|u| (the JAX package's own bound for
    its kernel against a float32 tower); the times agree to 1e-6."""
    model_j, _, model_t, params_t, u, dt = flagship
    u0 = torch.from_numpy(u)
    want_times, want = tint.integrate(model_t.rhs_fn(params_t), u0, dt, 4, 2, t0=0.2)
    advance = model_t.fused_rk4_fn(params_t, dt, 2)
    got_times, got = tint.integrate_fused(advance, u0, dt, 4, 2, t0=0.2)
    torch.testing.assert_close(got_times, want_times, rtol=1e-6, atol=0)
    assert got.shape == want.shape == (3, 8, 128)
    assert float((got - want).abs().max() / want.abs().max()) < 2e-3


def test_import_needs_no_jax_and_no_nvcc(tmp_path):
    """Importing the package and every submodule (the training, evaluation,
    selection, export and parallel modules and the scripts included) loads
    neither jax, the JAX package, optax, orbax, h5py, matplotlib nor the
    JAX members tool (``tools/export_jax_members.py``), builds
    nothing (no nvcc on PATH, no CUDA_HOME) and starts no process group."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import pde_superresolution_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from pde_superresolution_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pde_superresolution_tpu', 'h5py', 'optax', 'orbax', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "assert 'export_jax_members' not in sys.modules\n"
        "assert _build.load_library.cache_info().currsize == 0\n"
        "assert _build.build.cache_info().currsize == 0\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "for n in ('scripts.run_ensemble', 'ops.spectral', 'ops.resample', 'analysis',\n"
        "          'training.loop', 'training.data', 'training.losses', 'training.config',\n"
        "          'utils.metrics', 'utils.tb_events', 'scripts.run_training', 'evaluate',\n"
        "          'weno', 'scripts.run_evaluation', 'training.selection',\n"
        "          'scripts.run_select', 'scripts.run_sweep', 'export', 'scripts.run_export',\n"
        "          'scripts.create_training_data', 'scripts.run_analysis',\n"
        "          'parallel.mesh', 'parallel.halo', 'parallel.sharded', 'bench',\n"
        "          'utils.profiling', 'utils.debugging', 'scripts.probe_zoo'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # an empty directory: no nvcc anywhere
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 41
