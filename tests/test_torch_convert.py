"""The committed assets and the converter against the JAX checkpoints."""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pde_superresolution_tpu import equations as jeq
from pde_superresolution_tpu.training.config import TrainingConfig
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import convert
from pde_superresolution_torch import equations as teq

torch.set_num_threads(1)

CKPT = "artifacts/ckpt_ks8"


@pytest.fixture(scope="module")
def jax_checkpoint():
    return load_model(CKPT)


def test_asset_params_bit_equal(jax_checkpoint):
    _, params, _ = jax_checkpoint
    tree = convert.jax_tree_from_npz(convert.ASSET_DIR / "ckpt_ks8.npz")
    assert len(tree["tower"]) == len(params["tower"]) == 3
    for (w_a, b_a), (w_j, b_j) in zip(tree["tower"], params["tower"]):
        np.testing.assert_array_equal(w_a, np.asarray(w_j))
        np.testing.assert_array_equal(b_a, np.asarray(b_j))
        assert w_a.dtype == np.float32
    assert sorted(tree["heads"]) == sorted(params["heads"]) == ["0", "1", "3"]
    for d, (w_j, b_j) in params["heads"].items():
        np.testing.assert_array_equal(tree["heads"][d][0], np.asarray(w_j))
        np.testing.assert_array_equal(tree["heads"][d][1], np.asarray(b_j))


def test_asset_config_equal(jax_checkpoint):
    _, _, config = jax_checkpoint
    asset = json.loads((convert.ASSET_DIR / "ckpt_ks8.json").read_text())
    with open(f"{CKPT}/3000/config/metadata") as f:
        assert asset == json.load(f)
    assert TrainingConfig.from_json(json.dumps(asset)) == config


def test_params_from_jax_layout_and_coefficients(jax_checkpoint):
    """The converted state dict has torch's [Co, Cin, K] layout, and the
    port's model built from the asset's config predicts the JAX model's
    coefficients: float32 convs and projection in other summation orders,
    so 1e-5 of each order's largest coefficient."""
    model_j, params_j, _ = jax_checkpoint
    model_t, params_t, _ = convert.load_asset("ckpt_ks8", device="cpu")
    assert params_t["tower.0.weight"].shape == (32, 1, 5)
    assert params_t["tower.1.weight"].shape == (32, 32, 5)
    assert params_t["heads.0.weight"].shape == (4, 32, 1)
    w_j = np.asarray(params_j["tower"][1][0])
    np.testing.assert_array_equal(params_t["tower.1.weight"][3, 7, 2].item(), w_j[2, 7, 3])
    assert (model_t.grid.size, model_t.grid.origin, model_t.grid.dx) == (
        model_j.grid.size, model_j.grid.origin, model_j.grid.dx)
    assert model_t.config.stencil_size == 6 and model_t.equation.conservative
    u = np.random.default_rng(3).standard_normal((4, 128)).astype(np.float32)
    want = model_j.coefficients(params_j, jnp.asarray(u))
    got = model_t.coefficients(params_t, torch.from_numpy(u))
    for d in want:
        w = np.asarray(want[d])
        np.testing.assert_allclose(got[d].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


NEW_ASSETS = [("ckpt_burgers8", 2000, ["0", "1"]), ("ckpt_kdv8", 2000, ["0", "2"]),
              ("ckpt_ks8_u16s8", 3000, ["0", "1", "3"]), ("ckpt_ks16", 3000, ["0", "1", "3"]),
              ("ckpt_ks32", 3000, ["0", "1", "3"]), ("ckpt_kdv16", 2000, ["0", "2"]),
              ("ckpt_kdv16_f64", 2000, ["0", "2"]), ("kdv16_select_seed7", 2000, ["0", "2"]),
              ("ckpt_burgers64", 4000, ["0", "1"]), ("ks32_select_seed0", 3000, ["0", "1", "3"])]
# the checkpoint directory of an asset named otherwise
CHECKPOINT_DIRS = {"kdv16_select_seed7": "artifacts/r5_kdv16_select/seed7",
                   "ks32_select_seed0": "artifacts/r5_ks32_select/seed0"}
# (stencil size, coarsening factor, filters) of each asset's model
SHAPES = {"ckpt_burgers8": (8, 8, 32), "ckpt_kdv8": (8, 8, 32), "ckpt_ks8_u16s8": (8, 8, 32),
          "ckpt_ks16": (8, 16, 32), "ckpt_ks32": (10, 32, 32), "ckpt_kdv16": (10, 16, 32),
          "ckpt_kdv16_f64": (10, 16, 64), "kdv16_select_seed7": (10, 16, 32),
          "ckpt_burgers64": (8, 64, 32), "ks32_select_seed0": (10, 32, 32)}


def _checkpoint_dir(name):
    return CHECKPOINT_DIRS.get(name, f"artifacts/{name}")


@pytest.mark.parametrize("name,step,heads", NEW_ASSETS)
def test_new_asset_equals_checkpoint(name, step, heads):
    """Each asset beside ckpt_ks8 (the JAX package's model zoo) holds its
    checkpoint's latest step: params bit-equal, config equal to the stored
    metadata."""
    _, params, config = load_model(_checkpoint_dir(name))
    tree = convert.jax_tree_from_npz(convert.ASSET_DIR / f"{name}.npz")
    assert sorted(tree["heads"]) == sorted(params["heads"]) == heads
    for (w_a, b_a), (w_j, b_j) in zip(tree["tower"], params["tower"]):
        np.testing.assert_array_equal(w_a, np.asarray(w_j))
        np.testing.assert_array_equal(b_a, np.asarray(b_j))
    for d, (w_j, b_j) in params["heads"].items():
        np.testing.assert_array_equal(tree["heads"][d][0], np.asarray(w_j))
        np.testing.assert_array_equal(tree["heads"][d][1], np.asarray(b_j))
    asset = json.loads((convert.ASSET_DIR / f"{name}.json").read_text())
    with open(f"{_checkpoint_dir(name)}/{step}/config/metadata") as f:
        assert asset == json.load(f)
    assert TrainingConfig.from_json(json.dumps(asset)) == config
    assert name in convert.asset_names()


@pytest.mark.parametrize("name,step,heads", NEW_ASSETS)
def test_new_asset_rhs_matches_jax(name, step, heads):
    """The asset's model (conservative; stencil 8 or 10; 1024 or 512 points
    coarsened 8 to 64 times, down to 16 points) against
    training.loop.load_model on a seeded state, with the same numpy forcing
    at t = 2.5 for Burgers: float32 convolutions, projection and tap sums in
    other orders, then a face difference over dx, so 1e-5 of max|u_t|
    (measured 1.7e-6 and 1.5e-6 at 8x). Where float32 itself cannot reach
    that, the limit is twice JAX's own float32 distance from the same model
    in float64 (jax.enable_x64): KS at 8x with 8 taps, whose third-derivative
    taps of order dx^-3 cancel in the face difference, reads 1.1e-4 there,
    and the port 6.1e-5 from JAX."""
    model_j, params_j, _ = load_model(_checkpoint_dir(name))
    model_t, params_t, config = convert.load_asset(name, device="cpu")
    stencil, factor, filters = SHAPES[name]
    assert model_t.config.stencil_size == stencil and model_t.equation.conservative
    assert model_t.config.filters == filters and config["resample_factor"] == factor
    assert model_t.grid.size == config["fine_size"] // factor == model_j.grid.size
    assert model_t.equation == type(model_t.equation)(
        conservative=True, **config["equation_params"])
    rng = np.random.default_rng(5)
    x = model_j.grid.x
    u = np.stack([
        sum(rng.uniform(-1, 1) * np.sin(2 * np.pi * k * x / model_j.equation.period
                                        + rng.uniform(0, 2 * np.pi)) for k in (1, 2, 3))
        for _ in range(4)
    ]).astype(np.float32)
    forcing_j = forcing_t = None
    if model_j.equation.forced:
        shape = (4, 20)
        leaves = [
            rng.uniform(-0.5, 0.5, shape), rng.uniform(-0.4, 0.4, shape),
            rng.integers(3, 7, shape) * rng.choice([-1.0, 1.0], shape),
            rng.uniform(0, 2 * np.pi, shape),
        ]
        leaves = [a.astype(np.float32) for a in leaves]
        forcing_j = jeq.ForcingParams(*(jnp.asarray(a) for a in leaves))
        forcing_t = teq.ForcingParams(*(torch.from_numpy(a) for a in leaves))
    want = np.asarray(model_j.rhs_fn(params_j, forcing_j, use_pallas=False)(
        jnp.asarray(u), jnp.float32(2.5)))
    got = model_t.rhs_fn(params_t, forcing_t, use_kernel=True)(
        torch.from_numpy(u), torch.tensor(2.5)).numpy()
    with jax.enable_x64():
        wide = lambda tree: jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)
        exact = np.asarray(model_j.rhs_fn(wide(params_j), wide(forcing_j), use_pallas=False)(
            jnp.asarray(u, jnp.float64), jnp.float64(2.5)))
    assert exact.dtype == np.float64
    limit = max(1e-5, 2 * np.abs(want - exact).max() / np.abs(exact).max())
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < limit, (err, limit)


def test_load_asset_by_path_stem_and_unknown(tmp_path):
    """load_asset takes a committed asset's name or the path stem of a
    .npz/.json pair, with or without a suffix; equation_params reach the
    equation; a name that is neither raises with the list of assets."""
    import shutil

    config = json.loads((convert.ASSET_DIR / "ckpt_burgers8.json").read_text())
    config["equation_params"] = {"eta": 0.02}
    (tmp_path / "mine.json").write_text(json.dumps(config))
    shutil.copy(convert.ASSET_DIR / "ckpt_burgers8.npz", tmp_path / "mine.npz")
    for ref in (tmp_path / "mine", tmp_path / "mine.npz", tmp_path / "mine.json"):
        model, params, loaded = convert.load_asset(str(ref), device="cpu")
        assert model.equation.eta == 0.02 and loaded == config
        assert params["tower.1.weight"].shape == (32, 32, 5)
    with pytest.raises(FileNotFoundError, match="ckpt_ks8"):
        convert.load_asset("ckpt_nothing", device="cpu")


# -- what --checkpoint_dir takes: a JAX checkpoint directory is refused ------------------

TOOL = "tools/export_jax_checkpoint.py"


def _jax_copy(tmp_path, source, name):
    """A copy of the JAX checkpoint directory ``source`` named ``name``."""
    import shutil

    return shutil.copytree(source, tmp_path / name)


def test_jax_directory_named_as_an_asset_is_refused(tmp_path):
    """The KdV-8x JAX checkpoint copied under the KS-8x asset's name is
    refused by ``load_checkpoint`` and by ``run_ensemble --checkpoint_dir``,
    naming the conversion tool and the asset whose config equals its latest
    step's (``ckpt_kdv8``), never serving ``ckpt_ks8`` in its place (as the
    loader did before: a path's last part fell back to the committed
    asset of that name)."""
    from pde_superresolution_torch.scripts import run_ensemble

    path = _jax_copy(tmp_path, "artifacts/ckpt_kdv8", "ckpt_ks8")
    message = f"{path} is a JAX .*{TOOL}.*ckpt_kdv8"
    with pytest.raises(ValueError, match=message):
        convert.load_checkpoint(str(path), device="cpu")
    with pytest.raises(ValueError, match=message):
        run_ensemble.main(["--checkpoint_dir", str(path), "--num_trajectories", "4",
                           "--time_max", "0.05", "--warmup_time", "0.1", "--num_saves", "2",
                           "--device", "cpu"])


@pytest.mark.parametrize("source", ["artifacts/ckpt_ks32", "artifacts/r5_ks32_select/seed0"])
def test_committed_jax_directory_asks_for_the_bare_name(source):
    """A committed JAX checkpoint given by its path is refused, naming the
    asset converted from it; the bare name loads that asset."""
    asset = {"artifacts/ckpt_ks32": "ckpt_ks32",
             "artifacts/r5_ks32_select/seed0": "ks32_select_seed0"}[source]
    with pytest.raises(ValueError, match=f"{TOOL}.*the committed asset {asset} has"):
        convert.load_checkpoint(source, device="cpu")
    assert convert.load_checkpoint(asset, device="cpu")[2].resample_factor == 32


def test_jax_directory_without_a_matching_asset_is_refused(tmp_path):
    """A JAX checkpoint whose latest config is no committed asset's (here
    the KdV-8x one with another seed) is refused naming the tool only; its
    own name, a committed asset's, does not make it load."""
    path = _jax_copy(tmp_path, "artifacts/ckpt_kdv8", "ckpt_kdv8")
    metadata = path / "2000" / "config" / "metadata"
    config = json.loads(metadata.read_text())
    config["seed"] = 99
    metadata.write_text(json.dumps(config))
    with pytest.raises(ValueError, match=f"JAX .*{TOOL}") as raised:
        convert.load_checkpoint(str(path), device="cpu")
    assert "committed asset" not in str(raised.value)


def test_other_paths_and_half_pairs_are_refused(tmp_path):
    """An existing path that is no pair and no training directory is refused
    naming it; a pair with one half missing names the missing file; a bare
    name that does not exist lists the assets."""
    import shutil

    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match=f"{tmp_path / 'empty'} is neither a training"):
        convert.load_checkpoint(str(tmp_path / "empty"), device="cpu")
    shutil.copy(convert.ASSET_DIR / "ckpt_burgers8.npz", tmp_path / "half.npz")
    shutil.copy(convert.ASSET_DIR / "ckpt_burgers8.json", tmp_path / "other.json")
    for ref, missing in ((tmp_path / "half", "half.json"), (tmp_path / "half.npz", "half.json"),
                         (tmp_path / "other.json", "other.npz")):
        with pytest.raises(FileNotFoundError, match=f"{tmp_path / missing} is missing"):
            convert.load_checkpoint(str(ref), device="cpu")
    with pytest.raises(FileNotFoundError, match="committed assets: .*ks32_select_seed0"):
        convert.load_checkpoint("ckpt_nothing", device="cpu")


@pytest.mark.parametrize("ref", ["ckpt_ks32", "ckpt_ks32.npz", "ckpt_ks32.json"])
def test_bare_names_load_the_asset(ref, tmp_path, monkeypatch):
    """A bare name (no directory part, no existing path) loads the committed
    asset, with or without a suffix, from any working directory; where the
    working directory holds a JAX checkpoint of that name, the name is a
    path and is refused."""
    monkeypatch.chdir(tmp_path)
    model, params, config = convert.load_checkpoint(ref, device="cpu")
    want = convert.params_from_jax(
        convert.jax_tree_from_npz(convert.ASSET_DIR / "ckpt_ks32.npz"), device="cpu")
    assert config.resample_factor == 32 and model.config.stencil_size == 10
    assert all(torch.equal(params[k], want[k]) for k in want)
    _jax_copy(tmp_path, convert.ASSET_DIR.parents[1] / "artifacts" / "ckpt_kdv8", "ckpt_ks32")
    if ref == "ckpt_ks32":
        with pytest.raises(ValueError, match="ckpt_ks32 is a JAX .*ckpt_kdv8"):
            convert.load_checkpoint(ref, device="cpu")
