"""The committed ckpt_ks8 asset and the converter against the JAX checkpoint."""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pde_superresolution_tpu.training.config import TrainingConfig
from pde_superresolution_tpu.training.loop import load_model
from pde_superresolution_torch import convert

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
