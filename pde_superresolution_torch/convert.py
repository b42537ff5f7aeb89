"""Checkpoint conversion: JAX-layout parameters -> this package's state dict.

The JAX package keeps its parameters as a pytree
``{"tower": [(w [K, Cin, Co], b [Co]), ...], "heads": {"<order>": (w [1, C,
free], b [free])}}``; ``params_from_jax`` takes that tree with numpy leaves
and imports no JAX. The committed assets under ``assets/`` hold a trained
checkpoint's tree as ``.npz`` (keys ``tower/<i>/w``, ``heads/<order>/b``, ...)
beside its config in the JSON layout of a checkpoint's ``config/metadata``;
``tools/export_jax_checkpoint.py`` writes them from an orbax checkpoint.
``load_checkpoint`` is the one loader of the entry points: a training
checkpoint directory written by ``training.loop`` or an asset. A JAX
checkpoint directory is refused with the tool's name: the port reads no
orbax checkpoint, and falls back to a committed asset only for a bare name.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import from_name
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models.stencil_net import ModelConfig, StencilModel

ASSET_DIR = Path(__file__).resolve().parent / "assets"


def params_from_jax(tree: Mapping, device=None) -> dict[str, torch.Tensor]:
    """The port's state dict from a JAX params tree with numpy leaves.

    Conv weights go from ``[K, Cin, Co]`` to ``[Co, Cin, K]``; both
    frameworks compute cross-correlation, so no flip is needed.
    """
    device = resolve_device(device)

    def conv(w):
        return torch.from_numpy(np.array(np.transpose(np.asarray(w), (2, 1, 0)), order="C"))

    state = {}
    for i, (w, b) in enumerate(tree["tower"]):
        state[f"tower.{i}.weight"] = conv(w)
        state[f"tower.{i}.bias"] = torch.from_numpy(np.array(b))
    for name, (w, b) in tree["heads"].items():
        state[f"heads.{name}.weight"] = conv(w)
        state[f"heads.{name}.bias"] = torch.from_numpy(np.array(b))
    return {k: v.to(device) for k, v in state.items()}


def npz_arrays_from_params(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``, as the asset ``.npz`` keys
    (``tower/<i>/w`` [K, Cin, Co], ``heads/<order>/b``, ...): float32 numpy
    on the host, bit for bit the state dict's values."""
    arrays = {}
    for name, value in params.items():
        kind, key, leaf = name.split(".")
        value = value.detach().cpu().numpy()
        if leaf == "weight":
            value = np.ascontiguousarray(np.transpose(value, (2, 1, 0)))
        arrays[f"{kind}/{key}/{'w' if leaf == 'weight' else 'b'}"] = value
    return arrays


def widen_params(params: Mapping[str, torch.Tensor], filters: int, seed: int,
                 noise: float) -> dict[str, torch.Tensor]:
    """A tower model's state dict at ``filters`` channels: its own values in
    the leading corner of each tensor, every new entry (new channels, and
    every weight from or to them) drawn from N(0, noise^2) with a
    ``torch.Generator`` seeded ``seed``. A trained model so widened stays
    about as stable as it was while every channel carries signal, which a
    tower seeded from scratch at that width does not promise."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, value in params.items():
        shape = list(value.shape)
        if key.startswith("tower."):
            shape[0] = filters
            if value.dim() == 3 and not key.startswith("tower.0."):
                shape[1] = filters
        elif key.endswith(".weight"):  # heads [F_d, C, 1]
            shape[1] = filters
        wide = (noise * torch.randn(shape, generator=gen)).to(value.device, value.dtype)
        wide[tuple(slice(n) for n in value.shape)] = value
        out[key] = wide
    return out


def jax_tree_from_npz(path) -> dict:
    """Read an asset ``.npz`` back into the JAX params tree layout."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    n_layers = len({k.split("/")[1] for k in arrays if k.startswith("tower/")})
    heads = sorted({k.split("/")[1] for k in arrays if k.startswith("heads/")})
    return {
        "tower": [
            (arrays[f"tower/{i}/w"], arrays[f"tower/{i}/b"]) for i in range(n_layers)
        ],
        "heads": {d: (arrays[f"heads/{d}/w"], arrays[f"heads/{d}/b"]) for d in heads},
    }


def model_from_config(config: Mapping, device=None) -> StencilModel:
    """The model a checkpoint config (``config/metadata`` JSON layout)
    describes: equation, coarse grid and ``ModelConfig``."""
    equation = from_name(
        config["equation"],
        conservative=config["conservative"],
        **config.get("equation_params", {}),
    )
    fine = Grid(config["fine_size"], equation.period)
    coarse = fine.resample(config["resample_factor"], conservative=config["conservative"])
    return StencilModel(equation, coarse, ModelConfig(**config["model"]), device=device)


def asset_names() -> list[str]:
    """The committed assets: the JAX package's model zoo under
    ``artifacts/``, each at its checkpoint's latest step (``ckpt_ks8``,
    ``ckpt_ks8_u16s8``, ``ckpt_ks16``, ``ckpt_ks32``, ``ks32_select_seed0``
    from ``r5_ks32_select/seed0``, ``ckpt_kdv8``, ``ckpt_kdv16``,
    ``ckpt_kdv16_f64``, ``kdv16_select_seed7`` from
    ``r5_kdv16_select/seed7``, ``ckpt_burgers8``, ``ckpt_burgers64``)."""
    return sorted(p.stem for p in ASSET_DIR.glob("*.npz"))


def _is_bare_name(name: str) -> bool:
    """A name with no directory part that is no existing path: the only
    kind of reference that may fall back to a committed asset."""
    return os.sep not in name and "/" not in name and not Path(name).exists()


def _orbax_steps(path) -> list[int]:
    """The steps of a JAX package's (orbax) checkpoint directory, sorted:
    numeric subdirectories holding ``_CHECKPOINT_METADATA`` and
    ``config/metadata``."""
    path = Path(path)
    if not path.is_dir():
        return []
    return sorted(
        int(step.name) for step in path.iterdir()
        if step.name.isdigit() and (step / "_CHECKPOINT_METADATA").is_file()
        and (step / "config" / "metadata").is_file()
    )


def _refuse_path(path: Path):
    """Raise for an existing path that is no ``.npz``/``.json`` pair: a JAX
    checkpoint directory is named as such, with the conversion tool and
    any committed asset whose config equals its latest step's (plain JSON,
    read without JAX; equal configs need not mean equal weights, so the
    asset is never loaded in its place)."""
    steps = _orbax_steps(path)
    if not steps:
        raise ValueError(
            f"{path} is neither a training checkpoint directory of this package "
            "(step subdirectories with state.json) nor a .npz/.json pair"
        )
    config = json.loads((path / str(steps[-1]) / "config" / "metadata").read_text())
    same = [name for name in asset_names()
            if json.loads((ASSET_DIR / f"{name}.json").read_text()) == config]
    hint = ""
    if same:
        hint = (f"; the committed asset {' and '.join(same)} has the config of its step "
                f"{steps[-1]}: pass that bare name if it holds these weights")
    raise ValueError(
        f"{path} is a JAX (orbax) checkpoint directory, which this package does not read: "
        "write its latest step as a .npz/.json pair with "
        f"`python tools/export_jax_checkpoint.py {path} <stem>` and pass the stem{hint}"
    )


def load_asset(name: str = "ckpt_ks8", device=None):
    """(model, params, config) from ``<stem>.npz`` and ``<stem>.json``.

    ``name`` is a committed asset's bare name (``ckpt_ks32``, also with a
    ``.npz``/``.json`` suffix: ``assets/<name>``, unless the working
    directory holds such a pair) or the path stem of a pair written by
    ``tools/export_jax_checkpoint.py`` (with or without a suffix). Any
    other existing path raises ``ValueError`` naming it, a JAX checkpoint
    directory with the tool's command line.
    """
    name = str(name)
    stem = Path(name)
    if stem.suffix in (".npz", ".json"):
        stem = stem.with_suffix("")
    if _is_bare_name(name) and not stem.with_suffix(".npz").is_file():
        stem = ASSET_DIR / stem.name
    npz, config_path = stem.with_suffix(".npz"), stem.with_suffix(".json")
    if not (npz.is_file() and config_path.is_file()):
        if npz.is_file() or config_path.is_file():
            missing = config_path if npz.is_file() else npz
            raise FileNotFoundError(f"{name}: {missing} is missing (a pair is {stem}.npz "
                                    "and .json)")
        if Path(name).exists():
            _refuse_path(Path(name))
        raise FileNotFoundError(
            f"no asset {name!r}: expected {stem}.npz and .json; committed "
            f"assets: {asset_names()}"
        )
    config = json.loads(config_path.read_text())
    model = model_from_config(config, device=device)
    params = params_from_jax(jax_tree_from_npz(npz), device)
    return model, params, config


def load_checkpoint(path, device=None):
    """(model, params, ``TrainingConfig``) from ``path``, for every entry point.

    ``path`` is a training checkpoint directory (step subdirectories written
    by ``training.loop``; the latest step is loaded by ``loop.load_model``)
    or what ``load_asset`` takes: a committed asset's bare name or the path
    stem of an exported ``.npz``/``.json`` pair, whose JSON is a stored
    ``TrainingConfig``. A JAX package's checkpoint directory, or any other
    existing path, raises ``ValueError`` naming it (``load_asset``).
    """
    # imported here: training.loop imports this module
    from pde_superresolution_torch.training import loop
    from pde_superresolution_torch.training.config import TrainingConfig

    if loop.checkpoint_steps(str(path)):
        return loop.load_model(str(path), device=device)
    model, params, config = load_asset(str(path), device=device)
    return model, params, TrainingConfig.from_json(json.dumps(config))
