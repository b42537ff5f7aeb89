"""Write a JAX checkpoint's params and config as a PyTorch-port asset.

    python tools/export_jax_checkpoint.py artifacts/ckpt_ks8 \
        pde_superresolution_torch/assets/ckpt_ks8

loads the checkpoint through ``pde_superresolution_tpu.training.loop``
(orbax, on the CPU) and writes ``<out>.npz`` (the params tree, keys
``tower/<i>/w``, ``tower/<i>/b``, ``heads/<order>/w``, ``heads/<order>/b``,
float32, uncompressed) and ``<out>.json`` (the checkpoint's config dict as
stored in ``config/metadata``). The port reads them with
``pde_superresolution_torch.convert.load_asset`` and never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def checkpoint_config(checkpoint_dir: str) -> dict:
    """The latest step's ``config/metadata`` JSON, as stored."""
    steps = [int(s) for s in os.listdir(checkpoint_dir) if s.isdigit()]
    path = os.path.join(checkpoint_dir, str(max(steps)), "config", "metadata")
    with open(path) as f:
        return json.load(f)


def export(checkpoint_dir: str, out_stem: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pde_superresolution_tpu.training.loop import load_model

    _, params, _ = load_model(checkpoint_dir)
    arrays = {}
    for i, (w, b) in enumerate(params["tower"]):
        arrays[f"tower/{i}/w"] = np.asarray(w)
        arrays[f"tower/{i}/b"] = np.asarray(b)
    for name, (w, b) in params["heads"].items():
        arrays[f"heads/{name}/w"] = np.asarray(w)
        arrays[f"heads/{name}/b"] = np.asarray(b)
    np.savez(out_stem + ".npz", **arrays)
    with open(out_stem + ".json", "w") as f:
        json.dump(checkpoint_config(checkpoint_dir), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint_dir")
    parser.add_argument("out_stem")
    args = parser.parse_args()
    export(args.checkpoint_dir, args.out_stem)
