"""Write the JAX package's evaluation members for the zoo's eval keys.

    python tools/export_jax_members.py [out_dir]

For each (equation, fine grid, eval key) that
``pde_superresolution_torch.scripts.probe_zoo.ZOO`` evaluates, this draws
what the JAX package's ``evaluate`` draws from that key for 32 members,
with JAX on the CPU: ``k_ic, k_f = jax.random.split(key)``, then
``initial_conditions(k_ic, fine_grid, (32,))`` before ``ic_scale`` and, for
a forced equation, ``sample_forcing(k_f, (32,))``. It writes one
compressed ``<equation>_<fine size>.npz`` per equation and grid under
``out_dir`` (default ``pde_superresolution_torch/assets/members``), float32
arrays keyed ``u0/<key>`` and ``amplitude/<key>``, ``omega/<key>``,
``k/<key>``, ``phi/<key>``. ``probe_zoo --members jax`` evaluates the port
on them; the port reads the files with numpy and never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

MEMBERS = 32
DEFAULT_OUT = os.path.join("pde_superresolution_torch", "assets", "members")


def draw(equation, fine_grid, key: int, members: int = MEMBERS) -> dict:
    """The arrays JAX's ``evaluate`` draws from ``PRNGKey(key)``, by name."""
    import jax

    k_ic, k_f = jax.random.split(jax.random.PRNGKey(key))
    arrays = {"u0": np.asarray(equation.initial_conditions(k_ic, fine_grid, (members,)))}
    forcing = equation.sample_forcing(k_f, (members,))
    if forcing is not None:
        arrays.update({name: np.asarray(leaf) for name, leaf in forcing._asdict().items()})
    return {name: a.astype(np.float32) for name, a in arrays.items()}


def zoo_draws(members: int = MEMBERS) -> dict:
    """{file stem: {"<array>/<key>": float32 array}} for every eval key of
    ``probe_zoo.ZOO``; raises if two models that share a file draw
    differently (their equations' parameters differ)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pde_superresolution_tpu import equations
    from pde_superresolution_tpu.grids import Grid
    from pde_superresolution_torch import convert
    from pde_superresolution_torch.scripts import probe_zoo

    files: dict = {}
    for name, seeds, _ in probe_zoo.ZOO:
        config = json.loads((convert.ASSET_DIR / f"{name}.json").read_text())
        equation = equations.from_name(config["equation"], conservative=config["conservative"],
                                       **config.get("equation_params", {}))
        fine = Grid(config["fine_size"], equation.period)
        arrays = files.setdefault(probe_zoo.members_stem(config), {})
        for key in (int(s) for s in seeds.split(",")):
            for array, value in draw(equation, fine, key, members).items():
                entry = f"{array}/{key}"
                if entry in arrays and not np.array_equal(arrays[entry], value):
                    raise ValueError(f"{name}: key {key} draws other {array} than an earlier "
                                     "model of the same file")
                arrays[entry] = value
    return files


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", nargs="?", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for stem, arrays in sorted(zoo_draws().items()):
        path = os.path.join(args.out_dir, f"{stem}.npz")
        np.savez_compressed(path, **arrays)
        print(f"{path}: {sorted(arrays)}")


if __name__ == "__main__":
    main()
