"""Evaluate the committed model zoo at the protocol of the JAX package's results.

    python -m pde_superresolution_torch.scripts.probe_zoo

Runs ``run_evaluation.evaluate_checkpoint`` (everything ``run_evaluation``
does but the HDF5 write) for each committed zoo model at the multi-key
protocol its published numbers use (RESULTS.md, "The full zoo under the
multi-key convention"): 32 members per eval key, the keys pooled; KS keys
0, 1 and 54321 with a warm-up of 44 and a horizon of 50; KdV keys 0, 1 and
2 (12345, 1 and 2 for ``ckpt_kdv16_f64``, sampled every 0.05) at ic_scale
0.5 to a horizon of 10; Burgers keys 0, 1 and 2 to a horizon of 3. The
model, the matched-width classic baseline and, for Burgers, WENO5 are
integrated from the same members; there is no reference cache. Prints, per
model, one JSON line: the pooled final-MAE median, survival median and
mean and diverged count of each scheme, the per-key survival medians, the
seconds by layer (fine solve, each scheme; host clock after a synchronize)
and the ``fused_rhs`` launches, then the card's ``nvidia-smi`` line. With
``--members jax`` a row also holds, per key, each member's survival time
under the model and the closest its correlation comes to 0.8
(``member_margins``): the members that can flip a median.

By default (``--members port``) the port draws its members from
``torch.Generator`` keys, so they are not the JAX package's members of the
same key number: the comparison with the published numbers is then
statistical. ``--members jax`` evaluates the JAX package's own members of
each key instead (``JaxMembers``: the committed draws under
``assets/members/``, written by ``tools/export_jax_members.py``), so the
KdV and Burgers rows compare member by member. ``--models`` picks a
subset; ``--num_samples`` (with ``--members jax`` the first that many of
the 32 committed members) and ``--max_horizon`` shrink a run for a
rehearsal on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# (asset, eval keys, run_evaluation flags): RESULTS.md's protocol per model
ZOO = (
    ("ckpt_ks8_u16s8", "0,1,54321", ["--time_max", "50", "--warmup_time", "44"]),
    ("ckpt_ks16", "0,1,54321", ["--time_max", "50", "--warmup_time", "44"]),
    ("ckpt_ks32", "0,1,54321", ["--time_max", "50", "--warmup_time", "44"]),
    ("ks32_select_seed0", "0,1,54321", ["--time_max", "50", "--warmup_time", "44"]),
    ("ckpt_kdv8", "0,1,2", ["--time_max", "10", "--ic_scale", "0.5"]),
    ("ckpt_kdv16", "0,1,2", ["--time_max", "10", "--ic_scale", "0.5"]),
    ("ckpt_kdv16_f64", "12345,1,2",
     ["--time_max", "10", "--ic_scale", "0.5", "--time_delta", "0.05"]),
    ("kdv16_select_seed7", "0,1,2", ["--time_max", "10", "--ic_scale", "0.5"]),
    ("ckpt_burgers8", "0,1,2", ["--time_max", "3"]),
    ("ckpt_burgers64", "0,1,2", ["--time_max", "3"]),
)


def members_dir():
    """Where the JAX package's committed members lie (``assets/members``)."""
    from pde_superresolution_torch import convert

    return convert.ASSET_DIR / "members"


def members_stem(config) -> str:
    """The members file of a checkpoint config: one per equation and fine
    grid (``ks_1024``, ``kdv_512``, ``burgers_1024``)."""
    return f"{config['equation']}_{config['fine_size']}"


class JaxMembers:
    """While entered, ``evaluate`` draws the JAX package's members: its
    ``_draw`` is replaced by one that returns, for the eval key its
    generator was seeded with (``torch.Generator().manual_seed(key)``, as
    ``run_evaluation`` seeds it), the first ``num_samples`` of the 32
    members JAX's ``evaluate`` draws from ``PRNGKey(key)`` (the initial
    conditions times ``ic_scale``, and the forcing), from the committed
    file of the model's equation and fine grid. Raises ``ValueError``
    naming the model where a key has no committed draw."""

    def __init__(self, name: str, seeds):
        from pde_superresolution_torch import convert

        config = json.loads((convert.ASSET_DIR / f"{name}.json").read_text())
        self.fine_size = config["fine_size"]
        path = members_dir() / f"{members_stem(config)}.npz"
        self.arrays = {}
        if path.is_file():
            with np.load(path) as data:
                self.arrays = {k: data[k] for k in data.files}
        missing = [seed for seed in seeds if f"u0/{seed}" not in self.arrays]
        if missing:
            raise ValueError(f"{name}: no committed JAX members for eval keys {missing} "
                             f"in {path} (tools/export_jax_members.py writes them)")

    def draw(self, equation, fine_grid, generator, num_samples, ic_scale, device):
        """``evaluate._draw``'s signature and results, on JAX's members."""
        from pde_superresolution_torch.equations import ForcingParams

        key = generator.initial_seed()
        u0 = self.arrays[f"u0/{key}"]
        if fine_grid.size != self.fine_size or num_samples > len(u0):
            raise ValueError(f"JAX members of key {key}: {len(u0)} on {self.fine_size} "
                             f"points, asked for {num_samples} on {fine_grid.size}")
        take = lambda a: torch.from_numpy(a[:num_samples]).to(device)
        forcing = None
        if equation.forced:
            forcing = ForcingParams(*(take(self.arrays[f"{leaf}/{key}"])
                                      for leaf in ForcingParams._fields))
        return ic_scale * take(u0), forcing

    def __enter__(self):
        from pde_superresolution_torch import evaluate

        self._real = evaluate._draw
        evaluate._draw = self.draw
        return self

    def __exit__(self, *exc):
        from pde_superresolution_torch import evaluate

        evaluate._draw = self._real


class LayerTimes:
    """Host seconds (after a synchronize) of each exact fine solve and each
    scheme's integration inside ``evaluate``, recorded while it is entered:
    ``integrate.exact_solve_sampled`` and ``integrate.integrate`` are
    wrapped for that time (evaluate runs the schemes in their dict's
    order)."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        from pde_superresolution_torch import integrate

        self._real = (integrate.exact_solve_sampled, integrate.integrate)

        def sync():
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()

        def timed(fn, kind):
            def run(*args, **kwargs):
                sync()
                start = time.perf_counter()
                out = fn(*args, **kwargs)
                sync()
                self.records.append((kind, time.perf_counter() - start))
                return out
            return run

        integrate.exact_solve_sampled = timed(self._real[0], "exact")
        integrate.integrate = timed(self._real[1], "scheme")
        return self

    def __exit__(self, *exc):
        from pde_superresolution_torch import integrate

        integrate.exact_solve_sampled, integrate.integrate = self._real

    def by_layer(self, schemes) -> dict:
        """{layer: seconds summed over the eval keys}; the scheme records are
        matched to ``schemes`` in order."""
        out = {"exact": sum(t for kind, t in self.records if kind == "exact")}
        legs = [t for kind, t in self.records if kind == "scheme"]
        for i, name in enumerate(schemes):
            out[name] = sum(legs[i::len(schemes)])
        return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def member_margins(corr: torch.Tensor, threshold: float = 0.8) -> torch.Tensor:
    """Per member (``corr`` [members, T]), the closest its correlation comes
    to ``threshold`` up to and including its first sample below it: how
    near the member is to another survival time."""
    dead = corr < threshold
    first_dead = torch.where(dead.any(-1), dead.float().argmax(-1), corr.shape[-1] - 1)
    upto = torch.arange(corr.shape[-1], device=corr.device) <= first_dead[:, None]
    return torch.where(upto, (corr - threshold).abs(), torch.inf).amin(-1)


def _keys(seeds: str) -> list[int]:
    return [int(s) for s in seeds.split(",")]


def evaluate_model(name: str, seeds: str, flags: list, num_samples: int,
                   max_horizon: float, device, members: str = "port") -> dict:
    """One zoo model at its protocol, on the port's members or JAX's
    (``members``: "port" or "jax"): the pooled and per-key statistics,
    seconds by layer and ``fused_rhs`` launches."""
    from pde_superresolution_torch.ops import fused_kernels as fk
    from pde_superresolution_torch.scripts import run_evaluation

    flags = list(flags)
    horizon = float(flags[flags.index("--time_max") + 1])
    if horizon > max_horizon:
        horizon = max_horizon
        flags[flags.index("--time_max") + 1] = str(horizon)
    argv = ["--checkpoint_dir", name, "--num_samples", str(num_samples), "--seeds", seeds,
            "--reference_cache_dir", "", "--output_path", "unused.h5", *flags]
    if device is not None:
        argv += ["--device", str(device)]
    args = run_evaluation.build_parser().parse_args(argv)
    draws = JaxMembers(name, _keys(seeds)) if members == "jax" else contextlib.nullcontext()
    fk.fused_rhs.launches = 0
    start = time.perf_counter()
    with draws, LayerTimes() as layers:
        result = run_evaluation.evaluate_checkpoint(args)
    seconds = time.perf_counter() - start
    schemes = list(result["pooled"])
    per_key = {scheme: [result["per_key"][seed][scheme]["survival_median"]
                        for seed in result["seeds"]] for scheme in schemes}
    times = layers.by_layer(schemes)
    detail = {}
    if members == "jax":  # the model's members, to compare member by member
        for seed, res in result["results"].items():
            detail[str(seed)] = {
                "survival": res.survival_time["model"].cpu().tolist(),
                "margin": member_margins(res.correlation["model"]).cpu().tolist()}
    return {
        "model": name, "seeds": result["seeds"], "members": members,
        "num_samples": num_samples,
        "horizon": horizon, "flags": flags, "pooled": result["pooled"],
        "per_key_survival_median": per_key, "seconds": seconds, "layers_s": times,
        "other_s": seconds - sum(times.values()), "fused_rhs_launches": fk.fused_rhs.launches,
        **({"model_members": detail} if detail else {}),
    }


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", default="",
                        help="comma-separated subset of the zoo (default: all ten)")
    parser.add_argument("--num_samples", type=int, default=32, help="members per eval key")
    parser.add_argument("--members", choices=("port", "jax"), default="port",
                        help="the port's torch.Generator draw of each key, or the JAX "
                        "package's committed draw (assets/members/)")
    parser.add_argument("--max_horizon", type=float, default=float("inf"),
                        help="cap on each protocol's horizon (rehearsals)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    picked = [m for m in args.models.split(",") if m]
    unknown = set(picked) - {name for name, _, _ in ZOO}
    if unknown:
        parser.error(f"not in the zoo: {sorted(unknown)}")
    zoo = [(name, seeds, flags) for name, seeds, flags in ZOO if not picked or name in picked]
    if args.members == "jax":
        for name, seeds, _ in zoo:  # refuse a model without JAX members before any run
            JaxMembers(name, _keys(seeds))
    card = card_line() if args.device != "cpu" else "cpu"
    rows = []
    for name, seeds, flags in zoo:
        row = evaluate_model(name, seeds, flags, args.num_samples, args.max_horizon,
                             args.device, args.members)
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
