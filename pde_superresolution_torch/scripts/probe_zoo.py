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
and the ``fused_rhs`` launches, then the card's ``nvidia-smi`` line.

The port draws its members from ``torch.Generator`` keys, so they are not
the JAX package's members of the same key number: the comparison with the
published numbers is statistical. ``--models`` picks a subset;
``--num_samples`` and ``--max_horizon`` shrink a run for a rehearsal on
the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# (asset, eval keys, run_evaluation flags): RESULTS.md's protocol per model
ZOO = (
    ("ckpt_ks8_u16s8", "0,1,54321", ["--time_max", "50", "--warmup_time", "44"]),
    ("ckpt_ks16", "0,1,54321", ["--time_max", "50", "--warmup_time", "44"]),
    ("ckpt_ks32", "0,1,54321", ["--time_max", "50", "--warmup_time", "44"]),
    ("ckpt_kdv8", "0,1,2", ["--time_max", "10", "--ic_scale", "0.5"]),
    ("ckpt_kdv16", "0,1,2", ["--time_max", "10", "--ic_scale", "0.5"]),
    ("ckpt_kdv16_f64", "12345,1,2",
     ["--time_max", "10", "--ic_scale", "0.5", "--time_delta", "0.05"]),
    ("kdv16_select_seed7", "0,1,2", ["--time_max", "10", "--ic_scale", "0.5"]),
    ("ckpt_burgers8", "0,1,2", ["--time_max", "3"]),
    ("ckpt_burgers64", "0,1,2", ["--time_max", "3"]),
)


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


def evaluate_model(name: str, seeds: str, flags: list, num_samples: int,
                   max_horizon: float, device) -> dict:
    """One zoo model at its protocol: the pooled and per-key statistics,
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
    fk.fused_rhs.launches = 0
    start = time.perf_counter()
    with LayerTimes() as layers:
        result = run_evaluation.evaluate_checkpoint(args)
    seconds = time.perf_counter() - start
    schemes = list(result["pooled"])
    per_key = {scheme: [result["per_key"][seed][scheme]["survival_median"]
                        for seed in result["seeds"]] for scheme in schemes}
    times = layers.by_layer(schemes)
    return {
        "model": name, "seeds": result["seeds"], "members": num_samples,
        "horizon": horizon, "flags": flags, "pooled": result["pooled"],
        "per_key_survival_median": per_key, "seconds": seconds, "layers_s": times,
        "other_s": seconds - sum(times.values()), "fused_rhs_launches": fk.fused_rhs.launches,
    }


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", default="",
                        help="comma-separated subset of the zoo (default: all nine)")
    parser.add_argument("--num_samples", type=int, default=32, help="members per eval key")
    parser.add_argument("--max_horizon", type=float, default=float("inf"),
                        help="cap on each protocol's horizon (rehearsals)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    picked = [m for m in args.models.split(",") if m]
    unknown = set(picked) - {name for name, _, _ in ZOO}
    if unknown:
        parser.error(f"not in the zoo: {sorted(unknown)}")
    card = card_line() if args.device != "cpu" else "cpu"
    rows = []
    for name, seeds, flags in ZOO:
        if picked and name not in picked:
            continue
        row = evaluate_model(name, seeds, flags, args.num_samples, args.max_horizon,
                             args.device)
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
