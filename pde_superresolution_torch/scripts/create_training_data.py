"""Generate exact-solution training snapshots and write HDF5.

The counterpart of ``pde_superresolution_tpu/scripts/create_training_data.py``:
pick an equation and a seed, draw the initial conditions and forcing from a
``torch.Generator`` seeded with ``--seed``, run the exact ETDRK4 solve on
the fine grid, sample snapshots every ``--time_delta`` and write them with
``training.data.save_snapshots_h5`` in the JAX package's layout (needs
``h5py``). The solve runs on ``cuda`` unless ``--device cpu`` is given.

Example:
  python -m pde_superresolution_torch.scripts.create_training_data \
      --equation burgers --output_path /tmp/burgers.h5 \
      --num_trajectories 32 --num_times 128 --time_delta 0.1 --seed 0
"""

from __future__ import annotations

import argparse
import sys

import torch

from pde_superresolution_torch import equations
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.training import data as data_lib


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output_path", required=True, help="HDF5 output path")
    parser.add_argument("--equation", choices=sorted(equations.EQUATION_TYPES),
                        default="burgers", help="equation to solve")
    parser.add_argument("--conservative", action=argparse.BooleanOptionalAction, default=True,
                        help="conservative (finite-volume) labeling downstream")
    parser.add_argument("--fine_size", type=int, default=1024, help="fine (exact) grid size")
    parser.add_argument("--num_trajectories", type=int, default=32,
                        help="number of trajectories")
    parser.add_argument("--num_times", type=int, default=128, help="snapshots per trajectory")
    parser.add_argument("--time_delta", type=float, default=0.1, help="time between snapshots")
    parser.add_argument("--warmup_time", type=float, default=0.0,
                        help="discard this much initial time (KS: about 40 to land "
                        "on the attractor)")
    parser.add_argument("--ic_scale", type=float, default=1.0,
                        help="initial-condition amplitude scale")
    parser.add_argument("--seed", type=int, default=0, help="random seed")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    """Generate and write; returns the path, the snapshots' shape and the
    equation's name."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    equation = equations.from_name(args.equation, conservative=args.conservative)
    fine = Grid(args.fine_size, equation.period)
    snapshots = data_lib.generate_snapshots(
        equation, fine, torch.Generator().manual_seed(args.seed),
        num_trajectories=args.num_trajectories, num_times=args.num_times,
        time_delta=args.time_delta, warmup_time=args.warmup_time,
        ic_scale=args.ic_scale, device=device,
    )
    data_lib.save_snapshots_h5(args.output_path, snapshots, equation, fine)
    print(f"wrote {args.num_trajectories}x{args.num_times}x{args.fine_size} "
          f"{args.equation} snapshots to {args.output_path}", flush=True)
    return {"output_path": args.output_path, "shape": tuple(snapshots.u.shape),
            "equation": equation.name}


if __name__ == "__main__":
    main(sys.argv[1:])
