"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m port_bench.control --workload <name> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 2]

For each seed of ``--seeds`` one run of the cell as the benchmark makes it
(the program, at the cell's own sizes, a short window), and for each of
``--control-seeds`` one run with the control in the program's place: the
plain reference computed in the precision one step below the one the
configuration states (``config["control"][route]``: float8 e4m3 for the
fused kernel's bfloat16 tower, TF32 for the per-step route's float32). Each
run prints one JSON line with the numbers ``correct`` compares. The lower
reading of a number is the largest of the program's runs, the upper one the
smallest of the control's; ``limits/<workload>.json`` lies between them.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

from port_bench import cells, run
from port_bench.reference import model as reference


def control_route(cell):
    """A route whose requests are the reference's at the control precision.
    It builds the program's route too, for the pack ``choose_route`` reads."""
    precision = cell.config["control"][cell.traffic["route"]]
    ref_model = None

    def build(model, params, dt_, traffic, forcing, t0):
        nonlocal ref_model
        if ref_model is None:
            ref_model = reference.build(cell.config, traffic["domain_factor"]).to(
                model.device)
        _, pack = cell.route.build(model, params, dt_, traffic, forcing, t0)
        ref_forcing = None if forcing is None else forcing._asdict()

        def request(u0):
            saves = reference.integrate(ref_model, u0, ref_forcing, dt_, traffic["steps"],
                                        traffic["save_every"], precision, t0=t0)
            return None, saves

        return request, pack

    return types.SimpleNamespace(FLAG=cell.route.FLAG, FUSED=cell.route.FUSED, build=build)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    cell = cells.load(args.workload)
    sides = [("program", s, None) for s in args.seeds.split(",") if s]
    sides += [("control", s, "control") for s in args.control_seeds.split(",") if s]
    for side, seed, control in sides:
        start = time.perf_counter()
        route = control_route(cell) if control else None
        result = run.run(args.workload, int(seed), args.seconds, False, route=route,
                         start=start)
        line = {"workload": args.workload, "side": side, "seed": int(seed),
                "correct": result["correct"], "requests": result["attempted"],
                "numbers": {n: c["value"] for n, c in result["checks"].items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
