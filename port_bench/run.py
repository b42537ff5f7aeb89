"""The port's benchmark: one cell, one run.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is a closed loop with one client, as a researcher's script that waits
for each ensemble before it asks for the next: request i advances pool batch
i mod pool over the traffic's steps through the port's own entry (the cell's
route, built as ``scripts/run_ensemble`` builds it) and ends in a
synchronize. Set-up loads the asset, makes the input pool from ``--seed``
on the card and runs two requests; then requests run back to back for
``--seconds``, each timed by the host's clock from its start to its
synchronize.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
same window, then a few more requests under ``torch.profiler``, and prints
the per-layer metrics (``metrics/<name>.py``) and a breakdown. Either way,
once the window has closed, a sample of its requests drawn from the seed is
held against the plain reference (``reference/model.py``) on the same
inputs, every save of the whole batch, and the last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` and, last, ``checks`` (each compared number beside its limit).
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional, Sequence  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pde_superresolution_tpu")
WARMUP_REQUESTS = 2
TRACE_MAX_REQUESTS = 50


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` of JAX or the JAX package, compared
    whole: the port's name begins with the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Port:
    """The system under test, set up for one cell."""

    requests: list  # one request function per pool batch; each holds the model
    route_reason: str


def port_forcing(batch):
    from pde_superresolution_torch.equations import ForcingParams

    return None if batch.forcing is None else ForcingParams(**batch.forcing)


def setup_port(cell, pool, dt: float, device: str) -> Port:
    """The model as ``run_ensemble.setup`` loads and widens it, a request
    function a pool batch from the cell's route, and the route
    ``run_ensemble.choose_route`` takes, which has to be the cell's."""
    from pde_superresolution_torch.scripts import run_ensemble

    args = argparse.Namespace(
        checkpoint_dir=cell.config["asset"], exported_dir=None, device=device,
        domain_factor=cell.traffic["domain_factor"], seed=0, num_trajectories=1,
        ic_scale=1.0)
    ensemble = run_ensemble.setup(args)
    requests, pack = [], None
    for batch in pool:
        request, pack = cell.route.build(ensemble.model, ensemble.params, dt, cell.traffic,
                                         port_forcing(batch), batch.t0)
        requests.append(request)
    flag = cell.route.FLAG if device == "cuda" else ("true" if cell.route.FUSED else "false")
    fused, reason = run_ensemble.choose_route(
        flag, dataclasses.replace(ensemble, u0=pool[0].u0, forcing=port_forcing(pool[0])),
        pack)
    if fused != cell.route.FUSED:
        raise RuntimeError(f"the port took the {'fused' if fused else 'rhs_fn'} route "
                           f"({reason}); the cell is {cell.traffic['route']}")
    return Port(requests, reason)


def synchronize(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    seconds: float = 0.0  # from the first request's start to the last one's synchronize
    latencies_s: list = dataclasses.field(default_factory=list)
    host_s: list = dataclasses.field(default_factory=list)  # start to the call's return
    kept: list = dataclasses.field(default_factory=list)  # (request index, saves)
    failed: int = 0
    error: str = ""

    @property
    def completed(self) -> int:
        return len(self.latencies_s)


def run_window(requests: list, pool, seconds: float, device: str, keep: int,
               rng: random.Random) -> Window:
    """Requests back to back until ``seconds`` have passed; the last one
    started runs to its end. A reservoir drawn from ``rng`` keeps the saves
    of ``keep`` requests, each as likely as any other."""
    import torch

    window = Window()
    begin = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        if start - begin >= seconds:
            break
        try:
            with torch.no_grad():
                _, saves = requests[i % len(requests)](pool[i % len(pool)].u0)
            returned = time.perf_counter()
            synchronize(device)
        except RuntimeError as e:  # a launch or kernel failure: the run is not correct
            window.failed += 1
            window.error = f"request {i}: {e}"
            break
        end = time.perf_counter()
        window.latencies_s.append(end - start)
        window.host_s.append(returned - start)
        if len(window.kept) < keep:
            window.kept.append((i, saves))
        else:
            slot = rng.randrange(i + 1)
            if slot < keep:
                window.kept[slot] = (i, saves)
        i += 1
    window.seconds = time.perf_counter() - begin
    return window


def traced_requests(requests: list, pool, device: str, count: int, first: int):
    """``count`` requests under the profiler, after the window, each in a
    ``trace.REQUEST_SPAN`` ended by its synchronize."""
    import torch

    from port_bench import trace

    def body():
        for i in range(first, first + count):
            with torch.profiler.record_function(trace.REQUEST_SPAN), torch.no_grad():
                requests[i % len(requests)](pool[i % len(pool)].u0)
                synchronize(device)

    return trace.capture(body)


def p95(values: Sequence[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    window: Window  # the untraced window
    trace: object  # trace.Trace of the traced requests
    traced: int  # requests in the trace

    @property
    def traced_window_s(self) -> float:
        lo, hi = self.trace.window_us
        return (hi - lo) * 1e-6


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def check(cell, window: Window, pool, dt: float, device: str, ref_model) -> dict:
    """Each kept request's saves against the reference's, from the same
    batch, at the precision the configuration states for the route."""
    from port_bench import compare
    from port_bench.reference import model as reference

    precision = cell.config["precision"][cell.traffic["route"]]
    readings = []
    for i, saves in window.kept:
        batch = pool[i % len(pool)]
        ref = reference.integrate(ref_model, batch.u0, batch.forcing, dt, cell.traffic["steps"],
                                  cell.traffic["save_every"], precision, t0=batch.t0)
        readings.append(compare.gaps(saves, ref))
    if not readings:
        return {n: {"value": math.inf, "limit": cell.limits[n]} for n in compare.NUMBERS}
    worst = compare.worst(readings)
    return {n: {"value": worst[n], "limit": cell.limits[n]} for n in compare.NUMBERS}


def run(workload: str, seed: int, seconds: float, trace_on: bool, *,
        dirs: Optional[Sequence[Path]] = None, spec_path: Optional[Path] = None,
        device: str = "cuda", start: float = START, route=None) -> dict:
    """One run of one cell; returns the result line's object. Raises
    ``NoDevice`` where the cards are missing, before anything else runs.
    ``route`` puts another route in the cell's (the control's)."""
    import torch

    from port_bench import cells, compare, inputs, trace
    from port_bench.reference import model as reference

    marks = [("import", time.perf_counter() - start)]
    cell = cells.load(workload, dirs, spec_path)
    if route is not None:
        cell = dataclasses.replace(cell, route=route)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise NoDevice(f"{workload} needs {cell.chips} CUDA device(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen")
    torch.set_num_threads(2)
    traffic = cell.traffic
    # the reference's own work is no set-up of the program: its seconds are
    # taken out of setup_s (the time step it works out is an input)
    ref_start = time.perf_counter()
    ref_model = reference.build(cell.config, traffic["domain_factor"])
    dt = reference.stable_dt(cell.config, ref_model)
    ref_s = time.perf_counter() - ref_start
    marks.append(("dt", time.perf_counter() - start))
    pool = inputs.make_pool(cell.config, traffic, seed, device)
    synchronize(device)
    marks.append(("inputs", time.perf_counter() - start))
    port = setup_port(cell, pool, dt, device)
    marks.append(("port", time.perf_counter() - start))
    if device == "cuda":
        from pde_superresolution_torch.ops import _build

        _build.load_library()
    marks.append(("kernels", time.perf_counter() - start))
    with torch.no_grad():
        for i in range(WARMUP_REQUESTS):
            port.requests[i % len(port.requests)](pool[i % len(pool)].u0)
    synchronize(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start - ref_s

    rng = random.Random(seed)
    window = run_window(port.requests, pool, seconds, device, traffic["check_requests"], rng)
    traj_steps = window.completed * traffic["batch"] * traffic["steps"]
    metrics = {}
    for m in cell.end_to_end:
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"] == "traj_steps_per_s":
            value = traj_steps / window.seconds if window.completed else None
        elif m["name"] == "request_p95_ms":
            value = 1e3 * p95(window.latencies_s) if window.completed else None
        else:
            raise KeyError(f"no reading for end-to-end metric {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips}
    breakdown = None
    if trace_on and window.completed and not window.failed:
        per_request = statistics.median(window.latencies_s)
        count = max(2, min(TRACE_MAX_REQUESTS, math.ceil(traffic["trace_seconds"] / per_request)))
        traced = traced_requests(port.requests, pool, device, count, window.completed)
        readings = Readings(cell.config, traffic, window, traced, count)
        metrics = {}
        for m, reader in cell.per_layer:
            value = reader.read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = trace.busy_us(traced) * 1e-6
        dev["window_s"] = readings.traced_window_s
        breakdown = trace.breakdown(traced)
    if device == "cuda":
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"port_bench: card {power_limit()}", file=sys.stderr)
    else:
        dev["memory_peak_bytes"] = 0

    # the program's state goes before the reference runs
    port_reason = port.route_reason
    del port
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checked = time.perf_counter()
    checks = check(cell, window, pool, dt, device, ref_model.to(device))
    print(f"port_bench: {workload} seed {seed}: route {port_reason}; dt {dt!r}; "
          f"{window.completed} requests in {window.seconds:.3f} s; set-up {setup_s:.3f} s "
          f"({', '.join(f'{k} {v:.2f}' for k, v in marks)}; the reference's "
          f"{ref_s:.2f} s left out); "
          f"{len(window.kept)} checked in {time.perf_counter() - checked:.3f} s",
          file=sys.stderr)
    correct = (window.completed > 0 and window.failed == 0
               and all(compare.within(c["value"], c["limit"]) for c in checks.values()))
    result = {"correct": correct, "attempted": window.completed + window.failed,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if window.error:
        print(f"port_bench: {window.error}", file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoDevice as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}; the benchmark may load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
