"""Benchmark: the north-star metric of the PyTorch port, on one CUDA card.

    python -m pde_superresolution_torch.bench                 # on the card
    python -m pde_superresolution_torch.bench --device cpu    # plain routes only

The counterpart of the repository's ``bench.py`` (the JAX package's), with
its constants: coarse RK4 steps per second of the flagship program, the
learned constrained-stencil KS model at 8x coarsening (fine 1024 -> coarse
128, conservative, stencil 6), over a batch of 256 trajectories, 100 RK4
steps per timed call, against the same program on the CPU.

Prints progress on stderr and ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "rk4_steps/s/chip", "vs_baseline": N,
   "detail": {...}}
``value`` is the better of the ``rhs_fn`` and ``fused`` legs; ``vs_baseline``
is it over the ``cpu`` leg. The legs (``detail`` keys), beside bench.py's:

  * ``chip_ref_matmul``: a chain of 50 renormalized 4096^2 bf16 products
    (``torch.matmul``), a program-independent marker of the card's state;
  * ``rhs_fn`` (bench.py's ``xla``): ``integrate(model.rhs_fn(params))``,
    one ``fused_rhs`` launch per RHS (400 per call), the tower in cuDNN;
  * ``fused``: ``model.fused_rk4_fn(params, dt, 100)``, one
    ``fused_learned_rk4`` launch per call;
  * ``ratio_fused_vs_rhs_fn`` (bench.py's ``ratio_fused_vs_xla``);
  * ``throughput_fused_b4096``: the fused leg at B=4096, with
    ``traj_steps_per_s``;
  * ``cpu``: the ``rhs_fn`` program on the CPU (the plain route), with
    ``torch.get_num_threads()``; the denominator of ``vs_baseline``;
  * ``train`` (``scripts_dev/bench_train_step.py``'s full step): ms per
    optimizer step at the KS-8x training recipe (``assets/ckpt_ks8.json``:
    batch 128, unroll 8, 12 RK4 substeps), by both RHS routes, through the
    train step ``training.loop`` builds for ``train()``, on batches drawn as
    ``train()`` draws them; with the device-busy share of one block, read
    from a ``utils.profiling.trace``.

Every leg runs blocks sized to about 0.3 s (the train leg: a number of
steps), each ended by a synchronize, and reports the median, the samples,
the spread (IQR over median), the block's seconds and calls, the kernel
launches per call (from the wrappers' counters) and whether the state is
finite at the end. The weights are the ``ckpt_ks8`` asset (the flagship's
shape; bench.py draws random ones from a key the port does not share):
trained weights keep the state finite over thousands of chained steps, and
the cost does not depend on the values.

No fallback: a failing leg fails the run, and without ``--device cpu`` a
machine without CUDA raises. ``--device cpu`` times only the plain routes
(``rhs_fn``, the train step with ``use_kernel=False``) and says so in
``detail``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pde_superresolution_torch import convert, equations, integrate
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import ModelConfig, StencilModel
from pde_superresolution_torch.ops import fused_kernels
from pde_superresolution_torch.training import loop
from pde_superresolution_torch.training.config import TrainingConfig, parse_hparams
from pde_superresolution_torch.utils import profiling

BATCH = 256
THROUGHPUT_BATCH = 4096
FINE = 1024
FACTOR = 8
INNER_STEPS = 100  # RK4 steps per timed call
BLOCK_S = 0.3  # seconds a timed block aims at
ASSET = "ckpt_ks8"
KERNELS = ("fused_rhs", "fused_learned_rk4", "fused_rk4")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def build(fused: bool = False, batch: int = BATCH, device=None, params=None):
    """(program, u0): ``program(u)`` advances ``u [batch, 128]`` by
    ``INNER_STEPS`` RK4 steps of the KS-8x model, by ``fused_rk4_fn`` (one
    ``fused_learned_rk4`` launch) or by ``integrate(model.rhs_fn(params))``;
    ``u0`` is a seeded initial batch. ``params`` default to the
    ``ckpt_ks8`` asset's."""
    device = resolve_device(device)
    eq = equations.from_name("ks", conservative=True)
    coarse = Grid(FINE, eq.period).resample(FACTOR, conservative=True)
    model = StencilModel(eq, coarse, ModelConfig(stencil_size=6), device=device)
    if params is None:
        params = convert.load_asset(ASSET, device=device)[1]
    dt = eq.stable_time_step(coarse, u_scale=3.0)
    u0 = eq.initial_conditions(torch.Generator().manual_seed(1), coarse, (batch,), device)
    if fused:
        return model.fused_rk4_fn(params, dt, INNER_STEPS), u0
    rhs = model.rhs_fn(params)

    def many_steps(u):
        return integrate.integrate(rhs, u, dt, INNER_STEPS, save_every=INNER_STEPS)[1][-1]

    return many_steps, u0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches(since: Optional[dict] = None) -> dict:
    """The kernel wrappers' launch counts, or with ``since`` the launches
    made after it was read (the kernels launched at least once)."""
    now = {name: getattr(fused_kernels, name).launches for name in KERNELS}
    if since is None:
        return now
    return {name: n - since[name] for name, n in now.items() if n > since[name]}


def _spread(samples: Sequence[float]) -> dict:
    med = float(np.median(samples))
    q1, q3 = np.percentile(samples, [25, 75])
    return {"median": med, "samples": list(samples),
            "iqr_over_median_pct": 100.0 * (q3 - q1) / med}


def steps_per_sec(device, fused: bool = False, num_samples: int = 5,
                  batch: int = BATCH) -> tuple[float, dict]:
    """(median RK4 steps/s, detail) of the program over ``num_samples``
    blocks of about ``BLOCK_S`` seconds, each ended by a synchronize, the
    state chained through every call after one warm-up call."""
    device = resolve_device(device)
    fn, u0 = build(fused=fused, batch=batch, device=device)
    before = _launches()
    u = fn(u0)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    fn(u0)
    _sync(device)
    once = time.perf_counter() - t0
    repeats = max(1, int(BLOCK_S / max(once, 1e-4)))
    samples, blocks = [], []
    for _ in range(num_samples):
        t0 = time.perf_counter()
        for _ in range(repeats):
            u = fn(u)
        _sync(device)
        wall = time.perf_counter() - t0
        blocks.append(wall)
        samples.append(repeats * INNER_STEPS / wall)
    calls = 2 + num_samples * repeats
    launches = _launches(before)
    detail = {
        **_spread(samples),
        "block_s": float(np.median(blocks)),
        "repeats_per_block": repeats,
        "batch": batch,
        "launches": launches,
        "launches_per_call": {k: n / calls for k, n in launches.items()},
        "finite": bool(torch.isfinite(u).all()),
    }
    return detail["median"], detail


def chip_ref_matmul_ms(device, num_samples: int = 5, length: int = 50) -> dict:
    """A program-independent marker of the card's state: a chain of
    ``length`` 4096^2 bf16 products, each renormalized so the chain neither
    overflows nor underflows; ms per product (host clock around the chain,
    ended by a synchronize) and the rate in TFLOP/s."""
    n = 4096
    a = torch.randn(n, n, generator=torch.Generator().manual_seed(2))
    a = (a / n**0.5).to(device=device, dtype=torch.bfloat16)

    def marker(x):
        c = x
        for _ in range(length):
            c = c @ c
            c = c * torch.rsqrt(c.float().square().mean()).to(c.dtype)
        return c.float().square().mean()

    marker(a)  # warm-up
    _sync(device)
    samples = []
    for _ in range(num_samples):
        t0 = time.perf_counter()
        marker(a)
        _sync(device)
        samples.append((time.perf_counter() - t0) / length * 1e3)
    med = float(np.median(samples))
    return {"median_ms": med, "samples_ms": samples, "tflops": 2 * n**3 / (med * 1e-3) / 1e12}


def device_events(logdir: str) -> list:
    """The device's activity in the traces of ``logdir``: (name, start µs,
    duration µs) of every kernel, copy and fill CUPTI recorded."""
    events = []
    for name in sorted(os.listdir(logdir)):
        if name.endswith(".pt.trace.json"):
            with open(os.path.join(logdir, name)) as f:
                trace = json.load(f)
            events += [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                       for e in trace.get("traceEvents", [])
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return events


def busy_us(events: list) -> float:
    """Microseconds in which the device ran anything: the union of the
    events' intervals."""
    total, end = 0.0, -float("inf")
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def train_leg(device, blocks: int = 5, steps: int = 3, hparams: str = "",
              routes: Sequence[bool] = (False, True)) -> dict:
    """ms per train step at the KS-8x recipe (``hparams`` overrides it), by
    each RHS route in ``routes`` (``use_kernel``): one warm-up step, then
    ``blocks`` blocks of ``steps`` steps, each ended by a synchronize, the
    state chained through the steps and each batch drawn as ``train()``
    draws it; on a card one more block under ``profiling.trace`` gives the
    device's busy time per step and, over the untraced median step, its
    busy share."""
    device = resolve_device(device)
    config = TrainingConfig.from_json((convert.ASSET_DIR / f"{ASSET}.json").read_text())
    if hparams:
        config = parse_hparams(hparams, base=config)
    equation, fine, model = loop._model_for(config, device)
    t0 = time.perf_counter()
    run = loop.prepare_run(config, equation, fine, model)
    _sync(device)
    unroll = config.curriculum_phases()[-1][0]
    out = {"asset": ASSET, "hparams": hparams, "batch": config.batch_size,
           "unroll": unroll, "substeps": run.substeps, "setup_s": time.perf_counter() - t0}
    for use_kernel in routes:
        train_step = loop._step_functions(config, model, run.tx, run.norms, run.substeps,
                                          use_kernel)(unroll)[0]
        state = run.state

        def block(state):
            for _ in range(steps):
                state, parts = train_step(state, run.next_batch(state.step))
            _sync(device)
            return state, parts

        before = _launches()
        state, _ = train_step(state, run.next_batch(state.step))  # warm-up
        _sync(device)
        samples = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            state, parts = block(state)
            samples.append(1e3 * (time.perf_counter() - t0) / steps)
        launches = _launches(before)
        leg = {**_spread(samples), "steps_per_block": steps,
               "launches_per_step": {k: n / (1 + blocks * steps) for k, n in launches.items()}}
        if device.type == "cuda":
            # the trace's host recording slows the host several times over,
            # not the device: its busy time per step is set against the
            # untraced median step
            with tempfile.TemporaryDirectory() as logdir:
                t0 = time.perf_counter()
                with profiling.trace(logdir):
                    state, parts = block(state)
                leg["traced_block_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / steps
                leg["device_busy_ms_per_step"] = busy_us(device_events(logdir)) / 1e3 / steps
            leg["device_busy_share"] = leg["device_busy_ms_per_step"] / leg["median"]
        leg["launches"] = _launches(before)
        leg["finite"] = bool(all(torch.isfinite(v).all() for v in state.params.values())
                             and all(np.isfinite(float(v)) for v in parts.values()))
        out["kernel_route" if use_kernel else "plain_route"] = leg
        log(f"train step ({'kernel' if use_kernel else 'plain'} route, B={config.batch_size}): "
            f"{leg['median']:.1f} ms median of {blocks} blocks of {steps} "
            f"(iqr {leg['iqr_over_median_pct']:.1f}%), busy "
            f"{leg.get('device_busy_share', 'not measured')}")
    return out


def card_detail(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them, and the
    torch and CUDA versions."""
    detail = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        detail["nvidia_smi"] = smi.stdout.strip().splitlines()[device.index or 0]
        detail["name"] = torch.cuda.get_device_name(device)
    return detail


def measure(device=None, samples: int = 5, cpu_samples: int = 5, batch: int = BATCH,
            train_blocks: int = 5, train_steps: int = 3, train_hparams: str = "") -> dict:
    """Run every leg; returns bench.py's JSON object. Raises if a leg fails
    or leaves a non-finite state."""
    device = resolve_device(device)
    detail = {"device": str(device), "card": card_detail(device)}
    if device.type == "cuda":
        detail["chip_ref_matmul"] = chip_ref_matmul_ms(device)
        log(f"chip marker: 4096^2 bf16 matmul {detail['chip_ref_matmul']['median_ms']:.4f} ms")
    rhs_sps, detail["rhs_fn"] = steps_per_sec(device, num_samples=samples, batch=batch)
    log(f"{device} rhs_fn route: {rhs_sps:,.0f} RK4 steps/s (batch={batch}, "
        f"iqr {detail['rhs_fn']['iqr_over_median_pct']:.2f}%)")
    value = rhs_sps
    vs = None
    if device.type == "cuda":
        fused_sps, detail["fused"] = steps_per_sec(device, fused=True, num_samples=samples,
                                                   batch=batch)
        detail["ratio_fused_vs_rhs_fn"] = fused_sps / rhs_sps
        log(f"fused learned-RK4 kernel: {fused_sps:,.0f} RK4 steps/s "
            f"({fused_sps / rhs_sps:.2f}x rhs_fn, "
            f"iqr {detail['fused']['iqr_over_median_pct']:.2f}%)")
        value = max(value, fused_sps)
        thr, d = steps_per_sec(device, fused=True, num_samples=samples, batch=THROUGHPUT_BATCH)
        d["traj_steps_per_s"] = thr * THROUGHPUT_BATCH
        detail[f"throughput_fused_b{THROUGHPUT_BATCH}"] = d
        log(f"fused batch-{THROUGHPUT_BATCH} throughput: {thr * THROUGHPUT_BATCH:,.0f} "
            f"traj-steps/s ({thr:,.0f} steps/s)")
        cpu_sps, detail["cpu"] = steps_per_sec("cpu", num_samples=cpu_samples, batch=batch)
        detail["cpu"]["threads"] = torch.get_num_threads()
        log(f"CPU ({torch.get_num_threads()} threads): {cpu_sps:,.1f} RK4 steps/s "
            f"(iqr {detail['cpu']['iqr_over_median_pct']:.2f}%)")
        vs = value / cpu_sps
        routes = (False, True)
    else:
        detail["note"] = ("--device cpu: plain routes only (rhs_fn without a kernel, the train "
                          "step with use_kernel=False); no card, so no fused, throughput, "
                          "marker or cpu-denominator leg and no vs_baseline")
        routes = (False,)
    if train_blocks:
        detail["train"] = train_leg(device, train_blocks, train_steps, train_hparams, routes)
    legs = [v for v in detail.values() if isinstance(v, dict)]
    legs += [v for v in detail.get("train", {}).values() if isinstance(v, dict)]
    if not all(leg.get("finite", True) for leg in legs):
        raise RuntimeError(f"a leg ended in a non-finite state: {json.dumps(detail)}")
    return {
        "metric": f"KS 8x learned-model coarse RK4 steps/sec/chip (batch {batch})",
        "value": value,
        "unit": "rk4_steps/s/chip",
        "vs_baseline": vs,
        "detail": detail,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu (plain routes only)")
    parser.add_argument("--samples", type=int, default=5, help="timed blocks per leg")
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--train_blocks", type=int, default=5,
                        help="timed blocks of the train leg per route (0: no train leg)")
    parser.add_argument("--train_steps", type=int, default=3, help="train steps per block")
    parser.add_argument("--train_hparams", default="",
                        help="overrides of the KS-8x recipe, as run_training's --hparams")
    args = parser.parse_args(argv)
    result = measure(args.device, args.samples, args.samples, args.batch, args.train_blocks,
                     args.train_steps, args.train_hparams)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
