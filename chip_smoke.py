#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build, check, run, time.

    python3 chip_smoke.py

Runs from the repository root on a machine with one NVIDIA H100 (sm_90a) and
``nvcc``. It imports no JAX. Phases, each printed as it ends:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. the kernels' build from ``pde_superresolution_torch/csrc`` (seconds,
     ptxas registers and spills);
  3. ``fused_rhs`` against its plain version: at the flagship (KS-8x
     checkpoint coefficients, B=256, nx=128) and in all six equation forms
     at a ragged shape (B=3, nx=96, forced for Burgers);
  4. ``fused_learned_rk4`` against its plain version: one step of the KS-8x
     checkpoint from a standard-normal state (energy at every wavenumber,
     where the tower's output matters), then 100 steps of it at B=256 and of
     a seeded conservative-KdV model; the KS-8x checks must also catch three
     faults planted in the weights (heads zeroed, the last tower layer
     skipped, layer 1's input channels reversed);
  5. the main path, 100 RK4 steps at B=256 from a seeded initial condition
     through ``integrate(model.rhs_fn(params))`` and
     ``integrate_fused(model.fused_rk4_fn(params, dt, 100))``, with the
     kernels' launch counts zeroed just before and read just after, checked
     against the plain path and against the port's float64 CPU path on a
     small batch;
  6. times (CUDA events, warm median of 7) at B=256 and B=4096: each
     kernel's device time and call time, its plain version, both routes,
     the ``rhs_fn`` route's device time (one RK4 step queued behind a
     device-side sleep, times 100) and its launches per RHS, and its device
     time by kernel (torch.profiler, which can drop records);
  7. one ``{"kernels": [...]}`` line, then the card's line, then the result.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; it also exits non-zero
when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
STEPS = 100  # RK4 steps per main-path call
BATCH = 256
THROUGHPUT_BATCH = 4096
SAMPLES = 7
# One-step increment tolerances, relative to max|plain increment|, from a
# standard-normal state, near 10x the largest reading on an H100: kernel vs
# plain (phase 4) read 2.4e-7, and 1.7e-7 to 2.8e-7 for the GPU tests'
# models; the bf16 tower route vs the float32 one (phase 5) read 1.1e-3.
# The planted faults read 1.3e-1 to 2.4e-1.
STEP_TOL = 3e-6
ROUTE_STEP_TOL = 1e-2
SLEEP_CYCLES = 60_000_000  # about 30 ms of device-side sleep at H100 clocks
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(name: str, got, want, tol: float) -> float:
    """Max abs error; raises if it exceeds ``tol`` x max|want| or if either
    side is not finite."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    verdict = "ok" if rel <= tol else "FAIL"
    log(f"  {name}: max abs err {err:.3e}, rel {rel:.3e} (tolerance {tol:.0e} "
        f"of max|ref| {float(want.abs().max()):.4g}) {verdict}")
    if rel > tol:
        raise AssertionError(f"{name}: relative error {rel} > {tol}")
    return err


def check_catches(name: str, got, want, tol: float) -> None:
    """Raises unless ``got`` (from planted-fault weights) misses ``want`` by
    more than ``tol`` x max|want|: a check that passes a fault has no power."""
    rel = float((got - want).abs().max()) / float(want.abs().max())
    verdict = "caught" if rel > tol else "NOT CAUGHT"
    log(f"  planted fault, {name}: rel err {rel:.3e} (tolerance {tol:.0e}) {verdict}")
    if not rel > tol:
        raise AssertionError(f"planted fault {name} passes the {tol} check: {rel}")


def planted_faults(params: dict) -> dict:
    """{name: a copy of a tower model's state dict with one planted fault}."""
    import torch

    layers = sum(1 for k in params if k.startswith("tower.") and k.endswith(".weight"))
    last = f"tower.{layers - 1}"
    w = params[f"{last}.weight"]  # [C, C, K]
    identity = torch.zeros_like(w)
    identity[range(w.shape[0]), range(w.shape[0]), (w.shape[2] - 1) // 2] = 1.0
    return {
        "heads zeroed": {k: torch.zeros_like(v) if k.startswith("heads.") else v
                         for k, v in params.items()},
        "last tower layer skipped": {**params, f"{last}.weight": identity,
                                     f"{last}.bias": torch.zeros_like(params[f"{last}.bias"])},
        "layer 1 input channels reversed": {
            **params, "tower.1.weight": params["tower.1.weight"].flip(1).contiguous()},
    }


def time_ms(fn, inner: int = 1, queued: bool = False) -> float:
    """Median over SAMPLES of the per-call time of ``inner`` back-to-back
    calls, on CUDA events, after one warm-up call.

    Unqueued, the events also count the host's dispatch whenever the host is
    slower than the card: that is the time a caller pays. ``queued`` first
    holds the card in a device-side sleep while the host queues the calls,
    so the events time the device's work alone; it logs when the host took
    longer to queue them than the sleep lasted (the time is then not the
    device's alone).
    """
    import torch

    fn()
    torch.cuda.synchronize()
    sleep_ms = 0.0
    if queued:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        end.record()
        end.synchronize()
        sleep_ms = start.elapsed_time(end)
    samples = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host = time.perf_counter()
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - host)
        end.synchronize()
        if queued and host_ms > sleep_ms:
            log(f"    note: queuing took {host_ms:.2f} ms > the {sleep_ms:.2f} ms sleep")
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def launch_count(fn) -> tuple:
    """(kernel launches the host issued, kernel records on the device) in
    one call of ``fn``, from torch.profiler, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = sum(1 for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name)
    device = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    return host, device


def device_profile(fn, calls: int) -> dict:
    """{kernel name: device microseconds per call} over ``calls`` calls,
    from torch.profiler's CUDA activity (CUPTI), after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            per_kernel[evt.name] = (
                per_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us() / calls
            )
    return per_kernel


def perturbed_model(name, cons, size, device, nx, filters=32, layers=3, batch=3):
    """A seeded model with small non-zero heads and a seeded initial batch."""
    import torch

    from pde_superresolution_torch import equations
    from pde_superresolution_torch.grids import Grid
    from pde_superresolution_torch.models import ModelConfig, StencilModel

    eq = equations.from_name(name, conservative=cons)
    grid = Grid(8 * nx, eq.period).resample(8, conservative=cons)
    model = StencilModel(eq, grid, ModelConfig(num_layers=layers, filters=filters,
                                               stencil_size=size), device=device)
    gen = torch.Generator().manual_seed(SEED)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen).to(device)
              for k, v in model.init_params(gen).items()}
    u = eq.initial_conditions(gen, grid, (batch,), device)
    return model, params, u


def rhs_bound_ms(u, coeffs, f) -> float:
    """Least time for one fused RHS: each input read once and u_t written
    once at the HBM rate (the tap arithmetic, 2 flops per tap plus about 10
    per point, is far below the float32 rate)."""
    numel = u.numel() * (2 + (f is not None)) + sum(c.numel() for c in coeffs.values())
    flops = u.numel() * (2 * sum(c.shape[-1] for c in coeffs.values()) + 10)
    return 1e3 * max(4 * numel / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def learned_rk4_bound_ms(pack, batch: int, steps: int) -> float:
    """Least time for ``steps`` fused RK4 steps. Per grid point and RHS the
    tower (K*Cin*C per layer) and heads (C*F) multiply bf16-rounded inputs,
    at the bf16 tensor-core rate; the projection (S*F) and stencil (S) are
    float32, at the CUDA-core rate. The bytes (state in and out, weights)
    are far below either."""
    points = pack.grid.size * batch * 4 * steps
    bf16_macs = sum(w.numel() for w, _ in pack.tower) + pack.head_w.numel()
    f32_macs = pack.pn.numel() + pack.pn.shape[0]
    ops_s = 2.0 * points * (bf16_macs / BF16_TENSOR_FLOPS + f32_macs / FP32_FLOPS)
    bytes_s = 4 * (2 * batch * pack.grid.size + pack.flat.numel()) / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from pde_superresolution_torch import convert, integrate
    from pde_superresolution_torch.ops import _build
    from pde_superresolution_torch.ops import fused_kernels as fk

    device = torch.device("cuda")
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------------
    start = time.perf_counter()
    build = _build.build()
    _build.load_library()
    log(f"[2] kernels built in {time.perf_counter() - start:.1f} s "
        f"(nvcc {build.seconds:.1f} s) -> {build.library.name}")
    for source, text in sorted(build.logs.items()):
        report = dict.fromkeys(  # unique lines, in order
            line.strip() for line in text.splitlines()
            if "registers" in line or "spill" in line)
        for line in report:
            log(f"    {source}: {line}")

    model, params, config = convert.load_asset("ckpt_ks8", device=device)
    eq, grid = model.equation, model.grid
    dt = eq.stable_time_step(grid, u_scale=3.0)
    gen = torch.Generator().manual_seed(SEED)
    u0 = eq.initial_conditions(gen, grid, (BATCH,), device)
    log(f"    model: ckpt_ks8 ({config['equation']} conservative={eq.conservative}, "
        f"nx={grid.size}, {model.config.num_layers}x{model.config.filters} tower, "
        f"stencil {model.config.stencil_size}), dt={dt}, B={BATCH}")

    # ---- 3. fused_rhs against its plain version -----------------------------
    # float32 on both sides, tap sums in other orders and with FMAs, then a
    # face difference over dx that cancels most of the sum: 1e-4 of max|u_t|
    rhs_tol = 1e-4
    log("[3] fused_rhs vs plain")
    coeffs = model.coefficients(params, u0)
    rhs_args = (eq, grid, model.taps)
    rhs_err = check(f"flagship B={BATCH} nx={grid.size}", fk.fused_rhs(u0, coeffs, None, *rhs_args),
                    fk.fused_rhs_plain(u0, coeffs, None, *rhs_args), rhs_tol)
    for name, cons, size in [("burgers", True, 6), ("burgers", False, 5),
                             ("kdv", True, 6), ("kdv", False, 7),
                             ("ks", True, 6), ("ks", False, 7)]:
        m, p, u = perturbed_model(name, cons, size, device, nx=96)
        c = m.coefficients(p, u)
        f = torch.randn(u.shape, generator=gen).to(device) if m.equation.forced else None
        a = (m.equation, m.grid, m.taps)
        form = f"{name} {'conservative' if cons else 'direct'}"
        rhs_err = max(rhs_err, check(f"{form} B=3 nx=96{' forced' if f is not None else ''}",
                                     fk.fused_rhs(u, c, f, *a),
                                     fk.fused_rhs_plain(u, c, f, *a), rhs_tol))

    # ---- 4. fused_learned_rk4 against its plain version ---------------------
    # Both round the tower's inputs to bf16 at the same places and sum in
    # float32 in other orders, which can flip single bf16 roundings.
    # One step from a standard-normal state, compared on the increment
    # u(dt) - u(0), relative to the plain increment's max: the tower's output
    # moves it at every point. The tolerance must fail each planted fault.
    log("[4] fused_learned_rk4 vs plain")
    pack = fk.pack_learned_rk4(params, eq, grid, model.config.kernel_size,
                               model.constraint_layers, model.taps)
    rng = np.random.default_rng(SEED)
    u_rough = torch.from_numpy(rng.standard_normal((BATCH, grid.size)).astype(np.float32)).to(device)
    want_inc = fk.fused_learned_rk4_plain(u_rough, pack, dt, 1) - u_rough
    rk4_err = check(f"ckpt_ks8 one step from N(0,1), B={BATCH}, increment",
                    fk.fused_learned_rk4(u_rough, pack, dt, 1) - u_rough, want_inc, STEP_TOL)
    faults = planted_faults(params)
    fault_packs = {name: fk.pack_learned_rk4(p, eq, grid, model.config.kernel_size,
                                             model.constraint_layers, model.taps)
                   for name, p in faults.items()}
    for name, bad in fault_packs.items():
        check_catches(f"{name}, one step", fk.fused_learned_rk4(u_rough, bad, dt, 1) - u_rough,
                      want_inc, STEP_TOL)
    # 100 steps from the smooth seeded state: 1e-5 of max|u|, 9x the largest
    # reading on an H100 (1.1e-6); the planted faults read 9.3e-5 to 5.2e-4
    rk4_tol = 1e-5
    want = fk.fused_learned_rk4_plain(u0, pack, dt, STEPS)
    rk4_err = max(rk4_err, check(f"ckpt_ks8 {STEPS} steps B={BATCH}",
                                 fk.fused_learned_rk4(u0, pack, dt, STEPS), want, rk4_tol))
    for name, bad in fault_packs.items():
        check_catches(f"{name}, {STEPS} steps", fk.fused_learned_rk4(u0, bad, dt, STEPS),
                      want, rk4_tol)
    m, p, u = perturbed_model("kdv", True, 6, device, nx=128, batch=BATCH)
    kdv_pack = fk.pack_learned_rk4(p, m.equation, m.grid, m.config.kernel_size,
                                   m.constraint_layers, m.taps)
    kdv_dt = m.equation.stable_time_step(m.grid, u_scale=3.0)
    rk4_err = max(rk4_err, check(
        f"kdv conservative seeded {STEPS} steps B={BATCH}",
        fk.fused_learned_rk4(0.3 * u, kdv_pack, kdv_dt, STEPS),
        fk.fused_learned_rk4_plain(0.3 * u, kdv_pack, kdv_dt, STEPS), rk4_tol))

    # ---- 5. the main path -----------------------------------------------------
    log(f"[5] main path: {STEPS} RK4 steps at B={BATCH}")
    fk.fused_rhs.launches = 0
    fk.fused_learned_rk4.launches = 0
    _, traj_rhs = integrate.integrate(model.rhs_fn(params), u0, dt, STEPS)
    _, traj_fused = integrate.integrate_fused(
        model.fused_rk4_fn(params, dt, STEPS), u0, dt, STEPS, save_every=STEPS)
    torch.cuda.synchronize()
    launches = {"fused_rhs": fk.fused_rhs.launches,
                "fused_learned_rk4": fk.fused_learned_rk4.launches}
    log(f"    launches: {launches}")
    if launches != {"fused_rhs": 4 * STEPS, "fused_learned_rk4": 1}:
        raise AssertionError(f"the main path did not run through the kernels: {launches}")
    if traj_rhs.shape != (STEPS + 1, BATCH, grid.size) or traj_fused.shape != (2, BATCH, grid.size):
        raise AssertionError(f"shapes {traj_rhs.shape}, {traj_fused.shape}")
    # the fused route's tower is bf16-rounded, the rhs_fn route's float32;
    # from the smooth seeded state that moves u by 6.7e-7 of max|u| after
    # 100 steps on an H100: 1e-5. From a standard-normal state, one step,
    # ROUTE_STEP_TOL:
    check("integrate_fused vs integrate(rhs_fn)", traj_fused[-1], traj_rhs[-1], 1e-5)
    check("one step from N(0,1), increment, fused vs rhs_fn route",
          model.fused_rk4_fn(params, dt, 1)(u_rough) - u_rough,
          integrate.rk4_step(model.rhs_fn(params), u_rough, 0.0, dt) - u_rough, ROUTE_STEP_TOL)
    _, traj_plain = integrate.integrate(model.rhs_fn(params, use_kernel=False), u0, dt, STEPS)
    check("integrate(rhs_fn) kernel vs plain path", traj_rhs[-1], traj_plain[-1], 1e-4)
    ref_model, ref_params, _ = convert.load_asset("ckpt_ks8", device="cpu")
    small = u0[:8].double().cpu()
    _, ref = integrate.integrate(
        ref_model.rhs_fn({k: v.double() for k, v in ref_params.items()}, use_kernel=False),
        small, dt, 20)
    _, got = integrate.integrate(model.rhs_fn(params), u0[:8].contiguous(), dt, 20)
    check("card rhs_fn vs CPU float64, B=8, 20 steps", got[-1].cpu().double(), ref[-1], 1e-5)

    # ---- 6. times -------------------------------------------------------------
    log(f"[6] times (ms, median of {SAMPLES}) on {card}")
    times = {}
    for batch in (BATCH, THROUGHPUT_BATCH):
        u = u0 if batch == BATCH else eq.initial_conditions(gen, grid, (batch,), device)
        c = model.coefficients(params, u)
        rhs_kernel = lambda: fk.fused_rhs(u, c, None, *rhs_args)
        rhs_plain = lambda: fk.fused_rhs_plain(u, c, None, *rhs_args)
        path_kernel = lambda: integrate.integrate(model.rhs_fn(params), u, dt, STEPS, STEPS)
        path_plain = lambda: integrate.integrate(
            model.rhs_fn(params, use_kernel=False), u, dt, STEPS, STEPS)
        rk4_kernel = lambda: fk.fused_learned_rk4(u, pack, dt, STEPS)
        rk4_plain = lambda: fk.fused_learned_rk4_plain(u, pack, dt, STEPS)
        # "_ms": the kernel's device time (queued); "_call_ms": a wrapper
        # call as a caller pays it, host dispatch included; plain versions
        # and routes: call time
        row = {
            "fused_rhs_ms": time_ms(rhs_kernel, inner=100, queued=True),
            "fused_rhs_call_ms": time_ms(rhs_kernel, inner=100),
            "fused_rhs_plain_ms": time_ms(rhs_plain, inner=10),
            "fused_rhs_bound_ms": rhs_bound_ms(u, c, None),
            "rhs_fn_route_100_steps_ms": time_ms(path_kernel),
            "plain_route_100_steps_ms": time_ms(path_plain),
            "fused_learned_rk4_ms": time_ms(rk4_kernel, queued=True),
            "fused_learned_rk4_call_ms": time_ms(rk4_kernel),
            "fused_learned_rk4_plain_ms": time_ms(rk4_plain),
            "fused_learned_rk4_bound_ms": learned_rk4_bound_ms(pack, batch, STEPS),
        }
        # where the rhs_fn route's time goes: device time by kernel name over
        # one 100-step call (torch.profiler), against the call's event time.
        # The profiler can drop kernel records, so the sum is a lower bound.
        # the route's device time: one RK4 step queued behind a device-side
        # sleep (no host in it; the card's own gaps between kernels count as
        # busy), times STEPS. Launches: one RHS, host side and device side.
        rhs = model.rhs_fn(params)
        t0 = torch.zeros((), device=device)
        row["rhs_fn_route_device_ms"] = STEPS * time_ms(
            lambda: integrate.rk4_step(rhs, u, t0, dt), queued=True)
        row["rhs_fn_route_idle_share"] = (
            1 - row["rhs_fn_route_device_ms"] / row["rhs_fn_route_100_steps_ms"])
        host_launches, device_kernels = launch_count(lambda: rhs(u, t0))
        row["rhs_fn_launches_per_rhs"] = host_launches
        row["rhs_fn_device_kernels_per_rhs"] = device_kernels
        path = device_profile(path_kernel, 1)
        row["rhs_fn_route_profiled_device_ms"] = sum(path.values()) / 1e3  # a lower bound
        row["rhs_fn_route_profiled_fused_rhs_ms"] = sum(
            t for k, t in path.items() if "fused_rhs_kernel" in k) / 1e3
        times[batch] = row
        log(f"    B={batch}: " + json.dumps(row))
        for name, us in sorted(path.items(), key=lambda kv: -kv[1])[:8]:
            log(f"      rhs_fn route kernel {us / 1e3:9.3f} ms  {name[:110]}")

    # ---- 7. report ------------------------------------------------------------
    flagship = times[BATCH]
    kernels = [
        {
            "name": "fused_rhs",
            "route": "cuda",
            "source": "pde_superresolution_torch/csrc/fused_rhs.cu",
            "replaces": "pde_superresolution_tpu/ops/pallas_kernels.py:135",
            "launches": launches["fused_rhs"],
            "max_abs_err": rhs_err,
            "ms": flagship["fused_rhs_ms"],
            "call_ms": flagship["fused_rhs_call_ms"],
            "plain_ms": flagship["fused_rhs_plain_ms"],
            "bound_ms": flagship["fused_rhs_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "fused_learned_rk4",
            "route": "cuda",
            "source": "pde_superresolution_torch/csrc/fused_learned_rk4.cu",
            "replaces": "pde_superresolution_tpu/ops/pallas_kernels.py:390",
            "launches": launches["fused_learned_rk4"],
            "max_abs_err": rk4_err,
            "ms": flagship["fused_learned_rk4_ms"],
            "call_ms": flagship["fused_learned_rk4_call_ms"],
            "plain_ms": flagship["fused_learned_rk4_plain_ms"],
            "bound_ms": flagship["fused_learned_rk4_bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
        },
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
