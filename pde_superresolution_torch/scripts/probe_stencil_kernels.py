"""Time ``fused_rhs`` and ``fused_rk4`` at the main paths' shapes, beside the launch floor.

    python -m pde_superresolution_torch.scripts.probe_stencil_kernels [--label NAME]

Needs a CUDA device and ``nvcc``. It builds the package's kernels, prints
ptxas' registers, stack frames and spills of both kernels' instantiations and
counts local-memory (``LDL``/``STL``) and barrier (``BAR``) instructions in
their SASS (``cuobjdump``). Then, each on CUDA events with the card held in a
device-side sleep while the host queues 100 calls (median of 5):

  * an empty kernel's launch (the floor under any kernel), when the library
    has one;
  * ``fused_rhs`` with the KS-8x checkpoint's coefficients at B=256 and
    4096 (nx=128, 3 orders of 6 taps) and the Burgers-8x checkpoint's in the
    forced form at B=10240 (2 orders of 8 taps plus the forcing), beside the
    bytes bound (each input read once, the output written once, at 3.35
    TB/s);
  * ``fused_rk4`` (KS conservative, nx=128) per 100 RK4 steps at B=256, 4096
    and 10240, beside the operations bound (2 flops per tap, 12 per point
    and stage, at 67 TFLOP/s), and per stage for one trajectory alone;
    at each of ``--warps`` warps per block (when the package has
    ``rk4_launch``);
  * ``fused_rk4`` beyond the classic scheme at nx=128 (KS at accuracy order
    4, taps at run time; KdV on 512 points; KS on 2048, the block form) at
    B=256, 4096 and 10240, KS at accuracy order 4 on 2048 points and with 40
    taps an order at nx=128 (B=256 and 10240) and KS on 16384 points
    (B=256), each beside its operations bound
    (a tree whose kernel refuses a shape prints the refusal);
  * with ``--clusters`` (a tree whose ``fused_rk4`` takes ``cluster=``):
    the block form forced over each of those cluster sizes at nx 2048
    (B=10240) and 16384 (B=256), and over one block at 40 taps (beside the
    rule's rows form);
  * with ``--classic-points P,...``: the classic rows of the block form also
    with its compiled taps at each P (``fk.RK4_BLOCK_CLASSIC_POINTS``);
  * with ``--rival``: the block form forced over one block against the
    run-time-tap register form at nx 128 and 512 (KS at accuracy order 4
    and with 16 taps, B=256 and 10240), in turns.

Each kernel is checked against its plain version at every timed shape
before it is timed. The script uses only the wrappers' public calls, so it
can time an older tree of the package from that tree's root; ``--label``
tags its lines. One JSON line at the end holds every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path
from typing import Optional

import torch

from pde_superresolution_torch import convert, equations
from pde_superresolution_torch.ops import _build
from pde_superresolution_torch.ops import fused_kernels as fk

STEPS = 100
SLEEP_CYCLES = 60_000_000  # about 30 ms of device-side sleep at H100 clocks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12
FORCING_T0 = 3.7


def time_ms(fn, inner: int = 100, samples: int = 5) -> float:
    """Median per-call device time of ``inner`` calls queued behind a
    device-side sleep, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rhs_bytes_bound_ms(u, coeffs, f) -> float:
    floats = u.numel() * (2 + (f is not None)) + sum(c.numel() for c in coeffs.values())
    return 1e3 * 4 * floats / HBM_BYTES_PER_S


def rk4_ops_bound_ms(scheme, batch: int) -> float:
    taps = sum(len(t) for t in scheme.taps.values())
    flops = scheme.grid.size * batch * scheme.num_steps * 4 * (2 * taps + 12)
    return 1e3 * flops / FP32_FLOPS


def ptxas_lines(build) -> list:
    """ptxas' report per instantiation of the two kernels (``fused_rk4``'s
    sources ``fused_rk4*.cu``), one line each."""
    lines = []
    for source in sorted(n for n in build.logs if n.startswith(("fused_rk4", "fused_rhs."))):
        name = None
        for line in build.logs.get(source, "").splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                name = found.group(1)
            elif name and ("stack frame" in line or "registers" in line):
                lines.append(f"{source} {name}: {line.replace('ptxas info    :', '').strip()}")
    return lines


def read_sass(library) -> Optional[str]:
    """The SASS of every kernel in ``library`` (``cuobjdump -sass``), or
    None where the toolkit has no cuobjdump beside nvcc."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    return subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          timeout=300).stdout


def sass_counts(library, sass: Optional[str] = None) -> dict:
    """{kernel: {LDL, STL, BAR}} instruction counts of the two kernels (every
    form of ``fused_rk4``), from ``sass`` (``read_sass``'s text) or read
    from ``library``."""
    sass = read_sass(library) if sass is None else sass
    if sass is None:
        return {}
    counts, name = {}, None
    ops = re.compile(r"\b(LDL|STL|BAR)\b")
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if ("fused_rk4_" in name or "fused_rhs_kernel" in name) else None
            if name:
                counts[name] = {"LDL": 0, "STL": 0, "BAR": 0}
        elif name:
            for op in set(ops.findall(line)):
                counts[name][op] += 1
    return counts


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--warps", default="4,8",
                        help="fused_rk4 warps per block to time at B=10240")
    parser.add_argument("--more", action="store_true",
                        help="also fused_rhs for KS at B=10240 and Burgers at B=4096, and "
                             "Burgers unforced at B=10240")
    parser.add_argument("--rhs-block-points", default="128,256,512",
                        help="fused_rhs points per block to time at B >= 4096 (when the "
                             "package has rhs_launch)")
    parser.add_argument("--clusters", default="",
                        help="fused_rk4's block form forced over these blocks a trajectory "
                             "at nx 2048 and 16384, e.g. 1,2,4,8,16")
    parser.add_argument("--classic-points", default="",
                        help="also time the compiled-tap block form at nx >= 2048 with "
                             "fk.RK4_BLOCK_CLASSIC_POINTS set to each of these (the C entry "
                             "refuses a P its kernels are not built for)")
    parser.add_argument("--rival", action="store_true",
                        help="fused_rk4's block form against the run-time-tap register form")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_stencil_kernels: no CUDA device is available")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    tag = f"[{args.label}]"
    print(f"{tag} card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build = _build.build()
    lib = _build.load_library()
    for line in ptxas_lines(build):
        print(f"{tag} ptxas {line}")
    sass = sass_counts(build.library)
    for name, row in sass.items():
        print(f"{tag} SASS {name}: {row}")
    result = {"label": args.label, "card": card, "sass": sass}

    empty = getattr(lib, "pde_empty_kernel", None)
    if empty is not None:
        empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        result["launch_floor_ms"] = time_ms(lambda: empty(stream))
        print(f"{tag} empty kernel: {1e3 * result['launch_floor_ms']:.3f} us per launch")

    gen = torch.Generator().manual_seed(0)
    ks, ks_params, _ = convert.load_asset("ckpt_ks8", device=device)
    bm, b_params, _ = convert.load_asset("ckpt_burgers8", device=device)
    rhs = {}
    cases = [("ks8", ks, ks_params, 256, False), ("ks8", ks, ks_params, 4096, False),
             ("burgers8 forced", bm, b_params, 10240, True)]
    if args.more:
        cases += [("ks8", ks, ks_params, 10240, False), ("burgers8 forced", bm, b_params, 4096, True),
                  ("burgers8", bm, b_params, 10240, False)]
    for name, model, params, batch, forced in cases:
        eq, grid = model.equation, model.grid
        u = eq.initial_conditions(gen, grid, (batch,), device)
        coeffs = model.coefficients(params, u)
        f = None
        if forced:
            x = torch.as_tensor(grid.x, dtype=torch.float32, device=device)
            f = equations.forcing_term(eq.sample_forcing(gen, (batch,), device), x, FORCING_T0,
                                       eq.period, grid.dx).contiguous()
        a = (eq, grid, model.taps)
        want = fk.fused_rhs_plain(u, coeffs, f, *a)
        rel = float((fk.fused_rhs(u, coeffs, f, *a) - want).abs().max() / want.abs().max())
        if not rel <= 1e-4:
            raise AssertionError(f"fused_rhs {name} B={batch}: {rel} of max|u_t|")
        ms = time_ms(lambda: fk.fused_rhs(u, coeffs, f, *a))
        bound = rhs_bytes_bound_ms(u, coeffs, f)
        key = batch if (name, batch) in [(n, b) for n, _, _, b, _ in cases[:3]] else f"{name} {batch}"
        rhs[key] = {"ms": ms, "bytes_bound_ms": bound, "rel_err": rel}
        if hasattr(fk, "rhs_launch") and batch >= 4096:
            default = fk.RHS_BLOCK_POINTS
            for points in (int(n) for n in args.rhs_block_points.split(",")):
                fk.RHS_BLOCK_POINTS = points
                rhs[key][f"ms_{points}_points"] = time_ms(lambda: fk.fused_rhs(u, coeffs, f, *a))
                print(f"{tag} fused_rhs {name} B={batch}, {fk.rhs_launch(batch, grid.size, a[2])}: "
                      f"{1e3 * rhs[key][f'ms_{points}_points']:.3f} us")
            fk.RHS_BLOCK_POINTS = default
        print(f"{tag} fused_rhs {name} B={batch}: {1e3 * ms:.3f} us, bytes bound "
              f"{1e3 * bound:.3f} us ({100 * bound / ms:.0f}%), vs plain {rel:.2e}")
        del coeffs, f, want
    result["fused_rhs"] = rhs

    eq, grid = ks.equation, ks.grid
    dt = ks.stable_time_step(u_scale=3.0)
    u_all = eq.initial_conditions(gen, grid, (10240,), device)
    base = fk.make_fused_rk4(eq, grid, dt, STEPS)
    has_warps = hasattr(fk, "rk4_launch")  # the wrapper reads fk.RK4_MAX_WARPS
    rk4 = {}
    for batch in (256, 4096, 10240):
        u = u_all[:batch].contiguous()
        want = fk.fused_rk4_plain(u, base.scheme)
        rel = float((base(u) - want).abs().max() / want.abs().max())
        if not rel <= 1e-6:
            raise AssertionError(f"fused_rk4 B={batch}: {rel} of max|u|")
        row = {"ms": time_ms(lambda: base(u), inner=5), "ops_bound_ms": rk4_ops_bound_ms(
            base.scheme, batch), "rel_err": rel}
        if has_warps and batch == 10240:
            default = fk.RK4_MAX_WARPS
            for w in (int(n) for n in args.warps.split(",")):
                fk.RK4_MAX_WARPS = w
                row[f"ms_{w}_warps"] = time_ms(lambda: base(u), inner=5)
            fk.RK4_MAX_WARPS = default
        rk4[batch] = row
        print(f"{tag} fused_rk4 B={batch}, {STEPS} steps: "
              + ", ".join(f"{k} {v:.4g}" for k, v in row.items()))
    long = fk.make_fused_rk4(eq, grid, dt, 10 * STEPS)
    alone = u_all[:1].contiguous()
    stage_us = 1e3 * time_ms(lambda: long(alone), inner=2) / (4 * 10 * STEPS)
    rk4["stage_us_one_trajectory"] = stage_us
    print(f"{tag} fused_rk4, one trajectory alone: {stage_us:.4f} us per stage")
    result["fused_rk4"] = rk4
    domain = {}
    # (label, equation, nx, scheme, batches)
    shapes = (("ks accuracy order 4", "ks", 128, {"accuracy_order": 4}, (256, 4096, 10240)),
              ("kdv nx 512", "kdv", 512, {}, (256, 4096, 10240)),
              ("ks nx 2048", "ks", 2048, {}, (256, 4096, 10240)),
              ("ks accuracy order 4 nx 2048", "ks", 2048, {"accuracy_order": 4}, (256, 10240)),
              ("ks stencil 40", "ks", 128, {"stencil_size": 40}, (256, 10240)),
              ("ks nx 16384", "ks", 16384, {}, (256,)))
    clusters = [int(c) for c in args.clusters.split(",") if c]
    for label, name, nx, scheme, batches in shapes:
        period = equations.from_name(name).period * nx / 128  # the same dx
        e = equations.from_name(name, conservative=True, period=period)
        g = type(grid)(nx, period)
        advance = fk.make_fused_rk4(e, g, e.stable_time_step(g) / (4 if scheme else 1), STEPS,
                                    **scheme)
        for batch in batches:
            u = 0.3 * e.initial_conditions(gen, g, (batch,), device)
            try:
                got = advance(u)
            except ValueError as refusal:
                print(f"{tag} fused_rk4 {label} B={batch}: refused ({refusal})")
                break
            if not torch.equal(got, fk.fused_rk4_plain(u, advance.scheme)):
                raise AssertionError(f"fused_rk4 {label} B={batch}: not its plain version")
            row = {"ms": time_ms(lambda: advance(u), inner=5),
                   "ops_bound_ms": rk4_ops_bound_ms(advance.scheme, batch)}
            if has_warps:
                row["launch"] = fk.rk4_launch(batch, nx, fk.rk4_is_classic(advance.scheme),
                                              advance.scheme.taps)._asdict()
            forced = (clusters if not scheme and nx in (2048, 16384)
                      and batch == (10240 if nx == 2048 else 256) else [])
            for c in forced:
                try:
                    fk.rk4_launch(batch, nx, fk.rk4_is_classic(advance.scheme),
                                  advance.scheme.taps, c)
                except ValueError as refusal:
                    print(f"{tag} fused_rk4 {label} B={batch} over {c} blocks: {refusal}")
                    continue
                if not torch.equal(fk.fused_rk4(u, advance.scheme, cluster=c), got):
                    raise AssertionError(f"fused_rk4 {label} B={batch} over {c} blocks")
                row[f"ms_cluster_{c}"] = time_ms(
                    lambda: fk.fused_rk4(u, advance.scheme, cluster=c), inner=5)
            if scheme.get("stencil_size") == 40 and clusters:  # the block form beside the rule's
                if not torch.equal(fk.fused_rk4(u, advance.scheme, cluster=1), got):
                    raise AssertionError(f"fused_rk4 {label} B={batch} over one block")
                row["ms_block_form"] = time_ms(
                    lambda: fk.fused_rk4(u, advance.scheme, cluster=1), inner=5)
            if args.classic_points and not scheme and nx >= 2048:
                default = fk.RK4_BLOCK_CLASSIC_POINTS
                for p in (int(n) for n in args.classic_points.split(",")):
                    fk.RK4_BLOCK_CLASSIC_POINTS = p
                    if not torch.equal(advance(u), got):
                        raise AssertionError(f"fused_rk4 {label} B={batch} at {p} points")
                    row[f"ms_{p}_points"] = time_ms(lambda: advance(u), inner=5)
                fk.RK4_BLOCK_CLASSIC_POINTS = default
            domain[f"{label} B={batch}"] = row
            print(f"{tag} fused_rk4 {label} B={batch}, {STEPS} steps: "
                  + ", ".join(f"{k} {v:.4g}" for k, v in row.items() if k != "launch")
                  + (f"; {row['launch']}" if "launch" in row else ""))
            del u, got
    result["fused_rk4_domain"] = domain
    if args.rival:
        rival = {}
        for nx, scheme in ((128, {"accuracy_order": 4}), (128, {"stencil_size": 16}),
                           (512, {"accuracy_order": 4}), (512, {"stencil_size": 16})):
            period = equations.from_name("ks").period * nx / 128
            e = equations.from_name("ks", conservative=True, period=period)
            g = type(grid)(nx, period)
            advance = fk.make_fused_rk4(e, g, e.stable_time_step(g) / 4, STEPS, **scheme)
            for batch in (256, 10240):
                u = 0.3 * e.initial_conditions(gen, g, (batch,), device)
                want = fk.fused_rk4_plain(u, advance.scheme)

                def registers(u=u, advance=advance):
                    return advance(u)

                def block(u=u, advance=advance):
                    return fk.fused_rk4(u, advance.scheme, cluster=1)

                if not (torch.equal(registers(), want) and torch.equal(block(), want)):
                    raise AssertionError(f"fused_rk4 rival nx={nx} {scheme} B={batch}")
                times = {"registers": [], "block": []}
                for form, fn in (("registers", registers), ("block", block), ("block", block),
                                 ("registers", registers)):
                    times[form].append(time_ms(fn, inner=5))
                key = f"ks {scheme} nx {nx} B={batch}"
                rival[key] = times
                print(f"{tag} fused_rk4 rival {key}: registers {times['registers']} ms, "
                      f"block (one block) {times['block']} ms; "
                      f"{fk.rk4_launch(batch, nx, False, advance.scheme.taps, 1)}")
        result["fused_rk4_rival"] = rival
    print(json.dumps(result))


if __name__ == "__main__":
    main()
