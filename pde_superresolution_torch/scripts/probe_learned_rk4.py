"""Time ``fused_learned_rk4`` with other numbers of trajectories per block.

    python -m pde_superresolution_torch.scripts.probe_learned_rk4

Needs a CUDA device and ``nvcc``. For each setting it rebuilds the kernels
with ``-DPDE_MAX_TEAMS=<teams>`` (the block's thread bound, and so the
registers a thread may use, follow from it), sets the wrapper's caps to
match, checks 10 steps against the plain version and prints, per 100 RK4
steps of the KS-8x (unforced) and Burgers-8x (forced, 20 terms) checkpoints,
and of both widened to ``fused_kernels.WIDE_CHANNELS`` filters
(``convert.widen_params``: the 128-channel form, one trajectory a block,
whatever the caps), the kernel's time at several batches (CUDA events,
median of 3) with the launch geometry and ptxas' registers and spills of the
32- and 128-channel instantiations. The first setting is run again at the
end, so drift shows.
The package's default is the first setting; nothing is kept from a run.

``--checkpoints`` and ``--filters`` choose the towers (by default the two
checkpoints at their own width and at ``WIDE_CHANNELS``). ``--nx`` times
the checkpoints on other grids, built as ``run_ensemble
--domain_factor`` builds them (a multiple of each checkpoint's own nx, 128),
where one block may not hold a trajectory; ``--clusters`` times the split
form with that many blocks per trajectory (``auto``: the launch
``learned_rk4_launch`` picks, whole trajectories a block where they fit), as
the whole form is timed by trajectories per block. A cluster too small for a
shape is skipped with the refusal's reason. For example
``--settings 4:4 --nx 128,1280,2048 --clusters auto,2,4,8 --batches 256,10240``.

``--profile`` instead builds with ``-DPDE_PROFILE``: the kernel then counts
clock cycles by phase of one RHS evaluation (``clock64`` around each phase,
which also keeps the compiler from overlapping them, so the sum is above an
ordinary build's time) and writes them over its output. It prints cycles per
RHS for the first and last trajectory of each batch, warp 0 of the team.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import tempfile
from pathlib import Path

import torch

from pde_superresolution_torch import convert
from pde_superresolution_torch.ops import _build
from pde_superresolution_torch.ops import fused_kernels as fk

STEPS = 100
FORCING_T0 = 3.7
WIDE_NOISE = 0.02  # chip_smoke.WIDE_NOISE


def time_ms(fn, samples: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PHASES = ("layer 0 (mma.sync)", "layer 0 epilogue, stores", "later layers (wgmma)",
          "later layers' epilogues, stores", "heads, z tile", "projection, stencil, flux",
          "barriers between layers", "barrier after the fluxes", "forcing, stage combine",
          "barrier after the combine")


def load_case(name: str, filters: int, nx: int, device, stems: Path):
    """The checkpoint ``name`` (widened to ``filters`` when given, written to
    ``stems`` first) on ``nx`` points, built as ``run_ensemble --domain_factor``
    builds it: (model, params)."""
    import json

    import numpy as np

    from pde_superresolution_torch.scripts import run_ensemble

    if filters:
        _, params, config = convert.load_asset(name, device=device)
        config = {**config, "model": {**config["model"], "filters": filters}}
        params = convert.widen_params(params, filters, 11, WIDE_NOISE)
        stem = stems / f"{name}_{filters}"
        stem.with_suffix(".json").write_text(json.dumps(config))
        np.savez(stem.with_suffix(".npz"), **convert.npz_arrays_from_params(params))
        name = str(stem)
    base = convert.load_checkpoint(name, device=device)[0].grid.size
    ens = run_ensemble.setup(run_ensemble.build_parser().parse_args(
        ["--checkpoint_dir", name, "--num_trajectories", "1", "--domain_factor",
         str(nx // base), "--device", str(device)]))
    return ens.model, ens.params


def rebuild(teams: int, profile: bool = False) -> list:
    """Build and load the library for ``teams`` per block; ptxas' lines for
    the 32-channel kernels (empty when the build was already on disk)."""
    _build.NVCC_FLAGS[:] = [f for f in _build.NVCC_FLAGS if not f.startswith("-DPDE_")]
    _build.NVCC_FLAGS.append(f"-DPDE_MAX_TEAMS={teams}")
    if profile:
        _build.NVCC_FLAGS.append("-DPDE_PROFILE")
    _build.build.cache_clear()
    _build.load_library.cache_clear()
    _build.load_library()
    report, keep = [], False
    for line in _build.build().logs.get("fused_learned_rk4.cu", "").splitlines():
        if "Compiling entry function" in line:
            keep = "kernelILi4E" in line or "kernelILi16E" in line
            width = 128 if "kernelILi16E" in line else 32
            forced = "Lb1E" in line
        elif keep and ("registers" in line or "spill" in line):
            report.append(f"{width} channels, {'forced' if forced else 'unforced'}: "
                          + line.replace("ptxas info    : ", "").strip())
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--settings", default="4:4,6:4,8:4",
                        help="comma-separated teams:forced_teams caps per block")
    parser.add_argument("--batches", default="256,1024,4096,10240")
    parser.add_argument("--profile", action="store_true",
                        help="cycles per RHS by phase (first setting only)")
    parser.add_argument("--nx", default="128",
                        help="comma-separated grids, multiples of the checkpoints' 128 points")
    parser.add_argument("--clusters", default="auto",
                        help="comma-separated blocks per trajectory of the split form, or auto")
    parser.add_argument("--checkpoints", default="ckpt_ks8,ckpt_burgers8",
                        help="comma-separated committed checkpoints")
    parser.add_argument("--filters", default=f"0,{fk.WIDE_CHANNELS}",
                        help="comma-separated tower widths (0: the checkpoint's own)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_learned_rk4: no CUDA device is available")
    device = torch.device("cuda")
    settings = [tuple(int(n) for n in s.split(":")) for s in args.settings.split(",")]
    batches = [int(b) for b in args.batches.split(",")]
    grids = [int(n) for n in args.nx.split(",")]
    clusters = [None if c == "auto" else int(c) for c in args.clusters.split(",")]

    cases = {}
    gen = torch.Generator().manual_seed(0)
    stems = Path(tempfile.mkdtemp(prefix="probe_learned_rk4_"))
    for filters, checkpoint, nx in [(int(f), n, x) for f in args.filters.split(",")
                                    for n in args.checkpoints.split(",") for x in grids]:
        model, params = load_case(checkpoint, filters, nx, device, stems)
        name = checkpoint + (f" at {filters} filters" if filters else "") + f", nx {nx}"
        eq, grid = model.equation, model.grid
        dt = model.stable_time_step(u_scale=3.0)
        pack = fk.pack_learned_rk4(params, eq, grid, model.config.kernel_size,
                                   model.constraint_layers, model.taps)
        u = eq.initial_conditions(gen, grid, (max(batches),), device)
        forcing = None
        if eq.forced:
            forcing = fk.pack_forcing(eq.sample_forcing(gen, (max(batches),), device),
                                      FORCING_T0, eq, grid, dt, max(batches))
        cases[name] = (pack, dt, u, forcing)

    if args.profile:
        teams, forced_teams = settings[0]
        rebuild(teams, profile=True)
        fk.MAX_TEAMS, fk.MAX_TEAMS_FORCED = teams, forced_teams
        steps = 20
        print(f"card: {torch.cuda.get_device_name(0)}; cycles per RHS by phase, warp 0, "
              f"caps {teams}:{forced_teams}, {steps} steps")
        for name, (pack, dt, u, forcing) in cases.items():
            for batch in batches:
                fb = None if forcing is None else type(forcing)(
                    *(leaf[:batch].contiguous() for leaf in forcing))
                out = fk.fused_learned_rk4(u[:batch].contiguous(), pack, dt, steps, forcing=fb)
                cycles = out[[0, batch - 1], :len(PHASES)].cpu() / (4 * steps)
                print(f"{name} B={batch}: first trajectory, last trajectory")
                for phase, (first, last) in zip(PHASES, cycles.t().tolist()):
                    print(f"  {phase:34s} {first:8.0f} {last:8.0f}")
                print(f"  {'sum':34s} {float(cycles[0].sum()):8.0f} {float(cycles[1].sum()):8.0f}")
        return
    print(f"card: {torch.cuda.get_device_name(0)}; per {STEPS} RK4 steps, ms")
    for teams, forced_teams in settings + settings[:1]:
        for line in rebuild(teams):
            print(f"  max teams {teams}: {line}")
        fk.MAX_TEAMS, fk.MAX_TEAMS_FORCED = teams, forced_teams
        for name, (pack, dt, u, forcing) in cases.items():
            terms = 0 if forcing is None else forcing.amplitude.shape[-1]
            for batch, cluster in [(b, c) for b in batches for c in clusters]:
                ub = u[:batch].contiguous()
                fb = None if forcing is None else type(forcing)(
                    *(leaf[:batch].contiguous() for leaf in forcing))
                nx = ub.shape[1]
                refusal = fk.learned_rk4_refusal(pack, nx, terms, cluster=cluster)
                if refusal:
                    print(f"{name} B={batch} cluster {cluster}: skipped ({refusal})")
                    continue
                if batch == batches[0]:
                    want = fk.fused_learned_rk4_plain(ub, pack, dt, 10, fb)
                    got = fk.fused_learned_rk4(ub, pack, dt, 10, forcing=fb, cluster=cluster)
                    # a model may blow up on some members (KdV-16x does) and
                    # amplify roundings: as chip_smoke.hold_run holds a run, the
                    # kernel blows up on the same members and 90% of the others
                    # are within 1e-4, or 4x the plain version's own distance
                    # from float64 sums (unforced) where that is larger
                    finite = torch.isfinite(want).all(-1)
                    if not torch.equal(finite, torch.isfinite(got).all(-1)):
                        raise AssertionError(f"{name}: kernel and plain blow up on other members")

                    def spread(a, b):
                        return float(((a - b)[finite].abs().amax(-1)
                                      / b[finite].abs().amax(-1)).quantile(0.9))

                    rel, limit = spread(got, want), 1e-4
                    if fb is None:
                        exact = fk.fused_learned_rk4_plain(
                            ub.double(), dataclasses.replace(pack, flat=pack.flat.double()),
                            dt, 10)
                        limit = max(limit, 4 * spread(want.double(), exact))
                    if not rel < limit:
                        raise AssertionError(f"{name}: kernel vs plain after 10 steps: {rel} "
                                             f"(limit {limit})")
                launch = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster)
                ms = time_ms(lambda: fk.fused_learned_rk4(ub, pack, dt, STEPS, forcing=fb,
                                                          cluster=cluster))
                form = (f"{launch.blocks} blocks x {launch.teams} trajectories" if not launch.split
                        else f"clusters of {launch.cluster} blocks x {launch.segment} points"
                        + (", weights streamed" if launch.stream else ""))
                print(f"caps {teams}:{forced_teams} {name} B={batch}: {ms:.3f} ms "
                      f"({form}, {launch.threads} threads, {launch.shared_bytes} bytes shared; "
                      f"{batch * STEPS * nx / ms * 1e3:,.0f} cell-steps/s)")


if __name__ == "__main__":
    main()
