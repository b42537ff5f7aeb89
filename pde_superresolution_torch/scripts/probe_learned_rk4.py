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
form with that many blocks per trajectory and ``--groups`` with that many
warp groups a block (``auto``: the launch ``learned_rk4_launch`` picks,
whole trajectories a block where they fit; ``all``: every cluster size or
group count), as the whole form is timed by trajectories per block. A
cluster too small for a shape is skipped with the refusal's reason. For
example ``--settings 4:4 --nx 1280,2048 --clusters all --groups all
--batches 10240`` (the sweep behind the split form's choice; each line also
gives the blocks an SM, busy warps and passes ``fk.split_occupancy``
counts).

``--per_team`` times the whole form with that many trajectories a team
(``auto``: the launch's own; ``1``: unpacked, the launch of every batch
before the kernel packed short grids; ``all``: 1, 2, 4 and 8 where the grid
takes them). The packed A/B at the zoo's short grids, on the same kernels:
``--settings 4:4 --checkpoints ckpt_ks32,ckpt_kdv16_f64,ckpt_burgers64
--filters 0 --nx 16,32 --batches 256,10240 --per_team 1,auto`` (a grid
that is no multiple of a checkpoint's own is skipped).

``--slots`` and ``--share`` time the whole form at 128 filters (the ring)
with that many slots of a conv tap's slice and blocks of a cluster
sharing each slice's copy (``auto``: the rule's ``fk.RING_SLOTS`` and
``fk.WIDE_CLUSTER``; ``all``: 1 to 5 slots, where they fit, and 1, 2, 4
and 8 blocks), setting the rule's constants for the launch: the sweep
behind their values is ``--checkpoints ckpt_ks8,ckpt_burgers8 --filters
128 --batches 256,10240 --slots all --share all``.

``--src DIR[,DIR...]`` builds the kernels from other ``csrc`` trees (``-``:
this package's own) and times each launch on every tree in turn, forward
then backward (A B B A), each tree's 10 steps bit for bit the first's: an
older tree (``git archive`` of a parent commit's ``csrc``) is driven
through this package's wrapper, so give it launches its entry takes (the
split form before warp groups: ``--groups 1``; the whole form before packed
teams: ``--per_team 1``); a tree without the ring's source
(``fused_learned_rk4_wide.cu``) gets the whole form at 128 filters as it
was before the ring (``window_launch``: one warp group a block, one window
of a slice). For example ``--src
_checkout/parent/pde_superresolution_torch/csrc,- --checkpoints ckpt_ks8
--filters 256 --nx 128 --clusters 1 --groups 1 --batches 10240 --steps 20
--settings 4:4``. ``--ab`` and ``--profile`` build from the first tree.

``--sass`` with two ``--src`` trees instead compares the SASS of the whole
form's one-trajectory-a-team kernels (every width, forced or not) of the
two builds, instruction by instruction without addresses and encodings
(``cuobjdump -sass``), and prints each kernel's instruction, HMMA and GMMA
counts: for example the parent's ``csrc`` against this one's, whose P = 1
kernels must be the parent's.

``--ab ROUNDS`` instead times, for each split shape and batch, the launch the
choice took before warp groups (``fewest_blocks``: the fewest blocks that
hold the weights whole, else the fewest that stream them, one warp group a
block) against the one ``learned_rk4_launch`` picks, on the same kernels, in turns
(parent, new, new, parent) ROUNDS times, after checking that both give the
same result bit for bit over 10 steps. For example ``--ab 2 --nx
1280,2048 --filters 0 --batches 10240``.

``--profile`` instead builds with ``-DPDE_PROFILE``: the kernel then counts
clock cycles by phase of one RHS evaluation (``clock64`` around each phase,
which also keeps the compiler from overlapping them, so the sum is above an
ordinary build's time) and writes each warp's over its team's own output
(warp w's from float 10 w of the team's first trajectory on). It prints
cycles per RHS for the first and the last team of each batch, warp 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from pde_superresolution_torch import convert
from pde_superresolution_torch.ops import _build
from pde_superresolution_torch.ops import fused_kernels as fk

STEPS = 100
RING_SLOTS, WIDE_CLUSTER = fk.RING_SLOTS, fk.WIDE_CLUSTER  # the package's rule
CHECK_BATCH = 256  # trajectories of the 10-step check (the plain version's memory)
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
          "barrier after the combine", "ring waits (streamed weights)")


def load_case(name: str, filters: int, nx: int, device, stems: Path):
    """The checkpoint ``name`` (widened to ``filters`` when given, written to
    ``stems`` first) on ``nx`` points, built as ``run_ensemble --domain_factor``
    builds it: (model, params); None where nx is no multiple of its grid."""
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
    if nx % base:
        return None
    ens = run_ensemble.setup(run_ensemble.build_parser().parse_args(
        ["--checkpoint_dir", name, "--num_trajectories", "1", "--domain_factor",
         str(nx // base), "--device", str(device)]))
    return ens.model, ens.params


def fewest_blocks(pack, nx: int, terms: int, batch: int):
    """The split launch the choice took before warp groups (kept to time
    against the occupancy rule): the fewest blocks whose segments fit beside
    the whole weights, else the fewest beside the window of streamed
    weights, one warp group a block. None where one block holds the
    trajectory."""
    if not fk.learned_rk4_launch(pack, nx, terms, batch).split:
        return None
    for stream in (False, True):
        for cluster in range(1, fk.MAX_CLUSTER + 1):
            if fk.learned_rk4_refusal(pack, nx, terms, cluster=cluster, groups=1):
                continue
            launch = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster, groups=1)
            if launch.stream == stream:
                return launch
    return None


def launch_text(launch, pack) -> str:
    """A launch in words, with what one SM holds of a split one
    (``fk.split_occupancy``)."""
    if launch.slots and not launch.split:
        return (f"{launch.blocks} blocks x {launch.groups} groups, a ring of {launch.slots} "
                f"slots shared by clusters of {launch.multicast}")
    if not launch.split:
        return (f"{launch.blocks} blocks x {launch.teams} teams x {launch.per_team} "
                "trajectories")
    per_sm, busy, passes = fk.split_occupancy(launch, pack.padded_channels >= fk.WIDE_CHANNELS)
    return (f"clusters of {launch.cluster} blocks x {launch.segment} points, {launch.groups} "
            f"groups" + (f", weights streamed through {launch.slots} slots" if launch.stream
                         else "")
            + f"; {per_sm} blocks an SM, {busy} busy warps, {passes} passes")


def window_launch(ring, pack, batch: int):
    """The whole form at 128 filters as it was before the ring, where the
    launch ``ring`` takes the ring: one warp group a block (one trajectory)
    beside one 32 KB window of a conv tap's slice."""
    return fk.LearnedRK4Launch(
        teams=1, threads=fk.TEAM_THREADS, team_bytes=ring.team_bytes,
        shared_bytes=fk._window_bytes(pack) + ring.team_bytes, blocks=batch,
        segment=ring.segment, stream=True)


def split_window_launch(launch, pack):
    """A split launch that streams, as a tree before the split form's ring
    takes it: the same blocks and warp groups, no producer warp, one window
    of a slice in place of the ring's slots and barriers."""
    return launch._replace(
        threads=fk.TEAM_THREADS * launch.groups, slots=0,
        shared_bytes=fk._window_bytes(pack) + launch.team_bytes
        + (launch.groups - 1) * fk._group_bytes(pack))


def rebuild(teams: int, profile: bool = False, src: str = "-") -> list:
    """Build and load the library for ``teams`` per block from the kernel
    sources in ``src`` (``-``: this package's); ptxas' lines for the 32-
    and 128-channel kernels and the split form's ring kernels (empty when
    the build was already on disk)."""
    source = _build.PACKAGE_DIR / "csrc" if src == "-" else Path(src).resolve()
    _build.SOURCE_DIR = source
    _build.BUILD_DIR = _build.PACKAGE_DIR / "_build" if src == "-" else source.parent / "_build"
    _build.NVCC_FLAGS[:] = [f for f in _build.NVCC_FLAGS if not f.startswith("-DPDE_")]
    _build.NVCC_FLAGS.append(f"-DPDE_MAX_TEAMS={teams}")
    if profile:
        _build.NVCC_FLAGS.append("-DPDE_PROFILE")
    _build.build.cache_clear()
    _build.load_library.cache_clear()
    _build.load_library()
    report, keep = [], False
    logs = _build.build().logs
    # the whole form's 32- and 128-channel kernels, and every kernel of the
    # split form's ring (fused_learned_rk4_cluster_ring*.cu)
    ring = sorted(name for name in logs if name.startswith("fused_learned_rk4_cluster_ring"))
    for line in "\n".join(logs.get(name, "") for name in (
            "fused_learned_rk4.cu", "fused_learned_rk4_wide.cu", *ring)).splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
            split = re.search(r"cluster_ring_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d)E", name)
            keep = bool(split) or "kernelILi4E" in name or "kernelILi16E" in name or (
                "wide_kernel" in name)
            forced = "Lb1E" in name
            label = f"{32 if 'kernelILi4E' in name else 128} channels"
            if split:
                forced = split.group(2) == "1"
                label = (f"split ring, {8 * int(split.group(1))} channels"
                         f"{' a chunk' if split.group(3) == '1' else ''}, "
                         f"{split.group(4)} groups")
        elif keep and ("registers" in line or "spill" in line):
            report.append(f"{label}, {'forced' if forced else 'unforced'}: "
                          + line.replace("ptxas info    : ", "").strip())
    return report


def sass_whole_kernels(library: Path) -> dict:
    """{(channels, forced): instructions} of the whole form's kernels with
    one trajectory a team in ``library``'s SASS (``cuobjdump -sass``; the
    kernels before packed teams had no third template argument), each line
    without its address and encoding."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    kernels, key = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            found = re.search(r"fused_learned_rk4_kernelILi(\d+)ELb(\d)E(?:Li(\d)E)?E", line)
            key = None
            if found and found.group(3) in (None, "1"):
                key = (8 * int(found.group(1)), found.group(2) == "1")
                kernels[key] = []
        elif key is not None:
            text = re.sub(r"/\*\s*[0-9a-fx]+\s*\*/", "", line).strip().rstrip(";").strip()
            if text:
                kernels[key].append(text)
    return kernels


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--settings", default="4:4,6:4,8:4",
                        help="comma-separated teams:forced_teams caps per block")
    parser.add_argument("--batches", default="256,1024,4096,10240")
    parser.add_argument("--profile", action="store_true",
                        help="cycles per RHS by phase (first setting only)")
    parser.add_argument("--nx", default="128",
                        help="comma-separated grids, multiples of each checkpoint's own grid "
                             "(others are skipped)")
    parser.add_argument("--clusters", default="auto",
                        help="comma-separated blocks per trajectory of the split form, auto "
                             "or all")
    parser.add_argument("--groups", default="auto",
                        help="comma-separated warp groups a split block, auto or all")
    parser.add_argument("--per_team", default="auto",
                        help="comma-separated trajectories a team of the whole form, auto or all")
    parser.add_argument("--slots", default="auto",
                        help="comma-separated slots of the ring at 128 filters, auto or all")
    parser.add_argument("--share", default="auto",
                        help="comma-separated blocks of a cluster that share the ring's copies "
                             "at 128 filters, auto or all")
    parser.add_argument("--steps", type=int, default=STEPS, help="RK4 steps a timed call")
    parser.add_argument("--sass", action="store_true",
                        help="compare the two --src trees' one-trajectory whole-form SASS")
    parser.add_argument("--ab", type=int, default=0,
                        help="rounds of the fewest-blocks split launch against the rule's")
    parser.add_argument("--src", default="-",
                        help="comma-separated csrc trees to build from, timed in turns (-: this "
                             "package's)")
    parser.add_argument("--checkpoints", default="ckpt_ks8,ckpt_burgers8",
                        help="comma-separated committed checkpoints")
    parser.add_argument("--filters", default=f"0,{fk.WIDE_CHANNELS}",
                        help="comma-separated tower widths (0: the checkpoint's own)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_learned_rk4: no CUDA device is available")
    device = torch.device("cuda")
    if args.sass:
        trees = args.src.split(",")
        if len(trees) != 2:
            raise SystemExit("probe_learned_rk4 --sass: give two --src trees")
        builds = []
        for tree in trees:
            rebuild(int(args.settings.split(",")[0].split(":")[0]), src=tree)
            builds.append(sass_whole_kernels(_build.build().library))
        for key in sorted(set(builds[0]) | set(builds[1])):
            a, b = (build.get(key, []) for build in builds)
            # lines outside the longest matching runs (difflib), so one
            # inserted instruction counts once
            ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
            differ = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")
            counts = [(len(k), sum("HMMA" in i for i in k), sum("GMMA" in i for i in k))
                      for k in (a, b)]
            print(f"{key[0]} channels, {'forced' if key[1] else 'unforced'}: "
                  + "; ".join(f"{tree}: {n} instructions, {h} HMMA, {g} GMMA"
                              for tree, (n, h, g) in zip(trees, counts))
                  + f"; {'identical' if a and not differ else f'{differ} lines differ'}")
            for tag, i1, i2, j1, j2 in [op for op in ops if op[0] != "equal"][:3]:
                print(f"    {tag}: {' / '.join(a[i1:i2][:2])}  |  {' / '.join(b[j1:j2][:2])}")
        return
    settings = [tuple(int(n) for n in s.split(":")) for s in args.settings.split(",")]
    batches = [int(b) for b in args.batches.split(",")]
    grids = [int(n) for n in args.nx.split(",")]
    clusters = [None if c == "auto" else int(c) for c in args.clusters.split(",")
                if c != "all"] + (list(range(1, fk.MAX_CLUSTER + 1))
                                  if "all" in args.clusters.split(",") else [])
    group_counts = [None if g == "auto" else int(g) for g in args.groups.split(",")
                    if g != "all"] + (list(fk.GROUP_COUNTS)
                                      if "all" in args.groups.split(",") else [])
    per_teams = [None if p == "auto" else int(p) for p in args.per_team.split(",")
                 if p != "all"] + (list(fk.PER_TEAM_COUNTS)
                                   if "all" in args.per_team.split(",") else [])
    slot_counts = [None if n == "auto" else int(n) for n in args.slots.split(",")
                   if n != "all"] + (list(range(1, fk.MAX_RING_SLOTS + 1))
                                     if "all" in args.slots.split(",") else [])
    shares = [None if n == "auto" else int(n) for n in args.share.split(",") if n != "all"] + (
        [1, 2, 4, 8] if "all" in args.share.split(",") else [])
    trees = args.src.split(",")
    rule = fk.learned_rk4_launch

    def ring_rule(slots, share, tree="-"):
        """The rule with the ring's constants ``slots`` and ``share`` (None:
        the package's), or for a tree without the ring the whole form at 128
        filters as before it, and for a tree without the split form's ring
        its streamed launches through one window."""
        fk.RING_SLOTS = RING_SLOTS if slots is None else slots
        fk.WIDE_CLUSTER = WIDE_CLUSTER if share is None else share
        fk.learned_rk4_launch = rule
        whole_ring = tree == "-" or (Path(tree) / "fused_learned_rk4_wide.cu").is_file()
        split_ring = tree == "-" or (Path(tree) / "fused_learned_rk4_cluster_ring.cu").is_file()
        if not (whole_ring and split_ring):
            def old(pack, nx, terms=0, batch=fk.NUM_SMS * fk.MAX_TEAMS, **kwargs):
                launch = rule(pack, nx, terms, batch, **kwargs)
                if launch.split and launch.stream and not split_ring:
                    return split_window_launch(launch, pack)
                if launch.slots and not launch.split and not whole_ring:
                    return window_launch(launch, pack, batch)
                return launch
            fk.learned_rk4_launch = old

    cases = {}
    gen = torch.Generator().manual_seed(0)
    stems = Path(tempfile.mkdtemp(prefix="probe_learned_rk4_"))
    for filters, checkpoint, nx in [(int(f), n, x) for f in args.filters.split(",")
                                    for n in args.checkpoints.split(",") for x in grids]:
        case = load_case(checkpoint, filters, nx, device, stems)
        if case is None:
            print(f"{checkpoint} at nx {nx}: skipped (no multiple of its grid)")
            continue
        model, params = case
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

    def batch_of(u, forcing, batch):
        fb = None if forcing is None else type(forcing)(
            *(leaf[:batch].contiguous() for leaf in forcing))
        return u[:batch].contiguous(), fb

    if args.ab:
        teams, forced_teams = settings[0]
        rebuild(teams, src=trees[0])
        ring_rule(None, None, trees[0])
        fk.MAX_TEAMS, fk.MAX_TEAMS_FORCED = teams, forced_teams
        print(f"card: {torch.cuda.get_device_name(0)}; per {args.steps} RK4 steps, ms; the "
              f"fewest-blocks split launch (P) against the rule's (N), in turns P N N P, "
              f"{args.ab} rounds")
        for name, (pack, dt, u, forcing) in cases.items():
            terms = 0 if forcing is None else forcing.amplitude.shape[-1]
            for batch in batches:
                ub, fb = batch_of(u, forcing, batch)
                nx = ub.shape[1]
                old = fewest_blocks(pack, nx, terms, batch)
                new = fk.learned_rk4_launch(pack, nx, terms, batch)
                if old is None:
                    print(f"{name} B={batch}: one block holds a trajectory, no split launch")
                    continue
                runs = {}
                for label, launch in (("P", old), ("N", new)):
                    def run(launch=launch, steps=args.steps):
                        return fk.fused_learned_rk4(ub, pack, dt, steps, forcing=fb,
                                                    cluster=launch.cluster, groups=launch.groups)
                    runs[label] = run
                if not torch.equal(runs["P"](steps=10), runs["N"](steps=10)):
                    raise AssertionError(f"{name} B={batch}: the two launches differ")
                times = {"P": [], "N": []}
                for _ in range(args.ab):
                    for label in "PNNP":
                        times[label].append(time_ms(runs[label]))
                p_ms, n_ms = statistics.median(times["P"]), statistics.median(times["N"])
                print(f"{name} B={batch}: P {p_ms:.3f} ms ({launch_text(old, pack)}; "
                      f"{', '.join(f'{t:.3f}' for t in times['P'])}), N {n_ms:.3f} ms "
                      f"({launch_text(new, pack)}; {', '.join(f'{t:.3f}' for t in times['N'])}); "
                      f"P / N {p_ms / n_ms:.3f}; bit for bit over 10 steps")
        return

    if args.profile:
        teams, forced_teams = settings[0]
        rebuild(teams, profile=True, src=trees[0])
        ring_rule(None, None, trees[0])
        fk.MAX_TEAMS, fk.MAX_TEAMS_FORCED = teams, forced_teams
        steps = 20
        print(f"card: {torch.cuda.get_device_name(0)}; cycles per RHS by phase, warp 0, "
              f"caps {teams}:{forced_teams}, {steps} steps")
        for name, (pack, dt, u, forcing) in cases.items():
            terms = 0 if forcing is None else forcing.amplitude.shape[-1]
            for batch, per_team in [(b, p) for b in batches for p in per_teams]:
                ub, fb = batch_of(u, forcing, batch)
                try:
                    launch = fk.learned_rk4_launch(pack, ub.shape[1], terms, batch,
                                                   per_team=per_team)
                except ValueError as e:
                    print(f"{name} B={batch} per_team {per_team}: skipped ({e})")
                    continue
                out = fk.fused_learned_rk4(ub, pack, dt, steps, forcing=fb, per_team=per_team)
                # the last team's counters lie over its first trajectory
                last = (batch - 1) // launch.per_team * launch.per_team
                cycles = out[[0, last], :len(PHASES)].cpu() / (4 * steps)
                print(f"{name} B={batch} ({launch_text(launch, pack)}): first team, last team")
                for phase, (first, last) in zip(PHASES, cycles.t().tolist()):
                    print(f"  {phase:34s} {first:8.0f} {last:8.0f}")
                print(f"  {'sum':34s} {float(cycles[0].sum()):8.0f} {float(cycles[1].sum()):8.0f}")
        return
    print(f"card: {torch.cuda.get_device_name(0)}; per {args.steps} RK4 steps, ms")
    # several trees: each launch on every tree in turn, forward then backward
    order = trees if len(trees) == 1 else trees + trees[::-1]
    for teams, forced_teams in settings + settings[:1]:
        for tree in trees:
            for line in rebuild(teams, src=tree):
                print(f"  max teams {teams}{'' if len(trees) == 1 else ', ' + tree}: {line}")
        fk.MAX_TEAMS, fk.MAX_TEAMS_FORCED = teams, forced_teams
        for name, (pack, dt, u, forcing) in cases.items():
            terms = 0 if forcing is None else forcing.amplitude.shape[-1]
            most = fk.MAX_GROUPS_WIDE if pack.padded_channels >= fk.WIDE_CHANNELS else (
                fk.MAX_GROUPS)
            first = {}  # batches[0]'s plain version, its limit and the first kernel run
            for batch, cluster, groups, per_team, slots, share in [
                    (b, c, g, p, n, m) for b in batches for c in clusters for g in group_counts
                    for p in per_teams for n in slot_counts for m in shares
                    if g is None or g <= most]:
                ub, fb = batch_of(u, forcing, batch)
                nx = ub.shape[1]
                ring_rule(slots, share)
                refusal = fk.learned_rk4_refusal(pack, nx, terms, cluster=cluster, groups=groups)
                if not refusal:
                    try:
                        launch = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster,
                                                       groups=groups, per_team=per_team)
                    except ValueError as e:
                        refusal = str(e)
                if refusal:
                    print(f"{name} B={batch} cluster {cluster} groups {groups} per_team "
                          f"{per_team}: skipped ({refusal})")
                    continue
                if cluster and -(-nx // -(-nx // cluster)) < cluster:
                    continue  # as many blocks as a smaller cluster's: timed there
                if (slots or share) and (launch.slots, launch.multicast) != (
                        slots or launch.slots, share or launch.multicast):
                    print(f"{name} B={batch} slots {slots} share {share}: skipped (the launch "
                          f"takes {launch.slots} slots shared by {launch.multicast})")
                    continue
                for tree in trees if batch == batches[0] else ():
                    if len(trees) > 1:
                        rebuild(teams, src=tree)
                    ring_rule(slots, share, tree)
                    uc, fc = batch_of(u, forcing, min(batch, CHECK_BATCH))
                    got = fk.fused_learned_rk4(uc, pack, dt, 10, forcing=fc, cluster=cluster,
                                               groups=groups, per_team=per_team)
                    if not first:
                        first["got"] = got
                        first["want"] = want = fk.fused_learned_rk4_plain(uc, pack, dt, 10, fc)
                        # a model may blow up on some members (KdV-16x does)
                        # and amplify roundings: as chip_smoke.hold_run holds
                        # a run, the kernel blows up on the same members and
                        # 90% of the others are within 1e-4, or 4x the plain
                        # version's own distance from float64 sums (unforced)
                        # where that is larger
                        first["finite"] = finite = torch.isfinite(want).all(-1)
                        if not torch.equal(finite, torch.isfinite(got).all(-1)):
                            raise AssertionError(f"{name}: kernel and plain blow up on other "
                                                 "members")

                        def spread(a, b):
                            return float(((a - b)[finite].abs().amax(-1)
                                          / b[finite].abs().amax(-1)).quantile(0.9))

                        rel, limit = spread(got, want), 1e-4
                        if fc is None:
                            exact = fk.fused_learned_rk4_plain(
                                uc.double(), dataclasses.replace(pack, flat=pack.flat.double()),
                                dt, 10)
                            limit = max(limit, 4 * spread(want.double(), exact))
                        if not rel < limit:
                            raise AssertionError(f"{name}: kernel vs plain after 10 steps: "
                                                 f"{rel} (limit {limit})")
                    # every launch of the kernel, from every tree, gives the
                    # same bits (a member that blows up gives NaN in each):
                    # each row runs the same products in the same order
                    elif not torch.equal(got.nan_to_num(nan=7.0),
                                         first["got"].nan_to_num(nan=7.0)):
                        raise AssertionError(f"{name} cluster {cluster} groups {groups} per_team "
                                             f"{per_team} tree {tree}: not bit for bit the "
                                             "first launch's 10 steps")
                for tree in order:
                    if len(trees) > 1:
                        rebuild(teams, src=tree)
                    ring_rule(slots, share, tree)
                    ms = time_ms(lambda: fk.fused_learned_rk4(
                        ub, pack, dt, args.steps, forcing=fb, cluster=cluster, groups=groups,
                        per_team=per_team))
                    shown = fk.learned_rk4_launch(pack, nx, terms, batch, cluster=cluster,
                                                  groups=groups, per_team=per_team)
                    print(f"caps {teams}:{forced_teams} {name} B={batch} cluster {cluster} "
                          f"groups {groups} per_team {per_team} slots {slots} share {share}"
                          f"{'' if len(trees) == 1 else ' tree ' + tree}: "
                          f"{ms:.3f} ms ({launch_text(shown, pack)}, {shown.threads} "
                          f"threads, {shown.shared_bytes} bytes shared; "
                          f"{batch * args.steps * nx / ms * 1e3:,.0f} cell-steps/s)", flush=True)


if __name__ == "__main__":
    main()
