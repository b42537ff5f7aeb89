"""Large-ensemble integration with a trained model.

Integrates an ensemble of trajectories (default 10240) with the learned
scheme on the coarse grid, batched on one device, and reports throughput
and ensemble statistics (finite members, final rms, energy-spectrum peak).
Optionally writes the snapshots to HDF5 through the crash-resumable
integrator (``--output_path``; needs ``h5py``). The counterpart of
``pde_superresolution_tpu/scripts/run_ensemble.py``.

Example:
  python -m pde_superresolution_torch.scripts.run_ensemble \
      --checkpoint_dir ckpt_burgers8 --num_trajectories 10240 \
      --time_max 10 --warmup_time 1

``--checkpoint_dir`` is a training checkpoint directory written by
``run_training``, a committed asset (``convert.asset_names()``: the JAX
package's model zoo, ``ckpt_ks8`` to ``ckpt_burgers64``) or the path stem
of a ``.npz``/``.json`` pair written by ``tools/export_jax_checkpoint.py``
(``convert.load_checkpoint``).
``--exported_dir`` serves a frozen ``run_export`` artifact instead (no
model code or checkpoint; its RHS steps). Exactly one of the two is given.
The run is on ``cuda`` unless ``--device cpu`` is given.

Routes between snapshots: the fused kernel (``StencilModel.fused_rk4_fn``:
one launch per save interval, forcing evaluated in the kernel) or single
RK4 steps of ``StencilModel.rhs_fn`` (on the card a ``fused_rhs`` launch
per RHS), or of a frozen artifact's RHS. ``--output_path`` and
``--exported_dir`` take RHS steps; ``--fused true`` with either is refused.
``--fused auto`` decides from the device and the shapes alone, before
anything is launched, and prints its choice; a kernel that then fails to
build or launch raises.

``--data_parallel N`` splits the ensemble over N ranks, one process per
device: ``torchrun --standalone --nproc_per_node N -m
pde_superresolution_torch.scripts.run_ensemble ... --data_parallel N``
(NCCL on ``cuda``, gloo with ``--device cpu``); N=1 runs without torchrun.
Every rank draws the global members from ``--seed`` and keeps its rows, so
member i is the same member as without the flag; the warm-up, the route and
the integration run per rank, with no communication; the statistics come
from the final state gathered over the ranks, and rank 0 prints them.
With ``--output_path`` rank 0 writes the gathered global batch, in the
layout a single process writes, and every rank resumes from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from pde_superresolution_torch import analysis, convert, integrate
from pde_superresolution_torch import export as export_lib
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import Equation, ForcingParams
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import StencilModel
from pde_superresolution_torch.ops import fused_kernels


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint_dir", default=None,
                        help="training checkpoint directory, asset name or path "
                        "stem of a trained model (or use --exported_dir)")
    parser.add_argument("--exported_dir", default=None,
                        help="serving artifact from run_export: integrates the ensemble "
                        "with the frozen graph's RHS (no model code or checkpoint)")
    parser.add_argument("--output_path", default=None,
                        help="optional HDF5 store of the snapshots (resumable across "
                        "restarts)")
    parser.add_argument("--num_trajectories", type=int, default=10240,
                        help="ensemble size")
    parser.add_argument("--time_max", type=float, default=10.0,
                        help="integration horizon")
    parser.add_argument("--warmup_time", type=float, default=0.0,
                        help="exact-solver warm-up before handing off to the "
                        "model (KS: about 40 to start on the attractor)")
    parser.add_argument("--seed", type=int, default=0, help="ensemble seed")
    parser.add_argument("--ic_scale", type=float, default=1.0,
                        help="initial-condition amplitude")
    parser.add_argument("--num_saves", type=int, default=10,
                        help="snapshots to keep over the horizon")
    parser.add_argument("--fused", choices=["auto", "true", "false"], default="auto",
                        help="whole-interval fused kernel between snapshots; "
                        "auto = on a CUDA device when the kernel takes the shape: "
                        "nx >= 16 with whole trajectories in one block, or nx >= 32 "
                        "split over a cluster of up to 16 (fused_kernels.learned_rk4_refusal)")
    parser.add_argument("--domain_factor", type=int, default=1,
                        help="integrate on a domain this many times larger "
                        "than the checkpoint was trained on (same dx; the "
                        "forcing and initial-condition wavenumber bands "
                        "scale with it, so the physical wavelengths match); "
                        "checkpoints only: a frozen artifact's grid is baked in")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="split the ensemble (warm-up and integration) over this "
                        "many ranks of a ('data',) mesh, one process per device "
                        "(torchrun --nproc_per_node N; N=1 runs without it); 0 = one "
                        "process. Composes with --fused: each rank launches the "
                        "kernel on its own rows")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    return parser


@dataclasses.dataclass
class Ensemble:
    """What a run integrates: the model (or a frozen artifact), its grid, and
    the seeded members."""

    model: Optional[StencilModel]  # None when serving a frozen artifact
    params: Optional[dict]
    equation: Equation
    coarse: Grid
    u0: torch.Tensor  # [n, nx], before any warm-up
    forcing: Optional[ForcingParams]
    served: Optional[export_lib.ServedModel] = None


def setup(args: argparse.Namespace) -> Ensemble:
    """Load the model or the artifact, widen the domain if asked, and draw
    the ensemble's initial conditions and forcing from ``--seed``."""
    device = resolve_device(args.device)
    model = params = served = None
    if args.exported_dir:
        served = export_lib.load_served_model(args.exported_dir, device=device)
        equation, _, coarse = export_lib.science_context(served.meta)
    else:
        model, params, config = convert.load_checkpoint(args.checkpoint_dir, device=device)
        equation, coarse = model.equation, model.grid
    if args.domain_factor > 1:
        # the same physics in an N-times larger box at the same dx: the
        # parameters apply unchanged (a translation-invariant tower, a
        # constraint layer that does not depend on nx); the integer
        # wavenumber bands scale so the physical wavelengths stay
        nf = args.domain_factor
        equation = dataclasses.replace(
            equation,
            period=nf * equation.period,
            forcing_k_min=nf * equation.forcing_k_min,
            forcing_k_max=nf * equation.forcing_k_max,
            ic_k_min=nf * equation.ic_k_min,
            ic_k_max=nf * equation.ic_k_max,
        )
        coarse = Grid(nf * config.fine_size, equation.period).resample(
            config.resample_factor, conservative=equation.conservative
        )
        model = StencilModel(equation, coarse, model.config, device=device)
    generator = torch.Generator().manual_seed(args.seed)
    n = args.num_trajectories
    u0 = args.ic_scale * equation.initial_conditions(generator, coarse, (n,), device)
    forcing = equation.sample_forcing(generator, (n,), device)  # None if unforced
    return Ensemble(model, params, equation, coarse, u0, forcing, served)


def choose_route(fused: str, ensemble: Ensemble, pack,
                 resumable: bool = False) -> tuple[bool, str]:
    """(take the fused route, why), from the device and the shapes alone.
    ``pack`` is the fused kernel's packed weights; ``--fused false``, a
    frozen artifact and a resumable run (``--output_path``) do not read it:
    they take RHS steps.

    The kernel takes a shape when the weights it keeps in shared memory (or
    a ring of one conv tap's slices) fit the card's opt-in limit per
    block beside one trajectory of at least 16 points, or beside one segment
    of a trajectory of at least 32 points split over a cluster of up to
    ``fused_kernels.MAX_CLUSTER`` blocks (as at ``--domain_factor`` grids,
    and for every tower wider than 128 filters). ``--fused true`` on a shape
    it cannot take raises; on the CPU it runs the kernel's plain version.
    """
    if fused == "false":
        return False, "--fused false"
    if ensemble.served is not None:
        return False, "auto: a frozen artifact has no live parameters for the fused kernel"
    if resumable:
        return False, "auto: --output_path, the resumable integrator drives single RK4 steps"
    device = ensemble.model.device
    limit = fused_kernels.MAX_SHARED_BYTES
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        limit = getattr(props, "shared_memory_per_block_optin", limit)
    terms = 0 if ensemble.forcing is None else ensemble.forcing.amplitude.shape[-1]
    refusal = fused_kernels.learned_rk4_refusal(pack, ensemble.coarse.size, terms, limit)
    if fused == "true":
        if refusal:
            raise ValueError(f"--fused true, but the kernel cannot take this shape: {refusal}")
        return True, "--fused true"
    if device.type != "cuda":
        return False, f"auto: device is {device.type}"
    if refusal:
        return False, f"auto: {refusal}"
    launch = fused_kernels.learned_rk4_launch(
        pack, ensemble.coarse.size, terms, ensemble.u0.shape[0], limit)
    if launch.split:
        weights = "a conv tap's weights at a time" if launch.stream else "the weights"
        return True, (f"auto: cuda, a trajectory split over clusters of {launch.cluster} "
                      f"blocks of {launch.segment} points ({launch.blocks} blocks, "
                      f"{launch.groups} warp groups each), {weights} and a segment in "
                      f"{launch.shared_bytes} bytes of shared memory per block fit")
    return True, (f"auto: cuda, {launch.blocks} blocks of {launch.teams} warp groups of "
                  f"{launch.per_team} trajectories, {launch.threads} threads and "
                  f"{launch.shared_bytes} bytes of shared memory per block fit")


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from each rank's rows (all ranks get it)."""
    import torch.distributed as dist

    from pde_superresolution_torch.parallel import DATA_AXIS

    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(DATA_AXIS))
    return torch.cat(parts)


def main(argv=None) -> dict:
    """Run the ensemble; print the report and return it as a dict (with the
    warmed-up start state, the final state and the save times as tensors
    under ``initial``, ``final`` and ``times``; under ``--data_parallel`` the
    states of the whole ensemble, on every rank)."""
    import torch.distributed as dist

    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.checkpoint_dir) == bool(args.exported_dir):
        parser.error("pass exactly one of --checkpoint_dir / --exported_dir")
    if args.data_parallel < 0:
        parser.error("--data_parallel must be >= 0")
    if args.data_parallel and args.num_trajectories % args.data_parallel:
        raise ValueError(
            f"num_trajectories={args.num_trajectories} not divisible by "
            f"data_parallel={args.data_parallel}")
    if not args.data_parallel:
        return _run(args, None)
    from pde_superresolution_torch import parallel

    own_group = not dist.is_initialized()
    parallel.initialize_multihost(device=args.device)
    try:
        return _run(args, parallel.make_mesh(data=args.data_parallel, device=args.device))
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args, mesh) -> dict:
    """``main`` after the process group: ``mesh`` is None without
    ``--data_parallel``."""
    if args.exported_dir and args.fused == "true":
        raise ValueError(
            "--fused true needs live model parameters (the fused kernel is built "
            "from them); a frozen artifact serves by RHS steps: pass "
            "--checkpoint_dir or drop --fused")
    if args.exported_dir and args.domain_factor > 1:
        raise ValueError(
            "--domain_factor needs a live checkpoint: a frozen artifact's grid "
            "size (nx) is baked into the exported graph")
    if args.fused == "true" and args.output_path:
        raise ValueError(
            "--fused true conflicts with --output_path: the resumable HDF5 "
            "integrator drives single RK4 steps (drop one of the two flags)")
    ensemble = setup(args)
    global_forcing = ensemble.forcing
    rank, dp = 0, ""
    if mesh is not None:
        # every rank drew the global members; it keeps its rows
        from pde_superresolution_torch.parallel.sharded import Shard

        rank = torch.distributed.get_rank()
        shard = Shard(mesh, ensemble.coarse.size)
        ensemble = dataclasses.replace(
            ensemble, u0=ensemble.u0[shard.rows(args.num_trajectories)].contiguous(),
            forcing=shard.forcing_rows(global_forcing))
        dp = f", dp={args.data_parallel}"
    model, params, equation, coarse = (
        ensemble.model, ensemble.params, ensemble.equation, ensemble.coarse)
    forcing, u0, served = ensemble.forcing, ensemble.u0, ensemble.served
    device = u0.device
    n = args.num_trajectories
    say = print if rank == 0 else (lambda *a, **k: None)

    t0 = 0.0
    warmup_s = 0.0
    if args.warmup_time > 0:
        # warm up with the exact solver on the coarse grid (cheap, batched)
        dt_w = 0.2 * coarse.dx
        steps_w = int(np.ceil(args.warmup_time / dt_w))
        start = time.perf_counter()
        _, warm = integrate.integrate_spectral(
            equation, coarse, u0, dt_w, steps_w, save_every=steps_w, forcing=forcing
        )
        u0 = warm[-1].contiguous()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        warmup_s = time.perf_counter() - start
        t0 = steps_w * dt_w  # the forcing's phase continues: it is not reset to 0

    # model-aware CFL: wide stencils need a tighter dt than the equation's.
    # A frozen artifact carries it in meta["stable_dt"] (the live model is
    # gone at serve time); one without it runs at the equation's bound.
    if served is None:
        dt = model.stable_time_step(u_scale=3.0)
    else:
        dt = served.meta.get("stable_dt")
        if dt is None:
            dt = equation.stable_time_step(coarse, u_scale=3.0)
        elif not dt > 0:  # a silent fallback could integrate a wide stencil unstably
            raise ValueError(
                f"exported artifact carries invalid stable_dt={dt!r} (expected a "
                "positive float); re-export with run_export")
    num_steps = int(np.ceil(args.time_max / dt))
    save_every = max(1, num_steps // args.num_saves)
    num_steps = save_every * args.num_saves

    # set-up outside the timed region: the weights' pack, the route, and the
    # kernels' build on first use
    start = time.perf_counter()
    advance = None
    resumable = bool(args.output_path)
    if args.fused == "false" or served is not None or resumable:
        fused, reason = choose_route(args.fused, ensemble, None, resumable)
    else:
        advance = model.fused_rk4_fn(params, dt, save_every, forcing=global_forcing,
                                     t0=t0, mesh=mesh)
        fused, reason = choose_route(args.fused, ensemble, advance.pack)
    if device.type == "cuda" and served is None:
        from pde_superresolution_torch.ops import _build

        _build.load_library()
    setup_s = time.perf_counter() - start
    if fused:
        path = "fused kernel" if device.type == "cuda" else "fused kernel's plain version"
    else:
        path = "resumable rhs_fn steps" if resumable else "rhs_fn steps"
    if served is not None:
        path = "frozen artifact, " + path
    path += dp
    say(f"route: {path} ({reason})", flush=True)

    # t0 is the physical start time (the warm-up's end); the wall clock has
    # its own variable
    wall_start = time.perf_counter()
    with torch.no_grad():
        if fused:
            times, traj = integrate.integrate_fused(
                advance, u0, dt, num_steps, save_every, t0=t0)
        else:
            # under --data_parallel the per-step route keeps fused_rhs: each
            # rank launches it on its own rows. (The JAX package turns its
            # Pallas RHS off there only because GSPMD cannot partition a
            # Mosaic call; per-rank execution has no such limit.)
            rhs = (served.rhs_fn(forcing) if served is not None
                   else model.rhs_fn(params, forcing))
            if resumable:
                times, traj = integrate.integrate_resumable(
                    rhs, u0, dt, num_steps, save_every, args.output_path, t0=t0,
                    mesh=mesh)
            else:
                times, traj = integrate.integrate(rhs, u0, dt, num_steps, save_every, t0=t0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - wall_start

    final = traj[-1]
    if mesh is not None:
        final, u0 = _gather_rows(final, mesh), _gather_rows(u0, mesh)
        slowest = torch.tensor([elapsed], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(slowest, op=torch.distributed.ReduceOp.MAX)
        elapsed = float(slowest)
    final_np = final.cpu().numpy()
    finite = np.isfinite(final_np).all(axis=-1)
    k, spectrum = analysis.energy_spectrum(final_np[finite], equation.period)
    result = {
        "num_trajectories": n,
        "num_steps": num_steps,
        "save_every": save_every,
        "nx": coarse.size,
        "dt": dt,
        "elapsed_s": elapsed,
        "traj_steps_per_s": n * num_steps / elapsed,
        "path": path,
        "reason": reason,
        "setup_s": setup_s,
        "warmup_s": warmup_s,
        "device": str(device),
        "t_start": float(times[0]),
        "t_end": float(times[-1]),
        "t0": t0,
        "finite": int(finite.sum()),
        "final_rms": float(np.sqrt((final_np[finite] ** 2).mean())),
        "spectrum_peak_k": float(k[np.argmax(spectrum[1:]) + 1]),
        "initial": u0,
        "final": final,
        "times": times,
    }
    say(
        f"{n} trajectories x {num_steps} RK4 steps (nx={coarse.size}) in "
        f"{elapsed:.3f}s = {result['traj_steps_per_s']:,.0f} traj-steps/s on "
        f"{device} [{path}, set-up {setup_s:.1f}s, warm-up {warmup_s:.3f}s]"
    )
    say(
        f"physical time window t=[{result['t_start']:.6f}, "
        f"{result['t_end']:.6f}] (warmup handoff at t0={t0:.6f})"
    )
    say(
        f"finite: {result['finite']}/{n} | final rms {result['final_rms']:.3f} "
        f"| spectrum peak k={result['spectrum_peak_k']:.3f}",
        flush=True,
    )
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
