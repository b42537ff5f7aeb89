"""Check the parallel layer's collectives across several devices, a rank per device.

    torchrun --standalone --nproc_per_node 4 -m pde_superresolution_torch.scripts.probe_parallel

On cards the backend is NCCL; ``--device cpu`` runs it over gloo (with
smaller ``--ensemble``, ``--batch`` and ``--trajectories``, for a rehearsal).
It checks only what a world of one cannot show and the CPU tests hold over
gloo alone: the same paths over NCCL. Every rank runs every phase; rank 0
prints, and raises (as does every rank at its next collective) when a
check fails:

  1. the group: backend, world size W, each rank's device name;
  2. the halo exchange on a ring of W (mesh (1, W)), a KS-8x block
     ([--batch, 128 / W], halo 7): each rank's padded block equal to the
     periodic pad's, bit for bit, and its gradient equal to the periodic
     pad's (rtol 1e-6);
  3. ``run_ensemble --data_parallel W`` on W x --ensemble Burgers-8x members
     (warm-up 1, 100 RK4 steps in 10 saves), the fused route and ``rhs_fn``
     steps: the gathered final state against rank 0's run of the same
     members without the flag (bit for bit on the fused route, 1e-6 of
     max|u| on the other);
  4. ``train(mesh=)`` at the KS-8x recipe cut to 2 steps (``--trajectories``
     trajectories, PyTorch's deterministic algorithms): on (W, 1) by the
     kernel route (the gradient average), on (1, W) by the plain route (the
     halo exchange's backward and the grid means' all-reduce; the kernel
     needs the whole grid). Every rank's params bit for bit rank 0's, and
     against rank 0's ``train()`` by the same route, of a leaf's max (limit
     1e-4, JAX's DP bound).

The last line is one JSON object with every reading. Nothing is timed: the
probe is a correctness check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch
import torch.distributed as dist

from pde_superresolution_torch import convert, parallel
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.scripts import run_ensemble
from pde_superresolution_torch.training import data as data_lib
from pde_superresolution_torch.training import loop
from pde_superresolution_torch.training.config import TrainingConfig

STEPS = 100
SAVES = 10
HALO_GRAD_TOL = 1e-6
ENSEMBLE_TOL = 1e-6
TRAIN_TOL = 1e-4


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--ensemble", type=int, default=10240,
                        help="ensemble members per rank")
    parser.add_argument("--batch", type=int, default=1024,
                        help="members of the halo phase")
    parser.add_argument("--trajectories", type=int, default=32,
                        help="trajectories of the training data (the recipe's 32)")
    return parser


def _agree(flag: bool, what: str, device) -> None:
    """Raise on every rank unless ``flag`` holds on every rank."""
    ok = torch.tensor([int(flag)], device=device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if not int(ok):
        raise AssertionError(f"{what}: failed on a rank (rank {dist.get_rank()}: {flag})")


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def _block(u, mesh):
    shard = parallel.sharded.Shard(mesh, u.shape[-1])
    return u[shard.rows(u.shape[0]), shard.cols()].contiguous()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    parallel.initialize_multihost(device=args.device)
    try:
        return _probe(args)
    finally:
        dist.destroy_process_group()


def _probe(args) -> dict:
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    out: dict = {"backend": dist.get_backend(), "world": world}
    names = [None] * world
    dist.all_gather_object(names, torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")
    out["devices"] = names
    say(f"[1] {out['backend']}, world size {world}: {names}", flush=True)

    # -- 2. the halo exchange on a ring of W
    ring = parallel.make_mesh(data=1, space=world, device=device.type)
    model, _, stored = convert.load_asset("ckpt_ks8", device=device)
    eq, grid = model.equation, model.grid
    gen = torch.Generator().manual_seed(0)
    u = eq.initial_conditions(gen, grid, (args.batch,), device)
    halo = parallel.sharded.model_halo(model)[0]
    width = grid.size // world
    field = u.clone().requires_grad_()
    weights = torch.randn((world, args.batch, width + 2 * halo), generator=gen).to(device)
    pad = torch.cat([field[..., -halo:], field, field[..., :halo]], dim=-1)
    periodic = [pad[..., q * width:q * width + width + 2 * halo] for q in range(world)]
    (grad_want,) = torch.autograd.grad(
        sum((periodic[q] * weights[q]).sum() for q in range(world)), field)
    block = _block(u, ring).requires_grad_()
    padded = parallel.halo_exchange(block, halo, ring)
    (padded * weights[rank]).sum().backward()
    values_ok = torch.equal(padded.detach(), periodic[rank].detach())
    grad_err = _rel(block.grad, _block(grad_want, ring))
    out["halo_values_equal"] = values_ok
    out["halo_grad_err"] = grad_err
    say(f"[2] halo {halo} on a ring of {world}, block [{args.batch}, {width}]: values equal "
        f"{values_ok}, gradient rel err {grad_err:.3e} (tolerance {HALO_GRAD_TOL:.0e})",
        flush=True)
    _agree(values_ok and grad_err <= HALO_GRAD_TOL, "halo exchange", device)

    # -- 3. the ensemble
    bmodel = convert.load_asset("ckpt_burgers8", device=device)[0]
    bdt = bmodel.stable_time_step(u_scale=3.0)
    n = world * args.ensemble
    base = ["--checkpoint_dir", "ckpt_burgers8", "--num_trajectories", str(n),
            "--warmup_time", "1.0", "--time_max", str((STEPS - 0.5) * bdt), "--num_saves",
            str(SAVES), "--device", device.type]
    for route in ("true", "false"):
        dp = run_ensemble.main(base + ["--fused", route, "--data_parallel", str(world)])
        if rank == 0:
            one = run_ensemble.main(base + ["--fused", route])
            err = _rel(dp["final"], one["final"])
            exact = torch.equal(dp["final"], one["final"])
            del one
        else:
            err, exact = 0.0, True
        ok = exact if route == "true" else err <= ENSEMBLE_TOL
        out[f"ensemble_{route}"] = {"members": n, "err": err, "exact": exact}
        say(f"[3] run_ensemble --fused {route}, {n} members, --data_parallel {world} against "
            f"one rank: final states bit for bit {exact}, rel err {err:.3e}", flush=True)
        _agree(ok, f"ensemble --fused {route}", device)
        del dp

    # -- 4. training
    config = TrainingConfig.from_json(json.dumps(stored))
    short = dataclasses.replace(
        config, num_trajectories=args.trajectories, learning_rates=config.learning_rates[:1],
        learning_stops=(2,), eval_interval=2, checkpoint_interval=2)
    fine = Grid(config.fine_size, eq.period)
    snaps = data_lib.generate_snapshots(
        eq, fine, torch.Generator().manual_seed(config.data_seed), short.num_trajectories,
        config.num_times, config.time_delta, warmup_time=config.warmup_time,
        ic_scale=config.ic_scale, device=device)
    data = data_lib.build_training_data(eq, fine, snaps, config.resample_factor,
                                        config.num_time_steps)
    del snaps
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for shape, use_kernel in (((world, 1), True), ((1, world), False)):
            single = (loop.train(short, dataset=data, device=device, use_kernel=use_kernel)[1]
                      if rank == 0 else None)
            mesh = parallel.make_mesh(*shape, device=device.type)
            _, trained, metrics = loop.train(short, dataset=data, device=device,
                                             use_kernel=use_kernel, mesh=mesh)
            flat = torch.cat([trained[k].reshape(-1) for k in sorted(trained)]).double()
            copies = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(copies, flat)
            same = all(torch.equal(c, copies[0]) for c in copies)
            err = (max(float((trained[k] - single[k]).abs().max() / single[k].abs().max())
                       for k in single) if rank == 0 else 0.0)
            route = "kernel" if use_kernel else "plain"
            out[f"train_{shape[0]}x{shape[1]}"] = {
                "route": route, "ranks_equal": same, "err": err,
                "eval_total": metrics["eval_total"]}
            say(f"[4] train(mesh={shape}), {short.num_trajectories} trajectories, 2 steps, "
                f"{route} route: ranks bit for bit {same}; worst leaf against train() by the "
                f"same route {err:.3e} (tolerance {TRAIN_TOL:.0e}); eval_total "
                f"{metrics['eval_total']:.6g}", flush=True)
            _agree(same and err <= TRAIN_TOL, f"train(mesh={shape})", device)
    finally:
        torch.use_deterministic_algorithms(False)
    say(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
