"""Rank processes for the port's multi-rank tests on the CPU (gloo).

``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_train.py``
start one process per rank with ``spawn(job, world, inputs, tmp_path)``:

    python tests/torch_parallel_worker.py JOB RANK WORLD RDV INPUTS OUT_DIR

The ranks meet over gloo at a file rendezvous (``file://RDV``, which cannot
race another test for a TCP port), run every case of ``JOB`` on the
inputs the parent saved with ``torch.save``, and save their results to
``OUT_DIR/rank<r>.pt``; the parent compares them with the JAX package and
with the port's single-process functions. A rank never imports JAX.

Under ``torchrun``, ``torch_parallel_worker.py ensemble ARGS --save PATH``
runs ``run_ensemble.main(ARGS)`` in each rank, and rank 0 saves the states
it returns to ``PATH``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 180


def spawn(job: str, world: int, inputs: dict, tmp_path, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``job`` on ``world`` ranks; return each rank's result dict. Fails
    (AssertionError with the ranks' output) on a non-zero exit or when the
    ranks take longer than ``timeout`` seconds, killing them."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    inputs_path = tmp_path / f"{job}_inputs.pt"
    out_dir = tmp_path / f"{job}_out"
    out_dir.mkdir(exist_ok=True)
    torch.save(inputs, inputs_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    logs = [tmp_path / f"{job}_rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, job, str(r), str(world),
                 str(tmp_path / f"{job}_rdv"), str(inputs_path), str(out_dir)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        timed_out = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = "\n".join(f"--- rank {r}:\n{logs[r].read_text()[-3000:]}" for r in range(world))
    assert not any(timed_out), f"{job}: ranks still running after {timeout} s\n{text}"
    assert all(p.returncode == 0 for p in procs), f"{job} failed\n{text}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def blocks(results: list, key: str, data: int, space: int) -> torch.Tensor:
    """The global array from each rank's block ``key`` on a (data, space)
    mesh: ranks d * space + s hold rows block d, columns block s."""
    rows = []
    for d in range(data):
        rows.append(torch.cat([results[d * space + s][key] for s in range(space)], dim=-1))
    return torch.cat(rows, dim=0) if rows[0].ndim > 1 else rows[0]


def _error(fn, errors=ValueError) -> str:
    """The message of the error of ``errors`` that ``fn()`` raises, or "no
    error"."""
    try:
        fn()
    except errors as e:
        return str(e)
    return "no error"


# -- jobs ----------------------------------------------------------------------


def job_mesh(rank: int, world: int, inputs: dict, out: dict) -> None:
    """make_mesh's shapes and refusals on this world."""
    from pde_superresolution_torch import parallel

    mesh = parallel.make_mesh(device="cpu")
    out["default"] = tuple(mesh.shape)
    out["names"] = tuple(mesh.mesh_dim_names)
    out["space4"] = tuple(parallel.make_mesh(space=4, device="cpu").shape)
    out["bad_factorization"] = _error(lambda: parallel.make_mesh(data=3, space=3, device="cpu"))
    out["not_divisible"] = _error(lambda: parallel.make_mesh(space=3, device="cpu"))
    out["not_covering"] = _error(lambda: parallel.make_mesh(data=2, space=2, device="cpu"))


def job_core(rank: int, world: int, inputs: dict, out: dict) -> None:
    """The halo exchange, the sharded RHS, fused_rk4_fn(mesh=) and the served
    artifact per rank, on a world of 4."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from pde_superresolution_torch import export, integrate, parallel
    from pde_superresolution_torch import equations as teq
    from pde_superresolution_torch.grids import Grid
    from pde_superresolution_torch.models import ModelConfig, StencilModel
    from pde_superresolution_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, axis_rank

    out["backend"] = dist.get_backend()
    meshes = {shape: parallel.make_mesh(*shape, device="cpu") for shape in ((1, 4), (2, 2), (4, 1))}

    def block(u, mesh, data, space):
        b, w = u.shape[0] // data, u.shape[-1] // space
        d, s = axis_rank(mesh, DATA_AXIS), axis_rank(mesh, SPACE_AXIS)
        return u[d * b:(d + 1) * b, s * w:(s + 1) * w].contiguous()

    # the halo: values at every space size, the gradient on a ring of 4
    u = torch.arange(32.0)
    for (data, space), mesh in meshes.items():
        w = 32 // space
        s = axis_rank(mesh, SPACE_AXIS)
        out[f"halo/{space}"] = parallel.halo_exchange(u[s * w:(s + 1) * w], 2, mesh)
    field, weights = inputs["halo_field"], inputs["halo_weights"]
    blk = block(field, meshes[(1, 4)], 1, 4).requires_grad_()
    padded = parallel.halo_exchange(blk, 3, meshes[(1, 4)])
    (padded * weights[rank]).sum().backward()
    out["halo_grad"] = blk.grad

    # the sharded baseline RHS at (data=2, space=2)
    for name, cons in (("burgers", False), ("burgers", True), ("ks", False), ("ks", True)):
        eq = teq.from_name(name, conservative=cons)
        grid = Grid(64, eq.period)
        forcing = inputs[f"base/{name}/forcing"]
        rhs = parallel.sharded_baseline_rhs(eq, grid, meshes[(2, 2)], forcing=forcing)
        out[f"base/{name}/{cons}"] = rhs(block(inputs[f"base/{name}/u"], meshes[(2, 2)], 2, 2), 0.3)

    # the sharded model RHS, stencil 7, perturbed params
    for cons in (False, True):
        eq = teq.from_name("ks", conservative=cons)
        model = StencilModel(eq, Grid(64, eq.period),
                             ModelConfig(num_layers=2, filters=8, stencil_size=7), device="cpu")
        params = inputs[f"model/{cons}/params"]
        for shape in ((2, 2), (1, 4)):
            rhs = parallel.sharded_model_rhs(model, params, meshes[shape])
            out[f"model/{cons}/{shape}"] = rhs(block(inputs["model/u"], meshes[shape], *shape), 0.0)

    # 50 integrated steps of the sharded baseline on a ring of 4
    eq = teq.from_name("ks", conservative=True)
    grid = Grid(64, eq.period)
    u0 = inputs["integrate/u0"]
    s = axis_rank(meshes[(1, 4)], SPACE_AXIS)
    rhs = parallel.sharded_baseline_rhs(eq, grid, meshes[(1, 4)])
    _, traj = integrate.integrate(rhs, u0[s * 16:(s + 1) * 16], eq.stable_time_step(grid), 50)
    out["integrate"] = traj[-1]

    # fused_rk4_fn(mesh=) at data=4: each rank its rows, the plain version
    for name in ("ks", "burgers"):
        eq = teq.from_name(name, conservative=True)
        grid = Grid(8 * 128, eq.period).resample(8, conservative=True)
        model = StencilModel(eq, grid, ModelConfig(stencil_size=6), device="cpu")
        params, u0 = inputs[f"fused/{name}/params"], inputs[f"fused/{name}/u0"]
        forcing = inputs.get(f"fused/{name}/forcing")
        dt = eq.stable_time_step(grid, u_scale=3.0)
        rows = block(u0, meshes[(4, 1)], 4, 1)
        advance = model.fused_rk4_fn(params, dt, 2, forcing=forcing, mesh=meshes[(4, 1)])
        out[f"fused/{name}"] = advance(rows, 0.37 if forcing is not None else None)
        if name == "ks":
            times, traj = integrate.integrate_fused(advance, rows, dt, 4, 2)
            out["fused/integrate"] = traj
            out["fused/times"] = times
            out["fused/space_refused"] = _error(
                lambda: model.fused_rk4_fn(params, dt, 2, mesh=meshes[(2, 2)]))
            model_mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
            out["fused/no_data_refused"] = _error(
                lambda: model.fused_rk4_fn(params, dt, 2, mesh=model_mesh))

    # a served artifact per rank, on its rows
    served = export.load_served_model(inputs["serve/path"], device="cpu")
    rows = block(inputs["serve/u"], meshes[(4, 1)], 4, 1)
    out["serve/rhs"] = served.rhs_fn()(rows, 0.5)
    out["serve/advance"] = served.advance(rows, 0.0)[0]

    # a store rank 0 cannot open (not HDF5): every rank raises, none waits
    # at the broadcast
    out["store/error"] = _error(lambda: integrate.integrate_resumable(
        lambda v, t: -v, rows, 0.01, 2, 1, inputs["store/bad_path"], mesh=meshes[(4, 1)]),
        Exception)

    # a second initialization keeps the group
    parallel.initialize_multihost(device="cpu")
    out["still_world"] = dist.get_world_size()


def train_cases(inputs: dict) -> dict:
    """{case: (config, dataset maker, mesh shape)} of the training job; the
    parent trains the same cases in one process. ``inputs`` holds the
    injected flat datasets."""
    import dataclasses

    from pde_superresolution_torch import equations as teq
    from pde_superresolution_torch.grids import Grid
    from pde_superresolution_torch.models import ModelConfig
    from pde_superresolution_torch.training import data as tdata
    from pde_superresolution_torch.training.config import TrainingConfig
    from pde_superresolution_torch.training.losses import LossWeights

    # tests/test_parallel.py's configurations
    dp = TrainingConfig(
        equation="burgers", conservative=True, resample_factor=4, fine_size=128,
        num_trajectories=2, num_times=32, time_delta=0.1,
        model=ModelConfig(num_layers=1, filters=4, stencil_size=4), num_time_steps=0,
        learning_rates=(1e-3,), learning_stops=(3,), batch_size=16, eval_interval=3,
        frac_training=0.75)
    noise = dataclasses.replace(dp, num_times=34, num_time_steps=2, rollout_noise=0.1)
    curriculum = dataclasses.replace(
        dp, num_times=34, num_time_steps=2, learning_stops=(4,), unroll_curriculum=(1, 2),
        curriculum_stops=(2, 4), eval_interval=2)
    trajectories = dataclasses.replace(dp, num_trajectories=8, num_times=12, num_time_steps=2)
    space = TrainingConfig(
        equation="ks", conservative=True, resample_factor=2, fine_size=64,
        num_trajectories=2, num_times=17, time_delta=0.1,
        model=ModelConfig(num_layers=1, filters=4, stencil_size=6), num_time_steps=1,
        learning_rates=(1e-3,), learning_stops=(3,), batch_size=8, eval_interval=3,
        frac_training=0.75, ic_scale=0.3)
    space_rel = dataclasses.replace(
        space, rollout_noise=0.1, loss_weights=LossWeights(relative_error=0.5))

    def trajectory_data(host):
        eq = teq.from_name("burgers", conservative=True)
        return lambda: tdata.build_trajectory_data(
            eq, Grid(128, eq.period), 0, num_trajectories=8, num_times=12, time_delta=0.1,
            resample_factor=4, unroll_steps=2, chunk_trajectories=4, host_resident=host,
            device="cpu")

    return {
        "dp": (dp, lambda: inputs["dp"], (4, 1)),
        "noise": (noise, lambda: inputs["noise"], (4, 1)),
        "curriculum": (curriculum, lambda: inputs["noise"], (4, 1)),
        "trajectories_host": (trajectories, trajectory_data(True), (4, 1)),
        "trajectories_device": (trajectories, trajectory_data(False), (4, 1)),
        "space": (space, lambda: None, (2, 2)),
        "space_rel": (space_rel, lambda: None, (2, 2)),
        "space4": (space, lambda: None, (1, 4)),
    }


def job_train(rank: int, world: int, inputs: dict, out: dict) -> None:
    """train(mesh=) for every case of ``train_cases``, and its refusals."""
    import dataclasses

    from pde_superresolution_torch import parallel
    from pde_superresolution_torch.training import loop

    meshes = {}
    for name, (config, dataset, shape) in train_cases(inputs).items():
        if shape not in meshes:
            meshes[shape] = parallel.make_mesh(*shape, device="cpu")
        _, params, metrics = loop.train(config, dataset=dataset(), device="cpu",
                                        mesh=meshes[shape])
        out[name] = (params, metrics)
    config = train_cases(inputs)["dp"][0]
    out["refused/batch"] = _error(lambda: loop.train(
        dataclasses.replace(config, batch_size=6), dataset=inputs["dp"], device="cpu",
        mesh=meshes[(4, 1)]))
    out["refused/eval"] = _error(lambda: loop.train(
        dataclasses.replace(config, frac_training=0.97), dataset=inputs["dp"]._replace(
            traj_ids=None), device="cpu", mesh=meshes[(4, 1)]))
    out["refused/kernel_space"] = _error(lambda: loop.train(
        train_cases(inputs)["space"][0], device="cpu", use_kernel=True, mesh=meshes[(2, 2)]))


def run_ensemble_under_torchrun(args: list) -> int:
    """``run_ensemble.main(args)`` in a torchrun rank; rank 0 saves the
    states it returns to the path after ``--save``."""
    from pde_superresolution_torch.scripts import run_ensemble

    save = args[args.index("--save") + 1]
    args = [a for i, a in enumerate(args) if a != "--save" and args[i - 1] != "--save"]
    result = run_ensemble.main(args)
    if int(os.environ["RANK"]) == 0:
        torch.save({k: result[k] for k in ("initial", "final", "times", "path")}, save)
    return 0


JOBS = {"mesh": job_mesh, "core": job_core, "train": job_train}


def main(argv: list) -> int:
    torch.set_num_threads(1)
    if argv[0] == "ensemble":
        return run_ensemble_under_torchrun(argv[1:])
    from pde_superresolution_torch import parallel

    import torch.distributed as dist

    job, rank, world, rdv, inputs_path, out_dir = argv
    rank, world = int(rank), int(world)
    parallel.initialize_multihost(device="cpu", init_method=f"file://{rdv}", rank=rank,
                                  world_size=world)
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        out: dict = {}
        JOBS[job](rank, world, inputs, out)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
