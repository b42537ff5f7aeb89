"""Train a learned discretization model.

The counterpart of ``pde_superresolution_tpu/scripts/run_training.py``:
``--hparams`` comma-separated overrides on ``TrainingConfig`` ->
``training.loop.train``. Without ``--input_path`` the snapshots are
generated on the device from the config (exact ETDRK4 solves);
``--large_ensemble`` takes the trajectory-structured pipeline. With
``--input_path`` they are read from an HDF5 file in the JAX package's layout
(``create_training_data`` of either package writes one; needs ``h5py``),
whose equation, physics, fine grid and snapshot spacing replace the
config's. The run is on ``cuda`` unless ``--device cpu`` is given.

Example:
  python -m pde_superresolution_torch.scripts.run_training \
      --checkpoint_dir /tmp/ckpt \
      --hparams equation=ks,resample_factor=8,num_time_steps=4

``--data_parallel N`` trains one replica per rank, one process per device
(``torchrun --standalone --nproc_per_node N -m
pde_superresolution_torch.scripts.run_training ... --data_parallel N``; N=1
runs without torchrun): each rank builds the same data, takes its rows of
every batch, and the gradients are averaged (``training.loop.train(mesh=)``).
Only rank 0 writes the checkpoints, metrics and events, and prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import torch

from pde_superresolution_torch import equations
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.training import config as config_lib
from pde_superresolution_torch.training import data as data_lib
from pde_superresolution_torch.training import loop as loop_lib

# auto --host_data threshold: leave room on the card for the fine generation
# chunks, model/optimizer state and unrolled-loss activations
_HOST_DATA_AUTO_BYTES = 6 * 1024**3


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_path", default=None,
                        help="HDF5 snapshots (optional; default: generate on the device)")
    parser.add_argument("--input_num_trajectories", type=int, default=0,
                        help="trajectory count for a 2-D [samples, x] --input_path "
                        "matrix (0 = the file's num_trajectories attr, or treat the "
                        "matrix as one contiguous trajectory)")
    parser.add_argument("--checkpoint_dir", required=True, help="checkpoint directory")
    parser.add_argument("--metrics_path", default=None,
                        help="JSONL metrics path (default: <checkpoint_dir>/metrics.jsonl)")
    parser.add_argument("--tensorboard_dir", default=None,
                        help="optional TensorBoard event-file dir (scalars mirrored "
                        "from the JSONL stream)")
    parser.add_argument("--hparams", default="",
                        help="comma-separated key=value overrides "
                        "(tuples use ';': learning_rates=1e-3;1e-4)")
    parser.add_argument("--large_ensemble", action="store_true",
                        help="use the trajectory-structured pipeline (chunked "
                        "generation on the device, lazy rollout windows, "
                        "by-trajectory eval split) for datasets of thousands "
                        "of trajectories that the flat pipeline cannot hold")
    parser.add_argument("--chunk_trajectories", type=int, default=1024,
                        help="trajectories per generation chunk (large_ensemble)")
    parser.add_argument("--host_data", choices=["auto", "true", "false"], default="auto",
                        help="stage the large_ensemble dataset in host memory and "
                        "move only each batch to the device (generation still "
                        "runs on the device, chunk by chunk); auto = stage on "
                        "the host when the estimated dataset exceeds 6 GB")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="train over this many ranks of a ('data',) mesh, one "
                        "process per device (torchrun --nproc_per_node N; N=1 runs "
                        "without it); 0 = one process")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def _estimated_dataset_bytes(equation, config) -> int:
    """float32 bytes of the TrajectoryData arrays the config will build."""
    nx_c = config.fine_size // config.resample_factor
    usable = config.num_times - config.num_time_steps
    per_traj = nx_c * (
        config.num_times + (len(equation.derivative_orders) + 1) * usable
    )
    return 4 * config.num_trajectories * per_traj


def main(argv: Optional[list[str]] = None) -> dict:
    """Run the training; returns the final metrics (``train_*``/``eval_*``)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.host_data == "true" and not args.large_ensemble:
        # silently ignoring the flag would let a bigger-than-memory run fail
        # despite the explicit request for host staging
        parser.error(
            "--host_data=true applies to the --large_ensemble trajectory "
            "pipeline only (the flat pipeline materializes rollouts and "
            "is not host-stageable); add --large_ensemble"
        )
    if args.large_ensemble and args.input_path:
        parser.error("--large_ensemble generates on the device; drop --input_path")
    if args.data_parallel < 0:
        parser.error("--data_parallel must be >= 0")
    if not args.data_parallel:
        return _run(args, None)
    import torch.distributed as dist

    from pde_superresolution_torch import parallel

    own_group = not dist.is_initialized()
    parallel.initialize_multihost(device=args.device)
    try:
        return _run(args, parallel.make_mesh(data=args.data_parallel, device=args.device))
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args: argparse.Namespace, mesh) -> dict:
    """``main`` after the process group: ``mesh`` is None without
    ``--data_parallel``."""
    device = resolve_device(args.device)
    config = config_lib.parse_hparams(args.hparams)
    dataset = None
    if args.large_ensemble:
        equation = equations.from_name(
            config.equation, conservative=config.conservative, **config.equation_params,
        )
        fine = Grid(config.fine_size, equation.period)
        if args.host_data == "auto":
            est = _estimated_dataset_bytes(equation, config)
            host_resident = est > _HOST_DATA_AUTO_BYTES
            if host_resident:
                print(f"host_data=auto: estimated dataset {est / 1024**3:.1f} GB > "
                      f"{_HOST_DATA_AUTO_BYTES / 1024**3:.0f} GB: staging on the host "
                      "(per-batch device transfer)")
        else:
            host_resident = args.host_data == "true"
        dataset = data_lib.build_trajectory_data(
            equation, fine, config.data_seed,
            num_trajectories=config.num_trajectories,
            num_times=config.num_times,
            time_delta=config.time_delta,
            resample_factor=config.resample_factor,
            unroll_steps=config.num_time_steps,
            warmup_time=config.warmup_time,
            ic_scale=config.ic_scale,
            chunk_trajectories=args.chunk_trajectories,
            host_resident=host_resident,
            device=device,
        )
    if args.input_path:
        snapshots, equation, fine = data_lib.load_snapshots_h5(
            args.input_path, num_trajectories=args.input_num_trajectories or None)
        times = snapshots.times
        time_delta = (float(times[1] - times[0]) if times.shape[0] > 1
                      else config.time_delta)
        config = dataclasses.replace(
            config,
            equation=equation.name,
            equation_params=equations.params_dict(equation),  # custom physics
            conservative=equation.conservative,
            fine_size=fine.size,
            # the unrolled loss must use the file's snapshot spacing
            time_delta=time_delta,
        )
        dataset = data_lib.build_training_data(
            equation, fine, data_lib.map_data(lambda a: a.to(device), snapshots),
            config.resample_factor,
            unroll_steps=config.num_time_steps,
        )
    metrics_path = args.metrics_path or f"{args.checkpoint_dir}/metrics.jsonl"
    _, _, metrics = loop_lib.train(
        config,
        dataset=dataset,
        checkpoint_dir=args.checkpoint_dir,
        metrics_path=metrics_path,
        tensorboard_dir=args.tensorboard_dir,
        device=device,
        mesh=mesh,
    )
    if mesh is None or torch.distributed.get_rank() == 0:
        print({k: round(v, 4) for k, v in metrics.items() if k.startswith("eval")})
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
