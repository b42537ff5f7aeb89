"""Training data generation and coarse-grained label construction.

The PyTorch counterpart of the JAX package's ``training/data.py``: ETDRK4
exact solves (``integrate.exact_solve_sampled``), spectral labels and
coarse-graining all run on the tensors' device. Snapshots go to and come
from HDF5 in the JAX package's layout (``save_snapshots_h5``,
``load_snapshots_h5``; ``h5py`` is imported inside them), so each package
reads the other's files.

Label conventions:
  * non-conservative (finite differences): coarse-graining = subsample;
    derivative labels are fine-grid spectral derivatives subsampled at the
    coarse points.
  * conservative (finite volumes): coarse-graining = block mean; derivative
    labels are fine-grid spectral derivatives evaluated (via the Fourier
    shift theorem) exactly at the coarse cell faces x_{j+1/2}; the
    time-derivative label is the block mean of the fine-grid RHS (exact, by
    linearity).

Randomness comes from explicit ``torch.Generator``s (CPU generators: the
draws are the same on any device). ``build_trajectory_data`` seeds chunk
``c`` from ``chunk_seed(seed, c)``, a pure function of the two, as the JAX
package folds ``c`` into its key.
"""

from __future__ import annotations

import json
import typing
import warnings
from typing import Optional

import numpy as np
import torch

from pde_superresolution_torch import integrate
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import Equation, ForcingParams, from_name, params_dict
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.ops import resample, spectral


class Snapshots(typing.NamedTuple):
    """Fine-grid solution snapshots."""

    u: torch.Tensor  # [num_trajectories, num_times, nx_fine]
    times: torch.Tensor  # [num_times]
    forcing: Optional[ForcingParams]  # leaves [num_trajectories, terms]
    # True when the times were synthesized (unit spacing): unrolled-loss
    # labels would then assume a wrong time structure (build_training_data)
    synthetic_times: bool = False


class TrainingData(typing.NamedTuple):
    """Flattened (trajectory, time) samples with coarse inputs and labels."""

    inputs: torch.Tensor  # [n, nx_coarse]
    t: torch.Tensor  # [n]
    forcing: Optional[ForcingParams]  # leaves [n, terms]
    deriv_labels: dict  # {order: [n, nx_coarse]}
    time_deriv_label: torch.Tensor  # [n, nx_coarse]
    rollout: torch.Tensor  # [n, unroll_steps, nx_coarse] (unroll may be 0)
    # source-trajectory index per sample [n], so train() can split
    # train/eval by trajectory; None for datasets without that structure
    traj_ids: Optional[torch.Tensor] = None

    @property
    def num_samples(self) -> int:
        return self.inputs.shape[0]


def map_data(fn, data):
    """``data`` (Snapshots, TrainingData or TrajectoryData) with ``fn``
    applied to every array leaf, forcing and label dicts included."""
    out = {}
    for name, value in data._asdict().items():
        if isinstance(value, dict):
            value = {d: fn(v) for d, v in value.items()}
        elif isinstance(value, ForcingParams):
            value = ForcingParams(*(fn(leaf) for leaf in value))
        elif isinstance(value, (torch.Tensor, np.ndarray)):
            value = fn(value)
        out[name] = value
    return type(data)(**out)


def generate_snapshots(
    equation: Equation,
    fine_grid: Grid,
    generator: torch.Generator,
    num_trajectories: int,
    num_times: int,
    time_delta: float,
    warmup_time: float = 0.0,
    ic_scale: float = 1.0,
    device=None,
) -> Snapshots:
    """Exact (spectral ETDRK4) solves sampled every ``time_delta``.

    The initial conditions, then the forcing, are drawn from ``generator``
    (a CPU generator) and moved to ``device`` (default ``cuda``), where the
    solve runs.
    """
    device = resolve_device(device)
    u0 = ic_scale * equation.initial_conditions(
        generator, fine_grid, (num_trajectories,), device)
    forcing = equation.sample_forcing(generator, (num_trajectories,), device)
    times, traj = integrate.exact_solve_sampled(
        equation, fine_grid, u0, time_delta, num_times,
        warmup_time=warmup_time, forcing=forcing,
    )
    # traj: [num_times, num_traj, nx] -> [num_traj, num_times, nx]
    return Snapshots(u=traj.transpose(0, 1).contiguous(), times=times, forcing=forcing)


@torch.no_grad()
def _coarse_fields_and_labels(
    equation: Equation,
    fine_grid: Grid,
    snapshots: Snapshots,
    factor: int,
    usable: int,
):
    """Shared label pipeline: (coarse series [traj, times, nx],
    {order: labels [traj, usable, nx]}, u_t labels [traj, usable, nx])."""
    conservative = equation.conservative
    u = snapshots.u  # [traj, times, nx_fine]
    if conservative:
        coarsen = lambda f: resample.resample_mean(f, factor)
    else:
        coarsen = lambda f: resample.subsample(f, factor)

    inputs_all = coarsen(u)  # [traj, times, nx_c]

    deriv_labels = {}
    for d in equation.derivative_orders:
        if conservative:
            # exact value/derivative at coarse right faces:
            # x = (j*factor + factor - 0.5) * dx_fine
            offset = (factor - 0.5) * fine_grid.dx
            shifted = spectral.spectral_derivative_at_offset(
                u, d, fine_grid.period, offset
            )
            label = resample.subsample(shifted, factor)
        else:
            fine_deriv = spectral.spectral_derivative(u, d, fine_grid.period)
            label = resample.subsample(fine_deriv, factor)
        deriv_labels[d] = label[:, :usable].contiguous()

    # the exact spectral RHS at each snapshot time; the per-trajectory
    # forcing broadcasts against u[:, i] [traj, nx]. An unforced RHS does
    # not depend on t, so it takes every time at once.
    rhs = integrate.SpectralDifferentiator(equation, fine_grid, u.device).rhs_fn(
        snapshots.forcing
    )
    if snapshots.forcing is None:
        ut_fine = rhs(u[:, :usable], snapshots.times[0])
    else:
        ut_fine = torch.stack(
            [rhs(u[:, i], snapshots.times[i]) for i in range(usable)], dim=1
        )
    time_deriv_label = coarsen(ut_fine).contiguous()
    return inputs_all.contiguous(), deriv_labels, time_deriv_label


def build_training_data(
    equation: Equation,
    fine_grid: Grid,
    snapshots: Snapshots,
    resample_factor: int,
    unroll_steps: int = 0,
) -> TrainingData:
    """Coarse inputs + spectral labels from fine snapshots (see module doc),
    on the snapshots' device."""
    factor = resample_factor
    coarse = fine_grid.resample(factor)
    u = snapshots.u  # [traj, times, nx_fine]
    num_traj, num_times, _ = u.shape
    usable = num_times - unroll_steps
    if usable < 1:
        raise ValueError(
            f"need > {unroll_steps} snapshot times, got {num_times}"
        )
    if unroll_steps > 0 and snapshots.synthetic_times:
        raise ValueError(
            "unrolled-loss training from snapshots with synthesized times: "
            "the snapshot spacing (and trajectory structure) is unknown and "
            "rollout labels would be silently wrong. Set num_time_steps=0 "
            "(derivative-only training) or give the snapshots real times."
        )
    times = snapshots.times
    inputs_all, deriv_labels, time_deriv_label = _coarse_fields_and_labels(
        equation, fine_grid, snapshots, factor, usable
    )

    if unroll_steps > 0:
        idx = (torch.arange(usable)[:, None] + torch.arange(1, unroll_steps + 1)).to(u.device)
        rollout = inputs_all[:, idx]  # [traj, usable, K, nx_c]
    else:
        rollout = inputs_all.new_zeros((num_traj, usable, 0, coarse.size))

    # flatten (traj, time) -> samples
    def flat(a):
        return a.reshape((num_traj * usable,) + tuple(a.shape[2:]))

    forcing_flat = None
    if snapshots.forcing is not None:
        forcing_flat = ForcingParams(
            *(leaf.repeat_interleave(usable, dim=0) for leaf in snapshots.forcing)
        )
    return TrainingData(
        inputs=flat(inputs_all[:, :usable]),
        t=times[:usable].repeat(num_traj),
        forcing=forcing_flat,
        deriv_labels={d: flat(v) for d, v in deriv_labels.items()},
        time_deriv_label=flat(time_deriv_label),
        rollout=flat(rollout),
        traj_ids=torch.arange(num_traj, dtype=torch.int32, device=u.device)
        .repeat_interleave(usable),
    )


# ---------------------------------------------------------------------------
# Large-ensemble training: trajectory-structured dataset + sampler.
# ---------------------------------------------------------------------------


class TrajectoryData(typing.NamedTuple):
    """Trajectory-structured training data for large ensembles.

    Unlike the flat ``TrainingData`` (whose materialized ``rollout`` copies
    each field ``unroll_steps`` times), rollout windows are gathered from the
    full coarse series when a batch is sampled: one copy of each label array.

    Leaves are tensors on the training device (default), or host numpy
    arrays (``build_trajectory_data(host_resident=True)``): batch gathers
    then run in numpy and only the gathered batch crosses to the device each
    step, for ensembles larger than the card's memory.
    """

    series: torch.Tensor  # [traj, num_times, nx] full coarse series
    times: torch.Tensor  # [num_times]
    forcing: Optional[ForcingParams]  # leaves [traj, terms]
    deriv_labels: dict  # {order: [traj, usable, nx]}
    time_deriv_label: torch.Tensor  # [traj, usable, nx]
    unroll_steps: int

    @property
    def num_trajectories(self) -> int:
        return self.series.shape[0]

    @property
    def usable_times(self) -> int:
        return self.series.shape[1] - self.unroll_steps

    @property
    def host_resident(self) -> bool:
        return isinstance(self.series, np.ndarray)

    def nbytes(self) -> int:
        """Total array bytes (device or host) held by this dataset."""
        arrays = [self.series, self.times, self.time_deriv_label]
        arrays += list(self.deriv_labels.values())
        if self.forcing is not None:
            arrays += list(self.forcing)
        return sum(a.nbytes if isinstance(a, np.ndarray) else a.numel() * a.element_size()
                   for a in arrays)


def chunk_seed(seed: int, chunk: int) -> int:
    """The generator seed of chunk ``chunk`` of a dataset seeded ``seed``: a
    pure function of the two (numpy's ``SeedSequence``)."""
    return int(np.random.SeedSequence([seed, chunk]).generate_state(1, np.uint64)[0] >> 1)


def build_trajectory_data(
    equation: Equation,
    fine_grid: Grid,
    seed: int,
    num_trajectories: int,
    num_times: int,
    time_delta: float,
    resample_factor: int,
    unroll_steps: int,
    warmup_time: float = 0.0,
    ic_scale: float = 1.0,
    chunk_trajectories: int = 512,
    host_resident: bool = False,
    device=None,
) -> TrajectoryData:
    """Generate a large ensemble in trajectory chunks on ``device`` (fine
    snapshots are discarded per chunk; only coarse fields and labels
    accumulate). Chunk ``c`` draws from a generator seeded
    ``chunk_seed(seed, c)``.

    With ``host_resident=True`` each chunk's coarse fields and labels go to
    host numpy as soon as they are computed (generation itself still runs on
    ``device``, one chunk of fine snapshots at a time); the dataset's leaves
    are numpy and its size is bounded by host memory, not the card's.
    """
    device = resolve_device(device)
    chunks = []
    usable = num_times - unroll_steps
    num_chunks = int(np.ceil(num_trajectories / chunk_trajectories))
    to_host = (lambda a: a.cpu().numpy()) if host_resident else (lambda a: a)
    for c in range(num_chunks):
        n_c = min(chunk_trajectories, num_trajectories - c * chunk_trajectories)
        snaps = generate_snapshots(
            equation, fine_grid, torch.Generator().manual_seed(chunk_seed(seed, c)),
            n_c, num_times, time_delta, warmup_time=warmup_time, ic_scale=ic_scale,
            device=device,
        )
        series, deriv_labels, ut_label = _coarse_fields_and_labels(
            equation, fine_grid, snaps, resample_factor, usable
        )
        chunks.append(map_data(to_host, TrajectoryData(
            series=series,
            times=snaps.times,
            forcing=snaps.forcing,
            deriv_labels=deriv_labels,
            time_deriv_label=ut_label,
            unroll_steps=unroll_steps,
        )))
    cat = (lambda leaves: np.concatenate(leaves, axis=0)) if host_resident else (
        lambda leaves: torch.cat(leaves, dim=0))
    forcing = None
    if chunks[0].forcing is not None:
        forcing = ForcingParams(*(cat(list(leaves))
                                  for leaves in zip(*[c.forcing for c in chunks])))
    return TrajectoryData(
        series=cat([c.series for c in chunks]),
        times=chunks[-1].times,
        forcing=forcing,
        deriv_labels={
            d: cat([c.deriv_labels[d] for c in chunks]) for d in chunks[0].deriv_labels
        },
        time_deriv_label=cat([c.time_deriv_label for c in chunks]),
        unroll_steps=unroll_steps,
    )


def sample_training_batch(
    data: TrajectoryData,
    traj_idx,
    time_idx,
    unroll_steps: int | None = None,
) -> TrainingData:
    """Gather a flat TrainingData batch (with rollout windows) from the
    structured dataset: pure gathers, rollout windows sliced from
    ``series``. Index arrays are tensors on the dataset's device, or numpy
    for a host-resident dataset, whose gathers then run in numpy on the host
    and return a numpy batch (the training loop moves just the batch)."""
    k = data.unroll_steps if unroll_steps is None else unroll_steps
    if data.host_resident:
        window = time_idx[:, None] + np.arange(1, k + 1)
        ids = traj_idx.astype(np.int32)
    else:
        window = time_idx[:, None] + torch.arange(1, k + 1, device=time_idx.device)
        ids = traj_idx.to(torch.int32)
    forcing = None
    if data.forcing is not None:
        forcing = ForcingParams(*(leaf[traj_idx] for leaf in data.forcing))
    return TrainingData(
        inputs=data.series[traj_idx, time_idx],
        t=data.times[time_idx],
        forcing=forcing,
        deriv_labels={d: v[traj_idx, time_idx] for d, v in data.deriv_labels.items()},
        time_deriv_label=data.time_deriv_label[traj_idx, time_idx],
        rollout=data.series[traj_idx[:, None], window],  # [B, K, nx]
        traj_ids=ids,
    )


# ---------------------------------------------------------------------------
# HDF5 interchange: dataset 'v' of snapshots, the JAX package's layout.
# ---------------------------------------------------------------------------


def save_snapshots_h5(
    path: str, snapshots: Snapshots, equation: Equation, fine_grid: Grid
) -> None:
    """Write snapshots to HDF5: dataset ``v`` [traj, times, nx], ``times``,
    the forcing group, and the attrs ``equation``, ``conservative``,
    ``period``, ``fine_size`` and ``equation_params`` (JSON, every field
    but ``conservative``, so non-default physics round-trips)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("v", data=snapshots.u.detach().cpu().numpy())
        f.create_dataset("times", data=snapshots.times.detach().cpu().numpy())
        f.attrs["equation"] = equation.name
        f.attrs["conservative"] = equation.conservative
        f.attrs["period"] = equation.period
        f.attrs["fine_size"] = fine_grid.size
        f.attrs["equation_params"] = json.dumps(params_dict(equation))
        if snapshots.forcing is not None:
            g = f.create_group("forcing")
            for name, leaf in snapshots.forcing._asdict().items():
                g.create_dataset(name, data=leaf.detach().cpu().numpy())


def load_snapshots_h5(
    path: str, num_trajectories: Optional[int] = None
) -> tuple[Snapshots, Equation, Grid]:
    """Load snapshots (CPU tensors), the equation and the fine grid. Both
    layouts are accepted:

      * 3-D ``v`` [trajectory, time, x] + ``times`` [time];
      * 2-D ``v`` [samples, x]: the sample axis is split into
        ``num_trajectories`` equal trajectories (the argument, or the
        file's ``num_trajectories`` attr); with neither it is ONE
        contiguous trajectory, with a warning, since rollout windows would
        silently span any hidden trajectory boundaries.

    Flat ``times`` of length trajectories x times must share one window
    (warning when only the start times differ). Without a ``times``
    dataset the times are synthesized as arange and the snapshots are
    marked ``synthetic_times``; ``build_training_data`` then refuses
    unrolled-loss training (the spacing is unknown).
    """
    import h5py

    with h5py.File(path, "r") as f:
        u = torch.from_numpy(np.asarray(f["v"][...]))
        synthetic = False
        if u.ndim == 2:
            count = num_trajectories or int(f.attrs.get("num_trajectories", 0))
            if count:
                if u.shape[0] % count:
                    raise ValueError(
                        f"2-D snapshot matrix with {u.shape[0]} samples does "
                        f"not divide into num_trajectories={count}"
                    )
                u = u.reshape(count, u.shape[0] // count, u.shape[1])
            else:
                warnings.warn(
                    f"{path}: 2-D snapshot matrix with no trajectory count "
                    "(num_trajectories attr or argument): treating all "
                    f"{u.shape[0]} samples as ONE contiguous trajectory. If "
                    "the rows are independent snapshots or concatenated "
                    "trajectories, declare the count.",
                    stacklevel=2,
                )
                u = u[None]
        if "times" in f:
            times = torch.from_numpy(np.asarray(f["times"][...]))
            k, nt = u.shape[0], u.shape[1]
            if times.shape[0] == k * nt and times.shape[0] != nt:
                # flat times beside a reshaped 2-D matrix: every trajectory
                # must share ONE time window (the loader keeps one [T] axis)
                per_traj = times.numpy().reshape(k, nt)
                rel = per_traj - per_traj[:, :1]
                if not np.allclose(rel, rel[0], rtol=1e-6, atol=1e-8):
                    raise ValueError(
                        f"{path}: flat 'times' of length {k * nt} does not "
                        f"split into {k} trajectories with a shared time "
                        "window (rows have differing spacings); store times "
                        "as one [num_times] axis or fix num_trajectories"
                    )
                if not np.allclose(per_traj[:, 0], per_traj[0, 0]):
                    # segments of one long run: only time differences enter
                    # training for unforced equations; forced labels need t
                    warnings.warn(
                        f"{path}: trajectories have differing start times; "
                        "using trajectory 0's window for all (forced-"
                        "equation labels would be wrong for the rest)",
                        stacklevel=2,
                    )
                times = times[:nt]
            elif times.shape[0] != nt:
                raise ValueError(
                    f"{path}: 'times' has length {times.shape[0]}, expected "
                    f"{nt} (per-trajectory) or {k * nt} (flat)"
                )
        else:
            times = torch.arange(u.shape[1], dtype=torch.float32)
            synthetic = True
        forcing = None
        if "forcing" in f:
            forcing = ForcingParams(
                **{k: torch.from_numpy(np.asarray(v[...])) for k, v in f["forcing"].items()}
            )
        params = json.loads(f.attrs.get("equation_params", "{}"))
        params.setdefault("period", float(f.attrs["period"]))
        equation = from_name(
            f.attrs["equation"], conservative=bool(f.attrs["conservative"]), **params
        )
        grid = Grid(int(f.attrs["fine_size"]), float(f.attrs["period"]))
    return (
        Snapshots(u=u, times=times, forcing=forcing, synthetic_times=synthetic),
        equation,
        grid,
    )
