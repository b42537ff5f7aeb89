"""The training loop: Adam + piecewise LR, checkpoints, JSONL logs.

The PyTorch counterpart of the JAX package's ``training/loop.py``:

  * one train step = ``compute_loss``, ``torch.autograd.grad`` and the
    optimizer update; batches are gathered on the device from a
    device-resident dataset (or, for a host-resident ``TrajectoryData``,
    gathered on the host and moved);
  * the optimizer is optax's ``apply_if_finite(chain(clip_by_global_norm,
    adam(join_schedules(...))))``, written out (``Optimizer``): a non-finite
    gradient skips the whole update, so the learning-rate schedule counts
    applied updates, not loop steps;
  * checkpoints are one directory per step (the last 3 kept): ``model.npz``
    (params under the JAX package's leaf names, read back by
    ``convert.params_from_jax``), ``model.json`` (the config JSON, the JAX
    package's layout), ``opt_state.npz`` (Adam's moments) and ``state.json``
    (the step and the count of applied updates). A resumed run replays the
    uninterrupted one: batches, rollout noise and updates are pure functions
    of (seed, step) and the saved state;
  * metrics stream to JSONL via ``utils.metrics.MetricsLogger``, with the
    JAX package's keys.

The numpy ``RandomState`` streams of the train/eval split and of the batches
are the JAX package's, so both draw the same samples.
"""

from __future__ import annotations

import json
import os
import shutil
import typing
import warnings
from typing import Mapping, Optional

import numpy as np
import torch

from pde_superresolution_torch import convert
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import from_name
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models.stencil_net import StencilModel
from pde_superresolution_torch.training import data as data_lib
from pde_superresolution_torch.training import losses as loss_lib
from pde_superresolution_torch.training.config import TrainingConfig
from pde_superresolution_torch.utils.metrics import MetricsLogger

KEEP_CHECKPOINTS = 3


class AdamState(typing.NamedTuple):
    """The optimizer's state. ``count`` is the number of applied updates: it
    is Adam's bias-correction count and the learning-rate schedule's step,
    as optax's ``ScaleByAdamState.count`` and ``ScaleByScheduleState.count``
    (both frozen by a skipped update)."""

    count: int
    mu: dict
    nu: dict


class TrainState(typing.NamedTuple):
    params: dict
    opt_state: AdamState
    step: int


def _leaf_order(name: str) -> tuple:
    """Sort key giving the JAX params tree's leaf order (heads by order name,
    then the tower by layer; w before b): optax sums the global norm in it."""
    kind, key, leaf = name.split(".")
    return (kind != "heads", key if kind == "heads" else int(key), leaf != "weight")


class Optimizer:
    """optax's ``apply_if_finite(chain(clip_by_global_norm(clip),
    adam(join_schedules(constants, boundaries=stops[:-1]))))`` on a state
    dict, in float32 and in optax's order of operations:

      * a gradient with any non-finite value skips the whole update: params,
        moments and ``count`` stay as they were;
      * ``clip_by_global_norm``: each leaf becomes ``(g / norm) * clip`` when
        ``norm >= clip`` (the norm summed over the leaves in the JAX tree's
        order), else stays;
      * Adam (b1 0.9, b2 0.999, eps 1e-8): ``mu = (1 - b1) g + b1 mu``,
        ``nu = (1 - b2) g^2 + b2 nu``, bias-corrected by ``1 - b^(count+1)``,
        ``update = mu_hat / (sqrt(nu_hat) + eps)``;
      * the step is ``-lr(count) * update``, ``lr(count)`` the rate whose
        boundary ``count`` has reached (``count >= boundary`` switches).
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rates, learning_stops, grad_clip_norm: float):
        rates, stops = list(learning_rates), list(learning_stops)
        if len(rates) != len(stops):
            raise ValueError("learning_rates and learning_stops must align")
        self.rates = rates
        self.boundaries = stops[:-1]
        self.clip = grad_clip_norm

    def learning_rate(self, count: int) -> float:
        rate = self.rates[0]
        for boundary, r in zip(self.boundaries, self.rates[1:]):
            if count >= boundary:
                rate = r
        return rate

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor]) -> tuple[dict, AdamState]:
        """(new params, new state); one host synchronization (the finite
        check)."""
        names = sorted(params, key=_leaf_order)
        if not bool(torch.stack([torch.isfinite(grads[k]).all() for k in names]).all()):
            return dict(params), state
        g = {k: grads[k] for k in names}
        if self.clip > 0:
            norm = torch.sqrt(sum(torch.sum(g[k] * g[k]) for k in names))
            keep = norm < self.clip
            g = {k: torch.where(keep, v, (v / norm) * self.clip) for k, v in g.items()}
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        step = float(f32(-self.learning_rate(state.count)))
        mu, nu, new = {}, {}, {}
        for k in names:
            mu[k] = (1 - self.b1) * g[k] + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * (g[k] * g[k]) + self.b2 * state.nu[k]
            update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            new[k] = params[k] + step * update
        new = {k: new[k] for k in params}
        return new, AdamState(count=count, mu=mu, nu=nu)


def make_optimizer(config: TrainingConfig) -> Optimizer:
    """Adam with the reference's piecewise-constant LR schedule, gradient
    clipping and the skip of non-finite updates."""
    return Optimizer(config.learning_rates, config.learning_stops, config.grad_clip_norm)


# Config fields allowed to differ when resuming from a checkpoint: they only
# extend or re-pace the run. (learning_stops is special-cased: only its LAST
# element, which sets num_steps, not the schedule's boundaries, may change.)
_RESUME_MUTABLE = frozenset(
    {"eval_interval", "checkpoint_interval", "learning_stops"}
)


def _noise_generator(config: TrainingConfig, step: int) -> torch.Generator:
    """Per-step rollout-noise generator, a pure function of (seed, step), so
    that resumed runs replay the noise stream of an uninterrupted one. The
    offset decorrelates it from the data_seed/seed streams used for initial
    conditions and init."""
    return torch.Generator().manual_seed(data_lib.chunk_seed(config.seed + 0x6E01, step))


# --- checkpoints ---------------------------------------------------------------


def checkpoint_steps(checkpoint_dir: str) -> list[int]:
    """The steps with a complete checkpoint under ``checkpoint_dir``, sorted."""
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(
        int(name) for name in os.listdir(checkpoint_dir)
        if name.isdigit() and os.path.isfile(os.path.join(checkpoint_dir, name, "state.json"))
    )


def _config_dict(config: TrainingConfig) -> dict:
    return json.loads(config.to_json())


def save_checkpoint(checkpoint_dir: str, state: TrainState, config: TrainingConfig) -> str:
    """Write ``<checkpoint_dir>/<step>/`` (see the module doc) through a
    temporary directory renamed into place; keep the newest
    ``KEEP_CHECKPOINTS``."""
    path = os.path.join(checkpoint_dir, str(state.step))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "model.npz"), **convert.npz_arrays_from_params(state.params))
    with open(os.path.join(tmp, "model.json"), "w") as f:
        json.dump(_config_dict(config), f, indent=1, sort_keys=True)
    opt = state.opt_state
    np.savez(os.path.join(tmp, "opt_state.npz"),
             **{f"mu/{k}": v.cpu().numpy() for k, v in opt.mu.items()},
             **{f"nu/{k}": v.cpu().numpy() for k, v in opt.nu.items()})
    with open(os.path.join(tmp, "state.json"), "w") as f:
        json.dump({"step": state.step, "count": opt.count}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    for old in checkpoint_steps(checkpoint_dir)[:-KEEP_CHECKPOINTS]:
        shutil.rmtree(os.path.join(checkpoint_dir, str(old)))
    return path


def _stored_config(path: str) -> dict:
    with open(os.path.join(path, "model.json")) as f:
        return json.load(f)


def _restore_state(checkpoint_dir: str, state: TrainState, config: TrainingConfig) -> TrainState:
    """Restore the latest step's state, validating the live config against
    the one stored with it.

    Resuming a directory with changed hparams would silently continue with
    mismatched optimizer/schedule/data semantics. Raises ValueError listing
    every differing field outside ``_RESUME_MUTABLE``.
    """
    steps = checkpoint_steps(checkpoint_dir)
    if not steps:
        return state
    latest = steps[-1]
    path = os.path.join(checkpoint_dir, str(latest))
    stored = _stored_config(path)
    live = _config_dict(config)
    # configs written before a field existed stay resumable: round-trip the
    # stored dict so missing fields take the live defaults
    try:
        stored = _config_dict(TrainingConfig.from_json(json.dumps(stored)))
    except (TypeError, KeyError):
        pass  # unknown/missing stored keys: the explicit diff below reports
    diffs = {
        k: (stored.get(k), live.get(k))
        for k in sorted(set(stored) | set(live))
        if k not in _RESUME_MUTABLE and stored.get(k) != live.get(k)
    }
    s_stops = list(stored.get("learning_stops", []))
    l_stops = list(live.get("learning_stops", []))
    if s_stops[:-1] != l_stops[:-1] or len(s_stops) != len(l_stops):
        diffs["learning_stops"] = (s_stops, l_stops)
    if diffs:
        raise ValueError(
            f"checkpoint at step {latest} was written with a different "
            f"config; refusing to resume. Differing fields "
            f"(stored, live): {diffs}. Use a fresh checkpoint_dir or "
            f"match the stored config."
        )
    device = next(iter(state.params.values())).device
    params = convert.params_from_jax(
        convert.jax_tree_from_npz(os.path.join(path, "model.npz")), device)
    with np.load(os.path.join(path, "opt_state.npz")) as arrays:
        moments = {k: torch.from_numpy(arrays[k]).to(device) for k in arrays.files}
    with open(os.path.join(path, "state.json")) as f:
        counts = json.load(f)
    opt = AdamState(
        count=counts["count"],
        mu={k: moments[f"mu/{k}"] for k in params},
        nu={k: moments[f"nu/{k}"] for k in params},
    )
    return TrainState({k: params[k] for k in state.params}, opt, counts["step"])


# --- batches -------------------------------------------------------------------


def _slice_batch(dataset: data_lib.TrainingData, idx: torch.Tensor) -> data_lib.TrainingData:
    """Rows ``idx`` of every leaf (on the dataset's device)."""
    idx = torch.as_tensor(idx, device=dataset.inputs.device)
    return data_lib.map_data(lambda leaf: leaf.index_select(0, idx), dataset)


def _block(batch: data_lib.TrainingData, shard) -> data_lib.TrainingData:
    """This rank's block of a global batch: its rows and, of the fields, its
    points of the grid (``parallel.sharded.Shard``)."""
    rows, cols = shard.rows(batch.num_samples), shard.cols()

    def field(leaf):
        return leaf[rows][..., cols]

    return data_lib.TrainingData(
        inputs=field(batch.inputs),
        t=batch.t[rows],
        forcing=shard.forcing_rows(batch.forcing),
        deriv_labels={d: field(v) for d, v in batch.deriv_labels.items()},
        time_deriv_label=field(batch.time_deriv_label),
        rollout=field(batch.rollout),
        traj_ids=None if batch.traj_ids is None else batch.traj_ids[rows],
    )


def _world_mean(tensors: list) -> list:
    """Each tensor averaged over every rank of the process group, in one
    all-reduce; every rank gets the same values."""
    import torch.distributed as dist

    flat = torch.cat([x.reshape(-1) for x in tensors])
    dist.all_reduce(flat)
    flat = flat / dist.get_world_size()
    return [piece.reshape(x.shape) for piece, x in
            zip(torch.split(flat, [x.numel() for x in tensors]), tensors)]


def _shard(config: TrainingConfig, model: StencilModel, mesh):
    """The rank's ``parallel.sharded.Shard`` of ``mesh`` (None without one);
    refuses a batch the data axis does not divide."""
    if mesh is None:
        return None
    from pde_superresolution_torch.parallel.sharded import Shard

    shard = Shard(mesh, model.grid.size)
    if config.batch_size % shard.n_data:
        raise ValueError(
            f"batch_size {config.batch_size} must be divisible by the "
            f"mesh data axis ({shard.n_data})"
        )
    return shard


def _split_train_eval(
    dataset: data_lib.TrainingData, frac_training: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """(train_idx, eval_idx) sample indices, split by trajectory.

    A random split of the flattened (trajectory, time) samples would leak
    each eval trajectory's other timesteps into training. Falls back to the
    sample-level split, with a warning, only when the dataset carries no
    trajectory ids.
    """
    n = dataset.num_samples
    rng = np.random.RandomState(seed)
    if dataset.traj_ids is None:
        warnings.warn(
            "dataset carries no traj_ids: falling back to a sample-level "
            "train/eval split, which leaks eval trajectories' other "
            "timesteps into training (eval losses will read optimistic). "
            "Build the dataset with build_training_data to get the "
            "by-trajectory split.",
            stacklevel=3,
        )
        perm = rng.permutation(n)
        n_train = int(frac_training * n)
        if n_train in (0, n):
            raise ValueError(
                f"eval split is empty ({n} samples, frac_training="
                f"{frac_training}): lower frac_training or add data"
            )
        return perm[:n_train], perm[n_train:]
    ids = dataset.traj_ids.cpu().numpy()
    unique = np.unique(ids)
    traj_perm = rng.permutation(unique)
    n_train_traj = int(frac_training * unique.size)
    train_traj = traj_perm[:n_train_traj]
    mask = np.isin(ids, train_traj)
    # shuffle within each split so fixed-size batch slices don't correlate
    # with trajectory order
    train_idx = rng.permutation(np.nonzero(mask)[0])
    eval_idx = rng.permutation(np.nonzero(~mask)[0])
    if eval_idx.size == 0 or train_idx.size == 0:
        raise ValueError(
            f"train or eval split is empty under the by-trajectory split "
            f"({unique.size} trajectories, frac_training={frac_training}): "
            "adjust frac_training or add trajectories"
        )
    return train_idx, eval_idx


def _substeps(config: TrainingConfig, model: StencilModel) -> int:
    """Inner RK4 steps per snapshot interval: the config's, or (0 = auto)
    enough to respect the model's own explicit-RK4 limit."""
    if config.coarse_time_subsample:
        return config.coarse_time_subsample
    stable = model.stable_time_step(u_scale=3.0)
    return max(1, int(np.ceil(config.time_delta / stable)))


def _step_functions(config: TrainingConfig, model: StencilModel, tx: Optimizer,
                    full_norms: loss_lib.LossNorms, substeps: int, use_kernel: bool,
                    shard=None):
    """``make_steps(unroll_k) -> (train_step, eval_step)`` for one curriculum
    phase, the integrated-target norms restricted to its width.

    With a ``shard`` each rank's loss covers its block of the batch; the
    gradients are averaged over every rank before the update (so the clip
    sees the global gradient, and every rank applies the same update), and
    so are the logged parts. The average over the whole world is the
    global batch's: the ranks of one ``"space"`` ring each hold the global
    grid mean (``SpaceShardedLoss``), whose differentiable all-reduce gives
    each of them the whole gradient of its block's share."""

    def make_steps(unroll_k: int):
        norms = loss_lib.truncate_norms(full_norms, unroll_k)

        def loss_fn(params, batch, noise_generator=None):
            return loss_lib.compute_loss(
                model, params, batch, norms, config.loss_weights, dt=config.time_delta,
                unroll_steps=unroll_k, substeps=substeps, use_kernel=use_kernel,
                rollout_noise=config.rollout_noise, noise_generator=noise_generator,
                shard=shard,
            )

        def averaged(parts):
            parts = {k: v.detach() for k, v in parts.items()}
            if shard is None:
                return parts
            return dict(zip(parts, _world_mean(list(parts.values()))))

        def train_step(state: TrainState, batch):
            params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
            noise = (_noise_generator(config, state.step)
                     if config.rollout_noise > 0 else None)
            loss, parts = loss_fn(params, batch, noise)
            grads = torch.autograd.grad(loss, list(params.values()))
            if shard is not None:
                grads = _world_mean(list(grads))
            new_params, opt_state = tx.update(dict(zip(params, grads)), state.opt_state,
                                              state.params)
            return TrainState(new_params, opt_state, state.step + 1), averaged(parts)

        @torch.no_grad()
        def eval_step(params, batch):
            # eval is always clean: no rollout noise
            return averaged(loss_fn(params, batch)[1])

        return train_step, eval_step

    return make_steps


def _run_phases(config, state, make_steps, next_batch, eval_batch, checkpoint_dir,
                metrics_path, tensorboard_dir, shard=None):
    """The step loop shared by both dataset layouts: per curriculum phase,
    train steps on ``next_batch(step)``, evals every ``eval_interval`` and
    at each phase's end, checkpoints every ``checkpoint_interval`` and at
    each phase's end. Every rank restores; with a ``shard`` only rank 0
    writes checkpoints, metrics and events, and the ranks meet at the end."""
    import torch.distributed as dist

    writer = shard is None or dist.get_rank() == 0
    if checkpoint_dir:
        state = _restore_state(checkpoint_dir, state, config)
    if not writer:
        checkpoint_dir = metrics_path = tensorboard_dir = None
    logger = MetricsLogger(metrics_path, tensorboard_dir)
    metrics = {}
    for unroll_k, phase_end in config.curriculum_phases():
        if state.step >= phase_end:
            continue  # resumed past this phase
        train_step, eval_step = make_steps(unroll_k)
        for step in range(state.step, phase_end):
            state, parts = train_step(state, next_batch(step))
            if (step + 1) % config.eval_interval == 0 or step + 1 == phase_end:
                eval_parts = eval_step(state.params, eval_batch)
                metrics = {
                    **{f"train_{k}": float(v) for k, v in parts.items()},
                    **{f"eval_{k}": float(v) for k, v in eval_parts.items()},
                }
                logger.log(step + 1, unroll_steps=unroll_k, **metrics)
            if checkpoint_dir and (
                (step + 1) % config.checkpoint_interval == 0 or step + 1 == phase_end
            ):
                save_checkpoint(checkpoint_dir, state, config)
    logger.close()
    if shard is not None:
        dist.barrier()
    return state, metrics


def _model_for(config: TrainingConfig, device) -> tuple:
    equation = from_name(
        config.equation,
        conservative=config.conservative,
        **config.equation_params,
    )
    fine = Grid(config.fine_size, equation.period)
    coarse = fine.resample(config.resample_factor, conservative=config.conservative)
    return equation, fine, StencilModel(equation, coarse, config.model, device=device)


def _initial_state(config: TrainingConfig, model: StencilModel, tx: Optimizer) -> TrainState:
    params = model.init_params(torch.Generator().manual_seed(config.seed))
    return TrainState(params, tx.init(params), 0)


def train(
    config: TrainingConfig,
    dataset=None,
    checkpoint_dir: Optional[str] = None,
    metrics_path: Optional[str] = None,
    tensorboard_dir: Optional[str] = None,
    device=None,
    use_kernel: bool = False,
    mesh=None,
) -> tuple[StencilModel, dict, dict]:
    """Train a learned discretization end to end on ``device`` (default
    ``cuda``).

    If ``dataset`` is None, snapshots are generated on the device from the
    config (exact ETDRK4 solves, generator seeded ``data_seed``); a
    ``TrajectoryData`` takes the large-ensemble path. ``use_kernel`` is the
    unrolled loss's RHS route (``compute_loss``); False, the default, is the
    JAX package's training route. Returns (model, params, final_metrics).

    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``, ``parallel.make_mesh``)
    trains one replica per rank, as the JAX package's GSPMD split does:
    every rank builds the same dataset and norms and draws the same global
    batch, keeps its rows ``[r * b / N, (r + 1) * b / N)`` (and, where the
    mesh's ``"space"`` axis is larger than 1, its points of the grid, the
    rollout through ``parallel.sharded_model_rhs``), and the gradients are
    averaged before the update. The eval split is trimmed to a multiple of
    the data axis and its metrics averaged. Only rank 0 writes. With a
    space axis larger than 1, ``use_kernel=True`` is refused.
    """
    device = resolve_device(device)
    equation, fine, model = _model_for(config, device)
    shard = _shard(config, model, mesh)
    if isinstance(dataset, data_lib.TrajectoryData):
        return _train_on_trajectories(config, model, dataset, checkpoint_dir,
                                      metrics_path, tensorboard_dir, use_kernel, shard)

    if dataset is None:
        snapshots = data_lib.generate_snapshots(
            equation,
            fine,
            torch.Generator().manual_seed(config.data_seed),
            num_trajectories=config.num_trajectories,
            num_times=config.num_times,
            time_delta=config.time_delta,
            warmup_time=config.warmup_time,
            ic_scale=config.ic_scale,
            device=device,
        )
        dataset = data_lib.build_training_data(
            equation, fine, snapshots, config.resample_factor,
            unroll_steps=config.num_time_steps,
        )
    dataset = data_lib.map_data(lambda leaf: torch.as_tensor(leaf).to(device), dataset)

    train_idx, eval_idx = _split_train_eval(dataset, config.frac_training, config.seed)
    n_train = train_idx.size
    train_set = _slice_batch(dataset, train_idx)
    eval_set = _slice_batch(dataset, eval_idx)
    if shard is not None:
        # trim the eval split to a multiple of the data axis
        n_eval = (eval_set.num_samples // shard.n_data) * shard.n_data
        if n_eval == 0:
            raise ValueError("eval split smaller than the mesh data axis")
        eval_set = _block(_slice_batch(eval_set, np.arange(n_eval)), shard)
    substeps = _substeps(config, model)
    phases = config.curriculum_phases()

    tx = make_optimizer(config)
    state = _initial_state(config, model, tx)
    # norms once, at the final curriculum width, on the whole train set (on
    # every rank); each phase takes the prefix
    full_norms = loss_lib.compute_loss_norms(
        model, train_set, phases[-1][0], config.time_delta, substeps,
        floor_quantile=config.loss_weights.error_floor_quantile,
    )
    make_steps = _step_functions(config, model, tx, full_norms, substeps, use_kernel, shard)

    def next_batch(step):
        # batch indices are a pure function of (seed, step), so that a
        # resumed run replays the batch stream of an uninterrupted one
        idx = np.random.RandomState(config.seed * 100003 + step).randint(
            0, n_train, size=config.batch_size
        )
        batch = _slice_batch(train_set, idx)
        return batch if shard is None else _block(batch, shard)

    state, metrics = _run_phases(config, state, make_steps, next_batch, eval_set,
                                 checkpoint_dir, metrics_path, tensorboard_dir, shard)
    return model, state.params, metrics


def _train_on_trajectories(
    config: TrainingConfig,
    model: StencilModel,
    data: data_lib.TrajectoryData,
    checkpoint_dir: Optional[str],
    metrics_path: Optional[str],
    tensorboard_dir: Optional[str] = None,
    use_kernel: bool = False,
    shard=None,
) -> tuple[StencilModel, dict, dict]:
    """Training over a TrajectoryData ensemble.

    The train/eval split is by trajectory, batches are (trajectory, time)
    index pairs gathered by ``sample_training_batch`` (rollout windows
    sliced on the fly; on the host for a host-resident dataset, then moved),
    and the eval set is one fixed sampled batch. With a ``shard`` each rank
    draws the global indices and gathers its block of them.
    """
    if config.num_time_steps != data.unroll_steps:
        raise ValueError(
            f"config.num_time_steps={config.num_time_steps} != dataset "
            f"unroll_steps={data.unroll_steps}"
        )
    device = model.device
    n_traj = data.num_trajectories
    usable = data.usable_times
    n_train = max(1, int(config.frac_training * n_traj))
    perm = np.random.RandomState(config.seed).permutation(n_traj)
    eval_traj = perm[n_train:]
    substeps = _substeps(config, model)

    if data.host_resident:
        as_idx = np.asarray
        to_device = lambda b: data_lib.map_data(
            lambda leaf: torch.from_numpy(np.ascontiguousarray(leaf)).to(device), b)
    else:
        index_device = data.series.device
        as_idx = lambda a: torch.as_tensor(a, device=index_device)
        to_device = lambda b: data_lib.map_data(lambda leaf: leaf.to(device), b)

    def draw(rng, traj_pool, size, sharded=True):
        ti = as_idx(rng.choice(traj_pool, size=size))
        si = as_idx(rng.randint(0, usable, size=size))
        batch = data_lib.sample_training_batch(data, ti, si, data.unroll_steps)
        if shard is not None and sharded:
            batch = _block(batch, shard)
        return to_device(batch)

    if eval_traj.size == 0:
        raise ValueError(
            "by-trajectory eval split is empty: lower frac_training or add "
            "trajectories (silently evaluating on training trajectories "
            "would defeat the no-leakage guarantee)"
        )
    eval_batch = draw(np.random.RandomState(config.seed + 7), eval_traj,
                      min(1024, config.batch_size * 8))
    norm_batch = draw(np.random.RandomState(config.seed + 11), perm[:n_train], 1024,
                      sharded=False)
    phases = config.curriculum_phases()

    tx = make_optimizer(config)
    state = _initial_state(config, model, tx)
    full_norms = loss_lib.compute_loss_norms(
        model, norm_batch, phases[-1][0], config.time_delta, substeps,
        floor_quantile=config.loss_weights.error_floor_quantile,
    )
    make_steps = _step_functions(config, model, tx, full_norms, substeps, use_kernel, shard)
    train_pool = perm[:n_train]

    def next_batch(step):
        return draw(np.random.RandomState(config.seed * 100003 + step), train_pool,
                    config.batch_size)

    state, metrics = _run_phases(config, state, make_steps, next_batch, eval_batch,
                                 checkpoint_dir, metrics_path, tensorboard_dir, shard)
    return model, state.params, metrics


def restore_params(checkpoint_dir: str, device=None) -> dict:
    """The latest checkpoint's params (inference path)."""
    return load_model(checkpoint_dir, device)[1]


def load_model(checkpoint_dir: str, device=None) -> tuple[StencilModel, dict, TrainingConfig]:
    """Rebuild (model, params, config) from the latest checkpoint under
    ``checkpoint_dir``; the model's ``rhs_fn(params, forcing)`` plugs into
    ``integrate.integrate``."""
    steps = checkpoint_steps(checkpoint_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    model, params, stored = convert.load_asset(
        os.path.join(checkpoint_dir, str(steps[-1]), "model"), device=device)
    return model, params, TrainingConfig.from_json(json.dumps(stored))
