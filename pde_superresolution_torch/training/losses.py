"""Training losses: baseline-normalized multi-target errors + unrolled loss.

The PyTorch counterpart of the JAX package's ``training/losses.py``. Each
target's error is normalized by the error of the fixed polynomial *baseline*
scheme on the same data, so a loss of 1.0 means "no better than the classic
stencils" and the weights are comparable across targets of very different
scales (u_x against u_xxxx against u_t).

Targets:
  * space derivatives (one per derivative order the PDE needs),
  * the time derivative u_t through the equation of motion,
  * the integrated (unrolled) solution: roll the learned scheme forward K
    snapshot intervals with the same RK4 step used at inference and compare
    to coarse-grained exact snapshots.

The normalization constants are computed once on the dataset, as host
floats (``LossNorms``).
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pde_superresolution_torch import integrate
from pde_superresolution_torch.equations import ForcingParams
from pde_superresolution_torch.models.stencil_net import StencilModel


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Relative weights per target.

    ``absolute_error``/``relative_error`` mix two error forms per target:

      * absolute: MAE normalized by the baseline scheme's dataset-level MAE
        (baseline = 1.0 per target);
      * relative: pointwise |error| divided by the baseline scheme's |error|
        at the same point, floored at the ``error_floor_quantile`` quantile
        of the baseline error distribution (from the training set). At zero
        params (model = baseline) it is about 1.0 as well.

    Defaults (1.0 / 0.0) give the absolute-only loss.
    """

    space_derivatives: float = 1.0
    time_derivative: float = 1.0
    integrated_solution: float = 1.0
    absolute_error: float = 1.0
    relative_error: float = 0.0
    error_floor_quantile: float = 0.1


ROLLOUT_CLIP = 100.0  # bound on |u| during unrolled training rollouts


class _DivergenceGuard(torch.autograd.Function):
    """``clip(nan_to_num(x, nan=c, posinf=c, neginf=-c), -c, c)`` with the JAX
    package's gradient: 1 inside the bounds, 0 outside and at a replaced
    value, and 0.5 at a finite value equal to a bound, where ``jnp.clip``'s
    ``max``/``min`` split a tie (``torch.clamp`` would pass 1)."""

    @staticmethod
    def forward(ctx, x, clip):
        ctx.save_for_backward(x)
        ctx.clip = clip
        return torch.nan_to_num(x, nan=clip, posinf=clip, neginf=-clip).clamp(-clip, clip)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        size = x.abs()
        finite = torch.isfinite(x)
        scale = torch.where(finite & (size < ctx.clip), 1.0,
                            torch.where(finite & (size == ctx.clip), 0.5, 0.0)).to(grad.dtype)
        return torch.where(scale > 0, grad * scale, torch.zeros_like(grad)), None


def divergence_guard(u: torch.Tensor, clip: float = ROLLOUT_CLIP) -> torch.Tensor:
    """Map non-finite values onto the clip bound (sign kept for infinities),
    then clamp to ``[-clip, clip]``; the identity on states inside."""
    return _DivergenceGuard.apply(u, clip)


def rollout_states(
    rhs,
    u: torch.Tensor,
    t: torch.Tensor,
    dt: float,
    substeps: int,
    unroll_steps: int,
    clip: float = ROLLOUT_CLIP,
) -> torch.Tensor:
    """Advance ``u`` by ``unroll_steps`` snapshot intervals of ``substeps``
    inner RK4 steps each; return the state at each snapshot [K, ...].

    States pass ``divergence_guard`` after every inner step: a diverging
    member then contributes a large-but-finite loss (with live gradients
    from its pre-divergence dynamics) instead of turning the whole batch
    into NaN. For rollouts that stay finite the guard is the identity.

    Under grad each inner step is rematerialized
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX package):
    only the K * substeps states are kept, and the backward re-runs each
    step's forward before differentiating it.
    """
    dt_inner = dt / substeps

    def inner(u, t):
        return divergence_guard(integrate.rk4_step(rhs, u, t, dt_inner), clip)

    remat = torch.is_grad_enabled()
    states = []
    for _ in range(unroll_steps):
        for _ in range(substeps):
            u = checkpoint(inner, u, t, use_reentrant=False) if remat else inner(u, t)
            t = t + dt_inner
        states.append(u)
    return torch.stack(states)


class LossNorms(typing.NamedTuple):
    """Static per-target normalization: the baseline scheme's MAE, plus
    per-target floors (the ``error_floor_quantile`` quantile of the
    baseline's pointwise |error|) for the relative-error form."""

    derivs: typing.Mapping  # {order: float}
    time_deriv: float
    integrated: tuple  # per-unroll-step float
    deriv_floors: typing.Mapping = types.MappingProxyType({})  # {order: float}
    time_floor: float = 1e-7
    integrated_floors: tuple = ()


@torch.no_grad()
def compute_loss_norms(
    model: StencilModel,
    data,
    unroll_steps: int,
    dt: float,
    substeps: int = 1,
    floor: float = 1e-7,
    max_samples: int = 1024,
    floor_quantile: float = 0.1,
) -> LossNorms:
    """Baseline-scheme MAEs on (a subset of) the dataset, as host floats.

    Also computes the per-target relative-error floors: the
    ``floor_quantile`` quantile of the baseline's pointwise |error|, taken
    with ``np.quantile`` on the host as the JAX package does.
    """
    n = min(data.num_samples, max_samples)
    u = data.inputs[:n]

    def quantile_floor(err):
        return max(float(np.quantile(np.abs(err.cpu().numpy()), floor_quantile)), floor)

    base_derivs = model.baseline_derivatives(u)
    d_norms, d_floors = {}, {}
    for d in base_derivs:
        err = base_derivs[d] - data.deriv_labels[d][:n]
        d_norms[d] = max(float(torch.mean(torch.abs(err))), floor)
        d_floors[d] = quantile_floor(err)
    forcing = None if data.forcing is None else ForcingParams(*(f[:n] for f in data.forcing))
    ut_base = model.equation.time_derivative(u, base_derivs, model.grid, data.t[:n], forcing)
    t_err = ut_base - data.time_deriv_label[:n]
    t_norm = max(float(torch.mean(torch.abs(t_err))), floor)
    t_floor = quantile_floor(t_err)

    int_norms, int_floors = [], []
    if unroll_steps > 0:
        # the normalizing baseline is the model's own zero-z scheme (same
        # stencil width), which is stable where the model's classic stencils
        # are
        def rhs(ut, t):
            return model.equation.time_derivative(
                ut, model.baseline_derivatives(ut), model.grid, t, forcing
            )

        states = rollout_states(rhs, u, data.t[:n], dt, substeps, unroll_steps)
        for k in range(unroll_steps):
            cur = torch.nan_to_num(states[k], nan=1e3, posinf=1e3, neginf=-1e3)
            err = cur - data.rollout[:n, k]
            int_norms.append(max(float(torch.mean(torch.abs(err))), floor))
            int_floors.append(quantile_floor(err))
    return LossNorms(
        derivs=d_norms,
        time_deriv=t_norm,
        integrated=tuple(int_norms),
        deriv_floors=d_floors,
        time_floor=t_floor,
        integrated_floors=tuple(int_floors),
    )


def truncate_norms(norms: LossNorms, unroll_steps: int) -> LossNorms:
    """Restrict full-width norms to a shorter unroll: the norms of a shorter
    unroll are an exact prefix of a longer one's (the derivative norms do not
    depend on the rollout length and the baseline rollout is deterministic),
    so the curriculum computes them once, at the final width."""
    if unroll_steps > len(norms.integrated):
        raise ValueError(
            f"cannot truncate norms of width {len(norms.integrated)} to "
            f"{unroll_steps}"
        )
    return norms._replace(
        integrated=norms.integrated[:unroll_steps],
        integrated_floors=norms.integrated_floors[:unroll_steps],
    )


class _WholeGrid:
    """What ``compute_loss`` asks of the model when a rank holds whole
    rows of the grid (``parallel.sharded.SpaceShardedLoss`` is the same for
    a block of it). ``params=None`` means the baseline's (classic)
    coefficients."""

    mean = staticmethod(torch.mean)

    def __init__(self, model: StencilModel, forcing, use_kernel: bool):
        self.model, self.forcing, self.use_kernel = model, forcing, use_kernel

    def derivatives(self, params, u):
        if params is None:
            return self.model.baseline_derivatives(u)
        return self.model.derivatives(params, u)

    @staticmethod
    def on_block(derivs):
        return derivs

    def time_derivative(self, u, derivs, t):
        return self.model.equation.time_derivative(u, derivs, self.model.grid, t,
                                                   self.forcing)

    def rhs(self, params):
        if params is not None:
            return self.model.rhs_fn(params, self.forcing, use_kernel=self.use_kernel)

        def base_rhs(u, t):
            return self.time_derivative(u, self.derivatives(None, u), t)

        return base_rhs

    @staticmethod
    def rms(u):
        return torch.sqrt(torch.mean(u * u, dim=-1, keepdim=True))

    @staticmethod
    def all_points(mask):
        return mask.all(dim=-1)


def compute_loss(
    model: StencilModel,
    params,
    batch,
    norms: LossNorms,
    weights: LossWeights,
    dt: float,
    unroll_steps: int,
    substeps: int = 1,
    use_kernel: bool = False,
    rollout_noise: float = 0.0,
    noise_generator: Optional[torch.Generator] = None,
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """Total weighted loss + per-target breakdown (0-d tensors) for logging.

    Each target's part mixes the absolute form (MAE / dataset baseline MAE)
    and the relative form (pointwise |err| / floored baseline |err|) with
    ``weights.absolute_error`` / ``weights.relative_error``; the baseline's
    pointwise errors are recomputed per batch (for the integrated target a
    second baseline rollout, only when relative_error > 0).

    ``use_kernel`` is the rollout's RHS route (``StencilModel.rhs_fn``):
    False, the JAX package's default for training, runs the plain PyTorch
    RHS; True runs the ``fused_rhs`` kernel forward with its plain backward.
    ``noise_generator`` draws the rollout noise (``rollout_noise > 0``); the
    noise is drawn on the CPU and moved, so a seed gives the same noise on
    any device.

    ``shard`` (``parallel.sharded.Shard``) says that ``batch`` is this
    rank's block of a global batch: its rows over the mesh's ``"data"``
    axis and, where ``"space"`` is larger than 1, its points of the grid.
    The rollout noise is drawn at the global batch's shape and the block
    taken from it, so every rank adds the noise a single process would.
    With a space axis the model's functions run through the halo exchange
    and the means over the grid are taken over the space group
    (``SpaceShardedLoss`` in place of ``_WholeGrid``); the means over the
    rows stay the rank's, for the caller to average with the gradients.
    ``use_kernel`` is refused there: ``fused_rhs`` needs the whole periodic
    grid.
    """
    u, t, forcing = batch.inputs, batch.t, batch.forcing
    if shard is not None and shard.n_space > 1:
        if use_kernel:
            raise ValueError(
                f"use_kernel=True needs the whole grid on each rank; the mesh splits it "
                f"over space={shard.n_space} (the halo-exchange RHS is plain PyTorch)")
        from pde_superresolution_torch.parallel.sharded import SpaceShardedLoss

        grid = SpaceShardedLoss(model, shard.mesh, forcing)
    else:
        grid = _WholeGrid(model, forcing, use_kernel)
    derivs_ext = grid.derivatives(params, u)
    derivs = grid.on_block(derivs_ext)

    w_abs, w_rel = weights.absolute_error, weights.relative_error
    use_rel = w_rel > 0
    if use_rel:
        base_ext = grid.derivatives(None, u)
        base_derivs = grid.on_block(base_ext)

    def mix(pred, label, norm, base_pred, rel_floor):
        part = w_abs * (grid.mean(torch.abs(pred - label)) / norm)
        if use_rel:
            scale = torch.clamp(torch.abs(base_pred - label), min=rel_floor)
            part = part + w_rel * grid.mean(torch.abs(pred - label) / scale)
        return part

    parts = {}
    loss = 0.0
    num_orders = len(derivs)
    for d, pred in derivs.items():
        part = mix(
            pred,
            batch.deriv_labels[d],
            norms.derivs[d],
            base_derivs[d] if use_rel else None,
            norms.deriv_floors.get(d, 1e-7) if use_rel else None,
        )
        parts[f"deriv_{d}"] = part
        loss = loss + weights.space_derivatives * part / num_orders

    ut = grid.time_derivative(u, derivs_ext, t)
    ut_base = grid.time_derivative(u, base_ext, t) if use_rel else None
    part = mix(ut, batch.time_deriv_label, norms.time_deriv, ut_base, norms.time_floor)
    parts["time_deriv"] = part
    loss = loss + weights.time_derivative * part

    if unroll_steps > 0 and weights.integrated_solution > 0:
        rhs = grid.rhs(params)
        # Rollout-noise injection (train-time): perturb the rollout's initial
        # state with Gaussian noise of std rollout_noise * rms(u) per sample,
        # keeping the clean snapshots as targets.
        u0 = u
        if rollout_noise > 0.0 and noise_generator is not None:
            if shard is None:
                noise = torch.randn(u.shape, generator=noise_generator, dtype=u.dtype)
            else:
                rows = u.shape[0] * shard.n_data
                noise = torch.randn((rows, shard.nx), generator=noise_generator,
                                    dtype=u.dtype)[shard.rows(rows), shard.cols()]
            u0 = u + rollout_noise * grid.rms(u) * noise.to(u.device)
        states = rollout_states(rhs, u0, t, dt, substeps, unroll_steps)
        # diagnostic (never part of the loss): the fraction of batch members
        # whose rollout stayed strictly inside the divergence clip
        inside = grid.all_points(torch.abs(states) < ROLLOUT_CLIP).all(dim=0)
        parts["rollout_finite_frac"] = torch.mean(inside.to(torch.float32)).detach()
        base_states = None
        if use_rel:
            # the relative form's normalizer starts from the same perturbed
            # state
            with torch.no_grad():
                base_states = rollout_states(grid.rhs(None), u0.detach(), t, dt, substeps,
                                             unroll_steps)
        int_loss = 0.0
        for k in range(unroll_steps):
            part = mix(
                states[k],
                batch.rollout[:, k],
                norms.integrated[k],
                base_states[k] if use_rel else None,
                (
                    norms.integrated_floors[k]
                    if use_rel and k < len(norms.integrated_floors)
                    else 1e-7
                ),
            )
            parts[f"integrated_{k}"] = part
            int_loss = int_loss + part / unroll_steps
        parts["integrated"] = int_loss
        loss = loss + weights.integrated_solution * int_loss

    parts["total"] = loss
    return loss, parts
