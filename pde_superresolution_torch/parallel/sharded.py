"""Spatially sharded RHS closures: the baseline and the learned scheme.

A rank passes its own block of the state, ``[batch / data, nx / space]``
(or ``[nx / space]``): the batch split over the mesh's ``"data"`` axis, the
periodic grid split into contiguous blocks over ``"space"``. The closure
takes the rank's slice of the grid's cell centres and its rows of the
forcing, exchanges the stencil and tower halos with its ring neighbours
(``halo.halo_exchange``) and does everything else locally. It is
differentiable (the exchange's backward sends the halo cotangents back), so
the same closure carries the spatially sharded training rollout.

The spectral (ETDRK4, FFT) path has no sharded variant, as in the JAX
package: a distributed FFT is all-to-all-bound; shard the batch instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pde_superresolution_torch import integrate
from pde_superresolution_torch.equations import Equation, ForcingParams, forcing_term
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import conv_net
from pde_superresolution_torch.models.stencil_net import StencilModel
from pde_superresolution_torch.parallel import halo as halo_lib
from pde_superresolution_torch.parallel.mesh import (
    DATA_AXIS, SPACE_AXIS, axis_rank, axis_size)


class Shard:
    """This rank's block of a batch of fields on ``mesh``: rows over
    ``"data"``, columns of the ``nx``-point grid over ``"space"``."""

    def __init__(self, mesh, nx: int):
        self.mesh, self.nx = mesh, nx
        self.n_data, self.data_rank = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
        self.n_space, self.space_rank = axis_size(mesh, SPACE_AXIS), axis_rank(mesh, SPACE_AXIS)
        if nx % self.n_space:
            raise ValueError(f"grid of {nx} not divisible by space={self.n_space}")

    def rows(self, total: int) -> slice:
        """The rank's rows of a global batch of ``total``."""
        if total % self.n_data:
            raise ValueError(f"batch of {total} not divisible by data={self.n_data}")
        per = total // self.n_data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def cols(self) -> slice:
        """The rank's points of the grid."""
        width = self.nx // self.n_space
        return slice(self.space_rank * width, (self.space_rank + 1) * width)

    def forcing_rows(self, forcing: Optional[ForcingParams],
                     rows: Optional[int] = None) -> Optional[ForcingParams]:
        """The rank's rows of ``forcing``, whose leaves hold a global batch's
        rows: ``self.rows`` of them. Unbatched leaves are shared, and leaves
        that already hold ``rows`` rows (the block's own) are kept."""
        if forcing is None or forcing.amplitude.ndim < 2 or forcing.amplitude.shape[0] == rows:
            return forcing
        mine = ForcingParams(*(leaf[self.rows(forcing.amplitude.shape[0])] for leaf in forcing))
        if rows is not None and mine.amplitude.shape[0] != rows:
            raise ValueError(
                f"forcing holds {forcing.amplitude.shape[0]} rows; a block of {rows} on a "
                f"data axis of {self.n_data} needs {rows * self.n_data} or {rows}")
        return mine


def _divergence(flux_ext: torch.Tensor, dx: float) -> torch.Tensor:
    """u_t from face fluxes F on positions [-1 .. local-1] (length local+1)."""
    return -(flux_ext[..., 1:] - flux_ext[..., :-1]) / dx


class _Block:
    """The rank's place on the grid: its cell centres, and the forcing term
    on them."""

    def __init__(self, equation: Equation, grid: Grid, mesh, forcing, device):
        x = torch.as_tensor(grid.x, dtype=torch.float32, device=device)
        self.shard = Shard(mesh, grid.size)
        self.x = x[self.shard.cols()]
        self.width = self.x.shape[0]
        self.equation, self.grid, self.forcing = equation, grid, forcing

    def check(self, u: torch.Tensor) -> None:
        if u.ndim not in (1, 2):
            raise ValueError(f"u must be [nx] or [batch, nx], got ndim={u.ndim}")
        if u.shape[-1] != self.width:
            raise ValueError(f"block of {u.shape[-1]} points; this mesh gives {self.width}")

    def add_forcing(self, u_t: torch.Tensor, u: torch.Tensor, t) -> torch.Tensor:
        if self.forcing is None:
            return u_t
        forcing = self.shard.forcing_rows(self.forcing, u.shape[0] if u.ndim == 2 else 1)
        width = self.grid.dx if self.equation.conservative else None
        return u_t + forcing_term(forcing, self.x, t, self.equation.period, width)


def sharded_baseline_rhs(
    equation: Equation,
    grid: Grid,
    mesh,
    accuracy_order: int = 2,
    forcing: Optional[ForcingParams] = None,
):
    """Spatially sharded fixed-stencil RHS, ``PolynomialDifferentiator.rhs_fn``
    on this rank's block, on the mesh's device type: ``rhs(u_block, t) ->
    u_t_block``."""
    diff = integrate.PolynomialDifferentiator(equation, grid, accuracy_order,
                                              device=mesh.device_type)
    staggered = equation.conservative
    shift = -0.5 if staggered else 0.0
    all_taps = np.concatenate(
        [np.asarray(diff.offsets[d]) - shift for d in diff.offsets]
    )
    reach = int(max(abs(all_taps.min()), abs(all_taps.max())))
    halo = reach + (1 if staggered else 0)
    block = _Block(equation, grid, mesh, forcing, diff.device)

    def rhs(u, t):
        block.check(u)
        u_pad = halo_lib.halo_exchange(u, halo, mesh)
        coeffs = {d: torch.as_tensor(diff.coeffs[d], dtype=u.dtype, device=u.device)
                  for d in diff.offsets}
        if staggered:
            faces = {
                d: halo_lib.apply_stencil_local(
                    u_pad, coeffs[d], diff.offsets[d], halo, shift,
                    out_start=-1, out_size=u.shape[-1] + 1)
                for d in diff.offsets
            }
            u_t = _divergence(equation.flux(faces), grid.dx)
        else:
            derivs = {
                d: halo_lib.apply_stencil_local(u_pad, coeffs[d], diff.offsets[d], halo)
                for d in diff.offsets
            }
            u_t = equation.equation_of_motion(u, derivs)
        return block.add_forcing(u_t, u, t)

    rhs.conservative = equation.conservative
    return rhs


def model_halo(model: StencilModel) -> tuple[int, int, int]:
    """(halo, tower radius, extra) of ``model``'s sharded RHS: the halo
    covers the tower's receptive field and the stencils' reach, plus
    ``extra`` = 1 face left of the block for a conservative divergence."""
    radius = conv_net.receptive_radius(model.config.tower())
    all_taps = np.concatenate([np.asarray(taps) for taps in model.taps.values()])
    reach = int(max(abs(all_taps.min()), abs(all_taps.max())))
    extra = 1 if model.equation.conservative else 0
    return max(radius + extra, reach + extra), radius, extra


def local_derivatives(model: StencilModel, params, u: torch.Tensor, mesh) -> dict:
    """The model's derivatives (direct form) or face values (conservative
    form) on this rank's block, ``{order: [..., local + extra]}``: a
    conservative block also gets the face left of it first (position -1).
    ``params=None`` gives the classic coefficients' (z = 0, the baseline)."""
    halo, radius, extra = model_halo(model)
    local = u.shape[-1]
    u_pad = halo_lib.halo_exchange(u, halo, mesh)
    if params is None:
        coeffs = {d: torch.as_tensor(layer.c0, dtype=u.dtype, device=u.device)
                  for d, layer in model.constraint_layers.items()}
    else:
        # the tower runs VALID on the padded block: translation invariance
        # makes it the periodic global tower; coefficients for positions
        # [-extra, local)
        coeffs = model.coefficients(
            params, u_pad[..., halo - radius - extra:halo + local + radius], periodic=False)
    return {
        d: halo_lib.apply_stencil_local(
            u_pad, coeffs[d], layer.offsets, halo, model._shift,
            out_start=-extra, out_size=local + extra)
        for d, layer in model.constraint_layers.items()
    }


def local_time_derivative(model: StencilModel, u: torch.Tensor, derivs: dict) -> torch.Tensor:
    """u_t on the block, without forcing, from ``local_derivatives``."""
    if model.equation.conservative:
        return _divergence(model.equation.flux(derivs), model.grid.dx)
    return model.equation.equation_of_motion(u, derivs)


def sharded_model_rhs(
    model: StencilModel,
    params,
    mesh,
    forcing: Optional[ForcingParams] = None,
):
    """Spatially sharded learned-model RHS, ``StencilModel.rhs_fn`` on this
    rank's block: ``rhs(u_block, t) -> u_t_block``. The tower computes in
    the model's ``tower_dtype``, as the unsharded route does; ``params=None``
    gives the classic coefficients' RHS (the loss's baseline).

    ``forcing`` holds the global batch's rows (the rank's are taken) or
    already the block's own.
    """
    block = _Block(model.equation, model.grid, mesh, forcing, model.device)

    def rhs(u, t):
        block.check(u)
        derivs = local_derivatives(model, params, u, mesh)
        return block.add_forcing(local_time_derivative(model, u, derivs), u, t)

    rhs.conservative = model.equation.conservative
    return rhs


class SpaceShardedLoss:
    """What ``training.losses.compute_loss`` asks of the model, on this rank's
    block ``[rows, nx / space]`` of a batch whose grid is split over the
    mesh's ``"space"`` axis: the derivatives, the time derivative and the
    rollout's RHS through the halo exchange, and the grid-wide reductions
    (means, the rms, "all points") over the space group, the means with
    differentiable collectives."""

    def __init__(self, model: StencilModel, mesh, forcing: Optional[ForcingParams]):
        from torch.distributed.nn import functional as dist_fn

        self.model, self.mesh, self.forcing = model, mesh, forcing
        self.block = _Block(model.equation, model.grid, mesh, forcing, model.device)
        self.group = mesh.get_group(SPACE_AXIS)
        self.n_space = axis_size(mesh, SPACE_AXIS)
        self.extra = model_halo(model)[2]
        self._all_reduce = dist_fn.all_reduce

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the whole grid (blocks of equal width)."""
        return self._all_reduce(torch.mean(x), group=self.group) / self.n_space

    def rms(self, u: torch.Tensor) -> torch.Tensor:
        """Per-row root mean square over the whole grid, ``[rows, 1]``."""
        total = self._all_reduce(torch.sum(u * u, dim=-1, keepdim=True), group=self.group)
        return torch.sqrt(total / self.model.grid.size)

    def all_points(self, mask: torch.Tensor) -> torch.Tensor:
        """``mask.all(dim=-1)`` over the whole grid."""
        import torch.distributed as dist

        local = mask.all(dim=-1).to(torch.int32)
        dist.all_reduce(local, op=dist.ReduceOp.MIN, group=self.group)
        return local.bool()

    def derivatives(self, params, u: torch.Tensor) -> dict:
        """``local_derivatives`` (``params=None``: the baseline's), with the
        face left of the block still first."""
        return local_derivatives(self.model, params, u, self.mesh)

    def on_block(self, derivs: dict) -> dict:
        """Drop the face left of the block: the values at the block's points."""
        return {d: v[..., self.extra:] for d, v in derivs.items()}

    def time_derivative(self, u: torch.Tensor, derivs: dict, t) -> torch.Tensor:
        return self.block.add_forcing(local_time_derivative(self.model, u, derivs), u, t)

    def rhs(self, params):
        """The rollout's RHS (``params=None``: the baseline's)."""
        return sharded_model_rhs(self.model, params, self.mesh, self.forcing)
