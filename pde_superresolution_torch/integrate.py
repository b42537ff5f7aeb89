"""Time integration: method-of-lines Runge-Kutta with a fixed step.

The PyTorch counterpart of ``pde_superresolution_tpu.integrate``'s
differentiators and explicit integrators. Each ``lax.scan`` of the JAX
package is a Python loop here; on the card the per-step work is kernels
launched on the current stream. The spectral solvers (ETDRK4, exact
references) come with a later slice.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from pde_superresolution_torch import stencils
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import Equation, ForcingParams
from pde_superresolution_torch.grids import Grid

# RHS signature: (u, t) -> du/dt. Forcing params are closed over.
RHSFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class Differentiator:
    """A spatial discretization scheme bound to (equation, grid, device).

    Subclasses implement ``derivatives(u)`` returning ``{order: like u}``:
    point derivatives for direct-form equations, right-face reconstructions
    for conservative ones.
    """

    def __init__(self, equation: Equation, grid: Grid, device=None):
        self.equation = equation
        self.grid = grid
        self.device = resolve_device(device)

    def derivatives(self, u: torch.Tensor) -> Mapping[int, torch.Tensor]:
        raise NotImplementedError

    def rhs_fn(self, forcing: Optional[ForcingParams] = None) -> RHSFn:
        def rhs(u, t):
            return self.equation.time_derivative(
                u, self.derivatives(u), self.grid, t, forcing
            )

        # family tag: a conservative (cell-average) scheme must be compared
        # under block-mean coarse-graining, a direct one under subsampling
        rhs.conservative = self.equation.conservative
        return rhs


class PolynomialDifferentiator(Differentiator):
    """Fixed classic polynomial stencils, the baseline scheme: centered
    finite differences (direct form) or finite-volume reconstructions at
    right faces (conservative form)."""

    def __init__(
        self,
        equation: Equation,
        grid: Grid,
        accuracy_order: int = 2,
        stencil_size: int | None = None,
        device=None,
    ):
        super().__init__(equation, grid, device)
        self.accuracy_order = accuracy_order
        staggered = equation.conservative
        self.coeffs: dict[int, np.ndarray] = {}
        self.offsets: dict[int, np.ndarray] = {}
        for d in equation.derivative_orders:
            self.offsets[d], self.coeffs[d] = stencils.classic_stencil(
                d, staggered, grid.dx, size=stencil_size,
                accuracy_order=accuracy_order,
            )

    def derivatives(self, u):
        shift = -0.5 if self.equation.conservative else 0.0
        return {
            d: stencils.apply_stencil(
                u,
                torch.as_tensor(self.coeffs[d], dtype=u.dtype, device=u.device),
                self.offsets[d],
                shift,
            )
            for d in self.equation.derivative_orders
        }


def rk4_step(rhs: RHSFn, u: torch.Tensor, t, dt: float) -> torch.Tensor:
    """One classic RK4 step."""
    k1 = rhs(u, t)
    k2 = rhs(u + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = rhs(u + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = rhs(u + dt * k3, t + dt)
    return u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk3_ssp_step(rhs: RHSFn, u: torch.Tensor, t, dt: float) -> torch.Tensor:
    """Strong-stability-preserving RK3 (Shu-Osher)."""
    u1 = u + dt * rhs(u, t)
    u2 = 0.75 * u + 0.25 * (u1 + dt * rhs(u1, t + dt))
    return u / 3.0 + 2.0 / 3.0 * (u2 + dt * rhs(u2, t + 0.5 * dt))


STEP_FUNCS = {"rk4": rk4_step, "rk3_ssp": rk3_ssp_step}


def _save_times(u0, dt, save_every, num_saves, t0) -> torch.Tensor:
    steps = torch.arange(num_saves + 1, device=u0.device)
    return t0 + dt * save_every * steps.to(u0.dtype)


def integrate(
    rhs: RHSFn,
    u0: torch.Tensor,
    dt: float,
    num_steps: int,
    save_every: int = 1,
    t0: float = 0.0,
    method: str = "rk4",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate ``du/dt = rhs(u, t)`` with a fixed step; save periodically.

    The time is carried as a ``u0.dtype`` scalar tensor on ``u0``'s device,
    advanced by ``dt`` per step, as in the JAX package's scan carry.

    Returns:
      times: [num_saves + 1] (includes t0),
      trajectory: [num_saves + 1, *u0.shape] (includes u0).
    """
    if num_steps % save_every:
        raise ValueError(f"{num_steps=} not divisible by {save_every=}")
    num_saves = num_steps // save_every
    step = STEP_FUNCS[method]
    u = u0
    t = torch.as_tensor(t0, dtype=u0.dtype, device=u0.device)
    traj = [u0]
    for _ in range(num_saves):
        for _ in range(save_every):
            u = step(rhs, u, t, dt)
            t = t + dt
        traj.append(u)
    return _save_times(u0, dt, save_every, num_saves, t0), torch.stack(traj)


def integrate_fused(
    advance,
    u0: torch.Tensor,
    dt: float,
    num_steps: int,
    save_every: int = 1,
    t0: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``integrate``'s contract, with each save interval one ``advance``.

    ``advance(u, t)`` must run exactly ``save_every`` RK4 steps of size
    ``dt`` from time ``t``, e.g. ``StencilModel.fused_rk4_fn(params, dt,
    num_steps=save_every)``, which keeps the state on chip for the whole
    interval.
    """
    if num_steps % save_every:
        raise ValueError(f"{num_steps=} not divisible by {save_every=}")
    num_saves = num_steps // save_every
    u = u0
    t = torch.as_tensor(t0, dtype=u0.dtype, device=u0.device)
    traj = [u0]
    for _ in range(num_saves):
        u = advance(u, t)
        t = t + dt * save_every
        traj.append(u)
    return _save_times(u0, dt, save_every, num_saves, t0), torch.stack(traj)
