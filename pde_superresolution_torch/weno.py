"""5th-order WENO (weighted essentially non-oscillatory) Burgers baseline.

The PyTorch counterpart of ``pde_superresolution_tpu/weno.py``: the
standard Jiang & Shu (1996) WENO5 with global Lax-Friedrichs flux
splitting, the strong classical comparator for shock-forming Burgers at
coarse resolution.

Scheme (periodic, conservative):
    f(u) = u^2 / 2                        (convective flux)
    f±  = (f(u) ± alpha u) / 2,  alpha = max|u|   (LF splitting)
    F_{j+1/2} = WENO5_left(f+)_{j+1/2} + WENO5_right(f-)_{j+1/2}
    u_t = -(F_{j+1/2} - F_{j-1/2})/dx + eta u_xx + forcing

The viscous term uses a centered 2nd-order stencil (it is non-hyperbolic and
small). Everything is rolls along the last axis, in the JAX package's order
of operations; plain PyTorch (the JAX package has no kernel here either).
"""

from __future__ import annotations

from typing import Optional

import torch

from pde_superresolution_torch import integrate, stencils
from pde_superresolution_torch.equations import BurgersEquation, ForcingParams, forcing_term
from pde_superresolution_torch.grids import Grid

# classic WENO5 linear (optimal) weights and epsilon
_GAMMA = (0.1, 0.6, 0.3)
_EPS = 1e-6


def _roll(f: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(f, shift, dims=-1)


def _weights_sum(q0, q1, q2, b0, b1, b2):
    w0 = _GAMMA[0] / (_EPS + b0) ** 2
    w1 = _GAMMA[1] / (_EPS + b1) ** 2
    w2 = _GAMMA[2] / (_EPS + b2) ** 2
    wsum = w0 + w1 + w2
    return (w0 * q0 + w1 * q1 + w2 * q2) / wsum


def reconstruct_left(f: torch.Tensor) -> torch.Tensor:
    """Left-biased WENO5 value at the right face x_{j+1/2} (axis -1, periodic).

    Candidate stencils: {j-2,j-1,j}, {j-1,j,j+1}, {j,j+1,j+2}.
    """
    fm2 = _roll(f, 2)
    fm1 = _roll(f, 1)
    f0 = f
    fp1 = _roll(f, -1)
    fp2 = _roll(f, -2)

    q0 = (2 * fm2 - 7 * fm1 + 11 * f0) / 6.0
    q1 = (-fm1 + 5 * f0 + 2 * fp1) / 6.0
    q2 = (2 * f0 + 5 * fp1 - fp2) / 6.0

    b0 = (13.0 / 12.0) * (fm2 - 2 * fm1 + f0) ** 2 + 0.25 * (
        fm2 - 4 * fm1 + 3 * f0
    ) ** 2
    b1 = (13.0 / 12.0) * (fm1 - 2 * f0 + fp1) ** 2 + 0.25 * (fm1 - fp1) ** 2
    b2 = (13.0 / 12.0) * (f0 - 2 * fp1 + fp2) ** 2 + 0.25 * (
        3 * f0 - 4 * fp1 + fp2
    ) ** 2
    return _weights_sum(q0, q1, q2, b0, b1, b2)


def reconstruct_right(f: torch.Tensor) -> torch.Tensor:
    """Right-biased WENO5 value at the right face x_{j+1/2} (mirror of left).

    Candidate stencils: {j+1,j+2,j+3}, {j,j+1,j+2}, {j-1,j,j+1}.
    """
    fm1 = _roll(f, 1)
    f0 = f
    fp1 = _roll(f, -1)
    fp2 = _roll(f, -2)
    fp3 = _roll(f, -3)

    q0 = (2 * fp3 - 7 * fp2 + 11 * fp1) / 6.0
    q1 = (-fp2 + 5 * fp1 + 2 * f0) / 6.0
    q2 = (2 * fp1 + 5 * f0 - fm1) / 6.0

    b0 = (13.0 / 12.0) * (fp3 - 2 * fp2 + fp1) ** 2 + 0.25 * (
        fp3 - 4 * fp2 + 3 * fp1
    ) ** 2
    b1 = (13.0 / 12.0) * (fp2 - 2 * fp1 + f0) ** 2 + 0.25 * (fp2 - f0) ** 2
    b2 = (13.0 / 12.0) * (fp1 - 2 * f0 + fm1) ** 2 + 0.25 * (
        3 * fp1 - 4 * f0 + fm1
    ) ** 2
    return _weights_sum(q0, q1, q2, b0, b1, b2)


def burgers_flux(u: torch.Tensor) -> torch.Tensor:
    """Numerical convective flux at right faces via LF-split WENO5."""
    f = 0.5 * u**2
    alpha = u.abs().amax(dim=-1, keepdim=True)
    f_plus = 0.5 * (f + alpha * u)
    f_minus = 0.5 * (f - alpha * u)
    return reconstruct_left(f_plus) + reconstruct_right(f_minus)


class WENODifferentiator(integrate.Differentiator):
    """WENO5 Burgers scheme as a Differentiator, bound to a device (default
    ``cuda``). Use with rk3_ssp (SSP pairs with WENO)."""

    def __init__(self, equation: BurgersEquation, grid: Grid, device=None):
        if equation.name != "burgers":
            raise ValueError("the WENO baseline supports Burgers only")
        super().__init__(equation, grid, device)
        self._visc_offsets = [-1, 0, 1]
        self._visc_coeffs = stencils.coefficients(
            self._visc_offsets, stencils.Method.FINITE_DIFFERENCES, 2, dx=grid.dx
        )

    def rhs_fn(self, forcing: Optional[ForcingParams] = None):
        eq = self.equation
        grid = self.grid

        def rhs(u, t):
            flux = burgers_flux(u)
            u_t = -(flux - _roll(flux, 1)) / grid.dx
            u_t = u_t + eq.eta * stencils.apply_stencil(
                u, torch.as_tensor(self._visc_coeffs, dtype=u.dtype, device=u.device),
                self._visc_offsets,
            )
            if forcing is not None:
                x = torch.as_tensor(grid.x, dtype=u.dtype, device=u.device)
                # WENO is a flux (cell-average) scheme: when built on a
                # conservative equation/grid, use the cell-averaged forcing
                width = grid.dx if eq.conservative else None
                u_t = u_t + forcing_term(forcing, x, t, eq.period, width)
            return u_t

        # family tag for evaluate(): WENO is intrinsically a flux /
        # cell-average scheme (face reconstruction + telescoping flux
        # divergence) whichever equation object built it, so the tag does
        # not copy the caller's family
        rhs.conservative = True
        return rhs
