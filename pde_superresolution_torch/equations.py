"""PDE definitions: Burgers, KdV, Kuramoto-Sivashinsky (+ conservative twins).

The PyTorch counterpart of ``pde_superresolution_tpu.equations``:

    Burgers:  u_t = -u u_x + eta u_xx + f(x, t)       (periodic, forced)
    KdV:      u_t = -6 u u_x - u_xxx                  (unforced)
    KS:       u_t = -u u_x - u_xx - u_xxxx            (unforced, chaotic)

Each has a conservative (flux) form ``u_t = -d/dx J + f`` for finite-volume
models:

    Burgers:  J = u^2/2 - eta u_x
    KdV:      J = 3 u^2 + u_xx
    KS:       J = u^2/2 + u_x + u_xxx

Equations are static configuration (frozen dataclasses). Per-trajectory
randomness (forcing parameters, initial conditions) is drawn from an
explicit ``torch.Generator``; its stream is not ``jax.random``'s, so
parity with the JAX package is tested on shared numpy inputs and the
samplers on their distributions only.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Mapping, Optional

import numpy as np
import torch

from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.grids import Grid


class ForcingParams(typing.NamedTuple):
    """Parameters of a sum-of-sinusoids forcing; leading dims = batch.

    f(x, t) = sum_m amplitude[m] * sin(omega[m] t + 2 pi k[m] x / L + phi[m])
    """

    amplitude: torch.Tensor  # [..., num_terms]
    omega: torch.Tensor  # [..., num_terms] temporal frequency
    k: torch.Tensor  # [..., num_terms] integer spatial wavenumber (as float)
    phi: torch.Tensor  # [..., num_terms] phase


def forcing_term(
    params: ForcingParams,
    x: torch.Tensor,
    t,
    period: float,
    cell_width: Optional[float] = None,
) -> torch.Tensor:
    """The forcing on grid ``x`` [nx] at time ``t``.

    With ``cell_width`` the exact cell average over ``[x - w/2, x + w/2]``
    is returned: the average of ``sin(kappa x + c)`` is
    ``sinc(kappa w / 2) sin(kappa x_center + c)``. Conservative schemes
    evolve cell averages, so their forcing term is the cell average.

    Returns shape ``params.batch_shape + [nx]``.
    """
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    phase = (
        params.omega[..., None] * t[..., None, None]
        + 2 * np.pi * params.k[..., None] * x / period
        + params.phi[..., None]
    )  # [..., num_terms, nx]
    amplitude = params.amplitude
    if cell_width is not None:
        kappa = 2 * np.pi * params.k / period
        z = kappa * cell_width / 2
        amplitude = amplitude * torch.sinc(z / np.pi)  # sinc(y)=sin(pi y)/(pi y)
    return torch.sum(amplitude[..., None] * torch.sin(phase), dim=-2)


@dataclasses.dataclass(frozen=True)
class Equation:
    """Base class: static PDE configuration.

    Attributes:
      period: spatial period L of the domain.
      conservative: if True, schemes reconstruct face values and
        ``time_derivative`` applies a conservative flux divergence.
    """

    period: float
    conservative: bool = False

    name: typing.ClassVar[str] = "equation"
    forced: typing.ClassVar[bool] = False

    @property
    def derivative_orders(self) -> tuple[int, ...]:
        """Spatial-derivative orders a scheme must supply: point derivatives
        (direct form) or right-face reconstructions (conservative form,
        order 0 = the face value)."""
        raise NotImplementedError

    def equation_of_motion(
        self, u: torch.Tensor, derivs: Mapping[int, torch.Tensor]
    ) -> torch.Tensor:
        """u_t from point derivatives (direct form), without forcing."""
        raise NotImplementedError

    def flux(self, face_values: Mapping[int, torch.Tensor]) -> torch.Tensor:
        """Flux J at faces from face reconstructions (conservative form)."""
        raise NotImplementedError

    def time_derivative(
        self,
        u: torch.Tensor,
        derivs: Mapping[int, torch.Tensor],
        grid: Grid,
        t=0.0,
        forcing: Optional[ForcingParams] = None,
    ) -> torch.Tensor:
        """Full RHS: equation of motion (or flux divergence) plus forcing.

        For conservative equations index j of a face array is face
        ``x_{j+1/2}``, so the divergence is ``(J[j] - J[j-1]) / dx``.
        """
        if self.conservative:
            j = self.flux(derivs)
            u_t = -(j - torch.roll(j, 1, dims=-1)) / grid.dx
        else:
            u_t = self.equation_of_motion(u, derivs)
        if forcing is not None:
            x = torch.as_tensor(grid.x, dtype=u.dtype, device=u.device)
            # conservative schemes evolve cell averages: grid.x must be the
            # true cell centers (Grid.resample(conservative=True))
            width = grid.dx if self.conservative else None
            u_t = u_t + forcing_term(forcing, x, t, self.period, width)
        return u_t

    # Per-instance wavenumber bands (cycles per domain), so a model can be
    # deployed on an N-times larger domain with the same physical scales.
    num_forcing_terms: int = 20
    forcing_k_min: int = 3
    forcing_k_max: int = 6

    def sample_forcing(
        self,
        generator: torch.Generator,
        batch_shape: tuple[int, ...] = (),
        device=None,
    ) -> Optional[ForcingParams]:
        """Random forcing parameters (None for unforced equations): 20
        sinusoids, amplitude ~ U(-0.5, 0.5), temporal frequency ~
        U(-0.4, 0.4), |k| in {k_min..k_max} with random sign, phase ~
        U(0, 2 pi). Drawn on the generator's device, then moved."""
        if not self.forced:
            return None
        device = resolve_device(device)
        shape = batch_shape + (self.num_forcing_terms,)

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator)

        amplitude = uniform(-0.5, 0.5)
        omega = uniform(-0.4, 0.4)
        k_mag = torch.randint(
            self.forcing_k_min, self.forcing_k_max + 1, shape, generator=generator
        ).to(torch.float32)
        sign = torch.where(torch.rand(shape, generator=generator) < 0.5, 1.0, -1.0)
        phi = uniform(0.0, 2 * np.pi)
        return ForcingParams(
            *(leaf.to(device) for leaf in (amplitude, omega, k_mag * sign, phi))
        )

    ic_num_modes: int = 10
    ic_k_min: int = 1
    ic_k_max: int = 3
    ic_amplitude: float = 1.0

    def initial_conditions(
        self,
        generator: torch.Generator,
        grid: Grid,
        batch_shape: tuple[int, ...] = (),
        device=None,
    ) -> torch.Tensor:
        """Random smooth initial conditions, float32 ``batch_shape + [nx]``:

        u0(x) = sum_m A_m sin(2 pi k_m x / L + phi_m),  A ~ U(-a, a),
        k in {ic_k_min..ic_k_max}.
        """
        device = resolve_device(device)
        shape = batch_shape + (self.ic_num_modes,)
        a = self.ic_amplitude * (2 * torch.rand(shape, generator=generator) - 1)
        k = torch.randint(self.ic_k_min, self.ic_k_max + 1, shape, generator=generator)
        phi = 2 * np.pi * torch.rand(shape, generator=generator)
        x = torch.as_tensor(grid.x, dtype=torch.float32)
        phase = 2 * np.pi * k[..., None] * x / self.period + phi[..., None]
        return torch.sum(a[..., None] * torch.sin(phase), dim=-2).to(device)

    # Fourier-space form u_t = L u + N(u), for the exact ETDRK4 solves
    def linear_symbol(self, k: np.ndarray) -> np.ndarray:
        """Diagonal symbol L(k) of the stiff linear part for the rfft modes
        ``k`` (angular wavenumbers). Float64/complex128 numpy, at set-up."""
        raise NotImplementedError

    def nonlinear_term(
        self,
        u: torch.Tensor,
        u_x: torch.Tensor,
        grid: Grid,
        t,
        forcing: Optional[ForcingParams],
    ) -> torch.Tensor:
        """Real-space nonlinear part N(u): everything but ``linear_symbol``."""
        raise NotImplementedError

    def stable_time_step(self, grid: Grid, u_scale: float = 2.0) -> float:
        """Conservative explicit-RK4 stable step for this equation on ``grid``:
        the minimum of the advective ``dx/|u|`` limit and each linear term's
        ``C_p dx^p / a_p`` limit, with safety factors."""
        raise NotImplementedError


def _advective_dt(dx: float, u_scale: float) -> float:
    return dx / max(u_scale, 1e-6)


@dataclasses.dataclass(frozen=True)
class BurgersEquation(Equation):
    """Forced viscous Burgers: u_t = -u u_x + eta u_xx + f."""

    eta: float = 0.01
    period: float = 2 * np.pi
    name: typing.ClassVar[str] = "burgers"
    forced: typing.ClassVar[bool] = True

    @property
    def derivative_orders(self) -> tuple[int, ...]:
        return (0, 1) if self.conservative else (1, 2)

    def equation_of_motion(self, u, derivs):
        return -u * derivs[1] + self.eta * derivs[2]

    def flux(self, face_values):
        return 0.5 * face_values[0] ** 2 - self.eta * face_values[1]

    def linear_symbol(self, k):
        return -self.eta * k**2

    def nonlinear_term(self, u, u_x, grid, t, forcing):
        n = -u * u_x
        if forcing is not None:
            x = torch.as_tensor(grid.x, dtype=u.dtype, device=u.device)
            n = n + forcing_term(forcing, x, t, self.period)
        return n

    def stable_time_step(self, grid: Grid, u_scale: float = 2.0) -> float:
        dx = grid.dx
        dt_adv = _advective_dt(dx, u_scale)
        dt_diff = 0.5 * dx**2 / max(self.eta, 1e-12)
        return 0.4 * min(dt_adv, dt_diff)


@dataclasses.dataclass(frozen=True)
class KdVEquation(Equation):
    """Korteweg-de Vries: u_t = -6 u u_x - u_xxx."""

    period: float = 32.0
    name: typing.ClassVar[str] = "kdv"

    @property
    def derivative_orders(self) -> tuple[int, ...]:
        return (0, 2) if self.conservative else (1, 3)

    def equation_of_motion(self, u, derivs):
        return -6.0 * u * derivs[1] - derivs[3]

    def flux(self, face_values):
        return 3.0 * face_values[0] ** 2 + face_values[2]

    def linear_symbol(self, k):
        # -u_xxx -> -(ik)^3 = +i k^3 (purely dispersive)
        return 1j * k**3

    def nonlinear_term(self, u, u_x, grid, t, forcing):
        return -6.0 * u * u_x

    def stable_time_step(self, grid: Grid, u_scale: float = 2.0) -> float:
        dx = grid.dx
        dt_adv = _advective_dt(dx, 6.0 * u_scale)
        # centered 3rd-derivative stencil spectral radius ~ 2/dx^3 on the
        # imaginary axis; RK4 imaginary-axis stability ~ 2.8
        dt_disp = 1.4 * dx**3
        return 0.4 * min(dt_adv, dt_disp)


@dataclasses.dataclass(frozen=True)
class KSEquation(Equation):
    """Kuramoto-Sivashinsky: u_t = -u u_x - u_xx - u_xxxx (chaotic)."""

    period: float = 64.0
    name: typing.ClassVar[str] = "ks"

    @property
    def derivative_orders(self) -> tuple[int, ...]:
        return (0, 1, 3) if self.conservative else (1, 2, 4)

    def equation_of_motion(self, u, derivs):
        return -u * derivs[1] - derivs[2] - derivs[4]

    def flux(self, face_values):
        return 0.5 * face_values[0] ** 2 + face_values[1] + face_values[3]

    def linear_symbol(self, k):
        # -u_xx - u_xxxx -> +k^2 - k^4
        return k**2 - k**4

    def nonlinear_term(self, u, u_x, grid, t, forcing):
        return -u * u_x

    def stable_time_step(self, grid: Grid, u_scale: float = 2.0) -> float:
        dx = grid.dx
        dt_adv = _advective_dt(dx, u_scale)
        # 4th-derivative stencil spectral radius 16/dx^4; RK4 real-axis
        # stability 2.79, with margin for the destabilizing -u_xx term
        dt_hyper = 2.79 * dx**4 / 16.0
        return 0.4 * min(dt_adv, dt_hyper)


EQUATION_TYPES: dict[str, type[Equation]] = {
    "burgers": BurgersEquation,
    "kdv": KdVEquation,
    "ks": KSEquation,
}


def params_dict(equation: Equation) -> dict:
    """The equation's constructor parameters, minus ``conservative``:
    ``from_name(name, conservative=..., **params_dict(eq))`` rebuilds it."""
    return {
        k: v
        for k, v in dataclasses.asdict(equation).items()
        if k != "conservative"
    }


def from_name(name: str, conservative: bool = False, **kwargs) -> Equation:
    """Build an equation from its registry name; ``conservative_<name>``
    aliases select the conservative form."""
    key = name.lower()
    if key.startswith("conservative_"):
        key = key[len("conservative_") :]
        conservative = True
    if key not in EQUATION_TYPES:
        raise ValueError(
            f"unknown equation {name!r}; options: {sorted(EQUATION_TYPES)}"
        )
    return EQUATION_TYPES[key](conservative=conservative, **kwargs)
