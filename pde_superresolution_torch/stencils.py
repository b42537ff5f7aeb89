"""Polynomial-accuracy stencil mathematics.

The float64 numpy setup is a copy of ``pde_superresolution_tpu.stencils``
(constraint systems, classic stencils, the null-space parameterization
``c = c0 + scale * (z @ N)``), so its arrays are bit-identical to the JAX
package's. All linear algebra happens once, at setup, in float64 numpy; the
only tensor ops are the affine map ``c(z)`` and the stencil application.

Conventions: a stencil is a set of offsets ``o_i`` (in units of ``dx``;
integers for collocated points, half-integers for staggered evaluation) and
coefficients ``c_i`` with ``sum_i c_i u(x + o_i dx) ~= d^k u / dx^k (x)``.
FINITE_DIFFERENCES reads point values, FINITE_VOLUMES cell averages;
``num_constraints = derivative_order + accuracy_order``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Sequence

import numpy as np
import torch


class Method(enum.Enum):
    """How stencil inputs are interpreted."""

    FINITE_DIFFERENCES = 1  # inputs are point values
    FINITE_VOLUMES = 2  # inputs are cell averages


def stencil_offsets(size: int, staggered: bool = False) -> np.ndarray:
    """Grid offsets (in dx units) for a stencil of ``size`` inputs.

    Collocated odd sizes are symmetric (5 -> [-2..2]), even sizes
    left-heavy (4 -> [-2..1]); staggered offsets are half-integers
    (4 -> [-1.5, -0.5, 0.5, 1.5]).
    """
    if size < 1:
        raise ValueError(f"stencil size must be >= 1, got {size}")
    if staggered:
        return np.arange(size) - size / 2 + 0.5
    return np.arange(size, dtype=np.float64) - size // 2


def constraints(
    offsets: Sequence[float],
    method: Method,
    derivative_order: int,
    accuracy_order: int,
) -> tuple[np.ndarray, np.ndarray]:
    """The float64 system ``A @ c_grid = b`` for polynomial exactness.

    ``c_grid`` are coefficients in grid units; physical coefficients are
    ``c_grid / dx**derivative_order``. ``A`` has
    ``derivative_order + accuracy_order`` rows.
    """
    if derivative_order < 0:
        raise ValueError(f"derivative_order must be >= 0: {derivative_order}")
    if accuracy_order < 1:
        raise ValueError(f"accuracy_order must be >= 1: {accuracy_order}")
    offsets = np.asarray(offsets, dtype=np.float64)
    num_constraints = derivative_order + accuracy_order
    if num_constraints > offsets.size and accuracy_order > 0:
        raise ValueError(
            f"{num_constraints} constraints > {offsets.size} stencil points: "
            "the system is overdetermined; enlarge the stencil or lower "
            "accuracy_order"
        )
    rows = []
    for m in range(num_constraints):
        if method is Method.FINITE_DIFFERENCES:
            row = offsets**m / math.factorial(m)
        elif method is Method.FINITE_VOLUMES:
            upper = (offsets + 0.5) ** (m + 1)
            lower = (offsets - 0.5) ** (m + 1)
            row = (upper - lower) / math.factorial(m + 1)
        else:
            raise TypeError(f"unknown method: {method}")
        rows.append(row)
    a = np.stack(rows)
    b = np.zeros(num_constraints)
    b[derivative_order] = 1.0
    return a, b


def coefficients(
    offsets: Sequence[float],
    method: Method,
    derivative_order: int,
    accuracy_order: int | None = None,
    dx: float = 1.0,
) -> np.ndarray:
    """Classic maximal-accuracy stencil coefficients (physical units).

    ``accuracy_order=None`` makes the system square, which gives the
    textbook stencils (e.g. ``[1, -2, 1] / dx**2`` for the second
    derivative on three points).
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    if accuracy_order is None:
        accuracy_order = offsets.size - derivative_order
        if accuracy_order < 1:
            raise ValueError(
                f"stencil of {offsets.size} points cannot represent "
                f"derivative order {derivative_order}"
            )
    a, b = constraints(offsets, method, derivative_order, accuracy_order)
    if a.shape[0] == a.shape[1]:
        c_grid = np.linalg.solve(a, b)
    else:
        # Underdetermined: minimum-norm solution.
        c_grid, *_ = np.linalg.lstsq(a, b, rcond=None)
    return c_grid / dx**derivative_order


def baseline_stencil_size(
    derivative_order: int, accuracy_order: int, staggered: bool
) -> int:
    """Smallest stencil achieving ``accuracy_order`` with the right parity
    (collocated odd, staggered even)."""
    size = max(derivative_order + accuracy_order, derivative_order + 1)
    if staggered:
        return size + (size % 2)
    return size if size % 2 else size + 1


def classic_stencil(
    derivative_order: int,
    staggered: bool,
    dx: float,
    size: int | None = None,
    accuracy_order: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, classic maximal-accuracy coefficients) for one derivative.

    The one place that chooses stencil geometry: parity-corrects ``size``,
    picks FD or FV by ``staggered`` and solves the square system. The
    baseline differentiator and the learned model both use it, so their
    z=0 schemes cannot drift apart.
    """
    size = size or baseline_stencil_size(derivative_order, accuracy_order, staggered)
    if staggered and size % 2:
        size += 1
    if not staggered and size % 2 == 0:
        size += 1
    offsets = stencil_offsets(size, staggered=staggered)
    method = Method.FINITE_VOLUMES if staggered else Method.FINITE_DIFFERENCES
    coeffs = coefficients(offsets, method, derivative_order, None, dx=dx)
    return offsets, coeffs


class _ConstantCache:
    """Per-(dtype, device) tensor copies of a layer's numpy constants, so a
    CUDA forward pass copies them to the card once rather than per call.

    A tensor made while tracing (``torch.export``, ``torch.compile``: a
    fake or functional tensor under a dispatch mode) is returned but never
    stored, so a model whose first call is traced still works when called
    eagerly afterwards.
    """

    def __init__(self):
        self._tensors: dict = {}

    def get(self, name: str, array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.dtype, like.device)
        cached = self._tensors.get(key)
        if cached is not None:
            return cached
        tensor = torch.as_tensor(array, dtype=like.dtype, device=like.device)
        if type(tensor) is torch.Tensor and not torch.compiler.is_compiling():
            self._tensors[key] = tensor
        return tensor


@dataclasses.dataclass(frozen=True)
class PolynomialAccuracy:
    """Null-space parameterization of polynomial-accurate stencils.

    ``c(z) = c0 + scale * (z @ nullspace)``: ``c0`` is a particular
    solution of the constraints and ``nullspace`` ([free_dims,
    stencil_size]) an orthonormal basis of ``ker(A)`` from the SVD, so any
    network output ``z`` gives a scheme that is at least
    ``accuracy_order`` accurate by construction. Setup runs in float64
    numpy.
    """

    offsets: tuple[float, ...]
    method: Method
    derivative_order: int
    accuracy_order: int
    dx: float
    scale: float
    c0: np.ndarray  # [stencil_size], physical units
    nullspace: np.ndarray  # [free_dims, stencil_size], physical units
    _cache: _ConstantCache = dataclasses.field(
        init=False, repr=False, compare=False
    )

    def __post_init__(self):
        object.__setattr__(self, "_cache", _ConstantCache())

    @classmethod
    def create(
        cls,
        offsets: Sequence[float],
        method: Method,
        derivative_order: int,
        accuracy_order: int,
        dx: float = 1.0,
        scale: float | None = None,
        bias: np.ndarray | None = None,
    ) -> "PolynomialAccuracy":
        """Build the projection for the given constraint system.

        Args:
          bias: particular solution to use instead of the minimum-norm one
            (must satisfy the constraints in grid units), e.g. the classic
            stencil, so that ``z = 0`` reproduces the baseline scheme.
          scale: multiplier on the null-space component. Default: the RMS
            of the grid-unit particular solution.
        """
        offsets = np.asarray(offsets, dtype=np.float64)
        a, b = constraints(offsets, method, derivative_order, accuracy_order)
        _, sing, vt = np.linalg.svd(a)
        rank = int(np.sum(sing > max(a.shape) * np.finfo(np.float64).eps * sing[0]))
        nullspace_grid = vt[rank:]  # [free, size], orthonormal rows
        if nullspace_grid.shape[0] == 0:
            raise ValueError(
                "constraint system leaves no degrees of freedom; enlarge the "
                "stencil or lower accuracy_order"
            )
        if bias is not None:
            c0_grid = np.asarray(bias, dtype=np.float64)
            residual = a @ c0_grid - b
            if not np.allclose(residual, 0.0, atol=1e-8):
                raise ValueError(f"bias violates constraints: |r|={np.abs(residual).max()}")
        else:
            c0_grid, *_ = np.linalg.lstsq(a, b, rcond=None)
        dx_scale = dx ** (-derivative_order)
        c0 = c0_grid * dx_scale
        nullspace = nullspace_grid * dx_scale
        if scale is None:
            scale = float(np.sqrt(np.mean(c0_grid**2)))
        return cls(
            offsets=tuple(offsets.tolist()),
            method=method,
            derivative_order=derivative_order,
            accuracy_order=accuracy_order,
            dx=dx,
            scale=scale,
            c0=c0,
            nullspace=nullspace,
        )

    @property
    def stencil_size(self) -> int:
        return self.c0.shape[-1]

    @property
    def free_dims(self) -> int:
        """Number of unconstrained degrees of freedom the network controls."""
        return self.nullspace.shape[0]

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        """Map ``z[..., free_dims]`` to coefficients ``[..., stencil_size]``.

        The projection is a full-precision float32 matmul: the JAX package
        pins it to ``Precision.HIGHEST`` because a bf16 projection costs
        about three digits of the scheme's accuracy. On the card the model
        keeps TF32 off (``StencilModel``), so ``torch.matmul`` runs in
        full float32 there too.
        """
        c0 = self._cache.get("c0", self.c0, z)
        nullspace = self._cache.get("nullspace", self.nullspace, z)
        return c0 + self.scale * torch.matmul(z, nullspace)


@dataclasses.dataclass(frozen=True)
class FixedCoefficients:
    """Degenerate constraint layer: ``c(z) = c0 + scale * z``.

    Used for baselines and for ``polynomial_accuracy_order=0`` ablations,
    where the model adds an unconstrained perturbation to the classic
    stencil.
    """

    offsets: tuple[float, ...]
    derivative_order: int
    c0: np.ndarray
    scale: float = 1.0
    _cache: _ConstantCache = dataclasses.field(
        init=False, repr=False, compare=False
    )

    def __post_init__(self):
        object.__setattr__(self, "_cache", _ConstantCache())

    @property
    def stencil_size(self) -> int:
        return self.c0.shape[-1]

    @property
    def free_dims(self) -> int:
        return self.c0.shape[-1]  # unconstrained: one dof per tap

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        return self._cache.get("c0", self.c0, z) + self.scale * z



def int_taps(offsets: Sequence[float], shift: float = 0.0) -> tuple[int, ...]:
    """Integer input taps ``offset - shift`` of a stencil; raises if any
    offset does not land on a grid point."""
    taps = np.asarray(offsets, dtype=np.float64) - shift
    rounded = np.round(taps).astype(int)
    if not np.allclose(taps, rounded, atol=1e-9):
        raise ValueError(
            f"offsets {list(offsets)} with shift {shift} do not land on grid points"
        )
    return tuple(int(t) for t in rounded)


def apply_stencil(
    u: torch.Tensor,
    coeffs: torch.Tensor,
    offsets: Sequence[float],
    shift: float = 0.0,
) -> torch.Tensor:
    """Apply per-point stencil coefficients to a periodic 1-D field.

    ``out[..., j] = sum_i coeffs[..., j, i] * u[..., j + (offsets[i] - shift)]``
    with periodic wraparound on the last axis, one ``torch.roll`` per tap
    (``roll(u, -t)[j] == u[(j + t) % nx]``, as ``jnp.roll``).

    Args:
      u: field, shape ``[..., nx]``.
      coeffs: ``[..., nx, stencil_size]`` (or broadcastable, e.g. a bare
        ``[stencil_size]``).
      offsets: stencil offsets in dx units. Staggered (half-integer)
        offsets take ``shift=-0.5``: output j is then the right face
        ``x_{j+1/2}`` of cell j.
    """
    shifted = torch.stack(
        [torch.roll(u, -t, dims=-1) for t in int_taps(offsets, shift)], dim=-1
    )  # [..., nx, stencil]
    return torch.sum(coeffs * shifted, dim=-1)
