"""Periodic 1-D grid geometry (fine/coarse pairs related by a resample factor).

A copy of ``pde_superresolution_tpu.grids`` (the port imports nothing of the
JAX package). Grids are static configuration: plain frozen dataclasses whose
float64 numpy coordinates are cast to tensors at their use sites.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform periodic grid on ``[0, period)`` with ``size`` points.

    Point ``j`` sits at ``x_j = origin + j * dx`` (equivalently: cell ``j``
    spans ``[x_j - dx/2, x_j + dx/2)`` for finite-volume interpretations).

    ``origin`` matters for block-mean (conservative) coarse grids: the mean
    of fine points ``j*f .. (j+1)*f - 1`` is the average over an interval
    centered at ``(j*f + (f-1)/2) * dx_fine``. Any x-dependent field
    evaluated on the coarse grid (the forcing) must use these true cell
    centers, which ``resample(conservative=True)`` encodes here.
    """

    size: int
    period: float
    origin: float = 0.0

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"grid size must be >= 1, got {self.size}")
        if self.period <= 0:
            raise ValueError(f"period must be > 0, got {self.period}")

    @property
    def dx(self) -> float:
        return self.period / self.size

    @property
    def x(self) -> np.ndarray:
        """Point locations, shape [size], float64 (cast at use sites)."""
        return self.origin + np.arange(self.size) * self.dx

    def resample(self, factor: int, conservative: bool = False) -> "Grid":
        """The coarse grid obtained by resampling this grid by ``factor``.

        Coarse point ``j`` corresponds to fine points ``j*factor ..
        (j+1)*factor - 1`` for block-mean (``conservative=True``; cell
        centers shifted by ``(factor-1)/2 * dx_fine``) and to fine point
        ``j*factor`` for subsampling (``conservative=False``).
        """
        if factor < 1 or self.size % factor:
            raise ValueError(
                f"resample factor {factor} must divide grid size {self.size}"
            )
        origin = self.origin
        if conservative:
            origin += (factor - 1) / 2 * self.dx
        return Grid(self.size // factor, self.period, origin)
