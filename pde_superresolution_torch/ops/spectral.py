"""Spectral (FFT) derivatives and filters on periodic 1-D domains.

The PyTorch counterpart of ``pde_superresolution_tpu/ops/spectral.py``. All
ops use ``torch.fft.rfft``/``irfft`` on the last axis; the multipliers are
float64 numpy constants computed at the call and cast to the field's
complex type. The FFT is a library call on both sides.
"""

from __future__ import annotations

import numpy as np
import torch


def wavenumbers(size: int, period: float) -> np.ndarray:
    """Angular wavenumbers ``2*pi*k/period`` for the rfft of a length-``size``
    real signal, as float64 numpy (a set-up constant)."""
    return 2 * np.pi * np.fft.rfftfreq(size, d=period / size)


def _multiply_spectrum(u: torch.Tensor, mult: np.ndarray, axis: int) -> torch.Tensor:
    """irfft(rfft(u) * mult) along ``axis``, in ``u``'s dtype."""
    if axis != -1:
        u = torch.movedim(u, axis, -1)
    n = u.shape[-1]
    u_hat = torch.fft.rfft(u)
    mult = torch.as_tensor(np.asarray(mult, np.complex128), device=u.device).to(u_hat.dtype)
    out = torch.fft.irfft(u_hat * mult, n=n).to(u.dtype)
    if axis != -1:
        out = torch.movedim(out, -1, axis)
    return out


def spectral_derivative(
    u: torch.Tensor, order: int, period: float, axis: int = -1
) -> torch.Tensor:
    """Exact derivative of a band-limited periodic signal via FFT.

    Multiplies by ``(i*k)**order`` in Fourier space. For odd orders the
    Nyquist mode is zeroed (its derivative is pure imaginary and cannot be
    represented on the real grid; zeroing is the symmetric choice).
    """
    n = u.shape[axis]
    mult = (1j * wavenumbers(n, float(period))) ** order
    if order % 2 and n % 2 == 0:
        mult[-1] = 0
    return _multiply_spectrum(u, mult, axis)


def spectral_derivative_at_offset(
    u: torch.Tensor, order: int, period: float, offset: float
) -> torch.Tensor:
    """Derivative evaluated at points shifted by ``offset`` (physical units).

    Combines the symbol ``(ik)^order`` with the Fourier shift theorem
    ``exp(ik*offset)``: output index j is the derivative at ``x_j + offset``.
    It gives exact face labels (``x_{j+1/2}``) for conservative models. The
    Nyquist bin is zeroed for odd orders and for shifts that are not a
    multiple of the grid spacing (tested with a tolerance: exact float
    modulo can misclassify offsets like ``3*period/n``).
    """
    period, offset = float(period), float(offset)
    n = u.shape[-1]
    k = wavenumbers(n, period)
    mult = (1j * k) ** order * np.exp(1j * k * offset)
    dx = period / n
    frac = offset / dx - round(offset / dx)
    if n % 2 == 0 and (order % 2 or abs(frac) > 1e-9):
        mult[-1] = 0
    return _multiply_spectrum(u, mult, -1)


def smoothing_filter(
    u: torch.Tensor, period: float, cutoff_fraction: float = 0.5, axis: int = -1
) -> torch.Tensor:
    """Gaussian low-pass filter: multiplies the spectrum by
    ``exp(-(k/k_c)**2)`` with ``k_c = cutoff_fraction * k_nyquist``. It
    smooths random initial conditions so the fine-grid exact solve is well
    resolved."""
    k = wavenumbers(u.shape[axis], float(period))
    k_c = float(cutoff_fraction) * k[-1]
    return _multiply_spectrum(u, np.exp(-((k / k_c) ** 2)), axis)
