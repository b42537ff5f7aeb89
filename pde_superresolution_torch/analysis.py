"""Offline analysis helpers (numpy, host side).

The counterpart of ``pde_superresolution_tpu/analysis.py``; the survival
statistics are not ported yet (they need ``evaluate``).
"""

from __future__ import annotations

import numpy as np


def energy_spectrum(u: np.ndarray, period: float) -> tuple[np.ndarray, np.ndarray]:
    """Mean 1-D energy spectrum E(k) over all leading (ensemble/time) axes.

    Returns (k, E) with k the angular wavenumbers of the rfft and
    ``E[k] = <|u_hat_k|^2> / n^2`` (Parseval-normalized so that
    ``sum E ~ <u^2>`` up to the one-sided counting).
    """
    u = np.asarray(u)
    n = u.shape[-1]
    u_hat = np.fft.rfft(u, axis=-1)
    e = (np.abs(u_hat) ** 2).reshape(-1, u_hat.shape[-1]).mean(axis=0) / n**2
    k = 2 * np.pi * np.fft.rfftfreq(n, d=period / n)
    return k, e
