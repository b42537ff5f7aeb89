"""Offline analysis helpers for evaluation artifacts (numpy, host side).

The counterpart of ``pde_superresolution_tpu/analysis.py``: MAE-vs-time
curves, survival-time distributions, spectra and a text report, from an
``evaluate.EvalResult`` (tensors on any device, or numpy arrays) or the
HDF5 artifacts it saves (``load_eval_h5``).
"""

from __future__ import annotations

import numpy as np

from pde_superresolution_torch.evaluate import EvalResult, load_eval_h5  # noqa: F401
from pde_superresolution_torch.evaluate import as_numpy as _numpy


def mae_curves(result: EvalResult) -> dict:
    """Ensemble-mean MAE vs time per scheme: {scheme: (times, mae[T])}."""
    times = _numpy(result.times)
    return {
        name: (times, _numpy(mae).mean(axis=0))
        for name, mae in result.mae.items()
    }


def survival_summary(result: EvalResult) -> dict:
    """Survival-time stats per scheme: median/mean/quantiles over the ensemble."""
    out = {}
    for name, st in result.survival_time.items():
        st = _numpy(st).astype(np.float64)
        out[name] = {
            "median": float(np.median(st)),
            "mean": float(st.mean()),
            "q25": float(np.quantile(st, 0.25)),
            "q75": float(np.quantile(st, 0.75)),
            "min": float(st.min()),
            "max": float(st.max()),
        }
    return out


def survival_curves(result: EvalResult) -> dict:
    """Fraction of ensemble members still valid vs time, per scheme:
    ``frac[t] = P(survival_time >= t)`` on the evaluation's own time grid,
    relative to the evaluation start (warmup excluded, the convention of
    ``EvalResult.survival_time``)."""
    rel = _numpy(result.times).astype(np.float64)
    rel = rel - rel[0]
    return {
        name: (
            rel,
            (_numpy(st).astype(np.float64)[:, None] >= rel[None, :]).mean(axis=0),
        )
        for name, st in result.survival_time.items()
    }


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


def report(result: EvalResult, reference_scheme: str = "exact") -> str:
    """Human-readable comparison table (what run_evaluation prints, richer)."""
    lines = []
    surv = survival_summary(result)
    times = _numpy(result.times)
    horizon = float(times[-1] - times[0])
    for name in sorted(result.mae):
        final = _numpy(result.mae[name])[:, -1]
        finite = np.isfinite(final)
        mae = final[finite].mean() if finite.any() else float("nan")
        note = f" [{int((~finite).sum())} diverged]" if (~finite).any() else ""
        s = surv[name]
        lines.append(
            f"{name:>12}: MAE final {mae:.4f}{note} | "
            f"survival median {s['median']:.2f} (IQR {s['q25']:.2f}-"
            f"{s['q75']:.2f}) of horizon {horizon:.1f}"
        )
    return "\n".join(lines)
