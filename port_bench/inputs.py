"""The inputs of a cell, made from ``--seed`` on the device.

The benchmark's own copy of the equations' distributions (the port's
``Equation.initial_conditions`` and ``sample_forcing``):

    u0(x) = a * sum_m A_m sin(2 pi k_m x / L + phi_m), A ~ U(-1, 1),
            k_m in {ic k_min .. k_max}, phi ~ U(0, 2 pi), ``modes`` terms
    f(x, t) = sum_m A_m sin(omega_m t + 2 pi k_m x / L + phi_m),
            A ~ U(-amp, amp), omega ~ U(-w, w), |k_m| in {k_min .. k_max}
            with a random sign, phi ~ U(0, 2 pi), ``terms`` terms

At ``domain_factor`` n the period and both wavenumber bands scale by n, so
the physical wavelengths stay (as ``run_ensemble --domain_factor`` widens
them). The pool holds ``pool`` distinct batches; request i takes batch
i mod pool. Every seed gives the same sizes; only the values differ.

A configuration with ``warmup_time`` starts its members from a developed
state, as ``run_ensemble --warmup_time`` does (KS: 40, on the attractor;
forced Burgers: 1, past the initial steepening): set-up integrates the pool
that long with the exact solver on the coarse grid (ETDRK4 in Fourier space
with the 2/3 rule, Kassam and Trefethen, SISC 26(4), 2005, at a step of
dx / 5; the forcing at point values), and the requests start at the
warm-up's end. KS's smooth low modes alone barely exercise the learned
stencils; Burgers' raw initial conditions (|u| up to about 5) overrun the
time step's u_scale of 3 in a few members of 10^5 within 100 steps.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class Batch(NamedTuple):
    u0: torch.Tensor  # [B, nx] float32
    forcing: Optional[dict]  # amplitude, omega, k, phi: [B, terms] float32, or None
    t0: float = 0.0  # the time u0 is at: the forcing's phase runs on from the warm-up


def grid_x(cfg: dict, domain_factor: int) -> np.ndarray:
    """Coarse cell centres: block means of the fine grid."""
    period = domain_factor * cfg["period"]
    fine = domain_factor * cfg["fine_size"]
    factor = cfg["resample_factor"]
    return (factor - 1) / 2 * period / fine + np.arange(fine // factor) * period * factor / fine


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> list[Batch]:
    """``traffic["pool"]`` batches of ``traffic["batch"]`` members, drawn
    from one generator on ``device`` seeded with ``seed``."""
    n = traffic["domain_factor"]
    period = n * cfg["period"]
    batch, ic, fc = traffic["batch"], cfg["ic"], cfg.get("forcing")
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    x = torch.as_tensor(grid_x(cfg, n), dtype=torch.float32, device=device)

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    pool = []
    for _ in range(traffic["pool"]):
        shape = (batch, ic["modes"])
        a = uniform(-ic["amplitude"], ic["amplitude"], shape)
        k = torch.randint(n * ic["k_min"], n * ic["k_max"] + 1, shape, generator=gen,
                          device=device)
        phi = uniform(0.0, 2 * math.pi, shape)
        phase = 2 * math.pi * k[..., None] * x / period + phi[..., None]
        u0 = torch.sum(a[..., None] * torch.sin(phase), dim=-2).contiguous()
        forcing = None
        if fc is not None:
            shape = (batch, fc["terms"])
            k = torch.randint(n * fc["k_min"], n * fc["k_max"] + 1, shape, generator=gen,
                              device=device).float()
            sign = torch.where(torch.rand(shape, generator=gen, device=device) < 0.5, 1.0, -1.0)
            forcing = {
                "amplitude": uniform(-fc["amplitude"], fc["amplitude"], shape),
                "omega": uniform(-fc["omega"], fc["omega"], shape),
                "k": k * sign,
                "phi": uniform(0.0, 2 * math.pi, shape),
            }
        t0 = 0.0
        if cfg.get("warmup_time", 0.0) > 0:
            u0, t0 = warm_up(cfg, n, u0, forcing, cfg["warmup_time"])
        pool.append(Batch(u0, forcing, t0))
    return pool


def _etdrk4_coefficients(symbol: np.ndarray, dt: float, points: int = 64) -> dict:
    z0 = symbol.astype(np.complex128) * dt
    z = z0[:, None] + np.exp(1j * (np.arange(points) + 0.5) * 2 * np.pi / points)
    ez = np.exp(z)
    return {
        "e": np.exp(z0), "e2": np.exp(z0 / 2),
        "q": dt * np.mean((np.exp(z / 2) - 1) / z, axis=-1),
        "f1": dt * np.mean((-4 - z + ez * (4 - 3 * z + z ** 2)) / z ** 3, axis=-1),
        "f2": dt * np.mean((2 + z + ez * (-2 + z)) / z ** 3, axis=-1),
        "f3": dt * np.mean((-4 - 3 * z - z ** 2 + ez * (4 - z)) / z ** 3, axis=-1),
    }


def warm_up(cfg: dict, domain_factor: int, u0: torch.Tensor, forcing: Optional[dict],
            duration: float) -> tuple:
    """(``u0`` after ``duration`` of the equation, exactly solved; the time
    it ends at)."""
    nx = u0.shape[-1]
    period = domain_factor * cfg["period"]
    k = 2 * np.pi * np.fft.rfftfreq(nx, d=period / nx)
    symbol = {"ks": k ** 2 - k ** 4, "kdv": 1j * k ** 3,
              "burgers": -cfg.get("eta", 0.0) * k ** 2}[cfg["equation"]]
    nonlinear_scale = {"ks": -1.0, "kdv": -6.0, "burgers": -1.0}[cfg["equation"]]
    x = torch.as_tensor(grid_x(cfg, domain_factor), dtype=torch.float32, device=u0.device)
    dt = 0.2 * period / nx
    steps = int(np.ceil(duration / dt))
    c = {n: torch.as_tensor(a, dtype=torch.complex64, device=u0.device)
         for n, a in _etdrk4_coefficients(symbol, dt).items()}
    mask = torch.as_tensor(np.arange(k.size) <= (2 * (nx // 2)) // 3, dtype=torch.float32,
                           device=u0.device)
    ik = torch.as_tensor(1j * k, dtype=torch.complex64, device=u0.device)

    if forcing is not None:  # sin(w t + phi + kx) = sin(w t + phi) cos kx + cos(w t + phi) sin kx
        kx = (2 * math.pi / period) * forcing["k"][..., None] * x  # [B, terms, nx]
        cos_kx, sin_kx = torch.cos(kx), torch.sin(kx)
        del kx

    def nonlinear(v, t):  # N(u) = s u u_x + f(x, t)
        v = v * mask
        u, u_x = torch.fft.irfft(v, n=nx), torch.fft.irfft(v * ik, n=nx)
        n = nonlinear_scale * u * u_x
        if forcing is not None:
            wt = forcing["omega"] * t + forcing["phi"]
            a = forcing["amplitude"]
            n = n + (torch.bmm((a * torch.sin(wt))[:, None], cos_kx)
                     + torch.bmm((a * torch.cos(wt))[:, None], sin_kx))[:, 0]
        return torch.fft.rfft(n) * mask

    v = torch.fft.rfft(u0)
    for i in range(steps):
        t = i * dt
        nv = nonlinear(v, t)
        a = c["e2"] * v + c["q"] * nv
        na = nonlinear(a, t + dt / 2)
        b = c["e2"] * v + c["q"] * na
        nb = nonlinear(b, t + dt / 2)
        cc = c["e2"] * a + c["q"] * (2 * nb - nv)
        v = c["e"] * v + c["f1"] * nv + 2 * c["f2"] * (na + nb) + c["f3"] * nonlinear(cc, t + dt)
    return torch.fft.irfft(v, n=nx).contiguous(), steps * dt
