"""Plain float32 PyTorch reference of a learned discretization and its RK4.

A frozen copy of the model's mathematics (Bar-Sinai et al., PNAS 116(31),
2019), written from the equations and independent of the code under test:
it reads the committed asset's weights (``<asset>.npz``) itself, builds the
polynomial-accuracy constraint projection and the classic stencils again in
float64 numpy, and integrates with the classic RK4 step. It imports nothing
of ``pde_superresolution_torch`` or of the JAX package.

Forward chain, per RHS evaluation of ``u [B, nx]`` at time ``t``:

    conv tower (periodic, ReLU; im2col matmuls)   [B, C, nx]
    1x1 heads                                     z_d [B, F_d, nx]
    c_d = c0_d + (scale N_d)^T z_d                [B, S_d, nx]
    face value d = sum_i c_d[i] u[j + tap_i]      [B, nx]
    u_t = -(J[j] - J[j-1]) / dx + forcing         (conservative form)

``precision`` names how the matmul inputs are rounded: ``tower`` for the
tower's and heads' inputs (weights and activations; float32 sums) and
``rest`` for the projection's. Each is one of ``ROUNDINGS``. The config
file of a cell states the precision the program runs in; the control lowers
it one step.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ASSET_DIR = Path(__file__).resolve().parents[2] / "pde_superresolution_torch" / "assets"
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 stored mantissa bits, to nearest even, as
    a tensor core reads a float32 operand with TF32 on."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one power-of-two scale for the whole tensor, its
    largest magnitude just under the format's largest finite value."""
    amax = float(x.abs().max())
    if amax == 0.0 or not math.isfinite(amax):
        return x
    scale = 2.0 ** math.floor(math.log2(FP8_MAX / amax))
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


ROUNDINGS = {"float32": _identity, "tf32": _tf32, "bfloat16": _bf16,
             "float8_e4m3fn": _fp8}


# --- stencil mathematics (float64 numpy, at set-up) ---------------------------

def stencil_offsets(size: int, staggered: bool) -> np.ndarray:
    """Offsets in units of dx: staggered ones are half-integers about the face."""
    if staggered:
        return np.arange(size) - size / 2 + 0.5
    return np.arange(size, dtype=np.float64) - size // 2


def constraint_system(offsets: np.ndarray, staggered: bool, order: int,
                      accuracy: int) -> tuple[np.ndarray, np.ndarray]:
    """``A c = b``: the stencil differentiates polynomials of degree below
    ``order + accuracy`` exactly, in grid units. Finite volumes (staggered)
    read cell averages."""
    rows = []
    for m in range(order + accuracy):
        if staggered:
            rows.append(((offsets + 0.5) ** (m + 1) - (offsets - 0.5) ** (m + 1))
                        / math.factorial(m + 1))
        else:
            rows.append(offsets ** m / math.factorial(m))
    b = np.zeros(order + accuracy)
    b[order] = 1.0
    return np.stack(rows), b


@dataclasses.dataclass
class Order:
    """One derivative order's stencil: integer taps, the classic
    coefficients ``c0`` and the scaled null-space ``pn [S, F]``, physical
    units, float64."""

    order: int
    taps: tuple
    c0: np.ndarray
    pn: np.ndarray


def make_order(order: int, size: int, accuracy: int, dx: float, staggered: bool) -> Order:
    if staggered and size % 2:
        size += 1
    if not staggered and size % 2 == 0:
        size += 1
    offsets = stencil_offsets(size, staggered)
    square, rhs = constraint_system(offsets, staggered, order, size - order)
    classic = np.linalg.solve(square, rhs)  # grid units: the z = 0 scheme
    a, _ = constraint_system(offsets, staggered, order, accuracy)
    _, sing, vt = np.linalg.svd(a)
    rank = int(np.sum(sing > max(a.shape) * np.finfo(np.float64).eps * sing[0]))
    nullspace = vt[rank:]
    scale = float(np.sqrt(np.mean(classic ** 2)))
    unit = dx ** (-order)
    shift = -0.5 if staggered else 0.0
    taps = tuple(int(round(o - shift)) for o in offsets)
    return Order(order, taps, classic * unit, scale * (nullspace * unit).T)


# --- the model -----------------------------------------------------------------

@dataclasses.dataclass
class Model:
    """The reference model of one configuration at one domain factor."""

    equation: str
    period: float
    eta: float
    nx: int
    dx: float
    x: np.ndarray  # cell centres, float64
    kernel_size: int
    tower: list  # [(w [Co, K*Cin] with column k*Cin + ci, b [Co])], float32 cpu
    heads: dict  # order -> (w [F, C], b [F]), float32 cpu
    orders: list  # [Order]

    def to(self, device) -> "Model":
        move = lambda t: t.to(device)  # noqa: E731
        return dataclasses.replace(
            self,
            tower=[(move(w), move(b)) for w, b in self.tower],
            heads={d: (move(w), move(b)) for d, (w, b) in self.heads.items()},
        )


def load_asset(asset: str) -> tuple[dict, dict]:
    """(config JSON, npz arrays) of a committed asset."""
    config = json.loads((ASSET_DIR / f"{asset}.json").read_text())
    with np.load(ASSET_DIR / f"{asset}.npz") as npz:
        arrays = {k: np.array(v) for k, v in npz.items()}
    return config, arrays


def build(cfg: dict, domain_factor: int = 1) -> Model:
    """The reference model from a cell's configuration file: the shapes it
    states, the weights from its asset. Raises where the asset's own
    model block disagrees with the configuration."""
    asset_cfg, arrays = load_asset(cfg["asset"])
    for key, value in cfg["model"].items():
        if asset_cfg["model"].get(key) != value:
            raise ValueError(f"{cfg['asset']}: model.{key} is {asset_cfg['model'].get(key)!r}, "
                             f"the configuration states {value!r}")
    for key in ("equation", "conservative", "fine_size", "resample_factor"):
        if asset_cfg[key] != cfg[key]:
            raise ValueError(f"{cfg['asset']}: {key} is {asset_cfg[key]!r}, "
                             f"the configuration states {cfg[key]!r}")
    if not cfg["conservative"]:
        raise ValueError("the reference implements the conservative (flux) form only")
    m = cfg["model"]
    period = domain_factor * cfg["period"]
    fine = domain_factor * cfg["fine_size"]
    factor = cfg["resample_factor"]
    nx = fine // factor
    dx = period / nx
    fine_dx = period / fine
    # block means of the fine grid: cell j is centred (factor - 1) / 2 fine
    # spacings right of fine point j * factor
    x = (factor - 1) / 2 * fine_dx + np.arange(nx) * dx
    tower = []
    for i in range(m["num_layers"]):
        w = arrays[f"tower/{i}/w"]  # [K, Cin, Co]
        k, cin, co = w.shape
        tower.append((torch.from_numpy(np.ascontiguousarray(
            w.reshape(k * cin, co).T)).float(), torch.from_numpy(arrays[f"tower/{i}/b"]).float()))
    orders = [make_order(d, m["stencil_size"], m["polynomial_accuracy_order"], dx, True)
              for d in cfg["derivative_orders"]]
    heads = {o.order: (torch.from_numpy(np.ascontiguousarray(
        arrays[f"heads/{o.order}/w"][0].T)).float(),
        torch.from_numpy(arrays[f"heads/{o.order}/b"]).float()) for o in orders}
    for o in orders:
        if heads[o.order][0].shape[0] != o.pn.shape[1]:
            raise ValueError(f"head {o.order} has {heads[o.order][0].shape[0]} outputs, "
                             f"the constraint layer {o.pn.shape[1]} free dims")
    return Model(cfg["equation"], period, float(cfg.get("eta", 0.0)), nx, dx, x,
                 m["kernel_size"], tower, heads, orders)


def _taps_stack(u: torch.Tensor, taps) -> torch.Tensor:
    """``[..., len(taps), nx]`` with row i ``u[j + taps[i]]`` (periodic)."""
    return torch.stack([torch.roll(u, -t, dims=-1) for t in taps], dim=-2)


def tower(model: Model, u: torch.Tensor, round_in) -> dict:
    """{order: z [B, F, nx]}: the conv tower and the heads."""
    kh = (model.kernel_size - 1) // 2
    taps = range(-kh, model.kernel_size - kh)
    h = u[:, None, :]
    for w, b in model.tower:
        hr = round_in(h)
        cols = torch.cat([torch.roll(hr, -t, dims=-1) for t in taps], dim=1)  # row k*Cin + ci
        h = torch.relu(torch.matmul(round_in(w), cols) + b[:, None])
    hr = round_in(h)
    return {d: torch.matmul(round_in(w), hr) + b[:, None] for d, (w, b) in model.heads.items()}


def flux(model: Model, faces: dict) -> torch.Tensor:
    if model.equation == "ks":  # J = u^2/2 + u_x + u_xxx
        return 0.5 * faces[0] ** 2 + faces[1] + faces[3]
    if model.equation == "burgers":  # J = u^2/2 - eta u_x
        return 0.5 * faces[0] ** 2 - model.eta * faces[1]
    if model.equation == "kdv":  # J = 3 u^2 + u_xx
        return 3.0 * faces[0] ** 2 + faces[2]
    raise ValueError(f"unknown equation {model.equation}")


def linear_flux(model: Model, faces: dict) -> torch.Tensor:
    """The part of ``flux`` linear in the face values: its linearization at
    u = 0."""
    return {"ks": lambda: faces[1] + faces[3], "burgers": lambda: -model.eta * faces[1],
            "kdv": lambda: faces[2]}[model.equation]()


def forcing_field(model: Model, forcing: dict, t) -> torch.Tensor:
    """Cell averages of ``sum_m a_m sin(omega_m t + kappa_m x + phi_m)``
    over ``[x - dx/2, x + dx/2]``, ``[B, nx]``."""
    kappa = 2 * math.pi * forcing["k"] / model.period  # [B, M]
    amp = forcing["amplitude"] * torch.sinc(kappa * model.dx / 2 / math.pi)
    x = torch.as_tensor(model.x, dtype=torch.float32, device=kappa.device)
    phase = (forcing["omega"] * t + forcing["phi"])[..., None] + kappa[..., None] * x
    return torch.sum(amp[..., None] * torch.sin(phase), dim=-2)


def rhs(model: Model, u: torch.Tensor, t, forcing: Optional[dict], precision: dict
        ) -> torch.Tensor:
    round_tower = ROUNDINGS[precision["tower"]]
    round_rest = ROUNDINGS[precision["rest"]]
    zs = tower(model, u, round_tower)
    faces = {}
    for o in model.orders:
        pn = torch.as_tensor(o.pn, dtype=torch.float32, device=u.device)  # [S, F]
        c0 = torch.as_tensor(o.c0, dtype=torch.float32, device=u.device)
        coeffs = c0[:, None] + torch.matmul(round_rest(pn), round_rest(zs[o.order]))
        faces[o.order] = torch.sum(coeffs * _taps_stack(u, o.taps), dim=-2)
    j = flux(model, faces)
    u_t = -(j - torch.roll(j, 1, dims=-1)) / model.dx
    if forcing is not None:
        u_t = u_t + forcing_field(model, forcing, t)
    return u_t


def integrate(model: Model, u0: torch.Tensor, forcing: Optional[dict], dt: float,
              steps: int, save_every: int, precision: dict, t0: float = 0.0) -> torch.Tensor:
    """Classic RK4 from ``u0 [B, nx]``: the saves ``[steps / save_every + 1,
    B, nx]``, ``u0`` first. Rows are independent, so they run in blocks
    sized to bound the im2col buffers."""
    with torch.no_grad():
        batch = u0.shape[0]
        width = max(w.shape[1] for w, _ in model.tower)
        block_rows = max(1, 2 ** 27 // (width * model.nx))
        outs = []
        for r in range(0, batch, block_rows):
            rows = slice(r, min(batch, r + block_rows))
            f = None if forcing is None else {k: v[rows] for k, v in forcing.items()}
            u = u0[rows]
            saves = [u]
            for i in range(steps):
                t = t0 + i * dt
                k1 = rhs(model, u, t, f, precision)
                k2 = rhs(model, u + 0.5 * dt * k1, t + 0.5 * dt, f, precision)
                k3 = rhs(model, u + 0.5 * dt * k2, t + 0.5 * dt, f, precision)
                k4 = rhs(model, u + dt * k3, t + dt, f, precision)
                u = u + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
                if (i + 1) % save_every == 0:
                    saves.append(u)
            outs.append(torch.stack(saves))
        return torch.cat(outs, dim=1)


def stable_dt(cfg: dict, model: Model, u_scale: float = 3.0, safety: float = 0.82) -> float:
    """The time step an ensemble takes: the equation's explicit-RK4 bound at
    ``u_scale``, or ``safety`` times the exact RK4 bound of the classic
    scheme's linear part (a circulant: the FFT of its response to a unit
    impulse gives every eigenvalue), whichever is smaller."""
    dx = model.dx
    adv = dx / max(u_scale, 1e-6)
    if model.equation == "burgers":
        eq_dt = 0.4 * min(adv, 0.5 * dx ** 2 / max(model.eta, 1e-12))
    elif model.equation == "ks":
        eq_dt = 0.4 * min(adv, 2.79 * dx ** 4 / 16.0)
    else:  # kdv
        eq_dt = 0.4 * min(dx / max(6.0 * u_scale, 1e-6), 1.4 * dx ** 3)

    impulse = torch.zeros(model.nx, dtype=torch.float64)
    impulse[0] = 1.0
    faces = {o.order: torch.sum(torch.as_tensor(o.c0)[:, None] * _taps_stack(impulse, o.taps),
                                dim=-2) for o in model.orders}
    j = linear_flux(model, faces)
    lam = np.fft.fft((-(j - torch.roll(j, 1, dims=-1)) / dx).numpy())

    def stable(step):
        z = step * lam
        amp = np.abs(1 + z + z ** 2 / 2 + z ** 3 / 6 + z ** 4 / 24)
        return bool((amp <= np.maximum(1.0, np.abs(np.exp(z))) + 1e-9).all())

    lo, hi = 1e-9, 1e3
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if stable(mid) else (lo, mid)
    return min(eq_dt, safety * lo)
