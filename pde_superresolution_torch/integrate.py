"""Time integration: method-of-lines Runge-Kutta with a fixed step.

The PyTorch counterpart of ``pde_superresolution_tpu.integrate``'s
differentiators and explicit integrators. Each ``lax.scan`` of the JAX
package is a Python loop here; on the card the per-step work is kernels
launched on the current stream. The exact reference solver is ETDRK4 in
Fourier space (``SpectralETDRK4``, ``integrate_spectral``), a plain loop of
``torch.fft`` calls; ``exact_solve_sampled`` samples it every
``time_delta`` after an optional warm-up, for training data and warm-ups.
``integrate_resumable`` keeps a long integration's saves and carry in an
HDF5 store (the JAX package's layout; ``h5py`` is imported inside it), so a
run that dies resumes from its last completed save.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from pde_superresolution_torch import stencils
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import Equation, ForcingParams
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.ops import spectral
from pde_superresolution_torch.utils import profiling

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


class SpectralDifferentiator(Differentiator):
    """Exact (band-limited) derivatives via FFT; the ground-truth scheme.

    Always uses the direct form of the equation: spectral derivatives are
    exact, so the forms coincide. Spectral derivatives raise the resolvable
    wavenumber ceiling to pi/dx, so for stiff equations (KS's u_xxxx) an
    explicit RK4 step sized for classic stencils is unstable on fine grids;
    integrate this scheme with ``integrate_spectral``.
    """

    def _direct(self) -> Equation:
        eq = self.equation
        return dataclasses.replace(eq, conservative=False) if eq.conservative else eq

    def derivatives(self, u):
        return {
            d: spectral.spectral_derivative(u, d, self.grid.period)
            for d in self._direct().derivative_orders
        }

    def rhs_fn(self, forcing: Optional[ForcingParams] = None) -> RHSFn:
        equation = self._direct()

        def rhs(u, t):
            return equation.time_derivative(
                u, self.derivatives(u), self.grid, t, forcing
            )

        # the original equation's family: the scheme is family-agnostic, but
        # the caller's intended coarse-graining is the original equation's
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


# the JAX package's integrate re-exports it; it lives with the rest of the
# stencil geometry in stencils.py
baseline_stencil_size = stencils.baseline_stencil_size


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
    with profiling.span(profiling.INTEGRATE):
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
    with profiling.span(profiling.INTEGRATE_FUSED):
        u = u0
        t = torch.as_tensor(t0, dtype=u0.dtype, device=u0.device)
        traj = [u0]
        for _ in range(num_saves):
            u = advance(u, t)
            t = t + dt * save_every
            traj.append(u)
        return _save_times(u0, dt, save_every, num_saves, t0), torch.stack(traj)


def integrate_resumable(
    rhs: RHSFn,
    u0: torch.Tensor,
    dt: float,
    num_steps: int,
    save_every: int,
    store_path: str,
    t0: float = 0.0,
    method: str = "rk4",
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``integrate`` with crash-resumable progress in an HDF5 store.

    The store holds the saves ``u`` [num_saves + 1, *u0.shape], the carry
    ``carry_u`` and the attrs ``next`` (the next save to write),
    ``carry_t``, ``dt``, ``t0`` and ``method``. Each save interval of
    ``save_every`` steps runs on ``u0``'s device and is written, carry
    included, before the next begins; calling again with the same
    arguments resumes from the last completed interval. The carry is kept
    exactly (float32 state and time), so a resumed run equals an
    uninterrupted one, and ``integrate``, bit for bit.

    Returns the same (times, trajectory) as ``integrate``, the trajectory
    read back from the store onto ``u0``'s device.

    With ``mesh`` (a ``DeviceMesh`` whose ``"data"`` axis splits the batch)
    ``u0`` is this rank's rows: each rank integrates its own, rank 0 of the
    data axis writes the gathered global batch after each interval (the
    store a single process writes), and every rank resumes from the carry
    rank 0 reads. The trajectory returned is the rank's rows.
    """
    if num_steps % save_every:
        raise ValueError(f"{num_steps=} not divisible by {save_every=}")
    if mesh is not None:
        return _integrate_resumable_dp(rhs, u0, dt, num_steps, save_every, store_path, t0,
                                       method, mesh)
    import h5py

    num_saves = num_steps // save_every
    step = STEP_FUNCS[method]
    shape = (num_saves + 1,) + tuple(u0.shape)
    with h5py.File(store_path, "a") as f:
        _open_store(f, store_path, shape, dt, t0, method)
        start = int(f.attrs["next"])
        with torch.no_grad():
            if start == 0:
                f["u"][0] = u0.detach().cpu().numpy()
                f["carry_u"][...] = u0.detach().cpu().numpy()
                f.attrs["next"] = 1
                start = 1
            u = torch.from_numpy(np.asarray(f["carry_u"][...])).to(u0.device, u0.dtype)
            t = torch.as_tensor(float(f.attrs["carry_t"]), dtype=u0.dtype, device=u0.device)
            for i in range(start, num_saves + 1):
                for _ in range(save_every):
                    u = step(rhs, u, t, dt)
                    t = t + dt
                _write_save(f, i, u.cpu().numpy(), t)
        traj = torch.from_numpy(np.asarray(f["u"][...])).to(u0.device)
    return _save_times(u0, dt, save_every, num_saves, t0), traj


def _open_store(f, store_path: str, shape: tuple, dt: float, t0: float, method: str) -> None:
    """Create the store's datasets and attrs, or check that an existing
    store was written by the same integration."""
    if "u" not in f:
        f.create_dataset("u", shape=shape, dtype="float32")
        f.create_dataset("carry_u", shape=shape[1:], dtype="float32")
        f.attrs["next"] = 0
        f.attrs["carry_t"] = float(t0)
        f.attrs["dt"] = float(dt)
        f.attrs["t0"] = float(t0)
        f.attrs["method"] = method
    elif tuple(f["u"].shape) != shape:
        raise ValueError(
            f"existing store {store_path} has shape {f['u'].shape}, "
            f"expected {shape}; delete it to start fresh"
        )
    else:
        # resuming: the parameters must match what wrote the stored saves,
        # or the result would mix two integrations with mislabeled times
        for name, val in (("dt", float(dt)), ("t0", float(t0))):
            stored = float(f.attrs.get(name, val))
            if abs(stored - val) > 1e-12 * max(abs(val), 1.0):
                raise ValueError(
                    f"store {store_path} was written with {name}="
                    f"{stored}, called with {val}; delete it to restart"
                )
        if f.attrs.get("method", method) != method:
            raise ValueError(
                f"store {store_path} was written with method="
                f"{f.attrs['method']!r}, called with {method!r}"
            )


def _write_save(f, i: int, saved: np.ndarray, t: torch.Tensor) -> None:
    """Save ``i`` and the carry, then mark the interval done."""
    f["u"][i] = saved
    f["carry_u"][...] = saved
    f.attrs["carry_t"] = float(t)
    f.attrs["next"] = i + 1
    f.flush()


def _integrate_resumable_dp(rhs, u0, dt, num_steps, save_every, store_path, t0, method, mesh):
    """``integrate_resumable`` over the ``"data"`` ranks of ``mesh``: only
    rank 0 of the axis opens the store; the carry, or any error met opening
    it, reaches the other ranks by broadcast, and each save by a gather."""
    import h5py  # on every rank, before the first collective
    import torch.distributed as dist

    from pde_superresolution_torch.parallel.mesh import DATA_AXIS

    group = mesh.get_group(DATA_AXIS)
    size, me = dist.get_world_size(group), dist.get_rank(group)
    root = dist.get_global_rank(group, 0)
    rows = u0.shape[0]
    num_saves = num_steps // save_every
    step = STEP_FUNCS[method]
    shape = (num_saves + 1, rows * size) + tuple(u0.shape[1:])

    def gather(u):
        parts = [torch.empty_like(u) for _ in range(size)]
        dist.all_gather(parts, u.contiguous(), group=group)
        return torch.cat(parts).cpu().numpy()

    def from_root(array, like):
        """Rank 0's global array, broadcast; this rank's rows of it."""
        whole = (torch.from_numpy(array).to(like.device, like.dtype) if me == 0
                 else torch.empty((rows * size,) + tuple(like.shape[1:]), dtype=like.dtype,
                                  device=like.device))
        dist.broadcast(whole, src=root, group=group)
        return whole[me * rows:(me + 1) * rows]

    f = None
    with torch.no_grad():
        first = gather(u0)
        state = [None]  # {"start", "carry_t"}, or the error rank 0 met
        error = None
        if me == 0:
            try:
                f = h5py.File(store_path, "a")
                _open_store(f, store_path, shape, dt, t0, method)
                if int(f.attrs["next"]) == 0:
                    f["u"][0] = first
                    f["carry_u"][...] = first
                    f.attrs["next"] = 1
                state = [{"start": int(f.attrs["next"]), "carry_t": float(f.attrs["carry_t"])}]
            except Exception as e:  # the other ranks wait at the broadcast
                if f is not None:
                    f.close()
                    f = None
                error, state = e, [{"error": type(e).__name__, "message": str(e)}]
        dist.broadcast_object_list(state, src=root, group=group)
        if error is not None:
            raise error
        if "error" in state[0]:
            # a refusal stays a ValueError on every rank
            if state[0]["error"] == "ValueError":
                raise ValueError(state[0]["message"])
            raise RuntimeError(f"rank 0 could not open the store {store_path}: "
                               f"{state[0]['error']}: {state[0]['message']}")
        start, carry_t = state[0]["start"], state[0]["carry_t"]
        try:
            u = from_root(np.asarray(f["carry_u"][...]) if me == 0 else None, u0)
            t = torch.as_tensor(carry_t, dtype=u0.dtype, device=u0.device)
            for i in range(start, num_saves + 1):
                for _ in range(save_every):
                    u = step(rhs, u, t, dt)
                    t = t + dt
                saved = gather(u)
                if me == 0:
                    _write_save(f, i, saved, t)
            traj = [from_root(np.asarray(f["u"][i]) if me == 0 else None, u0)
                    for i in range(num_saves + 1)]
        finally:
            if f is not None:
                f.close()
    return _save_times(u0, dt, save_every, num_saves, t0), torch.stack(traj)


# ---------------------------------------------------------------------------
# ETDRK4 spectral solver (exact reference solutions)
# ---------------------------------------------------------------------------


def _etdrk4_coefficients(
    linear_symbol: np.ndarray, dt: float, n_contour: int = 64
) -> dict[str, np.ndarray]:
    """ETDRK4 scalar coefficient arrays via contour-integral averaging.

    Follows Kassam & Trefethen (SISC 2005): evaluate the phi-function
    combinations on a circle |z - L*dt| = 1 to avoid cancellation for small
    |L*dt|. Works for real (dissipative) and imaginary (dispersive) symbols
    by centering the contour at each L*dt value. float64/complex128 numpy,
    computed once at set-up.
    """
    z0 = np.asarray(linear_symbol, dtype=np.complex128) * dt
    theta = (np.arange(n_contour) + 0.5) * (2 * np.pi / n_contour)
    r = np.exp(1j * theta)  # contour offsets
    z = z0[..., None] + r  # [modes, n_contour]

    e_full = np.exp(z0)
    e_half = np.exp(z0 / 2)
    q = dt * np.mean((np.exp(z / 2) - 1) / z, axis=-1)
    f1 = dt * np.mean((-4 - z + np.exp(z) * (4 - 3 * z + z**2)) / z**3, axis=-1)
    f2 = dt * np.mean((2 + z + np.exp(z) * (-2 + z)) / z**3, axis=-1)
    f3 = dt * np.mean((-4 - 3 * z - z**2 + np.exp(z) * (4 - z)) / z**3, axis=-1)
    return {"e": e_full, "e2": e_half, "q": q, "f1": f1, "f2": f2, "f3": f3}


@dataclasses.dataclass(frozen=True)
class SpectralETDRK4:
    """ETDRK4 stepper for ``u_t = L u + N(u)`` on a periodic grid.

    The linear symbol comes from ``equation.linear_symbol``; the
    nonlinearity from ``equation.nonlinear_term``, evaluated in real space
    with 2/3-rule dealiasing. The state is the spectrum ``v_hat``. The
    coefficients, the dealiasing mask and ``ik`` are tensors on the
    stepper's device, moved there once by ``create``.
    """

    equation: Equation
    grid: Grid
    dt: float
    coeffs: dict  # name -> complex tensor [modes]
    dealias_mask: torch.Tensor  # real [modes]
    ik: torch.Tensor  # complex [modes]

    @classmethod
    def create(
        cls, equation: Equation, grid: Grid, dt: float, device=None,
        dtype: torch.dtype = torch.float32,
    ) -> "SpectralETDRK4":
        """``dtype`` is the real field's type; the spectrum is its complex
        counterpart (complex64 for float32)."""
        device = resolve_device(device)
        ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
        k = spectral.wavenumbers(grid.size, grid.period)
        coeffs = _etdrk4_coefficients(equation.linear_symbol(k), dt)
        cutoff = (2 * (grid.size // 2)) // 3  # 2/3 rule on the mode index
        mask = (np.arange(k.size) <= cutoff).astype(np.float64)
        return cls(
            equation, grid, dt,
            {n: torch.as_tensor(a, device=device).to(ctype) for n, a in coeffs.items()},
            torch.as_tensor(mask, device=device).to(dtype),
            torch.as_tensor(1j * k, device=device).to(ctype),
        )

    def _nonlinear_hat(self, v_hat, t, forcing):
        """N(u) in Fourier space with dealiasing, from the spectrum."""
        v_hat = v_hat * self.dealias_mask
        u = torch.fft.irfft(v_hat, n=self.grid.size)
        u_x = torch.fft.irfft(v_hat * self.ik, n=self.grid.size)
        n = self.equation.nonlinear_term(u, u_x, self.grid, t, forcing)
        return torch.fft.rfft(n) * self.dealias_mask

    def step_hat(self, v_hat, t, forcing=None):
        """One ETDRK4 step on the spectrum."""
        c, dt = self.coeffs, self.dt
        nv = self._nonlinear_hat(v_hat, t, forcing)
        a = c["e2"] * v_hat + c["q"] * nv
        na = self._nonlinear_hat(a, t + dt / 2, forcing)
        b = c["e2"] * v_hat + c["q"] * na
        nb = self._nonlinear_hat(b, t + dt / 2, forcing)
        cc = c["e2"] * a + c["q"] * (2 * nb - nv)
        nc = self._nonlinear_hat(cc, t + dt, forcing)
        return c["e"] * v_hat + c["f1"] * nv + 2 * c["f2"] * (na + nb) + c["f3"] * nc


def integrate_spectral(
    equation: Equation,
    grid: Grid,
    u0: torch.Tensor,
    dt: float,
    num_steps: int,
    save_every: int = 1,
    t0: float = 0.0,
    forcing: Optional[ForcingParams] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact reference solve: ETDRK4 in Fourier space, saved in real space.

    A plain loop over ``step_hat`` under ``torch.no_grad()``, on ``u0``'s
    device; the time is carried as a ``u0.dtype`` scalar tensor, advanced by
    ``dt`` per step. The stepper (coefficients on the device) is built at
    every call.

    Returns (times [S+1], trajectory [S+1, *u0.shape]).
    """
    if num_steps % save_every:
        raise ValueError(f"{num_steps=} not divisible by {save_every=}")
    num_saves = num_steps // save_every
    stepper = SpectralETDRK4.create(equation, grid, float(dt), u0.device, u0.dtype)
    with torch.no_grad():
        v = torch.fft.rfft(u0)
        t = torch.as_tensor(t0, dtype=u0.dtype, device=u0.device)
        saved = [v]
        for _ in range(num_saves):
            for _ in range(save_every):
                v = stepper.step_hat(v, t, forcing)
                t = t + dt
            saved.append(v)
        traj = torch.fft.irfft(torch.stack(saved), n=grid.size).to(u0.dtype)
    return _save_times(u0, dt, save_every, num_saves, t0), traj


# Version stamp of the exact-solver numerics (ETDRK4 contour coefficients,
# dealiasing rule, step selection), the JAX package's value: bump it on any
# change that alters a bit of ``exact_solve_sampled``'s output.
EXACT_SOLVER_VERSION = 1


def exact_solve_sampled(
    equation: Equation,
    grid: Grid,
    u0: torch.Tensor,
    time_delta: float,
    num_times: int,
    warmup_time: float = 0.0,
    forcing: Optional[ForcingParams] = None,
    dt_cap: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ETDRK4 exact solve sampled every ``time_delta``, with optional warm-up.

    The internal step only resolves the nonlinear dynamics (the stiff linear
    part is exact at any step): ``dt_cap`` defaults to ``0.2 * dx``, and
    each ``time_delta`` is split into ``ceil(time_delta / dt_cap)`` equal
    steps. Returns (times [num_times], traj [num_times, ..., nx]); the
    warm-up segment is discarded and the times start at its end.
    """
    dt_cap = dt_cap or 0.2 * grid.dx
    substeps = max(1, int(np.ceil(time_delta / dt_cap)))
    dt = time_delta / substeps
    t0 = 0.0
    if warmup_time > 0:
        warm_steps = int(np.ceil(warmup_time / dt))
        _, warm = integrate_spectral(
            equation, grid, u0, dt, warm_steps, save_every=warm_steps,
            forcing=forcing,
        )
        u0 = warm[-1]
        t0 = warm_steps * dt
    return integrate_spectral(
        equation, grid, u0, dt, (num_times - 1) * substeps,
        save_every=substeps, t0=t0, forcing=forcing,
    )


def integrate_exact(
    equation: Equation,
    grid: Grid,
    u0: torch.Tensor,
    dt: float,
    num_steps: int,
    save_every: int = 1,
    **kwargs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact (spectral ETDRK4) solve, the ground-truth path: an alias of
    ``integrate_spectral``."""
    return integrate_spectral(equation, grid, u0, dt, num_steps, save_every, **kwargs)
