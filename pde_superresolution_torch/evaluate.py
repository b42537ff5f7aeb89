"""Evaluation harness: exact vs baselines vs model, MAE and survival time.

The PyTorch counterpart of ``pde_superresolution_tpu/evaluate.py``. The
whole ensemble integrates batched on one device: matched initial conditions
go through the exact fine solve (ETDRK4) and through every coarse scheme,
and the metrics compare each scheme with the coarse-grained exact solution.
``save_eval_h5``/``load_eval_h5`` keep the JAX package's HDF5 layout, so a
file written by either package loads in the other.

Survival ("valid") time, as in the JAX package:

    survival_time = first time the Pearson correlation over x between the
    scheme's solution and the coarse-grained exact solution drops below
    ``correlation_threshold`` (default 0.8); once dead, always dead.

Randomness comes from a CPU ``torch.Generator``: the initial conditions,
then the forcing, are drawn on the host and moved to the device, so the
card and the CPU draw the same members. ``h5py`` is imported only by the
functions that read or write a file.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import typing
import warnings
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from pde_superresolution_torch import integrate
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import Equation, ForcingParams, params_dict
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.ops import resample

logger = logging.getLogger(__name__)

# the reference cache's own format tag: this package's files never share a
# key with the JAX package's (whose "format" is 1), nor its directory
CACHE_FORMAT = "pde_superresolution_torch/1"


class EvalResult(typing.NamedTuple):
    times: torch.Tensor  # [T]
    exact: torch.Tensor  # [batch, T, nx_coarse]
    trajectories: dict  # {scheme: [batch, T, nx_coarse]}
    mae: dict  # {scheme: [batch, T]}
    correlation: dict  # {scheme: [batch, T]}
    survival_time: dict  # {scheme: [batch]}


def pearson_correlation(a: torch.Tensor, b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    a = a - a.mean(dim=axis, keepdim=True)
    b = b - b.mean(dim=axis, keepdim=True)
    num = (a * b).sum(dim=axis)
    den = torch.sqrt((a**2).sum(dim=axis) * (b**2).sum(dim=axis))
    return num / torch.maximum(den, torch.full_like(den, 1e-12))


def _last_alive_time(alive: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """``times`` at the last index of the leading run of ``alive`` (bool
    ``[..., T]``); ``times[0]`` if dead on arrival."""
    n_alive = torch.cumprod(alive.to(torch.int32), dim=-1).sum(dim=-1)
    idx = torch.clamp(n_alive - 1, 0, times.shape[0] - 1)
    return times[idx]


def survival_time_from_correlation(
    corr: torch.Tensor, times: torch.Tensor, threshold: float = 0.8
) -> torch.Tensor:
    """First time corr drops below threshold (monotone: once dead, dead).

    corr: [..., T]; returns [...] (the last alive time; times[-1] if never
    dies, times[0] if dead on arrival).
    """
    return _last_alive_time(corr >= threshold, times)


def survival_time_from_mae(
    mae: torch.Tensor,
    times: torch.Tensor,
    threshold: float,
) -> torch.Tensor:
    """Alternative validity criterion: first time the MAE exceeds
    ``threshold`` (monotone: once dead, always dead). The correlation
    criterion is the default; this one serves MAE-threshold analyses."""
    return _last_alive_time(mae <= threshold, times)


def default_reference_cache_dir() -> str:
    """The default on-disk location for cached exact references."""
    base = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    return os.path.join(base, "pde_superresolution_torch", "exact_refs")


def resolve_reference_cache_dir(flag: str) -> Optional[str]:
    """The CLIs' ``--reference_cache_dir``: ``auto`` is the default cache
    directory when ``h5py`` imports, else no cache (one printed line says
    so; results are bit-identical without it); ``''`` is no cache; any other
    value is that directory, which needs ``h5py``."""
    if flag != "auto":
        return flag or None
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("reference cache: off (h5py is not installed; every exact fine solve is "
              "computed, with bit-identical results)", flush=True)
        return None
    return default_reference_cache_dir()


def _reference_cache_key(
    equation: Equation,
    fine_grid: Grid,
    generator_state: torch.Tensor,
    num_samples: int,
    time_delta: float,
    num_times: int,
    warmup_time: float,
    ic_scale: float,
    exact_dt_cap: Optional[float],
    dtype: torch.dtype = torch.float32,
) -> tuple[str, str]:
    """(hash, canonical-JSON) identifying one exact fine solve EXACTLY.

    Every input that changes a single bit of the fine trajectory is in the
    key: the full equation dataclass, the fine grid, the generator's state
    before the draw (initial conditions and forcing), the sampling protocol,
    the integrator step cap, the compute dtype and the solver's version. The
    coarse-graining factor is deliberately NOT in the key: all resample
    factors share one fine solve.
    """
    canonical = json.dumps(
        {
            "equation": equation.name,
            "equation_params": dict(sorted(params_dict(equation).items())),
            "conservative": bool(equation.conservative),
            "fine_size": int(fine_grid.size),
            "period": float(fine_grid.period),
            "generator_state_sha256": hashlib.sha256(
                generator_state.cpu().numpy().tobytes()).hexdigest(),
            "num_samples": int(num_samples),
            "time_delta": float(time_delta),
            "num_times": int(num_times),
            "warmup_time": float(warmup_time),
            "ic_scale": float(ic_scale),
            "exact_dt_cap": None if exact_dt_cap is None else float(exact_dt_cap),
            "dtype": str(dtype).removeprefix("torch."),
            "solver_version": integrate.EXACT_SOLVER_VERSION,
            "format": CACHE_FORMAT,
        },
        sort_keys=True,
        default=list,
    )
    return hashlib.sha256(canonical.encode()).hexdigest()[:20], canonical


def _draw(equation, fine_grid, generator, num_samples, ic_scale, device):
    """(u0, forcing): the initial conditions, then the forcing, from
    ``generator`` (as ``training.data.generate_snapshots`` draws them)."""
    u0 = ic_scale * equation.initial_conditions(generator, fine_grid, (num_samples,), device)
    forcing = equation.sample_forcing(generator, (num_samples,), device)
    return u0, forcing


def _cached_exact_solve(
    cache_dir: str,
    equation: Equation,
    fine_grid: Grid,
    generator: torch.Generator,
    num_samples: int,
    time_delta: float,
    num_times: int,
    warmup_time: float,
    ic_scale: float,
    exact_dt_cap: Optional[float],
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, Optional[ForcingParams]]:
    """Exact fine solve through a content-keyed on-disk cache.

    Returns (times, traj_fine, forcing) bit-identical to the uncached path
    (the stored arrays ARE the computed ones; the forcing draw is stored and
    reloaded so the cache is self-contained). The members are drawn on a hit
    too, so the generator advances the same either way. Concurrent writers
    are safe: the store is written to a temp file and atomically renamed.
    """
    import h5py

    device = resolve_device(device)
    state = generator.get_state()
    u0, forcing = _draw(equation, fine_grid, generator, num_samples, ic_scale, device)
    h, canonical = _reference_cache_key(
        equation, fine_grid, state, num_samples, time_delta, num_times,
        warmup_time, ic_scale, exact_dt_cap, u0.dtype,
    )
    path = os.path.join(cache_dir, f"ref_{h}.h5")
    if os.path.exists(path):
        with h5py.File(path, "r") as f:
            stored = f.attrs["canonical"]
            if stored != canonical:  # sha256-20 collision: effectively never
                raise RuntimeError(
                    f"reference cache collision at {path}:\n"
                    f"stored   {stored}\nrequested {canonical}"
                )
            load = lambda ds: torch.from_numpy(ds[...]).to(device)
            times = load(f["times"])
            traj_fine = load(f["traj_fine"])
            forcing = None
            if "forcing" in f:
                forcing = ForcingParams(**{k: load(v) for k, v in f["forcing"].items()})
        logger.info("exact-reference cache HIT: %s", path)
        return times, traj_fine, forcing

    logger.info("exact-reference cache miss: computing %s", path)
    times, traj_fine = integrate.exact_solve_sampled(
        equation, fine_grid, u0, time_delta, num_times,
        warmup_time=warmup_time, forcing=forcing, dt_cap=exact_dt_cap,
    )
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".h5.tmp")
    os.close(fd)
    try:
        with h5py.File(tmp, "w") as f:
            f.attrs["canonical"] = canonical
            f.create_dataset("times", data=times.cpu().numpy())
            f.create_dataset("traj_fine", data=traj_fine.cpu().numpy())
            if forcing is not None:
                g = f.create_group("forcing")
                for name, arr in forcing._asdict().items():
                    g.create_dataset(name, data=arr.cpu().numpy())
        os.replace(tmp, path)
        logger.info(
            "exact-reference cache write: %s (%.1f MB; the cache has no "
            "eviction — delete old ref_*.h5 files or the directory to "
            "reclaim space)",
            path,
            os.path.getsize(path) / 1e6,
        )
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return times, traj_fine, forcing


# the warnings point at evaluate's caller: above this helper, evaluate and
# its torch.no_grad wrapper
_CALLER = 4


def model_coarse_dt(model_dt: Optional[float], equation: Equation,
                    grid: Grid) -> Optional[float]:
    """The model-aware coarse step for ``evaluate(coarse_dt=...)``: the
    model's stable RK4 step (``StencilModel.stable_time_step(u_scale=3)``,
    or a frozen artifact's ``stable_dt``) where it is tighter than the
    equation's on ``grid`` (wide stencils), else None, so protocols with
    stencils up to 8 taps keep their exact step counts. The baseline and
    WENO integrate at the same step, which only ever tightens for them."""
    if model_dt and model_dt < equation.stable_time_step(grid, u_scale=3.0):
        return model_dt
    return None


def _warn_on_family(name: str, rhs, equation: Equation) -> None:
    """The coarse-graining family check: rhs closures carry a
    ``.conservative`` tag; a scheme of the other family (or an untagged
    one, which cannot be verified) is compared against this family's
    coarse-graining, half a cell off."""
    family = getattr(rhs, "conservative", None)
    if family is None:
        warnings.warn(
            f"scheme {name!r} carries no .conservative family tag, so "
            "its coarse-graining family (cell-average vs point-value) "
            "cannot be verified against this evaluation's "
            f"{'conservative' if equation.conservative else 'non-conservative'}"
            " coarse-graining — if the families differ, its initial"
            " conditions and exact reference are half a cell off. Set"
            " rhs.conservative = True/False on the closure to assert"
            " the family and silence this warning.",
            stacklevel=_CALLER,
        )
    elif family != equation.conservative:
        warnings.warn(
            f"scheme {name!r} is a "
            f"{'conservative (cell-average)' if family else 'non-conservative (point-value)'}"
            f" scheme but the evaluation coarse-graining follows the "
            f"{'conservative' if equation.conservative else 'non-conservative'}"
            " equation — its initial conditions and exact reference are"
            " half a cell off. Run a separate evaluation for this"
            " scheme's family.",
            stacklevel=_CALLER,
        )


@torch.no_grad()
def evaluate(
    equation: Equation,
    fine_grid: Grid,
    resample_factor: int,
    schemes: Mapping[str, Callable[[Optional[ForcingParams]], integrate.RHSFn]],
    generator: torch.Generator,
    num_samples: int,
    time_max: float,
    time_delta: float,
    warmup_time: float = 0.0,
    correlation_threshold: float = 0.8,
    coarse_dt: Optional[float] = None,
    exact_dt_cap: Optional[float] = None,
    ic_scale: float = 1.0,
    reference_cache_dir: Optional[str] = None,
    device=None,
) -> EvalResult:
    """Integrate matched ICs through exact + every scheme; compute metrics.

    Args:
      schemes: name -> (forcing -> rhs_fn) factories, e.g.
        ``{"baseline": lambda f: PolynomialDifferentiator(...).rhs_fn(f),
           "model": lambda f: model.rhs_fn(params, f)}``. ONE
        coarse-graining, chosen by ``equation.conservative`` (block mean if
        conservative, subsample otherwise), produces the matched initial
        conditions and the exact reference for EVERY scheme; a scheme whose
        ``.conservative`` family tag differs (or is missing) raises a
        UserWarning.
      generator: a CPU ``torch.Generator``; the initial conditions, then
        the forcing, are drawn from it and moved to ``device`` (default
        ``cuda``), where the exact solve runs. The schemes run on the
        devices their closures were built for.
      coarse_dt: coarse integrator step; defaults to an integer subdivision
        of ``time_delta`` near the equation's stable step.
      reference_cache_dir: if set, the exact fine solve is served from a
        content-keyed on-disk cache (``_reference_cache_key``; needs
        ``h5py``). Results are bit-identical to the uncached path.
    """
    device = resolve_device(device)
    coarse = fine_grid.resample(resample_factor, conservative=equation.conservative)
    num_times = int(round(time_max / time_delta)) + 1

    if reference_cache_dir:
        times, traj_fine, forcing = _cached_exact_solve(
            reference_cache_dir, equation, fine_grid, generator, num_samples,
            time_delta, num_times, warmup_time, ic_scale, exact_dt_cap, device,
        )
    else:
        u0, forcing = _draw(equation, fine_grid, generator, num_samples, ic_scale, device)
        # exact fine solve (the SAME solver as training-data generation)
        times, traj_fine = integrate.exact_solve_sampled(
            equation,
            fine_grid,
            u0,
            time_delta,
            num_times,
            warmup_time=warmup_time,
            forcing=forcing,
            dt_cap=exact_dt_cap,
        )  # [T, batch, nx_fine]; traj_fine[0] is the (possibly warmed) IC
    t0 = float(times[0])

    if equation.conservative:
        coarsen = lambda f: resample.resample_mean(f, resample_factor)
    else:
        coarsen = lambda f: resample.subsample(f, resample_factor)
    exact = coarsen(traj_fine).transpose(0, 1).contiguous()  # [batch, T, nx_c]
    u0_coarse = exact[:, 0].contiguous()

    # coarse integrations
    if coarse_dt is None:
        stable = equation.stable_time_step(coarse, u_scale=3.0)
        inner = max(1, int(np.ceil(time_delta / stable)))
    else:
        # ceil, not round: when coarse_dt does not divide time_delta the
        # requested step is impossible and FINER is the only safe side
        inner = max(1, int(np.ceil(time_delta / coarse_dt - 1e-9)))
    dt_coarse = time_delta / inner

    trajectories, mae, corr_d, surv = {}, {}, {}, {}
    for name, factory in schemes.items():
        rhs = factory(forcing)
        _warn_on_family(name, rhs, equation)
        _, traj = integrate.integrate(
            rhs,
            u0_coarse,
            dt_coarse,
            (num_times - 1) * inner,
            save_every=inner,
            t0=t0,
        )
        traj = traj.transpose(0, 1)  # [batch, T, nx_c]
        trajectories[name] = traj
        mae[name] = (traj - exact).abs().mean(dim=-1)
        c = pearson_correlation(traj, exact)
        c = torch.where(torch.isfinite(c), c, torch.full_like(c, -1.0))  # NaN blowup = dead
        corr_d[name] = c
        # survival relative to the evaluation start (warmup excluded)
        surv[name] = survival_time_from_correlation(
            c, times - times[0], correlation_threshold
        )

    return EvalResult(
        times=times,
        exact=exact,
        trajectories=trajectories,
        mae=mae,
        correlation=corr_d,
        survival_time=surv,
    )


def as_numpy(x) -> np.ndarray:
    """A host numpy array from a tensor (any device) or an array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_eval_h5(path: str, result: EvalResult) -> None:
    """Persist an EvalResult in the JAX package's HDF5 layout."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("times", data=as_numpy(result.times))
        f.create_dataset("exact", data=as_numpy(result.exact))
        for group_name in ("trajectories", "mae", "correlation", "survival_time"):
            g = f.create_group(group_name)
            for scheme, arr in getattr(result, group_name).items():
                g.create_dataset(scheme, data=as_numpy(arr))


def load_eval_h5(path: str) -> EvalResult:
    """An EvalResult of CPU tensors from a file of either package."""
    import h5py

    with h5py.File(path, "r") as f:
        read_group = lambda name: {
            k: torch.from_numpy(v[...]) for k, v in f[name].items()
        }
        return EvalResult(
            times=torch.from_numpy(f["times"][...]),
            exact=torch.from_numpy(f["exact"][...]),
            trajectories=read_group("trajectories"),
            mae=read_group("mae"),
            correlation=read_group("correlation"),
            survival_time=read_group("survival_time"),
        )
