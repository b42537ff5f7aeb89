"""Turn a run_evaluation HDF5 file into the paper-style figures.

The counterpart of ``pde_superresolution_tpu/scripts/run_analysis.py``: it
reads the HDF5 written by ``run_evaluation`` (of either package) and writes
the figures and prints the ``analysis.report`` text, or draws the sweep
figures from ``run_sweep`` JSONL results. It only reads files, so it runs on
the CPU; ``--checkpoint_dir`` is loaded there by ``convert.load_checkpoint``.
Needs ``h5py`` (for ``--input_path``) and ``matplotlib``, both imported
inside the functions that use them.

Example:
  python -m pde_superresolution_torch.scripts.run_analysis \
      --input_path /tmp/eval.h5 --output_dir /tmp/figs

Figures (PNG):
  mae.png       ensemble-median MAE vs time per scheme (log y)
  survival.png  fraction of ensemble still valid vs time per scheme
  spectrum.png  time-averaged energy spectrum E(k), schemes vs exact
  spacetime.png space-time diagrams u(x, t) of one sample, all schemes
  coefficients.png  (with --checkpoint_dir) the learned stencil
                coefficients across one model state against the classic
                polynomial stencil, and the learned vs classic taps at the
                roughest and smoothest points
  sweep_mae.png, sweep_survival.png  (with --sweep_jsonl) final MAE and
                median survival vs resample factor, per scheme
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from pde_superresolution_torch import analysis, convert
from pde_superresolution_torch.evaluate import as_numpy as _numpy


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_path", default=None,
                        help="evaluation HDF5 file (or use --sweep_jsonl)")
    parser.add_argument("--sweep_jsonl", default=None,
                        help="run_sweep JSONL results instead of an evaluation HDF5: "
                        "the accuracy-vs-coarsening figures (final MAE and median "
                        "survival vs resample factor, per scheme; hollow markers = "
                        "some ensemble members diverged)")
    parser.add_argument("--output_dir", required=True, help="directory for figures")
    parser.add_argument("--period", type=float, default=0.0,
                        help="domain period for the spectrum's wavenumber axis; "
                        "0 = label the axis in cycles per domain instead")
    parser.add_argument("--sample", type=int, default=0,
                        help="ensemble member for the space-time plot")
    parser.add_argument("--spacetime_window", type=int, default=0,
                        help="grid points shown in the space-time diagrams (0 = the "
                        "whole domain); crop for large domains")
    parser.add_argument("--dpi", type=int, default=150, help="figure raster resolution")
    parser.add_argument("--checkpoint_dir", default=None,
                        help="trained checkpoint (training directory, asset name or "
                        "path stem); if given, also write coefficients.png")
    parser.add_argument("--coeff_time_index", type=int, default=-1,
                        help="trajectory snapshot for the coefficients figure; "
                        "-1 = mid-horizon")
    return parser


# Fixed scheme -> color assignment (identity, never cycled): the first
# three slots of the validated categorical palette; the exact reference
# is neutral ink (it is the ground truth, not a competing series).
_SCHEME_COLORS = {
    "model": "#2a78d6",     # blue
    "baseline": "#eb6834",  # orange
    "weno": "#1baf7a",      # aqua
}
_EXTRA_COLORS = ["#eda100", "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_EXACT_COLOR = "#52514e"
_SURFACE = "#fcfcfb"
_GRID = "#e1e0d9"
_MUTED = "#898781"
_AXIS = "#c3c2b7"
_INK = "#0b0b0b"


def _color(name: str, fallback_idx: int) -> str:
    if name in _SCHEME_COLORS:
        return _SCHEME_COLORS[name]
    return _EXTRA_COLORS[fallback_idx % len(_EXTRA_COLORS)]


def _style_axes(ax):
    ax.set_facecolor(_SURFACE)
    ax.grid(True, color=_GRID, linewidth=0.8)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_AXIS)
    ax.tick_params(colors=_MUTED, labelcolor=_MUTED)
    ax.xaxis.label.set_color(_INK)
    ax.yaxis.label.set_color(_INK)
    ax.title.set_color(_INK)


def make_figures(result, output_dir: str, period: float = 0.0,
                 sample: int = 0, dpi: int = 150,
                 spacetime_window: int = 0) -> list:
    """Write the four figures for an EvalResult; returns the paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    paths = []
    names = sorted(result.mae)
    rel = _numpy(result.times).astype(np.float64)
    rel = rel - rel[0]

    # 1. MAE vs time: ensemble-median over members still valid (a member
    # blowing up passes through astronomically large float values before
    # reaching NaN, so an unconditioned mean is unreadable); the line ends
    # once fewer than half the ensemble survives (beyond that the curve
    # would describe a shrinking, survivor-biased subset).
    fig, ax = plt.subplots(figsize=(6, 3.6), facecolor=_SURFACE)
    for i, name in enumerate(names):
        mae = _numpy(result.mae[name]).astype(np.float64)
        surv = _numpy(result.survival_time[name]).astype(np.float64)
        alive = (surv[:, None] >= rel[None, :]) & np.isfinite(mae)
        masked = np.where(alive, mae, np.nan)
        n_alive = alive.sum(axis=0)
        med = np.full(rel.shape, np.nan)
        ok = n_alive >= (mae.shape[0] + 1) // 2  # at least half survive
        if ok.any():
            med[ok] = np.nanmedian(masked[:, ok], axis=0)
        ax.plot(rel, med, color=_color(name, i), linewidth=2, label=name)
    ax.set_yscale("log")
    ax.set_xlabel("time since evaluation start")
    ax.set_ylabel("median MAE vs exact (valid members)")
    _style_axes(ax)
    ax.legend(frameon=False, labelcolor=_INK)
    fig.tight_layout()
    p = os.path.join(output_dir, "mae.png")
    fig.savefig(p, dpi=dpi, facecolor=_SURFACE)
    plt.close(fig)
    paths.append(p)

    # 2. Survival curves (fraction of ensemble valid vs time).
    fig, ax = plt.subplots(figsize=(6, 3.6), facecolor=_SURFACE)
    for i, (name, (t, frac)) in enumerate(
        sorted(analysis.survival_curves(result).items())
    ):
        ax.step(t, frac, where="post", color=_color(name, i), linewidth=2,
                label=name)
    ax.set_ylim(-0.02, 1.05)
    ax.set_xlabel("time since evaluation start")
    ax.set_ylabel("fraction of ensemble valid")
    _style_axes(ax)
    ax.legend(frameon=False, labelcolor=_INK)
    fig.tight_layout()
    p = os.path.join(output_dir, "survival.png")
    fig.savefig(p, dpi=dpi, facecolor=_SURFACE)
    plt.close(fig)
    paths.append(p)

    # 3. Energy spectra: exact vs schemes, averaged over all times and the
    # members that stayed finite for the whole horizon.
    fig, ax = plt.subplots(figsize=(6, 3.6), facecolor=_SURFACE)
    nx = _numpy(result.exact).shape[-1]
    spec_period = period if period > 0 else float(nx)
    k, e = analysis.energy_spectrum(_numpy(result.exact), spec_period)
    ax.loglog(k[1:], e[1:], color=_EXACT_COLOR, linewidth=2,
              linestyle="--", label="exact")
    for i, name in enumerate(names):
        traj = _numpy(result.trajectories[name]).astype(np.float64)
        alive = np.isfinite(traj).all(axis=(1, 2))
        if not alive.any():
            continue
        k, e = analysis.energy_spectrum(traj[alive], spec_period)
        ax.loglog(k[1:], e[1:], color=_color(name, i), linewidth=2,
                  label=name)
    ax.set_xlabel(
        "wavenumber k" if period > 0 else "wavenumber (cycles/domain scale)"
    )
    ax.set_ylabel("E(k)")
    _style_axes(ax)
    ax.legend(frameon=False, labelcolor=_INK)
    fig.tight_layout()
    p = os.path.join(output_dir, "spectrum.png")
    fig.savefig(p, dpi=dpi, facecolor=_SURFACE)
    plt.close(fig)
    paths.append(p)

    # 4. Space-time diagrams of one member: exact + every scheme, shared
    # symmetric diverging scale (u is signed; blue <-> red, neutral mid).
    # An optional window crops the spatial axis (periodic fields carry the
    # same statistics everywhere; the full width of a large domain aliases
    # into an unreadable raster).
    w = spacetime_window
    crop = (lambda u: u[..., :w]) if w else (lambda u: u)
    panels = [("exact", crop(_numpy(result.exact)[sample]))]
    panels += [
        (name, crop(_numpy(result.trajectories[name])[sample]))
        for name in names
    ]
    vmax = float(np.nanmax(np.abs(panels[0][1]))) or 1.0
    fig, axes = plt.subplots(
        1, len(panels), figsize=(3.2 * len(panels), 3.6),
        facecolor=_SURFACE, sharey=True,
    )
    for ax, (name, u) in zip(np.atleast_1d(axes), panels):
        u = np.where(np.isfinite(u), u, 0.0)
        ax.imshow(
            u, aspect="auto", origin="lower", cmap="RdBu_r",
            vmin=-vmax, vmax=vmax,
            extent=(0, u.shape[1], float(rel[0]), float(rel[-1])),
        )
        ax.set_title(name)
        ax.set_xlabel("x (grid index)")
        ax.tick_params(colors=_MUTED, labelcolor=_MUTED)
        ax.title.set_color(_INK)
        ax.xaxis.label.set_color(_INK)
    np.atleast_1d(axes)[0].set_ylabel("time")
    np.atleast_1d(axes)[0].yaxis.label.set_color(_INK)
    fig.tight_layout()
    p = os.path.join(output_dir, "spacetime.png")
    fig.savefig(p, dpi=dpi, facecolor=_SURFACE)
    plt.close(fig)
    paths.append(p)

    return paths


def make_coefficients_figure(model, params, u, output_dir: str,
                             dpi: int = 150) -> str:
    """The paper's central qualitative figure: learned coefficients adapt
    to the local solution.

    For each derivative order, two views of one state ``u``:
      * a diverging heatmap of (learned − classic) per stencil tap across
        the whole field — where the model departs from polynomial numerics;
      * the full coefficient vectors (learned vs classic) at the roughest
        point (max |∂u/∂x| — a shock/front) and the smoothest point, the
        comparison the paper draws.

    Coefficients are shown in grid units (× dx^order), so classic taps are
    O(1) ([1,−2,1]-style) regardless of resolution.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    u = np.asarray(u, dtype=np.float64)
    nx = u.shape[-1]
    dx = model.grid.dx
    with torch.no_grad():
        state = torch.as_tensor(u[None], dtype=torch.float32, device=model.device)
        coeffs = {
            d: _numpy(c[0]).astype(np.float64) * dx**d  # [nx, S], grid units
            for d, c in model.coefficients(params, state).items()
        }
    orders = sorted(coeffs)
    # roughest / smoothest points of this state (periodic gradient)
    slope = np.abs(np.gradient(u, dx))
    i_rough, i_smooth = int(slope.argmax()), int(slope.argmin())

    fig = plt.figure(
        figsize=(9, 2.6 * (len(orders) + 1)), facecolor=_SURFACE
    )
    gs = fig.add_gridspec(len(orders) + 1, 2)
    # top row: the state, with the two probed locations marked
    ax_u = fig.add_subplot(gs[0, :])
    x = np.arange(nx) * dx
    ax_u.plot(x, u, color=_EXACT_COLOR, linewidth=2)
    for idx, label in ((i_rough, "roughest"), (i_smooth, "smoothest")):
        ax_u.axvline(x[idx], color=_SCHEME_COLORS["model"], linewidth=1,
                     linestyle=":" if label == "smoothest" else "-")
        ax_u.annotate(label, (x[idx], float(u[idx])), color=_INK,
                      fontsize=8, xytext=(4, 4), textcoords="offset points")
    ax_u.set_xlabel("x")
    ax_u.set_ylabel("u")
    _style_axes(ax_u)

    for row, d in enumerate(orders, start=1):
        c = coeffs[d]  # [nx, S]
        layer = model.constraint_layers[d]
        classic = np.asarray(layer.c0, dtype=np.float64) * dx**d
        offsets = np.asarray(layer.offsets, dtype=np.float64)
        dev = c - classic[None, :]

        ax = fig.add_subplot(gs[row, 0])
        vmax = float(np.nanmax(np.abs(dev))) or 1.0
        im = ax.imshow(
            dev.T, aspect="auto", origin="lower", cmap="RdBu_r",
            vmin=-vmax, vmax=vmax,
            extent=(0, nx * dx, offsets[0], offsets[-1]),
        )
        ax.set_xlabel("x")
        ax.set_ylabel(f"tap offset (order {d})")
        ax.set_title(f"learned − classic, order {d}", fontsize=9)
        ax.title.set_color(_INK)
        ax.tick_params(colors=_MUTED, labelcolor=_MUTED)
        ax.xaxis.label.set_color(_INK)
        ax.yaxis.label.set_color(_INK)
        fig.colorbar(im, ax=ax, fraction=0.046)

        ax = fig.add_subplot(gs[row, 1])
        ax.plot(offsets, classic, color=_SCHEME_COLORS["baseline"],
                linewidth=2, linestyle="--", marker="o", markersize=5,
                fillstyle="none", label="classic")
        ax.plot(offsets, c[i_rough], color=_SCHEME_COLORS["model"],
                linewidth=2, marker="o", markersize=5, label="learned @ roughest")
        ax.plot(offsets, c[i_smooth], color=_SCHEME_COLORS["model"],
                linewidth=2, linestyle=":", marker="o", markersize=5,
                fillstyle="none", label="learned @ smoothest")
        ax.axhline(0.0, color=_AXIS, linewidth=0.8)
        ax.set_xlabel("stencil offset (grid units)")
        ax.set_ylabel(f"coefficient · dx^{d}")
        _style_axes(ax)
        ax.legend(frameon=False, labelcolor=_INK, fontsize=8)

    fig.tight_layout()
    p = os.path.join(output_dir, "coefficients.png")
    fig.savefig(p, dpi=dpi, facecolor=_SURFACE)
    plt.close(fig)
    return p


def make_sweep_figures(records: list, output_dir: str, dpi: int = 150) -> list:
    """The paper's accuracy-vs-coarsening figure from run_sweep JSONL rows.

    Two panels as separate PNGs: final MAE vs resample factor (log-log)
    and median survival time vs factor (log x). A scheme's point is drawn
    hollow when some ensemble members diverged (its MAE is then over the
    survivors only); a fully-diverged row has no MAE point but still has
    a survival point (survival of a dead member is its blowup time).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    names = sorted(
        {k[: -len("_mae")] for r in records for k in r if k.endswith("_mae")}
    )
    factors = sorted({int(r["factor"]) for r in records})
    by_factor = {int(r["factor"]): r for r in records}
    paths = []
    specs = [
        ("sweep_mae.png", "_mae", "final MAE vs exact (survivors)", True),
        ("sweep_survival.png", "_survival_median",
         "median survival time", False),
    ]
    for fname, suffix, ylabel, logy in specs:
        fig, ax = plt.subplots(figsize=(6, 3.6), facecolor=_SURFACE)
        for i, name in enumerate(names):
            color = _color(name, i)
            xs, ys, hollow = [], [], []
            for f in factors:
                r = by_factor[f]
                v = r.get(name + suffix)
                if v is None:
                    continue
                xs.append(f)
                ys.append(v)
                hollow.append(bool(r.get(name + "_diverged")))
            if not xs:
                continue
            ax.plot(xs, ys, color=color, linewidth=2, label=name, zorder=2)
            for x, y, h in zip(xs, ys, hollow):
                ax.plot([x], [y], marker="o", markersize=6, color=color,
                        fillstyle="none" if h else "full", zorder=3)
        ax.set_xscale("log", base=2)
        ax.set_xticks(factors)
        ax.set_xticklabels([f"{f}x" for f in factors])
        if logy:
            ax.set_yscale("log")
        ax.set_xlabel("resample factor (coarsening)")
        ax.set_ylabel(ylabel)
        _style_axes(ax)
        ax.legend(frameon=False, labelcolor=_INK)
        fig.tight_layout()
        p = os.path.join(output_dir, fname)
        fig.savefig(p, dpi=dpi, facecolor=_SURFACE)
        plt.close(fig)
        paths.append(p)
    return paths


def main(argv=None) -> list:
    """Write the figures (and print the report); returns their paths."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.input_path) == bool(args.sweep_jsonl):
        parser.error("pass exactly one of --input_path / --sweep_jsonl")
    if args.sweep_jsonl:
        with open(args.sweep_jsonl) as f:
            records = [json.loads(line) for line in f if line.strip()]
        paths = make_sweep_figures(records, args.output_dir, dpi=args.dpi)
        for p in paths:
            print("wrote", p)
        return paths
    result = analysis.load_eval_h5(args.input_path)
    print(analysis.report(result))
    paths = make_figures(
        result,
        args.output_dir,
        period=args.period,
        sample=args.sample,
        dpi=args.dpi,
        spacetime_window=args.spacetime_window,
    )
    if args.checkpoint_dir:
        model, params, _ = convert.load_checkpoint(args.checkpoint_dir, device="cpu")
        traj = _numpy(result.trajectories.get("model", result.exact))[args.sample]
        t_idx = args.coeff_time_index
        if t_idx < 0:
            t_idx = traj.shape[0] // 2
        u = traj[t_idx]
        if traj.shape[-1] != model.grid.size:
            raise ValueError(
                f"evaluation grid ({traj.shape[-1]} points) does not match "
                f"the checkpoint's ({model.grid.size})"
            )
        if not np.isfinite(u).all():
            # a diverged member: fall back to the exact trajectory's state
            u = _numpy(result.exact)[args.sample, t_idx]
        paths.append(
            make_coefficients_figure(model, params, u, args.output_dir, dpi=args.dpi)
        )
    for p in paths:
        print("wrote", p)
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
