"""Serving export: freeze a trained model into a standalone ``torch.export``
artifact.

The counterpart of ``pde_superresolution_tpu/export.py``. The model's RHS
(and optionally a ``num_steps`` RK4 advance) is traced once with
``torch.export`` and written to disk; ``ServedModel`` loads and calls it
with nothing but ``torch``: no ``StencilModel``, no checkpoint, no stencil
code and no kernel library.

* The plain route is traced (``rhs_fn(use_kernel=False)``), as the JAX
  package exports its XLA path and not its Pallas kernel: the artifact then
  needs no kernel library to load, and runs on the CPU and on a CUDA card.
* The trace runs on the CPU, on a model of its own: the caller's model is
  not touched. The batch dimension is symbolic (``torch.export.Dim``), so
  one artifact serves any ensemble size; the grid size is baked in. The
  time ``t`` is a 0-d tensor; a forced equation's forcing comes as four
  ``[b, num_terms]`` arguments, so one artifact serves any draw.
* The ``num_steps`` advance is the RK4 loop unrolled in the graph (a
  ``num_steps`` of 16 traces in about 15 s on a CPU and writes a few MB).
* ``ServedModel`` moves a program to its device with
  ``torch.export.passes.move_to_device_pass`` and checks that no tensor or
  device argument was left behind. On CUDA it sets the same TF32 pins as
  ``StencilModel``: they are process state, not part of the graph.

Layout of an artifact directory::

    meta.json  # physics, geometry and calling convention, versioned
    rhs.pt2    # (u[b,nx], t[]) [, 4x forcing[b,m]] -> u_t[b,nx]
    step.pt2   # optional: the same signature -> u after num_steps RK4 steps
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from pde_superresolution_torch import equations, integrate
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import ForcingParams
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import StencilModel

FORMAT_VERSION = 1
DEFAULT_PLATFORMS = ("cpu", "cuda")
# the device types a torch.export program can be loaded on here
SUPPORTED_PLATFORMS = frozenset(DEFAULT_PLATFORMS)

_RHS_FILE = "rhs.pt2"
_STEP_FILE = "step.pt2"
_META_FILE = "meta.json"
_FORCING_ARGS = ForcingParams._fields  # amplitude, omega, k, phi


def check_platforms(platforms) -> list:
    """``platforms`` as a list, or ``ValueError`` unless it is a non-empty
    subset of ``SUPPORTED_PLATFORMS``."""
    platforms = [platforms] if isinstance(platforms, str) else list(platforms)
    unknown = sorted(set(platforms) - SUPPORTED_PLATFORMS)
    if "tpu" in unknown:
        raise ValueError("platform 'tpu': a torch.export artifact has no TPU lowering; "
                         f"choose from {sorted(SUPPORTED_PLATFORMS)}")
    if unknown or not platforms:
        raise ValueError(f"platforms {platforms}: choose a non-empty subset of "
                         f"{sorted(SUPPORTED_PLATFORMS)}")
    return platforms


class _Frozen(torch.nn.Module):
    """One function of a trained model, ``fn(params, u, t, forcing)``, with
    the parameters held as buffers: the module ``torch.export`` traces."""

    def __init__(self, params, fn):
        super().__init__()
        self._names = list(params)
        for i, name in enumerate(self._names):
            self.register_buffer(f"param{i}", params[name])
        self._fn = fn

    def forward(self, u, t, amplitude=None, omega=None, k=None, phi=None):
        params = {name: getattr(self, f"param{i}") for i, name in enumerate(self._names)}
        forcing = None if amplitude is None else ForcingParams(amplitude, omega, k, phi)
        return self._fn(params, u, t, forcing)


def export_model(
    model: StencilModel,
    params,
    *,
    dt: Optional[float] = None,
    num_steps: int = 0,
    platforms=DEFAULT_PLATFORMS,
    fine_size: Optional[int] = None,
    resample_factor: Optional[int] = None,
    extra_meta: Optional[dict] = None,
):
    """Trace a trained ``StencilModel`` into ``torch.export`` programs.

    Args:
      model: a ``models.StencilModel`` on any device (grid- and
        equation-bound); a CPU model of the same configuration is traced.
      params: its trained parameters.
      dt: RK4 step of the ``num_steps`` advance; ``None`` uses the
        model-aware stable step (``StencilModel.stable_time_step``,
        u_scale=3), which is also recorded as ``meta["stable_dt"]`` for
        the science CLIs.
      num_steps: if > 0, also export an advance of ``num_steps`` RK4 steps
        of ``dt`` in one call.
      fine_size, resample_factor: the fine grid the model was trained
        against and the coarsening factor. The graph does not need them;
        ``science_context`` (``run_evaluation``/``run_ensemble
        --exported_dir``) does.
      extra_meta: more keys for ``meta.json`` (provenance).

    Returns:
      (meta, exported): the JSON-able metadata and ``{"rhs": program}``
      (and ``"step"`` if asked), ``torch.export.ExportedProgram``s on the
      CPU.
    """
    platforms = check_platforms(platforms)
    equation, grid = model.equation, model.grid
    forced = equation.forced
    m = equation.num_forcing_terms if forced else 0
    stable_dt = float(model.stable_time_step(u_scale=3.0))
    if num_steps and dt is None:
        dt = stable_dt

    traced = StencilModel(equation, grid, model.config, device="cpu")
    cpu_params = {k: v.detach().to("cpu", torch.float32).clone() for k, v in params.items()}

    def rhs(p, u, t, forcing):
        return traced.rhs_fn(p, forcing, use_kernel=False)(u, t)

    def step(p, u, t, forcing):
        rhs_fn = traced.rhs_fn(p, forcing, use_kernel=False)
        for _ in range(num_steps):
            u = integrate.rk4_step(rhs_fn, u, t, dt)
            t = t + dt
        return u

    batch = torch.export.Dim("b", min=1)
    example = (torch.zeros(2, grid.size), torch.tensor(0.0))
    shapes = {"u": {0: batch}, "t": None}
    if forced:
        example += tuple(torch.zeros(2, m) for _ in _FORCING_ARGS)
        shapes.update({name: {0: batch} for name in _FORCING_ARGS})

    # one eager call fills the traced model's constant caches, so the graph
    # holds each stencil constant once instead of once per RHS
    traced.rhs_fn(cpu_params, None if not forced else ForcingParams(*example[2:]),
                  use_kernel=False)(example[0], example[1])

    def trace(fn):
        return torch.export.export(_Frozen(cpu_params, fn), example,
                                   dynamic_shapes=shapes, strict=False)

    exported = {"rhs": trace(rhs)}
    if num_steps:
        exported["step"] = trace(step)

    meta = {
        "format_version": FORMAT_VERSION,
        "equation": equation.name,
        "conservative": bool(equation.conservative),
        # every equation field, so science_context rebuilds the physics the
        # model was trained on ('conservative' is stored above)
        "equation_params": equations.params_dict(equation),
        "forced": bool(forced),
        "num_forcing_terms": int(m),
        "period": float(grid.period),
        "nx": int(grid.size),
        "dx": float(grid.dx),
        "platforms": platforms,
        "dt": float(dt) if num_steps else None,
        "num_steps": int(num_steps),
        # consumers of the frozen rhs integrate at this step, not the
        # equation's: for wide stencils the equation's bound is unstable
        "stable_dt": stable_dt,
        "stencil_size": int(model.config.stencil_size),
        "fine_size": int(fine_size) if fine_size else None,
        "resample_factor": int(resample_factor) if resample_factor else None,
    }
    if extra_meta:
        meta.update(extra_meta)
    return meta, exported


def save_exported_model(path: str, meta: dict, exported: dict) -> None:
    """Write an artifact directory (meta.json and one file per program)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    files = {"rhs": _RHS_FILE, "step": _STEP_FILE}
    for name, program in exported.items():
        torch.export.save(program, os.path.join(path, files[name]))


def export_and_save(model: StencilModel, params, path: str, **kwargs) -> dict:
    """``export_model`` + ``save_exported_model``; returns the metadata."""
    meta, exported = export_model(model, params, **kwargs)
    save_exported_model(path, meta, exported)
    return meta


def _devices_in(node) -> list:
    """The devices a graph node names: its ``device`` keyword and any
    ``torch.device`` among its positional arguments."""
    named = [a for a in node.args if isinstance(a, torch.device)]
    if node.kwargs.get("device") is not None:
        named.append(torch.device(node.kwargs["device"]))
    return named


def _load_program(path: str, device: torch.device):
    """The program at ``path`` on ``device``, as a callable module; raises
    if a tensor or a device argument of the graph is elsewhere."""
    program = torch.export.load(path)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    left = [name for name, tensor in (*program.state_dict.items(), *program.constants.items())
            if isinstance(tensor, torch.Tensor) and tensor.device.type != device.type]
    for node in program.graph.nodes:
        placed = [d for d in _devices_in(node) if d.type != device.type]
        if placed:
            left.append(f"{node.name} ({placed[0]})")
    if left:
        raise RuntimeError(f"{path}: not moved to {device}: {', '.join(left[:5])}")
    return program.module()


class ServedModel:
    """A frozen model loaded from an export directory onto ``device``
    (``cuda`` unless told otherwise, via ``device.resolve_device``).

    It needs no model code, checkpoint or config. ``rhs_fn(forcing)``
    follows the differentiator protocol (``.conservative`` included), so a
    served model plugs into ``integrate.integrate`` and
    ``evaluate.evaluate``.
    """

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(path, _META_FILE)) as f:
            self.meta = json.load(f)
        if self.meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.meta['format_version']} is newer "
                f"than this library supports ({FORMAT_VERSION})"
            )
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"{path} was exported for {self.meta['platforms']}, not for "
                f"{self.device.type}: export it again with that platform"
            )
        if self.device.type == "cuda":
            # the live model's precision (StencilModel): cuDNN would run the
            # graph's float32 convolutions in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._rhs = _load_program(os.path.join(path, _RHS_FILE), self.device)
        step_path = os.path.join(path, _STEP_FILE)
        self._step = (_load_program(step_path, self.device)
                      if os.path.exists(step_path) else None)

    @property
    def conservative(self) -> bool:
        return self.meta["conservative"]

    @property
    def nx(self) -> int:
        return self.meta["nx"]

    def _prepare(self, u, forcing):
        """Flatten leading dims to one batch axis; check and broadcast the
        forcing."""
        u = torch.as_tensor(u, dtype=torch.float32, device=self.device)
        if u.shape[-1] != self.nx:
            raise ValueError(
                f"u has {u.shape[-1]} grid points; artifact expects {self.nx}"
            )
        lead = tuple(u.shape[:-1])
        args = []
        if self.meta["forced"]:
            if forcing is None:
                raise ValueError(
                    f"artifact for forced equation {self.meta['equation']!r} "
                    "requires forcing parameters"
                )
            m = self.meta["num_forcing_terms"]
            for leaf in forcing:
                leaf = torch.as_tensor(leaf, dtype=torch.float32, device=self.device)
                if leaf.shape[-1] != m:
                    raise ValueError(
                        f"forcing has {leaf.shape[-1]} terms; artifact expects {m}"
                    )
                args.append(leaf.expand(lead + (m,)).reshape(-1, m))
        elif forcing is not None:
            raise ValueError(
                f"artifact for unforced equation {self.meta['equation']!r} "
                "does not take forcing"
            )
        return u.reshape(-1, self.nx), lead, args

    def rhs_fn(self, forcing: Optional[ForcingParams] = None):
        """``(u, t) -> u_t`` over the frozen graph. Any leading batch shape
        is flattened to the artifact's symbolic batch and restored; forcing
        without a batch broadcasts against it."""

        def rhs(u, t):
            u2, lead, args = self._prepare(u, forcing)
            t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
            return self._rhs(u2, t, *args).reshape(lead + (self.nx,))

        rhs.conservative = self.conservative
        return rhs

    def advance(self, u, t, forcing: Optional[ForcingParams] = None):
        """Advance ``u`` by the artifact's ``num_steps`` RK4 steps of ``dt``.

        Returns ``(u_next, t + dt * num_steps)``. Raises if the artifact
        was exported without a step function.
        """
        if self._step is None:
            raise ValueError("artifact was exported without a step function")
        u2, lead, args = self._prepare(u, forcing)
        t_in = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        out = self._step(u2, t_in, *args)
        return out.reshape(lead + (self.nx,)), t + self.meta["dt"] * self.meta["num_steps"]


def load_served_model(path: str, device=None) -> ServedModel:
    return ServedModel(path, device)


def science_context(meta: dict):
    """Rebuild ``(equation, fine_grid, coarse_grid)`` from artifact metadata.

    The science pipeline around a frozen graph (initial conditions, warm-up
    solves, CFL steps, evaluation) needs the equation and the exact grids
    the model was trained on, including the half-cell origin of a
    conservative coarse grid: the coarse grid is rebuilt by resampling the
    fine one, not from ``nx``/``dx``.
    """
    if not meta.get("fine_size") or not meta.get("resample_factor"):
        raise ValueError(
            "artifact metadata lacks fine_size/resample_factor: it was "
            "exported without the science-pipeline keys (export_model's "
            "fine_size=/resample_factor= arguments, which run_export fills "
            "from the checkpoint config). The frozen graph can still be "
            "integrated via ServedModel.rhs_fn/advance, but the evaluation "
            "CLIs need the fine-grid geometry to build exact references."
        )
    equation = equations.from_name(
        meta["equation"], conservative=meta["conservative"],
        **meta.get("equation_params", {}),
    )
    fine = Grid(meta["fine_size"], equation.period)
    coarse = fine.resample(meta["resample_factor"], conservative=equation.conservative)
    if coarse.size != meta["nx"]:
        raise ValueError(
            f"inconsistent artifact metadata: fine_size/resample_factor give "
            f"{coarse.size} coarse points but nx is {meta['nx']}"
        )
    return equation, fine, coarse
