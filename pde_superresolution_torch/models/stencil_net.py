"""The learned-discretization model: conv net -> constrained stencils -> RHS.

Forward chain:

    u (coarse, [batch, nx])
    -> conv tower (periodic)                       [batch, filters, nx]
    -> per-derivative heads z_d                    [batch, nx, free_dims]
    -> PolynomialAccuracy: c_d = c0 + scale(z@N)   [batch, nx, stencil]
    -> apply_stencil(u, c_d)                       [batch, nx]  per order d
    -> equation.time_derivative                    u_t [batch, nx]

For conservative equations the "derivatives" are face reconstructions
(staggered stencils, index j = right face x_{j+1/2}) and the RHS is the
conservative flux divergence. The constraint layers are biased at the
classic stencils and the heads are zero-initialized, so an untrained model
is the polynomial baseline.

``params`` is the port's state dict (``conv_net.ConvTower`` names); the
model applies it with ``torch.func.functional_call``, so the forward
functions stay pure in their parameters, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call, jvp

from pde_superresolution_torch import stencils
from pde_superresolution_torch.device import resolve_device
from pde_superresolution_torch.equations import Equation, ForcingParams, forcing_term
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.models import conv_net
from pde_superresolution_torch.ops import fused_kernels
from pde_superresolution_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (the JSON ``model`` block of a checkpoint)."""

    num_layers: int = 3
    filters: int = 32
    kernel_size: int = 5
    stencil_size: int = 7  # taps per derivative (even sizes for staggered)
    polynomial_accuracy_order: int = 2
    polynomial_accuracy_scale: float = 1.0  # multiplier on the default scale
    # False: coefficients = classic + raw net output (no constraint layer)
    constrained: bool = True
    # compute dtype of the tower activations ("float32" | "bfloat16"); the
    # parameters stay float32 and the head outputs are cast back before the
    # full-precision constraint projection
    tower_dtype: str = "float32"

    def tower(self) -> conv_net.ConvTowerConfig:
        return conv_net.ConvTowerConfig(
            num_layers=self.num_layers,
            filters=self.filters,
            kernel_size=self.kernel_size,
        )


class StencilModel:
    """A learned discretization bound to (equation, coarse grid, config, device).

    ``device`` defaults to ``cuda`` and raises if no card is present;
    ``device="cpu"`` runs every function through plain PyTorch.

    Precision on the card: building a CUDA model sets
    ``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (process-wide), so the
    eager tower's convolutions and the constraint projection run in full
    float32, as the JAX package's CPU reference does. cuDNN would otherwise
    run float32 convolutions in TF32 (about three decimal digits).
    """

    def __init__(
        self,
        equation: Equation,
        grid: Grid,
        config: ModelConfig = ModelConfig(),
        device=None,
    ):
        self.equation = equation
        self.grid = grid
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        staggered = equation.conservative
        method = (
            stencils.Method.FINITE_VOLUMES
            if staggered
            else stencils.Method.FINITE_DIFFERENCES
        )
        self._shift = -0.5 if staggered else 0.0
        self.constraint_layers: dict[int, object] = {}
        for d in equation.derivative_orders:
            offsets, classic = stencils.classic_stencil(
                d, staggered, grid.dx, size=config.stencil_size
            )
            if config.constrained and config.polynomial_accuracy_order > 0:
                # the bias must satisfy the grid-unit constraint system
                classic_grid = classic * grid.dx**d
                layer = stencils.PolynomialAccuracy.create(
                    offsets,
                    method,
                    d,
                    config.polynomial_accuracy_order,
                    dx=grid.dx,
                    bias=classic_grid,
                )
                if config.polynomial_accuracy_scale != 1.0:
                    layer = dataclasses.replace(
                        layer, scale=layer.scale * config.polynomial_accuracy_scale
                    )
            else:
                layer = stencils.FixedCoefficients(
                    offsets=tuple(offsets.tolist()),
                    derivative_order=d,
                    c0=classic,
                    scale=config.polynomial_accuracy_scale / grid.dx**d,
                )
            self.constraint_layers[d] = layer
        self.taps = {
            d: stencils.int_taps(layer.offsets, self._shift)
            for d, layer in self.constraint_layers.items()
        }
        self._head_dims = {
            str(d): layer.free_dims for d, layer in self.constraint_layers.items()
        }
        # parameter-less template for functional_call: every forward call
        # supplies all of its tensors from ``params``
        self._tower = conv_net.ConvTower(
            config.tower(), self._head_dims, device="meta"
        )

    # -- params ---------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Fresh parameters (He-normal tower, zero heads) on the model's device."""
        tower = conv_net.ConvTower(self.config.tower(), self._head_dims)
        tower.reset_parameters(generator)
        return {
            k: v.detach().to(self.device) for k, v in tower.state_dict().items()
        }

    # -- forward --------------------------------------------------------------
    def coefficients(
        self, params: Mapping[str, torch.Tensor], u: torch.Tensor,
        periodic: bool = True,
    ) -> dict[int, torch.Tensor]:
        """Predicted constrained coefficients, ``{order: [..., nx, stencil]}``.

        ``periodic=False`` runs the tower VALID on a halo-padded ``u``
        (``parallel/sharded.py``): ``2 * receptive_radius`` fewer points.
        The tower computes in ``config.tower_dtype`` either way."""
        dtype = (
            None
            if self.config.tower_dtype == "float32"
            else getattr(torch, self.config.tower_dtype)
        )
        with profiling.span(profiling.TOWER):
            zs = functional_call(
                self._tower, dict(params), (u,), {"dtype": dtype, "periodic": periodic},
                strict=True,
            )
        with profiling.span(profiling.PROJECTION):
            return {
                d: layer(zs[str(d)]) for d, layer in self.constraint_layers.items()
            }

    def derivatives(
        self, params: Mapping[str, torch.Tensor], u: torch.Tensor
    ) -> dict[int, torch.Tensor]:
        """Predicted spatial derivatives (or face reconstructions)."""
        coeffs = self.coefficients(params, u)
        return {
            d: stencils.apply_stencil(
                u, coeffs[d], self.constraint_layers[d].offsets, self._shift
            )
            for d in coeffs
        }

    def baseline_derivatives(self, u: torch.Tensor) -> dict[int, torch.Tensor]:
        """The same stencil layout with the classic coefficients (z = 0)."""
        out = {}
        for d, layer in self.constraint_layers.items():
            c0 = torch.as_tensor(layer.c0, dtype=u.dtype, device=u.device)
            out[d] = stencils.apply_stencil(u, c0, layer.offsets, self._shift)
        return out

    def time_derivative(
        self,
        params: Mapping[str, torch.Tensor],
        u: torch.Tensor,
        t=0.0,
        forcing: Optional[ForcingParams] = None,
    ) -> torch.Tensor:
        derivs = self.derivatives(params, u)
        return self.equation.time_derivative(u, derivs, self.grid, t, forcing)

    def linear_stability_bound(self) -> float:
        """Exact explicit-RK4 stability limit of the z=0 (classic) scheme's
        linear part on this grid.

        The scheme is shift-invariant on a periodic grid, so its
        linearization at u=0 is circulant: one jvp with a unit impulse gives
        the first column, whose FFT is the full eigenvalue set. The bound is
        the largest dt with |R(dt lam)| <= max(1, |exp(dt lam)|) for every
        eigenvalue (R = the RK4 amplification polynomial; the max with
        |exp| exempts physically unstable modes such as KS's k^2 - k^4
        band).
        """
        if getattr(self, "_linear_bound", None) is not None:
            return self._linear_bound
        nx = self.grid.size

        def f(u):
            derivs = self.baseline_derivatives(u[None])
            return self.equation.time_derivative(
                u[None], derivs, self.grid, 0.0, None
            )[0]

        e0 = torch.zeros(nx, dtype=torch.float32, device=self.device)
        e0[0] = 1.0
        _, col = jvp(f, (torch.zeros_like(e0),), (e0,))
        lam = np.fft.fft(col.cpu().numpy().astype(np.float64))

        def rk4_amp(z):
            return np.abs(1 + z + z**2 / 2 + z**3 / 6 + z**4 / 24)

        def stable(dt):
            z = dt * lam
            cap = np.maximum(1.0, np.abs(np.exp(z)))
            return bool((rk4_amp(z) <= cap + 1e-9).all())

        lo, hi = 1e-9, 1e3
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if stable(mid):
                lo = mid
            else:
                hi = mid
        self._linear_bound = float(lo)
        return self._linear_bound

    def stable_time_step(self, u_scale: float = 2.0, safety: float = 0.82) -> float:
        """Stable explicit-RK4 step for this model's stencil widths:
        ``min(equation bound, safety * exact linear bound)``. Wider stencils
        have larger spectral radii than the equation-level bound assumes;
        ``safety=0.82`` leaves stencils up to 8 taps at the equation's dt."""
        eq_dt = self.equation.stable_time_step(self.grid, u_scale=u_scale)
        return min(eq_dt, safety * self.linear_stability_bound())

    def rhs_fn(
        self,
        params: Mapping[str, torch.Tensor],
        forcing: Optional[ForcingParams] = None,
        use_kernel: Optional[bool] = None,
    ):
        """``(u, t) -> u_t`` closure for ``integrate.integrate``.

        Args:
          use_kernel: compute the coefficients in PyTorch, then fuse the
            stencil apply, flux divergence and forcing add into one
            ``fused_kernels.fused_rhs`` launch (its plain version for CPU
            tensors). Default (None): True on a CUDA model. False runs
            ``time_derivative`` (apply_stencil + Equation) instead. Both
            routes are differentiable (the kernel's backward is its plain
            version's), and both take a per-sample time ``t [B]`` with
            per-sample forcing (leaves ``[B, terms]``), as training does;
            ``training.losses.compute_loss`` passes False unless asked, as
            the JAX package's does.
        """
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        if not use_kernel:

            def rhs(u, t):
                return self.time_derivative(params, u, t, forcing)

            rhs.conservative = self.equation.conservative
            return rhs

        x = torch.as_tensor(self.grid.x, dtype=torch.float32, device=self.device)
        width = self.grid.dx if self.equation.conservative else None

        def rhs(u, t):
            nx = u.shape[-1]
            coeffs = self.coefficients(params, u)
            f = None
            if forcing is not None:
                with profiling.span(profiling.FORCING):
                    f = forcing_term(forcing, x, t, self.equation.period, width)
                    f = f.expand(u.shape).reshape(-1, nx).contiguous()
            u_t = fused_kernels.fused_rhs(
                u.reshape(-1, nx),
                {d: c.reshape(-1, nx, c.shape[-1]) for d, c in coeffs.items()},
                f,
                self.equation,
                self.grid,
                self.taps,
            )
            return u_t.reshape(u.shape)

        rhs.conservative = self.equation.conservative
        return rhs

    def fused_rk4_fn(
        self,
        params: Mapping[str, torch.Tensor],
        dt: float,
        num_steps: int,
        forcing: Optional[ForcingParams] = None,
        t0: float = 0.0,
        mesh=None,
    ):
        """``num_steps`` RK4 steps of the learned model in one
        ``fused_kernels.fused_learned_rk4`` launch: conv tower, constraint
        projection, stencil apply, flux divergence and all four stages stay
        on chip. The tower's matmul inputs are rounded to bf16 (float32
        sums), as in the JAX kernel, so agreement with ``rhs_fn`` +
        ``integrate.rk4_step`` is to bf16 tolerance.

        A forced equation (Burgers) passes its per-trajectory ``forcing``
        and the start time ``t0``; the kernel advances the sinusoids' phases
        by planar rotation, with no transcendental per stage. Forcing for an
        unforced equation raises at the call, as in the JAX package.

        Returns ``advance(u [batch, nx], t=None) -> u``: ``t`` is the start
        time of the call (default ``t0``), so ``integrate_fused`` can hand
        each save interval its own.

        ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with a ``"data"``
        axis) composes the kernel with data parallelism: each rank passes
        its own rows of the batch, ``[batch / data, nx]``, and launches the
        kernel on them with the params replicated and its rows of the global
        ``forcing``; nothing is communicated. Any other mesh axis must have
        size 1: the kernel needs the whole grid.
        """
        if self.equation.forced and forcing is None:
            raise ValueError(
                f"{self.equation.name} is forced: pass forcing params"
            )
        if mesh is not None:
            from pde_superresolution_torch.parallel.sharded import Shard

            self._check_data_mesh(mesh)
            forcing = Shard(mesh, self.grid.size).forcing_rows(forcing)
        pack = fused_kernels.pack_learned_rk4(
            params,
            self.equation,
            self.grid,
            self.config.kernel_size,
            self.constraint_layers,
            self.taps,
        )

        def advance(u: torch.Tensor, t=None) -> torch.Tensor:
            """Advance ``num_steps`` RK4 steps from time ``t`` (default: the
            ``t0`` this closure was built with); the forcing's phase state
            is rebuilt from ``t`` at every call."""
            return fused_kernels.fused_learned_rk4(
                u, pack, dt, num_steps, forcing=forcing,
                t=t0 if t is None else t,
            )

        advance.pack = pack
        return advance

    @staticmethod
    def _check_data_mesh(mesh) -> None:
        """Refuse a mesh the fused kernel cannot shard over."""
        from pde_superresolution_torch.parallel.mesh import DATA_AXIS

        names = tuple(mesh.mesh_dim_names or ())
        if DATA_AXIS not in names:
            raise ValueError(f"mesh axes {names} lack a '{DATA_AXIS}' axis")
        other = {ax: mesh.size(i) for i, ax in enumerate(names)
                 if ax != DATA_AXIS and mesh.size(i) > 1}
        if other:
            raise ValueError(
                "fused-kernel DP shards the trajectory batch only; mesh "
                f"axes {other} must have size 1 (the kernel needs the whole "
                "grid in one shard)")
