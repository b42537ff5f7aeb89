"""Hand-written CUDA kernels for the stencil hot loop, with their plain twins.

The counterpart of ``pde_superresolution_tpu/ops/pallas_kernels.py``:

  * ``fused_rhs`` (``csrc/fused_rhs.cu``, replaces ``make_fused_rhs``): one
    RHS evaluation from precomputed per-point coefficients: tap sums against
    periodic shifts of ``u`` for each order, then the flux divergence or the
    equation of motion, plus an optional forcing field.
  * ``fused_learned_rk4`` (``csrc/fused_learned_rk4.cu``, replaces
    ``make_fused_learned_rk4``): ``num_steps`` whole RK4 steps of the learned
    model in one launch (tower, heads, constraint projection, stencil, flux,
    all four stages). The tower and the heads run on the tensor cores
    (``wgmma`` and ``mma.sync`` on bf16, float32 sums); a warp group owns a
    trajectory and a block holds up to four of them. For a forced equation
    (Burgers) the sum-of-sinusoids forcing is evaluated in the kernel from a
    ``ForcingPack``: per-term (sin, cos) phase state advanced by a planar
    rotation per half step.
  * ``fused_rk4`` (``csrc/fused_rk4.cu``, built by ``make_fused_rk4``,
    replaces ``make_fused_rk4``): ``num_steps`` RK4 steps of the fixed
    classic-stencil baseline scheme, unforced equations only; a warp owns a
    trajectory and holds it in registers; the tap loops are unrolled, each
    coefficient a kernel parameter read by its multiply.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. It takes its plain PyTorch version (``*_plain``, in this
module) only for CPU tensors; for CUDA tensors it launches its kernel or
raises. Each keeps a launch count, ``<wrapper>.launches``, a plain integer
that grows by one per kernel launch (a forward re-run by activation
checkpointing launches, and counts, again). Each hands its kernel's output
to ``utils.debugging.check_output``, so ``debugging.checked`` and
``debug_nans`` see the kernels, which no dispatch mode does.

``fused_rhs`` is differentiable, as the JAX package's ``custom_vjp`` makes
its kernel: the forward is the kernel (or its plain version on the CPU), the
backward the plain version's vector-Jacobian product at the same inputs
(``fused_rhs_vjp``), so the unrolled training loss can run through it.
``fused_learned_rk4`` and ``fused_rk4`` are forward only, as in JAX: an input
that requires grad raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from pde_superresolution_torch import stencils
from pde_superresolution_torch.equations import Equation, ForcingParams
from pde_superresolution_torch.grids import Grid
from pde_superresolution_torch.utils import debugging

EQUATION_CODES = {"burgers": 0, "kdv": 1, "ks": 2}
MAX_ORDERS = 3
# fused_learned_rk4.cu's compile-time limits (kMaxLayers, kMaxTeams,
# kMaxTeamWarps) and the tower widths it is instantiated for
MAX_LAYERS = 16
MAX_TEAMS = 4  # trajectories per block
MAX_TEAMS_FORCED = 4  # the same for a forced equation (kMaxTeamsForced)
TEAM_THREADS = 128  # one warp group owns a trajectory (kTeamThreads)
U_HALO = 8  # periodic copies at both ends of the state in shared memory (kHalo)
PADDED_CHANNELS = (16, 32, 64)
MAX_SHARED_BYTES = 232448  # opt-in shared memory per block on sm_90
NUM_SMS = 132  # H100: a launch should have at least this many blocks
# fused_rhs.cu's block: one thread per point, at most RHS_BLOCK_POINTS of
# them unless one trajectory is longer, dynamic shared memory under the
# 48 KB that needs no opt-in. On an H100 one trajectory of 128 points per
# block was 10-14% faster than four for the KS-8x checkpoint's coefficients
# at B=4096 and 10240, and 4-9% slower for the Burgers-8x checkpoint's.
RHS_SHARED_BYTES = 49152
RHS_BLOCK_POINTS = 128
MAX_THREADS = 1024
# fused_rk4.cu's compile-time limits (kMaxTaps, kMaxWarps), the points per
# lane it is built for (nx = 32 P) and the classic schemes it is built for:
# (equation, conservative) -> {order: (first tap, number of taps)}
MAX_TAPS = 16
RK4_MAX_WARPS = 8
RK4_POINTS_PER_LANE = (2, 3, 4, 5, 8, 32)
RK4_LAYOUTS = {
    ("kdv", True): {0: (0, 2), 2: (-1, 4)},
    ("kdv", False): {1: (-1, 3), 3: (-2, 5)},
    ("ks", True): {0: (0, 2), 1: (-1, 4), 3: (-2, 6)},
    ("ks", False): {1: (-1, 3), 2: (-2, 5), 4: (-3, 7)},
}


def _check_forward_only(tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise ValueError(
            "fused_learned_rk4 and fused_rk4 are forward only, as in the JAX "
            "package (only fused_rhs has a backward); pass tensors that do "
            "not require grad"
        )


def _check_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _contiguous_run(taps: Sequence[int]) -> bool:
    return list(taps) == list(range(taps[0], taps[0] + len(taps)))


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on_cuda_error(code: int, what: str) -> None:
    if code != 0:
        from pde_superresolution_torch.ops import _build

        raise RuntimeError(f"{what} failed: {_build.error_string(code)} ({code})")


# ---------------------------------------------------------------------------
# fused RHS
# ---------------------------------------------------------------------------


def fused_rhs_plain(
    u: torch.Tensor,
    coeffs: Mapping[int, torch.Tensor],
    f: Optional[torch.Tensor],
    equation: Equation,
    grid: Grid,
    taps: Mapping[int, Sequence[int]],
) -> torch.Tensor:
    """``fused_rhs`` in plain PyTorch: ``apply_stencil`` + ``time_derivative``."""
    from pde_superresolution_torch.stencils import apply_stencil

    derivs = {d: apply_stencil(u, coeffs[d], taps[d]) for d in sorted(taps)}
    u_t = equation.time_derivative(u, derivs, grid)
    if f is not None:
        u_t = u_t + f
    return u_t


class RhsLaunch(NamedTuple):
    """Geometry of one ``fused_rhs`` launch (``csrc/fused_rhs.cu``)."""

    rows: int  # trajectories per block (1 when a trajectory is split)
    seg: int  # points of a trajectory per block: nx, or a segment of it
    parts: int  # blocks per trajectory
    halo: int  # periodic points on each side of a row's u window
    threads_x: int  # threads along the points (>= seg); rows along y
    shared_bytes: int
    blocks: int


def _rhs_shared_bytes(rows: int, seg: int, halo: int, sizes: Sequence[int]) -> int:
    """u windows [rows][seg + 2 halo] and fluxes [rows][1 + seg], then per
    order the coefficients [rows seg][S] as they lie in device memory, each
    block of floats starting on 16 bytes (fused_rhs.cu's layout)."""
    return 4 * (_align4(rows * (seg + 2 * halo + seg + 1))
                + sum(_align4(rows * seg * size) for size in sizes))


def rhs_launch(batch: int, nx: int, taps: Mapping[int, Sequence[int]]) -> RhsLaunch:
    """The launch of ``fused_rhs`` for ``batch`` trajectories of ``nx``
    points and the orders' ``taps``. A block holds whole trajectories, one
    thread per point: as many as keep the launch at ``NUM_SMS`` blocks or
    more, up to ``RHS_BLOCK_POINTS`` points (at least one trajectory),
    within ``MAX_THREADS`` threads and ``RHS_SHARED_BYTES``. Where one
    trajectory does not fit, it is split into segments of a multiple of 32
    points, one block each."""
    sizes = [len(t) for t in taps.values()]
    lo = min(t[0] for t in taps.values())
    hi = max(t[-1] for t in taps.values())
    halo = max(1 - lo, hi, 0)  # a segment also reads its left neighbour's taps

    def fits(rows, seg):
        return (rows * -(-seg // 32) * 32 <= MAX_THREADS
                and _rhs_shared_bytes(rows, seg, halo, sizes) <= RHS_SHARED_BYTES)

    if fits(1, nx):
        seg = nx
        rows = max(1, min(RHS_BLOCK_POINTS // nx, batch // NUM_SMS))
        while not fits(rows, nx):
            rows -= 1
    else:
        rows = 1
        seg = MAX_THREADS
        while seg > 32 and not fits(1, seg):
            seg -= 32
    parts = -(-nx // seg)
    return RhsLaunch(
        rows=rows, seg=seg, parts=parts, halo=halo, threads_x=-(-seg // 32) * 32,
        shared_bytes=_rhs_shared_bytes(rows, seg, halo, sizes),
        blocks=-(-batch // rows) * parts,
    )


def fused_rhs(
    u: torch.Tensor,
    coeffs: Mapping[int, torch.Tensor],
    f: Optional[torch.Tensor],
    equation: Equation,
    grid: Grid,
    taps: Mapping[int, Sequence[int]],
) -> torch.Tensor:
    """u_t from ``u [B, nx]`` and per-point coefficients.

    Args:
      coeffs: ``{order: [B, nx, S_order]}`` float32, the model's layout.
      f: ``[B, nx]`` forcing field, or None.
      taps: ``{order: integer taps}``; ``out[j]`` reads ``u[(j + t) % nx]``.
    """
    orders = sorted(taps)
    if orders != sorted(equation.derivative_orders) or sorted(coeffs) != orders:
        raise ValueError(
            f"{equation.name} needs orders {sorted(equation.derivative_orders)}; "
            f"got taps for {orders} and coefficients for {sorted(coeffs)}"
        )
    if u.dim() != 2:
        raise ValueError(f"u must be [batch, nx], got shape {tuple(u.shape)}")
    batch, nx = u.shape
    _check_f32("u", u, (batch, nx), u.device)
    for d in orders:
        if not _contiguous_run(taps[d]):
            raise ValueError(f"taps of order {d} are not contiguous: {taps[d]}")
        _check_f32(f"coeffs[{d}]", coeffs[d], (batch, nx, len(taps[d])), u.device)
    if f is not None:
        _check_f32("f", f, (batch, nx), u.device)
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {u.device}")
    static = (equation, grid, {d: taps[d] for d in orders})
    tensors = (u, f, *(coeffs[d] for d in orders))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _FusedRhs.apply(static, *tensors)
    return _fused_rhs_forward(static, *tensors)


fused_rhs.launches = 0


def _fused_rhs_forward(static, u, f, *coeffs) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones;
    ``coeffs`` in the sorted orders of ``static``'s taps."""
    equation, grid, taps = static
    orders = sorted(taps)
    coeffs = dict(zip(orders, coeffs))
    if u.device.type == "cpu":
        return fused_rhs_plain(u, coeffs, f, equation, grid, taps)
    from pde_superresolution_torch.ops import _build

    batch, nx = u.shape
    launch = rhs_launch(batch, nx, taps)
    lib = _build.load_library()
    out = torch.empty_like(u)
    c_ptrs = [coeffs[d].data_ptr() for d in orders] + [0] * (MAX_ORDERS - len(orders))
    meta = (ctypes.c_int * 16)(
        EQUATION_CODES[equation.name],
        int(equation.conservative),
        len(orders),
        *[len(taps[d]) for d in orders], *[0] * (MAX_ORDERS - len(orders)),
        *[taps[d][0] for d in orders], *[0] * (MAX_ORDERS - len(orders)),
        launch.rows, launch.seg, launch.parts, launch.halo, launch.threads_x,
        launch.blocks, launch.shared_bytes,
    )
    code = lib.pde_fused_rhs(
        u.data_ptr(), *c_ptrs, f.data_ptr() if f is not None else None,
        out.data_ptr(), batch, nx, meta, grid.dx,
        float(getattr(equation, "eta", 0.0)), _stream(u.device),
    )
    _raise_on_cuda_error(code, "fused_rhs launch")
    fused_rhs.launches += 1
    debugging.check_output("fused_rhs", out)
    return out


def fused_rhs_vjp(static, inputs, grad_out, needs=None):
    """The backward of ``fused_rhs``: the vector-Jacobian product of
    ``fused_rhs_plain`` at ``inputs = (u, f, *coeffs)`` (``f`` may be None,
    ``coeffs`` in sorted order), as the JAX package's ``rhs_bwd`` linearises
    the kernel's XLA twin at the same primal point. Returns the gradients in
    that order, None where ``needs`` (default: every input given) is false.
    Any float dtype."""
    equation, grid, taps = static
    if needs is None:
        needs = [t is not None for t in inputs]
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs)]
        u, f, *coeffs = leaves
        out = fused_rhs_plain(u, dict(zip(sorted(taps), coeffs)), f, equation, grid, taps)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


class _FusedRhs(torch.autograd.Function):
    """``fused_rhs`` under autograd: the forward launches the kernel (its plain
    version on the CPU) and saves its inputs; the backward is
    ``fused_rhs_vjp`` at them, as the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, static, u, f, *coeffs):
        ctx.static = static
        ctx.save_for_backward(u, f, *coeffs)
        return _fused_rhs_forward(static, u, f, *coeffs)

    @staticmethod
    def backward(ctx, grad_out):
        return (None, *fused_rhs_vjp(ctx.static, ctx.saved_tensors, grad_out,
                                     ctx.needs_input_grad[1:]))


# ---------------------------------------------------------------------------
# fused learned RK4
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back to ``x``'s dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def _pad_to(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x`` in the leading corner of zeros of ``shape``."""
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out[tuple(slice(n) for n in x.shape)] = x
    return out


def _fragment_order(b: torch.Tensor) -> torch.Tensor:
    """``b [depth, n]`` (depth a multiple of 16, n of 8) as bf16 in the order
    ``mma.sync.m16n8k16``'s ``.col`` B operand wants it: for each depth step
    of 16 and each tile of 8 columns, lane ``4 g + q`` holds ``b[2 q + 8 r +
    e, g]`` of that tile at position ``2 r + e``: 8 bytes that one thread
    loads at once, consecutive lanes at consecutive addresses."""
    depth, n = b.shape
    tiles = b.reshape(depth // 16, 2, 4, 2, n // 8, 8)  # step, r, q, e, tile, g
    return tiles.permute(0, 4, 5, 2, 1, 3).reshape(-1).to(torch.bfloat16)


def _wgmma_order(b: torch.Tensor) -> torch.Tensor:
    """``b [depth, n]`` (depth a multiple of 16, n of 8) as bf16 the way
    ``wgmma`` reads its B operand from shared memory without swizzle: per
    depth step of 16, two halves of 8 depth values, each ``[n][8]`` (16 bytes
    a row, 8 rows a core matrix): ``[step][half][n][8]``. The descriptor
    gives 16 n bytes between the halves and 128 between core matrices."""
    depth, n = b.shape
    return b.reshape(depth // 16, 2, 8, n).permute(0, 1, 3, 2).reshape(-1).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class LearnedRK4Pack:
    """The learned model's weights, for the plain version and for the kernel.

    ``flat`` is one float32 buffer of blocks at the model's own width, each
    starting at a multiple of 4 floats; ``offsets`` holds the start of each
    block, in buffer order: per tower layer ``w [K*Cin, C]`` then ``b [C]``,
    then ``head_w [C, F]``, ``head_b [F]``, ``c0 [S]`` and ``pn [S, F]``. The
    properties are views into ``flat`` in the plain version's orientation:
    ``tower[l] = (w [Co, K*Cin], b [Co])`` with the contraction index
    ``k*Cin + ci``, ``head_w [F, C]`` stacking the heads of the sorted
    orders. Tower and head weights hold bf16-rounded values; biases, ``c0``
    and the block-diagonal ``pn`` (scale folded in) are float32.

    ``blob`` is the kernel's buffer (bytes; ``blob_offsets`` the byte offset
    of each block, a multiple of 128, in the same order). The channels are
    zero-padded to ``padded_channels`` (16, 32 or 64) and the free dims to a
    multiple of 8: zero weights and biases add exact zeros. Per layer the
    weights ``w [depth, padded_channels]`` are bf16: layer 0 (depth = the K
    taps padded to 16) in the order of ``mma.m16n8k16``'s B fragments
    (``_fragment_order``), every later layer (depth index ``k *
    padded_channels + ci``) as ``wgmma`` reads it from shared memory
    (``_wgmma_order``); then the float32 bias ``[padded_channels]``. The
    heads are the fragments of ``head_w [padded_channels, padded F]`` and the
    float32 ``head_b [padded F]``. The last block is the projection,
    float32: per order and per block of 8 stencil rows, ``c0 [8]`` then the
    rows' part of ``pn`` transposed, ``[count, 8]``, both zero-padded to 8
    rows. ``free_ranges[i] = (first, count, start)`` are the columns of
    ``pn`` that the i-th order's rows use (the rest of those rows is zero)
    and the float index of the order's first row block in that block.
    """

    equation: Equation
    grid: Grid
    kernel_size: int
    taps: dict
    channels: int
    num_layers: int
    n_free: int
    n_rows: int
    flat: torch.Tensor
    offsets: tuple
    padded_channels: int
    free_ranges: tuple
    blob: torch.Tensor
    blob_offsets: tuple

    def _block(self, i: int, *shape: int) -> torch.Tensor:
        start = self.offsets[i]
        return self.flat[start : start + int(np.prod(shape))].view(*shape)

    @property
    def tower(self) -> tuple:
        k, c = self.kernel_size, self.channels
        return tuple(
            (self._block(2 * l, k * (1 if l == 0 else c), c).t(), self._block(2 * l + 1, c))
            for l in range(self.num_layers)
        )

    @property
    def head_w(self) -> torch.Tensor:
        return self._block(2 * self.num_layers, self.channels, self.n_free).t()

    @property
    def head_b(self) -> torch.Tensor:
        return self._block(2 * self.num_layers + 1, self.n_free)

    @property
    def c0(self) -> torch.Tensor:
        return self._block(2 * self.num_layers + 2, self.n_rows)

    @property
    def pn(self) -> torch.Tensor:
        return self._block(2 * self.num_layers + 3, self.n_rows, self.n_free)


def pack_learned_rk4(
    params: Mapping[str, torch.Tensor],
    equation: Equation,
    grid: Grid,
    kernel_size: int,
    constraint_layers: Mapping[int, object],
    taps: Mapping[int, Sequence[int]],
) -> LearnedRK4Pack:
    """Pack a model's state dict for ``fused_learned_rk4``.

    Raises for what the kernel does not take (as the JAX kernel does): an
    even conv kernel, more than one input channel, or taps that are not
    contiguous.
    """
    if kernel_size % 2 != 1:
        raise ValueError("fused learned RK4 assumes odd conv kernels")
    if params["tower.0.weight"].shape[1] != 1:
        raise ValueError("fused learned RK4 assumes a 1-channel input")
    orders = sorted(taps)
    kh = (kernel_size - 1) // 2
    for d in orders:
        if not _contiguous_run(taps[d]):
            raise ValueError("per-order taps must be contiguous")
    union = sorted(set(range(-kh, kh + 1)).union(*[set(taps[d]) for d in orders]))
    if not _contiguous_run(union):
        raise ValueError(f"tap union {union} is not contiguous")

    with torch.no_grad():
        blocks = []  # in buffer order, each as the kernel reads it
        n_layers = sum(1 for k in params if k.startswith("tower.") and k.endswith(".weight"))
        for i in range(n_layers):
            w = params[f"tower.{i}.weight"].detach().float()  # [Co, Cin, K]
            co, cin, k = w.shape
            blocks += [
                _bf16(w.permute(2, 1, 0).reshape(k * cin, co)),  # [K*Cin, Co]
                params[f"tower.{i}.bias"].detach().float(),
            ]
        blocks += [
            _bf16(torch.cat(  # [C, F]
                [params[f"heads.{d}.weight"].detach().float()[:, :, 0] for d in orders]
            ).t()),
            torch.cat([params[f"heads.{d}.bias"].detach().float() for d in orders]),
        ]
        proj = []
        for d in orders:
            layer = constraint_layers[d]
            ns = getattr(layer, "nullspace", None)
            if ns is None:  # FixedCoefficients: c = c0 + scale * z
                ns = np.eye(len(taps[d]))
            proj.append(float(layer.scale) * np.asarray(ns, np.float64).T)
        s_tot = sum(b.shape[0] for b in proj)
        f_tot = sum(b.shape[1] for b in proj)
        pn = np.zeros((s_tot, f_tot))
        r = c = 0
        for blk in proj:
            pn[r : r + blk.shape[0], c : c + blk.shape[1]] = blk
            r += blk.shape[0]
            c += blk.shape[1]
        c0 = np.concatenate([np.asarray(constraint_layers[d].c0, np.float64) for d in orders])
        device = blocks[0].device
        blocks += [torch.as_tensor(a, dtype=torch.float32, device=device) for a in (c0, pn)]

        offsets, n = [], 0
        for blk in blocks:
            offsets.append(n)
            n += _align4(blk.numel())
        flat = torch.zeros(n, device=device)
        for start, blk in zip(offsets, blocks):
            flat[start : start + blk.numel()] = blk.reshape(-1)

        # the kernel's buffer: the same blocks, zero-padded, the matmul
        # weights as bf16 in the tensor-core operands' orders
        channels = blocks[1].numel()
        cp = next((c for c in PADDED_CHANNELS if c >= channels), -(-channels // 16) * 16)
        fp = -(-f_tot // 8) * 8
        k = kernel_size
        kernel_blocks = []
        for i in range(n_layers):
            w, b = blocks[2 * i], blocks[2 * i + 1]
            if i == 0:
                padded = _pad_to(w, -(-k // 16) * 16, cp)
            else:
                padded = _pad_to(w.view(k, channels, channels), k, cp, cp).reshape(k * cp, cp)
            order = _fragment_order if i == 0 else _wgmma_order
            kernel_blocks += [order(padded), _pad_to(b, cp)]
        # projection: per order, per block of 8 stencil rows, c0 [8] then
        # the rows' columns of pn transposed [free dims of the order][8]
        tail, proj_starts, row, first = [], [], 0, 0
        for blk in proj:
            proj_starts.append(sum(t.numel() for t in tail))
            size, count = blk.shape
            for r in range(0, size, 8):
                rows = slice(row + r, row + min(r + 8, size))
                tail += [_pad_to(blocks[-2][rows], 8),
                         _pad_to(blocks[-1][rows, first : first + count].t(), count, 8)]
            row += size
            first += count
        kernel_blocks += [
            _fragment_order(_pad_to(blocks[-4], cp, fp)), _pad_to(blocks[-3], fp),
            torch.cat([t.reshape(-1) for t in tail]),
        ]
        blob_offsets, n = [], 0
        for blk in kernel_blocks:
            blob_offsets.append(n)
            n += -(-blk.numel() * blk.element_size() // 128) * 128
        blob = torch.zeros(n, dtype=torch.uint8, device=device)
        for start, blk in zip(blob_offsets, kernel_blocks):
            raw = blk.contiguous().reshape(-1).view(torch.uint8)
            blob[start : start + raw.numel()] = raw
        free_ranges, first = [], 0
        for start, blk in zip(proj_starts, proj):
            free_ranges.append((first, blk.shape[1], start))
            first += blk.shape[1]
    return LearnedRK4Pack(
        equation=equation,
        grid=grid,
        kernel_size=kernel_size,
        taps={d: tuple(taps[d]) for d in orders},
        channels=channels,
        num_layers=n_layers,
        n_free=f_tot,
        n_rows=s_tot,
        flat=flat,
        offsets=tuple(offsets),
        padded_channels=cp,
        free_ranges=tuple(free_ranges),
        blob=blob,
        blob_offsets=tuple(blob_offsets),
    )


def _learned_rhs_plain(u: torch.Tensor, pack: LearnedRK4Pack) -> torch.Tensor:
    kh = (pack.kernel_size - 1) // 2
    rolls = {}

    def roll(t):
        if t not in rolls:
            rolls[t] = torch.roll(u, -t, dims=-1)
        return rolls[t]

    h = None
    for li, (w, b) in enumerate(pack.tower):
        if li == 0:  # the K rolled copies of u are the first layer's input rows
            stack = _bf16(torch.stack([roll(t) for t in range(-kh, kh + 1)], dim=1))
        else:
            hb = _bf16(h)
            stack = torch.cat(
                [torch.roll(hb, -(k - kh), dims=-1) for k in range(pack.kernel_size)],
                dim=1,
            )  # [B, K*C, nx], row k*C + ci
        h = torch.relu(torch.matmul(w, stack) + b[:, None])
    z = torch.matmul(pack.head_w, _bf16(h)) + pack.head_b[:, None]  # [B, F, nx]
    c_all = pack.c0[:, None] + torch.matmul(pack.pn, z)  # [B, S, nx]
    vals = {}
    r = 0
    for d, taps in pack.taps.items():
        shifted = torch.stack([roll(t) for t in taps], dim=1)
        vals[d] = torch.sum(c_all[:, r : r + len(taps)] * shifted, dim=1)
        r += len(taps)
    return pack.equation.time_derivative(u, vals, pack.grid)


class ForcingPack(NamedTuple):
    """A batch's forcing in the fused kernel's form, built by ``pack_forcing``.

    ``amplitude`` has the cell-average ``sinc`` factor folded in for
    conservative schemes; ``rot_cos``/``rot_sin`` are the planar rotation by
    ``omega dt/2``; ``sin0``/``cos0`` are the per-point phase state at the
    launch's start time.
    """

    amplitude: torch.Tensor  # [B, terms]
    rot_cos: torch.Tensor  # [B, terms]
    rot_sin: torch.Tensor  # [B, terms]
    sin0: torch.Tensor  # [B, terms, nx]
    cos0: torch.Tensor  # [B, terms, nx]


def pack_forcing(
    forcing: ForcingParams,
    t,
    equation: Equation,
    grid: Grid,
    dt: float,
    batch: int,
    device=None,
) -> ForcingPack:
    """``ForcingParams`` (leaves ``[B, terms]`` or broadcastable to it) at
    start time ``t`` -> the kernel's ``ForcingPack``.

    Everything is float32 on the device, from a float32 ``x``, in the order
    of the JAX kernel's host-side pack: ``theta0 = omega t + kappa x + phi``
    and its sin and cos are rounded as the reference rounds them, which
    matters at a large ``t`` after a warm-up.
    """
    leaves = tuple(forcing)
    device = leaves[0].device if device is None else torch.device(device)
    for name, leaf in zip(ForcingParams._fields, leaves):
        if not isinstance(leaf, torch.Tensor) or leaf.dtype != torch.float32:
            raise TypeError(f"forcing.{name} must be a float32 tensor")
        if leaf.device != device:
            raise ValueError(f"forcing.{name} is on {leaf.device}, expected {device}")
    terms = leaves[0].shape[-1]
    try:
        amp, omega, k, phi = (leaf.expand(batch, terms) for leaf in leaves)
    except RuntimeError as e:
        raise ValueError(
            f"forcing leaves {[tuple(l.shape) for l in leaves]} do not "
            f"broadcast to [batch={batch}, terms={terms}]"
        ) from e
    with torch.no_grad():
        kappa = 2 * np.pi * k / equation.period
        if equation.conservative:
            # exact cell average of sin over [x - dx/2, x + dx/2]
            amp = amp * torch.sinc(kappa * grid.dx / 2 / np.pi)
        x = torch.as_tensor(grid.x, dtype=torch.float32, device=device)
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
        theta0 = omega[:, :, None] * t + kappa[:, :, None] * x + phi[:, :, None]
        half = omega * (dt / 2)
        return ForcingPack(
            amp.contiguous(), torch.cos(half), torch.sin(half),
            torch.sin(theta0), torch.cos(theta0),
        )


def _force(fp: ForcingPack, s: torch.Tensor) -> torch.Tensor:
    """sum_m amplitude[m] * s[m], in term order, each product and each sum
    rounded on its own (as the kernel's _rn intrinsics round them)."""
    f = fp.amplitude[:, 0, None] * s[:, 0]
    for m in range(1, s.shape[1]):
        f = f + fp.amplitude[:, m, None] * s[:, m]
    return f


def _rotate(fp: ForcingPack, s: torch.Tensor, c: torch.Tensor):
    """Advance every term's phase by omega dt/2, from the old (s, c)."""
    rc, rs = fp.rot_cos[:, :, None], fp.rot_sin[:, :, None]
    return s * rc + c * rs, c * rc - s * rs


def fused_learned_rk4_plain(
    u: torch.Tensor,
    pack: LearnedRK4Pack,
    dt: float,
    num_steps: int,
    forcing: Optional[ForcingPack] = None,
) -> torch.Tensor:
    """``fused_learned_rk4`` in plain PyTorch: the same RK4 loop, with the
    tower's weights and activations rounded through bfloat16 before float32
    matmuls. With a ``ForcingPack`` each stage adds the forcing from the
    rotated phase state: k1 at the step's start, k2 and k3 share the
    half-step value, k4 takes the full step's, and the state carries on."""
    half_dt, dt_sixth = 0.5 * dt, dt / 6.0
    if forcing is not None:
        s, c = forcing.sin0, forcing.cos0
    for _ in range(num_steps):
        if forcing is None:
            f0 = f_half = f1 = 0.0
        else:
            f0 = _force(forcing, s)
            s, c = _rotate(forcing, s, c)
            f_half = _force(forcing, s)
            s, c = _rotate(forcing, s, c)
            f1 = _force(forcing, s)
        k1 = _learned_rhs_plain(u, pack) + f0
        k2 = _learned_rhs_plain(u + half_dt * k1, pack) + f_half
        k3 = _learned_rhs_plain(u + half_dt * k2, pack) + f_half
        k4 = _learned_rhs_plain(u + dt * k3, pack) + f1
        u = u + dt_sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return u


class LearnedRK4Launch(NamedTuple):
    """Geometry of one ``fused_learned_rk4`` launch."""

    teams: int  # trajectories per block, one warp group (128 threads) each
    threads: int  # per block
    team_bytes: int  # shared memory of one trajectory
    shared_bytes: int  # dynamic shared memory of a block: weights + teams
    blocks: int


def _team_bytes(pack: LearnedRK4Pack, nx: int, terms: int) -> int:
    """Shared memory of one trajectory (fused_learned_rk4.cu counts the same
    in ``team_bytes_needed``): two bf16 activation buffers of one plane per
    8 channels, ``[rows + K, 8]`` each (rows: nx rounded up to 64; K - 1
    halo rows for the periodic wrap and a dump row), four float32 rows
    (stage input with 8 halo points at each end, fluxes, the step's start
    value, the k sum), a ``[32, F | 1]`` tile per warp for the head outputs
    and, forced, the forcing value, four floats of constants per term and
    the (sin, cos) phase state per point."""
    rows = -(-nx // 64) * 64
    planes = pack.padded_channels // 8
    n = (2 * planes * (rows + pack.kernel_size) * 16 + 4 * (4 * rows + 2 * U_HALO)
         + 4 * 32 * (pack.n_free | 1) * 4)
    if terms:
        n += 4 * rows + 16 + 16 * terms + 8 * terms * nx
    return -(-n // 128) * 128


def learned_rk4_launch(
    pack: LearnedRK4Pack, nx: int, terms: int = 0, batch: int = NUM_SMS * MAX_TEAMS,
    shared_limit: int = MAX_SHARED_BYTES,
) -> LearnedRK4Launch:
    """The launch of ``fused_learned_rk4`` for ``batch`` trajectories of
    ``nx`` points (``terms`` forcing sinusoids). A warp group owns a
    trajectory. A block holds one copy of the weights and as many
    trajectories as fit the shared-memory limit, at most 4, but no more than
    leave the launch ``NUM_SMS`` blocks: a small batch spreads over the
    card, a large one shares the weights. ``teams`` is 0 when not even one
    fits (``learned_rk4_refusal`` says so)."""
    team_bytes = _team_bytes(pack, nx, terms)
    weights = pack.blob.numel()
    fit = max(0, shared_limit - weights) // team_bytes
    teams = min(MAX_TEAMS_FORCED if terms else MAX_TEAMS, fit, max(1, batch // NUM_SMS))
    return LearnedRK4Launch(
        teams=teams, threads=TEAM_THREADS * teams, team_bytes=team_bytes,
        shared_bytes=weights + max(1, teams) * team_bytes,
        blocks=-(-batch // max(1, teams)),
    )


def learned_rk4_refusal(
    pack: LearnedRK4Pack, nx: int, terms: int = 0,
    shared_limit: int = MAX_SHARED_BYTES,
) -> Optional[str]:
    """Why the kernel cannot take this shape, or None if it can. The limits
    are the kernel's compile-time bounds and the opt-in shared memory of one
    block (232448 bytes on sm_90), which must hold the weights and one
    trajectory."""
    if pack.num_layers > MAX_LAYERS:
        return f"{pack.num_layers} tower layers > kernel limit {MAX_LAYERS}"
    if pack.padded_channels not in PADDED_CHANNELS:
        return f"{pack.channels} filters > kernel limit {PADDED_CHANNELS[-1]}"
    if nx < 32:
        return f"nx={nx} < 32"
    reach = max(pack.kernel_size // 2, *(abs(t) for taps in pack.taps.values() for t in taps))
    if reach > U_HALO:
        return f"conv kernel or stencil reaches {reach} points > the halo of {U_HALO}"
    launch = learned_rk4_launch(pack, nx, terms, shared_limit=shared_limit)
    if launch.teams < 1:
        return (f"needs {launch.shared_bytes} bytes of shared memory per block > the "
                f"limit of {shared_limit}")
    return None


def fused_learned_rk4(
    u: torch.Tensor,
    pack: LearnedRK4Pack,
    dt: float,
    num_steps: int,
    forcing: Union[ForcingParams, ForcingPack, None] = None,
    t=0.0,
) -> torch.Tensor:
    """``num_steps`` RK4 steps of the packed learned model from ``u [B, nx]``.

    A forced equation (Burgers) needs ``forcing``: ``ForcingParams`` with
    leaves ``[B, terms]`` (or broadcastable), packed here at start time
    ``t``, or a ready ``ForcingPack``. Forcing for an unforced equation
    raises, as does a forced equation without it.
    """
    if pack.equation.forced and forcing is None:
        raise ValueError(f"{pack.equation.name} is forced: forcing required")
    if not pack.equation.forced and forcing is not None:
        # rhs_fn applies any forcing it is handed; dropping it here would
        # make the two routes differ
        raise ValueError(f"{pack.equation.name} is unforced but forcing was passed")
    if u.dim() != 2:
        raise ValueError(f"u must be [batch, nx], got shape {tuple(u.shape)}")
    batch, nx = u.shape
    _check_f32("u", u, (batch, nx), u.device)
    if pack.blob.device != u.device:
        raise ValueError(f"weights are on {pack.blob.device}, u on {u.device}")
    _check_forward_only([u])
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    terms = 0
    if forcing is not None:
        if not isinstance(forcing, ForcingPack):
            forcing = pack_forcing(forcing, t, pack.equation, pack.grid, dt, batch, u.device)
        terms = forcing.amplitude.shape[-1]
        for name, leaf in zip(ForcingPack._fields, forcing):
            shape = (batch, terms, nx) if name in ("sin0", "cos0") else (batch, terms)
            _check_f32(f"forcing.{name}", leaf, shape, u.device)
        _check_forward_only(forcing)
    if u.device.type == "cpu":
        return fused_learned_rk4_plain(u, pack, dt, num_steps, forcing)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")

    refusal = learned_rk4_refusal(pack, nx, terms)
    if refusal:
        raise ValueError(refusal)
    if pack.blob.data_ptr() % 16:
        raise ValueError("packed weights must be 16-byte aligned")
    launch = learned_rk4_launch(pack, nx, terms, batch)
    orders = list(pack.taps)

    from pde_superresolution_torch.ops import _build

    lib = _build.load_library()
    out = torch.empty_like(u)
    pad = [0] * (MAX_ORDERS - len(orders))
    meta = (ctypes.c_int * 26)(
        EQUATION_CODES[pack.equation.name],
        int(pack.equation.conservative),
        nx, pack.padded_channels, pack.kernel_size, pack.num_layers, pack.n_free,
        len(orders),
        *[len(pack.taps[d]) for d in orders], *pad,
        *[pack.taps[d][0] for d in orders], *pad,
        *[first for first, _, _ in pack.free_ranges], *pad,
        *[count for _, count, _ in pack.free_ranges], *pad,
        *[start for _, _, start in pack.free_ranges], *pad,
        terms, launch.teams, launch.team_bytes,
    )
    offsets = (ctypes.c_int * (1 + len(pack.blob_offsets)))(
        pack.blob.numel(), *pack.blob_offsets)
    scalars = (ctypes.c_float * 5)(
        pack.grid.dx, float(getattr(pack.equation, "eta", 0.0)),
        0.5 * dt, dt, dt / 6.0,
    )
    forcing_ptrs = (ctypes.c_void_p * 5)(
        *([leaf.data_ptr() for leaf in forcing] if forcing is not None else [None] * 5)
    )
    code = lib.pde_fused_learned_rk4(
        u.data_ptr(), pack.blob.data_ptr(), out.data_ptr(), batch, num_steps,
        meta, offsets, scalars, forcing_ptrs, launch.shared_bytes, _stream(u.device),
    )
    _raise_on_cuda_error(code, "fused_learned_rk4 launch")
    fused_learned_rk4.launches += 1
    debugging.check_output("fused_learned_rk4", out)
    return out


fused_learned_rk4.launches = 0


# ---------------------------------------------------------------------------
# fused RK4 of the fixed-stencil baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaselineRK4:
    """The classic-stencil scheme of ``make_fused_rk4``: per order the
    integer taps and the float coefficients (already divided by dx^order)."""

    equation: Equation
    grid: Grid
    dt: float
    num_steps: int
    taps: dict  # order -> tuple of contiguous integer taps
    coefficients: dict  # order -> tuple of floats


def _baseline_rhs_plain(u: torch.Tensor, scheme: BaselineRK4) -> torch.Tensor:
    vals = {}
    for d, taps in scheme.taps.items():
        acc = None
        for c, t in zip(scheme.coefficients[d], taps):
            term = c * torch.roll(u, -t, dims=-1)
            acc = term if acc is None else acc + term
        vals[d] = acc
    return scheme.equation.time_derivative(u, vals, scheme.grid)


def fused_rk4_plain(u: torch.Tensor, scheme: BaselineRK4) -> torch.Tensor:
    """``fused_rk4`` in plain PyTorch: tap sums in tap order (each product
    and sum rounded on its own), then the flux divergence or the equation of
    motion, in the RK4 loop of ``fused_learned_rk4_plain``."""
    dt = scheme.dt
    half_dt, dt_sixth = 0.5 * dt, dt / 6.0
    for _ in range(scheme.num_steps):
        k1 = _baseline_rhs_plain(u, scheme)
        k2 = _baseline_rhs_plain(u + half_dt * k1, scheme)
        k3 = _baseline_rhs_plain(u + half_dt * k2, scheme)
        k4 = _baseline_rhs_plain(u + dt * k3, scheme)
        u = u + dt_sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return u


class RK4Launch(NamedTuple):
    """Geometry of one ``fused_rk4`` launch."""

    warps: int  # trajectories per block, one warp each
    threads: int  # per block
    blocks: int


def rk4_launch(batch: int) -> RK4Launch:
    """The launch of ``fused_rk4`` for ``batch`` trajectories. A warp owns a
    trajectory and warps never wait for each other, so a block is only a
    package of warps: as many as leave the launch ``NUM_SMS`` blocks, at most
    ``RK4_MAX_WARPS`` (8 timed 1-2% faster than 4 at B=10240 on an H100)."""
    warps = min(RK4_MAX_WARPS, max(1, batch // NUM_SMS))
    return RK4Launch(warps=warps, threads=32 * warps, blocks=-(-batch // warps))


def rk4_refusal(scheme: BaselineRK4, nx: int) -> Optional[str]:
    """Why the kernel cannot run ``scheme`` on ``nx`` points, or None if it
    can. Each of a warp's 32 lanes holds nx / 32 points in registers, and
    the tap layout is compiled in: the classic schemes of ``make_fused_rk4``
    (accuracy order 2) at the points per lane in ``RK4_POINTS_PER_LANE``."""
    if nx % 32:
        return f"nx={nx} is not a multiple of 32: each of a warp's 32 lanes holds nx/32 points"
    if nx // 32 not in RK4_POINTS_PER_LANE:
        return (f"nx={nx} ({nx // 32} points per lane) has no instantiation; the kernel "
                f"is built for nx in {[32 * p for p in RK4_POINTS_PER_LANE]}")
    eq = scheme.equation
    layout = {d: (t[0], len(t)) for d, t in scheme.taps.items()}
    built = RK4_LAYOUTS.get((eq.name, eq.conservative))
    if layout != built:
        return (f"taps {layout} are not the classic scheme the kernel is built for "
                f"({eq.name}, conservative={eq.conservative}: {built})")
    return None


def fused_rk4(u: torch.Tensor, scheme: BaselineRK4) -> torch.Tensor:
    """``scheme.num_steps`` RK4 steps of the baseline scheme from ``u [B, nx]``
    in one launch of ``csrc/fused_rk4.cu`` (its plain version for a CPU
    tensor). On the card a warp owns a trajectory; ``rk4_refusal`` says
    which shapes and schemes it takes."""
    if u.dim() != 2:
        raise ValueError(f"u must be [batch, nx], got shape {tuple(u.shape)}")
    batch, nx = u.shape
    _check_f32("u", u, (batch, nx), u.device)
    if nx != scheme.grid.size:
        raise ValueError(f"u has nx={nx}, the scheme's grid {scheme.grid.size}")
    _check_forward_only([u])
    if u.device.type == "cpu":
        return fused_rk4_plain(u, scheme)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    refusal = rk4_refusal(scheme, nx)
    if refusal:
        raise ValueError(refusal)
    launch = rk4_launch(batch)

    from pde_superresolution_torch.ops import _build

    lib = _build.load_library()
    out = torch.empty_like(u)
    orders = sorted(scheme.taps)
    pad = [0] * (MAX_ORDERS - len(orders))
    meta = (ctypes.c_int * 11)(
        EQUATION_CODES[scheme.equation.name],
        int(scheme.equation.conservative),
        nx, launch.warps, len(orders),
        *[len(scheme.taps[d]) for d in orders], *pad,
        *[scheme.taps[d][0] for d in orders], *pad,
    )
    coefs = (ctypes.c_float * (MAX_ORDERS * MAX_TAPS))()
    for i, d in enumerate(orders):
        for s, c in enumerate(scheme.coefficients[d]):
            coefs[i * MAX_TAPS + s] = c
    dt = scheme.dt
    scalars = (ctypes.c_float * 5)(
        scheme.grid.dx, float(getattr(scheme.equation, "eta", 0.0)),
        0.5 * dt, dt, dt / 6.0,
    )
    code = lib.pde_fused_rk4(
        u.data_ptr(), out.data_ptr(), batch, scheme.num_steps, meta, coefs,
        scalars, _stream(u.device),
    )
    _raise_on_cuda_error(code, "fused_rk4 launch")
    fused_rk4.launches += 1
    debugging.check_output("fused_rk4", out)
    return out


fused_rk4.launches = 0


def make_fused_rk4(
    equation: Equation,
    grid: Grid,
    dt: float,
    num_steps: int,
    accuracy_order: int = 2,
    stencil_size: Optional[int] = None,
):
    """Whole multi-step RK4 integration of the fixed-stencil baseline scheme
    in one kernel: the state stays on chip for all ``num_steps`` steps.

    Unforced equations only (KdV, KS). The classic coefficients are
    computed here in float64 and passed to the kernel by value. Returns
    ``advance(u [batch, nx]) -> u`` after ``num_steps`` steps; its
    ``scheme`` attribute is the ``BaselineRK4`` it runs.
    """
    if equation.forced:
        raise ValueError("fused RK4 kernel supports unforced equations only")
    staggered = equation.conservative
    shift = -0.5 if staggered else 0.0
    method = (
        stencils.Method.FINITE_VOLUMES if staggered
        else stencils.Method.FINITE_DIFFERENCES
    )
    taps, coefs = {}, {}
    for d in sorted(equation.derivative_orders):
        size = stencil_size or stencils.baseline_stencil_size(d, accuracy_order, staggered)
        offs = stencils.stencil_offsets(size, staggered=staggered)
        taps[d] = stencils.int_taps(offs, shift)
        coefs[d] = tuple(
            float(c) for c in stencils.coefficients(offs, method, d, None, dx=grid.dx)
        )
        if not _contiguous_run(taps[d]):
            raise ValueError(f"taps of order {d} are not contiguous: {taps[d]}")
        if len(taps[d]) > MAX_TAPS:
            raise ValueError(f"{len(taps[d])} taps > kernel limit {MAX_TAPS}")
    scheme = BaselineRK4(equation, grid, float(dt), int(num_steps), taps, coefs)

    def advance(u: torch.Tensor) -> torch.Tensor:
        return fused_rk4(u, scheme)

    advance.scheme = scheme
    return advance
