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
    trajectory, or below nx 128 up to eight of them packed point by point,
    and a block holds up to four warp groups; at 65-128 filters two warp
    groups share a block's one trajectory, the weights arriving a conv
    tap's slice at a time in a ring fed by bulk copies that a cluster of
    blocks shares (``csrc/fused_learned_rk4_wide.cu``); where one block
    cannot hold a trajectory, a thread-block cluster shares it, a segment a
    block run by up to four warp groups, halos by distributed shared memory.
    For a forced equation (Burgers) the sum-of-sinusoids forcing is
    evaluated in the kernel from a
    ``ForcingPack``: per-term (sin, cos) phase state advanced by a planar
    rotation per half step.
  * ``fused_rk4`` (``csrc/fused_rk4*.cu``, built by ``make_fused_rk4``,
    replaces ``make_fused_rk4``): ``num_steps`` RK4 steps of the fixed
    classic-stencil baseline scheme of any accuracy order or stencil size,
    unforced equations only; up to 1024 points a warp owns a trajectory and
    holds it in registers (the default schemes' tap loops unrolled, each
    coefficient a kernel parameter read by its multiply; any other scheme's
    taps taken at run time), above that (and for a scheme of more than 32
    taps an order) the warps of a block, or of a thread-block cluster's
    blocks, hold it in registers and trade only their edges through shared
    memory.

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
from pde_superresolution_torch.utils import debugging, profiling

EQUATION_CODES = {"burgers": 0, "kdv": 1, "ks": 2}
MAX_ORDERS = 3
# fused_learned_rk4.cuh's compile-time limits (kMaxTeams, kMaxCluster) and
# the tower widths it is instantiated for; at WIDE_CHANNELS (kWideNT) a block
# holds one trajectory run by WIDE_GROUPS warp groups and a producer warp,
# RING_THREADS in all (kWideGroups, kRingThreads), layer >= 1's weights
# reaching it through a ring of one conv tap's slices, as many slots as fit
# up to RING_SLOTS (at most MAX_RING_SLOTS, kMaxRingSlots), each slice
# copied once for a cluster of WIDE_CLUSTER blocks, a trajectory each (at
# most MAX_WIDE_CLUSTER, kMaxWideCluster), with RING_CONTROL_BYTES of
# barriers after the layout (kRingControlBytes): the ring,
# fused_learned_rk4_wide.cu. RING_SLOTS and WIDE_CLUSTER are the rule's,
# from a sweep on an H100 (PERF.md), not options. Where one block cannot
# hold a trajectory, the split form shares it over a thread-block cluster of
# up to MAX_CLUSTER blocks (above PORTABLE_CLUSTER the card must allow a
# non-portable size). Wider
# towers pad to a multiple of 16 and take the split form in chunks of
# WIDE_CHANNELS output channels (the chunked form), their activation rows
# rounded up to 8 with CHUNK_SLACK bytes after them (kChunkSlack). A split
# block runs one of GROUP_COUNTS warp groups on its segment, up to
# MAX_GROUPS (kMaxGroups), at WIDE_CHANNELS and above up to MAX_GROUPS_WIDE
# (kMaxGroupsWide: the kernel's thread bound leaves 255 registers a thread
# for 64 accumulators). A split launch that streams its weights (always at
# WIDE_CHANNELS and above) takes the ring too: a producer warp beside the
# groups, up to RING_SLOTS slots beside the segment, each slice copied once
# for the cluster's blocks (fused_learned_rk4_cluster_ring.cu).
MAX_TEAMS = 4  # teams (warp groups) per block
MAX_TEAMS_FORCED = 4  # the same for a forced equation (kMaxTeamsForced)
TEAM_THREADS = 128  # one warp group owns a trajectory, or per_team of them (kTeamThreads)
# Below WIDE_CHANNELS a team of the whole form packs P trajectories of a
# short grid into its rows, one kernel per count (kMaxPerTeam): the most whose
# P nx points fit PACKED_ROWS rows (kPackedRows: two 64-row tiles), as long as
# the launch keeps NUM_SMS teams. The split form takes nx >= MIN_SPLIT_NX,
# the whole form nx >= MIN_NX.
PER_TEAM_COUNTS = (1, 2, 4, 8)
PACKED_ROWS = 128
MIN_NX = 16
MIN_SPLIT_NX = 32
U_HALO = 8  # the least number of periodic copies of u at each end in shared memory
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
GROUP_COUNTS = (1, 2, 4)  # one kernel each (no sweep shape chose 3)
MAX_GROUPS = 4
MAX_GROUPS_WIDE = 2
WIDE_GROUPS = 2
RING_THREADS = TEAM_THREADS * WIDE_GROUPS + 32
MAX_RING_SLOTS = 5
RING_SLOTS = 4
RING_CONTROL_BYTES = 128
MAX_WIDE_CLUSTER = 8
WIDE_CLUSTER = 2
PADDED_CHANNELS = (16, 32, 64, 128)
WIDE_CHANNELS = 128
CHUNK_SLACK = 64 * 16  # one 64-row tile of one plane
MAX_SHARED_BYTES = 232448  # opt-in shared memory per block on sm_90
NUM_SMS = 132  # H100: a launch should have at least this many blocks
# What one SM holds of the split form's blocks (learned_rk4_launch,
# split_occupancy): shared memory for the blocks and BLOCK_RESERVED_BYTES
# each beside them (the opt-in limit plus one reservation: 233,472 bytes on
# sm_90), and registers for SM_WARPS warps (128 registers a thread, the
# most that 2 and 4 groups may use) or, at WIDE_CHANNELS and above,
# SM_WARPS_WIDE (255 a thread). These are the rule's fitted constants, not
# ptxas' counts: one group takes 80 to 166 registers (ptxas for sm_90a, an
# H100), so 3 one-group blocks an SM at 64 channels, not 4, and 3 at 128,
# not 2; counted so, the rule ranks 16 blocks of one group first at 128
# filters nx 1024, 8% slower in the sweep than its pick (PERF.md).
BLOCK_RESERVED_BYTES = 1024
SM_WARPS = 16
SM_WARPS_WIDE = 8
# fused_rhs.cu's block: one thread per point, at most RHS_BLOCK_POINTS of
# them unless one trajectory is longer, dynamic shared memory under the
# 48 KB that needs no opt-in. On an H100 one trajectory of 128 points per
# block was 10-14% faster than four for the KS-8x checkpoint's coefficients
# at B=4096 and 10240, and 4-9% slower for the Burgers-8x checkpoint's.
RHS_SHARED_BYTES = 49152
RHS_BLOCK_POINTS = 128
MAX_THREADS = 1024
# fused_rk4.cuh's compile-time limits (kMaxTaps, kReach, kMaxWarps), the
# points per lane its register forms are built for (nx = lanes x P, 17 to 32
# lanes) and the classic schemes compiled into one of them: (equation,
# conservative) -> {order: (first tap, number of taps)}. Any other scheme of
# at most MAX_TAPS taps an order within RK4_REACH points takes its taps at
# run time, in registers up to RK4_SCHEME_MAX_POINTS a lane (at 32 its six
# register rows spill). Longer grids and wider schemes take the block form:
# a trajectory over the warps of a block, or of a cluster of up to
# MAX_CLUSTER blocks, at most RK4_BLOCK_MAX_WARPS warps a block
# (kBlockMaxWarps: the thread bound leaves RK4_BLOCK_REGISTERS registers a
# thread), P points a lane (RK4_BLOCK_POINTS: 4 up to 128 points, else 8;
# the classic layouts compiled in at RK4_BLOCK_CLASSIC_POINTS,
# kBlockClassicPoints, 13-21% faster than 16 at nx 2048 on an H100; any
# scheme's taps at run time, kBlockSchemePoints at most: at 16 its register
# rows spill), the warps' edges in shared memory. The rule fills a block up
# to RK4_BLOCK_WARPS warps before it adds a block to the cluster, up to
# PORTABLE_CLUSTER blocks, then up to RK4_BLOCK_MAX_WARPS (on an H100, nx
# 16384 at B=256 ran 4.29 ms on 8 blocks of 8 warps, 5.52 on 4 of 16; PERF.md). A wide scheme (rk4_wide) whose rows fit a block takes the rows
# form (on an H100 3.3x faster than the block form at 40 taps, nx 128): a
# block of RK4_ROWS_THREADS threads, its rows and coefficients in shared
# memory.
MAX_TAPS = 32
RK4_REACH = 16  # the register forms' taps lie in [-RK4_REACH, RK4_REACH]
RK4_MAX_WARPS = 8
RK4_POINTS_PER_LANE = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)
RK4_REGISTER_MAX_NX = 32 * RK4_POINTS_PER_LANE[-1]
RK4_SCHEME_MAX_POINTS = 24  # fused_rk4.cuh's kSchemeMaxPoints
RK4_BLOCK_POINTS = (4, 8)  # powers of two: each divides every nx % 32 == 0
RK4_BLOCK_CLASSIC_POINTS = 8
RK4_BLOCK_MAX_WARPS = 16
RK4_BLOCK_WARPS = 8
RK4_BLOCK_REGISTERS = 128
RK4_ROWS_THREADS = 256
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
    with profiling.span(profiling.FUSED_RHS):
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
    zero-padded to ``padded_channels`` (16, 32, 64 or 128, and above 128 a
    multiple of 16) and the free dims to a multiple of 8: zero weights and
    biases add exact zeros. Per layer the weights ``w [depth,
    out_channels]`` are bf16: layer 0 (depth = the K taps padded to a
    multiple of 16) in the order of ``mma.m16n8k16``'s B fragments
    (``_fragment_order``), every later layer (depth index ``k *
    padded_channels + ci``) as ``wgmma`` reads it from shared memory
    (``_wgmma_order``), so that one conv tap's ``[padded_channels]^2`` slice
    is contiguous (the 128-channel form streams it); then the float32 bias
    ``[out_channels]``. ``out_channels`` is ``padded_channels`` up to 128;
    above (the chunked form) it is rounded up to whole chunks of 128, and a
    later layer's weights are laid out per output chunk and conv tap, each
    ``[padded_channels, 128]`` in ``_wgmma_order``, so that the slice of one
    chunk, tap and 128 input channels is contiguous. The
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
        out_p = cp if cp <= WIDE_CHANNELS else -(-cp // WIDE_CHANNELS) * WIDE_CHANNELS
        fp = -(-f_tot // 8) * 8
        k = kernel_size
        kernel_blocks = []
        for i in range(n_layers):
            w, b = blocks[2 * i], blocks[2 * i + 1]
            if i == 0:
                w = _fragment_order(_pad_to(w, -(-k // 16) * 16, out_p))
            else:  # per output chunk (one but in the chunked form) and tap
                padded = _pad_to(w.view(k, channels, channels), k, cp, out_p)
                w = torch.cat([_wgmma_order(padded[t, :, c0 : c0 + min(out_p, WIDE_CHANNELS)])
                               for c0 in range(0, out_p, WIDE_CHANNELS) for t in range(k)])
            kernel_blocks += [w, _pad_to(b, out_p)]
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
    with profiling.span(profiling.PACK_FORCING):
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
    """Geometry of one ``fused_learned_rk4`` launch.

    Whole trajectories a block (``split`` false): ``teams`` warp groups,
    each owning ``per_team`` trajectories; at ``WIDE_CHANNELS`` one
    trajectory a block run by ``groups`` warp groups, layer >= 1's weights
    through a ring of ``slots`` slices, each slice copied once for the
    ``multicast`` blocks of a cluster. The split form (``split``): a
    thread-block cluster of ``cluster`` blocks per trajectory, each holding
    a segment of ``segment``
    points (the last block the rest) run by ``groups`` warp groups, with the
    weights whole in shared memory or, ``stream``, layer >= 1's through a
    ring of ``slots`` slices, each copied once for the cluster's blocks
    (``multicast`` 1: the cluster holds one trajectory). A launch with a
    ring has a producer warp beside its groups (``ring_threads``). ``teams``
    is 0 when no form fits (1 in the split form)."""

    teams: int  # warp groups (128 threads) per block, each its own trajectories
    threads: int  # per block
    team_bytes: int  # shared memory of one team: its trajectories, or a segment
    shared_bytes: int  # dynamic shared memory of a block: weights + teams
    blocks: int
    split: bool = False  # the cluster form
    cluster: int = 1  # blocks per trajectory
    segment: int = 0  # points a block holds: nx, or a segment of it
    stream: bool = False  # layer >= 1's weights through the ring, a slice at a time
    groups: int = 1  # the split form: warp groups a block on its one segment
    per_team: int = 1  # the whole form: trajectories a team, packed point by point
    slots: int = 0  # streamed: the ring's slots of one slice
    multicast: int = 1  # the whole form: the blocks (a trajectory each) sharing each copy


def learned_rk4_reach(pack: LearnedRK4Pack) -> int:
    """How far a point's update reads: the conv kernel's half width or the
    farthest stencil tap, whichever is larger."""
    return max(pack.kernel_size // 2, *(abs(t) for taps in pack.taps.values() for t in taps))


def learned_rk4_halo(pack: LearnedRK4Pack) -> int:
    """Periodic points of u the kernel keeps at each end of a team's row:
    the reach, at least ``U_HALO``."""
    return max(U_HALO, learned_rk4_reach(pack))


def _team_bytes(pack: LearnedRK4Pack, nx: int, terms: int, per_team: int = 1) -> int:
    """Shared memory of one team holding ``nx`` points of each of
    ``per_team`` trajectories (whole ones, packed a row per point and
    trajectory), or a segment of one trajectory (fused_learned_rk4.cuh
    counts the same in ``team_bytes_needed``): two bf16 activation buffers
    of one plane per 8 channels, ``[rows + (K - 1) P + 1, 8]`` each (rows: P
    nx rounded up to 64, to 8 above 128 channels, where ``CHUNK_SLACK``
    bytes follow the buffers; K - 1 halo rows of each trajectory for the
    periodic wrap and a dump row), four float32 rows (stage input with
    ``learned_rk4_halo`` points of each trajectory at each end, fluxes, the
    step's start value, the k sum), a ``[32, F | 1]`` tile per warp for the
    head outputs and, forced, the forcing value, four floats of constants
    per term and trajectory and the (sin, cos) phase state per row."""
    chunked = pack.padded_channels > WIDE_CHANNELS
    rows = -(-nx * per_team // (8 if chunked else 64)) * (8 if chunked else 64)
    planes = pack.padded_channels // 8
    plane_rows = rows + (pack.kernel_size - 1) * per_team + 1
    n = (2 * planes * plane_rows * 16 + (CHUNK_SLACK if chunked else 0)
         + 4 * (4 * rows + 2 * learned_rk4_halo(pack) * per_team)
         + 4 * 32 * (pack.n_free | 1) * 4)
    if terms:
        n += 4 * rows + 16 + 16 * terms * per_team + 8 * terms * nx * per_team
    return -(-n // 128) * 128


def _group_bytes(pack: LearnedRK4Pack) -> int:
    """The z tiles of one more warp group on a split block's segment
    (``group_z_bytes``): one ``[32, F | 1]`` float32 tile per warp, kept
    after the segment's layout."""
    return 4 * 32 * (pack.n_free | 1) * 4


def ring_threads(groups: int) -> int:
    """Threads of a split block of ``groups`` warp groups that streams its
    weights through the ring: the groups and a producer warp, but at
    ``MAX_GROUPS`` none (block 0's first thread issues: a 17th warp would
    leave each thread 96 registers; fused_learned_rk4.cuh ring_threads)."""
    return TEAM_THREADS * groups + (0 if groups == MAX_GROUPS else 32)


def _window_bytes(pack: LearnedRK4Pack) -> int:
    """One slot of the ring: one conv tap's slice of a layer >= 1's
    weights, bf16 (in the chunked form: of one chunk's 128 outputs from 128
    inputs; a tap's last slice may hold fewer inputs)."""
    return 2 * min(pack.padded_channels, WIDE_CHANNELS) ** 2


def _ring_bytes(pack: LearnedRK4Pack, nx: int, terms: int, slots: int,
                groups: int = WIDE_GROUPS) -> int:
    """Shared memory of a block with a ring of ``slots`` slices: the whole
    form at ``WIDE_CHANNELS`` (``nx``: the trajectory's points, two warp
    groups) or a split block that streams (``nx``: its segment's points,
    ``groups`` warp groups): the slots, the team bytes of the ``nx``
    points, the z tiles of the later warp groups and the barriers after
    them."""
    return (slots * _window_bytes(pack) + _team_bytes(pack, nx, terms)
            + (groups - 1) * _group_bytes(pack) + RING_CONTROL_BYTES)


def most_per_team(pack: LearnedRK4Pack, nx: int) -> int:
    """The most trajectories a team of the whole form packs at ``nx``
    points: the largest count of ``PER_TEAM_COUNTS`` whose rows fit
    ``PACKED_ROWS`` (8 at nx 16, 4 at 32, 2 at 64), 1 from nx 65 and at
    ``WIDE_CHANNELS`` and above (one 64-row tile a pass)."""
    if pack.padded_channels >= WIDE_CHANNELS:
        return 1
    return max(p for p in PER_TEAM_COUNTS if p == 1 or p * nx <= PACKED_ROWS)


def learned_rk4_launch(
    pack: LearnedRK4Pack, nx: int, terms: int = 0, batch: int = NUM_SMS * MAX_TEAMS,
    shared_limit: int = MAX_SHARED_BYTES, cluster: Optional[int] = None,
    groups: Optional[int] = None, per_team: Optional[int] = None,
) -> LearnedRK4Launch:
    """The launch of ``fused_learned_rk4`` for ``batch`` trajectories of
    ``nx`` points (``terms`` forcing sinusoids).

    Where a block holds whole trajectories, a warp group (a team) owns P of
    them: the most that ``most_per_team`` allows and that still leave the
    launch ``NUM_SMS`` teams (at nx 32: 4 from B = 525, 2 from 263, else 1),
    and fit. A block holds one copy of the weights and as many teams as fit
    the shared-memory limit, at most 4, but no more than leave the launch
    ``NUM_SMS`` blocks: a small batch spreads over the card, a large one
    shares the weights. At ``WIDE_CHANNELS`` a block holds one trajectory,
    run by ``WIDE_GROUPS`` warp groups, beside a ring of as many slots of
    one conv tap's slice as fit, up to ``RING_SLOTS`` (``_ring_bytes``),
    each slice copied once for a cluster of ``WIDE_CLUSTER`` blocks (fewer
    where the batch is smaller; the last cluster's blocks past the batch
    run on zeros). Wider towers (the chunked form)
    always take the split form below, their weights streamed. ``per_team``
    forces P (one of ``PER_TEAM_COUNTS`` up to ``most_per_team``), whatever
    the batch; a value out of range raises, as does P > 1 with ``cluster``
    or ``groups`` or where the whole form does not fit.

    Where it does not, or where the reach (``learned_rk4_halo``) is longer
    than the grid or the conv kernel wider than nx + 1 points (a block of
    whole trajectories writes each halo as a single periodic copy), the
    split form: a cluster of up to ``MAX_CLUSTER`` blocks, each a segment of
    ``ceil(nx / cluster)`` points run by ``groups`` warp groups, chosen by
    ``_split_rank`` from the occupancy each choice gives. ``cluster`` and
    ``groups`` force the split form (also at a shape one block holds) with
    that many blocks (fewer where ``ceil(nx / cluster)``-point segments
    cover nx with fewer) or warp groups, the other chosen as above; a value
    out of range raises. A split block that streams its weights holds a
    ring of as many slots as fit beside its segment, up to ``RING_SLOTS``
    (``_ring_bytes``; fewer where that fits more blocks an SM), and a
    producer warp (``ring_threads``). ``teams`` is 0 when nothing fits
    (``learned_rk4_refusal`` says so)."""
    window, resident = _window_bytes(pack), pack.blob.numel()
    wide = pack.padded_channels >= WIDE_CHANNELS
    chunked = pack.padded_channels > WIDE_CHANNELS
    most_groups = MAX_GROUPS_WIDE if wide else MAX_GROUPS
    if cluster is not None and not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster={cluster}: the split form takes 1 to {MAX_CLUSTER} blocks")
    counts = [g for g in GROUP_COUNTS if g <= most_groups]
    if groups is not None and groups not in counts:
        raise ValueError(f"groups={groups}: the split form takes {counts} warp groups a block "
                         f"at {pack.padded_channels} channels")
    packs = [p for p in PER_TEAM_COUNTS if p <= most_per_team(pack, nx)]
    if per_team is not None and per_team not in packs:
        raise ValueError(f"per_team={per_team}: the whole form packs {packs} trajectories a "
                         f"team at nx {nx}, {pack.padded_channels} channels")
    if (per_team or 1) > 1 and (cluster is not None or groups is not None):
        raise ValueError(f"per_team={per_team} packs the whole form; cluster and groups force "
                         "the split form")
    # a block of whole trajectories writes each halo as one periodic copy
    wraps_once = learned_rk4_halo(pack) <= nx and 2 * (pack.kernel_size // 2) <= nx
    if cluster is None and groups is None and wraps_once and wide and not chunked:
        team_bytes = _team_bytes(pack, nx, terms)
        slots = min(RING_SLOTS, MAX_RING_SLOTS,
                    max(0, shared_limit - _ring_bytes(pack, nx, terms, 0)) // window)
        if slots >= 1:
            share = max(1, min(WIDE_CLUSTER, MAX_WIDE_CLUSTER, batch))
            return LearnedRK4Launch(
                teams=1, threads=RING_THREADS, team_bytes=team_bytes,
                shared_bytes=_ring_bytes(pack, nx, terms, slots),
                blocks=-(-batch // share) * share, segment=nx, stream=True, groups=WIDE_GROUPS,
                slots=slots, multicast=share)
    elif cluster is None and groups is None and wraps_once and not chunked:
        weights = resident
        most = MAX_TEAMS_FORCED if terms else MAX_TEAMS
        for p in [per_team] if per_team is not None else packs[::-1]:
            slots = -(-batch // p)  # teams of p trajectories
            if per_team is None and p > 1 and slots < NUM_SMS:
                continue  # fewer teams than SMs: a smaller P spreads the batch
            team_bytes = _team_bytes(pack, nx, terms, p)
            fit = max(0, shared_limit - weights) // team_bytes
            teams = min(most, fit, max(1, slots // NUM_SMS))
            if teams >= 1:
                return LearnedRK4Launch(
                    teams=teams, threads=TEAM_THREADS * teams, team_bytes=team_bytes,
                    shared_bytes=weights + teams * team_bytes, blocks=-(-slots // teams),
                    segment=nx, per_team=p)
        if (per_team or 1) > 1:
            raise ValueError(f"per_team={per_team}: {per_team} trajectories of {nx} points do "
                             f"not fit a team beside the weights in {shared_limit} bytes")
    sizes = range(1, MAX_CLUSTER + 1) if cluster is None else [cluster]
    counts = counts if groups is None else [groups]
    best = None
    for stream in (False, True) if not wide else (True,):
        for size in sizes:
            segment = -(-nx // size)
            team_bytes = _team_bytes(pack, segment, terms)
            for count in counts:
                # streamed: each ring size that fits beside the segment, up
                # to RING_SLOTS (fewer slots may fit more blocks an SM)
                most = min(RING_SLOTS, MAX_RING_SLOTS, max(0, shared_limit - _ring_bytes(
                    pack, segment, terms, 0, count)) // window) if stream else 0
                for slots in range(most, 0, -1) if stream else [0]:
                    shared = (_ring_bytes(pack, segment, terms, slots, count) if stream
                              else resident + team_bytes + (count - 1) * _group_bytes(pack))
                    if shared > shared_limit:
                        continue
                    launch = LearnedRK4Launch(
                        teams=1,
                        threads=ring_threads(count) if stream else TEAM_THREADS * count,
                        team_bytes=team_bytes, shared_bytes=shared,
                        blocks=batch * -(-nx // segment), split=True, cluster=-(-nx // segment),
                        segment=segment, stream=stream, groups=count, slots=slots)
                    rank = _split_rank(launch, wide, shared_limit)
                    if best is None or rank < best[0]:
                        best = (rank, launch)
    if best is not None:
        return best[1]
    segment = -(-nx // sizes[-1])
    team_bytes = _team_bytes(pack, segment, terms)
    return LearnedRK4Launch(
        teams=0, threads=ring_threads(counts[0]), team_bytes=team_bytes,
        shared_bytes=_ring_bytes(pack, segment, terms, 1, counts[0]), blocks=0, split=True,
        cluster=sizes[-1], segment=segment, stream=True, groups=counts[0], slots=1)


def split_occupancy(launch: LearnedRK4Launch, wide: bool,
                    shared_limit: int = MAX_SHARED_BYTES) -> tuple:
    """What one SM holds of a split launch: (blocks by shared memory and by
    registers, warps of them that have a pass of tiles to run, passes of
    64-row tiles per warp group and stage). A pass is two tiles below
    ``WIDE_CHANNELS`` (MT = 2), one at and above it. A block that streams
    its weights has a producer warp beside its groups (``ring_threads``);
    at least one block fits by registers (its kernel's thread bound sees to
    that)."""
    warps = (ring_threads(launch.groups) if launch.stream else
             TEAM_THREADS * launch.groups) // 32
    per_sm = min((shared_limit + BLOCK_RESERVED_BYTES)
                 // (launch.shared_bytes + BLOCK_RESERVED_BYTES),
                 max(1, (SM_WARPS_WIDE if wide else SM_WARPS) // warps))
    tiles = -(-launch.segment // 64)
    units = -(-tiles // (1 if wide else 2))  # passes of the segment, over all groups
    return per_sm, 4 * per_sm * min(launch.groups, units), -(-units // launch.groups)


def _split_rank(launch: LearnedRK4Launch, wide: bool, shared_limit: int) -> tuple:
    """The order of the split form's candidates (the least first), from the
    sweep of every cluster size and warp-group count on an H100
    (``scripts/probe_learned_rk4.py --clusters all --groups all``; PERF.md):
    the most warps with a pass to run resident an SM; then the weights
    whole before streamed; then, streamed, the fewest slices a trajectory's
    blocks wait for (blocks x passes: the groups of a block share each; the
    ring copies a slice once for the cluster, but each block still waits
    for it, and at 128 filters nx 1024 4 blocks of 2 passes ran 1.17x
    faster than 8 of one); then the fewest tile slots a trajectory holds
    (blocks x groups x passes: the padded tile work); then, where a group
    runs one pass between
    barriers, two blocks an SM or more before one (a block's cluster barrier
    then overlaps another's work: Burgers-8x nx 2048, 8 blocks of 2 groups
    against 4 of 4); then the fewest blocks (with two passes or more a group
    the barriers weigh less than the halos and barriers of more blocks:
    KS-8x nx 2048, 2 blocks of 4 groups against 4 of 2); then the fewest
    warp groups; then, streamed, the most slots of the ring."""
    per_sm, busy, passes = split_occupancy(launch, wide, shared_limit)
    copies = launch.cluster * passes if launch.stream else 0
    return (-busy, launch.stream, copies, launch.cluster * launch.groups * passes,
            per_sm < 2 and passes < 2, launch.cluster, launch.groups, -launch.slots)


def learned_rk4_refusal(
    pack: LearnedRK4Pack, nx: int, terms: int = 0,
    shared_limit: int = MAX_SHARED_BYTES, cluster: Optional[int] = None,
    groups: Optional[int] = None,
) -> Optional[str]:
    """Why the kernel cannot take this shape, or None if it can. The limits
    are nx >= ``MIN_NX`` (16; ``MIN_SPLIT_NX``, 32, where the shape takes
    the split form) and the opt-in shared memory of a block (232448 bytes on
    sm_90), which must hold the weights (or one slot of the ring)
    and one trajectory, or one segment of a trajectory split over at most
    ``MAX_CLUSTER`` blocks (``cluster``, ``groups``: exactly that many
    blocks or warp groups a block, as ``learned_rk4_launch`` takes them).
    The width, the depth and the reach of the tower and the stencil are not
    limited."""
    if nx < MIN_NX:
        return f"nx={nx} < {MIN_NX}"
    launch = learned_rk4_launch(pack, nx, terms, shared_limit=shared_limit, cluster=cluster,
                                groups=groups)
    if launch.split and nx < MIN_SPLIT_NX:
        return f"nx={nx} < {MIN_SPLIT_NX} in the split form"
    if launch.teams < 1:
        return (f"needs {launch.shared_bytes} bytes of shared memory per block split over "
                f"{launch.cluster} blocks ({launch.segment} points each) > the limit of "
                f"{shared_limit}")
    return None


def fused_learned_rk4(
    u: torch.Tensor,
    pack: LearnedRK4Pack,
    dt: float,
    num_steps: int,
    forcing: Union[ForcingParams, ForcingPack, None] = None,
    t=0.0,
    cluster: Optional[int] = None,
    groups: Optional[int] = None,
    per_team: Optional[int] = None,
) -> torch.Tensor:
    """``num_steps`` RK4 steps of the packed learned model from ``u [B, nx]``.

    A forced equation (Burgers) needs ``forcing``: ``ForcingParams`` with
    leaves ``[B, terms]`` (or broadcastable), packed here at start time
    ``t``, or a ready ``ForcingPack``. Forcing for an unforced equation
    raises, as does a forced equation without it. ``cluster`` and ``groups``
    force the split form with that many blocks per trajectory or warp groups
    a block, ``per_team`` the trajectories a team of the whole form packs
    (``learned_rk4_launch``, which raises on a value out of range); the
    plain version, which a CPU tensor takes, has no blocks and ignores
    them.
    """
    with profiling.span(profiling.FUSED_LEARNED_RK4):
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

        refusal = learned_rk4_refusal(pack, nx, terms, cluster=cluster, groups=groups)
        if refusal:
            raise ValueError(refusal)
        if pack.blob.data_ptr() % 16:
            raise ValueError("packed weights must be 16-byte aligned")
        launch = learned_rk4_launch(pack, nx, terms, batch, cluster=cluster, groups=groups,
                                    per_team=per_team)
        orders = list(pack.taps)

        from pde_superresolution_torch.ops import _build

        lib = _build.load_library()
        out = torch.empty_like(u)
        pad = [0] * (MAX_ORDERS - len(orders))
        meta = (ctypes.c_int * 33)(
            EQUATION_CODES[pack.equation.name],
            int(pack.equation.conservative),
            nx, pack.padded_channels, pack.kernel_size, pack.num_layers, pack.n_free,
            len(orders),
            *[len(pack.taps[d]) for d in orders], *pad,
            *[pack.taps[d][0] for d in orders], *pad,
            *[first for first, _, _ in pack.free_ranges], *pad,
            *[count for _, count, _ in pack.free_ranges], *pad,
            *[start for _, _, start in pack.free_ranges], *pad,
            terms, launch.groups if launch.split or launch.slots else launch.teams,
            launch.team_bytes,
            learned_rk4_halo(pack),
            launch.cluster if launch.split else 0, launch.segment, int(launch.stream),
            launch.per_team, launch.slots, launch.multicast,
        )
        weights = (_window_bytes(pack) * max(1, launch.slots) if launch.stream
                   else pack.blob.numel())
        offsets = (ctypes.c_int * (1 + len(pack.blob_offsets)))(weights, *pack.blob_offsets)
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
    # a wide scheme's coefficients on each card (rk4_wide), copied there at
    # its first launch: a copy from host memory waits for the card
    device_coefficients: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)


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

    form: str  # "registers" (a warp a trajectory), "block" (warps of a block or a cluster) or "rows"
    warps: int  # per block: trajectories (registers) or the block's warps (block, rows)
    threads: int  # per block
    blocks: int
    points: int  # points per lane P (registers, block; 0 for the rows form)
    lanes: int  # registers: lanes of the ring, nx = lanes x points; block: lanes of a warp
    shared_bytes: int  # block: the edge buffers and the coefficients; rows: the rows
    halo: int = 0  # rows form: periodic points of the stage input at each end
    cluster: int = 1  # block form: blocks a trajectory
    extra: int = 0  # block form: the first `extra` warps of a trajectory have one lane more
    left: int = 0  # block form: a warp's tail, the points its right neighbour reads
    right: int = 0  # block form: a warp's head, the points its left neighbour reads


def rk4_points(nx: int) -> tuple:
    """(points per lane P, lanes L) of the register form for ``nx = 32 P'``:
    the smallest P in ``RK4_POINTS_PER_LANE`` that is at least P' and divides
    nx, on ``L = nx / P`` lanes (the rest of the warp stores nothing)."""
    return next((p, nx // p) for p in RK4_POINTS_PER_LANE if 32 * p >= nx and nx % p == 0)


def rk4_shared_bytes(nx: int, halo: int, taps: int) -> int:
    """The rows form's shared memory: the stage input with ``halo`` periodic
    points at both ends, the fluxes, the step's start value and the k sum,
    then the scheme's ``taps`` coefficients, float32."""
    return 4 * (4 * nx + 2 * halo + taps)


def rk4_reach(taps: Mapping[int, Sequence[int]]) -> int:
    """How far a point's tap sums read, on either side."""
    return max(max(-t[0], t[-1]) for t in taps.values())


def rk4_edges(taps: Mapping[int, Sequence[int]]) -> tuple:
    """(left, right) of the block form: a warp's tail, the points left of a
    warp's first that its taps read and one more (the conservative
    divergence's left face: each lane computes that flux itself), and its
    head, the points right of its last."""
    return (1 - min(0, min(t[0] for t in taps.values())),
            max(0, max(t[-1] for t in taps.values())))


def rk4_wide(taps: Mapping[int, Sequence[int]]) -> bool:
    """Whether a scheme has more than ``MAX_TAPS`` taps an order or reaches
    beyond ``RK4_REACH`` points: the register forms do not take it, the
    block form takes it with its coefficients from global memory, copied
    once into shared memory."""
    return any(len(t) > MAX_TAPS for t in taps.values()) or rk4_reach(taps) > RK4_REACH


def _rk4_geometry(nx: int, points: int, left: int, right: int,
                  cluster: Optional[int]) -> Optional[tuple]:
    """(cluster, warps a block, lanes a warp, warps with one lane more) of
    the block form at P = ``points``: the trajectory's nx / P lanes over the
    fewest warps of 32 lanes, in ``cluster`` blocks or the fewest (a power of
    two) of at most ``RK4_BLOCK_WARPS`` warps, or past ``PORTABLE_CLUSTER``
    blocks of at most ``RK4_BLOCK_MAX_WARPS``; None where a warp would hold
    fewer points than the edges it publishes."""
    lanes = nx // points
    fewest = -(-lanes // 32)
    if cluster is None:
        sizes = (1, 2, 4, 8, 16)
        cluster = next((c for c in sizes if c <= PORTABLE_CLUSTER
                        and -(-fewest // c) <= RK4_BLOCK_WARPS),
                       next((c for c in sizes if -(-fewest // c) <= RK4_BLOCK_MAX_WARPS), None))
        if cluster is None:
            return None
    warps = -(-fewest // cluster)
    base, extra = divmod(lanes, warps * cluster)
    if not (1 <= cluster <= MAX_CLUSTER and warps <= RK4_BLOCK_MAX_WARPS and base >= 1
            and base * points >= max(left, right)):
        return None
    return cluster, warps, base, extra


def _rk4_block(batch: int, nx: int, taps: Mapping[int, Sequence[int]],
               cluster: Optional[int]) -> Optional[RK4Launch]:
    """The block form's launch, or None where its warps would hold fewer
    points than the edges they publish (or a forced cluster size does not
    fit). P: 4 up to 128 points, else 8, a classic scheme's taps compiled
    in at ``RK4_BLOCK_CLASSIC_POINTS`` (``_rk4_geometry`` deals out the
    lanes)."""
    left, right = rk4_edges(taps)
    points = RK4_BLOCK_POINTS[0] if nx <= 32 * RK4_BLOCK_POINTS[0] else RK4_BLOCK_POINTS[-1]
    geometry = _rk4_geometry(nx, points, left, right, cluster)
    if geometry is None:
        return None
    cluster, warps, base, extra = geometry
    shared = 4 * (3 * warps * (left + right) + sum(len(t) for t in taps.values()))
    return RK4Launch("block", warps, 32 * warps, batch * cluster, points, base, shared,
                     cluster=cluster, extra=extra, left=left, right=right)


def rk4_warp_spans(launch: RK4Launch) -> list:
    """The block form's warps in trajectory order (block r of the cluster
    holds warps r W to r W + W - 1): (first point, points) of each, as
    fused_rk4_block.cuh's WarpEdges places them."""
    total = launch.warps * launch.cluster
    spans = []
    for w in range(total):
        lanes = launch.lanes + (w < launch.extra)
        spans.append((launch.points * (w * launch.lanes + min(w, launch.extra)),
                      launch.points * lanes))
    return spans


def rk4_launch(batch: int, nx: int, classic: bool,
               taps: Mapping[int, Sequence[int]], cluster: Optional[int] = None) -> RK4Launch:
    """The launch of ``fused_rk4`` for ``batch`` trajectories of ``nx``
    points, for a classic scheme (taps compiled in) or not, of ``taps`` (by
    order). Up to ``RK4_REGISTER_MAX_NX`` (``32 RK4_SCHEME_MAX_POINTS`` for
    taps taken at run time) a warp owns a trajectory and warps never wait for
    each other, so a block is only a package of warps: as many as leave the
    launch ``NUM_SMS`` blocks, at most ``RK4_MAX_WARPS`` (8 timed 1-2% faster
    than 4 at B=10240 on an H100). Longer grids and wider schemes
    (``rk4_wide``), or any shape with ``cluster`` given: the block form
    (``_rk4_block``), the trajectory over the warps of ``cluster`` blocks
    (raises where that cluster does not fit). A wide scheme whose rows fit
    a block's shared memory (nx up to about 14,500) takes the rows form
    instead, a block of ``RK4_ROWS_THREADS`` threads a trajectory, its rows
    with a halo of the scheme's reach and its coefficients in shared memory:
    on an H100 it ran 40 taps at nx 128 3.3x faster than the block form
    (PERF.md), and it takes a reach beyond what a warp holds (80 taps on 32
    points reach 40)."""
    wide = rk4_wide(taps)
    if cluster is None and not wide and nx <= (
            RK4_REGISTER_MAX_NX if classic else 32 * RK4_SCHEME_MAX_POINTS):
        warps = min(RK4_MAX_WARPS, max(1, batch // NUM_SMS))
        points, lanes = rk4_points(nx)
        return RK4Launch("registers", warps, 32 * warps, -(-batch // warps), points, lanes, 0)
    halo = rk4_reach(taps)
    rows = rk4_shared_bytes(nx, halo, sum(len(t) for t in taps.values()))
    if cluster is None and wide and rows <= MAX_SHARED_BYTES:
        return RK4Launch("rows", RK4_ROWS_THREADS // 32, RK4_ROWS_THREADS, batch, 0, 0, rows,
                         halo)
    block = _rk4_block(batch, nx, taps, cluster)
    if block is None:
        raise ValueError(f"the block form does not take nx={nx} over a cluster of {cluster} "
                         f"blocks (1 to {MAX_CLUSTER}, at most {RK4_BLOCK_MAX_WARPS} warps a "
                         f"block, each warp holding the {max(rk4_edges(taps))} edge points)")
    return block


def rk4_is_classic(scheme: BaselineRK4) -> bool:
    """Whether the register form runs ``scheme`` with its taps compiled in
    (the classic accuracy-order-2 layouts of ``RK4_LAYOUTS``)."""
    eq = scheme.equation
    layout = {d: (t[0], len(t)) for d, t in scheme.taps.items()}
    return layout == RK4_LAYOUTS.get((eq.name, eq.conservative))


def rk4_refusal(scheme: BaselineRK4, nx: int) -> Optional[str]:
    """Why the kernel cannot run ``scheme`` on ``nx`` points, or None if it
    can. It runs the unforced equations at any nx that is a multiple of 32
    (the JAX kernel: multiples of 128) with contiguous taps of any number
    and reach: in registers up to ``RK4_REGISTER_MAX_NX`` (768 for taps at
    run time), over the warps of a block or a cluster above and for the
    wide schemes, in a block's shared memory where a scheme reaches further
    than a warp holds (``rk4_launch``)."""
    eq = scheme.equation
    if (eq.name, eq.conservative) not in RK4_LAYOUTS:
        return f"{eq.name} is forced: the kernel takes the unforced equations (KdV, KS)"
    if nx % 32:
        return f"nx={nx} is not a multiple of 32 (the JAX kernel takes multiples of 128)"
    for d, taps in scheme.taps.items():
        if not _contiguous_run(taps):
            return f"taps of order {d} {list(taps)} are not contiguous"
    return None


def fused_rk4(u: torch.Tensor, scheme: BaselineRK4, cluster: Optional[int] = None
              ) -> torch.Tensor:
    """``scheme.num_steps`` RK4 steps of the baseline scheme from ``u [B, nx]``
    in one launch of ``csrc/fused_rk4*.cu`` (its plain version for a CPU
    tensor). On the card a warp owns a trajectory up to 1024 points, the
    warps of a block or of a cluster of blocks above and for a wide scheme
    (``cluster`` forces the block form over that many blocks);
    ``rk4_refusal`` says which shapes and schemes it takes, ``rk4_launch``
    how."""
    with profiling.span(profiling.FUSED_RK4):
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
        launch = rk4_launch(batch, nx, rk4_is_classic(scheme), scheme.taps, cluster)
        wide = rk4_wide(scheme.taps)

        from pde_superresolution_torch.ops import _build

        lib = _build.load_library()
        out = torch.empty_like(u)
        orders = sorted(scheme.taps)
        pad = [0] * (MAX_ORDERS - len(orders))
        meta = (ctypes.c_int * 20)(
            EQUATION_CODES[scheme.equation.name],
            int(scheme.equation.conservative),
            nx, launch.warps, len(orders),
            *[len(scheme.taps[d]) for d in orders], *pad,
            *[scheme.taps[d][0] for d in orders], *pad,
            ("registers", "block", "rows").index(launch.form), launch.points, launch.lanes,
            launch.shared_bytes, launch.halo, launch.cluster, int(wide), launch.left, launch.right,
        )
        slots = 2 * RK4_REACH + 1  # order i's coefficient of tap t at [i][t + RK4_REACH]
        coefs = (ctypes.c_float * (MAX_ORDERS * slots))()
        wide_coefs = None
        if wide:  # every order's coefficients in tap order, on the card
            wide_coefs = scheme.device_coefficients.get(u.device)
            if wide_coefs is None:
                wide_coefs = scheme.device_coefficients[u.device] = torch.tensor(
                    [c for d in orders for c in scheme.coefficients[d]], dtype=torch.float32,
                    device=u.device)
        else:
            for i, d in enumerate(orders):
                for t, c in zip(scheme.taps[d], scheme.coefficients[d]):
                    coefs[i * slots + t + RK4_REACH] = c
        dt = scheme.dt
        scalars = (ctypes.c_float * 5)(
            scheme.grid.dx, float(getattr(scheme.equation, "eta", 0.0)),
            0.5 * dt, dt, dt / 6.0,
        )
        code = lib.pde_fused_rk4(
            u.data_ptr(), out.data_ptr(), batch, scheme.num_steps, meta, coefs, scalars,
            None if wide_coefs is None else wide_coefs.data_ptr(), _stream(u.device),
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

    Unforced equations only (KdV, KS), any ``accuracy_order`` or
    ``stencil_size``. The classic coefficients are computed here in float64
    and passed to the kernel by value (in global memory for a scheme of more
    than ``MAX_TAPS`` taps an order). Returns
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
    scheme = BaselineRK4(equation, grid, float(dt), int(num_steps), taps, coefs)

    def advance(u: torch.Tensor) -> torch.Tensor:
        return fused_rk4(u, scheme)

    advance.scheme = scheme
    return advance
