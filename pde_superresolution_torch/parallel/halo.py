"""Ring halo exchange and halo-padded stencil application.

The periodic 1-D grid is split into contiguous blocks over the mesh's
``"space"`` axis. Each RHS evaluation pads a block with ``halo`` points of
each ring neighbour (point-to-point sends on the space sub-group, O(halo)
bytes a message), after which all stencil and tower work is local.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from pde_superresolution_torch.parallel.mesh import SPACE_AXIS, axis_rank, axis_size


def _ring_shift(to_next: torch.Tensor, to_prev: torch.Tensor, group, me: int, size: int):
    """Send ``to_next`` to the next rank of the ring and ``to_prev`` to the
    previous one; return (what the previous rank sent its next, what the
    next rank sent its previous). P2P operations take global ranks."""
    nxt = dist.get_global_rank(group, (me + 1) % size)
    prv = dist.get_global_rank(group, (me - 1) % size)
    from_prev = torch.empty_like(to_next)
    from_next = torch.empty_like(to_prev)
    # the tags keep the two messages apart on a ring of two, where the
    # previous and the next rank are the same process
    ops = [
        dist.P2POp(dist.isend, to_next.contiguous(), nxt, group, tag=0),
        dist.P2POp(dist.isend, to_prev.contiguous(), prv, group, tag=1),
        dist.P2POp(dist.irecv, from_prev, prv, group, tag=0),
        dist.P2POp(dist.irecv, from_next, nxt, group, tag=1),
    ]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """Forward: ``[from_left, u, from_right]``, the left neighbour's right
    edge and the right neighbour's left edge. Backward, the transpose (JAX's
    ``ppermute`` transposes to the reverse permutation): each halo's
    cotangent goes back along the reversed ring and is added onto the edge it
    was read from."""

    @staticmethod
    def forward(ctx, u, halo, group, me, size):
        ctx.halo, ctx.group, ctx.me, ctx.size = halo, group, me, size
        from_left, from_right = _ring_shift(u[..., -halo:], u[..., :halo], group, me, size)
        return torch.cat([from_left, u, from_right], dim=-1)

    @staticmethod
    def backward(ctx, grad):
        h = ctx.halo
        # my left halo is the previous rank's right edge: its cotangent goes
        # back to the previous rank, my right halo's to the next. What the
        # previous rank sends back is its right halo's cotangent, my left
        # edge's; what the next rank sends, my right edge's.
        from_prev, from_next = _ring_shift(
            grad[..., -h:], grad[..., :h], ctx.group, ctx.me, ctx.size)
        grad_u = grad[..., h:-h].clone()
        grad_u[..., :h] += from_prev
        grad_u[..., -h:] += from_next
        return grad_u, None, None, None, None


def halo_exchange(u: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """Pad the last axis of this rank's block with its ring neighbours'
    edges on the mesh's space axis: ``[..., halo + local + halo]``.

    Differentiable. With a space axis of size 1 it is the periodic
    concatenation, with no communication.
    """
    if halo == 0:
        return u
    if u.shape[-1] < halo:
        raise ValueError(f"shard width {u.shape[-1]} < halo {halo}")
    size = axis_size(mesh, SPACE_AXIS)
    if size == 1:
        return torch.cat([u[..., -halo:], u, u[..., :halo]], dim=-1)
    return _HaloExchange.apply(u, halo, mesh.get_group(SPACE_AXIS),
                               axis_rank(mesh, SPACE_AXIS), size)


def apply_stencil_local(
    u_padded: torch.Tensor,
    coeffs: torch.Tensor,
    offsets: Sequence[float],
    halo: int,
    shift: float = 0.0,
    out_start: int = 0,
    out_size: int | None = None,
) -> torch.Tensor:
    """Block-local stencil application on halo-padded data (no wraparound).

    Computes ``out[..., j] = sum_i coeffs[..., j, i] * u_padded[..., halo +
    out_start + j + tap_i]`` for ``j in [0, out_size)``, ``tap_i =
    offsets[i] - shift``: the non-periodic counterpart of
    ``stencils.apply_stencil``, with its index convention.

    Args:
      out_start: first output position relative to the block's own origin
        (-1 also gives the face left of the block, for a conservative
        divergence).
      out_size: number of outputs (default: the block's width, the padded
        width less ``2 * halo``).
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    taps = offsets - shift
    int_taps = np.round(taps).astype(int)
    if not np.allclose(taps, int_taps, atol=1e-9):
        raise ValueError(f"offsets {offsets} with shift {shift} off-grid")
    local = u_padded.shape[-1] - 2 * halo
    if out_size is None:
        out_size = local
    lo = halo + out_start + int(int_taps.min())
    hi = halo + out_start + out_size - 1 + int(int_taps.max())
    if lo < 0 or hi >= u_padded.shape[-1]:
        raise ValueError(
            f"halo {halo} too small for taps {int_taps} with "
            f"out_start={out_start}, out_size={out_size}"
        )
    start = halo + out_start
    shifted = torch.stack(
        [u_padded[..., start + int(t): start + int(t) + out_size] for t in int_taps],
        dim=-1,
    )
    return torch.sum(coeffs * shifted, dim=-1)
