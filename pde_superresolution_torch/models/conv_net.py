"""Periodic 1-D convolution tower with 1x1 heads, as an ``nn.Module``.

The feature extractor of the learned-discretization model: ``num_layers``
convolutions of ``filters`` channels and width ``kernel_size`` with ReLU,
then one 1x1 head per derivative order. Periodic boundaries are an explicit
wrap pad of ``(k-1)//2`` cells on the left and ``k//2`` on the right before
a VALID convolution; for even ``k`` that is not what
``padding_mode="circular"`` pads.

Parameter names (the port's state dict): ``tower.{i}.weight`` [Co, Cin, K],
``tower.{i}.bias`` [Co], ``heads.{order}.weight`` [free, C, 1],
``heads.{order}.bias`` [free]. The JAX package keeps ``[K, Cin, Co]``; both
compute cross-correlation (``convert.params_from_jax`` transposes).

Heads are zero-initialized, so a fresh model reproduces the classic
baseline stencils exactly.

The JAX package's pure functions map onto the module: ``conv_tower_init(key,
config, head_dims)`` is ``ConvTower(config, head_dims)`` with
``reset_parameters(generator)`` (its ``state_dict()`` the params), and
``conv_tower_apply(params, u, periodic, dtype)`` is ``forward(u,
periodic=..., dtype=...)``, applied to a params dict with
``torch.func.functional_call`` (``StencilModel.coefficients``).

``periodic=False`` (the spatially sharded path, ``parallel/sharded.py``)
skips the wrap pad: each convolution is VALID, so the output is
``2 * receptive_radius`` points shorter than an input that its caller has
already padded with its neighbours' halos.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ConvTowerConfig:
    num_layers: int = 3
    filters: int = 32
    kernel_size: int = 5


def receptive_radius(config: ConvTowerConfig) -> int:
    """Half-width of the tower's receptive field (odd kernels)."""
    return config.num_layers * ((config.kernel_size - 1) // 2)


def periodic_pad(h: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Wrap-pad the last (spatial) axis of ``h`` [N, C, nx] for a VALID conv."""
    left = (kernel_size - 1) // 2
    right = kernel_size // 2
    return torch.cat([h[..., h.shape[-1] - left :], h, h[..., :right]], dim=-1)


class ConvTower(nn.Module):
    """``u [..., nx]`` -> ``{head: [..., nx, dims]}`` (``nx - 2 *
    receptive_radius`` points with ``periodic=False``).

    ``dtype`` (e.g. ``torch.bfloat16``) sets the activation compute dtype:
    the field and the float32 master parameters are cast on entry and the
    head outputs cast back to the parameters' dtype on exit, so the
    constraint projection downstream stays at full precision.
    """

    def __init__(
        self,
        config: ConvTowerConfig,
        head_dims: dict,
        in_channels: int = 1,
        device=None,
    ):
        super().__init__()
        self.kernel_size = config.kernel_size
        layers = []
        cin = in_channels
        for _ in range(config.num_layers):
            layers.append(
                nn.Conv1d(cin, config.filters, config.kernel_size, device=device)
            )
            cin = config.filters
        self.tower = nn.ModuleList(layers)
        self.heads = nn.ModuleDict(
            {str(name): nn.Conv1d(cin, dims, 1, device=device)
             for name, dims in head_dims.items()}
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal tower weights (truncated at two standard deviations,
        as ``jax.nn.initializers.he_normal``), zero biases, zero heads."""
        for conv in self.tower:
            cin, k = conv.weight.shape[1], conv.weight.shape[2]
            # 0.8796 is the standard deviation of a unit normal truncated
            # to [-2, 2]; dividing by it restores the target variance
            std = math.sqrt(2.0 / (cin * k)) / 0.87962566103423978
            w = torch.empty(conv.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            conv.weight.copy_(w)
            conv.bias.zero_()
        for head in self.heads.values():
            head.weight.zero_()
            head.bias.zero_()

    def forward(self, u: torch.Tensor, dtype: torch.dtype | None = None,
                periodic: bool = True) -> dict:
        batch_shape = u.shape[:-1]
        h = u.reshape(-1, 1, u.shape[-1])
        cast = (lambda x: x.to(dtype)) if dtype is not None else (lambda x: x)
        h = cast(h)
        for conv in self.tower:
            if periodic:
                h = periodic_pad(h, self.kernel_size)
            h = F.relu(F.conv1d(h, cast(conv.weight), cast(conv.bias)))
        out = {}
        for name, head in self.heads.items():
            z = F.conv1d(h, cast(head.weight), cast(head.bias))  # [N, dims, nx]
            if dtype is not None:
                z = z.to(head.weight.dtype)
            out[name] = z.transpose(-1, -2).reshape(batch_shape + (z.shape[-1], z.shape[1]))
        return out
