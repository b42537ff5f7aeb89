"""Learned discretization models."""

from pde_superresolution_torch.models.conv_net import (  # noqa: F401
    ConvTower,
    ConvTowerConfig,
)
from pde_superresolution_torch.models.stencil_net import (  # noqa: F401
    ModelConfig,
    StencilModel,
)
