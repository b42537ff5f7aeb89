"""Low-level ops: resampling and spectral derivatives (re-exported here, as
the JAX package's ``ops`` does), and the hand-written CUDA kernels
(``fused_kernels``) with their build (``_build``)."""

from pde_superresolution_torch.ops.resample import (  # noqa: F401
    RESAMPLE_FUNCS,
    resample_mean,
    subsample,
)
from pde_superresolution_torch.ops.spectral import (  # noqa: F401
    smoothing_filter,
    spectral_derivative,
    wavenumbers,
)
