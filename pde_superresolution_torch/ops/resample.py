"""Coarse-graining ops: block-mean resampling and strided subsampling.

The PyTorch counterpart of ``pde_superresolution_tpu/ops/resample.py``.

* ``resample_mean`` is the finite-volume coarse-graining: a coarse cell
  average is the mean of the ``factor`` fine cell averages it contains.
* ``subsample`` is the finite-difference coarse-graining: keep every
  ``factor``-th point value.
"""

from __future__ import annotations

import torch


def resample_mean(u: torch.Tensor, factor: int, axis: int = -1) -> torch.Tensor:
    """Block-mean along ``axis``: coarse point j averages fine points
    ``j*factor .. (j+1)*factor - 1``."""
    if factor == 1:
        return u
    axis = axis % u.dim()
    n = u.shape[axis]
    if n % factor:
        raise ValueError(f"axis size {n} not divisible by factor {factor}")
    new_shape = u.shape[:axis] + (n // factor, factor) + u.shape[axis + 1 :]
    return torch.mean(u.reshape(new_shape), dim=axis + 1)


def subsample(u: torch.Tensor, factor: int, axis: int = -1) -> torch.Tensor:
    """Strided subsampling along ``axis``: coarse point j is fine point
    ``j*factor``, so both grids share x=0, matching ``Grid.resample``."""
    if factor == 1:
        return u
    axis = axis % u.dim()
    if u.shape[axis] % factor:
        raise ValueError(f"axis size {u.shape[axis]} not divisible by {factor}")
    index = [slice(None)] * u.dim()
    index[axis] = slice(None, None, factor)
    return u[tuple(index)]


RESAMPLE_FUNCS = {
    "mean": resample_mean,
    "subsample": subsample,
}
