"""The numbers that decide ``correct``: the program's saves against the
reference's, for the same inputs.

  * ``max_gap``: the widest gap of any value, over the largest magnitude of
    the reference's save it belongs to, over every save of the request;
  * ``rms_gap``: the root mean square of the gaps over that of the
    reference's values, over every save after the first.

A value that is not finite, on either side, reads infinite.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("max_gap", "rms_gap")


def gaps(saves: torch.Tensor, ref: torch.Tensor) -> dict:
    if saves.shape != ref.shape:
        return {n: math.inf for n in NUMBERS}
    if not (torch.isfinite(saves).all() and torch.isfinite(ref).all()):
        return {n: math.inf for n in NUMBERS}
    diff = (saves - ref).double()
    scale = ref.double().abs().amax(dim=tuple(range(1, ref.dim())))
    widest = diff.abs().amax(dim=tuple(range(1, ref.dim())))
    max_gap = float((widest / scale).max())
    rms_gap = float(diff[1:].pow(2).mean().sqrt() / ref[1:].double().pow(2).mean().sqrt())
    return {"max_gap": max_gap, "rms_gap": rms_gap}


def worst(readings: list) -> dict:
    """Each number's largest reading over several requests."""
    return {n: max(r[n] for r in readings) for n in NUMBERS}


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit
