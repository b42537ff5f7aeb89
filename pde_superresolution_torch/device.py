"""Device selection shared by the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU. A
missing CUDA device is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; raises if a CUDA device is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device
