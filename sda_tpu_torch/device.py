"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and unavailable: there is no silent CPU
    fallback, the caller passes ``device="cpu"`` to run on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return dev
