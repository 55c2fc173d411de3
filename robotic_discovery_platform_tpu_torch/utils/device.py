"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. The default is the card;
    asking for CUDA on a machine without it raises instead of falling
    back to the CPU (the CPU runs only when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
