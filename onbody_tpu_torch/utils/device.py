"""Where an entry point runs: the CUDA device unless the caller names
another. Without a CUDA device, None raises; nothing falls back to the
CPU on its own."""

from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """torch.device(device), or the CUDA device for None (raising when
    there is none)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")
