"""The device an entry point runs on."""

from __future__ import annotations

import torch


def checked_device(device) -> torch.device:
    """``device`` as a torch.device. Asking for the card where none is
    visible raises: no entry point carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA card is visible; pass device='cpu' to "
            "run the plain twins on the host")
    return device
