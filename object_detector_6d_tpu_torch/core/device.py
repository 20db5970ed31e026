"""The device an entry point runs on."""

from __future__ import annotations

import contextlib

import numpy as np
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


def on_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its own device, anything else
    (numpy, lists, scalars) goes to ``checked_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    a = np.asarray(x)
    if not a.flags.writeable:  # torch warns on read-only memory
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=checked_device(device))


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products on the card (the reference's
    ``Precision.HIGHEST``), whatever the process has set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
