"""Depth cleaning (port of object_detector_6d_tpu/geom/cleaner.py;
DepthCleaner NIL).

A bilateral filter in depth only over a 7x7 window: a neighbour weighs
exp(-0.5 ((z_n - z) / sigma_z(z))^2) with the sensor's axial noise
model sigma_z(z) = 0.0012 + 0.0019 (z - 0.4)^2 [m] of the centre pixel.
Invalid (0 / NaN) depths are excluded and stay invalid. The window is
summed in the reference's order, rows (dy) then columns (dx).
"""

from __future__ import annotations

import torch

from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.exact import exp_rn
from object_detector_6d_tpu_torch.geom.depth import rescale_depth


def clean_depth(depth, window_size: int = 7, device="cuda") -> torch.Tensor:
    """Noise-model-weighted depth smoothing of one [H, W] frame.

    Integer input (mm) returns the same integer dtype in mm (u16 in, u16
    out); float input (m) returns float32 m. Tensors stay on their
    device; numpy input goes to ``device``."""
    d = on_device(depth, device)
    is_int = not d.dtype.is_floating_point
    z = rescale_depth(d.to(torch.int32) if is_int else d)
    H, W = z.shape
    valid = torch.isfinite(z)
    zf = torch.where(valid, z, 0.0)

    sigma = 0.0012 + 0.0019 * torch.square(zf - 0.4)
    r = window_size // 2
    num = torch.zeros_like(zf)
    den = torch.zeros_like(zf)
    zp = torch.nn.functional.pad(zf, (r, r, r, r))
    vp = torch.nn.functional.pad(valid.to(torch.float32), (r, r, r, r))
    offsets = [(dy, dx) for dy in range(window_size) for dx in range(window_size)]
    # the window's exponents in one correctly rounded exp (one cast to float64)
    ws = exp_rn(torch.stack([-0.5 * torch.square((zp[dy:dy + H, dx:dx + W] - zf) / sigma)
                             for dy, dx in offsets]))
    for w, (dy, dx) in zip(ws, offsets):
        zn = zp[dy:dy + H, dx:dx + W]
        w = w * vp[dy:dy + H, dx:dx + W]
        num = num + w * zn
        den = den + w
    out = torch.where(valid & (den > 0), num / den, float("nan"))
    if is_int:
        # via int32: torch has no float -> uint16 conversion
        mm = torch.where(torch.isfinite(out), torch.round(out * 1000.0), 0.0)
        return mm.to(torch.int32).to(d.dtype)
    return out
