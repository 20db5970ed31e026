"""Depth-normal modality: quantized surface normals (port of
object_detector_6d_tpu/quant/depth_normal.py), plain PyTorch.

Per interior pixel (y, x in [5, dim-6)) with depth < distance_threshold:
a bilateral-gated least-squares depth gradient over 8 ring samples at
radius 5, the normal (1150 ddx, 1150 ddy, -det d) in float32, its
direction quantized by the octant rule (== the oracle's NORMAL_LUT,
ops/lut.py) to a one-hot byte, then the 5x5 numeric median
(ops/median.py). Every float step is one separately rounded float32
operation, in the reference's order; float -> int conversion truncates.

This is the plain version the K2 kernel (ops/quantize.py,
csrc/dn_quantize.cu) is held against, and the quantizer the training
side (quant/pyramid.py) uses. ``DepthNormal`` is the modality's front
end: one frame through K2.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.config import DepthNormalParams
from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.exact import sqrt_rn
from object_detector_6d_tpu_torch.ops.median import median5_onehot_u8

_RING_RADIUS = 5
# (dx, dy) ring sample offsets, matching the oracle's 8 accumBilateral calls
_RING = tuple(
    (dx, dy)
    for dy in (-_RING_RADIUS, 0, _RING_RADIUS)
    for dx in (-_RING_RADIUS, 0, _RING_RADIUS)
    if not (dx == 0 and dy == 0)
)


def _shift(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """img[..., y+dy, x+dx] with zero fill. img: [B, H, W]."""
    H, W = img.shape[-2:]
    p = torch.nn.functional.pad(img, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    y0, x0 = max(dy, 0), max(dx, 0)
    return p[:, y0:y0 + H, x0:x0 + W]


def ring_gradient(d: torch.Tensor, difference_threshold: int, inclusive: bool = False):
    """Bilateral-masked ring least squares: (ddx, ddy, det) int32 [B, H, W].

    The quantizer keeps a sample when ``|delta| < threshold`` (bit-exact
    against linemod.cpp); the real-valued LINEMOD normals
    (geom/normals.py) keep it when ``|delta| <= threshold``
    (``inclusive``), as the oracle's normal.cpp does."""
    A0 = torch.zeros_like(d)
    A1 = torch.zeros_like(d)
    A3 = torch.zeros_like(d)
    b0 = torch.zeros_like(d)
    b1 = torch.zeros_like(d)
    for dx, dy in _RING:
        delta = _shift(d, dx, dy) - d
        ok = (torch.abs(delta) <= difference_threshold if inclusive
              else torch.abs(delta) < difference_threshold)
        f = ok.to(torch.int32)
        A0 = A0 + f * (dx * dx)
        A1 = A1 + f * (dx * dy)
        A3 = A3 + f * (dy * dy)
        b0 = b0 + f * dx * delta
        b1 = b1 + f * dy * delta
    det = A0 * A3 - A1 * A1
    ddx = A3 * b0 - A1 * b1
    ddy = -A1 * b0 + A0 * b1
    return ddx, ddy, det


def interior_mask(H: int, W: int, device=None) -> torch.Tensor:
    """The oracle's valid interior (asymmetric -1 on the far edges)."""
    v = torch.arange(H, device=device)[:, None]
    u = torch.arange(W, device=device)[None, :]
    return ((v >= _RING_RADIUS) & (v < H - _RING_RADIUS - 1)
            & (u >= _RING_RADIUS) & (u < W - _RING_RADIUS - 1))


def octant_bins(vx: torch.Tensor, vy: torch.Tensor) -> torch.Tensor:
    """Arithmetic octant rule on the x10+10 cell indices (== NORMAL_LUT)."""
    cx = (vx - 10).to(torch.float32)
    cy = (vy - 10).to(torch.float32)
    t = torch.tensor(0.41421356, dtype=torch.float32, device=vx.device)
    acx = torch.abs(cx)
    acy = torch.abs(cy)
    horiz = acy <= t * acx
    vert = acx <= t * acy
    ge_x = cx >= 0
    ge_y = cy >= 0
    bin_h = torch.where(ge_x, 0, 4)
    bin_v = torch.where(ge_y, 2, 6)
    bin_d = torch.where(ge_y, torch.where(ge_x, 1, 3), torch.where(ge_x, 7, 5))
    return torch.where(horiz, bin_h, torch.where(vert, bin_v, bin_d))


def quantized_normals(
    depth: torch.Tensor,
    distance_threshold: int = 2000,
    difference_threshold: int = 50,
) -> torch.Tensor:
    """Quantized normal image(s) u8, values in {0, 1, 2, ..., 128}.

    ``depth``: raw depth [H, W] or [B, H, W] (any int dtype), in the unit
    of the thresholds (mm for the defaults).
    """
    single = depth.dim() == 2
    d = (depth[None] if single else depth).to(torch.int32)
    H, W = d.shape[-2:]
    ddx, ddy, det = ring_gradient(d, difference_threshold)

    nx = (1150 * ddx).to(torch.float32)
    ny = (1150 * ddy).to(torch.float32)
    nz = (-det * d).to(torch.float32)
    norm = sqrt_rn(nx * nx + ny * ny + nz * nz)
    inv = 1.0 / norm
    ten = torch.tensor(10.0, dtype=torch.float32, device=d.device)
    # truncation toward zero; masked (norm == 0) pixels give NaN here,
    # which is zeroed before the cast
    fx = torch.nan_to_num(nx * inv * ten + ten)
    fy = torch.nan_to_num(ny * inv * ten + ten)
    bins = octant_bins(fx.to(torch.int32), fy.to(torch.int32))
    q = torch.bitwise_left_shift(torch.ones_like(bins), bins)
    valid = (interior_mask(H, W, d.device) & (d < distance_threshold)
             & (norm > 0))
    q = torch.where(valid, q, 0).to(torch.uint8)
    out = median5_onehot_u8(q)
    return out[0] if single else out


class DepthNormal:
    """Depth-normal modality front end (mirrors linemod::DepthNormal)."""

    name = "DepthNormal"

    def __init__(self, params: DepthNormalParams | None = None, device="cuda"):
        self.params = params or DepthNormalParams()
        self.device = device

    def quantize(self, depth_u16) -> torch.Tensor:
        """[H, W] raw depth (any int dtype) -> [H, W] u8 quantized normals,
        through K2 at B=1; numpy (widened to the int32 K2 reads) goes to
        ``device``, a tensor stays on its own."""
        from object_detector_6d_tpu_torch.ops.quantize import dn_quantize_batched

        if not isinstance(depth_u16, torch.Tensor):
            depth_u16 = np.asarray(depth_u16).astype(np.int32)
        d = on_device(depth_u16, self.device)
        return dn_quantize_batched(d[None], int(self.params.distance_threshold),
                                   int(self.params.difference_threshold))[0]
