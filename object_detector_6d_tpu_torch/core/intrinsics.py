"""Pinhole camera intrinsics (port of object_detector_6d_tpu/core/intrinsics.py).

fx, fy, cx, cy with a per-pyramid-level ``scale`` (level n halves the
focal lengths and centres n times), ``project`` / ``reproject``, the 3x3
``matrix`` and ``pixel_grid``. Values are float32 0-dim tensors, as the
reference's are float32 jnp scalars, so each step rounds exactly like
the reference's (``add_view``'s anchor point).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class Intrinsics:
    """fx, fy, cx, cy pinhole intrinsics (float32 tensors)."""

    def __init__(self, fx, fy, cx, cy):
        self.fx = fx
        self.fy = fy
        self.cx = cx
        self.cy = cy

    @classmethod
    def from_matrix(cls, K, device=None) -> "Intrinsics":
        K = torch.as_tensor(np.asarray(K, np.float32), device=device)
        return cls(K[0, 0], K[1, 1], K[0, 2], K[1, 2])

    def matrix(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, z, self.cx]),
                            torch.stack([z, self.fy, self.cy]),
                            torch.stack([z, z, o])])

    def scale(self, level: int) -> "Intrinsics":
        """Intrinsics for pyramid level ``level`` (kinfu::Intr::scale)."""
        s = 1.0 / (1 << level)
        return Intrinsics(self.fx * s, self.fy * s, self.cx * s, self.cy * s)

    def project(self, pts: torch.Tensor) -> torch.Tensor:
        """Camera-frame points [..., 3] -> pixels [..., 2]: u = fx*x/z + cx."""
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return torch.stack([self.fx * x / z + self.cx, self.fy * y / z + self.cy], dim=-1)

    def reproject(self, u, v, z) -> torch.Tensor:
        """Back-project pixel (u, v) at depth z: x = z*(u-cx)/fx, y = z*(v-cy)/fy."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.fx.device)
        x = z * (u - self.cx) / self.fx
        y = z * (v - self.cy) / self.fy
        return torch.stack([x, y, torch.broadcast_to(z, x.shape)], dim=-1)

    def __repr__(self):
        return (f"Intrinsics(fx={float(self.fx)}, fy={float(self.fy)}, "
                f"cx={float(self.cx)}, cy={float(self.cy)})")


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) pixel-coordinate images of shape [H, W]."""
    u = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    v = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    return u, v
