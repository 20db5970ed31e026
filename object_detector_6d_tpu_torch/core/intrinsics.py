"""Pinhole camera intrinsics (port of object_detector_6d_tpu/core/intrinsics.py).

Only what the depth-only detect slice uses: ``from_matrix`` and
``reproject``. Values are float32 0-dim tensors, as the reference's are
float32 jnp scalars, so ``reproject`` rounds exactly like the reference
(``add_view``'s anchor point).
"""

from __future__ import annotations

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

    def reproject(self, u, v, z) -> torch.Tensor:
        """Back-project pixel (u, v) at depth z: x = z*(u-cx)/fx, y = z*(v-cy)/fy."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.fx.device)
        x = z * (u - self.cx) / self.fx
        y = z * (v - self.cy) / self.fy
        return torch.stack([x, y, torch.broadcast_to(z, x.shape)], dim=-1)
