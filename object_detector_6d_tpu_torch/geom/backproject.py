"""Depth -> organized point cloud (port of object_detector_6d_tpu/geom/backproject.py).

x = z*(u-cx)/fx, y = z*(v-cy)/fy in float32, with the reference's
operation order (a true division by fx, not a reciprocal product).
``depth_to_3d_sparse`` does the same for pixel lists.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics
from object_detector_6d_tpu_torch.geom.depth import rescale_depth


def depth_to_3d(depth: torch.Tensor, K) -> torch.Tensor:
    """Organized cloud [H, W, 3] (metres) from depth [H, W] and 3x3 K."""
    z = rescale_depth(depth)
    H, W = z.shape
    Kf = np.asarray(K, np.float32)
    fx, fy, cx, cy = (float(Kf[0, 0]), float(Kf[1, 1]),
                      float(Kf[0, 2]), float(Kf[1, 2]))
    # f32 grid minus f32 scalar, as the reference's pixel_grid - cx
    u = torch.arange(W, dtype=torch.float32, device=z.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=z.device)[:, None]
    ucx = u - torch.tensor(cx, dtype=torch.float32, device=z.device)
    vcy = v - torch.tensor(cy, dtype=torch.float32, device=z.device)
    x = z * ucx / torch.tensor(fx, dtype=torch.float32, device=z.device)
    y = z * vcy / torch.tensor(fy, dtype=torch.float32, device=z.device)
    return torch.stack([x, y, z], dim=-1)


def depth_to_3d_sparse(u, v, z, K, device="cuda") -> torch.Tensor:
    """Back-project sparse pixel lists (depthTo3dSparse) -> [N, 3].

    ``z`` must already be metric (float); use rescale_depth for raw u16.
    Tensors stay on their device; numpy input goes to ``device``."""
    dev = next((x.device for x in (u, v, z) if isinstance(x, torch.Tensor)), device)
    u, v, z = (on_device(x, dev, torch.float32) for x in (u, v, z))
    return Intrinsics.from_matrix(K, device=z.device).reproject(u, v, z)
