"""FALS surface normals (port of object_detector_6d_tpu/geom/normals.py).

Only ``FalsNormals`` and ``normals_fals``, the method the detect slice
uses. With unit rays v and range r = |p|, the scaled normal minimizes
sum_w (v_i . n - 1/r_i)^2 over the 5x5 window: n = M^-1 b with
M = sum v v^T and b = sum v/r.

The per-pixel M^-1 is built on the host exactly as the reference builds
it: float64 rays, the outer products cast to float32 (the reference's
``jnp.asarray`` of a float64 array without x64), a float32 box sum in
the same accumulation order, then ``np.linalg.inv`` and a float32 cast.
M is near-singular, so any other rounding of M^-1 moves normals.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _box_sum(x, radius: int):
    """Separable box sum over the leading [H, W] dims with zero padding;
    rows then columns, each accumulated left to right (numpy or torch)."""
    k = 2 * radius + 1
    H, W = x.shape[0], x.shape[1]
    if isinstance(x, np.ndarray):
        p = np.pad(x, [(radius, radius)] + [(0, 0)] * (x.ndim - 1))
    else:
        p = torch.nn.functional.pad(
            x.movedim(0, -1), (radius, radius)).movedim(-1, 0)
    acc = p[0:H]
    for i in range(1, k):
        acc = acc + p[i:i + H]
    if isinstance(acc, np.ndarray):
        p = np.pad(acc, [(0, 0), (radius, radius)] + [(0, 0)] * (acc.ndim - 2))
    else:
        p = torch.nn.functional.pad(
            acc.movedim(1, -1), (radius, radius)).movedim(-1, 1)
    out = p[:, 0:W]
    for i in range(1, k):
        out = out + p[:, i:i + W]
    return out


class FalsNormals:
    """Per-(H, W, K, window) FALS normal estimator with cached M^-1."""

    def __init__(self, height: int, width: int, K, window_size: int = 5):
        self.height = height
        self.width = width
        self.window_size = window_size
        K = np.asarray(K, dtype=np.float64)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        rays = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones((height, width))], axis=-1
        )
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        radius = window_size // 2
        vvt = (rays[..., :, None] * rays[..., None, :]).astype(np.float32)
        M = _box_sum(vvt, radius)
        self.minv = np.linalg.inv(M).astype(np.float32)  # [H, W, 3, 3]
        self.rays = rays.astype(np.float32)  # [H, W, 3]

    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        """points [H, W, 3] (metres, NaN-invalid) -> normals [H, W, 3]."""
        dev = points.device
        rays = torch.as_tensor(self.rays, device=dev)
        minv = torch.as_tensor(self.minv, device=dev)
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        r = torch.sqrt(x * x + y * y + z * z)
        valid = torch.isfinite(r) & (r > 0)
        inv_r = torch.where(valid, 1.0 / torch.where(valid, r, 1.0), 0.0)
        b = _box_sum(rays * inv_r[..., None], self.window_size // 2)
        n = (minv[..., 0] * b[..., 0:1] + minv[..., 1] * b[..., 1:2]
             + minv[..., 2] * b[..., 2:3])
        norm = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1]
                          + n[..., 2] * n[..., 2])[..., None]
        n = n / norm
        flip = (n[..., 0] * rays[..., 0] + n[..., 1] * rays[..., 1]
                + n[..., 2] * rays[..., 2])[..., None] > 0
        n = torch.where(flip, -n, n)
        bad = (~valid) | (norm[..., 0] == 0) | ~torch.isfinite(norm[..., 0])
        return torch.where(bad[..., None], torch.full_like(n, float("nan")), n)


@functools.lru_cache(maxsize=8)
def _cached_fals(height: int, width: int, k_bytes: bytes, window_size: int) -> FalsNormals:
    K = np.frombuffer(k_bytes, dtype=np.float64).reshape(3, 3)
    return FalsNormals(height, width, K, window_size)


def normals_fals(points: torch.Tensor, K, window_size: int = 5) -> torch.Tensor:
    """Convenience wrapper over :class:`FalsNormals` (estimator cached)."""
    H, W, _ = points.shape
    k_bytes = np.ascontiguousarray(np.asarray(K, dtype=np.float64)).tobytes()
    return _cached_fals(H, W, k_bytes, window_size)(points)
