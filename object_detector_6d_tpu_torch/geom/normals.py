"""Surface normals (port of object_detector_6d_tpu/geom/normals.py).

Four estimators, as the reference has:

* ``FalsNormals`` / ``normals_fals``, the method the detect path uses:
  with unit rays v and range r = |p|, the scaled normal minimizes
  sum_w (v_i . n - 1/r_i)^2 over the 5x5 window: n = M^-1 b with
  M = sum v v^T and b = sum v/r. The per-pixel M^-1 is built on the host
  exactly as the reference builds it: float64 rays, the outer products
  cast to float32 (the reference's ``jnp.asarray`` of a float64 array
  without x64), a float32 box sum in the same accumulation order, then
  ``np.linalg.inv`` and a float32 cast. M is near-singular, so any other
  rounding of M^-1 moves normals.
* ``normals_linemod``: the oracle's LINEMOD method on raw u16 depth, the
  ring gradient of the DepthNormal quantizer with its inclusive cutoff.
* ``normals_cross``: central-difference cross products (odometry).
* ``normals_sri``: the smoothed range image differentiated in image space.

Tensors stay on their device; numpy input goes to ``device`` (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.exact import norm3, sqrt_rn
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics, pixel_grid
from object_detector_6d_tpu_torch.core.se3 import cross
from object_detector_6d_tpu_torch.quant.depth_normal import interior_mask, ring_gradient


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
        r = sqrt_rn(x * x + y * y + z * z)
        valid = torch.isfinite(r) & (r > 0)
        inv_r = torch.where(valid, 1.0 / torch.where(valid, r, 1.0), 0.0)
        b = _box_sum(rays * inv_r[..., None], self.window_size // 2)
        n = (minv[..., 0] * b[..., 0:1] + minv[..., 1] * b[..., 1:2]
             + minv[..., 2] * b[..., 2:3])
        norm = sqrt_rn(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1]
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


def gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along ``dim`` with unit spacing: central
    differences (a[i+1] - a[i-1]) * 0.5 inside, one-sided at the edges."""
    n = a.shape[dim]
    lo = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    hi = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([lo, inner, hi], dim=dim)


def _nan_where(bad: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.where(bad[..., None], torch.full_like(n, float("nan")), n)


def normals_linemod(depth_u16, K, difference_threshold: int = 50,
                    device="cuda") -> torch.Tensor:
    """RgbdNormals LINEMOD method: real-valued normals [H, W, 3] from RAW
    u16 depth [H, W].

    The depth gradient (z_u, z_v) is the DepthNormal quantizer's
    bilateral-masked r=5 ring least squares with the oracle's inclusive
    cutoff; the normal is normalize(fx z_u, fy z_v, -((u+1-cx) z_u +
    (v+1-cy) z_v + z)), camera-facing. Ring-margin borders are (0, 0, 0);
    pixels with zero depth or every ring sample rejected are NaN.
    """
    d = on_device(depth_u16, device).to(torch.int32)
    H, W = d.shape
    Kf = np.asarray(K, np.float64)
    fx, fy, cx, cy = (torch.tensor(np.float32(Kf[i, j]), device=d.device)
                      for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    ddx, ddy, det = (x[0] for x in ring_gradient(d[None], difference_threshold,
                                                  inclusive=True))
    detf = det.to(torch.float32)
    zero = det == 0
    gu = ddx.to(torch.float32) / torch.where(zero, 1.0, detf)
    gv = ddy.to(torch.float32) / torch.where(zero, 1.0, detf)
    u, v = pixel_grid(H, W, device=d.device)
    nx = fx * gu
    ny = fy * gv
    # the +1 pixel offsets are the oracle's (the reference measured them
    # on ramps: u+1-cx reproduces its values, u-cx is ~0.05 deg off)
    nz = -((u + 1.0 - cx) * gu + (v + 1.0 - cy) * gv + d.to(torch.float32))
    norm = sqrt_rn(nx * nx + ny * ny + nz * nz)
    inv = 1.0 / torch.where(norm > 0, norm, 1.0)
    n = torch.stack([nx * inv, ny * inv, nz * inv], -1)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    n = _nan_where(zero | (d == 0), n)
    return torch.where(interior_mask(H, W, d.device)[..., None], n, 0.0)


def normals_cross(points, device="cuda") -> torch.Tensor:
    """Central-difference cross-product normals [H, W, 3] of an organized
    cloud [H, W, 3]: camera-oriented, NaN where a contributing neighbour
    is invalid."""
    points = on_device(points, device, torch.float32)
    dx = gradient(points, 1)
    dy = gradient(points, 0)
    n = cross(dy, dx)
    norm = norm3(n)[..., None]
    n = n / norm
    n = torch.where(n[..., 2:3] > 0, -n, n)
    return _nan_where(~torch.isfinite(norm[..., 0]) | (norm[..., 0] == 0), n)


def normals_sri(points, K, window_size: int = 5, device="cuda") -> torch.Tensor:
    """SRI-method normals [H, W, 3] (RGBD_NORMALS_METHOD_SRI class).

    The range image r = |p| is box-smoothed over the valid pixels and
    differentiated in image space; with p = r(u, v) ray(u, v) the
    tangents are t_u = r_u ray + r ray_u, and the normal is their cross
    product, camera-oriented."""
    points = on_device(points, device, torch.float32)
    H, W, _ = points.shape
    dev = points.device
    intr = Intrinsics.from_matrix(K, device=dev)
    u, v = pixel_grid(H, W, device=dev)
    rays = torch.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                        torch.ones_like(u)], -1)
    rays_u = rays / norm3(rays)[..., None]
    d_du = gradient(rays_u, 1)
    d_dv = gradient(rays_u, 0)

    r = norm3(points)
    valid = torch.isfinite(r) & (r > 0)
    w = valid.to(torch.float32)
    r0 = torch.where(valid, r, 0.0)
    radius = window_size // 2
    rs = _box_sum(r0, radius) / torch.clamp(_box_sum(w, radius), min=1.0)
    r_u = gradient(rs, 1)
    r_v = gradient(rs, 0)

    t_u = r_u[..., None] * rays_u + rs[..., None] * d_du
    t_v = r_v[..., None] * rays_u + rs[..., None] * d_dv
    n = cross(t_v, t_u)
    norm = norm3(n)[..., None]
    n = n / norm
    flip = (n[..., 0] * rays_u[..., 0] + n[..., 1] * rays_u[..., 1]
            + n[..., 2] * rays_u[..., 2])[..., None] > 0
    n = torch.where(flip, -n, n)
    bad = (~valid) | (norm[..., 0] == 0) | ~torch.isfinite(norm[..., 0])
    return _nan_where(bad, n)
