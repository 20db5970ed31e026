"""Depth registration and frame warping (port of
object_detector_6d_tpu/geom/registration.py; registerDepth and
warpFrame).

Both reproject every valid pixel and z-buffer it into the target image:
the reference's ``.at[idx].min()`` is ``scatter_reduce_(..., "amin")``
over flat pixel indices with one sentinel slot past the image for the
pixels that land nowhere, and the warped image's winner scatter
``.at[].max()`` is ``"amax"``. Pixel indices are
``round(fx * x / z + cx)`` in the reference's order: an index that moves
by one is a wrong pixel, not a rounding difference.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.exact import fma_matmul
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics, pixel_grid
from object_detector_6d_tpu_torch.geom.depth import rescale_depth


def _cloud(depth, K, Rt, device):
    """Metric depth, the cloud transformed by Rt [H, W, 3], and H, W."""
    d = on_device(depth, device)
    z = rescale_depth(d.to(torch.int32) if not d.dtype.is_floating_point else d)
    H, W = z.shape
    intr = Intrinsics.from_matrix(K, device=z.device)
    u, v = pixel_grid(H, W, device=z.device)
    pts = torch.stack([z * (u - intr.cx) / intr.fx, z * (v - intr.cy) / intr.fy, z], -1)
    Rt = torch.as_tensor(np.asarray(Rt, np.float32), device=z.device)
    pts = fma_matmul(pts, Rt[:3, :3].T) + Rt[:3, 3]
    return pts, H, W


def _project(pts, K, out_h: int, out_w: int):
    """Flat target index per point (out_h * out_w = the sentinel slot)
    and its depth (inf where it lands nowhere)."""
    intr = Intrinsics.from_matrix(K, device=pts.device)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    # clamp before the cast (in-frame values are unaffected): a float
    # beyond int64 range, or NaN, has no defined conversion
    u = torch.round(intr.fx * x / z + intr.cx).nan_to_num(-1.0).clamp(-1e9, 1e9).to(torch.int64)
    v = torch.round(intr.fy * y / z + intr.cy).nan_to_num(-1.0).clamp(-1e9, 1e9).to(torch.int64)
    ok = (u >= 0) & (u < out_w) & (v >= 0) & (v < out_h) & (z > 0) & torch.isfinite(z)
    flat = torch.where(ok, v * out_w + u, out_h * out_w).reshape(-1)
    zz = torch.where(ok, z, float("inf")).reshape(-1)
    return flat, zz


def _zbuffer(flat, zz, n: int):
    zbuf = torch.full((n + 1,), float("inf"), dtype=torch.float32, device=zz.device)
    return zbuf.scatter_reduce_(0, flat, zz, "amin")


def register_depth(depth, K_src, K_dst, Rt, out_shape: tuple, device="cuda") -> torch.Tensor:
    """Reproject ``depth`` (u16 mm or f32 m, [H, W]) into a second camera.

    ``Rt`` maps source-camera points into the target camera frame.
    Returns f32 metres [out_h, out_w] with NaN holes (no dilation of
    missing data)."""
    pts, _, _ = _cloud(depth, K_src, Rt, device)
    out_h, out_w = out_shape
    flat, zz = _project(pts, K_dst, out_h, out_w)
    depth_out = _zbuffer(flat, zz, out_h * out_w)[:-1].reshape(out_h, out_w)
    return torch.where(torch.isfinite(depth_out), depth_out, float("nan"))


def warp_frame(depth, K, Rt, image=None, device="cuda"):
    """Warp a depth frame (and optionally an image [H, W] or [H, W, C]) by
    a rigid transform within the same camera (cv::rgbd::warpFrame: a
    forward warp with z-buffering; unobserved target pixels are NaN / 0).
    Returns the warped depth, or (depth, image)."""
    pts, H, W = _cloud(depth, K, Rt, device)
    flat, zz = _project(pts, K, H, W)
    zbuf = _zbuffer(flat, zz, H * W)
    warped = torch.where(torch.isfinite(zbuf[:-1]), zbuf[:-1], float("nan")).reshape(H, W)
    if image is None:
        return warped
    img = on_device(image, pts.device)
    # winner takes the pixel: a source pixel writes where its depth won
    won = torch.abs(zbuf[flat] - zz) < 1e-9
    tgt = torch.where(won, flat, H * W)
    src = img.reshape(H * W, -1)
    src = torch.where(won[:, None], src, torch.zeros_like(src))
    out = torch.zeros((H * W + 1, src.shape[1]), dtype=img.dtype, device=img.device)
    out.scatter_reduce_(0, tgt[:, None].expand_as(src), src, "amax")
    return warped, out[:-1].reshape(img.shape)
