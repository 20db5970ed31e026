"""Plane extraction from organized clouds (port of
object_detector_6d_tpu/geom/plane.py; RgbdPlane's block-merge
segmentation).

* device: per-block least-squares plane fits, batched 3x3 covariances
  and ``core/exact.py`` ``eigh3``; block validity from the share of
  finite points and the curvature ratio (smallest / total eigenvalue).
  Every float sum is a ``fixed_sum`` tree or one written order, so the
  card and the CPU give the same bits;
* host (hundreds of blocks): the reference's union of 4-adjacent
  similar block planes (angle and distance thresholds), copied as it
  stands;
* device: every pixel to its nearest active plane by |n.p + d|
  (``argmin`` keeps the first of equal distances, as the reference's).

Output mirrors RgbdPlane: a label image ([H, W] u8, 255 = no plane) and
plane coefficients [K, 4] with unit normals, n.p + d = 0, normals
oriented toward the camera.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.exact import div_rn, dot3, eigh3, fma_matmul
from object_detector_6d_tpu_torch.core.reduce import fixed_sum


def _block_planes(points: torch.Tensor, block_size: int):
    """Per-block plane fits: (normals [nB, 3], ds [nB], mse [nB],
    valid [nB], centroids [nB, 3])."""
    H, W, _ = points.shape
    bh, bw = H // block_size, W // block_size
    p = points[:bh * block_size, :bw * block_size]
    blocks = p.reshape(bh, block_size, bw, block_size, 3).permute(0, 2, 1, 3, 4)
    blocks = blocks.reshape(bh * bw, block_size * block_size, 3)
    finite = torch.isfinite(blocks).all(-1)
    w = finite.to(torch.float32)
    cnt = torch.clamp(w.sum(-1), min=1.0)
    b0 = torch.where(finite[..., None], blocks, 0.0)
    mean = div_rn(fixed_sum(b0, 1), cnt[:, None])
    centered = torch.where(finite[..., None], blocks - mean[:, None, :], 0.0)
    upper = {(i, j): fixed_sum(centered[..., i] * centered[..., j], 1)
             for i in range(3) for j in range(i, 3)}
    cov = torch.stack([torch.stack([upper[min(i, j), max(i, j)] for j in range(3)], -1)
                       for i in range(3)], -2)
    evals, evecs = eigh3(div_rn(cov, cnt[:, None, None]))
    normal = evecs[..., 0]
    # orient toward the camera (-z half-space; the camera looks down +z)
    normal = torch.where((normal[:, 2] > 0)[:, None], -normal, normal)
    d = -dot3(normal, mean)
    mse = evals[:, 0]
    total = torch.clamp((evals[:, 0] + evals[:, 1]) + evals[:, 2], min=1e-12)
    valid = (w.sum(-1) > 0.5 * block_size * block_size) & (mse / total < 1e-2)
    return normal, d, mse, valid, mean


def _assign_pixels(points, normals, ds, active, dist_threshold: float):
    """Per-pixel best plane by |n.p + d| (masked by ``active``)."""
    dist = torch.abs(fma_matmul(torch.nan_to_num(points), normals.T) + ds)
    dist = torch.where(active, dist, float("inf"))
    bestd, best = torch.min(dist, -1)
    ok = (bestd < np.float32(dist_threshold)) & torch.isfinite(points).all(-1)
    return torch.where(ok, best, 255).to(torch.uint8)


@dataclasses.dataclass
class PlaneExtraction:
    labels: np.ndarray  # [H, W] u8, 255 = none
    coefficients: np.ndarray  # [K, 4]


def extract_planes(
    points,
    block_size: int = 40,
    angle_threshold_deg: float = 10.0,
    dist_threshold: float = 0.01,
    min_blocks: int = 2,
    max_planes: int = 16,
    device="cuda",
) -> PlaneExtraction:
    """RgbdPlane-style segmentation of an organized cloud [H, W, 3].
    A tensor stays on its device; numpy input goes to ``device``."""
    pts = on_device(points, device, torch.float32)
    H, W, _ = pts.shape
    bh, bw = H // block_size, W // block_size
    normal, d, mse, valid, mean = (x.cpu().numpy() for x in _block_planes(pts, block_size))

    # host: union of adjacent similar block planes
    cos_thr = np.cos(np.deg2rad(angle_threshold_deg))
    parent = np.arange(bh * bw)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def similar(i, j):
        if not (valid[i] and valid[j]):
            return False
        if np.dot(normal[i], normal[j]) < cos_thr:
            return False
        return abs(np.dot(normal[i], mean[j]) + d[i]) < dist_threshold

    for by in range(bh):
        for bx in range(bw):
            i = by * bw + bx
            for nj in ((by, bx + 1), (by + 1, bx)):
                if nj[0] < bh and nj[1] < bw:
                    j = nj[0] * bw + nj[1]
                    if similar(i, j):
                        pa, pb = find(i), find(j)
                        if pa != pb:
                            parent[pb] = pa

    groups = {}
    for i in range(bh * bw):
        if valid[i]:
            groups.setdefault(find(i), []).append(i)
    planes = []
    for members in groups.values():
        if len(members) < min_blocks:
            continue
        ns = normal[members]
        ref = ns[0]
        ns = np.where((ns @ ref)[:, None] < 0, -ns, ns)
        n_mean = ns.mean(0)
        n_mean /= np.linalg.norm(n_mean)
        centroid = mean[members].mean(0)
        planes.append((n_mean, -float(np.dot(n_mean, centroid)), len(members)))
    planes.sort(key=lambda t: -t[2])
    planes = planes[:max_planes]

    if not planes:
        return PlaneExtraction(np.full((H, W), 255, np.uint8), np.zeros((0, 4), np.float32))
    Kn = np.stack([p[0] for p in planes]).astype(np.float32)
    Kd = np.array([p[1] for p in planes], np.float32)
    pad = max_planes - len(planes)
    active = np.zeros(max_planes, bool)
    active[:len(planes)] = True
    dev = pts.device
    labels = _assign_pixels(pts, torch.as_tensor(np.pad(Kn, ((0, pad), (0, 0))), device=dev),
                            torch.as_tensor(np.pad(Kd, (0, pad)), device=dev),
                            torch.as_tensor(active, device=dev), dist_threshold)
    coeffs = np.concatenate([Kn, Kd[:, None]], -1)
    return PlaneExtraction(labels.cpu().numpy(), coeffs)
