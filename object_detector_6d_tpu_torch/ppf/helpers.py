"""Point-cloud helpers (port of object_detector_6d_tpu/ppf/helpers.py;
ppf_helpers.hpp).

The samplers, the pose transform and the noise are numpy, copied from
the reference. ``knn`` is brute force in PyTorch (the reference's
``|q|^2 + |p|^2 - 2 q.p`` squared distances) and ``compute_normals_pc3d``
batches the per-point 3x3 eigen problems (``core/exact.py`` ``eigh3``).
Their float sums are ``fixed_sum`` trees, fma chains or one written
order, so the card and the CPU give the same bits. PLY IO lives in io/ply.py.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.exact import div_rn, dot3, eigh3, fma_matmul
from object_detector_6d_tpu_torch.core.reduce import fixed_sum

# knn holds a [rows, N] float32 distance block and its sort at a time;
# the query rows of a block are chosen to keep it within this many entries
KNN_BLOCK_ENTRIES = 1 << 24


def sample_pc_uniform(pc: np.ndarray, sample_step: int) -> np.ndarray:
    """Every sample_step-th point (samplePCUniform)."""
    return np.asarray(pc)[::sample_step]


def sample_pc_by_quantization(
    pc: np.ndarray, relative_sample_step: float = 0.05
) -> np.ndarray:
    """Voxel-grid downsampling (samplePCByQuantization): one averaged
    point per occupied voxel; voxel size = relative step x bbox extent."""
    pc = np.asarray(pc, np.float32)
    xyz = pc[:, :3]
    lo = xyz.min(0)
    hi = xyz.max(0)
    extent = float(np.linalg.norm(hi - lo))
    step = max(relative_sample_step * extent, 1e-9)
    keys = np.floor((xyz - lo) / step).astype(np.int64)
    flat = (keys[:, 0] << 42) + (keys[:, 1] << 21) + keys[:, 2]
    uniq, inv = np.unique(flat, return_inverse=True)
    out = np.zeros((len(uniq), pc.shape[1]), np.float64)
    np.add.at(out, inv, pc.astype(np.float64))
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    out /= counts[:, None]
    if pc.shape[1] >= 6:
        nrm = out[:, 3:6]
        n = np.linalg.norm(nrm, axis=-1, keepdims=True)
        out[:, 3:6] = np.divide(nrm, n, out=np.zeros_like(nrm), where=n > 0)
    return out.astype(np.float32)


def knn(query, points, k: int = 1, device="cuda"):
    """Brute-force k nearest neighbours (replaces FLANN).

    Returns (indices [Q, k] int64, squared distances [Q, k]) on the
    inputs' device. Equal distances list the lower index first, as the
    reference's ``lax.top_k`` does: a stable sort of each row, over blocks
    of query rows of at most ``KNN_BLOCK_ENTRIES`` distances."""
    dev = next((x.device for x in (query, points) if isinstance(x, torch.Tensor)), device)
    query = on_device(query, dev, torch.float32)
    points = on_device(points, query.device, torch.float32)
    p2 = dot3(points, points)[None, :]
    rows = max(1, KNN_BLOCK_ENTRIES // max(1, points.shape[0]))
    idx, d2s = [], []
    for s in range(0, query.shape[0], rows):
        q = query[s:s + rows]
        d2 = dot3(q, q)[:, None] + p2 - 2.0 * fma_matmul(q, points.T)
        d, i = torch.sort(d2, dim=-1, stable=True)
        idx.append(i[:, :k])
        d2s.append(d[:, :k])
    return torch.cat(idx), torch.cat(d2s)


def compute_normals_pc3d(pc, k: int = 12, viewpoint=None, device="cuda") -> torch.Tensor:
    """PCA normals from k nearest neighbours (computeNormalsPC3d).

    Returns [N, 6] xyz + normal, normals oriented toward ``viewpoint``
    (the origin by default)."""
    pc = on_device(pc, device, torch.float32)
    xyz = pc[:, :3]
    idx, _ = knn(xyz, xyz, k)
    nbrs = xyz[idx]  # [N, k, 3]
    count = torch.tensor(float(k), dtype=xyz.dtype, device=xyz.device)
    centered = nbrs - div_rn(fixed_sum(nbrs, 1), count)[:, None, :]
    cov = fma_matmul(centered.transpose(1, 2), centered)
    # the smallest eigenvector of the 3x3 covariance
    normal = eigh3(cov)[1][..., 0]
    vp = (torch.zeros(3, dtype=xyz.dtype, device=xyz.device) if viewpoint is None
          else on_device(viewpoint, xyz.device, torch.float32))
    flip = dot3(normal, vp[None, :] - xyz)[:, None] < 0
    normal = torch.where(flip, -normal, normal)
    return torch.cat([xyz, normal], -1)


def transform_pc_pose(pc: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Transform xyz (+rotate normals) by a 4x4 pose (transformPCPose)."""
    pc = np.asarray(pc, np.float32)
    pose = np.asarray(pose, np.float32)
    out = pc.copy()
    out[:, :3] = pc[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    if pc.shape[1] >= 6:
        out[:, 3:6] = pc[:, 3:6] @ pose[:3, :3].T
    return out


def add_noise_pc(pc: np.ndarray, scale: float, seed: int = 0) -> np.ndarray:
    """Gaussian position noise (addNoisePC)."""
    rng = np.random.RandomState(seed)
    out = np.asarray(pc, np.float32).copy()
    out[:, :3] += rng.normal(0, scale, out[:, :3].shape).astype(np.float32)
    return out
