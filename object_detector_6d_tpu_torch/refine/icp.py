"""Point-to-plane ICP with brute-force nearest neighbours and SE(3)
updates (port of object_detector_6d_tpu/refine/icp.py).

The host-orchestrated detect path refines its hypotheses here: every
iteration associates each model point with its nearest scene point (one
[N, M] distance matrix whose cross term is a matrix product), rejects
outliers by the median absolute deviation scaled by ``rejection_scale``,
solves the 6x6 normal equations of the point-to-plane linearization in
float32 and retracts with SE3.exp, coarse to fine over ``num_levels``
strided subsamples of the model cloud.

Conventions as the reference: clouds are [N, 6] xyz + normal, the model
moves, the scene stays, the returned pose maps model -> scene, scene
normals drive the metric. Plain functions on tensors; they run on the
device their arguments lie on. The reference vmaps its hypotheses through
one ``while_loop``; here each hypothesis runs its own loop with the same
exit rule, which gives the same result (a stopped vmap lane is frozen).

The reference asks Precision.HIGHEST of its products; PyTorch's float32
``matmul`` on the card is full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, which this package
never does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.config import ICPParams
from object_detector_6d_tpu_torch.core.device import checked_device
from object_detector_6d_tpu_torch.core.exact import div_rn, dot3, sincos_device, sqrt_rn
from object_detector_6d_tpu_torch.core.reduce import fixed_sum
from object_detector_6d_tpu_torch.core.se3 import SE3, cross
from object_detector_6d_tpu_torch.refine.projective import _chol_solve6

# elements of one [rows, M] block of the distance matrix: on the card 2^24
# (64 MB of float32; a whole 1024 x 76,800 matrix and its temporaries would
# take over a gigabyte per hypothesis), on the CPU 2^19, whose temporaries
# stay in the cache (the rows of a block do not change any row's bits)
_NN_BLOCK = 1 << 24
_NN_BLOCK_CPU = 1 << 19


def nanquantile(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """NaN-ignoring quantiles of ``a`` [..., n] over its last axis at the
    levels ``q`` [S] -> [..., S], linearly interpolated with
    ``jnp.nanquantile``'s arithmetic: position q*(count-1), result
    low*(1-w) + high*w. A row without a finite value gives NaN.
    (``torch.nanmedian`` returns the lower middle value of an even count;
    ``torch.nanquantile`` interpolates as low + w*(high-low).)"""
    a = torch.sort(a, dim=-1).values  # NaN sorts last
    counts = (~torch.isnan(a)).sum(-1, keepdim=True).to(q.dtype)  # [..., 1]
    pos = q * (counts - 1.0)  # [..., S]
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    zero = torch.zeros_like(counts)
    low = torch.maximum(zero, torch.minimum(low, counts - 1.0)).to(torch.int64)
    high = torch.maximum(zero, torch.minimum(high, counts - 1.0)).to(torch.int64)
    return torch.gather(a, -1, low) * low_w + torch.gather(a, -1, high) * high_w


def _nanmedian(a: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a vector: the mean of the two middle values
    when the count of non-NaN entries is even."""
    return nanquantile(a, torch.tensor([0.5], dtype=a.dtype, device=a.device))[0]


def _nearest_scene(model_pts, scene_pts, scene_valid):
    """Indices + squared distances of the nearest scene point for each
    model point: model_pts [N, 3], scene_pts [M, 3] -> ([N] int64, [N]).

    d2 = (|m|^2 + |s|^2) - 2 m.s, as the reference, in one written order
    ((m0 s0 + m1 s1) + m2 s2 for the cross term; the reference's is a
    matrix product), but on coordinates shifted by the model's
    mean point. In camera coordinates the three terms are ~1.7 m^2 each
    and cancel to ~1e-5 m^2, which leaves d2 with ~1% of float32 noise:
    the nearest neighbour, the MAD inlier set and with them the pose then
    depend on the last bit of every sum. Near the object the terms are
    ~1e-2 m^2 and d2 is good to ~1e-4 of itself, so the card and the CPU
    agree; the reference's own result is this one plus its noise.

    Invalid scene rows sit at +inf (through their |s|^2, which gives the
    same d2 as masking the matrix). The argmin keeps the first of equal
    distances."""
    origin = div_rn(fixed_sum(model_pts, 0),
                    torch.tensor(float(model_pts.shape[0]), device=model_pts.device))
    model_pts = model_pts - origin
    scene_pts = scene_pts - origin
    m2 = dot3(model_pts, model_pts)[:, None]  # [N, 1]
    s2 = dot3(scene_pts, scene_pts)
    s2 = torch.where(scene_valid, s2, float("inf"))[None, :]  # [1, M]
    s_cols = [scene_pts[:, k].contiguous()[None, :] for k in range(3)]  # [1, M] each
    m_cols = [model_pts[:, k:k + 1].contiguous() for k in range(3)]  # [N, 1] each
    block = _NN_BLOCK_CPU if model_pts.device.type == "cpu" else _NN_BLOCK
    rows = max(1, block // max(1, scene_pts.shape[0]))
    idx, best = [], []
    for r0 in range(0, model_pts.shape[0], rows):
        r = slice(r0, r0 + rows)
        cross_term = m_cols[0][r] * s_cols[0]
        cross_term.add_(m_cols[1][r] * s_cols[1])
        cross_term.add_(m_cols[2][r] * s_cols[2])
        d2 = (m2[r] + s2).sub_(cross_term.add_(cross_term))
        i = torch.argmin(d2, dim=-1)
        idx.append(i)
        best.append(torch.gather(d2, 1, i[:, None])[:, 0])
    return torch.cat(idx), torch.cat(best)


def _solve6(A, b):
    """Solve the 6x6 normal equations with relative Levenberg damping,
    1e-6 tr(A) + 1e-12 (refine/projective.py's unrolled Cholesky):
    degenerate directions (rotation about a sphere's centre) would
    otherwise amplify float32 noise into large spurious updates."""
    return _chol_solve6(A[None], b[None])[0]


def _p2pl_step(pose, model_pc, scene_pts, scene_nrm, scene_valid, sample_mask,
               rejection_scale, max_corr_dist=None):
    """One point-to-plane iteration: associate, reject, solve, retract.
    Returns (new pose [4, 4], update norm, mean inlier residual).

    ``max_corr_dist``: optional absolute correspondence cap on top of the
    MAD rule (occluded model points otherwise latch onto whatever surface
    is nearest and drag the pose)."""
    mp = SE3.apply(pose, model_pc[:, :3])
    idx, d2 = _nearest_scene(mp, scene_pts, scene_valid)
    q = scene_pts[idx]
    n = scene_nrm[idx]

    d = sqrt_rn(torch.clamp(d2, min=0.0))
    d_masked = torch.where(sample_mask, d, 1e30)
    # mask-aware robust statistics over the unmasked samples only
    d_nan = torch.where(sample_mask, d, float("nan"))
    med = torch.nan_to_num(_nanmedian(d_nan))
    mad = torch.nan_to_num(_nanmedian(torch.abs(d_nan - med)))
    sigma = float(np.float32(1.4826)) * mad
    thr = med + rejection_scale * sigma
    if max_corr_dist is not None:
        thr = torch.clamp(thr, max=max_corr_dist)
    w = (sample_mask & (d_masked <= thr) & torch.isfinite(d_masked)).to(torch.float32)

    r = dot3(mp - q, n)  # signed point-to-plane residual
    # rotation about the weighted model centroid: with the camera origin
    # over a metre away, origin-centred rotations alias translations and
    # Gauss-Newton diverges
    wsum = torch.clamp(fixed_sum(w, 0), min=1.0)
    c = div_rn(fixed_sum(mp * w[:, None], 0), wsum)
    J = torch.cat([cross(mp - c, n), n], dim=-1)  # [N, 6]
    Jw = J * w[:, None]
    A = fixed_sum(Jw[:, :, None] * J[:, None, :], 0)
    b = -fixed_sum(Jw * r[:, None], 0)
    x = _solve6(A, b)
    dT = SE3.exp(x, sincos=sincos_device)
    # conjugate by the centroid shift: rotate about c, not the origin
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    shift = SE3.from_rt(eye, c)
    unshift = SE3.from_rt(eye, -c)
    new_pose = SE3.compose(shift, SE3.compose(dT, SE3.compose(unshift, pose)))
    residual = div_rn(fixed_sum(torch.abs(r) * w, 0), wsum)
    return new_pose, sqrt_rn(fixed_sum(x * x, -1)), residual


def split_scene(scene_pc: torch.Tensor):
    """[M, 6] xyz + normal -> (points, normals, valid): rows with a
    non-finite value are invalid and zeroed."""
    scene_pts = scene_pc[:, :3]
    scene_nrm = scene_pc[:, 3:6]
    scene_valid = torch.isfinite(scene_pts).all(-1) & torch.isfinite(scene_nrm).all(-1)
    return torch.nan_to_num(scene_pts), torch.nan_to_num(scene_nrm), scene_valid


@torch.no_grad()
def refine_one(model_pc, pose0, scene_pts, scene_nrm, scene_valid, iterations,
               tolerance, rejection_scale, num_levels, corr_cap=None):
    """Multi-resolution ICP of one hypothesis -> (residual, pose [4, 4]).

    Level ``l`` (coarse to fine) takes every 2^l-th model row and runs
    until the update norm falls below ``tolerance`` or ``max(1,
    iterations // num_levels)`` steps are done. NaN model rows (fixed-size
    padding) are masked out. ``corr_cap``, if given, caps correspondences
    at ``corr_cap * 2^l`` metres."""
    N = model_pc.shape[0]
    pose = pose0
    residual = torch.zeros((), dtype=torch.float32, device=pose0.device)
    iters = max(1, iterations // num_levels)
    for level in range(num_levels - 1, -1, -1):
        stride = 1 << level
        sample = model_pc[::stride][:max(1, N // stride)]
        mask = torch.isfinite(sample[:, :3]).all(-1)
        sample = torch.nan_to_num(sample)
        cap = None if corr_cap is None else float(np.float32(corr_cap) * stride)
        for _ in range(iters):
            pose, upd, residual = _p2pl_step(
                pose, sample, scene_pts, scene_nrm, scene_valid, mask,
                rejection_scale, max_corr_dist=cap)
            if not float(upd) >= tolerance:
                break
    return residual, pose


def _icp_run(model_pc, scene_pc, poses, iterations, tolerance, rejection_scale,
             num_levels):
    """Multi-resolution ICP of one model [N, 6] from each of the poses
    [B, 4, 4] -> (residuals [B], poses [B, 4, 4])."""
    scene = split_scene(scene_pc)
    out = [refine_one(model_pc, pose0, *scene, iterations, tolerance,
                      rejection_scale, num_levels) for pose0 in poses]
    return torch.stack([r for r, _ in out]), torch.stack([p for _, p in out])


@dataclasses.dataclass
class ICP:
    """Point-to-plane ICP (mirrors ppf_match_3d::ICP). ``device`` is where
    the clouds are refined: the card unless the caller asks for the CPU."""

    iterations: int = 250
    tolerance: float = 0.005
    rejection_scale: float = 2.5
    num_levels: int = 6
    device: str = "cuda"

    @classmethod
    def from_params(cls, p: ICPParams, device="cuda") -> "ICP":
        return cls(p.iterations, p.tolerance, p.rejection_scale, p.num_levels, device)

    def scalars(self) -> Tuple[float, float]:
        """(tolerance, rejection_scale) rounded to float32, as the
        reference hands them to its program."""
        return float(np.float32(self.tolerance)), float(np.float32(self.rejection_scale))

    def register_model_to_scene(
        self,
        model_pc: np.ndarray,
        scene_pc: np.ndarray,
        poses: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Refine pose hypotheses; returns (residuals [B], poses [B, 4, 4]).

        ``model_pc`` [N, 6], ``scene_pc`` [M, 6] (xyz + normal). ``poses``
        [B, 4, 4] initial model -> scene transforms (identity if omitted);
        a single [4, 4] pose is accepted and returned unbatched."""
        dev = checked_device(self.device)
        single = poses is not None and np.ndim(poses) == 2
        if poses is None:
            poses = np.eye(4, dtype=np.float32)[None]
        poses = np.asarray(poses, np.float32).reshape(-1, 4, 4)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        residuals, out = _icp_run(t(model_pc), t(scene_pc), t(poses),
                                  self.iterations, *self.scalars(), self.num_levels)
        residuals = residuals.cpu().numpy()
        out = out.cpu().numpy()
        if single:
            return float(residuals[0]), out[0]
        return residuals, out
