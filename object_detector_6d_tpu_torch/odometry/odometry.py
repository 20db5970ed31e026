"""Dense RGB-D odometry (port of object_detector_6d_tpu/odometry/odometry.py;
cv::rgbd::Odometry).

* ``ICPOdometry``: projective point-to-plane ICP between two organized
  frames (transform the source points, project them into the destination
  camera, take the destination point and normal at the hit pixel, solve
  the centroid-centred 6x6 system).
* ``RgbdOdometry``: dense photometric alignment with the destination's
  image gradients at the warped pixels.
* ``RgbdICPOdometry``: both residuals in one normal-equation solve.
* ``FastICPOdometry``: ICPOdometry on every second pixel of each axis.

Coarse to fine over an averaging depth pyramid with the reference's
iteration counts (7, 7, 7, 10), finest first. The reference's
``lax.while_loop`` stops a level when the update norm falls under
``tolerance``; here the host reads the norm after each step (one sync a
step: odometry is not on the detect path) and stops at the same step.
Every float sum is written in one order for every device: the sums over
points (the normal equations, the centroid, the residual) are
``core/reduce.py`` ``fixed_sum`` trees, the damped 6x6 system is solved
by the detect path's unrolled Cholesky (``refine/projective.py``
``_chol_solve6``; the reference's ``jnp.linalg.solve`` is an LU), and a
grey image is the reference's channel sum times the float32 1/3, so the
card answers as the CPU does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import on_device
from object_detector_6d_tpu_torch.core.exact import sqrt_rn
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics
from object_detector_6d_tpu_torch.core.reduce import fixed_sum
from object_detector_6d_tpu_torch.core.se3 import SE3, cross
from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d
from object_detector_6d_tpu_torch.geom.depth import rescale_depth
from object_detector_6d_tpu_torch.geom.normals import gradient, normals_cross
from object_detector_6d_tpu_torch.refine.projective import _chol_solve6

# fine -> coarse; the oracle's defaultIterCounts {7,7,7,10} is indexed by
# pyramid level with level 0 = finest, so the coarsest level gets 10
DEFAULT_ITER_COUNTS = (7, 7, 7, 10)
DEFAULT_MAX_DEPTH_DIFF = 0.07  # metres (Odometry::DEFAULT_MAX_DEPTH_DIFF)


def _avg_pyr_down(z: torch.Tensor) -> torch.Tensor:
    """2x2 mean of the finite values (NaN where a block has none)."""
    H, W = z.shape
    z = z[:H // 2 * 2, :W // 2 * 2]
    blocks = z.reshape(H // 2, 2, W // 2, 2).permute(0, 2, 1, 3).reshape(H // 2, W // 2, 4)
    v = torch.isfinite(blocks)
    b = torch.where(v, blocks, 0.0)
    s = ((b[..., 0] + b[..., 1]) + b[..., 2]) + b[..., 3]
    c = v.sum(-1)
    return torch.where(c > 0, s / torch.clamp(c, min=1), float("nan"))


@dataclasses.dataclass
class OdometryFrame:
    """Cached per-level geometry for one RGB-D frame (OdometryFrame)."""

    clouds: List[torch.Tensor]  # [H, W, 3] per level
    normals: List[torch.Tensor]
    intensities: List[Optional[torch.Tensor]]  # f32 [H, W] or None
    Ks: List[np.ndarray]

    @classmethod
    def create(cls, depth, K, image=None, levels: int = 4, device="cuda"):
        """Depth (u16 mm or f32 m) [H, W] and an optional image [H, W] or
        [H, W, C]. A tensor stays on its device; numpy goes to ``device``."""
        d = on_device(depth, device)
        z = rescale_depth(d.to(torch.int32) if not d.dtype.is_floating_point else d)
        gray = None
        if image is not None:
            img = on_device(image, z.device).to(torch.float32)
            gray = (((img[..., 0] + img[..., 1]) + img[..., 2]) * _THIRD if img.dim() == 3
                    else img)
        clouds, normals, intensities, Ks = [], [], [], []
        Kl = np.asarray(K, np.float64)
        for lvl in range(levels):
            cloud = depth_to_3d(z, Kl)
            clouds.append(cloud)
            normals.append(normals_cross(cloud))
            intensities.append(gray)
            Ks.append(Kl.copy())
            if lvl + 1 < levels:
                z = _avg_pyr_down(z)
                if gray is not None:
                    gray = _avg_pyr_down(gray)
                Kl = Kl.copy()
                Kl[:2] *= 0.5
        return cls(clouds, normals, intensities, Ks)


def _f32(x: float) -> float:
    return float(np.float32(x))


# jnp.mean over 3 channels: the sum times the float32 reciprocal of 3
_THIRD = float(np.float32(1.0) / np.float32(3.0))
_TI, _TJ = np.tril_indices(6)  # the 21 entries i >= j of the 6x6 system


def _normal_equations(J: torch.Tensor, w: torch.Tensor, r: torch.Tensor):
    """(J^T W J [6, 6], J^T W r [6], sum |r| w) over the points [N] of
    J [N, 6], w [N], r [N], by one fixed_sum tree."""
    Jw = J * w[:, None]
    s = fixed_sum(torch.cat([Jw[:, _TI] * J[:, _TJ], Jw * r[:, None],
                             (torch.abs(r) * w)[:, None]], -1), 0)
    A = J.new_zeros((6, 6))
    A[_TI, _TJ] = s[:21]
    A[_TJ, _TI] = s[:21]
    return A, s[21:27], s[27]


@torch.no_grad()
def _odometry_level(src_cloud, dst_cloud, dst_normals, src_gray, dst_gray, K, pose0,
                    use_icp: bool, use_rgb: bool, iters: int, stride: int,
                    max_depth_diff: float, tolerance: float):
    """Gauss-Newton steps at one pyramid level; returns (pose, residual)."""
    H, W, _ = dst_cloud.shape
    dev = dst_cloud.device
    intr = Intrinsics.from_matrix(K, device=dev)
    sp = src_cloud[::stride, ::stride].reshape(-1, 3)
    s_valid = torch.isfinite(sp).all(-1)
    sp = torch.nan_to_num(sp)
    dst_c = torch.nan_to_num(dst_cloud)
    dst_n = torch.nan_to_num(dst_normals)
    dst_ok = torch.isfinite(dst_cloud).all(-1) & torch.isfinite(dst_normals).all(-1)
    if use_rgb:
        sg = src_gray[::stride, ::stride].reshape(-1)
        gx, gy = gradient(dst_gray, 1), gradient(dst_gray, 0)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)

    def step(pose):
        mp = SE3.apply(pose, sp)
        z = torch.clamp(mp[:, 2], min=1e-6)
        # clamp before the cast (in-frame values are unaffected)
        u = torch.round(intr.fx * mp[:, 0] / z + intr.cx).clamp(-1e9, 1e9).to(torch.int64)
        v = torch.round(intr.fy * mp[:, 1] / z + intr.cy).clamp(-1e9, 1e9).to(torch.int64)
        inb = (u >= 0) & (u < W) & (v >= 0) & (v < H) & s_valid & (mp[:, 2] > 0)
        uc = torch.clamp(u, 0, W - 1)
        vc = torch.clamp(v, 0, H - 1)
        q = dst_c[vc, uc]
        nq = dst_n[vc, uc]
        ok = inb & dst_ok[vc, uc] & (torch.abs(q[:, 2] - mp[:, 2]) < max_depth_diff)
        w = ok.to(torch.float32)
        s1 = fixed_sum(torch.cat([w[:, None], mp * w[:, None]], -1), 0)
        wsum = torch.clamp(s1[0], min=1.0)
        c = s1[1:] / wsum

        A = torch.zeros((6, 6), dtype=torch.float32, device=dev)
        b = torch.zeros((6,), dtype=torch.float32, device=dev)
        res_acc = torch.zeros((), dtype=torch.float32, device=dev)
        if use_icp:
            e = (mp - q) * nq
            r = (e[:, 0] + e[:, 1]) + e[:, 2]
            Ai, Jtr, rsum = _normal_equations(torch.cat([cross(mp - c, nq), nq], -1), w, r)
            A = A + Ai
            b = b - Jtr
            res_acc = res_acc + rsum / wsum
        if use_rgb:
            ig = dst_gray[vc, uc]
            rI = (ig - sg) * 0.01  # intensity scaled to ~metres
            # dI/dxi = [gx, gy] . dpi/dp . dp/dxi, with p about the centroid c
            jx = gx[vc, uc] * intr.fx / z
            jy = gy[vc, uc] * intr.fy / z
            jz = -(jx * mp[:, 0] + jy * mp[:, 1]) / z
            Jt = torch.stack([jx, jy, jz], -1) * 0.01
            pc = mp - c
            Jr = torch.stack([pc[:, 1] * Jt[:, 2] - pc[:, 2] * Jt[:, 1],
                              pc[:, 2] * Jt[:, 0] - pc[:, 0] * Jt[:, 2],
                              pc[:, 0] * Jt[:, 1] - pc[:, 1] * Jt[:, 0]], -1)
            Ai, JIr, rsum = _normal_equations(torch.cat([Jr, Jt], -1), w, rI)
            A = A + Ai
            b = b - JIr
            res_acc = res_acc + rsum / wsum

        x = _chol_solve6(A[None], b[None])[0]  # damped by 1e-6 tr(A) + 1e-12
        dT = SE3.exp(x)
        shift = SE3.from_rt(eye3, c)
        unshift = SE3.from_rt(eye3, -c)
        new_pose = SE3.compose(shift, SE3.compose(dT, SE3.compose(unshift, pose)))
        return new_pose, res_acc, sqrt_rn(fixed_sum(x * x, 0))

    pose = pose0
    residual = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        pose, residual, upd = step(pose)
        if float(upd) < tolerance:
            break
    return pose, residual


@dataclasses.dataclass
class Odometry:
    """Base odometry (mirrors cv::rgbd::Odometry::compute).

    ``compute(src_frame, dst_frame, init_Rt)`` estimates the transform
    that maps source-frame points into the destination frame; it runs on
    the frames' device."""

    method: str = "ICP"  # ICP | Rgbd | RgbdICP | FastICP
    iter_counts: Tuple[int, ...] = DEFAULT_ITER_COUNTS
    max_depth_diff: float = DEFAULT_MAX_DEPTH_DIFF
    tolerance: float = 1e-4

    def compute(self, src: OdometryFrame, dst: OdometryFrame,
                init_Rt: Optional[np.ndarray] = None) -> Tuple[bool, np.ndarray]:
        levels = len(src.clouds)
        dev = src.clouds[0].device
        pose = torch.as_tensor(np.eye(4, dtype=np.float32) if init_Rt is None
                               else np.asarray(init_Rt, np.float32), device=dev)
        use_icp = self.method in ("ICP", "RgbdICP", "FastICP")
        use_rgb = self.method in ("Rgbd", "RgbdICP")
        stride = 2 if self.method == "FastICP" else 1
        for lvl in range(levels - 1, -1, -1):
            iters = self.iter_counts[min(lvl, len(self.iter_counts) - 1)]
            src_gray = src.intensities[lvl]
            dst_gray = dst.intensities[lvl]
            if use_rgb and (src_gray is None or dst_gray is None):
                raise ValueError(f"method {self.method} needs intensity images")
            pose, _ = _odometry_level(
                src.clouds[lvl], dst.clouds[lvl], dst.normals[lvl], src_gray, dst_gray,
                src.Ks[lvl], pose, use_icp, use_rgb, int(iters), stride,
                _f32(self.max_depth_diff), _f32(self.tolerance))
        return True, pose.cpu().numpy()


def RgbdOdometry(**kw) -> Odometry:
    return Odometry(method="Rgbd", **kw)


def ICPOdometry(**kw) -> Odometry:
    return Odometry(method="ICP", **kw)


def RgbdICPOdometry(**kw) -> Odometry:
    return Odometry(method="RgbdICP", **kw)


def FastICPOdometry(**kw) -> Odometry:
    return Odometry(method="FastICP", **kw)
