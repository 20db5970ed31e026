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
Products run in full float32 (TF32 off, the reference's
``Precision.HIGHEST``); the damped 6x6 solve is ``torch.linalg.solve``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from object_detector_6d_tpu_torch.core.device import no_tf32, on_device
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics
from object_detector_6d_tpu_torch.core.se3 import SE3, cross
from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d
from object_detector_6d_tpu_torch.geom.depth import rescale_depth
from object_detector_6d_tpu_torch.geom.normals import gradient, normals_cross

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
    s = torch.where(v, blocks, 0.0).sum(-1)
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
            gray = img.mean(-1) if img.dim() == 3 else img
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
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
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
        wsum = torch.clamp(w.sum(), min=1.0)
        c = torch.sum(mp * w[:, None], 0) / wsum

        A = torch.zeros((6, 6), dtype=torch.float32, device=dev)
        b = torch.zeros((6,), dtype=torch.float32, device=dev)
        res_acc = torch.zeros((), dtype=torch.float32, device=dev)
        if use_icp:
            r = torch.sum((mp - q) * nq, -1)
            J = torch.cat([cross(mp - c, nq), nq], -1)
            Jw = J * w[:, None]
            A = A + torch.matmul(Jw.T, J)
            b = b - torch.matmul(Jw.T, r[:, None])[:, 0]
            res_acc = res_acc + torch.sum(torch.abs(r) * w) / wsum
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
            JI = torch.cat([Jr, Jt], -1)
            JIw = JI * w[:, None]
            A = A + torch.matmul(JIw.T, JI)
            b = b - torch.matmul(JIw.T, rI[:, None])[:, 0]
            res_acc = res_acc + torch.sum(torch.abs(rI) * w) / wsum

        lam = 1e-6 * torch.trace(A) + 1e-12
        x = torch.linalg.solve(A + lam * eye6, b)
        dT = SE3.exp(x)
        shift = SE3.from_rt(eye3, c)
        unshift = SE3.from_rt(eye3, -c)
        new_pose = SE3.compose(shift, SE3.compose(dT, SE3.compose(unshift, pose)))
        return new_pose, res_acc, torch.linalg.vector_norm(x)

    pose = pose0
    residual = torch.zeros((), dtype=torch.float32, device=dev)
    with no_tf32():
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
