"""Template generation from object models (port of
object_detector_6d_tpu/api/templates.py; reference glue: "render/sample
object views -> addTemplate/addSyntheticTemplate per view, storing the
view pose alongside the template id" — SURVEY.md section 2.2).

``render_view`` splat-renders a model cloud (xyz+normals, object frame)
under a view pose into a depth frame (+ a Lambertian gray image so the
ColorGradient modality has silhouette contrast), and
``train_from_model`` registers a set of views into a PoseDetector. The
detector's outputs then map the model frame into the scene camera
(``Pose.pose = T_model->camera``), directly comparable to BOP ground
truth.

Rendering is a z-buffered nearest-pixel splat (numpy, training-time
only; ``render_view`` is the reference's arithmetic, copied); model
clouds should be dense enough to cover their projected footprint (~1
point/px; BOP meshes easily are). ``train_from_model`` registers each view
through ``PoseDetector.add_view``, so it trains on the detector's device
(K1 / K2 quantize each view on the card by default).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from object_detector_6d_tpu_torch.api.pipeline import PoseDetector


def render_view(
    model6: np.ndarray,
    K: np.ndarray,
    view_pose: np.ndarray,
    shape: Tuple[int, int] = (480, 640),
    bg_mm: int = 0,
    fill_iters: int = 2,
):
    """(depth_u16, mask, gray) of the model under T (model -> camera)."""
    H, W = shape
    model6 = np.asarray(model6, np.float64)
    T = np.asarray(view_pose, np.float64)
    pts = model6[:, :3] @ T[:3, :3].T + T[:3, 3]
    nrm = (
        model6[:, 3:6] @ T[:3, :3].T
        if model6.shape[1] >= 6
        else np.zeros_like(pts)
    )
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = pts[:, 2]
    ok = z > 1e-6
    u = np.round(pts[:, 0] / z * fx + cx).astype(int)
    v = np.round(pts[:, 1] / z * fy + cy).astype(int)
    ok &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, z = u[ok], v[ok], z[ok]
    n_ok = nrm[ok]
    order = np.argsort(-z)
    flat = v[order] * W + u[order]
    depth = np.zeros(H * W)
    depth[flat] = z[order]
    # Lambertian shading toward the camera for texture-less contrast
    shade = np.clip(-n_ok[order, 2], 0.0, 1.0)
    gray = np.full(H * W, 128.0)
    gray[flat] = 200 + 55 * shade  # clearly off-background (128): silhouette contrast
    mask = np.zeros(H * W, bool)
    mask[flat] = True
    depth = depth.reshape(H, W)
    gray = gray.reshape(H, W)
    mask = mask.reshape(H, W)
    # close pin-holes: fill empty pixels fully surrounded by splat
    for _ in range(fill_iters):
        pad_d = np.pad(depth, 1)
        pad_m = np.pad(mask, 1)
        pad_g = np.pad(gray, 1)
        neigh_d = np.stack(
            [pad_d[1 + dy : H + 1 + dy, 1 + dx : W + 1 + dx]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
        )
        neigh_m = np.stack(
            [pad_m[1 + dy : H + 1 + dy, 1 + dx : W + 1 + dx]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
        )
        neigh_g = np.stack(
            [pad_g[1 + dy : H + 1 + dy, 1 + dx : W + 1 + dx]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
        )
        cnt = neigh_m.sum(0)
        hole = (~mask) & (cnt >= 6)
        mean_d = np.where(neigh_m, neigh_d, 0).sum(0) / np.maximum(cnt, 1)
        mean_g = np.where(neigh_m, neigh_g, 0).sum(0) / np.maximum(cnt, 1)
        depth = np.where(hole, mean_d, depth)
        gray = np.where(hole, mean_g, gray)
        mask = mask | hole
    depth_mm = np.round(np.where(mask, depth * 1000.0, float(bg_mm)))
    gray_u8 = np.where(mask, gray, 128.0)
    return depth_mm.astype(np.uint16), mask, gray_u8.astype(np.uint8)


def train_from_model(
    det: PoseDetector,
    class_id: str,
    model6: np.ndarray,
    K: np.ndarray,
    view_poses: Sequence[np.ndarray],
    shape: Tuple[int, int] = (480, 640),
    bg_mm: int = 1500,
) -> List[int]:
    """Render each view pose and register it; returns template ids
    (-1 entries for views where feature extraction failed)."""
    tids = []
    for T in view_poses:
        depth, mask, gray = render_view(model6, K, T, shape, bg_mm=bg_mm)
        rgb = np.repeat(gray[..., None], 3, axis=2)
        tid = det.add_view(
            class_id,
            depth,
            K,
            (mask * 255).astype(np.uint8),
            rgb=rgb,
            view_pose=np.asarray(T, np.float32),
        )
        tids.append(tid)
    return tids
