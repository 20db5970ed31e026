"""Streaming multi-camera detection (port of
object_detector_6d_tpu/api/streaming.py; the reference's config 5, 4x30
FPS RGB-D).

``StreamingDetector.process`` runs the whole N-camera tick as one call of
PoseDetector.detect_fused_batch (api/detect_program.py: match ->
geometry -> hypothesis lift -> projective ICP -> device cluster NMS over
the frame batch). An empty camera yields an empty list; a frame whose
coarse candidates overflow the program's slots falls back to the
host-orchestrated ``detect`` for that frame only, so the stream never
stalls.

``process_host`` is the reference's host-orchestrated tick: Detector.match
per camera, one geometry pass over the cameras (cloud + FALS normals),
a median-depth lift per match, one nearest-neighbour point-to-plane ICP
per (camera, hypothesis) against that camera's strided scene
(refine/icp.py), then per camera pose-cluster NMS. It runs on the pose
detector's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from object_detector_6d_tpu_torch.api.pipeline import PoseDetector, _geometry_single
from object_detector_6d_tpu_torch.core.device import checked_device
from object_detector_6d_tpu_torch.core.intrinsics import Intrinsics
from object_detector_6d_tpu_torch.refine.icp import refine_one, split_scene
from object_detector_6d_tpu_torch.refine.pose import Pose, cluster_poses


def _icp_pairs(models, scenes, cams, poses, iterations, tolerance, rejection_scale,
               num_levels):
    """ICP where each hypothesis has its own model [N, 6] and its camera's
    scene: models [P, N, 6], scenes [C, M, 6], cams [P] camera index, poses
    [P, 4, 4] -> (residuals [P], poses [P, 4, 4]). No correspondence cap,
    as the reference's ``_icp_pairs``."""
    split = {c: split_scene(scenes[c]) for c in sorted(set(cams))}
    out = [refine_one(m, p0, *split[c], iterations, tolerance, rejection_scale,
                      num_levels)
           for m, c, p0 in zip(models, cams, poses)]
    return torch.stack([r for r, _ in out]), torch.stack([p for _, p in out])


def _batched_geometry(depths: torch.Tensor, K) -> torch.Tensor:
    """[N, H, W] depth -> scene clouds + FALS normals [N, H, W, 6] (shared
    K), on the depths' device."""
    return torch.stack([_geometry_single(d, K) for d in depths])


class StreamingDetector:
    """Multi-camera streaming front end over a trained PoseDetector."""

    def __init__(
        self,
        pose_detector: PoseDetector,
        n_cameras: int = 4,
        scene_stride: int = 4,
    ):
        self.det = pose_detector
        self.n_cameras = n_cameras
        self.scene_stride = scene_stride

    def process(
        self,
        depths: np.ndarray,  # [N, H, W] u16
        K: np.ndarray,  # shared intrinsics (per-camera K: call per group)
        rgbs: Optional[np.ndarray] = None,  # [N, H, W, 3] u8 BGR
        match_threshold: Optional[float] = None,
    ) -> List[List[Pose]]:
        """One fused call for the whole camera batch."""
        return self.det.detect_fused_batch(
            np.asarray(depths), K, rgbs, match_threshold=match_threshold)

    def process_host(
        self,
        depths: np.ndarray,  # [N, H, W] u16
        K: np.ndarray,  # shared intrinsics (per-camera K: call per group)
        rgbs: Optional[np.ndarray] = None,  # [N, H, W, 3] u8 BGR
        match_threshold: Optional[float] = None,
    ) -> List[List[Pose]]:
        det = self.det
        dev = checked_device(det.device)
        p = det.params
        thr = p.match_threshold if match_threshold is None else match_threshold
        depths = np.asarray(depths)
        N = depths.shape[0]

        # 1. match every frame (the detector caches its programs per shape)
        all_matches = []
        for i in range(N):
            sources = det._sources(None if rgbs is None else rgbs[i], depths[i])
            all_matches.append(
                det.detector.match(sources, thr, device=dev)[: p.max_hypotheses])

        # 2. one geometry pass over the cameras; the lift reads z on the host
        scene6 = _batched_geometry(torch.as_tensor(depths.astype(np.int32), device=dev), K)
        z_img = scene6[..., 2].cpu().numpy()
        intr = Intrinsics.from_matrix(np.asarray(K))
        H, W = depths.shape[1:]

        # 3. lift all hypotheses across cameras (median depth of the bbox)
        hyps = []  # (camera, Match, rec, pose0)
        for cam, matches in enumerate(all_matches):
            for m in matches:
                rec = det.views.get((m.class_id, m.template_id))
                if rec is None:
                    continue
                bw, bh = rec.bbox[2], rec.bbox[3]
                y0, y1 = max(0, m.y), min(H, m.y + bh + 1)
                x0, x1 = max(0, m.x), min(W, m.x + bw + 1)
                zwin = z_img[cam, y0:y1, x0:x1]
                z = float(np.nanmedian(zwin)) if np.isfinite(zwin).any() else float("nan")
                if not np.isfinite(z):
                    continue
                target = intr.reproject(m.x + bw / 2.0, m.y + bh / 2.0, z).numpy()
                pose0 = np.eye(4, dtype=np.float32)
                pose0[:3, 3] = target - rec.anchor_point
                hyps.append((cam, m, rec, pose0))
        if not hyps:
            return [[] for _ in range(N)]

        # 4. ICP of every (camera, hypothesis) pair against its camera
        s = self.scene_stride
        scenes_sub = scene6[:, ::s, ::s].reshape(N, -1, 6)
        models = torch.as_tensor(np.stack([h[2].model_cloud for h in hyps]), device=dev)
        poses0 = torch.as_tensor(np.stack([h[3] for h in hyps]), device=dev)
        icp = p.icp
        residuals, poses = _icp_pairs(
            models, scenes_sub, [h[0] for h in hyps], poses0, icp.iterations,
            float(np.float32(icp.tolerance)), float(np.float32(icp.rejection_scale)),
            icp.num_levels)
        residuals = residuals.cpu().numpy()
        poses = poses.cpu().numpy()

        # 5. per-camera scoring + NMS
        out: List[List[Pose]] = [[] for _ in range(N)]
        per_cam: Dict[int, List[Pose]] = {}
        for i, (cam, m, rec, _p0) in enumerate(hyps):
            pose = poses[i]
            if rec.view_pose is not None:
                pose = pose @ rec.view_pose
            per_cam.setdefault(cam, []).append(Pose(
                pose=np.asarray(pose, np.float64),
                residual=float(residuals[i]),
                num_votes=int(round(m.similarity * 100)),
                class_id=m.class_id,
                template_id=m.template_id,
                match_x=m.x,
                match_y=m.y,
                match_similarity=m.similarity,
            ))
        for cam, plist in per_cam.items():
            clusters = cluster_poses(
                plist, translation_threshold=p.nms_radius_px / float(intr.fx))
            out[cam] = [c.mean_pose() for c in clusters]
        return out
