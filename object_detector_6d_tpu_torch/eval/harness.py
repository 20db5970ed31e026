"""Evaluation harness: ADD-0.1d over a scene (BASELINE configs 1-4).
Port of object_detector_6d_tpu/eval/harness.py; the distances run on the
pose detector's device.

Runs a trained PoseDetector over a BopScene, matches detections to
ground truth by class, and reports ADD(-S) accuracy plus per-frame
timing. Works on real BOP data or the synthetic stand-in scene
(data/bop.make_synthetic_bop_scene).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from object_detector_6d_tpu_torch.data.bop import BopScene
from object_detector_6d_tpu_torch.eval.add_metric import (
    add_distance,
    adds_distance,
    model_diameter,
)


@dataclasses.dataclass
class EvalResult:
    n_frames: int
    n_gt: int
    n_detected: int
    add_correct: int
    mean_add: float
    fps: float

    @property
    def add_accuracy(self) -> float:
        return self.add_correct / max(self.n_gt, 1)


def evaluate_scene(
    pose_detector,
    scene: BopScene,
    obj_to_class: Dict[int, str],
    model_points: Dict[int, np.ndarray],
    diameters: Optional[Dict[int, float]] = None,
    k: float = 0.1,
    symmetric: bool = False,
    match_threshold: Optional[float] = None,
    max_frames: Optional[int] = None,
    use_fused: bool = True,
) -> EvalResult:
    """``use_fused`` (default) drives the production single-call fused
    program (PoseDetector.detect_fused); False selects the
    host-orchestrated reference path for debugging — the fps and ADD it
    reports then measure a pipeline nobody ships."""
    dev = pose_detector.device
    n_gt = n_det = n_ok = 0
    adds: List[float] = []
    t0 = time.time()
    n_frames = 0
    detect = pose_detector.detect_fused if use_fused else pose_detector.detect
    for frame in scene.frames():
        if max_frames is not None and n_frames >= max_frames:
            break
        n_frames += 1
        poses = detect(
            frame.depth_u16, frame.K, rgb=frame.rgb, match_threshold=match_threshold
        )
        for gt in frame.gt:
            n_gt += 1
            cls = obj_to_class.get(gt.obj_id)
            cands = [p for p in poses if p.class_id == cls]
            if not cands:
                continue
            pts = model_points[gt.obj_id]
            dia = (diameters or {}).get(gt.obj_id) or model_diameter(pts, device=dev)
            fn = adds_distance if symmetric else add_distance
            dists = [float(fn(p.pose.astype(np.float32), gt.pose.astype(np.float32), pts,
                              device=dev)) for p in cands]
            best = min(dists)
            n_det += 1
            adds.append(best)
            if best < k * dia:
                n_ok += 1
    dt = time.time() - t0
    return EvalResult(
        n_frames=n_frames,
        n_gt=n_gt,
        n_detected=n_det,
        add_correct=n_ok,
        mean_add=float(np.mean(adds)) if adds else float("nan"),
        fps=n_frames / dt if dt > 0 else 0.0,
    )
