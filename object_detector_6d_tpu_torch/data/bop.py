"""Dataset loaders: LINEMOD / Occlusion-LINEMOD / YCB-Video (BOP layout).
Port of object_detector_6d_tpu/data/bop.py: the same loaders and
synthetic scene, with PNG through io/png.py (the JAX package uses PIL).

The reference's eval targets (BASELINE.json configs 1-4) ship in the BOP
format (bop.felk.cvut.cz): per-scene directories with

    scene_camera.json   {im_id: {cam_K: [9], depth_scale: s}}
    scene_gt.json       {im_id: [{cam_R_m2c: [9], cam_t_m2c: [3] (mm),
                                  obj_id: n}]}
    depth/{im_id:06d}.png   u16, depth_scale mm per unit
    rgb/{im_id:06d}.png
    mask_visib/{im_id:06d}_{gt_idx:06d}.png

plus models/obj_{id:06d}.ply (mm) with models_info.json (diameter).

Loaders return numpy frames ready for the pipeline (depth u16 mm, K,
poses in meters). Tests use the synthetic generator below when no
dataset directory is present (this machine has none).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from object_detector_6d_tpu_torch.io.ply import load_ply
from object_detector_6d_tpu_torch.io.png import read_png, write_png


@dataclasses.dataclass
class GtPose:
    obj_id: int
    R: np.ndarray  # [3, 3]
    t: np.ndarray  # [3] meters

    @property
    def pose(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T


@dataclasses.dataclass
class Frame:
    im_id: int
    depth_u16: np.ndarray  # mm
    rgb: Optional[np.ndarray]
    K: np.ndarray
    gt: List[GtPose]


class BopScene:
    """One BOP scene directory (e.g. lm/test/000001)."""

    def __init__(self, scene_dir: str, load_rgb: bool = True):
        self.dir = scene_dir
        self.load_rgb = load_rgb
        with open(os.path.join(scene_dir, "scene_camera.json")) as f:
            self.cameras = {int(k): v for k, v in json.load(f).items()}
        gt_path = os.path.join(scene_dir, "scene_gt.json")
        if os.path.exists(gt_path):
            with open(gt_path) as f:
                self.gts = {int(k): v for k, v in json.load(f).items()}
        else:
            self.gts = {}

    def im_ids(self) -> List[int]:
        return sorted(self.cameras.keys())

    def frame(self, im_id: int) -> Frame:
        cam = self.cameras[im_id]
        K = np.asarray(cam["cam_K"], np.float64).reshape(3, 3)
        scale = float(cam.get("depth_scale", 1.0))
        depth = read_png(os.path.join(self.dir, "depth", f"{im_id:06d}.png"))
        depth_mm = np.round(depth.astype(np.float64) * scale).astype(np.uint16)
        rgb = None
        if self.load_rgb:
            p = os.path.join(self.dir, "rgb", f"{im_id:06d}.png")
            if os.path.exists(p):
                rgb = read_png(p)[..., :3][..., ::-1]  # BGR like the pipeline
        gt = []
        for g in self.gts.get(im_id, []):
            gt.append(
                GtPose(
                    obj_id=int(g["obj_id"]),
                    R=np.asarray(g["cam_R_m2c"], np.float64).reshape(3, 3),
                    t=np.asarray(g["cam_t_m2c"], np.float64) / 1000.0,
                )
            )
        return Frame(im_id, depth_mm, rgb, K, gt)

    def frames(self) -> Iterator[Frame]:
        for im_id in self.im_ids():
            yield self.frame(im_id)


def load_model(models_dir: str, obj_id: int) -> Tuple[np.ndarray, float]:
    """(model cloud [N, 3 or 6] meters, diameter meters)."""
    pc = load_ply(os.path.join(models_dir, f"obj_{obj_id:06d}.ply"))
    pc[:, :3] /= 1000.0
    if pc.shape[1] >= 6:
        pass
    info_path = os.path.join(models_dir, "models_info.json")
    diameter = 0.0
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
        diameter = float(info[str(obj_id)]["diameter"]) / 1000.0
    return pc, diameter


# ----------------------------------------------------------------------
# synthetic stand-in dataset (no real BOP data on this machine)
# ----------------------------------------------------------------------

def make_synthetic_bop_scene(
    out_dir: str, n_frames: int = 4, obj_id: int = 1, seed: int = 0,
    max_rot_deg: float = 10.0,
) -> None:
    """Write a tiny BOP-layout scene from the snowman generator with
    FULL SE(3) ground truth (rotations up to ``max_rot_deg`` about
    random axes through the object centroid, composed with random
    translations), so the loaders and the eval harness exercise the
    rotation lift end-to-end without external data. ``max_rot_deg=0``
    reproduces the translation-only scene."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "tools"))
    import scenes

    rng = np.random.RandomState(seed)
    K = scenes.K_DEFAULT
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    dep0, gray0, mask0 = scenes.snowman_scene()
    centroid = scenes.masked_centroid(dep0, mask0, K)
    cameras = {}
    gts = {}
    for i in range(n_frames):
        t = rng.uniform([-0.06, -0.04, -0.05], [0.06, 0.04, 0.05])
        pose = scenes.rot_about(
            rng.normal(size=3), rng.uniform(-max_rot_deg, max_rot_deg),
            centroid,
        )
        pose[:3, 3] += t
        dep, _, gray = scenes.render_posed(dep0, mask0, K, pose)
        write_png(os.path.join(out_dir, "depth", f"{i:06d}.png"), dep)
        write_png(os.path.join(out_dir, "rgb", f"{i:06d}.png"),
                  np.repeat(gray[..., None], 3, 2))
        cameras[str(i)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
        gts[str(i)] = [
            {
                "obj_id": obj_id,
                "cam_R_m2c": pose[:3, :3].reshape(-1).tolist(),
                "cam_t_m2c": (pose[:3, 3] * 1000.0).tolist(),
            }
        ]
    with open(os.path.join(out_dir, "scene_camera.json"), "w") as f:
        json.dump(cameras, f)
    with open(os.path.join(out_dir, "scene_gt.json"), "w") as f:
        json.dump(gts, f)
