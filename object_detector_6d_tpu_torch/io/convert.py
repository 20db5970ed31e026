"""Build a PoseDetector from trained state given as plain numpy/python.

The state is what a detector learns in training, in a form that either
package can produce without importing the other:

* ``detector``: ``{"modalities": [...], "t_at_level": [t0, t1],
  "color_gradient_params": {...}, "depth_normal_params": {...}}``, the
  Detector's configuration (``detector_dict`` makes it from either
  package's Detector);
* ``templates``: ``{class_id: [pyramid, ...]}``, each pyramid a list of
  ``(width, height, pyramid_level, features [n, 3] int32 (x, y, label))``
  in the stored interleaved order;
* ``views``: ``{(class_id, template_id): {"model_cloud": [N, 6],
  "bbox": (x, y, w, h), "anchor_point": [3], "view_pose": [4, 4] or None}}``;
* ``params``: a DetectParams, or a dict of its fields (``icp`` a dict of
  ICPParams fields).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector, _ViewRecord
from object_detector_6d_tpu_torch.core.config import (
    ColorGradientParams,
    DepthNormalParams,
    DetectParams,
    ICPParams,
)
from object_detector_6d_tpu_torch.quant.features import Feature, Template


def _params(params) -> DetectParams:
    if isinstance(params, DetectParams):
        return params
    fields = dict(params)
    if isinstance(fields.get("icp"), Mapping):
        fields["icp"] = ICPParams(**fields["icp"])
    return DetectParams(**fields)


def pose_detector_from_state(
    detector: Mapping,
    templates: Dict[str, Sequence[Sequence[tuple]]],
    views: Dict[Tuple[str, int], Mapping],
    params,
    model_points: int = 1024,
    mesh=None,
    device="cuda",
) -> PoseDetector:
    """A PoseDetector holding the given detector configuration, templates
    and views (sharded over ``mesh`` when one is given: every rank builds
    it from the same state)."""
    det = Detector(
        modalities=tuple(detector["modalities"]),
        t_at_level=tuple(detector["t_at_level"]),
        color_gradient_params=ColorGradientParams(**detector["color_gradient_params"]),
        depth_normal_params=DepthNormalParams(**detector["depth_normal_params"]))
    for cid, pyramids in templates.items():
        for pyr in pyramids:
            tp = []
            for width, height, level, feats in pyr:
                feats = np.asarray(feats, np.int64).reshape(-1, 3)
                tp.append(Template(int(width), int(height), int(level),
                                   [Feature(int(x), int(y), int(lbl))
                                    for x, y, lbl in feats]))
            det.add_synthetic_template(tp, cid)
    pd = PoseDetector(detector=det, params=_params(params),
                      model_points=model_points, mesh=mesh, device=device)
    for (cid, tid), rec in views.items():
        vp = rec.get("view_pose")
        pd.views[(cid, int(tid))] = _ViewRecord(
            np.asarray(rec["model_cloud"], np.float32),
            tuple(int(v) for v in rec["bbox"]),
            np.asarray(rec["anchor_point"], np.float32),
            None if vp is None else np.asarray(vp, np.float32),
        )
    return pd


def params_dict(params) -> dict:
    """A DetectParams-like dataclass as the plain dict ``_params`` takes."""
    return dataclasses.asdict(params)


def detector_dict(det) -> dict:
    """Either package's Detector configuration as the plain dict
    ``pose_detector_from_state`` takes."""
    return {"modalities": list(det.modality_names),
            "t_at_level": list(det.t_at_level),
            "color_gradient_params": dataclasses.asdict(det.cg_params),
            "depth_normal_params": dataclasses.asdict(det.dn_params)}
