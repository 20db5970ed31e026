"""The detect path as a whole: the port's PoseDetector against the JAX
package's, on the same trained state and the same frames.

A JAX PoseDetector is trained on the snowman, depth-only and with the
reference's two modalities (``rgb=`` its gray view x3); its state goes to
the port through io/convert.py as plain numpy. On two tools/scenes.py
frames the cluster records must agree: class, template and match fields
equal, translations within 1 mm, rotations within 0.5 deg. This file runs
the promoted schedule and the two-modality default one
(test_torch_detect_default.py the depth-only default one; the reference's
compile dominates either). The port's own add_view must reproduce the
reference's templates.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu.core.config import DetectParams as RefDetectParams
from object_detector_6d_tpu.core.config import ICPParams as RefICPParams
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

K = scenes.K_DEFAULT
SCHEDULES = {
    "default": RefDetectParams(),
    "promoted": RefDetectParams(
        match_threshold=80.0, max_hypotheses=16,
        icp=RefICPParams(iterations=32, num_levels=4, solves_per_assoc=2, finest_assoc=2),
        num_seeds=2, fine_compact=8),
}
T_FRAMES = (np.array([0.055, -0.022, -0.04]), np.array([-0.03, 0.04, 0.02]))
DEPTH_ONLY = ("DepthNormal",)
BOTH = ("ColorGradient", "DepthNormal")


def _bgr(gray):
    return np.repeat(gray[..., None], 3, axis=-1)


def _view_rgb(modalities, gray):
    return _bgr(gray) if "ColorGradient" in modalities else None


@functools.lru_cache(maxsize=2)
def _trained(modalities=DEPTH_ONLY):
    """The reference trained on the snowman, and two frames (depths, BGRs)."""
    dep, gray, mask = scenes.snowman_scene()
    ref = RefPoseDetector(detector=RefDetector(modalities=modalities), model_points=512)
    assert ref.add_view("obj", dep, K, mask.astype(np.uint8) * 255,
                        rgb=_view_rgb(modalities, gray)) == 0
    rendered = [scenes.render_translated(dep, mask, K, t) for t in T_FRAMES]
    depths = np.stack([r[0] for r in rendered])
    rgbs = np.stack([_bgr(r[2]) for r in rendered])
    return ref, depths, rgbs


def _state(ref):
    templates = {
        cid: [[(t.width, t.height, t.pyramid_level, t.feature_array()) for t in tp]
              for tp in tps]
        for cid, tps in ref.detector.class_templates.items()}
    views = {k: dict(model_cloud=v.model_cloud, bbox=v.bbox,
                     anchor_point=v.anchor_point, view_pose=v.view_pose)
             for k, v in ref.views.items()}
    return templates, views


def _rot_deg(Ra, Rb):
    s = np.linalg.norm(Ra - Rb) / (2 * np.sqrt(2))
    return float(np.degrees(2 * np.arcsin(min(1.0, s))))


def check_schedule(schedule, modalities=DEPTH_ONLY):
    ref, frames, rgbs = _trained(modalities)
    params = SCHEDULES[schedule]
    ref.params = params
    templates, views = _state(ref)
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(params), model_points=512, device="cpu")
    assert port.detector.modality_names == modalities
    rgbs = rgbs if "ColorGradient" in modalities else None
    want = ref.detect_fused_batch(frames, K, rgbs)
    got = port.detect_fused_batch(frames, K, rgbs)
    assert len(got) == len(want) == 2
    assert any(want), "the reference found nothing"
    for b, (wp, gp) in enumerate(zip(want, got)):
        assert len(gp) == len(wp)
        for w, g in zip(wp, gp):
            assert (g.class_id, g.template_id, g.match_x, g.match_y, g.num_votes) == \
                (w.class_id, w.template_id, w.match_x, w.match_y, w.num_votes)
            assert g.match_similarity == pytest.approx(w.match_similarity, abs=1e-4)
            assert np.abs(g.pose[:3, 3] - w.pose[:3, 3]).max() < 1e-3
            assert _rot_deg(g.pose[:3, :3], w.pose[:3, :3]) < 0.5
        # and the frame's object is where it was put
        if gp:
            assert np.abs(gp[0].pose[:3, 3] - T_FRAMES[b]).max() < 0.01
    # the single-frame entry point is the batch of one
    one = port.detect_fused(frames[1], K, None if rgbs is None else rgbs[1])
    assert [(p.class_id, p.template_id, p.num_votes) for p in one] == \
        [(p.class_id, p.template_id, p.num_votes) for p in got[1]]
    for p, q in zip(one, got[1]):
        np.testing.assert_allclose(p.pose, q.pose, rtol=0, atol=1e-6)


def test_detect_fused_batch_equals_reference_promoted():
    check_schedule("promoted")


def test_two_modality_detect_fused_batch_equals_reference():
    check_schedule("promoted", BOTH)


def test_two_modality_detect_fused_batch_equals_reference_default():
    check_schedule("default", BOTH)


@pytest.mark.parametrize("modalities", [DEPTH_ONLY, BOTH])
def test_port_add_view_equals_reference(modalities):
    ref, _, _ = _trained(modalities)
    dep, gray, mask = scenes.snowman_scene()
    own = PoseDetector(detector=Detector(modalities=modalities), model_points=512,
                       device="cpu")
    assert own.add_view("obj", dep, K, mask.astype(np.uint8) * 255,
                        rgb=_view_rgb(modalities, gray)) == 0
    assert len(own.detector.class_templates["obj"][0]) == 2 * len(modalities)
    for a, b in zip(own.detector.class_templates["obj"][0],
                    ref.detector.class_templates["obj"][0]):
        assert (a.width, a.height, a.pyramid_level) == (b.width, b.height, b.pyramid_level)
        np.testing.assert_array_equal(a.feature_array(), b.feature_array())
    va, vb = own.views[("obj", 0)], ref.views[("obj", 0)]
    assert tuple(va.bbox) == tuple(vb.bbox)
    np.testing.assert_array_equal(va.anchor_point, vb.anchor_point)
    # model points: the same pixels (depth_to_3d is bit-exact); normals
    # within the FALS estimator's float noise
    np.testing.assert_array_equal(va.model_cloud[:, :3], vb.model_cloud[:, :3])
    dots = np.abs((va.model_cloud[:, 3:] * vb.model_cloud[:, 3:]).sum(-1))
    assert np.quantile(np.degrees(np.arccos(np.clip(dots, 0, 1))), 0.99) < 1.1
