"""The reference's config-4 schedule (bench.py:404-457): 64 hypothesis
slots x 3 depth seeds = 192 ICP lanes a frame, fine compaction to the 16
best coarse survivors, match threshold 75, and bench's promoted ICP.

A JAX PoseDetector is trained with both modalities on the snowman (objA)
and its 0.78-scale copy (objB), plus a small synthetic bank; its state
goes to the port through io/convert.py. On two two-object tools/scenes.py
frames (bench.py's generator, seed 3: frame 1 holds 20 candidates through
the threshold, more than the 16 slots of the promoted schedule, so lanes
and the fine compaction run past them; frame 5 holds 12) the cluster
records must agree: class, template and match fields equal, translations
within 1 mm, rotations within 0.5 deg; no frame goes through the overflow
fallback in either package.

At threshold 75 objB's template also fits the flat background (residual
~3.8 mm, 86,000-96,000 votes, 0.1-0.3 m from any object), where the
point-to-plane ICP is free to slide in the plane: there the pose moves by
mm with the last bit of a sum, in each package. On the eight frames of
seed 3 every cluster's class, template, match and votes agree, and every
pose within 1 mm but those background fits, which lie 0.29-9.2 mm apart
(frames 0, 3, 4, 6, 7 over 1 mm). Frame 1's lies 0.53 mm apart, frame 5
has none.
"""

import dataclasses
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
from object_detector_6d_tpu.data.synthetic import synthetic_bank as ref_synthetic_bank
from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

K = scenes.K_DEFAULT
PROMOTED = RefDetectParams(
    match_threshold=80.0, max_hypotheses=16,
    icp=RefICPParams(iterations=32, num_levels=4, solves_per_assoc=2, finest_assoc=2),
    num_seeds=2, fine_compact=8)
CONFIG4 = dataclasses.replace(PROMOTED, match_threshold=75.0, max_hypotheses=64, num_seeds=3,
                              fine_compact=16)
FRAME_SEED = 3
FRAMES = (1, 5)  # 20 and 12 candidates through the threshold


def _bgr(gray):
    return np.repeat(gray[..., None], 3, axis=-1)


def _frames(n: int, seed: int):
    """bench.py's two-object frames: objA at tA, objB at tB, z-min composed;
    depths, BGRs and the translations."""
    depA, _, maskA = scenes.snowman_scene()
    depB, _, maskB = scenes.snowman_scene(scale=0.78)
    rng = np.random.RandomState(seed)
    depths, rgbs, gts = [], [], []
    for _ in range(n):
        tA = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                       rng.uniform(-0.04, 0.04)])
        tB = np.array([-0.26 + rng.uniform(-0.03, 0.03), 0.11 + rng.uniform(-0.03, 0.03),
                       0.04 + rng.uniform(-0.03, 0.03)])
        d, _, g = scenes.merge_scenes([scenes.render_translated(depA, maskA, K, tA),
                                       scenes.render_translated(depB, maskB, K, tB)])
        depths.append(d)
        rgbs.append(_bgr(g))
        gts.append(tA)
    return np.stack(depths), np.stack(rgbs), gts


@functools.lru_cache(maxsize=1)
def _trained():
    """The reference at the config-4 schedule: synthetic_bank(2, 10) + objA +
    objB (22 templates); the port from its state; the two frames."""
    ref = RefPoseDetector(detector=ref_synthetic_bank(n_classes=2, per_class=10, bbox_px=120,
                                                      seed=0, detector=RefDetector()),
                          params=CONFIG4, model_points=512)
    for cid, scale in (("objA", 1.0), ("objB", 0.78)):
        dep, gray, mask = scenes.snowman_scene(scale=scale)
        assert ref.add_view(cid, dep, K, mask.astype(np.uint8) * 255, rgb=_bgr(gray)) == 0
    templates = {
        cid: [[(t.width, t.height, t.pyramid_level, t.feature_array()) for t in tp]
              for tp in tps]
        for cid, tps in ref.detector.class_templates.items()}
    views = {k: dict(model_cloud=v.model_cloud, bbox=v.bbox, anchor_point=v.anchor_point,
                     view_pose=v.view_pose) for k, v in ref.views.items()}
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(CONFIG4), model_points=512, device="cpu")
    depths, rgbs, gts = _frames(max(FRAMES) + 1, FRAME_SEED)
    pick = list(FRAMES)
    return ref, port, depths[pick], rgbs[pick], [gts[i] for i in pick]


def _rot_deg(Ra, Rb):
    s = np.linalg.norm(Ra - Rb) / (2 * np.sqrt(2))
    return float(np.degrees(2 * np.arcsin(min(1.0, s))))


def test_config4_lanes_run_past_the_promoted_slots():
    """More than 16 candidates pass the threshold on a frame: the 64 slots
    hold them all (no overflow) and the lanes past 16 x seeds run."""
    _, port, depths, rgbs, _ = _trained()
    handle = port.detect_fused_dispatch(depths, K, rgbs)
    _, K_cap = port.program(*depths.shape[1:], K)
    _, n_raw, n_pass = dp.unflatten_cluster_outputs(handle[0].numpy(), K_cap)
    assert K_cap == 64
    assert n_raw.max() > 16 and n_raw.max() <= K_cap, n_raw
    assert n_pass.max() > 0


def test_config4_detect_fused_batch_equals_reference():
    ref, port, depths, rgbs, gts = _trained()
    want = ref.detect_fused_batch(depths, K, rgbs)
    got = port.detect_fused_batch(depths, K, rgbs)
    assert ref.counters.counts.get("overflow_fallback", 0) == \
        port.counters.counts.get("overflow_fallback", 0) == 0
    assert len(got) == len(want) == len(FRAMES)
    for b, (wp, gp) in enumerate(zip(want, got)):
        assert len(gp) == len(wp), b
        for w, g in zip(wp, gp):
            assert (g.class_id, g.template_id, g.match_x, g.match_y, g.num_votes) == \
                (w.class_id, w.template_id, w.match_x, w.match_y, w.num_votes)
            assert g.match_similarity == pytest.approx(w.match_similarity, abs=1e-4)
            assert np.abs(g.pose[:3, 3] - w.pose[:3, 3]).max() < 1e-3
            assert _rot_deg(g.pose[:3, :3], w.pose[:3, :3]) < 0.5
        # objA is where it was put
        a = [p for p in gp if p.class_id == "objA"]
        assert a and np.abs(a[0].pose[:3, 3] - gts[b]).max() < 0.01
