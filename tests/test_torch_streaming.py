"""Streaming multi-camera detection (api/streaming.py) against the JAX
package's, on the reference's own tick (tests/test_streaming.py): the
snowman trained with both modalities, threshold 65, 4 hypotheses, ICP 45
iterations / 3 levels, four 480x640 cameras of which one sees an empty
scene.

The reference's trained state goes to the port as plain numpy. Both
``process`` (one fused call for the tick) and ``process_host`` (per-camera
match, one geometry pass, median lift, nearest-neighbour ICP per
hypothesis, per-camera NMS) must give the empty camera ``[]``, every other
camera its snowman within 12 mm, and poses within 1 mm / 0.5 deg of the
reference's with the same class, template and match fields. The
nearest-neighbour ICP of ``process_host`` is sensitive to the last bits
of its start (tests/test_torch_fallback.py), so the comparison is held on
cameras whose hypotheses are well separated: each camera's match list
here holds one object's hypotheses, all lifted to the same surface.
"""

import functools

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu.api.streaming import StreamingDetector as RefStreamingDetector
from object_detector_6d_tpu.core.config import DetectParams, ICPParams
from object_detector_6d_tpu_torch.api.streaming import StreamingDetector
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)

from test_torch_detect import K, _bgr, _rot_deg, _state, scenes

torch.set_num_threads(1)

TRUTHS = (np.array([0.03, -0.01, -0.02]), np.array([-0.04, 0.02, 0.03]), None,
          np.array([0.01, 0.03, -0.04]))


@functools.lru_cache(maxsize=1)
def _setup():
    """The reference's streaming detector as its test builds it, the
    port's holding the same state, and the tick's frames."""
    params = DetectParams(match_threshold=65.0, max_hypotheses=4,
                          icp=ICPParams(iterations=45, num_levels=3))
    ref = RefPoseDetector(params=params)
    dep, gray, mask = scenes.snowman_scene()
    assert ref.add_view("obj", dep, K, mask.astype(np.uint8) * 255, rgb=_bgr(gray)) == 0
    templates, views = _state(ref)
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(params), model_points=ref.model_points,
                                    device="cpu")
    depths, rgbs = [], []
    for t in TRUTHS:
        if t is None:
            depths.append(np.full((480, 640), 1500, np.uint16))
            rgbs.append(np.full((480, 640, 3), 128, np.uint8))
        else:
            d2, _, g2 = scenes.render_translated(dep, mask, K, t)
            depths.append(d2)
            rgbs.append(_bgr(g2))
    return (RefStreamingDetector(ref, n_cameras=4), StreamingDetector(port, n_cameras=4),
            np.stack(depths), np.stack(rgbs))


@pytest.mark.parametrize("entry", ["process", "process_host"])
def test_four_camera_tick_equals_reference(entry):
    ref, port, depths, rgbs = _setup()
    want = getattr(ref, entry)(depths, K, rgbs)
    got = getattr(port, entry)(depths, K, rgbs)
    assert len(got) == len(want) == 4
    assert got[2] == want[2] == []  # the empty camera yields nothing, no stall
    for cam, t in enumerate(TRUTHS):
        if t is None:
            continue
        assert got[cam], f"camera {cam} missed its detection"
        assert np.abs(got[cam][0].pose[:3, 3] - t).max() < 0.012
        assert [(p.class_id, p.template_id, p.match_x, p.match_y, p.num_votes)
                for p in got[cam]] == \
            [(p.class_id, p.template_id, p.match_x, p.match_y, p.num_votes) for p in want[cam]]
        for g, w in zip(got[cam], want[cam]):
            assert np.abs(g.pose[:3, 3] - w.pose[:3, 3]).max() < 1e-3
            assert _rot_deg(g.pose[:3, :3], w.pose[:3, :3]) < 0.5
