"""A frame's answer on the card must not depend on the batch it came in.

On a CUDA card ``torch.matmul`` and ``torch.sum`` reduce in an order that
changes with the number of lanes, so the Gauss-Newton sums of the
projective ICP (refine/projective.py) differ in their last bits between
batch sizes (``batch_probe.py`` names the first stage that does). The card
test holds what that may cost: one frame alone and as the first of 2 and
of 4 frames through ``detect_fused_batch`` gives the same detections
within 0.1 mm / 0.05 deg. The CPU test holds the solve itself to a known
motion.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams
from object_detector_6d_tpu_torch.refine.projective import _gn_solve

torch.set_num_threads(1)


def test_gn_solve_recovers_a_known_motion():
    """One solve on exact pairs recovers a small translation per lane,
    leaves an unmoved lane alone and reports the weighted mean |r|."""
    rng = np.random.RandomState(0)
    L, n = 3, 256
    pts = torch.as_tensor(rng.uniform(-0.1, 0.1, (L, n, 3)).astype(np.float32))
    pts[..., 2] += 1.0
    nrm = torch.nn.functional.normalize(torch.as_tensor(rng.randn(L, n, 3).astype(np.float32)),
                                        dim=-1)
    model = torch.cat([pts, nrm], -1)
    pose = torch.eye(4).repeat(L, 1, 1)
    shift = torch.as_tensor([[1e-3, -2e-3, 5e-4], [0.0, 0.0, 0.0], [-3e-3, 1e-3, 2e-3]])
    qp = pts + shift[:, None, :]
    w = torch.as_tensor((rng.rand(L, n) < 0.8).astype(np.float32))
    new_pose, upd, residual = _gn_solve(pose, model, qp, nrm, w)
    assert torch.allclose(new_pose[:, :3, 3], shift, atol=2e-5)
    assert torch.allclose(new_pose[:, :3, :3], torch.eye(3).expand(L, 3, 3), atol=2e-4)
    r = ((pts - qp) * nrm).sum(-1)
    assert torch.allclose(residual, (r.abs() * w).sum(-1) / w.sum(-1), rtol=1e-5, atol=1e-9)
    assert upd[1] < 1e-6 < upd[0]


def _rot_deg(Ra, Rb):
    s = np.linalg.norm(Ra - Rb) / (2 * np.sqrt(2))
    return float(np.degrees(2 * np.arcsin(min(1.0, s))))


@pytest.mark.cuda
def test_detect_fused_batch_answers_a_frame_alike_at_batch_sizes_1_2_4():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
    import scenes

    K = scenes.K_DEFAULT
    params = DetectParams(match_threshold=80.0, max_hypotheses=16,
                          icp=ICPParams(iterations=32, num_levels=4, solves_per_assoc=2,
                                        finest_assoc=2),
                          num_seeds=2, fine_compact=8)
    pd = PoseDetector(detector=Detector(modalities=("DepthNormal",)), params=params,
                      model_points=512, device="cuda:0")
    views = {}
    for cid, scale in (("objA", 1.0), ("objB", 0.78)):
        dep, _, mask = scenes.snowman_scene(scale=scale)
        assert pd.add_view(cid, dep, K, mask.astype(np.uint8) * 255) == 0
        views[cid] = (dep, mask)
    rng = np.random.RandomState(1)
    frames = []
    for _ in range(4):
        tA = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                       rng.uniform(-0.04, 0.04)])
        tB = np.array([-0.26, 0.11, 0.04]) + rng.uniform(-0.03, 0.03, 3)
        rendered = [scenes.render_translated(*views[cid], K, t)
                    for cid, t in (("objA", tA), ("objB", tB))]
        frames.append(scenes.merge_scenes(rendered)[0])
    depths = np.stack(frames)
    alone = pd.detect_fused_batch(depths[:1], K)[0]
    assert {p.class_id for p in alone} >= {"objA"}
    for B in (2, 4):
        first = pd.detect_fused_batch(depths[:B], K)[0]
        assert [(p.class_id, p.template_id) for p in first] == \
            [(p.class_id, p.template_id) for p in alone]
        for a, b in zip(alone, first):
            assert np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max() <= 1e-4   # 0.1 mm
            assert _rot_deg(a.pose[:3, :3], b.pose[:3, :3]) <= 0.05
