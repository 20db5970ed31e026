"""Port parity: the windowed ICP association (DetectParams.icp_window)
against the JAX package.

- The association inside a per-lane window (port ``_associate`` with
  ``window``) against the reference's ``_associate_window`` (the one-hot
  contractions over a crop): weights equal and gathered rows exact.
- ``icp_levels(window=...)`` against the reference's: inlier counts
  equal, poses within 1e-4 m / 0.05 deg, residuals within 2e-5 m (the
  bounds of tests/test_torch_icp.py for the full gather).
- ``icp_window=-1``'s automatic size against the size the reference's
  pipeline hands its program, for several banks and frames.
- The fused detect at icp_window 96 and -1 against the reference's, as
  tests/test_torch_detect.py holds the full gather: same cluster fields,
  translations within 1 mm, rotations within 0.5 deg.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from object_detector_6d_tpu.api import detect_program as ref_dp
from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu.core.config import DetectParams as RefDetectParams
from object_detector_6d_tpu.core.config import ICPParams as RefICPParams
from object_detector_6d_tpu.quant.features import Feature as RefFeature
from object_detector_6d_tpu.quant.features import Template as RefTemplate
from object_detector_6d_tpu.refine.projective import _associate_window as ref_assoc_window
from object_detector_6d_tpu.refine.projective import icp_levels as ref_icp_levels
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import resolve_icp_window
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from object_detector_6d_tpu_torch.quant.features import Feature, Template
from object_detector_6d_tpu_torch.refine.projective import _associate, icp_levels
from test_torch_detect import DEPTH_ONLY, K, T_FRAMES, _rot_deg, _state, _trained
from test_torch_icp import CX, CY, FX, FY, H, W, _lanes, _scene_and_model
from test_torch_icp import _rot_deg as _rot_deg_lanes

torch.set_num_threads(1)

IW = 48  # a window smaller than the object, so the mask cuts points


def _windows(models, poses, seed=0):
    """Per-lane window origins around each lane's projected model centre,
    shifted at random and clamped into the frame as the program does."""
    rng = np.random.RandomState(seed)
    c = models[:, :, :3]
    c = np.nanmean(c, axis=1)
    p = np.einsum("lij,lj->li", poses[:, :3, :3], c) + poses[:, :3, 3]
    u = np.round(FX * p[:, 0] / p[:, 2] + CX).astype(np.int64)
    v = np.round(FY * p[:, 1] / p[:, 2] + CY).astype(np.int64)
    wx0 = np.clip(u - IW // 2 + rng.randint(-12, 13, len(u)), 0, W - IW)
    wy0 = np.clip(v - IW // 2 + rng.randint(-12, 13, len(v)), 0, H - IW)
    return wy0, wx0


def _crops(scene, wy0, wx0):
    img = scene.reshape(H, W, -1)
    return np.stack([img[y:y + IW, x:x + IW] for y, x in zip(wy0, wx0)])


def test_associate_window_equals_reference():
    scene, model, _ = _scene_and_model()
    models, poses = _lanes(model, L=8, seed=3)
    wy0, wx0 = _windows(models, poses)
    crops = _crops(scene[0], wy0, wx0)
    mask = np.isfinite(models[..., :3]).all(-1)
    sample = np.nan_to_num(models)
    cap, cos = np.float32(0.03), np.float32(0.5)
    r_qp, r_qn, r_w = (np.asarray(a) for a in jax.vmap(
        lambda p, m, k, c, y, x: ref_assoc_window(
            p, m, k, c, y, x, np.float32(FX), np.float32(FY), np.float32(CX),
            np.float32(CY), cap, cos))(
        jnp.asarray(poses), jnp.asarray(sample), jnp.asarray(mask), jnp.asarray(crops),
        jnp.asarray(wy0, jnp.int32), jnp.asarray(wx0, jnp.int32)))
    args = (torch.as_tensor(poses), torch.as_tensor(sample), torch.as_tensor(mask),
            torch.as_tensor(scene), torch.zeros(len(poses), dtype=torch.int64),
            FX, FY, CX, CY, H, W, float(cap), float(cos))
    qp, qn, w = _associate(*args, (torch.as_tensor(wy0), torch.as_tensor(wx0), IW))
    np.testing.assert_array_equal(w.numpy(), r_w)
    np.testing.assert_array_equal(qp.numpy(), r_qp)
    np.testing.assert_array_equal(qn.numpy(), r_qn)
    # the window cut correspondences that the full gather keeps, and kept some
    _, _, w_full = _associate(*args)
    assert (w_full.numpy() > 0).sum() > (r_w > 0).sum() > 0
    assert ((w.numpy() > 0) <= (w_full.numpy() > 0)).all()


@pytest.mark.parametrize("levels,iters,solves", [((2, 1, 0), [4, 4, 2], 2),
                                                 ((1, 0), 5, 1)])
def test_icp_levels_window_equals_reference(levels, iters, solves):
    scene, model, _ = _scene_and_model()
    models, poses = _lanes(model)
    wy0, wx0 = _windows(models, poses, seed=1)
    crops = _crops(scene[0], wy0, wx0)
    ref = jax.vmap(lambda m, p, c, y, x: ref_icp_levels(
        m, p, jnp.asarray(scene[0]), np.float32(FX), np.float32(FY), np.float32(CX),
        np.float32(CY), H, W, levels=levels, iters_per_level=iters,
        tolerance=3e-4, solves=solves, window=(c, y, x)))(
        jnp.asarray(models), jnp.asarray(poses), jnp.asarray(crops),
        jnp.asarray(wy0, jnp.int32), jnp.asarray(wx0, jnp.int32))
    r_res, r_pose, r_nin = (np.asarray(a) for a in ref)
    res, pose, nin = icp_levels(
        torch.as_tensor(models), torch.as_tensor(poses), torch.as_tensor(scene),
        torch.zeros(len(models), dtype=torch.int64), FX, FY, CX, CY, H, W,
        levels=levels, iters_per_level=iters, tolerance=3e-4, solves=solves,
        window=(torch.as_tensor(wy0), torch.as_tensor(wx0), IW))
    pose = pose.numpy()
    assert (r_nin[:-1] > 10).all()
    np.testing.assert_array_equal(nin.numpy(), r_nin)
    np.testing.assert_allclose(pose[:, :3, 3], r_pose[:, :3, 3], rtol=0, atol=1e-4)
    assert _rot_deg_lanes(pose[:, :3, :3], r_pose[:, :3, :3]).max() < 0.05
    np.testing.assert_allclose(res.numpy()[:-1], r_res[:-1], rtol=0, atol=2e-5)


class _Captured(Exception):
    pass


def _reference_window(det, frame_hw, icp_window):
    """The window size the reference's pipeline gives its program."""
    ref = RefPoseDetector(detector=det, params=RefDetectParams(icp_window=icp_window))
    seen = {}

    def capture(*args, **kw):
        seen.update(kw)
        raise _Captured

    real = ref_dp.make_detect_program
    ref_dp.make_detect_program = capture
    try:
        with pytest.raises(_Captured):
            ref.detect_fused_dispatch(np.full((2,) + frame_hw, 800, np.uint16), K)
    finally:
        ref_dp.make_detect_program = real
    return seen["icp_window"]


@pytest.mark.parametrize("sides", [(20,), (64, 30), (150, 90, 40), (181,), (400, 12)])
@pytest.mark.parametrize("frame_hw", [(480, 640), (120, 200)])
def test_auto_window_size_equals_reference(sides, frame_hw):
    ref_det = RefDetector(modalities=DEPTH_ONLY)
    det = Detector(modalities=DEPTH_ONLY)
    for i, s in enumerate(sides):
        ref_det.add_synthetic_template([RefTemplate(s, s - i, 0, [RefFeature(1, 1, 0)]),
                                        RefTemplate(s // 2, s // 2, 1, [RefFeature(1, 1, 0)])],
                                       f"c{i}")
        det.add_synthetic_template([Template(s, s - i, 0, [Feature(1, 1, 0)]),
                                    Template(s // 2, s // 2, 1, [Feature(1, 1, 0)])], f"c{i}")
    want = _reference_window(ref_det, frame_hw, -1)
    got = resolve_icp_window(-1, det.get_bank(), *frame_hw)
    assert got == want
    assert resolve_icp_window(96, det.get_bank(), *frame_hw) == 96
    assert _reference_window(ref_det, frame_hw, 0) == 0


PROMOTED = dict(match_threshold=80.0, max_hypotheses=16,
                icp=RefICPParams(iterations=32, num_levels=4, solves_per_assoc=2,
                                 finest_assoc=2), num_seeds=2)


@pytest.mark.parametrize("icp_window,fine_compact", [(96, 8), (-1, 8), (96, 0)])
def test_windowed_detect_equals_reference(icp_window, fine_compact):
    """Fine compaction picks whose windows are used (8 of 16 lanes) or
    every lane keeps its own (0)."""
    ref, frames, _ = _trained(DEPTH_ONLY)
    params = RefDetectParams(**PROMOTED, fine_compact=fine_compact, icp_window=icp_window)
    ref.params = params
    templates, views = _state(ref)
    port = pose_detector_from_state(detector_dict(ref.detector), templates, views,
                                    params_dict(params), model_points=512, device="cpu")
    assert port.params.icp_window == icp_window
    want = ref.detect_fused_batch(frames, K)
    got = port.detect_fused_batch(frames, K)
    assert any(want), "the reference found nothing"
    for b, (wp, gp) in enumerate(zip(want, got)):
        assert len(gp) == len(wp)
        for w, g in zip(wp, gp):
            assert (g.class_id, g.template_id, g.match_x, g.match_y, g.num_votes) == \
                (w.class_id, w.template_id, w.match_x, w.match_y, w.num_votes)
            assert np.abs(g.pose[:3, 3] - w.pose[:3, 3]).max() < 1e-3
            assert _rot_deg(g.pose[:3, :3], w.pose[:3, :3]) < 0.5
        if gp:
            assert np.abs(gp[0].pose[:3, 3] - T_FRAMES[b]).max() < 0.01
    # the window reached the program
    iw = resolve_icp_window(icp_window, port.detector.get_bank(), *frames.shape[1:])
    assert iw >= 96
    assert any(k[0] == "prog" and k[-1] == iw for k in port._cache)
