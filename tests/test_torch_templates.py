"""Training from a model (api/templates.py) and the training pyramids of
the port against the JAX package, on the CPU (the twins of K1 and K2):
rendered views bitwise, templates exactly, view clouds within 1e-6 m, the
novel view's pose within 1 mm / 0.5 deg of the reference's (the NN ICP's
known sensitivity, ROADMAP queue 3)."""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu.api.templates import render_view as ref_render_view
from object_detector_6d_tpu.api.templates import train_from_model as ref_train_from_model
from object_detector_6d_tpu.core.config import DetectParams as RefDetectParams
from object_detector_6d_tpu.core.config import ICPParams as RefICPParams
from object_detector_6d_tpu.core.se3 import SE3 as RefSE3
from object_detector_6d_tpu.geom.backproject import depth_to_3d as ref_depth_to_3d
from object_detector_6d_tpu.geom.normals import normals_fals as ref_normals_fals
from object_detector_6d_tpu.quant.pyramid import ColorGradientPyramid as RefCGPyramid
from object_detector_6d_tpu.quant.pyramid import DepthNormalPyramid as RefDNPyramid
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.api.templates import render_view, train_from_model
from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams
from object_detector_6d_tpu_torch.quant import color_gradient
from object_detector_6d_tpu_torch.quant.pyramid import ColorGradientPyramid, DepthNormalPyramid

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(2)
K = scenes.K_DEFAULT
XDEV_T_M = 0.001
XDEV_DEG = 0.5


def rot_deg(Ra, Rb) -> float:
    s = np.linalg.norm(np.asarray(Ra) - np.asarray(Rb)) / (2.0 * np.sqrt(2.0))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, s))))


def _p99_deg(a, b):
    """99th percentile of the angle [deg] between unit normals [..., 3]."""
    dots = np.clip((a * b).sum(-1), -1.0, 1.0)
    return float(np.quantile(np.degrees(np.arccos(dots)), 0.99))


@functools.lru_cache(maxsize=1)
def _model():
    """The reference test's object model: the snowman view's cloud + FALS
    normals, centred (tests/test_templates.py)."""
    dep, _, mask = scenes.snowman_scene()
    cloud = np.asarray(ref_depth_to_3d(dep, K))
    nrm = np.asarray(ref_normals_fals(cloud, K))
    ok = mask & np.isfinite(cloud).all(-1) & np.isfinite(nrm).all(-1)
    pts, ns = cloud[ok], nrm[ok]
    center = pts.mean(0)
    return np.concatenate([pts - center, ns], -1).astype(np.float32), center


def _pose(t, w=(0, 0, 0)):
    T = np.asarray(RefSE3.exp(np.array([*w, 0, 0, 0], np.float32)), np.float64)
    T[:3, 3] = t
    return T


def _views():
    _, center = _model()
    return [_pose(center), _pose(center, w=(0.10, 0, 0)), _pose(center, w=(0, 0.10, 0))]


def _novel():
    _, center = _model()
    return _pose(center + np.array([0.05, -0.02, -0.03]), w=(0.05, 0.02, 0))


def _params(mod):
    return mod[0](match_threshold=65.0, max_hypotheses=4,
                  icp=mod[1](iterations=60, num_levels=3))


@functools.lru_cache(maxsize=1)
def _trained():
    model, _ = _model()
    ref = RefPoseDetector(params=_params((RefDetectParams, RefICPParams)))
    port = PoseDetector(params=_params((DetectParams, ICPParams)), device="cpu")
    return (ref, ref_train_from_model(ref, "obj", model, K, _views()),
            port, train_from_model(port, "obj", model, K, _views()))


@pytest.mark.parametrize("which", ["view0", "view1", "view2", "novel"])
def test_render_view_equals_reference(which):
    model, _ = _model()
    T = _novel() if which == "novel" else _views()[int(which[-1])]
    for a, b in zip(render_view(model, K, T, bg_mm=1500), ref_render_view(model, K, T, bg_mm=1500)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_train_from_model_templates_equal_reference():
    ref, ref_tids, port, tids = _trained()
    assert tids == ref_tids and all(t >= 0 for t in tids), (tids, ref_tids)
    ref_tps = ref.detector.class_templates["obj"]
    port_tps = port.detector.class_templates["obj"]
    assert len(port_tps) == len(ref_tps) == 3
    for tp, rtp in zip(port_tps, ref_tps):
        assert len(tp) == len(rtp) == 4
        for t, r in zip(tp, rtp):
            assert (t.width, t.height, t.pyramid_level) == (r.width, r.height, r.pyramid_level)
            np.testing.assert_array_equal(t.feature_array(), r.feature_array())


def test_train_from_model_views_equal_reference():
    ref, _, port, tids = _trained()
    for tid in tids:
        v, r = port.views[("obj", tid)], ref.views[("obj", tid)]
        assert v.bbox == r.bbox
        np.testing.assert_array_equal(np.isnan(v.model_cloud), np.isnan(r.model_cloud))
        np.testing.assert_allclose(v.model_cloud[:, :3], r.model_cloud[:, :3], atol=1e-6, rtol=0)
        # FALS normals: the bound the port holds them to (test_torch_geometry)
        ok = ~np.isnan(r.model_cloud[:, 3])
        assert _p99_deg(v.model_cloud[ok, 3:], r.model_cloud[ok, 3:]) <= 1.1
        np.testing.assert_allclose(v.anchor_point, r.anchor_point, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(v.view_pose, r.view_pose)


def test_detect_novel_view_within_reference():
    model, _ = _model()
    ref, _, port, _ = _trained()
    T_gt = _novel()
    depth, _, gray = render_view(model, K, T_gt, bg_mm=1500)
    rgb = np.repeat(gray[..., None], 3, 2)
    got = port.detect(depth, K, rgb=rgb)
    want = ref.detect(depth, K, rgb=rgb)
    assert got and [p.class_id for p in got] == [p.class_id for p in want]
    for a, b in zip(got, want):
        assert np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max() <= XDEV_T_M
        assert rot_deg(a.pose[:3, :3], b.pose[:3, :3]) <= XDEV_DEG
    best = got[0].pose
    pts = model[::7, :3]
    d = np.linalg.norm(pts @ best[:3, :3].T + best[:3, 3]
                       - (pts @ T_gt[:3, :3].T + T_gt[:3, 3]), axis=-1).mean()
    assert d < 0.012, f"mean model-point error {d:.4f} m"


def _noisy_view():
    dep, gray, mask = scenes.snowman_scene()
    noise = np.random.RandomState(3).randint(-24, 25, gray.shape + (3,))
    bgr = np.clip(np.repeat(gray[..., None], 3, 2) + noise, 0, 255).astype(np.uint8)
    return dep, bgr, mask.astype(np.uint8) * 255


@pytest.mark.parametrize("hw", [(480, 640), (479, 641)])
def test_pyramids_on_cpu_equal_reference(hw):
    """The quantized images and magnitudes of both training pyramids
    (K1 / K2 wrappers on CPU tensors, i.e. the twins) equal the
    reference's exactly at both levels, and so do their templates."""
    dep, bgr, mask = _noisy_view()
    h, w = hw
    dep, mask = np.pad(dep, ((0, 1), (0, 1)), mode="edge")[:h, :w], \
        np.pad(mask, ((0, 1), (0, 1)), mode="edge")[:h, :w]
    bgr = np.pad(bgr, ((0, 1), (0, 1), (0, 0)), mode="edge")[:h, :w]
    cg, rcg = ColorGradientPyramid(bgr, levels=2, mask=mask, device="cpu"), \
        RefCGPyramid(bgr, levels=2, mask=mask)
    dn, rdn = DepthNormalPyramid(dep, levels=2, mask=mask, device="cpu"), \
        RefDNPyramid(dep, levels=2, mask=mask)
    for lvl in range(2):
        np.testing.assert_array_equal(cg.quantize(lvl), rcg.quantize(lvl))
        np.testing.assert_array_equal(cg._magnitude[lvl], rcg._magnitude[lvl])
        np.testing.assert_array_equal(dn.quantize(lvl), rdn.quantize(lvl))
        for p, r in ((cg, rcg), (dn, rdn)):
            t, rt = p.extract_template(lvl), r.extract_template(lvl)
            assert (t is None) == (rt is None)
            if t is not None:
                np.testing.assert_array_equal(t.feature_array(), rt.feature_array())


def test_selected_magnitude_is_the_twins_magnitude():
    _, bgr, _ = _noisy_view()
    x = torch.as_tensor(bgr)
    q, mag = color_gradient.quantized_orientations(x)
    assert torch.equal(color_gradient.selected_magnitude(x), mag)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_training_on_the_default_device_raises_without_a_card():
    dep, bgr, mask = _noisy_view()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PoseDetector().add_view("obj", dep, K, mask, rgb=bgr)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PoseDetector().detector.add_template([bgr, dep], "obj", mask)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ColorGradientPyramid(bgr)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DepthNormalPyramid(dep)
