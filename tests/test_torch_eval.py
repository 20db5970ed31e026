"""The port's evaluation path against the JAX package's, on the CPU: the
ADD metrics (eval/add_metric.py) within 1e-6 m, the synthetic BOP scene
(data/bop.py over io/png.py) bitwise, and evaluate_scene (eval/harness.py)
with the reference's counts and its mean ADD within 1 mm."""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu.core.config import DetectParams as RefDetectParams
from object_detector_6d_tpu.core.config import ICPParams as RefICPParams
from object_detector_6d_tpu.data.bop import BopScene as RefBopScene
from object_detector_6d_tpu.data.bop import load_model as ref_load_model
from object_detector_6d_tpu.data.bop import make_synthetic_bop_scene as ref_make_scene
from object_detector_6d_tpu.eval import add_metric as ref_add
from object_detector_6d_tpu.eval.harness import evaluate_scene as ref_evaluate_scene
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams
from object_detector_6d_tpu_torch.data.bop import BopScene, load_model, make_synthetic_bop_scene
from object_detector_6d_tpu_torch.eval import add_metric
from object_detector_6d_tpu_torch.eval.harness import evaluate_scene
from object_detector_6d_tpu_torch.io.ply import write_ply

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(2)
TOL_M = 1e-6


def _poses(rng, n):
    """n seeded poses: rotations up to ~30 deg, translations ~1 m away."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        w = rng.normal(size=3)
        w *= rng.uniform(0, 0.5) / np.linalg.norm(w)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        out[i, :3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
        out[i, :3, 3] = rng.uniform([-0.2, -0.2, 0.8], [0.2, 0.2, 1.4])
        out[i, 3, 3] = 1
    return out


def _metric_inputs():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.05, 0.05, (700, 3)).astype(np.float32)
    gt = _poses(rng, 6)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.004, size=(6, 3)).astype(np.float32)
    est[3] = _poses(rng, 1)[0]  # one far off
    return est, gt, pts


@pytest.mark.parametrize("fn", ["add_distance", "adds_distance"])
def test_distances_equal_reference(fn):
    est, gt, pts = _metric_inputs()
    got = getattr(add_metric, fn)(est, gt, pts, device="cpu")
    want = np.asarray(getattr(ref_add, fn)(est, gt, pts))
    assert got.device.type == "cpu" and got.shape == want.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_M, rtol=0)
    # one pose, and tensors on their own device
    one = getattr(add_metric, fn)(torch.as_tensor(est[0]), torch.as_tensor(gt[0]),
                                  torch.as_tensor(pts))
    assert abs(float(one) - float(want[0])) <= TOL_M


def test_diameter_and_accuracy_equal_reference():
    est, gt, pts = _metric_inputs()
    dia = add_metric.model_diameter(pts, device="cpu")
    assert abs(dia - ref_add.model_diameter(pts)) <= TOL_M
    for sym in (False, True):
        for d in (None, 0.05):
            got = add_metric.add_accuracy(est, gt, pts, diameter=d, symmetric=sym,
                                          device="cpu")
            assert got == ref_add.add_accuracy(est, gt, pts, diameter=d, symmetric=sym)
            assert 0.0 < got < 1.0


def test_numpy_inputs_default_to_the_card():
    est, gt, pts = _metric_inputs()
    if torch.cuda.is_available():
        assert add_metric.add_distance(est, gt, pts).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            add_metric.add_distance(est, gt, pts)


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bop")
    make_synthetic_bop_scene(str(d / "port"), n_frames=3, obj_id=1, seed=0)
    ref_make_scene(str(d / "ref"), n_frames=3, obj_id=1, seed=0)
    return str(d / "port"), str(d / "ref")


def _frame_fields(f):
    return (f.im_id, f.depth_u16, f.rgb, f.K, [(g.obj_id, g.R, g.t) for g in f.gt])


def _assert_frames_equal(a, b):
    fa, fb = _frame_fields(a), _frame_fields(b)
    assert fa[0] == fb[0]
    for x, y in zip(fa[1:4], fb[1:4]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert len(fa[4]) == len(fb[4]) == 1
    for (oa, Ra, ta), (ob, Rb, tb) in zip(fa[4], fb[4]):
        assert oa == ob
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_synthetic_scene_equals_reference(scene_dirs, reader):
    """Both packages write the same scene; each package's loader gives the
    same frames and ground truth from either directory, bitwise."""
    port_dir, ref_dir = scene_dirs
    for name in ("scene_camera.json", "scene_gt.json"):
        assert (json.load(open(f"{port_dir}/{name}"))
                == json.load(open(f"{ref_dir}/{name}")))
    src = port_dir if reader == "port" else ref_dir
    scene, ref_scene = BopScene(src), RefBopScene(src)
    assert scene.im_ids() == ref_scene.im_ids() == [0, 1, 2]
    for i in scene.im_ids():
        _assert_frames_equal(scene.frame(i), ref_scene.frame(i))
        _assert_frames_equal(BopScene(port_dir).frame(i), RefBopScene(ref_dir).frame(i))
    f = scene.frame(0)
    assert f.depth_u16.shape == (480, 640) and f.rgb.shape == (480, 640, 3)
    R = f.gt[0].pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)


def test_load_model_equals_reference(tmp_path):
    rng = np.random.RandomState(1)
    pc = np.concatenate([rng.uniform(-50, 50, (300, 3)),
                         rng.normal(size=(300, 3))], 1).astype(np.float32)
    write_ply(str(tmp_path / "obj_000001.ply"), pc)
    json.dump({"1": {"diameter": 123.5}}, open(tmp_path / "models_info.json", "w"))
    got, dia = load_model(str(tmp_path), 1)
    want, rdia = ref_load_model(str(tmp_path), 1)
    np.testing.assert_array_equal(got, want)
    assert dia == rdia == 0.1235


def _params(mod):
    return mod[0](match_threshold=65.0, max_hypotheses=4,
                  icp=mod[1](iterations=60, num_levels=3))


@functools.lru_cache(maxsize=1)
def _trained():
    dep, gray, mask = scenes.snowman_scene()
    bgr = np.repeat(gray[..., None], 3, 2)
    m = mask.astype(np.uint8) * 255
    ref = RefPoseDetector(params=_params((RefDetectParams, RefICPParams)))
    port = PoseDetector(params=_params((DetectParams, ICPParams)), device="cpu")
    assert ref.add_view("obj1", dep, scenes.K_DEFAULT, m, rgb=bgr) == 0
    assert port.add_view("obj1", dep, scenes.K_DEFAULT, m, rgb=bgr) == 0
    return ref, port


def test_evaluate_scene_equals_reference(scene_dirs):
    port_dir, _ = scene_dirs
    ref, port = _trained()
    pts = port.views[("obj1", 0)].model_cloud[:, :3]
    ref_pts = ref.views[("obj1", 0)].model_cloud[:, :3]
    got = evaluate_scene(port, BopScene(port_dir), {1: "obj1"}, {1: pts})
    want = ref_evaluate_scene(ref, RefBopScene(port_dir), {1: "obj1"}, {1: ref_pts})
    assert (got.n_frames, got.n_gt, got.n_detected, got.add_correct) == (
        want.n_frames, want.n_gt, want.n_detected, want.add_correct) == (3, 3, 3, 3)
    assert got.add_accuracy == want.add_accuracy == 1.0
    assert abs(got.mean_add - want.mean_add) <= 0.001
    assert got.mean_add < 0.01 and got.fps > 0
