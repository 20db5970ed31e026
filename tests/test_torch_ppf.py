"""Port parity: the PPF detector and its point-cloud helpers against the
JAX package, on tests/test_ppf.py's model (three sphere caps, 900 points
with analytic normals).

Tolerances, measured here:

- the numpy helpers (voxel sampling, uniform sampling, the pose
  transform, the noise) are copies: bitwise;
- ``knn``: indices equal (ties list the lower index first), squared
  distances within 1e-6; ``compute_normals_pc3d``: the points bitwise,
  the normals within 1e-3 deg (1.2e-4 measured: ``eigh`` of another
  library);
- the trained tables: keys and first indices equal exactly (no
  ``arccos`` landed on a bin edge here), the sampled model and diameter
  exactly; the alphas within 1e-5 rad (3e-6 measured on ~37% of the
  entries: XLA:CPU's ``arctan2`` / ``arccos`` are its own approximations,
  not the C library's);
- ``match``: the best pose within 1 mm and 0.5 deg of the JAX package's
  (equal here), and within tests/test_ppf.py's bounds of the truth;
- the trained state crosses both ways through either package's npz with
  every array equal, and the loaded detector matches as the writer does.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.core.se3 import SE3 as RefSE3
from object_detector_6d_tpu.ppf import helpers as ref_helpers
from object_detector_6d_tpu.ppf.detector import PPFDetector as RefPPFDetector
from object_detector_6d_tpu_torch.ppf import helpers
from object_detector_6d_tpu_torch.ppf.detector import PPFDetector

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_ppf import _model_cloud  # noqa: E402

torch.set_num_threads(2)

ARRAYS = ("relative_sampling_step", "relative_distance_step", "num_angles", "model_sampled",
          "model_diameter", "keys_sorted", "vals_i", "vals_alpha")


def _pose_err(A, B):
    """(translation m, rotation deg) between two 4x4 poses."""
    c = (np.trace(A[:3, :3].T @ B[:3, :3]) - 1) / 2
    return (float(np.linalg.norm(A[:3, 3] - B[:3, 3])),
            float(np.degrees(np.arccos(np.clip(c, -1, 1)))))


def _scene(model, twist):
    T = np.asarray(RefSE3.exp(np.array(twist, np.float32)))
    return T, helpers.transform_pc_pose(model, T)


@pytest.fixture(scope="module")
def trained():
    model = _model_cloud()
    ref = RefPPFDetector(relative_sampling_step=0.05)
    ref.train_model(model)
    det = PPFDetector(relative_sampling_step=0.05, device="cpu")
    det.train_model(model)
    return model, ref, det


def test_numpy_helpers_are_the_reference_copies():
    pc = _model_cloud()
    for step in (0.05, 0.13):
        np.testing.assert_array_equal(helpers.sample_pc_by_quantization(pc, step),
                                      ref_helpers.sample_pc_by_quantization(pc, step))
    np.testing.assert_array_equal(helpers.sample_pc_uniform(pc, 7),
                                  ref_helpers.sample_pc_uniform(pc, 7))
    T = np.asarray(RefSE3.exp(np.array([0.4, -0.3, 0.5, 0.06, -0.02, 0.04], np.float32)))
    np.testing.assert_array_equal(helpers.transform_pc_pose(pc, T),
                                  ref_helpers.transform_pc_pose(pc, T))
    np.testing.assert_array_equal(helpers.add_noise_pc(pc, 0.001, seed=3),
                                  ref_helpers.add_noise_pc(pc, 0.001, seed=3))


def test_knn_and_pca_normals_equal_reference():
    pc = _model_cloud(400)
    want_i, want_d = (np.asarray(x) for x in ref_helpers.knn(pc[:, :3], pc[:, :3], 4))
    got_i, got_d = helpers.knn(pc[:, :3], pc[:, :3], 4, device="cpu")
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-6)
    assert (got_i.numpy()[:, 0] == np.arange(400)).all()
    # equal distances: the lower index first, as lax.top_k
    pts = np.array([[0, 0, 0], [2, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0]], np.float32)
    want = np.asarray(ref_helpers.knn(pts[:1], pts, 4)[0])
    got = helpers.knn(torch.as_tensor(pts[:1]), torch.as_tensor(pts), 4)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 2, 3, 4]])
    # blocks of query rows give the same answer
    small = helpers.KNN_BLOCK_ENTRIES
    try:
        helpers.KNN_BLOCK_ENTRIES = 7 * 400
        np.testing.assert_array_equal(helpers.knn(pc[:, :3], pc[:, :3], 4, device="cpu")[0],
                                      want_i)
    finally:
        helpers.KNN_BLOCK_ENTRIES = small
    vp = np.array([0.0, 0, 1.0], np.float32)
    want = np.asarray(ref_helpers.compute_normals_pc3d(pc[:, :3], k=10, viewpoint=vp))
    got = helpers.compute_normals_pc3d(pc[:, :3], k=10, viewpoint=vp, device="cpu").numpy()
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    a, b = got[:, 3:].astype(np.float64), want[:, 3:].astype(np.float64)
    ang = np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), (a * b).sum(-1)))
    assert ang.max() < 1e-3
    assert np.median(np.abs(np.sum(got[:, 3:] * pc[:, 3:], -1))) > 0.95


def test_trained_tables_equal_reference(trained):
    _, ref, det = trained
    np.testing.assert_array_equal(det.model_sampled, ref.model_sampled)
    assert det.model_diameter == ref.model_diameter
    assert det._keys_sorted.dtype == np.asarray(ref._keys_sorted).dtype
    np.testing.assert_array_equal(det._keys_sorted, ref._keys_sorted)
    np.testing.assert_array_equal(det._vals_i, ref._vals_i)
    assert det._vals_alpha.dtype == np.float32
    np.testing.assert_allclose(det._vals_alpha, ref._vals_alpha, rtol=0, atol=1e-5)


def test_match_equals_reference_and_truth(trained):
    model, ref, det = trained
    T_true, scene = _scene(model, [0.4, -0.3, 0.5, 0.06, -0.02, 0.04])
    want = ref.match(scene, relative_scene_sample_step=0.25)
    got = det.match(scene, relative_scene_sample_step=0.25)
    assert got and len(got) == len(want)
    assert got[0].num_votes == want[0].num_votes
    dt, dr = _pose_err(got[0].pose, want[0].pose)
    assert dt < 1e-3 and dr < 0.5, (dt, dr)
    # tests/test_ppf.py's bounds against the truth
    dt, dr = _pose_err(got[0].pose, T_true)
    assert dt < 0.1 * det.model_diameter and dr < 25.0, (dt, dr)
    assert det.vote_table_bytes == 4 * (len(det.model_sampled) * 2 * det.num_angles + 1) * \
        len(range(0, len(helpers.sample_pc_by_quantization(scene, 0.03)), 4))


def test_match_blocks_of_reference_points(trained, monkeypatch):
    """Vote tables in several blocks give the one-block answer."""
    from object_detector_6d_tpu_torch.ppf import detector as ppf_detector

    model, _, det = trained
    _, scene = _scene(model, [0.2, -0.1, 0.3, 0.04, -0.01, 0.03])
    whole = det.match(scene, relative_scene_sample_step=0.25)
    n_bins = len(det.model_sampled) * 2 * det.num_angles + 1
    monkeypatch.setattr(ppf_detector, "VOTE_BLOCK_BYTES", 4 * n_bins * 5)
    parts = det.match(scene, relative_scene_sample_step=0.25)
    assert det.vote_table_bytes == 4 * n_bins * 5
    assert len(parts) == len(whole)
    for a, b in zip(parts, whole):
        assert a.num_votes == b.num_votes
        np.testing.assert_array_equal(a.pose, b.pose)


def test_npz_carried_both_ways(trained, tmp_path):
    model, ref, det = trained
    _, scene = _scene(model, [0.2, -0.1, 0.3, 0.04, -0.01, 0.03])
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref.write(ref_path)
    det.write(port_path)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(ARRAYS)
    # the JAX package's file, read by the port
    loaded = PPFDetector.read(ref_path, device="cpu")
    with np.load(ref_path) as g:
        np.testing.assert_array_equal(loaded.model_sampled, g["model_sampled"])
        np.testing.assert_array_equal(loaded._keys_sorted, g["keys_sorted"])
        np.testing.assert_array_equal(loaded._vals_i, g["vals_i"])
        np.testing.assert_array_equal(loaded._vals_alpha, g["vals_alpha"])
        assert loaded.model_diameter == float(g["model_diameter"])
        assert loaded.num_angles == int(g["num_angles"])
    p_ref = ref.match(scene, relative_scene_sample_step=0.25)
    p_loaded = loaded.match(scene, relative_scene_sample_step=0.25)
    dt, dr = _pose_err(p_loaded[0].pose, p_ref[0].pose)
    assert dt < 1e-3 and dr < 0.5
    # the port's file, read by the JAX package
    back = RefPPFDetector.read(port_path)
    np.testing.assert_array_equal(back.model_sampled, det.model_sampled)
    np.testing.assert_array_equal(back._keys_sorted, det._keys_sorted)
    np.testing.assert_array_equal(back._vals_i, det._vals_i)
    np.testing.assert_array_equal(back._vals_alpha, det._vals_alpha)
    assert back.model_diameter == det.model_diameter
    p_port = det.match(scene, relative_scene_sample_step=0.25)
    p_back = back.match(scene, relative_scene_sample_step=0.25)
    dt, dr = _pose_err(p_back[0].pose, p_port[0].pose)
    assert dt < 1e-3 and dr < 0.5
    # and the port's own round trip is exact
    again = PPFDetector.read(port_path, device="cpu")
    p_again = again.match(scene, relative_scene_sample_step=0.25)
    np.testing.assert_array_equal(p_again[0].pose, p_port[0].pose)


def test_untrained_detector_refuses():
    with pytest.raises(ValueError, match="untrained"):
        PPFDetector(device="cpu").write("never.npz")
