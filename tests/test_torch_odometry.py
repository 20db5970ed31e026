"""Port parity: the four odometry methods against the JAX package on
tests/test_odometry.py's frame pairs (480x640, 3 levels).

Tolerances: the per-level frames (clouds, intensities) equal the
reference's exactly and the cross normals within 2e-7 (an ulp of
XLA:CPU's arithmetic); the recovered Rt within 0.5 mm and 0.05 deg of the
JAX package's (measured: <= 0.003 mm, 0 deg; the 6x6 normal equations sum
~300k rows in another order than XLA's); the motion-recovery bounds of
tests/test_odometry.py against the truth; the identity within 2e-3.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.odometry import odometry as ref_odo
from object_detector_6d_tpu_torch.odometry import odometry as odo

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(2)

K = scenes.K_DEFAULT


def _frames(method):
    """tests/test_odometry.py's pair: the camera moved by t, so the scene
    is rendered translated by -t; the photometric methods take its
    smooth texture."""
    rgb = method in ("Rgbd", "RgbdICP")
    t = np.array([0.008, -0.004, 0.006]) if rgb else np.array([0.012, -0.007, 0.009])
    dep1, gray1, mask = scenes.snowman_scene()
    if rgb:
        yy, xx = np.mgrid[0:480, 0:640]
        gray1 = (127 + 90 * np.sin(xx / 17.0) * np.cos(yy / 23.0)).astype(np.uint8)
    dep2, _, gray2 = scenes.render_translated(dep1, mask | True, K, -t, bg_mm=0,
                                              smooth_texture=rgb)
    return t, dep1, np.repeat(gray1[..., None], 3, 2), dep2, np.repeat(gray2[..., None], 3, 2)


def _rot_deg(A, B):
    c = (np.trace(A[:3, :3].T @ B[:3, :3]) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_frame_pyramid_equals_reference():
    _, dep1, img1, _, _ = _frames("RgbdICP")
    want = ref_odo.OdometryFrame.create(dep1, K, image=img1, levels=3)
    got = odo.OdometryFrame.create(dep1, K, image=img1, levels=3, device="cpu")
    for lvl in range(3):
        np.testing.assert_array_equal(got.clouds[lvl].numpy(), np.asarray(want.clouds[lvl]))
        np.testing.assert_array_equal(got.intensities[lvl].numpy(),
                                      np.asarray(want.intensities[lvl]))
        n, wn = got.normals[lvl].numpy(), np.asarray(want.normals[lvl])
        np.testing.assert_array_equal(np.isnan(n), np.isnan(wn))
        np.testing.assert_allclose(n, wn, rtol=0, atol=2e-7)
        np.testing.assert_array_equal(got.Ks[lvl], want.Ks[lvl])


@pytest.mark.parametrize("method", ["ICP", "FastICP", "Rgbd", "RgbdICP"])
def test_odometry_equals_reference(method):
    t, dep1, img1, dep2, img2 = _frames(method)
    src = odo.OdometryFrame.create(dep1, K, image=img1, levels=3, device="cpu")
    dst = odo.OdometryFrame.create(dep2, K, image=img2, levels=3, device="cpu")
    ok, Rt = odo.Odometry(method=method).compute(src, dst)
    rsrc = ref_odo.OdometryFrame.create(dep1, K, image=img1, levels=3)
    rdst = ref_odo.OdometryFrame.create(dep2, K, image=img2, levels=3)
    _, want = ref_odo.Odometry(method=method).compute(rsrc, rdst)
    assert ok and Rt.dtype == np.float32 and Rt.shape == (4, 4)
    assert np.abs(Rt[:3, 3] - want[:3, 3]).max() < 5e-4
    assert _rot_deg(Rt, want) < 0.05
    # tests/test_odometry.py's bounds against the truth
    assert np.abs(Rt[:3, 3] - (-t)).max() < 0.004
    assert _rot_deg(Rt, np.eye(4)) < 1.0


def test_factories_and_identity():
    for factory, method in ((odo.ICPOdometry, "ICP"), (odo.RgbdOdometry, "Rgbd"),
                            (odo.RgbdICPOdometry, "RgbdICP"),
                            (odo.FastICPOdometry, "FastICP")):
        o = factory(tolerance=1e-5)
        assert o.method == method and o.tolerance == 1e-5
        assert o.iter_counts == (7, 7, 7, 10)
    dep1, _, _ = scenes.snowman_scene()
    src = odo.OdometryFrame.create(torch.as_tensor(dep1.astype(np.int32)), K, levels=3)
    assert src.clouds[0].device.type == "cpu"
    ok, Rt = odo.ICPOdometry().compute(src, src)
    assert ok
    np.testing.assert_allclose(Rt, np.eye(4), atol=2e-3)
    with pytest.raises(ValueError, match="intensity"):
        odo.RgbdOdometry().compute(src, src)
