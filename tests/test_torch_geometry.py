"""Port parity: the fused geometry (kernel K5's plain twin) against the
reference's Pallas kernel in interpret mode, and the FALS normals and
back-projection the training side uses against the reference's XLA
formulation.

What holds against the reference's interpret run:

- bit-exact: the cloud planes, the validity plane, the zero pad and the
  NaN structure of every plane (the cloud multiplies by the float32
  reciprocals of fx, fy, as XLA runs the reference's division by a
  constant);
- the test_geom bound, not bit-exact: the FALS normals, p99 <= 1.1 deg
  (about 0.07 deg on these frames). The interpret run on XLA:CPU does
  not match a numpy float32 evaluation of the same steps either (the
  reference's own tests/test_geometry_pallas.py notes a 1-ulp difference
  in r between XLA:CPU and numpy), and the near-singular M^-1 amplifies
  any such rounding. The port's kernel and twin round every step as one
  IEEE float32 operation, so they agree bitwise with each other
  (tests/test_torch_cuda_kernels.py and chip_smoke.py, on the card).
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.geom.backproject import depth_to_3d as ref_depth_to_3d
from object_detector_6d_tpu.geom.normals import FalsNormals as RefFals
from object_detector_6d_tpu.ops.geometry_pallas import FusedScene as RefFusedScene
from object_detector_6d_tpu.refine.projective import pack_scene7 as ref_pack_scene7
from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d
from object_detector_6d_tpu_torch.geom.normals import normals_fals
from object_detector_6d_tpu_torch.ops.geometry import FusedScene, planes_to_scene8
from object_detector_6d_tpu_torch.refine.projective import pack_scene7

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

H, W = 96, 128
K_SMALL = np.array([[143.1028, 0.0, 64.3153], [0.0, 143.3926, 48.5122],
                    [0.0, 0.0, 1.0]])


def _depths():
    dep, _, mask = scenes.snowman_scene(width=W, height=H, cx=64, cy=48, scale=0.3,
                                        checker_px=4)
    dep = dep.copy()
    dep[20:28, 30:44] = 0  # a depth hole
    dep2, _, _ = scenes.render_translated(dep, mask, K_SMALL, np.array([0.02, 0.0, 0.01]))
    dep2[:, :3] = 0
    return np.stack([dep, dep2])


def _p99_deg(a, b):
    """99th percentile of the angle [deg] between unit normals [..., 3]."""
    dots = np.clip(np.abs((a * b).sum(-1)), 0, 1)
    return float(np.quantile(np.degrees(np.arccos(dots)), 0.99))


def test_fused_scene_twin_vs_pallas_kernel():
    deps = _depths()
    want = np.asarray(RefFusedScene(H, W, K_SMALL)(jnp.asarray(deps), interpret=True))
    got = FusedScene(H, W, K_SMALL, device="cpu")(torch.as_tensor(deps.astype(np.int32))).numpy()
    assert got.shape == want.shape == (2, 8, H, W)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    valid = want[:, 6] > 0
    assert valid.mean() > 0.5
    for c in (0, 1, 2, 6, 7):
        np.testing.assert_array_equal(got[:, c][valid], want[:, c][valid], err_msg=f"plane {c}")
    n_got = got[:, 3:6].transpose(0, 2, 3, 1)[valid]
    n_want = want[:, 3:6].transpose(0, 2, 3, 1)[valid]
    assert _p99_deg(n_got, n_want) <= 1.1
    scene = planes_to_scene8(torch.as_tensor(got)).numpy()
    np.testing.assert_array_equal(scene, np.nan_to_num(got.reshape(2, 8, -1)).transpose(0, 2, 1))


def test_pack_scene7_equals_reference():
    """The organized cloud + normals -> [H*W, 7] rows with validity."""
    planes = FusedScene(H, W, K_SMALL, device="cpu")(torch.as_tensor(_depths().astype(np.int32)))
    img = planes[:, :6].permute(0, 2, 3, 1).contiguous()  # [B, H, W, 6]
    got = pack_scene7(img).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(ref_pack_scene7(jnp.asarray(img[b].numpy()))))


@pytest.mark.parametrize("hw", [(96, 128), (47, 61)])
def test_training_geometry_equals_reference(hw):
    """depth_to_3d and normals_fals (used by add_view) vs the reference's
    XLA formulation, on a frame size the Pallas kernel cannot take."""
    h, w = hw
    dep = _depths()[0][:h, :w]
    K = K_SMALL.copy()
    K[0, 2], K[1, 2] = w / 2 + 0.3, h / 2 + 0.5
    ref_cloud = ref_depth_to_3d(jnp.asarray(dep), jnp.asarray(K))
    ref_n = np.asarray(RefFals(h, w, K)(ref_cloud))
    cloud = depth_to_3d(torch.as_tensor(dep.astype(np.int32)), K)
    np.testing.assert_array_equal(cloud.numpy(), np.asarray(ref_cloud))
    n = normals_fals(cloud, K).numpy()
    np.testing.assert_array_equal(np.isnan(n), np.isnan(ref_n))
    ok = np.isfinite(ref_n).all(-1)
    # the reference's per-pixel M^-1 b is an XLA einsum (its own summation
    # order): the test_geom bound, not bitwise
    assert _p99_deg(n[ok], ref_n[ok]) <= 1.1
