"""Port parity: the geometry utilities off the detect path against the JAX
package (and the oracle goldens the reference's own tests hold it to).

Tolerances, each measured on these inputs:

- se3, intrinsics, ``depth_to_3d_sparse``: 1e-6, exact where the
  reference is exact (identity, rotation / translation views, matrix,
  scale, pixel grid, the sparse back-projection).
- ``ring_gradient``: exact, strict and inclusive.
- normals: the same NaN and zero masks as the JAX functions and within
  1e-4 deg p99 (LINEMOD and cross ~3e-6, SRI ~5e-6 deg: XLA:CPU's
  arithmetic differs by an ulp in places), plus the goldens' bounds of
  tests/test_geom.py and tests/test_sri_normals.py.
- ``clean_depth``: u16 equal except +-1 mm on at most 0.1% of pixels
  (1-4 pixels here: the 49 exp weights round differently on XLA:CPU);
  f32 within 1e-6 m; the golden bounds of tests/test_cleaner.py.
- ``register_depth`` / ``warp_frame``: the same NaN mask on >= 99.9% of
  pixels and depths within 1e-6 m where both are finite (exact here);
  the invariants of tests/test_registration.py.
- ``extract_planes``: the same plane count, coefficients within 1e-4,
  labels equal on >= 99.9% of pixels.
- ``projective_icp``: pose within 1e-4 m and 0.05 deg, equal inlier
  counts (as tests/test_torch_icp.py holds ``icp_levels``).
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.core import intrinsics as ref_intr
from object_detector_6d_tpu.core import se3 as ref_se3
from object_detector_6d_tpu.geom import normals as ref_normals
from object_detector_6d_tpu.geom.backproject import depth_to_3d as ref_depth_to_3d
from object_detector_6d_tpu.geom.backproject import depth_to_3d_sparse as ref_sparse
from object_detector_6d_tpu.geom.cleaner import clean_depth as ref_clean_depth
from object_detector_6d_tpu.geom.plane import extract_planes as ref_extract_planes
from object_detector_6d_tpu.geom.registration import register_depth as ref_register_depth
from object_detector_6d_tpu.geom.registration import warp_frame as ref_warp_frame
from object_detector_6d_tpu.quant.depth_normal import ring_gradient as ref_ring_gradient
from object_detector_6d_tpu.refine.projective import projective_icp as ref_projective_icp
from object_detector_6d_tpu_torch.core import intrinsics
from object_detector_6d_tpu_torch.core.se3 import SE3, so3_log
from object_detector_6d_tpu_torch.geom import normals
from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d, depth_to_3d_sparse
from object_detector_6d_tpu_torch.geom.cleaner import clean_depth
from object_detector_6d_tpu_torch.geom.plane import extract_planes
from object_detector_6d_tpu_torch.geom.registration import register_depth, warp_frame
from object_detector_6d_tpu_torch.quant.depth_normal import ring_gradient
from object_detector_6d_tpu_torch.refine.projective import projective_icp

sys.path.insert(0, str(pathlib.Path(__file__).parent))
sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402
from test_torch_icp import CX, CY, FX, FY, H, W, _rot_deg, _scene_and_model  # noqa: E402

torch.set_num_threads(2)

K = scenes.K_DEFAULT


def _twists(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(-1.5, 1.5, (n, 3)), rng.uniform(-0.5, 0.5, (n, 3))],
                          -1).astype(np.float32)


def _angles_deg(a, b):
    """Angle [deg] between unit normals [..., 3], float64 (no arccos
    round-off near 1)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), (a * b).sum(-1)))


# ----------------------------------------------------------------------
# core: se3, intrinsics, the sparse back-projection, the ring gradient
# ----------------------------------------------------------------------

def test_se3_additions_equal_reference():
    tw = _twists()
    tw[1, :3] = 1e-9  # the small-angle branch of so3_log
    T_ref = ref_se3.SE3.exp(jnp.asarray(tw))
    T = SE3.exp(torch.as_tensor(tw))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), rtol=0, atol=1e-6)
    T_np = np.array(T_ref)
    Tt = torch.as_tensor(T_np)
    np.testing.assert_array_equal(SE3.rotation(Tt).numpy(), np.asarray(ref_se3.SE3.rotation(T_np)))
    np.testing.assert_array_equal(SE3.translation(Tt).numpy(),
                                  np.asarray(ref_se3.SE3.translation(T_np)))
    np.testing.assert_allclose(so3_log(Tt[:, :3, :3]).numpy(),
                               np.asarray(ref_se3.so3_log(T_np[:, :3, :3])), rtol=0, atol=1e-6)
    np.testing.assert_allclose(SE3.log(Tt).numpy(), np.asarray(ref_se3.SE3.log(T_np)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(SE3.log(Tt).numpy(), tw, rtol=0, atol=2e-5)
    np.testing.assert_allclose(SE3.inverse(Tt).numpy(), np.asarray(ref_se3.SE3.inverse(T_np)),
                               rtol=0, atol=1e-6)
    eye = SE3.compose(Tt, SE3.inverse(Tt)).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape), atol=1e-5)
    for shape in ((), (2, 3)):
        np.testing.assert_array_equal(SE3.identity(batch_shape=shape).numpy(),
                                      np.asarray(ref_se3.SE3.identity(batch_shape=shape)))


def test_intrinsics_additions_equal_reference():
    Kf = K.astype(np.float32)
    ri = ref_intr.Intrinsics.from_matrix(jnp.asarray(Kf))
    pi = intrinsics.Intrinsics.from_matrix(Kf)
    np.testing.assert_array_equal(pi.matrix().numpy(), np.asarray(ri.matrix()))
    for lvl in (0, 1, 3):
        np.testing.assert_array_equal(pi.scale(lvl).matrix().numpy(),
                                      np.asarray(ri.scale(lvl).matrix()))
    pts = np.random.RandomState(0).uniform([-0.3, -0.2, 0.5], [0.3, 0.2, 2.0],
                                           (200, 3)).astype(np.float32)
    np.testing.assert_allclose(pi.project(torch.as_tensor(pts)).numpy(),
                               np.asarray(ri.project(pts)), rtol=1e-6, atol=0)
    u, v = intrinsics.pixel_grid(5, 7)
    ru, rv = ref_intr.pixel_grid(5, 7)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_depth_to_3d_sparse_equals_reference_and_golden(golden):
    g = golden("geom")
    u = np.array([10, 320, 639, 0])
    v = np.array([5, 240, 479, 0])
    z = g["rescaled"][v, u]
    want = np.asarray(ref_sparse(u, v, z, g["K"]))
    got = depth_to_3d_sparse(u, v, z, g["K"], device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), g["p3d"][v, u], rtol=0, atol=1e-5)


@pytest.mark.parametrize("inclusive", [False, True])
def test_ring_gradient_equals_reference(inclusive):
    d = scenes.noisy_depth(64, 80, seed=3).astype(np.int32)
    d[10:14, 20:30] = 0
    want = ref_ring_gradient(jnp.asarray(d), 30, inclusive=inclusive)
    got = ring_gradient(torch.as_tensor(d)[None], 30, inclusive=inclusive)
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(gt[0].numpy(), np.asarray(w))
    strict = ring_gradient(torch.as_tensor(d)[None], 30)
    if inclusive:  # samples at exactly the threshold count only here
        assert not torch.equal(got[2], strict[2])
    else:  # the quantizer's default stays the strict form
        for a, b in zip(got, strict):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# normals
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sphere", "snowman", "rampxy", "holes"])
def test_normals_linemod_equals_reference_and_oracle(golden, case):
    g = golden("lmn_normals")
    want = np.asarray(ref_normals.normals_linemod(g[case + "_in"], g["K"]))
    got = normals.normals_linemod(g[case + "_in"], g["K"], device="cpu").numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal((got == 0).all(-1), (want == 0).all(-1))
    m = np.isfinite(want).all(-1) & ~(want == 0).all(-1)
    assert np.percentile(_angles_deg(got[m], want[m]), 99) <= 1e-4
    # the golden's bounds (tests/test_geom.py)
    ref = g[case + "_n"]
    np.testing.assert_array_equal(np.isnan(got).any(-1), np.isnan(ref).any(-1))
    zeros_ref = (ref == 0).all(-1) & ~np.isnan(ref).any(-1)
    np.testing.assert_array_equal((got == 0).all(-1) & ~np.isnan(got).any(-1), zeros_ref)
    m = np.isfinite(ref).all(-1) & ~zeros_ref
    ang = np.degrees(np.arccos(np.clip(np.abs((got[m] * ref[m]).sum(-1)), 0, 1)))
    assert np.percentile(ang, 99) < 0.2 and ang.mean() < 0.05


@pytest.mark.parametrize("case", ["sphere", "snowman"])
def test_normals_sri_and_cross_equal_reference(golden, case):
    g = golden("sri_normals")
    Kg = g["K"]
    ref_cloud = ref_depth_to_3d(jnp.asarray(g[case + "_in"]), jnp.asarray(Kg))
    cloud = depth_to_3d(torch.as_tensor(g[case + "_in"].astype(np.int32)), Kg)
    np.testing.assert_array_equal(cloud.numpy(), np.asarray(ref_cloud))
    for name, want, got in (
            ("sri", ref_normals.normals_sri(ref_cloud, jnp.asarray(Kg)),
             normals.normals_sri(cloud, Kg)),
            ("cross", ref_normals.normals_cross(ref_cloud), normals.normals_cross(cloud))):
        want, got = np.asarray(want), got.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        m = np.isfinite(want).all(-1)
        assert m.mean() > 0.99, name
        p99 = np.percentile(_angles_deg(got[m], want[m]), 99)
        assert p99 <= 1e-4, (name, p99)
    # the SRI golden's bounds (tests/test_sri_normals.py)
    ours = normals.normals_sri(cloud, Kg).numpy()
    ref = g[case + "_n"]
    both = np.isfinite(ref).all(-1) & np.isfinite(ours).all(-1)
    inner = np.zeros_like(both)
    inner[8:-8, 8:-8] = True
    ang = np.degrees(np.arccos(np.clip(np.abs((ref * ours).sum(-1)), 0, 1)[both & inner]))
    p50, p99 = np.percentile(ang, [50, 99])
    assert p50 <= 0.2 and p99 <= 4.0, (p50, p99)
    assert np.isfinite(ours).all(-1).mean() > 0.999


def test_normals_sri_fals_golden_agreement(golden):
    """tests/test_geom.py's SRI check: agrees with the FALS golden on
    smooth surfaces to a few degrees, camera-facing."""
    g = golden("geom")
    n = normals.normals_sri(g["p3d"], g["K"], device="cpu").numpy()
    expected = g["normals_fals"]
    m = np.isfinite(n).all(-1) & np.isfinite(expected).all(-1)
    m[:6] = m[-6:] = False
    m[:, :6] = m[:, -6:] = False
    ang = np.degrees(np.arccos(np.clip(np.abs((n[m] * expected[m]).sum(-1)), 0, 1)))
    assert np.median(ang) < 2.0
    assert (n[m][:, 2] < 0).mean() > 0.99


# ----------------------------------------------------------------------
# cleaner
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["rand", "snow", "holes"])
def test_clean_depth_equals_reference_and_oracle(golden, case):
    g = golden("cleaner")
    want = np.asarray(ref_clean_depth(g[case + "_in"]))
    got = clean_depth(g[case + "_in"], device="cpu")
    assert got.dtype == torch.uint16
    got = got.numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    # tests/test_cleaner.py's bounds against the oracle
    oracle = g[case + "_q"].astype(int)
    do = np.abs(got.astype(int) - oracle)[3:-3, 3:-3]
    m = oracle[3:-3, 3:-3] > 0
    assert do[m].mean() < 2.0 and do[m].max() <= 5
    if case == "holes":
        assert (got[42:48, 62:78] == 0).all()


def test_clean_depth_float_equals_reference():
    rng = np.random.RandomState(1)
    z = (1.2 + rng.uniform(-0.01, 0.01, (120, 160))).astype(np.float32)
    z[10:20, 30:40] = np.nan
    want = np.asarray(ref_clean_depth(z))
    got = clean_depth(torch.as_tensor(z))
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ok = np.isfinite(z[:-1]) & np.isfinite(z[1:])
    assert np.var(np.diff(got, axis=0)[ok & np.isfinite(np.diff(got, axis=0))]) < np.var(
        np.diff(z, axis=0)[ok])


# ----------------------------------------------------------------------
# registration
# ----------------------------------------------------------------------

def _motions():
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.03, -0.01, -0.02]
    Trt = SE3.exp(torch.tensor([0.05, -0.03, 0.02, 0.05, 0.01, -0.03])).numpy()
    return {"identity": np.eye(4), "translation": T, "rigid": Trt}


@pytest.mark.parametrize("motion", ["identity", "translation", "rigid"])
def test_registration_equals_reference(motion):
    dep, gray, _ = scenes.snowman_scene()
    Rt = _motions()[motion]
    want = np.asarray(ref_register_depth(dep, K, K, Rt, (480, 640)))
    got = register_depth(dep, K, K, Rt, (480, 640), device="cpu").numpy()
    assert (np.isnan(got) == np.isnan(want)).mean() >= 0.999
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-6)
    img = np.repeat(gray[..., None], 3, 2)
    wd, wi = (np.asarray(x) for x in ref_warp_frame(dep, K, Rt, img))
    gd, gi = (x.numpy() for x in warp_frame(dep, K, Rt, img, device="cpu"))
    assert gi.dtype == np.uint8 and gi.shape == img.shape
    assert (np.isnan(gd) == np.isnan(wd)).mean() >= 0.999
    both = np.isfinite(gd) & np.isfinite(wd)
    np.testing.assert_allclose(gd[both], wd[both], rtol=0, atol=1e-6)
    assert (gi == wi).all(-1).mean() >= 0.999
    np.testing.assert_array_equal(warp_frame(dep, K, Rt, device="cpu").numpy(), gd)


def test_registration_invariants():
    """tests/test_registration.py: the identity round trip, and a known
    translation against the splat renderer's ground truth."""
    dep, _, mask = scenes.snowman_scene()
    out = register_depth(dep, K, K, np.eye(4), (480, 640), device="cpu").numpy()
    ref = dep.astype(np.float32) / 1000.0
    m = np.isfinite(out)
    assert m.mean() > 0.99
    np.testing.assert_allclose(out[m], ref[m], atol=1e-3)
    t = np.array([0.03, -0.01, -0.02], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    warped = warp_frame(dep, K, T, device="cpu").numpy()
    ref_dep, ref_mask, _ = scenes.render_translated(dep, mask, K, t)
    both = ref_mask & np.isfinite(warped)
    assert both.sum() / max(ref_mask.sum(), 1) > 0.8
    assert np.median(np.abs(warped[both] - ref_dep[both].astype(np.float32) / 1000.0)) < 2e-3


# ----------------------------------------------------------------------
# planes
# ----------------------------------------------------------------------

def _plane_scene(name):
    if name == "single":
        return np.full((480, 640), 1500, np.uint16), None
    dep, _, mask = scenes.snowman_scene()
    yy, xx = np.mgrid[0:480, 0:640]
    dep = dep.copy()
    strip = xx < 120
    dep[strip] = (1200 + 0.8 * yy).astype(np.uint16)[strip]
    return dep, mask


@pytest.mark.parametrize("name", ["single", "two"])
def test_extract_planes_equals_reference(name):
    dep, mask = _plane_scene(name)
    pts = np.asarray(ref_depth_to_3d(dep, K))
    want = ref_extract_planes(pts)
    got = extract_planes(pts, device="cpu")
    assert len(got.coefficients) == len(want.coefficients) >= (1 if name == "single" else 2)
    np.testing.assert_allclose(got.coefficients, want.coefficients, rtol=0, atol=1e-4)
    assert got.labels.dtype == np.uint8
    assert (got.labels == want.labels).mean() >= 0.999
    # tests/test_plane.py's invariants
    n, d = got.coefficients[0, :3], got.coefficients[0, 3]
    if name == "single":
        assert abs(n[2]) > 0.999 and n[2] < 0 and abs(abs(d) - 1.5) < 0.01
        assert (got.labels == 0).mean() > 0.95
    else:
        xx = np.mgrid[0:480, 0:640][1]
        labels_bg = got.labels[(~mask) & (xx >= 160)]
        main = np.bincount(labels_bg[labels_bg != 255], minlength=1).argmax()
        assert (labels_bg == main).mean() > 0.9
        assert (got.labels[mask & (dep < 1400)] == main).mean() < 0.2


# ----------------------------------------------------------------------
# the single-hypothesis projective ICP
# ----------------------------------------------------------------------

def test_projective_icp_equals_reference():
    scene, model, _ = _scene_and_model()
    pose0 = np.eye(4, dtype=np.float32)
    pose0[:3, 3] = [0.015, -0.004, 0.016]
    scene7 = scene[0, :, :7]
    ref = ref_projective_icp(jnp.asarray(model), jnp.asarray(pose0), jnp.asarray(scene7[:, :6]),
                             jnp.asarray(scene7[:, 6] > 0), np.float32(FX), np.float32(FY),
                             np.float32(CX), np.float32(CY), H, W, iterations=24,
                             num_levels=3)
    r_res, r_pose, r_nin = (np.asarray(a) for a in ref)
    res, pose, nin = projective_icp(torch.as_tensor(model), torch.as_tensor(pose0),
                                    torch.as_tensor(scene7[:, :6]),
                                    torch.as_tensor(scene7[:, 6] > 0), FX, FY, CX, CY, H, W,
                                    iterations=24, num_levels=3)
    assert pose.shape == (4, 4) and res.dim() == 0
    assert float(nin) == float(r_nin) > 20
    np.testing.assert_allclose(pose.numpy()[:3, 3], r_pose[:3, 3], rtol=0, atol=1e-4)
    assert _rot_deg(pose.numpy()[:3, :3], r_pose[:3, :3]) < 0.05
    assert abs(float(res) - float(r_res)) < 2e-5
    # the 7-column packed form gives the same answer
    res7, pose7, _ = projective_icp(torch.as_tensor(model), torch.as_tensor(pose0),
                                    torch.as_tensor(scene7), None, FX, FY, CX, CY, H, W,
                                    iterations=24, num_levels=3)
    assert torch.equal(pose7, pose) and torch.equal(res7, res)
