"""Port parity: nearest-neighbour point-to-plane ICP (refine/icp.py)
against the JAX package on seeded numpy clouds and the golden icp.npz.

Tolerances: poses within 1e-4 m / 0.01 deg, residuals within 1e-5.
Float32 sums run in another order than XLA's, and the port forms its
squared distances about the model's mean point: in camera coordinates
the reference's |m|^2 + |s|^2 - 2 m.s cancels three terms of ~1.5 m^2
to ~1e-5 m^2, and that noise moves its MAD inlier set by a few points.
One step on clouds about the origin, where there is no such noise, holds
1e-6 m / 1e-4 deg. The clouds are clean sphere caps, so the runs are not
sensitive to the noise the way cluttered scenes are.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api import pipeline as ref_pipeline
from object_detector_6d_tpu.core.se3 import SE3 as RefSE3
from object_detector_6d_tpu.refine import icp as ref_icp
from object_detector_6d_tpu_torch.api import pipeline as port_pipeline
from object_detector_6d_tpu_torch.refine import icp as port_icp

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "icp.npz"


def _sphere_cloud(n=1024, r=0.09, center=(0.0, 0.0, 1.2), seed=0):
    """Three offset sphere caps (tests/test_icp.py): asymmetric, so all 6
    degrees of freedom are observable by the point-to-plane metric."""
    rng = np.random.RandomState(seed)

    def cap(m, rad, c):
        phi = rng.uniform(0, 2 * np.pi, m)
        ct = rng.uniform(0.6, 1.0, m)
        st = np.sqrt(1 - ct**2)
        dirs = np.stack([st * np.cos(phi), st * np.sin(phi), -ct], -1)
        return np.concatenate([np.asarray(c) + rad * dirs, dirs], -1)

    n3 = n // 3
    a = cap(n3, r, center)
    b = cap(n3, 0.6 * r, np.asarray(center) + [0.13, 0.05, 0.01])
    c = cap(n - 2 * n3, 0.75 * r, np.asarray(center) + [0.02, -0.11, -0.02])
    cloud = np.concatenate([a, b, c], 0).astype(np.float32)
    return cloud[rng.permutation(n)]


def _twist_pose(twist):
    return np.array(RefSE3.exp(jnp.asarray(np.asarray(twist, np.float32))))


def _rot_deg(Ra, Rb):
    s = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)) / (2 * np.sqrt(2))
    return float(np.degrees(2 * np.arcsin(min(1.0, s))))


def _close_pose(got, want, metres, degrees):
    assert np.abs(np.asarray(got)[:3, 3] - np.asarray(want)[:3, 3]).max() < metres
    assert _rot_deg(np.asarray(got)[:3, :3], np.asarray(want)[:3, :3]) < degrees
    np.testing.assert_array_equal(np.asarray(got)[3], [0, 0, 0, 1])


# ----------------------------------------------------------------------
# the robust statistics
# ----------------------------------------------------------------------

def _nan_rows():
    rng = np.random.RandomState(0)
    rows = {
        "odd": rng.rand(7),
        "even": rng.rand(8),
        "even_masked_to_odd": np.where(np.arange(8) == 3, np.nan, rng.rand(8)),
        "odd_masked_to_even": np.where(np.arange(9) % 4 == 1, np.nan, rng.rand(9)),
        "two": np.array([0.25, 0.75]),
        "one": np.array([np.nan, 0.5, np.nan]),
        "all_masked": np.full(6, np.nan),
        "ties": np.array([1.0, 1.0, 2.0, 2.0, np.nan, 3.0]),
    }
    return {k: v.astype(np.float32) for k, v in rows.items()}


@pytest.mark.parametrize("case", sorted(_nan_rows()))
def test_nanmedian_equals_reference(case):
    a = _nan_rows()[case]
    want = np.asarray(jnp.nanmedian(jnp.asarray(a)))
    got = port_icp._nanmedian(torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN == NaN here
    if case == "even":  # the mean of the middle pair, not the lower one
        s = np.sort(a)
        assert got == np.float32(0.5) * s[3] + np.float32(0.5) * s[4]
        assert got != torch.nanmedian(torch.as_tensor(a)).numpy()


def test_nanquantile_rows_equal_reference():
    rng = np.random.RandomState(1)
    a = rng.rand(12, 40).astype(np.float32)
    a[rng.rand(12, 40) < 0.3] = np.nan
    a[4] = np.nan  # a row without a finite value gives NaN
    a[5, 1:] = np.nan  # one finite value
    qs = np.array([0.25, 0.5, 0.75], np.float32)
    want = np.stack([np.asarray(jnp.nanquantile(jnp.asarray(r), jnp.asarray(qs))) for r in a])
    got = port_icp.nanquantile(torch.as_tensor(a), torch.as_tensor(qs)).numpy()
    assert np.isnan(got[4]).all() and np.isnan(want[4]).all()
    np.testing.assert_array_equal(got[5], a[5, 0])
    # the interpolation's last bit depends on whether the compiler fuses it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


# ----------------------------------------------------------------------
# association, one step, whole runs
# ----------------------------------------------------------------------

def _ref_scene(scene):
    sp, sn = jnp.asarray(scene[:, :3]), jnp.asarray(scene[:, 3:6])
    valid = jnp.isfinite(sp).all(-1) & jnp.isfinite(sn).all(-1)
    return jnp.nan_to_num(sp), jnp.nan_to_num(sn), valid


def _holed(scene, seed):
    """The scene with some rows invalid (NaN), as an organized cloud has."""
    scene = scene.copy()
    rng = np.random.RandomState(seed)
    scene[rng.rand(len(scene)) < 0.1, 2] = np.nan
    scene[rng.rand(len(scene)) < 0.05, 4] = np.nan
    return scene


def test_nearest_scene_equals_reference(monkeypatch):
    scene = _holed(_sphere_cloud(3000, seed=11), 0)
    model = _sphere_cloud(700, seed=12)[:, :3] + np.float32(0.003)
    sp, _sn, valid = _ref_scene(scene)
    want_idx, want_d2 = ref_icp._nearest_scene(jnp.asarray(model), sp, valid)
    tsp, _tsn, tvalid = port_icp.split_scene(torch.as_tensor(scene))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    # several row blocks, the last one ragged
    monkeypatch.setattr(port_icp, "_NN_BLOCK_CPU", 3000 * 128)
    idx, d2 = port_icp._nearest_scene(torch.as_tensor(model), tsp, tvalid)
    # exact distances decide: where the two picks differ, they are equally
    # near to within the reference's float32 cancellation noise
    exact = ((model[:, None, :].astype(np.float64)
              - np.nan_to_num(scene[None, :, :3]).astype(np.float64)) ** 2).sum(-1)
    exact[:, ~np.asarray(valid)] = np.inf
    rows = np.arange(len(model))
    np.testing.assert_array_equal(idx.numpy(), exact.argmin(-1))
    assert np.abs(exact[rows, np.asarray(want_idx)] - exact.min(-1)).max() < 1e-6
    np.testing.assert_allclose(d2.numpy(), exact.min(-1), rtol=1e-4, atol=2e-8)
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), atol=1e-6)


@pytest.mark.parametrize("cap", [None, 0.03])
@pytest.mark.parametrize("z, metres, degrees", [(0.0, 1e-6, 1e-4), (1.2, 1e-4, 0.01)])
def test_p2pl_step_equals_reference(cap, z, metres, degrees):
    """About the origin the reference's squared distances carry no
    cancellation noise and one step agrees to float32 round-off; 1.2 m
    from it the noise moves the reference's MAD inlier set by a few
    points."""
    scene = _holed(_sphere_cloud(4096, center=(0.0, 0.0, z), seed=1), 1)
    model = _sphere_cloud(600, center=(0.0, 0.0, z), seed=2)
    mask = np.ones(len(model), bool)
    mask[-40:] = False  # NaN-padded model rows arrive zeroed and masked
    model[-40:] = 0.0
    pose0 = _twist_pose([0.004, -0.003, 0.006, 0.01, -0.008, 0.006])
    rp, ru, rr = ref_icp._p2pl_step(
        jnp.asarray(pose0), jnp.asarray(model), *_ref_scene(scene), jnp.asarray(mask),
        jnp.float32(2.5), max_corr_dist=None if cap is None else jnp.float32(cap))
    tp, tu, tr = port_icp._p2pl_step(
        torch.as_tensor(pose0), torch.as_tensor(model),
        *port_icp.split_scene(torch.as_tensor(scene)), torch.as_tensor(mask), 2.5,
        max_corr_dist=cap)
    _close_pose(tp.numpy(), np.asarray(rp), metres, degrees)
    assert float(tu) == pytest.approx(float(ru), abs=metres)
    assert float(tr) == pytest.approx(float(rr), abs=1e-5)
    assert float(ru) > 1e-3, "the step moved nothing: no comparison"


def test_p2pl_step_all_masked():
    """No unmasked sample: both medians are NaN -> 0, no inlier, the damped
    solve returns a zero update and the pose stays."""
    scene = _sphere_cloud(512, seed=3)
    model = np.zeros((64, 6), np.float32)
    mask = np.zeros(64, bool)
    pose0 = _twist_pose([0.01, 0, 0, 0, 0.02, 0])
    rp, ru, rr = ref_icp._p2pl_step(
        jnp.asarray(pose0), jnp.asarray(model), *_ref_scene(scene), jnp.asarray(mask),
        jnp.float32(2.5))
    tp, tu, tr = port_icp._p2pl_step(
        torch.as_tensor(pose0), torch.as_tensor(model),
        *port_icp.split_scene(torch.as_tensor(scene)), torch.as_tensor(mask), 2.5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), atol=1e-7)
    assert float(tu) == float(ru) == 0.0
    assert float(tr) == float(rr) == 0.0


def test_solve6_damping():
    rng = np.random.RandomState(5)
    J = rng.randn(50, 6).astype(np.float32)
    J[:, 3] = 0.0  # a degenerate direction: only the damping keeps it solvable
    A = J.T @ J
    b = rng.randn(6).astype(np.float32)
    want = np.asarray(ref_icp._solve6(jnp.asarray(A), jnp.asarray(b)))
    got = port_icp._solve6(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


TWISTS = np.array([
    [0.0, 0.0, 0.03, 0.005, 0.002, -0.003],
    [0.02, -0.01, 0.0, -0.004, 0.006, 0.002],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
], np.float32)


def test_icp_run_equals_reference():
    scene = _holed(_sphere_cloud(4096, seed=3), 2)
    model = _sphere_cloud(512, seed=4)
    poses0 = np.stack([_twist_pose(t) for t in TWISTS])
    rres, rposes = ref_icp._icp_run(
        jnp.asarray(model), jnp.asarray(scene), jnp.asarray(poses0), 60,
        jnp.float32(0.005), jnp.float32(2.5), 3)
    tres, tposes = port_icp._icp_run(
        torch.as_tensor(model), torch.as_tensor(scene), torch.as_tensor(poses0), 60,
        float(np.float32(0.005)), 2.5, 3)
    assert tposes.shape == (3, 4, 4) and tres.shape == (3,)
    for b in range(3):
        _close_pose(tposes[b].numpy(), np.asarray(rposes[b]), 1e-4, 0.01)
    np.testing.assert_allclose(tres.numpy(), np.asarray(rres), atol=1e-5)
    assert (np.asarray(rres) < 2e-3).all()  # every lane landed on the scene


def test_register_model_to_scene_equals_reference():
    scene = _sphere_cloud(4096, seed=6)
    model = _sphere_cloud(512, seed=7)
    poses0 = np.stack([_twist_pose(t) for t in TWISTS[:2]])
    ref = ref_icp.ICP(iterations=40, num_levels=2)
    port = port_icp.ICP(iterations=40, num_levels=2, device="cpu")
    rres, rposes = ref.register_model_to_scene(model, scene, poses0)
    tres, tposes = port.register_model_to_scene(model, scene, poses0)
    assert isinstance(tres, np.ndarray) and tposes.shape == (2, 4, 4)
    for b in range(2):
        _close_pose(tposes[b], rposes[b], 1e-4, 0.01)
    np.testing.assert_allclose(tres, rres, atol=1e-5)
    # one [4, 4] pose comes back unbatched; no pose means the identity
    r1, p1 = port.register_model_to_scene(model, scene, poses0[0])
    assert isinstance(r1, float) and p1.shape == (4, 4)
    np.testing.assert_array_equal(p1, tposes[0])
    r_id, p_id = port.register_model_to_scene(model, scene)
    w_id, wp_id = ref.register_model_to_scene(model, scene)
    assert p_id.shape == (1, 4, 4)
    _close_pose(p_id[0], wp_id[0], 1e-4, 0.01)
    np.testing.assert_allclose(r_id, w_id, atol=1e-5)


def test_from_params_and_device():
    from object_detector_6d_tpu_torch.core.config import ICPParams

    icp = port_icp.ICP.from_params(ICPParams(iterations=32, num_levels=4), "cpu")
    assert (icp.iterations, icp.num_levels, icp.device) == (32, 4, "cpu")
    assert port_icp.ICP().device == "cuda"  # the card unless asked otherwise


def test_golden_icp():
    """The golden pair of tests/golden/icp.npz (the oracle's scene, moved
    model and injected motion T): the port recovers T^-1 as the reference
    does and agrees with it."""
    g = np.load(GOLDEN)
    eye = np.eye(4, dtype=np.float32)
    rres, rpose = ref_icp.ICP(iterations=100, num_levels=4).register_model_to_scene(
        g["model_moved"], g["scene"], eye)
    tres, tpose = port_icp.ICP(iterations=100, num_levels=4, device="cpu") \
        .register_model_to_scene(g["model_moved"], g["scene"], eye)
    _close_pose(tpose, rpose, 1e-4, 0.01)
    assert tres == pytest.approx(rres, abs=1e-5)
    assert np.abs(tpose @ g["T"] - np.eye(4)).max() < 2e-3
    assert tres < 1e-3


# ----------------------------------------------------------------------
# the detect path's per-hypothesis models
# ----------------------------------------------------------------------

def test_icp_run_multi_equals_reference():
    """Each hypothesis has its own NaN-padded model; correspondences are
    capped at 0.015 * 2^level m."""
    scene = _holed(_sphere_cloud(4096, seed=9), 3)
    models = np.stack([_sphere_cloud(256, seed=10), _sphere_cloud(256, seed=13),
                       _sphere_cloud(256, seed=14)])
    models[1, 200:] = np.nan
    models[2, 97:] = np.nan
    poses0 = np.stack([_twist_pose(0.3 * t) for t in TWISTS])
    rres, rposes = ref_pipeline._icp_run_multi(
        jnp.asarray(models), jnp.asarray(scene), jnp.asarray(poses0), 32,
        jnp.float32(0.005), jnp.float32(2.5), 4)
    tres, tposes = port_pipeline._icp_run_multi(
        torch.as_tensor(models), torch.as_tensor(scene), torch.as_tensor(poses0), 32,
        float(np.float32(0.005)), 2.5, 4)
    for b in range(3):
        _close_pose(tposes[b].numpy(), np.asarray(rposes[b]), 1e-4, 0.01)
    np.testing.assert_allclose(tres.numpy(), np.asarray(rres), atol=1e-5)
    assert (np.asarray(rres) < 2e-3).all()
