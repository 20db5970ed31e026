"""Port parity: projective ICP (lane-batched) and the hypothesis lift
against the JAX package, on one small organized scene.

Tolerances: poses within 1e-4 m and 0.05 deg with equal inlier counts
(float32 sums run in another order than XLA's); histogram quantiles
within one bin; seed masks equal and seed poses equal to float32
round-off.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api import detect_program as ref_dp
from object_detector_6d_tpu.core.config import ColorGradientParams as RefCGParams
from object_detector_6d_tpu.core.config import DepthNormalParams as RefDNParams
from object_detector_6d_tpu.match.program import PackedBank as RefPackedBank
from object_detector_6d_tpu.refine.projective import icp_levels as ref_icp_levels
from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu_torch.match.program import PackedBank
from object_detector_6d_tpu_torch.ops.geometry import FusedScene, planes_to_scene8
from object_detector_6d_tpu_torch.refine.projective import icp_levels

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

H, W = 96, 128
K_SMALL = np.array([[143.1028, 0.0, 64.3153], [0.0, 143.3926, 48.5122],
                    [0.0, 0.0, 1.0]])
FX, FY, CX, CY = (float(np.float32(v)) for v in
                  (K_SMALL[0, 0], K_SMALL[1, 1], K_SMALL[0, 2], K_SMALL[1, 2]))
T_TRUE = np.array([0.012, -0.008, 0.02])


def _scene_and_model(n_model=160):
    """Organized scene of the translated object + the training view's
    model cloud (xyz + normal) sampled from the untranslated view."""
    dep, _, mask = scenes.snowman_scene(width=W, height=H, cx=64, cy=48, scale=0.3,
                                        checker_px=4)
    dep2, _, _ = scenes.render_translated(dep, mask, K_SMALL, T_TRUE)
    fs = FusedScene(H, W, K_SMALL, device="cpu")
    planes = fs(torch.as_tensor(np.stack([dep, dep2]).astype(np.int32)))
    scene = planes_to_scene8(planes[1:]).numpy()  # [1, H*W, 8]
    view = planes[0].numpy()  # [8, H, W]
    ok = mask & (view[6] > 0)
    ys, xs = np.nonzero(ok)
    sel = np.linspace(0, len(ys) - 1, n_model).astype(int)
    model = view[:6, ys[sel], xs[sel]].T.astype(np.float32)  # [n, 6]
    return scene, model, planes[1, 2].numpy()


def _lanes(model, L=6, seed=0):
    rng = np.random.RandomState(seed)
    models = np.repeat(model[None], L, 0)
    models[1, -20:] = np.nan  # NaN padding rows
    poses = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    c = model[:, :3].mean(0)
    for i in range(L):
        a = rng.normal(size=3) * np.deg2rad(1.5)
        th = np.linalg.norm(a)
        k = a / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        # rotate about the model centroid, then offset from the truth
        poses[i, :3, :3] = R
        poses[i, :3, 3] = c - R @ c + T_TRUE + rng.uniform(-0.006, 0.006, 3)
    poses[-1, :3, 3] += 0.2  # a lane that finds no correspondences
    return models, poses


def _rot_deg(Ra, Rb):
    s = np.linalg.norm(Ra - Rb, axis=(-2, -1)) / (2 * np.sqrt(2))
    return np.degrees(2 * np.arcsin(np.minimum(1.0, s)))


@pytest.mark.parametrize("levels,iters,solves", [((2, 1, 0), [4, 4, 2], 2),
                                                 ((1,), 6, 1)])
def test_icp_levels_equals_reference(levels, iters, solves):
    scene, model, _ = _scene_and_model()
    models, poses = _lanes(model)
    ref = jax.vmap(lambda m, p: ref_icp_levels(
        m, p, jnp.asarray(scene[0]), np.float32(FX), np.float32(FY), np.float32(CX),
        np.float32(CY), H, W, levels=levels, iters_per_level=iters,
        tolerance=3e-4, solves=solves))(jnp.asarray(models), jnp.asarray(poses))
    r_res, r_pose, r_nin = (np.asarray(a) for a in ref)
    res, pose, nin = icp_levels(
        torch.as_tensor(models), torch.as_tensor(poses), torch.as_tensor(scene),
        torch.zeros(len(models), dtype=torch.int64), FX, FY, CX, CY, H, W,
        levels=levels, iters_per_level=iters, tolerance=3e-4, solves=solves)
    pose = pose.numpy()
    assert (r_nin[:-1] > 20).all() and r_nin[-1] == 0
    np.testing.assert_array_equal(nin.numpy(), r_nin)
    np.testing.assert_allclose(pose[:, :3, 3], r_pose[:, :3, 3], rtol=0, atol=1e-4)
    assert _rot_deg(pose[:, :3, :3], r_pose[:, :3, :3]).max() < 0.05
    np.testing.assert_allclose(res.numpy()[:-1], r_res[:-1], rtol=0, atol=2e-5)
    # every live lane moved off its seed
    assert (np.abs(pose[:-1, :3, 3] - poses[:-1, :3, 3]).max(-1) > 1e-4).all()


def test_hist_quantiles_within_one_bin():
    rng = np.random.RandomState(5)
    w = rng.uniform(0.8, 1.6, (5, 20, 24)).astype(np.float32)
    w[0] = np.nan  # all-NaN window
    w[1, :, :12] = np.nan
    w[2, :3] = 3.5  # background beyond the 1 m span cap
    q = np.array([0.25, 0.5, 0.75], np.float32)
    want = np.asarray(jax.vmap(lambda a: ref_dp._hist_quantiles(a, jnp.asarray(q)))(
        jnp.asarray(w)))
    got = dp._hist_quantiles(torch.as_tensor(w), torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(w).reshape(5, -1)
    zmin = np.array([w[i].reshape(-1)[fin[i]].min() if fin[i].any() else 0 for i in range(5)])
    zmax = np.array([w[i].reshape(-1)[fin[i]].max() if fin[i].any() else 0 for i in range(5)])
    bin_w = np.minimum(zmax - zmin, 1.0) / dp.LIFT_HIST_BINS
    ok = np.isfinite(want)
    assert (np.abs(got - want)[ok] <= np.broadcast_to(bin_w[:, None], want.shape)[ok]).all()


def _closure_fn(fn, name):
    """A function ``name`` captured by ``fn`` (jit-wrapped or not)."""
    fn = getattr(fn, "__wrapped__", fn)
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__ or ()))
    return cells[name].cell_contents


@pytest.mark.parametrize("lift_impl", ["hist", "sort"])
def test_lift_seeds_equal_reference(lift_impl):
    """seed_ok and the translation seeds pose0 of the hypothesis lift, with
    the histogram quantiles and with the exact (sorting) ones."""
    _, model, z_img = _scene_and_model()
    S, K_cap = 3, 8
    ref_run = ref_dp.make_detect_program(
        ("DepthNormal",), (5, 8), (H, W), RefDNParams(), RefCGParams(),
        K_SMALL, max_candidates=K_cap, num_seeds=S, lift_window=48, lift_impl=lift_impl)
    ref_lift = _closure_fn(_closure_fn(ref_run, "lift_and_refine"), "lift")
    port_run = dp.make_detect_program(("DepthNormal",), (5, 8), (H, W),
                                      DepthNormalParams(), ColorGradientParams(), K_SMALL,
                                      max_candidates=K_cap, num_seeds=S, lift_window=48,
                                      lift_impl=lift_impl, device="cpu")
    port_lift = _closure_fn(port_run, "lift_and_refine")
    port_lift = _closure_fn(port_lift, "lift")

    class Rec:
        def __init__(self, bbox, anchor):
            self.model_cloud, self.bbox, self.anchor_point = model, bbox, anchor
            self.view_pose = None

    views = {("a", 0): Rec((30, 20, 40, 36), np.array([0.01, -0.02, 0.9], np.float32)),
             ("a", 1): Rec((20, 10, 64, 60), np.array([0.0, 0.0, 1.1], np.float32))}
    bank_kw = dict(class_ids=["a", "a", "b"], local_tids=np.array([0, 1, 0], np.int32))
    ref_bank = RefPackedBank(kernels_low=[], kernels_dec=[], feat_plane=[], feat_dr=[],
                             feat_dc=[], feat_n=[], max_dr=0, nfeat=[], sizes=[], **bank_kw)
    bank = PackedBank(coarse=(), feat_plane=[], feat_dr=[], feat_dc=[], feat_n=[],
                      nfeat=[], sizes=[], **bank_kw)
    rng = np.random.RandomState(2)
    packed = np.zeros((5, K_cap + 1), np.float32)
    packed[0, :-1] = rng.randint(0, W - 40, K_cap)
    packed[1, :-1] = rng.randint(0, H - 36, K_cap)
    packed[3, :-1] = rng.randint(0, 3, K_cap)
    packed[4, :-1] = rng.uniform(size=K_cap) > 0.2
    r_views = ref_dp.pack_views(ref_bank, views, 160)
    p_views = dp.pack_views(bank, views, 160, device="cpu")
    _, r_keep, r_seed_ok, r_pose0, *_ = ref_lift(
        jnp.asarray(z_img), None, jnp.asarray(packed), r_views)
    _, keep, seed_ok, pose0, *_ = port_lift(
        torch.as_tensor(z_img)[None], torch.as_tensor(packed)[None], p_views)
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(r_keep))
    np.testing.assert_array_equal(seed_ok[0].numpy(), np.asarray(r_seed_ok))
    assert np.asarray(r_seed_ok).any()
    np.testing.assert_allclose(pose0[0].numpy(), np.asarray(r_pose0), rtol=1e-6, atol=1e-7)
