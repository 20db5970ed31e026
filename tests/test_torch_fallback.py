"""The overflow fallback: where a frame has more coarse candidates than
``max_hypotheses`` slots, ``detect_fused_batch`` must answer through the
host-orchestrated ``detect`` exactly where the JAX package does.

tools/parity_add.py's ``two`` and ``views`` scene sets (imported as they
are) overflow its 8 slots on every frame. On 2 frames of each, the port's
``detect`` and ``detect_fused_batch`` (device="cpu") against the JAX
package's on the same trained state: the same ``overflow_fallback``
count, pose lists of equal length, each pose of the same class, template
and match, within 1 mm / 0.5 deg.

The tolerance and the choice of frames. The nearest-neighbour ICP is
sensitive on these cluttered scenes: the reference's squared distances
carry float32 cancellation noise of the order of the distances
themselves, its MAD inlier set and tolerance-gated loops amplify it, and
a one-ulp change of a start pose moves the reference's own result by up
to ~0.5 mm on a well-fitted hypothesis. The port forms the distances
about the model's mean point (no such noise), so its answer is the
reference's to within that sensitivity. ``two`` uses frames 1 and 2:
frame 0's objB, a scaled copy of objA whose three seeds fit almost
equally well, differs by 1.26 mm / 0.51 deg.
"""

import functools
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api import pipeline as ref_pipeline
from object_detector_6d_tpu_torch.api import pipeline as port_pipeline
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)

from test_torch_detect import _bgr, _rot_deg, _state

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import parity_add  # noqa: E402

torch.set_num_threads(1)

FRAMES = {"two": (1, 2), "views": (0, 1)}


@functools.lru_cache(maxsize=2)
def _reference(config):
    """The reference detector of parity_add.run_ours(config), trained as
    there; the set's test frames (K, depths, BGRs); and what its
    ``detect_fused_batch`` returns for them, every frame through the
    fallback (so each list is ``detect``'s)."""
    ref = parity_add._our_detector()
    if config == "two":
        K, train, scene_list = parity_add.scene_set_two()
        for cid in ("objA", "objB"):
            dep, gray, mask = train[cid]
            assert ref.add_view(cid, dep, K, mask.astype(np.uint8) * 255,
                                rgb=_bgr(gray)) == 0
    else:
        K, _dep, _gray, _mask, train, scene_list = parity_add.scene_set_views()
        for k, (P, d2, g2, m2) in enumerate(train):
            assert ref.add_view("obj", d2, K, m2.astype(np.uint8) * 255,
                                rgb=_bgr(g2), view_pose=P) == k
    frames = [scene_list[i] for i in FRAMES[config]]
    depths = np.stack([f[1] for f in frames])
    rgbs = np.stack([_bgr(f[2]) for f in frames])
    assert ref.params.max_hypotheses == 8
    want = ref.detect_fused_batch(depths, K, rgbs)
    assert ref.counters.counts.get("overflow_fallback", 0) == len(frames), \
        "the scene set no longer overflows 8 slots"
    assert sum(len(w) for w in want) >= len(frames), \
        "the reference found too little to compare"
    return ref, K, depths, rgbs, want


def _port_of(ref):
    templates, views = _state(ref)
    return pose_detector_from_state(
        detector_dict(ref.detector), templates, views, params_dict(ref.params),
        model_points=ref.model_points, device="cpu")


def _same_poses(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.class_id, g.template_id, g.match_x, g.match_y, g.num_votes) == \
            (w.class_id, w.template_id, w.match_x, w.match_y, w.num_votes)
        assert g.match_similarity == pytest.approx(w.match_similarity, abs=1e-4)
        assert np.abs(g.pose[:3, 3] - w.pose[:3, 3]).max() < 1e-3
        assert _rot_deg(g.pose[:3, :3], w.pose[:3, :3]) < 0.5
        assert g.residual == pytest.approx(w.residual, abs=1e-4)


@pytest.mark.parametrize("config", ["two", "views"])
def test_detect_equals_reference(config):
    """``detect`` called directly, on the set's first test frame (the
    batch test below takes both through the fallback)."""
    ref, K, depths, rgbs, want = _reference(config)
    port = _port_of(ref)
    _same_poses(port.detect(depths[0], K, rgb=rgbs[0]), want[0])
    assert port.counters.counts["frames"] == 1
    assert "overflow_fallback" not in port.counters.counts


@pytest.mark.parametrize("config", ["two", "views"])
def test_detect_fused_batch_falls_back_as_reference(config):
    ref, K, depths, rgbs, want = _reference(config)
    port = _port_of(ref)
    got = port.detect_fused_batch(depths, K, rgbs)
    assert port.counters.counts.get("overflow_fallback", 0) == \
        ref.counters.counts["overflow_fallback"] == len(depths)
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        _same_poses(gp, wp)
    assert port.counters.counts["frames"] == len(depths)


def test_fallback_takes_tensors():
    """Frames handed over as tensors reach the fallback too."""
    ref, K, depths, rgbs, want = _reference("views")
    port = _port_of(ref)
    one = port.detect_fused_batch(torch.as_tensor(depths[:1].astype(np.int32)), K,
                                  torch.as_tensor(rgbs[:1]))
    assert port.counters.counts["overflow_fallback"] == 1
    _same_poses(one[0], want[0])


# ----------------------------------------------------------------------
# the lift's pieces
# ----------------------------------------------------------------------

def test_window_quantiles_equal_reference():
    """Windows clipped at every border, a bbox restriction narrower than
    the window, NaN cells, and a window without a finite cell (NaN: the
    seed is dropped)."""
    H, W, win = 60, 80, 16
    rng = np.random.RandomState(0)
    z = (1.0 + 0.2 * rng.rand(H, W)).astype(np.float32)
    z[rng.rand(H, W) < 0.2] = np.nan
    z[20:44, 30:54] = np.nan
    centers = np.array([[2, 3], [78, 58], [40, 30], [41, 31], [10, 50], [70, 5]], np.int32)
    whs = np.array([[30, 30], [9, 7], [4, 4], [40, 40], [3, 20], [20, 2]], np.int32)
    want = np.asarray(ref_pipeline._window_quantiles_fn(win, (H, W))(
        jnp.asarray(z), jnp.asarray(centers), jnp.asarray(whs)))
    got = port_pipeline._window_quantiles(
        torch.as_tensor(z), torch.as_tensor(centers.astype(np.int64)),
        torch.as_tensor(whs.astype(np.int64)), win).numpy()
    assert np.isnan(want[2]).all() and np.isfinite(want[[0, 1, 4, 5]]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_geometry_single_equals_reference():
    K, _train, scene_list = parity_add.scene_set_two()
    depth = scene_list[0][1][::4, ::4]
    Ks = np.asarray(K, np.float64).copy()
    Ks[:2] /= 4.0
    kb = np.ascontiguousarray(Ks).tobytes()
    want = np.asarray(ref_pipeline._geometry_single(kb, depth.shape)(jnp.asarray(depth)))
    got = port_pipeline._geometry_single(
        torch.as_tensor(depth.astype(np.int32)), Ks).numpy()
    assert got.shape == want.shape == depth.shape + (6,)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[..., :3][ok[..., :3]], want[..., :3][ok[..., :3]],
                               rtol=0, atol=1e-6)
    # unit normals: within the FALS estimator's float noise of the
    # reference's (the bound test_torch_detect.py holds the model clouds to)
    valid = ok[..., 3:].all(-1)
    dots = np.abs((got[..., 3:] * want[..., 3:]).sum(-1)[valid])
    assert valid.sum() > 1000
    assert np.quantile(np.degrees(np.arccos(np.clip(dots, 0, 1))), 0.99) < 1.1
