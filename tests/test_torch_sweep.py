"""The host matcher's sweeps (match/sweep.py) against the JAX package's,
exactly, as int32.

Response maps of tools/scenes.py frames (the snowman's depth normals at
level 0 with T=5, at level 1 with T=8); templates from a numpy seed, one
of them as large as the frame so that its features run past the planes'
edge at most anchors, one holding a repeated feature. The port's coarse
sum is K6's twin over the T-decimated planes and its local sum K4's twin;
the reference's are bf16 convolutions with dense one-hot kernels.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.match import sweep as ref_sweep
from object_detector_6d_tpu.match.response import response_maps, spread
from object_detector_6d_tpu.quant import features as ref_features
from object_detector_6d_tpu.quant.pyramid import DepthNormalPyramid
from object_detector_6d_tpu_torch.match import sweep
from object_detector_6d_tpu_torch.quant import features

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)

LEVELS = {0: 5, 1: 8}  # pyramid level -> T


def _responses(level):
    """[8, H, W] u8 response maps of a translated snowman frame."""
    dep, _gray, mask = scenes.snowman_scene()
    d2, _, _ = scenes.render_translated(dep, mask, scenes.K_DEFAULT,
                                        np.array([0.02, -0.01, 0.03]))
    q = DepthNormalPyramid(d2, levels=2).quantize(level)
    return np.array(response_maps(spread(jnp.asarray(q), LEVELS[level])))


def _templates(H, W, seed):
    """(w, h, features [n, 3]) per template: four random ones, one as
    large as the frame, one with a repeated feature."""
    rng = np.random.RandomState(seed)
    out = []
    for w, h, n in ((60, 45, 31), (23, 37, 9), (W - 3, H - 2, 63), (8, 5, 4), (41, 41, 63)):
        feats = np.stack([rng.randint(0, w + 1, n), rng.randint(0, h + 1, n),
                          rng.randint(0, 8, n)], 1)
        out.append((w, h, feats))
    w, h, feats = out[0]
    out.append((w, h, np.concatenate([feats, feats[3:4], feats[3:4]])))
    # a feature at the template's far corner (x == width, y == height)
    out[1][2][0] = (out[1][0], out[1][1], 5)
    return out


def _pair(specs, level):
    ref = [ref_features.Template(w, h, level, [ref_features.Feature(*map(int, f)) for f in fs])
           for w, h, fs in specs]
    port = [features.Template(w, h, level, [features.Feature(*map(int, f)) for f in fs])
            for w, h, fs in specs]
    return ref, port


def _ref_kernels(tmpls):
    kh = max(t.height for t in tmpls) + 1
    kw = max(t.width for t in tmpls) + 1
    return ref_sweep.pack_kernels(tmpls, kh, kw)


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_conv_sweep_equals_reference(level):
    t = LEVELS[level]
    R = _responses(level)
    H, W = R.shape[1:]
    gh, gw = H // t, W // t
    ref_t, port_t = _pair(_templates(H, W, level), level)
    Kr, sizes = _ref_kernels(ref_t)
    want = np.asarray(ref_sweep.conv_sweep(jnp.asarray(R), jnp.asarray(Kr), t, gh, gw))
    got = sweep.conv_sweep(torch.as_tensor(R), sweep.feature_tables(port_t, "cpu"), t, gh, gw)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sweep.template_sizes(port_t), sizes)
    assert want[2].any() and want[5].max() > want[0].max() - 10


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_local_scores_equal_reference(level):
    """Candidates of every template at anchors on the T-grid, off it,
    past the frame and below zero, where the reference's dynamic_slice
    reads the start from the padded maps' end and clamps it."""
    t = LEVELS[level]
    R = _responses(level)
    H, W = R.shape[1:]
    ref_t, port_t = _pair(_templates(H, W, level + 2), level)
    Kr, _ = _ref_kernels(ref_t)
    kernel_hw = Kr.shape[2:]
    rng = np.random.RandomState(level)
    n = 24
    tids = np.arange(n) % len(port_t)
    anchors = np.stack([rng.randint(0, W // t, n) * t, rng.randint(0, H // t, n) * t], 1)
    anchors[3] = (-2 * t, -t)
    anchors[4] = (W - t, H - 3)
    anchors[5] = (W + 7, H + 11)
    anchors[6] = (7, 3)
    anchors[7] = (W - 16 * t, H - 16 * t)
    anchors[8] = (40, -5)
    anchors[9] = (-kernel_hw[1] - 20 * t, 0)  # wraps to a start inside the maps
    anchors = anchors.astype(np.int32)
    want = np.asarray(ref_sweep.local_scores(
        jnp.asarray(R), jnp.asarray(Kr)[jnp.asarray(tids)], jnp.asarray(anchors), t))
    got = sweep.local_scores(torch.as_tensor(R), sweep.feature_tables(port_t, "cpu"),
                             torch.as_tensor(tids), torch.as_tensor(anchors), t, kernel_hw)
    assert got.shape == (n, 16, 16) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_span_mask_equals_reference(level):
    t = LEVELS[level]
    H, W = (480, 640) if level == 0 else (240, 320)
    _, port_t = _pair(_templates(H, W, level), level)
    sizes = sweep.template_sizes(port_t)
    for gh, gw in ((H // t, W // t), (H // t - 3, W // t + 2)):
        np.testing.assert_array_equal(
            sweep.span_mask(sizes, t, H, W, gh, gw),
            ref_sweep.span_mask(sizes, t, H, W, gh, gw))


def test_feature_tables_count_repeats():
    """A repeated feature is listed as often as it occurs, as the
    reference's one-hot kernel adds it; zero-feature templates sweep 0."""
    specs = [(10, 10, np.array([[1, 2, 3], [1, 2, 3], [4, 5, 6]])), (5, 5, np.zeros((0, 3), int))]
    _, port_t = _pair(specs, 0)
    x, y, label, n = sweep.feature_tables(port_t, "cpu")
    assert n.tolist() == [3, 0]
    assert x[0].tolist() == [1, 1, 4] and y[0].tolist() == [2, 2, 5]
    R = torch.zeros((8, 20, 20), dtype=torch.uint8)
    R[3, 2, 1] = 4
    out = sweep.conv_sweep(R, (x, y, label, n), 5, 4, 4)
    assert out[0, 0, 0] == 8 and out[1].abs().sum() == 0
