"""Training on the card: PoseDetector.add_view with device="cuda" quantizes
each view with K1 (both ColorGradient levels) and K2 and gives the CPU's
templates exactly (the twins), at 480x640 and at an odd 479x641 view; the
view clouds agree within 1e-6 m.

Marked ``cuda``: every test skips without a card (decided inside the
fixture, never at import). Run on the card with
``python -m pytest --noconftest -q tests/test_torch_train_cuda.py``.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.ops import quantize

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _view(hw):
    """The snowman view with seeded per-channel noise (so K1's channel
    select is exercised), cut or padded to ``hw``."""
    dep, gray, mask = scenes.snowman_scene()
    noise = np.random.RandomState(5).randint(-24, 25, gray.shape + (3,))
    bgr = np.clip(np.repeat(gray[..., None], 3, 2) + noise, 0, 255).astype(np.uint8)
    h, w = hw

    def fit(a):
        pad = [(0, max(0, h - a.shape[0])), (0, max(0, w - a.shape[1]))] + [(0, 0)] * (a.ndim - 2)
        return np.ascontiguousarray(np.pad(a, pad, mode="edge")[:h, :w])

    return fit(dep), fit(bgr), fit(mask.astype(np.uint8) * 255)


@pytest.mark.parametrize("hw", [(480, 640), (479, 641)])
def test_training_on_the_card_equals_the_cpu(dev, hw):
    dep, bgr, mask = _view(hw)
    K = scenes.K_DEFAULT
    card, cpu = PoseDetector(device=dev), PoseDetector(device="cpu")
    for fn in (quantize.cg_quantize_batched, quantize.dn_quantize_batched):
        fn.launches = 0
    assert card.add_view("obj", dep, K, mask, rgb=bgr) == 0
    assert (quantize.cg_quantize_batched.launches, quantize.dn_quantize_batched.launches) == (2, 1)
    assert cpu.add_view("obj", dep, K, mask, rgb=bgr) == 0
    assert (quantize.cg_quantize_batched.launches, quantize.dn_quantize_batched.launches) == (2, 1)
    for t, c in zip(card.detector.get_templates("obj", 0), cpu.detector.get_templates("obj", 0)):
        assert (t.width, t.height, t.pyramid_level) == (c.width, c.height, c.pyramid_level)
        np.testing.assert_array_equal(t.feature_array(), c.feature_array())
    v, w = card.views[("obj", 0)], cpu.views[("obj", 0)]
    assert v.bbox == w.bbox
    np.testing.assert_array_equal(np.isnan(v.model_cloud), np.isnan(w.model_cloud))
    np.testing.assert_allclose(v.model_cloud[:, :3], w.model_cloud[:, :3], atol=1e-6, rtol=0)
    np.testing.assert_allclose(v.anchor_point, w.anchor_point, atol=1e-6, rtol=0)
