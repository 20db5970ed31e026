"""The port's public detector API has the JAX package's signatures: the
parameters both have come in the same order with the same defaults, and
every reference parameter exists in the port unless it is listed below
with the reason it is absent. The port's only extra is PoseDetector's
``device``, keyword-last."""

import inspect

import numpy as np
import pytest

from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

# reference parameters the port does not take yet, and why
ABSENT = {
    ("PoseDetector.__init__", "mesh"):
        "sharding over a device mesh: ROADMAP queue 1 item 19",
    ("PoseDetector.__init__", "scene_points_stride"):
        "read only by the host-orchestrated detect path: ROADMAP queue 1 item 11",
}
PORT_ONLY = {("PoseDetector.__init__", "device")}

CALLABLES = {
    "Detector.__init__": (RefDetector.__init__, Detector.__init__),
    "PoseDetector.__init__": (RefPoseDetector.__init__, PoseDetector.__init__),
    "PoseDetector.add_view": (RefPoseDetector.add_view, PoseDetector.add_view),
    "PoseDetector.detect_fused": (RefPoseDetector.detect_fused, PoseDetector.detect_fused),
    "PoseDetector.detect_fused_batch": (RefPoseDetector.detect_fused_batch,
                                        PoseDetector.detect_fused_batch),
    "PoseDetector.detect_fused_dispatch": (RefPoseDetector.detect_fused_dispatch,
                                           PoseDetector.detect_fused_dispatch),
}


@pytest.mark.parametrize("name", sorted(CALLABLES))
def test_signature_mirrors_reference(name):
    ref, port = (inspect.signature(f).parameters for f in CALLABLES[name])
    shared = [p for p in ref if p in port]
    assert shared == [p for p in port if p in ref], "shared parameters out of order"
    for p in shared:
        assert port[p].kind == ref[p].kind, p
        assert port[p].default == ref[p].default, p
    missing = {p for p in ref if p not in port}
    assert missing == {p for (n, p) in ABSENT if n == name}
    extra = [p for p in port if p not in ref]
    assert set(extra) == {p for (n, p) in PORT_ONLY if n == name}
    if extra:
        assert list(port)[-len(extra):] == extra, "port-only parameters come last"


def test_default_detector_has_both_modalities():
    assert Detector().modality_names == ("ColorGradient", "DepthNormal")
    assert Detector().modality_names == RefDetector().modality_names
    with pytest.raises(ValueError, match="modality"):
        Detector(modalities=("Color",))


def test_color_gradient_needs_rgb():
    """As the reference: a detector with ColorGradient raises ValueError
    when a view or a batch comes without its colour frames."""
    K = np.array([[500.0, 0, 32], [0, 500.0, 24], [0, 0, 1]])
    depth = np.full((48, 64), 800, np.uint16)
    pd = PoseDetector()
    with pytest.raises(ValueError, match="rgb"):
        pd.add_view("obj", depth, K, np.ones((48, 64), np.uint8))
    with pytest.raises(ValueError, match="rgb"):
        pd.detect_fused_batch(depth[None], K)
    with pytest.raises(ValueError, match="rgb"):
        pd.detect_fused(depth, K)
