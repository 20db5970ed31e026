"""The port's public detector API has the JAX package's signatures: the
parameters both have come in the same order with the same defaults, and
every reference parameter exists in the port unless it is listed below
with the reason it is absent. The port's only extra is ``device``, last, on
the entry points that run on the card."""

import inspect

import numpy as np
import pytest
import torch

from object_detector_6d_tpu.api import detect_program as ref_detect_program
from object_detector_6d_tpu.api.detector import Detector as RefDetector
from object_detector_6d_tpu.api.pipeline import PoseDetector as RefPoseDetector
from object_detector_6d_tpu.api.streaming import StreamingDetector as RefStreamingDetector
from object_detector_6d_tpu.ops import refine_pallas as ref_refine_pallas
from object_detector_6d_tpu.ops import response_pallas as ref_response_pallas
from object_detector_6d_tpu.parallel import sharding as ref_sharding
from object_detector_6d_tpu.quant.color_gradient import ColorGradient as RefColorGradient
from object_detector_6d_tpu.quant.depth_normal import DepthNormal as RefDepthNormal
from object_detector_6d_tpu.refine.icp import ICP as RefICP
from object_detector_6d_tpu_torch.api import detect_program
from object_detector_6d_tpu_torch.api.detector import Detector
from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
from object_detector_6d_tpu_torch.api.streaming import StreamingDetector
from object_detector_6d_tpu_torch.core.config import DetectParams
from object_detector_6d_tpu_torch.io.convert import (
    detector_dict,
    params_dict,
    pose_detector_from_state,
)
from object_detector_6d_tpu_torch.ops import refine, response
from object_detector_6d_tpu_torch.parallel import sharding
from object_detector_6d_tpu_torch.quant.color_gradient import ColorGradient
from object_detector_6d_tpu_torch.quant.depth_normal import DepthNormal
from object_detector_6d_tpu_torch.refine.icp import ICP

# reference parameters the port does not take yet, and why
ABSENT = {
    ("make_detect_program", "max_dr"):
        "sizes the conv path's dense bank tensors; the port's sparse tables take any offset",
    ("make_detect_program", "refine_impl"): "TPU-only choice of the refine kernel",
    ("make_detect_program", "pallas_interpret"): "TPU-only: the port's twins run on the CPU",
    ("response_spread", "interpret"): "the same",
    ("refine_sweep", "interpret"): "the same",
}
PORT_ONLY = {("PoseDetector.__init__", "device"), ("Detector.match", "device"),
             ("ICP.from_params", "device"), ("make_detect_program", "device"),
             ("ColorGradient.__init__", "device"), ("DepthNormal.__init__", "device"),
             ("make_mesh", "device")}

CALLABLES = {
    "Detector.__init__": (RefDetector.__init__, Detector.__init__),
    "Detector.match": (RefDetector.match, Detector.match),
    "Detector.class_ids": (RefDetector.class_ids, Detector.class_ids),
    "Detector.get_templates": (RefDetector.get_templates, Detector.get_templates),
    "Detector.get_bank": (RefDetector.get_bank, Detector.get_bank),
    "ICP.from_params": (RefICP.from_params, ICP.from_params),
    "ICP.register_model_to_scene": (RefICP.register_model_to_scene,
                                    ICP.register_model_to_scene),
    "PoseDetector.detect": (RefPoseDetector.detect, PoseDetector.detect),
    "PoseDetector.__init__": (RefPoseDetector.__init__, PoseDetector.__init__),
    "PoseDetector.add_view": (RefPoseDetector.add_view, PoseDetector.add_view),
    "PoseDetector.detect_fused": (RefPoseDetector.detect_fused, PoseDetector.detect_fused),
    "PoseDetector.detect_fused_batch": (RefPoseDetector.detect_fused_batch,
                                        PoseDetector.detect_fused_batch),
    "PoseDetector.detect_fused_dispatch": (RefPoseDetector.detect_fused_dispatch,
                                           PoseDetector.detect_fused_dispatch),
    "PoseDetector.detect_fused_dispatch_multi": (RefPoseDetector.detect_fused_dispatch_multi,
                                                 PoseDetector.detect_fused_dispatch_multi),
    "PoseDetector.detect_fused_finalize_multi": (RefPoseDetector.detect_fused_finalize_multi,
                                                 PoseDetector.detect_fused_finalize_multi),
    "PoseDetector.detect_fused_finalize_many": (RefPoseDetector.detect_fused_finalize_many,
                                                PoseDetector.detect_fused_finalize_many),
    "StreamingDetector.__init__": (RefStreamingDetector.__init__, StreamingDetector.__init__),
    "StreamingDetector.process": (RefStreamingDetector.process, StreamingDetector.process),
    "StreamingDetector.process_host": (RefStreamingDetector.process_host,
                                       StreamingDetector.process_host),
    "make_detect_program": (ref_detect_program.make_detect_program,
                            detect_program.make_detect_program),
    "ColorGradient.__init__": (RefColorGradient.__init__, ColorGradient.__init__),
    "ColorGradient.quantize": (RefColorGradient.quantize, ColorGradient.quantize),
    "DepthNormal.__init__": (RefDepthNormal.__init__, DepthNormal.__init__),
    "DepthNormal.quantize": (RefDepthNormal.quantize, DepthNormal.quantize),
    "response_spread": (ref_response_pallas.response_spread, response.response_spread),
    "refine_sweep": (ref_refine_pallas.refine_sweep.__wrapped__, refine.refine_sweep),
    "make_mesh": (ref_sharding.make_mesh, sharding.make_mesh),
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
    pd = PoseDetector(device="cpu")
    with pytest.raises(ValueError, match="rgb"):
        pd.add_view("obj", depth, K, np.ones((48, 64), np.uint8))
    with pytest.raises(ValueError, match="rgb"):
        pd.detect_fused_batch(depth[None], K)
    with pytest.raises(ValueError, match="rgb"):
        pd.detect_fused(depth, K)


def test_pose_detector_defaults_to_the_card():
    assert PoseDetector().device.type == "cuda"


@pytest.mark.parametrize("name", ["PoseDetector.__init__", "pose_detector_from_state",
                                  "make_detect_program", "pack_views", "FusedScene.__init__",
                                  "Detector.match", "ICP.from_params",
                                  "ColorGradient.__init__", "DepthNormal.__init__",
                                  "make_mesh"])
def test_entry_points_default_to_the_card(name):
    from object_detector_6d_tpu_torch.io import convert
    from object_detector_6d_tpu_torch.ops import geometry

    fn = {"PoseDetector.__init__": PoseDetector.__init__,
          "pose_detector_from_state": convert.pose_detector_from_state,
          "make_detect_program": detect_program.make_detect_program,
          "pack_views": detect_program.pack_views,
          "FusedScene.__init__": geometry.FusedScene.__init__,
          "Detector.match": Detector.match, "ICP.from_params": ICP.from_params,
          "ColorGradient.__init__": ColorGradient.__init__,
          "DepthNormal.__init__": DepthNormal.__init__, "make_mesh": sharding.make_mesh}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("icp_window", [96, -1])
def test_icp_window_builds_and_carries_over(icp_window):
    """The windowed ICP association is no longer rejected: DetectParams
    takes it, and params_dict hands it to a port detector."""
    from object_detector_6d_tpu.core.config import DetectParams as RefDetectParams

    for params in (DetectParams(icp_window=icp_window), RefDetectParams(icp_window=icp_window)):
        assert params.icp_window == icp_window
        assert params_dict(params)["icp_window"] == icp_window
        pd = pose_detector_from_state(detector_dict(Detector(modalities=("DepthNormal",))),
                                      {}, {}, params_dict(params), device="cpu")
        assert pd.params == DetectParams(icp_window=icp_window)


def test_front_ends_raise_without_a_card():
    """ColorGradient / DepthNormal on the default device do not carry on
    on the CPU for numpy input."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ColorGradient().quantize(np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DepthNormal().quantize(np.zeros((16, 16), np.uint16))


def test_default_device_detect_raises_without_a_card():
    """Without a card, a detect call on the default device raises; it
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    K = np.array([[500.0, 0, 32], [0, 500.0, 24], [0, 0, 1]])
    depth = np.full((48, 64), 800, np.uint16)
    rgb = np.zeros((48, 64, 3), np.uint8)
    pd = PoseDetector()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pd.detect_fused_batch(depth[None], K, rgb[None])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pd.detect_fused(depth, K, rgb)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pd.detect(depth, K, rgb)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pd.detector.match([rgb, depth], 80.0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pd.detector.match([rgb, depth], 80.0, fused=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        StreamingDetector(pd).process_host(depth[None], K, rgb[None])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ICP().register_model_to_scene(np.zeros((8, 6), np.float32), np.zeros((8, 6), np.float32))
