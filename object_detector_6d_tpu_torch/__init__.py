"""object_detector_6d_tpu_torch — the PyTorch / CUDA port of object_detector_6d_tpu.

A second package beside the JAX reference ``object_detector_6d_tpu``,
with the same subpackage layout and module names. It runs on one NVIDIA
H100 (hand-written ``sm_90a`` kernels under ``csrc/``). Every entry point
(PoseDetector, Detector.match, ICP, pose_detector_from_state,
make_detect_program, pack_views, FusedScene) defaults to
``device="cuda"``; ``device="cpu"`` asks for the CPU, where every kernel
wrapper uses its plain PyTorch twin. StreamingDetector runs on its
PoseDetector's device.

It carries the fused detect path and, behind it, the host-orchestrated
one, with the reference's two modalities (ColorGradient + DepthNormal) or
either one alone:

    PoseDetector(detector=Detector(), device="cuda")
    .add_view(class_id, depth, K, mask, rgb)      training (templates + ICP model)
    .detect_fused_batch(depths, K, rgbs)          quantize -> response maps
                                -> coarse sweep -> top-K -> 16x16 refine
                                -> geometry -> hypothesis lift
                                -> projective ICP -> device cluster NMS -> [Pose]
    .detect_fused_dispatch_multi(depths_g, K, rgbs_g) / .detect_fused_finalize_multi(h)
                                G batches queued back to back, one copy back
    .detect_fused_finalize_many([h, ...])         several dispatch handles,
                                one copy back
    .detect(depth, K, rgb)                        Detector.match (capacity ladder)
                                -> window-quantile lift -> nearest-neighbour
                                ICP (refine/icp.py) -> host NMS -> [Pose];
                                detect_fused_batch falls back to it for a frame
                                with more coarse candidates than hypothesis slots

    Detector.match(sources, threshold, fused=True)
                                the fused match program over a capacity
                                ladder; with fused=False, another pyramid
                                depth than 2 or a ladder that runs out, the
                                host-orchestrated matcher (match/sweep.py:
                                coarse sweep K6, 16x16 local sweeps K4)
    StreamingDetector(pose_detector).process(depths, K, rgbs)
                                an N-camera tick as one fused call;
                                .process_host: per-camera match, one geometry
                                pass, median lift, NN ICP, per-camera NMS

Offline, before and after detection (on the detector's device as well):

    train_from_model(pose_detector, class_id, model6, K, view_poses)
                                render each view (api/templates.py) and
                                add_view it: K1 / K2 quantize every view
    Detector.write_classes / read_classes / write / Detector.read
                                the oracle's templates_%s.yml.gz store
                                (io/yaml_store.py; native reader io/native.py)
    evaluate_scene(pose_detector, BopScene(dir), obj_to_class, model_points)
                                ADD(-S)-0.1d over a BOP-layout scene
                                (eval/, data/bop.py, io/png.py, io/ply.py)

Geometry utilities, odometry and template-free detection, off the
detect path (on the given device as well):

    clean_depth, register_depth / warp_frame, extract_planes (geom/)
    normals_fals / normals_linemod / normals_cross / normals_sri
    OdometryFrame.create + ICPOdometry / RgbdOdometry / RgbdICPOdometry /
    FastICPOdometry().compute(src, dst)          odometry/
    PPFDetector().train_model(model6) / .match(scene6) / .write / .read
                                point-pair-feature voting (ppf/)
    utils/debug.py (checked, nan_watch), utils/profiling.py (scope,
    trace_to, DeviceTimer)

Template-bank / hypothesis / frame sharding over a torch.distributed
device mesh (``parallel``): one process per rank, each building the same
detector; ``make_mesh`` gives the (data, model) mesh that
``PoseDetector(mesh=)`` and ``make_detect_program(mesh=)`` take.

The package imports ``torch`` and numpy, never ``jax`` nor the
reference package. The names below, the reference's public surface and
this list's entry points, load their modules at first use. Every module
of the reference has its counterpart here.
"""

import importlib

from object_detector_6d_tpu_torch.version import __version__

_EXPORTS = {
    "Detector": "api.detector",
    "Match": "api.detector",
    "PoseDetector": "api.pipeline",
    "ICP": "refine.icp",
    "Pose": "refine.pose",
    "PoseCluster": "refine.pose",
    "cluster_poses": "refine.pose",
    "ColorGradientParams": "core.config",
    "DepthNormalParams": "core.config",
    "DetectorParams": "core.config",
    "ICPParams": "core.config",
    "Intrinsics": "core.intrinsics",
    "SE3": "core.se3",
    "render_view": "api.templates",
    "train_from_model": "api.templates",
    "BopScene": "data.bop",
    "make_synthetic_bop_scene": "data.bop",
    "evaluate_scene": "eval.harness",
    "EvalResult": "eval.harness",
    "clean_depth": "geom.cleaner",
    "extract_planes": "geom.plane",
    "PlaneExtraction": "geom.plane",
    "register_depth": "geom.registration",
    "warp_frame": "geom.registration",
    "normals_fals": "geom.normals",
    "normals_linemod": "geom.normals",
    "normals_cross": "geom.normals",
    "normals_sri": "geom.normals",
    "Odometry": "odometry.odometry",
    "OdometryFrame": "odometry.odometry",
    "ICPOdometry": "odometry.odometry",
    "RgbdOdometry": "odometry.odometry",
    "RgbdICPOdometry": "odometry.odometry",
    "FastICPOdometry": "odometry.odometry",
    "PPFDetector": "ppf.detector",
    "make_mesh": "parallel.sharding",
    "mesh_shape": "parallel.sharding",
}

__all__ = ["__version__", *_EXPORTS]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
