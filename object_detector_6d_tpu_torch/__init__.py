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

The package imports ``torch`` and numpy, never ``jax`` nor the
reference package. What is still to port is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
