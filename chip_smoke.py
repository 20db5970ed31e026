"""Drive the PyTorch port's detect paths once on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device   require CUDA (there is no CPU path); print the card's name and
            power limit as nvidia-smi reports them
2. build    compile the hand-written kernels (csrc/*.cu) with nvcc
3. two-modality path, the reference's default Detector() (ColorGradient +
   DepthNormal) on the repo's detect benchmark workload:
   a. kernels  K1 (colour quantize) against its twin at [B,480,640,3],
               at [B,240,320,3] (after pyr_down_u8) and at 479x641, each
               on the gray frames and on frames with seeded per-channel
               noise; K6 (coarse sweep) against its twin at the main
               path's planes and tables and at an odd plane size with
               bytes over -128..127, and beside one cuDNN conv2d that
               computes the same grid; K4
               (refine sweep) and K3 (spread + response) against their
               twins on the arguments the match program passes them;
               K7 (the match's exact top-K) against its twin at the
               benchmark cell's [128, 1202x30x40] grid, timed beside the
               stable torch.sort and torch.topk; timings
   b. main     PoseDetector.detect_fused_batch(depths, K, rgbs) on B=32
               two-object 480x640 frames: every kernel K1-K7 launched, no
               frame through the overflow fallback (the counter
               ``overflow_fallback`` stays 0, so a main phase never times
               the host path), every objA pose within 1 cm and 5 deg of
               the ground truth, objA found in >= 90% of frames, objB
               found / off-truth within 3 of the JAX reference's counts on
               the same frames; median ms per batch after warm-up
   c. cpu      the match program's [B, 5, K+1] on the card equals the CPU's
               (the twins) on all B frames; the flat NMS record and the Pose
               arrays of all B frames equal those of a CPU PoseDetector,
               bitwise (every inexact float32 call goes through
               core/exact.py, every float sum through fixed_sum or one
               written order)
4. depth-only path, Detector(modalities=("DepthNormal",)): K2-K5 against
   their twins, bitwise (K5's planes with NaN == NaN; main shapes and
   479x641; K4 on random in-bounds tables), with timings of K2 and K5,
   then the same main
   and cpu checks as 3b and 3c on its own frames
5. overflow fallback: the depth-only workload at frame seed 0, where a
   frame holds more coarse candidates than the 16 hypothesis slots, through
   detect_fused_batch on the card: that frame is answered by the
   host-orchestrated ``detect`` (Detector.match at B=1 -> window quantile
   lift -> nearest-neighbour ICP -> host NMS). Gates: ``overflow_fallback``
   counts exactly the frames whose candidates overflow, and at least one;
   K2, K3, K6 and K4 are launched by ``detect``'s B=1 match; objA within
   1 cm / 5 deg of the truth on those frames; their poses within 1 mm /
   0.5 deg of the same call with device="cpu"; ms per fallen-back frame
6. host matcher: ``Detector.match`` through its host-orchestrated
   matcher (match/sweep.py) on the card, on the two-modality detector's
   frame 0 with ``fused=False`` and on the fallback workload's overflowing
   frame with MAX_FUSED_CANDIDATES lowered to 8 on the instance and a
   first capacity of 4, so that the ladder runs out. Gates: the list equals
   ``device="cpu"``'s exactly (x, y, similarity, class, template); it
   equals the fused match's at capacity 64, which does not overflow (the
   similarity to 3 places, the fused program's being float32); K1 (two
   modalities), K2, K3, K6 and K4 launched by it; ms per call
7. multi: ``detect_fused_dispatch_multi`` with G=2 batches of B=32 (the
   two-modality frames, then the same frames in reverse order) + its
   finalize, and ``detect_fused_finalize_many`` on two dispatch handles,
   each equal to one ``detect_fused_batch`` per batch: the same (class,
   template, x, y) and poses within 0.001 mm; no fallback; ms per batch
8. streaming: ``StreamingDetector`` on the reference's
   tests/test_streaming.py tick (the snowman with both modalities,
   threshold 65, 4 hypotheses, ICP 45 iterations / 3 levels, 4 cameras of
   which one is empty): ``process`` and ``process_host`` give the empty
   camera [] and every other camera its snowman within 12 mm;
   ``process_host`` on the card within 1 mm / 0.5 deg of device="cpu";
   ms per tick of each
9. parity: parity_torch.py's base and occl sets (tools/parity_add.py, 64
   scenes each) at the promoted schedule through ``detect_fused`` on the
   card: ADD-0.1d no lower than the OpenCV oracle golden's; the table
10. offline: train, store, evaluate (the reference's tests/test_templates.py
   and tests/test_eval_harness.py workloads).
   a. train   ``train_from_model`` of the snowman model (the view's cloud +
              FALS normals, centred) on its three views, on the card and
              with device="cpu": every template equal exactly, the view
              points within 1e-6 m and normals within the FALS bound (p99
              <= 1.1 deg); K1 launched 2x and K2 1x per view; ``detect``
              on the novel view within 12 mm mean model-point error; ms
              per trained view on each device
   b. store   write_classes -> read_classes through the native reader
              (built into build/odc_native/) and the Python reader, equal
              exactly to the trained templates; Detector.write -> read
              keeps the configuration; write_ply -> load_ply and
              load_ply_native of a seeded [500, 6] cloud within 1e-5
              (binary and ASCII); ms per round trip
   c. evaluate make_synthetic_bop_scene (3 frames, seed 0) -> BopScene ->
              evaluate_scene with the snowman add_view detector: 3 of 3
              found, ADD-0.1d 1.0, mean ADD < 0.01 m; K1-K6 launched;
              frame 0's poses on the card within 1 mm / 0.5 deg of
              device="cpu"; ms per evaluated frame and the harness's fps
11. geometry utilities, odometry, PPF (off the detect path; no hand
   kernel is launched, and the phase checks that every count stays 0),
   at 480x640 on the card, held against the truth, device="cpu" and the
   goldens in tests/golden/:
   a. clean_depth on a Kinect-like noisy snowman frame (seeded axial
              noise and holes), u16 and float32, card == cpu bitwise;
              cleaner.npz's cases within the oracle bounds of
              tests/test_cleaner.py; ms per frame
   b. normals_linemod on lmn_normals.npz's four cases, normals_sri and
              normals_cross on sri_normals.npz's two clouds: the golden
              bounds of tests/test_geom.py and tests/test_sri_normals.py,
              card == cpu bitwise (NaN == NaN); ms each
   c. register_depth and warp_frame on the snowman frame: the identity
              round trip and the known translation against
              render_translated (tests/test_registration.py), depth and
              BGR card == cpu bitwise; ms each
   d. extract_planes on tests/test_plane.py's two-planes scene: >= 2
              planes, labels on every pixel and coefficients card == cpu
              bitwise (its block fits are core/exact.py's eigh3 over
              fixed_sum covariances); ms
   e. odometry: ICP, FastICP, Rgbd and RgbdICP at the reference's default
              (4 levels, iter_counts (7, 7, 7, 10)) on
              tests/test_odometry.py's translated snowman pairs: the
              motion within 4 mm and 1 deg, card == cpu bitwise; ms per
              compute
   f. PPF: train on scenes.snowman_model() (exact normals), match on it
              moved by a known pose with add_noise_pc(.., 0.001): the best
              pose within 10% of the diameter and 25 deg of the truth;
              the pair tables card vs cpu: every key, alpha and alpha vote
              bin equal bitwise, the sorted tables equal; the PCA normals
              (compute_normals_pc3d: knn + eigh3) of every 8th model point
              card == cpu bitwise; ms for train and match, and the vote
              tables' bytes
12. raw forms and windows, on phase 3's two-modality detector and frames:
   a. raw     make_detect_program with device_nms=False and with
              flat_output=True at batch=32: unflatten_outputs(flat) equals
              the raw tuple, and make_cluster_stage applied to the raw tuple
              equals the production record (PoseDetector.program), bitwise
   b. one     batch=None on frame 0 against row 0 of the batch: packed,
              poses, residuals and keep equal bitwise
   c. B=1     ColorGradient().quantize and DepthNormal().quantize of frame 0
              (gray x3 and a noisy BGR frame) equal row 0 of K1 / K2;
              response_spread (both modalities, T = 5 and 8) and
              refine_sweep (the match program's frame-0 tables, and random
              in-bounds tables with nfeat=None) equal their batched forms
              (those comparison launches do not count)
   d. windows detect_fused_batch at icp_window 96 and -1 (the resolved size
              is logged) under 3b-c's gates, and the largest pose difference
              from icp_window 0's records. At 96 px, smaller than objA's
              template, the JAX reference itself puts objA off its truth in
              frames 2 and 15, so objA must be off it in exactly those
              frames and on it in the others; card == cpu bitwise on all
              32 frames, objB included (3c)
   e. times   ms per batch at icp_window 0, 96 and -1, in turns; K1-K6
              launches of the phase, added to the kernels line
13. sharded (parallel/sharding.py), on phase 3's detector and frames:
   a. one     PoseDetector(mesh=make_mesh(1)) in this process over nccl (a
              real process group of one: the mesh path and its collectives
              with nothing to merge): every kernel launched, the flat NMS
              record equal to the unsharded one bitwise on all 32 frames
   b. two     two spawned processes sharing the card over gloo (NCCL
              refuses two ranks on one card), mesh (1, 2), each building
              PoseDetector(mesh=) from pose_detector_from_state: every
              kernel launched on each rank; the match record [B, 5, K+1]
              and every class's poses and residuals (objB included) equal
              to the unsharded ones bitwise on all 32 frames (a rank refines
              half of each frame's lanes, and a lane's bits do not depend on
              the lanes beside it); K6 at a rank's template shard (61 of 122
              templates) equal to its twin
   c. times   ms per batch, unsharded and world of one in turns, and each
              rank of the world of two (the ranks start each run together);
              launches per rank added to the kernels line
14. limits, on phase 3's frames and schedule:
   a. edge    bench's bank plus one 300 x 410 px template (taller than
              480 - 2 * 40 px) cut from frame 0's own quantized images, so
              that it is live in frame 0's top-K: 3b-c's gates (drive_path);
              its base row is negative, and K4 swept it from the row where
              the reference's conv path starts its window (dynamic_slice
              counts a negative start from the planes' end and clamps it)
   b. chunks  synthetic_bank(2, 2, bbox_px=320, num_features=600), one
              600-feature template cut from frame 0, objA and objB: K4 runs
              3 chunks of MAX_F = 256 a modality, K6 3 (300 + 300 coarse
              features); each chunked call on the match program's own
              arguments equals one twin call over all its features; the
              match record on the card equals the CPU's
   c. spread  phase 3's templates at t_at_level (5, 20): K3 at T=20 (the
              plain spread over 5, then the kernel at 16) equals its twin on
              the match program's own quantized images; the match record
              on the card equals the CPU's
   d. times   ms per batch through detect_fused_dispatch to the device's
              end, for phase 3's detector and a-c, in turns; the main runs'
              launches added to the kernels line
15. batch: a frame's answer does not depend on the batch it came in (every
   float sum of the projective ICP is a core/reduce.py fixed_sum tree):
   a. alone   on phase 3's and phase 4's detectors and frames: frames 0, 1
              and 31 alone, in batches of 2 and 4 (31 at their ends) and at
              positions 0, 1 and 31 of the B=32 batch: the flat NMS record's
              rows and the Pose arrays equal bitwise
   b. multi   phase 7's G=2 dispatch_multi batches: each equals
              detect_fused_batch of the same 32 frames, and the reversed
              batch's row 31 - f the first batch's row f, bitwise
   c. tick    phase 8's 4-camera StreamingDetector.process: each camera
              equals its frame alone, bitwise
   d. times   ms per B=32 two-modality batch; the device operations of one
              batch per detect.* span (torch.profiler trace, the port's
              spans switched on for it: trace_spans), the lift + ICP
              span's among them; the phase's launches added to the kernels
              line
16. colour: the snowman trained by add_view on a coloured view (blue the
   gray, green a dimmer gray, red a patterned gray: K1's channel argmax no
   longer ties as on gray x3) on the card and the CPU, templates equal
   exactly; two coloured 480x640 frames (tests/test_torch_limits_frame.py's):
   the match record card == CPU bitwise, the snowman on its truth, the
   Pose arrays card == CPU bitwise; launches added to the kernels line
17. device: the card gives the CPU's answer:
   a. helpers the card's own float32 sqrt (the route core/exact.py's
              sqrt_rn takes there) equals the float64 route on all 2^31
              non-negative finite float32 values; every helper of
              core/exact.py, card vs CPU, on 2^24 seeded inputs over the
              ranges the detect path and the tooling give it: 0 differ
   b. K5      the kernel on the card == its twin on the CPU bitwise (NaN ==
              NaN) at [B, 480, 640] and 479x641
   c. stages  batch_probe.py's card-vs-CPU stage mode on frames 0-1 of both
              workloads: 0 calls differ on identical inputs in lift + ICP
              and the cluster stage, every stage, the flat record and the
              Pose arrays equal
   d. poses   held in 3c, 4c, 12d (all 32 frames, windows 0, 96, -1) and 16
   e. tools   the stage mode over clean_depth, extract_planes and PPF's
              PCA normals (0 calls and 0 stages differ) and PPF's training
              and matching (logged); phase 11's gates
   f. cost    the device operations per span of a two-modality batch
              (torch.profiler) and clean_depth ms per frame
18. configurations: the JAX package's bench.py configurations through the
   port's entry points at 480x640 (frames from make_frames, bench.py's
   generator); every launch of a-d's main runs adds to the kernels line:
   a. config 4 (bench.py:404-457) phase 3's detector and views at 64
              hypothesis slots x 3 seeds (192 ICP lanes a frame), fine
              compaction 16, threshold 75 raised by 2 while the first
              batch has a frame through the overflow fallback (up to 80;
              the threshold is logged); two batches of B=16,
              make_frames(16, 200 + s): 4 warm-up detect_fused_dispatch
              calls, then 8 timed, finalized with finalize_many in groups
              of 4 (ms per batch, frames/s). Gates: (i) no timed frame
              through the fallback; (ii) a frame with more than 16
              candidates through the threshold (every frame's count and
              poses before NMS are logged); (iii) frames 0-1 of the B=16
              batch == the card's B=2 batch and a CPU PoseDetector's B=2
              batch, and the frame with the most candidates == the CPU's
              on it alone: flat record and Pose arrays bitwise; (iv) objA
              found / off truth within 3 of the JAX package's (REF4)
   b. scale   configs 2 + 4 (bench.py:459-515): a fresh Detector() with
              synthetic_bank(12, 100) + objA + objB (1202 templates) at
              a's schedule and gates ((ii) logged only; (iv) over frames
              0-1, REF_SCALE), frames make_frames(16, 300 + s); K6 ==
              its twin on the match program's own [1202, F] tables (time,
              L2 flushed, bound, the cuDNN conv), K4 at 64 candidates
   c. match   make_match_program alone at bench_match's banks (12x10,
              12x100, 40x100 = 120, 1200, 4000 templates), B=8 random
              BGR / depth 900-1599 frames from RandomState(0), 32
              candidates, threshold 80: the match record of frames 0-1
              card == CPU; ms per batch over 12 dispatches synced once (8
              at 4000); K6 at 4000 templates and K4 at 32 candidates on
              the program's own arguments
   d. config 5 (bench.py:518-600) phase 3's detector on 4-camera ticks
              make_frames(4, 100 + s), s = 0..3: StreamingDetector.process
              (mean of the 6 fastest of 8 ticks), 16 tick-wise pipelined
              dispatches finalized in groups of 8 after a warm group, 8
              dispatch_multi executions of G=4 ticks; ms per tick and
              frames/s against the 33.3 ms tick of 4 x 30 FPS; every
              camera of every pipelined and scanned tick == process on
              it, bitwise; device ops, host ms and device ms per detect.*
              span of one tick and of a B=32 batch (torch.profiler)

The two-modality workload is bench.py's: the snowman objA and its
0.78-scale objB trained with the port's add_view (rgb = the gray view x3)
plus synthetic_bank(n_classes=12, per_class=10, bbox_px=120, seed=0),
122 templates of 63+63 / 31+31 features; threshold 80, 16 hypotheses,
ICP 32 iterations / 4 levels / 2 solves per association / finest level 2
associations, 2 depth seeds, fine compaction 8, 512-point models. The
depth-only workload has 130 depth-only distractors instead (13 classes x
10, 63 / 31 features). Frames and templates come from fixed numpy seeds.

The line before the last is {"kernels": [...]}: every kernel with its
launches on the two-modality main path plus those of phases 10, 12, 13,
14, 15, 16 and 18,
its largest difference from its twin, its time beside the twin's, its
bound (the larger of its bytes over the card's memory rate and its
operations over the peak rate for their type, from this run's inputs;
bound_by says which) and the time of one PyTorch call that computes the
same function (library_ms, null where there is none), and cold_ms, its
time with the 50 MB L2 flushed before each launch, where that was taken
(K4, K5, K6; K6's 39 MB of planes fit the L2, so its repeated launches
find them there). K4 is timed alone, through its C entry point, on the
arguments the two-modality match program passes it, with the L2 flushed
before each batch; its wrapper's time (argument checks with a host sync)
is logged beside it. K3 is timed alone through its C entry point too, on
the match program's 4 launches (ColorGradient and DepthNormal, both
levels; repeated launches, the L2 warm as after K1 and K2). The last
line of standard output is {"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
B = 32
# depth-only frame seed 1: with seed 0, frame 29 holds 17 coarse candidates
# > 16 hypothesis slots in both packages and goes through the
# host-orchestrated fallback; the fallback phase drives exactly that
SEED = 1
SEED_FALLBACK = 0
# the JAX reference on these 32 frames (CPU, same trained state): objA
# correct in 32 frames with no other objA pose; objB correct in 21 frames,
# plus 17 objB poses more than 1 cm / 5 deg from its truth (the 0.78-scale
# snowman template also fits objA). objB is held to these within 3 frames
REF_OBJB_FOUND = 21
REF_OBJB_SPURIOUS = 17
# two-modality frames: bench.py's first batch, seed 0. The JAX reference on
# these 32 frames (CPU, the same trained state, no candidate overflow)
# finds objA in 32 frames with no other objA pose, and objB in none: its
# 27 objB poses all lie 0.3-0.65 m from objB's truth (the 0.78-scale
# snowman's template also fits objA). objB is held to these within 3
SEED2 = 0
REF2_OBJB_FOUND = 0
REF2_OBJB_SPURIOUS = 27
# the same at icp_window=96 (phase 12), a window smaller than objA's 179 x
# 159 px template: objA lands 10.8 and 11.2 mm off its truth in frames 2
# and 15 and on it in the other 30; objB found in none, 23 poses off. The
# window leaves the objB hypotheses on objA's body at the 4 mm residual
# gate, where a last-bit change of the ICP sums moves them by mm or flips
# their keep (tests/test_torch_window_bench.py holds the port against the
# reference frame by frame), so at 96 objA's off-truth frames must be the
# reference's, and card against CPU holds every class but objB on all 32
# frames and logs objB's frames apart
REF2_W96_OBJA_OFF = (2, 15)
OBJB_SLACK = 3
N_DISTRACTOR_CLASSES = 13
PER_CLASS = 10
THRESHOLD = 80.0
ODD_HW = (479, 641)
GT_T_M = 0.01
GT_DEG = 5.0
XDEV_T_M = 0.001
XDEV_DEG = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# workload (numpy only)
# ----------------------------------------------------------------------

def scenes_module():
    sys.path.insert(0, str(ROOT / "tools"))
    import scenes

    return scenes


def add_distractors(det, seed: int = 0):
    """13 classes x 10 depth-only template pyramids into ``det``: bbox
    ~120 px +-20%, 63 / 31 scattered features at levels 0 / 1 (the
    one-modality form of data/synthetic.py's bank)."""
    from object_detector_6d_tpu_torch.data.synthetic import scattered_features
    from object_detector_6d_tpu_torch.quant.features import Template

    rng = np.random.RandomState(seed)
    for c in range(N_DISTRACTOR_CLASSES):
        for _ in range(PER_CLASS):
            w = h = int(120 * rng.uniform(0.8, 1.2))
            det.add_synthetic_template(
                [Template(w, h, 0, scattered_features(rng, 63, w, h, 6)),
                 Template(w // 2, h // 2, 1, scattered_features(rng, 31, w // 2, h // 2, 4))],
                f"class_{c:02d}")
    return det


def make_frames(scenes, K, n: int, seed: int):
    """n two-object frames (objA at tA, objB at tB, z-min composed), their
    BGR frames (the composed gray x3) and ground-truth translations, as
    the repo's detect benchmark."""
    depA, _, maskA = scenes.snowman_scene()
    depB, _, maskB = scenes.snowman_scene(scale=0.78)
    rng = np.random.RandomState(seed)
    depths, rgbs, gts = [], [], []
    for _ in range(n):
        tA = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                       rng.uniform(-0.04, 0.04)])
        tB = np.array([-0.26 + rng.uniform(-0.03, 0.03),
                       0.11 + rng.uniform(-0.03, 0.03),
                       0.04 + rng.uniform(-0.03, 0.03)])
        rA = scenes.render_translated(depA, maskA, K, tA)
        rB = scenes.render_translated(depB, maskB, K, tB)
        d, _, g = scenes.merge_scenes([rA, rB])
        depths.append(d)
        rgbs.append(np.repeat(g[..., None], 3, axis=2))
        gts.append({"objA": tA, "objB": tB})
    return np.stack(depths), np.stack(rgbs), gts


def rot_deg(Ra, Rb=None) -> float:
    """Angle [deg] of the rotation between Ra and Rb (identity when None),
    from the Frobenius distance 2*sqrt(2)*sin(theta/2): well conditioned
    near zero, unlike arccos of the trace."""
    Rb = np.eye(3) if Rb is None else Rb
    s = np.linalg.norm(np.asarray(Ra) - np.asarray(Rb)) / (2.0 * np.sqrt(2.0))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, s))))


def ground_truth_stats(results, gts):
    """Per class: frames with a pose within GT_T_M and GT_DEG of the
    frame's truth (a pure translation), and poses outside it."""
    found = {"objA": 0, "objB": 0}
    spurious = {"objA": [], "objB": []}
    for b, (poses, gt) in enumerate(zip(results, gts)):
        hit = set()
        for p in poses:
            if p.class_id not in gt:
                continue
            dt = np.abs(p.pose[:3, 3] - gt[p.class_id]).max()
            ang = rot_deg(p.pose[:3, :3])
            if dt <= GT_T_M and ang <= GT_DEG:
                hit.add(p.class_id)
            else:
                spurious[p.class_id].append((b, round(float(dt) * 1e3, 1), round(ang, 2)))
        for c in hit:
            found[c] += 1
    return found, spurious


def two_modality_bank():
    """bench.py's distractor bank on the reference's default Detector()."""
    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank

    return synthetic_bank(n_classes=12, per_class=10, bbox_px=120, seed=0,
                          detector=Detector())


def train_params():
    """bench.py's promoted schedule."""
    from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams

    return DetectParams(match_threshold=THRESHOLD, max_hypotheses=16,
                        icp=ICPParams(iterations=32, num_levels=4,
                                      solves_per_assoc=2, finest_assoc=2),
                        num_seeds=2, fine_compact=8)


def train(det, dev, scenes, K):
    """A PoseDetector on ``dev`` with bench.py's promoted schedule, objA and
    objB (the 0.78-scale snowman) trained into ``det`` with add_view."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    pd = PoseDetector(detector=det, params=train_params(), model_points=512, device=dev)
    t0 = time.time()
    for cid, scale in (("objA", 1.0), ("objB", 0.78)):
        dep, gray, mask = scenes.snowman_scene(scale=scale)
        rgb = np.repeat(gray[..., None], 3, axis=2)
        if pd.add_view(cid, dep, K, mask.astype(np.uint8) * 255, rgb=rgb) != 0:
            raise AssertionError(f"add_view {cid} failed")
    log(f"train {det.modality_names}: {det.num_templates()} templates, 2 classes "
        f"with views ({time.time() - t0:.1f} s on the host)")
    return pd


# ----------------------------------------------------------------------
# card phases
# ----------------------------------------------------------------------

def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 20) -> float:
    """Mean ms per call with the 50 MB L2 flushed before each call (a
    256 MiB buffer written between calls; CUDA events around each call)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# Published peaks of one H100 SXM at 700 W: HBM 3.35 TB/s; 67 TFLOP/s
# float32 counts a fused multiply-add as 2, so 33.5 T single operations
# a second run on the CUDA cores (132 SMs x 128 lanes x 1.98 GHz), of
# which int32 has half the lanes: 16.7 T int32 operations a second.
HBM_BYTES_S = 3.35e12
ALL_OPS_S = 33.5e12
INT32_OPS_S = 16.7e12
# operations per output pixel of the algorithm each kernel computes
# (counted from its definition, not from the kernel's code):
# K1: 7-tap symmetric Gaussian 10 per pass, 2 passes + rounding (23) x 3
#     channels; Sobel 12 + magnitude 3 (15) x 3; channel select 6; vote
#     (packed 4-bit fields, separable 3x3) 6, the bin with >= 5 votes 5,
#     gates 5 -> 136 int; fastAtan2 + bin 23 float
K1_INT, K1_FP = 136, 23
# K2: the ring offsets are -5, 0 or 5, so the normal equations reduce to
#     counts and signed sums of the gated differences: 8 ring samples x
#     (difference, |.|, compare, gate, gated difference) 40; the sums with
#     their factors 25 and 5 (A0 3, A3 3, A1 4, corners 3, b0 6, b1 6) 25;
#     the solve (det, ddx, ddy) 9; scaling by 1150 and -det d 4; cell
#     indices 2; octant selects 5; validity and the one-hot shift 6; 5x5
#     median over packed counts (5 rows sliding 2, even / odd split 6, 5
#     columns sliding 4, running counts and first-set 20) 32 -> 123 int;
#     6 conversions, normal, norm, inverse, scale, octant compares 29 float.
#     (The two-pass design's count, which accumulated five sums per sample
#     and counted bits per tap, was 150 int + 20 float.)
K2_INT, K2_FP = 123, 29
# K3: log-step OR spread 2 x ceil(log2 T), then 8 orientations x
#     (rotate, lookup) -> ~40 int
K3_INT = 40
# K5: cloud 8, radius 6, inverse 1, unit ray 3, 5x5 box sums 3 x 8,
#     M^-1 b 15, normalize 9, orientation 6 -> 72 float
K5_FP = 72


def bound_ms(nbytes: float, int_ops: float = 0.0, fp_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(int_ops / INT32_OPS_S, (int_ops + fp_ops) / ALL_OPS_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def log_times(recs, gpu) -> None:
    for r in recs:
        cold = f" (L2 flushed before each launch: {r['cold_ms']:.4f} ms)" if "cold_ms" in r else ""
        log(f"time {r['name']}: kernel {r['ms']:.4f} ms{cold}, twin {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library {r['library_ms']} "
            f"ms ({r['shape']}; {gpu})")


def compare(name, got, want) -> float:
    """Kernel output against its twin's, bitwise; returns the max abs error (0)."""
    if not torch.equal(got, want):
        diff = (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()
        raise AssertionError(f"{name}: kernel != twin (max abs diff {diff})")
    return 0.0


def compare_planes(name, got, want) -> float:
    """K5's plane stacks against its twin's: the same NaNs, and bitwise
    equal elsewhere."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{name}: NaN structure differs from the twin's")
    return compare(name, torch.nan_to_num(got), torch.nan_to_num(want))


def decimate(R: torch.Tensor, t: int) -> torch.Tensor:
    """[B, 8, H, W] responses -> the match program's int8 T-decimated planes
    (responses are 0..4: the int8 view holds the same values)."""
    from object_detector_6d_tpu_torch.match.program import decimate as mp_decimate

    H, W = R.shape[2:]
    return mp_decimate(R.view(torch.int8), t, -(-H // t), -(-W // t)).contiguous()


def odd_frames(x: torch.Tensor) -> torch.Tensor:
    """The first 2 frames at ODD_HW: one row cut, the last column repeated."""
    oh, ow = ODD_HW
    x = x[:2, :oh]
    return torch.cat([x, x[:, :, -1:]], dim=2)[:, :, :ow].contiguous()


def coarse_conv_ms(D, tables, oh: int, ow: int, want: torch.Tensor) -> float:
    """The library yardstick of K6, timed only: one cuDNN float32 conv2d
    (TF32 off) of the stacked planes with each template's features as a
    dense one-hot kernel, which computes K6's sum. It must equal K6."""
    plane, dr, dc, n = tables
    nT, F = plane.shape
    dev = D.device
    kh, kw = int(dr.max()) + 1, int(dc.max()) + 1
    live = torch.arange(F, device=dev)[None] < n[:, None]
    tid = torch.arange(nT, device=dev)[:, None].expand(nT, F)
    w = torch.zeros((nT, D.shape[1], kh, kw), dtype=torch.float32, device=dev)
    w.index_put_((tid[live], plane[live].long(), dr[live].long(), dc[live].long()),
                 torch.ones(int(live.sum()), device=dev), accumulate=True)
    Df = torch.nn.functional.pad(D.to(torch.float32), (
        0, max(0, ow + kw - 1 - D.shape[3]), 0, max(0, oh + kh - 1 - D.shape[2])))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = torch.nn.functional.conv2d(Df, w)[:, :, :oh, :ow]
        compare("coarse conv2d (library)", got.round().to(torch.int32), want)
        return cuda_ms(lambda: torch.nn.functional.conv2d(Df, w), reps=3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def coarse_main_inputs(dev, pd, rgbs_np, depths_np):
    """K6's arguments on the main path: the modalities' level-1 responses,
    decimated and stacked along the planes, the bank's coarse tables and
    the grid's size. Returns (D, tables, gh, gw)."""
    from object_detector_6d_tpu_torch.match.program import quantize_pyramids_batched
    from object_detector_6d_tpu_torch.ops import response

    det = pd.detector
    sources = [torch.as_tensor(rgbs_np, device=dev) if n == "ColorGradient" else
               torch.as_tensor(depths_np.astype(np.int32), device=dev)
               for n in det.modality_names]
    qs = quantize_pyramids_batched(sources, det.modality_names, 2, det.dn_params,
                                   det.cg_params)
    t1 = det.t_at_level[1]
    D = torch.cat([decimate(response.response_spread_batched(q, t1), t1) for q in qs[1]],
                  dim=1)
    gh, gw = qs[1][0].shape[1] // t1, qs[1][0].shape[2] // t1
    return D, pd.bank_tensors(det.get_bank())[0].coarse_tables, gh, gw


def coarse_record(D, tables, gh: int, gw: int) -> dict:
    """K6's record on D and the bank's coarse tables (its twin was compared
    by the caller): warm and L2-flushed times, the twin's, the bound and the
    cuDNN conv2d's time (library_ms; null, with the bytes logged, where its
    dense one-hot kernels would not fit in the card's free memory)."""
    from object_detector_6d_tpu_torch.ops import refine

    nT = tables[0].shape[0]
    kh, kw = int(tables[1].max()) + 1, int(tables[2].max()) + 1
    dense = 4 * nT * D.shape[1] * kh * kw
    free = torch.cuda.mem_get_info()[0]
    want = refine.coarse_sweep(D, *tables, gh, gw)
    if dense < free // 4:
        library = coarse_conv_ms(D, tables, gh, gw, want)
    else:
        library = None
        log(f"coarse_sweep at nT={nT}: no library time, the conv's dense one-hot kernels "
            f"would take {dense / 1e9:.2f} GB of {free / 1e9:.2f} GB free")
    out_bytes = 4 * D.shape[0] * nT * gh * gw
    bnd, by = bound_ms(D.numel() + sum(t.numel() * 4 for t in tables) + out_bytes,
                       int(tables[3].sum()) * D.shape[0] * gh * gw)
    return dict(
        name="coarse_sweep", route="cuda",
        source="object_detector_6d_tpu_torch/csrc/coarse_sweep.cu",
        replaces="object_detector_6d_tpu/ops/refine_pallas.py:162",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: refine.coarse_sweep(D, *tables, gh, gw)),
        cold_ms=cuda_ms_cold(lambda: refine.coarse_sweep(D, *tables, gh, gw)),
        plain_ms=cuda_ms(lambda: refine.coarse_sweep_plain(D, *tables, gh, gw), reps=5),
        shape=f"D {list(D.shape)} i8, tables {list(tables[0].shape)} -> "
              f"[{D.shape[0]},{nT},{gh},{gw}] i32",
        library_ms=library, bound_ms=bnd, bound_by=by)


def color_kernel_checks(dev, pd, rgbs_np, depths_np, gpu):
    """K1 and K6 against their twins on the card. Returns their records."""
    from object_detector_6d_tpu_torch.ops import quantize, refine
    from object_detector_6d_tpu_torch.quant.pyramid import pyr_down_u8

    det = pd.detector
    weak = det.cg_params.weak_threshold
    gray = torch.as_tensor(rgbs_np, device=dev)
    noise = np.random.RandomState(7).randint(-24, 25, rgbs_np.shape, dtype=np.int16)
    noisy = torch.as_tensor(np.clip(rgbs_np + noise, 0, 255).astype(np.uint8), device=dev)
    gray1 = pyr_down_u8(gray)
    for tag, x in (("gray", gray), ("noise", noisy)):
        for xx in (x, pyr_down_u8(x), odd_frames(x)):
            compare(f"cg_quantize {tag} {tuple(xx.shape)}",
                    quantize.cg_quantize_batched(xx, weak),
                    quantize.cg_quantize_plain(xx, weak))
    log(f"kernel cg_quantize_batched: equal to twin at {tuple(gray.shape)}, "
        f"{tuple(gray1.shape)} and {tuple(odd_frames(gray).shape)}, gray and noisy frames")
    recs = [dict(
        name="cg_quantize_batched", route="cuda",
        source="object_detector_6d_tpu_torch/csrc/cg_quantize.cu",
        replaces="object_detector_6d_tpu/ops/quantize_pallas.py:177",
        max_abs_err=0.0,
        ms=(cuda_ms(lambda: quantize.cg_quantize_batched(gray, weak))
            + cuda_ms(lambda: quantize.cg_quantize_batched(gray1, weak))),
        plain_ms=(cuda_ms(lambda: quantize.cg_quantize_plain(gray, weak), reps=5)
                  + cuda_ms(lambda: quantize.cg_quantize_plain(gray1, weak), reps=5)),
        shape=f"{list(gray.shape)} + {list(gray1.shape)} u8 -> u8", library_ms=None)]
    px = (gray.numel() + gray1.numel()) // 3
    recs[0]["bound_ms"], recs[0]["bound_by"] = bound_ms(
        gray.numel() + gray1.numel() + px, K1_INT * px, K1_FP * px)

    # K6 on the main path's stacked level-1 planes and the bank's tables
    D, tables, gh, gw = coarse_main_inputs(dev, pd, rgbs_np, depths_np)
    rng = np.random.RandomState(8)
    D_odd = torch.as_tensor(rng.randint(-128, 128, (2, D.shape[1], 31, 43)),
                            dtype=torch.int8, device=dev)
    for Dt, oh, ow in ((D, gh, gw), (D_odd, 29, 37)):
        compare(f"coarse_sweep {tuple(Dt.shape)} -> {oh}x{ow}",
                refine.coarse_sweep(Dt, *tables, oh, ow),
                refine.coarse_sweep_plain(Dt, *tables, oh, ow))
    log(f"kernel coarse_sweep: equal to twin at D {tuple(D.shape)} with tables "
        f"{tuple(tables[0].shape)} and at D {tuple(D_odd.shape)} of bytes -128..127")
    recs.append(coarse_record(D, tables, gh, gw))
    log_times(recs, gpu)
    return recs


def capture_calls(wrapper: str, run):
    """The arguments of every call of the kernel wrapper ``wrapper`` that
    match/program.py makes in run()."""
    from object_detector_6d_tpu_torch.match import program as mp

    calls = []
    real = getattr(mp, wrapper)

    def capture(*args):
        calls.append(args)
        return real(*args)

    setattr(mp, wrapper, capture)
    try:
        with torch.no_grad():
            run()
    finally:
        setattr(mp, wrapper, real)
    return calls


def _capture_args(dev, pd, depths_np, rgbs_np, K, wrapper: str, threshold=THRESHOLD):
    """The arguments of every call of the kernel wrapper ``wrapper`` in
    one call of ``pd``'s match program on these frames."""
    H, W = depths_np.shape[1:]
    prog, _ = pd.program(H, W, K)
    det = pd.detector
    d = torch.as_tensor(depths_np.astype(np.int32), device=dev)
    sources = [torch.as_tensor(rgbs_np, device=dev) if n == "ColorGradient" else d
               for n in det.modality_names]
    return capture_calls(wrapper, lambda: prog.match_program(
        sources, *pd.bank_tensors(det.get_bank())[0], threshold))


def capture_refine_args(dev, pd, depths_np, rgbs_np, K, threshold=THRESHOLD):
    """Every K4 launch's arguments (D and its tables, one per modality)."""
    return _capture_args(dev, pd, depths_np, rgbs_np, K, "refine_sweep_batched", threshold)


def capture_response_args(dev, pd, depths_np, rgbs_np, K):
    """Every K3 launch's (q, T): per modality, level 0 then level 1."""
    return _capture_args(dev, pd, depths_np, rgbs_np, K, "response_spread_batched")


def response_launcher(lib, calls, dev):
    """A function that launches K3's C entry point in ``lib`` on each
    captured (q, T), into outputs allocated once, without the wrapper, so
    that it times the kernel alone; and the outputs it writes."""
    from object_detector_6d_tpu_torch.match.response import dist_vals
    from object_detector_6d_tpu_torch.ops import kernels

    stream = kernels.stream_ptr(dev)
    vals = dist_vals()
    prepared = [(q.contiguous(), int(t),
                 torch.empty((q.shape[0], 8, *q.shape[1:]), dtype=torch.uint8, device=dev))
                for q, t in calls]

    def run():
        for q, t, out in prepared:
            kernels.check(lib.odc_response_spread(q.data_ptr(), out.data_ptr(), *q.shape, t,
                                                  *vals, stream), "response_spread")

    return run, [out for _, _, out in prepared]


def response_main_path_record(dev, pd, depths_np, rgbs_np, K, gpu):
    """K3 against its twin on the (q, T) of the two-modality match
    program's 4 launches (ColorGradient and DepthNormal images at both
    levels), timed through its C entry point. Returns its record."""
    from object_detector_6d_tpu_torch.ops import kernels, response

    calls = capture_response_args(dev, pd, depths_np, rgbs_np, K)
    for q, t in calls:
        compare(f"response_spread main path T={t} {tuple(q.shape)}",
                response.response_spread_batched(q, t), response.response_spread_plain(q, t))
    raw, outs = response_launcher(kernels.library(), calls, dev)
    raw()
    for (q, t), o in zip(calls, outs):
        compare("response_spread C entry", o, response.response_spread_plain(q, t))

    def plain():
        for q, t in calls:
            response.response_spread_plain(q, t)

    px = sum(q.numel() for q, _ in calls)
    bnd, by = bound_ms(9 * px, K3_INT * px)
    shape = (f"{len(calls)} launches: " + " + ".join(f"{list(q.shape)} T={t}" for q, t in calls)
             + " u8 -> [B,8,H,W] u8, the kernel alone")
    ms = cuda_ms(raw)
    # each launch alone, and the card's write rate on the same outputs
    # (one fill_ of each: 8 of the 9 bytes a pixel, no reads)
    each = [cuda_ms(response_launcher(kernels.library(), [c], dev)[0]) for c in calls]
    fill = cuda_ms(lambda: [o.fill_(1) for o in outs])
    log(f"kernel response_spread_batched: equal to twin on the two-modality main path's "
        f"(q, T) ({shape}); the kernel alone {ms:.4f} ms per batch (launches "
        f"{', '.join(f'{t:.4f}' for t in each)} ms); fill_ of its outputs {fill:.4f} ms; "
        f"{gpu}")
    return dict(
        name="response_spread_batched", route="cuda",
        source="object_detector_6d_tpu_torch/csrc/response_spread.cu",
        replaces="object_detector_6d_tpu/ops/response_pallas.py:76",
        max_abs_err=0.0, ms=ms, plain_ms=cuda_ms(plain, reps=5), bound_ms=bnd,
        bound_by=by, library_ms=None, shape=shape)


def refine_launcher(lib, calls, dev):
    """A function that launches K4's C entry point in ``lib`` on each
    captured call's arguments (converted once, here), without the
    wrapper's argument checks and host sync, so that it times the kernel
    alone; and the outputs it writes."""
    from object_detector_6d_tpu_torch.ops import kernels

    stream = kernels.stream_ptr(dev)
    prepared = []
    for D, plane, r0, c0, nfe in calls:
        a = [D.to(torch.int8).contiguous()] + [
            t.to(torch.int32).contiguous() for t in (plane, r0, c0, nfe)]
        out = torch.empty((D.shape[0], plane.shape[1], 16, 16), dtype=torch.int32, device=dev)
        prepared.append((a, out, (*D.shape, plane.shape[1], plane.shape[2])))

    def run():
        for a, out, dims in prepared:
            kernels.check(lib.odc_refine_sweep(*(t.data_ptr() for t in a), out.data_ptr(),
                                               *dims, stream), "refine_sweep")

    return run, [out for _, out, _ in prepared]


def refine_main_path_record(dev, pd, depths_np, rgbs_np, K, gpu):
    """K4's record on the arguments the two-modality match program passes
    it (one call of the match program, D [B,200,Hp2,Wp2] i8 and tables
    [B,16,F] per modality)."""
    return refine_record(dev, capture_refine_args(dev, pd, depths_np, rgbs_np, K), gpu,
                         "the two-modality main path's")


def refine_record(dev, calls, gpu, what: str):
    """K4 against its twin on captured match-program ``calls``, timed with
    the L2 warm (repeated launches) and cold (flushed before each launch).
    Returns its record."""
    from object_detector_6d_tpu_torch.ops import kernels, refine

    nbytes = int_ops = 0
    for D, plane, r0, c0, nfe in calls:
        compare(f"refine_sweep {what} {tuple(D.shape)} {tuple(plane.shape)}",
                refine.refine_sweep_batched(D, plane, r0, c0, nfe),
                refine.refine_sweep_plain(D, plane, r0, c0, nfe))
        # distinct bytes of D that the live tiles cover, the live table
        # entries (plane, r0, c0), nfeat and the int32 [B,K,16,16] output
        Bt, P, Hp, Wp = D.shape
        live = torch.arange(plane.shape[2], device=dev)[None, None] < nfe[..., None]
        bidx = torch.arange(Bt, device=dev)[:, None, None].expand_as(plane)[live]
        base = ((bidx * P + plane[live]) * Hp + r0[live]) * Wp + c0[live]
        ar = torch.arange(16, device=dev)
        idx = base[:, None, None] + ar[None, :, None] * Wp + ar[None, None, :]
        touched = torch.zeros(D.numel(), dtype=torch.bool, device=dev)
        touched[idx.reshape(-1).long()] = True
        n_live = int(live.sum())
        nbytes += int(touched.sum()) + 12 * n_live + 4 * nfe.numel() + 4 * 256 * nfe.numel()
        int_ops += 256 * n_live
        del touched, idx
    bnd, by = bound_ms(nbytes, int_ops)

    def both():
        for a in calls:
            refine.refine_sweep_batched(*a)

    def both_plain():
        for a in calls:
            refine.refine_sweep_plain(*a)

    raw, outs = refine_launcher(kernels.library(), calls, dev)
    raw()
    for a, o in zip(calls, outs):
        compare("refine_sweep C entry", o, refine.refine_sweep_plain(*a))
    warm = cuda_ms(raw)
    cold = cuda_ms_cold(raw)
    wrapped = cuda_ms(both)
    D0, plane0 = calls[0][0], calls[0][1]
    shape = (f"{len(calls)} launches: D {list(D0.shape)} i8, tables {list(plane0.shape)}, "
             f"{nbytes / 1e6:.2f} MB touched, {int_ops} adds")
    log(f"kernel refine_sweep_batched: equal to twin on {what} "
        f"arguments ({shape}); the kernel alone: warm L2 {warm:.4f} ms, cold L2 "
        f"{cold:.4f} ms per batch; through the wrapper (argument checks with a host "
        f"sync, warm) {wrapped:.4f} ms; {gpu}")
    return dict(
        name="refine_sweep_batched", route="cuda",
        source="object_detector_6d_tpu_torch/csrc/refine_sweep.cu",
        replaces="object_detector_6d_tpu/ops/refine_pallas.py:83",
        max_abs_err=0.0, ms=cold, cold_ms=cold,
        plain_ms=cuda_ms(both_plain, reps=5), bound_ms=bnd, bound_by=by,
        library_ms=None, shape=shape + ", the kernel alone, L2 flushed before each batch")


def select_record(dev, gpu):
    """K7 against its twin at the benchmark cell's grid, [128, 1202 x 30 x
    40] int32: -1 but for 28-55 values above the threshold a frame, and two
    frames that overflow the 64 slots. Timed with CUDA events beside its
    bound (one read of the grid), its twin, the stable torch.sort that
    computes the same function (library_ms) and torch.topk (logged; its tie
    order is not fixed). Returns its record."""
    from object_detector_6d_tpu_torch.ops import select

    rng = np.random.RandomState(21)
    Bs, N, k, vmax = 128, 1202 * 30 * 40, 64, 4 * 62
    x = torch.full((Bs, N), -1, dtype=torch.int32, device=dev)
    for b in range(Bs):
        n = 300 if b in (5, 77) else rng.randint(28, 56)
        cells = torch.as_tensor(rng.choice(N, n, replace=False), device=dev)
        x[b, cells] = torch.as_tensor(rng.randint(150, 180, n), dtype=torch.int32, device=dev)
    got = select.select_topk(x, k, vmax)
    want = select.select_topk_plain(x, k, vmax)
    for g, w in zip(got, want):
        compare(f"select_topk {tuple(x.shape)}", g, w)
    bnd, by = bound_ms(x.numel() * 4 + Bs * k * 12)
    sort_ms = cuda_ms(lambda: torch.sort(x, dim=-1, descending=True, stable=True), reps=3)
    topk_ms = cuda_ms(lambda: torch.topk(x, k, dim=-1, sorted=True), reps=5)
    rec = dict(
        name="select_topk", route="cuda",
        source="object_detector_6d_tpu_torch/csrc/select_topk.cu",
        replaces="none (object_detector_6d_tpu/match/program.py lax.top_k's order)",
        max_abs_err=0.0, ms=cuda_ms(lambda: select.select_topk(x, k, vmax)),
        plain_ms=cuda_ms(lambda: select.select_topk_plain(x, k, vmax), reps=3),
        bound_ms=bnd, bound_by=by, library_ms=sort_ms,
        shape=f"{list(x.shape)} i32, vmax {vmax} -> [{Bs},{k}] i32 + i64")
    log(f"kernel select_topk: equal to twin at {tuple(x.shape)}; kernel {rec['ms']:.4f} ms, "
        f"bound {bnd:.4f} ms by {by}, twin {rec['plain_ms']:.4f} ms, torch.sort stable "
        f"{sort_ms:.4f} ms, torch.topk {topk_ms:.4f} ms; {gpu}")
    del x
    return rec


def depth_kernel_checks(dev, depths_np, K, bank_args, fscene_main, gpu):
    """K2-K5 against their twins on the card. Returns their records."""
    from object_detector_6d_tpu_torch.ops import quantize, refine, response
    from object_detector_6d_tpu_torch.ops.geometry import FusedScene

    recs = []
    d_main = torch.as_tensor(depths_np.astype(np.int32), device=dev)
    H, W = d_main.shape[1:]
    oh, ow = ODD_HW
    d_odd = odd_frames(d_main)

    # K2 depth-normal quantize
    err = 0.0
    for d in (d_main, d_odd):
        err = max(err, compare(f"dn_quantize {tuple(d.shape)}",
                               quantize.dn_quantize_batched(d),
                               quantize.dn_quantize_plain(d)))
    q0 = quantize.dn_quantize_batched(d_main)
    recs.append(dict(
        name="dn_quantize_batched", route="cuda",
        source="object_detector_6d_tpu_torch/csrc/dn_quantize.cu",
        replaces="object_detector_6d_tpu/ops/quantize_pallas.py:320",
        max_abs_err=err,
        ms=cuda_ms(lambda: quantize.dn_quantize_batched(d_main)),
        plain_ms=cuda_ms(lambda: quantize.dn_quantize_plain(d_main), reps=5),
        shape=f"[{B},{H},{W}] i32 -> u8", library_ms=None))
    px = d_main.numel()
    recs[-1]["bound_ms"], recs[-1]["bound_by"] = bound_ms(5 * px, K2_INT * px, K2_FP * px)
    log(f"kernel dn_quantize_batched: equal to twin at {tuple(d_main.shape)} and "
        f"{tuple(d_odd.shape)}; {recs[-1]['ms']:.4f} ms per batch = "
        f"{100 * recs[-1]['bound_ms'] / recs[-1]['ms']:.1f}% of its bound; {gpu}")

    # K3 spread + response, level 0 (T=5) and level 1 (T=8) (exactness
    # only; its record comes from the two-modality main path's launches)
    q1 = q0[:, ::2, ::2].contiguous()
    q_odd = quantize.dn_quantize_batched(d_odd)
    for q, t in ((q0, 5), (q1, 8), (q_odd, 5), (q_odd, 8)):
        compare(f"response_spread T={t} {tuple(q.shape)}",
                response.response_spread_batched(q, t),
                response.response_spread_plain(q, t))
    log("kernel response_spread_batched: equal to twin at T=5 and T=8, main and odd sizes")

    # K4 refine sweep (exactness only; its record comes from the
    # two-modality main path's own arguments) on the depth-only D with
    # bank feature tables at random in-bounds anchors, some candidates
    # with zero features
    R0 = response.response_spread_batched(q0, 5)
    Hd, Wd = -(-H // 5), -(-W // 5)
    Hp2 = 1 << (max(Hd + 17, 32) - 1).bit_length()
    Wp2 = 1 << (max(Wd + 17, 128) - 1).bit_length()
    D = torch.nn.functional.pad(decimate(R0, 5), (0, Wp2 - Wd, 0, Hp2 - Hd)).contiguous()
    plane_b, dr_b, dc_b, n_b = (a[0] for a in bank_args.feat_arrays)
    rng = np.random.RandomState(1)
    nT = plane_b.shape[0]
    Kc = 16

    def tables(Dt, seed):
        r = np.random.RandomState(seed)
        Bt, _, Hp, Wp = Dt.shape
        tids = torch.as_tensor(r.randint(0, nT, (Bt, Kc)), device=dev)
        lim_r = Hp - 16 - int(dr_b.max())
        lim_c = Wp - 16 - int(dc_b.max())
        br = torch.as_tensor(r.randint(0, lim_r, (Bt, Kc, 1)), device=dev)
        bc = torch.as_tensor(r.randint(0, lim_c, (Bt, Kc, 1)), device=dev)
        nf = n_b[tids] * torch.as_tensor(r.rand(Bt, Kc) > 0.2, device=dev)
        return (plane_b[tids].contiguous(), (br + dr_b[tids]).to(torch.int32).contiguous(),
                (bc + dc_b[tids]).to(torch.int32).contiguous(), nf.to(torch.int32).contiguous())

    tb = tables(D, 2)
    D_odd = torch.as_tensor(rng.randint(0, 5, (2, 200, 97, 131)), dtype=torch.int8,
                            device=dev)
    for Dt, tt in ((D, tb), (D_odd, tables(D_odd, 3))):
        compare(f"refine_sweep {tuple(Dt.shape)}",
                refine.refine_sweep_batched(Dt, *tt), refine.refine_sweep_plain(Dt, *tt))
    log(f"kernel refine_sweep_batched: equal to twin at D {tuple(D.shape)} and "
        f"{tuple(D_odd.shape)}")

    # K5 fused geometry: bitwise equal to the twin (NaN == NaN)
    fs_odd = FusedScene(oh, ow, K, device=dev)
    for fs, d in ((fscene_main, d_main), (fs_odd, d_odd)):
        compare_planes(f"FusedScene {tuple(d.shape)}", fs(d), fs.plain(d))
    log(f"kernel FusedScene: equal to twin (cloud, normals, validity, NaN structure) at "
        f"{tuple(d_main.shape)} and {tuple(d_odd.shape)}")
    recs.append(dict(
        name="FusedScene", route="cuda",
        source="object_detector_6d_tpu_torch/csrc/fused_scene.cu",
        replaces="object_detector_6d_tpu/ops/geometry_pallas.py:183",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: fscene_main(d_main)),
        cold_ms=cuda_ms_cold(lambda: fscene_main(d_main)),
        plain_ms=cuda_ms(lambda: fscene_main.plain(d_main), reps=5),
        shape=f"[{B},{H},{W}] i32 -> [{B},8,{H},{W}] f32", library_ms=None))
    px = d_main.numel()
    recs[-1]["bound_ms"], recs[-1]["bound_by"] = bound_ms(
        (4 + 32) * px + (5 + 9) * 4 * H * W, 0, K5_FP * px)
    log_times(recs, gpu)
    return recs


def match_record(pd, depths, rgbs, K) -> torch.Tensor:
    """``pd``'s match program [B, 5, K+1] on its device, at THRESHOLD (rgbs
    None for a depth-only detector)."""
    det = pd.detector
    H, W = depths.shape[1:]
    src = [torch.as_tensor(rgbs, device=pd.device) if n == "ColorGradient" else
           torch.as_tensor(depths.astype(np.int32), device=pd.device)
           for n in det.modality_names]
    with torch.no_grad():
        return pd.program(H, W, K)[0].match_program(
            src, *pd.bank_tensors(det.get_bank())[0], THRESHOLD).cpu()


def match_card_vs_cpu(label, pd, depths, rgbs, K) -> torch.Tensor:
    """The match program's [B, 5, K+1] on the card equals the CPU's (the
    twins), bitwise, on every frame. Returns the card's record."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    card = match_record(pd, depths, rgbs, K)
    cpu = match_record(PoseDetector(detector=pd.detector, params=pd.params,
                                    model_points=pd.model_points, device="cpu"),
                       depths, rgbs, K)
    if not torch.equal(card, cpu):
        bad = (card != cpu).any(-1).any(-1).nonzero().flatten().tolist()
        raise AssertionError(f"[{label}] match program card != cpu in frames {bad}")
    log(f"[{label}] card vs cpu: match program {list(card.shape)} equal on all "
        f"{len(depths)} frames (n_above per frame {card[:, 0, -1].to(torch.int64).tolist()})")
    return card


def drive_path(label, pd, depths, rgbs, gts, K, counted, ref_found, ref_spurious, gpu,
               ref_objA_off=None):
    """The path's main run (launch counts from 0, ground-truth gates, ms
    per batch), then card against CPU on every frame, bitwise. objA must
    be on the truth in >= 90% of frames with no pose off it, or, where the
    reference itself misses (``ref_objA_off``: the frames where its objA
    is off the truth), off it in exactly those frames and on it in all
    others. Returns (launches, ms per batch)."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    results = pd.detect_fused_batch(depths, K, rgbs)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"[{label}] main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{label}] {name} was not launched by the main path")
    if pd.counters.counts.get("overflow_fallback", 0):
        raise AssertionError(f"[{label}] candidate overflow: a frame went through the "
                             "host-orchestrated fallback")
    found, spurious = ground_truth_stats(results, gts)
    per_class = {}
    for poses in results:
        for p in poses:
            per_class[p.class_id] = per_class.get(p.class_id, 0) + 1
    log(f"[{label}] detections over {B} frames: {per_class}; found within "
        f"{GT_T_M * 1e3:g} mm / {GT_DEG:g} deg: objA {found['objA']}/{B}, objB "
        f"{found['objB']}/{B} (reference {ref_found}); objB poses off "
        f"truth: {len(spurious['objB'])} (reference {ref_spurious}) "
        f"(frame, mm, deg): {spurious['objB']}")
    if ref_objA_off is not None:
        off = tuple(sorted({f for f, _, _ in spurious["objA"]}))
        log(f"[{label}] objA off truth (frame, mm, deg): {spurious['objA']}; the "
            f"reference's frames off truth: {ref_objA_off}")
        if off != tuple(ref_objA_off) or found["objA"] != B - len(ref_objA_off):
            raise AssertionError(f"[{label}] objA off truth in frames {off}, found in "
                                 f"{found['objA']}/{B}; the reference's off-truth frames "
                                 f"{ref_objA_off}, found in the other {B - len(ref_objA_off)}")
    elif spurious["objA"]:
        raise AssertionError(f"[{label}] objA poses off the ground truth (frame, mm, deg): "
                             f"{spurious['objA']}")
    elif found["objA"] < 0.9 * B:
        raise AssertionError(f"[{label}] objA found in {found['objA']}/{B} frames (< 90%)")
    if (abs(found["objB"] - ref_found) > OBJB_SLACK
            or abs(len(spurious["objB"]) - ref_spurious) > OBJB_SLACK):
        raise AssertionError(f"[{label}] objB: found {found['objB']}, off truth "
                             f"{len(spurious['objB'])}; the reference's "
                             f"{ref_found} / {ref_spurious} +- {OBJB_SLACK}")

    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd.detect_fused_batch(depths, K, rgbs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if pd.counters.counts.get("overflow_fallback", 0):
        raise AssertionError(f"[{label}] a timed batch went through the fallback")
    batch_ms = statistics.median(times[1:])
    log(f"[{label}] time detect_fused_batch: median {batch_ms:.2f} ms per B={B} batch "
        f"of 480x640 frames, numpy in (5 runs after 1 warm-up; {gpu}); runs "
        f"{[round(t, 2) for t in times]}")

    # card versus CPU (the twins): the match program, then the flat NMS
    # record and the Pose arrays of the whole path, bitwise on every frame
    # (every inexact float call of the port goes through core/exact.py,
    # every float sum of lift + ICP and the cluster stage through
    # core/reduce.py fixed_sum or an explicit order)
    match_card_vs_cpu(label, pd, depths, rgbs, K)
    card_vs_cpu_poses(label, pd, depths, rgbs, K)
    return launches, batch_ms


def card_vs_cpu_poses(label, pd, depths, rgbs, K):
    """``pd``'s flat NMS record and Pose arrays on the card == those of the
    same frames through a CPU PoseDetector, bitwise on every frame."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    cpu_pd = PoseDetector(detector=pd.detector, params=pd.params,
                          model_points=pd.model_points, device="cpu")
    cpu_pd.views = pd.views
    t0 = time.time()
    flat_card, got_card = flat_record(pd, depths, K, rgbs)
    flat_cpu, got_cpu = flat_record(cpu_pd, depths, K, rgbs)
    apart = []
    for b in range(len(depths)):
        if torch.equal(torch.nan_to_num(flat_card[b], nan=7e7),
                       torch.nan_to_num(flat_cpu[b], nan=7e7)) and \
                pose_bits(got_card[b]) == pose_bits(got_cpu[b]):
            continue
        gap = {}
        for cls in sorted({p.class_id for p in got_card[b] + got_cpu[b]}):
            c = [p for p in got_card[b] if p.class_id == cls]
            g = [p for p in got_cpu[b] if p.class_id == cls]
            gap[cls] = f"{len(c)} vs {len(g)} clusters" if len(c) != len(g) else round(max(
                [float(np.abs(a.pose[:3, 3] - q.pose[:3, 3]).max()) * 1e3
                 for a, q in zip(c, g)] + [0.0]), 6)
        apart.append((b, gap))
    if apart:
        raise AssertionError(f"[{label}] card != cpu in {len(apart)} of {len(depths)} frames "
                             f"(frame, per class mm or counts): {apart}")
    log(f"[{label}] card == cpu bitwise on all {len(depths)} frames: flat NMS record "
        f"{list(flat_card.shape)} and Pose arrays ({sum(map(len, got_card))} poses; "
        f"{time.time() - t0:.1f} s)")


def fallback_phase(pd, scenes, K, gpu):
    """Frames whose coarse candidates overflow the hypothesis slots, on the
    card: detect_fused_batch answers them through ``detect``."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
    from object_detector_6d_tpu_torch.ops import quantize, refine, response

    label = "fallback"
    depths, _, gts = make_frames(scenes, K, B, seed=SEED_FALLBACK)
    H, W = depths.shape[1:]
    det = pd.detector
    prog, K_cap = pd.program(H, W, K)
    with torch.no_grad():
        m = prog.match_program([torch.as_tensor(depths.astype(np.int32), device=pd.device)],
                               *pd.bank_tensors(det.get_bank())[0], THRESHOLD)
    n_above = m[:, 0, -1].to(torch.int64).tolist()
    fallen = [b for b, n in enumerate(n_above) if n > K_cap]
    if not fallen:
        raise AssertionError(f"[{label}] no frame of seed {SEED_FALLBACK} overflows "
                             f"{K_cap} slots (n_above {n_above})")
    before = pd.counters.counts.get("overflow_fallback", 0)
    results = pd.detect_fused_batch(depths, K)
    torch.cuda.synchronize()
    n_fb = pd.counters.counts.get("overflow_fallback", 0) - before
    if n_fb != len(fallen):
        raise AssertionError(f"[{label}] overflow_fallback rose by {n_fb}; frames {fallen} "
                             f"overflow {K_cap} slots")
    log(f"[{label}] detect_fused_batch on B={B} depth-only frames of seed {SEED_FALLBACK}: "
        f"frames {fallen} hold {[n_above[b] for b in fallen]} coarse candidates > {K_cap} "
        f"slots; overflow_fallback = {n_fb}, no exception")

    # the fallen-back frames' own gates
    fb_results = [results[b] for b in fallen]
    found, spurious = ground_truth_stats(fb_results, [gts[b] for b in fallen])
    if found["objA"] != len(fallen) or spurious["objA"]:
        raise AssertionError(f"[{label}] objA found in {found['objA']}/{len(fallen)} "
                             f"fallen-back frames; off truth {spurious['objA']}")
    # detect alone: its B=1 match launches the kernels; ms per frame
    counted = (quantize.dn_quantize_batched, response.response_spread_batched,
               refine.coarse_sweep, refine.refine_sweep_batched)
    times = []
    for b in fallen:
        for _ in range(3):
            for fn in counted:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alone = pd.detect(depths[b], K)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches = {fn.__name__: fn.launches for fn in counted}
            if min(launches.values()) <= 0:
                raise AssertionError(f"[{label}] detect's match launched {launches}")
            if [p.class_id for p in alone] != [p.class_id for p in results[b]]:
                raise AssertionError(f"[{label}] frame {b}: detect alone differs from the "
                                     "batch's fallback")
    log(f"[{label}] detect's B=1 match launches per frame: {launches}")
    log(f"[{label}] time detect: median {statistics.median(times):.2f} ms per fallen-back "
        f"480x640 frame ({len(times)} runs; {gpu}); runs {[round(t, 2) for t in times]}")

    # the same call on the CPU (the twins), on the fallen-back frames
    cpu_pd = PoseDetector(detector=det, params=pd.params, model_points=pd.model_points,
                          device="cpu")
    cpu_pd.views = pd.views
    got_cpu = cpu_pd.detect_fused_batch(depths[fallen], K)
    if cpu_pd.counters.counts.get("overflow_fallback", 0) != len(fallen):
        raise AssertionError(f"[{label}] the CPU run fell back on "
                             f"{cpu_pd.counters.counts.get('overflow_fallback', 0)} frames")
    worst_t = worst_r = 0.0
    for b, pc, pg in zip(fallen, got_cpu, fb_results):
        key = [(p.class_id, p.template_id, p.match_x, p.match_y) for p in pc]
        if key != [(p.class_id, p.template_id, p.match_x, p.match_y) for p in pg]:
            raise AssertionError(f"[{label}] frame {b}: cpu {key} vs card "
                                 f"{[(p.class_id, p.template_id, p.match_x, p.match_y) for p in pg]}")
        for a, c in zip(pc, pg):
            worst_t = max(worst_t, float(np.abs(a.pose[:3, 3] - c.pose[:3, 3]).max()))
            worst_r = max(worst_r, rot_deg(a.pose[:3, :3], c.pose[:3, :3]))
    if worst_t > XDEV_T_M or worst_r > XDEV_DEG:
        raise AssertionError(f"[{label}] card vs cpu: {worst_t * 1e3:.3f} mm, "
                             f"{worst_r:.3f} deg")
    log(f"[{label}] card vs cpu on frames {fallen}: same detections "
        f"({[len(p) for p in fb_results]} poses), max |dt| {worst_t * 1e3:.4f} mm, max "
        f"rotation {worst_r:.4f} deg; objA within {GT_T_M * 1e3:g} mm / {GT_DEG:g} deg of "
        f"the truth in {found['objA']}/{len(fallen)}")
    return depths, fallen


def match_fields(matches):
    return [(m.x, m.y, m.similarity, m.class_id, m.template_id) for m in matches]


def host_matcher_phase(dev, pd2, depths2, rgbs2, pd, fb_depths, fb_frame, gpu):
    """``Detector.match`` through the host-orchestrated matcher on the card.
    Returns {case: launches per call}."""
    from object_detector_6d_tpu_torch.ops import quantize, refine, response

    label = "host-matcher"
    common = (quantize.dn_quantize_batched, response.response_spread_batched,
              refine.coarse_sweep, refine.refine_sweep_batched)
    cases = (
        ("two-modality frame 0, fused=False", pd2.detector,
         pd2._sources(rgbs2[0], depths2[0]), dict(fused=False), None,
         (quantize.cg_quantize_batched,) + common),
        (f"depth-only frame {fb_frame}, capacity 4 -> MAX_FUSED_CANDIDATES 8",
         pd.detector, pd._sources(None, fb_depths[fb_frame]), dict(max_candidates=4), 8,
         common),
    )
    per_call = {}
    for case, det, src, kw, cap, counted in cases:
        if cap is not None:
            n_above = det._match_fused(src, THRESHOLD, None, 4, dev)
            if not isinstance(n_above, int) or n_above <= cap:
                raise AssertionError(f"[{label}] {case}: the ladder does not run out "
                                     f"({n_above} coarse candidates)")
            det.MAX_FUSED_CANDIDATES = cap
        try:
            for fn in counted:
                fn.launches = 0
            torch.cuda.synchronize()
            got = det.match(src, THRESHOLD, device=dev, **kw)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counted}
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                det.match(src, THRESHOLD, device=dev, **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            cpu = det.match(src, THRESHOLD, device="cpu", **kw)
        finally:
            if cap is not None:
                del det.MAX_FUSED_CANDIDATES
        log(f"[{label}] {case}: launches per call {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"[{label}] {case}: a kernel was not launched: {launches}")
        if not got:
            raise AssertionError(f"[{label}] {case}: no match at threshold {THRESHOLD}")
        if match_fields(got) != match_fields(cpu):
            raise AssertionError(f"[{label}] {case}: card {match_fields(got)} != cpu "
                                 f"{match_fields(cpu)}")
        fused = det._match_fused(src, THRESHOLD, None, 64, dev)
        if isinstance(fused, int):
            raise AssertionError(f"[{label}] {case}: the fused match overflows 64 ({fused})")

        def rounded(ms):
            return [(m.x, m.y, round(m.similarity, 3), m.class_id, m.template_id) for m in ms]

        if rounded(fused) != rounded(got):
            raise AssertionError(f"[{label}] {case}: fused {rounded(fused)} != host "
                                 f"{rounded(got)}")
        log(f"[{label}] {case}: {len(got)} matches, card == cpu exactly, == the fused "
            f"match at capacity 64; time {statistics.median(times):.2f} ms per call "
            f"(median of 3, after the counted call; {gpu}); runs "
            f"{[round(t, 2) for t in times]}")
        per_call[case] = launches
    return per_call


def multi_phase(pd2, depths2, rgbs2, K, gpu):
    """G=2 batches through the multi and many entry points against one
    ``detect_fused_batch`` per batch."""
    label = "multi"
    G = 2
    depths_g = np.stack([depths2, depths2[::-1]])
    rgbs_g = np.stack([rgbs2, rgbs2[::-1]])
    before = pd2.counters.counts.get("overflow_fallback", 0)

    def single():
        return [pd2.detect_fused_batch(depths_g[g], K, rgbs_g[g]) for g in range(G)]

    def multi():
        return pd2.detect_fused_finalize_multi(
            pd2.detect_fused_dispatch_multi(depths_g, K, rgbs_g))

    def many():
        return pd2.detect_fused_finalize_many(
            [pd2.detect_fused_dispatch(depths_g[g], K, rgbs_g[g]) for g in range(G)])

    want = single()
    worst = 0.0
    for name, fn in (("multi", multi), ("many", many)):
        got = fn()
        if len(got) != G:
            raise AssertionError(f"[{label}] {name}: {len(got)} batches")
        for g in range(G):
            for b, (pg, pw) in enumerate(zip(got[g], want[g])):
                kg = [(p.class_id, p.template_id, p.match_x, p.match_y) for p in pg]
                kw = [(p.class_id, p.template_id, p.match_x, p.match_y) for p in pw]
                if kg != kw:
                    raise AssertionError(f"[{label}] {name} batch {g} frame {b}: {kg} != {kw}")
                for a, c in zip(pg, pw):
                    worst = max(worst, float(np.abs(a.pose[:3, 3] - c.pose[:3, 3]).max()),
                                float(np.abs(a.pose[:3, :3] - c.pose[:3, :3]).max()))
    if worst > 1e-6:
        raise AssertionError(f"[{label}] poses differ from detect_fused_batch's by {worst}")
    if pd2.counters.counts.get("overflow_fallback", 0) != before:
        raise AssertionError(f"[{label}] a frame went through the fallback")
    times = {}
    for name, fn in (("detect_fused_batch x2", single), ("dispatch_multi + finalize_multi", multi),
                     ("2 dispatches + finalize_many", many)):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / G)
        times[name] = runs
    log(f"[{label}] G={G} batches of B={B}: multi and many == detect_fused_batch per batch "
        f"(same class, template, x, y; poses within {worst * 1e3:.6f} mm / {worst:.2e} in "
        f"the rotation's entries)")
    for name, runs in times.items():
        log(f"[{label}] time {name}: median {statistics.median(runs):.2f} ms per B={B} batch "
            f"(3 runs; {gpu}); runs {[round(t, 2) for t in runs]}")


def streaming_phase(dev, scenes, K, gpu):
    """The reference's four-camera tick through StreamingDetector. Returns
    its PoseDetector and the tick's depths and BGR frames."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
    from object_detector_6d_tpu_torch.api.streaming import StreamingDetector
    from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams
    from object_detector_6d_tpu_torch.ops import geometry, quantize, refine, response

    label = "streaming"
    params = DetectParams(match_threshold=65.0, max_hypotheses=4,
                          icp=ICPParams(iterations=45, num_levels=3))
    pd = PoseDetector(params=params, device=dev)
    dep, gray, mask = scenes.snowman_scene()
    if pd.add_view("obj", dep, K, mask.astype(np.uint8) * 255,
                   rgb=np.repeat(gray[..., None], 3, 2)) != 0:
        raise AssertionError(f"[{label}] add_view failed")
    truths = (np.array([0.03, -0.01, -0.02]), np.array([-0.04, 0.02, 0.03]), None,
              np.array([0.01, 0.03, -0.04]))
    depths, rgbs = [], []
    for t in truths:
        if t is None:  # an empty camera
            depths.append(np.full((480, 640), 1500, np.uint16))
            rgbs.append(np.full((480, 640, 3), 128, np.uint8))
        else:
            d2, _, g2 = scenes.render_translated(dep, mask, K, t)
            depths.append(d2)
            rgbs.append(np.repeat(g2[..., None], 3, 2))
    depths, rgbs = np.stack(depths), np.stack(rgbs)
    stream = StreamingDetector(pd, n_cameras=4)
    counted = (quantize.cg_quantize_batched, quantize.dn_quantize_batched,
               response.response_spread_batched, refine.coarse_sweep,
               refine.refine_sweep_batched, geometry.FusedScene)
    out = {}
    for entry in ("process", "process_host"):
        fn = getattr(stream, entry)
        for c in counted:
            c.launches = 0
        torch.cuda.synchronize()
        res = fn(depths, K, rgbs)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counted}
        if len(res) != 4 or res[2] != []:
            raise AssertionError(f"[{label}] {entry}: {len(res)} cameras, empty camera "
                                 f"{res[2] if len(res) > 2 else None}")
        errs = []
        for cam, t in enumerate(truths):
            if t is None:
                continue
            if not res[cam]:
                raise AssertionError(f"[{label}] {entry}: camera {cam} missed its detection")
            errs.append(float(np.abs(res[cam][0].pose[:3, 3] - t).max()))
        if max(errs) >= 0.012:
            raise AssertionError(f"[{label}] {entry}: translation errors {errs} m")
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(depths, K, rgbs)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        log(f"[{label}] {entry}: empty camera [], others within "
            f"{max(errs) * 1e3:.3f} mm of the truth; launches {launches}; time median "
            f"{statistics.median(runs):.2f} ms per 4-camera tick (3 runs; {gpu}); runs "
            f"{[round(t, 2) for t in runs]}")
        out[entry] = res
    pd_cpu = PoseDetector(detector=pd.detector, params=params, device="cpu")
    pd_cpu.views = pd.views
    cpu = StreamingDetector(pd_cpu, n_cameras=4).process_host(depths, K, rgbs)
    worst_t = worst_r = 0.0
    for cam, (pc, pg) in enumerate(zip(cpu, out["process_host"])):
        kc = [(p.class_id, p.template_id, p.match_x, p.match_y) for p in pc]
        kg = [(p.class_id, p.template_id, p.match_x, p.match_y) for p in pg]
        if kc != kg:
            raise AssertionError(f"[{label}] process_host camera {cam}: cpu {kc} vs card {kg}")
        for a, c in zip(pc, pg):
            worst_t = max(worst_t, float(np.abs(a.pose[:3, 3] - c.pose[:3, 3]).max()))
            worst_r = max(worst_r, rot_deg(a.pose[:3, :3], c.pose[:3, :3]))
    if worst_t > XDEV_T_M or worst_r > XDEV_DEG:
        raise AssertionError(f"[{label}] process_host card vs cpu: {worst_t * 1e3:.3f} mm, "
                             f"{worst_r:.3f} deg")
    log(f"[{label}] process_host card vs cpu: same detections, max |dt| "
        f"{worst_t * 1e3:.4f} mm, max rotation {worst_r:.4f} deg")
    return pd, depths, rgbs


def parity_phase(gpu):
    """parity_torch.py's base and occl sets at the promoted schedule on the
    card, against the oracle's goldens."""
    import contextlib
    import io

    import parity_torch

    label = "parity"
    records = []
    for config in ("base", "occl"):
        t0 = time.perf_counter()
        port = parity_torch.run_set(parity_torch.port_detector("promoted", "cuda"), config)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):  # the per-scene rows
            rec = parity_torch.summarize(config, "promoted", port)
        for line in buf.getvalue().splitlines():
            if line.startswith(f"[{config}"):
                log(f"[{label}] {line}")
        log(f"[{label}] {config}: {time.perf_counter() - t0:.1f} s for {rec['frames']} "
            f"scenes, training included ({gpu})")
        records.append(rec)
    parity_torch.table(records)
    low = [r["config"] for r in records if r["port"]["add_01d"] < r["oracle"]["add_01d"]]
    if low:
        raise AssertionError(f"[{label}] ADD-0.1d below the oracle's on {low}")


def snowman_model(scenes, K):
    """The reference test's object model (tests/test_templates.py): the
    snowman view's cloud + FALS normals, centred; and the centre."""
    from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d
    from object_detector_6d_tpu_torch.geom.normals import normals_fals

    dep, _, mask = scenes.snowman_scene()
    cloud_t = depth_to_3d(torch.as_tensor(dep.astype(np.int32)), K)
    cloud, nrm = cloud_t.numpy(), normals_fals(cloud_t, K).numpy()
    ok = mask & np.isfinite(cloud).all(-1) & np.isfinite(nrm).all(-1)
    pts = cloud[ok]
    center = pts.mean(0)
    return np.concatenate([pts - center, nrm[ok]], -1).astype(np.float32), center


def view_pose(t, w=(0.0, 0.0, 0.0)) -> np.ndarray:
    from object_detector_6d_tpu_torch.core.se3 import SE3

    T = SE3.exp(torch.tensor([*w, 0.0, 0.0, 0.0])).numpy().astype(np.float64)
    T[:3, 3] = t
    return T


def p99_deg(a, b) -> float:
    """99th percentile of the angle [deg] between unit normals [..., 3]."""
    dots = np.clip((a * b).sum(-1), -1.0, 1.0)
    return float(np.quantile(np.degrees(np.arccos(dots)), 0.99))


def template_fields(tps):
    return [[(t.width, t.height, t.pyramid_level, t.feature_array().tolist()) for t in tp]
            for tp in tps]


def offline_phase(dev, scenes, K, gpu):
    """Phase 10: train from a model, store and load the templates, and
    evaluate ADD on a synthetic BOP scene, on the card. Returns the
    kernels' launches over the phase."""
    import shutil

    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
    from object_detector_6d_tpu_torch.api.templates import render_view, train_from_model
    from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams
    from object_detector_6d_tpu_torch.data.bop import BopScene, make_synthetic_bop_scene
    from object_detector_6d_tpu_torch.eval.harness import evaluate_scene
    from object_detector_6d_tpu_torch.io import native, yaml_store
    from object_detector_6d_tpu_torch.io.ply import load_ply, write_ply
    from object_detector_6d_tpu_torch.ops import geometry, quantize, refine, response, select

    label = "offline"
    counted = (quantize.cg_quantize_batched, quantize.dn_quantize_batched,
               response.response_spread_batched, refine.coarse_sweep,
               refine.refine_sweep_batched, geometry.FusedScene, select.select_topk)
    for fn in counted:
        fn.launches = 0
    total = {fn.__name__: 0 for fn in counted}

    def take():
        for fn in counted:
            total[fn.__name__] += fn.launches
            fn.launches = 0

    work = ROOT / "build" / "smoke_offline"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    params = DetectParams(match_threshold=65.0, max_hypotheses=4,
                          icp=ICPParams(iterations=60, num_levels=3))

    # a. train
    model, center = snowman_model(scenes, K)
    views = [view_pose(center), view_pose(center, (0.10, 0, 0)), view_pose(center, (0, 0.10, 0))]
    trained, ms_view = {}, {}
    for d in (dev, "cpu"):
        for run in range(2):  # the second run, warm, is timed
            pd = PoseDetector(params=params, device=d)
            take()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tids = train_from_model(pd, "obj", model, K, views)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3 / len(views)
            if tids != [0, 1, 2]:
                raise AssertionError(f"[{label}] train_from_model on {d}: template ids {tids}")
            k1, k2 = quantize.cg_quantize_batched.launches, quantize.dn_quantize_batched.launches
            want = (2 * len(views), len(views)) if d == dev else (0, 0)
            if (k1, k2) != want:
                raise AssertionError(f"[{label}] training on {d} launched K1 {k1}x and K2 "
                                     f"{k2}x for {len(views)} views; expected {want}")
            ms_view[str(d)] = dt
        trained[str(d)] = pd
    take()
    card, cpu = trained[str(dev)], trained["cpu"]
    if template_fields(card.detector.class_templates["obj"]) != template_fields(
            cpu.detector.class_templates["obj"]):
        raise AssertionError(f"[{label}] templates trained on the card differ from the CPU's")
    worst_p = worst_n = 0.0
    for key, v in card.views.items():
        w = cpu.views[key]
        if v.bbox != w.bbox or not np.array_equal(np.isnan(v.model_cloud), np.isnan(w.model_cloud)):
            raise AssertionError(f"[{label}] view {key}: bbox or valid rows differ")
        ok = ~np.isnan(w.model_cloud[:, 0])
        worst_p = max(worst_p, float(np.abs(v.model_cloud[ok, :3] - w.model_cloud[ok, :3]).max()),
                      float(np.abs(v.anchor_point - w.anchor_point).max()))
        worst_n = max(worst_n, p99_deg(v.model_cloud[ok, 3:], w.model_cloud[ok, 3:]))
    if worst_p > 1e-6 or worst_n > 1.1:
        raise AssertionError(f"[{label}] view clouds card vs cpu: points {worst_p} m, "
                             f"normals p99 {worst_n} deg")
    # ms per view of add_view alone (the views rendered beforehand)
    rendered = [render_view(model, K, T, bg_mm=1500) for T in views]
    add_ms = {}
    for d in (dev, "cpu"):
        pd = PoseDetector(params=params, device=d)
        runs = []
        for dep, mask, gray in rendered * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pd.add_view("obj", dep, K, (mask * 255).astype(np.uint8),
                        rgb=np.repeat(gray[..., None], 3, axis=2))
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        add_ms[str(d)] = statistics.median(runs[len(rendered):])
    # the quantize part of a view alone: both pyramids (on the card K1 2x,
    # K2 1x and the magnitude; on the CPU the twins), images back on the host
    dep, mask, gray = rendered[0]
    sources = [np.repeat(gray[..., None], 3, axis=2), dep]
    quant_ms = {}
    for d in (dev, "cpu"):
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Detector()._build_pyramids(sources, (mask * 255).astype(np.uint8), torch.device(d))
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        quant_ms[str(d)] = statistics.median(runs[1:])
    take()
    log(f"[{label}] train_from_model: 3 views, templates card == cpu exactly "
        f"({card.detector.num_templates()} pyramids of "
        f"{[len(t.features) for t in card.detector.get_templates('obj', 0)]} features), "
        f"view points within {worst_p:.2e} m, normals p99 {worst_n:.4f} deg; K1 2x and K2 1x "
        f"per view on the card")
    log(f"[{label}] time train_from_model: {ms_view[str(dev)]:.2f} ms per view on the card, "
        f"{ms_view['cpu']:.2f} ms on the cpu (render included, warm); add_view alone "
        f"{add_ms[str(dev)]:.2f} / {add_ms['cpu']:.2f} ms per view (median of 3); its "
        f"quantize part (both pyramids) {quant_ms[str(dev)]:.2f} / {quant_ms['cpu']:.2f} ms "
        f"(median of 5 after 1; {gpu})")
    T_gt = view_pose(center + np.array([0.05, -0.02, -0.03]), (0.05, 0.02, 0))
    depth, _, gray = render_view(model, K, T_gt, bg_mm=1500)
    poses = card.detect(depth, K, rgb=np.repeat(gray[..., None], 3, 2))
    if not poses:
        raise AssertionError(f"[{label}] no detection on the novel view")
    best = poses[0].pose
    pts = model[::7, :3]
    err = float(np.linalg.norm(pts @ best[:3, :3].T + best[:3, 3]
                               - (pts @ T_gt[:3, :3].T + T_gt[:3, 3]), axis=-1).mean())
    if err >= 0.012:
        raise AssertionError(f"[{label}] novel view: mean model-point error {err:.4f} m")
    log(f"[{label}] detect on the novel view: mean model-point error {err * 1e3:.3f} mm")
    take()

    # b. store
    if native.get_lib() is None:
        raise AssertionError(f"[{label}] the native library did not build: "
                             f"{native.build_info.get('error')}")
    so = pathlib.Path(native.build_info["path"])
    if so.parent.parent != ROOT / "build" / "odc_native":
        raise AssertionError(f"[{label}] native library at {so}, not under build/odc_native")
    log(f"[{label}] native library: {so} ({native.build_info['seconds']:.2f} s)")
    fmt = str(work / "templates_%s.yml.gz")
    want = template_fields(card.detector.class_templates["obj"])
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        card.detector.write_classes(fmt)
        back = Detector()
        back.read_classes(["obj"], fmt)
        runs.append((time.perf_counter() - t0) * 1e3)
    path = fmt % "obj"
    nat = native.read_class_native(path)
    py = yaml_store.read_class(path)
    if nat is None or template_fields(nat[3]) != want or template_fields(py[3]) != want \
            or template_fields(back.class_templates["obj"]) != want:
        raise AssertionError(f"[{label}] the stored templates differ from the trained ones")
    card.detector.write(str(work / "detector.yml"))
    again = Detector.read(str(work / "detector.yml"))
    det = card.detector
    if (again.modality_names, again.t_at_level, again.cg_params, again.dn_params) != (
            det.modality_names, det.t_at_level, det.cg_params, det.dn_params):
        raise AssertionError(f"[{label}] Detector.write -> read changed the configuration")
    cloud = np.random.RandomState(0).uniform(-1, 1, (500, 6)).astype(np.float32)
    for binary in (True, False):
        p = str(work / f"cloud_{binary}.ply")
        write_ply(p, cloud, binary=binary)
        for name, got in (("load_ply", load_ply(p)), ("load_ply_native", native.load_ply_native(p))):
            if got is None or got.shape != cloud.shape or np.abs(got - cloud).max() > 1e-5:
                raise AssertionError(f"[{label}] {name} of a {'binary' if binary else 'ASCII'} "
                                     "PLY differs from the cloud written")
    log(f"[{label}] store: write_classes -> read_classes (native and Python readers) equal "
        f"to the trained templates; Detector.write -> read keeps the configuration; PLY "
        f"binary and ASCII within 1e-5; time {statistics.median(runs):.2f} ms per round "
        f"trip (median of 3; runs {[round(t, 2) for t in runs]})")

    # c. evaluate
    scene_dir = str(work / "bop_scene")
    make_synthetic_bop_scene(scene_dir, n_frames=3, obj_id=1, seed=0)
    scene = BopScene(scene_dir)
    pd = PoseDetector(params=params, device=dev)
    dep, gray, mask = scenes.snowman_scene()
    if pd.add_view("obj1", dep, K, mask.astype(np.uint8) * 255,
                   rgb=np.repeat(gray[..., None], 3, 2)) != 0:
        raise AssertionError(f"[{label}] add_view failed")
    model_pts = pd.views[("obj1", 0)].model_cloud[:, :3]
    take()
    res = evaluate_scene(pd, scene, {1: "obj1"}, {1: model_pts})
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    if min(launches.values()) <= 0:
        raise AssertionError(f"[{label}] evaluate_scene launched {launches}")
    if (res.n_gt, res.n_detected, res.add_accuracy) != (3, 3, 1.0) or not res.mean_add < 0.01:
        raise AssertionError(f"[{label}] evaluate_scene: {res}")
    timed = [evaluate_scene(pd, scene, {1: "obj1"}, {1: model_pts}) for _ in range(2)]
    take()
    frame = scene.frame(0)
    pd_cpu = PoseDetector(detector=pd.detector, params=params, device="cpu")
    pd_cpu.views = pd.views
    got = pd.detect_fused(frame.depth_u16, frame.K, rgb=frame.rgb)
    want = pd_cpu.detect_fused(frame.depth_u16, frame.K, rgb=frame.rgb)
    if [p.class_id for p in got] != [p.class_id for p in want] or not got:
        raise AssertionError(f"[{label}] frame 0: card {[p.class_id for p in got]} vs cpu "
                             f"{[p.class_id for p in want]}")
    worst_t = max(float(np.abs(a.pose[:3, 3] - c.pose[:3, 3]).max()) for a, c in zip(got, want))
    worst_r = max(rot_deg(a.pose[:3, :3], c.pose[:3, :3]) for a, c in zip(got, want))
    if worst_t > XDEV_T_M or worst_r > XDEV_DEG:
        raise AssertionError(f"[{label}] frame 0 card vs cpu: {worst_t * 1e3:.3f} mm, "
                             f"{worst_r:.3f} deg")
    take()
    log(f"[{label}] evaluate_scene on 3 synthetic BOP frames: n_gt {res.n_gt}, detected "
        f"{res.n_detected}, ADD-0.1d {res.add_accuracy}, mean ADD {res.mean_add * 1e3:.4f} mm; "
        f"launches {launches}; frame 0 card vs cpu {worst_t * 1e3:.4f} mm, {worst_r:.4f} deg")
    log(f"[{label}] time evaluate_scene: {1e3 / timed[-1].fps:.2f} ms per evaluated frame, "
        f"fps {timed[-1].fps:.3f} (second of two warm runs; first {timed[0].fps:.3f} fps; "
        f"PNG read and ADD included; {gpu})")
    shutil.rmtree(work, ignore_errors=True)
    return total


# ----------------------------------------------------------------------
# phase 11: geometry utilities, odometry, PPF (no hand kernel on this path)
# ----------------------------------------------------------------------

def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms per call over ``reps`` calls after one warm-up,
    the card synchronized around each (for calls that sync themselves)."""
    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def angles_deg(a, b) -> np.ndarray:
    """Angle [deg] between unit normals [..., 3] in float64 (atan2 of the
    cross and dot products: no arccos round-off near 1)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), (a * b).sum(-1)))


def golden(name: str):
    return np.load(ROOT / "tests" / "golden" / f"{name}.npz")


def pose_err(A, B):
    """(translation m, rotation deg) between two 4x4 poses."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    return float(np.linalg.norm(A[:3, 3] - B[:3, 3])), rot_deg(A[:3, :3], B[:3, :3])


def normals_card_vs_cpu(label, name, got, want):
    """Card == CPU bitwise, NaN == NaN (every float call of the normals
    goes through core/exact.py or one explicit order)."""
    got, want = got.cpu().numpy(), want.numpy()
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"[{label}] {name}: NaN masks differ card vs cpu")
    if not np.array_equal(np.nan_to_num(got), np.nan_to_num(want)):
        m = np.isfinite(want).all(-1) & np.isfinite(got).all(-1) & ~(want == 0).all(-1)
        ang = angles_deg(got[m], want[m])
        raise AssertionError(f"[{label}] {name}: card != cpu on "
                             f"{float((got != want).any(-1).mean()):.2e} of pixels, p99 "
                             f"{float(np.percentile(ang, 99)):.2e} max {float(ang.max()):.2e} deg")


def noisy_snowman(scenes) -> np.ndarray:
    """A Kinect-like noisy u16 frame: the snowman depth with the NIL
    model's axial noise sigma_z(z) and a few holes (seeded)."""
    dep, _, _ = scenes.snowman_scene()
    z = dep.astype(np.float64) / 1000.0
    rng = np.random.RandomState(11)
    noisy = dep + rng.normal(0.0, 1.0, dep.shape) * (0.0012 + 0.0019 * (z - 0.4) ** 2) * 1000
    noisy = np.clip(np.round(noisy), 0, 65535).astype(np.uint16)
    noisy[rng.rand(*dep.shape) < 0.01] = 0
    noisy[200:216, 300:340] = 0
    return noisy


def geometry_cleaner_checks(dev, scenes, label, gpu):
    from object_detector_6d_tpu_torch.geom.cleaner import clean_depth

    noisy = noisy_snowman(scenes)
    card = clean_depth(noisy, device=dev)
    cpu = clean_depth(noisy, device="cpu")
    if card.dtype != torch.uint16 or card.shape != (480, 640):
        raise AssertionError(f"[{label}] clean_depth: {card.dtype} {tuple(card.shape)}")
    d = np.abs(card.cpu().numpy().astype(int) - cpu.numpy().astype(int))
    share = float((d > 0).mean())
    # float input (metres) too: the filter's own float32 output
    zf = torch.as_tensor(noisy.astype(np.float32) / np.float32(1000.0))
    fcard, fcpu = clean_depth(zf.to(dev)).cpu().numpy(), clean_depth(zf).numpy()
    if d.max() > 0 or not np.array_equal(np.isnan(fcard), np.isnan(fcpu)) or \
            not np.array_equal(np.nan_to_num(fcard), np.nan_to_num(fcpu)):
        raise AssertionError(f"[{label}] clean_depth card != cpu: max {d.max()} mm on "
                             f"{share:.2e} of pixels; float output max "
                             f"{float(np.nanmax(np.abs(fcard - fcpu))):.2e} m")
    g = golden("cleaner")
    worst = []
    for case in ("rand", "snow", "holes"):
        got = clean_depth(g[case + "_in"], device=dev).cpu().numpy().astype(int)
        oracle = g[case + "_q"].astype(int)
        do = np.abs(got - oracle)[3:-3, 3:-3]
        m = oracle[3:-3, 3:-3] > 0
        if do[m].mean() >= 2.0 or do[m].max() > 5:
            raise AssertionError(f"[{label}] clean_depth {case} vs the oracle: mean "
                                 f"{do[m].mean():.2f} max {do[m].max()} mm")
        worst.append(f"{case} mean {do[m].mean():.3f} max {do[m].max()}")
    frame = torch.as_tensor(noisy, device=dev)
    ms = cuda_ms(lambda: clean_depth(frame))
    log(f"[{label}] clean_depth 480x640 u16 and float32: card == cpu bitwise; vs the oracle (mm): {'; '.join(worst)}; time {ms:.4f} ms per frame "
        f"(CUDA events; {gpu})")
    return {"clean_depth": ms}


def geometry_normals_checks(dev, label, gpu):
    from object_detector_6d_tpu_torch.geom import normals
    from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d

    times = {}
    g = golden("lmn_normals")
    K = g["K"]
    lines = []
    for case in ("sphere", "snowman", "rampxy", "holes"):
        card = normals.normals_linemod(g[case + "_in"], K, device=dev)
        cpu = normals.normals_linemod(g[case + "_in"], K, device="cpu")
        normals_card_vs_cpu(label, f"normals_linemod {case}", card, cpu)
        got, ref = card.cpu().numpy(), g[case + "_n"]
        zeros_ref = (ref == 0).all(-1) & ~np.isnan(ref).any(-1)
        if not (np.array_equal(np.isnan(got).any(-1), np.isnan(ref).any(-1)) and np.array_equal(
                (got == 0).all(-1) & ~np.isnan(got).any(-1), zeros_ref)):
            raise AssertionError(f"[{label}] normals_linemod {case}: masks differ from the oracle")
        m = np.isfinite(ref).all(-1) & ~zeros_ref
        ang = np.degrees(np.arccos(np.clip(np.abs((got[m] * ref[m]).sum(-1)), 0, 1)))
        if np.percentile(ang, 99) >= 0.2 or ang.mean() >= 0.05:
            raise AssertionError(f"[{label}] normals_linemod {case} vs the oracle: p99 "
                                 f"{np.percentile(ang, 99):.3f} mean {ang.mean():.3f} deg")
        lines.append(f"{case} oracle p99 {np.percentile(ang, 99):.4f}, card == cpu")
    dep = torch.as_tensor(g["snowman_in"], device=dev)
    times["normals_linemod"] = cuda_ms(lambda: normals.normals_linemod(dep, K))
    log(f"[{label}] normals_linemod (deg): {'; '.join(lines)}")

    g = golden("sri_normals")
    K = g["K"]
    lines = []
    for case in ("sphere", "snowman"):
        cloud = depth_to_3d(torch.as_tensor(g[case + "_in"].astype(np.int32), device=dev), K)
        cloud_cpu = cloud.cpu()
        card = normals.normals_sri(cloud, K)
        normals_card_vs_cpu(label, f"normals_sri {case}", card, normals.normals_sri(cloud_cpu, K))
        got, ref = card.cpu().numpy(), g[case + "_n"]
        both = np.isfinite(ref).all(-1) & np.isfinite(got).all(-1)
        inner = np.zeros_like(both)
        inner[8:-8, 8:-8] = True
        ang = np.degrees(np.arccos(np.clip(np.abs((ref * got).sum(-1)), 0, 1)[both & inner]))
        p50, p99o = np.percentile(ang, [50, 99])
        if p50 > 0.2 or p99o > 4.0 or np.isfinite(got).all(-1).mean() <= 0.999:
            raise AssertionError(f"[{label}] normals_sri {case} vs the oracle: p50 {p50:.3f} "
                                 f"p99 {p99o:.3f} deg")
        cross = normals.normals_cross(cloud)
        normals_card_vs_cpu(label, f"normals_cross {case}", cross,
                            normals.normals_cross(cloud_cpu))
        cc = cross.cpu().numpy()
        fin = np.isfinite(cc).all(-1)
        if fin.mean() < 0.99 or np.abs(np.linalg.norm(cc[fin], axis=-1) - 1).max() > 1e-5 or \
                (cc[fin][:, 2] > 0).any():
            raise AssertionError(f"[{label}] normals_cross {case}: not unit, camera-facing")
        lines.append(f"{case} sri oracle p50 {p50:.4f} p99 {p99o:.4f}; sri and cross card == "
                     f"cpu")
    times["normals_sri"] = cuda_ms(lambda: normals.normals_sri(cloud, K))
    times["normals_cross"] = cuda_ms(lambda: normals.normals_cross(cloud))
    log(f"[{label}] normals_sri / normals_cross (deg): {'; '.join(lines)}")
    log(f"[{label}] time 480x640: normals_linemod {times['normals_linemod']:.4f}, normals_sri "
        f"{times['normals_sri']:.4f}, normals_cross {times['normals_cross']:.4f} ms (CUDA "
        f"events; {gpu})")
    return times


def geometry_registration_checks(dev, scenes, K, label, gpu):
    from object_detector_6d_tpu_torch.core.se3 import SE3
    from object_detector_6d_tpu_torch.geom.registration import register_depth, warp_frame

    dep, gray, mask = scenes.snowman_scene()
    out = register_depth(dep, K, K, np.eye(4), (480, 640), device=dev).cpu().numpy()
    m = np.isfinite(out)
    rt_err = float(np.abs(out[m] - dep.astype(np.float32)[m] / 1000.0).max())
    if m.mean() <= 0.99 or rt_err > 1e-3:
        raise AssertionError(f"[{label}] register_depth identity: {m.mean():.4f} finite, "
                             f"max err {rt_err}")
    t = np.array([0.03, -0.01, -0.02], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    warped = warp_frame(dep, K, T, device=dev).cpu().numpy()
    ref_dep, ref_mask, _ = scenes.render_translated(dep, mask, K, t)
    both = ref_mask & np.isfinite(warped)
    frac = both.sum() / max(ref_mask.sum(), 1)
    med = float(np.median(np.abs(warped[both] - ref_dep[both].astype(np.float32) / 1000.0)))
    if frac <= 0.8 or med >= 2e-3:
        raise AssertionError(f"[{label}] warp_frame vs render_translated: {frac:.3f}, {med}")
    img = np.repeat(gray[..., None], 3, 2)
    Trt = SE3.exp(torch.tensor([0.05, -0.03, 0.02, 0.05, 0.01, -0.03])).numpy()
    worst = []
    for name, Rt in (("identity", np.eye(4)), ("translation", T), ("rigid", Trt)):
        pairs = [(register_depth(dep, K, K, Rt, (480, 640), device=d),) + tuple(
            warp_frame(dep, K, Rt, img, device=d)) for d in (dev, "cpu")]
        (rc, wc, ic), (rp, wp, ip) = [[x.cpu().numpy() for x in p] for p in pairs]
        for what, a, b in (("register_depth", rc, rp), ("warp_frame", wc, wp)):
            same_nan = float((np.isnan(a) == np.isnan(b)).mean())
            fin = np.isfinite(a) & np.isfinite(b)
            dz = float(np.abs(a[fin] - b[fin]).max())
            if same_nan < 1.0 or dz > 0.0:
                raise AssertionError(f"[{label}] {what} {name} card != cpu: NaN mask equal on "
                                     f"{same_nan:.5f}, max |dz| {dz}")
        img_same = float((ic == ip).all(-1).mean())
        if img_same < 1.0:
            raise AssertionError(f"[{label}] warp_frame image {name}: equal on {img_same:.5f}")
        worst.append(name)
    d_t = torch.as_tensor(dep.astype(np.int32), device=dev)
    i_t = torch.as_tensor(img, device=dev)
    ms_reg = cuda_ms(lambda: register_depth(d_t, K, K, Trt, (480, 640)))
    ms_warp = cuda_ms(lambda: warp_frame(d_t, K, Trt, i_t))
    log(f"[{label}] register_depth identity: {m.mean():.4f} finite, max err {rt_err:.2e} m; "
        f"warp_frame vs render_translated: {frac:.3f} of the object, median |dz| {med:.2e} m; "
        f"depth and BGR card == cpu bitwise for {', '.join(worst)}")
    log(f"[{label}] time 480x640: register_depth {ms_reg:.4f} ms, warp_frame (depth + BGR) "
        f"{ms_warp:.4f} ms (CUDA events; {gpu})")
    return {"register_depth": ms_reg, "warp_frame": ms_warp}


def plane_cloud(scenes, K):
    """tests/test_plane.py's two-planes scene: the snowman frame with a
    sloped strip at the left, as a [480, 640, 3] float32 numpy cloud, and
    the snowman's mask."""
    from object_detector_6d_tpu_torch.geom.backproject import depth_to_3d

    dep, _, mask = scenes.snowman_scene()
    yy, xx = np.mgrid[0:480, 0:640]
    dep = dep.copy()
    strip = xx < 120
    dep[strip] = (1200 + 0.8 * yy).astype(np.uint16)[strip]
    return depth_to_3d(torch.as_tensor(dep.astype(np.int32)), K).numpy(), mask


def geometry_plane_checks(dev, scenes, K, label, gpu):
    from object_detector_6d_tpu_torch.geom.plane import extract_planes

    cloud, mask = plane_cloud(scenes, K)
    pts = torch.as_tensor(cloud, device=dev)
    card = extract_planes(pts)
    cpu = extract_planes(pts.cpu())
    # the block fits are core/exact.py's eigh3 over fixed_sum covariances:
    # labels on every pixel and the coefficients bitwise
    if len(card.coefficients) < 2 or not np.array_equal(card.labels, cpu.labels) or \
            float_bits(torch.as_tensor(card.coefficients)).tolist() != \
            float_bits(torch.as_tensor(cpu.coefficients)).tolist():
        raise AssertionError(f"[{label}] extract_planes card != cpu: {len(card.coefficients)} "
                             f"planes (cpu {len(cpu.coefficients)}), labels equal on "
                             f"{float((card.labels == cpu.labels).mean()):.5f}")
    xx = np.mgrid[0:480, 0:640][1]
    labels_bg = card.labels[(~mask) & (xx >= 160)]
    main = np.bincount(labels_bg[labels_bg != 255], minlength=1).argmax()
    if (labels_bg == main).mean() <= 0.9:
        raise AssertionError(f"[{label}] extract_planes: background plane {main} covers "
                             f"{(labels_bg == main).mean():.3f}")
    ms = host_ms(lambda: extract_planes(pts))
    log(f"[{label}] extract_planes (two planes + the snowman): {len(card.coefficients)} planes, "
        f"labels on every pixel and coefficients card == cpu bitwise; time {ms:.2f} ms per "
        f"cloud (host clock, median of 3; {gpu})")
    return {"extract_planes": ms}


def geometry_odometry_checks(dev, scenes, K, label, gpu):
    from object_detector_6d_tpu_torch.odometry import odometry as odo

    times = {}
    lines = []
    for factory in (odo.ICPOdometry, odo.FastICPOdometry, odo.RgbdOdometry,
                    odo.RgbdICPOdometry):
        o = factory()
        rgb = o.method in ("Rgbd", "RgbdICP")
        # tests/test_odometry.py's pairs: the camera moves by t
        t = np.array([0.008, -0.004, 0.006]) if rgb else np.array([0.012, -0.007, 0.009])
        dep1, gray1, mask = scenes.snowman_scene()
        if rgb:
            yy, xx = np.mgrid[0:480, 0:640]
            gray1 = (127 + 90 * np.sin(xx / 17.0) * np.cos(yy / 23.0)).astype(np.uint8)
        dep2, _, gray2 = scenes.render_translated(dep1, mask | True, K, -t, bg_mm=0,
                                                  smooth_texture=rgb)
        imgs = [np.repeat(g[..., None], 3, 2) for g in (gray1, gray2)]
        Rts = {}
        for d in (dev, "cpu"):
            src = odo.OdometryFrame.create(dep1, K, image=imgs[0], device=d)
            dst = odo.OdometryFrame.create(dep2, K, image=imgs[1], device=d)
            ok, Rts[str(d)] = o.compute(src, dst)
            if not ok or len(src.clouds) != 4:
                raise AssertionError(f"[{label}] {o.method}: compute failed")
        Rt = Rts[str(dev)]
        et = float(np.abs(Rt[:3, 3] + t).max())
        er = pose_err(Rt, np.eye(4))[1]
        if et >= 0.004 or er >= 1.0:
            raise AssertionError(f"[{label}] {o.method}: t err {et * 1e3:.3f} mm, rotation "
                                 f"{er:.3f} deg")
        dt, dr = pose_err(Rt, Rts["cpu"])
        if not np.array_equal(Rt, Rts["cpu"]):
            raise AssertionError(f"[{label}] {o.method} card != cpu: {dt * 1e3:.4f} mm "
                                 f"{dr:.4f} deg")
        src = odo.OdometryFrame.create(dep1, K, image=imgs[0], device=dev)
        dst = odo.OdometryFrame.create(dep2, K, image=imgs[1], device=dev)
        times[o.method] = host_ms(lambda: o.compute(src, dst))
        lines.append(f"{o.method} t err {et * 1e3:.3f} mm, rotation {er:.4f} deg, card == cpu "
                     f"bitwise, {times[o.method]:.2f} ms")
    log(f"[{label}] odometry, 4 levels, iter_counts (7, 7, 7, 10), 480x640: "
        f"{'; '.join(lines)} per compute (host clock, median of 3; {gpu})")
    return {f"odometry {k}": v for k, v in times.items()}


def ppf_inputs(scenes):
    """PPF's model (the snowman, exact normals), the scene (the model moved
    by T, with 1 mm noise) and T."""
    from object_detector_6d_tpu_torch.core.se3 import SE3
    from object_detector_6d_tpu_torch.ppf.helpers import add_noise_pc, transform_pc_pose

    model = scenes.snowman_model()
    T = SE3.exp(torch.tensor([0.4, -0.3, 0.5, 0.06, -0.02, 0.54])).numpy()
    return model, add_noise_pc(transform_pc_pose(model, T), 0.001), T


def geometry_ppf_checks(dev, scenes, label, gpu):
    from object_detector_6d_tpu_torch.ppf import detector as ppf
    from object_detector_6d_tpu_torch.ppf.helpers import compute_normals_pc3d

    model, scene, T = ppf_inputs(scenes)
    dets = {}
    for d in (dev, "cpu"):
        dets[str(d)] = ppf.PPFDetector(device=d)
        dets[str(d)].train_model(model)
    det, cpu = dets[str(dev)], dets["cpu"]
    # the pair tables before sorting, card against CPU: every key, every
    # alpha and every pair's alpha vote bin (2 pi / (2 num_angles) wide)
    # equal, bitwise
    raw = [ppf._train_pairs(torch.as_tensor(det.model_sampled, device=d), det._dist_step(),
                            det.num_angles) for d in (dev, "cpu")]
    keys_same = float((raw[0][0].cpu() == raw[1][0]).float().mean())
    alphas = [r[1].cpu().numpy().astype(np.float64) for r in raw]
    alpha_diff = float(np.abs(alphas[0] - alphas[1]).max())
    width = 2 * np.pi / (2 * det.num_angles)
    bins_same = float((np.floor((alphas[0] + np.pi) / width)
                       == np.floor((alphas[1] + np.pi) / width)).mean())
    sorted_same = bool(np.array_equal(det._keys_sorted, cpu._keys_sorted)
                       and np.array_equal(det._vals_i, cpu._vals_i))
    alphas_same = bool(torch.equal(float_bits(raw[0][1].cpu()), float_bits(raw[1][1])))
    if keys_same < 1.0 or bins_same < 1.0 or not alphas_same or not sorted_same or \
            not np.array_equal(det.model_sampled, cpu.model_sampled):
        raise AssertionError(f"[{label}] PPF tables card vs cpu: keys equal on {keys_same}, "
                             f"alpha bins on {bins_same}, alphas bitwise {alphas_same} (max "
                             f"|diff| {alpha_diff:.2e} rad), sorted tables equal {sorted_same}")
    # PCA normals (knn + eigh3) of every 8th model point, card == cpu bitwise
    sub = model[::8, :3]
    nrm = [compute_normals_pc3d(sub, device=d).cpu() for d in (dev, "cpu")]
    if not torch.equal(float_bits(nrm[0]), float_bits(nrm[1])):
        raise AssertionError(f"[{label}] compute_normals_pc3d card != cpu: max "
                             f"{float((nrm[0] - nrm[1]).abs().max()):.2e}")
    poses = det.match(scene)
    if not poses:
        raise AssertionError(f"[{label}] PPF: no hypotheses")
    et, er = pose_err(poses[0].pose, T)
    if et >= 0.1 * det.model_diameter or er >= 25.0:
        raise AssertionError(f"[{label}] PPF best pose: {et * 1e3:.2f} mm, {er:.2f} deg")
    pc = cpu.match(scene)
    dt, dr = pose_err(poses[0].pose, pc[0].pose)
    ms_train = host_ms(lambda: det.train_model(model))
    ms_match = host_ms(lambda: det.match(scene))
    log(f"[{label}] PPF on the snowman model ({len(model)} points, {len(det.model_sampled)} "
        f"sampled, {len(det._keys_sorted)} pairs, diameter {det.model_diameter:.4f} m): "
        f"tables card vs cpu: pair keys equal on {keys_same:.7f}, alpha bins on "
        f"{bins_same:.7f}, alphas bitwise, sorted key and index tables equal "
        f"{sorted_same}; PCA normals of {len(sub)} points (k=12) bitwise; best pose {et * 1e3:.3f} mm "
        f"/ {er:.3f} deg from the truth ({poses[0].num_votes} votes), card vs cpu "
        f"{dt * 1e3:.4f} mm / {dr:.4f} deg; vote tables {det.vote_table_bytes} bytes a block; "
        f"time train {ms_train:.2f} ms, match {ms_match:.2f} ms (host clock, median of 3; {gpu})")
    return {"ppf train": ms_train, "ppf match": ms_match}


def geometry_phase(dev, scenes, K, counted, gpu):
    """Phase 11: the geometry utilities, odometry and PPF on the card at
    480x640, held against the truth, device="cpu" and the goldens. No hand
    kernel lies on this path: every count stays 0. Returns its times."""
    label = "geometry"
    for fn in counted:
        fn.launches = 0
    times = {}
    for step in (lambda: geometry_cleaner_checks(dev, scenes, label, gpu),
                 lambda: geometry_normals_checks(dev, label, gpu),
                 lambda: geometry_registration_checks(dev, scenes, K, label, gpu),
                 lambda: geometry_plane_checks(dev, scenes, K, label, gpu),
                 lambda: geometry_odometry_checks(dev, scenes, K, label, gpu),
                 lambda: geometry_ppf_checks(dev, scenes, label, gpu)):
        times.update(step())
    launches = {fn.__name__: fn.launches for fn in counted}
    if any(launches.values()):
        raise AssertionError(f"[{label}] a hand kernel was launched: {launches}")
    log(f"[{label}] kernel launches over the phase: {launches}")
    return times


# ----------------------------------------------------------------------
# phase 12: the raw and one-frame forms of the detect program, the
# modality front ends and one-frame wrappers, the windowed ICP association
# ----------------------------------------------------------------------

@contextlib.contextmanager
def uncounted(counted):
    """Launches inside the block do not count: each wrapper's count is put
    back on exit (the batched comparisons of the one-frame forms)."""
    saved = [fn.launches for fn in counted]
    try:
        yield
    finally:
        for fn, n in zip(counted, saved):
            fn.launches = n


def same_nan(name, got, want) -> None:
    """Tensors or arrays bitwise equal, NaN where NaN."""
    got, want = (torch.as_tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x))
                 for x in (got, want))
    (compare_planes if got.is_floating_point() else compare)(name, got, want)


def raw_forms_checks(dev, pd, depths, rgbs, K, counted):
    """Phase 12 a-c: raw, flat and one-frame forms of the program; the
    front ends and one-frame kernel wrappers against their batched forms."""
    from object_detector_6d_tpu_torch.api import detect_program as dp
    from object_detector_6d_tpu_torch.ops import quantize, refine, response
    from object_detector_6d_tpu_torch.quant.color_gradient import ColorGradient
    from object_detector_6d_tpu_torch.quant.depth_normal import DepthNormal

    label = "raw forms"
    Bn, H, W = depths.shape
    det = pd.detector
    bank = det.get_bank()
    bargs, views, _ = pd.bank_tensors(bank)
    nms = pd._nms_device_args(bank, K)
    d = torch.as_tensor(depths.astype(np.int32), device=dev)
    bgr = torch.as_tensor(rgbs, device=dev)
    src = [bgr if n == "ColorGradient" else d for n in det.modality_names]
    prod, K_cap = pd.program(H, W, K)

    # (a) raw and flat outputs of the batch, and the production record
    t0 = time.time()
    raw_prog = pd.build_program(H, W, K, batch=Bn)
    flat_prog = pd.build_program(H, W, K, batch=Bn, flat_output=True)
    one_prog = pd.build_program(H, W, K)
    log(f"[{label}] three programs built in {time.time() - t0:.2f} s (the one-off cost "
        f"of a new form: FusedScene's host f64 setup and upload)")
    record = prod(src, bargs, views, THRESHOLD, *nms)
    raw = raw_prog(src, bargs, views, THRESHOLD)
    flat = flat_prog(src, bargs, views, THRESHOLD)
    torch.cuda.synchronize()
    for name, got, want in zip(("packed", "poses", "res", "keep"),
                               dp.unflatten_outputs(flat.cpu().numpy(), K_cap), raw):
        same_nan(f"[{label}] unflatten_outputs(flat) {name} vs raw", got, want.cpu().numpy())
    same_nan(f"[{label}] make_cluster_stage(raw) vs the production record",
             dp.make_cluster_stage(K_cap)(*raw, nms[0], float(np.float32(nms[1])),
                                          float(np.float32(nms[2]))), record)
    keep = raw[3].cpu().numpy()
    log(f"[{label}] B={Bn}: unflatten_outputs(flat) == raw; make_cluster_stage(raw) == "
        f"the production record, bitwise; kept lanes per frame "
        f"{keep.sum(1).tolist()}")

    # (b) frame 0 through the one-frame program against row 0 of the batch
    one = one_prog([s[0] for s in src], bargs, views, THRESHOLD)
    same_nan(f"[{label}] one-frame packed vs batch row 0", one[0], raw[0][0])
    same_nan(f"[{label}] one-frame keep vs batch row 0", one[3], raw[3][0])
    same_nan(f"[{label}] one-frame poses vs batch row 0", one[1], raw[1][0])
    same_nan(f"[{label}] one-frame residuals vs batch row 0", one[2], raw[2][0])
    if not keep[0].any():
        raise AssertionError(f"[{label}] frame 0 kept no pose")
    log(f"[{label}] batch=None on frame 0 == row 0 of the batch, bitwise: packed, poses, "
        f"residuals and keep ({int(keep[0].sum())} kept)")

    # (c) the front ends and one-frame wrappers against the batched forms
    noise = np.random.RandomState(7).randint(-24, 25, rgbs[0].shape, dtype=np.int16)
    noisy = np.clip(rgbs[0] + noise, 0, 255).astype(np.uint8)
    weak = det.cg_params.weak_threshold
    cg = ColorGradient(det.cg_params, device=dev)
    dn = DepthNormal(det.dn_params, device=dev)
    q_cg = cg.quantize(rgbs[0])
    q_dn = dn.quantize(depths[0])
    q_noisy = cg.quantize(noisy)
    with uncounted(counted):
        same_nan(f"[{label}] ColorGradient.quantize gray", q_cg,
                 quantize.cg_quantize_batched(bgr, weak)[0])
        same_nan(f"[{label}] ColorGradient.quantize noisy", q_noisy,
                 quantize.cg_quantize_batched(torch.as_tensor(noisy, device=dev)[None],
                                              weak)[0])
        same_nan(f"[{label}] DepthNormal.quantize", q_dn, quantize.dn_quantize_batched(
            d, det.dn_params.distance_threshold, det.dn_params.difference_threshold)[0])
    spreads = [(q, t) for q in (q_cg, q_dn) for t in det.t_at_level]
    outs = [response.response_spread(q, t) for q, t in spreads]
    with uncounted(counted):
        for (q, t), got in zip(spreads, outs):
            same_nan(f"[{label}] response_spread T={t}", got,
                     response.response_spread_batched(q[None], t)[0])
    with uncounted(counted):  # the match program's own K4 arguments for frame 0
        Dk, plane, r0, c0, nfeat = capture_refine_args(dev, pd, depths[:1], rgbs[:1], K)[0]
    rng = np.random.RandomState(12)
    P, Hp, Wp = Dk.shape[1:]
    Kc, F = plane.shape[1:]
    rnd = [torch.as_tensor(rng.randint(0, hi, (Kc, F)), dtype=torch.int32, device=dev)
           for hi in (P, Hp - 15, Wp - 15)]
    s_main = refine.refine_sweep(Dk[0], plane[0], r0[0], c0[0], nfeat[0])
    s_all = refine.refine_sweep(Dk[0], *rnd)
    with uncounted(counted):
        same_nan(f"[{label}] refine_sweep (main-path tables)", s_main,
                 refine.refine_sweep_batched(Dk, plane, r0, c0, nfeat)[0])
        same_nan(f"[{label}] refine_sweep nfeat=None", s_all, refine.refine_sweep_batched(
            Dk[:1], *(t[None] for t in rnd), torch.full((1, Kc), F, dtype=torch.int32,
                                                         device=dev))[0])
        same_nan(f"[{label}] refine_sweep nfeat=None vs twin", s_all.cpu(),
                 refine.refine_sweep_plain(Dk[:1].cpu(), *(t[None].cpu() for t in rnd),
                                           torch.full((1, Kc), F, dtype=torch.int32))[0])
    log(f"[{label}] ColorGradient / DepthNormal.quantize of frame 0 (gray x3 and noisy "
        f"BGR) == row 0 of K1 / K2; response_spread at T={list(det.t_at_level)} on both "
        f"modalities and refine_sweep (the match program's frame-0 tables, and random "
        f"in-bounds tables with nfeat=None, F={F}) == their batched forms")


def windowed_detect_checks(dev, pd, depths, rgbs, gts, K, counted, gpu):
    """Phase 12 d-e: detect_fused_batch with the windowed ICP association
    at icp_window 96 and -1 (drive_path's gates), then ms per batch at 0,
    96 and -1 in turns, and the largest pose difference from the full
    gather. Returns {icp_window: launches}."""
    import dataclasses

    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector, resolve_icp_window

    H, W = depths.shape[1:]
    pds = {}
    launches = {}
    results = {}
    for iw in (0, 96, -1):
        if iw == 0:
            q = pd
        else:
            q = PoseDetector(detector=pd.detector, params=dataclasses.replace(
                pd.params, icp_window=iw), model_points=pd.model_points, device=dev)
            q.views = pd.views
            size = resolve_icp_window(iw, pd.detector.get_bank(), H, W)
            log(f"[window {iw}] resolved window: {size} px")
            # at 96 see REF2_W96_OBJA_OFF; -1 is 248 px on this bank, where
            # the records equal the full gather's
            cut = iw == 96
            launches[iw], _ = drive_path(
                f"window {iw}", q, depths, rgbs, gts, K, counted, REF2_OBJB_FOUND,
                REF2_OBJB_SPURIOUS, gpu, ref_objA_off=REF2_W96_OBJA_OFF if cut else None)
        pds[iw] = q
        results[iw] = q.detect_fused_batch(depths, K, rgbs)
    for iw in (96, -1):
        worst = {}  # class -> [clusters, max |dt| mm, max deg]
        for full, win in zip(results[0], results[iw]):
            by_key = {(p.class_id, p.template_id, p.match_x, p.match_y): p for p in full}
            for p in win:
                f = by_key.get((p.class_id, p.template_id, p.match_x, p.match_y))
                if f is None:
                    continue
                w = worst.setdefault(p.class_id, [0, 0.0, 0.0])
                w[0] += 1
                w[1] = max(w[1], float(np.abs(f.pose[:3, 3] - p.pose[:3, 3]).max()) * 1e3)
                w[2] = max(w[2], rot_deg(f.pose[:3, :3], p.pose[:3, :3]))
        log(f"[window {iw}] against the full gather (icp_window 0), clusters with the same "
            f"(class, template, x, y) per class (count, max |dt| mm, max deg): "
            f"{ {c: (n, round(t, 4), round(r, 4)) for c, (n, t, r) in sorted(worst.items())} }; "
            f"clusters {sum(map(len, results[0]))} (full) vs {sum(map(len, results[iw]))}")
    times = {iw: [] for iw in pds}
    for _ in range(6):  # in turns; the first round is the warm-up
        for iw, q in pds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.detect_fused_batch(depths, K, rgbs)
            torch.cuda.synchronize()
            times[iw].append((time.perf_counter() - t0) * 1e3)
    for iw, ts in times.items():
        log(f"[window {iw}] time detect_fused_batch: median {statistics.median(ts[1:]):.2f} "
            f"ms per B={len(depths)} batch (5 runs after 1 warm-up, in turns with the other "
            f"windows; {gpu}); runs {[round(t, 2) for t in ts]}")
    return launches


def raw_forms_phase(dev, pd, depths, rgbs, gts, K, counted, gpu):
    """Phase 12 on phase 3's two-modality detector and frames. Returns the
    phase's launches per kernel wrapper (comparison launches excluded)."""
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    raw_forms_checks(dev, pd, depths, rgbs, K, counted)
    forms = {fn.__name__: fn.launches for fn in counted}
    log(f"[raw forms] launches of the raw / flat / one-frame programs and the one-frame "
        f"forms: {forms}")
    windowed = windowed_detect_checks(dev, pd, depths, rgbs, gts, K, counted, gpu)
    total = {name: forms[name] + sum(w[name] for w in windowed.values()) for name in forms}
    for name, n in total.items():
        if n <= 0:
            raise AssertionError(f"[raw forms] {name} was not launched in phase 12")
    log(f"[raw forms] launches over the phase (the windowed main runs included): {total}")
    return total


# ----------------------------------------------------------------------
# phase 13: sharded (parallel/sharding.py) on phase 3's detector and
# frames: PoseDetector(mesh=) in a world of one (nccl, in this process) and
# in a world of two (spawned processes, gloo, both on the one card)
# ----------------------------------------------------------------------

SHARD_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pd_state(pd):
    """A PoseDetector's trained state, as pose_detector_from_state takes it."""
    from object_detector_6d_tpu_torch.io.convert import detector_dict, params_dict

    templates = {cid: [[(t.width, t.height, t.pyramid_level, t.feature_array()) for t in tp]
                       for tp in tps]
                 for cid, tps in pd.detector.class_templates.items()}
    views = {k: dict(model_cloud=v.model_cloud, bbox=v.bbox, anchor_point=v.anchor_point,
                     view_pose=v.view_pose)
             for k, v in pd.views.items()}
    return detector_dict(pd.detector), templates, views, params_dict(pd.params)


def counted_wrappers():
    from object_detector_6d_tpu_torch.ops import geometry, quantize, refine, response, select

    return (quantize.cg_quantize_batched, quantize.dn_quantize_batched,
            response.response_spread_batched, refine.coarse_sweep,
            refine.refine_sweep_batched, geometry.FusedScene, select.select_topk)


def counted_run(counted, fn):
    """fn() with every wrapper's count from 0; returns (fn's result, counts)."""
    for w in counted:
        w.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in counted}


def batch_times(pd, depths, K, rgbs, runs: int = 6, barrier=None):
    """ms of ``runs`` detect_fused_batch calls (the first is the warm-up)."""
    times = []
    for _ in range(runs):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd.detect_fused_batch(depths, K, rgbs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def pose_fields(results):
    return [[(p.class_id, p.template_id, p.pose, p.residual) for p in poses]
            for poses in results]


def world_of_one(dev, pd, depths, rgbs, K, gpu):
    """PoseDetector(mesh=make_mesh(1)) in this process over nccl: the
    sharded code path with its real collectives and nothing to merge; its
    flat NMS record equals the unsharded one bitwise. Returns its launches."""
    import torch.distributed as dist

    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
    from object_detector_6d_tpu_torch.parallel.sharding import make_mesh

    label = "sharded, world of one"
    counted = counted_wrappers()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device=dev)
        pd1 = PoseDetector(detector=pd.detector, params=pd.params, model_points=pd.model_points,
                           mesh=mesh, device=dev)
        pd1.views = pd.views
        pd1.detect_fused_batch(depths[:2], K, rgbs[:2])  # the bank on the card
        handle, launches = counted_run(counted, lambda: pd1.detect_fused_dispatch(depths, K, rgbs))
        log(f"[{label}] main path launches: {launches}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"[{label}] {name} was not launched by the main path")
        if not any(k[0] == "prog" and k[-2] is mesh for k in pd1._cache):
            raise AssertionError(f"[{label}] the batch did not take the sharded program")
        same_nan(f"[{label}] flat NMS record vs the unsharded one", handle[0],
                 pd.detect_fused_dispatch(depths, K, rgbs)[0])
        log(f"[{label}] flat NMS record [{len(depths)}, {handle[0].shape[-1]}] equal to the "
            "unsharded one, bitwise, on every frame")
        times = {"unsharded": [], "world of one": []}
        for _ in range(6):  # in turns; the first round is the warm-up
            times["unsharded"] += batch_times(pd, depths, K, rgbs, runs=1)
            times["world of one"] += batch_times(pd1, depths, K, rgbs, runs=1)
        for name, ts in times.items():
            log(f"[{label}] time detect_fused_batch {name}: median "
                f"{statistics.median(ts[1:]):.2f} ms per B={len(depths)} batch (5 runs after "
                f"1 warm-up, in turns; {gpu}); runs {[round(t, 2) for t in ts]}")
    finally:
        dist.destroy_process_group()
    return launches


def sharded_rank(rank, port, dev, state, frames, K, out_path):
    """One rank of the world of two (spawned; gloo; both ranks on ``dev``):
    PoseDetector(mesh=make_mesh(2)) from the parent's trained state, its
    launches on the main path, its match record, K6 at its template
    shard's shape against the twin, ms per batch; saved to ``out_path``."""
    import torch.distributed as dist

    from object_detector_6d_tpu_torch.io.convert import pose_detector_from_state
    from object_detector_6d_tpu_torch.ops import refine
    from object_detector_6d_tpu_torch.parallel.sharding import make_mesh

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        mesh = make_mesh(2, device=dev)
        mi = mesh.get_local_rank("model")
        pd = pose_detector_from_state(*state, model_points=512, mesh=mesh, device=dev)
        depths, rgbs = frames
        H, W = depths.shape[1:]
        pd.detect_fused_batch(depths[:2], K, rgbs[:2])  # the bank on the card
        counted = counted_wrappers()
        results, launches = counted_run(counted, lambda: pd.detect_fused_batch(depths, K, rgbs))
        bank = pd.detector.get_bank(pad_to=2)
        prog, _ = pd.program(H, W, K, bank, mesh)
        sources = [torch.as_tensor(rgbs, device=dev) if n == "ColorGradient" else
                   torch.as_tensor(depths.astype(np.int32), device=dev)
                   for n in pd.detector.modality_names]
        with torch.no_grad():
            match = prog.match_program(sources, *pd.bank_tensors(bank)[0],
                                       pd.params.match_threshold).cpu()
        # K6 at this rank's shape on the main path: every frame, one shard
        D, tables, gh, gw = coarse_main_inputs(dev, pd, rgbs, depths)
        n_local = tables[0].shape[0] // 2
        shard = tuple(t[mi * n_local:(mi + 1) * n_local] for t in tables)
        k6_err = compare(f"K6 at the template shard {tuple(D.shape)} x {n_local} templates",
                         refine.coarse_sweep(D, *shard, gh, gw),
                         refine.coarse_sweep_plain(D, *shard, gh, gw))
        times = batch_times(pd, depths, K, rgbs, barrier=dist.barrier)
        torch.save(dict(launches=launches, poses=pose_fields(results), match=match,
                        k6=(tuple(D.shape), n_local, k6_err), times=times,
                        programs=[k[-2] is mesh for k in pd._cache if k[0] == "prog"]),
                   out_path.format(rank=rank))
    finally:
        dist.destroy_process_group()


def world_of_two(dev, pd, depths, rgbs, K, gpu):
    """The world of two against the unsharded detector: the match record
    and every class's poses and residuals on every frame bitwise (a rank
    refines half of each frame's lanes; a lane's bits do not depend on the
    lanes beside it). Returns the launches per rank."""
    label = "sharded, world of two"
    out_dir = ROOT / "build" / "chip_smoke_sharded"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("rank*.pt"):
        f.unlink()
    out_path = str(out_dir / "rank{rank}.pt")
    ctx = torch.multiprocessing.start_processes(
        sharded_rank, args=(free_port(), dev, pd_state(pd), (depths, rgbs), K, out_path),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.time() + SHARD_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"[{label}] the world did not finish in {SHARD_TIMEOUT_S} s")
    ranks = [torch.load(out_path.format(rank=r), weights_only=False) for r in range(2)]

    H, W = depths.shape[1:]
    bank = pd.detector.get_bank()
    sources = [torch.as_tensor(rgbs, device=dev) if n == "ColorGradient" else
               torch.as_tensor(depths.astype(np.int32), device=dev)
               for n in pd.detector.modality_names]
    with torch.no_grad():
        match = pd.program(H, W, K)[0].match_program(
            sources, *pd.bank_tensors(bank)[0], pd.params.match_threshold).cpu()
    want = pose_fields(pd.detect_fused_batch(depths, K, rgbs))
    for r, got in enumerate(ranks):
        log(f"[{label}] rank {r} main path launches: {got['launches']}")
        for name, n in got["launches"].items():
            if n <= 0:
                raise AssertionError(f"[{label}] rank {r}: {name} was not launched")
        if got["programs"] != [True]:
            raise AssertionError(f"[{label}] rank {r}: programs built {got['programs']}")
        same_nan(f"[{label}] rank {r} match record vs the unsharded one", got["match"], match)
        shape, n_local, err = got["k6"]
        log(f"[{label}] rank {r}: K6 at D {shape} x {n_local} templates == its twin "
            f"(max abs err {err})")
        apart = [b for b, (g, w) in enumerate(zip(got["poses"], want))
                 if [(c, t, p.tobytes(), res) for c, t, p, res in g]
                 != [(c, t, p.tobytes(), res) for c, t, p, res in w]]
        if apart:
            raise AssertionError(f"[{label}] rank {r}: frames {apart} differ from the "
                                 "unsharded ones (class, template, pose or residual bits)")
        log(f"[{label}] rank {r}: match record [{len(depths)}, 5, {match.shape[-1]}] and every "
            f"class's poses and residuals on all {len(depths)} frames (objB included) equal "
            f"to the unsharded ones, bitwise ({sum(len(g) for g in want)} poses)")
        ts = got["times"]
        log(f"[{label}] rank {r} time detect_fused_batch: median "
            f"{statistics.median(ts[1:]):.2f} ms per B={len(depths)} batch (5 runs after 1 "
            f"warm-up, the ranks started together; {gpu}); runs {[round(t, 2) for t in ts]}")
    return [got["launches"] for got in ranks]


def sharded_phase(dev, pd, depths, rgbs, K, gpu):
    """Phase 13. Returns the launches per kernel wrapper over its main runs
    (the world of one and both ranks of the world of two)."""
    one = world_of_one(dev, pd, depths, rgbs, K, gpu)
    two = world_of_two(dev, pd, depths, rgbs, K, gpu)
    return {name: one[name] + sum(r[name] for r in two) for name in one}


# ----------------------------------------------------------------------
# phase 14: limits, on phase 3's frames and schedule: a template taller
# than the frame less two borders, more than MAX_F features a template
# (K4 and K6 in chunks) and a spread T above MAX_T (K3)
# ----------------------------------------------------------------------

TALL_HW = (300, 410)  # (w, h): taller than 480 - 2 * 40
WIDE_BBOX_PX = 320  # 600 features 6 px apart fit a 256-384 px template
WIDE_FEATURES = 600
T_WIDE = (5, 20)


def frame_template(dev, det, rgbs, depths, x0, y0, w, h, n0, seed, flip=0.0):
    """A template pyramid cut from frame 0's own quantized images, both
    modalities and levels: n0 / n0 // 2 features drawn (seeded) from the
    non-zero orientations of its [x0, x0 + w] x [y0, y0 + h] box at level
    0 (half of it at level 1), with their labels (a ``flip`` fraction of
    them turned to the opposite orientation), so that it scores near 100%
    at frame 0's coarse cell (y0 // 16, x0 // 16) and enters its top-K
    at bench.py's threshold. x0, y0: multiples of 16."""
    from object_detector_6d_tpu_torch.match.program import quantize_pyramids_batched
    from object_detector_6d_tpu_torch.quant.features import Feature, Template

    sources = [torch.as_tensor(rgbs[:1], device=dev) if n == "ColorGradient" else
               torch.as_tensor(depths[:1].astype(np.int32), device=dev)
               for n in det.modality_names]
    qs = quantize_pyramids_batched(sources, det.modality_names, 2, det.dn_params,
                                   det.cg_params)
    rng = np.random.RandomState(seed)
    tps = []
    for lvl, (s, n) in enumerate(((1, n0), (2, n0 // 2))):
        for q in qs[lvl]:
            box = q[0, y0 // s:(y0 + h) // s + 1, x0 // s:(x0 + w) // s + 1].cpu().numpy()
            ys, xs = np.nonzero(box)
            pick = rng.choice(len(ys), n, replace=len(ys) < n)
            labels = np.log2(box[ys[pick], xs[pick]]).astype(int)
            labels[rng.rand(n) < flip] += 4  # the opposite orientation
            labels %= 8
            tps.append(Template(w // s, h // s, lvl, [Feature(int(x), int(y), int(lb)) for
                                                      x, y, lb in zip(xs[pick], ys[pick], labels)]))
    return tps


def limits_detector(dev, pd, t_at_level=None):
    """A PoseDetector from ``pd``'s trained state (templates, views,
    schedule), with another pyramid T when given."""
    from object_detector_6d_tpu_torch.io.convert import pose_detector_from_state

    det_state, templates, views, params = pd_state(pd)
    if t_at_level is not None:
        det_state = {**det_state, "t_at_level": list(t_at_level)}
    return pose_detector_from_state(det_state, templates, views, params, model_points=512,
                                    device=dev)


def limits_edge(dev, pd, depths, rgbs, gts, K, counted, gpu):
    """14a: bench's bank plus one template taller than the frame less two
    borders, cut from frame 0. Returns (its PoseDetector, launches)."""
    from object_detector_6d_tpu_torch.match import program as mp

    label = "limits edge"
    q = limits_detector(dev, pd)
    w, h = TALL_HW
    # a tenth of its labels flipped keeps it to a few live slots in 12 of 32
    # frames (all of its features true, it is live in every frame, at up to
    # 8 cells, and the 16 slots overflow); the frames' largest candidate
    # count goes from 11 to 12
    tall = frame_template(dev, q.detector, rgbs, depths, 0, 0, w, h, 63, seed=14, flip=0.1)
    q.detector.add_synthetic_template(tall, "tall")
    bank = q.detector.get_bank()
    tall_id = bank.class_ids.index("tall")
    bargs = q.bank_tensors(bank)[0]
    log(f"[{label}] bank of {bank.num_templates} templates: bench's and one {w}x{h} px "
        f"template (frame 0's orientations, 63 + 63 / 31 + 31 features) taller than "
        f"480 - 80 px; largest level-0 cell offset {int(mp.bank_max_dr(bargs.feat_arrays))}")
    launches, _ = drive_path(label, q, depths, rgbs, gts, K, counted, REF2_OBJB_FOUND,
                             REF2_OBJB_SPURIOUS, gpu)
    card = match_record(q, depths, rgbs, K)  # == the CPU's (drive_path)
    # the tall template's live slots, and where their sweep started
    n_above = card[:, 0, -1].to(torch.int64)
    K_cap = card.shape[-1] - 1
    live = torch.arange(K_cap)[None] < n_above[:, None]
    slots = (live & (card[:, 3, :-1] == tall_id)).nonzero().tolist()
    if not slots:
        raise AssertionError(f"[{label}] the {h} px template entered no frame's top-K")
    calls = capture_refine_args(dev, q, depths, rgbs, K)
    D, _plane, r0, c0, _n = calls[0]
    dr0, dc0 = bargs.feat_arrays[1][0][tall_id, 0], bargs.feat_arrays[2][0][tall_id, 0]
    H, W = depths.shape[1:]
    t0 = q.detector.t_at_level[0]
    # y2 = min(max(., border), H - h - border) is H - h - border (< the
    # border) at every coarse row, so the base row is negative; the sweep
    # starts where the reference's dynamic_slice starts it
    base_r = (H - h - 8 * t0) // t0 - 8
    Hp2 = D.shape[2]
    start_r = min(base_r + Hp2, Hp2 - 16 - int(mp.bank_max_dr(bargs.feat_arrays)))
    starts = sorted({(int(r0[b, k, 0] - dr0), int(c0[b, k, 0] - dc0)) for b, k in slots})
    if base_r >= 0 or {r for r, _ in starts} != {start_r}:
        raise AssertionError(f"[{label}] base row {base_r}, sweep starts {starts}, "
                             f"expected row {start_r}")
    log(f"[{label}] {len(slots)} live slots of the {h} px template (frame, slot): "
        f"{slots[:8]}; its base row {base_r} < 0, its sweep started at (row, column) "
        f"{starts} of planes {list(D.shape[2:])} (the reference's dynamic_slice start)")
    return q, launches


def limits_chunks(dev, depths, rgbs, K, counted):
    """14b: synthetic templates of 600 / 300 features (and one cut from
    frame 0, so that a 600-feature template is live), objA and objB: K4
    and K6 in chunks of MAX_F. Returns (its PoseDetector, launches)."""
    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank
    from object_detector_6d_tpu_torch.ops import refine

    label = "limits chunks"
    det = synthetic_bank(n_classes=2, per_class=2, bbox_px=WIDE_BBOX_PX,
                         num_features=WIDE_FEATURES, seed=0, detector=Detector())
    det.add_synthetic_template(frame_template(dev, det, rgbs, depths, 160, 64, 320, 320,
                                              WIDE_FEATURES, seed=15), "wide")
    q = train(det, dev, scenes_module(), K)
    bank = det.get_bank()
    F0 = max(a.shape[1] for a in bank.feat_plane)
    F1 = bank.coarse[0].shape[1]
    want = {"refine_sweep_batched": 2 * -(-F0 // refine.MAX_F),
            "coarse_sweep": -(-F1 // refine.MAX_F)}
    q.detect_fused_batch(depths[:2], K, rgbs[:2])  # the bank on the card
    _, launches = counted_run(counted, lambda: q.detect_fused_dispatch(depths, K, rgbs))
    log(f"[{label}] {bank.num_templates} templates, level-0 tables {F0} wide, coarse "
        f"{F1}; main path launches {launches} (chunks of {refine.MAX_F})")
    for name, n in launches.items():
        if n <= 0 or n != want.get(name, n):
            raise AssertionError(f"[{label}] {name} launched {n} times, expected "
                                 f"{want.get(name, '> 0')}")
    card = match_card_vs_cpu(label, q, depths, rgbs, K)
    with uncounted(counted):
        for i, (D, plane, r0, c0, n) in enumerate(capture_refine_args(dev, q, depths, rgbs, K)):
            before = refine.refine_sweep_batched.launches
            got = refine.refine_sweep_batched(D, plane, r0, c0, n)
            chunks = refine.refine_sweep_batched.launches - before
            compare(f"[{label}] K4 call {i} in {chunks} chunks vs one twin call", got.cpu(),
                    refine.refine_sweep_plain(*(t.cpu() for t in (D, plane, r0, c0, n))))
        D, tables, gh, gw = coarse_main_inputs(dev, q, rgbs, depths)
        before = refine.coarse_sweep.launches
        got = refine.coarse_sweep(D, *tables, gh, gw)
        k6_chunks = refine.coarse_sweep.launches - before
        compare(f"[{label}] K6 in {k6_chunks} chunks vs one twin call", got.cpu(),
                refine.coarse_sweep_plain(D.cpu(), *(t.cpu() for t in tables), gh, gw))
    keep = card[:, 4, :-1] > 0
    log(f"[{label}] K4 ({chunks} chunks a call) and K6 ({k6_chunks} chunks) on the match "
        f"program's own arguments == one twin call over all features, bitwise; kept slots "
        f"{int(keep.sum())}")
    return q, launches


def limits_spread(dev, pd, depths, rgbs, K, counted):
    """14c: phase 3's templates at t_at_level (5, 20): K3 at T=20 (spread
    over 5, then the kernel at 16). Returns (its PoseDetector, launches)."""
    from object_detector_6d_tpu_torch.ops import response

    label = "limits spread"
    q = limits_detector(dev, pd, T_WIDE)
    q.detect_fused_batch(depths[:2], K, rgbs[:2])  # the bank on the card
    _, launches = counted_run(counted, lambda: q.detect_fused_dispatch(depths, K, rgbs))
    log(f"[{label}] t_at_level {T_WIDE}: main path launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{label}] {name} was not launched by the main path")
    match_card_vs_cpu(label, q, depths, rgbs, K)
    with uncounted(counted):
        calls = capture_response_args(dev, q, depths, rgbs, K)
        ts = sorted({t for _, t in calls})
        if ts != sorted(T_WIDE):
            raise AssertionError(f"[{label}] spreads at {ts}")
        for qq, t in calls:
            compare(f"[{label}] K3 T={t} {tuple(qq.shape)}",
                    response.response_spread_batched(qq, t).cpu(),
                    response.response_spread_plain(qq.cpu(), t))
    log(f"[{label}] K3 at T={ts} on the match program's own quantized images == the twin, "
        f"bitwise (T=20: the plain spread over 5, then the kernel at {response.MAX_T})")
    return q, launches


def limits_phase(dev, pd, depths, rgbs, gts, K, counted, gpu):
    """Phase 14. Returns the launches per kernel wrapper over its three
    main runs."""
    runs = {"phase 3": pd}
    total = {fn.__name__: 0 for fn in counted}
    for name, case in (
            ("edge", lambda: limits_edge(dev, pd, depths, rgbs, gts, K, counted, gpu)),
            ("chunks", lambda: limits_chunks(dev, depths, rgbs, K, counted)),
            ("spread", lambda: limits_spread(dev, pd, depths, rgbs, K, counted))):
        t1 = time.time()
        runs[name], launches = case()
        for k, n in launches.items():
            total[k] += n
        log(f"[limits {name}] {time.time() - t1:.1f} s")
    times = {name: [] for name in runs}
    for _ in range(6):  # in turns; the first round is the warm-up
        for name, q in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.detect_fused_dispatch(depths, K, rgbs)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    for name, ts in times.items():
        log(f"[limits] time {name}: median {statistics.median(ts[1:]):.2f} ms per "
            f"B={len(depths)} batch through detect_fused_dispatch to the device's end (5 "
            f"runs after 1 warm-up, in turns; {gpu}); runs {[round(t, 2) for t in ts]}")
    return total


# ----------------------------------------------------------------------
# phase 15: batch invariance, on phases 3's and 4's detectors and frames,
# phase 7's multi batches, phase 8's tick: a frame's answer on the card
# is the same bits whatever batch it came in (every float sum of the
# projective ICP is core/reduce.py fixed_sum; tests/test_torch_batch_size.py)
# ----------------------------------------------------------------------

BATCH_FRAMES = (0, 1, 31)
# batches holding frames 0, 1 and 31 at positions 0, 1 and 31 and at the
# ends of batches of 2 and 4
BATCH_SLICES = (slice(0, 2), slice(0, 4), slice(30, 32), slice(28, 32), slice(0, 32))


def flat_record(pd, depths, K, rgbs):
    """One detect_fused_dispatch: its flat NMS record on the host and the
    finalized Pose lists."""
    handle = pd.detect_fused_dispatch(depths, K, rgbs)
    return handle[0].cpu(), pd.detect_fused_finalize(handle)


def pose_bits(poses):
    """A frame's Pose list as exact values: ids, match, votes, residual and
    the pose's bytes."""
    return [(p.class_id, p.template_id, p.match_x, p.match_y, p.num_votes,
             p.match_similarity, p.residual, p.pose.tobytes()) for p in poses]


def alone_vs_batches(label, pd, depths, rgbs, K):
    """Frames 0, 1 and 31 alone, in B = 2 and 4 (at the start, and for 31
    at the end) and at positions 0, 1 and 31 of the B = 32 batch: the flat
    record's rows and the Pose lists equal bitwise."""
    def part(a, s):
        return None if a is None else a[s]

    alone = {f: flat_record(pd, depths[f:f + 1], K, part(rgbs, slice(f, f + 1)))
             for f in BATCH_FRAMES}
    held = []
    for s in BATCH_SLICES:
        flat, poses = flat_record(pd, depths[s], K, part(rgbs, s))
        for f in BATCH_FRAMES:
            if s.start <= f < s.stop:
                pos = f - s.start
                same_nan(f"[{label}] frame {f} at position {pos} of B={s.stop - s.start}: "
                         "flat record vs the frame alone", flat[pos], alone[f][0][0])
                if pose_bits(poses[pos]) != pose_bits(alone[f][1][0]):
                    raise AssertionError(f"[{label}] frame {f} at position {pos} of B="
                                         f"{s.stop - s.start}: Pose arrays != the frame alone")
                held.append((f, s.stop - s.start, pos))
    classes = {f: [p.class_id for p in alone[f][1][0]] for f in BATCH_FRAMES}
    log(f"[{label}] frames alone == in the batch, bitwise (flat record and Pose arrays), "
        f"(frame, B, position): {held}; detections alone {classes}")


def multi_vs_batches(pd2, depths2, rgbs2, K):
    """Phase 7's G=2 multi batches (the frames, then reversed): each batch's
    flat record and Poses == detect_fused_batch of the same 32 frames, and
    the reversed batch's row 31 - f == the first batch's row f, bitwise."""
    label = "batch, multi"
    depths_g = np.stack([depths2, depths2[::-1]])
    rgbs_g = np.stack([rgbs2, rgbs2[::-1]])
    handle = pd2.detect_fused_dispatch_multi(depths_g, K, rgbs_g)
    flats = [h[0].cpu() for h in handle[1]]
    got = pd2.detect_fused_finalize_multi(handle)
    for g in range(2):
        flat, poses = flat_record(pd2, depths_g[g], K, rgbs_g[g])
        same_nan(f"[{label}] batch {g}: flat record vs detect_fused_batch's", flats[g], flat)
        if [pose_bits(p) for p in got[g]] != [pose_bits(p) for p in poses]:
            raise AssertionError(f"[{label}] batch {g}: Poses != detect_fused_batch's")
    n = len(depths2)
    same_nan(f"[{label}] the reversed batch's rows vs the first batch's",
             flats[1].flip(0), flats[0])
    log(f"[{label}] G=2 dispatch_multi: each batch == detect_fused_batch of its {n} frames "
        f"and every frame at position f == at position {n - 1} - f, bitwise")


def tick_vs_alone(pd, depths, rgbs, K):
    """Phase 8's tick: each camera of StreamingDetector.process == its
    frame alone, bitwise (the empty camera included)."""
    from object_detector_6d_tpu_torch.api.streaming import StreamingDetector

    label = "batch, streaming"
    res = StreamingDetector(pd, n_cameras=len(depths)).process(depths, K, rgbs)
    flat, _ = flat_record(pd, depths, K, rgbs)
    for cam in range(len(depths)):
        one, alone = flat_record(pd, depths[cam:cam + 1], K, rgbs[cam:cam + 1])
        same_nan(f"[{label}] camera {cam}: flat record vs the frame alone", flat[cam], one[0])
        if pose_bits(res[cam]) != pose_bits(alone[0]):
            raise AssertionError(f"[{label}] camera {cam}: Poses != the frame alone")
    log(f"[{label}] {len(depths)}-camera tick: every camera == its frame alone, bitwise "
        f"(detections per camera {[len(r) for r in res]})")


def trace_ops(pd, depths, rgbs, K):
    """Device operations (kernels, copies, fills) launched inside each
    detect.* span of one detect_fused_batch, from a torch.profiler trace:
    ({span: count}, {trace event category: count})."""
    spans, cats = trace_spans(lambda: pd.detect_fused_batch(depths, K, rgbs))
    return {name: ops for name, (ops, _, _) in spans.items()}, cats


def trace_spans(fn):
    """One call of fn() under torch.profiler, with the port's spans
    switched on for it (``profiling.enable(True)``; they are off by
    default): for each detect.* span, the device operations (kernels,
    copies, fills) launched inside it, its host ms and the device ms of
    those operations; and the count of trace events by category. ({span:
    (ops, host ms, device ms)}, {category: count})."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from object_detector_6d_tpu_torch.utils import profiling

    # a package from before the spans could be switched (batch_probe.py
    # --root) has them always on
    switch = getattr(profiling, "enable", None)
    was = profiling.enabled() if switch else True
    if switch:
        switch(True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        if switch:
            switch(was)
            profiling.take_spans()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    spans = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name")).startswith("detect.")]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {name: [0, 0.0, 0.0] for name, _, _ in spans}
    for name, t0, t1 in spans:
        out[name][1] += (t1 - t0) / 1e3
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ts = launched.get(e.get("args", {}).get("correlation"))
            for name, t0, t1 in spans:
                if ts is not None and t0 <= ts <= t1:
                    out[name][0] += 1
                    out[name][2] += e.get("dur", 0) / 1e3
    return {k: tuple(v) for k, v in out.items()}, cats


def batch_phase(dev, pd2, depths2, rgbs2, pd, depths, tick, K, counted, gpu):
    """Phase 15. Returns the launches per kernel wrapper over its runs."""
    for fn in counted:
        fn.launches = 0
    alone_vs_batches("batch, two-modality", pd2, depths2, rgbs2, K)
    alone_vs_batches("batch, depth-only", pd, depths, None, K)
    multi_vs_batches(pd2, depths2, rgbs2, K)
    tick_vs_alone(*tick, K)
    times = batch_times(pd2, depths2, K, rgbs2)
    ops, cats = trace_ops(pd2, depths2, rgbs2, K)
    launches = {fn.__name__: fn.launches for fn in counted}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[batch] {name} was not launched in phase 15")
    log(f"[batch] time detect_fused_batch: median {statistics.median(times[1:]):.2f} ms per "
        f"B={len(depths2)} two-modality batch (5 runs after 1 warm-up; {gpu}); runs "
        f"{[round(t, 2) for t in times]}")
    log(f"[batch] device operations per span of one batch (torch.profiler): {ops}; lift + "
        f"ICP {ops.get('detect.lift_icp')}; trace event categories {cats}; {gpu}")
    return launches


# ----------------------------------------------------------------------
# phase 16: colour frames, whose three BGR channels differ (every other
# phase runs gray x3, where K1's channel argmax ties everywhere):
# tests/test_torch_limits_frame.py::test_colour_frames_equal_reference's
# snowman frames and view
# ----------------------------------------------------------------------

T_COLOUR = (np.array([0.055, -0.022, -0.04]), np.array([-0.03, 0.04, 0.02]))


def colour(gray):
    """[H, W] u8 gray -> [H, W, 3] u8 BGR: blue the gray, green a dimmer
    gray, red a gray with a sinusoidal pattern of its own."""
    yy, xx = np.mgrid[:gray.shape[0], :gray.shape[1]]
    g = gray.astype(np.float64)
    red = 0.8 * g + 45 * np.sin(xx / 9.0) * np.cos(yy / 13.0) + 30
    return np.clip(np.stack([g, 0.55 * g + 60, red], -1), 0, 255).astype(np.uint8)


def colour_phase(dev, scenes, K, counted, gpu):
    """Phase 16: the snowman trained by add_view on a coloured view on the
    card and on the CPU (templates equal exactly), the match record of two
    coloured 480x640 frames card == CPU bitwise, their Pose arrays card ==
    CPU bitwise and on the truth. Returns the launches."""
    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    label = "colour"
    dep, gray, mask = scenes.snowman_scene()
    rendered = [scenes.render_translated(dep, mask, K, t) for t in T_COLOUR]
    depths = np.stack([r[0] for r in rendered])
    bgrs = np.stack([colour(r[2]) for r in rendered])
    for fn in counted:
        fn.launches = 0
    card, cpu = (PoseDetector(detector=Detector(), params=train_params(), model_points=512,
                              device=d) for d in (dev, "cpu"))
    for pd in (card, cpu):
        if pd.add_view("obj", dep, K, mask.astype(np.uint8) * 255, rgb=colour(gray)) != 0:
            raise AssertionError(f"[{label}] add_view on {pd.device} failed")
    if template_fields(card.detector.class_templates["obj"]) != \
            template_fields(cpu.detector.class_templates["obj"]):
        raise AssertionError(f"[{label}] add_view templates card != cpu")
    match_card_vs_cpu(label, card, depths, bgrs, K)
    got = card.detect_fused_batch(depths, K, bgrs)
    launches = {fn.__name__: fn.launches for fn in counted}
    want = cpu.detect_fused_batch(depths, K, bgrs)
    views_same = all(np.array_equal(card.views[k].model_cloud, cpu.views[k].model_cloud,
                                    equal_nan=True)
                     and np.array_equal(card.views[k].anchor_point, cpu.views[k].anchor_point)
                     for k in card.views)
    worst_t = 0.0
    for b, (pg, pc) in enumerate(zip(got, want)):
        if [p.class_id for p in pg] != [p.class_id for p in pc] or not pg:
            raise AssertionError(f"[{label}] frame {b}: {[p.class_id for p in pg]} (cuda) vs "
                                 f"{[p.class_id for p in pc]} (cpu)")
        if np.abs(pg[0].pose[:3, 3] - T_COLOUR[b]).max() > GT_T_M:
            raise AssertionError(f"[{label}] frame {b}: the snowman off its truth")
        for a, c in zip(pg, pc):
            worst_t = max(worst_t, float(np.abs(a.pose[:3, 3] - c.pose[:3, 3]).max()))
    if [pose_bits(x) for x in got] != [pose_bits(x) for x in want]:
        raise AssertionError(f"[{label}] Pose arrays card != cpu: max |dt| {worst_t * 1e3:.6f} "
                             f"mm; add_view's model clouds and anchors card == cpu {views_same}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{label}] {name} was not launched")
    tps = card.detector.class_templates["obj"]
    log(f"[{label}] add_view on a coloured view: {len(tps)} pyramid(s) of {len(tps[0])} "
        f"templates card == cpu exactly; {len(depths)} coloured frames: the snowman on its "
        f"truth, Pose arrays card == cpu bitwise (add_view's model clouds and anchors card == "
        f"cpu {views_same}); launches {launches}; {gpu}")
    return launches


# ----------------------------------------------------------------------
# phase 17: device: the card gives the CPU's answer. Every inexact float32
# call of the port goes through core/exact.py (the correctly rounded
# result, the same on both devices), every float sum of lift + ICP and the
# cluster stage through core/reduce.py fixed_sum or an explicit order
# ----------------------------------------------------------------------

SQRT_CHUNK = 1 << 27
HELPER_INPUTS = 1 << 24


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as int32, every NaN as one value (NaN == NaN)."""
    return torch.where(torch.isnan(x), torch.tensor(0x7FC00000, dtype=torch.int32),
                       x.contiguous().view(torch.int32))


def helper_inputs(rng, n: int):
    """Seeded float32 inputs over the ranges the detect path and the tooling
    give each helper, plus +-0, a subnormal, +-inf and NaN."""
    def pos_bits(k):  # positive finite float32 of every exponent
        return rng.integers(0, 0x7F800000, k, dtype=np.int64).astype(np.uint32).view(np.float32)

    def wide(k):  # +- log-uniform over 1e-30 .. 1e4
        return (rng.choice([-1.0, 1.0], k) * 10.0 ** rng.uniform(-30, 4, k)).astype(np.float32)

    h = n // 2
    special = np.array([0.0, -0.0, 1e-45, np.inf, -np.inf, np.nan, 1e-32, 1e-20], np.float32)
    f = np.float32
    return {
        "sqrt_rn": [np.concatenate([rng.uniform(0, 4, h).astype(f), pos_bits(h), special])],
        "sincos_rn": [np.concatenate([rng.uniform(0, 2 * np.pi, h).astype(f),
                                      (10.0 ** rng.uniform(-8, 0, h)).astype(f), special])],
        "exp_rn": [np.concatenate([rng.uniform(-120, 1, n).astype(f), special])],
        "arccos_rn": [np.concatenate([rng.uniform(-1, 1, n).astype(f), special])],
        "atan2_rn": [np.concatenate([rng.standard_normal(n).astype(f), special, special]),
                     np.concatenate([rng.standard_normal(n).astype(f), special, special[::-1]])],
        "fma_rn": [wide(n), wide(n), wide(n)],
        "norm3": [np.concatenate([rng.standard_normal((h, 3)).astype(f),
                                  wide(3 * h).reshape(h, 3)])],
        "norm4": [np.concatenate([rng.standard_normal((h, 4)).astype(f),
                                  wide(4 * h).reshape(h, 4)])],
        "fma_matmul": [wide(3 * (n // 8)).reshape(-1, 1, 3),
                       rng.standard_normal((3, 3)).astype(f)],
    }


def device_helpers(dev, gpu):
    """17a: the card's own float32 sqrt (the route sqrt_rn takes there)
    equals the float64 route on every non-negative finite float32; every
    helper's card output equals the CPU's bitwise on HELPER_INPUTS seeded
    inputs a helper. Returns {helper: inputs that differ} (all 0)."""
    from object_detector_6d_tpu_torch.core import exact

    if "cuda" not in exact._NATIVE["sqrt"]:
        raise AssertionError("[device] sqrt_rn no longer takes the card's own sqrt")
    t0 = time.time()
    bad = n = 0
    for lo in range(0, 0x7F800000, SQRT_CHUNK):
        x = torch.arange(lo, min(lo + SQRT_CHUNK, 0x7F800000), dtype=torch.int32,
                         device=dev).view(torch.float32)
        bad += int((torch.sqrt(x).view(torch.int32)
                    != torch.sqrt(x.double()).float().view(torch.int32)).sum())
        n += x.numel()
    log(f"[device] a. the card's float32 sqrt vs the float64 route on all {n} non-negative "
        f"finite float32 values: {bad} differ ({time.time() - t0:.1f} s)")
    differ = {"sqrt native vs float64": bad}
    for name, args in helper_inputs(np.random.default_rng(17), HELPER_INPUTS).items():
        fn = getattr(exact, name)
        cpu_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        want = fn(*cpu_args)
        got = fn(*[a.to(dev) for a in cpu_args])
        want, got = (w if isinstance(w, tuple) else (w,) for w in (want, got))
        differ[name] = sum(int((float_bits(g.cpu()) != float_bits(w)).sum())
                           for g, w in zip(got, want))
    log(f"[device] a. helpers card vs cpu on {HELPER_INPUTS} seeded inputs each (+-0, "
        f"subnormal, +-inf, NaN, the 1e-32 / 1e-20 clamps), inputs that differ: {differ}; {gpu}")
    if any(differ.values()):
        raise AssertionError(f"[device] helpers card != cpu: {differ}")
    return differ


def device_phase(dev, pd2, depths2, rgbs2, pd, depths, K, gpu):
    """Phase 17: a. the helpers; b. K5 on the card == its twin on the CPU;
    c. batch_probe.py's card-vs-CPU stage mode on both workloads (0 calls
    differ on identical inputs; every stage, the flat record and the Pose
    arrays equal), and on clean_depth and PPF; f. the cost: lift + ICP
    device operations of a two-modality batch and clean_depth ms."""
    import batch_probe
    from object_detector_6d_tpu_torch.geom.cleaner import clean_depth
    from object_detector_6d_tpu_torch.ops.geometry import FusedScene

    label = "device"
    device_helpers(dev, gpu)

    d_main = torch.as_tensor(depths.astype(np.int32), device=dev)
    d_odd = odd_frames(d_main)
    for d in (d_main, d_odd):
        fs = FusedScene(d.shape[1], d.shape[2], K, device=dev)
        got, want = fs(d).cpu(), fs.plain(d.cpu())
        if not torch.equal(float_bits(got), float_bits(want)):
            raise AssertionError(f"[{label}] b. K5 {tuple(d.shape)} on the card != its twin on "
                                 f"the cpu: max {float((got - want).abs().nan_to_num(0).max())}")
    log(f"[{label}] b. K5 on the card == its twin on the cpu bitwise (NaN == NaN) at "
        f"{list(d_main.shape)} and {list(d_odd.shape)}")

    stages = {"two-modality": batch_probe.xdev_mode("device c. two-modality", pd2, depths2,
                                                    rgbs2, K, gpu),
              "depth-only": batch_probe.xdev_mode("device c. depth-only", pd, depths, None,
                                                  K, gpu)}
    bad = {w: (r["calls_differing"], [r[f"frame {f}"]["differing"] for f in (0, 1)],
               [r[f"frame {f}"]["flat_equal"] and r[f"frame {f}"]["poses_equal"] for f in (0, 1)])
           for w, r in stages.items()}
    log(f"[{label}] c. lift + ICP and cluster stages, card vs cpu (calls differing on "
        f"identical inputs, stages differing on frames 0 / 1, flat record and Pose arrays "
        f"equal): {bad}")
    if any(c or any(n) or not all(e) for c, n, e in bad.values()):
        raise AssertionError(f"[{label}] c. card != cpu in the detect stages: {bad}")
    tools = batch_probe.tools_xdev(dev, gpu)
    log(f"[{label}] e. depth tools, card vs cpu (calls differing, stages differing): "
        f"{ {k: (v['calls_differing'], v['differing']) for k, v in tools.items()} }")
    for tool in ("clean_depth", "extract_planes", "ppf normals"):
        if tools[tool]["calls_differing"] or tools[tool]["differing"]:
            raise AssertionError(f"[{label}] e. {tool} card != cpu: {tools[tool]}")

    ops, _ = trace_ops(pd2, depths2, rgbs2, K)
    frame = torch.as_tensor(noisy_snowman(scenes_module()), device=dev)
    ms = cuda_ms(lambda: clean_depth(frame))
    log(f"[{label}] f. device operations per span of one B={len(depths2)} two-modality batch "
        f"{ops} (lift + ICP {ops.get('detect.lift_icp')}); clean_depth {ms:.4f} ms per 480x640 "
        f"frame (CUDA events); {gpu}")


# ----------------------------------------------------------------------
# phase 18: the reference's large configurations (bench.py's configs 2, 4
# and 5) through the port's entry points, on the card
# ----------------------------------------------------------------------

# config 4 (bench.py:404-457): 64 hypothesis slots x 3 depth seeds = 192
# ICP lanes a frame, fine compaction to 16, threshold 75, raised by 2 while
# the first batch has a frame whose candidates overflow the slots, up to 80
CONFIG4 = dict(max_hypotheses=64, num_seeds=3, fine_compact=16)
THRESHOLD4 = 75.0
B4 = 16
# the JAX package on the CPU, on the same trained state, frames and
# threshold back-off (computed once: this script runs where there is no
# JAX): the threshold the back-off chose, the frames counted, and per class
# the frames with a pose within GT_T_M / GT_DEG of the truth and the poses
# off it. objA is held to these within OBJB_SLACK (exactly over 2 frames).
# Config 4, frames make_frames(16, 200): objB's off-truth poses lie on the
# background plane, 0.34-0.57 m from its truth.
REF4 = {"threshold": 75.0, "frames": 16, "objA": (16, 0), "objB": (5, 10)}
# configs 2 + 4 (bench.py:459-515), the 1202-template bank, frames
# make_frames(16, 300): the JAX package's match takes ~10 min a frame at
# 1202 templates on a CPU, so its counts cover frames 0-1
REF_SCALE = {"threshold": 75.0, "frames": 2, "objA": (2, 0), "objB": (0, 1)}
# bench_match's points (bench.py:65-114, :627-634): (classes, templates a
# class, dispatches timed), B = 8 frames, 32 candidates, threshold 80
MATCH_POINTS = ((12, 10, 12), (12, 100, 12), (40, 100, 8))
MATCH_B = 8
# config 5 (bench.py:518-600): 4-camera ticks, 30 FPS a camera
N_CAM = 4
TICK_BUDGET_MS = 1000.0 / 30.0


def config4_detector(pd, dev):
    """``pd``'s detector and views at the config-4 schedule (bench.py's
    bench_hyp_scaling: only the hypothesis capacity and threshold change)."""
    import dataclasses

    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    pd4 = PoseDetector(detector=pd.detector, model_points=pd.model_points, device=dev,
                       params=dataclasses.replace(pd.params, match_threshold=THRESHOLD4,
                                                  **CONFIG4))
    pd4.views = pd.views
    return pd4


def back_off(label, pd4, depths, rgbs, K) -> float:
    """bench.py's adaptive threshold: from 75, +2 while the first batch has a
    frame through the overflow fallback, up to 80. Sets it on ``pd4``."""
    import dataclasses

    thr = THRESHOLD4
    while True:
        pd4.params = dataclasses.replace(pd4.params, match_threshold=thr)
        pd4.counters.counts["overflow_fallback"] = 0
        t0 = time.time()
        out = pd4.detect_fused_batch(depths, K, rgbs)
        n_over = pd4.counters.counts.get("overflow_fallback", 0)
        log(f"[{label}] threshold {thr:g}: {sum(map(len, out))} poses over {len(depths)} "
            f"frames, {n_over} through the overflow fallback ({time.time() - t0:.1f} s)")
        if n_over == 0 or thr >= 80.0:
            return thr
        thr += 2.0


def pipelined(pd, batches, K, n: int, group: int):
    """bench.py's pipelined run: n detect_fused_dispatch calls over
    ``batches`` in turn, then detect_fused_finalize_many in groups of
    ``group``. Returns (host ms, the results per dispatch)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [pd.detect_fused_dispatch(batches[i % len(batches)][0], K,
                                        batches[i % len(batches)][1]) for i in range(n)]
    out = []
    for i in range(0, n, group):
        out += pd.detect_fused_finalize_many(handles[i:i + group])
    return (time.perf_counter() - t0) * 1e3, out


def held_to_reference(label, results, gts, thr, ref):
    """objA's found / off-truth counts over the reference's frames within
    OBJB_SLACK of the JAX package's (``ref``; exactly over 2 frames), at
    its threshold; objB's logged beside its reference."""
    n = ref["frames"]
    found, spurious = ground_truth_stats(results[:n], gts[:n])
    got = {c: (found[c], len(spurious[c])) for c in ("objA", "objB")}
    log(f"[{label}] (iv) over frames 0-{n - 1} (found, off truth) per class: {got}; the JAX "
        f"package's {ref}; off truth (frame, mm, deg): {spurious}")
    slack = OBJB_SLACK if n > 2 else 0
    if thr != ref["threshold"] or any(abs(a - b) > slack
                                      for a, b in zip(got["objA"], ref["objA"])):
        raise AssertionError(f"[{label}] (iv) objA (found, off truth) {got['objA']} at "
                             f"threshold {thr:g}, the JAX package's {ref['objA']} +- {slack} "
                             f"at {ref['threshold']:g}")


def large_config_run(label, pd4, batches, gts, K, counted, ref, gate_lanes, gpu):
    """One config-4-shaped run (phases 18a, 18b) on batches of B4 frames:
    the threshold back-off, the pipelined timing with the launch counts
    from 0, then the gates: (i) no frame through the overflow fallback,
    (ii) more than 16 candidates through the threshold in some frame
    in either batch (``gate_lanes``; logged always), (iii) frames 0-1 of
    the card's first batch == a CPU PoseDetector's on those two frames as
    a B=2 batch and == the card's B=2 batch, and the frame with the most
    candidates == the CPU's on it alone, bitwise, (iv) objA held to the
    JAX package's counts over the first batch.
    Returns (launches, ms per batch, threshold)."""
    from object_detector_6d_tpu_torch.api import detect_program as dp
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    depths, rgbs = batches[0]
    thr = back_off(label, pd4, depths, rgbs, K)

    for fn in counted:
        fn.launches = 0
    pd4.counters.counts["overflow_fallback"] = 0
    pipelined(pd4, batches, K, 4, 4)
    ms, _ = pipelined(pd4, batches, K, 8, 4)
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"[{label}] launches over 12 pipelined batches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{label}] {name} was not launched")
    if pd4.counters.counts.get("overflow_fallback", 0):
        raise AssertionError(f"[{label}] (i) a timed batch went through the overflow fallback")
    B = len(depths)
    log(f"[{label}] time pipelined, 4 warm-up dispatches then 8 finalized in groups of 4: "
        f"{ms / 8:.2f} ms per B={B} batch, {8 * B / (ms / 1e3):.1f} frames/s at threshold "
        f"{thr:g} ({gpu})")

    _, K_cap = pd4.program(*depths.shape[1:], K)
    records = [flat_record(pd4, d, K, r) for d, r in batches]
    n_raw = [dp.unflatten_cluster_outputs(f.numpy(), K_cap)[1].astype(int).tolist()
             for f, _ in records]
    n_pass = [dp.unflatten_cluster_outputs(f.numpy(), K_cap)[2].astype(int).tolist()
              for f, _ in records]
    log(f"[{label}] (ii) per frame of each batch, candidates through the threshold {n_raw}; "
        f"poses before NMS {n_pass}; {K_cap} slots x {pd4.params.num_seeds} seeds")
    most = max(max(n) for n in n_raw)
    if gate_lanes and most <= 16:
        raise AssertionError(f"[{label}] (ii) no frame has more than 16 candidates: {n_raw}")
    if most > K_cap:
        raise AssertionError(f"[{label}] a frame overflows the {K_cap} slots: {n_raw}")

    # (iii) card vs CPU: frames 0-1 of the first batch as a B=2 batch, and
    # the frame with the most candidates alone
    cpu_pd = PoseDetector(detector=pd4.detector, params=pd4.params,
                          model_points=pd4.model_points, device="cpu")
    cpu_pd.views = pd4.views
    g, f_most = max(((g, f) for g in range(len(batches)) for f in range(B)),
                    key=lambda gf: n_raw[gf[0]][gf[1]])
    d_most, r_most = (x[f_most:f_most + 1] for x in batches[g])
    t0 = time.time()
    two = flat_record(pd4, depths[:2], K, rgbs[:2])
    cpu_two = flat_record(cpu_pd, depths[:2], K, rgbs[:2])
    alone = flat_record(cpu_pd, d_most, K, r_most)
    checks = ([(0, f, "the card's B=2 batch", two, f) for f in (0, 1)]
              + [(0, f, "the cpu's B=2 batch", cpu_two, f) for f in (0, 1)]
              + [(g, f_most, "the cpu's frame alone", alone, 0)])
    for g_, f, other, (oflat, oposes), row in checks:
        same_nan(f"[{label}] (iii) batch {g_} frame {f}: flat record of B={B} vs {other}",
                 records[g_][0][f], oflat[row])
        if pose_bits(records[g_][1][f]) != pose_bits(oposes[row]):
            raise AssertionError(f"[{label}] (iii) batch {g_} frame {f}: Pose arrays of "
                                 f"B={B} != {other}'s")
    log(f"[{label}] (iii) frames 0-1 of the card's B={B} batch == the card's B=2 and the "
        f"cpu's B=2, and batch {g} frame {f_most} == the cpu's frame alone, bitwise (flat "
        f"record and Pose arrays; {time.time() - t0:.1f} s)")
    poses = records[0][1]
    held_to_reference(label, poses, gts, thr, ref)
    return launches, ms / 8, thr


def config4_phase(dev, pd2, scenes, K, counted, gpu):
    """18a: bench.py's config 4 on phase 3's detector and views."""
    label = "config 4"
    pd4 = config4_detector(pd2, dev)
    frames = [make_frames(scenes, K, B4, 200 + s) for s in range(2)]
    return large_config_run(label, pd4, [(d, r) for d, r, _ in frames], frames[0][2], K,
                            counted, REF4, True, gpu)


def scale_bank_phase(dev, scenes, K, counted, gpu):
    """18b: configs 2 + 4, a fresh two-modality Detector() with
    synthetic_bank(12, 100) + objA + objB (1202 templates) at the config-4
    schedule; K6 on the match program's own arguments at nT = 1202, K4 at
    64 candidates. Returns (launches, ms, threshold, [K6, K4 records])."""
    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank
    from object_detector_6d_tpu_torch.ops import refine

    label = "scale bank"
    det = synthetic_bank(n_classes=12, per_class=100, bbox_px=120, seed=0, detector=Detector())
    pdl = config4_detector(train(det, dev, scenes, K), dev)
    frames = [make_frames(scenes, K, B4, 300 + s) for s in range(2)]
    launches, ms, thr = large_config_run(label, pdl, [(d, r) for d, r, _ in frames],
                                         frames[0][2], K, counted, REF_SCALE, False, gpu)
    depths, rgbs = frames[0][:2]
    coarse = _capture_args(dev, pdl, depths, rgbs, K, "coarse_sweep", thr)
    recs = []
    for D, *tables, gh, gw in coarse:
        compare(f"[{label}] coarse_sweep on the match program's arguments",
                refine.coarse_sweep(D, *tables, gh, gw),
                refine.coarse_sweep_plain(D, *tables, gh, gw))
        recs.append(coarse_record(D, tables, gh, gw))
    recs.append(refine_record(dev, capture_refine_args(dev, pdl, depths, rgbs, K, thr), gpu,
                              "the 1202-template bank's match program"))
    log_times(recs, gpu)
    return launches, ms, thr, recs


def match_inputs(dev, rng):
    """bench_match's frames: B random BGR frames and depths 900-1599 mm."""
    bgr = rng.randint(0, 256, (MATCH_B, 480, 640, 3), dtype=np.int64).astype(np.uint8)
    dep = (900 + rng.randint(0, 700, (MATCH_B, 480, 640))).astype(np.uint16)
    return (torch.as_tensor(bgr, device=dev),
            torch.as_tensor(dep.astype(np.int32), device=dev))


def match_scaling_phase(dev, counted, gpu):
    """18c: make_match_program alone at bench_match's three banks: the
    match record card == CPU on frames 0-1, ms per batch (dispatches
    synced once), K6 at each bank and K4 at 32 candidates on the program's
    own arguments. Returns (launches, {templates: ms}, records)."""
    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank
    from object_detector_6d_tpu_torch.match import program as mp
    from object_detector_6d_tpu_torch.ops import refine

    label = "match scaling"
    rng = np.random.RandomState(0)
    inputs = [match_inputs(dev, rng) for _ in range(4)]
    launches = {fn.__name__: 0 for fn in counted}
    times, recs = {}, []
    for n_classes, per_class, n_batches in MATCH_POINTS:
        det = synthetic_bank(n_classes=n_classes, per_class=per_class, bbox_px=120, seed=0,
                             detector=Detector())
        bank = mp.pack_bank(det.class_templates, 2, 2, t0=det.t_at_level[0],
                            t1=det.t_at_level[1])
        nT = bank.num_templates

        def program(d):
            prog = mp.make_match_program(det.modality_names, det.t_at_level, (480, 640),
                                         det.dn_params, det.cg_params, max_candidates=32)
            args = mp.bank_args(bank, d)
            return lambda src: prog(list(src), *args, THRESHOLD)

        card = program(dev)
        with torch.no_grad():
            card(inputs[0])
            torch.cuda.synchronize()
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            outs = [card(inputs[i % 4]) for i in range(n_batches)]
            torch.cuda.synchronize()
            times[nT] = (time.perf_counter() - t0) * 1e3 / n_batches
            for fn in counted:
                launches[fn.__name__] += fn.launches
            want = program("cpu")([s[:2].cpu() for s in inputs[0]])
        if not torch.equal(outs[0][:2].cpu(), want):
            raise AssertionError(f"[{label}] {nT} templates: the match record of frames 0-1 "
                                 "card != cpu")
        log(f"[{label}] {nT} templates: match record {list(outs[0].shape)} of frames 0-1 card "
            f"== cpu (n_above {outs[0][:, 0, -1].to(torch.int64).tolist()}); "
            f"{times[nT]:.2f} ms per B={MATCH_B} batch, {MATCH_B / (times[nT] / 1e3):.1f} "
            f"frames/s ({n_batches} dispatches synced once; {gpu})")
        if nT >= 4000:
            for D, *tables, gh, gw in capture_calls("coarse_sweep", lambda: card(inputs[0])):
                compare(f"[{label}] coarse_sweep at {nT} templates",
                        refine.coarse_sweep(D, *tables, gh, gw),
                        refine.coarse_sweep_plain(D, *tables, gh, gw))
                recs.append(coarse_record(D, tables, gh, gw))
            recs.append(refine_record(dev, capture_calls("refine_sweep_batched",
                                                         lambda: card(inputs[0])), gpu,
                                      f"the {nT}-template match program's"))
    log_times(recs, gpu)
    for name, n in launches.items():
        if n <= 0 and name != "FusedScene":
            raise AssertionError(f"[{label}] {name} was not launched")
    return launches, times, recs


def tick_spans(pd, depths, rgbs, K, gpu):
    """The device operations, host ms and device ms per detect.* span of one
    4-camera ``process`` tick and of one B=32 batch of the same frames
    (phase 18d's finding: why a tick costs more than 4/32 of a batch)."""
    from object_detector_6d_tpu_torch.api.streaming import StreamingDetector

    sd = StreamingDetector(pd, n_cameras=len(depths))
    big = (np.concatenate([depths] * 8), np.concatenate([rgbs] * 8))
    for name, fn in (("tick", lambda: sd.process(depths, K, rgbs)),
                     ("B=32", lambda: pd.detect_fused_batch(big[0], K, big[1]))):
        fn()
        spans, _ = trace_spans(fn)
        log(f"[config 5] {name}: per span (device ops, host ms, device ms) "
            f"{ {k: (v[0], round(v[1], 3), round(v[2], 3)) for k, v in spans.items()} }; {gpu}")


def streaming_config_phase(dev, pd2, scenes, K, counted, gpu):
    """18d: bench.py's config 5 on phase 3's detector: blocking ``process``
    ticks, tick-wise pipelined dispatches and G=4 scanned executions, each
    camera of each pipelined tick == ``process`` on it, bitwise. Returns
    (launches, {mode: ms per tick})."""
    from object_detector_6d_tpu_torch.api.streaming import StreamingDetector

    label = "config 5"
    sd = StreamingDetector(pd2, n_cameras=N_CAM)
    ticks = [make_frames(scenes, K, N_CAM, 100 + s)[:2] for s in range(4)]
    want = [[pose_bits(p) for p in sd.process(d, K, r)] for d, r in ticks]

    for fn in counted:
        fn.launches = 0
    pd2.counters.counts["overflow_fallback"] = 0
    lat = []
    for i in range(8):
        depths, rgbs = ticks[i % 4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd.process(depths, K, rgbs)
        lat.append((time.perf_counter() - t0) * 1e3)
    tick_ms = {"blocking process": statistics.mean(sorted(lat)[:6])}

    group = 8
    pipelined(pd2, ticks, K, group, group)  # one warm group
    ms, tickwise = pipelined(pd2, ticks, K, 16, group)
    tick_ms["tick-wise pipelined"] = ms / 16

    G = 4
    multis = [(np.stack([ticks[(2 * m + g) % 4][0] for g in range(G)]),
               np.stack([ticks[(2 * m + g) % 4][1] for g in range(G)])) for m in range(2)]
    pd2.detect_fused_finalize_multi(pd2.detect_fused_dispatch_multi(multis[0][0], K,
                                                                     multis[0][1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [pd2.detect_fused_dispatch_multi(multis[i % 2][0], K, multis[i % 2][1])
          for i in range(8)]
    scanned = [pd2.detect_fused_finalize_multi(h) for h in hs]
    tick_ms["scanned, G=4"] = (time.perf_counter() - t0) * 1e3 / (8 * G)
    launches = {fn.__name__: fn.launches for fn in counted}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{label}] {name} was not launched")
    if pd2.counters.counts.get("overflow_fallback", 0):
        raise AssertionError(f"[{label}] a tick went through the overflow fallback")

    for i, res in enumerate(tickwise):
        if [pose_bits(p) for p in res] != want[i % 4]:
            raise AssertionError(f"[{label}] tick-wise pipelined tick {i} != process")
    for i, res in enumerate(scanned):
        for g in range(G):
            if [pose_bits(p) for p in res[g]] != want[(2 * (i % 2) + g) % 4]:
                raise AssertionError(f"[{label}] scanned execution {i}, tick {g} != process")
    log(f"[{label}] every camera of {len(tickwise)} tick-wise pipelined ticks and "
        f"{len(scanned)} x {G} scanned ticks == process on the same tick, bitwise "
        f"(poses per camera {[[len(p) for p in w] for w in want]})")
    for mode, ms in tick_ms.items():
        log(f"[{label}] time {mode}: {ms:.2f} ms per {N_CAM}-camera tick, "
            f"{N_CAM * 1e3 / ms:.1f} frames/s aggregate, against the {TICK_BUDGET_MS:.1f} "
            f"ms tick of {N_CAM} x 30 FPS ({gpu})")
    log(f"[{label}] blocking ticks (ms): {[round(t, 2) for t in lat]}")
    tick_spans(pd2, *ticks[0], K, gpu)
    return launches, tick_ms


def configs_phase(dev, pd2, scenes, K, counted, gpu):
    """Phase 18. Returns (launches per kernel wrapper over its main runs,
    the K6 / K4 records at the new shapes)."""
    launches = {fn.__name__: 0 for fn in counted}
    recs = []
    for name, step in (
            ("18a config 4", lambda: config4_phase(dev, pd2, scenes, K, counted, gpu)),
            ("18b scale bank", lambda: scale_bank_phase(dev, scenes, K, counted, gpu)),
            ("18c match scaling", lambda: match_scaling_phase(dev, counted, gpu)),
            ("18d config 5", lambda: streaming_config_phase(dev, pd2, scenes, K, counted,
                                                             gpu))):
        t1 = time.time()
        out = step()
        for k, n in out[0].items():
            launches[k] += n
        if name.startswith("18b"):
            recs += out[3]
        if name.startswith("18c"):
            recs += out[2]
        log(f"phase {name}: {time.time() - t1:.1f} s; launches {out[0]}")
    return launches, recs


def run(dev, gpu: str) -> None:
    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.ops import (geometry, kernels, quantize, refine, response,
                                                  select)

    # phase 2: build
    t0 = time.time()
    kernels.library()
    log(f"build: {time.time() - t0:.1f} s -> {kernels.build_info['path']}")
    for line in kernels.build_info.get("log", "").splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    scenes = scenes_module()
    K = scenes.K_DEFAULT

    # phase 3: the two-modality path (the reference's default Detector)
    pd2 = train(two_modality_bank(), dev, scenes, K)
    depths2, rgbs2, gts2 = make_frames(scenes, K, B, seed=SEED2)
    pd2.detect_fused_batch(depths2[:2], K, rgbs2[:2])  # the bank on the card
    recs = color_kernel_checks(dev, pd2, rgbs2, depths2, gpu)
    recs.append(refine_main_path_record(dev, pd2, depths2, rgbs2, K, gpu))
    recs.append(response_main_path_record(dev, pd2, depths2, rgbs2, K, gpu))
    recs.append(select_record(dev, gpu))
    counted2 = (quantize.cg_quantize_batched, quantize.dn_quantize_batched,
                response.response_spread_batched, refine.coarse_sweep,
                refine.refine_sweep_batched, geometry.FusedScene, select.select_topk)
    launches, _ = drive_path("two-modality", pd2, depths2, rgbs2, gts2, K, counted2,
                             REF2_OBJB_FOUND, REF2_OBJB_SPURIOUS, gpu)

    # phase 4: the depth-only path
    pd = train(add_distractors(Detector(modalities=("DepthNormal",))), dev, scenes, K)
    det = pd.detector
    depths, _, gts = make_frames(scenes, K, B, seed=SEED)
    pd.detect_fused_batch(depths[:2], K)
    prog, _ = pd.program(480, 640, K)
    recs += depth_kernel_checks(dev, depths, K, pd.bank_tensors(det.get_bank())[0],
                                prog.fused_scene, gpu)
    counted = (quantize.dn_quantize_batched, response.response_spread_batched,
               refine.coarse_sweep, refine.refine_sweep_batched, geometry.FusedScene,
               select.select_topk)
    drive_path("depth-only", pd, depths, None, gts, K, counted, REF_OBJB_FOUND,
               REF_OBJB_SPURIOUS, gpu)

    # phase 5: the overflow fallback, on the depth-only detector
    fb_depths, fallen = fallback_phase(pd, scenes, K, gpu)

    log(f"phases 2-5: {time.time() - t0:.1f} s")

    # phases 6-9: the host matcher, multi / many, streaming, parity
    done = {}
    for name, phase in (
            ("host matcher", lambda: host_matcher_phase(dev, pd2, depths2, rgbs2, pd,
                                                        fb_depths, fallen[0], gpu)),
            ("multi", lambda: multi_phase(pd2, depths2, rgbs2, K, gpu)),
            ("streaming", lambda: streaming_phase(dev, scenes, K, gpu)),
            ("parity", lambda: parity_phase(gpu))):
        t1 = time.time()
        done[name] = phase()
        log(f"phase {name}: {time.time() - t1:.1f} s")

    # phase 10: train, store, evaluate
    t1 = time.time()
    offline = offline_phase(dev, scenes, K, gpu)
    log(f"phase offline: {time.time() - t1:.1f} s; launches {offline}")

    # phase 11: geometry utilities, odometry, PPF
    t1 = time.time()
    geometry_phase(dev, scenes, K, counted2, gpu)
    log(f"phase geometry: {time.time() - t1:.1f} s")

    # phase 12: raw and one-frame forms, front ends, windowed association
    t1 = time.time()
    forms = raw_forms_phase(dev, pd2, depths2, rgbs2, gts2, K, counted2, gpu)
    log(f"phase raw forms and windows: {time.time() - t1:.1f} s")

    # phase 13: sharded, worlds of one and two
    t1 = time.time()
    sharded = sharded_phase(dev, pd2, depths2, rgbs2, K, gpu)
    log(f"phase sharded: {time.time() - t1:.1f} s; launches {sharded}")

    # phase 14: limits (frame edge, chunked K4 / K6, K3 beyond T=16)
    t1 = time.time()
    limits = limits_phase(dev, pd2, depths2, rgbs2, gts2, K, counted2, gpu)
    log(f"phase limits: {time.time() - t1:.1f} s; launches {limits}")

    # phase 15: batch invariance (alone, B = 2, 4, 32, multi, streaming)
    t1 = time.time()
    batch = batch_phase(dev, pd2, depths2, rgbs2, pd, depths, done["streaming"], K, counted2,
                        gpu)
    log(f"phase batch: {time.time() - t1:.1f} s; launches {batch}")

    # phase 16: colour frames
    t1 = time.time()
    coloured = colour_phase(dev, scenes, K, counted2, gpu)
    log(f"phase colour: {time.time() - t1:.1f} s; launches {coloured}")

    # phase 17: the card gives the CPU's answer (helpers, K5, stages, tools)
    t1 = time.time()
    device_phase(dev, pd2, depths2, rgbs2, pd, depths, K, gpu)
    log(f"phase device: {time.time() - t1:.1f} s")

    # phase 18: the reference's large configurations (bench.py configs 2, 4, 5)
    t1 = time.time()
    configs, shapes = configs_phase(dev, pd2, scenes, K, counted2, gpu)
    log(f"phase configurations: {time.time() - t1:.1f} s; launches {configs}")
    log("phase 18 kernels at their new shapes: " + json.dumps(
        [{k: r[k] for k in ("name", "shape", "ms", "cold_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms") if k in r} for r in shapes]))

    for r in recs:
        r["launches"] = sum(ph[r["name"]] for ph in (launches, offline, forms, sharded, limits,
                                                      batch, coloured, configs))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(gpu)
    log(json.dumps({"kernels": [{**{k: r[k] for k in keys}, "cold_ms": r.get("cold_ms")}
                                for r in recs]}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    run(torch.device("cuda:0"), gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
