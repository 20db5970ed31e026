"""Where does the port's answer on the card start to depend on the batch
size? One CUDA card.

    python3 batch_probe.py [--device cpu --quick]

(``--quick``: the depth-only workload alone and no timing, for a
rehearsal on the CPU, where every batch size gives the same bits.)

Frame 0 of chip_smoke.py's two-modality and depth-only workloads goes
through ``PoseDetector.detect_fused_batch`` alone and as the first frame of
batches of 2 and 4. Every stage's values for frame 0 are recorded on the
way: the match program's [5, K+1], and in every projective ICP step of
both ICP phases the association (the pose it starts from, scene points,
normals, weights), each
Gauss-Newton solve's centroid, normal equations A and b, update x and new
pose, and last the frame's poses. Each batch size is then held against
B = 1 stage by stage, bitwise, and the first stage that differs is named;
the poses are compared in mm and degrees.

The Gauss-Newton solve is run in three forms, each over all batch sizes:
``matmul`` (the port's own: A and b by torch.matmul, sums by torch.sum),
``sum`` (A and b as an explicit product summed over the point axis by
torch.sum) and ``tree`` (every sum over the point axis as a pairwise tree
of elementwise adds, whose order cannot depend on the number of lanes).
The first form must equal the port's ``_gn_solve`` bitwise. Each form's
ms per B=32 batch is printed too. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

BATCHES = (1, 2, 4)


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a pairwise tree of elementwise adds."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    size = 1 << max(0, (n - 1).bit_length())
    if size != n:
        x = torch.cat([x, x.new_zeros((size - n, *x.shape[1:]))])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def make_gn_solve(form: str, record):
    """The port's ``_gn_solve`` with the reductions of ``form``; ``record``
    gets (name, tensor) for the solve's intermediates."""
    from object_detector_6d_tpu_torch.core.se3 import SE3, cross
    from object_detector_6d_tpu_torch.refine.projective import _chol_solve6

    red = tree_sum if form == "tree" else (lambda x, dim: torch.sum(x, dim=dim))

    def gn_solve(pose, model_pc, qp, qn, w):
        mp = SE3.apply(pose, model_pc[..., :3])
        r = torch.sum((mp - qp) * qn, dim=-1)
        wsum = torch.clamp(red(w, -1), min=1.0)
        c = red(mp * w[..., None], -2) / wsum[:, None]
        J = torch.cat([cross(mp - c[:, None, :], qn), qn], dim=-1)
        Jw = J * w[..., None]
        if form == "matmul":
            A = torch.matmul(Jw.transpose(-1, -2), J)
            b = -torch.matmul(Jw.transpose(-1, -2), r[..., None])[..., 0]
        else:
            A = red(Jw[..., :, None] * J[..., None, :], -3)
            b = -red(Jw * r[..., None], -2)
        x = _chol_solve6(A, b)
        dT = SE3.exp(x)
        eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(c.shape[0], 3, 3)
        new_pose = SE3.compose(SE3.from_rt(eye, c), SE3.compose(
            dT, SE3.compose(SE3.from_rt(eye, -c), pose)))
        residual = red(torch.abs(r) * w, -1) / wsum
        for name, t in (("r", r), ("c", c), ("A", A), ("b", b), ("x", x), ("pose", new_pose)):
            record(f"gn.{name}", t)
        return new_pose, torch.linalg.vector_norm(x, dim=-1), residual

    return gn_solve


def run_once(pd, depths, rgbs, K, form: str, B: int):
    """Frame 0's stage values and poses from a batch of B frames."""
    from object_detector_6d_tpu_torch.refine import projective

    stages = []

    def record(name, t):  # frame 0 owns the first 1/B of the lanes
        stages.append((f"{len(stages):03d}.{name}", t[: t.shape[0] // B].clone()))

    real_assoc, real_gn = projective._associate, projective._gn_solve
    prog, _ = pd.program(*depths.shape[1:], K)
    real_match = prog.match_program

    def assoc(*a):
        out = real_assoc(*a)
        for name, t in zip(("assoc.pose_in", "assoc.qp", "assoc.qn", "assoc.w"), (a[0], *out)):
            record(name, t)
        return out

    gn = make_gn_solve(form, record)
    if form == "matmul":  # the probe's copy is the port's solve
        def gn_checked(*a, _inner=gn):
            got, want = _inner(*a), real_gn(*a)
            for g, wv in zip(got, want):
                if not torch.equal(g, wv):
                    raise AssertionError("batch_probe's matmul form != the port's _gn_solve")
            return got
        gn = gn_checked
    projective._associate, projective._gn_solve = assoc, gn
    try:
        r = None if rgbs is None else rgbs[:B]
        poses = pd.detect_fused_batch(depths[:B], K, r)[0]
    finally:
        projective._associate, projective._gn_solve = real_assoc, real_gn
    d = torch.as_tensor(depths[:B].astype(np.int32), device=pd.device)
    src = [torch.as_tensor(rgbs[:B], device=pd.device) if n == "ColorGradient" else d
           for n in pd.detector.modality_names]
    with torch.no_grad():
        m = real_match(src, *pd.bank_tensors(pd.detector.get_bank())[0], cs.THRESHOLD)
    return [("match", m[:1].clone())] + stages, poses


def pose_gap(a, b):
    """(same detections, max |dt| mm, max rotation deg) of two pose lists."""
    key = [(p.class_id, p.template_id) for p in a]
    if key != [(p.class_id, p.template_id) for p in b]:
        return False, float("nan"), float("nan")
    dt = max([float(np.abs(p.pose[:3, 3] - q.pose[:3, 3]).max()) for p, q in zip(a, b)] + [0.0])
    dr = max([cs.rot_deg(p.pose[:3, :3], q.pose[:3, :3]) for p, q in zip(a, b)] + [0.0])
    return True, dt * 1e3, dr


def probe(label, pd, depths, rgbs, K, gpu):
    out = {}
    for form in ("matmul", "sum", "tree"):
        base_stages, base_poses = run_once(pd, depths, rgbs, K, form, 1)
        res = {}
        for B in BATCHES[1:]:
            stages, poses = run_once(pd, depths, rgbs, K, form, B)
            if [n for n, _ in stages] != [n for n, _ in base_stages]:
                raise AssertionError("the stage sequence depends on the batch size")
            differ = [(n, float((a.double() - b.double()).abs().max()))
                      for (n, a), (_, b) in zip(stages, base_stages) if not torch.equal(a, b)]
            same, dt, dr = pose_gap(base_poses, poses)
            res[f"B={B}"] = {"stages": len(stages), "differing": len(differ),
                             "first": differ[0] if differ else None,
                             "same_detections": same, "max_dt_mm": dt, "max_rot_deg": dr}
            cs.log(f"[{label}] {form}: frame 0 at B={B} against B=1: {len(differ)} of "
                   f"{len(stages)} stages differ; first {differ[0] if differ else None}; "
                   f"in its step {[d for d in differ[:8]]}; poses: same detections {same}, "
                   f"max |dt| {dt:.5f} mm, max rotation {dr:.5f} deg; {gpu}")
        out[form] = res
    return out


def batch_ms(pd, depths, rgbs, K, form: str) -> float:
    """Median ms per B=32 batch (host clock, 5 runs after a warm-up) with
    the Gauss-Newton solve in ``form``."""
    from object_detector_6d_tpu_torch.refine import projective

    real_gn = projective._gn_solve
    if form != "port":
        projective._gn_solve = make_gn_solve(form, lambda name, t: None)
    try:
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pd.detect_fused_batch(depths, K, rgbs)  # returns host poses: it has synchronised
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        projective._gn_solve = real_gn
    return statistics.median(times[1:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("batch_probe: no CUDA card", file=sys.stderr)
        return 2
    from object_detector_6d_tpu_torch.api.detector import Detector

    gpu = cs.gpu_line() if dev.type == "cuda" else "cpu"
    scenes = cs.scenes_module()
    K = scenes.K_DEFAULT
    res = {"gpu": gpu}
    n = max(BATCHES) if args.quick else cs.B
    if not args.quick:
        pd2 = cs.train(cs.two_modality_bank(), dev, scenes, K)
        depths2, rgbs2, _ = cs.make_frames(scenes, K, n, seed=cs.SEED2)
        res["two-modality"] = probe("two-modality", pd2, depths2, rgbs2, K, gpu)
    pd1 = cs.train(cs.add_distractors(Detector(modalities=("DepthNormal",))), dev, scenes, K)
    depths1, _, _ = cs.make_frames(scenes, K, n, seed=cs.SEED)
    res["depth-only"] = probe("depth-only", pd1, depths1, None, K, gpu)
    if not args.quick:
        res["batch_ms"] = {form: batch_ms(pd2, depths2, rgbs2, K, form)
                           for form in ("port", "sum", "tree")}
        cs.log(f"two-modality ms per B={cs.B} batch by form of the solve: "
               f"{res['batch_ms']}; {gpu}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
