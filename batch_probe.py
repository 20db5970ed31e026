"""Where does a frame's answer depend on the batch it came in, or differ
between the card and the CPU? One CUDA card.

    python3 batch_probe.py                     # batch mode
    python3 batch_probe.py --device cpu        # card-vs-CPU stage mode
    python3 batch_probe.py --time [--root DIR] # ms per batch, lift + ICP ops
    python3 batch_probe.py --card cpu --quick  # a rehearsal on the CPU

A stage is one floating-point result of a torch call made inside the
detect program's lift + ICP (``lift_and_refine``) and cluster
(``make_cluster_stage``) stages, recorded by a TorchFunctionMode and named
by its order, the function and the port's file:line that made it (the
caller first); the match record [5, K+1] comes before them, and the flat
NMS record and the Pose arrays after them.

Batch mode: frame 0 at position 0 and frame B-1 at the end of a batch of
B = 2, 4 and 32 through ``PoseDetector.detect_fused_batch``, each held
against the same frame alone (B = 1) stage by stage, bitwise; the first
stage that differs is named, and the flat record and the Pose arrays are
compared. Two forms of the Gauss-Newton solve run over every batch size:
``port`` (the port's own ``_gn_solve``, whose sums over points are
``core/reduce.py`` ``fixed_sum`` trees) and ``matmul`` (the solve before
them: A and b by torch.matmul, the other sums by torch.sum), which keeps
the old fault visible. Both workloads of chip_smoke.py run (``--quick``:
the depth-only one at B = 1, 2, 4).

Card-vs-CPU stage mode (``--device cpu``): chip_smoke.py phase 4's
depth-only frames 0 and 1 (seed 1) at B = 2 on the card and through a
CPU PoseDetector. Every stage is held twice: (a) the card's call
re-run on the CPU on copies of the card's own inputs, which names every
call whose CPU result differs from the card's on the same inputs; (b)
the card's run against the CPU run, which names the first stage where the
two runs part, for the frame and for the lanes of its objB hypotheses.

``--time``: ms per B=32 two-modality batch (host clock, median of 5 after
one warm-up) and the device operations (kernels, copies, fills) launched
inside the ``detect.lift_icp`` and ``detect.cluster`` spans of one batch
(torch.profiler trace). ``--root DIR`` imports the port from DIR (an
unpacked copy of another commit), so that two commits are timed in turns
by one script. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

import chip_smoke as cs

BATCHES = (1, 2, 4, 32)
REGIONS = ("lift_and_refine", "cluster")  # detect_program.py's stage closures


def gn_solve_matmul(pose, model_pc, qp, qn, w):
    """The Gauss-Newton solve before fixed_sum (refine/projective.py until
    it summed by trees): A and b by batched torch.matmul, the other sums
    over points by torch.sum; on the card their order changes with the
    number of lanes."""
    from object_detector_6d_tpu_torch.core.se3 import SE3, cross
    from object_detector_6d_tpu_torch.refine.projective import _chol_solve6

    mp = SE3.apply(pose, model_pc[..., :3])
    r = torch.sum((mp - qp) * qn, dim=-1)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    c = torch.sum(mp * w[..., None], dim=-2) / wsum[:, None]
    J = torch.cat([cross(mp - c[:, None, :], qn), qn], dim=-1)
    Jw = J * w[..., None]
    A = torch.matmul(Jw.transpose(-1, -2), J)
    b = -torch.matmul(Jw.transpose(-1, -2), r[..., None])[..., 0]
    x = _chol_solve6(A, b)
    dT = SE3.exp(x)
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(c.shape[0], 3, 3)
    new_pose = SE3.compose(SE3.from_rt(eye, c), SE3.compose(
        dT, SE3.compose(SE3.from_rt(eye, -c), pose)))
    residual = torch.sum(torch.abs(r) * w, dim=-1) / wsum
    return new_pose, torch.linalg.vector_norm(x, dim=-1), residual


def port_site(pkg: str):
    """(file:line of the port's frames that made the current call, caller
    first, at most two; whether the call is inside a REGIONS stage)."""
    f = sys._getframe(2)
    sites, inside = [], False
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(pkg):
            if len(sites) < 2:
                sites.append(f"{os.path.relpath(fn, pkg)}:{f.f_lineno}")
            if f.f_code.co_name in REGIONS and fn.endswith("detect_program.py"):
                inside = True
                break
        f = f.f_back
    return " < ".join(sites), inside


class StageRecorder(TorchFunctionMode):
    """Records, for the frames at ``positions`` of a batch of ``B``, every
    floating-point tensor that a torch call inside a REGIONS stage returns:
    the rows of that frame where the leading axis is a multiple of B
    (every lane and frame axis of the program is frame-major), the whole
    tensor where it is small. With ``on_cpu``, each such call is also run on
    CPU copies of its inputs and the first calls whose CPU result differs
    are kept in ``xdev``."""

    def __init__(self, B: int, positions, on_cpu: bool = False):
        super().__init__()
        import object_detector_6d_tpu_torch as port

        self.pkg = str(pathlib.Path(port.__file__).parent)
        self.B, self.positions, self.on_cpu = B, tuple(positions), on_cpu
        self.stages = {p: [] for p in self.positions}
        self.xdev = []  # (stage, max |card - cpu|, differing share)
        self.n_checked = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        site, inside = port_site(self.pkg)
        if not inside:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        cpu_args = None
        if self.on_cpu and not name.endswith("_") and name != "__setitem__":
            cpu_args = torch.utils._pytree.tree_map(_to_cpu, (args, kwargs))
        out = func(*args, **kwargs)
        if not (isinstance(out, torch.Tensor) and out.is_floating_point() and out.dim() > 0):
            return out
        stage = f"{len(self.stages[self.positions[0]]):05d} {name} {site}"
        lead = out.shape[0]
        for p in self.positions:
            if lead % self.B == 0:
                rows = lead // self.B
                part = out[p * rows:(p + 1) * rows]
            else:
                part = out
            whole = out if out.numel() <= 64 else None
            self.stages[p].append((stage, part.detach().clone(), whole if whole is None
                                   else whole.detach().clone(), tuple(out.shape)))
        if cpu_args is not None and out.device.type != "cpu":
            self.n_checked += 1
            want = func(*cpu_args[0], **cpu_args[1])
            got = out.detach().cpu()
            if isinstance(want, torch.Tensor) and want.shape == got.shape and \
                    not torch.equal(torch.nan_to_num(got, nan=7e7), torch.nan_to_num(want, nan=7e7)):
                d = (got.double() - want.double()).abs().nan_to_num(0.0)
                share = float((got != want).float().mean())
                self.xdev.append((stage, float(d.max()), share))
        return out


def _to_cpu(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    if isinstance(a, torch.device) and a.type != "cpu":
        return torch.device("cpu")
    return a


def record_run(pd, depths, rgbs, K, positions, on_cpu=False, solve=None):
    """One detect_fused_batch of all of ``depths`` on ``pd`` under a
    StageRecorder; returns (recorder, the match record's rows, the flat NMS
    record's rows and the Pose lists at ``positions``)."""
    from object_detector_6d_tpu_torch.refine import projective

    B = len(depths)
    rec = StageRecorder(B, positions, on_cpu)
    real = projective._gn_solve
    if solve is not None:
        projective._gn_solve = solve
    try:
        with rec:
            handle = pd.detect_fused_dispatch(depths, K, rgbs)
        flat = handle[0].cpu()
        results = pd.detect_fused_finalize(handle)
    finally:
        projective._gn_solve = real
    match = cs.match_record(pd, depths, rgbs, K)
    return rec, {p: (match[p], flat[p], results[p]) for p in positions}


def pose_arrays(poses):
    return [(p.class_id, p.template_id, p.match_x, p.match_y, p.num_votes,
             p.match_similarity, p.residual, p.pose.tobytes()) for p in poses]


def compare_stages(got, want):
    """Stage by stage, bitwise (NaN equal to NaN): (stages compared,
    differing [(stage, max |diff|)], stages whose shapes do not pair)."""
    if [s[0].split(" ", 1)[1] for s in got] != [s[0].split(" ", 1)[1] for s in want]:
        raise AssertionError("the stage sequence differs between the two runs")
    differ, unpaired = [], 0
    for (name, part, whole, shape), (_, wpart, wwhole, wshape) in zip(got, want):
        if part.shape == wpart.shape:
            a, b = part, wpart
        elif whole is not None and shape == wshape:
            a, b = whole, wwhole if wwhole is not None else wpart
        else:
            unpaired += 1
            continue
        a, b = a.cpu(), b.cpu()
        if not torch.equal(torch.nan_to_num(a, nan=7e7), torch.nan_to_num(b, nan=7e7)):
            differ.append((name, float((a.double() - b.double()).abs().nan_to_num(0.0).max())))
    return len(got), differ, unpaired


def batch_mode(label, pd, depths, rgbs, K, batches, forms, gpu):
    """Frame 0 at position 0 and frame B-1 at the end of each batch held
    against the same frame alone, for each form of the solve."""
    out = {}
    solves = {"port": None, "matmul": gn_solve_matmul}
    for form in forms:
        alone = {}
        for f in sorted({0} | {B - 1 for B in batches}):
            rgb = None if rgbs is None else rgbs[f:f + 1]
            alone[f] = record_run(pd, depths[f:f + 1], rgb, K, (0,), solve=solves[form])
        res = {}
        for B in batches[1:]:
            rgb = None if rgbs is None else rgbs[:B]
            rec, rows = record_run(pd, depths[:B], rgb, K, (0, B - 1), solve=solves[form])
            for pos in (0, B - 1):
                a_rec, a_rows = alone[pos]
                n, differ, unpaired = compare_stages(rec.stages[pos], a_rec.stages[0])
                m, fl, po = rows[pos]
                am, afl, apo = a_rows[0]
                flat_eq = torch.equal(torch.nan_to_num(fl, nan=7e7), torch.nan_to_num(afl, nan=7e7))
                poses_eq = pose_arrays(po) == pose_arrays(apo)
                key = f"B={B} frame {pos}"
                res[key] = {"stages": n, "unpaired": unpaired, "differing": len(differ),
                            "first": differ[0] if differ else None,
                            "match_equal": torch.equal(m, am), "flat_equal": flat_eq,
                            "poses_equal": poses_eq}
                cs.log(f"[{label}] {form}: frame {pos} at position {pos} of B={B} against "
                       f"alone: {len(differ)} of {n} stages differ ({unpaired} unpaired); "
                       f"first {differ[0] if differ else None}; next {differ[1:4]}; match "
                       f"record equal {res[key]['match_equal']}, flat record equal {flat_eq}, "
                       f"Pose arrays equal {poses_eq}; {gpu}")
        out[form] = res
    return out


def objb_lanes(pd, match_row, n_lanes_per_frame, K_cap):
    """Lane offsets (within a frame) of the coarse ICP lanes whose candidate
    is an objB template: lanes are [K, S] per frame."""
    bank = pd.detector.get_bank()
    S = n_lanes_per_frame // K_cap
    tids = match_row[3, :-1].to(torch.int64).tolist()
    keep = match_row[4, :-1].tolist()
    return [k * S + s for k in range(K_cap) for s in range(S)
            if keep[k] > 0 and bank.class_ids[tids[k]] == "objB"]


def final_pose_gaps(pd, got, want, match_row):
    """Each candidate slot whose refined pose (detect_program.py's
    ``final``, before the cluster stage) differs between two stage records
    of a frame: (slot, class, template, x, y, max |dt| mm)."""
    import object_detector_6d_tpu_torch.api.detect_program as dp

    lines = pathlib.Path(dp.__file__).read_text().splitlines()
    line = next(i + 1 for i, t in enumerate(lines) if "final = torch.matmul(" in t)
    stage = next(i for i, s in enumerate(got) if s[0].endswith(f"detect_program.py:{line}"))
    a, b = got[stage][1][0].cpu().double(), want[stage][1][0].cpu().double()
    bank = pd.detector.get_bank()
    out = []
    for k in range(a.shape[0]):
        dt = float((a[k, :3, 3] - b[k, :3, 3]).abs().nan_to_num(0.0).max()) * 1e3
        if dt > 0 or not torch.equal(a[k].nan_to_num(7e7), b[k].nan_to_num(7e7)):
            tid = int(match_row[3, k])
            out.append((k, bank.class_ids[tid], int(bank.local_tids[tid]), int(match_row[0, k]),
                        int(match_row[1, k]), dt))
    return out


def xdev_mode(pd, depths, K, gpu):
    """Card-vs-CPU stage mode on phase 4's depth-only frames 0 and 1."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    label = "card vs cpu"
    cpu_pd = PoseDetector(detector=pd.detector, params=pd.params,
                          model_points=pd.model_points, device="cpu")
    cpu_pd.views = pd.views
    d = depths[:2]
    card, crow = record_run(pd, d, None, K, (0, 1), on_cpu=True)
    cpu, prow = record_run(cpu_pd, d, None, K, (0, 1))
    sites = {}
    for stage, dmax, share in card.xdev:
        site = stage.split(" ", 2)[1:]
        key = " ".join(site)
        n, dm, sh = sites.get(key, (0, 0.0, 0.0))
        sites[key] = (n + 1, max(dm, dmax), max(sh, share))
    cs.log(f"[{label}] (a) {len(card.xdev)} of {card.n_checked} calls on the card differ from "
           f"the same call on the CPU on the card's own inputs; by function and site "
           f"(calls, max |diff|, largest differing share): {sites}; first calls "
           f"{card.xdev[:6]}; {gpu}")
    K_cap = pd._capacities(None)[0]
    coarse = pd.params.num_seeds * K_cap
    res = {"calls": card.n_checked, "calls_differing": len(card.xdev), "sites": sites}
    for f in (0, 1):
        n, differ, unpaired = compare_stages(card.stages[f], cpu.stages[f])
        lanes = objb_lanes(pd, crow[f][0], coarse, K_cap)
        first_b = None
        for (name, part, _, _), (_, wpart, _, _) in zip(card.stages[f], cpu.stages[f]):
            if lanes and part.shape == wpart.shape and part.dim() and part.shape[0] == coarse:
                a, b = part[lanes].cpu(), wpart[lanes]
                if not torch.equal(torch.nan_to_num(a, nan=7e7), torch.nan_to_num(b, nan=7e7)):
                    first_b = (name, float((a.double() - b.double()).abs().nan_to_num(0.0).max()))
                    break
        gap = {}
        for cls in ("objA", "objB"):
            c = [p for p in crow[f][2] if p.class_id == cls]
            g = [p for p in prow[f][2] if p.class_id == cls]
            gap[cls] = ("count", len(c), len(g)) if len(c) != len(g) else max(
                [float(np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max()) * 1e3
                 for a, b in zip(c, g)] + [0.0])
        slots = final_pose_gaps(pd, card.stages[f], cpu.stages[f], crow[f][0])
        res[f"frame {f}"] = {"stages": n, "differing": len(differ), "unpaired": unpaired,
                             "first": differ[0] if differ else None,
                             "objB_lanes": lanes, "first_on_objB_lanes": first_b,
                             "match_equal": torch.equal(crow[f][0], prow[f][0]),
                             "pose_gap_mm": gap, "slots_apart": slots}
        cs.log(f"[{label}] (b) frame {f}: {len(differ)} of {n} stages differ ({unpaired} "
               f"unpaired); first {differ[0] if differ else None}; next {differ[1:6]}; on "
               f"objB's coarse lanes {lanes} first {first_b}; match record equal "
               f"{res[f'frame {f}']['match_equal']}; card vs cpu poses (mm, or counts) {gap}; "
               f"hypotheses whose refined pose differs (slot, class, template, x, y, mm) "
               f"{slots}")
    return res


def time_mode(dev, gpu):
    """ms per B=32 two-modality batch and the device operations per span."""
    scenes = cs.scenes_module()
    K = scenes.K_DEFAULT
    pd2 = cs.train(cs.two_modality_bank(), dev, scenes, K)
    depths2, rgbs2, _ = cs.make_frames(scenes, K, cs.B, seed=cs.SEED2)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd2.detect_fused_batch(depths2, K, rgbs2)  # returns host poses: it has synchronised
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times[1:])
    counts, cats = cs.trace_ops(pd2, depths2, rgbs2, K)
    import object_detector_6d_tpu_torch as port

    cs.log(f"[time] {port.__file__}: median {ms:.2f} ms per B={cs.B} two-modality batch "
           f"(5 runs after 1 warm-up; runs {[round(t, 2) for t in times]}); device operations "
           f"per span of one batch {counts}; trace event categories {cats}; {gpu}")
    return {"package": port.__file__, "batch_ms": ms, "runs_ms": times, "device_ops": counts}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", default="cuda:0", help="the device under test")
    ap.add_argument("--device", default=None,
                    help="cpu: the card-vs-CPU stage mode against this device")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--root", default=None, help="import the port from this directory")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    dev = torch.device(args.card)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("batch_probe: no CUDA card", file=sys.stderr)
        return 2
    from object_detector_6d_tpu_torch.api.detector import Detector

    gpu = cs.gpu_line() if dev.type == "cuda" else "cpu"
    if args.time:
        if dev.type != "cuda":
            print("batch_probe: --time measures a CUDA card", file=sys.stderr)
            return 2
        print(json.dumps({"gpu": gpu, **time_mode(dev, gpu)}), flush=True)
        return 0
    scenes = cs.scenes_module()
    K = scenes.K_DEFAULT
    res = {"gpu": gpu}
    batches = BATCHES[:3] if args.quick else BATCHES
    n = max(batches)
    pd1 = cs.train(cs.add_distractors(Detector(modalities=("DepthNormal",))), dev, scenes, K)
    depths1, _, _ = cs.make_frames(scenes, K, n, seed=cs.SEED)
    if args.device is not None:
        if torch.device(args.device).type != "cpu":
            raise SystemExit("--device takes cpu")
        res["card vs cpu"] = xdev_mode(pd1, depths1, K, gpu)
    else:
        if not args.quick:
            pd2 = cs.train(cs.two_modality_bank(), dev, scenes, K)
            depths2, rgbs2, _ = cs.make_frames(scenes, K, n, seed=cs.SEED2)
            res["two-modality"] = batch_mode("two-modality", pd2, depths2, rgbs2, K, batches,
                                             ("port", "matmul"), gpu)
        res["depth-only"] = batch_mode("depth-only", pd1, depths1, None, K, batches,
                                       ("port", "matmul"), gpu)
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
