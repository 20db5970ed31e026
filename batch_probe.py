"""Where does a frame's answer depend on the batch it came in, or differ
between the card and the CPU? One CUDA card.

    python3 batch_probe.py                     # batch mode
    python3 batch_probe.py --device cpu        # card-vs-CPU stage mode
    python3 batch_probe.py --time [--root DIR] # ms per batch, lift + ICP ops
    python3 batch_probe.py --card cpu --quick  # a rehearsal on the CPU

A stage is one floating-point result of a torch call made inside the
detect program's lift + ICP (``lift_and_refine``) and cluster
(``make_cluster_stage``) stages, recorded by a TorchFunctionMode, or of
one of ``core/exact.py``'s helpers called there (the helper is the
stage: its torch calls differ by device by design); it is named by its
order, the function, the port's file:line that made it and the line of
the stage's own closure; the match record [5, K+1] comes before them,
and the flat NMS record and the Pose arrays after them.

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

Card-vs-CPU stage mode (``--device cpu``): chip_smoke.py phase 3's
two-modality and phase 4's depth-only frames 0 and 1 at B = 2 on the
card and through a CPU PoseDetector. Every stage is held twice: (a) the
card's call re-run on the CPU on copies of the card's own inputs, which
names every call whose CPU result differs from the card's on the same
inputs; (b) the card's run against the CPU run, which names the first
stage where the two runs part, for the frame and for the lanes of its
objB hypotheses. The same two holds run over every call inside
``clean_depth`` (phase 11's noisy snowman frame) and PPF's
``_train_pairs`` and ``_match_refs`` (phase 11's snowman model and
scene).

``--time``: ms per B=32 two-modality batch (host clock, median of 5 after
one warm-up), the device operations (kernels, copies, fills) launched
inside the ``detect.lift_icp`` and ``detect.cluster`` spans of one batch
(a torch.profiler trace, through chip_smoke.py ``trace_spans``, which
switches the port's spans on with ``profiling.enable(True)`` for it) and
``clean_depth``'s ms per 480x640 frame (CUDA events). ``--root DIR``
imports the port from DIR (an unpacked copy of another commit), so that
two commits are timed in turns by one script. The last line is one JSON object.
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
# the recorded regions: functions (by name) of the port's files
DETECT_REGIONS = {"api/detect_program.py": ("lift_and_refine", "cluster")}
TOOL_REGIONS = {"geom/cleaner.py": ("clean_depth",),
                "geom/plane.py": ("_block_planes", "_assign_pixels"),
                "ppf/detector.py": ("_train_pairs", "_match_refs"),
                "ppf/helpers.py": ("knn", "compute_normals_pc3d")}
# core/exact.py's helpers: each is one stage, re-run whole on the CPU
HELPERS = ("sqrt_rn", "sincos_rn", "sin_rn", "cos_rn", "exp_rn", "arccos_rn", "atan2_rn",
           "fma_rn", "fma_matmul", "norm3", "norm4", "sincos_device", "eigh3", "div_rn")


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


def port_site(pkg: str, regions):
    """(the port's file:line that made the current call, then the line of
    the region function it ran in; whether it ran inside a region)."""
    f = sys._getframe(2)
    first = None
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(pkg):
            rel = os.path.relpath(fn, pkg)
            site = f"{rel}:{f.f_lineno}"
            first = first or site
            if f.f_code.co_name in regions.get(rel, ()):
                return (first if first == site else f"{first} < {site}"), True
        f = f.f_back
    return first or "", False


class StageRecorder(TorchFunctionMode):
    """Records, for the frames at ``positions`` of a batch of ``B``, every
    floating-point tensor that a torch call or a ``core/exact.py`` helper
    inside a region returns (``regions``: DETECT_REGIONS by default): the
    rows of that frame where the leading axis is a multiple of B (every
    lane and frame axis of the program is frame-major), the whole tensor
    where it is small. With ``on_cpu``, each such call is also run on CPU
    copies of its inputs and the calls whose CPU result differs are kept
    in ``xdev``. The torch calls inside a helper are not recorded: the
    helper's result is the stage."""

    def __init__(self, B: int, positions, on_cpu: bool = False, regions=None):
        super().__init__()
        import object_detector_6d_tpu_torch as port

        self.pkg = str(pathlib.Path(port.__file__).parent)
        self.B, self.positions, self.on_cpu = B, tuple(positions), on_cpu
        self.regions = DETECT_REGIONS if regions is None else regions
        self.stages = {p: [] for p in self.positions}
        self.xdev = []  # (stage, max |card - cpu|, differing share)
        self.n_checked = 0
        self.in_helper = 0
        self.patched = []

    def __enter__(self):
        self._patch_helpers()
        return super().__enter__()

    def __exit__(self, *exc):
        for mod, name, fn in self.patched:
            setattr(mod, name, fn)
        self.patched = []
        return super().__exit__(*exc)

    def _patch_helpers(self):
        """Every module of the port that holds a core/exact.py helper gets
        a recording wrapper in its place, until __exit__."""
        from object_detector_6d_tpu_torch.core import exact

        helpers = {id(getattr(exact, n)) for n in HELPERS}
        wrapped = {}
        for mod in [m for n, m in sys.modules.items()
                    if n.startswith("object_detector_6d_tpu_torch") and m is not None]:
            for name, fn in list(vars(mod).items()):
                if id(fn) in helpers:
                    w = wrapped.setdefault(id(fn), self._wrap(fn))
                    self.patched.append((mod, name, fn))
                    setattr(mod, name, w)

    def _wrap(self, fn):
        def helper(*args, **kwargs):
            if self.in_helper:
                return fn(*args, **kwargs)
            site, inside = port_site(self.pkg, self.regions)
            self.in_helper += 1  # neither the helper's calls nor the recording are stages
            try:
                out = fn(*args, **kwargs)
                if inside:
                    self._keep(fn, fn.__name__, site, args, kwargs, out)
            finally:
                self.in_helper -= 1
            return out
        return helper

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.in_helper:
            return func(*args, **kwargs)
        site, inside = port_site(self.pkg, self.regions)
        if not inside:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        rerun = self.on_cpu and not name.endswith("_") and name != "__setitem__"
        cpu = torch.utils._pytree.tree_map(_to_cpu, (args, kwargs)) if rerun else None
        out = func(*args, **kwargs)
        self._keep(func if rerun else None, name, site, *(cpu or (None, None)), out,
                   on_copies=True)
        return out

    @staticmethod
    def _on_card(o) -> bool:
        return isinstance(o, torch.Tensor) and o.device.type != "cpu"

    def _keep(self, fn, name, site, args, kwargs, out, on_copies=False):
        """Record ``out`` (a tensor or a tuple of them) as stages; with
        ``on_cpu``, re-run ``fn`` on CPU copies of its inputs (``args``
        already are copies when ``on_copies``) and keep what differs."""
        outs = out if isinstance(out, tuple) else (out,)
        if not any(isinstance(o, torch.Tensor) and o.is_floating_point() and o.dim() > 0
                   for o in outs):
            return
        want = None
        if self.on_cpu and fn is not None and any(self._on_card(o) for o in outs):
            if not on_copies:
                args, kwargs = torch.utils._pytree.tree_map(_to_cpu, (args, kwargs))
            self.in_helper += 1  # the re-run's own calls are not stages
            try:
                want = fn(*args, **kwargs)
            finally:
                self.in_helper -= 1
            want = want if isinstance(want, tuple) else (want,)
        for k, o in enumerate(outs):
            if not (isinstance(o, torch.Tensor) and o.is_floating_point() and o.dim() > 0):
                continue
            tag = name if len(outs) == 1 else f"{name}[{k}]"
            stage = f"{len(self.stages[self.positions[0]]):05d} {tag} {site}"
            lead = o.shape[0]
            for p in self.positions:
                if lead % self.B == 0:
                    rows = lead // self.B
                    part = o[p * rows:(p + 1) * rows]
                else:
                    part = o
                whole = o if o.numel() <= 64 else None
                self.stages[p].append((stage, part.detach().clone(), whole if whole is None
                                       else whole.detach().clone(), tuple(o.shape)))
            if want is None:
                continue
            self.n_checked += 1
            got, w = o.detach().cpu(), want[k]
            if isinstance(w, torch.Tensor) and w.shape == got.shape and \
                    not torch.equal(torch.nan_to_num(got, nan=7e7), torch.nan_to_num(w, nan=7e7)):
                d = (got.double() - w.double()).abs().nan_to_num(0.0)
                share = float((got != w).float().mean())
                self.xdev.append((stage, float(d.max()), share))


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
    line = next(i + 1 for i, t in enumerate(lines) if "final = SE3.compose(" in t)
    stage = [i for i, s in enumerate(got) if s[0].endswith(f"detect_program.py:{line}")][-1]
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


def by_site(xdev):
    """The differing calls of a recorder, by function and site: (calls, max
    |diff|, largest differing share)."""
    sites = {}
    for stage, dmax, share in xdev:
        key = stage.split(" ", 1)[1]
        n, dm, sh = sites.get(key, (0, 0.0, 0.0))
        sites[key] = (n + 1, max(dm, dmax), max(sh, share))
    return sites


def xdev_mode(label, pd, depths, rgbs, K, gpu):
    """Card-vs-CPU stage mode on a workload's frames 0 and 1."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector

    cpu_pd = PoseDetector(detector=pd.detector, params=pd.params,
                          model_points=pd.model_points, device="cpu")
    cpu_pd.views = pd.views
    d = depths[:2]
    rgb = None if rgbs is None else rgbs[:2]
    card, crow = record_run(pd, d, rgb, K, (0, 1), on_cpu=True)
    cpu, prow = record_run(cpu_pd, d, rgb, K, (0, 1))
    sites = by_site(card.xdev)
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
        flat_eq = torch.equal(torch.nan_to_num(crow[f][1], nan=7e7),
                              torch.nan_to_num(prow[f][1], nan=7e7))
        poses_eq = pose_arrays(crow[f][2]) == pose_arrays(prow[f][2])
        res[f"frame {f}"] = {"stages": n, "differing": len(differ), "unpaired": unpaired,
                             "first": differ[0] if differ else None,
                             "objB_lanes": lanes, "first_on_objB_lanes": first_b,
                             "match_equal": torch.equal(crow[f][0], prow[f][0]),
                             "flat_equal": flat_eq, "poses_equal": poses_eq,
                             "pose_gap_mm": gap, "slots_apart": slots}
        cs.log(f"[{label}] (b) frame {f}: {len(differ)} of {n} stages differ ({unpaired} "
               f"unpaired); first {differ[0] if differ else None}; next {differ[1:6]}; on "
               f"objB's coarse lanes {lanes} first {first_b}; match record equal "
               f"{res[f'frame {f}']['match_equal']}, flat record equal {flat_eq}, Pose arrays "
               f"equal {poses_eq}; card vs cpu poses (mm, or counts) {gap}; hypotheses whose "
               f"refined pose differs (slot, class, template, x, y, mm) {slots}")
    return res


def stage_xdev(label, run, dev, gpu):
    """Card-vs-CPU stage mode over one call of a depth tool: ``run(device)``
    under TOOL_REGIONS, (a) every card call re-run on the CPU on its own
    inputs, (b) the card's run against the CPU's, stage by stage."""
    card = StageRecorder(1, (0,), on_cpu=True, regions=TOOL_REGIONS)
    with card:
        run(dev)
    cpu = StageRecorder(1, (0,), regions=TOOL_REGIONS)
    with cpu:
        run(torch.device("cpu"))
    sites = by_site(card.xdev)
    n, differ, unpaired = compare_stages(card.stages[0], cpu.stages[0])
    cs.log(f"[{label}] (a) {len(card.xdev)} of {card.n_checked} calls on the card differ from "
           f"the same call on the CPU on the card's own inputs; by function and site: {sites}; "
           f"(b) {len(differ)} of {n} stages of the two runs differ ({unpaired} unpaired); first "
           f"{differ[0] if differ else None}; next {differ[1:4]}; {gpu}")
    return {"calls": card.n_checked, "calls_differing": len(card.xdev), "sites": sites,
            "stages": n, "differing": len(differ), "first": differ[0] if differ else None}


def tools_xdev(dev, gpu):
    """Stage mode over clean_depth, extract_planes, PPF's training and
    matching and its PCA normals, on chip_smoke.py phase 11's inputs (PPF
    matches both devices against the CPU's trained tables, so that the two
    runs take the same inputs)."""
    from object_detector_6d_tpu_torch.geom.cleaner import clean_depth
    from object_detector_6d_tpu_torch.geom.plane import extract_planes
    from object_detector_6d_tpu_torch.ppf import detector as ppf
    from object_detector_6d_tpu_torch.ppf.helpers import compute_normals_pc3d

    scenes = cs.scenes_module()
    noisy = cs.noisy_snowman(scenes)
    cloud, _ = cs.plane_cloud(scenes, scenes.K_DEFAULT)
    model, scene, _ = cs.ppf_inputs(scenes)
    trained = ppf.PPFDetector(device="cpu")
    trained.train_model(model)

    def match(d):
        det = ppf.PPFDetector(device=str(d))
        for k in ("model_sampled", "model_diameter", "_keys_sorted", "_vals_i", "_vals_alpha"):
            setattr(det, k, getattr(trained, k))
        return det.match(scene)

    return {
        "clean_depth": stage_xdev("clean_depth card vs cpu",
                                  lambda d: clean_depth(noisy, device=d), dev, gpu),
        "ppf train": stage_xdev("ppf train card vs cpu", lambda d: ppf._train_pairs(
            torch.as_tensor(trained.model_sampled, device=d), trained._dist_step(),
            trained.num_angles), dev, gpu),
        "ppf match": stage_xdev("ppf match card vs cpu", match, dev, gpu),
        "extract_planes": stage_xdev("extract_planes card vs cpu",
                                     lambda d: extract_planes(cloud, device=d), dev, gpu),
        "ppf normals": stage_xdev("ppf normals card vs cpu", lambda d: compute_normals_pc3d(
            model[::8, :3], device=d), dev, gpu),
    }


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
    from object_detector_6d_tpu_torch.geom.cleaner import clean_depth

    frame = torch.as_tensor(cs.noisy_snowman(scenes), device=dev)
    clean_ms = cs.cuda_ms(lambda: clean_depth(frame))
    cs.log(f"[time] {port.__file__}: median {ms:.2f} ms per B={cs.B} two-modality batch "
           f"(5 runs after 1 warm-up; runs {[round(t, 2) for t in times]}); device operations "
           f"per span of one batch {counts}; trace event categories {cats}; clean_depth "
           f"{clean_ms:.4f} ms per 480x640 frame (CUDA events); {gpu}")
    return {"package": port.__file__, "batch_ms": ms, "runs_ms": times, "device_ops": counts,
            "clean_depth_ms": clean_ms}


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
        res["card vs cpu"] = xdev_mode("depth-only card vs cpu", pd1, depths1, None, K, gpu)
        if not args.quick:
            pd2 = cs.train(cs.two_modality_bank(), dev, scenes, K)
            depths2, rgbs2, _ = cs.make_frames(scenes, K, n, seed=cs.SEED2)
            res["two-modality card vs cpu"] = xdev_mode("two-modality card vs cpu", pd2,
                                                        depths2, rgbs2, K, gpu)
            res["tools card vs cpu"] = tools_xdev(dev, gpu)
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
