"""End-to-end ADD-0.1d parity of the PyTorch port on tools/parity_add.py's
four scene sets, against the OpenCV oracle's goldens.

    python3 parity_torch.py [--device cuda|cpu] [--reference] [--json PATH]
                            {base,occl,two,views,all}

tools/parity_add.py is imported as it is: its scene sets, thresholds,
MODEL_POINTS, LIFT_WINDOW, ``add_metric``, ``golden_path`` and ``_report``.
The port is trained with its own ``add_view`` as ``parity_add.run_ours``
trains the JAX package, and each scene goes through
``PoseDetector.detect_fused`` at the default schedule
(``parity_add._our_detector``: threshold 70, 8 hypotheses, ICP 32
iterations / 4 levels) or the promoted one (+ 2 solves per association,
finest level 2 associations, 2 seeds, fine compaction 8). A frame with more
coarse candidates than the 8 slots goes through the host-orchestrated
``detect``; every frame of ``two`` and ``views`` does.

Per set and schedule it prints parity_add's table (the port is "ours"),
the scenes only the port gets and the scenes only the oracle gets
(ADD-0.1d successes), the count of frames that fell back, and the seconds
per frame. ``--reference`` runs the JAX package's ``detect_fused`` on the
same scenes on the CPU (the only mode that imports JAX) and prints the
scenes whose success differs between the two packages and the largest
ADD difference. The last lines are a summary table in PARITY.md's
columns. Exits 1 if the port's ADD-0.1d is below the oracle's on a set.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))
import parity_add  # noqa: E402

CONFIGS = ("base", "occl", "two", "views")
SCHEDULES = ("default", "promoted")


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=4)
def scene_data(config):
    """parity_add's scene set for ``config``: (K, training views as
    (class_id, depth, gray, mask, view_pose), frames as (label suffixes,
    truths, depth, gray), match threshold or None, golden)."""
    g = dict(np.load(parity_add.golden_path(config)))
    if config in ("base", "occl"):
        K, dep, gray, mask, scene_list = parity_add.scene_set(occlude=config == "occl")
        train = [("obj", dep, gray, mask, None)]
        frames = [((f"scene {i:2d}",), (gt,), d2, g2)
                  for i, (gt, d2, g2, _m2) in enumerate(scene_list)]
        thr = parity_add.OCCL_THRESHOLD if config == "occl" else parity_add.MATCH_THRESHOLD
    elif config == "two":
        K, tr, scene_list = parity_add.scene_set_two()
        train = [(cid, *tr[cid], None) for cid in ("objA", "objB")]
        frames = [((f"scene {i:2d} objA", f"scene {i:2d} objB"), (gtA, gtB), d2, g2)
                  for i, ((gtA, gtB), d2, g2, _m2) in enumerate(scene_list)]
        thr = None
    else:
        K, _dep, _gray, _mask, tr, scene_list = parity_add.scene_set_views()
        train = [("obj", d2, g2, m2, P) for (P, d2, g2, m2) in tr]
        frames = [((f"yaw {parity_add.TEST_DEGS[i]:+5.1f}",), (gt,), d2, g2)
                  for i, (gt, d2, g2, _m2) in enumerate(scene_list)]
        thr = None
    return K, train, frames, thr, g


def _models_and_threshold(config, g):
    """Per class: the golden's model points and the ADD-0.1d bound (the
    tighter class bound for ``two``, as parity_add.run_ours reports)."""
    if config == "two":
        models = {"objA": g["modelA"][:, :3], "objB": g["modelB"][:, :3]}
        return models, min(0.1 * float(g["diameterA"]), 0.1 * float(g["diameterB"]))
    return {"obj": g["model"][:, :3]}, 0.1 * float(g["diameter"])


def _bgr(gray):
    return np.repeat(gray[..., None], 3, axis=2)


def port_detector(schedule, device):
    """The port's counterpart of parity_add._our_detector at ``schedule``."""
    from object_detector_6d_tpu_torch.api.pipeline import PoseDetector
    from object_detector_6d_tpu_torch.core.config import DetectParams, ICPParams

    if schedule == "promoted":
        params = DetectParams(
            match_threshold=parity_add.MATCH_THRESHOLD, max_hypotheses=8,
            icp=ICPParams(iterations=32, num_levels=4, solves_per_assoc=2, finest_assoc=2),
            num_seeds=2, fine_compact=8)
    else:
        params = DetectParams(match_threshold=parity_add.MATCH_THRESHOLD, max_hypotheses=8,
                              icp=ICPParams(iterations=32, num_levels=4))
    return PoseDetector(params=params, model_points=parity_add.MODEL_POINTS,
                        scene_window=parity_add.LIFT_WINDOW, device=device)


@contextlib.contextmanager
def _promoted_env(schedule):
    old = os.environ.get("ODC_PROMOTED")
    os.environ["ODC_PROMOTED"] = "1" if schedule == "promoted" else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ODC_PROMOTED"]
        else:
            os.environ["ODC_PROMOTED"] = old


def reference_detector(schedule):
    """The JAX package's detector of parity_add.run_ours (CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    with _promoted_env(schedule):
        return parity_add._our_detector()


def run_set(pd, config):
    """Train ``pd`` on ``config``'s views and detect every frame. Returns
    {"rows": [(label, ADD, oracle ADD)], "bound": m, "fallback": frames,
    "frames": n, "s_per_frame": s}."""
    K, train, frames, thr, g = scene_data(config)
    models, bound = _models_and_threshold(config, g)
    for k, (cid, dep, gray, mask, P) in enumerate(train):
        tid = pd.add_view(cid, dep, K, mask.astype(np.uint8) * 255, rgb=_bgr(gray),
                          view_pose=P)
        assert tid >= 0, f"add_view {cid} failed"
    est_poses = g["est_poses"].reshape(len(g["est_found"]), -1, 4, 4)
    est_found = g["est_found"].reshape(len(g["est_found"]), -1)
    rows = []
    t0 = time.perf_counter()
    for i, (labels, gts, depth, gray) in enumerate(frames):
        kw = {} if thr is None else {"match_threshold": thr}
        poses = pd.detect_fused(depth, K, rgb=_bgr(gray), **kw)
        for j, (label, gt) in enumerate(zip(labels, gts)):
            cid = "objA" if label.endswith("objA") else "objB" if label.endswith("objB") \
                else "obj"
            best = next((p for p in poses if p.class_id == cid), None)
            ours = (parity_add.add_metric(np.asarray(best.pose), gt, models[cid])
                    if best is not None else np.nan)
            orc = (parity_add.add_metric(est_poses[i, j], gt, models[cid])
                   if est_found[i, j] else np.nan)
            rows.append((label, ours, orc))
    seconds = time.perf_counter() - t0
    return {"rows": rows, "bound": bound, "frames": len(frames),
            "fallback": int(pd.counters.counts.get("overflow_fallback", 0)),
            "s_per_frame": seconds / max(1, len(frames))}


def _hits(adds, bound):
    return {i for i, a in enumerate(adds) if np.isfinite(a) and a < bound}


def summarize(config, schedule, port, ref=None):
    """Print the comparison of one set; returns its summary record."""
    rows, bound = port["rows"], port["bound"]
    labels = [r[0] for r in rows]
    ours = [r[1] for r in rows]
    orc = [r[2] for r in rows]
    tag = f"{config}/{schedule}"
    log(f"\n===== {tag} =====")
    parity_add._report(tag, rows, bound)
    mine, theirs = _hits(ours, bound), _hits(orc, bound)
    n = len(rows)

    def stats(adds):
        fin = [a for a in adds if np.isfinite(a)]
        return {"detected": len(fin), "mean_add_mm": float(np.mean(fin)) * 1e3 if fin else None}

    rec = {"config": config, "schedule": schedule, "instances": n,
           "bound_mm": bound * 1e3,
           "port": {**stats(ours), "add_01d": 100.0 * len(mine) / n},
           "oracle": {**stats(orc), "add_01d": 100.0 * len(theirs) / n},
           "port_only": [labels[i] for i in sorted(mine - theirs)],
           "oracle_only": [labels[i] for i in sorted(theirs - mine)],
           "fallback": port["fallback"], "frames": port["frames"],
           "s_per_frame": port["s_per_frame"]}
    log(f"[{tag}] scenes only the port gets: {rec['port_only']}")
    log(f"[{tag}] scenes only the oracle gets: {rec['oracle_only']}")
    log(f"[{tag}] frames through the fallback: {port['fallback']}/{port['frames']}; "
        f"{port['s_per_frame']:.3f} s per frame")
    if ref is not None:
        radds = [r[1] for r in ref["rows"]]
        rh = _hits(radds, bound)
        both = [i for i in range(n) if np.isfinite(ours[i]) and np.isfinite(radds[i])]
        diff = max((abs(ours[i] - radds[i]) for i in both), default=0.0)
        found_diff = [labels[i] for i in range(n)
                      if np.isfinite(ours[i]) != np.isfinite(radds[i])]
        rec["reference"] = {**stats(radds), "add_01d": 100.0 * len(rh) / n,
                            "fallback": ref["fallback"], "s_per_frame": ref["s_per_frame"],
                            "success_differs": [labels[i] for i in sorted(mine ^ rh)],
                            "found_differs": found_diff, "max_add_diff_mm": diff * 1e3}
        r = rec["reference"]
        log(f"[{tag}] reference (JAX, CPU): {r['detected']}/{n} detected, mean ADD "
            f"{r['mean_add_mm']:.2f} mm, ADD-0.1d {r['add_01d']:.1f}%, fallback "
            f"{r['fallback']}, {r['s_per_frame']:.3f} s per frame")
        log(f"[{tag}] scenes where the port and the reference disagree (ADD-0.1d "
            f"success): {r['success_differs']}; found by one only: {found_diff}; "
            f"largest |ADD port - ADD reference| {r['max_add_diff_mm']:.4f} mm")
    return rec


def table(records):
    log("\n| Set | Schedule | Port detected | Port mean ADD | Port ADD-0.1d | Oracle detected "
        "| Oracle mean ADD | Oracle ADD-0.1d | Port only | Oracle only | Fallback "
        "| Reference ADD-0.1d | Disagree |")
    log("|" + " --- |" * 13)
    for r in records:
        n = r["instances"]
        ref = r.get("reference")
        log(f"| {r['config']} | {r['schedule']} | {r['port']['detected']}/{n} | "
            f"{r['port']['mean_add_mm']:.2f} mm | {r['port']['add_01d']:.1f}% | "
            f"{r['oracle']['detected']}/{n} | {r['oracle']['mean_add_mm']:.2f} mm | "
            f"{r['oracle']['add_01d']:.1f}% | {len(r['port_only'])} | "
            f"{len(r['oracle_only'])} | {r['fallback']}/{r['frames']} | "
            f"{'-' if ref is None else format(ref['add_01d'], '.1f') + '%'} | "
            f"{'-' if ref is None else len(ref['success_differs'])} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=CONFIGS + ("all",))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reference", action="store_true",
                    help="also run the JAX package on the CPU and compare scene by scene")
    ap.add_argument("--json", default=None, help="write the summary records here")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("parity_torch: no CUDA card; pass --device cpu", file=sys.stderr)
        return 2
    if args.device == "cuda":
        import subprocess

        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        log(f"card: {gpu}")
    configs = CONFIGS if args.config == "all" else (args.config,)
    records = []
    for config in configs:
        for schedule in SCHEDULES:
            port = run_set(port_detector(schedule, args.device), config)
            ref = run_set(reference_detector(schedule), config) if args.reference else None
            records.append(summarize(config, schedule, port, ref))
    table(records)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(records, indent=1))
    low = [f"{r['config']}/{r['schedule']}" for r in records
           if r["port"]["add_01d"] < r["oracle"]["add_01d"]]
    if low:
        log(f"ADD-0.1d below the oracle's on {low}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
