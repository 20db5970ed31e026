"""Readings for a cell's limits: the program's and the control's numbers
over many seeds, in one process.

    python3 -m bench_port.control --workload <cell> --seeds 11,12,13 --seconds 3

The bank, the program, the plain reference and the control (the
reference with every float step in bfloat16) are built once. For each
seed the pool is rendered, the threshold rule applied, the program run in
a short closed loop at the cell's batch (every sampled frame answered at
least once) and the sampled frames' records compared with the
reference's (the lower readings); then the control's records on the same
frames are compared with the reference's (the upper readings). One JSON
line a seed on stdout. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from bench_port import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, cfg, mix, limits, _, _ = run.resolve(spec, args.workload)

    import numpy as np
    import torch

    from bench_port import bank as bank_mod
    from bench_port import compare, frames

    on_card = args.device == "cuda"
    bank = bank_mod.make_bank(cfg, args.device)
    entry = importlib.import_module(f"bench_port.entries.{mix['entry']}").Entry(
        cfg, mix, bank, args.device, run.log)
    maker = frames.FrameMaker(cfg["objects"], mix["placements"], device=args.device)
    shape = (maker.H, maker.W)
    ref = run.reference(cfg, bank, entry.K_cap, shape, args.device)
    ctl = run.reference(cfg, bank, entry.K_cap, shape, args.device, "bfloat16")
    B = int(mix["batch"])
    n_pool = B * int(mix["pool_batches"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        depth, bgr, _ = frames.make_pool(maker, n_pool, seed, pin=on_card)
        entry.threshold = float(cfg["match_threshold"])
        entry.set_pool(depth, bgr)
        entry.calibrate()
        rng = np.random.default_rng([abs(seed), 1])
        sample = sorted(int(i) for i in rng.choice(n_pool, int(mix["sample_frames"]),
                                                   replace=False))
        loop = run.Loop(entry, int(mix["ahead"]), sample)
        loop.fill()
        frames_done, window_s = loop.window(args.seconds)
        loop.drain()
        idx = torch.as_tensor(sample)
        d, c = depth[idx], bgr[idx]
        want = dict(zip(sample, ref.match(d, c, entry.threshold)))
        low = dict(zip(sample, ctl.match(d, c, entry.threshold)))
        program, control = compare.compare_match(loop.answers, want), compare.compare_match(low, want)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "threshold": entry.threshold,
            "frames": frames_done, "window_s": window_s,
            "answered": sum(i in loop.answers for i in sample),
            "program": program, "control": control, "limits": limits,
            "program_correct": compare.judge(program, limits),
            "control_correct": compare.judge(control, limits),
            "seconds": time.time() - t}), flush=True)
        del loop, depth, bgr
    return 0


if __name__ == "__main__":
    sys.exit(main())
