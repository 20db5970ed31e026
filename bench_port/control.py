"""Readings for a cell's limits: the program's and the control's numbers
over many seeds, in one process.

    python3 -m bench_port.control --workload <cell> --seeds 11,12,13 --seconds 3

The bank and the program (the cell's entry) are built once. For each
seed the pool is rendered, the entry's calibration applied, the program
run in a short closed loop at the cell's batch (every sampled frame
answered at least once) and the sampled frames' answers compared with the
entry's plain reference's by the entry's comparison (the lower
readings); then the control, the reference in the entry's ``CONTROL``
precision, answers the same frames and is compared with the reference
(the upper readings). One JSON line a seed on stdout. The benchmark's own
runs do not run this.
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

    from bench_port import bank as bank_mod
    from bench_port import compare, frames

    on_card = args.device == "cuda"
    entry_mod = importlib.import_module(f"bench_port.entries.{mix['entry']}")
    bank = bank_mod.make_bank(cfg, args.device)
    entry = entry_mod.Entry(cfg, mix, bank, args.device, run.log)
    maker = frames.FrameMaker(cfg["objects"], mix["placements"], device=args.device)
    n_pool = entry.B * int(mix["pool_batches"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        pool = frames.make_pool(maker, n_pool, seed, pin=on_card)
        entry.set_pool(pool)
        entry.calibrate()
        rng = np.random.default_rng([abs(seed), 1])
        sample = sorted(int(i) for i in rng.choice(n_pool, int(mix["sample_frames"]),
                                                   replace=False))
        loop = run.Loop(entry, int(mix["ahead"]), sample)
        loop.fill()
        frames_done, window_s = loop.window(args.seconds)
        loop.drain()
        state = entry.reference_state()
        want = entry_mod.reference_answers(cfg, bank, pool, sample, state, args.device)
        low = entry_mod.reference_answers(cfg, bank, pool, sample, state, args.device,
                                          entry_mod.CONTROL)
        program = entry_mod.compare(loop.answers, want, pool, sample)
        control = entry_mod.compare(low, want, pool, sample)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "state": state,
            "frames": frames_done, "window_s": window_s,
            "answered": sum(i in loop.answers for i in sample),
            "program": program, "control": control, "limits": limits,
            "program_correct": compare.judge(program, limits),
            "control_correct": compare.judge(control, limits),
            "seconds": time.time() - t}), flush=True)
        del loop, pool
    return 0


if __name__ == "__main__":
    sys.exit(main())
