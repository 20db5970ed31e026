"""The benchmark of object_detector_6d_tpu_torch on one H100.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once, from the root of a checkout. The
cell names a configuration (``bench_port/configs/<config>.json``: the
bank and the program's settings) and a traffic mix
(``bench_port/traffic/<traffic>.json``: entry, batch, batches in flight,
pool, placements); the mix's entry (``bench_port/entries/<entry>.py``)
is the program under test with its reference and comparison; its
per-layer metrics are readers in ``bench_port/metrics/<name>.py`` and its
compared numbers' limits are in ``bench_port/limits/<cell>.json``.
Nothing here is specific to a cell or a program.

Set-up makes the configuration's template bank (``bench_port/bank.py``),
hands it to the program (the entry), renders a pool of ``pool_batches`` x B
distinct frames from the seed on the card into page-locked host memory
(with their ground-truth translations and the camera), applies the
entry's calibration over the pool and warms the loop; it ends with
``gc.collect(); gc.freeze()``. The window is a closed loop that keeps
``ahead`` batches dispatched: it finalizes the oldest, then dispatches the
next batch of the pool, until ``--seconds`` have passed. The rate is the
frames returned over the window's length (from its start to the last
finalize); the host ms of every call are kept for the log and for the
per-layer metrics. ``--trace 1`` runs the same window, then
``torch.profiler`` over ``traced_batches`` steady batches with the
program's own spans off, then, for an entry that can switch them on,
``bench_port/program_trace.py``'s host pass and device pass, and reports
the per-layer metrics. Every metric, end-to-end or per-layer, is read by
``bench_port/metrics/<name>.py``.

After the window, with the program freed, the entry's plain reference
answers the sampled frames (``sample_frames``, drawn from the seed) from
the same pool and bank, and the entry's comparison holds the program's
answers for them to the reference's (``bench_port/compare.py`` judges the
numbers against the limits). The last line on stdout is the result's
JSON.
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

# one process with few threads: the port's host work is single-threaded
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench_port"
FORBIDDEN = ("jax", "jaxlib", "flax", "object_detector_6d_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_start_s() -> float:
    """Wall-clock time at which this process started (/proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, root: pathlib.Path = ROOT):
    """The cell's entry in BENCHMARK.json, its configuration, traffic mix,
    limits and per-layer metrics, found by name under ``root`` (the
    checkout's root)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / cfg_entry["file"])
    mix = load_json(root / "bench_port" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "bench_port" / "limits" / f"{workload}.json")
    per_layer = [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    return cell, cfg, mix, limits, end_to_end, per_layer


def reader(name: str):
    """The ``read`` of ``bench_port/metrics/<name>.py`` (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + name.replace(".", "__"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def smi() -> str:
    """The card's name, power limit, SM clock, power draw and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: no reading"


class GcWatch:
    """Collector pauses (gc.callbacks) while installed."""

    def __init__(self):
        self.pauses, self._t = [], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((time.perf_counter() - self._t) * 1e3)
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def summary(self) -> str:
        p = self.pauses
        return (f"{len(p)} collector pauses, {sum(p):.2f} ms in all, longest "
                f"{max(p, default=0.0):.2f} ms")


class Loop:
    """The closed loop: ``ahead`` batches dispatched, the oldest finalized
    before the next is dispatched. Keeps the sampled frames' answers."""

    def __init__(self, entry, ahead: int, sample):
        self.entry, self.ahead = entry, ahead
        self.inflight = collections.deque()
        self.next = 0
        self.rows = collections.defaultdict(list)  # pool batch -> sampled rows
        for idx in sample:
            self.rows[idx // entry.B].append(idx % entry.B)
        self.answers = {}  # pool frame -> the latest answer
        self.host = {"dispatch": [], "finalize": []}

    def dispatch(self, timed=False):
        t = time.perf_counter()
        self.inflight.append((self.next % self.entry.n_batches, self.entry.dispatch(self.next)))
        self.next += 1
        if timed:
            self.host["dispatch"].append((time.perf_counter() - t) * 1e3)

    def finalize(self, timed=False) -> int:
        t = time.perf_counter()
        j, h = self.inflight.popleft()
        n, kept = self.entry.finalize(h, self.rows.get(j, ()))
        if timed:
            self.host["finalize"].append((time.perf_counter() - t) * 1e3)
        for r, ans in kept.items():
            self.answers[j * self.entry.B + r] = ans
        return n

    def fill(self):
        while len(self.inflight) < self.ahead:
            self.dispatch()

    def drain(self):
        while self.inflight:
            self.finalize()

    def window(self, seconds: float):
        """-> (frames returned, seconds) of a window of at least ``seconds``;
        the host ms of each call go to ``self.host`` and the time of each
        finalize's end to ``self.ends``."""
        frames = 0
        t0 = time.perf_counter()
        self.ends = []
        while True:
            frames += self.finalize(True)
            t = time.perf_counter() - t0
            self.ends.append(t)
            if t >= seconds:
                return frames, t
            self.dispatch(True)


def steps_summary(loop: Loop) -> str:
    """Quartiles of the window's host ms a call and the batches a third."""
    import statistics

    def q(v):
        return "/".join(f"{x:.1f}" for x in statistics.quantiles(v, n=4)) if len(v) > 1 else "-"

    ends = loop.ends
    thirds = [sum(1 for e in ends if k * ends[-1] / 3 <= e < (k + 1) * ends[-1] / 3)
              for k in range(3)]
    return (f"host ms a call, quartiles: dispatch {q(loop.host['dispatch'])}, finalize "
            f"{q(loop.host['finalize'])}; batches finalized in each third of the window {thirds}")


def traced_window(loop: Loop, n: int) -> dict:
    """torch.profiler over ``n`` steady steps of the loop (then the drain,
    so the operations the window launched are all recorded); the trace is
    reduced and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench_port.trace import reduce_trace

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities) as prof:
            with record_function("bench.window"):
                for _ in range(n):
                    with record_function("bench.finalize"):
                        loop.finalize()
                    with record_function("bench.dispatch"):
                        loop.dispatch()
            loop.drain()
            if on_card:
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        log(f"trace: {os.path.getsize(path) / 1e6:.1f} MB")
        return reduce_trace(path, n)


def set_up(cfg: dict, mix: dict, seed: int, device, part=lambda name, t: None):
    """The entry's module and kernels, the bank, the entry, the pool, the
    sample, the calibration and a warm loop, each timed by ``part(name,
    start)``; ends with ``gc.collect(); gc.freeze()``. -> (entry module,
    bank, entry, pool, sample, loop)."""
    t = time.time()
    import numpy as np
    import torch

    from bench_port import bank as bank_mod
    from bench_port import frames
    entry_mod = importlib.import_module(f"bench_port.entries.{mix['entry']}")  # the program
    part("import", t)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        t = time.time()
        entry_mod.load_kernels()
        part("kernel library load", t)
        torch.cuda.reset_peak_memory_stats()
    t = time.time()
    bank = bank_mod.make_bank(cfg, device)
    part("bank", t)
    t = time.time()
    entry = entry_mod.Entry(cfg, mix, bank, device, log)
    part("program set-up", t)
    t = time.time()
    n_pool = entry.B * int(mix["pool_batches"])
    maker = frames.FrameMaker(cfg["objects"], mix["placements"], device=device)
    pool = frames.make_pool(maker, n_pool, seed, pin=on_card)
    del maker
    entry.set_pool(pool)
    if on_card:
        torch.cuda.synchronize()
    part("frame pool", t)
    t = time.time()
    entry.calibrate()
    rng = np.random.default_rng([abs(int(seed)), 1])
    sample = sorted(int(i) for i in rng.choice(n_pool, int(mix["sample_frames"]),
                                               replace=False))
    loop = Loop(entry, int(mix["ahead"]), sample)
    loop.fill()
    for _ in range(int(mix["pool_batches"]) + 1):
        loop.finalize()
        loop.dispatch()
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    part("warm-up", t)
    return entry_mod, bank, entry, pool, sample, loop


def run_cell(workload: str, cfg: dict, mix: dict, limits: dict, end_to_end, per_layer,
             seed: int, seconds: float, trace: bool, device="cuda", started=None) -> dict:
    """Set-up, the window, the comparison; returns the result's JSON."""
    started = time.time() if started is None else started
    parts = {"start": time.time() - started}  # interpreter, torch, the card's context
    log(f"set-up: start {parts['start']:.2f} s")

    def part(name, t):
        parts[name] = time.time() - t
        log(f"set-up: {name} {parts[name]:.2f} s")

    import torch

    from bench_port import compare

    on_card = torch.device(device).type == "cuda"
    entry_mod, bank, entry, pool, sample, loop = set_up(cfg, mix, seed, device, part)
    B = entry.B
    log(f"{entry.summary()}; pool {pool.depth.shape[0]} frames; sample {sample}")
    card = smi() if on_card else "cpu"
    log(f"card at the window's start: {card}")
    setup_s = time.time() - started
    with GcWatch() as watch:
        frames_done, window_s = loop.window(seconds)
    log(steps_summary(loop))
    card_end = smi() if on_card else "cpu"
    log(f"window: {frames_done} frames in {window_s:.3f} s ({frames_done // B} batches of {B}); "
        f"{watch.summary()}")
    log(f"card at the window's end: {card_end}")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"memory peak {memory_peak} bytes")
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name() if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None
    if trace:
        n = int(mix["traced_batches"])
        red = traced_window(loop, n)
        run = {"host": loop.host, "trace": red, "shapes": entry.shapes()}
        log("per span a batch: " + json.dumps(red["spans"]))
        if hasattr(entry, "program_spans"):
            from bench_port import program_trace

            run["program"], dev = program_trace.passes(loop, n)
            log(f"program's host pass: {json.dumps(run['program']['host'])}; device pass, a "
                f"batch: {json.dumps(dev['program'])}")
        for m in per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    else:
        run = {"frames": frames_done, "window_s": window_s, "setup_s": setup_s}
        for m in end_to_end:
            metrics[m["name"]] = {"value": float(reader(m["name"])(run)), "unit": m["unit"]}
    loop.drain()
    log("set-up parts: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items())
        + f"; setup_s {setup_s:.2f} s")

    # the comparison, with the program freed
    state = entry.reference_state()
    got = loop.answers
    entry.free()
    del loop, entry
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.time()
    want = entry_mod.reference_answers(cfg, bank, pool, sample, state, device)
    numbers = entry_mod.compare(got, want, pool, sample)
    log(f"reference: {len(sample)} frames in {time.time() - t:.1f} s")
    correct = compare.judge(numbers, limits)
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    out = {"correct": bool(correct), "attempted": int(frames_done), "failed": 0,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    started = process_start_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix, limits, end_to_end, per_layer = resolve(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA card(s); torch.cuda.is_available() "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible")
        return 2
    torch.cuda.set_device(0)
    result = run_cell(args.workload, cfg, mix, limits, end_to_end, per_layer, args.seed,
                      args.seconds, bool(args.trace), "cuda", started)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"the process holds {loaded}: the benchmark may not load them")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
