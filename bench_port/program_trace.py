"""The program's own spans and host-read counter (the port's
``utils/profiling.py``, switched by the entry's ``program_spans``), read
over steady batches of a cell:

    python3 -m bench_port.program_trace --workload <cell> --seed <n> [--cost-seconds 51]

Set-up is run.py's ``set_up``: the configuration's bank, the entry, the
pinned pool made from the seed, the calibration, a warm closed loop.
Then, over steady batches of that loop:

1. window 1: run.py's ``traced_window`` as the benchmark's traced run
   takes it, with the program's spans off (their default), read by the
   cell's per-layer readers. ``reduce_trace`` gives each operation to the
   innermost span around its launch, so with ``match.*`` spans open
   ``bench.match`` would keep almost nothing: the spans stay off there.
2. the host pass: spans on, no profiler (under torch.profiler every aten
   call and runtime call pays a callback, a large part of the launch time
   itself), ``HOST_BATCHES`` batches: host ms a batch inside the
   ``match.*`` spans and inside the ``sync.*`` spans, and the ``sync.*``
   counters' increments a batch.
3. the device pass: spans on, torch.profiler over the mix's
   ``traced_batches``: the device ms a batch of the operations launched
   under each ``match.*`` span, the blocking runtime calls launched under
   a ``match.*`` span inside and outside the ``sync.*`` spans, the idle
   gaps named by program span (trace.py ``reduce_trace``), and the
   in-memory record's stamps against the trace's.
4. one batch's record with the spans off and on, bitwise.
5. the spans' cost: frames/s over ``--cost-seconds`` windows, spans off,
   on, on, off.

Steps 1-3 are what the benchmark's own traced run (run.py) makes, for an
entry that has ``program_spans``; ``passes`` makes steps 2 and 3, and
its ``program`` goes under ``run["program"]``, where the nine readers
``bench_port/metrics/<name>.py`` of ``PROGRAM_METRICS`` read. Steps 4
and 5 are this module's alone. The last line on stdout is the result's
JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

from bench_port import run
from bench_port.trace import DEVICE_CATS, HOST_CALL_CATS, WINDOW_SPAN, reduce_trace

STAGES = ("match.quantize", "match.responses", "match.coarse", "match.topk", "match.refine",
          "match.post")
PROGRAM_METRICS = ("quantize_device_ms", "responses_device_ms", "coarse_device_ms",
                   "topk_device_ms", "refine_device_ms", "post_device_ms", "host_syncs",
                   "host_sync_wait_ms", "host_launch_ms")
# steady batches of the host pass: ~1 s of a B=128 batch every ~40 ms, and
# two K4 reads a batch, so a mean over 50 reads
HOST_BATCHES = 25
# runtime calls that block the host until the card has caught up (or
# that synchronise the device themselves)
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                      "cudaMemcpy", "cudaMalloc", "cudaFree"})


def blocking(name: str) -> bool:
    return name in BLOCKING or (name.startswith("cudaMemcpy") and "Async" not in name)


def _within(spans, t: float):
    """The first of ``spans`` [(name, start, end)] that holds ``t``, or None."""
    return next((name for name, s, e in spans if s <= t <= e), None)


def reduce_program_trace(path: str, n_batches: int) -> dict:
    """A torch.profiler Chrome trace with the program's spans on ->
    {"stages": {span: {"device_ms", "ops"} a batch}, "blocking":
    {"in_sync" | "outside_sync": {runtime call: count a batch}}}.

    An operation belongs to the ``match.*`` span around its launch, at any
    depth (K4's read is a ``sync.*`` span inside ``match.refine``); a
    blocking call counts when launched under a ``match.*`` span, split by
    whether a ``sync.*`` span holds it (the trace's times are us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    stage_spans, sync_spans, launches, calls, device = [], [], {}, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "user_annotation":
            span = (name, float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            if name.startswith("match."):
                stage_spans.append(span)
            elif name.startswith("sync."):
                sync_spans.append(span)
        elif cat in HOST_CALL_CATS:
            calls.append((name, float(ev["ts"])))
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(ev["ts"])
        elif cat in DEVICE_CATS:
            device.append(ev)
    stages: dict = {}
    for ev in device:
        launch = launches.get(ev.get("args", {}).get("correlation"))
        stage = None if launch is None else _within(stage_spans, launch)
        if stage is not None:
            rec = stages.setdefault(stage, {"device_ms": 0.0, "ops": 0})
            rec["device_ms"] += float(ev["dur"]) / 1e3
            rec["ops"] += 1
    held = {"in_sync": collections.Counter(), "outside_sync": collections.Counter()}
    for name, t in calls:
        if blocking(name) and _within(stage_spans, t) is not None:
            held["in_sync" if _within(sync_spans, t) is not None else "outside_sync"][name] += 1
    return {
        "stages": {k: {"device_ms": v["device_ms"] / n_batches, "ops": v["ops"] / n_batches}
                   for k, v in stages.items()},
        "blocking": {k: {name: c / n_batches for name, c in v.items()} for k, v in held.items()},
    }


def host_numbers(spans, counted: dict, n_batches: int) -> dict:
    """The host pass's numbers a batch from its record ``spans`` [(name,
    parent, t0_ns, t1_ns)] and the counters' increments ``counted``:
    ``spans_ms`` each ``match.*`` / ``sync.*`` span's host ms, ``match_ms``
    inside the ``match.*`` spans, ``sync_wait_ms`` inside the ``sync.*``
    spans, ``launch_ms`` the first less the second, and ``syncs``, the
    ``sync.*`` counters' increments."""
    spans_ms: dict = collections.defaultdict(float)
    for name, _, t0, t1 in spans:
        if name.startswith(("match.", "sync.")):
            spans_ms[name] += (t1 - t0) / 1e6 / n_batches

    def ms(prefix):
        return sum(v for k, v in spans_ms.items() if k.startswith(prefix))

    match_ms, sync_ms = ms("match."), ms("sync.")
    return {"spans_ms": dict(spans_ms), "match_ms": match_ms, "sync_wait_ms": sync_ms,
            "launch_ms": match_ms - sync_ms,
            "syncs": sum(v for k, v in counted.items() if k.startswith("sync.")) / n_batches}


def stage_ms(run_: dict, span: str):
    """A reader's value: device ms a batch under ``span``, or None."""
    return run_.get("program", {}).get("stages_ms", {}).get(span)


def host_value(run_: dict, key: str):
    """A reader's value: the host pass's ``key`` a batch, or None."""
    return run_.get("program", {}).get("host", {}).get(key)


def setup(cfg: dict, mix: dict, seed: int, device) -> run.Loop:
    """run.py's set-up: the bank, the entry, the pool, the calibration and
    a warm loop."""
    return run.set_up(cfg, mix, seed, device)[-1]


def warm(loop: run.Loop, n: int) -> None:
    """Fills the loop and runs ``n`` steps of it."""
    loop.fill()
    for _ in range(n):
        loop.finalize()
        loop.dispatch()


@contextlib.contextmanager
def spans_on(entry):
    """The program's spans on inside the block, off after it; the dict
    yielded gets ``spans``, the block's record, and ``counted``, the
    counters' increments over it."""
    rec = {}
    entry.program_spans(True)
    try:
        yield rec
    finally:
        rec["spans"], rec["counted"] = entry.program_spans(False)


def host_pass(loop: run.Loop, n: int = HOST_BATCHES) -> dict:
    """``n`` steady steps with the spans on and no profiler; the numbers of
    their ``n`` dispatches (a finalize runs no program span)."""
    with spans_on(loop.entry) as rec:
        for _ in range(n):
            loop.finalize()
            loop.dispatch()
    return host_numbers(rec["spans"], rec["counted"], n)


def device_pass(loop: run.Loop, n: int) -> dict:
    """run.py's ``traced_window`` with the spans on: torch.profiler over
    ``n`` steady steps, then the drain. -> {"trace": reduce_trace's
    numbers, "program": reduce_program_trace's, "clock_us": the record's
    span starts less their trace events' (ts + baseTimeNanoseconds/1e3)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with spans_on(loop.entry) as rec:
            with profile(activities=activities) as prof:
                with record_function(WINDOW_SPAN):
                    for _ in range(n):
                        with record_function("bench.finalize"):
                            loop.finalize()
                        with record_function("bench.dispatch"):
                            loop.dispatch()
                loop.drain()
                if on_card:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        out = {"trace": reduce_trace(path, n), "program": reduce_program_trace(path, n),
               "clock_us": clock_offsets(path, rec["spans"])}
    return out


def passes(loop: run.Loop, n: int, host_batches: int = HOST_BATCHES):
    """After a traced window: the host pass over ``host_batches`` steps and
    the device pass over ``n``, each from a warm loop. -> (``program``,
    the numbers the readers read: {"stages_ms": device ms a batch of each
    of ``STAGES`` found, "host": the host pass's numbers}; the device
    pass's own numbers)."""
    warm(loop, 2)
    host = host_pass(loop, host_batches)
    warm(loop, 2)
    dev = device_pass(loop, n)
    stages = dev["program"]["stages"]
    program = {"stages_ms": {s: stages[s]["device_ms"] for s in STAGES if s in stages},
               "host": host}
    return program, dev


def clock_offsets(path: str, spans) -> list:
    """For each recorded ``match.*`` / ``sync.*`` span, in start order, its
    start (time.time_ns) less its trace event's, in us."""
    with open(path) as f:
        trace = json.load(f)
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    prefixes = ("match.", "sync.")
    events = sorted(float(e["ts"]) for e in trace["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(prefixes))
    starts = sorted(t0 for name, _, t0, _ in spans if name.startswith(prefixes))
    if len(events) != len(starts):
        run.log(f"clock check skipped: {len(starts)} recorded spans, {len(events)} in the trace")
        return []
    return [t0 / 1e3 - (ts + base_us) for t0, ts in zip(starts, events)]


def bitwise_on_off(entry) -> bool:
    """One pool batch's record with the spans off and on: equal, bitwise."""
    import torch

    off = entry.dispatch(0).cpu()
    with spans_on(entry):
        on = entry.dispatch(0).cpu()
    return torch.equal(off, on)


def cost(loop: run.Loop, seconds: float) -> dict:
    """frames/s of windows of ``seconds`` with the spans off, on, on, off."""
    rates = {"off": [], "on": []}
    for on in (False, True, True, False):
        loop.fill()
        with spans_on(loop.entry) if on else contextlib.nullcontext():
            n, t = loop.window(seconds)
        rates["on" if on else "off"].append(n / t)
    return rates


def measure(cfg: dict, mix: dict, per_layer, seed: int, cost_seconds: float, device="cuda",
            host_batches: int = HOST_BATCHES) -> dict:
    """Set-up and steps 1-5 of the module docstring; returns the result."""
    import torch

    t = time.time()
    loop = setup(cfg, mix, seed, device)
    run.log(f"set-up {time.time() - t:.2f} s; {loop.entry.summary()}")
    n = int(mix["traced_batches"])
    red = run.traced_window(loop, n)
    window1 = {m["name"]: run.reader(m["name"])(
        {"host": loop.host, "trace": red, "shapes": loop.entry.shapes()}) for m in per_layer}
    run.log(f"window 1 (spans off): {window1}; per span a batch {json.dumps(red['spans'])}")
    program, dev = passes(loop, n, host_batches)
    run.log(f"host pass ({host_batches} batches): {program['host']}")
    stages = dev["program"]["stages"]
    metrics = {name: run.reader(name)({"program": program}) for name in PROGRAM_METRICS}
    stage_sum = sum(program["stages_ms"].values())
    whole = window1.get("match_device_ms")
    run.log(f"device pass ({n} batches): stages {json.dumps(stages)}; blocking calls a batch "
            f"{dev['program']['blocking']}; idle gaps {dev['trace']['idle_gaps']}")
    clock = dev["clock_us"]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    same = bitwise_on_off(loop.entry)
    rates = cost(loop, cost_seconds)
    loop.drain()
    run.log(f"frames/s spans off {rates['off']}, on {rates['on']}")
    busy, window = dev["trace"]["busy_s"], dev["trace"]["window_s"]
    return {
        "device": torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu",
        "card": run.smi() if torch.device(device).type == "cuda" else "cpu",
        "torch": torch.__version__,
        "window1": window1,
        "metrics": metrics,
        "stage_sum_ms": stage_sum,
        "stage_sum_over_match_device_ms": stage_sum / whole if whole else None,
        "stage_ops": {s: v["ops"] for s, v in stages.items()},
        "device_pass": {"spans": dev["trace"]["spans"], "idle_gaps": dev["trace"]["idle_gaps"],
                        "idle_share": 100.0 * (1 - busy / window) if busy and window else None,
                        "blocking": dev["program"]["blocking"]},
        "clock_us": {"n": len(clock), "median": statistics.median(clock) if clock else None,
                     "max_abs": max(map(abs, clock), default=None)},
        "bitwise_on_off": same,
        "frames_per_s": rates,
        "spans_on_over_off": statistics.mean(rates["on"]) / statistics.mean(rates["off"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost-seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, cfg, mix, _, _, per_layer = run.resolve(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        run.log(f"needs {cell['chips']} CUDA card(s)")
        return 2
    torch.cuda.set_device(0)
    print(json.dumps(measure(cfg, mix, per_layer, args.seed, args.cost_seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
