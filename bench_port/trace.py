"""Reduces a torch.profiler trace of steady batches to per-span numbers.

The profiler's Chrome trace holds the card's operations (kernels, copies,
memsets) with the correlation id of the runtime call that launched each,
the runtime calls on the host, and the named host spans
(``record_function``: the program's ``detect.*`` and the harness's
``bench.*``). Each device operation belongs to the innermost named span
that encloses its launch on the host.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


def _innermost(spans, t: float) -> str:
    best, best_dur = "no_span", None
    for name, s, e in spans:
        if s <= t <= e and (best_dur is None or e - s < best_dur):
            best, best_dur = name, e - s
    return best


def reduce_trace(path: str, n_batches: int) -> dict:
    """-> {"spans": {name: {"device_ms", "ops"} a batch}, "h2d_ms" a batch,
    "busy_s", "window_s", "device_ops", "idle_gaps"}. A span's numbers sum
    the operations launched under it; the copies, the busy time, the top
    operations and the idle gaps are those of the ``bench.window`` span,
    which holds ``n_batches`` steps (the trace's times are microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, launches, device = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation":
            spans.append((ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
        elif cat in HOST_CALL_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(ev["ts"])
        elif cat in DEVICE_CATS:
            device.append(ev)
    windows = [s for s in spans if s[0] == WINDOW_SPAN]
    if not windows:
        raise RuntimeError("the trace has no bench.window span")
    w0, w1 = windows[0][1], windows[0][2]
    inner = [s for s in spans if s[0] != WINDOW_SPAN]
    per_span: dict = {}
    by_name: dict = {}
    h2d_us = 0.0
    intervals = []
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev["dur"])
        launch = launches.get(ev.get("args", {}).get("correlation"))
        # per span: every operation launched under it, wherever it ran
        span = _innermost(inner, launch) if launch is not None else "no_span"
        rec = per_span.setdefault(span, {"device_ms": 0.0, "ops": 0})
        rec["device_ms"] += dur / 1e3
        rec["ops"] += 1
        if (ev.get("cat") == "gpu_memcpy" and "HtoD" in ev["name"] and launch is not None
                and w0 <= launch <= w1):
            h2d_us += dur
        # the device's busy time and top operations: inside the window
        s, e = max(ts, w0), min(ts + dur, w1)
        if e > s:
            intervals.append((s, e))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + (e - s) / 1e6
    # busy time: the union of the device intervals inside the window
    intervals.sort()
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    prev_end = w0
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((s - prev_end, (s + prev_end) / 2))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > prev_end:
        gaps.append((w1 - prev_end, (w1 + prev_end) / 2))
    gaps.sort(reverse=True)
    return {
        "spans": {k: {"device_ms": v["device_ms"] / n_batches, "ops": v["ops"] / n_batches}
                  for k, v in per_span.items()},
        "h2d_ms": h2d_us / 1e3 / n_batches,
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[n[:64], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_innermost(inner, mid), g / 1e6] for g, mid in gaps[:10]],
    }
