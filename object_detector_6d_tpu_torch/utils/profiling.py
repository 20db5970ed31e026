"""Tracing and timing utilities (port of object_detector_6d_tpu/utils/profiling.py).

* ``scope(name)``: a ``torch.profiler.record_function`` span, as the
  detect program's ``detect.*`` spans, so stages show up by name in a
  trace.
* ``trace_to(dir)``: profile a block with ``torch.profiler`` (the CPU,
  and the card where one is visible) and write a Chrome trace there.
* ``DeviceTimer``: steady-state wall timing of a callable, with
  ``torch.cuda.synchronize`` as the barrier when its output lies on a
  card (CPU work is synchronous).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch


def scope(name: str):
    """Named profiler span: ``with scope("match/coarse"): ...``."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; writes ``log_dir/trace.json`` (chrome://tracing,
    Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _sync(x) -> None:
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class DeviceTimer:
    """Measure steady-state latency / throughput of a device callable."""

    def __init__(self, fn: Callable, warmup: int = 1):
        self.fn = fn
        self.warmup = warmup

    def measure(self, *args, iters: int = 10, batch: int = 1) -> dict:
        for _ in range(self.warmup):
            _sync(self.fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self.fn(*args)
        _sync(out)
        dt = time.perf_counter() - t0
        per_call = dt / iters
        return {
            "ms_per_call": per_call * 1e3,
            "ms_per_item": per_call / batch * 1e3,
            "items_per_sec": batch * iters / dt,
        }
