"""Tracing and timing utilities (port of object_detector_6d_tpu/utils/profiling.py).

* ``enable(on)`` / ``enabled()``: the program's spans, off by default.
* ``scope(name)``: a named span, the port's one span mechanism. Off, it
  returns one shared no-op context: its cost is one flag test. On, it
  enters ``torch.profiler.record_function(name)``, so a torch.profiler
  trace shows the span and the device operations launched under it, and
  appends ``(name, parent, t0_ns, t1_ns)`` to an in-memory record of the
  newest ``MAX_SPANS`` spans (``take_spans``). The stamps are
  ``time.time_ns()``, the clock of a torch.profiler Chrome trace: an
  event's ``ts`` (us) plus the trace's ``baseTimeNanoseconds / 1e3`` is
  ``time.time_ns() / 1e3`` (checked with PyTorch 2.13 on the CPU and 2.11
  with CUDA 12.8 on an H100: a span's two starts lie within 50 us), so
  the record and a device trace share a clock.
* ``host_read(name)``: the span ``sync.<name>`` around a deliberate
  device-to-host read; every entry raises ``counts["sync.<name>"]``,
  whether spans are on or off.
* ``trace_to(dir)``: profile a block with ``torch.profiler`` (the CPU,
  and the card where one is visible) and write a Chrome trace there.
* ``DeviceTimer``: steady-state wall timing of a callable, with
  ``torch.cuda.synchronize`` as the barrier when its output lies on a
  card (CPU work is synchronous).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, Iterator, List, Optional, Tuple

import torch

MAX_SPANS = 1 << 16

_on = False
_record: collections.deque = collections.deque(maxlen=MAX_SPANS)
_NOOP = contextlib.nullcontext()
counts: collections.Counter = collections.Counter()


class _Open(threading.local):
    """The names of this thread's open spans, innermost last."""

    def __init__(self):
        self.names: List[str] = []


_open = _Open()


def enable(on: bool) -> None:
    """Switch the program's spans on or off (off by default)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "parent", "t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        names = _open.names
        self.parent = names[-1] if names else None
        names.append(self.name)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._rf.__exit__(*exc)
        _open.names.pop()
        _record.append((self.name, self.parent, self.t0, t1))
        return False


def scope(name: str):
    """Named span: ``with scope("match.coarse"): ...`` (see the module
    docstring)."""
    return _Span(name) if _on else _NOOP


def take_spans() -> List[Tuple[str, Optional[str], int, int]]:
    """The recorded spans ``(name, parent, t0_ns, t1_ns)`` in the order
    they closed; clears the record."""
    out = list(_record)
    _record.clear()
    return out


def host_read(name: str):
    """``with host_read("k4_bounds"): flag = bool(t)``: counts the read in
    ``counts["sync.<name>"]`` and spans it as ``sync.<name>``."""
    key = "sync." + name
    counts[key] += 1
    return scope(key)


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
