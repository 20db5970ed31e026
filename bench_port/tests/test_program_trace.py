"""bench_port/program_trace.py: the reduction of a trace with the program's
spans on (a small hand-written Chrome trace), the host pass's numbers and
the nine readers; on the CPU with the small cell, that run.py's
``traced_window`` runs with the program's spans off, before and after the
passes, and the whole measurement."""

import json

import pytest

from bench_port import program_trace, run
from bench_port.tests.cells import small_cell
from bench_port.trace import reduce_trace
from object_detector_6d_tpu_torch.utils import profiling


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _call(name, ts, corr=None):
    ev = {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "args": {}}
    if corr is not None:
        ev["args"]["correlation"] = corr
    return ev


def _op(cat, corr, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


@pytest.fixture
def trace_path(tmp_path):
    """One batch: quantize launches a kernel; refine a kernel, a cudaMalloc
    and, inside its sync span, K4's read (a copy and a stream sync); post a
    kernel; a kernel and a cudaFree outside every program span."""
    events = [
        _span("bench.window", 0, 1000), _span("bench.dispatch", 10, 490),
        _span("bench.match", 20, 460), _span("match.quantize", 30, 70),
        _span("match.refine", 200, 200), _span("sync.k4_bounds", 300, 50),
        _span("match.post", 410, 40),
        _call("cudaLaunchKernel", 40, 1), _call("cudaLaunchKernel", 210, 2),
        _call("cudaMalloc", 220), _call("cudaMemcpyAsync", 310, 3),
        _call("cudaStreamSynchronize", 320), _call("cudaLaunchKernel", 420, 4),
        _call("cudaFree", 600), _call("cudaLaunchKernel", 700, 5),
        _op("kernel", 1, 45, 50), _op("kernel", 2, 215, 100),
        _op("gpu_memcpy", 3, 315, 2, "Memcpy DtoH"), _op("kernel", 4, 425, 10),
        _op("kernel", 5, 705, 30),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": 0}))
    return str(path)


def test_stage_device_ms_and_blocking_calls(trace_path):
    got = program_trace.reduce_program_trace(trace_path, 1)
    assert got["stages"] == {"match.quantize": {"device_ms": pytest.approx(0.05), "ops": 1},
                             "match.refine": {"device_ms": pytest.approx(0.102), "ops": 2},
                             "match.post": {"device_ms": pytest.approx(0.01), "ops": 1}}
    assert got["blocking"] == {"in_sync": {"cudaStreamSynchronize": 1.0},
                               "outside_sync": {"cudaMalloc": 1.0}}
    # run.py's reduction, unchanged, gives the read's copy to the sync span
    # (the innermost) and names each idle gap by its innermost span
    spans = reduce_trace(trace_path, 1)["spans"]
    assert spans["sync.k4_bounds"] == {"device_ms": pytest.approx(0.002), "ops": 1}
    assert spans["match.refine"] == {"device_ms": pytest.approx(0.1), "ops": 1}


def test_host_numbers_and_the_nine_readers():
    spans = [("match.quantize", None, 0, 2_000_000), ("sync.k4_bounds", "match.refine",
                                                      4_000_000, 9_000_000),
             ("match.refine", None, 2_000_000, 10_000_000),
             ("match.post", None, 10_000_000, 11_000_000)]
    host = program_trace.host_numbers(spans, {"sync.k4_bounds": 4, "sync.chunk_max": 0}, 2)
    assert host == {"spans_ms": {"match.quantize": 1.0, "sync.k4_bounds": 2.5,
                                 "match.refine": 4.0, "match.post": 0.5},
                    "match_ms": 5.5, "sync_wait_ms": 2.5, "launch_ms": 3.0, "syncs": 2.0}
    stages = dict(zip(program_trace.STAGES, (1.0, 2.0, 3.0, 4.0, 5.0, 6.0)))
    prog = {"program": {"stages_ms": stages, "host": host}}
    got = {m: run.reader(m)(prog) for m in program_trace.PROGRAM_METRICS}
    assert got == {"quantize_device_ms": 1.0, "responses_device_ms": 2.0,
                   "coarse_device_ms": 3.0, "topk_device_ms": 4.0, "refine_device_ms": 5.0,
                   "post_device_ms": 6.0, "host_syncs": 2.0, "host_sync_wait_ms": 2.5,
                   "host_launch_ms": 3.0}
    # a run without the passes (or a program without the spans) reads nothing
    assert all(run.reader(m)({"host": {}, "trace": {}}) is None
               for m in program_trace.PROGRAM_METRICS)


def test_blocking_names():
    assert [n for n in ("cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyAsync", "cudaLaunchKernel",
                        "cudaStreamSynchronize", "cudaFree", "cudaEventRecord")
            if program_trace.blocking(n)] == ["cudaMemcpy", "cudaMemcpy2D",
                                              "cudaStreamSynchronize", "cudaFree"]


@pytest.fixture(scope="module")
def small_loop():
    cfg, mix, _, _, _ = small_cell()
    return program_trace.setup(cfg, mix, 5, "cpu")


@pytest.fixture
def window_spans(monkeypatch):
    """The span names of each trace that run.py's ``traced_window`` reduces
    (on the CPU its reduction holds no device operation to name them)."""
    from bench_port import trace

    seen, reduce = [], trace.reduce_trace

    def spy(path, n):
        with open(path) as f:
            seen.append({e["name"] for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "user_annotation"})
        return reduce(path, n)

    monkeypatch.setattr(trace, "reduce_trace", spy)
    return seen


def test_traced_window_runs_with_the_program_spans_off(small_loop, window_spans):
    """Window 1 is the benchmark's: no program span opens in it, before
    the passes or after them, and the passes leave the spans off."""
    assert not profiling.enabled()
    run.traced_window(small_loop, 1)
    program_trace.warm(small_loop, 1)
    host = program_trace.host_pass(small_loop, 2)
    assert host["syncs"] == 2 and 0 < host["sync_wait_ms"] < host["match_ms"]
    program_trace.warm(small_loop, 1)
    dev = program_trace.device_pass(small_loop, 1)
    assert len(dev["clock_us"]) == 8 and max(map(abs, dev["clock_us"])) < 1e3
    assert not profiling.enabled() and profiling.take_spans() == []
    program_trace.warm(small_loop, 1)
    run.traced_window(small_loop, 1)
    assert len(window_spans) == 2
    for names in window_spans:
        assert "bench.match" in names
        assert not [n for n in names if n.startswith(("match.", "sync.", "detect."))]


def test_measure_on_the_cpu():
    """The whole measurement at the small cell: the program's host numbers
    and its record bitwise on and off; the device readers find nothing on
    the CPU."""
    cfg, mix, _, _, per_layer = small_cell()
    out = program_trace.measure(cfg, mix, per_layer, 5, 0.01, "cpu", host_batches=2)
    assert out["bitwise_on_off"] and out["device"] == "cpu"
    assert out["metrics"]["host_syncs"] == 2
    assert out["metrics"]["host_launch_ms"] > 0
    assert all(out["metrics"][f"{s}_device_ms"] is None
               for s in ("quantize", "responses", "coarse", "topk", "refine", "post"))
    assert len(out["frames_per_s"]["on"]) == len(out["frames_per_s"]["off"]) == 2
    assert not profiling.enabled()
