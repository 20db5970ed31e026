"""A whole run of the cell on the CPU (the harness's look for a chip
skipped), sound and with the timed path broken underneath: the sound run
is correct, and each fault that the cell can have makes ``correct``
false. The cell runs on one chip and keeps no state from batch to batch,
so the faults are half of the batch left out and an answer altered where
it is produced."""

import math

import pytest
import torch

from bench_port import program_trace
from bench_port.tests.cells import run_small
from object_detector_6d_tpu_torch.utils import profiling


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["metrics"]["setup_s"]["value"] > 0
    assert out["metrics"]["frames_per_s"]["value"] > 0


HOST = ("host_syncs", "host_sync_wait_ms", "host_launch_ms")
STAGES = tuple(f"{s.split('.')[1]}_device_ms" for s in program_trace.STAGES)


def test_traced_run_reports_per_layer_metrics():
    """On the CPU the traces hold no device operation, so the device
    readers find nothing and leave their metrics out of the line; the
    program's host pass gives the three host metrics."""
    out = run_small(trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(HOST)
    assert out["metrics"]["host_syncs"]["value"] == 2.0
    assert 0 < out["metrics"]["host_sync_wait_ms"]["value"] < math.inf
    assert 0 < out["metrics"]["host_launch_ms"]["value"] < math.inf
    assert set(out["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert list(out)[-1] == "checks"
    assert not profiling.enabled()


def test_traced_run_reports_the_nine_program_metrics(monkeypatch):
    """With the device pass's reduction giving each stage device ms (the
    CPU trace has none), the traced run reports all nine program metrics,
    finite, the stages' as the reduction gave them."""
    given = {s: {"device_ms": 1.0 + i, "ops": 1.0} for i, s in enumerate(program_trace.STAGES)}
    monkeypatch.setattr(program_trace, "reduce_program_trace",
                        lambda path, n: {"stages": given, "blocking": {}})
    out = run_small(trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(STAGES + HOST)
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    assert [out["metrics"][m]["value"] for m in STAGES] == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]


@pytest.fixture
def match_entry():
    from bench_port.entries import match

    return match.Entry


def test_traced_run_without_program_spans(monkeypatch, match_entry):
    """An entry without ``program_spans``: the traced run makes no program
    pass, reports no program metric and is correct."""
    monkeypatch.delattr(match_entry, "program_spans")
    out = run_small(seed=7, trace=True)
    assert out["correct"], out["checks"]
    assert not set(out["metrics"]) & set(STAGES + HOST)
    assert set(out["device"]) >= {"busy_s", "window_s"}


def test_half_batch_left_out(monkeypatch, match_entry):
    """The match program runs on the first half of each batch and answers
    the second half with the first half's records."""
    dispatch = match_entry.dispatch

    def half(self, i):
        prog = self.prog

        def run(sources, *rest):
            n = sources[0].shape[0] // 2
            return prog([torch.cat([s[:n]] * 2) for s in sources], *rest)

        self.prog = run
        try:
            return dispatch(self, i)
        finally:
            self.prog = prog

    monkeypatch.setattr(match_entry, "dispatch", half)
    out = run_small(seed=8)
    assert not out["correct"], out["checks"]


def test_answer_altered(monkeypatch, match_entry):
    """One similarity of every record raised by 1 where it is produced."""
    dispatch = match_entry.dispatch

    def altered(self, i):
        rec = dispatch(self, i).clone()
        rec[:, 2, 0] += 1.0
        return rec

    monkeypatch.setattr(match_entry, "dispatch", altered)
    out = run_small(seed=9)
    assert not out["correct"], out["checks"]
