"""A whole run of the cell on the CPU (the harness's look for a chip
skipped), sound and with the timed path broken underneath: the sound run
is correct, and each fault that the cell can have makes ``correct``
false. The cell runs on one chip and keeps no state from batch to batch,
so the faults are half of the batch left out and an answer altered where
it is produced."""

import pytest
import torch

from bench_port.tests.cells import run_small


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["metrics"]["setup_s"]["value"] > 0
    assert out["metrics"]["frames_per_s"]["value"] > 0


def test_traced_run_reports_per_layer_metrics():
    """On the CPU the trace holds no device operation, so the device
    readers find nothing and leave their metrics out of the line."""
    out = run_small(trace=True)
    assert out["correct"] and out["metrics"] == {}
    assert set(out["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert list(out)[-1] == "checks"


@pytest.fixture
def match_entry():
    from bench_port.entries import match

    return match.Entry


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
