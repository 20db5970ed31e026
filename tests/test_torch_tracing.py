"""The port's spans and host-read counter (utils/profiling.py) inside the
match program (match/program.py) and K4's wrapper (ops/refine.py).

Off (the default), a torch.profiler trace of a match run holds none of
the program's spans and the in-memory record stays empty. On, each batch
shows the six ``match.*`` stage spans once, in order, in both the trace
and the record, with K4's bounds check as ``sync.k4_bounds`` inside
``match.refine`` once a modality; the record's stamps lie on the trace's
clock. The match record is bitwise the same on and off, and
``counts["sync.k4_bounds"]`` rises by 2 a two-modality batch either way.
The programs run at tests/test_torch_limits.py's smallest setup: 120x160
frames of colour noise, ``synthetic_bank(2, 4, bbox_px=40)``, threshold
60, 4 candidates.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.ops import refine
from object_detector_6d_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, W, B, K_CAP, THRESHOLD = 120, 160, 2, 4, 60.0
BATCHES = 2
STAGES = ["match.quantize", "match.responses", "match.coarse", "match.topk",
          "match.refine", "match.post"]
PREFIXES = ("match.", "detect.", "sync.")


@pytest.fixture(scope="module")
def match_run():
    """() -> [B, 5, K+1] of one call of the small match program."""
    det = synthetic_bank(2, 4, bbox_px=40, seed=0)
    bank = mp.pack_bank(det.class_templates, 2, 2, t0=5, t1=8)
    prog = mp.make_match_program(det.modality_names, det.t_at_level, (H, W),
                                 det.dn_params, det.cg_params, K_CAP)
    rng = np.random.RandomState(0)
    bgrs = rng.randint(0, 256, (B, H, W, 3), dtype=np.int64).astype(np.uint8)
    deps = (1000 + rng.randint(0, 400, (B, H, W))).astype(np.int32)
    sources = [torch.as_tensor(bgrs), torch.as_tensor(deps)]
    args = mp.bank_args(bank, "cpu")
    return lambda: prog(sources, *args, THRESHOLD)


@pytest.fixture(scope="module")
def record_off(match_run):
    return match_run()


@pytest.fixture
def spans_on():
    """Switches the spans on for one test and off again after it."""
    profiling.take_spans()
    profiling.enable(True)
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.take_spans()


def _profiled(fn, tmp_path):
    """fn() under torch.profiler -> (the program's span events sorted by
    start, the trace's baseTimeNanoseconds)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIXES)),
                    key=lambda e: e["ts"])
    return events, trace.get("baseTimeNanoseconds", 0)


def test_spans_off_leave_no_trace(match_run, tmp_path):
    assert not profiling.enabled()
    profiling.take_spans()
    events, _ = _profiled(lambda: [match_run() for _ in range(BATCHES)], tmp_path)
    assert events == []
    assert profiling.take_spans() == []
    assert profiling.scope("match.coarse") is profiling.scope("sync.k4_bounds")


def _warm_then(fn):
    """The profiler's first span pays its lazy set-up (~1.3 ms on the
    CPU) between the trace's stamp and the record's: a span of another
    name takes it."""
    with profiling.scope("warm-up"):
        pass
    return fn()


def test_spans_on_once_a_batch_in_order_on_the_trace_clock(match_run, spans_on, tmp_path):
    events, base_ns = _profiled(
        lambda: _warm_then(lambda: [match_run() for _ in range(BATCHES)]), tmp_path)
    record = sorted((s for s in profiling.take_spans() if s[0].startswith(PREFIXES)),
                    key=lambda s: s[2])
    per_batch = STAGES[:5] + ["sync.k4_bounds"] * 2 + STAGES[5:]
    assert [e["name"] for e in events] == per_batch * BATCHES
    assert [s[0] for s in record] == per_batch * BATCHES
    assert [s[1] for s in record] == ([None] * 5 + ["match.refine"] * 2 + [None]) * BATCHES
    for (name, _, t0, t1), e in zip(record, events):
        # the record stamps inside the profiler's span: its start and end
        # lie within the trace event's, to 1 ms (us here)
        start = e["ts"] + base_ns / 1e3
        assert start - 1e3 <= t0 / 1e3 <= t1 / 1e3 <= start + e["dur"] + 1e3, name


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_record_and_sync_count_on_and_off(match_run, record_off, on):
    profiling.take_spans()
    profiling.enable(on)
    try:
        before = profiling.counts["sync.k4_bounds"]
        outs = [match_run() for _ in range(BATCHES)]
        counted = profiling.counts["sync.k4_bounds"] - before
        names = [s[0] for s in profiling.take_spans()]
    finally:
        profiling.enable(False)
    for out in outs:
        assert torch.equal(out, record_off)
    assert counted == 2 * BATCHES  # once a modality a batch
    assert names.count("match.refine") == (BATCHES if on else 0)


@pytest.mark.parametrize("F,reads", [(63, {"sync.k4_bounds": 1}),
                                     (300, {"sync.k4_bounds": 1, "sync.chunk_max": 1})])
def test_k4_wrapper_counts_its_host_reads(F, reads):
    """K4's bounds check reads one flag; a table wider than MAX_F also
    reads its largest count to size its chunks."""
    rng = np.random.RandomState(F)
    d = torch.as_tensor(rng.randint(-8, 8, (1, 4, 24, 24)).astype(np.int8))
    plane = torch.as_tensor(rng.randint(0, 4, (1, 2, F)).astype(np.int32))
    r0 = torch.as_tensor(rng.randint(0, 9, (1, 2, F)).astype(np.int32))
    c0 = torch.as_tensor(rng.randint(0, 9, (1, 2, F)).astype(np.int32))
    nfeat = torch.as_tensor([[F, F // 2]], dtype=torch.int32)
    before = dict(profiling.counts)
    refine.refine_sweep_batched(d, plane, r0, c0, nfeat)
    got = {k: v - before.get(k, 0) for k, v in profiling.counts.items()
           if v != before.get(k, 0)}
    assert got == reads


def test_record_keeps_the_newest_spans(spans_on):
    for i in range(profiling.MAX_SPANS + 5):
        with profiling.scope("s%d" % i):
            pass
    record = profiling.take_spans()
    assert len(record) == profiling.MAX_SPANS
    assert record[-1][0] == "s%d" % (profiling.MAX_SPANS + 4)
    assert profiling.take_spans() == []
