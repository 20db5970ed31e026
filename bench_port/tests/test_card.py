"""On the card: one short run of the cell through the command, as the
benchmark's checks run it, untraced and traced (skips without a CUDA
card)."""

import json
import subprocess
import sys

import pytest
import torch

from bench_port.tests.cells import MATCH, ROOT, SPEC


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_match_cell_runs_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", MATCH,
         "--seed", "2147483700", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name()
    assert list(res)[-1] == "checks"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["match_roofline"]["value"] <= 100
        # the program passes: all nine metrics, the six stages summing to
        # the match span of the window before them
        names = [m["name"] for m in SPEC["per_layer"] if MATCH in m.get("workloads", [MATCH])]
        assert set(res["metrics"]) == set(names)
        stages = sum(res["metrics"][f"{s}_device_ms"]["value"]
                     for s in ("quantize", "responses", "coarse", "topk", "refine", "post"))
        assert 0.95 <= stages / res["metrics"]["match_device_ms"]["value"] <= 1.05
        assert res["metrics"]["host_syncs"]["value"] > 0
