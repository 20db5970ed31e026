"""On the card: one short run of the cell through the command, as the
benchmark's checks run it (skips without a CUDA card)."""

import json
import subprocess
import sys

import pytest
import torch

from bench_port.tests.cells import MATCH, ROOT


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
