"""The control, at a size a test run can hold: the plain reference with
every float step in bfloat16 fails the cell's comparison against the
reference in float32, on the CPU, where the reference equals itself."""

import pytest

from bench_port import bank as bank_mod
from bench_port import compare, frames, run
from bench_port.reference.quantize import rounding
from bench_port.tests.cells import small_cell


def test_control_fails_and_reference_passes():
    cfg, mix, limits, _, _ = small_cell()
    bank = bank_mod.make_bank(cfg)
    maker = frames.FrameMaker(cfg["objects"], mix["placements"])
    depth, bgr, _ = frames.make_pool(maker, 2, 21)
    K, thr = int(cfg["max_hypotheses"]), float(cfg["match_threshold"])

    def answers(precision):
        m = run.reference(cfg, bank, K, (maker.H, maker.W), "cpu", precision)
        return dict(enumerate(m.match(depth, bgr, thr)))

    want = answers("float32")
    assert compare.judge(compare.compare_match(answers("float32"), want), limits)
    numbers = compare.compare_match(answers("bfloat16"), want)
    assert not compare.judge(numbers, limits), numbers


def test_rounding():
    import torch

    x = torch.tensor([1.0 + 2.0 ** -10, 3.0])
    assert torch.equal(rounding("float32")(x), x)
    assert rounding("bfloat16")(x).tolist() == [1.0, 3.0]
    with pytest.raises(ValueError):
        rounding("float16")
