"""The control, at a size a test run can hold: the plain reference with
every float step in bfloat16 fails the cell's comparison against the
reference in float32, on the CPU, where the reference equals itself."""

import pytest

from bench_port import bank as bank_mod
from bench_port import compare, frames
from bench_port.entries import match
from bench_port.reference.quantize import rounding
from bench_port.tests.cells import small_cell


def test_control_fails_and_reference_passes():
    cfg, mix, limits, _, _ = small_cell()
    bank = bank_mod.make_bank(cfg)
    maker = frames.FrameMaker(cfg["objects"], mix["placements"])
    pool = frames.make_pool(maker, 2, 21)
    state = {"threshold": float(cfg["match_threshold"]), "K_cap": int(cfg["max_hypotheses"])}

    def answers(precision):
        return match.reference_answers(cfg, bank, pool, [0, 1], state, "cpu", precision)

    want = answers("float32")
    assert compare.judge(match.compare(answers("float32"), want, pool, [0, 1]), limits)
    numbers = match.compare(answers(match.CONTROL), want, pool, [0, 1])
    assert not compare.judge(numbers, limits), numbers


def test_rounding():
    import torch

    x = torch.tensor([1.0 + 2.0 ** -10, 3.0])
    assert torch.equal(rounding("float32")(x), x)
    assert rounding("bfloat16")(x).tolist() == [1.0, 3.0]
    with pytest.raises(ValueError):
        rounding("float16")
