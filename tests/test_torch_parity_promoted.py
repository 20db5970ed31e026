"""test_torch_parity.py at the promoted schedule (2 solves per
association, finest level 2 associations, 2 depth seeds, fine compaction
8) on the base set."""

from test_torch_parity import check_parity


def test_parity_base_promoted_schedule():
    check_parity("base", "promoted")
