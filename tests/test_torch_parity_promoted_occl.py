"""test_torch_parity.py at the promoted schedule on the occl set."""

from test_torch_parity import check_parity


def test_parity_occl_promoted_schedule():
    check_parity("occl", "promoted")
