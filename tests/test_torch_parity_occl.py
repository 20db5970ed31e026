"""test_torch_parity.py on the occl set (the base scenes with a box
occluding each object, match threshold 55) at the default schedule."""

from test_torch_parity import check_parity


def test_parity_occl_default_schedule():
    check_parity("occl", "default")
