"""match_roofline: the least time the card could take for one batch's
match work (bench_port/roofline.py ``match_work`` at the cell's shapes)
as a share of the device time of the match stage's span."""

from bench_port import roofline
from bench_port.metrics import match_device_ms


def read(run):
    ms = match_device_ms.read(run)
    if not ms:
        return None
    return 100.0 * roofline.bound_ms(*roofline.match_work(run["shapes"])) / ms
