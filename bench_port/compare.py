"""The comparison that decides ``correct``: the program's sampled match
records against the plain reference's on the same frames.

Each compared number has its limit in ``bench_port/limits/<cell>.json``;
a run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import numpy as np


def compare_match(got: dict, want: dict) -> dict:
    """Per sampled frame, the program's [5, K+1] match record against the
    reference's: records_differing counts the frames missing from ``got``
    or whose record differs in any entry (integer sums, one float32
    division and float32 angles and normals rounded once a step: equal
    inputs give equal bits)."""
    differing = 0
    for i, w in want.items():
        g = got.get(i)
        if g is None or g.shape != w.shape or not np.array_equal(g, w, equal_nan=True):
            differing += 1
    return {"records_differing": differing}


def judge(numbers: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (a missing or NaN
    number fails)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())
