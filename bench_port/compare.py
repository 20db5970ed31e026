"""The judgement that decides ``correct``.

A cell's entry (``bench_port/entries/<entry>.py``) compares the program's
sampled answers with its plain reference's and returns the compared
numbers by name; each number has its limit in
``bench_port/limits/<cell>.json``, and a run is correct when every
number is at or under its limit.
"""

from __future__ import annotations


def judge(numbers: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (a missing or NaN
    number fails)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())
