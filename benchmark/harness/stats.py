"""Percentiles and rates, in plain Python.

Kept here so that the program cannot move the yardstick: every end-to-end
number of the benchmark is computed by these functions.
"""

from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 <= q <= 100) with linear interpolation
    between the two nearest ranks (numpy's default ``linear`` method):
    position ``q / 100 * (n - 1)`` in the sorted values."""
    if not values:
        raise ValueError("percentile of no values")
    if not 0 <= q <= 100:
        raise ValueError(f"q must lie in [0, 100], got {q}")
    xs = sorted(values)
    pos = q / 100 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(completed: int, seconds: float) -> float:
    """Work completed over the seconds it took: all the work of a window
    over all its time."""
    if seconds <= 0:
        raise ValueError("a rate needs a positive time")
    return completed / seconds

