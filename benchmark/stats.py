"""Arithmetic of the end-to-end metrics, over every call of the window."""

from __future__ import annotations

import math


def percentile(values, p):
    """The p-th percentile of all values, interpolated linearly between
    the two nearest ranks (numpy's default), with nothing left out."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count, seconds):
    """count per second of the window's wall time."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds
