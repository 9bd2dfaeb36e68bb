"""Reductions of the benchmark's measurements: percentiles, rates, the
union of device intervals and its gaps, quartile spreads."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) of all values, linear between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(amount: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return amount / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the intervals cover."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The uncovered stretches of [lo, hi]."""
    out, cur = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, Python's `statistics.quantiles(n=4)`."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
