"""Statistics the benchmark reports: the spread of a set of runs, device
busy time as a union of intervals, and the idle gaps between them."""

from __future__ import annotations

import statistics
from collections.abc import Sequence


def spread(values: Sequence[float]) -> float:
    """Distance between the first and the third quartile, as Python's
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge overlapping (start, end) intervals, sorted by start."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[tuple[float, float]], lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals: Sequence[tuple[float, float]], lo: float, hi: float) -> float:
    """Time within [lo, hi] that at least one interval covers."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def idle_share(intervals: Sequence[tuple[float, float]], lo: float, hi: float) -> float:
    """1 - busy / window over [lo, hi]."""
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals: Sequence[tuple[float, float]], lo: float, hi: float):
    """The idle (start, end) gaps within [lo, hi], longest first."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])
