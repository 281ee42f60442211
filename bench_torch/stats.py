"""The arithmetic that turns a run's readings into its metrics: rates over
every call, nearest-rank percentiles and unions of intervals. Plain
Python, so the CPU tests hold it exactly."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def rate_gbps(raw_bytes: Sequence[int], seconds: Sequence[float]) -> float:
    """GB/s (1e9 B) of every call together: all bytes over all the time,
    not a mean of per-call rates."""
    if len(raw_bytes) != len(seconds) or not seconds:
        raise ValueError("one byte count per timed call, and at least one call")
    return sum(raw_bytes) / sum(seconds) / 1e9


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    s = sorted(values)
    return s[max(1, math.ceil(q / 100 * len(s))) - 1]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[Interval] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Interval], window: Interval) -> float:
    """The length of window that the intervals cover, each point once."""
    lo, hi = window
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def gaps(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    """The parts of window that no interval covers."""
    lo, hi = window
    out, t = [], lo
    for a, b in union(intervals):
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out
