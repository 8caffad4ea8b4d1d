"""Frozen arithmetic of the benchmark: window rates, percentiles and the
union of device intervals. Plain Python, no torch."""
from __future__ import annotations

import math

# a tail is reported only where at least ten samples lie beyond it
TAIL_MIN_BEYOND = 10


def job_seconds(window_s: float, njobs: int) -> float:
    """Time to solution: the whole window divided by the jobs in it."""
    if njobs < 1:
        raise ValueError("no job completed in the window")
    return window_s / njobs


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    order statistics (numpy's default, 'linear')."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def tail(values, q: float):
    """The q-th percentile where at least TAIL_MIN_BEYOND samples lie
    beyond it (len * (1 - q/100) >= 10), else None."""
    n = len(values)
    if n * (1.0 - q / 100.0) < TAIL_MIN_BEYOND - 1e-9:
        return None
    return percentile(values, q)


def interval_union(intervals) -> list:
    """Merge (start, end) intervals into disjoint sorted ones."""
    out = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals):
        if e < s:
            raise ValueError(f"interval ends before it starts: {(s, e)}")
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list:
    """Intervals cut to [lo, hi]; those outside are dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the union of the intervals covers."""
    return sum(e - s for s, e in interval_union(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    out = []
    t = lo
    for s, e in interval_union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
