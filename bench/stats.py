"""Statistics the benchmark's metrics share."""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np

# an interaction that failed or never completed counts as this latency:
# beyond every TPC-W timeout
FAILED_MS = 1e9


def pctl(values: Sequence[float], p: float) -> float:
    """Nearest-rank ``p``-th percentile over all ``values`` (no
    interpolation, so a failed interaction's ``FAILED_MS`` is never
    averaged into a finite one)."""
    if not values:
        raise ValueError("a percentile of no values")
    s = sorted(values)
    k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
    return s[k]


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def beats_busy(spans: Sequence[Tuple[float, float]], window: float) -> float:
    """The device's busy time in [0, ``window``] from each beat's (start
    event, end event) on one stream, in dispatch order: a beat is busy
    from its start, or the previous beat's end if later, to its end."""
    busy, prev = 0.0, 0.0
    for s, e in spans:
        s, e = max(s, prev, 0.0), min(e, window)
        busy += max(0.0, e - s)
        prev = max(prev, e)
    return busy


def backlog(due, done, at: Sequence[float]) -> List[int]:
    """Interactions due but not completed at each time of ``at`` (never
    completed: ``done`` is NaN)."""
    due = np.sort(due[~np.isnan(due)])
    fin = np.sort(np.where(np.isnan(done), np.inf, done))
    return [int(np.searchsorted(due, t, "right")
                - np.searchsorted(fin, t, "right")) for t in at]
