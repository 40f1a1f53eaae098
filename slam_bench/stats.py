"""The arithmetic of the end-to-end and device metrics."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    if len(values) == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: int, seconds: float) -> float:
    """Events per second over a window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps
