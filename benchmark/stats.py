"""The benchmark's arithmetic: percentiles of a sample and the union of
device intervals (copied from `ssvio_tpu_torch/utils/profiling.py::_union_us`).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of `values`, linear between the two
    nearest ranks (numpy's default, written out so that the yardstick does
    not move with a library)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def clip(intervals: Iterable[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """The intervals cut to [t0, t1]; those outside it dropped."""
    return [(max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1]


def gaps(intervals: Iterable[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers, in time order."""
    out, cur = [], t0
    for a, b in sorted(clip(intervals, t0, t1)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return out

