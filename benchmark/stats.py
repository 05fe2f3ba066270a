"""The benchmark's arithmetic: window rates, tails, interval unions, idle
shares and the K5 bound.  Plain Python, no program code."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet: 67 TFLOP/s in float32 outside the tensor
# cores counts a fused multiply-add as two; the port's distance contract
# forbids fusing, so one lane instruction is one operation and the peak is
# half of it.
PEAK_LANE_OPS_S = 67e12 / 2
# lane instructions a (query, target) pair costs in a brute 1-NN: three
# differences, three products, two sums, one comparison
BRUTE_OPS_PER_PAIR = 9


def window_rate(units: float, t_open: float, t_last_end: float) -> float:
    """Units of work over the time from the window's opening to the end of
    the last request started in it."""
    span = t_last_end - t_open
    if span <= 0:
        raise ValueError("empty window")
    return units / span


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of closed intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """Each interval cut to [lo, hi]; empty ones dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval of ``busy`` covers."""
    out, t = [], lo
    for s, e in union(clip(busy, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(busy: Sequence[Tuple[float, float]], lo: float, hi: float
             ) -> float:
    """Share of [lo, hi], in %, in which no interval of ``busy`` runs."""
    if hi <= lo:
        raise ValueError("empty window")
    return 100.0 * (1.0 - covered(clip(busy, lo, hi)) / (hi - lo))


def brute_bound_s(shapes: Iterable[Tuple[int, int]]) -> float:
    """Least time of brute 1-NN calls of (queries, targets) shapes: Q x N x
    9 lane instructions at the float32 peak."""
    ops = sum(q * n * BRUTE_OPS_PER_PAIR for q, n in shapes)
    return ops / PEAK_LANE_OPS_S
