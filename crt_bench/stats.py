"""The benchmark's arithmetic: percentiles, rates, interval unions, idle
shares and open-loop latency.  Times are in seconds unless a name says
otherwise; intervals are (start, end) pairs."""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every value, interpolated linearly between
    the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"rate over a window of {seconds} s")
    return count / seconds


def union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float,
                                                                   float]]:
    """The disjoint, sorted union of the intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[tuple[float, float]],
         walls: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    """The parts of the intervals that lie inside the walls."""
    walls = union(walls)
    out = []
    for s, e in union(intervals):
        for ws, we in walls:
            a, b = max(s, ws), min(e, we)
            if a < b:
                out.append((a, b))
    return out


def covered(intervals: Iterable[tuple[float, float]]) -> float:
    """Total length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(busy: Iterable[tuple[float, float]],
         walls: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    """The idle intervals of the walls: their parts no busy interval
    covers, longest first."""
    out = []
    inside = union(clip(busy, walls))
    for ws, we in union(walls):
        t = ws
        for s, e in inside:
            if e <= ws or s >= we:
                continue
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < we:
            out.append((t, we))
    return sorted(out, key=lambda g: g[0] - g[1])


def open_loop(n: int, period: float, serve: Callable[[int], None],
              clock: Callable[[], float], sleep: Callable[[float], None],
              start: float) -> tuple[list[float], list[float]]:
    """Serve requests 0..n-1, request i due at start + i * period, each
    sent at its due time or, when the one before ended late, at once.
    Returns (due, done) times: a request's latency runs from its due time,
    so a stall is charged to every request queued behind it."""
    due, done = [], []
    for i in range(n):
        t_due = start + i * period
        wait = t_due - clock()
        if wait > 0:
            sleep(wait)
        serve(i)
        due.append(t_due)
        done.append(clock())
    return due, done
