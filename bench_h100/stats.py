"""The arithmetic of the end-to-end metrics, taken over every call."""
from __future__ import annotations

import math
from typing import Sequence


def rate_ms(window_s: float, calls: int) -> float:
    """Milliseconds a call: the whole window over the calls completed in it."""
    if calls <= 0:
        raise ValueError("no call completed in the window")
    return window_s * 1000.0 / calls


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of every value, linear between the
    two nearest ranks (numpy's default, the "inclusive" rule)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values: Sequence[float], q: float) -> int:
    """How many values lie above the ``q``-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)



def pool_wall_s(calls, traced) -> float:
    """The mean wall time of a call over the pool entries that ``traced``
    covers, each entry's mean over the window's ``calls`` (so that it
    matches the traced calls' mix of right-hand sides)."""
    walls = {}
    for c in calls:
        walls.setdefault(c.pool, []).append(c.wall_s)
    pools = sorted({c.pool for c in traced} & set(walls))
    return sum(sum(walls[p]) / len(walls[p]) for p in pools) / len(pools)
