"""Window arithmetic of the benchmark: rates over a window, tails from raw
samples, and device busy time as the union of kernel intervals.

``percentile`` is a copy of ``repro_torch.serving.workload.percentile``
(numpy's linear interpolation) and ``union_length`` of the interval union
in ``repro_torch.launch.profile_serve``: the yardstick keeps its own copy
so that a change to the program cannot move it.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of the raw samples ``xs`` (nan when empty).
    An infinite sample (a request that never finished) stands for a wait
    longer than any: a percentile that reaches it reads above 1e300."""
    if not len(xs):
        return float("nan")
    arr = np.nan_to_num(np.asarray(xs, np.float64),
                        posinf=np.finfo(np.float64).max)
    return float(np.percentile(arr, q))


def rate(amount: float, seconds: float) -> float:
    """``amount`` per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return amount / seconds


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``[start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of ``[start, end)`` that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def idle_share(busy_s: float, window_s: float) -> float:
    """1 - busy / window, as a percentage."""
    return 100.0 * (1.0 - busy_s / window_s)
