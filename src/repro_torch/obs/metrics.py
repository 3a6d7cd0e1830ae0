"""Metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``repro/obs/metrics.py`` (pure Python).  A histogram observe is
one ``bisect`` plus three adds.  ``MetricsRegistry.snapshot()`` returns a
nested plain dict that is JSON-safe by construction (non-finite values
become ``None``), and ``dump`` writes it.  Components that keep their own
counters register a *source*, a callback run at snapshot time.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def _finite(x: float) -> Optional[float]:
    x = float(x)
    return x if math.isfinite(x) else None


class Counter:
    """Monotonic count. ``inc`` only; reset by replacing the object."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": _finite(self.value)}


class Gauge:
    """Last-write-wins level (queue depth, blocks in use, ...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": _finite(self.value)}


def exp_buckets(lo: float, hi: float, factor: float = 1.15,
                ) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds covering ``[lo, hi]``."""
    if not (lo > 0 and hi > lo and factor > 1):
        raise ValueError("need 0 < lo < hi and factor > 1")
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


# Default latency buckets: 1 µs .. ~60 s expressed in ms, ~124 buckets.
# 15% growth keeps interpolation error on p50/p99 under ~7.5%.
DEFAULT_MS_BUCKETS = exp_buckets(1e-3, 6e4, 1.15)


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds[i]`` is the inclusive upper edge of bucket ``i``; one extra
    overflow bucket catches everything above ``bounds[-1]``. Exact
    min/max are tracked so percentile interpolation never reports a
    value outside the observed range.
    """

    __slots__ = ("bounds", "counts", "count", "total", "min", "max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BUCKETS) -> None:
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("bucket bounds must be strictly increasing")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        self.counts[bisect_left(self.bounds, x)] += 1
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated ``q``-th percentile (``0 <= q <= 100``), or
        ``None`` when empty. Linear within the containing bucket,
        clamped to the exact observed [min, max]."""
        if not self.count:
            return None
        target = self.count * min(max(q, 0.0), 100.0) / 100.0
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else min(self.min, self.bounds[0])
            hi = self.bounds[i] if i < len(self.bounds) else self.max
            if cum + n >= target:
                frac = (target - cum) / n
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.min, min(self.max, est))
            cum += n
        return self.max

    def snapshot(self) -> dict:
        """JSON-safe summary; only non-empty buckets are listed as
        ``[upper_bound, count]`` pairs (overflow bound is ``None``)."""
        buckets = [[self.bounds[i] if i < len(self.bounds) else None, n]
                   for i, n in enumerate(self.counts) if n]
        return {
            "type": "histogram", "count": self.count,
            "sum": _finite(self.total), "mean": _finite(self.mean or 0.0)
            if self.count else None,
            "min": _finite(self.min) if self.count else None,
            "max": _finite(self.max) if self.count else None,
            "p50": _finite(self.percentile(50) or 0.0) if self.count else None,
            "p90": _finite(self.percentile(90) or 0.0) if self.count else None,
            "p99": _finite(self.percentile(99) or 0.0) if self.count else None,
            "buckets": buckets,
        }


class MetricsRegistry:
    """Name → metric map with get-or-create accessors.

    ``counter/gauge/histogram`` return the instrument already registered
    under a name (and raise if the name is bound to another kind);
    ``register`` binds an externally owned instrument."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._sources: List[Callable[["MetricsRegistry"], None]] = []

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(*args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_MS_BUCKETS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def register(self, name: str, metric) -> None:
        """Bind (or rebind) ``name`` to an externally owned instrument."""
        self._metrics[name] = metric

    def add_source(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """``fn(registry)`` runs at every ``snapshot()``."""
        self._sources.append(fn)

    def snapshot(self) -> Dict[str, dict]:
        for fn in self._sources:
            fn(self)
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, allow_nan=False)
