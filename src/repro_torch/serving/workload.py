"""Synthetic open-loop serving workloads.

A copy of ``repro/serving/workload.py`` (numpy only): equal configs give
the same traces in both packages.

Generates deterministic (seeded) request traces for the engine
benchmarks: Poisson / diurnal / bursty arrival processes, categorical or
heavy-tailed (Zipf) output-length distributions, a tier mix mapping
expert budgets k to traffic fractions (FLAME's premium/constrained
client tiers at serving time), and optional shared system-prompt
prefixes for exercising the paged pool's prefix cache.  ``rate=inf``
collapses the trace to a closed batch (everything arrives at t=0) — the
deterministic configuration the parity tests use.

Arrival processes (``arrival=``):

* ``"poisson"`` — homogeneous: exponential inter-arrivals at ``rate``.
* ``"diurnal"`` — the rate is modulated by a sinusoid of period
  ``diurnal_period_s`` swinging ``±diurnal_depth`` around ``rate`` (a
  compressed day/night load curve); inter-arrivals are exponential at
  the instantaneous rate.
* ``"burst"`` — every ``burst_every_s`` seconds the rate multiplies by
  ``burst_factor`` for ``burst_len_s`` seconds (flash-crowd spikes on a
  quiet baseline) — the overload-bench shape.

Output lengths (``length_dist=``): ``"categorical"`` draws from
``new_tokens``/``new_tokens_probs``; ``"zipf"`` draws
``min(new_tokens) - 1 + Zipf(zipf_alpha)`` clipped to ``max_new_cap`` —
a heavy right tail of long generations over a short-request bulk.

Shared prefixes: with ``shared_prefix_len > 0`` every prompt starts with
one of ``n_shared_prefixes`` fixed token templates (chosen per request),
followed by private random tokens — the many-requests-one-system-prompt
shape prefix caching exists for.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import Request


@dataclass(frozen=True)
class WorkloadConfig:
    """Declarative trace spec; :func:`make_trace` materialises it."""
    n_requests: int = 32
    rate: float = float("inf")            # mean arrival rate, requests/s
    prompt_lens: Tuple[int, ...] = (16, 32)
    prompt_len_probs: Optional[Tuple[float, ...]] = None   # None = uniform
    new_tokens: Tuple[int, ...] = (8, 16)
    new_tokens_probs: Optional[Tuple[float, ...]] = None
    # (k, fraction) tier mix; empty = every request takes any slot
    tier_mix: Tuple[Tuple[int, float], ...] = ()
    vocab_size: int = 512
    seed: int = 0
    # arrival process: "poisson" | "diurnal" | "burst"
    arrival: str = "poisson"
    diurnal_period_s: float = 2.0
    diurnal_depth: float = 0.8            # rate swing fraction in [0, 1)
    burst_every_s: float = 1.0
    burst_len_s: float = 0.2
    burst_factor: float = 8.0
    # output-length distribution: "categorical" | "zipf"
    length_dist: str = "categorical"
    zipf_alpha: float = 1.8
    max_new_cap: int = 64                 # clip for the zipf tail
    # shared system-prompt prefixes (0 = fully private prompts)
    shared_prefix_len: int = 0
    n_shared_prefixes: int = 1


def _rate_at(wl: WorkloadConfig, t: float) -> float:
    """Instantaneous arrival rate of the configured process at time t."""
    if wl.arrival == "diurnal":
        return wl.rate * (1.0 + wl.diurnal_depth
                          * math.sin(2.0 * math.pi * t
                                     / wl.diurnal_period_s))
    if wl.arrival == "burst":
        in_burst = (t % wl.burst_every_s) < wl.burst_len_s
        return wl.rate * (wl.burst_factor if in_burst else 1.0)
    return wl.rate


def make_trace(wl: WorkloadConfig) -> List[Request]:
    """Materialise a deterministic request trace from ``wl``.

    Everything is drawn from one ``np.random.default_rng(wl.seed)``
    stream, so equal configs produce identical traces (arrival times,
    prompts, tiers and lengths alike)."""
    assert wl.arrival in ("poisson", "diurnal", "burst"), wl.arrival
    assert wl.length_dist in ("categorical", "zipf"), wl.length_dist
    assert 0.0 <= wl.diurnal_depth < 1.0, wl.diurnal_depth
    rng = np.random.default_rng(wl.seed)
    ks: Sequence[Optional[int]]
    if wl.tier_mix:
        tiers = [k for k, _ in wl.tier_mix]
        fracs = np.asarray([f for _, f in wl.tier_mix], np.float64)
        fracs = fracs / fracs.sum()
        ks = rng.choice(tiers, size=wl.n_requests, p=fracs).tolist()
    else:
        ks = [None] * wl.n_requests

    prefixes: Optional[np.ndarray] = None
    if wl.shared_prefix_len > 0:
        assert wl.shared_prefix_len < min(wl.prompt_lens), \
            "shared prefix must leave room for private prompt tokens"
        prefixes = rng.integers(
            0, wl.vocab_size,
            (wl.n_shared_prefixes, wl.shared_prefix_len)).astype(np.int32)

    t = 0.0
    out: List[Request] = []
    for i in range(wl.n_requests):
        if np.isfinite(wl.rate) and wl.rate > 0 and i > 0:
            # exponential inter-arrival at the instantaneous rate — a
            # cheap deterministic approximation of the inhomogeneous
            # process, good enough for load-shape benchmarking
            t += float(rng.exponential(1.0 / _rate_at(wl, t)))
        L = int(rng.choice(wl.prompt_lens, p=wl.prompt_len_probs))
        if wl.length_dist == "zipf":
            n_new = min(wl.new_tokens) - 1 + int(rng.zipf(wl.zipf_alpha))
            n_new = min(n_new, wl.max_new_cap)
        else:
            n_new = int(rng.choice(wl.new_tokens, p=wl.new_tokens_probs))
        prompt = rng.integers(0, wl.vocab_size, (L,)).astype(np.int32)
        if prefixes is not None:
            which = int(rng.integers(0, wl.n_shared_prefixes))
            prompt[:wl.shared_prefix_len] = prefixes[which]
        out.append(Request(rid=i, prompt=prompt, max_new_tokens=n_new,
                           k=ks[i], arrival=t))
    return out


def percentile(xs: Sequence[float], q: float) -> float:
    """float(np.percentile) with an empty-input guard."""
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))
