"""Expert-load telemetry (a copy of ``repro/obs/expert_load.py``, numpy
only).

Serving side: the ragged dispatch plan is built on device from router
outputs, but the router already returns per-expert activation counts
(``MoEAux.activation_counts``) which ``model.decode_step`` can surface
host-side with ``return_counts=True`` — no kernel changes.
:class:`ExpertLoadTracker` turns those per-step ``{poskey: (n_periods,
E)}`` count arrays into occupancy histograms, cumulative totals, and
imbalance summaries (gini, normalized entropy, hottest expert).

Federated side: :class:`ActivationDriftTracker` consumes the per-round
activation *frequencies* FLAME's aggregation runs on (Eq. 6–7) and
reports per-period normalized entropy plus L1 drift against the
previous round — the "did routing move" signal per MoE position.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np

from .metrics import Histogram, MetricsRegistry, exp_buckets


def gini(x) -> float:
    """Gini coefficient of a non-negative load vector (0 = perfectly
    even, →1 = one expert takes everything)."""
    x = np.sort(np.asarray(x, dtype=np.float64).ravel())
    n = x.size
    tot = float(x.sum())
    if n == 0 or tot <= 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2.0 * cum.sum() / tot) / n)


def entropy(x) -> float:
    """Shannon entropy of a load vector normalized to [0, 1] by
    ``log(len(x))`` (1 = uniform)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    tot = float(x.sum())
    if x.size <= 1 or tot <= 0:
        return 0.0
    p = x / tot
    p = p[p > 0]
    return float(-(p * np.log(p)).sum() / math.log(x.size))


class ExpertLoadTracker:
    """Accumulates per-decode-step expert activation counts.

    ``observe_step`` takes ``{poskey: counts}`` with ``counts`` shaped
    ``(n_periods, E)`` — token→expert assignments routed in that step
    (inactive slots contribute zero; adaptive budgets shrink row sums).
    Keeps cumulative totals per position and a per-step occupancy
    histogram (assignments routed per step), so both "who is hot over
    the run" and "how loaded is a single step" are answerable.
    """

    def __init__(self, num_experts: int) -> None:
        self.num_experts = int(num_experts)
        self.reset()

    def reset(self) -> None:
        self.steps = 0
        self.totals: Dict[str, np.ndarray] = {}
        # assignments routed per decode step (all positions/periods)
        self.step_occupancy = Histogram(exp_buckets(1.0, 1e6, 1.6))

    def observe_step(self, counts: Mapping[str, np.ndarray]) -> None:
        self.steps += 1
        step_total = 0.0
        for pos, arr in counts.items():
            arr = np.asarray(arr, dtype=np.float64)
            arr = arr.reshape(-1, arr.shape[-1])  # (n_periods, E)
            tot = self.totals.get(pos)
            if tot is None:
                self.totals[pos] = arr.copy()
            else:
                tot += arr
            step_total += float(arr.sum())
        self.step_occupancy.observe(step_total)

    # -- summaries --------------------------------------------------------
    def _grand_total(self) -> np.ndarray:
        if not self.totals:
            return np.zeros(self.num_experts)
        return np.sum([t.sum(axis=0) for t in self.totals.values()], axis=0)

    def gini(self) -> float:
        return gini(self._grand_total())

    def entropy(self) -> float:
        return entropy(self._grand_total())

    def hot_expert(self) -> Optional[int]:
        g = self._grand_total()
        return int(np.argmax(g)) if g.sum() > 0 else None

    def snapshot(self) -> dict:
        return {
            "steps": self.steps,
            "num_experts": self.num_experts,
            "assignments_total": float(self._grand_total().sum()),
            "gini": self.gini(),
            "entropy": self.entropy(),
            "hot_expert": self.hot_expert(),
            "totals": {pos: [[float(v) for v in row] for row in t]
                       for pos, t in sorted(self.totals.items())},
            "step_occupancy": self.step_occupancy.snapshot(),
        }

    def publish(self, reg: MetricsRegistry,
                prefix: str = "serving.experts") -> None:
        reg.gauge(f"{prefix}.gini").set(self.gini())
        reg.gauge(f"{prefix}.entropy").set(self.entropy())
        reg.gauge(f"{prefix}.steps").set(self.steps)
        reg.gauge(f"{prefix}.assignments_total").set(
            float(self._grand_total().sum()))
        reg.register(f"{prefix}.step_occupancy", self.step_occupancy)


def _normalize_rows(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float64)
    arr = arr.reshape(-1, arr.shape[-1])
    denom = arr.sum(axis=1, keepdims=True)
    return np.divide(arr, denom, out=np.zeros_like(arr), where=denom > 0)


class ActivationDriftTracker:
    """Per-round activation-frequency entropy and L1 drift.

    ``update`` takes the round's mean activation frequencies per MoE
    position (``{poskey: (n_periods, E)}``, e.g. the participation-
    weighted client mean) and returns, per position::

        {"entropy": [per-period normalized entropy ...],
         "entropy_mean": float,
         "l1_drift": float | None}   # None on the first round

    L1 drift is the mean over periods of ``sum |p_t - p_{t-1}|`` after
    row-normalizing each period's distribution (range [0, 2]).
    """

    def __init__(self) -> None:
        self._prev: Dict[str, np.ndarray] = {}
        self.rounds = 0

    def update(self, freqs: Mapping[str, np.ndarray],
               ) -> Dict[str, Dict[str, object]]:
        out: Dict[str, Dict[str, object]] = {}
        nxt: Dict[str, np.ndarray] = {}
        for pos, arr in freqs.items():
            p = _normalize_rows(arr)
            ents = [entropy(row) for row in p]
            prev = self._prev.get(pos)
            drift = (float(np.abs(p - prev).sum(axis=1).mean())
                     if prev is not None and prev.shape == p.shape else None)
            out[pos] = {"entropy": ents,
                        "entropy_mean": float(np.mean(ents)) if ents else 0.0,
                        "l1_drift": drift}
            nxt[pos] = p
        self._prev = nxt
        self.rounds += 1
        return out

    def publish(self, reg: MetricsRegistry,
                per_pos: Mapping[str, Mapping[str, object]],
                prefix: str = "fed.activation") -> None:
        for pos, d in per_pos.items():
            reg.gauge(f"{prefix}.entropy.{pos}").set(
                float(d["entropy_mean"]))
            if d["l1_drift"] is not None:
                reg.gauge(f"{prefix}.l1_drift.{pos}").set(
                    float(d["l1_drift"]))
