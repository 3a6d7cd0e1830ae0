"""Request queue and admission policy for the serving engine.

A copy of ``repro/serving/scheduler.py`` (numpy only), kept in the port so
it imports nothing of the JAX package.

Requests arrive (open-loop) and wait in a queue; each engine step the
scheduler packs waiting requests into free KV-cache slots.  Slots are
tier-typed — the engine compiles ONE decode step with a static per-slot
expert-budget vector (premium slots at full k, constrained slots at
k=1–2), so admission is ordered *per tier*: a request is placed into the
first free slot whose budget matches, and otherwise keeps waiting without
blocking requests of other tiers behind it.

Two queue orderings:

* ``policy="fifo"`` (default) — arrival order.
* ``policy="slo"`` — earliest-deadline-first: each request's deadline is
  ``arrival + tier_slo_s[k]`` (its tier's TTFT target); requests whose
  tier has no target sort last (deadline ``inf``) and stay FIFO among
  themselves.  Under overload this admits latency-critical tiers ahead
  of best-effort traffic instead of strict arrival order, and it is the
  ordering the engine's decode preemption keys victim selection off.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    """One serving request.

    ``k``: requested expert budget (None = take any slot / server default).
    ``forced``: optional teacher-forced continuation — when set, the engine
    feeds these tokens back instead of its argmax samples and accumulates
    their negative log-likelihood (quality evaluation through the engine,
    used by examples/adaptive_serving.py).
    """
    rid: int
    prompt: np.ndarray                 # (L,) int32 token ids
    max_new_tokens: int
    k: Optional[int] = None
    arrival: float = 0.0               # seconds on the engine clock
    forced: Optional[np.ndarray] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclass
class Completion:
    """Per-request record emitted when a request leaves its slot."""
    rid: int
    prompt_len: int
    tokens: np.ndarray                 # generated token ids
    k: int                             # budget the request decoded at
    arrival: float
    admitted: float                    # prefill start (queueing delay ends)
    first_token: float                 # TTFT reference point
    finished: float
    nll_sum: float = 0.0               # teacher-forced NLL (forced mode)
    truncated: bool = False            # slot capacity hit before max_new
    preemptions: int = 0               # times swapped out mid-decode

    @property
    def ttft(self) -> float:
        """Time to first token: queueing delay + prefill."""
        return self.first_token - self.arrival

    @property
    def latency(self) -> float:
        """End-to-end request latency (arrival to final token)."""
        return self.finished - self.arrival

    @property
    def n_generated(self) -> int:
        return int(self.tokens.shape[0])


@dataclass
class Scheduler:
    """Request queue + tier-aware slot admission (FIFO or EDF order)."""

    queue: List[Request] = field(default_factory=list)
    policy: str = "fifo"               # "fifo" | "slo" (EDF)
    tier_slo_s: Optional[Dict[Optional[int], float]] = None
    enqueued: int = 0                  # cumulative adds (incl. re-queues)

    def __post_init__(self) -> None:
        assert self.policy in ("fifo", "slo"), self.policy
        if self.policy == "slo":
            assert self.tier_slo_s, "policy='slo' needs tier_slo_s targets"

    def add(self, req: Request) -> None:
        """Enqueue an arrived request."""
        self.queue.append(req)
        self.enqueued += 1

    def __len__(self) -> int:
        return len(self.queue)

    def publish(self, reg) -> None:
        """Set queue gauges on ``reg`` (a repro.obs.MetricsRegistry);
        the engine registers this as a snapshot-time pull source."""
        reg.gauge("serving.scheduler.queue_depth").set(len(self.queue))
        reg.gauge("serving.scheduler.enqueued_total").set(self.enqueued)

    def deadline(self, req: Request) -> float:
        """The request's TTFT deadline on the engine clock: arrival plus
        its tier's SLO target; ``inf`` when the tier has no target (such
        requests are never considered urgent)."""
        if not self.tier_slo_s:
            return float("inf")
        slo = self.tier_slo_s.get(req.k, float("inf"))
        return req.arrival + slo

    def _order(self) -> None:
        """Re-order the queue by the active policy.  EDF sort is stable,
        so equal deadlines (and untargeted tiers) stay FIFO."""
        if self.policy == "slo":
            self.queue.sort(key=self.deadline)

    def admit(self, free_slots: Sequence[int],
              slot_k: Sequence[Optional[int]],
              can_admit: Optional[Callable[[Request, int], bool]] = None
              ) -> List[Tuple[Request, int]]:
        """Pack queued requests into ``free_slots``.

        ``slot_k[s]`` is slot ``s``'s static expert budget (None for
        non-MoE models).  Queue-order per tier (FIFO, or EDF under
        ``policy="slo"``): each queued request takes the first free slot
        matching its requested ``k`` (any slot when the request doesn't
        care); non-matching requests are skipped, not blocked on.
        Returns (request, slot) assignments and removes the admitted
        requests from the queue.

        ``can_admit``: optional resource predicate ``(request, slot) ->
        bool`` (the paged engine's projected-block-need + tier-quota
        check), consulted AFTER a slot match — a request the predicate
        accepts is guaranteed admitted, so the predicate may account
        resources as it accepts (rejected probes must be side-effect
        free).  A rejection blocks the probed SLOT tier for the rest of
        this admit round (head-of-line per tier): later requests —
        including wildcard ``k=None`` ones — cannot take that tier's
        slots and leapfrog an earlier request that is only waiting on
        blocks, since a stream of small requests could otherwise starve
        a big one forever; other tiers' admission proceeds untouched.
        A wildcard request is probed against one slot of EACH distinct
        unblocked tier (in free-list order) before it is deemed
        blocked, so a single tier's quota saturation cannot idle slots
        another tier could have given it.
        """
        self._order()
        free = list(free_slots)
        assigned: List[Tuple[Request, int]] = []
        remaining: List[Request] = []
        blocked_tiers: set = set()
        for req in self.queue:
            candidates: List[int] = []
            seen_tiers: set = set()
            for s in free:
                t = slot_k[s]
                if t in blocked_tiers or t in seen_tiers:
                    continue
                if req.k is None or t == req.k:
                    seen_tiers.add(t)
                    candidates.append(s)
                    if req.k is not None:
                        break
            placed = False
            for slot in candidates:
                if can_admit is None or can_admit(req, slot):
                    free.remove(slot)
                    assigned.append((req, slot))
                    placed = True
                    break
                blocked_tiers.add(slot_k[slot])
            if not placed:
                remaining.append(req)
        self.queue = remaining
        return assigned
