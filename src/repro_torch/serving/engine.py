"""Continuous-batching serving engine with per-slot adaptive k (port of
``repro/serving/engine.py``: ragged dispatch over the block-paged or the
slotted KV pool, greedy or sampled decoding, self-speculative decoding,
the production traffic layer and its observability).

One engine iteration:

  1. requests whose arrival time has passed join the scheduler queue;
  2. the scheduler packs waiting requests into free slots (FIFO per tier,
     or earliest-deadline-first under ``slo_ms``), gated on each request's
     projected block need and per-tier block quotas; admitted requests are
     prefilled in groups, their K/V scattered into the block pool, and
     their first token emitted (TTFT);
  3. one decode step advances every active slot by a token.  Slots carry
     static expert budgets ``slot_k`` (premium slots at full k,
     constrained ones at k=1–2): the MoE layers route each row at its own
     budget and the ragged dispatch makes expert work follow
     ``sum(slot_k)``.  Finished requests release their slot and blocks.

``kv_layout="slotted"`` backs the slots with the monolithic
:class:`SlotPool` instead (the reference's differential oracle: token for
token the paged engine's); an attention-free model (``mamba2-780m``) has
no K/V to page and always runs on it.  Mamba layers keep their state per
slot in either pool.  ``sampler=SamplerConfig(kind="temperature" |
"top_p")`` samples: each draw takes its uniforms from (``seed``, request
id, the request's event counter), so a request's tokens never depend on
its slot, the layout or what shares its batch; the draws run on the
device over the step's logits.  ``speculative=SpeculativeConfig(...)``
replaces the decode step by self-speculative rounds
(:mod:`.speculative`): draft W tokens per slot at ``draft_k``, verify in
one full-k multi-token step, accept by the rejection rule and roll the
rejected K/V back.

Production traffic controls:

* ``prefix_cache=True`` — prompts are matched against the pool's
  content-addressed block index at admission (``BlockPool.attach_prefix``,
  digests salted by the slot's tier k), so requests sharing a system
  prompt hold its K/V blocks once, and prefill runs over the unmatched
  suffix only (``model.prefill_suffix``), attending into the attached
  pages.  Matched rows group by the power-of-two bucket of their suffix
  length (the reference's grouping, so the prefill calls are the
  reference's); cold misses keep the exact-length full prefill.
* ``slo_ms={tier_k: target_ms}`` — per-tier TTFT targets: admission
  becomes earliest-deadline-first and the report gains per-tier SLO
  attainment.
* ``preemption=True`` (needs ``slo_ms``) — when a waiter is past its TTFT
  deadline after a packing pass (for want of blocks, or, as in the
  reference, of a free slot of its tier), the active request with the
  most lenient deadline is swapped out to host memory
  (``BlockPool.swap_out``, blocks and reservation freed) and resumes
  through normal admission, bit for bit, at most ``max_preemptions``
  times each.

Observability (all opt-in; the defaults cost one attribute check per
event site): ``tracer`` (a :class:`repro_torch.obs.Tracer`) records
request-lifecycle spans (queued / prefill / decode, swap instants) and
engine-loop spans with no device sync of its own, and is flight-dumped if
``run`` raises.  The loop's spans are on the tracer's clock
(``time.time_ns``, the clock ``torch.profiler`` stamps with; the
request-lifecycle spans map the engine-relative ``Completion`` times onto
it): one ``engine.iter`` per working loop iteration (an idle poll before
the next arrival leaves none), ``admit``, a ``prefill`` per group
(``rids``: its requests; parent of ``model.prefill``, ``pool.write`` and
``engine.readback``, the wait in the step's one host copy),
``engine.emit``, ``decode_step`` (parent of ``pool.prepare_decode`` and
``model.decode_step``); the pool counts the decode step's K/V rows
gathered against live (``kv.rows_gathered``, ``kv.rows_live``).  With
``tracer=None`` the tracer is resolved at each ``run`` by
:func:`repro_torch.obs.trace.active`: while a ``torch.profiler`` session
records, the process's session tracer, which also takes each model
call's device time (``dev_ms``) and counts its host syncs; else none.
``metrics`` (a ``MetricsRegistry``) gets
the engine's counters, the pool and scheduler as snapshot sources and the
run's step histograms; ``expert_telemetry=True`` makes each decode step
return its per-expert counts, brought to the host in the same transfer as
the logits, into ``report.expert_load``.

LoRA serving: ``lora=`` serves a FLAME global adapter unmerged (at bf16,
merging a small ΔW into W rounds much of it away).  The adapters ride in
launches the engine makes anyway: ``lora_matmul`` takes the place of the
plain q/k/v/o products, and each expert's ``{a, b}`` enters the grouped
ragged matmul.  One engine serves one adapter, so the prefix cache's
tier salt still keys its K/V.

Dispatch: ``"ragged"`` (the default), ``"dense"`` (one-hot, capacity the
token count: loss-free) or ``"capacity"`` (GShard capacity; batching may
change results; refused under speculation); ``no_drop`` is the
reference's legacy alias.  Prefill groups run at their own batch size
under the loss-free modes: the reference pads them to power-of-two
buckets to bound recompiles, which eager PyTorch does not have, and a
padding row cannot change a loss-free result.  Under ``"capacity"`` the
expert capacity follows the batch's size, so the groups are padded to the
reference's buckets (masked rows: they route nowhere, but size C as
there).  ``"dense"`` routes a prefill or suffix group one routing group
per row, as the reference does, so its one-hot tensors grow with the
group and not with its square.  Every engine step runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import model as model_lib
from ..models.moe_layer import resolve_dispatch
from ..obs import trace as obs_trace
from ..obs.expert_load import ExpertLoadTracker
from ..obs.metrics import Histogram, MetricsRegistry
from ..obs.trace import NULL_TRACER, PID_ENGINE, PID_REQUESTS, Tracer
from .kv_cache import BlockPool, SlotPool
from .sampler import SamplerConfig, event_uniforms, sample_token
from .scheduler import Completion, Request, Scheduler
from .speculative import SpeculativeConfig, SpeculativeDecoder
from .workload import percentile

PyTree = Any


def _log_softmax_np(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return x - (np.log(np.exp(x - m).sum(axis=-1, keepdims=True)) + m)


def _bucket(n: int) -> int:
    """Next power of two >= n (the reference's prefill buckets)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _tier_salt(k: Optional[int]) -> bytes:
    """Prefix-digest salt for an expert-budget tier: a block's K/V depend
    on the k its writer ran at, so equal prompts at different k must
    never alias each other's pages."""
    return b"" if k is None else str(int(k)).encode()


@dataclass
class _ActiveSlot:
    req: Request
    tokens: List[int]
    nll: float
    admitted: float
    first_token: float
    max_new: int
    # the request's sampling event counter: every draw takes its uniforms
    # from (seed, rid, events), so draws follow the request's own order
    events: int = 0
    # times swapped out mid-decode (capped by max_preemptions)
    preemptions: int = 0
    # engine time of the latest swap-out (the tracer's swapped_out span)
    swap_t: float = 0.0


def _pct_ms(xs: Sequence[float], q: float) -> Optional[float]:
    return percentile(list(xs), q) * 1e3 if xs else None


@dataclass
class ServingReport:
    """Everything a serving run produced, plus latency/throughput views."""
    completions: List[Completion]
    decode_step_s: List[float] = field(default_factory=list)
    prefill_s: List[float] = field(default_factory=list)
    wall_s: float = 0.0
    num_slots: int = 0
    slot_k: Tuple[Optional[int], ...] = ()
    # speculative accounting (zero when speculation is off)
    draft_step_s: List[float] = field(default_factory=list)
    verify_step_s: List[float] = field(default_factory=list)
    spec_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    preemptions: int = 0                     # swap-outs over the run
    # tokens the prefill calls computed: whole prompts on a cold engine,
    # the unmatched suffixes under suffix prefill
    prefill_tokens: int = 0
    prefix: Dict[str, int] = field(default_factory=dict)
    slo_ms: Optional[Dict[Optional[int], float]] = None
    decode_hist: Histogram = field(default_factory=Histogram)
    prefill_hist: Histogram = field(default_factory=Histogram)
    draft_hist: Histogram = field(default_factory=Histogram)
    verify_hist: Histogram = field(default_factory=Histogram)
    expert_load: Optional[Dict[str, Any]] = None

    def tokens_by_rid(self) -> Dict[int, np.ndarray]:
        """Generated tokens keyed by request id."""
        return {c.rid: c.tokens for c in self.completions}

    def per_tier(self) -> Dict[str, Dict[str, float]]:
        """Per-tier p50/p99 TTFT, tokens/s and (with ``slo_ms``) the share
        of requests whose TTFT met the tier's target."""
        by_tier: Dict[int, List[Completion]] = {}
        for c in self.completions:
            by_tier.setdefault(c.k, []).append(c)
        out: Dict[str, Dict[str, float]] = {}
        for k, cs in sorted(by_tier.items()):
            ttfts = [c.ttft for c in cs]
            row = {
                "n_requests": len(cs),
                "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
                "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
                "gen_tokens_per_s": (sum(c.n_generated for c in cs)
                                     / max(self.wall_s, 1e-9)),
            }
            slo = (self.slo_ms or {}).get(k)
            if slo is not None:
                row["slo_attainment"] = (
                    sum(t * 1e3 <= slo for t in ttfts) / len(cs))
            out[str(k)] = row
        return out

    def summary(self) -> Dict[str, Any]:
        """Flat, JSON-safe run summary (percentiles None when empty), with
        speculation, prefix-cache, preemption and expert-load accounting
        when on."""
        n = len(self.completions)
        gen = sum(c.n_generated for c in self.completions)
        ttfts = [c.ttft for c in self.completions]
        lats = [c.latency for c in self.completions]
        out = {
            "n_requests": n,
            "gen_tokens": gen,
            "wall_s": self.wall_s,
            "requests_per_s": n / max(self.wall_s, 1e-9),
            "gen_tokens_per_s": gen / max(self.wall_s, 1e-9),
            "ttft_p50_ms": _pct_ms(ttfts, 50),
            "ttft_p95_ms": _pct_ms(ttfts, 95),
            "ttft_p99_ms": _pct_ms(ttfts, 99),
            "latency_p50_ms": _pct_ms(lats, 50),
            "latency_p95_ms": _pct_ms(lats, 95),
            "decode_step_ms_mean": (float(np.mean(self.decode_step_s)) * 1e3
                                    if self.decode_step_s else None),
            "decode_step_ms_p50": self.decode_hist.percentile(50),
            "decode_step_ms_p99": self.decode_hist.percentile(99),
            "decode_steps": len(self.decode_step_s),
            "prefill_tokens": self.prefill_tokens,
            "truncated": sum(c.truncated for c in self.completions),
            "per_tier": self.per_tier(),
        }
        if self.preemptions:
            out["preemptions"] = self.preemptions
        if self.prefix:
            out["prefix_cache"] = dict(self.prefix)
        if self.spec_rounds:
            out.update({
                "spec_rounds": self.spec_rounds,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "acceptance_rate": (self.spec_accepted
                                    / max(self.spec_drafted, 1)),
                "draft_step_ms_mean": float(np.mean(self.draft_step_s)) * 1e3,
                "draft_step_ms_p50": self.draft_hist.percentile(50),
                "draft_step_ms_p99": self.draft_hist.percentile(99),
                "verify_step_ms_mean": (float(np.mean(self.verify_step_s))
                                        * 1e3),
                "verify_step_ms_p50": self.verify_hist.percentile(50),
                "verify_step_ms_p99": self.verify_hist.percentile(99),
            })
        if self.expert_load is not None:
            out["expert_load"] = {
                k: self.expert_load[k]
                for k in ("steps", "gini", "entropy", "hot_expert",
                          "assignments_total")}
        return out


class ServingEngine:
    """Continuous batching over a :class:`BlockPool` (or, with
    ``kv_layout="slotted"``, a :class:`SlotPool`) with per-slot k.

    ``params`` live on the device the engine runs on (CUDA: the kernels;
    CPU: their plain versions).  ``slot_k``: per-slot expert budgets
    (default ``cfg.moe.top_k`` everywhere); requests are matched to slots
    of their tier.  ``rescaler_by_k``: optional ``{k: {"pos{j}":
    (n_periods,)}}`` — each tier's FLAME s_i, applied per slot in decode
    and per group in prefill (one entry per MoE position ``pos{j}``).
    ``sampler``, ``seed``, ``speculative``,
    ``prefix_cache``, ``slo_ms``, ``preemption``, ``max_preemptions``,
    ``tracer``, ``metrics`` and ``expert_telemetry``: see the module
    docstring.  ``lora``: the unmerged adapter tree (``{"blocks": ...}``,
    on the engine's device and dtype).  ``dispatch``: ``"ragged"``
    (default), ``"dense"`` or ``"capacity"``; ``no_drop`` the legacy alias
    (True -> dense, False -> capacity) when ``dispatch`` is unset."""

    def __init__(self, cfg, params: PyTree, *, lora: Optional[PyTree] = None,
                 rescaler_by_k: Optional[Dict[int, PyTree]] = None,
                 num_slots: int = 8, slot_len: int = 64,
                 slot_k: Optional[Sequence[int]] = None,
                 kv_layout: str = "paged", block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 no_drop: Optional[bool] = None,
                 dispatch: Optional[str] = None,
                 sampler: Optional[SamplerConfig] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 prefix_cache: bool = False,
                 preemption: bool = False,
                 slo_ms: Optional[Dict[Optional[int], float]] = None,
                 max_preemptions: int = 4,
                 seed: int = 0,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 expert_telemetry: bool = False):
        # the reference's guards first, with its errors
        dispatch = (resolve_dispatch(dispatch, no_drop)
                    if dispatch is not None or no_drop is not None
                    else "ragged")
        if kv_layout not in ("paged", "slotted"):
            raise ValueError(f"kv_layout={kv_layout!r}: paged or slotted")
        # an attention-free model has no K/V to page: it runs on the
        # slotted pool (its per-row state), as the reference's engine does
        kinds = {cfg.layer_kind(p) for p in range(cfg.pattern_period)}
        paged = kv_layout == "paged" and "attn" in kinds
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache needs the paged KV layout (block sharing "
                "has no meaning in the slotted pool)")
        if preemption:
            if not paged:
                raise ValueError(
                    "preemption needs the paged KV layout (swap-out "
                    "frees blocks, not whole slots)")
            if not slo_ms:
                raise ValueError(
                    "preemption needs slo_ms targets: victim selection "
                    "is driven by TTFT deadlines")
        if expert_telemetry and not cfg.moe.enabled:
            raise ValueError("expert_telemetry needs an MoE model: a "
                             "dense model routes nothing to observe")
        if expert_telemetry and speculative is not None:
            raise ValueError(
                "expert_telemetry under speculative decoding is not "
                "supported yet: the fused draft window does not surface "
                "activation counts")
        if speculative is not None and dispatch == "capacity":
            raise ValueError(
                "speculative verify requires a loss-free dispatch mode "
                "(ragged/dense): capacity dispatch makes the verify "
                "distribution depend on co-batched rows")
        if cfg.num_codebooks:
            raise ValueError("serving engine: text models only")
        self.cfg = cfg
        self.params = params
        self.device = params["final_norm"].device
        self.num_slots = num_slots
        self.slot_len = slot_len
        self.dispatch = dispatch
        self.paged = paged
        self._sampler = sampler or SamplerConfig()
        self._seed = seed
        if cfg.moe.enabled:
            resolved = tuple(int(v) for v in (
                slot_k if slot_k is not None
                else (cfg.moe.top_k,) * num_slots))
            if len(resolved) != num_slots or not all(
                    1 <= v <= cfg.moe.num_experts for v in resolved):
                raise ValueError(f"slot_k={resolved} for {num_slots} slots "
                                 f"and {cfg.moe.num_experts} experts")
            self.slot_k: Tuple[Optional[int], ...] = resolved
            self._moe_k: Optional[Tuple[int, ...]] = resolved
        else:
            if slot_k is not None:
                raise ValueError("slot_k is meaningless without MoE")
            self.slot_k = (None,) * num_slots
            self._moe_k = None

        self._lora = lora
        self._rescaler_by_k = rescaler_by_k
        self._decode_trainable = self._build_decode_trainable()

        if self.paged:
            self.pool = BlockPool(cfg, num_slots, slot_len,
                                  block_size=block_size,
                                  num_blocks=num_blocks,
                                  prefix_cache=prefix_cache,
                                  device=self.device)
            # per-tier block quotas (the tier's slot share, floored at one
            # full request): a tier exceeds its quota only while no other
            # tier waits
            counts: Dict[Optional[int], int] = {}
            for t in self.slot_k:
                counts[t] = counts.get(t, 0) + 1
            self._tier_quota = {
                t: max(self.pool.blocks_per_slot,
                       self.pool.num_blocks * c // num_slots)
                for t, c in counts.items()}
            self._tier_reserved = {t: 0 for t in counts}
        else:
            self.pool = SlotPool(cfg, num_slots, slot_len,
                                 device=self.device)
        self.prefix_cache = prefix_cache
        # suffix-only prefill for attention-only models: a Mamba layer's
        # state is cumulative over the whole prompt, so a hybrid model's
        # prefix hit shares blocks but prefills in full
        self._use_suffix = prefix_cache and kinds == {"attn"}
        self.slo_ms = dict(slo_ms) if slo_ms else None
        self._preemption = preemption
        self._max_preemptions = max_preemptions
        # rid -> (pool swap state, _ActiveSlot, last sampled token):
        # everything a preempted request needs to resume bit for bit
        self._swapped: Dict[int, Tuple[Dict[str, Any], _ActiveSlot,
                                       int]] = {}
        if self.slo_ms:
            self.scheduler = Scheduler(
                policy="slo",
                tier_slo_s={t: ms / 1e3 for t, ms in self.slo_ms.items()})
        else:
            self.scheduler = Scheduler()
        self._active: List[Optional[_ActiveSlot]] = [None] * num_slots
        self._last_tok = np.zeros((num_slots, 1), np.int64)

        self._tracer_arg = tracer
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._metrics = metrics
        self._expert_tracker = (ExpertLoadTracker(cfg.moe.num_experts)
                                if expert_telemetry else None)
        if metrics is not None:
            metrics.add_source(self.pool.publish)
            metrics.add_source(self.scheduler.publish)
            self._ctr_completions = metrics.counter("serving.completions")
            self._ctr_tokens = metrics.counter("serving.gen_tokens")
            self._ctr_admitted = metrics.counter("serving.admitted")
            self._ctr_preempt = metrics.counter("serving.preemptions")
        self._spec = (SpeculativeDecoder(self, speculative)
                      if speculative is not None else None)

    # ------------------------------------------------------------- trainables
    def _build_decode_trainable(self) -> Optional[PyTree]:
        tr: dict = {}
        if self._lora is not None:
            tr["lora"] = self._lora
        if self._rescaler_by_k:
            ks = [k for k in self.slot_k if k is not None]
            missing = sorted(set(ks) - set(self._rescaler_by_k))
            if missing:
                raise ValueError(f"rescaler_by_k missing tiers {missing}")
            # stack tiers per slot: (n_periods,) -> (n_periods, num_slots);
            # the stack loop slices the leading axis, so each MoE layer
            # sees a (num_slots,) vector — the per-slot rescaler of
            # apply_moe
            tr["rescaler"] = {
                pos: torch.stack([self._rescaler_by_k[k][pos] for k in ks],
                                 dim=-1).to(self.device)
                for pos in self._rescaler_by_k[ks[0]]}
        return tr or None

    def _build_draft_trainable(self, draft_k: int) -> Optional[PyTree]:
        """The draft window's trainables: the adapter, and every slot at
        the scalar ``draft_k``, so the ``draft_k`` tier's rescaler when one
        was given (otherwise the draft runs unrescaled: any draft
        distribution keeps the rule exact, only the acceptance rate
        moves)."""
        known = bool(self._rescaler_by_k) and draft_k in self._rescaler_by_k
        return self._prefill_trainable(draft_k if known else None)

    def _prefill_trainable(self, k: Optional[int]) -> Optional[PyTree]:
        tr: dict = {}
        if self._lora is not None:
            tr["lora"] = self._lora
        if self._rescaler_by_k and k is not None:
            tr["rescaler"] = {pos: r.to(self.device) for pos, r in
                              self._rescaler_by_k[k].items()}
        return tr or None

    # ------------------------------------------------------------------ admit
    @staticmethod
    def _max_new(req: Request) -> int:
        if req.forced is not None:
            return min(req.max_new_tokens, len(req.forced))
        return req.max_new_tokens

    def _projected_tokens(self, req: Request) -> int:
        """Cache positions the request writes over its lifetime: the prompt
        plus one per generated token after the first."""
        return req.prompt_len + max(self._max_new(req), 1) - 1

    def _admit(self, report: ServingReport) -> int:
        """One admission round: a packing pass, then (with preemption)
        swap out lenient-deadline victims while a waiter is past its TTFT
        deadline and another pass can seat it."""
        with self._tracer.span("admit", cat="engine") as sp:
            n = self._admit_pass(report)
            if self._preemption:
                for _ in range(self.num_slots):
                    victim = self._pick_victim()
                    if victim is None:
                        break
                    self._preempt(victim, report)
                    got = self._admit_pass(report)
                    n += got
                    if got == 0:
                        # the freed blocks alone did not seat the waiter:
                        # stop rather than strip the pool in one round
                        break
            if n:
                sp.note(admitted=n)
            else:
                sp.drop()
        if n and self._metrics is not None:
            self._ctr_admitted.inc(n)
        return n

    def _pick_victim(self) -> Optional[int]:
        """When the most urgent waiter is past its TTFT deadline, the
        active request with the latest deadline — strictly later than the
        waiter's — ties broken toward the most recently admitted; requests
        preempted ``max_preemptions`` times are exempt."""
        if not len(self.scheduler):
            return None
        sch = self.scheduler
        now = self._now()
        urgent = [sch.deadline(r) for r in sch.queue
                  if sch.deadline(r) <= now]
        if not urgent:
            return None
        w_deadline = min(urgent)
        best: Optional[int] = None
        best_key: Optional[Tuple[float, float]] = None
        for s, a in enumerate(self._active):
            if a is None or a.preemptions >= self._max_preemptions:
                continue
            v_deadline = sch.deadline(a.req)
            if v_deadline <= w_deadline:
                continue
            key = (v_deadline, a.admitted)
            if best_key is None or key > best_key:
                best, best_key = s, key
        return best

    def _preempt(self, slot: int, report: ServingReport) -> None:
        """Swap ``slot``'s request out to the host and requeue it; its tier
        is pinned to the slot's k so it resumes at the budget it started
        decoding with."""
        a = self._active[slot]
        if self._spec is not None:
            # an open draft window must not leak into the swap state
            self._spec.rollback_open(slot)
        tier = self.slot_k[slot]
        self._tier_reserved[tier] -= self.pool.reserved_for(slot)
        state = self.pool.swap_out(slot)
        a.preemptions += 1
        a.req.k = tier
        self._swapped[a.req.rid] = (state, a, int(self._last_tok[slot, 0]))
        self._active[slot] = None
        self.scheduler.add(a.req)
        report.preemptions += 1
        if self._tracer.enabled:
            a.swap_t = self._now()
            self._tracer.instant("swap_out", a.swap_t, pid=PID_REQUESTS,
                                 tid=a.req.rid, cat="preempt",
                                 args={"slot": slot})
        if self._metrics is not None:
            self._ctr_preempt.inc()

    def _can_admit_fn(self):
        """The paged admission predicate: projected block need against the
        headroom (with an escrow for the oldest block-starved waiter) and
        the per-tier quota under cross-tier contention, accounting blocks
        as the scheduler accepts."""
        booked = 0
        booked_by_tier: Dict[Optional[int], int] = {}
        waiting_tiers: set = set()
        for r in self.scheduler.queue:
            if r.k is None:
                waiting_tiers.update(self._tier_quota)
                break
            waiting_tiers.add(r.k)
        escrow = 0
        escrow_rid: Optional[int] = None

        def can_admit(req: Request, slot: int) -> bool:
            nonlocal booked, escrow, escrow_rid
            tier = self.slot_k[slot]
            need = self.pool.blocks_needed(self._projected_tokens(req))
            avail = self.pool.available_blocks - booked
            if escrow_rid is not None and req.rid != escrow_rid:
                avail -= escrow
            if need > avail:
                if escrow_rid is None or escrow_rid == req.rid:
                    escrow, escrow_rid = need, req.rid
                return False
            held = (self._tier_reserved[tier]
                    + booked_by_tier.get(tier, 0) + need)
            if held > self._tier_quota[tier] and waiting_tiers - {tier}:
                return False
            booked += need
            booked_by_tier[tier] = booked_by_tier.get(tier, 0) + need
            return True
        return can_admit

    def _admit_pass(self, report: ServingReport) -> int:
        free = self.pool.free_slots
        if not free or not len(self.scheduler):
            return 0
        assignments = self.scheduler.admit(
            free, self.slot_k, self._can_admit_fn() if self.paged else None)
        # prefill groups keyed (kind, width, tier): "full" groups key on the
        # exact prompt length; under the prefix cache the match runs now
        # (in admission order, so same-pass duplicates share), and rows
        # with a usable matched head form "suffix" groups keyed by the
        # power-of-two bucket of their suffix.  Items carry (request, slot,
        # suffix start, matched tokens).
        groups: Dict[Tuple[str, int, Optional[int]],
                     List[Tuple[Request, int, int, int]]] = {}
        for req, slot in assignments:
            self.pool.take(slot)
            if self.paged:
                proj = self._projected_tokens(req)
                self.pool.reserve(slot, proj)
                self._tier_reserved[self.slot_k[slot]] += \
                    self.pool.blocks_needed(proj)
            if req.rid in self._swapped:
                # resume a preempted request from its exact KV state; its
                # timestamps continue from where the swap-out left them
                state, a, last = self._swapped.pop(req.rid)
                self.pool.swap_in(slot, state)
                self._active[slot] = a
                self._last_tok[slot, 0] = last
                if self._tracer.enabled:
                    now = self._now()
                    self._tracer.complete(
                        "swapped_out", a.swap_t, now, pid=PID_REQUESTS,
                        tid=req.rid, cat="preempt", rid=req.rid)
                    self._tracer.instant("swap_in", now, pid=PID_REQUESTS,
                                         tid=req.rid, cat="preempt",
                                         args={"slot": slot})
                continue
            if self._use_suffix:
                L = req.prompt_len
                covered, ready = self.pool.attach_prefix(
                    slot, req.prompt, L, _tier_salt(self.slot_k[slot]))
                # the suffix starts at the ready span rounded down to a
                # block (the cache validity is idx < start, which must not
                # admit a partially matched block's foreign tail), floored
                # at L-1 so a full match still runs a one-token step
                bs = self.pool.block_size
                sstart = min((ready // bs) * bs, L - 1)
                key = (("suffix", _bucket(L - sstart))
                       if sstart > 0 else ("full", L))
                groups.setdefault(key + (self.slot_k[slot],), []).append(
                    (req, slot, sstart, covered))
            else:
                groups.setdefault(("full", req.prompt_len, self.slot_k[slot]),
                                  []).append((req, slot, 0, 0))

        tr = self._tracer
        for (kind, width, kk), items in groups.items():
            nb = len(items)
            slots = [s for _, s, _, _ in items]
            with tr.span("prefill", cat="engine",
                         rids=[r.rid for r, _, _, _ in items]) as sp:
                admitted = self._now()
                if kind == "suffix":
                    logits = self._prefill_suffix_group(items, kk)
                    report.prefill_tokens += sum(
                        r.prompt_len - st for r, _, st, _ in items)
                    targs = {"batch": nb, "suffix_bucket": width}
                else:
                    prompts = np.stack([r.prompt for r, _, _, _ in items])
                    real = self._capacity_rows(nb)
                    if real is not None:
                        # the reference's bucket rows (copies of the first
                        # prompt, routed nowhere)
                        prompts = np.concatenate(
                            [prompts,
                             np.repeat(prompts[:1], len(real) - nb, 0)])
                        real = torch.as_tensor(real, device=self.device)
                    # only the first L columns are scattered, so the
                    # prefill cache needs no padding to slot_len
                    logits, cache = model_lib.prefill(
                        self.cfg, self.params,
                        torch.as_tensor(prompts, dtype=torch.int64,
                                        device=self.device),
                        trainable=self._prefill_trainable(kk), k=kk,
                        slot_mask=real, dispatch=self.dispatch,
                        num_groups=self._groups(len(prompts)))
                    logits = logits[:nb, 0].float()
                    # under suffix prefill the match/attach/alloc already
                    # ran: scatter past the matched span only (a same-pass
                    # duplicate recomputes its prompt but must not rewrite
                    # the shared blocks it attached); a hybrid model's pool
                    # matches, attaches and indexes the prompts itself
                    with tr.span("pool.write"):
                        if self._use_suffix:
                            self.pool.write(
                                slots, cache, [width] * nb,
                                starts=[cov for _, _, _, cov in items])
                        else:
                            self.pool.write(
                                slots, cache, [width] * nb,
                                tokens=([r.prompt for r, _, _, _ in items]
                                        if self.prefix_cache else None),
                                salt=_tier_salt(kk))
                    report.prefill_tokens += nb * width
                    targs = {"batch": nb, "prompt_len": width}
                actives = [_ActiveSlot(req=req, tokens=[], nll=0.0,
                                       admitted=admitted, first_token=0.0,
                                       max_new=self._max_new(req))
                           for req, _, _, _ in items]
                logits_np, drawn = self._select(logits, actives)   # waits
                tft = self._now()
                report.prefill_s.append(tft - admitted)
                report.prefill_hist.observe((tft - admitted) * 1e3)
                sp.note(**targs, k=kk if kk is not None else 0)
            with tr.span("engine.emit"):
                for j, (a, slot) in enumerate(zip(actives, slots)):
                    a.first_token = tft
                    self._active[slot] = a
                    self._emit(slot, a, logits_np[j], drawn[j], report)
        return len(assignments)

    def _capacity_rows(self, nb: int) -> Optional[np.ndarray]:
        """Under capacity dispatch (MoE): the 0/1 real-row vector of the
        reference's power-of-two prefill bucket, whose size sets the
        expert capacity; otherwise None (groups run at their own size)."""
        if self.dispatch != "capacity" or not self.cfg.moe.enabled:
            return None
        return (np.arange(_bucket(nb)) < nb).astype(np.float32)

    def _groups(self, rows: int) -> int:
        """Routing groups of a prefill or suffix call: one per row under
        dense dispatch (the reference's), else one."""
        return rows if self.dispatch == "dense" else 1

    def _prefill_suffix_group(self, items, kk: Optional[int]) -> torch.Tensor:
        """One suffix-prefill call for a group; scatters the new K/V past
        each row's matched span and returns the rows' last logits (fp32,
        on the device).  The token block is as wide as the group's
        longest suffix (under capacity dispatch: the reference's shape,
        the group's suffix bucket wide and the rows padded to the batch
        bucket, pad rows with prefix 0 and suffix 1); when rows' suffixes
        differ, per-token budgets route the padding columns to no
        expert."""
        nb = len(items)
        pref = np.asarray([st for _, _, st, _ in items], np.int64)
        suf = np.asarray([r.prompt_len - st for r, _, st, _ in items],
                         np.int64)
        real = self._capacity_rows(nb)
        S, rows = int(suf.max()), nb
        if real is not None:
            S, rows = _bucket(S), len(real)
            pref = np.concatenate([pref, np.zeros(rows - nb, np.int64)])
            suf = np.concatenate([suf, np.ones(rows - nb, np.int64)])
        toks = np.zeros((rows, S), np.int64)
        for j, (req, _slot, st, _cov) in enumerate(items):
            toks[j, :suf[j]] = req.prompt[st:]
        # only prefix positions < pref are read: gather just their blocks
        span_b = -(-int(pref.max()) // self.pool.block_size)
        tbl = np.zeros((rows, span_b), self.pool.block_table.dtype)
        for j, (_req, s, _st, _cov) in enumerate(items):
            tbl[j] = self.pool.block_table[s, :span_b]
        k, mask = kk, None
        if self.cfg.moe.enabled and (real is not None or (suf < S).any()):
            k = (kk,) * rows
            live = np.arange(S)[None, :] < suf[:, None]
            if real is not None:
                live = live * real[:, None]
            mask = torch.as_tensor(live, dtype=torch.float32,
                                   device=self.device)
        logits, piece = model_lib.prefill_suffix(
            self.cfg, self.params,
            torch.as_tensor(toks, device=self.device), pref, suf,
            self.pool.cache, torch.as_tensor(tbl, device=self.device),
            page_span=span_b * self.pool.block_size,
            trainable=self._prefill_trainable(kk), k=k, slot_mask=mask,
            dispatch=self.dispatch, num_groups=self._groups(rows))
        with self._tracer.span("pool.write"):
            self.pool.write([s for _, s, _, _ in items], piece,
                            [r.prompt_len for r, _, _, _ in items],
                            starts=[cov for _, _, _, cov in items],
                            piece_col0=pref[:nb].tolist())
        return logits[:nb, 0].float()

    # --------------------------------------------------------------- sampling
    def _draw(self, a: _ActiveSlot) -> float:
        """The uniform of the request's next sampling event."""
        u = event_uniforms(self._seed, a.req.rid, a.events)[0]
        a.events += 1
        return u

    def _select(self, logits: torch.Tensor,
                rows: Sequence[Optional[_ActiveSlot]], *extra: torch.Tensor):
        """Bring a step's logits (n, V) to the host in one copy, with any
        ``extra`` tensors and, for the sampled kinds, a token per row drawn
        on the device (each live, unforced request's row from its next
        event; the other rows' draws go unused).  Returns (host logits,
        drawn tokens (all -1 under greedy), host extras...)."""
        parts = [logits.reshape(-1)]
        sampled = self._sampler.kind != "greedy"
        if sampled:
            u = np.zeros(len(rows))
            for j, a in enumerate(rows):
                if a is not None and a.req.forced is None:
                    u[j] = self._draw(a)
            tok = sample_token(logits, torch.as_tensor(u).to(
                logits.device, non_blocking=True), self._sampler)
            parts.append(tok.to(logits.dtype))     # ids < 2^24: exact
        parts += [t.float().reshape(-1) for t in extra]
        host = torch.cat(parts)
        with self._tracer.span("engine.readback"):
            host = host.cpu().numpy()
        pieces = np.split(host, np.cumsum([t.numel() for t in parts])[:-1])
        logits_np = pieces[0].reshape(logits.shape)
        drawn = (pieces[1].astype(np.int64) if sampled
                 else np.full(len(rows), -1, np.int64))
        return (logits_np, drawn) + tuple(pieces[1 + sampled:])

    def _pick(self, logits_row: np.ndarray, a: _ActiveSlot,
              drawn: int) -> Tuple[int, float]:
        """Next token: the request's forced token with its NLL, the greedy
        argmax (first maximal id), or the token drawn on the device."""
        if a.req.forced is not None:
            tok = int(a.req.forced[len(a.tokens)])
            return tok, float(-_log_softmax_np(logits_row)[tok])
        if self._sampler.kind == "greedy":
            return int(np.argmax(logits_row)), 0.0
        return int(drawn), 0.0

    def _emit(self, slot: int, a: _ActiveSlot, logits_row: np.ndarray,
              drawn: int, report: ServingReport) -> None:
        tok, nll = self._pick(logits_row, a, drawn)
        a.tokens.append(tok)
        a.nll += nll
        self._last_tok[slot, 0] = tok
        if len(a.tokens) >= a.max_new or self.pool.slot_full(slot):
            self._finish(slot, report)

    # ----------------------------------------------------------------- decode
    def _decode_once(self, report: ServingReport) -> None:
        tr = self._tracer
        with tr.span("decode_step", cat="engine") as sp:
            t_start = time.perf_counter()
            active = [s for s, a in enumerate(self._active) if a is not None]
            active_mask = torch.as_tensor(
                [a is not None for a in self._active], dtype=torch.float32,
                device=self.device)
            paged = {}
            if self.paged:
                with tr.span("pool.prepare_decode"):
                    self.pool.prepare_decode(active)
                    paged = dict(block_table=self.pool.tables(),
                                 page_span=self.pool.attn_len)
            telemetry = self._expert_tracker is not None
            out = model_lib.decode_step(
                self.cfg, self.params, self.pool.cache,
                torch.as_tensor(self._last_tok, device=self.device),
                self.pool.positions(), trainable=self._decode_trainable,
                k=self._moe_k,
                slot_mask=active_mask if self.cfg.moe.enabled else None,
                dispatch=self.dispatch, return_counts=telemetry, **paged)
            # the expert counts ride in the logits' transfer: one wait, one
            # copy
            keys = sorted(out[2]) if telemetry else []
            logits_np, drawn, *counts = self._select(
                out[0][:, 0].float(), self._active,
                *[out[2][p] for p in keys])
            dt = time.perf_counter() - t_start
            report.decode_step_s.append(dt)
            report.decode_hist.observe(dt * 1e3)
            if telemetry:
                self._expert_tracker.observe_step(
                    {p: c.reshape(out[2][p].shape)
                     for p, c in zip(keys, counts)})
            sp.note(active=len(active))
        with tr.span("engine.emit"):
            self.pool.advance(active)
            for slot in active:
                self._emit(slot, self._active[slot], logits_np[slot],
                           drawn[slot], report)

    def _finish(self, slot: int, report: ServingReport) -> None:
        a = self._active[slot]
        c = Completion(
            rid=a.req.rid, prompt_len=a.req.prompt_len,
            tokens=np.asarray(a.tokens, np.int32),
            k=self.slot_k[slot] or 0, arrival=a.req.arrival,
            admitted=a.admitted, first_token=a.first_token,
            finished=self._now(), nll_sum=a.nll,
            truncated=len(a.tokens) < a.max_new,
            preemptions=a.preemptions)
        report.completions.append(c)
        if self._tracer.enabled:
            # the request's lifecycle track, from the completion's
            # timestamps: an enclosing span and its queued -> prefill ->
            # decode phases (swap events were emitted as they happened)
            tr, tid = self._tracer, c.rid
            tr.thread_name(PID_REQUESTS, tid, f"req {tid}")
            args = {"rid": c.rid, "k": c.k, "prompt_len": c.prompt_len,
                    "gen_tokens": c.n_generated,
                    "preemptions": c.preemptions}
            tr.complete("request", c.arrival, c.finished, pid=PID_REQUESTS,
                        tid=tid, cat="request", args=args, rid=tid)
            tr.complete("queued", c.arrival, c.admitted, pid=PID_REQUESTS,
                        tid=tid, cat="request", rid=tid)
            tr.complete("prefill", c.admitted, c.first_token,
                        pid=PID_REQUESTS, tid=tid, cat="request", rid=tid)
            tr.complete("decode", c.first_token, c.finished,
                        pid=PID_REQUESTS, tid=tid, cat="request", rid=tid)
        if self._metrics is not None:
            self._ctr_completions.inc()
            self._ctr_tokens.inc(c.n_generated)
        self._active[slot] = None
        if self.paged:
            self._tier_reserved[self.slot_k[slot]] -= \
                self.pool.reserved_for(slot)
        self.pool.release(slot)

    # ------------------------------------------------------------------- loop
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self._active)

    @torch.inference_mode()
    def run(self, requests: Sequence[Request],
            max_steps: Optional[int] = None) -> ServingReport:
        """Serve an open-loop trace to completion (arrival times on the
        engine clock from the call; ``arrival=0.0`` everywhere is a
        deterministic closed batch)."""
        if self.n_active or len(self.scheduler):
            raise RuntimeError("engine already mid-run")
        too_long = [r.rid for r in requests
                    if r.prompt_len + 1 > self.slot_len]
        if too_long:
            raise ValueError(
                f"requests {too_long}: prompt leaves no room for a "
                f"generated token in a {self.slot_len}-token slot")
        if self._spec is not None:
            forced = [r.rid for r in requests if r.forced is not None]
            if forced:
                raise ValueError(
                    f"requests {forced}: teacher-forced (NLL) requests "
                    "cannot run under speculative decoding — the drafts "
                    "would diverge from the forced continuation")
        pending = sorted(requests, key=lambda r: r.arrival)
        report = ServingReport(completions=[], num_slots=self.num_slots,
                               slot_k=self.slot_k, slo_ms=self.slo_ms)
        if self._metrics is not None:
            # this run's step histograms, rebound every run
            self._metrics.register("serving.decode_step_ms",
                                   report.decode_hist)
            self._metrics.register("serving.prefill_ms", report.prefill_hist)
            if self._spec is not None:
                self._metrics.register("serving.draft_step_ms",
                                       report.draft_hist)
                self._metrics.register("serving.verify_step_ms",
                                       report.verify_hist)
        if self._expert_tracker is not None:
            self._expert_tracker.reset()
        tr = self._tracer = obs_trace.active(self._tracer_arg)
        if tr.enabled:
            tr.process_name(PID_ENGINE, "serving-engine")
            tr.thread_name(PID_ENGINE, 0, "engine loop")
            tr.process_name(PID_REQUESTS, "requests")
        self._t0 = time.perf_counter()
        if tr.enabled:
            tr.anchor(0.0)           # tracer time == engine-relative time
        steps = 0
        try:
            with obs_trace.use(tr):
                while pending or len(self.scheduler) or self.n_active:
                    with tr.span("engine.iter", pid=PID_ENGINE,
                                 tid=0) as it:
                        now = self._now()
                        while pending and pending[0].arrival <= now:
                            self.scheduler.add(pending.pop(0))
                        admitted = self._admit(report)
                        if tr.enabled:
                            tr.counter("engine", self._now(),
                                       {"active_slots": self.n_active,
                                        "queue_depth": len(self.scheduler)})
                        busy = self.n_active
                        if busy:
                            if self._spec is not None:
                                self._spec.round(report)
                            else:
                                self._decode_once(report)
                            steps += 1
                        elif not admitted:
                            it.drop()
                    if busy:
                        if max_steps is not None and steps >= max_steps:
                            break
                    elif not admitted:
                        if pending:          # idle until the next arrival
                            time.sleep(max(0.0, min(
                                pending[0].arrival - self._now(), 0.01)))
                        elif len(self.scheduler):
                            stuck = [r.rid for r in self.scheduler.queue]
                            raise RuntimeError(
                                f"requests {stuck} match no slot tier "
                                f"(slot_k={self.slot_k})")
        except Exception:
            # flight recorder: leave the last trace events on disk for a
            # postmortem, then re-raise
            path = tr.flight_dump()
            if path is not None:
                print(f"serving engine: exception — flight recorder "
                      f"dumped to {path}", file=sys.stderr)
            raise
        report.wall_s = self._now()
        report.completions.sort(key=lambda c: c.rid)
        if self._swapped and max_steps is None:
            raise RuntimeError("swapped-out requests left behind after a "
                               "full run")
        if self.prefix_cache:
            report.prefix = self.pool.prefix_stats()
        if self._expert_tracker is not None:
            report.expert_load = self._expert_tracker.snapshot()
            if self._metrics is not None:
                self._expert_tracker.publish(self._metrics)
        return report
