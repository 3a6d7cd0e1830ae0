"""Continuous-batching serving engine with per-slot adaptive k (port of
``repro/serving/engine.py``: the block-paged, ragged-dispatch, greedy path).

One engine iteration:

  1. requests whose arrival time has passed join the scheduler queue;
  2. the scheduler packs waiting requests into free slots (FIFO per tier,
     gated on each request's projected block need and per-tier block
     quotas); admitted requests are prefilled in groups of equal
     ``(prompt_len, tier k)``, their K/V scattered into the block pool,
     and their first token emitted (TTFT);
  3. one decode step advances every active slot by a token.  Slots carry
     static expert budgets ``slot_k`` (premium slots at full k,
     constrained ones at k=1–2): the MoE layers route each row at its own
     budget and the ragged dispatch makes expert work follow
     ``sum(slot_k)``.  Finished requests release their slot and blocks.

Prefill groups run at their own batch size: the reference pads them to
power-of-two buckets to bound recompiles, which eager PyTorch does not
have, and ragged dispatch is row-isolated, so padding rows could not
change a result anyway.  Every engine step runs under
``torch.inference_mode()``.

Speculative decoding, prefix caching, preemption/SLO admission, the
tracer, metrics registry and expert telemetry, the slotted pool, LoRA
adapters, sampled decoding and the one-hot dispatch modes come with later
slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import model as model_lib
from ..obs.metrics import Histogram
from .kv_cache import BlockPool
from .sampler import SamplerConfig
from .scheduler import Completion, Request, Scheduler
from .workload import percentile

PyTree = Any

_LATER = "comes with the serving-extras slice of the port"


def _log_softmax_np(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return x - (np.log(np.exp(x - m).sum(axis=-1, keepdims=True)) + m)


@dataclass
class _ActiveSlot:
    req: Request
    tokens: List[int]
    nll: float
    admitted: float
    first_token: float
    max_new: int


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
    prefill_tokens: int = 0
    decode_hist: Histogram = field(default_factory=Histogram)
    prefill_hist: Histogram = field(default_factory=Histogram)

    def tokens_by_rid(self) -> Dict[int, np.ndarray]:
        """Generated tokens keyed by request id."""
        return {c.rid: c.tokens for c in self.completions}

    def per_tier(self) -> Dict[str, Dict[str, float]]:
        by_tier: Dict[int, List[Completion]] = {}
        for c in self.completions:
            by_tier.setdefault(c.k, []).append(c)
        out: Dict[str, Dict[str, float]] = {}
        for k, cs in sorted(by_tier.items()):
            ttfts = [c.ttft for c in cs]
            out[str(k)] = {
                "n_requests": len(cs),
                "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
                "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
                "gen_tokens_per_s": (sum(c.n_generated for c in cs)
                                     / max(self.wall_s, 1e-9)),
            }
        return out

    def summary(self) -> Dict[str, Any]:
        """Flat, JSON-safe run summary (percentiles None when empty)."""
        n = len(self.completions)
        gen = sum(c.n_generated for c in self.completions)
        ttfts = [c.ttft for c in self.completions]
        lats = [c.latency for c in self.completions]
        return {
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


class ServingEngine:
    """Continuous batching over a :class:`BlockPool` with per-slot k.

    ``params`` live on the device the engine runs on (CUDA: the kernels;
    CPU: their plain versions).  ``slot_k``: per-slot expert budgets
    (default ``cfg.moe.top_k`` everywhere); requests are matched to slots
    of their tier.  ``rescaler_by_k``: optional ``{k: {"pos0":
    (n_periods,)}}`` — each tier's FLAME s_i, applied per slot in decode
    and per group in prefill.  The remaining keywords name features of the
    reference engine that later slices bring; anything but their default
    raises ``NotImplementedError``."""

    def __init__(self, cfg, params: PyTree, *, lora: Optional[PyTree] = None,
                 rescaler_by_k: Optional[Dict[int, PyTree]] = None,
                 num_slots: int = 8, slot_len: int = 64,
                 slot_k: Optional[Sequence[int]] = None,
                 kv_layout: str = "paged", block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 dispatch: str = "ragged",
                 sampler: Optional[SamplerConfig] = None,
                 speculative=None, prefix_cache: bool = False,
                 preemption: bool = False,
                 slo_ms: Optional[Dict[Optional[int], float]] = None,
                 tracer=None, metrics=None, expert_telemetry: bool = False):
        unsupported = {
            "lora": lora is not None, "speculative": speculative is not None,
            "prefix_cache": prefix_cache, "preemption": preemption,
            "slo_ms": bool(slo_ms), "tracer": tracer is not None,
            "metrics": metrics is not None,
            "expert_telemetry": expert_telemetry,
            f"kv_layout={kv_layout!r}": kv_layout != "paged",
            f"dispatch={dispatch!r}": dispatch != "ragged",
        }
        asked = [name for name, on in unsupported.items() if on]
        if asked:
            raise NotImplementedError(f"ServingEngine {', '.join(asked)}: "
                                      f"{_LATER}")
        if cfg.num_codebooks:
            raise ValueError("serving engine: text models only")
        self.cfg = cfg
        self.params = params
        self.device = params["final_norm"].device
        self.num_slots = num_slots
        self.slot_len = slot_len
        self.dispatch = dispatch
        del sampler      # SamplerConfig admits only greedy in this slice
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

        self._rescaler_by_k = rescaler_by_k
        self._decode_trainable = self._build_decode_trainable()

        self.pool = BlockPool(cfg, num_slots, slot_len, block_size=block_size,
                              num_blocks=num_blocks, device=self.device)
        # per-tier block quotas (the tier's slot share, floored at one full
        # request): a tier exceeds its quota only while no other tier waits
        counts: Dict[Optional[int], int] = {}
        for t in self.slot_k:
            counts[t] = counts.get(t, 0) + 1
        self._tier_quota = {
            t: max(self.pool.blocks_per_slot,
                   self.pool.num_blocks * c // num_slots)
            for t, c in counts.items()}
        self._tier_reserved = {t: 0 for t in counts}
        self.scheduler = Scheduler()
        self._active: List[Optional[_ActiveSlot]] = [None] * num_slots
        self._last_tok = np.zeros((num_slots, 1), np.int64)

    # ------------------------------------------------------------- trainables
    def _build_decode_trainable(self) -> Optional[PyTree]:
        if not self._rescaler_by_k:
            return None
        ks = [k for k in self.slot_k if k is not None]
        missing = sorted(set(ks) - set(self._rescaler_by_k))
        if missing:
            raise ValueError(f"rescaler_by_k missing tiers {missing}")
        # stack tiers per slot: (n_periods,) -> (n_periods, num_slots); the
        # stack loop slices the leading axis, so each MoE layer sees a
        # (num_slots,) vector — the per-slot rescaler of apply_moe
        return {"rescaler": {
            pos: torch.stack([self._rescaler_by_k[k][pos] for k in ks],
                             dim=-1).to(self.device)
            for pos in self._rescaler_by_k[ks[0]]}}

    def _prefill_trainable(self, k: Optional[int]) -> Optional[PyTree]:
        if self._rescaler_by_k and k is not None:
            return {"rescaler": {pos: r.to(self.device) for pos, r in
                                 self._rescaler_by_k[k].items()}}
        return None

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

    def _can_admit_fn(self):
        """The paged admission predicate: projected block need against the
        headroom (with an escrow for the oldest block-starved waiter) and
        the per-tier quota under cross-tier contention — the reference's
        rule, accounting blocks as the scheduler accepts."""
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
        assignments = self.scheduler.admit(free, self.slot_k,
                                           self._can_admit_fn())
        groups: Dict[Tuple[int, Optional[int]], List[Tuple[Request, int]]] = {}
        for req, slot in assignments:
            self.pool.take(slot)
            proj = self._projected_tokens(req)
            self.pool.reserve(slot, proj)
            self._tier_reserved[self.slot_k[slot]] += \
                self.pool.blocks_needed(proj)
            groups.setdefault((req.prompt_len, self.slot_k[slot]),
                              []).append((req, slot))

        for (L, kk), items in groups.items():
            admitted = self._now()
            prompts = torch.as_tensor(np.stack([r.prompt for r, _ in items]),
                                      dtype=torch.int64, device=self.device)
            # only the first L columns are scattered, so the prefill cache
            # needs no padding to slot_len
            logits, cache = model_lib.prefill(
                self.cfg, self.params, prompts,
                trainable=self._prefill_trainable(kk), k=kk,
                dispatch=self.dispatch)
            logits_np = logits[:, 0].float().cpu().numpy()
            self.pool.write([s for _, s in items], cache, [L] * len(items))
            report.prefill_tokens += len(items) * L
            tft = self._now()
            report.prefill_s.append(tft - admitted)
            report.prefill_hist.observe((tft - admitted) * 1e3)
            for j, (req, slot) in enumerate(items):
                a = _ActiveSlot(req=req, tokens=[], nll=0.0,
                                admitted=admitted, first_token=tft,
                                max_new=self._max_new(req))
                self._active[slot] = a
                self._emit(slot, a, logits_np[j], report)
        return len(assignments)

    # --------------------------------------------------------------- sampling
    def _pick(self, logits_row: np.ndarray,
              a: _ActiveSlot) -> Tuple[int, float]:
        """Next token: greedy argmax (first maximal id), or the request's
        forced token with its NLL."""
        if a.req.forced is not None:
            tok = int(a.req.forced[len(a.tokens)])
            return tok, float(-_log_softmax_np(logits_row)[tok])
        return int(np.argmax(logits_row)), 0.0

    def _emit(self, slot: int, a: _ActiveSlot, logits_row: np.ndarray,
              report: ServingReport) -> None:
        tok, nll = self._pick(logits_row, a)
        a.tokens.append(tok)
        a.nll += nll
        self._last_tok[slot, 0] = tok
        if len(a.tokens) >= a.max_new or self.pool.slot_full(slot):
            self._finish(slot, report)

    # ----------------------------------------------------------------- decode
    def _decode_once(self, report: ServingReport) -> None:
        t_start = time.perf_counter()
        active = [s for s, a in enumerate(self._active) if a is not None]
        active_mask = torch.as_tensor(
            [a is not None for a in self._active], dtype=torch.float32,
            device=self.device)
        self.pool.prepare_decode(active)
        logits, _ = model_lib.decode_step(
            self.cfg, self.params, self.pool.cache,
            torch.as_tensor(self._last_tok, device=self.device),
            self.pool.positions(), trainable=self._decode_trainable,
            k=self._moe_k,
            slot_mask=active_mask if self.cfg.moe.enabled else None,
            block_table=self.pool.tables(), page_span=self.pool.attn_len,
            dispatch=self.dispatch)
        logits_np = logits[:, 0].float().cpu().numpy()   # waits for the step
        dt = time.perf_counter() - t_start
        report.decode_step_s.append(dt)
        report.decode_hist.observe(dt * 1e3)
        self.pool.advance(active)
        for slot in active:
            self._emit(slot, self._active[slot], logits_np[slot], report)

    def _finish(self, slot: int, report: ServingReport) -> None:
        a = self._active[slot]
        report.completions.append(Completion(
            rid=a.req.rid, prompt_len=a.req.prompt_len,
            tokens=np.asarray(a.tokens, np.int32),
            k=self.slot_k[slot] or 0, arrival=a.req.arrival,
            admitted=a.admitted, first_token=a.first_token,
            finished=self._now(), nll_sum=a.nll,
            truncated=len(a.tokens) < a.max_new))
        self._active[slot] = None
        self._tier_reserved[self.slot_k[slot]] -= self.pool.reserved_for(slot)
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
        pending = sorted(requests, key=lambda r: r.arrival)
        report = ServingReport(completions=[], num_slots=self.num_slots,
                               slot_k=self.slot_k)
        self._t0 = time.perf_counter()
        steps = 0
        while pending or len(self.scheduler) or self.n_active:
            now = self._now()
            while pending and pending[0].arrival <= now:
                self.scheduler.add(pending.pop(0))
            admitted = self._admit_pass(report)
            if self.n_active:
                self._decode_once(report)
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    break
            elif not admitted:
                if pending:                  # idle until the next arrival
                    time.sleep(max(0.0, min(pending[0].arrival - self._now(),
                                            0.01)))
                elif len(self.scheduler):
                    stuck = [r.rid for r in self.scheduler.queue]
                    raise RuntimeError(
                        f"requests {stuck} match no slot tier "
                        f"(slot_k={self.slot_k})")
        report.wall_s = self._now()
        report.completions.sort(key=lambda c: c.rid)
        return report
