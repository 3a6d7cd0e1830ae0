"""Self-speculative decoding: the adaptive-k model drafts for itself (port
of ``repro/serving/speculative.py``).

FLAME's global expert weights serve any activation budget, so the model is
its own draft model: each round drafts a window of W tokens per slot at
``draft_k`` (default 1, the cheapest budget), verifies the whole window in
one full-k multi-token decode step (``model.decode_step`` with S = W + 1)
and accepts a prefix by the standard rejection rule: accept draft ``d_i``
with probability ``min(1, p_i[d_i] / q_i[d_i])`` (q the draft's, p the
target's distribution under the engine's sampler), resample the first
rejected position from ``norm(max(p_i - q_i, 0))``, and emit a bonus token
from ``p_W`` when every draft survives.  The output equals plain full-k
decoding in distribution, and token for token under greedy.

KV correctness: the draft never writes the cache (its K/V live in a
per-round window buffer, ``model.draft_window``), the verify step reads
the cache before depositing full-k K/V at the window's positions, and each
row is then rolled back to its first rejected position
(``pool.truncate_to``), so the cache after a round is what a straight
decode of the accepted prefix would have left.

The reference's round is three device launches (a jitted ``lax.scan``
over the window, the verify step, the vmapped rule); eager PyTorch
launches every op of W draft steps.  What stays the reference's: the
draft picks its tokens on the device, the window's tokens reach the host
in one copy at its end (the draft logits stay on the device for the
rule), the rule runs over all slots in one vectorised pass, and its
result comes back in one copy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..models import model as model_lib
from .sampler import (SamplerConfig, event_uniforms, sample_from_probs,
                      sampler_probs)


@dataclass(frozen=True)
class SpeculativeConfig:
    """``window``: drafts per round (W); ``draft_k``: the draft budget."""
    window: int = 4
    draft_k: int = 1

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"speculative window must be >= 1, "
                             f"got {self.window}")
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")


def verify_window(draft_tokens: torch.Tensor, draft_logits: torch.Tensor,
                  target_logits: torch.Tensor, sc: SamplerConfig,
                  u: torch.Tensor, u_last: torch.Tensor):
    """The rejection rule for every slot's window in one pass.

    ``draft_tokens``: (B, W); ``draft_logits``: (B, W, V), the logits each
    draft was picked from; ``target_logits``: (B, W+1, V), the full-k
    logits at every window position (the last conditions on all W drafts
    and feeds the bonus token); ``u``: (B, W) the accept uniforms;
    ``u_last``: (B,) the resample / bonus uniform.  Returns ``(tokens
    (B, W+1), n_emitted (B,), n_accepted (B,))``: the first ``n_emitted =
    n_accepted + 1`` entries of a row are its output.  Under greedy the
    distributions are one-hot and the outcome does not depend on ``u``."""
    B, W = draft_tokens.shape
    q = sampler_probs(draft_logits, sc)                        # (B, W, V)
    p = sampler_probs(target_logits, sc)                       # (B, W+1, V)
    d = draft_tokens.long()[..., None]
    p_d = p[:, :W].gather(-1, d)[..., 0]
    q_d = q.gather(-1, d)[..., 0]
    # u < min(1, p/q)  <=>  u·q < p  (q == 0 accepts iff p > 0)
    accept = u.to(p_d.device, p_d.dtype) * q_d < p_d
    n_acc = torch.cumprod(accept.long(), dim=-1).sum(-1)      # (B,)
    rows = torch.arange(B, device=p.device)
    ridx = torch.clamp(n_acc, max=W - 1)
    resid = torch.clamp(p[rows, ridx] - q[rows, ridx], min=0.0)
    rs = resid.sum(-1, keepdim=True)
    # the p fallback keeps the rule total where p <= q everywhere, which a
    # real rejection cannot reach
    resid = torch.where(rs > 0, resid / rs, p[rows, ridx])
    last_probs = torch.where((n_acc == W)[:, None], p[:, W], resid)
    last = sample_from_probs(last_probs, u_last)
    out = torch.cat([draft_tokens.long(),
                     torch.zeros_like(draft_tokens[:, :1]).long()], dim=1)
    out[rows, n_acc] = last
    return out, n_acc + 1, n_acc


class SpeculativeDecoder:
    """The draft / verify loop bound to one ``ServingEngine``; the engine
    calls :meth:`round` wherever it would call ``_decode_once``."""

    def __init__(self, engine, spec: SpeculativeConfig):
        cfg = engine.cfg
        if not cfg.moe.enabled:
            raise ValueError(
                "self-speculation drafts the same weights at a reduced "
                "expert budget; a non-MoE model has no cheaper draft")
        if not spec.draft_k <= cfg.moe.num_experts:
            raise ValueError(f"draft_k={spec.draft_k} > "
                             f"{cfg.moe.num_experts} experts")
        if any(cfg.layer_kind(p) != "attn"
               for p in range(cfg.pattern_period)):
            raise ValueError(
                "speculative decoding requires attention-only models: "
                "SSM state is cumulative and cannot roll back to a "
                "rejected position")
        if 0 < cfg.attention_window < engine.slot_len:
            raise ValueError(
                "speculative rollback requires a non-wrapping KV cache: "
                f"attention_window={cfg.attention_window} < slot_len="
                f"{engine.slot_len} would alias window positions")
        self.eng = engine
        self.window = spec.window
        self.draft_k = spec.draft_k
        # slot -> window base (its last verified cache_pos) while the
        # slot's window is open; a preemption mid-window rolls back to it
        # (rollback_open), so a swap never carries draft positions
        self._open: Dict[int, int] = {}
        self._draft_trainable = engine._build_draft_trainable(spec.draft_k)
        sc = engine._sampler
        if sc.kind == "greedy":
            self._sample_fn = lambda logits, u: torch.argmax(logits, dim=-1)
        else:
            self._sample_fn = lambda logits, u: sample_from_probs(
                sampler_probs(logits, sc), u)

    def _draws(self, active: List[int], n_events: int,
               per_event: int) -> torch.Tensor:
        """(B, n_events · per_event) uniforms on the device: each active
        slot's next ``n_events`` events, ``per_event`` draws each, its
        event counter advanced.  Greedy draws nothing (zeros)."""
        eng = self.eng
        u = np.zeros((eng.num_slots, n_events * per_event))
        if eng._sampler.kind != "greedy":
            for s in active:
                a = eng._active[s]
                u[s] = np.concatenate([
                    event_uniforms(eng._seed, a.req.rid, a.events + e,
                                   per_event) for e in range(n_events)])
                a.events += n_events
        return torch.as_tensor(u).to(eng.device, non_blocking=True)

    def _round_window(self, active: List[int]) -> int:
        """Largest safe W this round: every active slot needs room for the
        verify step's top position (``pos + W <= attn_len - 1``) and for
        ``W + 1`` emitted tokens within its budget."""
        eng = self.eng
        W = self.window
        for s in active:
            a = eng._active[s]
            W = min(W, eng.pool.attn_len - 1 - int(eng.pool.cache_pos[s]),
                    a.max_new - len(a.tokens) - 1)
        return W

    def round(self, report) -> None:
        """One draft / verify round over every active slot; a plain decode
        step when no window fits."""
        eng = self.eng
        pool, dev = eng.pool, eng.device
        active = [s for s, a in enumerate(eng._active) if a is not None]
        W = self._round_window(active)
        if W < 1:
            eng._decode_once(report)
            return
        pos0 = pool.cache_pos.copy()
        first = eng._last_tok.copy()                               # (B, 1)
        for s in active:
            self._open[s] = int(pos0[s])
        pos0_d = torch.as_tensor(pos0, dtype=torch.int64).to(
            dev, non_blocking=True)

        tr = eng._tracer
        # ---- draft: W read-only steps at draft_k, tokens picked on the
        # device, one host copy at the end ----
        with tr.span("draft", cat="engine") as sp:
            t0 = time.perf_counter()
            paged = {}
            if eng.paged:
                # the draft writes no page, but verify writes positions
                # pos0 .. pos0+W: their blocks come out of the reservation
                # now
                for _ in range(W):
                    pool.prepare_decode(active)
                    pool.advance(active)
                paged = dict(block_table=pool.tables(),
                             page_span=pool.attn_len)
            else:
                for _ in range(W):
                    pool.advance(active)
            qs, toks = model_lib.draft_window(
                eng.cfg, eng.params, pool.cache,
                torch.as_tensor(first).to(dev, non_blocking=True), pos0_d,
                self._draws(active, W, 1).T, sample_fn=self._sample_fn,
                window=W, trainable=self._draft_trainable, k=self.draft_k,
                dispatch=eng.dispatch, **paged)
            d_toks = toks.T.cpu().numpy()                          # (B, W)
            dt = time.perf_counter() - t0
            report.draft_step_s.append(dt)
            report.draft_hist.observe(dt * 1e3)
            sp.note(window=W, active=len(active))

        # ---- verify + reject: one full-k step over the W+1 window tokens,
        # the rule over all slots, one host copy ----
        with tr.span("verify", cat="engine") as sp:
            t0 = time.perf_counter()
            if eng.paged:
                pool.prepare_decode(active)                        # pos0 + W
                paged = dict(block_table=pool.tables(),
                             page_span=pool.attn_len)
            active_mask = torch.as_tensor(
                [a is not None for a in eng._active],
                dtype=torch.float32).to(dev, non_blocking=True)
            verify_in = torch.as_tensor(np.concatenate([first, d_toks],
                                                       axis=1))
            lv, _ = model_lib.decode_step(
                eng.cfg, eng.params, pool.cache,
                verify_in.to(dev, non_blocking=True), pos0_d,
                trainable=eng._decode_trainable, k=eng._moe_k,
                slot_mask=active_mask, dispatch=eng.dispatch, **paged)
            u = self._draws(active, 1, W + 1)
            out, n_emit, n_acc = verify_window(
                toks.T, qs.transpose(0, 1), lv.float(), eng._sampler,
                u[:, :W], u[:, W])
            host = torch.cat([out, n_emit[:, None], n_acc[:, None]],
                             dim=1).cpu().numpy()
            out_toks, n_emit, n_acc = host[:, :-2], host[:, -2], host[:, -1]
            dt = time.perf_counter() - t0
            report.verify_step_s.append(dt)
            report.verify_hist.observe(dt * 1e3)
            sp.note(window=W)

        for s in active:
            a = eng._active[s]
            acc = int(n_acc[s])
            emitted = [int(t) for t in out_toks[s, :int(n_emit[s])]]
            a.tokens.extend(emitted)
            eng._last_tok[s, 0] = emitted[-1]
            report.spec_drafted += W
            report.spec_accepted += acc
            self._open.pop(s, None)
            if acc == W:
                # position pos0+W holds the accepted last draft's K/V: keep
                # it (the bonus token's K/V come with the next step)
                pool.advance([s])
            else:
                pool.truncate_to(s, int(pos0[s]) + acc + 1)
            if len(a.tokens) >= a.max_new or pool.slot_full(s):
                eng._finish(s, report)
        report.spec_rounds += 1

    def rollback_open(self, slot: int) -> None:
        """Preemption safety: a slot swapped out while its window is open
        is first rolled back to the window base, so ``swap_out`` captures
        only the verified prefix.  A no-op in the engine loop, where a
        round resolves every window it opens before admission runs."""
        base = self._open.pop(slot, None)
        if base is not None:
            self.eng.pool.truncate_to(slot, base)
