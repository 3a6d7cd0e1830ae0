"""Sparse Mixture-of-Experts FFN with adaptive top-k (port of
``repro/models/moe_layer.py``).

1. router logits; static-k routing through the router kernel, or per-slot
   budgets (a ``k`` tuple and/or ``slot_mask``, every decode step) through
   the same kernel's per-token-budget entry (``adaptive_router``; the
   reference runs ``adaptive_topk_router_ref`` as plain ops, which XLA
   fuses under ``jit`` and eager PyTorch would launch one by one);
2. token dispatch, one of three modes:

   * ``"capacity"`` (the default, the training mode) — GShard one-hot
     dispatch with ``C = max(8, round8(int(assignments·cf/E) + 1))``;
     tokens past an expert's capacity (in token order) fall back to the
     residual stream.  The expert SwiGLU runs the ``lora_matmul_experts``
     kernel when the experts carry adapters;
   * ``"dense"`` — the same one-hot dispatch with C = a routing group's
     token count (rounded up to 8): loss-free, worst-case padding;
   * ``"ragged"`` (serving) — the counting-sort plan, then gather ->
     grouped expert SwiGLU -> combine through the three ragged kernels,
     the expert adapters inside the grouped matmul;
3. the FLAME rescaler s_i (scalar, or one value per batch row);
4. shared experts through :func:`apply_ffn`;
5. ``MoEAux`` activation counts for the activation-aware aggregation.

Routing is global; the one-hot modes dispatch over ``num_groups`` equal
routing groups of the batch (GShard groups, each with its own capacity:
the serving engine's dense prefill runs one group per row, so the one-hot
tensors grow with the bucket and not with its square).

On the card mesh (``shard``, ``models/parallel.py``) the one-hot modes
run the schedule the reference's ``_moe_shard_fns`` describe: the router
is replicated and runs on every rank; each rank's routing groups are
whole groups of the global batch (G a multiple of the batch ways, else
the tokens are gathered over the batch axes and every rank routes them
all); the (G, Tg, E, C) one-hots are built with the full E; each rank
takes its E/M experts' slice of the slot tensor and of the combine
one-hot, runs its experts, and the (G, Tg, D) output is all-reduced over
``model``.  No expert all-to-all.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import backend as kernel_backend
from ..kernels.ragged_dispatch import ragged_plan
from . import parallel
from .layers import (apply_ffn, expert_adapter, expert_weight,
                     lora_expert_einsum)

_F32 = torch.float32


class MoEAux(NamedTuple):
    activation_counts: torch.Tensor   # (E,) float — tokens routed to expert j
    total_tokens: torch.Tensor        # () float
    load_balance_loss: torch.Tensor   # () float — Switch aux loss


def _capacity_from_assignments(n_assign: float, num_experts: int,
                               factor: float) -> int:
    """Expert-queue capacity for ``n_assign`` total (token, expert)
    assignments, rounded up to a multiple of 8 (the reference's rule)."""
    c = int(n_assign * factor / num_experts) + 1
    return max(8, ((c + 7) // 8) * 8)


def _capacity(tokens: int, num_experts: int, k: int, factor: float) -> int:
    return _capacity_from_assignments(tokens * k, num_experts, factor)


def dense_capacity(tokens: int) -> int:
    """Per-expert capacity of the dense no-drop mode: one expert receives
    at most one copy of each token, so C = the token count (rounded up)."""
    return max(8, ((tokens + 7) // 8) * 8)


DISPATCH_MODES = ("capacity", "dense", "ragged")


def resolve_dispatch(dispatch, no_drop: bool) -> str:
    """An explicit ``dispatch`` wins; otherwise the legacy ``no_drop``
    flag selects dense (True) or GShard capacity (False)."""
    if dispatch is None:
        return "dense" if no_drop else "capacity"
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch {dispatch!r}; one of "
                         f"{DISPATCH_MODES}")
    return dispatch


def _one_hot_expert_ffn(p: dict, cfg, xg: torch.Tensor, weights, mask, *,
                        dispatch: str, k: Optional[int],
                        n_assign: Optional[int], lora: dict,
                        lora_scale: float, shard=None) -> torch.Tensor:
    """GShard one-hot dispatch + expert SwiGLU + combine.  ``xg``: (G, Tg,
    D) grouped tokens; ``weights``/``mask``: (G, Tg, E).  A token's place
    in an expert's queue is its rank in token order among its group's
    tokens routed there; places past C are dropped.  The G groups' slots
    meet in one (E, G·C, D) expert product.  On the mesh (``shard``) this
    rank's experts' slice of the one-hots, its experts, and the output
    all-reduced over ``model``."""
    m = cfg.moe
    G, Tg, D = xg.shape
    E = m.num_experts
    if dispatch == "dense":
        C = dense_capacity(Tg)
    elif n_assign is not None:
        C = _capacity_from_assignments(n_assign, E, m.capacity_factor)
    else:
        C = _capacity(Tg, E, k, m.capacity_factor)
    pos = (torch.cumsum(mask, dim=1) - 1.0) * mask                # (G,Tg,E)
    keep = (pos < C) & (mask > 0)
    # the one-hot in the compute dtype: F.one_hot would be int64 (344 MB
    # at OLMoE FULL, T=2048, E=64, C=328); the comparison is a bool
    slot = torch.arange(C, device=xg.device, dtype=pos.dtype)
    dispatch_oh = ((pos[..., None] == slot) & keep[..., None]).to(xg.dtype)
    combine = dispatch_oh * weights[..., None].to(xg.dtype)    # (G,Tg,E,C)

    ex = p["experts"]
    w = {key: ex[key] for key in ("w1", "w3", "w2")}
    lp = {key: lora.get(key) for key in w}
    if shard is not None:
        d_exp = m.d_expert
        for key, d_in in (("w1", D), ("w3", D), ("w2", d_exp)):
            w[key] = expert_weight(w[key], d_in, shard)
            lp[key] = expert_adapter(lp[key], d_in, shard)
        El = w["w1"].shape[0]
        if El != E:
            e0 = shard.mi * El
            dispatch_oh = dispatch_oh.narrow(2, e0, El)
            combine = combine.narrow(2, e0, El)
            E = El
    slots = torch.einsum("gtec,gtd->egcd", dispatch_oh, xg).reshape(
        E, G * C, D)
    gate = lora_expert_einsum(slots, w["w1"], lp["w1"], lora_scale)
    up = lora_expert_einsum(slots, w["w3"], lp["w3"], lora_scale)
    h = F.silu(gate.to(_F32)).to(up.dtype) * up
    eo = lora_expert_einsum(h, w["w2"], lp["w2"], lora_scale)
    out = torch.einsum("gtec,egcd->gtd", combine,
                       eo.reshape(E, G, C, D))                    # (G,Tg,D)
    if shard is not None:
        out = parallel.reduce_from(out, shard.model)
    return out


def _ragged_expert_ffn(p: dict, x2d: torch.Tensor, weights, mask, *,
                       budget: int, max_k: int, lora: dict,
                       lora_scale: float) -> torch.Tensor:
    """Counting-sort plan, gather, grouped expert SwiGLU (each expert's
    adapter ``{a, b}`` rides in the grouped matmul), combine."""
    plan = ragged_plan(mask, weights, budget=budget, max_k=max_k)
    xs = kernel_backend.ragged_gather(x2d, plan.src, plan.valid)
    ex = p["experts"]

    def mm(inp, key):
        lp = lora.get(key)
        return kernel_backend.ragged_expert_matmul(
            inp, plan.block_expert, ex[key],
            None if lp is None else lp["a"], None if lp is None else lp["b"],
            scale=lora_scale)

    gate = mm(xs, "w1")
    up = mm(xs, "w3")
    h = F.silu(gate.to(_F32)).to(up.dtype) * up
    eo = mm(h, "w2")
    return kernel_backend.ragged_combine(eo, plan.rows, plan.wrank)


def apply_moe(p: dict, cfg, x: torch.Tensor, *, k,
              rescaler: Optional[torch.Tensor] = None,
              lora: Optional[dict] = None, lora_scale: float = 0.0,
              slot_mask: Optional[torch.Tensor] = None,
              dispatch: Optional[str] = None, num_groups: int = 1,
              shard=None):
    """x: (B, S, D) -> (out (B, S, D), MoEAux).

    ``k``: an int for every token, or a length-B tuple of per-row budgets
    (a uniform tuple without ``slot_mask`` collapses to the int path, as in
    the reference).  ``slot_mask``: optional (B,) or (B, S) 0/1 — rows at
    0 route to zero experts.  ``rescaler``: scalar or (B,) s_i.
    ``dispatch``: ``"capacity"`` (default), ``"dense"`` or ``"ragged"``.
    ``lora``: the block's ``{"experts": {w1, w2, w3}, "shared": ...}``
    adapters.  ``num_groups``: the one-hot modes' routing groups (equal
    slices of the B·S tokens; per-row budgets under capacity need one).
    ``shard``: the card mesh (the module docstring); ``num_groups`` is
    then the global batch's, and the counts are this rank's tokens'."""
    dispatch = resolve_dispatch(dispatch, False)
    if shard is not None:
        return _apply_moe_sharded(p, cfg, x, k=k, rescaler=rescaler,
                                  lora=lora, lora_scale=lora_scale,
                                  slot_mask=slot_mask, dispatch=dispatch,
                                  num_groups=num_groups, sh=shard)
    le = (lora or {}).get("experts") or {}
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E = m.num_experts
    G = num_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    x2d = x.reshape(T, D)

    if isinstance(k, (tuple, list)):
        if len(k) != B:
            raise ValueError(f"per-row k has {len(k)} entries for {B} rows")
        if len(set(k)) == 1 and slot_mask is None:
            k = int(k[0])                 # uniform budgets: static-int path
    adaptive = isinstance(k, (tuple, list)) or slot_mask is not None
    if G > 1 and (dispatch == "ragged" or (adaptive
                                           and dispatch == "capacity")):
        # ragged routes globally; per-row budgets would need per-group
        # capacities (the dense capacity does not depend on them)
        raise ValueError(f"num_groups={G} with {dispatch} dispatch"
                         + (" and per-row k" if adaptive else ""))
    if adaptive:
        k_slots = (tuple(int(v) for v in k)
                   if isinstance(k, (tuple, list)) else (int(k),) * B)
        max_k = max(k_slots)

    logits = x2d @ p["router"]                                    # (T, E)
    if adaptive:
        # non_blocking: a blocking host-to-device copy would wait for the
        # whole queued step, once per layer
        k_tok = torch.tensor(k_slots, dtype=torch.int32).to(
            x.device, non_blocking=True).repeat_interleave(S)
        if slot_mask is not None:
            per_tok = (slot_mask.reshape(T) if slot_mask.dim() == 2
                       else slot_mask.repeat_interleave(S))
            k_tok = k_tok * per_tok.to(torch.int32)
        weights, mask, counts = kernel_backend.adaptive_router(logits, k_tok,
                                                               max_k)
        budget = S * sum(k_slots)
    else:
        weights, mask, counts = kernel_backend.router(logits, k)
        budget, max_k = T * k, k
    probs = torch.softmax(logits.to(_F32), dim=-1)
    lb = E * (probs.mean(0) * mask.mean(0)).mean() * E

    if dispatch == "ragged":
        out = _ragged_expert_ffn(p, x2d, weights, mask, budget=budget,
                                 max_k=max_k, lora=le, lora_scale=lora_scale)
    else:
        out = _one_hot_expert_ffn(
            p, cfg, x2d.reshape(G, T // G, D), weights.reshape(G, T // G, E),
            mask.reshape(G, T // G, E), dispatch=dispatch,
            k=None if adaptive else k,
            n_assign=budget if adaptive else None, lora=le,
            lora_scale=lora_scale).reshape(T, D)

    if rescaler is not None:
        r = rescaler.to(out.dtype)
        if r.dim() == 1 and r.shape[0] == B:
            r = r.repeat_interleave(S)[:, None]   # per-slot s_i, row b's tokens
        out = out * r

    if "shared" in p:
        out = out + apply_ffn(p["shared"], x2d, (lora or {}).get("shared"),
                              lora_scale)

    aux = MoEAux(activation_counts=counts,
                 total_tokens=torch.full((), float(T), device=x.device),
                 load_balance_loss=lb)
    return out.reshape(B, S, D), aux


def _apply_moe_sharded(p: dict, cfg, x: torch.Tensor, *, k, rescaler, lora,
                       lora_scale, slot_mask, dispatch, num_groups, sh):
    """:func:`apply_moe` on the mesh (the module docstring's schedule),
    one-hot dispatch with a static k."""
    if dispatch == "ragged" or isinstance(k, (tuple, list)) \
            or slot_mask is not None:
        raise NotImplementedError("the mesh routes with a static k on the "
                                  "one-hot dispatch modes; ragged dispatch "
                                  "and per-row budgets stay single-card")
    le = (lora or {}).get("experts") or {}
    m = cfg.moe
    B, S, D = x.shape
    E = m.num_experts
    G = num_groups
    gathered = sh.B > 1 and G % sh.B != 0
    if gathered:
        # the groups span ranks: every rank routes the global batch
        xr = parallel.gather(x, sh.batch, 0)
    else:
        xr = x
        G //= sh.B
    Bg = xr.shape[0]
    T = Bg * S
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    x2d = xr.reshape(T, D)
    xc = parallel.copy_to(x2d, sh.model)
    logits = xc @ p["router"]                                     # (T, E)
    weights, mask, counts = kernel_backend.router(logits, k)
    probs = torch.softmax(logits.to(_F32), dim=-1)
    lb = E * (probs.mean(0) * mask.mean(0)).mean() * E
    out = _one_hot_expert_ffn(
        p, cfg, xc.reshape(G, T // G, D), weights.reshape(G, T // G, E),
        mask.reshape(G, T // G, E), dispatch=dispatch, k=k, n_assign=None,
        lora=le, lora_scale=lora_scale, shard=sh).reshape(T, D)
    if rescaler is not None:
        out = out * rescaler.to(out.dtype)
    if "shared" in p:
        out = out + apply_ffn(p["shared"], x2d, (lora or {}).get("shared"),
                              lora_scale, shard=sh)
    if gathered:
        rows = slice(sh.bi * B * S, (sh.bi + 1) * B * S)
        out = out[rows]
        counts = mask[rows].sum(0).to(counts.dtype)
    aux = MoEAux(activation_counts=counts,
                 total_tokens=torch.full((), float(B * S), device=x.device),
                 load_balance_loss=lb)
    return out.reshape(B, S, D), aux
