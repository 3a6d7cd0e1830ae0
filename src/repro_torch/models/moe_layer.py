"""Sparse Mixture-of-Experts FFN with adaptive top-k, ragged dispatch
(port of ``repro/models/moe_layer.py``, ``dispatch="ragged"``).

1. router logits; static-k routing through the router kernel, or per-slot
   budgets (a ``k`` tuple and/or ``slot_mask``) through the plain
   :func:`adaptive_topk_router_ref` — per-token budgets have no fused
   kernel in the reference either;
2. the counting-sort ragged plan, then gather -> grouped expert SwiGLU ->
   combine through the three ragged kernels;
3. the FLAME rescaler s_i (scalar, or one value per batch row);
4. shared experts through :func:`apply_ffn`;
5. ``MoEAux`` activation counts for the activation-aware aggregation.

The ``capacity`` and ``dense`` one-hot dispatch modes belong to the
training slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import backend as kernel_backend
from ..kernels.ragged_dispatch import ragged_plan
from ..kernels.ref import adaptive_topk_router_ref
from .layers import apply_ffn

_F32 = torch.float32


class MoEAux(NamedTuple):
    activation_counts: torch.Tensor   # (E,) float — tokens routed to expert j
    total_tokens: torch.Tensor        # () float
    load_balance_loss: torch.Tensor   # () float — Switch aux loss


def _ragged_expert_ffn(p: dict, x2d: torch.Tensor, weights, mask, *,
                       budget: int, max_k: int) -> torch.Tensor:
    plan = ragged_plan(mask, weights, budget=budget, max_k=max_k)
    xs = kernel_backend.ragged_gather(x2d, plan.src, plan.valid)
    ex = p["experts"]

    def mm(inp, key):
        return kernel_backend.ragged_expert_matmul(inp, plan.block_expert,
                                                   ex[key])

    gate = mm(xs, "w1")
    up = mm(xs, "w3")
    h = F.silu(gate.to(_F32)).to(up.dtype) * up
    eo = mm(h, "w2")
    return kernel_backend.ragged_combine(eo, plan.rows, plan.wrank)


def apply_moe(p: dict, cfg, x: torch.Tensor, *, k,
              rescaler: Optional[torch.Tensor] = None,
              lora: Optional[dict] = None, lora_scale: float = 0.0,
              slot_mask: Optional[torch.Tensor] = None,
              dispatch: str = "ragged"):
    """x: (B, S, D) -> (out (B, S, D), MoEAux).

    ``k``: an int for every token, or a length-B tuple of per-row budgets
    (a uniform tuple without ``slot_mask`` collapses to the int path, as in
    the reference).  ``slot_mask``: optional (B,) or (B, S) 0/1 — rows at
    0 route to zero experts.  ``rescaler``: scalar or (B,) s_i."""
    if dispatch != "ragged":
        raise NotImplementedError(
            f"dispatch={dispatch!r} (one-hot capacity/dense dispatch) comes "
            "with the training slice of the port")
    if lora and lora.get("experts"):
        raise NotImplementedError(
            "expert LoRA adapters at serving time come with the "
            "serving-extras slice of the port")
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E = m.num_experts
    x2d = x.reshape(T, D)

    if isinstance(k, (tuple, list)):
        if len(k) != B:
            raise ValueError(f"per-row k has {len(k)} entries for {B} rows")
        if len(set(k)) == 1 and slot_mask is None:
            k = int(k[0])                 # uniform budgets: static-int path
    adaptive = isinstance(k, (tuple, list)) or slot_mask is not None
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
        weights, mask, counts = adaptive_topk_router_ref(logits, k_tok, max_k)
        budget = S * sum(k_slots)
    else:
        weights, mask, counts = kernel_backend.router(logits, k)
        budget, max_k = T * k, k
    probs = torch.softmax(logits.to(_F32), dim=-1)
    lb = E * (probs.mean(0) * mask.mean(0)).mean() * E

    out = _ragged_expert_ffn(p, x2d, weights, mask, budget=budget,
                             max_k=max_k)

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
