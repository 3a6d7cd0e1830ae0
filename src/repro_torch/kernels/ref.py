"""Plain PyTorch versions of every kernel (the port of ``repro/kernels/ref.py``).

Deliberately naive, as the reference's oracles are: the full score matrix
is materialised, top-k is an iterative argmax.  All math runs in float32
and the result is cast once.  These run for CPU tensors (the tests) and
are what ``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

_F32 = torch.float32


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B,H,S,D); k,v: (B,KV,S,D) -> (B,H,S,D).  fp32 softmax.  With
    ``softcap > 0`` the scaled scores are capped, ``s = softcap·tanh(s /
    softcap)``, before the masks (the reference's blockwise path,
    ``models/attention.py`` ``flash_attention_jnp``)."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kr = k.repeat_interleave(rep, dim=1).to(_F32)
    vr = v.repeat_interleave(rep, dim=1).to(_F32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(_F32), kr) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        valid = kpos <= qpos
        if window > 0:
            valid &= kpos > qpos - window
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def lora_matmul_ref(x, w, a, b, scale: float) -> torch.Tensor:
    """x: (M,K); w: (K,N); a: (K,r); b: (r,N) -> x@w + (x@a)@b·scale."""
    xf = x.to(_F32)
    y = xf @ w.to(_F32)
    y = y + (xf @ a.to(_F32)) @ b.to(_F32) * scale
    return y.to(x.dtype)


def lora_matmul_experts_ref(x, w, a, b, scale: float) -> torch.Tensor:
    """Stacked per-expert version: x (E,C,K); w (E,K,N); a (E,K,r);
    b (E,r,N) -> (E,C,N).  All math in fp32, one cast at the end."""
    xf, wf, af, bf = (t.to(_F32) for t in (x, w, a, b))
    y = torch.einsum("eck,ekn->ecn", xf, wf)
    xa = torch.einsum("eck,ekr->ecr", xf, af)
    y = y + torch.einsum("ecr,ern->ecn", xa, bf) * scale
    return y.to(x.dtype)


def topk_router_ref(logits: torch.Tensor, k: int):
    """logits: (T,E) -> (weights (T,E) fp32, mask (T,E) fp32, counts (E,)).

    Softmax -> iterative argmax top-k (``torch.argmax`` returns the first
    maximal index, the reference's tie rule) -> renormalised weights.
    """
    probs = torch.softmax(logits.to(_F32), dim=-1)
    E = probs.shape[-1]
    masked = probs
    mask = torch.zeros_like(probs)
    for _ in range(k):
        onehot = torch.nn.functional.one_hot(
            masked.argmax(dim=-1), E).to(_F32)
        mask = mask + onehot
        masked = masked * (1.0 - onehot)
    weights = probs * mask
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, mask, mask.sum(dim=0)


def ragged_gather_ref(x: torch.Tensor, src: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """x (T, D); src, valid (N,) int32 -> (N, D) with
    ``out[i] = x[src[i]] * valid[i]`` (padding rows land zero)."""
    return x[src.long()] * valid.to(x.dtype)[:, None]


def ragged_expert_matmul_ref(xs: torch.Tensor, block_expert: torch.Tensor,
                             w: torch.Tensor, a: torch.Tensor = None,
                             b: torch.Tensor = None,
                             scale: float = 0.0) -> torch.Tensor:
    """Grouped (segment) LoRA matmul over the ragged buffer: xs (N, K);
    block_expert (N // bm,) int32; w (E, K, H); optional LoRA factors
    a (E, K, r), b (E, r, H).  Row block ``i`` multiplies expert
    ``block_expert[i]``'s weights — a per-block weight gather plus a
    batched product.  fp32 accumulate, one cast."""
    N, K = xs.shape
    nb = block_expert.shape[0]
    be = block_expert.long()
    xb = xs.reshape(nb, N // nb, K).to(_F32)
    y = torch.bmm(xb, w[be].to(_F32))
    if a is not None:
        xa = torch.bmm(xb, a[be].to(_F32))
        y = y + torch.bmm(xa, b[be].to(_F32)) * scale
    return y.reshape(N, -1).to(xs.dtype)


def ragged_combine_ref(eo: torch.Tensor, rows: torch.Tensor,
                       wrank: torch.Tensor) -> torch.Tensor:
    """eo (N, D); rows (T, max_k) int32; wrank (T, max_k) -> (T, D),
    ``out[t] = sum_j wrank[t,j] * eo[rows[t,j]]`` (ranks past the token's
    budget carry weight 0 and point at row 0)."""
    g = eo[rows.long()].to(_F32)                      # (T, max_k, D)
    out = (g * wrank[..., None].to(_F32)).sum(dim=1)
    return out.to(eo.dtype)


def adaptive_topk_router_ref(logits: torch.Tensor, k_tok: torch.Tensor,
                             max_k: int):
    """Per-token-budget routing: token ``t`` activates its top ``k_tok[t]``
    experts (FLAME's adaptive k at serving time, per slot of a mixed
    batch); budget 0 deselects the token entirely.  Same layout as
    :func:`topk_router_ref`; uniform ``k_tok == k`` reproduces it exactly
    because top-k selection is nested."""
    probs = torch.softmax(logits.to(_F32), dim=-1)
    E = probs.shape[-1]
    masked = probs
    mask = torch.zeros_like(probs)
    take = k_tok.to(torch.int64)[:, None]
    for rank in range(max_k):
        onehot = torch.nn.functional.one_hot(
            masked.argmax(dim=-1), E).to(_F32)
        mask = mask + onehot * (rank < take)
        masked = masked * (1.0 - onehot)
    weights = probs * mask
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, mask, mask.sum(dim=0)
