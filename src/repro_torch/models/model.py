"""Decoder model: the serving path of ``repro/models/model.py``.

The parameter tree keeps the reference's layout — ``{"embed": {"tokens"},
"blocks": {"pos0": <leaves stacked over n_periods>, ...}, "final_norm",
"lm_head"}`` — so a JAX tree converts leaf for leaf.  The reference scans
over the leading ``n_periods`` axis; here the stack is a Python loop over
it, each period reading views of the stacked leaves.

Caches are dicts ``{"pos0": {"attn": {"k", "v"}}}`` with a leading
``n_periods`` axis.  The block-paged pool (:func:`init_paged_cache`) is
updated in place by :func:`decode_step`; the reference threads it through
the scan carry and returns a new one.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from . import attention as attn_mod
from . import moe_layer as moe_mod
from .layers import apply_ffn, dense_init, embed_init, rms_norm

PyTree = Any


# ==========================================================================
# init
# ==========================================================================

def _init_block(cfg, n: int, generator, device) -> dict:
    """One stacked block position (attention + MoE or dense FFN) with a
    leading ``n`` = n_periods axis; same distributions as the reference."""
    dt = cfg.torch_dtype
    d, hd = cfg.d_model, cfg.head_dim_

    def dense(shape, scale=1.0):
        return dense_init((n,) + shape, dt, generator, device, scale)

    def ones(dim):
        return torch.ones((n, dim), dtype=dt, device=device)

    p: dict = {"mixer_norm": ones(d)}
    attn = {"wq": dense((d, cfg.n_heads * hd)),
            "wk": dense((d, cfg.n_kv_heads * hd)),
            "wv": dense((d, cfg.n_kv_heads * hd)),
            "wo": dense((cfg.n_heads * hd, d))}
    if cfg.qk_norm:
        attn["q_norm"] = ones(hd)
        attn["k_norm"] = ones(hd)
    p["attn"] = attn
    m = cfg.moe
    if m.enabled:
        p["ffn_norm"] = ones(d)
        moe = {"router": dense((d, m.num_experts), scale=0.1),
               "experts": {"w1": dense((m.num_experts, d, m.d_expert)),
                           "w3": dense((m.num_experts, d, m.d_expert)),
                           "w2": dense((m.num_experts, m.d_expert, d))}}
        if m.num_shared_experts > 0:
            dsh = m.d_shared_expert or m.d_expert * m.num_shared_experts
            moe["shared"] = {"w1": dense((d, dsh)), "w3": dense((d, dsh)),
                             "w2": dense((dsh, d))}
        p["moe"] = moe
    elif cfg.d_ff > 0:
        p["ffn_norm"] = ones(d)
        p["ffn"] = {"w1": dense((d, cfg.d_ff)), "w3": dense((d, cfg.d_ff)),
                    "w2": dense((cfg.d_ff, d))}
    return p


def _check_supported(cfg) -> None:
    P = cfg.pattern_period
    if any(cfg.layer_kind(p) != "attn" for p in range(P)):
        raise NotImplementedError(
            f"{cfg.name}: SSM layers come with the SSM slice of the port")
    if cfg.num_codebooks:
        raise NotImplementedError(
            f"{cfg.name}: audio codebooks come with a later slice")
    if cfg.moe.enabled and P != 1:
        raise NotImplementedError(
            f"{cfg.name}: interleaved MoE layers come with a later slice")


def init_params(cfg, generator: torch.Generator,
                device="cuda") -> PyTree:
    """Random weights from ``generator`` with the reference's
    distributions: truncated normal ±3σ, σ = scale/sqrt(fan_in) (router
    scale 0.1), embeddings and head N(0, 0.02), norms one."""
    cfg.validate()
    _check_supported(cfg)
    n = cfg.num_layers // cfg.pattern_period
    dt = cfg.torch_dtype
    params = {
        "embed": {"tokens": embed_init((cfg.vocab_size, cfg.d_model), dt,
                                       generator, device)},
        "blocks": {"pos0": _init_block(cfg, n, generator, device)},
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init((cfg.d_model, cfg.vocab_size), dt,
                                       generator, device)
    return params


# ==========================================================================
# embedding / head
# ==========================================================================

def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tokens"][tokens.long()]


def lm_head(params, cfg, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"]["tokens"].T
    return h @ params["lm_head"]


# ==========================================================================
# the block stack
# ==========================================================================

def _index(tree, i: int):
    """Period ``i`` of a tree of stacked leaves (views, no copies)."""
    if isinstance(tree, dict):
        return {key: _index(val, i) for key, val in tree.items()}
    return tree[i]


def _apply_block(cfg, p: dict, x: torch.Tensor, positions, *, rescaler, k,
                 cache=None, cache_pos=None, return_cache=False,
                 slot_mask=None, block_table=None, page_span=None,
                 dispatch="ragged"):
    h = rms_norm(p["mixer_norm"], x, cfg.rms_eps)
    h, new_cache = attn_mod.apply_attention(
        p["attn"], cfg, h, positions, cache=cache, cache_pos=cache_pos,
        return_cache=return_cache, block_table=block_table,
        page_span=page_span)
    x = x + h
    aux = None
    if "moe" in p:
        h2 = rms_norm(p["ffn_norm"], x, cfg.rms_eps)
        h2, aux = moe_mod.apply_moe(p["moe"], cfg, h2, k=k,
                                    rescaler=rescaler, slot_mask=slot_mask,
                                    dispatch=dispatch)
        x = x + h2
    elif "ffn" in p:
        h2 = rms_norm(p["ffn_norm"], x, cfg.rms_eps)
        x = x + apply_ffn(p["ffn"], h2)
    return x, aux, new_cache


def _run_stack(cfg, params, x, positions, *, trainable, k, cache=None,
               cache_pos=None, return_cache=False, slot_mask=None,
               block_table=None, page_span=None, dispatch="ragged"):
    """The layer stack as a loop over the leading n_periods axis.
    Returns (h, counts {pos0: (n_periods, E)}, new K/V per period)."""
    _check_supported(cfg)
    trainable = trainable or {}
    if trainable.get("lora"):
        raise NotImplementedError(
            "LoRA-adapter serving comes with the serving-extras slice")
    rescalers = (trainable.get("rescaler") or {}).get("pos0")
    k = k if k is not None else cfg.moe.top_k
    n = cfg.num_layers // cfg.pattern_period
    blocks = params["blocks"]["pos0"]
    layer_cache = (cache or {}).get("pos0", {}).get("attn")
    counts, kv = [], []
    for i in range(n):
        h_cache = None if layer_cache is None else _index(layer_cache, i)
        x, aux, nc = _apply_block(
            cfg, _index(blocks, i), x, positions,
            rescaler=None if rescalers is None else rescalers[i],
            k=k, cache=h_cache, cache_pos=cache_pos,
            return_cache=return_cache, slot_mask=slot_mask,
            block_table=block_table, page_span=page_span, dispatch=dispatch)
        if aux is not None:
            counts.append(aux.activation_counts)
        kv.append(nc)
    out_counts = {"pos0": torch.stack(counts)} if counts else {}
    return x, out_counts, kv


# ==========================================================================
# serving entry points
# ==========================================================================

def cache_len_for(cfg, seq_len: int) -> int:
    if cfg.attention_window > 0:
        return min(cfg.attention_window, seq_len)
    return seq_len


def init_paged_cache(cfg, num_slots: int, num_blocks: int, block_size: int,
                     device="cuda") -> PyTree:
    """Zeroed block-paged decode cache (leading axis n_periods): K/V live
    in a pool of ``num_blocks + 1`` blocks, block 0 being the trash block
    unallocated table entries point at.  ``num_slots`` sizes per-row state
    (the SSM slice's; attention-only models keep none)."""
    del num_slots
    _check_supported(cfg)
    n = cfg.num_layers // cfg.pattern_period
    shape = (n, num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim_)
    z = dict(dtype=cfg.torch_dtype, device=device)
    return {"pos0": {"attn": {"k": torch.zeros(shape, **z),
                              "v": torch.zeros(shape, **z)}}}


def prefill(cfg, params, tokens: torch.Tensor, *, trainable=None, k=None,
            cache_len: Optional[int] = None, slot_mask=None,
            dispatch: str = "ragged"):
    """Forward pass that also returns the contiguous decode cache.
    Returns (logits_last (B,1,V), cache) with cache leaves
    (n_periods, B, cache_len_for(cache_len or S), KV, hd), zero-padded
    past the prompt."""
    B, S = tokens.shape[:2]
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(params, cfg, tokens)
    h, _, kv = _run_stack(cfg, params, x, positions, trainable=trainable,
                          k=k, return_cache=True, slot_mask=slot_mask,
                          dispatch=dispatch)
    target = cache_len_for(cfg, cache_len or S)
    cache = {}
    for leaf in ("k", "v"):
        stacked = torch.stack([c[leaf] for c in kv])   # (n, B, S, KV, hd)
        if target > S:
            pad = stacked.new_zeros(stacked.shape[:2] + (target - S,)
                                    + stacked.shape[3:])
            stacked = torch.cat([stacked, pad], dim=2)
        cache[leaf] = stacked
    h = rms_norm(params["final_norm"], h[:, -1:], cfg.rms_eps)
    return lm_head(params, cfg, h), {"pos0": {"attn": cache}}


def decode_step(cfg, params, cache, tokens: torch.Tensor, pos, *,
                trainable=None, k=None, slot_mask=None, block_table=None,
                page_span=None, dispatch: str = "ragged",
                return_counts: bool = False):
    """One block-paged decode step.  tokens: (B, 1); pos: (B,) per-row
    positions (or a scalar); ``k``: int or per-slot tuple; ``slot_mask``:
    (B,) 0/1 rows in use.  The pool in ``cache`` is written in place.
    Returns (logits (B,1,V), cache) [+ counts {pos0: (n_periods, E)}]."""
    if block_table is None:
        raise NotImplementedError(
            "slotted (non-paged) decode comes with the serving-extras slice")
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    if S != 1:
        raise NotImplementedError(
            "multi-token decode (speculative verify) comes with the "
            "serving-extras slice")
    pos = torch.as_tensor(pos, device=x.device)
    base = pos[:, None] if pos.dim() == 1 else pos.expand(B, 1)
    positions = base + torch.arange(S, device=x.device)[None, :]
    h, counts, _ = _run_stack(
        cfg, params, x, positions, trainable=trainable, k=k, cache=cache,
        cache_pos=pos, return_cache=True, slot_mask=slot_mask,
        block_table=block_table, page_span=page_span, dispatch=dispatch)
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    logits = lm_head(params, cfg, h)
    if return_counts:
        return logits, cache, counts
    return logits, cache
