"""Attention: GQA with RoPE and optional qk-norm (port of
``repro/models/attention.py``, the branches of ``apply_attention`` on the
serving path).

* prefill (no cache): the flash-attention kernel through
  :func:`repro_torch.kernels.backend.flash_attention`;
* block-paged decode: :func:`paged_decode_write`, :func:`paged_gather` and
  :func:`decode_attention`, plain PyTorch as in the reference (which keeps
  them outside Pallas too).

The other branches — slotted decode, speculative verify, suffix-readonly
prefill, sliding-window ring caches and logit softcap — come with later
slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import backend as kernel_backend
from .layers import apply_rope, lora_dense, rms_norm, softcap

NEG_INF = -1e30
_F32 = torch.float32


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """One-token attention.  q: (B,1,H,D); caches: (B,Sc,KV,D); ``pos``:
    scalar or (B,) absolute position of the current token.  For a linear
    cache only slots ``<= pos`` are valid; for a ring (window > 0) every
    written slot is."""
    B, Sc, KV, D = k_cache.shape
    H = q.shape[2]
    rep = H // KV
    scale = D ** -0.5
    qh = q.reshape(B, KV, rep, D)
    s = torch.einsum("bkrd,bskd->bkrs", qh.to(_F32),
                     k_cache.to(_F32)) * scale
    s = softcap(s, logit_softcap)
    idx = torch.arange(Sc, device=q.device)
    posb = torch.as_tensor(pos, device=q.device).expand(B)
    if window > 0:
        valid = idx[None, :] < torch.clamp(posb + 1, max=Sc)[:, None]
    else:
        valid = idx[None, :] <= posb[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(_F32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def paged_decode_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       k_tok: torch.Tensor, v_tok: torch.Tensor,
                       block_table: torch.Tensor, cache_pos: torch.Tensor,
                       *, page_span: int, window: int) -> None:
    """Write one token's K/V per row into the block pool, IN PLACE (the
    reference returns updated copies; here the pool is mutated).

    ``k_pool``/``v_pool``: (NB+1, bs, KV, D), block 0 is the trash block
    free rows (zeroed table) write into.  ``k_tok``/``v_tok``: (B, KV, D).
    Row ``r`` writes logical slot ``pos % page_span`` (ring) or ``pos``."""
    bs = k_pool.shape[1]
    B = k_tok.shape[0]
    cp = torch.as_tensor(cache_pos, device=k_pool.device).expand(B).long()
    logical = cp % page_span if window > 0 else cp
    rows = torch.arange(B, device=k_pool.device)
    bi = block_table[rows, logical // bs].long()
    off = logical % bs
    k_pool[bi, off] = k_tok.to(k_pool.dtype)
    v_pool[bi, off] = v_tok.to(v_pool.dtype)


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor,
                 page_span: int) -> torch.Tensor:
    """Each row's KV pages as a contiguous (B, page_span, KV, D) view-copy,
    the layout :func:`decode_attention` consumes.  Unallocated entries
    gather the trash block; positions past a row's length are masked by
    the per-row validity in :func:`decode_attention`."""
    B, MB = block_table.shape
    bs = pool.shape[1]
    pages = pool[block_table.long()]                  # (B, MB, bs, KV, D)
    return pages.reshape(B, MB * bs, *pool.shape[2:])[:, :page_span]


def apply_attention(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                    *, lora: Optional[dict] = None, lora_scale: float = 0.0,
                    cache: Optional[dict] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    return_cache: bool = False,
                    block_table: Optional[torch.Tensor] = None,
                    page_span: Optional[int] = None):
    """x: (B,S,D_model).  Prefill when ``cache`` is None; block-paged
    decode (S == 1) when ``cache`` holds the pool leaves and a
    ``block_table`` is given.  Returns (out, new_cache): for prefill with
    ``return_cache`` the new (B,S,KV,D) K/V; for decode the (mutated)
    pool leaves."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    lg = lora or {}
    if cfg.attn_logit_softcap > 0:
        raise NotImplementedError(
            "logit-softcap attention comes with a later slice of the port "
            "(the flash kernel has no softcap)")

    q = lora_dense(x, p["wq"], lg.get("wq"), lora_scale)
    k = lora_dense(x, p["wk"], lg.get("wk"), lora_scale)
    v = lora_dense(x, p["wv"], lg.get("wv"), lora_scale)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = rms_norm(p["k_norm"], k, cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None:
        if cfg.attention_window > 0:
            raise NotImplementedError(
                "sliding-window (ring) caches come with a later slice")
        out = kernel_backend.flash_attention(q, k, v, causal=True, window=0)
        if return_cache:
            new_cache = {"k": k, "v": v}
    elif block_table is not None and cache_pos is not None and S == 1:
        paged_decode_write(cache["k"], cache["v"], k[:, 0], v[:, 0],
                           block_table, cache_pos, page_span=page_span,
                           window=cfg.attention_window)
        kg = paged_gather(cache["k"], block_table, page_span)
        vg = paged_gather(cache["v"], block_table, page_span)
        out = decode_attention(q, kg, vg, cache_pos,
                               window=cfg.attention_window)
        new_cache = cache
    else:
        raise NotImplementedError(
            "slotted decode, speculative verify and suffix-only prefill "
            "come with the serving-extras slice of the port; this slice "
            "serves prefill and block-paged single-token decode")

    out = out.reshape(B, S, cfg.n_heads * hd)
    return lora_dense(out, p["wo"], lg.get("wo"), lora_scale), new_cache
