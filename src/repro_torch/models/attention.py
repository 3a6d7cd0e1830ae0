"""Attention: GQA with RoPE and optional qk-norm (port of
``repro/models/attention.py``).

* training and prefill (no cache): the flash-attention kernel through
  :func:`repro_torch.kernels.backend.flash_attention` (differentiable),
  with the config's sliding window (``attention_window``; the kernel
  skips the key tiles before a query block's window), and optional LoRA
  adapters on q/k/v/o through ``lora_matmul``.  With a window ``w`` and
  ``S >= w`` the returned cache is the reference's ring: the last ``w``
  tokens, token ``t`` at slot ``t % w``;
* single-token decode, block-paged (:func:`paged_decode_write`,
  :func:`paged_gather`, :func:`decode_attention`) or slotted (a per-row
  scatter at ``cache_pos`` — ``cache_pos % Sc`` on a ring — into the
  (B, Sc, KV, D) rows, then the same :func:`decode_attention`), plain
  PyTorch as in the reference (which keeps them outside Pallas too);
* suffix-only cached prefill (``suffix_readonly``): the suffix rows attend
  each row's gathered prefix pages plus the in-flight suffix through
  :func:`suffix_attention`, which runs the flash kernel of the cold
  prefill on the rows laid out at their absolute positions, and the new
  K/V come back as a contiguous piece.  (The reference attends the suffix
  with plain jnp, :func:`verify_attention`; the same math, but at bf16 its
  fp32 probabilities against the kernel's rounded ones are enough to flip
  near-tied routing decisions, so a prefix hit would not reproduce the
  cold prefill's tokens.)  This branch is checked before the decode ones,
  so a one-token suffix never writes the pool;
* speculative verify (S > 1 with a cache): :func:`verify_attention` reads
  the cache before any write (the window's positions may hold nothing
  the full-k pass should see), then the window's K/V are written at
  ``cache_pos + s`` (mod the ring span on a ring), through
  :func:`paged_verify_write` or a per-row scatter;
* speculative draft: :func:`apply_draft_attention` /
  :func:`draft_attention`, one reduced-k step against a read-only prefix
  and a small (B, W, KV, D) window buffer (``model.draft_window``).

Every branch applies the config's logit softcap (``attn_logit_softcap``:
``s = cap·tanh(s·D^-½ / cap)`` after the scale, before the masks): the
flash kernel computes it itself, where the reference sends a capped model
to its blockwise jnp path; the plain decode, verify and draft functions
take it as the reference's do.

The suffix branch refuses a ring, as the reference's pools do (a
``BlockPool`` with a prefix cache needs a linear cache): it raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import backend as kernel_backend
from . import parallel
from .layers import (apply_rope, col_dense, lora_dense, rms_norm, row_dense,
                     softcap)

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


def draft_attention(q: torch.Tensor, k_win: torch.Tensor,
                    v_win: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: torch.Tensor, j: int, *,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """One speculative-draft step's attention: a read-only prefix plus the
    window buffer.  q: (B,1,H,D) RoPE'd at ``pos + j``; ``k_win``/``v_win``:
    (B,W,KV,D) holding the draft pass's own K/V at indices ``<= j``;
    caches: (B,Sc,KV,D), valid strictly below ``pos`` (the window's start).
    Needs a non-wrapping cache."""
    B, Sc, KV, D = k_cache.shape
    W = k_win.shape[1]
    H = q.shape[2]
    rep = H // KV
    scale = D ** -0.5
    qh = q.reshape(B, KV, rep, D).to(_F32)
    s_old = torch.einsum("bkrd,bskd->bkrs", qh, k_cache.to(_F32)) * scale
    s_new = torch.einsum("bkrd,btkd->bkrt", qh, k_win.to(_F32)) * scale
    s_old = softcap(s_old, logit_softcap)
    s_new = softcap(s_new, logit_softcap)
    posb = torch.as_tensor(pos, device=q.device).expand(B)
    valid_old = torch.arange(Sc, device=q.device)[None, :] < posb[:, None]
    valid_new = (torch.arange(W, device=q.device) <= j)[None, :].expand(B, W)
    valid = torch.cat([valid_old, valid_new], dim=-1)             # (B, Sc+W)
    scores = torch.cat([s_old, s_new], dim=-1)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = (torch.einsum("bkrs,bskd->bkrd", p[..., :Sc], v_cache.to(_F32))
           + torch.einsum("bkrt,btkd->bkrd", p[..., Sc:], v_win.to(_F32)))
    return out.reshape(B, 1, H, D).to(q.dtype)


def verify_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """Attention of an S-token window that starts at per-row position
    ``pos`` against a cache.  q/k_new/v_new: (B,S,H|KV,D), RoPE'd at
    ``pos + s``; caches: (B,Sc,KV,D); ``pos``: (B,).  Query ``s`` attends
    cache indices ``< pos`` plus window keys ``t <= s`` (the cache is read
    before any write, so positions ``>= pos`` never leak in).  Needs a
    non-wrapping cache: cache index == absolute position."""
    B, S, H, D = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    scale = D ** -0.5
    qh = q.reshape(B, S, KV, rep, D).to(_F32)
    s_old = torch.einsum("bskrd,bckd->bkrsc", qh, k_cache.to(_F32)) * scale
    s_new = torch.einsum("bskrd,btkd->bkrst", qh, k_new.to(_F32)) * scale
    s_old = softcap(s_old, logit_softcap)
    s_new = softcap(s_new, logit_softcap)

    posb = torch.as_tensor(pos, device=q.device).expand(B)
    steps = torch.arange(S, device=q.device)
    idx = torch.arange(Sc, device=q.device)
    valid_old = (idx[None, None, :] < posb[:, None, None]).expand(B, S, Sc)
    valid_new = (steps[None, None, :] <= steps[None, :, None]).expand(
        B, S, S)
    if window > 0:
        qpos = posb[:, None] + steps[None, :]
        kpos_new = posb[:, None, None] + steps[None, None, :]
        lo = qpos[:, :, None] - window
        valid_old = valid_old & (idx[None, None, :] > lo)
        valid_new = valid_new & (kpos_new > lo)
    valid = torch.cat([valid_old, valid_new], dim=-1)            # (B,S,Sc+S)
    scores = torch.cat([s_old, s_new], dim=-1)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = (torch.einsum("bkrsc,bckd->bskrd", p[..., :Sc], v_cache.to(_F32))
           + torch.einsum("bkrst,btkd->bskrd", p[..., Sc:], v_new.to(_F32)))
    return out.reshape(B, S, H, D).to(q.dtype)


def suffix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     block_table: torch.Tensor, prefix_len: torch.Tensor,
                     page_span: int, *,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal attention of S suffix tokens per row over the row's cached
    prefix and the suffix itself, through the flash kernel.

    q/k/v: (B,S,H|KV,D), RoPE'd at ``prefix_len[b] + s``; ``k_pool``/
    ``v_pool``: (NB+1, bs, KV, D); ``block_table`` (B, page_span // bs)
    covers every prefix position (``page_span >= max(prefix_len)``).  Each
    row is laid out at its absolute positions in a sequence of
    ``page_span + S``: keys below ``prefix_len[b]`` from its pages, the
    suffix's keys and queries at ``[prefix_len[b], prefix_len[b] + S)``.
    Causal masking then gives every suffix query exactly the keys a cold
    prefill of the whole prompt gives it (anything past the suffix is in
    its future); the other query rows are discarded."""
    B, S = q.shape[:2]
    T = page_span + S
    cols = (torch.as_tensor(prefix_len, device=q.device).long()[:, None]
            + torch.arange(S, device=q.device)[None, :])           # (B, S)
    rows = torch.arange(B, device=q.device)[:, None]

    def laid_out(pages, new):
        pad = new.new_zeros((B, T - pages.shape[1]) + new.shape[2:])
        full = torch.cat([pages.to(new.dtype), pad], dim=1)
        full[rows, cols] = new
        return full

    kf = laid_out(paged_gather(k_pool, block_table, page_span), k)
    vf = laid_out(paged_gather(v_pool, block_table, page_span), v)
    qf = laid_out(q.new_zeros((B, 0) + q.shape[2:]), q)
    out = kernel_backend.flash_attention(qf, kf, vf, causal=True, window=0,
                                         softcap=logit_softcap)
    return out[rows, cols]


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


def paged_verify_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       k_win: torch.Tensor, v_win: torch.Tensor,
                       block_table: torch.Tensor, cache_pos: torch.Tensor,
                       *, page_span: int, window: int) -> None:
    """Write an S-token verify window's K/V per row into the block pool,
    in place: row ``r`` writes logical slots ``pos + s`` for ``s < S``
    (the multi-token :func:`paged_decode_write`).  ``k_win``/``v_win``:
    (B, S, KV, D); free rows (zeroed table) write the trash block."""
    bs = k_pool.shape[1]
    B, S = k_win.shape[:2]
    cp = torch.as_tensor(cache_pos, device=k_pool.device).expand(B).long()
    pos = cp[:, None] + torch.arange(S, device=k_pool.device)[None, :]
    logical = pos % page_span if window > 0 else pos
    rows = torch.arange(B, device=k_pool.device)[:, None]
    bi = block_table[rows, logical // bs].long()
    off = logical % bs
    k_pool[bi, off] = k_win.to(k_pool.dtype)
    v_pool[bi, off] = v_win.to(v_pool.dtype)


def _slotted_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                   cache_pos, *, window: int) -> None:
    """Scatter an S-token window's K/V into the slotted rows in place:
    row ``b`` writes indices ``cache_pos[b] + s`` of its (Sc, KV, D) row,
    taken mod ``Sc`` on a ring (``window > 0``)."""
    B, S = k.shape[:2]
    dev = cache["k"].device
    cp = torch.as_tensor(cache_pos, device=dev).expand(B).long()
    cols = cp[:, None] + torch.arange(S, device=dev)[None, :]
    if window > 0:
        cols = cols % cache["k"].shape[1]
    rows = torch.arange(B, device=dev)[:, None]
    cache["k"][rows, cols] = k.to(cache["k"].dtype)
    cache["v"][rows, cols] = v.to(cache["v"].dtype)


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


def _project_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                 lg: dict, lora_scale: float):
    """q, k, v (B,S,H|KV,hd) of ``x``: the projections (with adapters),
    qk-norm and RoPE at ``positions``."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = lora_dense(x, p["wq"], lg.get("wq"), lora_scale)
    k = lora_dense(x, p["wk"], lg.get("wk"), lora_scale)
    v = lora_dense(x, p["wv"], lg.get("wv"), lora_scale)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = rms_norm(p["k_norm"], k, cfg.rms_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def kv_layout(cfg, sh) -> tuple:
    """On the mesh: (local q heads, the first and the number of KV heads
    they read, whether K/V are split by head over ``model``).  With the KV
    heads dividing the model axis each rank projects and caches its own
    (KV/M of them); otherwise every rank projects all KV heads (their
    columns gathered where the rule split them mid-head) and its query
    heads read a slice."""
    H, KV, M = cfg.n_heads, cfg.n_kv_heads, sh.M
    if H % M:
        raise NotImplementedError(f"{cfg.name}: {H} query heads do not divide "
                                  f"a {M}-way model axis")
    Hl, rep = H // M, H // KV
    if KV % M == 0:
        return Hl, sh.mi * (KV // M), KV // M, True
    if Hl % rep and rep % Hl:
        raise NotImplementedError(f"{cfg.name}: {Hl} query heads a rank do "
                                  f"not align with groups of {rep}")
    return Hl, sh.mi * Hl // rep, max(Hl // rep, 1), False


def _project_qkv_sharded(p: dict, cfg, x: torch.Tensor,
                         positions: torch.Tensor, lg: dict,
                         lora_scale: float, sh):
    """:func:`_project_qkv` on the mesh: this rank's query heads and K/V
    heads (all of them where they do not divide the model axis, see
    :func:`kv_layout`), from column-split ``wq``/``wk``/``wv``."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    Hl, _, _, kv_split = kv_layout(cfg, sh)
    xc = parallel.copy_to(x, sh.model)
    q = col_dense(xc, p["wq"], lg.get("wq"), lora_scale, sh)
    kv = []
    for name in ("wk", "wv"):
        w, lp = p[name], lg.get(name)
        full = cfg.n_kv_heads * hd
        if not kv_split and parallel.split_dim(full, w.shape[-1], sh.M,
                                               name):
            # split mid-head by the rule: gather the columns, so every rank
            # projects every KV head (b's gradient is then partial on each
            # rank: the gather's reduce-scatter sums it back)
            w = parallel.gather_frozen(w, sh.model, w.dim() - 1)
            if lp is not None:
                lp = {"a": lp["a"],
                      "b": parallel.gather(lp["b"], sh.model,
                                           lp["b"].dim() - 1)}
        elif not kv_split and lp is not None:
            # replicated by the rule: b's gradient is partial on each rank
            lp = {"a": lp["a"], "b": parallel.copy_to(lp["b"], sh.model)}
        kv.append(col_dense(xc, w, lp, lora_scale, sh))
    k, v = kv
    q = q.reshape(B, S, Hl, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = rms_norm(p["k_norm"], k, cfg.rms_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _local_kv(t: torch.Tensor, cfg, sh) -> torch.Tensor:
    """The KV heads this rank's query heads read, of ``t`` (..., KV', hd)
    holding all KV heads or this rank's own."""
    _, kv0, nkv, kv_split = kv_layout(cfg, sh)
    return t if kv_split else t.narrow(-2, kv0, nkv)


def _apply_attention_sharded(p: dict, cfg, x: torch.Tensor,
                             positions: torch.Tensor, *, lora, lora_scale,
                             cache, cache_pos, return_cache, block_table,
                             suffix_readonly, sh):
    """:func:`apply_attention` on the mesh: prefill / training (flash over
    this rank's heads) and the slotted one-token decode step (the cache
    holds this rank's KV heads, or all of them where they do not divide
    the model axis); ``wo`` row-split, its output all-reduced."""
    B, S, D = x.shape
    lg = lora or {}
    if block_table is not None or suffix_readonly or (cache is not None
                                                      and S > 1):
        raise NotImplementedError("the mesh runs prefill, training and the "
                                  "slotted decode step; the paged pool, "
                                  "suffix prefill and speculative verify "
                                  "stay single-card")
    q, k, v = _project_qkv_sharded(p, cfg, x, positions, lg, lora_scale, sh)
    window = cfg.attention_window
    cap = cfg.attn_logit_softcap
    new_cache = None
    if cache is None:
        out = kernel_backend.flash_attention(
            q, _local_kv(k, cfg, sh), _local_kv(v, cfg, sh), causal=True,
            window=window, softcap=cap)
        if return_cache:
            new_cache = {"k": _ring_piece(k, window),
                         "v": _ring_piece(v, window)}
    else:
        _slotted_write(cache, k, v, cache_pos, window=window)
        out = decode_attention(q, _local_kv(cache["k"], cfg, sh),
                               _local_kv(cache["v"], cfg, sh), cache_pos,
                               window=window, logit_softcap=cap)
        new_cache = cache
    out = out.reshape(B, S, -1)
    return row_dense(out, p["wo"], lg.get("wo"), lora_scale, sh,
                     D), new_cache


def _ring_piece(t: torch.Tensor, window: int) -> torch.Tensor:
    """A prefill's K or V (B,S,KV,D) as the decode cache: on a ring
    (``0 < window <= S``) the last ``window`` tokens, rolled so token ``t``
    sits at slot ``t % window`` and the next decode write overwrites the
    oldest entry; else the whole sequence."""
    S = t.shape[1]
    if window <= 0 or S < window:
        return t
    return torch.roll(t[:, S - window:], S % window, dims=1)


def apply_attention(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                    *, lora: Optional[dict] = None, lora_scale: float = 0.0,
                    cache: Optional[dict] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    return_cache: bool = False,
                    block_table: Optional[torch.Tensor] = None,
                    page_span: Optional[int] = None,
                    suffix_readonly: bool = False, shard=None):
    """x: (B,S,D_model).  Prefill when ``cache`` is None.  With a cache and
    ``cache_pos``: single-token decode (S == 1) or speculative verify
    (S > 1, the S tokens teacher-forced at ``cache_pos + s``), block-paged
    when a ``block_table`` is given (the cache leaves are then the pool
    (NB+1, bs, KV, D)), slotted otherwise (the leaves are (B, Sc, KV, D)
    rows); the cache is written in place.  ``suffix_readonly`` (with a
    block table): suffix-only cached prefill — queries sit at per-row
    offset ``cache_pos`` (the cached prefix length) and attend the
    gathered prefix pages plus the in-flight suffix; the pool is not
    written (rows sharing attached blocks must not rewrite them), the new
    K/V come back as a contiguous (B,S,KV,D) piece for the caller to
    scatter.  Returns (out, new_cache): for prefill with ``return_cache``
    and for the suffix the new K/V; otherwise the (mutated) cache.
    ``shard`` (the card mesh, ``models/parallel.py``): this rank's heads,
    :func:`_apply_attention_sharded`."""
    if shard is not None:
        return _apply_attention_sharded(
            p, cfg, x, positions, lora=lora, lora_scale=lora_scale,
            cache=cache, cache_pos=cache_pos, return_cache=return_cache,
            block_table=block_table, suffix_readonly=suffix_readonly,
            sh=shard)
    B, S, _ = x.shape
    lg = lora or {}
    q, k, v = _project_qkv(p, cfg, x, positions, lg, lora_scale)
    window = cfg.attention_window
    cap = cfg.attn_logit_softcap

    new_cache = None
    if cache is None:
        out = kernel_backend.flash_attention(q, k, v, causal=True,
                                             window=window, softcap=cap)
        if return_cache:
            new_cache = {"k": _ring_piece(k, window),
                         "v": _ring_piece(v, window)}
    elif suffix_readonly:
        # checked before the decode branches: a one-token suffix must not
        # write the pool either.  Prefix sharing needs a linear cache
        # (BlockPool refuses prefix_cache with a window)
        if window > 0:
            raise NotImplementedError(
                "suffix-only prefill attends a linear cache; a "
                "sliding-window (ring) model has no prefix cache")
        out = suffix_attention(q, k, v, cache["k"], cache["v"], block_table,
                               cache_pos, page_span, logit_softcap=cap)
        new_cache = {"k": k, "v": v}
    elif block_table is not None and S == 1:
        paged_decode_write(cache["k"], cache["v"], k[:, 0], v[:, 0],
                           block_table, cache_pos, page_span=page_span,
                           window=window)
        kg = paged_gather(cache["k"], block_table, page_span)
        vg = paged_gather(cache["v"], block_table, page_span)
        out = decode_attention(q, kg, vg, cache_pos, window=window,
                               logit_softcap=cap)
        new_cache = cache
    elif S == 1:
        _slotted_write(cache, k, v, cache_pos, window=window)
        out = decode_attention(q, cache["k"], cache["v"], cache_pos,
                               window=window, logit_softcap=cap)
        new_cache = cache
    elif block_table is not None:
        # paged verify: attend the gathered pages before the write, then
        # deposit the window's full-k K/V at its positions
        kg = paged_gather(cache["k"], block_table, page_span)
        vg = paged_gather(cache["v"], block_table, page_span)
        out = verify_attention(q, k, v, kg, vg, cache_pos, window=window,
                               logit_softcap=cap)
        paged_verify_write(cache["k"], cache["v"], k, v, block_table,
                           cache_pos, page_span=page_span, window=window)
        new_cache = cache
    else:
        out = verify_attention(q, k, v, cache["k"], cache["v"], cache_pos,
                               window=window, logit_softcap=cap)
        _slotted_write(cache, k, v, cache_pos, window=window)
        new_cache = cache

    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim_)
    return lora_dense(out, p["wo"], lg.get("wo"), lora_scale), new_cache


def apply_draft_attention(p: dict, cfg, x: torch.Tensor,
                          positions: torch.Tensor, j: int, win: dict,
                          static_kv: dict, pos: torch.Tensor, *,
                          lora: Optional[dict] = None,
                          lora_scale: float = 0.0) -> torch.Tensor:
    """The attention sub-layer of one speculative-draft step (S == 1): the
    projections of :func:`apply_attention`, the new K/V written in place
    at index ``j`` of the window buffer ``win`` ((B,W,KV,D) leaves) rather
    than into the cache, and :func:`draft_attention` against the read-only
    contiguous prefix ``static_kv``."""
    B, S, _ = x.shape
    lg = lora or {}
    q, k, v = _project_qkv(p, cfg, x, positions, lg, lora_scale)
    win["k"][:, j] = k[:, 0].to(win["k"].dtype)
    win["v"][:, j] = v[:, 0].to(win["v"].dtype)
    out = draft_attention(q, win["k"], win["v"], static_kv["k"],
                          static_kv["v"], pos, j,
                          logit_softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim_)
    return lora_dense(out, p["wo"], lg.get("wo"), lora_scale)
