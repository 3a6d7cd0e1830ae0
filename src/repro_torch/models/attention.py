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

On the card mesh (``shard``) the rules split ``wq``'s columns and ``wo``'s
rows contiguously over ``model`` (:func:`kv_layout`: a rank computes the
heads that overlap its columns, 1.5 heads a rank where 24 meet 16 ways)
and the decode cache's sequence (``launch/sharding.cache_specs``): the
one-token step merges every rank's partial softmax over its slice
(:func:`decode_attention_partial`, :func:`merge_partial`).
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


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor, pos, *, lo: int,
                   Sc: int, window: int, logit_softcap: float):
    """One-token scores (B, KV, rep, Sc') of q (B,1,H,D) against cache
    slots ``lo .. lo + Sc'`` of an Sc-deep cache, masked to ``NEG_INF``
    where invalid, and the validity (B, Sc')."""
    B, Scl, KV, D = k_cache.shape
    H = q.shape[2]
    qh = q.reshape(B, KV, H // KV, D)
    s = torch.einsum("bkrd,bskd->bkrs", qh.to(_F32),
                     k_cache.to(_F32)) * D ** -0.5
    s = softcap(s, logit_softcap)
    idx = torch.arange(lo, lo + Scl, device=q.device)
    posb = torch.as_tensor(pos, device=q.device).expand(B)
    if window > 0:
        valid = idx[None, :] < torch.clamp(posb + 1, max=Sc)[:, None]
    else:
        valid = idx[None, :] <= posb[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s, valid


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
    s, _ = _decode_scores(q, k_cache, pos, lo=0, Sc=Sc, window=window,
                          logit_softcap=logit_softcap)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(_F32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos, *, lo: int, Sc: int,
                             window: int = 0, logit_softcap: float = 0.0):
    """:func:`decode_attention` over one slice of an Sc-deep cache, the
    slots ``lo .. lo + Sc'`` that ``k_cache``/``v_cache`` (B,Sc',KV,D)
    hold, unnormalised, in fp32: the running max m (B,H), the sum of
    exponentials l (B,H) and the weighted sum of values o (B,H,D).  A
    slice with no valid slot gives m = ``NEG_INF``, l = 0, o = 0, so it
    adds nothing to :func:`merge_partial`."""
    B, Scl, KV, D = k_cache.shape
    H = q.shape[2]
    s, valid = _decode_scores(q, k_cache, pos, lo=lo, Sc=Sc, window=window,
                              logit_softcap=logit_softcap)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * valid[:, None, None, :]
    o = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(_F32))
    return m.reshape(B, H), p.sum(-1).reshape(B, H), o.reshape(B, H, D)


def merge_partial(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                  group) -> torch.Tensor:
    """The softmax-weighted output (B,H,D) fp32 from every rank of
    ``group``'s :func:`decode_attention_partial` over its slice: one
    all-gather of the packed (m, l, o), then each slice rescaled by
    e^(m_r - max m) and summed."""
    packed = torch.cat([m[..., None], l[..., None], o], dim=-1)
    parts = parallel.gather_frozen(packed[None], group, 0)
    m_r, l_r, o_r = parts[..., 0], parts[..., 1], parts[..., 2:]
    w = torch.exp(m_r - m_r.amax(dim=0))
    return ((w[..., None] * o_r).sum(0)
            / (w * l_r).sum(0)[..., None])


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
    q = lora_dense(x, p["wq"], lg.get("wq"), lora_scale)
    k = lora_dense(x, p["wk"], lg.get("wk"), lora_scale)
    v = lora_dense(x, p["wv"], lg.get("wv"), lora_scale)
    return (_heads(q, cfg.n_heads, p.get("q_norm"), cfg, positions),
            _heads(k, cfg.n_kv_heads, p.get("k_norm"), cfg, positions),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim_))


def kv_layout(cfg, sh) -> tuple:
    """On the mesh: this rank's query heads and how it reads K/V, as (h0,
    nh, off, kv_split).  The reference's rules split ``wq``'s columns and
    ``wo``'s rows contiguously over ``model``: rank r owns columns [r·C,
    (r+1)·C) of the attention output, C = H·hd / M.  It computes attention
    for the ``nh`` heads from ``h0`` that overlap them and keeps columns
    ``off .. off + C`` of their output.  Where the heads divide the model
    axis those are its own H/M heads (``off`` 0, its ``wq`` shard);
    otherwise (phi4-mini's 24 heads on 16 ways: 192 columns, 1.5 heads)
    at most ⌈H/M⌉ + 1 heads, from ``wq``'s columns gathered over
    ``model``.  ``kv_split``: the KV heads divide the model axis, so each
    rank projects its own KV/M (the only ones its query heads read);
    otherwise every rank projects all KV heads."""
    H, KV, M, hd = cfg.n_heads, cfg.n_kv_heads, sh.M, cfg.head_dim_
    if (H * hd) % M:
        raise NotImplementedError(f"{cfg.name}: {H * hd} query columns do "
                                  f"not divide a {M}-way model axis")
    C = H * hd // M
    c0 = sh.mi * C
    h0 = c0 // hd
    nh = -(-(c0 + C) // hd) - h0
    return h0, nh, c0 - h0 * hd, KV % M == 0


def _local_kv(t: torch.Tensor, cfg, sh) -> torch.Tensor:
    """The K or V heads this rank's query heads read, in the layout the
    flash kernel and :func:`decode_attention` take (local query head i
    reads head i // (nh / nkv)), of ``t`` (..., KV', hd) holding all KV
    heads or (``kv_layout``'s kv_split) this rank's own.  Where the local
    heads do not map so onto a run of KV heads (they start or end
    mid-group), one KV head per query head."""
    KV = cfg.n_kv_heads
    if t.shape[-2] != KV:
        return t
    h0, nh, _, _ = kv_layout(cfg, sh)
    rep = cfg.n_heads // KV
    kv = [h // rep for h in range(h0, h0 + nh)]
    n = kv[-1] - kv[0] + 1
    if nh % n == 0 and all(g - kv[0] == i // (nh // n)
                           for i, g in enumerate(kv)):
        return t.narrow(-2, kv[0], n)
    return t.index_select(-2, torch.tensor(kv, device=t.device))


def _heads(t: torch.Tensor, n: int, norm, cfg, positions) -> torch.Tensor:
    """(B, S, n·hd) projections as (B, S, n, hd) heads, qk-normed and
    RoPE'd at ``positions``."""
    t = t.reshape(t.shape[0], t.shape[1], n, cfg.head_dim_)
    if cfg.qk_norm:
        t = rms_norm(norm, t, cfg.rms_eps)
    return apply_rope(t, positions, cfg.rope_theta)


def _project_qkv_sharded(p: dict, cfg, x: torch.Tensor,
                         positions: torch.Tensor, lg: dict,
                         lora_scale: float, sh):
    """:func:`_project_qkv` on the mesh for prefill and training: the
    query heads of :func:`kv_layout` (``wq``'s columns and the adapter's
    ``b`` gathered over ``model`` where they do not divide it) and this
    rank's K/V heads (all of them where they do not divide the model
    axis), from column-split ``wq``/``wk``/``wv``."""
    hd = cfg.head_dim_
    h0, nh, _, kv_split = kv_layout(cfg, sh)
    xc = parallel.copy_to(x, sh.model)
    w, lp = p["wq"], lg.get("wq")
    if w.shape[-1] != nh * hd:
        # uneven heads: the rank's heads from the gathered columns (b's
        # gradient partial on each rank, as for K/V below)
        w = parallel.gather_frozen(w, sh.model, w.dim() - 1).narrow(
            -1, h0 * hd, nh * hd)
        if lp is not None:
            lp = {"a": lp["a"],
                  "b": parallel.gather(lp["b"], sh.model,
                                       lp["b"].dim() - 1).narrow(
                      -1, h0 * hd, nh * hd)}
    q = col_dense(xc, w, lp, lora_scale, sh)
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
    return (_heads(q, nh, p.get("q_norm"), cfg, positions),
            _heads(k, k.shape[-1] // hd, p.get("k_norm"), cfg, positions),
            v.reshape(v.shape[0], v.shape[1], -1, hd))


def _own_columns(out: torch.Tensor, off: int, cfg, sh) -> torch.Tensor:
    """Columns ``off .. off + H·hd/M`` of an attention output (B, S, n·hd):
    this rank's rows of ``wo``."""
    C = cfg.n_heads * cfg.head_dim_ // sh.M
    return out if out.shape[-1] == C else out.narrow(-1, off, C)


def _cache_piece(t: torch.Tensor, cfg, sh, window: int) -> torch.Tensor:
    """This rank's slice of a prefill's K or V cache (``t``: (B,S,KV',hd),
    all KV heads or this rank's own): :func:`_ring_piece`'s Sc columns
    split over ``model`` where they divide it (``sharding.cache_specs``),
    every KV head; whole on every rank where they do not.  Own heads are
    redistributed: an all-to-all of the sequence slices (or, for a whole
    cache, an all-gather of the heads)."""
    t = _ring_piece(t, window)
    if sh.model is None:
        return t
    M = sh.M
    B, Sc, KVl, hd = t.shape
    own = KVl != cfg.n_kv_heads
    if Sc % M:
        return parallel.gather_frozen(t, sh.model, 2) if own else t
    Scl = Sc // M
    if not own:
        return t.narrow(1, sh.mi * Scl, Scl)
    blocks = t.reshape(B, M, Scl, KVl, hd).movedim(1, 0)
    got = parallel.all_to_all(blocks, sh.model)
    return got.permute(1, 2, 0, 3, 4).reshape(B, Scl, M * KVl, hd)


def _decode_sharded(p: dict, cfg, x: torch.Tensor, positions, lg: dict,
                    lora_scale: float, cache: dict, cache_pos, sh):
    """The one-token decode step on the mesh, out (B, 1, C): this rank's
    columns of the attention output.  Every rank projects its columns of
    q, k and v and gathers them over ``model`` (B·(H + 2·KV)·hd), so it
    holds every head of the new token.  On a cache whose depth the model
    axis splits (``sharding.cache_specs``), rank r holds slots [r·Sc/M,
    (r+1)·Sc/M) of every KV head: it writes the rows whose slot (``pos``,
    ``pos % Sc`` on a ring) falls there, computes every query head's
    partial softmax over its slots (:func:`decode_attention_partial`) and
    merges them over ``model`` (:func:`merge_partial`).  On a whole cache
    it writes every row and attends with its :func:`kv_layout` heads."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    window, cap = cfg.attention_window, cfg.attn_logit_softcap
    h0, nh, off, _ = kv_layout(cfg, sh)

    def whole(name, n):
        t = col_dense(x, p[name], lg.get(name), lora_scale, sh)
        if parallel.split_dim(n * hd, t.shape[-1], sh.M, name):
            t = parallel.gather_frozen(t, sh.model, t.dim() - 1)
        return t
    q = _heads(whole("wq", H), H, p.get("q_norm"), cfg, positions)
    k = _heads(whole("wk", KV), KV, p.get("k_norm"), cfg, positions)
    v = whole("wv", KV).reshape(B, 1, KV, hd)
    if sh.model is not None and sh.cache_len is None:
        raise ValueError("a sharded decode step needs the cache's depth "
                         "(Shard.cache_len)")
    Scl = cache["k"].shape[1]
    split = sh.model is not None and sh.cache_len % sh.M == 0
    Sc, lo = (sh.cache_len, sh.mi * Scl) if split else (Scl, 0)
    _slice_write(cache, k, v, cache_pos, lo=lo, Sc=Sc, window=window)
    if not split:
        out = decode_attention(q.narrow(2, h0, nh),
                               _local_kv(cache["k"], cfg, sh),
                               _local_kv(cache["v"], cfg, sh), cache_pos,
                               window=window, logit_softcap=cap)
        return _own_columns(out.reshape(B, 1, nh * hd), off, cfg, sh)
    m, l, o = decode_attention_partial(q, cache["k"], cache["v"], cache_pos,
                                       lo=lo, Sc=Sc, window=window,
                                       logit_softcap=cap)
    out = merge_partial(m, l, o, sh.model).to(q.dtype)
    return _own_columns(out.reshape(B, 1, H * hd), sh.mi * H * hd // sh.M,
                        cfg, sh)


def _slice_write(cache: dict, k: torch.Tensor, v: torch.Tensor, cache_pos,
                 *, lo: int, Sc: int, window: int) -> None:
    """The one-token write into this rank's slots ``lo .. lo + Sc'`` of an
    Sc-deep cache, in place: a row writes only where its slot (``pos``,
    ``pos % Sc`` on a ring) falls in them."""
    B = k.shape[0]
    dev = cache["k"].device
    Scl = cache["k"].shape[1]
    cp = torch.as_tensor(cache_pos, device=dev).expand(B).long()
    col = (cp % Sc if window > 0 else cp) - lo
    mine = ((col >= 0) & (col < Scl))[:, None, None]
    col = col.clamp(0, Scl - 1)
    rows = torch.arange(B, device=dev)
    for leaf, t in (("k", k), ("v", v)):
        c = cache[leaf]
        c[rows, col] = torch.where(mine, t[:, 0].to(c.dtype), c[rows, col])


def _apply_attention_sharded(p: dict, cfg, x: torch.Tensor,
                             positions: torch.Tensor, *, lora, lora_scale,
                             cache, cache_pos, return_cache, block_table,
                             suffix_readonly, sh):
    """:func:`apply_attention` on the mesh: prefill / training (flash over
    :func:`kv_layout`'s heads, the returned cache this rank's slice,
    :func:`_cache_piece`) and the slotted one-token decode step
    (:func:`_decode_sharded`); ``wo`` row-split, its output all-reduced."""
    B, S, D = x.shape
    lg = lora or {}
    if block_table is not None or suffix_readonly or (cache is not None
                                                      and S > 1):
        raise NotImplementedError("the mesh runs prefill, training and the "
                                  "slotted decode step; the paged pool, "
                                  "suffix prefill and speculative verify "
                                  "stay single-card")
    if cache is not None:
        out = _decode_sharded(p, cfg, x, positions, lg, lora_scale, cache,
                              cache_pos, sh)
        return row_dense(out, p["wo"], lg.get("wo"), lora_scale, sh,
                         D), cache
    q, k, v = _project_qkv_sharded(p, cfg, x, positions, lg, lora_scale, sh)
    window = cfg.attention_window
    _, nh, off, _ = kv_layout(cfg, sh)
    out = kernel_backend.flash_attention(
        q, _local_kv(k, cfg, sh), _local_kv(v, cfg, sh), causal=True,
        window=window, softcap=cfg.attn_logit_softcap)
    out = _own_columns(out.reshape(B, S, nh * cfg.head_dim_), off, cfg, sh)
    new_cache = None
    if return_cache:
        new_cache = {"k": _cache_piece(k, cfg, sh, window),
                     "v": _cache_piece(v, cfg, sh, window)}
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
