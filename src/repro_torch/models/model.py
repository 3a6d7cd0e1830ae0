"""Decoder model: the serving and training paths of ``repro/models/model.py``.

A model is ``num_layers`` blocks; each block is a mixer (attention or the
Mamba-2 block) and an optional FFN (dense SwiGLU or sparse MoE).  Blocks
group into repeating periods of ``cfg.pattern_period`` positions (Jamba:
period 8, attention at position 4, MoE at the odd positions).

The parameter tree keeps the reference's layout — ``{"embed": {"tokens"},
"blocks": {"pos0": <leaves stacked over n_periods>, ..., "pos{P-1}"},
"final_norm", "lm_head"}`` — so a JAX tree converts leaf for leaf.  The
reference scans over the leading ``n_periods`` axis; here the stack is a
Python loop over it, each period running its P positions in order on
views of their stacked leaves.

The trainable (federated) tree is ``{"lora": {"blocks": {"pos{i}":
<adapter pairs {"a", "b"} mirroring the targeted weights>}}, "rescaler":
{"pos{i}": (n_periods,)}}`` with one rescaler per MoE position
(``repro_torch.core.lora``).

Caches are dicts ``{"pos{i}": {"attn": {"k", "v"}} | {"ssm": {"conv",
"ssm"}}}`` with a leading ``n_periods`` axis: for attention the slotted
rows of :func:`init_cache` (n, B, Sc, KV, hd) or the block-paged pool of
:func:`init_paged_cache`; for the Mamba block per-row state (n, B, ...)
in both.  Both are updated in place by :func:`decode_step`; the reference
threads them through the scan carry and returns new ones.
:func:`draft_window` runs the speculative draft: W reduced-k steps that
never write the cache (attention-only models).

On the card mesh the training, prefill and slotted decode entry points
take ``shard`` (``models/parallel.py``): every tree is then this rank's
shard (``launch/sharding.py``), the batch this rank's rows, and each
layer runs its sharded path (vocabulary-split embedding and head, heads
and FFN columns and experts split over ``model``, FSDP gathers over
``data``, head-parallel Mamba-2 blocks: ``mamba2.apply_mamba``) to the
unsharded model's result, for every arch of the registry.

The training and serving entry points (``lm_loss``, ``prefill``,
``prefill_suffix``, ``decode_step``) are spans ``model.<name>`` of the
tracer of the run or round in progress (``repro_torch.obs.trace``), with
device markers under a ``torch.profiler`` session.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from ..obs import trace as obs_trace
from . import attention as attn_mod
from . import mamba2 as ssm_mod
from . import moe_layer as moe_mod
from . import parallel
from .layers import apply_ffn, dense_init, embed_init, rms_norm

_F32 = torch.float32

PyTree = Any


# ==========================================================================
# init
# ==========================================================================

def _init_block(cfg, kind: str, is_moe: bool, n: int, generator,
                device) -> dict:
    """One stacked block position (an attention or Mamba mixer, and an MoE
    or dense FFN or neither) with a leading ``n`` = n_periods axis; same
    distributions as the reference."""
    dt = cfg.torch_dtype
    d, hd = cfg.d_model, cfg.head_dim_

    def dense(shape, scale=1.0):
        return dense_init((n,) + shape, dt, generator, device, scale)

    def ones(dim):
        return torch.ones((n, dim), dtype=dt, device=device)

    p: dict = {"mixer_norm": ones(d)}
    if kind == "attn":
        attn = {"wq": dense((d, cfg.n_heads * hd)),
                "wk": dense((d, cfg.n_kv_heads * hd)),
                "wv": dense((d, cfg.n_kv_heads * hd)),
                "wo": dense((cfg.n_heads * hd, d))}
        if cfg.qk_norm:
            attn["q_norm"] = ones(hd)
            attn["k_norm"] = ones(hd)
        p["attn"] = attn
    else:
        p["ssm"] = ssm_mod.init_mamba(cfg, n, generator, device)
    m = cfg.moe
    if is_moe:
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


def _attention_only(cfg) -> bool:
    return all(cfg.layer_kind(p) == "attn" for p in range(cfg.pattern_period))


def init_params(cfg, generator: torch.Generator,
                device="cuda") -> PyTree:
    """Random weights from ``generator`` with the reference's
    distributions: truncated normal ±3σ, σ = scale/sqrt(fan_in) (router
    scale 0.1), embeddings and head N(0, 0.02), norms one, the Mamba
    block's as :func:`mamba2.init_mamba`; block positions drawn in order.
    An audio model (``num_codebooks`` K > 0) has a (K, V, D) embedding
    and a (K, D, V) head, one table per codebook."""
    cfg.validate()
    P = cfg.pattern_period
    n = cfg.num_layers // P
    dt = cfg.torch_dtype
    K = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    params = {
        "embed": {"tokens": embed_init(K + (cfg.vocab_size, cfg.d_model), dt,
                                       generator, device)},
        "blocks": {f"pos{pos}": _init_block(cfg, cfg.layer_kind(pos),
                                            cfg.layer_is_moe(pos), n,
                                            generator, device)
                   for pos in range(P)},
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(K + (cfg.d_model, cfg.vocab_size), dt,
                                       generator, device)
    return params


# ==========================================================================
# embedding / head
# ==========================================================================

def embed_tokens(params, cfg, tokens: torch.Tensor,
                 shard=None) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D); for an audio model tokens (B, S, K) ->
    the sum of the K codebooks' lookups, added in order k = 0 ... K-1
    (MusicGen's summed input embeddings).  On the mesh each rank looks up
    its vocabulary rows of each table (the others zero) and the sum is
    all-reduced over ``model``."""
    emb = params["embed"]["tokens"]
    Vl = emb.shape[-2]
    split = shard is not None and Vl != cfg.vocab_size

    def lookup(table, tok):
        if not split:
            return table[tok.long()]
        rel = tok.long() - shard.mi * Vl
        mine = (rel >= 0) & (rel < Vl)
        return table[rel.clamp(0, Vl - 1)] * mine[..., None].to(table.dtype)

    if cfg.num_codebooks:
        x = lookup(emb[0], tokens[..., 0])
        for k in range(1, cfg.num_codebooks):
            x = x + lookup(emb[k], tokens[..., k])
    else:
        x = lookup(emb, tokens)
    return parallel.reduce_from(x, shard.model) if split else x


def lm_head(params, cfg, h: torch.Tensor, shard=None) -> torch.Tensor:
    """(B, S, D) -> logits (B, S, V), or (B, S, K, V) for an audio model
    (one head per codebook).  On the mesh the whole V, gathered over
    ``model`` from each rank's columns (:func:`lm_head_local`)."""
    logits = lm_head_local(params, cfg, h)
    if shard is not None:
        return parallel.gather(logits, shard.model, -1)
    return logits


def _vocab_cols(params, cfg) -> int:
    """The head's vocabulary columns on this rank."""
    if cfg.tie_embeddings:
        return params["embed"]["tokens"].shape[-2]
    return params["lm_head"].shape[-1]


def lm_head_local(params, cfg, h: torch.Tensor) -> torch.Tensor:
    """This rank's vocabulary columns of the logits (its rows of a tied
    embedding, its columns of the head; per codebook for an audio model);
    all of them off the mesh."""
    if cfg.tie_embeddings:
        w = params["embed"]["tokens"]
        if cfg.num_codebooks:
            return torch.einsum("bsd,kvd->bskv", h, w)
        return h @ w.T
    w = params["lm_head"]
    if cfg.num_codebooks:
        return torch.einsum("bsd,kdv->bskv", h, w)
    return h @ w


# ==========================================================================
# the block stack
# ==========================================================================

def _index(tree, i: int):
    """Period ``i`` of a tree of stacked leaves (views, no copies)."""
    if isinstance(tree, dict):
        return {key: _index(val, i) for key, val in tree.items()}
    return tree[i]


def _apply_block(cfg, kind: str, p: dict, x: torch.Tensor, positions, *,
                 lora, rescaler, lora_scale, k, cache=None, cache_pos=None,
                 return_cache=False, slot_mask=None, block_table=None,
                 page_span=None, dispatch=None, suffix_readonly=False,
                 num_groups=1, shard=None):
    """One block position.  Returns (x, MoE aux or None, the position's
    new cache ``{"attn": ...}`` / ``{"ssm": ...}`` or None).  A decode
    step (a cache and S == 1) writes a Mamba position's state rows in
    place, as attention writes its K/V."""
    lg = lora or {}
    h = rms_norm(p["mixer_norm"], x, cfg.rms_eps)
    new_cache = None
    if kind == "attn":
        h, mc = attn_mod.apply_attention(
            p["attn"], cfg, h, positions, lora=lg.get("attn"),
            lora_scale=lora_scale, cache=(cache or {}).get("attn"),
            cache_pos=cache_pos, return_cache=return_cache,
            block_table=block_table, page_span=page_span,
            suffix_readonly=suffix_readonly, shard=shard)
        if mc is not None:
            new_cache = {"attn": mc}
    else:
        c = (cache or {}).get("ssm")
        h, mc = ssm_mod.apply_mamba(p["ssm"], cfg, h, lora=lg.get("ssm"),
                                    lora_scale=lora_scale, cache=c,
                                    return_cache=return_cache, shard=shard)
        if c is not None and x.shape[1] == 1:
            for leaf in ("conv", "ssm"):
                c[leaf].copy_(mc[leaf])
            mc = c
        if mc is not None:
            new_cache = {"ssm": mc}
    x = x + h
    aux = None
    if "moe" in p:
        h2 = rms_norm(p["ffn_norm"], x, cfg.rms_eps)
        h2, aux = moe_mod.apply_moe(p["moe"], cfg, h2, k=k,
                                    rescaler=rescaler, lora=lg.get("moe"),
                                    lora_scale=lora_scale,
                                    slot_mask=slot_mask, dispatch=dispatch,
                                    num_groups=num_groups, shard=shard)
        x = x + h2
    elif "ffn" in p:
        h2 = rms_norm(p["ffn_norm"], x, cfg.rms_eps)
        x = x + apply_ffn(p["ffn"], h2, lg.get("ffn"), lora_scale,
                          shard=shard)
    return x, aux, new_cache


def _run_stack(cfg, params, x, positions, *, trainable, k, cache=None,
               cache_pos=None, return_cache=False, slot_mask=None,
               block_table=None, page_span=None, dispatch=None,
               suffix_readonly=False, num_groups=1, remat=False,
               remat_chunk=0, shard=None):
    """The layer stack as a loop over the leading n_periods axis, each
    period running its P positions in order; position ``pos{j}`` of
    period ``i`` reads views of its stacked weights, LoRA adapters
    (``trainable["lora"]["blocks"]["pos{j}"]``), rescaler and cache.
    Returns (h, counts {pos{j}: (n_periods, E)} per MoE position, new
    caches {pos{j}: [per-period cache dicts]}).

    ``remat`` (cacheless calls only, as the reference's): each period runs
    under ``torch.utils.checkpoint``, so autograd keeps only its input and
    recomputes it in the backward pass; with ``1 < remat_chunk <
    n_periods`` the periods go in groups of ``remat_chunk`` (lowered to a
    divisor of n_periods) checkpointed at both levels, the reference's
    two-level (√L) scheme: n_periods/g + g saved inputs for one more
    forward.  Loss and gradients are those of the plain loop.

    ``shard.act_mode`` "dmodel" or "sp" (cacheless calls on a ``model``
    axis of more than one rank): between periods the residual stream is
    held as this rank's slice of D or of S (``parallel.split_to`` at a
    period's end, ``gather_from`` at its start; the reference's ``act_fn``
    on its scan carry), so a checkpoint keeps 1/M of each saved input;
    inside a period the blocks run on the whole tensor, as the
    reference's ``inner_act_fn`` gathers it.  The collectives only move
    data: loss and gradients are the "batch" mode's, bit for bit."""
    trainable = trainable or {}
    lora_blocks = (trainable.get("lora") or {}).get("blocks") or {}
    rescalers = trainable.get("rescaler") or {}
    lora_scale = cfg.lora.scale if cfg.lora.enabled else 0.0
    k = k if k is not None else cfg.moe.top_k
    P = cfg.pattern_period
    n = cfg.num_layers // P
    keys = [f"pos{j}" for j in range(P)]
    kinds = [cfg.layer_kind(j) for j in range(P)]
    blocks = params["blocks"]
    caches = cache or {}

    def period(i, x):
        counts, new = {}, {}
        for key, kind in zip(keys, kinds):
            lb, r, c = lora_blocks.get(key), rescalers.get(key), \
                caches.get(key)
            x, aux, nc = _apply_block(
                cfg, kind, _index(blocks[key], i), x, positions,
                lora=None if not lb else _index(lb, i),
                rescaler=None if r is None else r[i],
                lora_scale=lora_scale, k=k,
                cache=None if c is None else _index(c, i),
                cache_pos=cache_pos, return_cache=return_cache,
                slot_mask=slot_mask, block_table=block_table,
                page_span=page_span, dispatch=dispatch,
                suffix_readonly=suffix_readonly, num_groups=num_groups,
                shard=shard)
            if aux is not None:
                counts[key] = aux.activation_counts
            if nc is not None:
                new[key] = nc
        return x, counts, new

    cacheless = cache is None and not return_cache
    split = (cacheless and shard is not None and shard.model is not None
             and shard.act_mode != "batch")
    step = period
    if split:
        dim = -1 if shard.act_mode == "dmodel" else 1

        def step(i, x):
            x, counts, new = period(i, parallel.gather_from(x, shard.model,
                                                            dim))
            return parallel.split_to(x, shard.model, dim), counts, new

        x = parallel.split_to(x, shard.model, dim)

    per_counts, per_cache = [], []
    if not remat or not cacheless:
        for i in range(n):
            x, c, nc = step(i, x)
            per_counts.append(c)
            per_cache.append(nc)
    elif 1 < remat_chunk < n:
        g = remat_chunk
        while n % g:
            g -= 1

        def group(x, g0):
            cs = []
            for i in range(g0, g0 + g):
                x, c, _ = _checkpoint(step, i, x)
                cs.append(c)
            return x, cs

        for g0 in range(0, n, g):
            x, cs = _checkpoint(group, x, g0)
            per_counts.extend(cs)
    else:
        for i in range(n):
            x, c, _ = _checkpoint(step, i, x)
            per_counts.append(c)
    if split:
        x = parallel.gather_from(x, shard.model, dim)
    out_counts = {key: torch.stack([c[key] for c in per_counts])
                  for key in keys if per_counts and key in per_counts[0]}
    out_cache = {key: [nc[key] for nc in per_cache]
                 for key in keys if per_cache and key in per_cache[0]}
    return x, out_counts, out_cache


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ==========================================================================
# training entry points: forward and the LM loss
# ==========================================================================

def forward_hidden(cfg, params, tokens: torch.Tensor, *, trainable=None,
                   k=None, positions=None, dispatch=None, remat=False,
                   remat_chunk=0, num_groups=1, shard=None):
    """tokens (B, S), or (B, S, K) for an audio model -> (final hidden
    states (B, S, D) after the final norm, activation counts {pos{j}:
    (n_periods, E)} per MoE position).
    MoE layers dispatch on ``capacity`` unless told otherwise, as in the
    reference, over ``num_groups`` routing groups.  ``remat`` / ``remat_chunk``: layer
    checkpointing (:func:`_run_stack`).  ``shard``: the card mesh (the
    module docstring)."""
    S = tokens.shape[1]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, shard)
    h, counts, _ = _run_stack(cfg, params, x, positions, trainable=trainable,
                              k=k, dispatch=dispatch, num_groups=num_groups,
                              remat=remat, remat_chunk=remat_chunk,
                              shard=shard)
    return rms_norm(params["final_norm"], h, cfg.rms_eps), counts


def forward(cfg, params, tokens: torch.Tensor, *, trainable=None, k=None,
            positions=None, dispatch=None):
    """tokens -> (logits (B, S, V) or, for an audio model, (B, S, K, V),
    activation counts)."""
    h, counts = forward_hidden(cfg, params, tokens, trainable=trainable,
                               k=k, positions=positions, dispatch=dispatch)
    return lm_head(params, cfg, h), counts


def chunked_ce_loss(cfg, params, h: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: int = 512, shard=None) -> torch.Tensor:
    """Masked mean cross-entropy over sequence chunks: h (B, S, D); labels
    (B, S), or (B, S, K) for an audio model; mask (B, S) 0/1.  Each
    chunk's logits are formed in fp32 and summed into (total, count) in
    chunk order, as the reference's scan.  With codebooks a position's
    NLL is the mean of its K codebooks' NLLs, taken before the mask.

    On the mesh (``shard``) the logits are this rank's vocabulary columns
    and the NLL is ``parallel.vocab_parallel_nll``'s; the loss is the
    global masked mean: the sum and the count are each all-reduced over
    the batch axes (not a mean of the ranks' means); with codebooks each
    codebook's NLL is vocabulary-parallel and their mean is taken as on
    one card."""
    if shard is not None and _vocab_cols(params, cfg) != cfg.vocab_size:
        return _vocab_parallel_ce(cfg, params, h, labels, mask, chunk, shard)
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=_F32, device=h.device)
    tot = torch.zeros((), dtype=_F32, device=h.device)
    cnt = torch.zeros((), dtype=_F32, device=h.device)
    for c0 in range(0, S, chunk):
        logits = lm_head(params, cfg, h[:, c0:c0 + chunk]).to(_F32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + chunk, ..., None].long())[..., 0]
        nll = lse - gold                          # (B, chunk[, K])
        if nll.dim() == 3:
            nll = nll.mean(-1)
        mm = mask[:, c0:c0 + chunk].to(_F32)
        tot = tot + (nll * mm).sum()
        cnt = cnt + mm.sum()
    if shard is not None:
        tot = parallel.reduce_from(tot, shard.batch)
        cnt = parallel.reduce_from(cnt, shard.batch)
    return tot / torch.clamp(cnt, min=1.0)


def _vocab_parallel_ce(cfg, params, h, labels, mask, chunk, sh):
    """:func:`chunked_ce_loss` over vocabulary-split logits."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=_F32, device=h.device)
    hc = parallel.copy_to(h, sh.model)
    tot = torch.zeros((), dtype=_F32, device=h.device)
    cnt = torch.zeros((), dtype=_F32, device=h.device)
    for c0 in range(0, S, chunk):
        logits = lm_head_local(params, cfg, hc[:, c0:c0 + chunk]).to(_F32)
        Vl = logits.shape[-1]
        lab = labels[:, c0:c0 + chunk]
        nll = parallel.vocab_parallel_nll(
            logits.reshape(-1, Vl), lab.reshape(-1), sh.mi * Vl,
            sh.model).reshape(lab.shape)              # (B, chunk[, K])
        if nll.dim() == 3:
            nll = nll.mean(-1)
        mm = mask[:, c0:c0 + chunk].to(_F32)
        tot = tot + (nll * mm).sum()
        cnt = cnt + mm.sum()
    tot = parallel.reduce_from(tot, sh.batch)
    cnt = parallel.reduce_from(cnt, sh.batch)
    return tot / torch.clamp(cnt, min=1.0)


@obs_trace.traced("model.lm_loss", device=True)
def lm_loss(cfg, params, tokens, labels, mask=None, *, trainable=None,
            k=None, dispatch=None, remat=False, remat_chunk=0, num_groups=1,
            shard=None):
    """Full LM loss.  Returns (loss, activation counts).  On the mesh
    (``shard``) the loss is the global batch's and the counts this rank's
    tokens'."""
    h, counts = forward_hidden(cfg, params, tokens, trainable=trainable,
                               k=k, dispatch=dispatch, remat=remat,
                               remat_chunk=remat_chunk, num_groups=num_groups,
                               shard=shard)
    return chunked_ce_loss(cfg, params, h, labels, mask,
                           shard=shard), counts


# ==========================================================================
# serving entry points
# ==========================================================================

def cache_len_for(cfg, seq_len: int) -> int:
    if cfg.attention_window > 0:
        return min(cfg.attention_window, seq_len)
    return seq_len


def _cache(cfg, attn_shape: tuple, rows: int, device) -> PyTree:
    """Zeroed decode cache, leading axis n_periods: K and V of shape
    ``attn_shape`` at each attention position (model dtype), ``rows`` rows
    of Mamba state at each Mamba position (``conv`` and ``ssm`` in fp32,
    as the reference's pools hold them)."""
    P = cfg.pattern_period
    n = cfg.num_layers // P
    cache = {}
    for j in range(P):
        if cfg.layer_kind(j) == "attn":
            z = dict(dtype=cfg.torch_dtype, device=device)
            cache[f"pos{j}"] = {"attn": {
                leaf: torch.zeros((n,) + attn_shape, **z)
                for leaf in ("k", "v")}}
        else:
            base = ssm_mod.init_mamba_cache(cfg, rows, device=device)
            cache[f"pos{j}"] = {"ssm": {leaf: t.new_zeros((n,) + t.shape)
                                        for leaf, t in base.items()}}
    return cache


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> PyTree:
    """Zeroed slotted decode cache: per attention position (n_periods,
    batch, cache_len_for(seq_len), KV, hd) K and V, per Mamba position
    (n_periods, batch, ...) state rows."""
    return _cache(cfg, (batch, cache_len_for(cfg, seq_len), cfg.n_kv_heads,
                        cfg.head_dim_), batch, device)


def init_paged_cache(cfg, num_slots: int, num_blocks: int, block_size: int,
                     device="cuda") -> PyTree:
    """Zeroed block-paged decode cache (leading axis n_periods): attention
    K/V live in a pool of ``num_blocks + 1`` blocks, block 0 being the
    trash block unallocated table entries point at; a Mamba position's
    state is O(1) per request, so it stays per row (``num_slots`` rows),
    as in :func:`init_cache`."""
    return _cache(cfg, (num_blocks + 1, block_size, cfg.n_kv_heads,
                        cfg.head_dim_), num_slots, device)


def _stacked(per_period: list, kind: str) -> dict:
    """A position's per-period cache dicts stacked on a leading axis."""
    leaves = per_period[0][kind]
    return {kind: {leaf: torch.stack([c[kind][leaf] for c in per_period])
                   for leaf in leaves}}


def grow_cache(cache: PyTree, depth: int) -> PyTree:
    """A contiguous decode cache with its attention leaves (n, B, Sc, KV,
    hd) zero-padded to ``depth`` columns where shallower; Mamba state as
    it is."""
    out = {}
    for key, c in cache.items():
        if "attn" not in c:
            out[key] = c
            continue
        kv = {}
        for leaf, t in c["attn"].items():
            if depth > t.shape[2]:
                t = torch.cat([t, t.new_zeros(t.shape[:2] + (
                    depth - t.shape[2],) + t.shape[3:])], dim=2)
            kv[leaf] = t
        out[key] = {"attn": kv}
    return out


@obs_trace.traced("model.prefill", device=True)
def prefill(cfg, params, tokens: torch.Tensor, *, trainable=None, k=None,
            cache_len: Optional[int] = None, slot_mask=None,
            dispatch: str = "ragged", num_groups: int = 1, shard=None):
    """Forward pass that also returns the contiguous decode cache.
    Returns (logits_last (B,1,V), cache): attention leaves (n_periods, B,
    cache_len_for(cache_len or S), KV, hd), zero-padded past the prompt
    (with a sliding window ``w <= S`` the leaves are the ring of
    :func:`attention.apply_attention`: w columns, token ``t`` at ``t %
    w``, no padding); Mamba leaves the state after the prompt, ``conv``
    in the model's dtype and ``ssm`` in fp32 (n_periods, B, ...).
    ``num_groups``: the one-hot dispatch modes' routing groups
    (:func:`moe_layer.apply_moe`).  On the mesh (``shard``): this rank's
    rows and slice of the sequence of the cache, every KV head
    (``launch/sharding.cache_specs``; ``cache_len`` is not taken there:
    ``launch/sharding.grow_cache`` deepens a sharded cache), the logits
    whole."""
    B, S = tokens.shape[:2]
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, shard)
    h, _, new = _run_stack(cfg, params, x, positions, trainable=trainable,
                           k=k, return_cache=True, slot_mask=slot_mask,
                           dispatch=dispatch, num_groups=num_groups,
                           shard=shard)
    cache = {key: _stacked(per, "ssm" if "ssm" in per[0] else "attn")
             for key, per in new.items()}
    if shard is None:
        cache = grow_cache(cache, cache_len_for(cfg, cache_len or S))
    elif cache_len is not None:
        raise ValueError("on the mesh the prefill's cache is S deep: "
                         "launch/sharding.grow_cache deepens it")
    h = rms_norm(params["final_norm"], h[:, -1:], cfg.rms_eps)
    return lm_head(params, cfg, h, shard), cache


@obs_trace.traced("model.prefill_suffix", device=True)
def prefill_suffix(cfg, params, tokens: torch.Tensor, prefix_len,
                   suffix_len, cache, block_table: torch.Tensor, *,
                   page_span: int, trainable=None, k=None, slot_mask=None,
                   dispatch: str = "ragged", num_groups: int = 1):
    """Suffix-only cached prefill against a block-paged pool.

    A request whose prompt head is already cached pays compute for the
    unmatched suffix only: ``tokens`` (B, S) holds each row's suffix
    (padded to S), RoPE'd and attended at absolute positions
    ``prefix_len[b] + s``, reading the attached prefix pages through
    ``block_table`` read-only.  MoE routing runs over the S suffix
    columns only; a (B, S) ``slot_mask`` with per-row ``k`` routes the
    padding columns to no expert, so ragged dispatch moves
    ``sum(suffix_len · k)`` rows.

    ``prefix_len``/``suffix_len``: (B,) ints — the cached-prefix offset
    and the real suffix length; logits come from column
    ``suffix_len - 1``.  Returns (logits (B, 1, V), piece) with piece
    leaves (n_periods, B, S, KV, hd) whose column ``c`` holds prompt
    position ``prefix_len[b] + c``: what ``BlockPool.write(...,
    starts=, piece_col0=)`` scatters.  ``num_groups``: as in
    :func:`prefill`.  Attention-only models: a Mamba layer's state at
    the suffix start cannot be rebuilt from cached K/V."""
    if not _attention_only(cfg):
        raise ValueError("prefill_suffix requires attention-only models")
    B, S = tokens.shape[:2]
    dev = tokens.device
    prefix_len = torch.as_tensor(prefix_len, device=dev).long()
    suffix_len = torch.as_tensor(suffix_len, device=dev).long()
    positions = prefix_len[:, None] + torch.arange(S, device=dev)[None, :]
    x = embed_tokens(params, cfg, tokens)
    h, _, new = _run_stack(cfg, params, x, positions, trainable=trainable,
                           k=k, cache=cache, cache_pos=prefix_len,
                           return_cache=True, slot_mask=slot_mask,
                           block_table=block_table, page_span=page_span,
                           dispatch=dispatch, suffix_readonly=True,
                           num_groups=num_groups)
    piece = {key: _stacked(per, "attn") for key, per in new.items()}
    col = torch.clamp(suffix_len - 1, 0, S - 1)
    last = h[torch.arange(B, device=dev), col]
    h = rms_norm(params["final_norm"], last[:, None], cfg.rms_eps)
    return lm_head(params, cfg, h), piece


@obs_trace.traced("model.decode_step", device=True)
def decode_step(cfg, params, cache, tokens: torch.Tensor, pos, *,
                trainable=None, k=None, slot_mask=None, block_table=None,
                page_span=None, dispatch: str = "ragged",
                return_counts: bool = False, shard=None):
    """One decode step over the whole slot batch.  tokens: (B, S); pos:
    (B,) per-row positions (or a scalar).  ``S`` is normally 1; ``S > 1``
    is the speculative verify step (attention-only models: a Mamba
    layer's state cannot roll back to a rejected position): the S tokens
    are teacher-forced at positions ``pos .. pos+S-1`` against the cache
    (read before the window's K/V are written) and logits for every
    window position come back.  ``block_table`` (B, max_blocks) with
    ``page_span``: the attention leaves are the block-paged pool; without
    one they are the slotted rows of :func:`init_cache`.  Mamba state
    rows are per slot in both.  The cache is written in place.  ``k``:
    int or per-slot tuple; ``slot_mask``: (B,) 0/1 rows in use.  Returns
    (logits (B,S,V), cache) [+ counts {pos{j}: (n_periods, E)}].  On the
    mesh (``shard``, its ``cache_len`` the cache's global depth): the
    slotted cache's rows and slice of the sequence of this rank
    (``launch/sharding.cache_specs``), a static ``k``, one-hot dispatch."""
    x = embed_tokens(params, cfg, tokens, shard)
    B, S = x.shape[0], x.shape[1]
    if S > 1 and not _attention_only(cfg):
        raise ValueError("the S > 1 verify step requires attention-only "
                         "models")
    pos = torch.as_tensor(pos, device=x.device)
    base = pos[:, None] if pos.dim() == 1 else pos.expand(B, 1)
    positions = base + torch.arange(S, device=x.device)[None, :]
    h, counts, _ = _run_stack(
        cfg, params, x, positions, trainable=trainable, k=k, cache=cache,
        cache_pos=pos, return_cache=True, slot_mask=slot_mask,
        block_table=block_table, page_span=page_span, dispatch=dispatch,
        shard=shard)
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    logits = lm_head(params, cfg, h, shard)
    if return_counts:
        return logits, cache, counts
    return logits, cache


def draft_window(cfg, params, cache, tok0: torch.Tensor, pos, draws, *,
                 sample_fn, window: int, trainable=None, k=None,
                 block_table=None, page_span=None, dispatch: str = "ragged"):
    """W reduced-k decode steps for the speculative draft, without writing
    the cache.

    Each step's K/V go into a per-layer window buffer (B, W, KV, hd) and
    attention reads the cache read-only (``attention.apply_draft_attention``);
    for the block-paged pool each layer's prefix pages are gathered once
    per window.  The next token is picked on the device by ``sample_fn(
    logits (B, V) fp32, draws[j]) -> (B,)``, so the window needs no host
    sync.  tok0: (B, 1) first window token per row; pos: (B,) window start
    (each row's cache_pos); draws: (W, B) the sampler's uniforms (ignored
    by a greedy ``sample_fn``); ``k``: the scalar draft budget (every row
    drafts at it: free rows ride along, and ragged dispatch keeps rows
    apart).  Attention-only models with a non-wrapping cache (the engine
    guards both).  Returns (draft logits (W, B, V) fp32, draft tokens
    (W, B)), both on the device."""
    if not _attention_only(cfg):
        raise ValueError("draft_window requires attention-only models")
    trainable = trainable or {}
    lora_blocks = (trainable.get("lora") or {}).get("blocks") or {}
    rescalers = trainable.get("rescaler") or {}
    lora_scale = cfg.lora.scale if cfg.lora.enabled else 0.0
    kk = k if k is not None else cfg.moe.top_k
    P = cfg.pattern_period
    n = cfg.num_layers // P
    keys = [f"pos{j}" for j in range(P)]
    dev = tok0.device
    pos = torch.as_tensor(pos, device=dev).long()
    B = tok0.shape[0]
    # per (period, position): the read-only prefix and the window buffer
    static, win = {}, {}
    for i in range(n):
        for key in keys:
            kv = cache[key]["attn"]
            if block_table is not None:
                static[i, key] = {leaf: attn_mod.paged_gather(
                    kv[leaf][i], block_table, page_span)
                    for leaf in ("k", "v")}
            else:
                static[i, key] = {leaf: kv[leaf][i] for leaf in ("k", "v")}
            win[i, key] = {leaf: torch.zeros(
                (B, window, cfg.n_kv_heads, cfg.head_dim_),
                dtype=cfg.torch_dtype, device=dev) for leaf in ("k", "v")}
    tok = tok0
    qs, toks = [], []
    for j in range(window):
        x = embed_tokens(params, cfg, tok)                        # (B, 1, D)
        positions = pos[:, None] + j
        for i in range(n):
            for key in keys:
                p = _index(params["blocks"][key], i)
                lb, r = lora_blocks.get(key), rescalers.get(key)
                lg = {} if not lb else _index(lb, i)
                h1 = rms_norm(p["mixer_norm"], x, cfg.rms_eps)
                x = x + attn_mod.apply_draft_attention(
                    p["attn"], cfg, h1, positions, j, win[i, key],
                    static[i, key], pos, lora=lg.get("attn"),
                    lora_scale=lora_scale)
                if "moe" in p:
                    h2 = rms_norm(p["ffn_norm"], x, cfg.rms_eps)
                    h2, _ = moe_mod.apply_moe(
                        p["moe"], cfg, h2, k=kk,
                        rescaler=None if r is None else r[i],
                        lora=lg.get("moe"), lora_scale=lora_scale,
                        dispatch=dispatch)
                    x = x + h2
                elif "ffn" in p:
                    h2 = rms_norm(p["ffn_norm"], x, cfg.rms_eps)
                    x = x + apply_ffn(p["ffn"], h2, lg.get("ffn"),
                                      lora_scale)
        h = rms_norm(params["final_norm"], x, cfg.rms_eps)
        logits = lm_head(params, cfg, h)[:, 0].float()
        tok = sample_fn(logits, draws[j]).to(tok0.dtype)[:, None]
        qs.append(logits)
        toks.append(tok[:, 0])
    return torch.stack(qs), torch.stack(toks)
