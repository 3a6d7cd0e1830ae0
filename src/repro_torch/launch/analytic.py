"""Analytic per-device FLOPs and HBM-traffic models for the roofline's
compute and memory terms: a line-for-line port of
``repro/launch/analytic.py``.

The compute and memory terms come from the same first-principles
accounting the paper's Table 1 uses (``core/flops.py``), extended with a
traffic model; the collective term comes from the collectives the step
makes, counted while it runs (``launch/dryrun.py``,
``models/parallel.py``'s counters).  Pure arithmetic on the config, so it
equals the reference's to the bit.

All quantities returned are PER DEVICE per step.
"""
from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ModelConfig, ShapeConfig
from ..core import flops as F

DT = 2          # bf16 bytes


def device_flops(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                 knobs: Dict[str, Any]) -> float:
    """Executed FLOPs per device per step (incl. backward + remat)."""
    k = knobs.get("k") or (cfg.moe.top_k if cfg.moe.enabled else None)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        fwd = F.flops_detailed(cfg, tokens, shape.seq_len, k=k,
                               lora_rank=cfg.lora.rank)
        # fwd + 2×bwd + (remat ≈ one extra fwd; two-level remat adds one
        # more re-forward for the outer checkpoint level)
        mult = 3.0
        if knobs.get("remat", True):
            mult = 5.0 if knobs.get("remat_chunk") else 4.0
        return fwd * mult / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return F.flops_detailed(cfg, tokens, shape.seq_len, k=k,
                                lora_rank=cfg.lora.rank) / chips
    # decode: 1 token/request; per-layer context = cache length
    tokens = shape.global_batch
    ctx = _cache_len(cfg, shape.seq_len)
    f = F.flops_detailed(cfg, tokens, 1, k=k, lora_rank=cfg.lora.rank)
    # flops_detailed's attention-context term used seq/2=0.5; replace with
    # the true cache-read matmul flops
    hd = cfg.head_dim_
    attn_layers = sum(1 for l in range(cfg.num_layers)
                      if cfg.layer_kind(l) == "attn")
    f += 2.0 * tokens * ctx * cfg.n_heads * hd * 2 * attn_layers
    return f / chips


def _cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.attention_window > 0:
        return min(cfg.attention_window, seq_len)
    return seq_len


def _param_bytes(cfg: ModelConfig) -> float:
    return F.count_params(cfg)["total"] * DT


def _cache_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    clen = _cache_len(cfg, seq_len)
    hd = cfg.head_dim_
    total = 0.0
    for l in range(cfg.num_layers):
        if cfg.layer_kind(l) == "attn":
            total += 2 * batch * clen * cfg.n_kv_heads * hd * DT
        else:
            from ..models.mamba2 import mamba_dims
            d = mamba_dims(cfg)
            total += batch * (d["conv_dim"] * (d["conv_width"] - 1) * DT
                              + d["n_heads"] * d["head_dim"] * d["d_state"]
                              * 4)
    return total


def device_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                 knobs: Dict[str, Any]) -> float:
    """HBM traffic per device per step (first-order: weight reads +
    activation reads/writes + cache traffic; fp32 grad-accum buffers)."""
    p_local = _param_bytes(cfg) / chips
    d = cfg.d_model
    L = cfg.num_layers

    if shape.kind == "train":
        n_micro = knobs.get("n_micro", 1)
        mb_tok_local = shape.global_batch * shape.seq_len / (n_micro * chips)
        # weights: read on fwd, bwd, and the remat re-forward, per microbatch
        w = 3.0 * n_micro * p_local
        # activations: ~12 touches of the residual stream per layer
        # (reads+writes over fwd, remat re-fwd, bwd), per microbatch
        a = n_micro * L * 12.0 * mb_tok_local * d * DT
        # flash attention KV re-streaming: each of nq query blocks re-reads
        # the visible KV span (≈S/2 causal avg)
        kv_w = cfg.n_kv_heads * cfg.head_dim_ * 2
        nq = max(shape.seq_len // 512, 1)
        attn_layers = sum(1 for l in range(L) if cfg.layer_kind(l) == "attn")
        a += (n_micro * attn_layers * (mb_tok_local / shape.seq_len)
              * nq * (shape.seq_len / 2) * kv_w * DT * 3)   # fwd+remat+bwd
        # LoRA grads + Adam state (fp32 accumulate + m + v, read+write)
        g = knobs.get("trainable_bytes", 0) / chips * (2 / DT) * 6
        return w + a + g

    tok_local = shape.global_batch * (shape.seq_len
                                      if shape.kind == "prefill" else 1)
    tok_local /= chips
    if shape.kind == "prefill":
        w = p_local
        a = L * 8.0 * tok_local * d * DT
        kv_w = cfg.n_kv_heads * cfg.head_dim_ * 2
        nq = max(shape.seq_len // 512, 1)
        attn_layers = sum(1 for l in range(L) if cfg.layer_kind(l) == "attn")
        a += (attn_layers * (tok_local / shape.seq_len) * nq
              * (shape.seq_len / 2) * kv_w * DT)
        c = _cache_bytes(cfg, shape.global_batch, shape.seq_len) / chips
        return w + a + c
    # decode: every weight + the whole cache are read once per token
    c = _cache_bytes(cfg, shape.global_batch, shape.seq_len) / chips
    a = L * 8.0 * tok_local * d * DT
    return p_local + c + a


def model_flops_global(cfg: ModelConfig, shape: ShapeConfig,
                       knobs: Dict[str, Any]) -> float:
    """MODEL_FLOPS: 6·N_active·D (train) / 2·N_active·D (inference)."""
    k = knobs.get("k") or (cfg.moe.top_k if cfg.moe.enabled else None)
    n_active = F.count_params(cfg, k=k)["active"]
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
