"""Analytic parameter / FLOPs accounting (a copy of
``repro/core/flops.py``: plain arithmetic on the config).

Reproduces the paper's Table 1 (the FLOPs-based limitation analysis of rank
compression vs FLAME's expert reduction) and supplies the
``MODEL_FLOPS = 6·N_active·D`` terms the roofline analysis needs.

Two conventions:
  * ``flops_paper_convention`` — 2 FLOPs per *active* parameter per token
    (the convention that reproduces the paper's 153.6/179.2/230.4/332.8 B
    grid exactly: 2 · P_a · T with T = 128);
  * ``flops_detailed``        — per-matmul accounting (incl. router, lm head,
    attention score/value matmuls, LoRA bypass) for honest roofline numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..configs.base import ModelConfig
from ..models.mamba2 import mamba_dims


# --------------------------------------------------------------------------
# parameter counting
# --------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim_
    return (cfg.d_model * cfg.n_heads * hd          # wq
            + 2 * cfg.d_model * cfg.n_kv_heads * hd  # wk, wv
            + cfg.n_heads * hd * cfg.d_model)        # wo


def _ffn_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff if cfg.d_ff else 0


def _expert_params_each(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.moe.d_expert


def _shared_params(cfg: ModelConfig) -> int:
    m = cfg.moe
    if m.num_shared_experts <= 0:
        return 0
    dsh = m.d_shared_expert or m.d_expert * m.num_shared_experts
    return 3 * cfg.d_model * dsh


def _mamba_params(cfg: ModelConfig) -> int:
    d = mamba_dims(cfg)
    return (cfg.d_model * d["in_dim"] + d["conv_dim"] * d["conv_width"]
            + d["d_inner"] * cfg.d_model + 3 * d["n_heads"] + d["d_inner"])


def count_params(cfg: ModelConfig, k: Optional[int] = None) -> Dict[str, int]:
    """Total and active parameter counts; ``k`` = activated experts."""
    k = k if k is not None else cfg.moe.top_k
    embed = cfg.vocab_size * cfg.d_model * max(cfg.num_codebooks, 1)
    head = 0 if cfg.tie_embeddings else embed
    total = embed + head + cfg.d_model  # final norm
    active = total
    for layer in range(cfg.num_layers):
        kind = cfg.layer_kind(layer)
        mixer = _attn_params(cfg) if kind == "attn" else _mamba_params(cfg)
        total += mixer + cfg.d_model
        active += mixer + cfg.d_model
        if cfg.layer_is_moe(layer):
            router = cfg.d_model * cfg.moe.num_experts
            ep = _expert_params_each(cfg)
            sp = _shared_params(cfg)
            total += router + cfg.moe.num_experts * ep + sp + cfg.d_model
            active += router + k * ep + sp + cfg.d_model
        elif cfg.d_ff:
            total += _ffn_params(cfg) + cfg.d_model
            active += _ffn_params(cfg) + cfg.d_model
    return {"total": total, "active": active, "embed": embed + head}


# --------------------------------------------------------------------------
# LoRA parameter counting
# --------------------------------------------------------------------------

def lora_param_counts(cfg: ModelConfig, rank: Optional[int] = None,
                      k: Optional[int] = None) -> Dict[str, int]:
    """Trainable adapter params, total (P̂) and active (P̂_a)."""
    r = rank if rank is not None else cfg.lora.rank
    k = k if k is not None else cfg.moe.top_k
    hd = cfg.head_dim_
    total = active = 0
    for layer in range(cfg.num_layers):
        kind = cfg.layer_kind(layer)
        if kind == "attn" and cfg.lora.target_attn:
            per = (r * (cfg.d_model + cfg.n_heads * hd)            # wq
                   + 2 * r * (cfg.d_model + cfg.n_kv_heads * hd)   # wk, wv
                   + r * (cfg.n_heads * hd + cfg.d_model))         # wo
            total += per
            active += per
        if kind == "ssm" and cfg.lora.target_ssm:
            d = mamba_dims(cfg)
            per = (r * (cfg.d_model + d["in_dim"])
                   + r * (d["d_inner"] + cfg.d_model))
            total += per
            active += per
        if cfg.layer_is_moe(layer) and cfg.lora.target_expert:
            per_exp = (2 * r * (cfg.d_model + cfg.moe.d_expert)    # w1, w3
                       + r * (cfg.moe.d_expert + cfg.d_model))     # w2
            total += cfg.moe.num_experts * per_exp
            active += k * per_exp
        elif cfg.d_ff and cfg.lora.target_ffn and not cfg.layer_is_moe(layer):
            per = 3 * r * (cfg.d_model + cfg.d_ff)
            total += per
            active += per
    return {"total": total, "active": active}


# --------------------------------------------------------------------------
# FLOPs
# --------------------------------------------------------------------------

def flops_paper_convention(cfg: ModelConfig, tokens: int,
                           k: Optional[int] = None,
                           lora_rank: Optional[int] = None) -> float:
    """2 FLOPs per active param per token (paper's Table 1/2 convention)."""
    p = count_params(cfg, k=k)
    extra = 0
    if lora_rank:
        extra = lora_param_counts(cfg, rank=lora_rank, k=k)["active"]
    return 2.0 * (p["active"] + extra) * tokens


def flops_detailed(cfg: ModelConfig, tokens: int, seq_len: int,
                   k: Optional[int] = None,
                   lora_rank: Optional[int] = None,
                   backward: bool = False) -> float:
    """Per-matmul forward FLOPs; ``backward=True`` multiplies matmul terms by
    3 (standard fwd:bwd = 1:2 for LoRA-frozen base it is closer to 1+2·ρ with
    ρ the trainable fraction, but activations still backprop through the
    frozen base, so 3× is the honest count)."""
    k = k if k is not None else cfg.moe.top_k
    r = lora_rank if lora_rank is not None else cfg.lora.rank
    hd = cfg.head_dim_
    f = 0.0
    for layer in range(cfg.num_layers):
        kind = cfg.layer_kind(layer)
        if kind == "attn":
            f += 2.0 * tokens * _attn_params(cfg)
            # score + value matmuls (causal ~ S/2 average context)
            ctx = (cfg.attention_window if cfg.attention_window
                   else seq_len / 2.0)
            f += 2.0 * tokens * ctx * cfg.n_heads * hd * 2
            if r and cfg.lora.target_attn:
                f += 2.0 * tokens * (
                    r * (cfg.d_model + cfg.n_heads * hd)
                    + 2 * r * (cfg.d_model + cfg.n_kv_heads * hd)
                    + r * (cfg.n_heads * hd + cfg.d_model))
        else:
            d = mamba_dims(cfg)
            f += 2.0 * tokens * (cfg.d_model * d["in_dim"]
                                 + d["d_inner"] * cfg.d_model)
            f += 2.0 * tokens * d["conv_dim"] * d["conv_width"]
            # SSD: intra-chunk (L) + state update (N) per head-dim element
            L = min(cfg.ssm.chunk_size, seq_len)
            f += 2.0 * tokens * d["d_inner"] * (L + 2 * d["d_state"])
            if r and cfg.lora.target_ssm:
                f += 2.0 * tokens * (r * (cfg.d_model + d["in_dim"])
                                     + r * (d["d_inner"] + cfg.d_model))
        if cfg.layer_is_moe(layer):
            f += 2.0 * tokens * cfg.d_model * cfg.moe.num_experts   # router
            f += 2.0 * tokens * k * _expert_params_each(cfg)
            f += 2.0 * tokens * _shared_params(cfg)
            if r and cfg.lora.target_expert:
                f += (2.0 * tokens * k
                      * (2 * r * (cfg.d_model + cfg.moe.d_expert)
                         + r * (cfg.moe.d_expert + cfg.d_model)))
        elif cfg.d_ff:
            f += 2.0 * tokens * _ffn_params(cfg)
            if r and cfg.lora.target_ffn:
                f += 2.0 * tokens * 3 * r * (cfg.d_model + cfg.d_ff)
    f += 2.0 * tokens * cfg.d_model * cfg.vocab_size * max(cfg.num_codebooks, 1)
    return 3.0 * f if backward else f


def model_flops_roofline(cfg: ModelConfig, tokens: int,
                         kind: str = "train") -> float:
    """MODEL_FLOPS for the roofline table: 6·N_active·D for training,
    2·N_active·D for inference (per forward)."""
    n_active = count_params(cfg)["active"]
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_active * tokens


# --------------------------------------------------------------------------
# Table 1 grid
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BudgetRow:
    budget: str
    method: str
    rank: int
    k: int
    params_total: int
    params_active: int
    train_total: int
    train_active: int
    flops: float


def table1_grid(cfg_dense: ModelConfig, cfg_moe: ModelConfig,
                tokens: int = 128):
    """The paper's Table 1: β1–β4 for HLoRA/FlexLoRA (rank compression) on
    dense + MoE, and FLAME (expert reduction) on MoE."""
    rows = []
    dense_ranks = {"b1": 40, "b2": 24, "b3": 16, "b4": 12}
    moe_ranks = {"b1": 20, "b2": 12, "b3": 8, "b4": 6}
    flame_k = {"b1": 8, "b2": 4, "b3": 2, "b4": 1}

    for b, rk in dense_ranks.items():
        p = count_params(cfg_dense)
        l = lora_param_counts(cfg_dense, rank=rk)
        rows.append(BudgetRow(b, "rank-compress/dense", rk, 0,
                              p["total"], p["active"], l["total"], l["active"],
                              flops_paper_convention(cfg_dense, tokens,
                                                     lora_rank=rk)))
    for b, rk in moe_ranks.items():
        p = count_params(cfg_moe, k=cfg_moe.moe.top_k)
        l = lora_param_counts(cfg_moe, rank=rk)
        rows.append(BudgetRow(b, "rank-compress/moe", rk, cfg_moe.moe.top_k,
                              p["total"], p["active"], l["total"], l["active"],
                              flops_paper_convention(cfg_moe, tokens,
                                                     lora_rank=rk)))
    for b, kk in flame_k.items():
        p = count_params(cfg_moe, k=kk)
        l = lora_param_counts(cfg_moe, rank=20, k=kk)
        rows.append(BudgetRow(b, "flame", 20, kk,
                              p["total"], p["active"], l["total"], l["active"],
                              flops_paper_convention(cfg_moe, tokens, k=kk,
                                                     lora_rank=20)))
    return rows
