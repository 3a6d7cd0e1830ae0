"""LoRA adapter trees, the federated trainable surface (port of
``repro/core/lora.py``: init, rescalers, the trainable tree, client-axis
stacking, and the baselines' rank surgery).

The adapter tree mirrors the base parameter tree: every targeted weight
``W`` of shape ``(..., d_in, d_out)`` (leading axes = periods and/or
experts) gets ``{"a": (..., d_in, r), "b": (..., r, d_out)}``, ``a``
Gaussian with σ = d_in^-½ and ``b`` zero, so a fresh adapter is an exact
no-op.  Per-expert adapters arise because the expert weights are stacked
on an expert axis.  FLAME's rescaler s_i sits beside the adapters in the
client's trainable tree; it is client-local and never aggregated.

``jax.random`` streams cannot be reproduced here: adapters are drawn from
an explicit ``torch.Generator`` with the reference's distributions, and a
test that needs the reference's exact adapters converts them
(``repro_torch.convert.lora_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..tree import leaves, tree_map

PyTree = Any
_F32 = torch.float32

# weight names eligible for adapters, per block sub-module
_TARGETS = {
    "attn": ("wq", "wk", "wv", "wo"),
    "ffn": ("w1", "w2", "w3"),
    "moe.experts": ("w1", "w2", "w3"),
    "moe.shared": ("w1", "w2", "w3"),
    "ssm": ("in_proj", "out_proj"),
}


def _module_enabled(cfg, module: str) -> bool:
    lc = cfg.lora
    return {
        "attn": lc.target_attn,
        "ffn": lc.target_ffn,
        "moe.experts": lc.target_expert,
        "moe.shared": lc.target_ffn,
        "ssm": lc.target_ssm,
    }[module]


def _init_pair(generator: torch.Generator, w: torch.Tensor, rank: int) -> dict:
    """Adapter for a stacked weight (..., d_in, d_out): ``a`` drawn in fp32
    and cast to the weight's dtype, ``b`` zero."""
    lead = tuple(w.shape[:-2])
    d_in, d_out = w.shape[-2:]
    a = torch.randn(lead + (d_in, rank), dtype=torch.float32,
                    device=w.device, generator=generator) * d_in ** -0.5
    return {"a": a.to(w.dtype),
            "b": torch.zeros(lead + (rank, d_out), dtype=w.dtype,
                             device=w.device)}


def init_lora(generator: torch.Generator, cfg, params: PyTree,
              rank: Optional[int] = None) -> PyTree:
    """The adapter tree for ``params`` (the output of
    ``model.init_params``); ``generator`` lives on the params' device."""
    rank = rank if rank is not None else cfg.lora.rank
    blocks = {}
    for pos_name, block in params["blocks"].items():
        out: dict = {}
        for module, names in _TARGETS.items():
            if not _module_enabled(cfg, module):
                continue
            node = block
            for part in module.split("."):
                node = node.get(part) if isinstance(node, dict) else None
            if node is None:
                continue
            sub = {name: _init_pair(generator, node[name], rank)
                   for name in names if name in node}
            if sub:
                cur = out
                parts = module.split(".")
                for part in parts[:-1]:
                    cur = cur.setdefault(part, {})
                cur[parts[-1]] = sub
        blocks[pos_name] = out
    return {"blocks": blocks}


def init_rescalers(cfg, k_client: int, mode: str = "learnable",
                   device="cuda") -> Optional[Dict[str, torch.Tensor]]:
    """FLAME Eq. 5 rescaler s_i, one fp32 scalar per MoE layer, initialised
    at k / k_i.  ``mode``: "learnable" (trained), "static" (kept at k/k_i:
    its gradient is zeroed), "none" (no rescaler)."""
    if mode == "none" or not cfg.moe.enabled:
        return None
    P = cfg.pattern_period
    n_periods = cfg.num_layers // P
    init_val = cfg.moe.top_k / max(k_client, 1)
    out = {}
    for pos in range(P):
        if cfg.layer_is_moe(pos):
            out[f"pos{pos}"] = torch.full((n_periods,), init_val,
                                          dtype=torch.float32, device=device)
    return out or None


def make_trainable(lora: Optional[PyTree],
                   rescaler: Optional[PyTree]) -> PyTree:
    """The client's trainable tree in the form ``model.lm_loss`` takes."""
    t: dict = {}
    if lora is not None:
        t["lora"] = lora
    if rescaler is not None:
        t["rescaler"] = rescaler
    return t


# --------------------------------------------------------------------------
# client-axis stacking (the batched round engine's interchange format)
# --------------------------------------------------------------------------

def stack_adapters(trees: Sequence[PyTree]) -> PyTree:
    """Stack N trees of one structure and leaf shapes along a new leading
    client axis: every leaf ``(...)`` becomes ``(N, ...)``."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def unstack_adapters(stacked: PyTree, n: Optional[int] = None
                     ) -> Tuple[PyTree, ...]:
    """Inverse of :func:`stack_adapters`: ``n`` per-client trees (default:
    the leading dim of the first leaf), each leaf a view into ``stacked``."""
    if n is None:
        n = next(leaves(stacked)).shape[0]
    return tuple(tree_map(lambda leaf, i=i: leaf[i], stacked)
                 for i in range(n))


# --------------------------------------------------------------------------
# rank surgery (the HLoRA / FlexLoRA baselines)
# --------------------------------------------------------------------------

def _map_pairs(fn, lora: PyTree) -> PyTree:
    """``fn({"a", "b"}) -> {"a", "b"}`` on every adapter pair.  (Rank
    surgery recurses through module-level functions: a nested function
    that calls itself keeps the trees it closes over alive until Python's
    cyclic collector runs.)"""
    if isinstance(lora, dict) and set(lora) == {"a", "b"}:
        return fn(lora)
    if isinstance(lora, dict):
        return {k: _map_pairs(fn, v) for k, v in lora.items()}
    return lora


def truncate_rank(lora: PyTree, r_client: int) -> PyTree:
    """HLoRA distribution: the first ``r_client`` rank components."""
    return _map_pairs(lambda pair: {"a": pair["a"][..., :r_client],
                                    "b": pair["b"][..., :r_client, :]}, lora)


def pad_rank(lora: PyTree, r_full: int) -> PyTree:
    """Zero-pad a truncated adapter back to the server rank."""
    def fn(pair):
        a, b = pair["a"], pair["b"]
        r = a.shape[-1]
        if r == r_full:
            return pair
        pa = a.new_zeros(a.shape[:-1] + (r_full - r,))
        pb = b.new_zeros(b.shape[:-2] + (r_full - r,) + b.shape[-1:])
        return {"a": torch.cat([a, pa], dim=-1),
                "b": torch.cat([b, pb], dim=-2)}
    return _map_pairs(fn, lora)


def _delta(pair, scale: float) -> torch.Tensor:
    """scale · A @ B in fp32."""
    return torch.matmul(pair["a"].to(_F32), pair["b"].to(_F32)) * scale


def merge_delta(lora: PyTree, scale: float) -> PyTree:
    """ΔW = scale · A @ B per adapter, in the adapter's dtype (the FlexLoRA
    aggregation operand)."""
    return _map_pairs(lambda pair: _delta(pair, scale).to(pair["a"].dtype),
                      lora)


def svd_refactor(delta: PyTree, rank: int, scale: float) -> PyTree:
    """FlexLoRA redistribution: ΔW = U S Vᵀ (fp32) → A = U_r √S_r,
    B = √S_r V_rᵀ / scale, so that scale·A·B is the best rank-``rank``
    approximation of ΔW."""
    def fn(dw):
        u, s, vt = torch.linalg.svd(dw.to(_F32), full_matrices=False)
        r = min(rank, s.shape[-1])
        sq = torch.sqrt(s[..., :r])
        a = u[..., :, :r] * sq[..., None, :]
        b = sq[..., :, None] * vt[..., :r, :] / scale
        return {"a": a.to(dw.dtype), "b": b.to(dw.dtype)}

    return tree_map(fn, delta)


# --------------------------------------------------------------------------
# merging adapters into the base weights (deployment path)
# --------------------------------------------------------------------------

def _merge_node(p_node, l_node, scale: float):
    if not isinstance(l_node, dict):
        return p_node
    if set(l_node) == {"a", "b"}:
        return (p_node.to(_F32) + _delta(l_node, scale)).to(p_node.dtype)
    if isinstance(p_node, dict):
        return {k: _merge_node(v, l_node[k], scale) if k in l_node else v
                for k, v in p_node.items()}
    return p_node


def merge_into_params(params: PyTree, lora: PyTree, scale: float) -> PyTree:
    """``params`` with W := W + scale·A·B wherever an adapter exists."""
    out = dict(params)
    out["blocks"] = {k: _merge_node(params["blocks"][k],
                                    lora["blocks"].get(k, {}), scale)
                     for k in params["blocks"]}
    return out
