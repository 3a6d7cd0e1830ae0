"""Server-side aggregation (port of ``repro/core/aggregation.py``).

* :func:`fedavg` — Eq. 3–4: dataset-size-weighted average of every leaf.
* :func:`flame_aggregate` — Eq. 6–7: per-expert weights
  ``γ_i^j = (a_i^j / S_i)^t · |D_i|`` on the per-expert LoRA factors;
  every other adapter falls back to dataset-size weights.  An expert
  nobody activated keeps the previous global adapter (``prev_lora``).
* ``flame_acc_*`` — the same rule streamed: ``init → update`` (one cohort
  at a time) ``→ merge → finalize``.  The accumulator holds one fp32
  adapter tree of weighted sums and the weight masses, so the batched
  engine never holds more than one cohort's trees; ``finalize`` equals
  ``flame_aggregate`` over all clients up to fp32 summation order.
* :func:`hlora_aggregate` — HLoRA: zero-padded truncated adapters, each
  rank component averaged over the clients that trained it.
* :func:`flexlora_aggregate` — FlexLoRA: average ΔW = s·A_i·B_i, then SVD
  back to rank-r factors.

Inputs come either as a list of per-client trees or as one *stacked* tree
(a leading client axis on every leaf).  A list is stacked one leaf at a
time (:func:`_leaf_stack`, the reference's ``_as_stacked`` per leaf), so
the peak is one leaf of every client in fp32, not every client's whole
tree (at OLMoE FULL one client's adapters are ~390 MB in bf16).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..tree import leaves, subtree, tree_map, tree_map_with_path
from . import lora as lora_lib

PyTree = Any
EPS = 1e-12
_F32 = torch.float32


def _leaf_stack(trees, path) -> torch.Tensor:
    """The leaf at ``path`` of every client, stacked in fp32 (n, ...)."""
    if isinstance(trees, (list, tuple)):
        return torch.stack([subtree(t, path).to(_F32) for t in trees])
    return subtree(trees, path).to(_F32)


def _is_expert(path) -> bool:
    """``path`` = ("blocks", pos, ...) lies under a ``moe/experts`` node."""
    return "experts" in path[2:]


def _template(trees):
    return trees[0] if isinstance(trees, (list, tuple)) else trees


def _sizes(sizes: Sequence[float], device) -> torch.Tensor:
    """|D_i| as an fp32 vector on ``device`` (a tensor already there is
    used as it is: the device round driver's sizes)."""
    if isinstance(sizes, torch.Tensor):
        return sizes.to(device=device, dtype=_F32)
    return torch.as_tensor(np.asarray(sizes, np.float32), device=device)


def _size_weights(sizes: Sequence[float], device) -> torch.Tensor:
    w = _sizes(sizes, device)
    return w / torch.clamp(w.sum(), min=EPS)


def _weighted_tree_mean(trees, weights: Sequence[float]) -> PyTree:
    """Σ_i w_i · tree_i / Σ_i w_i leaf by leaf, in fp32, each leaf cast
    back to its dtype."""
    def mean(path, node):
        leaf = _leaf_stack(trees, path)                          # (n, ...)
        w = _size_weights(weights, leaf.device)
        out = (leaf * w.reshape((-1,) + (1,) * (leaf.dim() - 1))).sum(0)
        return out.to(node.dtype)

    return tree_map_with_path(mean, _template(trees))


def fedavg(client_trees, dataset_sizes: Sequence[float]) -> PyTree:
    """Standard FedAvg (Eq. 3–4) over a list of trees or a stacked tree."""
    return _weighted_tree_mean(client_trees, dataset_sizes)


def activation_frequency(counts: Dict[str, torch.Tensor],
                         total_tokens: float) -> Dict[str, torch.Tensor]:
    """counts: {pos: (n_periods, E)} summed over the client's local steps."""
    return {k: torch.clamp(v / max(total_tokens, EPS), 0.0, 1.0)
            for k, v in counts.items()}


def _stack_freqs(client_freqs, n: int, device) -> Dict[str, torch.Tensor]:
    """{pos: (n, n_periods, E)} fp32 on ``device``, from the stacked dict
    or a list of per-client dicts (a client with no entry — no steps —
    reports zero frequency)."""
    if isinstance(client_freqs, dict):
        return {pos: torch.as_tensor(f, device=device).to(_F32)
                for pos, f in client_freqs.items()}
    pos_keys = sorted({k for f in client_freqs for k in f})
    out = {}
    for pos in pos_keys:
        like = next(np.asarray(f[pos]) for f in client_freqs if pos in f)
        out[pos] = torch.stack([
            torch.as_tensor(np.asarray(f.get(pos, np.zeros_like(like)),
                                       np.float32), device=device)
            for f in client_freqs[:n]])
    return out


def flame_aggregate(client_loras, client_freqs,
                    dataset_sizes: Sequence[float], temperature: int,
                    prev_lora: Optional[PyTree] = None) -> PyTree:
    """Aggregate client LoRA trees with Eq. 6–7.

    ``client_loras``: a list of ``n`` adapter trees, or one tree whose
    leaves carry a leading client axis.  ``client_freqs``: a list of ``n``
    ``{pos: (n_periods, E)}`` activation frequencies, or the stacked
    ``{pos: (n, n_periods, E)}``.  ``dataset_sizes``: |D_i| per client.
    Expert leaves (under a ``moe/experts`` path, shape (n, n_periods, E,
    ...)) take the per-expert weights ``γ = freq^t · |D_i|`` normalised over
    clients; an expert whose total mass is zero keeps ``prev_lora``'s
    value when given (else it collapses to zero, the legacy rule).  Every
    other adapter takes dataset-size weights.  Results keep each leaf's
    dtype."""
    template = _template(client_loras)
    n = len(dataset_sizes)
    device = next(leaves(template)).device
    sizes = _sizes(dataset_sizes, device)
    freqs = _stack_freqs(client_freqs, n, device)
    gamma = {pos: (f ** temperature) * sizes[:, None, None]
             for pos, f in freqs.items()}
    w_size = sizes / torch.clamp(sizes.sum(), min=EPS)

    def aggregate(path, node):
        pos = path[1]
        leaf = _leaf_stack(client_loras, path)                    # (n, ...)
        if _is_expert(path) and pos in gamma:
            g = gamma[pos]
            g = g.reshape(g.shape + (1,) * (leaf.dim() - 3))
            mass = g.sum(0)                              # (n_periods, E, 1…)
            out = (leaf * g).sum(0) / torch.clamp(mass, min=EPS)
            prev = subtree(prev_lora, path)
            if prev is not None:
                out = torch.where(mass > 0, out, prev.to(_F32))
        else:
            out = (leaf * w_size.reshape((n,) + (1,) * (leaf.dim() - 1))
                   ).sum(0)
        return out.to(node.dtype)

    return tree_map_with_path(aggregate, {"blocks": template["blocks"]})


# --------------------------------------------------------------------------
# streaming FLAME aggregation: init → update per chunk → merge → finalize
# --------------------------------------------------------------------------
#
# The accumulator is a plain tree:
#
#   {"num":       fp32 adapter tree, no client axis — Σ_i w_i · leaf_i,
#    "den_gamma": {pos: (n_periods, E)} — Σ_i γ_i per expert position,
#    "den_size":  ()                    — Σ_i |D_i|}
#
# Expert leaves accumulate with w_i = γ_i^j = freq^t·|D_i|, all others with
# w_i = |D_i|; finalize divides by the matching denominator.

def flame_acc_init(template_lora: PyTree) -> PyTree:
    """A fresh accumulator shaped after one (unstacked) adapter tree."""
    device = next(leaves(template_lora)).device
    return {"num": tree_map(lambda l: torch.zeros(l.shape, dtype=_F32,
                                                  device=l.device),
                            template_lora),
            "den_gamma": {},
            "den_size": torch.zeros((), dtype=_F32, device=device)}


def flame_acc_update(acc: PyTree, stacked_loras, stacked_freqs,
                     dataset_sizes, temperature: int) -> PyTree:
    """Fold one chunk of clients (stacked, or a list) into the running
    sums.  A client with ``dataset_sizes[i] == 0`` contributes nothing."""
    device = acc["den_size"].device
    sizes = _sizes(dataset_sizes, device)
    n = sizes.shape[0]
    freqs = _stack_freqs(stacked_freqs, n, device)
    gamma = {pos: (f ** temperature) * sizes[:, None, None]
             for pos, f in freqs.items()}

    def add(path, node):
        pos, num = path[1], subtree(acc["num"], path)
        leaf = _leaf_stack(stacked_loras, path)                  # (n, ...)
        if _is_expert(path) and pos in gamma:
            g = gamma[pos]
            g = g.reshape(g.shape + (1,) * (leaf.dim() - 3))
            return num + (leaf * g).sum(0)
        return num + (leaf * sizes.reshape((n,) + (1,) * (leaf.dim() - 1))
                      ).sum(0)

    template = _template(stacked_loras)
    num = tree_map_with_path(add, {"blocks": template["blocks"]})
    den_gamma = dict(acc["den_gamma"])
    for pos, g in gamma.items():
        den_gamma[pos] = den_gamma.get(
            pos, torch.zeros(g.shape[1:], dtype=_F32, device=device)
        ) + g.sum(0)
    return {"num": num, "den_gamma": den_gamma,
            "den_size": acc["den_size"] + sizes.sum()}


def flame_acc_merge(a: PyTree, b: PyTree) -> PyTree:
    """Two accumulators over disjoint client sets merge by addition."""
    den_gamma = dict(a["den_gamma"])
    for pos, g in b["den_gamma"].items():
        den_gamma[pos] = den_gamma[pos] + g if pos in den_gamma else g
    return {"num": tree_map(torch.add, a["num"], b["num"]),
            "den_gamma": den_gamma,
            "den_size": a["den_size"] + b["den_size"]}


def flame_acc_finalize(acc: PyTree,
                       prev_lora: Optional[PyTree] = None) -> PyTree:
    """The running sums over their weight masses: the global adapter.

    An expert with zero mass over every streamed chunk keeps ``prev_lora``'s
    value when given (else zero), as ``flame_aggregate(prev_lora=...)``;
    the other leaves keep it when no client had data at all.  Leaves take
    ``prev_lora``'s dtypes when given, else stay fp32."""
    den_gamma, den_size = acc["den_gamma"], acc["den_size"]

    def finalize(path, num):
        pos, prev = path[1], subtree(prev_lora, path)
        if _is_expert(path) and pos in den_gamma:
            den = den_gamma[pos]
            den = den.reshape(den.shape + (1,) * (num.dim() - 2))
            out = num / torch.clamp(den, min=EPS)
            fallback = (prev.to(_F32) if prev is not None
                        else torch.zeros_like(out))
            out = torch.where(den > 0, out, fallback)
        else:
            out = num / torch.clamp(den_size, min=EPS)
            if prev is not None:
                out = torch.where(den_size > 0, out, prev.to(_F32))
        return out.to(prev.dtype) if prev is not None else out

    return tree_map_with_path(finalize, {"blocks": acc["num"]["blocks"]})


# --------------------------------------------------------------------------
# HLoRA: sparsity-weighted aggregation of rank-truncated adapters
# --------------------------------------------------------------------------

def hlora_aggregate(client_loras: Sequence[PyTree],
                    client_ranks: Sequence[int],
                    dataset_sizes: Sequence[float], r_full: int) -> PyTree:
    """Clients trained adapters truncated to ``client_ranks[i]``: pad each
    to the server rank and average each rank component over the clients
    that trained it, weighted by dataset size."""
    n = len(client_loras)
    device = next(leaves(client_loras[0])).device
    sizes = _sizes(dataset_sizes, device)
    padded = [lora_lib.pad_rank(cl, r_full) for cl in client_loras]
    ranks = torch.as_tensor(list(client_ranks), device=device)
    comp = torch.arange(r_full, device=device)
    trained = (ranks[:, None] > comp[None, :]).to(_F32)          # (n, r)
    w = trained * sizes[:, None]
    w = w / torch.clamp(w.sum(0, keepdim=True), min=EPS)

    def avg(path, node):
        x = _leaf_stack(padded, path)            # a (n,…,d,r) / b (n,…,r,o)
        if path[-1] == "a":
            wx = w.reshape((n,) + (1,) * (x.dim() - 2) + (r_full,))
        else:
            wx = w.reshape((n,) + (1,) * (x.dim() - 3) + (r_full, 1))
        return (x * wx).sum(0).to(node.dtype)

    return tree_map_with_path(avg, padded[0])


# --------------------------------------------------------------------------
# FlexLoRA: ΔW aggregation + SVD redistribution
# --------------------------------------------------------------------------

def flexlora_aggregate(client_loras: Sequence[PyTree],
                       dataset_sizes: Sequence[float],
                       r_full: int, scale: float) -> PyTree:
    """Average the full-rank updates ΔW_i = scale·A_i·B_i by dataset size,
    then SVD-refactor the mean back into rank-``r_full`` factors."""
    deltas = [lora_lib.merge_delta(cl, scale) for cl in client_loras]
    return lora_lib.svd_refactor(_weighted_tree_mean(deltas, dataset_sizes),
                                 r_full, scale)


# --------------------------------------------------------------------------
# round summary (the Figure-2 heatmap tensor)
# --------------------------------------------------------------------------

def stack_client_frequencies(client_freqs: Sequence[Dict[str, Any]]
                             ) -> Dict[str, torch.Tensor]:
    """{pos: (n_clients, n_periods, E)}."""
    return {pos: torch.stack([torch.as_tensor(np.asarray(f[pos]))
                              for f in client_freqs])
            for pos in client_freqs[0]}
