"""Adam(W) over nested-dict trees (port of ``repro/optim/adam.py``).

State mirrors the trainable tree with fp32 moments.  Global-norm clipping,
decoupled weight decay and an optional boolean mask tree (leaves with mask
False are frozen: parameter and moments keep their values).  Each update
is computed in fp32 and cast back to the leaf's dtype.  Functional, as the
reference: :func:`update` returns new trees and leaves its inputs as they
were.

On the card mesh (``launch/steps.py`` with ``mesh=``) every rank updates
its shard of each leaf; only the clipping norm crosses ranks:
``norm_groups`` gives each leaf the process group of the axes it is split
over, and its sum of squares is all-reduced there, so a leaf replicated
on an axis is counted once.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves, tree_map

PyTree = Any
_F32 = torch.float32


class AdamState(NamedTuple):
    step: int
    mu: PyTree
    nu: PyTree


def init(params: PyTree) -> AdamState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=_F32, device=p.device)
    return AdamState(step=0, mu=tree_map(zeros, params),
                     nu=tree_map(zeros, params))


def global_norm(tree: PyTree, groups: Optional[PyTree] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares; with ``groups`` (a tree of
    process groups or None, one a leaf) each leaf's sum is first
    all-reduced over its group (the shards of a split leaf)."""
    sums = (torch.sum(torch.square(g.to(_F32))) for g in leaves(tree))
    if groups is not None:
        from ..models.parallel import all_reduce
        sums = [s if grp is None else all_reduce(s, grp)
                for s, grp in zip(sums, leaves(groups))]
    return torch.sqrt(sum(sums))


def clip_by_global_norm(grads: PyTree, max_norm: float,
                        groups: Optional[PyTree] = None) -> PyTree:
    norm = global_norm(grads, groups)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(_F32) * scale, grads)


@torch.no_grad()
def update(grads: PyTree, state: AdamState, params: PyTree, *,
           lr: float, beta1: float = 0.9, beta2: float = 0.999,
           eps: float = 1e-8, weight_decay: float = 0.0,
           grad_clip: float = 0.0,
           mask: Optional[PyTree] = None,
           norm_groups: Optional[PyTree] = None
           ) -> Tuple[PyTree, AdamState]:
    """Returns (new_params, new_state).  ``norm_groups``: the mesh's
    per-leaf groups for the clipping norm (the module docstring)."""
    if grad_clip > 0:
        grads = clip_by_global_norm(grads, grad_clip, norm_groups)
    step = state.step + 1
    # bias corrections in fp32, as the reference's traced step counter
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** t)

    def upd(g, m, v, p, use=True):
        g = g.to(_F32)
        p32 = p.to(_F32)
        m_new = beta1 * m + (1 - beta1) * g
        v_new = beta2 * v + (1 - beta2) * g * g
        delta = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if weight_decay:
            delta = delta + lr * weight_decay * p32
        p_new = (p32 - delta).to(p.dtype)
        if use is not True:                      # masked leaf: freeze
            keep = torch.as_tensor(use, device=p.device)
            p_new = torch.where(keep, p_new, p)
            m_new = torch.where(keep, m_new, m)
            v_new = torch.where(keep, v_new, v)
        return p_new, m_new, v_new

    if mask is None:
        triples = tree_map(upd, grads, state.mu, state.nu, params)
    else:
        triples = tree_map(upd, grads, state.mu, state.nu, params, mask)

    def pick(i):
        return _map_triples(lambda t: t[i], triples)
    return pick(0), AdamState(step=step, mu=pick(1), nu=pick(2))


def _map_triples(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_triples(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    """fn(step) -> the fp32 learning rate: linear warmup to ``base_lr``
    over ``warmup`` steps, then a half cosine to 0 at ``total``.  ``step``
    is an int or a tensor."""
    def fn(step):
        step = torch.as_tensor(step).to(_F32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant_schedule(base_lr: float) -> Callable[[Any], torch.Tensor]:
    return lambda step: torch.tensor(base_lr, dtype=_F32)
