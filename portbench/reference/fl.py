"""Plain reference of one FLAME round (arXiv:2409.02060, Eqs. 5-7), over
:mod:`.moe_lm`: every client trains the global adapter and its own
rescaler at its budget ``k`` with Adam on its batches, then the server
aggregates the adapters, each expert's weighted by its clients'
activation frequencies to the power ``T`` times their dataset sizes and
every other leaf by dataset size alone.

The rules the round runs by (the configuration's precision, the
schedule) are worked out here again:

* a client's schedule for round ``r`` of a run seeded ``s``: numpy
  ``default_rng((s * 1000 + r) * 10007 + client_id)``, one permutation of
  the shard per local epoch, whole batches only;
* the adapter is stored in the configuration's dtype and the rescaler in
  float32; gradients are taken in float32, clipped by their global norm,
  and Adam's moments are float32 with float32 bias corrections; each
  update is applied in float32 and stored back in the leaf's dtype;
* frequencies are a client's routed assignments per expert over its
  trained tokens; an expert no client routed to keeps the old adapter;
  the aggregate is stored in the adapter's dtype.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .moe_lm import Ref

F32 = torch.float32


def flat(tree, path=()) -> Dict[Tuple[str, ...], torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], path + (k,)))
        return out
    return {path: tree}


def unflat(d: Dict[Tuple[str, ...], torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in d.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


def batch_plan(n: int, batch_size: int, epochs: int, run_seed: int,
               round_idx: int, client_id: int) -> List[np.ndarray]:
    rng = np.random.default_rng((run_seed * 1000 + round_idx) * 10_007
                                + client_id)
    out = []
    for _ in range(epochs):
        idx = rng.permutation(n)
        for i in range(0, (n // batch_size) * batch_size, batch_size):
            out.append(idx[i:i + batch_size])
    return out


def client_round(ref: Ref, lora: Dict, rescaler: torch.Tensor, shard: Dict,
                 plan: List[np.ndarray], k: int, tc: Dict,
                 drop_half: bool = False, routes=None):
    """One client's local round.  Returns ``(lora, rescaler, losses,
    first-step gradient norms {leaf path: norm}, counts (L, E), tokens,
    the selections of each step)``; the trees are new, the inputs are left
    as they were.  ``routes``: each step's per-layer selections to follow
    (where their shape fits the step).  ``drop_half`` plants a fault: each
    step trains on the first half of its rows."""
    dev = rescaler.device
    params = flat({"lora": lora, "rescaler": {"pos0": rescaler}})
    dtypes = {p: t.dtype for p, t in params.items()}
    cur = {p: t.detach().clone() for p, t in params.items()}
    mu = {p: torch.zeros(t.shape, dtype=F32, device=dev)
          for p, t in cur.items()}
    nu = {p: torch.zeros_like(v) for p, v in mu.items()}
    b1, b2, eps, lr = tc["beta1"], tc["beta2"], tc["eps"], tc["lr"]
    losses, g1, counts, tokens, chosen = [], None, None, 0, []
    for step, rows in enumerate(plan):
        if drop_half:
            rows = rows[:len(rows) // 2]
        tok = torch.as_tensor(shard["tokens"][rows], device=dev)
        lab = torch.as_tensor(shard["labels"][rows], device=dev)
        msk = torch.as_tensor(shard["mask"][rows], device=dev)
        leaves = {p: t.to(F32).requires_grad_(True) for p, t in cur.items()}
        tree = unflat(leaves)
        forced = routes[step] if routes is not None else None
        if forced is not None and forced[0].shape[0] != tok.numel():
            forced = None
        h, c = ref.hidden(tok, lora=tree["lora"],
                          rescaler=tree["rescaler"]["pos0"], k=k,
                          capacity=True, remat=True, routes=forced)
        chosen.append(ref.last_routes)
        loss = ref.loss(h, lab, msk)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = torch.clamp(tc["grad_clip"] / torch.clamp(norm, min=1e-9),
                           max=1.0)
        t = np.float32(step + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        for p, g in grads.items():
            g = g * clip
            mu[p] = b1 * mu[p] + (1 - b1) * g
            nu[p] = b2 * nu[p] + (1 - b2) * g * g
            delta = lr * (mu[p] / bc1) / (torch.sqrt(nu[p] / bc2) + eps)
            cur[p] = (cur[p].to(F32) - delta).to(dtypes[p])
        if step == 0:
            g1 = {p: float(torch.linalg.vector_norm(g * clip))
                  for p, g in grads.items()}
        losses.append(float(loss.detach()))
        counts = c if counts is None else counts + c
        tokens += tok.numel()
        del h, loss, grads, leaves, tree
    out = unflat(cur)
    return (out["lora"], out["rescaler"]["pos0"], losses, g1, counts, tokens,
            chosen)


def flame_aggregate(prev: Dict, loras: List[Dict], freqs: List[torch.Tensor],
                    sizes: List[float], temperature: int) -> Dict:
    """Eqs. 6-7 over the clients' adapters; ``freqs[i]`` is (L, E)."""
    size = torch.as_tensor(sizes, dtype=F32, device=freqs[0].device)
    gamma = torch.stack([f.to(F32) ** temperature for f in freqs]) \
        * size[:, None, None]                                  # (n, L, E)
    mass = gamma.sum(0)
    out = {}
    for path, old in flat(prev).items():
        stack = torch.stack([flat(t)[path].to(F32) for t in loras])
        if "experts" in path:
            g = gamma.reshape(gamma.shape + (1,) * (stack.dim() - 3))
            den = mass.reshape(mass.shape + (1,) * (stack.dim() - 3))
            agg = (stack * g).sum(0) / den.clamp_min(1e-12)
            agg = torch.where(den > 0, agg, old.to(F32))
        else:
            w = size / size.sum()
            agg = (stack * w.reshape((-1,) + (1,) * (stack.dim() - 1))).sum(0)
        out[path] = agg.to(old.dtype)
    return unflat(out)


def run_round(ref: Ref, global_lora: Dict, clients: List[Dict], tc: Dict,
              run_seed: int, round_idx: int, temperature: int,
              drop_half: bool = False, routes=None):
    """The whole round.  ``clients[i]``: ``{"id", "k", "rescaler",
    "shard"}``; ``routes[i]``: client i's selections to follow, or None.
    Returns ``(new global adapter, per-client results {"rescaler",
    "losses", "grad1", "routes"})``."""
    loras, freqs, sizes, results = [], [], [], []
    for c in clients:
        n = len(c["shard"]["tokens"])
        plan = batch_plan(n, min(tc["batch_size"], n), tc["local_epochs"],
                          run_seed, round_idx, c["id"])
        lora, resc, losses, g1, counts, tokens, chosen = client_round(
            ref, global_lora, c["rescaler"], c["shard"], plan, c["k"], tc,
            drop_half=drop_half,
            routes=None if routes is None else routes[len(results)])
        loras.append(lora)
        freqs.append(counts / max(tokens, 1))
        sizes.append(float(n))
        results.append({"rescaler": resc, "losses": losses, "grad1": g1,
                        "routes": chosen})
    return flame_aggregate(global_lora, loras, freqs, sizes,
                           temperature), results
