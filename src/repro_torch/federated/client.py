"""Client-side local training, one federated participant (port of
``repro/federated/client.py``: the looped path and the batched cohort
path).

A client owns a data shard, an expert budget k_i and a rescaler s_i, and
runs ``local_epochs`` of Adam over its shard each round (paper A2.2: Adam,
lr 1.5e-4, batch 16, one local epoch).  The schedule is a deterministic
:class:`BatchPlan` seeded by ``(round_seed, client_id)``, the reference's
numpy stream, so both packages train on byte-identical batches.

:func:`local_update` is the reference's scan as a Python loop over steps:
forward with autograd through the kernels' ``autograd.Function``s,
gradients of the trainable tree only (the base weights are frozen and no
gradient is formed for them), global-norm clipping and Adam.  An invalid
(padding) step is not computed at all: it would be discarded whole —
trainable tree, Adam state and step counter, counts and loss — so
skipping it is the same result.  Running sums stay on the device; the host
reads them once per client.  :func:`cohort_update` runs a cohort of
clients on stacked plans (:func:`stack_plans`), one member after another.
Under the round's tracer a client's update is a span
``client.local_update`` and each step a ``client.step`` (device markers
under a ``torch.profiler`` session) holding ``model.lm_loss``,
``client.backward`` (the ``autograd.grad``) and ``optim.adam``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import TrainConfig
from ..core import lora as lora_lib
from ..data.synthetic import Corpus, batches
from ..models import model as model_lib
from ..obs import trace as obs_trace
from ..optim import adam
from ..tree import leaves, tree_map

PyTree = Any


@dataclass
class ClientState:
    client_id: int
    shard: Corpus
    k: int                        # FLAME expert budget k_i
    rank: int                     # LoRA rank
    rescaler: Optional[PyTree]    # client-local s_i (persists across rounds)
    rescaler_mode: str = "learnable"
    budget: str = ""              # β-tier label "b1".."b4" (informational)

    @property
    def dataset_size(self) -> int:
        return len(self.shard.tokens)


# ==========================================================================
# batch plans: the deterministic per-round data schedule
# ==========================================================================

@dataclass
class BatchPlan:
    """One client's minibatch schedule for one round: ``tokens``/``labels``
    (n_steps, B, S); ``mask`` (n_steps, B, S); ``valid`` (n_steps,) — 1.0
    for real steps, 0.0 for padding steps (:func:`pad_plan`)."""
    tokens: np.ndarray
    labels: np.ndarray
    mask: np.ndarray
    valid: np.ndarray

    @property
    def n_steps(self) -> int:
        return self.tokens.shape[0]

    @property
    def batch_size(self) -> int:
        return self.tokens.shape[1]


def plan_batch_size(client: ClientState, tc: TrainConfig) -> int:
    """``tc.batch_size``, shrunk so a tiny shard still gets one batch."""
    return max(1, min(tc.batch_size, len(client.shard.tokens)))


def make_batch_plan(client: ClientState, tc: TrainConfig,
                    round_seed: int) -> BatchPlan:
    """``local_epochs`` shuffled epochs over the client's shard, seeded by
    (round_seed, client_id) exactly as the reference."""
    rng = np.random.default_rng(round_seed * 10_007 + client.client_id)
    bs = plan_batch_size(client, tc)
    toks, labs, msks = [], [], []
    for _ in range(tc.local_epochs):
        for tokens, labels, mask in batches(client.shard, bs, rng=rng):
            toks.append(tokens)
            labs.append(labels)
            msks.append(mask)
    if not toks:
        # zero-step client: one all-invalid dummy step, discarded whole
        shape = (1, bs) + client.shard.tokens.shape[1:]
        return BatchPlan(tokens=np.zeros(shape, np.int32),
                         labels=np.zeros(shape, np.int32),
                         mask=np.zeros((1, bs) + client.shard.mask.shape[1:],
                                       np.float32),
                         valid=np.zeros((1,), np.float32))
    return BatchPlan(tokens=np.stack(toks), labels=np.stack(labs),
                     mask=np.stack(msks),
                     valid=np.ones((len(toks),), np.float32))


def pad_plan(plan: BatchPlan, n_steps: int) -> BatchPlan:
    """Pad a plan to ``n_steps`` with repeats of step 0 flagged invalid."""
    extra = n_steps - plan.n_steps
    if extra <= 0:
        return plan

    def rep(x):
        return np.concatenate([x, np.repeat(x[:1], extra, axis=0)])

    return BatchPlan(tokens=rep(plan.tokens), labels=rep(plan.labels),
                     mask=rep(plan.mask),
                     valid=np.concatenate([plan.valid,
                                           np.zeros((extra,), np.float32)]))


def empty_plan(like: BatchPlan) -> BatchPlan:
    """An all-invalid plan with ``like``'s shapes: a cohort slot with no
    real participant.  ``local_update`` returns its inputs untouched with
    zero counts and tokens, and a dataset size of 0 keeps it out of the
    aggregate."""
    return BatchPlan(tokens=np.zeros_like(like.tokens),
                     labels=np.zeros_like(like.labels),
                     mask=np.zeros_like(like.mask),
                     valid=np.zeros_like(like.valid))


def stack_plans(plans: Sequence[BatchPlan]) -> BatchPlan:
    """Stack per-client plans to (C, n_steps, B, S) for
    :func:`cohort_update`, padding shorter plans with invalid steps.  All
    plans must share a batch size (the cohort builder groups by it)."""
    sizes = {p.batch_size for p in plans}
    if len(sizes) > 1:
        raise ValueError(f"cannot stack plans with mixed batch sizes {sizes}"
                         " — cohort grouping should have split these")
    n = max(p.n_steps for p in plans)
    padded = [pad_plan(p, n) for p in plans]
    return BatchPlan(tokens=np.stack([p.tokens for p in padded]),
                     labels=np.stack([p.labels for p in padded]),
                     mask=np.stack([p.mask for p in padded]),
                     valid=np.stack([p.valid for p in padded]))


# ==========================================================================
# the local-training program (one client)
# ==========================================================================

def _count_zeros(cfg, device) -> Dict[str, torch.Tensor]:
    """Zeroed activation-count sums {pos: (n_periods, E)}."""
    P = cfg.pattern_period
    n_periods = cfg.num_layers // P
    return {f"pos{p}": torch.zeros((n_periods, cfg.moe.num_experts),
                                   dtype=torch.float32, device=device)
            for p in range(P) if cfg.layer_is_moe(p)}


def _train_step(cfg, params, trainable, opt_state, tokens, labels, mask, *,
                k: int, tc: TrainConfig, rescaler_trainable: bool):
    """One Adam step on the trainable tree.  Returns (trainable, opt_state,
    loss, counts)."""
    tracer = obs_trace.current()
    with tracer.span("client.step", device=True):
        tr = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
        flat = list(leaves(tr))
        loss, counts = model_lib.lm_loss(cfg, params, tokens, labels, mask,
                                         trainable=tr, k=k)
        with tracer.span("client.backward"):
            grads_flat = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(t): (torch.zeros_like(t) if g is None else g)
                 for t, g in zip(flat, grads_flat)}
        grads = tree_map(lambda t: by_id[id(t)], tr)
        if not rescaler_trainable and "rescaler" in grads:
            # zeroed before clipping, so s_i takes no share of the global
            # norm
            grads["rescaler"] = tree_map(torch.zeros_like,
                                         grads["rescaler"])
        with tracer.span("optim.adam"):
            new_tr, new_opt = adam.update(
                grads, opt_state, tree_map(torch.Tensor.detach, tr),
                lr=tc.learning_rate, beta1=tc.beta1, beta2=tc.beta2,
                eps=tc.eps, weight_decay=tc.weight_decay,
                grad_clip=tc.grad_clip)
        counts = {pos: c.detach() for pos, c in counts.items()}
    return new_tr, new_opt, loss.detach(), counts


@obs_trace.traced("client.local_update")
def local_update(cfg, params: PyTree, trainable: PyTree, tokens, labels,
                 mask, valid, *, k: int, tc: TrainConfig,
                 rescaler_trainable: bool):
    """One client's local round.  ``tokens``/``labels``: (n_steps, B, S);
    ``mask``: (n_steps, B, S); ``valid``: (n_steps,) — tensors on the
    params' device, or numpy arrays (moved there).  Invalid steps leave
    the trainable tree, the Adam state (step counter included), counts and
    loss untouched.

    Returns ``(trainable, count_sums {pos: (n_periods, E)}, token_count,
    loss_sum, n_valid)``; the last three are 0-dim fp32 tensors."""
    device = next(leaves(params)).device

    def dev(a):
        return torch.as_tensor(a).to(device)

    tokens, labels, mask = dev(tokens), dev(labels), dev(mask)
    valid = np.asarray(torch.as_tensor(valid).cpu())
    opt_state = adam.init(trainable)
    tokens_per_step = float(np.prod(tokens.shape[1:3]))          # B * S
    counts_acc = _count_zeros(cfg, device)
    f32 = dict(dtype=torch.float32, device=device)
    tok_acc = torch.zeros((), **f32)
    loss_acc = torch.zeros((), **f32)
    n_acc = torch.zeros((), **f32)
    tr = trainable
    for step in range(tokens.shape[0]):
        if not valid[step] > 0:
            continue
        tr, opt_state, loss, counts = _train_step(
            cfg, params, tr, opt_state, tokens[step], labels[step],
            mask[step], k=k, tc=tc, rescaler_trainable=rescaler_trainable)
        for pos, c in counts.items():
            counts_acc[pos] = counts_acc[pos] + c
        tok_acc = tok_acc + tokens_per_step
        loss_acc = loss_acc + loss
        n_acc = n_acc + 1.0
    return tr, counts_acc, tok_acc, loss_acc, n_acc


# ==========================================================================
# batched cohort execution
# ==========================================================================

def cohort_update(cfg, params: PyTree, stacked_trainable: PyTree, tokens,
                  labels, mask, valid, *, k: int, tc: TrainConfig,
                  rescaler_trainable: bool, backend: str = "vmap"):
    """:func:`local_update` for a whole cohort, on stacked inputs.

    ``stacked_trainable``: a trainable tree with a leading client axis C
    (``lora.stack_adapters``); ``tokens``…``valid``: a stacked
    :class:`BatchPlan` (C, n_steps, ...).  The kernels are ``ctypes``
    calls, which ``torch.func.vmap`` cannot batch, so both ``backend``
    values run ``local_update`` once per member, in order, on its slice
    of the inputs: the reference's ``"map"`` semantics (one
    single-client program, members in turn).

    Returns stacked ``(trainable, count_sums {pos: (C, n_periods, E)},
    token_counts (C,), loss_sums (C,), n_valid (C,))``."""
    if backend not in ("vmap", "map"):
        raise ValueError(f"unknown cohort backend {backend!r}")
    members = lora_lib.unstack_adapters(stacked_trainable, len(valid))
    outs = [local_update(cfg, params, tr_j, tokens[j], labels[j], mask[j],
                         valid[j], k=k, tc=tc,
                         rescaler_trainable=rescaler_trainable)
            for j, tr_j in enumerate(members)]
    tr, counts = (lora_lib.stack_adapters([o[i] for o in outs])
                  for i in (0, 1))
    tok, loss_sum, n_valid = (torch.stack([o[i] for o in outs])
                              for i in (2, 3, 4))
    return tr, counts, tok, loss_sum, n_valid


# ==========================================================================
# looped reference path
# ==========================================================================

def local_train(cfg, params: PyTree, global_lora: PyTree,
                client: ClientState, tc: TrainConfig, round_seed: int
                ) -> Tuple[PyTree, Dict[str, np.ndarray], float, Dict]:
    """Run the client's local epoch(s).  Returns (trained_lora,
    activation_frequencies {pos: (n_periods, E)} numpy, total_tokens,
    info {"mean_loss", "steps"}).  The trained rescaler stays on the
    client (``client.rescaler``)."""
    trainable = lora_lib.make_trainable(global_lora, client.rescaler)
    plan = make_batch_plan(client, tc, round_seed)
    trained, count_sums, tok, loss_sum, n_valid = local_update(
        cfg, params, trainable, plan.tokens, plan.labels, plan.mask,
        plan.valid, k=client.k, tc=tc,
        rescaler_trainable=(client.rescaler_mode == "learnable"))

    total_tokens = float(tok)
    freqs = {pos: c.cpu().numpy() / max(total_tokens, 1.0)
             for pos, c in count_sums.items()}
    if "rescaler" in trained:
        client.rescaler = trained["rescaler"]     # persist s_i locally
    steps = int(n_valid)
    info = {"mean_loss": (float(loss_sum) / steps if steps
                          else float("nan")),
            "steps": steps}
    return trained["lora"], freqs, total_tokens, info


# ==========================================================================
# evaluation
# ==========================================================================

@torch.no_grad()
def evaluate(cfg, params: PyTree, trainable: Optional[PyTree],
             corpus: Corpus, *, k: int, batch_size: int = 16) -> float:
    """Mean masked CE loss over a corpus (batch means weighted by batch
    size, as the reference)."""
    device = next(leaves(params)).device
    tot, n = 0.0, 0
    rng = np.random.default_rng(0)
    for tokens, labels, mask in batches(corpus, batch_size, rng=rng,
                                        drop_last=False):
        loss, _ = model_lib.lm_loss(
            cfg, params, torch.as_tensor(tokens).to(device),
            torch.as_tensor(labels).to(device),
            torch.as_tensor(mask).to(device), trainable=trainable, k=k)
        tot += float(loss) * len(tokens)
        n += len(tokens)
    return tot / max(n, 1)
