"""Single-device step functions: the port of ``repro/launch/steps.py``
without the mesh and the sharding.

One build function per input-shape kind:

  * :func:`build_train` — the LoRA fine-tune step (the paper's client
    step): ``n_micro`` microbatches whose gradients are summed in fp32 and
    averaged, the layer stack checkpointed (``remat``, two-level √L groups
    with ``remat_chunk``), Adam (``optim.adam``) on the trainable (LoRA +
    rescaler) tree only: the frozen base carries no optimizer state.
  * :func:`build_prefill` — the forward pass with its decode cache.
  * :func:`build_serve` — ONE token against a ``seq_len``-deep cache
    (decode); the cache is written in place, as the reference donates it.

Each returns a :class:`StepBundle`: ``fn`` a plain callable on tensors
(kernels on CUDA tensors, their plain versions on CPU ones), ``args``
example arguments as ``device="meta"`` tensors (shapes and dtypes, no
storage) and ``meta`` the knobs and byte counts under the reference's
keys.  As in the reference, the prefill and serve steps run MoE layers on
``capacity`` dispatch (its default); the serving engine is the ragged
path.

FLAME integration, as the reference's: every step takes the static expert
budget ``k``, and the train step returns the summed per-expert activation
counts the server's activation-aware aggregation (Eq. 6) consumes.

The activation budget.  The reference sizes microbatches against a fixed
4 GiB per TPU core.  Here the budget is the card's own:
``ACT_BUDGET_FRACTION`` of what the device's memory leaves after the
frozen parameters and the trainable state (the adapters, their fp32
gradient sum and Adam's two fp32 moments).  The other half is headroom
for the allocator's fragmentation, library workspaces and the fp32
weight copies the LoRA backward forms.  A microbatch's footprint
(:func:`activation_bytes`) counts, per sequence: the checkpointed layer
inputs (√L carries), one layer's recomputed activations and their
gradients (a period's worth: Jamba's eight positions), the flash
backward's (H, S, S) fp32 recompute (the plain version's vjp forms the
scores, the probabilities and their gradient for one layer at a time:
1 GiB each at OLMo width and 4096 tokens, which the carry count alone
misses), the plain SSD's (H, L, L) fp32 transients, 3·S·H·L·4 bytes (the
reference's rule), the one-hot dispatch tensors of a capacity MoE layer,
and the cross-entropy's fp32 logits that autograd keeps for every
chunk.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..core import lora as lora_lib
from ..federated import client as client_lib
from ..models import mamba2 as ssm_mod
from ..models import model as model_lib
from ..optim import adam
from ..tree import leaves, tree_map

PyTree = Any
_F32 = torch.float32

# share of (device memory - parameters - trainable state) the saved
# activations of one microbatch may take
ACT_BUDGET_FRACTION = 0.5


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Any                      # the step, a plain callable on tensors
    args: Tuple[PyTree, ...]     # example args (meta tensors)
    meta: Dict[str, Any]


# --------------------------------------------------------------------------
# abstract state (meta tensors: shapes and dtypes, no storage)
# --------------------------------------------------------------------------

_META = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> PyTree:
    return model_lib.init_params(cfg, torch.Generator(), _META)


def abstract_trainable(cfg: ModelConfig, k_client: int = 0,
                       rescaler: str = "learnable") -> PyTree:
    lora = lora_lib.init_lora(torch.Generator(), cfg, abstract_params(cfg))
    resc = (lora_lib.init_rescalers(cfg, k_client or cfg.moe.top_k,
                                    rescaler, device=_META)
            if cfg.moe.enabled else None)
    return lora_lib.make_trainable(lora, resc)


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> PyTree:
    return model_lib.init_cache(cfg, batch, seq_len, device=_META)


def token_shape(cfg: ModelConfig, batch: int, seq: int) -> Tuple[int, ...]:
    """(batch, seq), or (batch, seq, K) for an audio model's K codebook
    streams (the reference's ``launch/specs.py`` ``_token_shape``)."""
    if cfg.num_codebooks:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Example inputs of the step the shape runs (train/prefill/decode);
    tokens and labels carry the codebook axis of an audio model, the mask
    does not."""
    def t(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=_META)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": t(token_shape(cfg, B, S), torch.int32),
                "labels": t(token_shape(cfg, B, S), torch.int32),
                "mask": t((B, S), _F32)}
    if shape.kind == "prefill":
        return {"tokens": t(token_shape(cfg, B, S), torch.int32)}
    return {"tokens": t(token_shape(cfg, B, 1), torch.int32),
            "pos": t((), torch.int32)}


def state_bytes(tree: PyTree) -> int:
    if isinstance(tree, adam.AdamState):
        return state_bytes(tree.mu) + state_bytes(tree.nu)
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def device_bytes(device="cuda") -> int:
    """Memory of ``device``: the card's total, or the host's for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


# --------------------------------------------------------------------------
# knob selection
# --------------------------------------------------------------------------

def _remat_chunk(n_periods: int) -> int:
    chunk = max(int(round(n_periods ** 0.5)), 1)
    while n_periods % chunk:
        chunk -= 1
    return chunk


def activation_bytes(cfg: ModelConfig, seq_len: int, remat_chunk: int,
                     k: Optional[int] = None) -> int:
    """Estimated peak autograd footprint of one sequence of ``seq_len``
    tokens under layer checkpointing (the module docstring lists the
    terms), over the P positions of one period."""
    S, d = seq_len, cfg.d_model
    n_periods = cfg.num_layers // cfg.pattern_period
    n_saved = (n_periods // remat_chunk + remat_chunk if remat_chunk > 1
               else n_periods)
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    carries = n_saved * S * d * itemsize
    hd = cfg.head_dim_
    m = cfg.moe
    kinds = [cfg.layer_kind(j) for j in range(cfg.pattern_period)]
    acts = extra = 0
    if "attn" in kinds:
        # the plain flash backward's (H, S, S) fp32 recompute, one layer
        extra += 3 * cfg.n_heads * S * S * 4
    if "ssm" in kinds:
        # the SSD's (H, L, L) fp32 transients and their gradients, as the
        # reference's knob rule counts them (one layer at a time)
        dims = ssm_mod.mamba_dims(cfg)
        extra += 3 * S * dims["n_heads"] * min(cfg.ssm.chunk_size, S) * 4
    for j, kind in enumerate(kinds):
        if kind == "attn":
            acts += S * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd + 2 * S * d
        else:
            acts += S * (dims["in_dim"] + dims["conv_dim"]
                         + 2 * dims["d_inner"]) + 2 * S * d
        if cfg.layer_is_moe(j):
            kk = k or m.top_k
            group = min(S, 2048)
            acts += S * kk * 3 * m.d_expert + S * 3 * m.d_shared_expert
            # (G, Tg, E, C) fp32 dispatch and combine: C ~ Tg·k·cf/E
            acts += int(2 * S * group * kk * m.capacity_factor)
        else:
            acts += S * 3 * cfg.d_ff
    # one period's activations and their gradients, fp32 at most
    layer = 2 * 4 * acts
    ce = S * cfg.vocab_size * 6          # fp32 logits kept + a bf16 chunk
    return carries + layer + extra + ce


def choose_train_knobs(cfg: ModelConfig, shape: ShapeConfig, *,
                       memory_bytes: Optional[int] = None,
                       device="cuda", k: Optional[int] = None
                       ) -> Dict[str, Any]:
    """Pick (n_micro, remat_chunk) so one microbatch's footprint fits the
    card's activation budget (the module docstring's rule): two-level √L
    checkpointing, and the fewest microbatches that fit (n_micro doubles
    from 1; a model whose one-sequence microbatch does not fit gets
    ``n_micro = global_batch``).  ``act_mode`` is always ``"batch"``: one
    card has no other axis to shard the activations over.  ``memory_bytes``
    defaults to :func:`device_bytes` of ``device``."""
    if memory_bytes is None:
        memory_bytes = device_bytes(device)
    B, S = shape.global_batch, shape.seq_len
    n_periods = cfg.num_layers // cfg.pattern_period
    chunk = _remat_chunk(n_periods)
    per_seq = activation_bytes(cfg, S, chunk, k)
    param_bytes = state_bytes(abstract_params(cfg))
    # adapters + their fp32 gradient sum + Adam's two fp32 moments
    train_bytes = 4 * state_bytes(tree_map(
        lambda t: t.to(_F32), abstract_trainable(cfg, k or 0)))
    budget = int(ACT_BUDGET_FRACTION
                 * max(memory_bytes - param_bytes - train_bytes, 0))
    n_micro = 1
    while n_micro < B:
        if max(B // n_micro, 1) * per_seq <= budget:
            break
        n_micro *= 2
    n_micro = min(n_micro, B)
    return {"n_micro": n_micro, "act_mode": "batch",
            "remat_chunk": chunk if chunk > 1 else 0,
            "act_bytes": max(B // n_micro, 1) * per_seq,
            "act_budget": budget}


def choose_num_groups(cfg: ModelConfig, batch: int, seq: int,
                      target_group: int = 2048) -> int:
    """GShard routing groups of the capacity dispatch: T_g stays near
    ``target_group`` tokens, since capacity C grows with T_g·k/E and the
    (G, T_g, E, C) one-hots with T_g squared.  (The reference also rounds
    G up to the data parallelism, which is 1 here.)"""
    if not cfg.moe.enabled:
        return 1
    T = batch * seq
    if T <= target_group:
        return 1
    g = 1
    while g * 2 <= T // target_group and T % (g * 2) == 0:
        g *= 2
    return g


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, *, k: Optional[int], tc: TrainConfig,
                    n_micro: int, num_groups: int, remat: bool = True,
                    remat_chunk: int = 0, rescaler_trainable: bool = True):
    """Returns step(params, trainable, opt_state, tokens, labels, mask)
    -> (trainable, opt_state, metrics): the reference's step.  Gradients
    of the ``n_micro`` microbatches are summed in fp32 in order and divided
    by ``n_micro``; the loss is their mean; ``metrics["counts"]`` sums the
    activation counts per ``pos{p}``."""

    def step(params, trainable, opt_state, tokens, labels, mask):
        B, S = tokens.shape[:2]
        if B % n_micro:
            raise ValueError(f"global batch {B} does not split into "
                             f"{n_micro} microbatches")
        mb = B // n_micro
        dev = tokens.device
        tr = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
        flat = list(leaves(tr))
        g_acc = {id(t): torch.zeros(t.shape, dtype=_F32, device=dev)
                 for t in flat}
        c_acc = client_lib._count_zeros(cfg, dev)
        l_acc = torch.zeros((), dtype=_F32, device=dev)
        for i in range(n_micro):
            sl = slice(i * mb, (i + 1) * mb)
            loss, counts = model_lib.lm_loss(
                cfg, params, tokens[sl], labels[sl], mask[sl], trainable=tr,
                k=k, remat=remat, remat_chunk=remat_chunk,
                num_groups=num_groups)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            for t, g in zip(flat, grads):
                if g is not None:
                    g_acc[id(t)] = g_acc[id(t)] + g.to(_F32)
            for key in c_acc:
                c_acc[key] = c_acc[key] + counts[key]
            l_acc = l_acc + loss.detach().to(_F32)
        grads = tree_map(lambda t: g_acc[id(t)] / n_micro, tr)
        if not rescaler_trainable and "rescaler" in grads:
            grads["rescaler"] = tree_map(torch.zeros_like,
                                         grads["rescaler"])
        new_trainable, new_opt = adam.update(
            grads, opt_state, trainable, lr=tc.learning_rate,
            beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
            weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
        metrics = {"loss": l_acc / n_micro, "counts": c_acc,
                   "tokens": float(B * S)}
        return new_trainable, new_opt, metrics

    return step


def _train_args(cfg, shape, k):
    a_train = abstract_trainable(cfg, k or 0)
    inputs = input_specs(cfg, shape)
    return (abstract_params(cfg), a_train, adam.init(a_train),
            inputs["tokens"], inputs["labels"], inputs["mask"])


def build_train(cfg: ModelConfig, shape: ShapeConfig, *,
                k: Optional[int] = None, tc: Optional[TrainConfig] = None,
                n_micro: Optional[int] = None,
                num_groups: Optional[int] = None,
                remat_chunk: Optional[int] = None, remat: bool = True,
                device="cuda") -> StepBundle:
    """The train step with its knobs: each one not given is chosen by
    :func:`choose_train_knobs` for ``device``'s memory and
    :func:`choose_num_groups`."""
    tc = tc or TrainConfig()
    k = k if k is not None else (cfg.moe.top_k or None)
    knobs = choose_train_knobs(cfg, shape, device=device, k=k)
    n_micro = n_micro if n_micro is not None else knobs["n_micro"]
    remat_chunk = (remat_chunk if remat_chunk is not None
                   else knobs["remat_chunk"])
    num_groups = (num_groups if num_groups is not None else
                  choose_num_groups(cfg, shape.global_batch // n_micro,
                                    shape.seq_len))
    step = make_train_step(cfg, k=k, tc=tc, n_micro=n_micro,
                           num_groups=num_groups, remat=remat,
                           remat_chunk=remat_chunk)
    args = _train_args(cfg, shape, k)
    return StepBundle(
        name="train_step", fn=step, args=args,
        meta={"n_micro": n_micro, "act_mode": knobs["act_mode"],
              "num_groups": num_groups, "k": k, "remat": remat,
              "remat_chunk": remat_chunk,
              "param_bytes": state_bytes(args[0]),
              "trainable_bytes": state_bytes(args[1]),
              "act_bytes": knobs["act_bytes"],
              "act_budget": knobs["act_budget"]})


# --------------------------------------------------------------------------
# prefill and serve (decode) steps
# --------------------------------------------------------------------------

def build_prefill(cfg: ModelConfig, shape: ShapeConfig, *,
                  k: Optional[int] = None,
                  num_groups: Optional[int] = None) -> StepBundle:
    """fn(params, trainable, tokens) -> (last logits (B, 1, V), cache)."""
    k = k if k is not None else (cfg.moe.top_k or None)
    num_groups = (num_groups if num_groups is not None else
                  choose_num_groups(cfg, shape.global_batch, shape.seq_len))

    def step(params, trainable, tokens):
        return model_lib.prefill(cfg, params, tokens, trainable=trainable,
                                 k=k, num_groups=num_groups,
                                 dispatch="capacity")

    a_params = abstract_params(cfg)
    return StepBundle(
        name="prefill_step", fn=step,
        args=(a_params, abstract_trainable(cfg, k or 0),
              input_specs(cfg, shape)["tokens"]),
        meta={"num_groups": num_groups, "k": k,
              "cache_bytes": state_bytes(abstract_cache(
                  cfg, shape.global_batch, shape.seq_len)),
              "param_bytes": state_bytes(a_params)})


def build_serve(cfg: ModelConfig, shape: ShapeConfig, *,
                k: Optional[int] = None) -> StepBundle:
    """ONE new token with a ``seq_len``-deep cache: fn(params, trainable,
    cache, tokens (B, 1), pos) -> (logits (B, 1, V), cache), the cache
    written in place."""
    k = k if k is not None else (cfg.moe.top_k or None)

    def step(params, trainable, cache, tokens, pos):
        return model_lib.decode_step(cfg, params, cache, tokens, pos,
                                     trainable=trainable, k=k,
                                     dispatch="capacity")

    a_params = abstract_params(cfg)
    a_cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    inputs = input_specs(cfg, shape)
    return StepBundle(
        name="serve_step", fn=step,
        args=(a_params, abstract_trainable(cfg, k or 0), a_cache,
              inputs["tokens"], inputs["pos"]),
        meta={"k": k, "cache_bytes": state_bytes(a_cache),
              "param_bytes": state_bytes(a_params)})


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               **overrides) -> StepBundle:
    if shape.kind == "train":
        return build_train(cfg, shape, **overrides)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, **overrides)
    return build_serve(cfg, shape, **overrides)
