"""Step functions: the port of ``repro/launch/steps.py``, on one device
or on the card mesh (``mesh=``).

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

The mesh (``mesh=`` a ``launch.mesh.Mesh``; ``None`` keeps the
single-device step, bit for bit).  Every rank calls the step on its
shards (``launch/sharding.py``: ``shard_tree`` or ``init_sharded_*``)
and its rows of the batch (:func:`shard_batch`); the model runs its
sharded path (``models/parallel.py``).  The train step then all-reduces
over the batch axes the gradient of every leaf not split on ``data``
(those split there were reduce-scattered by their gather's backward; the
``pod`` axis is all-reduced after it), and the activation counts; the
clipping norm sums each leaf's squares over the axes the leaf is split
on.  The loss is the global batch's masked mean on every rank.  The knob
chooser follows the reference's data-parallel arithmetic against each
rank's own bytes (its shards and trainable state, a layer's FSDP gathers
and the LoRA backward's fp32 copies, its activations with heads, FFN
columns, experts and vocabulary split ``model`` ways, all of what
``memory_bytes`` leaves: no fraction is held back, so a caller passes the
card's memory less its reserve).  ``act_mode`` is ``"batch"`` when one
microbatch fits so, else ``"dmodel"`` (the reference's last resort: the
checkpointed carries held as each rank's 1/M of D, counted so in
:func:`activation_bytes`); a step where neither fits raises
:class:`DoesNotFit`.  ``"sp"`` (the carries held as each rank's 1/M of
the sequence, Megatron-style) is never chosen, only asked for, as in the
reference.  Both run in ``models/model.py`` (``Shard.act_mode``) and give
the ``"batch"`` step's result bit for bit.
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
from ..models.parallel import Shard, all_reduce
from ..optim import adam
from ..tree import leaves, tree_map, tree_map_with_path
from . import sharding as shd

PyTree = Any
_F32 = torch.float32

# share of (device memory - parameters - trainable state) the saved
# activations of one microbatch may take
ACT_BUDGET_FRACTION = 0.5


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Any                      # the step, a plain callable on tensors
    args: Tuple[PyTree, ...]     # example args (meta tensors, global shapes)
    meta: Dict[str, Any]
    specs: Optional[Dict[str, Any]] = None   # the mesh's spec trees


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
                     k: Optional[int] = None, model_ways: int = 1,
                     carry_ways: int = 1) -> int:
    """Estimated peak autograd footprint of one sequence of ``seq_len``
    tokens under layer checkpointing (the module docstring lists the
    terms), over the P positions of one period.  ``model_ways``: on the
    mesh, the terms that scale with heads, FFN columns, expert slots and
    the vocabulary are one rank's share; ``carry_ways``: the checkpointed
    carries are one rank's share too (``act_mode`` "dmodel" or "sp")."""
    M = model_ways
    S, d = seq_len, cfg.d_model
    n_periods = cfg.num_layers // cfg.pattern_period
    n_saved = (n_periods // remat_chunk + remat_chunk if remat_chunk > 1
               else n_periods)
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    carries = n_saved * S * d * itemsize // carry_ways
    hd = cfg.head_dim_
    m = cfg.moe
    kinds = [cfg.layer_kind(j) for j in range(cfg.pattern_period)]
    acts = extra = 0
    if "attn" in kinds:
        # the plain flash backward's (H, S, S) fp32 recompute, one layer
        extra += 3 * cfg.n_heads * S * S * 4 // M
    if "ssm" in kinds:
        # the SSD's (H, L, L) fp32 transients and their gradients, as the
        # reference's knob rule counts them (one layer at a time; a rank
        # runs H/M heads)
        dims = ssm_mod.mamba_dims(cfg)
        extra += (3 * S * dims["n_heads"] * min(cfg.ssm.chunk_size, S) * 4
                  // M)
    for j, kind in enumerate(kinds):
        if kind == "attn":
            acts += (S * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd // M
                     + 2 * S * d)
        else:
            # in_proj's output whole (gathered on the mesh); the conv, the
            # scan's output and the norm over this rank's heads
            acts += (S * (dims["in_dim"] + (dims["conv_dim"]
                                            + 2 * dims["d_inner"]) // M)
                     + 2 * S * d)
        if cfg.layer_is_moe(j):
            kk = k or m.top_k
            group = min(S, 2048)
            acts += (S * kk * 3 * m.d_expert + S * 3 * m.d_shared_expert) // M
            # (G, Tg, E, C) fp32 dispatch and combine: C ~ Tg·k·cf/E
            acts += int(2 * S * group * kk * m.capacity_factor)
        else:
            acts += S * 3 * cfg.d_ff // M
    # one period's activations and their gradients, fp32 at most
    layer = 2 * 4 * acts
    ce = S * cfg.vocab_size * 6 // M     # fp32 logits kept + a bf16 chunk
    return carries + layer + extra + ce


def _data_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def rank_bytes(tree: PyTree, specs: PyTree, mesh) -> int:
    """Bytes of one rank's shards of ``tree`` (abstract leaves)."""
    total = 0

    def add(path, leaf):
        nonlocal total
        n = 1
        for d in shd.local_shape(leaf.shape, shd.specs_at(specs, path),
                                 mesh):
            n *= d
        total += n * leaf.element_size()
    tree_map_with_path(add, tree)
    return total


def period_gather_bytes(cfg: ModelConfig, a_params, mesh,
                        copies: int = 3) -> int:
    """A period's frozen weights as one rank holds them after the FSDP
    gather (split ``model`` ways only), times ``copies``: in training
    three, the gathered copy and, in the backward, the LoRA backward's
    fp32 copy."""
    n = cfg.num_layers // cfg.pattern_period
    per = sum(t.numel() * t.element_size()
              for t in leaves(a_params["blocks"])) // max(n, 1)
    return copies * per // mesh.shape.get("model", 1)


class DoesNotFit(ValueError):
    """One microbatch of one sequence exceeds a rank's budget in every
    activation mode the chooser may pick."""


def _mesh_knobs(cfg, shape, mesh, memory_bytes, k):
    """The reference's data-parallel n_micro rule against one rank's
    bytes (the module docstring): the microbatch's activations must fit
    what ``memory_bytes`` leaves after the rank's shards, trainable state
    and FSDP gathers, in "batch" if they fit so, else in "dmodel"."""
    dp = _data_size(mesh)
    M = mesh.shape.get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    n_periods = cfg.num_layers // cfg.pattern_period
    chunk = _remat_chunk(n_periods)
    a_params = abstract_params(cfg)
    a_train = tree_map(lambda t: t.to(_F32), abstract_trainable(cfg, k or 0))
    param_bytes = rank_bytes(a_params, shd.param_specs(cfg, a_params, mesh),
                             mesh)
    train_bytes = 4 * rank_bytes(
        a_train, shd.trainable_specs(cfg, a_train, mesh), mesh)
    fixed = param_bytes + train_bytes + period_gather_bytes(cfg, a_params,
                                                            mesh)
    # the gathers' fp32 copies are counted in ``fixed`` and the activations
    # at their worst, so a rank's budget is all that is left of
    # ``memory_bytes`` (the caller keeps its reserve out of it)
    budget = max(memory_bytes - fixed, 0)
    tried = []
    for mode in ("batch", "dmodel"):
        per_seq = activation_bytes(cfg, S, chunk, k, model_ways=M,
                                   carry_ways=1 if mode == "batch" else M)
        n_micro = 1
        while n_micro < B // max(dp, 1):
            if max(B // (n_micro * dp), 1) * per_seq <= budget:
                break
            n_micro *= 2
        mb_local = max(B // (n_micro * dp), 1)
        if mb_local * per_seq <= budget:
            return {"n_micro": n_micro, "act_mode": mode,
                    "remat_chunk": chunk if chunk > 1 else 0,
                    "act_bytes": mb_local * per_seq, "act_budget": budget,
                    "rank_param_bytes": param_bytes,
                    "rank_train_bytes": train_bytes,
                    "rank_fixed_bytes": fixed}
        tried.append(f"{mode} {per_seq / 2 ** 30:.2f} GiB")
    raise DoesNotFit(
        f"{cfg.name} x {shape.name} on {mesh.shape}: one sequence's "
        f"activations ({', '.join(tried)}) exceed a rank's budget "
        f"({budget / 2 ** 30:.2f} GiB): cut the depth or the sequence")


def deepest_fit(cfg: ModelConfig, shape: ShapeConfig, mesh,
                memory_bytes: int, k: Optional[int] = None) -> int:
    """The most layers, in whole periods of the layer pattern, at which
    one rank's shards, trainable state, FSDP gathers and one microbatch's
    activations fit ``memory_bytes`` by :func:`choose_train_knobs`'s
    estimate on the ``mesh`` ("batch" or "dmodel"); 0 if not even one
    period fits."""
    P = cfg.pattern_period

    def fits(n):
        try:
            _mesh_knobs(cfg.replace(num_layers=n * P), shape, mesh,
                        memory_bytes, k)
            return True
        except DoesNotFit:
            return False

    return most_periods(fits, cfg.num_layers // P) * P


def most_periods(fits, n_periods: int) -> int:
    """The largest n <= ``n_periods`` with ``fits(n)`` (``fits`` holding
    for every smaller n too), 0 if none."""
    lo, hi = 0, n_periods
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def choose_train_knobs(cfg: ModelConfig, shape: ShapeConfig, *,
                       memory_bytes: Optional[int] = None,
                       device="cuda", k: Optional[int] = None,
                       mesh=None) -> Dict[str, Any]:
    """Pick (n_micro, remat_chunk) so one microbatch's footprint fits the
    card's activation budget (the module docstring's rule): two-level √L
    checkpointing, and the fewest microbatches that fit (n_micro doubles
    from 1; a model whose one-sequence microbatch does not fit gets
    ``n_micro = global_batch``).  ``act_mode`` is ``"batch"``: one card
    has no other axis to shard the activations over.  ``memory_bytes``
    defaults to :func:`device_bytes` of ``device``.  On the ``mesh``: the
    reference's data-parallel rule against one rank's bytes
    (``n_micro`` up to B / data ways), ``"batch"`` when it fits, else
    ``"dmodel"`` (the module docstring)."""
    if memory_bytes is None:
        memory_bytes = device_bytes(device)
    if mesh is not None:
        return _mesh_knobs(cfg, shape, mesh, memory_bytes, k)
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
                      target_group: int = 2048, mesh=None) -> int:
    """GShard routing groups of the capacity dispatch over ``batch`` x
    ``seq`` global tokens: T_g stays near ``target_group`` tokens, since
    capacity C grows with T_g·k/E and the (G, T_g, E, C) one-hots with T_g
    squared; on the ``mesh`` G is rounded up to the data parallelism, so
    each rank holds whole groups (as the reference's)."""
    if not cfg.moe.enabled:
        return 1
    T = batch * seq
    if T <= target_group:
        return 1
    g = 1
    while g * 2 <= T // target_group and T % (g * 2) == 0:
        g *= 2
    dp = 1 if mesh is None else _data_size(mesh)
    while g < dp and T % (g * 2) == 0:     # >= one group per data shard
        g *= 2
    return g


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def shard_batch(t: torch.Tensor, mesh, n_micro: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch (B, ...): microbatch ``i`` is
    global rows ``[i·mb, (i+1)·mb)`` split over the batch axes, as the
    reference's train step reshapes its batch (with ``n_micro`` 1, the
    batch spec's contiguous block).  A batch that does not divide the
    batch axes is replicated: every rank gets it whole."""
    dp = _data_size(mesh)
    B = t.shape[0]
    if B % (dp * n_micro):
        if n_micro == 1:
            return t
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches over {dp} data ways")
    mb = B // n_micro
    mbl = mb // dp
    i = mesh.index(tuple(a for a in ("pod", "data")
                         if a in mesh.axis_names))
    return torch.cat([t[j * mb + i * mbl:j * mb + (i + 1) * mbl]
                      for j in range(n_micro)])


def _reduce_grads(grads: PyTree, t_specs: PyTree, mesh) -> PyTree:
    """Each leaf's gradient all-reduced over the batch axes it is not
    split on (a leaf split on ``data`` was reduce-scattered there)."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def red(path, g):
        axes = shd.spec_axes(shd.specs_at(t_specs, path))
        group = mesh.group(tuple(a for a in baxes if a not in axes))
        return g if group is None else all_reduce(g, group)
    return tree_map_with_path(red, grads)


def _norm_groups(t_specs: PyTree, mesh) -> PyTree:
    return tree_map(lambda spec: mesh.group(shd.spec_axes(spec)), t_specs)


def make_train_step(cfg: ModelConfig, *, k: Optional[int], tc: TrainConfig,
                    n_micro: int, num_groups: int, remat: bool = True,
                    remat_chunk: int = 0, rescaler_trainable: bool = True,
                    mesh=None, t_specs: Optional[PyTree] = None,
                    act_mode: str = "batch"):
    """Returns step(params, trainable, opt_state, tokens, labels, mask)
    -> (trainable, opt_state, metrics): the reference's step.  Gradients
    of the ``n_micro`` microbatches are summed in fp32 in order and divided
    by ``n_micro``; the loss is their mean; ``metrics["counts"]`` sums the
    activation counts per ``pos{p}``.  On the ``mesh`` (with the trainable
    tree's spec tree ``t_specs``): the module docstring's reductions; the
    batch is this rank's rows (:func:`shard_batch` with ``n_micro``), the
    loss, counts and token count the global batch's; ``act_mode`` (one of
    ``parallel.ACT_MODES``) how the checkpointed carries are held.  One
    device (``mesh`` None) runs ``"batch"`` only."""
    if mesh is None and act_mode != "batch":
        raise ValueError(f"act_mode {act_mode!r}: one device runs 'batch' "
                         "only")
    shard = None if mesh is None else Shard(mesh, act_mode=act_mode)
    dp = 1 if mesh is None else _data_size(mesh)
    norm_groups = None if mesh is None else _norm_groups(t_specs, mesh)

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
                num_groups=num_groups, shard=shard)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            for t, g in zip(flat, grads):
                if g is not None:
                    g_acc[id(t)] = g_acc[id(t)] + g.to(_F32)
            for key in c_acc:
                c_acc[key] = c_acc[key] + counts[key]
            l_acc = l_acc + loss.detach().to(_F32)
        grads = tree_map(lambda t: g_acc[id(t)] / n_micro, tr)
        if mesh is not None:
            grads = _reduce_grads(grads, t_specs, mesh)
            group = shard.batch
            if group is not None:
                c_acc = {key: all_reduce(c, group)
                         for key, c in c_acc.items()}
        if not rescaler_trainable and "rescaler" in grads:
            grads["rescaler"] = tree_map(torch.zeros_like,
                                         grads["rescaler"])
        new_trainable, new_opt = adam.update(
            grads, opt_state, trainable, lr=tc.learning_rate,
            beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
            weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
            norm_groups=norm_groups)
        metrics = {"loss": l_acc / n_micro, "counts": c_acc,
                   "tokens": float(B * S * dp)}
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
                device="cuda", mesh=None,
                memory_bytes: Optional[int] = None,
                act_mode: Optional[str] = None) -> StepBundle:
    """The train step with its knobs: each one not given is chosen by
    :func:`choose_train_knobs` for ``device``'s memory (or
    ``memory_bytes``) and :func:`choose_num_groups`.  ``mesh``: the card
    mesh's step (the module docstring); ``specs`` holds the parameter,
    trainable and optimizer spec trees, and ``meta`` each rank's bytes
    (``act_bytes`` one microbatch's in the mode that runs) and in
    ``act_mode`` the mode that runs ("batch" where the ``model`` axis has
    one rank)."""
    tc = tc or TrainConfig()
    k = k if k is not None else (cfg.moe.top_k or None)
    knobs = choose_train_knobs(cfg, shape, device=device, k=k, mesh=mesh,
                               memory_bytes=memory_bytes)
    n_micro = n_micro if n_micro is not None else knobs["n_micro"]
    act_mode = act_mode if act_mode is not None else knobs["act_mode"]
    remat_chunk = (remat_chunk if remat_chunk is not None
                   else knobs["remat_chunk"])
    num_groups = (num_groups if num_groups is not None else
                  choose_num_groups(cfg, shape.global_batch // n_micro,
                                    shape.seq_len, mesh=mesh))
    args = _train_args(cfg, shape, k)
    act_bytes = knobs["act_bytes"]
    specs = t_specs = None
    if mesh is not None:
        if shape.global_batch % (n_micro * _data_size(mesh)):
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split into {n_micro} microbatches over "
                             f"{_data_size(mesh)} data ways")
        M = mesh.shape.get("model", 1)
        act_bytes = max(shape.global_batch // (n_micro * _data_size(mesh)),
                        1) * activation_bytes(
            cfg, shape.seq_len, remat_chunk, k, model_ways=M,
            carry_ways=1 if act_mode == "batch" else M)
        t_specs = shd.trainable_specs(cfg, args[1], mesh)
        specs = {"params": shd.param_specs(cfg, args[0], mesh),
                 "trainable": t_specs, "opt": shd.opt_specs(t_specs),
                 "batch": shd.batch_spec(shape.global_batch, mesh,
                                         len(args[3].shape) - 1)}
    step = make_train_step(cfg, k=k, tc=tc, n_micro=n_micro,
                           num_groups=num_groups, remat=remat,
                           remat_chunk=remat_chunk, mesh=mesh,
                           t_specs=t_specs, act_mode=act_mode)
    runs = act_mode if mesh is not None and M > 1 else "batch"
    meta = {"n_micro": n_micro, "act_mode": runs,
            "num_groups": num_groups, "k": k, "remat": remat,
            "remat_chunk": remat_chunk,
            "param_bytes": state_bytes(args[0]),
            "trainable_bytes": state_bytes(args[1]),
            "act_bytes": act_bytes,
            "act_budget": knobs["act_budget"]}
    if mesh is not None:
        meta.update(mesh=dict(mesh.shape),
                    **{key: knobs[key] for key in (
                        "rank_param_bytes", "rank_train_bytes",
                        "rank_fixed_bytes")})
    return StepBundle(name="train_step", fn=step, args=args, meta=meta,
                      specs=specs)


# --------------------------------------------------------------------------
# prefill and serve (decode) steps
# --------------------------------------------------------------------------

def _mesh_specs(cfg, shape, mesh, a_params, a_train, a_cache):
    return {"params": shd.param_specs(cfg, a_params, mesh),
            "trainable": shd.trainable_specs(cfg, a_train, mesh),
            "cache": shd.cache_specs(cfg, a_cache, mesh, shape.global_batch),
            "batch": shd.batch_spec(shape.global_batch, mesh, 1)}


def _shard_for(mesh, batch: int, cache_len: Optional[int] = None):
    if mesh is None:
        return None
    return Shard(mesh, batch_sharded=batch % _data_size(mesh) == 0,
                 cache_len=cache_len)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, *,
                  k: Optional[int] = None,
                  num_groups: Optional[int] = None, mesh=None) -> StepBundle:
    """fn(params, trainable, tokens) -> (last logits (B, 1, V), cache).
    On the ``mesh``: this rank's shards and rows (:func:`shard_batch`), the
    logits whole, the cache this rank's rows and slice of the sequence,
    every KV head (``sharding.cache_specs``, in ``specs["cache"]``;
    ``sharding.grow_cache`` deepens it for :func:`build_serve`)."""
    k = k if k is not None else (cfg.moe.top_k or None)
    num_groups = (num_groups if num_groups is not None else
                  choose_num_groups(cfg, shape.global_batch, shape.seq_len,
                                    mesh=mesh))
    shard = _shard_for(mesh, shape.global_batch)

    def step(params, trainable, tokens):
        return model_lib.prefill(cfg, params, tokens, trainable=trainable,
                                 k=k, num_groups=num_groups,
                                 dispatch="capacity", shard=shard)

    a_params = abstract_params(cfg)
    a_train = abstract_trainable(cfg, k or 0)
    a_cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    return StepBundle(
        name="prefill_step", fn=step,
        args=(a_params, a_train, input_specs(cfg, shape)["tokens"]),
        meta={"num_groups": num_groups, "k": k,
              "cache_bytes": state_bytes(a_cache),
              "param_bytes": state_bytes(a_params)},
        specs=None if mesh is None else _mesh_specs(cfg, shape, mesh,
                                                    a_params, a_train,
                                                    a_cache))


def build_serve(cfg: ModelConfig, shape: ShapeConfig, *,
                k: Optional[int] = None, mesh=None) -> StepBundle:
    """ONE new token with a ``seq_len``-deep cache: fn(params, trainable,
    cache, tokens (B, 1), pos) -> (logits (B, 1, V), cache), the cache
    written in place.  On the ``mesh``: as :func:`build_prefill`'s; each
    rank attends its slice of the cache and the ranks' partial softmaxes
    are merged over ``model``."""
    k = k if k is not None else (cfg.moe.top_k or None)
    shard = _shard_for(mesh, shape.global_batch,
                       model_lib.cache_len_for(cfg, shape.seq_len))

    def step(params, trainable, cache, tokens, pos):
        return model_lib.decode_step(cfg, params, cache, tokens, pos,
                                     trainable=trainable, k=k,
                                     dispatch="capacity", shard=shard)

    a_params = abstract_params(cfg)
    a_train = abstract_trainable(cfg, k or 0)
    a_cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    inputs = input_specs(cfg, shape)
    return StepBundle(
        name="serve_step", fn=step,
        args=(a_params, a_train, a_cache, inputs["tokens"], inputs["pos"]),
        meta={"k": k, "cache_bytes": state_bytes(a_cache),
              "param_bytes": state_bytes(a_params)},
        specs=None if mesh is None else _mesh_specs(cfg, shape, mesh,
                                                    a_params, a_train,
                                                    a_cache))


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               **overrides) -> StepBundle:
    if shape.kind == "train":
        return build_train(cfg, shape, **overrides)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, **overrides)
    return build_serve(cfg, shape, **overrides)
