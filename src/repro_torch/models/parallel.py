"""The model's sharded path: collectives inside autograd.

On the card mesh (``launch/mesh.py``) every rank holds its shard of the
parameters and adapters (``launch/sharding.py``'s rules) and of the batch,
and runs the same model code on them; the functions here put the
collectives that make each rank's result the unsharded model's.  They are
the four operators of Megatron-style tensor parallelism plus the FSDP
gathers, each a no-op on an axis of one rank:

  * :func:`copy_to` — identity forward, all-reduce backward: on the
    replicated input of a column-split product (and on a replicated
    adapter factor used there), whose gradient each rank holds only in
    part;
  * :func:`reduce_from` — all-reduce forward, identity backward: after a
    row-split product, the vocabulary-split embedding and the expert-split
    MoE combine, whose outputs are partial sums;
  * :func:`gather` — all-gather forward, reduce-scatter backward: an
    adapter factor stored split (``a`` on ``data``, a row-split ``b`` on
    ``model``) but used whole by partial computations;
  * :func:`vocab_parallel_nll` — the cross-entropy over vocabulary-split
    logits, with its own backward;
  * :func:`split_to` / :func:`gather_from` — Megatron's split / gather
    pair for a tensor whose gradient every rank of the group holds whole
    (the residual stream between periods under ``act_mode`` "dmodel" or
    "sp", ``models/model.py``): this rank's slice forward and an
    all-gather backward, and the reverse.  :func:`gather` is not that
    pair: its backward reduce-scatters, which would add up the group's
    identical copies of such a gradient.

Frozen weights are gathered outside autograd (:func:`gather_frozen`):
they carry no gradient; so is a prefill's cache redistributed
(:func:`all_to_all`).  Collectives use ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single``, on NCCL on the cards and on gloo in the CPU tests;
none sits inside a kernel.

:func:`comm_start` / :func:`comm_stop` count every collective of this
module between them: calls, bytes (the tensor each rank sends in) and
time (CUDA events on the current stream around each call, so a call's
time includes waiting for the slowest rank to arrive; host time on the
CPU) and, per call, the shape and dtype sent and the group's ranks (the
roofline charges a group inside one node and one across nodes at
different rates).  Off by default: the path then runs no event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

_F32 = torch.float32


ACT_MODES = ("batch", "dmodel", "sp")


@dataclasses.dataclass
class Shard:
    """What the sharded model needs of the mesh: the groups and sizes of
    its axes, whether this step's batch is split over the batch axes (a
    batch that does not divide them is replicated), how the residual
    stream is held between checkpointed periods (``act_mode``, one of
    :data:`ACT_MODES`: whole on every ``model`` rank, or this rank's
    slice of D or of S) and, for a decode step, the global depth of the
    cache it is handed (``cache_len``: ``sharding.cache_specs`` splits
    that depth over ``model`` where it divides, so a rank's slice alone
    does not tell)."""
    mesh: Any
    batch_sharded: bool = True
    act_mode: str = "batch"
    cache_len: Optional[int] = None

    def __post_init__(self):
        if self.act_mode not in ACT_MODES:
            raise ValueError(f"act_mode {self.act_mode!r}: one of "
                             f"{ACT_MODES}")

    @property
    def model(self):
        return self.mesh.group("model")

    @property
    def M(self) -> int:
        return self.mesh.size("model")

    @property
    def mi(self) -> int:
        return self.mesh.index("model")

    @property
    def data(self):
        return self.mesh.group("data")

    @property
    def D(self) -> int:
        return self.mesh.size("data")

    @property
    def batch_axes(self):
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def batch(self):
        """The batch axes' group, or None when the batch is replicated."""
        return self.mesh.group(self.batch_axes) if self.batch_sharded else None

    @property
    def B(self) -> int:
        """Ways the batch is split (1 when replicated)."""
        return self.mesh.size(self.batch_axes) if self.batch_sharded else 1

    @property
    def bi(self) -> int:
        return self.mesh.index(self.batch_axes) if self.batch_sharded else 0


_COMM: Dict[str, Optional[List]] = {"calls": None}


def comm_start() -> None:
    """Start counting this module's collectives (the module docstring)."""
    _COMM["calls"] = []


def comm_stop(log: bool = False) -> Dict[str, Any]:
    """Stop counting; returns {"calls", "bytes", "ms", "by_kind": {kind:
    [calls, bytes, ms]}} since :func:`comm_start`, and with ``log`` also
    "log": [{"kind", "bytes", "ms", "shape", "dtype", "ranks"} per call,
    in order]."""
    calls, _COMM["calls"] = _COMM["calls"] or [], None
    if calls and isinstance(calls[0][2], torch.cuda.Event):
        torch.cuda.synchronize()
    out = {"calls": len(calls), "bytes": 0, "ms": 0.0, "by_kind": {}}
    if log:
        out["log"] = []
    for kind, nbytes, t0, t1, shape, dtype, ranks in calls:
        ms = (t0.elapsed_time(t1) if isinstance(t0, torch.cuda.Event)
              else (t1 - t0) * 1e3)
        out["bytes"] += nbytes
        out["ms"] += ms
        k = out["by_kind"].setdefault(kind, [0, 0, 0.0])
        k[0] += 1
        k[1] += nbytes
        k[2] += ms
        if log:
            out["log"].append({"kind": kind, "bytes": nbytes, "ms": ms,
                               "shape": shape, "dtype": dtype,
                               "ranks": ranks})
    return out


def _run(kind: str, x: torch.Tensor, fn, group) -> None:
    calls = _COMM["calls"]
    if calls is None:
        fn()
        return
    if x.is_cuda:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
    else:
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
    calls.append((kind, x.numel() * x.element_size(), t0, t1,
                  list(x.shape), str(x.dtype).replace("torch.", ""),
                  list(dist.get_process_group_ranks(group))))


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place on a contiguous copy; returns it."""
    x = x.contiguous()
    _run("all_reduce", x, lambda: dist.all_reduce(x, op=op, group=group),
         group)
    return x


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
    _run("all_gather", moved, lambda: dist.all_gather_into_tensor(
        out, moved, group=group), group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    _run("reduce_scatter", moved, lambda: dist.reduce_scatter_tensor(
        out, moved, group=group), group)
    return out.movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same gradient to other functions
        return all_reduce(g.clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``group``."""
    if group is None or not x.requires_grad:
        return x
    return _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward, identity backward."""
    if group is None:
        return x
    if not x.requires_grad:
        return all_reduce(x.clone(), group)
    return _Reduce.apply(x, group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter backward."""
    if group is None:
        return x
    if not x.requires_grad:
        return _all_gather(x, group, dim)
    return _Gather.apply(x, group, dim)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of ``dim`` (its own storage, so the whole tensor
    can be freed)."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} tensor "
                         f"({x.shape[dim]}) does not split {n} ways")
    chunk = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * chunk, chunk).clone(
        memory_format=torch.contiguous_format)


def _whole(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The all-gather of ``dim`` laid out as a contiguous tensor: the
    blocks then see the memory layout, and so the rounding, of the
    "batch" mode's carry."""
    return _all_gather(x, group, dim).contiguous()


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _whole(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of ``dim`` forward; the gradient's slices
    all-gathered backward.  ``x`` must be whole and alike on every rank of
    ``group``; a ``dim`` that does not split evenly raises ``ValueError``."""
    if group is None:
        return x
    return _SplitTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather of ``dim`` forward; backward, this rank's slice of the
    gradient, which every rank of ``group`` holds whole and alike."""
    if group is None:
        return x
    return _GatherFrom.apply(x, group, dim)


@torch.no_grad()
def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of ``x``'s dim 0 (``x.shape[0]`` = the group's size)
    sent to rank ``j`` of ``group``; block ``j`` of the result is what rank
    ``j`` sent this rank (no autograd)."""
    if group is None:
        return x
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    _run("all_to_all", x, lambda: dist.all_to_all_single(out, x,
                                                         group=group), group)
    return out


@torch.no_grad()
def gather_frozen(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A frozen weight's whole ``dim`` from its shards (no autograd): the
    FSDP gather just before a layer uses it."""
    if group is None:
        return w
    return _all_gather(w.detach(), group, dim)


def split_dim(full: int, local: int, ways: int, what: str) -> bool:
    """Whether a dim of ``full`` features stored as ``local`` is split
    ``ways`` ways (the rule dropped the axis when it did not divide)."""
    if local == full:
        return False
    if local * ways != full:
        raise ValueError(f"{what}: local {local} of {full} over {ways}")
    return True


# --------------------------------------------------------------------------
# the vocabulary-parallel cross-entropy
# --------------------------------------------------------------------------

class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, v0, group):
        # logits (N, Vl) fp32: this rank's vocabulary columns [v0, v0+Vl)
        Vl = logits.shape[-1]
        m = logits.max(dim=-1).values
        m = all_reduce(m, group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[:, None])
        se = all_reduce(e.sum(-1), group)
        lse = m + torch.log(se)
        rel = labels.long() - v0
        mine = (rel >= 0) & (rel < Vl)
        idx = rel.clamp(0, Vl - 1)
        gold = torch.gather(logits, -1, idx[:, None])[:, 0] * mine
        gold = all_reduce(gold, group)
        ctx.save_for_backward(e, se, idx, mine)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e * (g / se)[:, None]
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, idx] -= g * mine
        return grad, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                       group) -> torch.Tensor:
    """Per-row NLL ``logsumexp(z) - z[label]`` of logits whose vocabulary
    is split over ``group`` (this rank's columns start at ``v0``): the row
    max, the sum of exponentials and the label's logit are each
    all-reduced over ``group``.  logits (N, Vl) fp32, labels (N,)."""
    return _VocabNLL.apply(logits, labels, v0, group)
