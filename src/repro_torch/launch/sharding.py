"""Sharding rules for every parameter / state / input tree: a port of
``repro/launch/sharding.py``.

A spec is a plain tuple with one entry per dim of a leaf: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
their product, the first axis major) — the entries of the reference's
``PartitionSpec``, so ``tuple(P(...))`` of the reference equals the spec
here.  The rules are the reference's, leaf for leaf:

  * every large matrix: output features (or the expert axis) on
    ``model``, input features on ``data`` (FSDP);
  * LoRA adapters follow their base weight (``a``'s input features on
    ``data``, ``b``'s output features on ``model``; an expert adapter's
    expert axis on ``model``); ranks and rescalers replicated;
  * the batch on ``("pod", "data")`` when it divides, else replicated;
  * an axis that does not divide its dim is dropped (``_maybe``).

The reference hands these specs to GSPMD, which places every collective.
In the port each rank holds its shard (:func:`shard_tree`, or
:func:`init_sharded_params` / :func:`init_sharded_lora`, which make only
this rank's shard) and the model's sharded path (``models/parallel.py``)
runs the collectives itself.
"""
from __future__ import annotations

import zlib
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..optim.adam import AdamState
from ..tree import tree_map, tree_map_with_path

PyTree = Any
Spec = Tuple[Any, ...]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _path_str(path: Sequence[str]) -> str:
    return "/".join(str(p) for p in path)


def _divisible(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return dim % size == 0


def _maybe(spec_axes, dim: int, mesh):
    """Drop a sharding axis when the dim isn't divisible."""
    if spec_axes and _divisible(dim, mesh, spec_axes):
        return spec_axes
    return None


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: Tuple[str, ...]):
    """A dim's spec entry for ``axes``: None, one axis name, or a tuple of
    two or more (``PartitionSpec`` stores a one-axis tuple as its name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits a dim over."""
    return tuple(a for e in spec for a in _axes_of(e))


def _ways(mesh, entry) -> int:
    n = 1
    for a in _axes_of(entry):
        n *= mesh.shape[a]
    return n


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(s // _ways(mesh, e) for s, e in zip(shape, spec))


# --------------------------------------------------------------------------
# base parameters
# --------------------------------------------------------------------------

def _param_rule(path: str, shape: Tuple[int, ...], mesh,
                fsdp: Optional[str], model: str) -> Spec:
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]

    # ---- embedding / head ----
    if path.startswith("embed"):
        if nd == 3:   # (K, V, D) codebooks
            return (None, _maybe(model, shape[1], mesh), None)
        return (_maybe(model, shape[0], mesh), None)             # (V, D)
    if path.startswith("lm_head"):
        if nd == 3:   # (K, D, V)
            return (None, None, _maybe(model, shape[2], mesh))
        return (None, _maybe(model, shape[1], mesh))             # (D, V)
    if path.startswith("final_norm"):
        return ()

    # ---- blocks (leading axis = n_periods, always unsharded) ----
    if "experts" in path:
        # (np, E, d_in, d_out): expert-parallel on model, FSDP on d_in
        return (None, _maybe(model, shape[1], mesh),
                _maybe(fsdp, shape[2], mesh), None)
    if leaf == "router":
        return (None, None, None)                                 # small
    if leaf in ("wq", "wk", "wv", "w1", "w3", "in_proj"):
        return (None, _maybe(fsdp, shape[1], mesh),
                _maybe(model, shape[2], mesh))
    if leaf in ("wo", "w2", "out_proj"):
        return (None, _maybe(model, shape[1], mesh),
                _maybe(fsdp, shape[2], mesh))
    # norms, conv, dt_bias, A_log, D, rescalers, scalars -> replicated
    return (None,) * nd


def _fsdp(mesh) -> Optional[str]:
    return "data" if "data" in mesh.axis_names else None


def param_specs(cfg, abstract_params: PyTree, mesh) -> PyTree:
    """Spec tree mirroring ``model.init_params``'s output."""
    fsdp = _fsdp(mesh)
    return tree_map_with_path(
        lambda path, leaf: _param_rule(_path_str(path), tuple(leaf.shape),
                                       mesh, fsdp, "model"),
        abstract_params)


# --------------------------------------------------------------------------
# trainable tree (LoRA + rescaler)
# --------------------------------------------------------------------------

def _lora_rule(path: str, shape: Tuple[int, ...], mesh,
               fsdp: Optional[str], model: str) -> Spec:
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]
    if "rescaler" in path:
        return (None,) * nd
    if "experts" in path:
        # a: (np, E, d_in, r) / b: (np, E, r, d_out) — follow the experts
        if leaf == "a":
            return (None, _maybe(model, shape[1], mesh),
                    _maybe(fsdp, shape[2], mesh), None)
        return (None, _maybe(model, shape[1], mesh), None, None)
    if leaf == "a":   # (np, d_in, r): d_in like the base weight's input
        return (None, _maybe(fsdp, shape[1], mesh), None)
    if leaf == "b":   # (np, r, d_out): d_out on model
        return (None, None, _maybe(model, shape[2], mesh))
    return (None,) * nd


def trainable_specs(cfg, abstract_trainable: PyTree, mesh) -> PyTree:
    fsdp = _fsdp(mesh)
    return tree_map_with_path(
        lambda path, leaf: _lora_rule(_path_str(path), tuple(leaf.shape),
                                      mesh, fsdp, "model"),
        abstract_trainable)


def opt_specs(trainable_spec: PyTree) -> AdamState:
    """Adam's moments mirror the trainable tree; the step is a scalar."""
    return AdamState(step=(), mu=trainable_spec,
                     nu=tree_map(lambda s: s, trainable_spec))


# --------------------------------------------------------------------------
# inputs / batch / activations
# --------------------------------------------------------------------------

def batch_spec(global_batch: int, mesh, extra_dims: int = 1) -> Spec:
    """(B, S, ...) — B over ("pod", "data") when divisible."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    lead = _entry(axes) if global_batch % size == 0 else None
    return (lead,) + (None,) * extra_dims


def activation_spec(mesh, mode: str, batch_ok: bool = True) -> Spec:
    """The (B, S, D) residual stream's spec: "batch" (B on the batch
    axes), "dmodel" (also D on model), "seq" (S on model).  The port's
    steps run "batch" only."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    b = _entry(baxes) if batch_ok else None
    if mode == "dmodel":
        return (b, None, "model")
    if mode == "seq":
        return (b, "model", None)
    return (b, None, None)


# --------------------------------------------------------------------------
# decode cache
# --------------------------------------------------------------------------

def cache_specs(cfg, abstract_cache: PyTree, mesh, batch: int) -> PyTree:
    """KV cache (np, B, Sc, KV, hd): batch on the batch axes, the sequence
    on ``model`` where it divides (else replicated); Mamba conv (np, B,
    C, W-1): C on model; SSM state (np, B, H, Pd, N): H on model.  The
    attention's sharded decode step (``models/attention.py``) merges the
    ranks' partial softmaxes over the sequence slices."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bsize = 1
    for a in baxes:
        bsize *= mesh.shape[a]
    b_ax = _entry(baxes) if batch % bsize == 0 else None

    def rule(path, leaf):
        p = _path_str(path)
        s = tuple(leaf.shape)
        if "/attn/" in p or p.endswith("/k") or p.endswith("/v"):
            return (None, b_ax, _maybe("model", s[2], mesh), None, None)
        if p.endswith("conv"):
            return (None, b_ax, _maybe("model", s[2], mesh), None)
        if p.endswith("ssm"):
            return (None, b_ax, _maybe("model", s[2], mesh), None, None)
        return (None,) * len(s)

    return tree_map_with_path(rule, abstract_cache)


def grow_cache(cache: PyTree, specs: PyTree, new_specs: PyTree, depth: int,
               mesh) -> PyTree:
    """This rank's shard of a decode cache with its attention leaves
    zero-padded to ``depth`` columns where shallower (``model.grow_cache``
    of the whole cache): ``cache`` is laid out by ``specs`` (a prefill's
    ``cache_specs``), the result by ``new_specs`` (the decode step's).
    Each attention leaf's sequence is gathered over ``model`` one period at
    a time, padded, and this rank's new slice taken; Mamba state is as it
    was."""
    def grow(t, spec, new_spec):
        out = []
        for i in range(t.shape[0]):
            whole = gather_leaf(t[i], (None,) + tuple(spec[2:]), mesh)
            if depth > whole.shape[1]:
                whole = torch.cat([whole, whole.new_zeros(
                    (whole.shape[0], depth - whole.shape[1])
                    + whole.shape[2:])], dim=1)
            out.append(shard_leaf(whole, (None,) + tuple(new_spec[2:]),
                                  mesh))
        return torch.stack(out)

    return {key: c if "attn" not in c else {"attn": {
        name: grow(t, specs[key]["attn"][name], new_specs[key]["attn"][name])
        for name, t in c["attn"].items()}} for key, c in cache.items()}


# --------------------------------------------------------------------------
# local shards
# --------------------------------------------------------------------------

def _spec_tree_map(fn, tree, specs):
    """``fn(leaf, spec)`` leaf-wise; specs are tuples, so they are leaves
    of the spec tree (tree.tree_map would descend into nothing else)."""
    if isinstance(tree, dict):
        return {k: _spec_tree_map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of a whole leaf (a copy, so the whole leaf can be
    freed)."""
    out = t
    for dim, entry in enumerate(spec):
        n = _ways(mesh, entry)
        if n == 1:
            continue
        chunk = out.shape[dim] // n
        out = out.narrow(dim, mesh.index(_axes_of(entry)) * chunk, chunk)
    return out.clone() if out is not t else out


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's local shard of every leaf of a whole tree."""
    return _spec_tree_map(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


def gather_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard (an all-gather over each
    split dim's axes); the inverse of :func:`shard_leaf`."""
    out = t
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        group = mesh.group(axes) if axes else None
        if group is None:
            continue
        n = _ways(mesh, entry)
        moved = out.movedim(dim, 0).contiguous()
        full = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
        dist.all_gather_into_tensor(full, moved, group=group)
        out = full.movedim(0, dim)
    return out


def gather_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    return _spec_tree_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


def _shard_seed(seed: int, path: str, spec: Spec, mesh) -> int:
    """A generator seed per leaf and shard: ranks that hold the same shard
    (those differing only on axes the spec does not split over) draw the
    same values."""
    shard = tuple(mesh.index(_axes_of(e)) if _ways(mesh, e) > 1 else 0
                  for e in spec)
    key = f"{seed}/{path}/{shard}".encode()
    return zlib.crc32(key) | (seed << 32)


def init_sharded_params(cfg, mesh, seed: int, device="cuda") -> PyTree:
    """This rank's shard of a random parameter tree, made on ``device``
    with the reference's distributions (``model.init_params``): truncated
    normal ±3σ, σ = scale/sqrt(global fan_in) (router scale 0.1),
    embeddings and head N(0, 0.02) (one table per codebook), norms one,
    the Mamba block's leaves as ``mamba2.mamba_leaf`` draws them.  Each
    leaf's shard comes from its own seeded generator, so the whole tree
    never exists in one place and a replicated leaf comes out alike on
    every rank; the values differ from ``init_params(seed)``'s (a
    whole-tree draw), and depend on the mesh."""
    from ..models.layers import dense_init, embed_init
    from ..models.mamba2 import mamba_leaf
    from . import steps as steps_lib
    a_params = steps_lib.abstract_params(cfg)
    specs = param_specs(cfg, a_params, mesh)

    def make(path, leaf):
        p = _path_str(path)
        spec = specs_at(specs, path)
        shape = local_shape(leaf.shape, spec, mesh)
        gen = torch.Generator(device=device).manual_seed(
            _shard_seed(seed, p, spec, mesh))
        name = path[-1]
        if p.startswith("embed") or p.startswith("lm_head"):
            return embed_init(shape, leaf.dtype, gen, device)
        if "ssm" in path:
            return mamba_leaf(name, shape, leaf.dtype, gen, device,
                              fan_in=leaf.shape[-2])
        if "norm" in name:
            return torch.ones(shape, dtype=leaf.dtype, device=device)
        return dense_init(shape, leaf.dtype, gen, device,
                          scale=0.1 if name == "router" else 1.0,
                          fan_in=leaf.shape[-2])

    return tree_map_with_path(make, a_params)


def specs_at(specs: PyTree, path: Sequence[str]) -> Spec:
    for key in path:
        specs = specs[key]
    return specs


def init_sharded_lora(cfg, mesh, seed: int, k_client: int = 0,
                      device="cuda", rescaler: str = "learnable") -> PyTree:
    """This rank's shard of a fresh trainable tree (``core.lora``'s
    distributions: ``a`` N(0, 1/global d_in) drawn in fp32 and cast, ``b``
    zero; rescalers at k / k_i), each ``a`` shard from its own seeded
    generator."""
    from . import steps as steps_lib
    a_train = steps_lib.abstract_trainable(cfg, k_client, rescaler)
    specs = trainable_specs(cfg, a_train, mesh)
    init_val = cfg.moe.top_k / max(k_client or cfg.moe.top_k, 1)

    def make(path, leaf):
        spec = specs_at(specs, path)
        shape = local_shape(leaf.shape, spec, mesh)
        if path[0] == "rescaler":
            return torch.full(shape, init_val, dtype=torch.float32,
                              device=device)
        if path[-1] == "b":
            return torch.zeros(shape, dtype=leaf.dtype, device=device)
        gen = torch.Generator(device=device).manual_seed(
            _shard_seed(seed, _path_str(path), spec, mesh))
        a = torch.randn(shape, dtype=torch.float32, device=device,
                        generator=gen) * leaf.shape[-2] ** -0.5
        return a.to(leaf.dtype)

    return tree_map_with_path(make, a_train)
