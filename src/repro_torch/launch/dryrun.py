"""The dry run: the port of ``repro/launch/dryrun.py``, priced for the H100.

The reference lowers and compiles every (architecture x input shape)
step for the production mesh against abstract stand-ins, then reads
XLA's memory and cost analyses and the collective schedule out of the
HLO.  The port has no compiler to ask; instead it runs the very step the
cards run, once, as rank 0 of a world of the mesh's size:

  * the world is torch's ``fake`` process-group backend in this one
    process (``launch.mesh.fake_world``): every collective returns at
    once and moves nothing;
  * every argument is a ``meta`` tensor (shape and dtype, no storage) at
    rank 0's local shape (``sharding.local_shape`` under the step's spec
    trees), so nothing is allocated and the kernels' plain versions run
    (``kernels/backend.py`` sends only CUDA tensors to a kernel);
  * the step runs under ``models/parallel.py``'s collective counters and
    ``torch.utils.flop_counter.FlopCounterMode``; a train step runs its
    backward and the optimizer step too.

The counted calls are the port's counterpart of the reference's HLO
collective schedule, and they are exact: the same code at the same
shapes makes the same calls on the cards (``chip_smoke.py --mesh``
holds them equal).  The roofline (``launch/roofline.py``) prices them
and ``launch/analytic.py``'s FLOPs and bytes with the H100's figures.

Memory is each rank's bytes by part, as the step's build functions count
(no allocator runs, so no measured peak exists here): for a train step
the rank's parameter shards, its trainable state (adapters, their fp32
gradient sum and Adam's two moments), the FSDP gathers of one period
(``steps._mesh_knobs``) and one microbatch's activations
(``steps.activation_bytes`` in the mode that runs); for prefill and
decode the shards of parameters, adapters and cache
(``sharding.cache_specs``: a rank's rows and slice of the sequence) and
one period's gathered weights.
``peak_gb`` is their sum: an estimate, not a measurement.

Usage (the CPU; no card, no network):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
      --shape train_4k --multi-pod --out build/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from ..configs import INPUT_SHAPES, ShapeConfig, get_config, list_archs
from ..configs.registry import long_context_variant
from ..optim import adam
from . import analytic
from . import roofline as roofline_lib
from . import sharding as shd
from . import steps as steps_lib
from .mesh import fake_world, make_production_mesh
from .train import MESH_RESERVE

_META = torch.device("meta")
# the knob chooser's budget on a card, as ``train.py`` sets it there
MEMORY_BYTES = roofline_lib.CARD_MEMORY_BYTES - MESH_RESERVE


def variant_for(arch: str, shape_name: str) -> str:
    """long_500k needs a sub-quadratic attention path: native for SSM/hybrid
    (mamba state is O(1)); the sliding-window variant for attention archs."""
    if shape_name == "long_500k":
        return long_context_variant(arch)
    return "full"


def _world(mesh_shape: Sequence[int]) -> int:
    n = 1
    for s in mesh_shape:
        n *= s
    return n


def _local(tree, specs, mesh):
    """A meta tensor at rank 0's local shape for every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _local(tree[k], specs[k], mesh) for k in tree}
    return torch.empty(shd.local_shape(tree.shape, specs, mesh),
                       dtype=tree.dtype, device=_META)


def local_args(bundle, mesh):
    """``bundle.args`` cut to rank 0's shards and rows (the cards' inputs:
    ``sharding.shard_tree`` and ``steps.shard_batch``)."""
    sp, a = bundle.specs, bundle.args

    def rows(t):
        return _local(t, shd.batch_spec(t.shape[0], mesh, t.dim() - 1),
                      mesh)
    p = _local(a[0], sp["params"], mesh)
    tr = _local(a[1], sp["trainable"], mesh)
    if bundle.name == "train_step":
        return (p, tr, adam.init(tr)) + tuple(rows(t) for t in a[3:])
    if bundle.name == "prefill_step":
        return (p, tr, rows(a[2]))
    return (p, tr, _local(a[2], sp["cache"], mesh), rows(a[3]), a[4])


def memory_parts(cfg, shape, mesh, bundle) -> Dict[str, float]:
    """Each rank's bytes by part and their sum, in GiB (the module
    docstring)."""
    m = bundle.meta
    if shape.kind == "train":
        parts = {"params": m["rank_param_bytes"],
                 "trainable_state": m["rank_train_bytes"],
                 "gathers": (m["rank_fixed_bytes"] - m["rank_param_bytes"]
                             - m["rank_train_bytes"]),
                 "activations": m["act_bytes"]}
    else:
        a_params, a_train = bundle.args[0], bundle.args[1]
        a_cache = steps_lib.abstract_cache(cfg, shape.global_batch,
                                           shape.seq_len)
        sp = bundle.specs
        parts = {"params": steps_lib.rank_bytes(a_params, sp["params"], mesh),
                 "adapters": steps_lib.rank_bytes(a_train, sp["trainable"],
                                                  mesh),
                 "cache": steps_lib.rank_bytes(a_cache, sp["cache"], mesh),
                 "gathers": steps_lib.period_gather_bytes(cfg, a_params,
                                                          mesh, copies=1)}
    out = {f"{k}_gb": v / 2 ** 30 for k, v in parts.items()}
    out["peak_gb"] = sum(parts.values()) / 2 ** 30
    return out


def trace(bundle, args):
    """Run the step once on ``args`` under the collective counters and a
    FLOP counter: (calls (``comm_stop()``), FLOPs, seconds)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import parallel
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    parallel.comm_start()
    try:
        with counter:
            bundle.fn(*args)
    finally:
        comm = parallel.comm_stop(log=True)
    return comm, float(counter.get_total_flops()), time.perf_counter() - t0


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             cards_per_node: int = roofline_lib.CARDS_PER_NODE,
             shape: Optional[ShapeConfig] = None,
             variant: Optional[str] = None,
             cfg_replace: Optional[Dict[str, Any]] = None,
             memory_bytes: int = MEMORY_BYTES,
             keep_calls: bool = False) -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) step as rank 0 of a fake world; the
    dry-run record (roofline terms, memory, collective counts).

    ``mesh_shape``: the mesh in place of the production one (three
    entries: ``pod``, ``data``, ``model``).  ``shape`` replaces
    ``INPUT_SHAPES[shape_name]``, ``variant`` the config's variant
    (:func:`variant_for`'s), ``cfg_replace`` its fields (the cards' cut
    runs: ``{"num_layers": 38}``); ``memory_bytes`` is the knob chooser's
    budget (default: an H100's memory less the mesh launcher's reserve,
    as ``train.py`` budgets on the card);
    ``overrides`` go to the step's build function (``n_micro``, ``act_mode``,
    ``num_groups``, ``remat_chunk``, ``k``).  ``keep_calls`` adds every
    counted call (``calls``)."""
    shape = shape or INPUT_SHAPES[shape_name]
    variant = variant or variant_for(arch, shape_name)
    cfg = get_config(arch, variant).replace(**(cfg_replace or {}))
    if mesh_shape is not None:
        multi_pod = len(mesh_shape) == 3
    else:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    fake_world(_world(mesh_shape))
    mesh = make_production_mesh(multi_pod=multi_pod, mesh_shape=mesh_shape)
    mesh_name = "x".join(str(s) for s in mesh_shape)
    chips = _world(mesh_shape)

    kw = dict(overrides or {})
    if shape.kind == "train":
        kw.setdefault("memory_bytes", memory_bytes)
        kw.setdefault("device", _META)
    bundle = steps_lib.build_step(cfg, shape, mesh=mesh, **kw)
    comm, traced, t_trace = trace(bundle, local_args(bundle, mesh))
    meta = dict(bundle.meta)
    memory = memory_parts(cfg, shape, mesh, bundle)

    model_flops = analytic.model_flops_global(cfg, shape, meta)
    dev_flops = analytic.device_flops(cfg, shape, chips, meta)
    dev_bytes = analytic.device_bytes(cfg, shape, chips, meta)
    rl = roofline_lib.extract(
        arch=arch, shape=shape.name, mesh_name=mesh_name, chips=chips,
        model_flops=model_flops, device_flops=dev_flops,
        device_bytes=dev_bytes, traced_flops=traced, calls=comm["log"],
        cards_per_node=cards_per_node,
        bytes_per_device=memory["peak_gb"] * 2 ** 30, meta=meta)
    record = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "variant": variant, "step": bundle.name, "chips": chips,
        "ok": True, "t_trace_s": round(t_trace, 2),
        "memory": memory,
        "roofline": rl.row(),
        "collectives": {
            "execs_by_kind": {k: v[0] for k, v in comm["by_kind"].items()},
            "bytes_by_kind": {k: v[1] for k, v in comm["by_kind"].items()},
        },
        "meta": rl.meta,
    }
    if cfg_replace:
        record["cfg_replace"] = dict(cfg_replace)
    if keep_calls:
        record["calls"] = comm["log"]
    return record


def _mesh_arg(text: str):
    return tuple(int(x) for x in text.replace("x", ",").split(","))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--act-mode", default=None)
    ap.add_argument("--mesh-shape", type=_mesh_arg, default=None,
                    help="e.g. 2x2 or 2x1x2 (pod, data, model): in place of "
                    "the production mesh")
    ap.add_argument("--cards-per-node", type=int,
                    default=roofline_lib.CARDS_PER_NODE)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    if args.mesh_shape is not None:
        meshes = [args.mesh_shape]
    else:
        meshes = [(16, 16), (2, 16, 16)] if args.both_meshes else [
            (2, 16, 16) if args.multi_pod else (16, 16)]
    os.makedirs(args.out, exist_ok=True)

    overrides: Dict[str, Any] = {}
    if args.n_micro is not None:
        overrides["n_micro"] = args.n_micro
    if args.act_mode is not None:
        overrides["act_mode"] = args.act_mode

    n_ok = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_shape in meshes:
                mesh_name = "x".join(map(str, mesh_shape))
                tag = f"{arch}__{shape_name}__{mesh_name}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    ov = dict(overrides)
                    if INPUT_SHAPES[shape_name].kind != "train":
                        ov.pop("n_micro", None)
                        ov.pop("act_mode", None)
                    rec = run_pair(arch, shape_name, mesh_shape=mesh_shape,
                                   overrides=ov,
                                   cards_per_node=args.cards_per_node)
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"OK   {tag}: peak={rec['memory']['peak_gb']:.2f}GB"
                          f" bottleneck={r['bottleneck']}"
                          f" tc={r['t_compute_ms']:.1f}ms"
                          f" tm={r['t_memory_ms']:.1f}ms"
                          f" tx={r['t_collective_ms']:.1f}ms"
                          f" (trace {rec['t_trace_s']}s)", flush=True)
                except Exception as e:  # noqa: BLE001 — record + continue
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
