"""One pair's profile view: trace one (arch x shape) step in the dry run
and print its top collectives by bytes — the port of
``repro/launch/inspect_pair.py``.

  PYTHONPATH=src python -m repro_torch.launch.inspect_pair llama3-405b \\
      train_4k [--multi-pod] [--n-micro 8] [--act-mode dmodel] [--mesh 2x2]

The reference groups HLO collectives by their jaxpr ``op_name``; the port
has no HLO, so the calls the step made (``models/parallel.py``'s
counters) are grouped by kind, group size, the shape each rank sent and
whether the group spans nodes, each group with its calls, the bytes sent
and the bus bytes the roofline charges (``launch/roofline.py``).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

from .dryrun import run_pair
from .roofline import CARDS_PER_NODE, bus_bytes, spans_nodes


def top_collectives(calls, cards_per_node: int, top: int) -> List[Dict]:
    """The ``top`` groups of ``calls`` (``comm_stop(log=True)["log"]``) by
    bytes: {"kind", "ranks" (group size), "shape", "dtype",
    "spans_nodes", "calls", "bytes", "bus_bytes"}."""
    groups: Dict[tuple, Dict] = {}
    for c in calls:
        n = len(c["ranks"])
        across = spans_nodes(c["ranks"], cards_per_node)
        key = (c["kind"], n, tuple(c["shape"]), c["dtype"], across)
        g = groups.setdefault(key, {
            "kind": c["kind"], "ranks": n, "shape": list(c["shape"]),
            "dtype": c["dtype"], "spans_nodes": across, "calls": 0,
            "bytes": 0, "bus_bytes": 0.0})
        g["calls"] += 1
        g["bytes"] += c["bytes"]
        g["bus_bytes"] += bus_bytes(c["kind"], c["bytes"], n)
    return sorted(groups.values(), key=lambda g: -g["bytes"])[:top]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.inspect_pair")
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--act-mode", default=None)
    ap.add_argument("--mesh", default=None, help="e.g. 2x2 or 2x1x2")
    ap.add_argument("--cards-per-node", type=int, default=CARDS_PER_NODE)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    overrides = {}
    if args.n_micro is not None:
        overrides["n_micro"] = args.n_micro
    if args.act_mode is not None:
        overrides["act_mode"] = args.act_mode

    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)
    rec = run_pair(args.arch, args.shape, multi_pod=args.multi_pod,
                   overrides=overrides, mesh_shape=mesh_shape,
                   cards_per_node=args.cards_per_node, keep_calls=True)
    calls = rec.pop("calls")
    r, m = rec["roofline"], rec["meta"]
    print(f"\n{args.arch} × {args.shape} ({rec['mesh']}): "
          f"peak {rec['memory']['peak_gb']:.2f} GB (estimate) | "
          f"tc {r['t_compute_ms']:.0f} tm {r['t_memory_ms']:.0f} "
          f"tx {r['t_collective_ms']:.0f} ms | knobs "
          f"{m.get('n_micro'), m.get('act_mode'), m.get('num_groups')} | "
          f"trace {rec['t_trace_s']} s")
    print(f"\ntop {args.top} collectives of {len(calls)} calls (by bytes "
          f"sent; {args.cards_per_node} cards a node):")
    print(f"{'kind':15s} {'ranks':>5s} {'nodes':>6s} {'calls':>6s} "
          f"{'GiB':>9s} {'bus GiB':>9s} shape")
    for g in top_collectives(calls, args.cards_per_node, args.top):
        print(f"{g['kind']:15s} {g['ranks']:5d} "
              f"{'across' if g['spans_nodes'] else 'one':>6s} "
              f"{g['calls']:6d} {g['bytes'] / 2 ** 30:9.3f} "
              f"{g['bus_bytes'] / 2 ** 30:9.3f} "
              f"{g['dtype']}{g['shape']}")


if __name__ == "__main__":
    main()
