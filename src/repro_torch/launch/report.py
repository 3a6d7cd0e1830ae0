"""Consolidate the dry run's JSON records into one roofline table, one
line of advice a pair: the port of ``repro/launch/report.py``.

  PYTHONPATH=src python -m repro_torch.launch.report build/dryrun_torch

The terms are the H100's (``launch/roofline.py``); the memory column is
the dry run's per-rank estimate (``launch/dryrun.py``), held against a
card's memory (``roofline.CARD_MEMORY_BYTES``).
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

from .roofline import CARD_MEMORY_BYTES

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_records(dirpath: str) -> List[Dict]:
    out = []
    for name in sorted(os.listdir(dirpath)):
        if name.endswith(".json"):
            with open(os.path.join(dirpath, name)) as f:
                out.append(json.load(f))
    return out


def advice(r: Dict) -> str:
    """One sentence: what would move the dominant roofline term down."""
    rl = r["roofline"]
    b = rl["bottleneck"]
    moe = "moe" in r["arch"] or r["arch"].startswith(("jamba", "olmoe"))
    kind = ("train" if r["shape"].startswith("train") else
            "prefill" if r["shape"].startswith("prefill") else "decode")
    if b == "collective":
        if moe:
            return ("shard_map all-to-all of slot payloads instead of "
                    "GSPMD-inferred gathers around dispatch/combine")
        if kind == "train":
            return "data-heavier mesh — TP-AR volume ∝ local batch"
        return ("overlap weight all-gathers with the layer compute "
                "(double-buffered prefetch)")
    if b == "memory":
        if kind == "decode":
            return ("int8 KV cache halves the floor; grouped-query width "
                    "already minimal")
        return "larger microbatch raises arithmetic intensity per weight read"
    return ("already compute-bound — kernel-level (tensor-core utilisation) "
            "work only")


def fmt_row(r: Dict) -> str:
    rl = r["roofline"]
    mem = r["memory"]["peak_gb"]
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{rl['t_compute_ms']:.1f} | {rl['t_memory_ms']:.1f} | "
            f"{rl['t_collective_ms']:.1f} | **{rl['bottleneck']}** | "
            f"{mem:.1f} | {rl['model_gflops'] / 1e3:.1f} | "
            f"{rl['useful_frac']:.2f} | {rl['mfu'] * 100:.1f}% | "
            f"{advice(r)} |")


def main() -> None:
    dirpath = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun_torch"
    recs = load_records(dirpath)
    ok = [r for r in recs if r.get("ok")]
    fail = [r for r in recs if not r.get("ok")]

    print("| arch | shape | mesh | t_comp ms | t_mem ms | t_coll ms | "
          "bottleneck | HBM GB/dev | model TFLOPs | useful | roofline-MFU | "
          "what moves the dominant term |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    key = lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                     if r["shape"] in SHAPE_ORDER else 9, r["mesh"])
    for r in sorted(ok, key=key):
        print(fmt_row(r))

    if fail:
        print(f"\nFAILED ({len(fail)}):")
        for r in fail:
            print(f"  {r['arch']} × {r['shape']} × {r['mesh']}: "
                  f"{r.get('error', '?')}")

    budget = CARD_MEMORY_BYTES / 2 ** 30
    over = [r for r in ok if r["memory"]["peak_gb"] > budget]
    if over:
        print(f"\nOVER the {budget:.1f} GiB a card ({len(over)}):")
        for r in sorted(over, key=lambda r: -r["memory"]["peak_gb"]):
            print(f"  {r['arch']} × {r['shape']} × {r['mesh']}: "
                  f"{r['memory']['peak_gb']:.1f} GB  (knobs {r['meta']})")


if __name__ == "__main__":
    main()
