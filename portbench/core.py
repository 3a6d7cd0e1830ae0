"""Finds a cell's files by name and runs it once.

Everything that belongs to one cell is a file of its own under
``portbench/``, found by the names in ``BENCHMARK.json``:

* ``configs/<file>``: the configuration (the ``file`` of its entry);
* ``traffic/<traffic>.json``: the mix, including the ``driver`` that
  runs it (``drivers/<driver>.py``);
* ``cells/<workload>.json``: what the cell adds to its mix (a measured
  rate) and the limit of each number the correctness check compares;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(rec)``;
* ``counts/<kernel>.py``: a kernel's operations and bytes per call.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

PKG = "portbench"
_LOADED: Dict[str, object] = {}


@dataclass
class Cell:
    name: str
    bench: Dict
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]

    @property
    def model(self) -> Dict:
        return self.config["model"]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
    entry = entries[name]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(root / conf["file"])
    traffic = _json(root / PKG / "traffic" / f"{entry['traffic']}.json")
    cell_path = root / PKG / "cells" / f"{name}.json"
    extra = _json(cell_path) if cell_path.exists() else {}
    traffic = {**traffic, **extra.get("traffic", {})}
    return Cell(name=name, bench=bench, entry=entry,
                config=config, traffic=traffic,
                limits=extra.get("limits", {}))


def _module(path: Path, key: str):
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            re.sub(r"\W", "_", key), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def reader(root: Path, metric: str):
    """The ``read(rec)`` of ``metrics/<metric>.py``."""
    return _module(root / PKG / "metrics" / f"{metric}.py",
                   f"pb_metric_{metric}").read


def counts(root: Path) -> Dict[str, object]:
    """Every ``counts/<kernel>.py``, by kernel name."""
    return {p.stem: _module(p, f"pb_counts_{p.stem}")
            for p in sorted((root / PKG / "counts").glob("*.py"))}


def driver(kind: str):
    return importlib.import_module(f"{PKG}.drivers.{kind}")


def port_config(m: Dict):
    """The program's ``ModelConfig`` for configuration ``m``."""
    from repro_torch.configs.base import LoRAConfig, ModelConfig, MoEConfig
    cfg = ModelConfig(
        name=m["name"], family=m["family"], num_layers=m["num_layers"],
        d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"],
        d_ff=m.get("d_ff", 0), vocab_size=m["vocab_size"],
        qk_norm=m["qk_norm"], rope_theta=m["rope_theta"],
        rms_eps=m["rms_eps"], dtype=m["dtype"],
        moe=MoEConfig(num_experts=m["num_experts"], top_k=m["top_k"],
                      d_expert=m["d_expert"],
                      num_shared_experts=m["num_shared_experts"],
                      d_shared_expert=m["d_shared_expert"],
                      capacity_factor=m["capacity_factor"]),
        lora=LoRAConfig(rank=m["lora_rank"], alpha=m["lora_alpha"]))
    cfg.validate()
    return cfg


def device_info(device) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number the cell's limits name, beside its limit; a number the
    run did not give, or one that is not finite, fails, and so does a cell
    with no limit at all."""
    if not limits:
        return {"no limit set": {"value": None, "limit": None, "ok": False}}
    out = {}
    for name, lim in limits.items():
        value = numbers.get(name)
        ok = (lim is not None and value is not None
              and math.isfinite(value) and value <= lim)
        out[name] = {"value": value, "limit": lim, "ok": bool(ok)}
    return out


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Dict:
    """One run of one cell: set-up, the window, the check.  Returns the
    result line's object."""
    from . import trace as tr
    cell = load_cell(root, workload)
    drv = driver(cell.traffic["driver"]).Driver(cell, device)
    drv.setup(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    with tr.Traced(trace, drv.spans()) as traced:
        run_rec = drv.window(seconds)
    dev = device_info(device)
    drv.free_program()
    numbers = drv.check()
    checks = judge(numbers, cell.limits)
    correct = (all(c["ok"] for c in checks.values())
               and run_rec["failed"] == 0)
    result = {"correct": bool(correct), "attempted": run_rec["attempted"],
              "failed": run_rec["failed"], "metrics": {}, "device": dev}
    if not trace:
        values = dict(run_rec["e2e"], setup_s=setup_s,
                      peak_mem_gib=dev["memory_peak_bytes"] / 2**30)
        for m in cell.end_to_end():
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        s = traced.summary or {}
        rec = {"cell": cell.name, "run": run_rec, "calls": traced.calls,
               "counts": counts(root), **s}
        for m in cell.per_layer():
            v = reader(root, m["name"])(rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if s:
            dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
            result["breakdown"] = {"device_ops": tr.top(s["kernel_s"]),
                                   "idle_gaps": tr.top(s["idle_s"])}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    return result
