"""A benchmark tree of its own for the CPU tests: SMOKE-size
configurations and mixes written as new files beside a ``BENCHMARK.json``
that names them, with the real metric readers and kernel counts copied in.
The drivers, the reference and the program run on the CPU (the program's
plain kernel versions)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]

OLMOE_SMOKE = {
    "name": "olmoe-smoke", "family": "moe", "num_layers": 2, "d_model": 64,
    "n_heads": 4, "n_kv_heads": 4, "head_dim": 16, "vocab_size": 512,
    "qk_norm": True, "rope_theta": 10000.0, "rms_eps": 1e-06,
    "num_experts": 4, "top_k": 2, "d_expert": 32, "num_shared_experts": 0,
    "d_shared_expert": 0, "capacity_factor": 1.25, "lora_rank": 4,
    "lora_alpha": 16.0, "dtype": "float32"}

QWEN_SMOKE = dict(OLMOE_SMOKE, name="qwen2-moe-smoke", qk_norm=False,
                  num_shared_experts=1, d_shared_expert=48,
                  rope_theta=1e6)

FL_SMOKE = {
    "driver": "fl_round", "clients": 4, "tiers": ["b1", "b2", "b3", "b4"],
    "budget_k": {"b1": 8, "b2": 4, "b3": 2, "b4": 1}, "participation": 1.0,
    "examples_per_client": 4, "batch_size": 2, "seq_len": 16,
    "prompt_len": 4, "local_epochs": 1, "data_vocab": 64, "n_clusters": 3,
    "peak": 6.0, "dirichlet_alpha": 5.0, "method": "flame",
    "rescaler": "learnable", "temperature": 2, "round_engine": "batched",
    "round_driver": "host", "adapter_b_rel": 0.1}

SERVE_SMOKE = {
    "driver": "serve_open", "rate_rps": 40.0, "prompt_len_min": 8,
    "prompt_len_max": 24, "output_min": 3, "output_max": 6,
    "zipf_alpha": 1.8, "tiers": ["b1", "b2", "b3", "b4"],
    "budget_k": {"b1": 8, "b2": 4, "b3": 2, "b4": 1}, "slots": 4,
    "slot_len": 32, "kv_layout": "paged", "block_size": 4,
    "dispatch": "ragged", "data_vocab": 64, "adapter_b_rel": 0.1,
    "check_tokens": 12}

LOOSE = {"fl_round": {"loss": 1e-3, "delta": 1e-2, "route_gap": 1e-3},
         "serve_open": {"logit_err_p90": 1e-3, "token_excess": 0.0,
                        "route_gap": 1e-3}}


def write(root: Path, configs=None, mixes=None, cells=None) -> Path:
    """A tree under ``root`` holding the smoke cells (and any extra
    ``configs``/``mixes``/``cells`` given as ``{name: dict}``)."""
    configs = {"olmoe-smoke": OLMOE_SMOKE, "qwen2-moe-smoke": QWEN_SMOKE,
               **(configs or {})}
    mixes = {"fl-smoke": FL_SMOKE, "serve-smoke": SERVE_SMOKE,
             **(mixes or {})}
    cells = {"olmoe.fl-smoke": ("olmoe-smoke", "fl-smoke"),
             "olmoe.serve-smoke": ("olmoe-smoke", "serve-smoke"),
             "qwen.fl-smoke": ("qwen2-moe-smoke", "fl-smoke"),
             "qwen.serve-smoke": ("qwen2-moe-smoke", "serve-smoke"),
             **(cells or {})}
    pkg = root / "portbench"
    for sub in ("configs", "traffic", "cells"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "counts"):
        shutil.copytree(PKG / sub, pkg / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, m in configs.items():
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "model": m}))
    for name, mix in mixes.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (_, mix) in cells.items():
        (pkg / "cells" / f"{name}.json").write_text(json.dumps(
            {"limits": LOOSE[mixes[mix]["driver"]]}))
    real = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    fl = [c for c, (_, t) in cells.items() if mixes[t]["driver"] ==
          "fl_round"]
    sv = [c for c in cells if c not in fl]
    e2e = []
    for m in real["end_to_end"]:
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = fl if "train" in m["name"] else sv
        e2e.append(m)
    per = []
    for m in real["per_layer"]:
        m = dict(m, workloads=fl if m["name"].endswith(".train") else sv)
        per.append(m)
    bench = {
        "command": real["command"], "paths": real["paths"],
        "run_seconds": 1,
        "configs": [{"name": n, "source": "test", "why": "test",
                     "file": f"portbench/configs/{n}.json", "reduced": []}
                    for n in configs],
        "workloads": [{"name": c, "config": cf, "traffic": t, "chips": 1,
                       "why": "test"} for c, (cf, t) in cells.items()],
        "end_to_end": e2e, "per_layer": per}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
