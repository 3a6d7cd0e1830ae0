"""Two builds of the port's kernel library, A/B in one process on the card.

    PYTHONPATH=src python -m repro_torch.launch.ab_kernels --other DIR

``DIR`` is another ``kernels/csrc`` directory with the same C entry
points: an earlier commit's (unpacked with ``git archive``) or a variant
of this one.  Both are built; then one process, on one set of seeded
weights, alternates between the two libraries in the order other, this,
this, other, ... for:

- serving: ``chip_smoke.py``'s workload (OLMoE-1.3B/6.9B FULL, bf16, 8
  slots at tiers 8,8,4,4,2,2,1,1, 16 requests of 128/256-token prompts,
  16 new tokens each, the same prompts every run), 10 pairs of runs:
  generated tokens/s, the decode step's p50, the prefill call's p50 and
  TTFT p50 per run.  Only where the other build has every C entry point
  the serving path calls (a build without ``rt_adaptive_topk_router``
  cannot serve this Python; compare whole checkouts with the
  benchmark, ``portbench/run.py``, instead);
- the router's static entry (``topk_router``, bf16 logits, E = 64) at
  each prefill group's shape (T = 128, 256 tokens at k = 8, 4, 2, 1),
  5 pairs;
- the grouped ragged expert matmul (``ragged_expert_matmul``, bf16, no
  LoRA) at the serving path's shapes: the decode step's plan (8 slots at
  the tiers above) and each prefill group's (T = 128, 256 tokens at k = 8,
  4, 2, 1), w1/w3 2048 -> 1024 and w2 1024 -> 2048, 5 pairs;
- ``ragged_gather`` and ``ragged_combine`` (bf16, D = 2048) on the same
  plans, 5 pairs;
- the LoRA expert kernel: ``lora_matmul_experts`` at each training tier's
  capacity (k = 8, 4, 2, 1 at 2048 tokens: C = 328, 168, 88, 48; w1/w3
  2048 -> 1024 and w2 1024 -> 2048, r = 20, bf16), 5 pairs.

Kernel times are CUDA-event means of 20 calls, the L2 flushed before each.
The Python code is the same in both arms, so they differ only in the
kernels.  Prints one line per run, then a JSON line of the medians per
arm.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config
from ..kernels import _build, ref
from ..kernels.lora_matmul import lora_matmul_experts
from ..kernels.ragged_dispatch import (ragged_combine, ragged_expert_matmul,
                                       ragged_gather, ragged_plan)
from ..kernels.topk_router import topk_router
from ..models import model as model_lib
from ..serving import Request, ServingEngine

SLOT_K = (8, 8, 4, 4, 2, 2, 1, 1)
TIERS = ((8, 328), (4, 168), (2, 88), (1, 48))
SERVE_PAIRS, KERNEL_PAIRS, REPS = 10, 5, 20


def _order(pairs: int):
    """other, this, this, other, ... : each arm first in half the pairs."""
    for i in range(pairs):
        yield from (("other", "this") if i % 2 == 0 else ("this", "other"))


def serving_pairs(cfg, dev, libs, results) -> None:
    """The serving workload, alternating the two libraries run by run."""
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServingEngine(cfg, params, num_slots=8, slot_len=512,
                           slot_k=SLOT_K)

    def requests(n, new):
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, ((128, 256)[i % 2],)).astype(np.int32),
                        max_new_tokens=new, k=SLOT_K[i % 8]) for i in range(n)]

    for arm in libs:                                 # warm-up, both arms
        _build.use(libs[arm])
        engine.run(requests(8, 2))
    for arm in _order(SERVE_PAIRS):
        _build.use(libs[arm])
        torch.cuda.synchronize()
        report = engine.run(requests(16, 16))
        s = report.summary()
        prefill_p50 = statistics.median(report.prefill_s) * 1e3
        row = {"tokens_per_s": s["gen_tokens_per_s"],
               "decode_step_ms_p50": s["decode_step_ms_p50"],
               "prefill_ms_p50": prefill_p50,
               "ttft_ms_p50": s["ttft_p50_ms"]}
        for key, val in row.items():
            results[arm].setdefault(key, []).append(val)
        print(f"serve {arm}: {s['gen_tokens_per_s']:.2f} tokens/s, decode "
              f"step p50 {s['decode_step_ms_p50']:.3f} ms, prefill p50 "
              f"{prefill_p50:.2f} ms, TTFT p50 {s['ttft_p50_ms']:.1f} ms",
              flush=True)
    del engine, params
    torch.cuda.empty_cache()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.ab_kernels")
    ap.add_argument("--other", required=True, type=Path,
                    help="the other build's kernels/csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels needs a CUDA device")
    if not sorted(args.other.glob("*.cu")):
        raise SystemExit(f"--other {args.other}: no .cu sources")
    dev = torch.device("cuda")
    libs = {"this": _build.load(_build.build()),
            "other": _build.load(_build.build(args.other.resolve()))}
    results = {arm: {} for arm in libs}
    cfg = get_config("olmoe-1.3b-6.9b", "full")
    if hasattr(libs["other"], "rt_adaptive_topk_router"):
        serving_pairs(cfg, dev, libs, results)
    else:       # the decode step calls it: this Python cannot serve there
        print("serving pairs skipped: the other build lacks "
              "rt_adaptive_topk_router", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(REPS):
            flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / REPS

    def kernel_pairs(label, calls):
        for arm in _order(KERNEL_PAIRS):
            _build.use(libs[arm])
            row = {key: time_ms(fn) for key, fn in calls.items()}
            for key, ms in row.items():
                results[arm].setdefault(key + "_ms", []).append(ms)
            print(f"{label} {arm}: " + ", ".join(f"{k} {v:.4f}"
                                                 for k, v in row.items()),
                  flush=True)

    E = cfg.moe.num_experts
    # ---- the router's static entry at the prefill groups' shapes
    kernel_pairs("router", {
        f"router_T{T}k{k}": (lambda l_=randn(T, E, scale=0.5), k_=k:
                             topk_router(l_, k_))
        for T in (128, 256) for k in (8, 4, 2, 1)})

    # ---- the grouped ragged expert matmul at the serving shapes
    w13, w2 = randn(E, 2048, 1024, scale=2048 ** -0.5), randn(
        E, 1024, 2048, scale=1024 ** -0.5)
    w_, m_, _ = ref.adaptive_topk_router_ref(
        randn(8, E), torch.tensor(SLOT_K, device=dev), 8)
    plans = {"decode": ragged_plan(m_, w_, budget=sum(SLOT_K), max_k=8)}
    for T in (128, 256):
        for k in (8, 4, 2, 1):
            w_, m_, _ = ref.topk_router_ref(randn(T, E), k)
            plans[f"T{T}k{k}"] = ragged_plan(m_, w_, budget=T * k, max_k=k)
    calls = {}
    for name, pl in plans.items():
        n_rows = pl.src.shape[0]
        for wn, wt in (("w13", w13), ("w2", w2)):
            xin = randn(n_rows, wt.shape[1])
            calls[f"ragged_{name}_{wn}"] = (
                lambda x_=xin, b_=pl.block_expert, w_=wt:
                ragged_expert_matmul(x_, b_, w_))
    kernel_pairs("ragged", calls)
    del calls, w13, w2

    # ---- the gather and the combine on the same plans (D = 2048)
    calls = {}
    for name, pl in plans.items():
        x, eo = randn(pl.rows.shape[0], 2048), randn(pl.src.shape[0], 2048)
        calls[f"gather_{name}"] = (lambda x_=x, p_=pl:
                                   ragged_gather(x_, p_.src, p_.valid))
        calls[f"combine_{name}"] = (lambda e_=eo, p_=pl:
                                    ragged_combine(e_, p_.rows, p_.wrank))
    kernel_pairs("gather/combine", calls)
    del calls, plans

    # ---- the LoRA expert kernel at each tier
    def ops(C, K, N, r=20):
        return (randn(E, C, K), randn(E, K, N, scale=K ** -0.5),
                randn(E, K, r, scale=K ** -0.5), randn(E, r, N, scale=0.5))

    kernel_pairs("experts", {
        f"k{k}_{name}": (lambda t=ops(C, K, N):
                         lora_matmul_experts(*t, scale=1.25))
        for k, C in TIERS
        for name, K, N in (("w13", 2048, 1024), ("w2", 1024, 2048))})
    _build.use(libs["this"])
    print(json.dumps({"ab_medians": {
        arm: {key: statistics.median(vals) for key, vals in res.items()}
        for arm, res in results.items()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
