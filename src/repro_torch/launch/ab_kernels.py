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
  generated tokens/s and the decode step's p50 per run;
- the expert kernel: ``lora_matmul_experts`` at each training tier's
  capacity (k = 8, 4, 2, 1 at 2048 tokens: C = 328, 168, 88, 48; w1/w3
  2048 -> 1024 and w2 1024 -> 2048, r = 20, bf16), 5 pairs: CUDA-event
  means of 20 calls, the L2 flushed before each.

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
from ..kernels import _build
from ..kernels.lora_matmul import lora_matmul_experts
from ..models import model as model_lib
from ..serving import Request, ServingEngine

SLOT_K = (8, 8, 4, 4, 2, 2, 1, 1)
TIERS = ((8, 328), (4, 168), (2, 88), (1, 48))
SERVE_PAIRS, KERNEL_PAIRS, REPS = 10, 5, 20


def _order(pairs: int):
    """other, this, this, other, ... : each arm first in half the pairs."""
    for i in range(pairs):
        yield from (("other", "this") if i % 2 == 0 else ("this", "other"))


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
    results = {arm: {"tokens_per_s": [], "decode_step_ms_p50": []}
               for arm in libs}

    # ---- serving
    cfg = get_config("olmoe-1.3b-6.9b", "full")
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
        s = engine.run(requests(16, 16)).summary()
        results[arm]["tokens_per_s"].append(s["gen_tokens_per_s"])
        results[arm]["decode_step_ms_p50"].append(s["decode_step_ms_p50"])
        print(f"serve {arm}: {s['gen_tokens_per_s']:.2f} tokens/s, decode "
              f"step p50 {s['decode_step_ms_p50']:.3f} ms, TTFT p50 "
              f"{s['ttft_p50_ms']:.1f} ms", flush=True)
    del engine, params
    torch.cuda.empty_cache()

    # ---- the expert kernel at each tier
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def ops(C, K, N, r=20, E=64):
        return (randn(E, C, K), randn(E, K, N, scale=K ** -0.5),
                randn(E, K, r, scale=K ** -0.5), randn(E, r, N, scale=0.5))

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

    shapes = {f"k{k}_{name}": ops(C, K, N) for k, C in TIERS
              for name, K, N in (("w13", 2048, 1024), ("w2", 1024, 2048))}
    for arm in _order(KERNEL_PAIRS):
        _build.use(libs[arm])
        row = {key: time_ms(lambda t=t: lora_matmul_experts(*t, scale=1.25))
               for key, t in shapes.items()}
        for key, ms in row.items():
            results[arm].setdefault(key + "_ms", []).append(ms)
        print(f"experts {arm}: " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in row.items()),
              flush=True)
    _build.use(libs["this"])
    print(json.dumps({"ab_medians": {
        arm: {key: statistics.median(vals) for key, vals in res.items()}
        for arm, res in results.items()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
