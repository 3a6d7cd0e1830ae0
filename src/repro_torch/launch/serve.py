"""Serving launcher of the port: the continuous-batching engine on one device.

``--local`` runs the adaptive-k serving engine over a synthetic open-loop
workload — a real request queue, the block-paged KV pool, grouped prefill
and one mixed-k decode step per iteration — and prints throughput and
TTFT/latency percentiles.  It runs on the CUDA kernels unless given
``--device cpu`` (their plain versions).  ``--variant full`` serves the
arch's full-size config; the default, like the reference's ``--local``,
is the reduced smoke config.  Weights are random (seed 0), as is the
trace (the reference's 8- and 16-token prompts).

  PYTHONPATH=src python -m repro_torch.launch.serve --local \\
      --variant full --slots 8 --mix 8:0.25,4:0.25,2:0.25,1:0.25 \\
      --requests 16 --new-tokens 16

Flags of the reference launcher that belong to later slices of the port
are rejected with a message naming the slice.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from ..configs import get_config
from ..models import model as model_lib
from ..serving import ServingEngine, WorkloadConfig, make_trace

_EXTRAS = "the serving-extras slice"
LATER_FLAGS = {
    "--shape": "the multi-chip slice (the production-mesh serve step)",
    "--multi-pod": "the multi-chip slice (the production-mesh serve step)",
    "--kv-layout": _EXTRAS + " (the slotted pool)",
    "--dispatch": "the training slice (one-hot capacity/dense dispatch)",
    "--speculate": _EXTRAS + " (speculative decoding)",
    "--window": _EXTRAS + " (speculative decoding)",
    "--draft-k": _EXTRAS + " (speculative decoding)",
    "--prefix-cache": _EXTRAS + " (prefix caching)",
    "--shared-prefix": _EXTRAS + " (prefix caching)",
    "--preemption": _EXTRAS + " (preemption)",
    "--slo-ms": _EXTRAS + " (SLO admission)",
    "--trace-out": _EXTRAS + " (tracing)",
    "--metrics-out": _EXTRAS + " (metrics registry)",
    "--expert-telemetry": _EXTRAS + " (expert telemetry)",
}


def parse_mix(spec: str, top_k: int):
    """``"8:0.5,1:0.5"`` -> tier mix tuple; ``""`` -> uniform top_k."""
    if not spec:
        return ((top_k, 1.0),)
    out = []
    for part in spec.split(","):
        k, frac = part.split(":")
        out.append((int(k), float(frac)))
    return tuple(out)


def slot_k_for_mix(mix, num_slots: int):
    """Partition the slot pool proportionally to the tier mix; every tier
    keeps >= 1 slot (a tier without slots would strand its requests)."""
    if num_slots < len(mix):
        raise SystemExit(f"--slots {num_slots} < {len(mix)} tiers in --mix;"
                         " every tier needs at least one slot")
    total = sum(f for _, f in mix)
    counts = [max(1, round(num_slots * f / total)) for _, f in mix]
    while sum(counts) > num_slots:
        counts[counts.index(max(counts))] -= 1
    while sum(counts) < num_slots:
        counts[counts.index(min(counts))] += 1
    slot_k = []
    for (k, _), n in zip(mix, counts):
        slot_k.extend([k] * n)
    return tuple(slot_k)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmoe-1.3b-6.9b")
    ap.add_argument("--variant", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain versions)")
    ap.add_argument("--k", type=int, default=None,
                    help="uniform serving budget; shorthand for --mix K:1.0")
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--slot-len", type=int, default=48)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV tokens per page block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="usable KV blocks in the pool; default: every slot "
                         "can hold a max-length request")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=float("inf"),
                    help="mean arrival rate (req/s); inf = closed batch")
    ap.add_argument("--arrival", choices=("poisson", "diurnal", "burst"),
                    default="poisson")
    ap.add_argument("--length-dist", choices=("categorical", "zipf"),
                    default="categorical")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--mix", default="",
                    help="tier mix k:frac[,k:frac...]; empty = full top_k")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    for tok in extra:
        flag = tok.split("=", 1)[0]
        if flag in LATER_FLAGS:
            raise SystemExit(f"{flag}: comes with {LATER_FLAGS[flag]} of "
                             "the PyTorch port")
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if not args.local:
        raise SystemExit("without --local the reference builds the sharded "
                         "production-mesh serve step, which comes with the "
                         "multi-chip slice of the PyTorch port")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here "
                         "(pass --device cpu for the plain versions)")

    cfg = get_config(args.arch, args.variant)
    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    top_k = cfg.moe.top_k if cfg.moe.enabled else 0
    if args.k is not None and top_k:
        if args.mix:
            raise SystemExit("--k and --mix are mutually exclusive")
        args.mix = f"{args.k}:1.0"
    mix = parse_mix(args.mix, top_k) if top_k else ()
    bad = [k for k, _ in mix if not 1 <= k <= cfg.moe.num_experts]
    if bad:
        raise SystemExit(f"--mix tiers {bad} out of range: {cfg.name} has "
                         f"{cfg.moe.num_experts} experts")
    slot_k = slot_k_for_mix(mix, args.slots) if mix else None
    # prompts must leave room for at least one generated token in a slot
    prompt_lens = tuple(L for L in (8, 16) if L + 1 <= args.slot_len)
    if not prompt_lens:
        raise SystemExit(f"--slot-len {args.slot_len} too small for the "
                         "workload's 8-token prompts (need >= 9)")
    wl = WorkloadConfig(
        n_requests=args.requests, rate=args.rate, prompt_lens=prompt_lens,
        new_tokens=(args.new_tokens,), tier_mix=mix,
        vocab_size=cfg.vocab_size, arrival=args.arrival,
        length_dist=args.length_dist)
    engine = ServingEngine(cfg, params, num_slots=args.slots,
                           slot_len=args.slot_len, slot_k=slot_k,
                           block_size=args.block_size,
                           num_blocks=args.num_blocks)
    print(f"{cfg.name} on {device}: {args.slots} slots × {args.slot_len} "
          f"tokens ({engine.pool.num_blocks} x {engine.pool.block_size}"
          f"-token KV blocks), slot_k={engine.slot_k}, "
          f"dispatch={engine.dispatch}")
    report = engine.run(make_trace(wl))
    for key, val in report.summary().items():
        print(f"  {key}: {val:.2f}" if isinstance(val, float)
              else f"  {key}: {val}")


if __name__ == "__main__":
    main(sys.argv[1:])
