"""Serving launcher of the port: the continuous-batching engine on one device.

``--local`` runs the adaptive-k serving engine over a synthetic open-loop
workload — a real request queue, the block-paged KV pool, grouped prefill
and one mixed-k decode step per iteration — and prints throughput and
TTFT/latency percentiles.  It runs on the CUDA kernels unless given
``--device cpu`` (their plain versions).  ``--variant full`` serves the
arch's full-size config and ``--variant swa`` the full-size config with
sliding-window attention (ring KV caches of the window's length); the
default, like the reference's ``--local``, is the reduced smoke config.
``--layers N`` cuts the depth in whole periods of the layer pattern
(``--arch jamba-v0.1-52b --variant full --layers 16`` fits one card; an
attention-free arch such as ``mamba2-780m`` serves from the slotted
pool whatever ``--kv-layout`` says; an audio arch, ``musicgen-large``, is
refused with the reference's message: the engine is text-only).
Weights are random (seed 0), as is the trace (the reference's 8- and
16-token prompts).

Production-traffic knobs, as the reference's: ``--prefix-cache`` (shared
prompt blocks pay their K/V once, and prefill runs over the unmatched
suffix), ``--shared-prefix N`` (every prompt opens with one of the
trace's system prompts), ``--slo-ms K:MS,...`` (per-tier TTFT targets,
earliest-deadline-first admission) and ``--preemption`` (decode swap-out
under deadline pressure; needs ``--slo-ms``).  Observability:
``--trace-out PATH`` (Chrome trace-event JSON of the run; the flight
recorder dumps to ``PATH.crash.json`` if the engine raises),
``--metrics-out PATH`` (a metrics-registry snapshot) and
``--expert-telemetry`` (per-decode-step expert counts in the report).
Serving extras: ``--kv-layout slotted`` (the monolithic slotted pool, the
paged pool's differential oracle) and ``--speculate`` (self-speculative
decoding: ``--window`` drafts per round at ``--draft-k``, verified in one
full-k step).  ``--dispatch {ragged,dense,capacity}`` picks the MoE token
dispatch, as the reference's flag (the engine refuses capacity under
``--speculate``).

  PYTHONPATH=src python -m repro_torch.launch.serve --local \\
      --variant full --slots 8 --mix 8:0.25,4:0.25,2:0.25,1:0.25 \\
      --requests 16 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --local --device cpu \\
      --prefix-cache --shared-prefix 4 --slo-ms 2:50,1:5000 --preemption \\
      --trace-out build/serve_trace.json \\
      --metrics-out build/serve_metrics.json --expert-telemetry
  PYTHONPATH=src python -m repro_torch.launch.serve --local --device cpu \
      --speculate --window 4 --draft-k 1 --kv-layout slotted
  PYTHONPATH=src python -m repro_torch.launch.serve --local --device cpu \
      --dispatch capacity

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
from ..obs import MetricsRegistry, Tracer
from ..serving import (ServingEngine, SpeculativeConfig, WorkloadConfig,
                       make_trace)

LATER_FLAGS = {
    "--shape": "the multi-chip slice (the production-mesh serve step)",
    "--multi-pod": "the multi-chip slice (the production-mesh serve step)",
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


def parse_slo(spec: str):
    """``"8:150,1:1000"`` -> per-tier TTFT targets {k: ms}; ``""`` -> None.
    A bare number names no tier, so the K:MS form is required."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        try:
            k, ms = part.split(":")
            out[int(k)] = float(ms)
        except ValueError:
            raise SystemExit(f"--slo-ms: bad entry {part!r} "
                             "(expected K:MILLISECONDS[,K:MS...])")
    return out


def cut_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers (0: as it is), in whole periods of
    its layer pattern: ``jamba-v0.1-52b`` FULL (51.5 B parameters) serves
    from one 80 GB card at 16 layers, two of its four periods."""
    if not layers:
        return cfg
    if layers % cfg.pattern_period or not 0 < layers <= cfg.num_layers:
        raise SystemExit(f"--layers {layers}: {cfg.name} has "
                         f"{cfg.num_layers} layers in periods of "
                         f"{cfg.pattern_period}")
    return cfg.replace(num_layers=layers)


def add_depth_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, a multiple "
                         "of the layer pattern's period (0: the variant's)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmoe-1.3b-6.9b")
    ap.add_argument("--variant", choices=("smoke", "full", "swa"),
                    default="smoke")
    add_depth_flag(ap)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain versions)")
    ap.add_argument("--k", type=int, default=None,
                    help="uniform serving budget; shorthand for --mix K:1.0")
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--slot-len", type=int, default=48)
    ap.add_argument("--kv-layout", choices=("paged", "slotted"),
                    default="paged",
                    help="paged: block-paged KV pool (admission follows "
                         "block availability); slotted: one fixed-capacity "
                         "slot per request")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV tokens per page block (paged layout)")
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
    ap.add_argument("--dispatch", choices=("ragged", "dense", "capacity"),
                    default="ragged",
                    help="MoE token dispatch: ragged = sort-based, "
                         "loss-free AND sum(slot_k)-proportional (default); "
                         "dense = loss-free one-hot at worst-case padding; "
                         "capacity = GShard capacity-limited throughput "
                         "mode (batching may change results)")
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative decoding: draft a window of "
                         "tokens per slot at --draft-k through the same "
                         "weights, verify it in one full-k step, accept by "
                         "the exact rejection rule")
    ap.add_argument("--window", type=int, default=4,
                    help="speculative draft window W (tokens drafted per "
                         "round and verified in one step)")
    ap.add_argument("--draft-k", type=int, default=1,
                    help="expert budget of the draft pass (the cheap k)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed prompt block sharing with "
                         "copy-on-write, and suffix-only prefill of matched "
                         "prompts")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared system-prompt tokens at the head of every "
                         "prompt (exercises --prefix-cache)")
    ap.add_argument("--preemption", action="store_true",
                    help="SLO-driven decode preemption: swap the most "
                         "lenient-deadline request out to host memory when "
                         "a waiter misses its TTFT target (needs --slo-ms)")
    ap.add_argument("--slo-ms", default="",
                    help="per-tier TTFT targets K:MS[,K:MS...]: "
                         "earliest-deadline-first admission and per-tier "
                         "SLO attainment in the report")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(request lifecycle + engine-loop spans); arms the "
                         "flight recorder (PATH.crash.json on an engine "
                         "exception)")
    ap.add_argument("--metrics-out", default="",
                    help="write a metrics-registry JSON snapshot after the "
                         "run (engine counters, step histograms, pool and "
                         "scheduler gauges)")
    ap.add_argument("--expert-telemetry", action="store_true",
                    help="per-decode-step expert activation counts: "
                         "gini/entropy and the hot expert in the report")
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

    cfg = cut_depth(get_config(args.arch, args.variant), args.layers)
    if cfg.num_codebooks > 0:
        raise SystemExit(f"{cfg.name}: the serving engine is text-only; "
                         "codebook (audio) archs have no engine path yet")
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
    if args.shared_prefix and args.shared_prefix >= min(prompt_lens):
        raise SystemExit(f"--shared-prefix {args.shared_prefix} must be "
                         f"shorter than the shortest prompt "
                         f"({min(prompt_lens)} tokens)")
    wl = WorkloadConfig(
        n_requests=args.requests, rate=args.rate, prompt_lens=prompt_lens,
        new_tokens=(args.new_tokens,), tier_mix=mix,
        vocab_size=cfg.vocab_size, arrival=args.arrival,
        length_dist=args.length_dist, shared_prefix_len=args.shared_prefix)
    slo = parse_slo(args.slo_ms)
    if args.preemption and not slo:
        raise SystemExit("--preemption needs --slo-ms: victims are chosen "
                         "by TTFT deadlines")
    if args.expert_telemetry and not cfg.moe.enabled:
        raise SystemExit(f"--expert-telemetry needs an MoE arch: "
                         f"{cfg.name} routes nothing to observe")
    spec = None
    if args.speculate:
        if not cfg.moe.enabled:
            raise SystemExit(f"--speculate needs an MoE arch: {cfg.name} "
                             "has no cheaper draft budget")
        spec = SpeculativeConfig(window=args.window, draft_k=args.draft_k)
    tracer = (Tracer(flight_path=f"{args.trace_out}.crash.json")
              if args.trace_out else None)
    registry = MetricsRegistry() if args.metrics_out else None
    engine = ServingEngine(cfg, params, num_slots=args.slots,
                           slot_len=args.slot_len, slot_k=slot_k,
                           kv_layout=args.kv_layout,
                           block_size=args.block_size,
                           num_blocks=args.num_blocks,
                           dispatch=args.dispatch, speculative=spec,
                           prefix_cache=args.prefix_cache,
                           preemption=args.preemption, slo_ms=slo,
                           tracer=tracer, metrics=registry,
                           expert_telemetry=args.expert_telemetry)
    traffic = [flag for flag, on in
               (("prefix-cache", args.prefix_cache),
                ("preemption", args.preemption),
                (f"slo={args.slo_ms}", bool(slo))) if on]
    pool_desc = (f"{engine.pool.num_blocks} x {engine.pool.block_size}"
                 f"-token KV blocks" if engine.paged else "slotted KV pool")
    spec_desc = (f", speculative W={args.window} draft_k={args.draft_k}"
                 if spec else "")
    if cfg.attention_window:
        pool_desc += (f", sliding window {cfg.attention_window}: ring of "
                      f"{engine.pool.attn_len}")
    print(f"{cfg.name} on {device}: {args.slots} slots × {args.slot_len} "
          f"tokens ({pool_desc}), slot_k={engine.slot_k}, "
          f"dispatch={engine.dispatch}{spec_desc}"
          + (f", {' '.join(traffic)}" if traffic else ""))
    report = engine.run(make_trace(wl))
    for key, val in report.summary().items():
        print(f"  {key}: {val:.2f}" if isinstance(val, float)
              else f"  {key}: {val}")
    if tracer is not None:
        print(f"trace: {tracer.dump(args.trace_out)} "
              f"({len(tracer.events)} events — open in Perfetto)")
    if registry is not None:
        registry.dump(args.metrics_out)
        print(f"metrics: {args.metrics_out}")


if __name__ == "__main__":
    main(sys.argv[1:])
