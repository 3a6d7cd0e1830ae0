"""Serving launcher of the port: the continuous-batching engine on one
device, or the sharded prefill and serve steps on the card mesh.

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

Without ``--local`` (as the reference's): the sharded prefill and serve
steps (``launch/steps.py`` with ``mesh=``) on the production mesh of the
visible cards, ``--variant full`` by default, at ``--shape``
(``INPUT_SHAPES``, ``decode_32k`` by default; ``--batch`` and
``--seq-len`` cut its batch and cache depth): a prefill of
``--prompt-len`` tokens a row, then ``--new-tokens`` greedy decode steps
against the cache, with each rank's shard of seeded random weights; it
prints the prefill time, decode ms per step, tokens/s, each rank's peak
memory and every cut (the depth: ``--layers`` or the deepest whole-period
cut whose shards and cache fit a rank).  One worker a card, started by
the launcher (``spawn``) or by ``torchrun``; ``--device cpu`` runs
``--world`` gloo ranks (default 2).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --batch 8 --seq-len 4096 --new-tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen3-moe-235b-a22b --variant smoke --multi-pod --world 2 \
      --batch 4 --seq-len 32 --prompt-len 8 --new-tokens 2
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..configs import INPUT_SHAPES, ShapeConfig, get_config
from ..models import model as model_lib
from ..obs import MetricsRegistry, Tracer
from ..serving import (ServingEngine, SpeculativeConfig, WorkloadConfig,
                       make_trace)


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


def add_mesh_flags(ap: argparse.ArgumentParser, shape: str) -> None:
    """The mesh launchers' flags (train.py and serve.py)."""
    ap.add_argument("--shape", default=shape, choices=sorted(INPUT_SHAPES),
                    help="the mesh step's input shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a 2-way pod axis in front: (pod, data, model)")
    ap.add_argument("--mesh-shape", default="",
                    help="override the production mesh, e.g. 1,4 or 2,1,2")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks to start (default: the visible cards; 2 "
                         "gloo ranks with --device cpu)")
    ap.add_argument("--batch", type=int, default=0,
                    help="cut the shape's global batch to this")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="cut the shape's sequence (train) or cache depth "
                         "(decode) to this")
    ap.add_argument("--timeout", type=float, default=0,
                    help="seconds after which the spawned workers are "
                         "killed (0: none)")


def run_on_mesh(worker: Callable, args) -> None:
    """Run ``worker(rank, world, vars(args))`` on every rank: under
    ``torchrun`` in this process, else in one spawned process a rank."""
    from . import mesh as mesh_lib
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu for the plain versions)")
    backend = "nccl" if cuda else "gloo"
    opts = dict(vars(args))
    opts["mesh_shape"] = (tuple(int(v) for v in args.mesh_shape.split(","))
                          if args.mesh_shape else None)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        rank, world = mesh_lib.init_from_env(backend)
        try:
            worker(rank, world, opts)
        finally:
            dist.destroy_process_group()
        return
    world = args.world or (torch.cuda.device_count() if cuda else 2)
    mesh_lib.spawn(worker, world, opts, backend=backend,
                   timeout=args.timeout or None)


def mesh_serve(cfg, mesh, device, *, batch: int, prompt_len: int,
               cache_len: int, new_tokens: int, seed: int = 0,
               k: Optional[int] = None,
               log: Callable[[str], None] = print) -> Dict[str, Any]:
    """The sharded prefill of ``batch`` random prompts of ``prompt_len``
    tokens, then ``new_tokens`` greedy decode steps against a
    ``cache_len``-deep cache, on this rank of ``mesh`` (every rank calls
    it; ``log`` prints on rank 0).  Returns the prefill s, each decode
    step's ms, the decoded tokens (batch, new_tokens) of the whole batch,
    the collectives of the prefill and of the decode steps
    (``parallel.comm_stop()``) and each rank's
    peak bytes (the card only)."""
    from ..models import parallel
    from . import sharding as shd
    from . import steps as steps_lib
    from .mesh import rank_peaks
    device = torch.device(device)
    pre = steps_lib.build_prefill(
        cfg, ShapeConfig("prefill", prompt_len, batch, "prefill"), k=k,
        mesh=mesh)
    srv = steps_lib.build_serve(
        cfg, ShapeConfig("decode", cache_len, batch, "decode"), k=k,
        mesh=mesh)
    params = shd.init_sharded_params(cfg, mesh, seed, device)
    trainable = shd.init_sharded_lora(cfg, mesh, seed + 1, pre.meta["k"] or 0,
                                      device)
    gen = torch.Generator(device=device).manual_seed(seed + 200)
    prompts = torch.randint(0, cfg.vocab_size,
                            steps_lib.token_shape(cfg, batch, prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    parallel.comm_start()
    t0 = time.perf_counter()
    logits, cache = pre.fn(params, trainable,
                           steps_lib.shard_batch(prompts, mesh))
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_comm = parallel.comm_stop()

    cache = shd.grow_cache(cache, pre.specs["cache"], srv.specs["cache"],
                           model_lib.cache_len_for(cfg, cache_len), mesh)
    nxt = logits.argmax(-1).to(torch.int32)
    toks, step_ms = [nxt], []
    parallel.comm_start()
    for i in range(new_tokens - 1):
        pos = torch.tensor(prompt_len + i, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        logits, cache = srv.fn(params, trainable, cache, nxt, pos)
        nxt = logits.argmax(-1).to(torch.int32)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(nxt)
    comm = parallel.comm_stop()
    tokens = torch.cat(toks, dim=1)
    tokens = shd.gather_leaf(tokens, shd.batch_spec(batch, mesh,
                                                    tokens.dim() - 1), mesh)
    peaks = rank_peaks(device) if on_card else None
    decode_s = sum(step_ms) / 1e3
    out = {"prefill_s": prefill_s, "decode_ms": step_ms, "tokens": tokens,
           "comm": comm, "prefill_comm": prefill_comm, "peak_bytes": peaks,
           "tokens_per_s": (batch * len(step_ms) / decode_s
                            if decode_s else 0.0)}
    med = sorted(step_ms)[len(step_ms) // 2] if step_ms else 0.0
    peak = ("not measured (CPU)" if peaks is None else
            "[" + ", ".join(f"{p / 2 ** 30:.2f}" for p in peaks) + "] GiB")
    log(f"{cfg.name} ({cfg.num_layers} layers) on mesh {dict(mesh.shape)}: "
        f"prefill {batch} x {prompt_len} tokens {prefill_s:.3f} s, "
        f"{len(step_ms)} decode steps against a {cache_len}-deep cache: "
        f"p50 {med:.2f} ms, {out['tokens_per_s']:.1f} tokens/s; peak per "
        f"rank {peak}; decode collectives {comm['calls']} calls, "
        f"{comm['bytes'] / 2 ** 20:.2f} MiB, {comm['ms']:.1f} ms")
    log(f"tokens of row 0: {tokens[0].tolist()}")
    return out


def serve_fit(cfg, batch: int, cache_len: int, mesh, memory_bytes: int,
              reserve: int = 8 * 2 ** 30) -> int:
    """The most layers, in whole periods, whose shards and decode cache
    (its rows and slice of the sequence, ``sharding.cache_specs``) fit one
    rank beside ``reserve`` bytes."""
    from . import sharding as shd
    from . import steps as steps_lib
    P = cfg.pattern_period

    def fits(n):
        c = cfg.replace(num_layers=n * P)
        p = steps_lib.abstract_params(c)
        cache = steps_lib.abstract_cache(c, batch, cache_len)
        need = (steps_lib.rank_bytes(p, shd.param_specs(c, p, mesh), mesh)
                + steps_lib.rank_bytes(cache, shd.cache_specs(
                    c, cache, mesh, batch), mesh))
        return need + reserve <= memory_bytes

    return steps_lib.most_periods(fits, cfg.num_layers // P) * P


def _serve_worker(rank: int, world: int, opts: dict) -> None:
    from . import mesh as mesh_lib
    from . import steps as steps_lib
    args = argparse.Namespace(**opts)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    log = print if rank == 0 else (lambda *_: None)
    mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                         mesh_shape=args.mesh_shape)
    cfg = get_config(args.arch, args.variant or "full")
    base = INPUT_SHAPES[args.shape]
    batch = args.batch or base.global_batch
    cache_len = args.seq_len or base.seq_len
    cuts = [f"{what} {a} -> {b}" for what, a, b in (
        ("batch", base.global_batch, batch),
        ("cache depth", base.seq_len, cache_len)) if a != b]
    layers = args.layers or serve_fit(cfg, batch, cache_len, mesh,
                                      steps_lib.device_bytes(device))
    if not layers:
        raise SystemExit(f"{cfg.name}: not one period fits a rank with a "
                         f"{batch} x {cache_len} cache")
    if layers != cfg.num_layers:
        cuts.append(f"depth {cfg.num_layers} -> {layers} layers")
    cfg = cut_depth(cfg, layers)
    log(f"cut: {', '.join(cuts) or 'none'}")
    mesh_serve(cfg, mesh, device, batch=batch,
               prompt_len=min(args.prompt_len, cache_len - args.new_tokens),
               cache_len=cache_len, new_tokens=args.new_tokens, k=args.k,
               log=log)
    log("done")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmoe-1.3b-6.9b")
    ap.add_argument("--variant", choices=("smoke", "full", "swa"),
                    default=None,
                    help="default smoke with --local, full on the mesh")
    add_depth_flag(ap)
    add_mesh_flags(ap, "decode_32k")
    ap.add_argument("--prompt-len", type=int, default=128,
                    help="mesh: prompt tokens a row of the prefill")
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
    args = build_parser().parse_args(argv)
    if not args.local:
        run_on_mesh(_serve_worker, args)
        return
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here "
                         "(pass --device cpu for the plain versions)")

    cfg = cut_depth(get_config(args.arch, args.variant or "smoke"),
                    args.layers)
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
