"""Adaptive-activation serving (FLAME's deployment-efficiency claim), on
the port (twin of ``examples/adaptive_serving.py``).

A model fine-tuned under reduced expert activation can be SERVED with
reduced activation — and the serving engine makes the trade-off per
REQUEST TIER, not per deployment: after federated fine-tuning the merged
model is loaded into one ``repro_torch.serving.ServingEngine`` whose KV
slots are split between a premium tier (full top_k) and constrained tiers
(k=1–2), all decoding in the same mixed-k step.

Quality is measured through the engine itself: each held-out prompt is
submitted as a teacher-forced request (``Request.forced``), so the
reported per-tier NLL is the NLL of the exact tokens the serving path
scores.  Like the reference, this example merges the adapter into the
weights; ``ServingEngine(lora=...)`` serves it unmerged.

  PYTHONPATH=src python -m repro_torch.examples.adaptive_serving \\
      --new-tokens 16          # --device cpu for the plain versions
"""
import argparse

import numpy as np

from repro_torch.configs import FederatedConfig, TrainConfig
from repro_torch.configs.olmoe_1_3b_6_9b import BENCH as cfg
from repro_torch.core import flops as F
from repro_torch.core import lora as lora_lib
from repro_torch.data.synthetic import DataConfig
from repro_torch.examples.quickstart import device_from
from repro_torch.federated.simulation import build_experiment
from repro_torch.serving import Request, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "adaptive_serving")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    device = device_from(args.device)

    fed = FederatedConfig(num_clients=2, rounds=args.rounds, method="flame")
    tc = TrainConfig(batch_size=8)
    data = DataConfig(vocab_size=cfg.vocab_size, n_examples=128, seq_len=64)
    exp = build_experiment(cfg, fed=fed, tc=tc, data=data, device=device)
    exp.server.run()

    # deployment: merge LoRA into the base weights (zero serving overhead)
    params = lora_lib.merge_into_params(exp.server.params,
                                        exp.server.global_lora,
                                        cfg.lora.scale)

    prompts = np.asarray(exp.test.tokens[:args.batch, :32], np.int32)
    golds = np.asarray(exp.test.tokens[:args.batch,
                                       32:32 + args.new_tokens], np.int32)

    tiers = sorted({cfg.moe.top_k, max(cfg.moe.top_k // 2, 1), 1},
                   reverse=True)
    print(f"serving {cfg.name} on {device}: {cfg.moe.num_experts} experts, "
          f"trained top-{cfg.moe.top_k}; engine = "
          f"{args.batch * len(tiers)} slots over tiers k={tiers}, "
          f"prefill 32 + decode {args.new_tokens}\n")

    # one engine, one mixed-k decode step: `args.batch` slots per tier,
    # every tier decoding the SAME prompts teacher-forced on the gold
    # continuation so the per-tier NLLs are directly comparable
    slot_k = tuple(k for k in tiers for _ in range(args.batch))
    engine = ServingEngine(cfg, params, num_slots=len(slot_k),
                           slot_len=32 + args.new_tokens, slot_k=slot_k)
    requests = [
        Request(rid=t * args.batch + b, prompt=prompts[b],
                max_new_tokens=args.new_tokens, k=k, forced=golds[b])
        for t, k in enumerate(tiers) for b in range(args.batch)
    ]
    report = engine.run(requests)

    print("k,active_params_M,decode_GFLOPs_per_tok,nll,latency_p50_ms")
    by_rid = {c.rid: c for c in report.completions}
    for t, k in enumerate(tiers):
        comps = [by_rid[t * args.batch + b] for b in range(args.batch)]
        nll = float(np.mean([c.nll_sum / c.n_generated for c in comps]))
        lat = float(np.median([c.latency for c in comps])) * 1e3
        p_act = F.count_params(cfg, k=k)["active"] / 1e6
        gflops = F.flops_paper_convention(cfg, tokens=1, k=k) / 1e9
        print(f"{k},{p_act:.1f},{gflops:.3f},{nll:.4f},{lat:.1f}")

    s = report.summary()
    print(f"\nengine: {s['decode_steps']} mixed-k decode steps, "
          f"{s['gen_tokens_per_s']:.1f} tok/s, "
          f"TTFT p95 {s['ttft_p95_ms']:.1f} ms")
    print("lower k => proportionally fewer active params/FLOPs per token "
          "with modest quality cost — the paper's Table 1 economics, "
          "per request tier in one serving batch.")


if __name__ == "__main__":
    main()
