"""End-to-end federated fine-tuning driver on the port (twin of
``examples/federated_finetune.py``).

Runs the full FLAME pipeline (or a baseline) for a configurable number of
rounds on the reference's default round engine, with a checkpoint after
every round, resumability, and a final test loss.  ``--large`` selects the
~100M-parameter model.

  PYTHONPATH=src python -m repro_torch.examples.federated_finetune \\
      --rounds 3 --clients 4 --alpha 0.5 --method flame --out runs/flame

Resume after an interruption (``--resume`` takes the output directory):

  PYTHONPATH=src python -m repro_torch.examples.federated_finetune \\
      --resume runs/flame

``--device cpu`` runs the kernels' plain versions; the default is the card.
"""
import argparse
import os
import time

import numpy as np

from repro_torch.configs import (FederatedConfig, LoRAConfig, MoEConfig,
                                 TrainConfig, get_config)
from repro_torch.data.synthetic import DataConfig
from repro_torch.examples.quickstart import device_from
from repro_torch.federated.client import evaluate
from repro_torch.federated.simulation import build_experiment


def model_for(large: bool):
    cfg = get_config("olmoe-1.3b-6.9b", "full")
    if large:
        # ~100M-class OLMoE-family config (8 layers, d=512, 16 experts)
        return cfg.replace(
            name="olmoe-100m", num_layers=8, d_model=512, n_heads=8,
            n_kv_heads=8, head_dim=64, vocab_size=8192,
            moe=MoEConfig(num_experts=16, top_k=4, d_expert=512),
            lora=LoRAConfig(rank=8))
    return cfg.replace(
        name="olmoe-mini", num_layers=4, d_model=256, n_heads=4,
        n_kv_heads=4, head_dim=64, vocab_size=2048,
        moe=MoEConfig(num_experts=8, top_k=4, d_expert=256),
        lora=LoRAConfig(rank=8))


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "federated_finetune")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--method", default="flame",
                    choices=["flame", "trivial", "hlora", "flexlora"])
    ap.add_argument("--temperature", type=int, default=2)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--out", default="runs/flame")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    device = device_from(args.device)

    out = args.resume or args.out
    os.makedirs(out, exist_ok=True)

    cfg = model_for(args.large)
    fed = FederatedConfig(
        num_clients=args.clients, rounds=args.rounds,
        participation=args.participation, dirichlet_alpha=args.alpha,
        temperature=args.temperature, method=args.method, seed=0)
    tc = TrainConfig(batch_size=8 if not args.large else 16, local_epochs=1)
    data = DataConfig(vocab_size=cfg.vocab_size,
                      n_examples=512 if args.large else 256,
                      seq_len=128 if args.large else 64, n_clusters=8)

    exp = build_experiment(cfg, fed=fed, tc=tc, data=data, device=device)

    start_round = 0
    state_path = os.path.join(out, "state.npz")
    if args.resume and os.path.exists(state_path):
        # server-side resume: restores the global LoRA, every client's
        # local rescaler s_i, and replays the participant-sampling RNG so
        # the continued run matches an uninterrupted one
        start_round = exp.server.restore_checkpoint(state_path)
        print(f"resumed at round {start_round} from {state_path}")

    init = evaluate(cfg, exp.server.params, None, exp.val,
                    k=cfg.moe.top_k or 1)
    print(f"[{cfg.name}] {args.method} on {device} | clients={args.clients} "
          f"alpha={args.alpha} | init val loss {init:.4f}")

    for r in range(start_round, args.rounds):
        t0 = time.time()
        res = exp.server.run_round(r)
        val = evaluate(cfg, exp.server.params,
                       {"lora": exp.server.global_lora}, exp.val,
                       k=cfg.moe.top_k or 1)
        print(f"round {r}: mean client loss "
              f"{np.mean(res.client_losses):.4f} | global val {val:.4f} | "
              f"clients {res.participating} | {time.time() - t0:.1f}s")
        exp.server.save_checkpoint(state_path)

    test = evaluate(cfg, exp.server.params,
                    {"lora": exp.server.global_lora}, exp.test,
                    k=cfg.moe.top_k or 1)
    print(f"final test loss {test:.4f} | score {100 * np.exp(-test):.2f} | "
          f"state: {state_path}")


if __name__ == "__main__":
    main()
