"""Quickstart: FLAME in ~60 lines, on the port (twin of
``examples/quickstart.py``).

Builds a small OLMoE-family SMoE model, runs TWO federated fine-tuning
rounds with four budget-heterogeneous clients (k_i ∈ {2,1,1,1}) on the
reference's default round engine, and shows the three FLAME mechanisms:

  1. clients fine-tune the FULL global LoRA with fewer activated experts;
  2. each client trains its own output rescaler s_i;
  3. the server aggregates with activation-aware weights (Eq. 6–7).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      (``--device cpu`` for the kernels' plain versions)
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import FederatedConfig, TrainConfig, get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.federated.client import evaluate
from repro_torch.federated.simulation import build_experiment, run_experiment


def device_from(name: str) -> torch.device:
    """The requested device; a missing card is an error, never the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu for the plain versions)")
    return device


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    device = device_from(ap.parse_args().device)

    cfg = get_config("olmoe-1.3b-6.9b", "smoke")   # 2L, 4 experts top-2
    fed = FederatedConfig(num_clients=4, rounds=2, method="flame",
                          dirichlet_alpha=0.5, temperature=2,
                          rescaler="learnable", seed=0)
    tc = TrainConfig(batch_size=8, local_epochs=1)
    data = DataConfig(vocab_size=cfg.vocab_size, n_examples=192,
                      seq_len=64, n_clusters=8)

    print(f"model: {cfg.name} ({cfg.num_layers}L, d={cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}) on {device}")
    exp = build_experiment(cfg, fed=fed, tc=tc, data=data, device=device)
    for c, b in zip(exp.server.clients, exp.budgets):
        print(f"  client {c.client_id}: budget {b}, k_i={c.k}, "
              f"|D_i|={c.dataset_size}")

    init_loss = evaluate(cfg, exp.server.params, None, exp.val,
                         k=cfg.moe.top_k)
    print(f"\nval loss before fine-tuning: {init_loss:.4f}")

    res = run_experiment(exp)
    print(f"val loss after {res['rounds']} FLAME rounds: "
          f"{res['val_loss']:.4f}  (score {res['score']:.2f})")

    # the deployment-efficiency claim: serve with fewer activated experts
    # (as in the original, run_experiment runs the rounds once more first)
    res_k1 = run_experiment(exp, eval_k=1)
    print(f"served with k=1 instead of k={cfg.moe.top_k}: "
          f"val loss {res_k1['val_loss']:.4f}")

    # inspect a trained rescaler and the round's activation imbalance
    s = exp.server.clients[2].rescaler
    if s is not None:
        print(f"\nclient 2 learned rescaler s_i (init k/k_i): "
              f"{list(s.values())[0].cpu().numpy().round(3)}")
    freqs = exp.server.history[-1].client_freqs[0]
    f = np.concatenate([np.asarray(v).ravel() for v in freqs.values()])
    print(f"client 0 expert activation freqs: min {f.min():.3f} "
          f"max {f.max():.3f} (imbalance motivates Eq. 6)")


if __name__ == "__main__":
    main()
