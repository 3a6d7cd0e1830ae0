"""Where a training step's time goes, on the card: a torch.profiler window.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--k 8]

Builds the FULL config (all 16 layers) with random seeded weights and the
FLAME experiment of ``chip_smoke.py``'s training phase (4
clients at k = 8, 4, 2, 1, learnable rescalers, batch 16 x 128 tokens,
Adam), runs one local step of the client at budget ``--k`` off the clock
(warm-up), then profiles one more step of the same client on its first
batch and prints: the device time per kernel name (top 20), the device
time of the port's own CUDA kernels against PyTorch's, the device-busy
time (union of kernel intervals) against the wall time of the window,
hence the device's idle share, and the port's kernel launches in the
window.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch

from ..configs import FederatedConfig, TrainConfig, get_config
from ..data.synthetic import DataConfig
from ..federated import client as client_lib
from ..federated.simulation import build_experiment
from ..kernels import _build
from .profile_serve import device_summary, print_rows

# substrings of the port's kernel symbols (csrc/*.cu)
PORT_KERNELS = ("lora_wgmma_kernel", "lora_matmul_kernel", "flash_mma_kernel",
                "flash_fwd_kernel", "topk_router", "ragged_")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile_train")
    ap.add_argument("--k", type=int, default=8, choices=(8, 4, 2, 1))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda")
    cfg = get_config("olmoe-1.3b-6.9b", "full")
    fed = FederatedConfig(num_clients=4, rounds=1, method="flame",
                          round_engine="looped", rescaler="learnable")
    tc = TrainConfig()
    exp = build_experiment(cfg, fed=fed, tc=tc,
                           data=DataConfig(vocab_size=512, n_examples=160,
                                           seq_len=128), device=dev)
    server = exp.server
    client = next(c for c in server.clients if c.k == args.k)
    plan = client_lib.make_batch_plan(client, tc, fed.seed * 1000)
    trainable = {"lora": server.global_lora, "rescaler": client.rescaler}

    def step():
        client_lib.local_update(
            cfg, server.params, trainable, plan.tokens[:1], plan.labels[:1],
            plan.mask[:1], plan.valid[:1], k=client.k, tc=tc,
            rescaler_trainable=True)

    step()                                  # warm-up: build, cuBLAS, caches
    torch.cuda.synchronize()
    _build.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    n_kernels, busy, by_name = device_summary(prof)
    port_ms = sum(ms for name, (ms, _) in by_name.items()
                  if any(p in name for p in PORT_KERNELS))
    total_ms = sum(ms for ms, _ in by_name.values())
    B, S = plan.tokens.shape[1:3]
    print(f"{cfg.name} ({cfg.num_layers} layers) on "
          f"{torch.cuda.get_device_name(0)}: one local step at k={client.k} "
          f"({B}x{S} tokens): window {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, "
          f"{n_kernels} kernel launches")
    print(f"device time: port kernels {port_ms:.1f} ms, PyTorch ops "
          f"{total_ms - port_ms:.1f} ms (sum of kernel times {total_ms:.1f} ms)")
    print(f"port launches: {json.dumps(launches)}")
    print_rows(by_name, 20, width=110)


if __name__ == "__main__":
    main(sys.argv[1:])
