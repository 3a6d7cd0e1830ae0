"""Where a serving step's time goes, on the card: a torch.profiler window.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--layers N]

Builds the FULL config (``--layers`` cuts depth) with random seeded
weights, warms the engine up, then profiles one closed-batch run (8 slots
at tiers 8,8,4,4,2,2,1,1; 8 requests of 128/256-token prompts; 8 new
tokens) and prints: the device time per kernel name (top rows), the total
device-busy time (union of kernel intervals) against the wall time of the
window, hence the device's idle share, and the engine's own step times.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..models import model as model_lib
from ..serving import Request, ServingEngine

SLOT_K = (8, 8, 4, 4, 2, 2, 1, 1)


def _busy_ms(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (microseconds in,
    milliseconds out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile_serve")
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--rows", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    dev = torch.device("cuda")
    cfg = get_config("olmoe-1.3b-6.9b", "full").replace(num_layers=args.layers)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)

    def requests(n, new):
        return [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, ((128, 256)[i % 2],)).astype(np.int32),
                        max_new_tokens=new, k=SLOT_K[i % 8]) for i in range(n)]

    engine = ServingEngine(cfg, params, num_slots=8, slot_len=512,
                           slot_k=SLOT_K)
    engine.run(requests(8, 2))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        report = engine.run(requests(8, 8))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    print(f"{cfg.name} ({cfg.num_layers} layers) on "
          f"{torch.cuda.get_device_name(0)}: window {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, "
          f"{len(kernels)} kernel launches")
    s = report.summary()
    print(f"engine: {s['decode_steps']} decode steps, p50 "
          f"{s['decode_step_ms_p50']:.2f} ms; {len(report.prefill_s)} "
          f"prefill calls, p50 {float(np.median(report.prefill_s)) * 1e3:.1f}"
          f" ms")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.rows]
    for name, (ms, n) in rows:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:100]}")


if __name__ == "__main__":
    main(sys.argv[1:])
