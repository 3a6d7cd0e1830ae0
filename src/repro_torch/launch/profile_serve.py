"""Where a serving step's time goes, on the card: a torch.profiler window.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Builds the FULL config (16 layers) with random seeded weights, warms the
engine up, then profiles one closed-batch run (8 slots
at tiers 8,8,4,4,2,2,1,1; 8 requests of 128/256-token prompts; 8 new
tokens) and prints: the device time per kernel name (top rows), the total
device-busy time (union of kernel intervals) against the wall time of the
window, hence the device's idle share, and the engine's own step times.
Then one prefill call alone (a 256-token prompt at k = 8, the serving
path's largest group), median of 5: its wall time (synchronised), the
host's time until the call returns (enqueue), and its device-busy time —
a call whose enqueue time is close to its wall time waits on the host.
With ``--speculate``, then one engine step with all 8 slots busy, plain
against speculative (W = 4 drafts at k = 1 and one full-k verify):
per plain decode step and per speculative round, the kernel launches,
wall time, device-busy time, idle share and tokens emitted.  Needs a CUDA
device.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --speculate
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..models import model as model_lib
from ..serving import Request, ServingEngine, SpeculativeConfig
from ..serving.engine import ServingReport

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


def device_summary(prof) -> Tuple[int, float, Dict[str, List[float]]]:
    """(kernel launches, device-busy ms, {kernel name: [ms, count]}) of a
    finished ``torch.profiler`` window."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    by_name: Dict[str, List[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    return len(kernels), busy, by_name


def print_rows(by_name: Dict[str, List[float]], n: int, width: int = 100) -> None:
    """The ``n`` kernel names with the most device time."""
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:n]:
        print(f"  {ms:9.3f} ms {count:6d}x  {name[:width]}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile_serve")
    ap.add_argument("--rows", type=int, default=15)
    ap.add_argument("--speculate", action="store_true",
                    help="also profile speculative rounds beside plain "
                         "decode steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    dev = torch.device("cuda")
    cfg = get_config("olmoe-1.3b-6.9b", "full")
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
    n_kernels, busy, by_name = device_summary(prof)
    print(f"{cfg.name} ({cfg.num_layers} layers) on "
          f"{torch.cuda.get_device_name(0)}: window {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, "
          f"{n_kernels} kernel launches")
    s = report.summary()
    print(f"engine: {s['decode_steps']} decode steps, p50 "
          f"{s['decode_step_ms_p50']:.2f} ms; {len(report.prefill_s)} "
          f"prefill calls, p50 {float(np.median(report.prefill_s)) * 1e3:.1f}"
          f" ms")
    print_rows(by_name, args.rows)

    prefill_split(cfg, params, rng, acts, dev)
    if args.speculate:
        step_windows(cfg, params, rng, acts, dev)


@torch.inference_mode()
def step_windows(cfg, params, rng, acts, dev, n_steps: int = 4) -> None:
    """Engine steps with all 8 slots busy (256-token prompts, requests long
    enough that none finishes): ``n_steps`` plain decode steps, then
    ``n_steps`` speculative rounds, each after one unprofiled step."""
    spec_cfg = SpeculativeConfig(window=4, draft_k=1)
    for name, spec in (("plain decode step", None),
                       ("speculative round (W=4, draft_k=1)", spec_cfg)):
        eng = ServingEngine(cfg, params, num_slots=8, slot_len=512,
                            slot_k=SLOT_K, speculative=spec)
        report = ServingReport(completions=[])
        eng._t0 = time.perf_counter()
        for i in range(8):
            eng.scheduler.add(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, (256,)).astype(np.int32),
                max_new_tokens=128, k=SLOT_K[i]))
        eng._admit(report)
        step = eng._decode_once if spec is None else eng._spec.round
        step(report)
        torch.cuda.synchronize()
        emitted = sum(len(a.tokens) for a in eng._active)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step(report)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        emitted = sum(len(a.tokens) for a in eng._active) - emitted
        n_kernels, busy, _ = device_summary(prof)
        print(f"{name}, 8 slots busy, {n_steps} steps: per step "
              f"{n_kernels / n_steps:.0f} kernel launches, wall "
              f"{wall / n_steps:.2f} ms, device busy {busy / n_steps:.2f} "
              f"ms, idle share {1 - busy / wall:.3f}, "
              f"{emitted / n_steps:.2f} tokens emitted "
              f"({wall / emitted:.2f} ms per token)")


@torch.inference_mode()
def prefill_split(cfg, params, rng, acts, dev) -> None:
    """One prefill call alone (a 256-token prompt at k = 8), median of 5,
    with and without the profiler: wall time, host enqueue time, device
    busy time."""
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                             device=dev)

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_lib.prefill(cfg, params, prompt, k=8, dispatch="ragged")
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    call()                                 # warm-up
    walls, enqueues, busies = [], [], []
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            wall, enq = call()
        walls.append(wall)
        enqueues.append(enq)
        busies.append(device_summary(prof)[1])
    print(f"prefill call (T=256, k=8) under the profiler, median of 5: "
          f"wall {np.median(walls):.1f} ms, host enqueue "
          f"{np.median(enqueues):.1f} ms, device busy "
          f"{np.median(busies):.1f} ms")
    walls, enqueues = zip(*(call() for _ in range(5)))
    print(f"prefill call (T=256, k=8) unprofiled, median of 5: wall "
          f"{np.median(walls):.1f} ms, host enqueue "
          f"{np.median(enqueues):.1f} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
