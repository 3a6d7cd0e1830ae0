"""Serving from two checkouts, alternated as processes on one card.

    PYTHONPATH=src python -m repro_torch.launch.ab_serve --parent DIR

``DIR`` is the root of another checkout of this repository (an earlier
commit, unpacked with ``git archive`` into a gitignored directory).  Where
two builds differ in their Python as well as their kernels,
``launch/ab_kernels.py`` (one process, libraries swapped) cannot compare
them; this runs each arm as its own process, with that checkout's
``src`` on ``PYTHONPATH``:

- ``--pairs`` pairs (default 10) of ``chip_smoke.py``'s serving workload
  (OLMoE-1.3B/6.9B FULL, bf16, random seeded weights, 8 slots at tiers
  8,8,4,4,2,2,1,1, one warm-up run, then 16 requests of 128/256-token
  prompts and 16 new tokens each), in the order parent, this, this,
  parent, ...: generated tokens/s, decode-step p50, prefill-call p50 and
  TTFT p50 per process, and the measured run's kernel launches;
- ``--aa-pairs`` pairs (default 10) of the parent against itself,
  interleaved with those, for the spread of the same metrics;
- ``--windows`` (default 2) ``launch/profile_serve.py`` windows of each
  checkout, parent, this, this, parent: their summary lines.

Prints one line per process, then one JSON line: the medians per arm of
the A/B pairs and of the A/A pairs, each pair set's relative gap of the
other arm to the parent, and the other arm's wins per pair (tokens/s
higher, times lower).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

ROOT = Path(__file__).resolve().parents[3]
METRICS = ("tokens_per_s", "decode_step_ms_p50", "prefill_ms_p50",
           "ttft_ms_p50")
HIGHER_IS_BETTER = {"tokens_per_s"}

# one serving run in a fresh process, on the checkout that PYTHONPATH names
WORKER = r'''
import json, statistics
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import model as model_lib
from repro_torch.serving import Request, ServingEngine

SLOT_K = (8, 8, 4, 4, 2, 2, 1, 1)
dev = torch.device("cuda")
cfg = get_config("olmoe-1.3b-6.9b", "full")
params = model_lib.init_params(
    cfg, torch.Generator(device=dev).manual_seed(0), dev)
engine = ServingEngine(cfg, params, num_slots=8, slot_len=512, slot_k=SLOT_K)


def requests(n, new):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, ((128, 256)[i % 2],)).astype(np.int32),
                    max_new_tokens=new, k=SLOT_K[i % 8]) for i in range(n)]


engine.run(requests(8, 2))
torch.cuda.synchronize()
_build.reset_launches()
report = engine.run(requests(16, 16))
torch.cuda.synchronize()
s = report.summary()
print("AB_SERVE " + json.dumps({
    "tokens_per_s": s["gen_tokens_per_s"],
    "decode_step_ms_p50": s["decode_step_ms_p50"],
    "prefill_ms_p50": statistics.median(report.prefill_s) * 1e3,
    "ttft_ms_p50": s["ttft_p50_ms"],
    "decode_steps": s["decode_steps"],
    "launches": dict(_build.LAUNCHES)}))
'''


def _run(root: Path, args: List[str], timeout: int = 600) -> str:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise SystemExit(f"{root}: {' '.join(args[:2])} failed "
                         f"({out.returncode}):\n{out.stdout[-3000:]}"
                         f"{out.stderr[-3000:]}")
    return out.stdout


def serve_once(root: Path) -> Dict[str, object]:
    for line in _run(root, ["-c", WORKER]).splitlines():
        if line.startswith("AB_SERVE "):
            return json.loads(line[len("AB_SERVE "):])
    raise SystemExit(f"{root}: the serving worker printed no result")


def _order(pairs: int, first: str, second: str):
    """first, second, second, first, ...: each arm first in half the
    pairs."""
    for i in range(pairs):
        yield (first, second) if i % 2 == 0 else (second, first)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.ab_serve")
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--aa-pairs", type=int, default=10)
    ap.add_argument("--windows", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_serve needs a CUDA device")
    parent = args.parent.resolve()
    if not (parent / "src" / "repro_torch").is_dir():
        raise SystemExit(f"--parent {parent}: no src/repro_torch there")
    roots = {"this": ROOT, "parent": parent, "parent_aa": parent}
    runs: Dict[str, Dict[str, List[Dict[str, object]]]] = {
        "ab": {"parent": [], "this": []},
        "aa": {"parent": [], "parent_aa": []}}
    pairs: Dict[str, List[tuple]] = {"ab": [], "aa": []}
    ab = list(_order(args.pairs, "parent", "this"))
    aa = list(_order(args.aa_pairs, "parent", "parent_aa"))
    for i in range(max(len(ab), len(aa))):
        for kind, order in (("ab", ab), ("aa", aa)):
            if i >= len(order):
                continue
            got = {}
            for arm in order[i]:
                got[arm] = serve_once(roots[arm])
                runs[kind][arm].append(got[arm])
                print(f"serve {kind} pair {i} {arm}: " + ", ".join(
                    f"{m} {got[arm][m]:.3f}" for m in METRICS)
                    + f", launches {json.dumps(got[arm]['launches'])}",
                    flush=True)
            pairs[kind].append(tuple(got[arm] for arm in order[i]
                                     if arm != "parent") + (got["parent"],))

    def wins(kind):
        """Per metric, the pairs whose non-parent arm did better."""
        out = {}
        for m in METRICS:
            sign = 1 if m in HIGHER_IS_BETTER else -1
            out[m] = sum(sign * (other[m] - par[m]) > 0
                         for other, par in pairs[kind])
        return out

    med = {kind: {arm: {m: statistics.median(r[m] for r in rs)
                        for m in METRICS}
                  for arm, rs in arms.items() if rs}
           for kind, arms in runs.items()}
    gap = {kind: {m: (med[kind][arm][m] - med[kind]["parent"][m])
                  / med[kind]["parent"][m] for m in METRICS}
           for kind, arm in (("ab", "this"), ("aa", "parent_aa"))
           if arm in med[kind]}

    for i in range(args.windows):
        for arm in ("parent", "this") if i % 2 == 0 else ("this", "parent"):
            out = _run(roots[arm], ["-m", "repro_torch.launch.profile_serve",
                                    "--rows", "25"])
            print(f"profile window {i} {arm}:\n" + out.rstrip(), flush=True)

    print(json.dumps({"ab_serve": {
        "medians": med, "relative_gap_to_parent": gap,
        "wins_of_this": wins("ab") if pairs["ab"] else None,
        "wins_of_parent_aa": wins("aa") if pairs["aa"] else None,
        "pairs": args.pairs, "aa_pairs": args.aa_pairs}}))


if __name__ == "__main__":
    main(sys.argv[1:])
