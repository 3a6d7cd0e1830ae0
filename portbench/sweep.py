"""The knee of a serving cell: one set-up, then one window at each offered
rate, each reporting whether its queue grew.  Not run by the benchmark's
own runs; its result is the rate written into ``cells/<cell>.json``.

    python3 portbench/sweep.py --workload <cell> --rates 10,20,30 \\
        --seconds 30 --seed 7

A window's queue grows when the wait from arrival to admission of the
last quarter of its arrivals is over twice the first quarter's and over
100 ms more."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    from portbench import core, window
    cell = core.load_cell(ROOT, args.workload)
    drv = core.driver(cell.traffic["driver"]).Driver(cell,
                                                     torch.device("cuda"))
    drv.setup(args.seed)
    print(f"setup {time.perf_counter() - T0:.1f} s", flush=True)
    for r in [float(x) for x in args.rates.split(",")]:
        drv.mix["rate_rps"] = r
        run = drv.window(args.seconds)
        q = run["queue_s"]              # by arrival
        n = len(q) // 4
        first, last = float(np.mean(q[:n])), float(np.mean(q[-n:]))
        print(json.dumps({
            "rate": r, "n": len(q), "e2e": run["e2e"],
            "ttft_p50_ms": window.percentile(run["ttft_s"], 50) * 1e3,
            "tokens_per_s": run["generated"] / run["window_s"],
            "queue_first_ms": first * 1e3, "queue_last_ms": last * 1e3,
            "grows": bool(last > 2 * first and last - first > 0.1),
            "wall_s": run["window_s"],
            "decode_steps": len(run["decode_step_s"]),
            "decode_ms": float(np.mean(run["decode_step_s"])) * 1e3,
            "prefill_ms": float(np.mean(run["prefill_s"])) * 1e3}),
            flush=True)


if __name__ == "__main__":
    main()
