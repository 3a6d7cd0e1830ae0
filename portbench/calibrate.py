"""Readings that the correctness limits are set from (not run by the
benchmark's own runs): for each seed, one process builds the cell as a run
does and reports the compared numbers of

* ``sound``: the program against the plain reference;
* ``control``: the reference computed in float8 e4m3 put in the program's
  place (the precision below the configuration's bfloat16);
* ``half`` (training cells): the reference put in the program's place
  with half of each batch left out.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 10]

A training cell's readings need no window: its check compares set-up's
round 0.  Each reading is a JSON line on standard output and in
``chiprun_out/calibrate_<cell>.jsonl``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_seeds(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import core
    root = Path(args.root)
    cell = core.load_cell(root, args.workload)
    dev = torch.device(args.device)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = open(out_dir / f"calibrate_{args.workload}.jsonl", "a")
    sound, ctrl, fault = (parse_seeds(s) for s in (
        args.seeds, args.control_seeds, args.fault_seeds))
    for seed in sorted(set(sound) | set(ctrl) | set(fault)):
        t = time.perf_counter()
        drv = core.driver(cell.traffic["driver"]).Driver(cell, dev)
        drv.setup(seed)
        train = cell.traffic["driver"] == "fl_round"
        run = ({"e2e": {}, "failed": 0, "attempted": 0} if train
               else drv.window(args.seconds))
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else 0.0)
        drv.free_program()
        rows = []
        if seed in sound:
            rows.append(("sound", drv.check()))
        if seed in ctrl:
            rows.append(("control", drv.stand_in(precision="fp8") if train
                         else drv.check(control=True)))
        if seed in fault and train:
            rows.append(("half", drv.stand_in(drop_half=True)))
        for kind, nums in rows:
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "kind": kind, "numbers": nums,
                               "e2e": run["e2e"], "failed": run["failed"],
                               "attempted": run["attempted"],
                               "peak_gib": peak,
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            log.write(line + "\n")
            log.flush()
        del drv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)


if __name__ == "__main__":
    main()
