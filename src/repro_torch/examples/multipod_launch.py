"""Production-mesh launch example, on the port (twin of
``examples/multipod_launch.py``).

Builds the production mesh for an architecture and binds its sharded
train step.  By default it stops at the dry run (``launch/dryrun.py``:
the step traced once as rank 0 of a 2 x 16 x 16 world on torch's ``fake``
backend, ``meta`` tensors, no card) and prints the memory and roofline
summary, priced with the H100's figures.  ``--cards N`` runs the real
step on N cards instead (one NCCL process a card, ``launch.mesh.spawn``)
at the deepest depth the knob chooser fits on them, and prints the
measured peak per rank and s/step next to the dry run's figures for the
same cut.

  PYTHONPATH=src python -m repro_torch.examples.multipod_launch \\
      --arch qwen3-moe-235b-a22b
  PYTHONPATH=src python -m repro_torch.examples.multipod_launch \\
      --arch llama3-405b --cards 4            # four cards
"""
import argparse
import json
import tempfile
from pathlib import Path


def _summary(rec) -> None:
    r = rec["roofline"]
    print(f"\n{rec['arch']} × {rec['shape']} on mesh {rec['mesh']} "
          f"({rec['chips']} cards):")
    knobs = {k: rec["meta"][k] for k in ("n_micro", "act_mode", "num_groups",
                                         "remat_chunk", "k")
             if k in rec["meta"]}
    print(f"  step = {rec['step']}  knobs = {knobs}")
    print(f"  memory a card (estimate): {rec['memory']['peak_gb']:.2f} GiB "
          f"({', '.join(f'{k} {v:.2f}' for k, v in rec['memory'].items() if k != 'peak_gb')})")
    print(f"  roofline: compute {r['t_compute_ms']:.2f} ms | "
          f"memory {r['t_memory_ms']:.2f} ms | "
          f"collective {r['t_collective_ms']:.2f} ms "
          f"-> bottleneck: {r['bottleneck']}")
    print(f"  useful-compute fraction: {r['useful_frac']:.2%}  "
          f"roofline-MFU: {r['mfu']:.2%}")


def _card_worker(rank, world, opts):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import mesh_train
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_production_mesh(mesh_shape=opts["mesh_shape"],
                                         multi_pod=len(opts["mesh_shape"]) == 3)
    cfg = get_config(opts["arch"]).replace(num_layers=opts["layers"])
    out = mesh_train(cfg, opts["shape"], mesh, device, steps=2, seed=0,
                     log=print if rank == 0 else (lambda *_: None))
    if rank == 0:
        last = out["steps"][-1]
        Path(opts["out"]).write_text(json.dumps(
            {"s": last["s"], "peak_bytes": last["peak_bytes"],
             "comm": last["comm"]}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "multipod_launch")
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--cards", type=int, default=0,
                    help="run the step on this many cards (0: dry run)")
    ap.add_argument("--batch", type=int, default=8,
                    help="with --cards: the global batch (train_4k's 256 "
                    "cut to what a node holds)")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_pair
    if not args.cards:
        rec = run_pair(args.arch, args.shape, multi_pod=args.multi_pod)
        _summary(rec)
        print("\nOn a real 512-card H100 cluster this step runs as-is "
              "(same mesh axes, same shards): --cards N runs it on N.")
        return

    import torch

    from repro_torch.configs import INPUT_SHAPES, ShapeConfig, get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch.train import MESH_RESERVE
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        raise SystemExit(f"--cards {args.cards}: "
                         f"{torch.cuda.device_count()} CUDA device(s) visible")
    base = INPUT_SHAPES[args.shape]
    if base.kind != "train":
        raise SystemExit("--cards runs the train step: pick a train shape")
    shape = ShapeConfig(base.name, base.seq_len, args.batch, "train")
    mesh_shape = mesh_lib.production_shape(args.cards, args.multi_pod)
    # the knob chooser's budget, as the workers' mesh_train sets it
    memory = steps.device_bytes("cuda") - MESH_RESERVE
    full = get_config(args.arch)
    # the dry run first (the fake world lives in this process only; the
    # card workers are fresh processes)
    mesh_lib.fake_world(args.cards)
    layers = steps.deepest_fit(
        full, shape, mesh_lib.make_production_mesh(
            multi_pod=args.multi_pod, mesh_shape=mesh_shape), memory)
    if not layers:
        raise SystemExit(f"{args.arch}: not one period fits {args.cards} "
                         "cards")
    rec = run_pair(args.arch, args.shape, shape=shape, mesh_shape=mesh_shape,
                   cfg_replace={"num_layers": layers}, memory_bytes=memory)
    torch.distributed.destroy_process_group()
    print(f"{args.arch}: {layers} of {full.num_layers} layers fit "
          f"{args.cards} cards; batch {args.batch} x {shape.seq_len} tokens")
    _summary(rec)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "card.json"
        mesh_lib.spawn(_card_worker, args.cards,
                       {"arch": args.arch, "shape": shape, "layers": layers,
                        "mesh_shape": mesh_shape, "out": str(out)})
        card = json.loads(out.read_text())
    r = rec["roofline"]
    peak = max(card["peak_bytes"]) / 2 ** 30
    print(f"\non {args.cards} cards: {card['s']:.3f} s/step (roofline "
          f"{max(r['t_compute_ms'], r['t_memory_ms'], r['t_collective_ms']) / 1e3:.3f} s), "
          f"peak {peak:.2f} GiB a rank (estimate "
          f"{rec['memory']['peak_gb']:.2f}), collectives "
          f"{card['comm']['calls']} calls, "
          f"{card['comm']['bytes'] / 2 ** 30:.3f} GiB (dry run "
          f"{sum(rec['collectives']['execs_by_kind'].values())} calls, "
          f"{sum(rec['collectives']['bytes_by_kind'].values()) / 2 ** 30:.3f} "
          f"GiB), {card['comm']['ms']:.1f} ms")


if __name__ == "__main__":
    main()
