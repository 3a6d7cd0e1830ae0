"""Training launcher of the port.

Three modes, as the reference launcher's:

  * ``--federated`` assembles an experiment (``build_experiment``: base
    model, global LoRA, Dirichlet-partitioned synthetic corpus, budgeted
    clients) and runs every round of FLAME on the reference's default
    engine (batched cohorts) on the round driver ``--round-driver``
    (``host``, the default, or ``device``: a checkpoint segment's rounds
    with no host read inside it), then evaluates the global adapter.
    ``--checkpoint-to`` writes a resumable checkpoint after every round
    (host driver) or every ``--checkpoint-every`` rounds (device driver),
    and ``--resume-from`` continues from one, on either driver.  The data
    vocabulary is the model's, capped at 512 tokens (a full-width model
    keeps its full embedding and head: the synthetic corpus builds a dense
    vocab x vocab transition matrix per cluster, ~10 GB at 50,304 tokens).
    An audio arch (``musicgen-large``) is refused here: this corpus is
    (B, S) text, as the reference launcher's is, which crashes on it.
  * ``--local`` runs the single-device train step (``launch/steps.py``
    ``build_train``: microbatches, layer checkpointing, Adam on the
    adapters) at the reference's ``local_train`` shape, 8 sequences of 64
    tokens, for ``--steps`` steps on seeded random weights and random
    token batches ((B, S, K) codebook tokens for an audio arch): it prints
    the chosen knobs, then each step's loss and time, and stops if a loss
    is not finite.
  * default: the sharded train step (``launch/steps.py`` with ``mesh=``)
    on the production mesh of the visible cards (``launch/mesh.py``:
    (2, 2) on four, (2, 1, 2) with ``--multi-pod``; ``--mesh-shape``
    overrides it) at ``--shape`` (``INPUT_SHAPES``), ``--variant full``
    by default: the launcher starts one worker a card itself (the
    ``spawn`` start method, a ``file://`` rendezvous), or under ``torchrun``
    joins the world its environment describes.  Each rank makes only its
    shard of seeded random weights and adapters (``init_sharded_*``) and
    takes its rows of a seeded random batch; ``--steps`` steps print the
    loss, s/step, tokens/s, each rank's peak memory against the knob
    chooser's estimate and the collectives' calls, bytes and time.  The
    depth is ``--layers`` or the deepest whole-period cut the estimate
    fits, ``--batch`` / ``--seq-len`` cut the shape; every cut is
    printed.  On ``--device cpu`` the ranks are ``--world`` gloo
    processes (default 2).  Every arch of the registry runs there
    (``jamba-v0.1-52b`` cut in whole periods of 8).

All run on the CUDA kernels unless given ``--device cpu`` (their plain
versions).  ``--variant`` defaults to the reduced smoke config, as the
reference's launcher does; ``--arch`` takes any arch of the port's
registry, and ``--layers`` cuts its depth in whole periods of its layer
pattern (``jamba-v0.1-52b`` FULL does not fit one card).

  PYTHONPATH=src python -m repro_torch.launch.train --federated \\
      --device cpu --clients 4 --rounds 2 --checkpoint-to build/fed.ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --federated \\
      --device cpu --clients 4 --rounds 3 --round-driver device \\
      --checkpoint-every 2 --checkpoint-to build/fed.ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --local \\
      --arch olmo-1.3b --device cpu --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-235b-a22b --shape train_4k --batch 8 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch llama3-405b --variant smoke --multi-pod --world 2 \\
      --batch 4 --seq-len 32 --steps 1
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import (INPUT_SHAPES, FederatedConfig, ShapeConfig,
                       TrainConfig, get_config)
from ..core import lora as lora_lib
from ..data.synthetic import DataConfig
from ..federated.simulation import build_experiment, run_experiment
from ..models import model as model_lib
from ..models import parallel
from ..optim import adam
from . import mesh as mesh_lib
from . import sharding as shd
from . import steps as steps_lib
from .serve import add_depth_flag, add_mesh_flags, cut_depth, run_on_mesh

# a card's memory the mesh step's knob and depth estimates keep out: the
# CUDA context, NCCL's buffers, the allocator's fragmentation
MESH_RESERVE = 8 * 2 ** 30


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--federated", action="store_true",
                    help="run the federated simulation end to end")
    ap.add_argument("--local", action="store_true",
                    help="run the single-device train step on random "
                         "batches")
    ap.add_argument("--steps", type=int, default=5,
                    help="--local: train steps to run")
    ap.add_argument("--arch", default="olmoe-1.3b-6.9b")
    ap.add_argument("--variant", default=None,
                    help="full | smoke | swa (full with sliding-window "
                         "attention); default smoke with --federated / "
                         "--local, full on the mesh")
    add_depth_flag(ap)
    add_mesh_flags(ap, "train_4k")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=None,
                    help="--federated: evaluation expert budget; --local: "
                         "the client's expert budget k_i (default: top_k)")
    ap.add_argument("--round-driver", default="host",
                    choices=("host", "device"),
                    help="host = per-round Python loop (oracle); device = "
                         "a checkpoint segment's rounds with no host read "
                         "inside it")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="device driver: rounds per checkpoint segment")
    ap.add_argument("--checkpoint-to", default=None,
                    help="write a resumable checkpoint after every round "
                         "(host) or segment (device)")
    ap.add_argument("--resume-from", default=None,
                    help="continue from a checkpoint")
    return ap


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu for the plain versions)")
    return device


def synthetic_batch(cfg, shape: ShapeConfig, generator: torch.Generator,
                    device):
    """Random tokens (B, S), or (B, S, K) for an audio model, over the
    model's vocabulary, next-token labels (the sequence rolled by one, as
    the reference's) and an all-ones (B, S) mask."""
    B, S = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size,
                           steps_lib.token_shape(cfg, B, S),
                           generator=generator, device=device,
                           dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=device)
    return tokens, labels, mask


def run_local(args) -> None:
    """--local: the train step of ``launch/steps.py`` on this device."""
    device = _device(args.device)
    cfg = cut_depth(get_config(args.arch, args.variant or "smoke"),
                    args.layers)
    shape = ShapeConfig("local_train", seq_len=64, global_batch=8,
                        kind="train")
    bundle = steps_lib.build_train(cfg, shape, k=args.k, tc=TrainConfig(),
                                   device=device)
    print(f"{cfg.name} x {shape.name} on {device}: knobs={bundle.meta}")
    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    lora = lora_lib.init_lora(
        torch.Generator(device=device).manual_seed(args.seed + 1), cfg,
        params)
    resc = (lora_lib.init_rescalers(cfg, bundle.meta["k"] or 1,
                                    device=device)
            if cfg.moe.enabled else None)
    trainable = lora_lib.make_trainable(lora, resc)
    opt = adam.init(trainable)
    gen = torch.Generator(device=device).manual_seed(args.seed + 100)
    for step in range(args.steps):
        tokens, labels, mask = synthetic_batch(cfg, shape, gen, device)
        t0 = time.perf_counter()
        trainable, opt, metrics = bundle.fn(params, trainable, opt, tokens,
                                            labels, mask)
        loss = float(metrics["loss"])
        print(f"step {step}: loss {loss:.4f} "
              f"({time.perf_counter() - t0:.2f}s)")
        if not np.isfinite(loss):
            raise SystemExit(f"step {step}: the loss is not finite")
    print("done")


def mesh_train(cfg, shape: ShapeConfig, mesh, device, *, steps: int,
               seed: int = 0, k: Optional[int] = None,
               log: Callable[[str], None] = print) -> Dict[str, Any]:
    """``steps`` sharded train steps of ``cfg`` (depth already cut) at
    ``shape`` on this rank of ``mesh``: seeded shards of random weights
    and adapters, this rank's rows of a seeded random global batch.
    Every rank calls it; ``log`` prints on rank 0.  Returns the bundle's
    meta and per step: loss, s, tokens/s, each rank's peak bytes (the
    card only) and the collectives' counts (``parallel.comm_stop``)."""
    device = torch.device(device)
    bundle = steps_lib.build_train(
        cfg, shape, k=k, tc=TrainConfig(), device=device, mesh=mesh,
        memory_bytes=steps_lib.device_bytes(device) - MESH_RESERVE)
    meta = bundle.meta
    log(f"{cfg.name} ({cfg.num_layers} layers) x {shape.name} (batch "
        f"{shape.global_batch}, {shape.seq_len} tokens) on mesh "
        f"{meta['mesh']}: n_micro {meta['n_micro']}, groups "
        f"{meta['num_groups']}, remat chunk {meta['remat_chunk']}; a rank's "
        f"estimate: shards + trainable state + gathers "
        f"{meta['rank_fixed_bytes'] / 2 ** 30:.2f} GiB, a microbatch's "
        f"activations {meta['act_bytes'] / 2 ** 30:.2f} GiB")
    params = shd.init_sharded_params(cfg, mesh, seed, device)
    trainable = shd.init_sharded_lora(cfg, mesh, seed + 1,
                                      meta["k"] or 0, device)
    opt = adam.init(trainable)
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    on_card = device.type == "cuda"
    out = {"meta": meta, "steps": []}
    for step in range(steps):
        batch = [steps_lib.shard_batch(t, mesh, meta["n_micro"])
                 for t in synthetic_batch(cfg, shape, gen, device)]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        parallel.comm_start()
        t0 = time.perf_counter()
        trainable, opt, metrics = bundle.fn(params, trainable, opt, *batch)
        loss = float(metrics["loss"])
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        comm = parallel.comm_stop()
        peaks = mesh_lib.rank_peaks(device) if on_card else None
        rec = {"loss": loss, "s": dt,
               "tokens_per_s": shape.global_batch * shape.seq_len / dt,
               "peak_bytes": peaks, "comm": comm}
        out["steps"].append(rec)
        peak = ("not measured (CPU)" if peaks is None else
                "[" + ", ".join(f"{p / 2 ** 30:.2f}" for p in peaks)
                + "] GiB")
        log(f"step {step}: loss {loss:.4f}, {dt:.3f} s/step, "
            f"{rec['tokens_per_s']:.1f} tokens/s, peak per rank {peak}; "
            f"collectives {comm['calls']} calls, "
            f"{comm['bytes'] / 2 ** 30:.3f} GiB, {comm['ms']:.1f} ms")
        if not np.isfinite(loss):
            raise SystemExit(f"step {step}: the loss is not finite")
    return out


def _train_worker(rank: int, world: int, opts: dict) -> None:
    args = argparse.Namespace(**opts)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    log = print if rank == 0 else (lambda *_: None)
    mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                         mesh_shape=args.mesh_shape)
    cfg = get_config(args.arch, args.variant or "full")
    base = INPUT_SHAPES[args.shape]
    shape = ShapeConfig(base.name, args.seq_len or base.seq_len,
                        args.batch or base.global_batch, "train")
    cuts = [f"{what} {a} -> {b}" for what, a, b in (
        ("batch", base.global_batch, shape.global_batch),
        ("sequence", base.seq_len, shape.seq_len)) if a != b]
    layers = args.layers or steps_lib.deepest_fit(
        cfg, shape, mesh, steps_lib.device_bytes(device) - MESH_RESERVE,
        args.k)
    if not layers:
        raise SystemExit(f"{cfg.name}: not one period fits a rank at "
                         f"{shape.seq_len} tokens")
    if layers != cfg.num_layers:
        cuts.append(f"depth {cfg.num_layers} -> {layers} layers"
                    + ("" if args.layers else " (the deepest the estimate "
                       "fits)"))
    cfg = cut_depth(cfg, layers)
    log(f"cut: {', '.join(cuts) or 'none'}")
    mesh_train(cfg, shape, mesh, device, steps=args.steps, seed=args.seed,
               k=args.k, log=log)
    log("done")


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.local:
        run_local(args)
        return
    if not args.federated:
        run_on_mesh(_train_worker, args)
        return
    device = _device(args.device)

    cfg = cut_depth(get_config(args.arch, args.variant or "smoke"),
                    args.layers)
    if cfg.num_codebooks:
        # the reference's --federated builds a (B, S) text corpus for any
        # arch (its DataConfig has no num_codebooks), which an audio model
        # cannot embed: it fails in its attention's reshape
        raise SystemExit(
            f"--federated: {cfg.name} reads (B, S, {cfg.num_codebooks}) "
            "codebook tokens, and this launcher's corpus is (B, S) text, as "
            "the reference launcher's is; run the audio arch's rounds through "
            "federated.simulation.build_experiment with "
            "DataConfig(num_codebooks=...), or its train step with --local")
    fed = FederatedConfig(num_clients=args.clients, rounds=args.rounds,
                          participation=args.participation,
                          round_driver=args.round_driver,
                          checkpoint_every=args.checkpoint_every,
                          seed=args.seed)
    tc = TrainConfig(batch_size=8, local_epochs=1)
    data = DataConfig(vocab_size=min(cfg.vocab_size, 512),
                      n_examples=max(args.clients * 8, 64),
                      seq_len=64, n_clusters=4)
    print(f"{cfg.name} on {device}: {args.clients} clients, "
          f"{args.rounds} rounds, method flame, {fed.round_engine} engine, "
          f"{fed.round_driver} driver")
    exp = build_experiment(cfg, fed=fed, tc=tc, data=data, device=device)
    t0 = time.perf_counter()
    metrics = run_experiment(exp, eval_k=args.k,
                             resume_from=args.resume_from,
                             checkpoint_to=args.checkpoint_to)
    dt = time.perf_counter() - t0
    for res in exp.server.history:
        finite = [l for l in res.client_losses if np.isfinite(l)]
        mean = float(np.mean(finite)) if finite else float("nan")
        print(f"round {res.round_idx}: {len(res.participating)} clients, "
              f"mean loss {mean:.4f}")
    print(f"val_loss {metrics['val_loss']:.4f}, test_loss "
          f"{metrics['test_loss']:.4f}, score {metrics['score']:.2f} "
          f"({dt:.2f} s for {metrics['rounds']} rounds via the "
          f"{fed.round_driver!r} driver and evaluation)")
    if args.checkpoint_to:
        print(f"checkpoint: {args.checkpoint_to}")
    print("done")


if __name__ == "__main__":
    main()
