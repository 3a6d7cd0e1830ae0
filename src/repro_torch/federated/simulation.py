"""End-to-end federated experiment assembly (port of
``repro/federated/simulation.py``).

Builds the base model (or takes a given one), the global LoRA, the
Dirichlet-partitioned synthetic corpus and one budgeted client per shard,
then the :class:`FederatedServer`; :func:`run_experiment` runs every round
(any method, either round engine) and evaluates the global adapter.
Budgets are assigned round-robin β1..β4 (the paper's uniform heterogeneous
setting) unless pinned; clients of one tier share k_i and rank, so a
round's participants form at most four cohorts for the batched engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import FederatedConfig, TrainConfig
from ..core import lora as lora_lib
from ..data.partition import dirichlet_partition
from ..data.synthetic import Corpus, DataConfig, make_corpus, split_corpus
from ..models import model as model_lib
from . import client as client_lib
from .server import (DENSE_BUDGET_RANKS, FLAME_BUDGET_K, MOE_BUDGET_RANKS,
                     FederatedServer)


@dataclass
class Experiment:
    cfg: object
    server: FederatedServer
    val: Corpus
    test: Corpus
    budgets: List[str]


def budget_for_client(i: int, budget: Optional[str]) -> str:
    """Round-robin β1..β4 when ``budget`` is None, else the fixed tier."""
    return budget if budget else f"b{(i % 4) + 1}"


def build_experiment(cfg, *, fed: FederatedConfig, tc: TrainConfig,
                     data: DataConfig, budget: Optional[str] = None,
                     base_params=None, device="cuda") -> Experiment:
    """Assemble an :class:`Experiment` on ``device``.

    ``base_params``: a frozen base to fine-tune (else random weights from
    ``fed.seed``).  The global LoRA is drawn from a generator seeded with
    ``fed.seed + 1`` on ``device``; ``jax.random`` streams cannot be
    reproduced, so a comparison with the reference converts its adapters
    (``repro_torch.convert.lora_from_jax``).  Data, partition and budgets
    follow the reference's numpy streams exactly."""
    device = torch.device(device)
    params = (base_params if base_params is not None
              else model_lib.init_params(
                  cfg, torch.Generator(device=device).manual_seed(fed.seed),
                  device))
    global_lora = lora_lib.init_lora(
        torch.Generator(device=device).manual_seed(fed.seed + 1), cfg,
        params)

    corpus = make_corpus(data)
    train, val, test = split_corpus(corpus)
    shards = dirichlet_partition(train, fed.num_clients, fed.dirichlet_alpha,
                                 seed=fed.seed)

    is_moe = cfg.moe.enabled
    clients, budgets = [], []
    for i in range(fed.num_clients):
        b = budget_for_client(i, budget)
        budgets.append(b)
        if fed.method == "flame":
            # scale the paper's k grid {8,4,2,1} into this model's top_k
            k_i = (max(1, round(cfg.moe.top_k * FLAME_BUDGET_K[b]
                                / FLAME_BUDGET_K["b1"]))
                   if is_moe else 0)
            rank_i = cfg.lora.rank
        else:
            grid = MOE_BUDGET_RANKS if is_moe else DENSE_BUDGET_RANKS
            rank_i = max(1, round(cfg.lora.rank * grid[b] / grid["b1"]))
            k_i = cfg.moe.top_k if is_moe else 0
        rescaler = None
        if fed.method == "flame" and is_moe and fed.rescaler != "none":
            rescaler = lora_lib.init_rescalers(cfg, k_i, fed.rescaler,
                                               device=device)
        clients.append(client_lib.ClientState(
            client_id=i, shard=shards[i], k=k_i or cfg.moe.top_k,
            rank=rank_i, rescaler=rescaler, rescaler_mode=fed.rescaler,
            budget=b))

    server = FederatedServer(cfg, params, global_lora, clients, fed, tc)
    return Experiment(cfg=cfg, server=server, val=val, test=test,
                      budgets=budgets)


def run_experiment(exp: Experiment, *, eval_k: Optional[int] = None,
                   resume_from: Optional[str] = None,
                   checkpoint_to: Optional[str] = None) -> Dict[str, float]:
    """Run all rounds (``FederatedServer.run``, which takes the checkpoint
    arguments), then evaluate the global adapter at ``eval_k`` experts
    (default: the server's top_k)."""
    exp.server.run(resume_from=resume_from, checkpoint_to=checkpoint_to)
    cfg = exp.cfg
    k = eval_k or (cfg.moe.top_k if cfg.moe.enabled else 0)
    trainable = {"lora": exp.server.global_lora}
    val_loss = client_lib.evaluate(cfg, exp.server.params, trainable,
                                   exp.val, k=k or 1)
    test_loss = client_lib.evaluate(cfg, exp.server.params, trainable,
                                    exp.test, k=k or 1)
    return {"val_loss": val_loss, "test_loss": test_loss,
            "score": 100.0 * float(np.exp(-test_loss)),
            "rounds": len(exp.server.history)}
