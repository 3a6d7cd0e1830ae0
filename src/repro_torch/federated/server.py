"""Server-side federated orchestration (port of
``repro/federated/server.py``: the four methods, both round engines, the
host driver, checkpoints and round telemetry).

Methods:

* ``flame`` — distribute the full-rank global LoRA; clients train at their
  budgets k_i; aggregate with Eq. 6–7 (activation-aware).
* ``trivial`` — every client trains the globally smallest rank; FedAvg.
* ``hlora`` — distribute rank-truncated adapters per client budget;
  sparsity-weighted aggregation over rank components.
* ``flexlora`` — clients train truncated adapters; the server averages
  ΔW = s·A·B and SVD-refactors back to the server rank.

Round engines (``fed.round_engine``):

* ``"batched"`` (the default) — participants are grouped into budget
  cohorts (:mod:`.cohort`) and each cohort trains through one
  ``client.cohort_update`` call on stacked inputs.  For FLAME each
  cohort's stacked adapters and activation frequencies stream into a
  running accumulator (``aggregation.flame_acc_*``) as soon as the cohort
  finishes, so the server holds one cohort's trees at a time.
* ``"looped"`` — one ``client.local_train`` per participant, the
  reference oracle the batched engine is tested against.

Every round runs on the host driver (``run`` iterates :meth:`run_round`).
The reference's device driver (``round_driver="device"``, one ``lax.scan``
program per checkpoint segment) is not ported yet and raises
``NotImplementedError`` naming the ROADMAP item.

``tracer`` (a :class:`repro_torch.obs.Tracer`) records the reference's
round spans on the federated track: ``round N`` enclosing ``distribute``
→ ``local_train`` (looped) or ``cohort_update`` (batched) per client or
cohort, then ``aggregate``; ``run(trace_to=...)`` writes them as Chrome
trace-event JSON.  The spans read the host clock and add no device sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import io as ckpt_io
from ..configs.base import FederatedConfig, TrainConfig
from ..core import aggregation as agg
from ..core import lora as lora_lib
from ..obs.expert_load import ActivationDriftTracker
from ..obs.metrics import MetricsRegistry
from ..obs.trace import NULL_TRACER, PID_FEDERATED, Tracer
from ..tree import leaves, tree_map
from . import client as client_lib
from .cohort import build_cohorts

PyTree = Any

# the paper's budget grids (Appendix A1)
FLAME_BUDGET_K = {"b1": 8, "b2": 4, "b3": 2, "b4": 1}
MOE_BUDGET_RANKS = {"b1": 20, "b2": 12, "b3": 8, "b4": 6}
DENSE_BUDGET_RANKS = {"b1": 40, "b2": 24, "b3": 16, "b4": 12}

_LATER = ("is not ported yet: it comes with the ROADMAP's \"Device round "
          "driver\" item (Modules to port)")


@dataclass
class RoundResult:
    round_idx: int
    client_losses: List[float]
    client_freqs: List[Dict[str, np.ndarray]]
    participating: List[int]
    # per-MoE-position activation telemetry for the round:
    # {pos: {"entropy": [per period], "entropy_mean": f, "l1_drift": f|None}}
    # — l1_drift is None on the first observed round (nothing to diff)
    activation_drift: Optional[Dict[str, Dict[str, Any]]] = None


class FederatedServer:
    """Holds the global LoRA state and runs communication rounds.

    ``tracer``/``metrics`` (optional): per-round spans (see the module
    docstring) and per-round counters and gauges (round count, mean
    client loss, participants, per-position activation entropy and L1
    drift).  The drift itself is always computed and stored on
    :class:`RoundResult`."""

    def __init__(self, cfg, params: PyTree, global_lora: PyTree,
                 clients: Sequence[client_lib.ClientState],
                 fed: FederatedConfig, tc: TrainConfig,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if fed.round_driver != "host":
            raise NotImplementedError(
                f"FederatedServer round_driver={fed.round_driver!r} {_LATER}"
                "; the port runs round_driver='host'")
        self.cfg = cfg
        self.params = params
        self.global_lora = global_lora
        self.clients = list(clients)
        self.fed = fed
        self.tc = tc
        self.history: List[RoundResult] = []
        self._rng = np.random.default_rng(fed.seed + 999)
        self._round_offset = 0        # rounds completed before a resume
        self._drift = ActivationDriftTracker()
        self._metrics = metrics
        self._set_tracer(tracer)

    def _set_tracer(self, tracer: Optional[Tracer]) -> None:
        self._tracer = tracer if tracer is not None else NULL_TRACER
        if self._tracer.enabled:
            self._tracer.process_name(PID_FEDERATED, "federated")
            self._tracer.thread_name(PID_FEDERATED, 0, "rounds")

    @property
    def device(self) -> torch.device:
        return next(leaves(self.params)).device

    # ----------------------------------------------------------- distribution
    def _dist_rank(self, c: client_lib.ClientState) -> int:
        """Rank of the adapter distributed to client ``c``: the shape the
        cohort builder groups by."""
        m = self.fed.method
        if m == "flame":
            return max(cl.rank for cl in self.clients)   # full rank, always
        if m == "trivial":
            return min(cl.rank for cl in self.clients)
        if m in ("hlora", "flexlora"):
            return c.rank
        raise ValueError(f"unknown method {m!r}")

    def _distribute(self, c: client_lib.ClientState) -> PyTree:
        m = self.fed.method
        if m == "flame":
            return self.global_lora
        if m in ("trivial", "hlora", "flexlora"):
            return lora_lib.truncate_rank(self.global_lora,
                                          self._dist_rank(c))
        raise ValueError(f"unknown method {m!r}")

    # ------------------------------------------------------------ aggregation
    def _aggregate(self, loras, freqs, sizes: List[float],
                   parts: List[int]) -> PyTree:
        """``loras``/``freqs``: per-participant lists."""
        m = self.fed.method
        r_full = max(cl.rank for cl in self.clients)
        if m == "flame":
            # prev_lora: an expert nobody activated this round keeps the
            # previous global adapter instead of collapsing to zero
            return agg.flame_aggregate(loras, freqs, sizes,
                                       self.fed.temperature,
                                       prev_lora=self.global_lora)
        if m == "trivial":
            # the uniformly small global, padded back to server-rank storage
            return lora_lib.pad_rank(agg.fedavg(loras, sizes), r_full)
        if m == "hlora":
            ranks = [self.clients[i].rank for i in parts]
            return agg.hlora_aggregate(loras, ranks, sizes, r_full)
        if m == "flexlora":
            return agg.flexlora_aggregate(loras, sizes, r_full,
                                          self.cfg.lora.scale)
        raise ValueError(f"unknown method {m!r}")

    # ----------------------------------------------------------------- rounds
    def _sample_participants(self) -> List[int]:
        n = len(self.clients)
        n_part = max(1, int(round(self.fed.participation * n)))
        return sorted(self._rng.choice(n, size=n_part, replace=False)
                      .tolist())

    def run_round(self, round_idx: int) -> RoundResult:
        tr = self._tracer
        t0 = tr.now()
        if self.fed.round_engine == "looped":
            res = self._run_round_looped(round_idx)
        else:
            res = self._run_round_batched(round_idx)
        res.activation_drift = self._round_drift(res)
        if tr.enabled:
            tr.complete(f"round {round_idx}", t0, tr.now(),
                        pid=PID_FEDERATED, cat="federated",
                        args={"participants": len(res.participating),
                              "method": self.fed.method})
        self._emit_round_metrics(res)
        return res

    def _emit_round_metrics(self, res: RoundResult) -> None:
        if self._metrics is None:
            return
        self._metrics.counter("fed.rounds").inc()
        finite = [l for l in res.client_losses if np.isfinite(l)]
        if finite:
            self._metrics.gauge("fed.round.mean_loss").set(
                float(np.mean(finite)))
        self._metrics.gauge("fed.participants").set(len(res.participating))
        self._drift.publish(self._metrics, res.activation_drift)

    def _round_drift(self, res: RoundResult) -> Dict[str, Dict[str, Any]]:
        """The unweighted mean of the participants' activation frequencies
        per MoE position (aggregation weighs by dataset size; telemetry
        tracks what the cohort as a whole routed), through the drift
        tracker: entropy per period and L1 drift against the last round."""
        freqs = [f for f in res.client_freqs if f]
        if not freqs:
            return {}
        mean = {pos: np.mean([np.asarray(f[pos], np.float64)
                              for f in freqs], axis=0)
                for pos in freqs[0]}
        return self._drift.update(mean)

    def _run_round_looped(self, round_idx: int) -> RoundResult:
        """One ``local_train`` per participant, then aggregation."""
        parts = self._sample_participants()
        tr = self._tracer
        loras, freqs, sizes, losses = [], [], [], []
        for i in parts:
            c = self.clients[i]
            with tr.span("distribute", pid=PID_FEDERATED, cat="federated",
                         args={"client": i}):
                dist = self._distribute(c)
            with tr.span("local_train", pid=PID_FEDERATED, cat="federated",
                         args={"client": i, "k": c.k}):
                trained, f, _, info = client_lib.local_train(
                    self.cfg, self.params, dist, c, self.tc,
                    round_seed=self.fed.seed * 1000 + round_idx)
            loras.append(trained)
            freqs.append(f)
            sizes.append(float(c.dataset_size))
            losses.append(info["mean_loss"])
        with tr.span("aggregate", pid=PID_FEDERATED, cat="federated",
                     args={"method": self.fed.method}):
            self.global_lora = self._aggregate(loras, freqs, sizes, parts)
        res = RoundResult(round_idx, losses, freqs, parts)
        self.history.append(res)
        return res

    def _run_round_batched(self, round_idx: int) -> RoundResult:
        """One ``cohort_update`` per budget cohort.  FLAME streams each
        cohort's stacked outputs into the running accumulator, so the
        round holds one cohort plus one fp32 adapter tree; the baselines
        collect per-participant trees for their aggregation rules."""
        parts = self._sample_participants()
        round_seed = self.fed.seed * 1000 + round_idx
        part_clients = [self.clients[i] for i in parts]
        sizes = [float(c.dataset_size) for c in part_clients]
        cohorts = build_cohorts(part_clients, self.tc,
                                rank_of=self._dist_rank)
        flame = self.fed.method == "flame"

        # per-participant results, keyed by position in `parts`
        loras_by_pos: Dict[int, PyTree] = {}
        freqs_by_pos: Dict[int, Dict[str, np.ndarray]] = {}
        losses_by_pos: Dict[int, float] = {}
        flame_acc = agg.flame_acc_init(self.global_lora) if flame else None

        tr = self._tracer
        for ci, co in enumerate(cohorts):
            members = [part_clients[i] for i in co.members]
            with tr.span("distribute", pid=PID_FEDERATED, cat="federated",
                         args={"cohort": ci, "clients": len(members)}):
                stacked_tr = lora_lib.stack_adapters(
                    [lora_lib.make_trainable(self._distribute(c), c.rescaler)
                     for c in members])
                plan = client_lib.stack_plans(
                    [client_lib.make_batch_plan(c, self.tc, round_seed)
                     for c in members])
            with tr.span("cohort_update", pid=PID_FEDERATED,
                         cat="federated",
                         args={"cohort": ci, "k": co.k,
                               "clients": len(members)}):
                out_tr, counts, tok, loss_sum, n_valid = \
                    client_lib.cohort_update(
                        self.cfg, self.params, stacked_tr, plan.tokens,
                        plan.labels, plan.mask, plan.valid, k=co.k,
                        tc=self.tc,
                        rescaler_trainable=(co.key[4] == "learnable"),
                        backend=self.fed.cohort_backend)
            del stacked_tr

            # stacked activation frequencies {pos: (C, n_periods, E)}
            denom = torch.clamp(tok, min=1.0)[:, None, None]
            freqs = {pos: c / denom for pos, c in counts.items()}

            if "rescaler" in out_tr:
                for c, r in zip(members, lora_lib.unstack_adapters(
                        out_tr["rescaler"], len(members))):
                    c.rescaler = tree_map(torch.clone, r)   # s_i stays local

            # nan (not 0.0) for a zero-valid-step client, as local_train
            n_valid_np = n_valid.cpu().numpy()
            loss_means = np.where(
                n_valid_np > 0,
                loss_sum.cpu().numpy() / np.maximum(n_valid_np, 1.0),
                np.nan)
            for j, pos in enumerate(co.members):
                losses_by_pos[pos] = float(loss_means[j])
                freqs_by_pos[pos] = {p: f[j].cpu().numpy()
                                     for p, f in freqs.items()}

            if flame:
                flame_acc = agg.flame_acc_update(
                    flame_acc, out_tr["lora"], freqs,
                    [sizes[pos] for pos in co.members],
                    self.fed.temperature)
            else:
                for pos, tree in zip(co.members, lora_lib.unstack_adapters(
                        out_tr["lora"], len(members))):
                    loras_by_pos[pos] = tree
            del out_tr

        n = len(parts)
        with tr.span("aggregate", pid=PID_FEDERATED, cat="federated",
                     args={"method": self.fed.method}):
            if flame:
                self.global_lora = agg.flame_acc_finalize(
                    flame_acc, prev_lora=self.global_lora)
            else:
                self.global_lora = self._aggregate(
                    [loras_by_pos[i] for i in range(n)],
                    [freqs_by_pos[i] for i in range(n)], sizes, parts)
        res = RoundResult(round_idx, [losses_by_pos[i] for i in range(n)],
                          [freqs_by_pos[i] for i in range(n)], parts)
        self.history.append(res)
        return res

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, path: str) -> None:
        """Persist the round-resumable state: the global LoRA, every
        client's local rescaler s_i, and the next round index."""
        ckpt_io.save(path, {"global_lora": self.global_lora,
                            "rescalers": [c.rescaler for c in self.clients]},
                     meta={"round_idx": self._round_offset + len(self.history),
                           "method": self.fed.method,
                           "num_clients": len(self.clients)})

    def restore_checkpoint(self, path: str) -> int:
        """Load a checkpoint onto the params' device; returns the round to
        resume from.  The participant-sampling RNG is replayed past the
        completed rounds, so a resumed run samples the cohorts a straight
        run would."""
        tree, meta = ckpt_io.load(path)
        if (meta is None or "num_clients" not in meta
                or not isinstance(tree, dict) or "global_lora" not in tree):
            raise ValueError(
                f"{path} is not a FederatedServer checkpoint (legacy or "
                "foreign format) — re-create it with save_checkpoint / "
                "run(checkpoint_to=...)")
        if meta["num_clients"] != len(self.clients):
            raise ValueError(f"{path}: {meta['num_clients']} clients, the "
                             f"server has {len(self.clients)}")
        if meta["method"] != self.fed.method:
            raise ValueError(f"{path}: method {meta['method']!r}, the "
                             f"server runs {self.fed.method!r}")
        device = self.device
        self.global_lora = ckpt_io.to_device(tree["global_lora"], device)
        for c, r in zip(self.clients, tree["rescalers"]):
            c.rescaler = ckpt_io.to_device(r, device)
        start = int(meta["round_idx"])
        self._round_offset = start
        for _ in range(start):
            self._sample_participants()
        return start

    def run(self, resume_from: Optional[str] = None,
            checkpoint_to: Optional[str] = None,
            metrics_to: Optional[str] = None,
            trace_to: Optional[str] = None) -> List[RoundResult]:
        """Run the remaining rounds on the host driver.

        ``resume_from``: a checkpoint written by :meth:`save_checkpoint`
        (or a previous ``run(checkpoint_to=...)``): loads the global LoRA,
        rescalers and round index, and continues from there.
        ``checkpoint_to``: write a checkpoint after every round.
        ``metrics_to``/``trace_to``: a registry snapshot (JSON) and a Chrome
        trace-event file of the round spans, written when the rounds
        finish; each creates its object when the server has none."""
        if metrics_to and self._metrics is None:
            self._metrics = MetricsRegistry()
        if trace_to and not self._tracer.enabled:
            self._set_tracer(Tracer())
        start = self.restore_checkpoint(resume_from) if resume_from else 0
        out = []
        for r in range(start, self.fed.rounds):
            out.append(self.run_round(r))
            if checkpoint_to:
                self.save_checkpoint(checkpoint_to)
        if metrics_to:
            self._metrics.dump(metrics_to)
        if trace_to:
            self._tracer.dump(trace_to)
        return out
