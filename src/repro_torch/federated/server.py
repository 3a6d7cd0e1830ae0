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

Round drivers (``fed.round_driver``):

* ``"host"`` (the default, the oracle) — ``run`` iterates
  :meth:`run_round`; each cohort's losses and frequencies come back to
  the host as it finishes.
* ``"device"`` (FLAME only) — the reference folds a checkpoint segment's
  rounds into one ``lax.scan`` program; here the segment is a loop over
  its rounds with **no host read inside it**.  Every remaining round's
  participants are drawn up front from the same sampling stream as the
  host loop (:meth:`_prep_device_rounds`), cohorts run against a static
  key set (a cohort short of its capacity in a round runs
  ``client.empty_plan`` slots: exact no-ops of weight 0), the client
  rescalers live in a stacked device bank gathered and scattered by
  client slot, and each round merges its cohorts' FLAME accumulators.
  The plans go to the device when the segment starts; losses, counts and
  token counts are read back when it ends, and the rounds'
  :class:`RoundResult` objects are rebuilt from them.  A checkpoint is
  written at every segment end (``fed.checkpoint_every`` rounds); resume
  replays the sampling stream, so either driver resumes the other's
  checkpoint.

``tracer`` (a :class:`repro_torch.obs.Tracer`) records the reference's
round spans on the federated track: ``round N`` enclosing ``distribute``
→ ``local_train`` (looped) or ``cohort_update`` (batched) per client or
cohort, then ``aggregate``; ``run(trace_to=...)`` writes them as Chrome
trace-event JSON.  The spans read the tracer's clock (``time.time_ns``,
the clock ``torch.profiler`` stamps with) and add no device sync.  The
port adds its layer spans beneath them: per cohort
``agg.flame_acc_update`` and ``server.readback`` (the cohort's losses and
frequencies brought to the host: the round's waits), and the client
step's spans (:mod:`.client`); ``round N`` and its descendants carry
``round``, ``local_train`` its ``client``, ``cohort_update`` its
``clients``.  On the device driver each ``round N`` span is the
segment's wall clock amortised evenly over its rounds (``args``:
``driver: "device"``, ``amortized: True``), as the reference's; the
segment's work is a ``segment`` span on track (3, 1).  With
``tracer=None`` the tracer is resolved at each round (or segment) by
:func:`repro_torch.obs.trace.active`: while a ``torch.profiler`` session
records, the process's session tracer, under which ``distribute``,
``agg.*`` and ``aggregate`` also take their device time from CUDA event
markers (``dev_ms``, read when the session is read) and the host syncs
are counted; else none.
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
from ..obs import trace as obs_trace
from ..obs.expert_load import ActivationDriftTracker
from ..obs.metrics import MetricsRegistry
from ..obs.trace import NULL_TRACER, PID_FEDERATED, Tracer
from ..tree import leaves, tree_map
from . import client as client_lib
from .cohort import CohortKey, build_cohorts, group_by_key

PyTree = Any

# the paper's budget grids (Appendix A1)
FLAME_BUDGET_K = {"b1": 8, "b2": 4, "b3": 2, "b4": 1}
MOE_BUDGET_RANKS = {"b1": 20, "b2": 12, "b3": 8, "b4": 6}
DENSE_BUDGET_RANKS = {"b1": 40, "b2": 24, "b3": 16, "b4": 12}


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
        self._tracer_arg = tracer
        self._tracer = tracer if tracer is not None else NULL_TRACER

    def _resolve_tracer(self):
        """The round's tracer (:func:`repro_torch.obs.trace.active`), its
        tracks named."""
        tr = self._tracer = obs_trace.active(self._tracer_arg)
        if tr.enabled:
            tr.process_name(PID_FEDERATED, "federated")
            tr.thread_name(PID_FEDERATED, 0, "rounds")
        return tr

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
        tr = self._resolve_tracer()
        with obs_trace.use(tr), tr.span(
                f"round {round_idx}", pid=PID_FEDERATED, tid=0,
                cat="federated", round=round_idx) as sp:
            if self.fed.round_engine == "looped":
                res = self._run_round_looped(round_idx)
            else:
                res = self._run_round_batched(round_idx)
            res.activation_drift = self._round_drift(res)
            sp.note(participants=len(res.participating),
                    method=self.fed.method)
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
                         args={"client": i}, device=True, client=i):
                dist = self._distribute(c)
            with tr.span("local_train", pid=PID_FEDERATED, cat="federated",
                         args={"client": i, "k": c.k}, client=i):
                trained, f, _, info = client_lib.local_train(
                    self.cfg, self.params, dist, c, self.tc,
                    round_seed=self.fed.seed * 1000 + round_idx)
            loras.append(trained)
            freqs.append(f)
            sizes.append(float(c.dataset_size))
            losses.append(info["mean_loss"])
        with tr.span("aggregate", pid=PID_FEDERATED, cat="federated",
                     args={"method": self.fed.method}, device=True):
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
            ids = [c.client_id for c in members]
            with tr.span("distribute", pid=PID_FEDERATED, cat="federated",
                         args={"cohort": ci, "clients": len(members)},
                         device=True, clients=ids):
                stacked_tr = lora_lib.stack_adapters(
                    [lora_lib.make_trainable(self._distribute(c), c.rescaler)
                     for c in members])
                plan = client_lib.stack_plans(
                    [client_lib.make_batch_plan(c, self.tc, round_seed)
                     for c in members])
            with tr.span("cohort_update", pid=PID_FEDERATED,
                         cat="federated",
                         args={"cohort": ci, "k": co.k,
                               "clients": len(members)}, clients=ids):
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
            with tr.span("server.readback", clients=ids):
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
                with tr.span("agg.flame_acc_update", device=True,
                             clients=ids):
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
                     args={"method": self.fed.method}, device=True):
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

    # ---------------------------------------------------- device round driver
    def _device_validate(self) -> None:
        """Only the FLAME path (streaming accumulator, the same full-rank
        adapter for everyone) runs on the device driver."""
        if self.fed.method != "flame":
            raise ValueError(
                "round_driver='device' supports method='flame' only "
                f"(got {self.fed.method!r}) — the compression baselines "
                "need host-side rank surgery between rounds")
        if self.fed.round_engine != "batched":
            raise ValueError(
                "round_driver='device' requires round_engine='batched' "
                f"(got {self.fed.round_engine!r})")
        if self.fed.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        has = [c.rescaler is not None for c in self.clients]
        if any(has) and not all(has):
            raise ValueError(
                "round_driver='device' needs homogeneous rescaler presence "
                "across the registry (the rescaler bank is one stacked "
                "tree) — got a mix of with/without")

    def _prep_device_rounds(self, start: int):
        """Host-side prep for rounds ``[start, fed.rounds)``, as the
        reference's.

        Draws every remaining round's participants from the same stream
        the host loop consumes (:meth:`_sample_participants`), groups each
        round's participants by cohort key, and fixes the static key set:
        the union of keys over the rounds in first-appearance order, each
        with capacity = the most members it has in any round.  A round
        where a key runs short (or not at all) fills the gap with
        ``client.empty_plan`` slots: every step invalid and dataset size
        0, so they change nothing.

        Returns ``(keys, caps, xs, meta)``: ``xs[f"k{i}"]`` holds numpy
        arrays with a leading round axis (``tokens``/``labels``/``mask``/
        ``valid`` slot-stacked plans, ``slot`` client ids with
        ``n_clients`` marking padding, ``size`` fp32 dataset sizes);
        ``meta[r]`` maps a round's outputs back to participant order."""
        rounds = list(range(start, self.fed.rounds))
        per_round = []
        for r in rounds:
            parts = self._sample_participants()
            order, members = group_by_key([self.clients[i] for i in parts],
                                          self.tc, rank_of=self._dist_rank)
            per_round.append((r, parts, order, members))

        keys: List[CohortKey] = []
        for _, _, order, _ in per_round:
            for key in order:
                if key not in keys:
                    keys.append(key)
        caps = [max(len(members.get(key, []))
                    for _, _, _, members in per_round) for key in keys]

        # every (round, key) plan list, and each key's most steps
        plans: Dict[int, List[List[client_lib.BatchPlan]]] = {
            i: [] for i in range(len(keys))}
        steps = [1] * len(keys)
        for r, parts, _, members in per_round:
            seed = self.fed.seed * 1000 + r
            for i, key in enumerate(keys):
                ps = [client_lib.make_batch_plan(
                          self.clients[parts[pos]], self.tc, seed)
                      for pos in members.get(key, [])]
                steps[i] = max([steps[i]] + [p.n_steps for p in ps])
                plans[i].append(ps)

        meta = [{"round": r, "parts": parts,
                 "members": {i: members.get(keys[i], [])
                             for i in range(len(keys))}}
                for r, parts, _, members in per_round]
        n_clients = len(self.clients)
        xs: Dict[str, Dict[str, np.ndarray]] = {}
        for i, key in enumerate(keys):
            template = client_lib.pad_plan(
                next(p for ps in plans[i] for p in ps), steps[i])
            cols: Dict[str, list] = {n: [] for n in (
                "tokens", "labels", "mask", "valid", "slot", "size")}
            for ri, (r, parts, _, members) in enumerate(per_round):
                padded = [client_lib.pad_plan(p, steps[i])
                          for p in plans[i][ri]]
                mem = members.get(key, [])
                pad_n = caps[i] - len(padded)
                padded += [client_lib.empty_plan(template)] * pad_n
                stacked = client_lib.stack_plans(padded)
                for name in ("tokens", "labels", "mask", "valid"):
                    cols[name].append(getattr(stacked, name))
                cols["slot"].append(np.asarray(
                    [parts[pos] for pos in mem] + [n_clients] * pad_n,
                    np.int32))
                cols["size"].append(np.asarray(
                    [float(self.clients[parts[pos]].dataset_size)
                     for pos in mem] + [0.0] * pad_n, np.float32))
            xs[f"k{i}"] = {name: np.stack(v) for name, v in cols.items()}
        return keys, caps, xs, meta

    def _upload_segment(self, xs, rows: slice) -> List[List[Dict]]:
        """A segment's inputs on the device before it starts, per round and
        cohort: the plans (``valid`` stays numpy: it is host knowledge),
        dataset sizes, the rescaler bank's gather rows (padding slots read
        the last row, their update is dropped) and the real slots'
        scatter rows."""
        device, n_clients = self.device, len(self.clients)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        out = []
        for ri in range(rows.start, rows.stop):
            per_key = []
            for i in range(len(xs)):
                xk = {name: arr[ri] for name, arr in xs[f"k{i}"].items()}
                slot = xk["slot"].astype(np.int64)
                real = slot[slot < n_clients]
                per_key.append({
                    "tokens": dev(xk["tokens"]),
                    "labels": dev(xk["labels"]),
                    "mask": dev(xk["mask"]),
                    "valid": xk["valid"],
                    "size": dev(xk["size"]),
                    "gather": dev(np.minimum(slot, n_clients - 1)),
                    "scatter": dev(real),
                    "n_real": len(real)})
            out.append(per_key)
        return out

    def _device_round(self, keys: List[CohortKey], caps: List[int],
                      gl: PyTree, bank: PyTree, xr: List[Dict],
                      meta_row: Dict):
        """One round of the segment on the device: every static cohort
        trains from the broadcast global adapter and its bank rows, the
        real slots' rescalers go back into ``bank`` (in place), each
        cohort streams into a fresh accumulator, and the accumulators
        left-fold-merge into the next global adapter.  The fold takes the
        round's cohorts in the host loop's order (first appearance among
        the participants), then the absent ones (all padding: zero sums):
        merging into a zero-initialised accumulator is exact, so the sums
        are the host loop's bit for bit.  Returns ``(global_lora,
        outs)``, ``outs[i]`` cohort ``i``'s device sums and frequencies."""
        accs, outs = [], []
        for i, key in enumerate(keys):
            k, _rank, _bs, has_resc, mode = key
            xk = xr[i]
            stacked_tr = {"lora": tree_map(
                lambda l: l.expand((caps[i],) + l.shape), gl)}
            if has_resc:
                stacked_tr["rescaler"] = tree_map(
                    lambda l: l[xk["gather"]], bank)
            out_tr, counts, tok, loss_sum, n_valid = \
                client_lib.cohort_update(
                    self.cfg, self.params, stacked_tr, xk["tokens"],
                    xk["labels"], xk["mask"], xk["valid"], k=k, tc=self.tc,
                    rescaler_trainable=(mode == "learnable"),
                    backend=self.fed.cohort_backend)
            if has_resc and xk["n_real"]:
                n = xk["n_real"]
                tree_map(lambda bl, nl: bl.index_copy_(0, xk["scatter"],
                                                       nl[:n]),
                         bank, out_tr["rescaler"])
            denom = torch.clamp(tok, min=1.0)[:, None, None]
            freqs = {pos: c / denom for pos, c in counts.items()}
            with obs_trace.current().span("agg.flame_acc_update",
                                          device=True):
                accs.append(agg.flame_acc_update(
                    agg.flame_acc_init(gl), out_tr["lora"], freqs,
                    xk["size"], self.fed.temperature))
            outs.append({"loss_sum": loss_sum, "n_valid": n_valid,
                         "freqs": freqs})
            del out_tr
        members = meta_row["members"]
        order = sorted((i for i in members if members[i]),
                       key=lambda i: members[i][0])
        order += [i for i in range(len(keys)) if not members[i]]
        acc = accs[order[0]]
        for i in order[1:]:
            acc = agg.flame_acc_merge(acc, accs[i])
        return agg.flame_acc_finalize(acc, prev_lora=gl), outs

    def _device_round_result(self, outs, meta_row) -> RoundResult:
        """One round's :class:`RoundResult` from its host copies, mapped
        back to participant order (losses as the host driver's:
        ``loss_sum / n_valid`` in fp32, nan for a client with no step)."""
        parts = meta_row["parts"]
        losses: Dict[int, float] = {}
        freqs: Dict[int, Dict[str, np.ndarray]] = {}
        for i, mem in meta_row["members"].items():
            yk = outs[i]
            n_valid = yk["n_valid"]
            loss_means = np.where(
                n_valid > 0, yk["loss_sum"] / np.maximum(n_valid, 1.0),
                np.nan)
            for s, pos in enumerate(mem):
                losses[pos] = float(loss_means[s])
                freqs[pos] = {p: f[s] for p, f in yk["freqs"].items()}
        return RoundResult(meta_row["round"],
                           [losses[i] for i in range(len(parts))],
                           [freqs[i] for i in range(len(parts))], parts)

    def _run_rounds_device(self, start: int,
                           checkpoint_to: Optional[str]) -> List[RoundResult]:
        """Rounds ``[start, fed.rounds)`` in segments of
        ``checkpoint_every`` rounds when checkpointing, else one segment;
        the host reads nothing between a segment's first and last round."""
        self._device_validate()
        if start >= self.fed.rounds:
            return []
        keys, caps, xs, meta = self._prep_device_rounds(start)
        bank = (lora_lib.stack_adapters([c.rescaler for c in self.clients])
                if self.clients and self.clients[0].rescaler is not None
                else {})
        gl = self.global_lora
        n_rounds = self.fed.rounds - start
        seg_len = (min(self.fed.checkpoint_every, n_rounds)
                   if checkpoint_to else n_rounds)
        out: List[RoundResult] = []
        for a in range(start, self.fed.rounds, seg_len):
            b = min(a + seg_len, self.fed.rounds)
            n_seg = b - a
            tr = self._resolve_tracer()
            if tr.enabled:
                tr.thread_name(PID_FEDERATED, 1, "device-driver segments")
            xseg = self._upload_segment(xs, slice(a - start, b - start))
            t0 = tr.now()
            seg_outs = []
            with obs_trace.use(tr), tr.span("segment", pid=PID_FEDERATED,
                                            tid=1, round=a):
                for j, xr in enumerate(xseg):
                    gl, outs = self._device_round(keys, caps, gl, bank, xr,
                                                  meta[a - start + j])
                    seg_outs.append(outs)
                # the segment's host reads, after its last round: every
                # round's sums
                with tr.span("server.readback"):
                    host = [[tree_map(lambda t: t.cpu().numpy(), o)
                             for o in outs] for outs in seg_outs]
            t1 = tr.now()
            del xseg, seg_outs

            self.global_lora = gl
            # bank rows back into client-local state (clones: the bank is
            # written in place by the next segment)
            if bank:
                for i, c in enumerate(self.clients):
                    c.rescaler = tree_map(lambda l, i=i: l[i].clone(), bank)
            for j in range(n_seg):
                res = self._device_round_result(host[j], meta[a - start + j])
                res.activation_drift = self._round_drift(res)
                self.history.append(res)
                out.append(res)
                if tr.enabled:
                    # the segment's wall clock amortised evenly over its
                    # rounds: no per-round host sync to time exactly
                    rt0 = t0 + (t1 - t0) * j / n_seg
                    rt1 = t0 + (t1 - t0) * (j + 1) / n_seg
                    tr.complete(f"round {res.round_idx}", rt0, rt1,
                                pid=PID_FEDERATED, cat="federated",
                                args={"participants": len(res.participating),
                                      "method": self.fed.method,
                                      "driver": "device", "amortized": True})
                self._emit_round_metrics(res)
            if checkpoint_to:
                self.save_checkpoint(checkpoint_to)
        return out

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
        """Run the remaining rounds on ``fed.round_driver``.

        ``resume_from``: a checkpoint written by :meth:`save_checkpoint`
        (or a previous ``run(checkpoint_to=...)``): loads the global LoRA,
        rescalers and round index, and continues from there.
        ``checkpoint_to``: write a checkpoint after every round (host
        driver) or every ``fed.checkpoint_every`` rounds (device driver:
        the segment ends are its host sync points).
        ``metrics_to``/``trace_to``: a registry snapshot (JSON) and a Chrome
        trace-event file of the round spans, written when the rounds
        finish; each creates its object when the server has none."""
        if metrics_to and self._metrics is None:
            self._metrics = MetricsRegistry()
        if trace_to and self._tracer_arg is None:
            self._set_tracer(Tracer())
        start = self.restore_checkpoint(resume_from) if resume_from else 0
        if self.fed.round_driver == "device":
            out = self._run_rounds_device(start, checkpoint_to)
        else:
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
