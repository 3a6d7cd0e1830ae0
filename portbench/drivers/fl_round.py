"""``fl_round``: FLAME rounds back to back on the program's server
(``repro_torch.federated.server.FederatedServer.run_round``).

Set-up builds the base weights, the global adapter, the clients' shards,
budgets and rescalers from the seed, builds one server over them and
drives it through round 0 with the window's own call: that round is the
one the check compares, and it warms up every cohort's shapes.  The
window then runs rounds 1, 2, ... until ``seconds`` have passed; its
tokens are every client step's rows times their length (the shards hold
no padding).

The check follows round 0 with the plain reference
(``reference/fl.py``) from the same inputs, taking at each layer of each
client step the experts the program chose (its own state: bf16 rounding
flips a top-k at near-ties, and a flipped expert changes the rest of the
stack), and compares, each against its limit: ``loss`` (the widest
relative gap of a client step's loss), ``grad1`` (the worst leaf's gap
between the norms of a client's first gradient as Adam got it, read back
from its first moment), ``delta`` (the worst leaf's gap between the norms
of the round's change: the aggregated adapter and each client's
rescaler) and ``route_gap`` (the stage that following skips: how far the
program's lowest chosen expert lies below the reference's k-th best
logit, in units of the token's logit spread).  A leaf's gap is taken
against the larger of its own reference norm and the median leaf's;
leaves whose reference gradient is under a thousandth of the median
leaf's are left out.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import core, flops, traffic, weights
from ..reference import fl as ref_fl
from ..reference.moe_lm import Ref, set_exact_fp32

EXCLUDE_BELOW = 1e-3
NUMBERS = ("loss", "grad1", "delta", "route_gap")


def batch_key(tokens) -> str:
    return hashlib.sha1(np.ascontiguousarray(
        np.asarray(tokens, dtype=np.int32)).tobytes()).hexdigest()


class Recorder:
    """Reads, during round 0, each client step's loss, its experts chosen
    at each layer and the first moment of its first Adam step, by wrapping
    the program's public client update, loss, router and optimizer for
    that round only."""

    def __init__(self):
        self.by_batch: Dict[str, Dict] = {}
        self._cur: Optional[Dict] = None

    def patches(self):
        from repro_torch.federated import client as client_mod
        from repro_torch.kernels import backend as kb
        from repro_torch.models import model as model_mod
        from repro_torch.optim import adam as adam_mod

        def local_update(fn):
            def w(cfg, params, trainable, tokens, *a, **kw):
                self._cur = {"losses": [], "grad1": None, "routes": []}
                self.by_batch[batch_key(torch.as_tensor(tokens[0]).cpu())] \
                    = self._cur
                return fn(cfg, params, trainable, tokens, *a, **kw)
            return w

        def router(fn):
            def w(logits, k):
                out = fn(logits, k)
                self._cur["routes"][-1].append(out[1] > 0)
                return out
            return w

        def loss(fn):
            def w(*a, **kw):
                self._cur["routes"].append([])
                out = fn(*a, **kw)
                self._cur["losses"].append(out[0].detach())
                return out
            return w

        def update(fn):
            def w(grads, state, params, **kw):
                new_p, new_s = fn(grads, state, params, **kw)
                if new_s.step == 1:
                    b1 = kw.get("beta1", 0.9)
                    self._cur["grad1"] = {
                        p: torch.linalg.vector_norm(m.float()) / (1 - b1)
                        for p, m in ref_fl.flat(new_s.mu).items()}
                return new_p, new_s
            return w

        return [(client_mod, "local_update", local_update),
                (model_mod, "lm_loss", loss),
                (adam_mod, "update", update), (kb, "router", router)]


class Driver:
    def __init__(self, cell: core.Cell, device):
        self.cell = cell
        self.m = cell.model
        self.mix = cell.traffic
        self.device = device

    # ------------------------------------------------------------- set-up
    def setup(self, seed: int) -> None:
        from repro_torch.configs.base import FederatedConfig, TrainConfig
        from repro_torch.data.synthetic import Corpus
        from repro_torch.federated import client as client_lib
        from repro_torch.federated.server import FederatedServer
        from .. import trace as tr

        m, mix, dev = self.m, self.mix, self.device
        self.seed = seed
        self.cfg = core.port_config(m)
        self.params = weights.make_params(m, seed, dev,
                                          self.cell.config.get("init"))
        self.lora0 = weights.make_adapter(m, seed, dev, mix["adapter_b_rel"])
        self.shards = traffic.fl_corpus(mix, seed)
        tiers = mix["tiers"]
        self.clients0 = []
        clients = []
        for i, shard in enumerate(self.shards):
            tier = tiers[i % len(tiers)]
            k = traffic.budget_k(m["top_k"], mix["budget_k"], tier)
            resc = torch.full((m["num_layers"],), m["top_k"] / k,
                              dtype=torch.float32, device=dev)
            self.clients0.append({"id": i, "k": k, "rescaler": resc,
                                  "shard": shard})
            clients.append(client_lib.ClientState(
                client_id=i, shard=Corpus(**shard), k=k,
                rank=m["lora_rank"], rescaler={"pos0": resc.clone()},
                rescaler_mode=mix["rescaler"], budget=tier))
        self.fed = FederatedConfig(
            num_clients=len(clients), rounds=1 << 30,
            participation=mix["participation"],
            dirichlet_alpha=mix["dirichlet_alpha"],
            temperature=mix["temperature"], method=mix["method"],
            rescaler=mix["rescaler"], seed=seed,
            round_engine=mix["round_engine"],
            round_driver=mix["round_driver"])
        self.tc = TrainConfig(batch_size=mix["batch_size"],
                              local_epochs=mix["local_epochs"],
                              seq_len=mix["seq_len"])
        self.server = FederatedServer(self.cfg, self.params, self.lora0,
                                      clients, self.fed, self.tc)
        self.rec = Recorder()
        with tr.patched(self.rec.patches()):
            res = self.server.run_round(0)
        self.round0 = {
            "losses": res.client_losses,
            "lora": self.server.global_lora,
            "rescalers": [c.rescaler["pos0"] for c in self.server.clients],
            "by_batch": self.rec.by_batch}
        self.next_round = 1
        self.steps_per_round = sum(
            self.tc.local_epochs * (len(s["tokens"]) // self.tc.batch_size)
            for s in self.shards)

    def spans(self):
        from repro_torch.core import aggregation as agg
        from repro_torch.federated import client as client_mod
        from repro_torch.federated import server as server_mod
        from repro_torch.models import model as model_mod
        from repro_torch.optim import adam as adam_mod
        return {"server.run_round": (server_mod.FederatedServer, "run_round"),
                "client.cohort_update": (client_mod, "cohort_update"),
                "client.local_update": (client_mod, "local_update"),
                "model.lm_loss": (model_mod, "lm_loss"),
                "optim.adam": (adam_mod, "update"),
                "agg.flame_acc_update": (agg, "flame_acc_update"),
                "agg.flame_acc_finalize": (agg, "flame_acc_finalize")}

    # ------------------------------------------------------------- window
    def window(self, seconds: float) -> Dict:
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda *a: None))
        B, S = self.tc.batch_size, self.tc.seq_len
        sync()
        t0 = time.perf_counter()
        rounds, losses = 0, []
        while True:
            res = self.server.run_round(self.next_round)
            self.next_round += 1
            rounds += 1
            losses += res.client_losses
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        wall = time.perf_counter() - t0
        steps = rounds * self.steps_per_round
        step_flops = sum(
            flops.train_step(self.m, B, S, c["k"]) * self.tc.local_epochs
            * (len(c["shard"]["tokens"]) // B) for c in self.clients0)
        failed = int(sum(not np.isfinite(x) for x in losses))
        return {"attempted": steps, "failed": failed, "window_s": wall,
                "rounds": rounds, "tokens": steps * B * S,
                "model_flops": rounds * step_flops,
                "e2e": {"train_tokens_per_s": steps * B * S / wall}}

    def free_program(self) -> None:
        del self.server
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def reference(self, precision: str = "fp32", drop_half: bool = False,
                  routes=None):
        """Round 0 by the plain reference; ``routes``: each client's
        selections to follow (the program's, or a control's)."""
        set_exact_fp32()
        ref = Ref(self.m, self.params, precision)
        tc = {"lr": self.tc.learning_rate, "beta1": self.tc.beta1,
              "beta2": self.tc.beta2, "eps": self.tc.eps,
              "grad_clip": self.tc.grad_clip,
              "batch_size": self.tc.batch_size,
              "local_epochs": self.tc.local_epochs}
        lora, results = ref_fl.run_round(
            ref, self.lora0, self.clients0, tc, self.seed, 0,
            self.mix["temperature"], drop_half=drop_half, routes=routes)
        return {"lora": lora, "results": results,
                "route_gap": max(ref.route_gaps, default=0.0)}

    def program_view(self) -> Dict:
        """Round 0 of the program, per client in the reference's order."""
        out = []
        for c in self.clients0:
            n = len(c["shard"]["tokens"])
            first = ref_fl.batch_plan(n, min(self.tc.batch_size, n),
                                      self.tc.local_epochs, self.seed, 0,
                                      c["id"])[0]
            got = self.round0["by_batch"].get(
                batch_key(c["shard"]["tokens"][first]))
            if got is None:
                out.append(None)
                continue
            out.append({"losses": [float(x) for x in got["losses"]],
                        "grad1": {p: float(v) for p, v in
                                  (got["grad1"] or {}).items()},
                        "rescaler": self.round0["rescalers"][c["id"]],
                        "routes": got["routes"]})
        return {"lora": self.round0["lora"], "results": out}

    def check(self) -> Dict[str, float]:
        prog = self.program_view()
        if any(r is None for r in prog["results"]):
            return dict.fromkeys(NUMBERS, float("inf"))
        want = self.reference(routes=[r["routes"] for r in prog["results"]])
        return numbers(prog, want, self.lora0, self.clients0)

    def stand_in(self, **kw) -> Dict[str, float]:
        """The numbers of the reference put in the program's place (the
        float8 control: ``precision="fp8"``; a planted fault:
        ``drop_half=True``) against the reference following it."""
        prog = self.reference(**kw)
        want = self.reference(routes=[r["routes"] for r in prog["results"]])
        return numbers(prog, want, self.lora0, self.clients0)


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(r, floor, 1e-30)


def _leaf_gaps(got: Dict, want: Dict, keep: Optional[set] = None
               ) -> List[float]:
    """``|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)`` of each leaf the reference
    has (inf for a leaf the program lacks)."""
    paths = [p for p in want if keep is None or p in keep]
    med = float(np.median([want[p] for p in paths])) if paths else 0.0
    return [_gap(got[p], want[p], med) if p in got else float("inf")
            for p in paths]


@torch.no_grad()
def numbers(prog: Dict, ref: Dict, lora0: Dict, clients0: List[Dict]
            ) -> Dict[str, float]:
    """``loss``, ``grad1`` and ``delta`` of a round against the reference's
    (see the module docstring)."""
    loss = grad1 = 0.0
    gmax: Dict = {}
    for pr, rr in zip(prog["results"], ref["results"]):
        for p, v in rr["grad1"].items():
            gmax[p] = max(gmax.get(p, 0.0), v)
    gmed = float(np.median(list(gmax.values())))
    keep = {p for p, v in gmax.items() if v >= EXCLUDE_BELOW * gmed}
    for pr, rr in zip(prog["results"], ref["results"]):
        if pr is None or len(pr["losses"]) != len(rr["losses"]):
            return dict.fromkeys(NUMBERS, float("inf"))
        for lp, lr in zip(pr["losses"], rr["losses"]):
            loss = max(loss, abs(lp - lr) / abs(lr))
        grad1 = max([grad1] + _leaf_gaps(pr["grad1"], rr["grad1"], keep))
    d_got, d_want = {}, {}
    old = ref_fl.flat(lora0)
    got_lora = ref_fl.flat(prog["lora"])
    for path, new_r in ref_fl.flat(ref["lora"]).items():
        if ("lora",) + path not in keep:
            continue
        d_want[path] = float(torch.linalg.vector_norm(
            new_r.float() - old[path].float()))
        d_got[path] = float(torch.linalg.vector_norm(
            got_lora[path].float() - old[path].float()))
    for c, pr, rr in zip(clients0, prog["results"], ref["results"]):
        if ("rescaler", "pos0") not in keep:
            continue
        key = ("rescaler", c["id"])
        d_want[key] = float(torch.linalg.vector_norm(
            rr["rescaler"] - c["rescaler"]))
        d_got[key] = float(torch.linalg.vector_norm(
            pr["rescaler"] - c["rescaler"]))
    d_gaps = _leaf_gaps(d_got, d_want)
    return {"loss": loss, "grad1": grad1, "delta": max(d_gaps, default=0.0),
            "route_gap": ref["route_gap"]}
