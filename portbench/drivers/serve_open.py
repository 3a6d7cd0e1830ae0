"""``serve_open``: open-loop requests through the program's engine
(``repro_torch.serving.engine.ServingEngine.run``), at a rate fixed in the
cell.

Set-up builds the base weights, the FLAME adapter (non-zero ``b``, served
unmerged) and one rescaler per tier from the seed, builds the engine (one
slot group per tier) and serves a short warm-up trace: every tier at the
shortest and the longest prompt.  The window offers the requests that
arrive over ``[0, seconds)`` and drains them.

Every time is the benchmark's own ``perf_counter``: the window runs from
just before ``engine.run`` to its return, and a request is due at the
window's start plus its arrival.  ``Tap`` stamps each call of the
program's public model entries (``repro_torch.models.model.prefill`` and
``decode_step``), the calls through which every token comes: a request's
first token is on the host when the engine makes its next model call (or
returns), since the engine reads each step's logits back before it goes
on.  Which requests a prefill served is read from the token rows it took,
once the window has closed.

The check samples requests from the seed before the window, the longest
among them (``check_tokens`` served tokens at least), keeps the logits
that the model entries returned at each of their positions and the
experts the program's routers chose there at every layer, runs the plain
reference once over each prompt and its served tokens at the request's
``k`` with the adapter and its tier's rescaler, following those experts,
and compares (``check``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import core, flops, traffic, weights, window as win
from ..reference.moe_lm import Ref, set_exact_fp32

NUMBERS = ("token_excess", "logit_err_p90", "route_gap")


class Tap:
    """A record of the program's model calls in the window that reads
    nothing back from the device until it has closed.

    Each call of ``prefill`` or ``decode_step`` is stamped when it starts,
    and a prefill keeps the engine's own token tensor (no copy).  A prefill
    whose prompt length and ``k`` are a sampled request's also keeps its
    last-position logits, the routers' outputs at each layer (the routers'
    own tensors) and the slots the engine then writes its rows to
    (``pool.write``); each decode step keeps, for those slots until their
    requests are due to finish, the slot's logits row (one device copy a
    slot) and the routers' outputs."""

    def __init__(self, want: Dict, pool_cls):
        self.calls: List[Dict] = []
        self.want = want                 # (prompt len, k) -> decode steps
        self.pool_cls = pool_cls
        self._cur: Optional[Dict] = None  # the call whose routes to keep
        self._pending: Optional[Dict] = None
        self._live: Dict[int, int] = {}  # slot -> decode steps to keep

    def patches(self):
        from repro_torch.kernels import backend as kb
        from repro_torch.models import model as model_mod

        def prefill(fn):
            def w(cfg, params, tokens, *a, **kw):
                rec = {"kind": "prefill", "t": time.perf_counter(),
                       "tokens": tokens if tokens.is_cuda
                       else tokens.clone()}
                self.calls.append(rec)
                steps = self.want.get((int(tokens.shape[1]), kw.get("k")))
                if steps is not None:
                    rec.update(routes=[], steps=steps)
                    self._cur = rec
                try:
                    out = fn(cfg, params, tokens, *a, **kw)
                finally:
                    self._cur = None
                if steps is not None:
                    rec["logits"] = out[0][:, 0].clone()
                    self._pending = rec
                return out
            return w

        def write(fn):
            def w(pool, slots, *a, **kw):
                if self._pending is not None:
                    rec, self._pending = self._pending, None
                    rec["slots"] = [int(s) for s in slots]
                    for s in rec["slots"]:
                        self._live[s] = rec["steps"]
                return fn(pool, slots, *a, **kw)
            return w

        def decode(fn):
            def w(cfg, params, cache, tokens, *a, **kw):
                rec = {"kind": "decode", "t": time.perf_counter()}
                self.calls.append(rec)
                live = [s for s, n in self._live.items() if n > 0]
                if live:
                    rec.update(routes=[], live=live)
                    self._cur = rec
                try:
                    out = fn(cfg, params, cache, tokens, *a, **kw)
                finally:
                    self._cur = None
                if live:
                    rec["logits"] = {s: out[0][s, 0].clone() for s in live}
                    for s in live:
                        self._live[s] -= 1
                return out
            return w

        def route(fn):
            def w(*a, **kw):
                out = fn(*a, **kw)
                if self._cur is not None:
                    self._cur["routes"].append(out[1])
                return out
            return w

        return [(model_mod, "prefill", prefill),
                (model_mod, "decode_step", decode),
                (self.pool_cls, "write", write),
                (kb, "router", route), (kb, "adaptive_router", route)]

    def served(self, prompts: Dict[bytes, int], t_end: float) -> Dict:
        """After the window: for each request a prefill served, its call's
        index, row, start and the next call's start (its first token)."""
        out = {}
        for i, rec in enumerate(self.calls):
            if rec["kind"] != "prefill":
                continue
            t_next = (self.calls[i + 1]["t"] if i + 1 < len(self.calls)
                      else t_end)
            rows = rec["tokens"].cpu().numpy().astype(np.int64)
            for j, row in enumerate(rows):
                rid = prompts.get(row.tobytes())
                if rid is not None and rid not in out:
                    out[rid] = {"call": i, "row": j, "admitted": rec["t"],
                                "first": t_next}
        return out


class Driver:
    def __init__(self, cell: core.Cell, device):
        self.cell = cell
        self.m = cell.model
        self.mix = cell.traffic
        self.device = device

    def tier_k(self) -> List[int]:
        return [traffic.budget_k(self.m["top_k"], self.mix["budget_k"], t)
                for t in self.mix["tiers"]]

    def setup(self, seed: int) -> None:
        from repro_torch.serving.engine import ServingEngine
        m, mix, dev = self.m, self.mix, self.device
        self.seed = seed
        self.cfg = core.port_config(m)
        self.params = weights.make_params(m, seed, dev,
                                          self.cell.config.get("init"))
        self.lora = weights.make_adapter(m, seed, dev, mix["adapter_b_rel"])
        ks = self.tier_k()
        self.rescalers = weights.make_rescalers(m, seed, ks, dev)
        per = mix["slots"] // len(ks)
        slot_k = [k for k in ks for _ in range(per)]
        self.engine = ServingEngine(
            self.cfg, self.params, lora=self.lora,
            rescaler_by_k=self.rescalers, num_slots=len(slot_k),
            slot_len=mix["slot_len"], slot_k=slot_k,
            kv_layout=mix["kv_layout"], block_size=mix["block_size"],
            dispatch=mix["dispatch"], seed=seed)
        rng = traffic.rng_for(seed, 3)
        warm = []
        for i, (k, L) in enumerate((k, L) for k in sorted(set(ks)) for L in (
                mix["prompt_len_min"], mix["prompt_len_max"])):
            warm.append(self._request(i, rng.integers(
                0, mix["data_vocab"], L).astype(np.int32), 4, k, 0.0))
        self.engine.run(warm)

    @staticmethod
    def _request(rid, prompt, max_new, k, arrival):
        from repro_torch.serving.scheduler import Request
        return Request(rid=rid, prompt=prompt, max_new_tokens=max_new, k=k,
                       arrival=arrival)

    def spans(self):
        from repro_torch.models import model as model_mod
        from repro_torch.serving.engine import ServingEngine
        return {"engine.run": (ServingEngine, "run"),
                "model.prefill": (model_mod, "prefill"),
                "model.decode_step": (model_mod, "decode_step")}

    def window(self, seconds: float) -> Dict:
        from .. import trace as tr
        trace = traffic.serve_trace(self.mix, self.seed, seconds,
                                    self.tier_k())
        self.trace = {r["rid"]: r for r in trace}
        self.sampled = self.sample(trace)
        want: Dict = {}
        for rid in self.sampled:
            r = self.trace[rid]
            key = (len(r["prompt"]), r["k"])
            want[key] = max(want.get(key, 0), r["max_new"] - 1)
        self.tap = Tap(want, type(self.engine.pool))
        requests = [self._request(r["rid"], r["prompt"], r["max_new"],
                                  r["k"], r["arrival"]) for r in trace]
        with tr.patched(self.tap.patches()):
            t0 = time.perf_counter()
            report = self.engine.run(requests)
            t_end = time.perf_counter()
        self.done = {c.rid: c for c in report.completions}
        self.first = self.tap.served(
            {r["prompt"].astype(np.int64).tobytes(): r["rid"]
             for r in trace}, t_end)
        untimed = sorted(set(self.done) - set(self.first))
        if untimed:
            raise RuntimeError(
                f"requests {untimed[:8]} finished, but no call of "
                "repro_torch.models.model.prefill took their prompts: the "
                "benchmark cannot time their first tokens")
        calls = self.tap.calls
        decode_s = [(calls[i + 1]["t"] if i + 1 < len(calls) else t_end)
                    - c["t"] for i, c in enumerate(calls)
                    if c["kind"] == "decode"]
        missing = len(trace) - len(self.done)
        truncated = sum(bool(c.truncated) for c in self.done.values())
        due = {r["rid"]: t0 + r["arrival"] for r in trace}
        ttft = [f["first"] - due[rid] for rid, f in self.first.items()] \
            + [float("inf")] * missing
        model_flops = sum(flops.serve_request(
            self.m, c.prompt_len, c.n_generated, c.k)
            for c in self.done.values())
        return {
            "attempted": len(trace), "failed": missing + truncated,
            "window_s": t_end - t0, "model_flops": model_flops,
            "generated": sum(c.n_generated for c in self.done.values()),
            "prefill_s": [f["first"] - f["admitted"]
                          for f in self.first.values()],
            "queue_s": [f["admitted"] - due[rid]
                        for rid, f in sorted(self.first.items())],
            "ttft_s": [f["first"] - due[rid]
                       for rid, f in sorted(self.first.items())],
            "decode_step_s": decode_s,
            "e2e": {"ttft_p95_ms": win.percentile(ttft, 95) * 1e3}}

    def program_rows(self, rid: int):
        """The logits the model entries returned at the request's served
        positions (n, V) and the experts chosen over its prompt and served
        tokens but the last (one (L + n - 1, E) bool tensor a layer), or
        None where the tap did not keep them."""
        n, f = len(self.done[rid].tokens), self.first.get(rid)
        L, layers = len(self.trace[rid]["prompt"]), self.m["num_layers"]
        if f is None:
            return None
        calls = self.tap.calls
        pre, j = calls[f["call"]], f["row"]
        if "slots" not in pre or len(pre["routes"]) != layers:
            return None
        slot = pre["slots"][j]
        steps = [c for c in calls[f["call"] + 1:]
                 if c["kind"] == "decode"][:n - 1]
        if len(steps) != n - 1 or any(
                slot not in c.get("logits", {}) or len(c["routes"]) != layers
                for c in steps):
            return None
        logits = torch.stack([pre["logits"][j]]
                             + [c["logits"][slot] for c in steps]).float()
        routes = [torch.cat([pre["routes"][i][j * L:(j + 1) * L]]
                            + [c["routes"][i][slot][None] for c in steps])
                  > 0 for i in range(layers)]
        return logits, routes

    def free_program(self) -> None:
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def sample(self, trace: List[Dict]) -> List[int]:
        """Requests to check, fixed before the window from the trace: the
        longest, then others drawn from the seed until ``check_tokens``
        tokens are to be served."""
        if not trace:
            return []
        longest = max(trace, key=lambda r: (r["max_new"], -r["rid"]))
        rng = traffic.rng_for(self.seed, 4)
        out, n = [longest["rid"]], longest["max_new"]
        for i in rng.permutation(len(trace)).tolist():
            if n >= self.mix["check_tokens"]:
                break
            if trace[i]["rid"] != longest["rid"]:
                out.append(trace[i]["rid"])
                n += trace[i]["max_new"]
        return out

    def ref_logits(self, ref: Ref, rid: int, routes=None) -> torch.Tensor:
        """Reference logits at each served token's position (n, V),
        following ``routes`` where given."""
        c = self.done[rid]
        prompt = self.trace[rid]["prompt"]
        seq = np.concatenate([prompt, c.tokens[:-1]]).astype(np.int64)
        tok = torch.as_tensor(seq, device=self.device)[None]
        with torch.no_grad():
            h, _ = ref.hidden(tok, lora=self.lora,
                              rescaler=self.rescalers[c.k]["pos0"], k=c.k,
                              capacity=False, routes=routes)
            return ref.logits(h[0, len(prompt) - 1:])

    def check(self, control: bool = False) -> Dict[str, float]:
        """The sampled requests' served tokens and logits against the
        reference's at the same positions, the reference following the
        program's experts.  ``logit_err_p90``: the 90th percentile over
        served tokens of ``‖l - l_ref‖ / ‖l_ref‖``.  ``route_gap``: how far
        the program's lowest chosen expert lies below the reference's k-th
        best logit (in units of the token's logit spread).
        ``token_excess``: the widest amount by which a served token's gap
        below the reference's best logit exceeds twice the program's
        largest logit error at that position; a greedy token of logits
        within ``e`` of the reference's is within ``2 e`` of its best, so
        a sound run reads 0 or less.  With ``control`` the fp8 reference
        (its own experts, logits and first choices) stands in for the
        program."""
        set_exact_fp32()
        ref = Ref(self.m, self.params, "fp32")
        low = Ref(self.m, self.params, "fp8") if control else None
        bad = dict.fromkeys(NUMBERS, float("inf"))
        if any(rid not in self.done for rid in self.sampled):
            return bad
        excess, errs = [], []
        for rid in self.sampled:
            if control:
                lp = self.ref_logits(low, rid)
                routes = low.last_routes
                served = lp.argmax(-1)
            else:
                got = self.program_rows(rid)
                if got is None:
                    return bad
                lp, routes = got
                served = torch.as_tensor(self.done[rid].tokens.astype(
                    np.int64), device=self.device)
            lr = self.ref_logits(ref, rid, routes)
            lp64, lr64 = lp.double(), lr.double()
            gap = lr64.max(-1).values - lr64.gather(1, served[:, None])[:, 0]
            err = (lp64 - lr64).abs().max(-1).values
            excess += (gap - 2 * err).tolist()
            errs += (torch.linalg.vector_norm(lp64 - lr64, dim=-1)
                     / torch.linalg.vector_norm(lr64, dim=-1)).tolist()
            del lr, lp, routes
        return {"token_excess": max(excess),
                "logit_err_p90": float(np.percentile(errs, 90)),
                "route_gap": max(ref.route_gaps, default=0.0)}
