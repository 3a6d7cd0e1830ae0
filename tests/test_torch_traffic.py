"""The port's production traffic layer and its observability against the
JAX package, at float32 on the CPU: the prefix-cached block pool with
copy-on-write and swap, suffix-only prefill, SLO admission with decode
preemption, the tracer, the engine's metrics and expert telemetry, the
federated round spans and the serving launcher's traffic flags.

The engine differentials use SLO targets of 0 ms for the urgent tier and
60 s for the other, so which request is urgent never depends on the
host's speed: the JAX and the port engines then take the same admission,
preemption and prefix-cache decisions, and every counter must agree.
Tolerances: tokens, counters, block tables and refcounts exactly;
``prefill_suffix`` logits and K/V against JAX within rel 1e-5 (float32,
only the summation order differs); pool contents after an op sequence
within 1e-5 (pieces from each package's own prefill).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.configs import base as jbase
from repro.data import synthetic as jsyn
from repro.federated.server import FederatedServer as JServer
from repro.federated.simulation import build_experiment as j_build
from repro.models import model as jmodel
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.obs import validate_chrome_trace as j_validate
from repro.serving import BlockPool as JPool
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic as tsyn
from repro_torch.federated.server import FederatedServer as TServer
from repro_torch.federated.simulation import build_experiment as t_build
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models.attention import paged_gather
from repro_torch.obs import MetricsRegistry, Tracer, validate_chrome_trace
from repro_torch.serving import BlockPool, Request, ServingEngine
from test_torch_model import port_cfg

JCFG = tiny_moe()
TCFG = port_cfg(JCFG)
JPARAMS = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
TPARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
V = JCFG.vocab_size
# the urgent tier's target is already missed at arrival, the other's never
SLO = {2: 0.0, 1: 60000.0}
KW = dict(num_slots=4, slot_len=16, slot_k=(2, 2, 1, 1), block_size=4)


def _shared_prefix_trace(cls, n=8, prefix_len=4, lens=(6, 8), tiers=(1, 2),
                         new=(2, 4, 5), seed=3):
    """Closed batch: every prompt opens with one of two fixed prefixes,
    and the last two repeat earlier prompts exactly."""
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(0, V, (2, prefix_len)).astype(np.int32)
    reqs = []
    for i in range(n):
        L = int(rng.choice(lens))
        p = rng.integers(0, V, (L,)).astype(np.int32)
        p[:prefix_len] = prefixes[i % 2]
        if i >= n - 2:
            p = np.array(reqs[i - 2].prompt, np.int32)
        reqs.append(cls(rid=i, prompt=p, max_new_tokens=int(rng.choice(new)),
                        k=int(tiers[i % len(tiers)])))
    return reqs


def _assert_same_tokens(want, got):
    assert sorted(want) == sorted(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"rid {rid}")


def _events(tracer_dict, pid):
    """The reference's events on track ``pid``: the port's own layer
    spans (``cat: "layer"``, which the reference does not record) are
    left out."""
    return [e for e in tracer_dict["traceEvents"]
            if e["ph"] != "M" and e["pid"] == pid
            and e.get("cat") != "layer"]


# ==========================================================================
# engine differentials (one JAX run, shared through a module fixture)
# ==========================================================================

@pytest.fixture(scope="module")
def traffic_runs():
    """The traffic stack (prefix cache + EDF + preemption) with a tracer,
    a metrics registry and expert telemetry, in both packages, plus the
    port's cold engine, on the shared-prefix closed batch."""
    obs = {}
    runs = {}
    for name, (Eng, cfg, params, cls, Trc, Reg) in {
            "jax": (JEngine, JCFG, JPARAMS, JRequest, JTracer, JRegistry),
            "port": (ServingEngine, TCFG, TPARAMS, Request, Tracer,
                     MetricsRegistry)}.items():
        tracer, reg = Trc(), Reg()
        eng = Eng(cfg, params, prefix_cache=True, preemption=True,
                  slo_ms=SLO, tracer=tracer, metrics=reg,
                  expert_telemetry=True, **KW)
        runs[name] = eng.run(_shared_prefix_trace(cls))
        obs[name] = (eng, tracer, reg)
    cold = ServingEngine(TCFG, TPARAMS, **KW).run(
        _shared_prefix_trace(Request))
    return runs, obs, cold


def test_traffic_engine_matches_jax_engine_and_cold(traffic_runs):
    runs, obs, cold = traffic_runs
    j, t = runs["jax"], runs["port"]
    _assert_same_tokens(j.tokens_by_rid(), t.tokens_by_rid())
    _assert_same_tokens(cold.tokens_by_rid(), t.tokens_by_rid())
    assert t.prefix == j.prefix and t.prefix["hit_tokens"] > 0
    assert t.preemptions == j.preemptions >= 1
    assert [c.preemptions for c in t.completions] == \
        [c.preemptions for c in j.completions]
    assert t.prefill_tokens == j.prefill_tokens < cold.prefill_tokens
    assert len(t.prefill_s) == len(j.prefill_s)      # the same prefill calls
    assert len(t.decode_step_s) == len(j.decode_step_s)
    eng = obs["port"][0]
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0
    assert eng.pool.swap_outs == eng.pool.swap_ins == t.preemptions


def test_traffic_engine_metrics_match_jax_engine(traffic_runs):
    """Every counter and gauge equal; the step histograms hold the same
    number of observations (their values are host times)."""
    _, obs, _ = traffic_runs
    js, ts = obs["jax"][2].snapshot(), obs["port"][2].snapshot()
    assert sorted(js) == sorted(ts)
    for name in js:
        if js[name]["type"] == "histogram":
            assert ts[name]["count"] == js[name]["count"], name
        else:
            assert ts[name] == js[name], name
    for name in ("serving.kv.blocks_peak", "serving.scheduler.queue_depth",
                 "serving.decode_step_ms", "serving.prefill_ms",
                 "serving.kv.prefix.hit_tokens", "serving.preemptions"):
        assert name in ts


def test_engine_spans_and_expert_load_match_jax_engine(traffic_runs):
    runs, obs, _ = traffic_runs
    jd, td = obs["jax"][1].to_dict(), obs["port"][1].to_dict()
    assert validate_chrome_trace(td) == [] and j_validate(td) == []

    def by_rid(d):
        out = {}
        for e in _events(d, 2):
            out.setdefault(e["tid"], []).append(
                (e["name"], e["ph"], e.get("args")))
        return {rid: sorted(v, key=repr) for rid, v in out.items()}

    assert by_rid(td) == by_rid(jd)
    for rid, names in by_rid(td).items():
        assert {"request", "queued", "prefill", "decode"} <= \
            {n for n, _, _ in names}, rid
    eng_names = lambda d: sorted(e["name"] for e in _events(d, 1))  # noqa
    assert eng_names(td) == eng_names(jd)
    jl, tl = runs["jax"].expert_load, runs["port"].expert_load
    for key in ("steps", "num_experts", "assignments_total", "hot_expert",
                "totals"):
        assert tl[key] == jl[key], key
    np.testing.assert_allclose([tl["gini"], tl["entropy"]],
                               [jl["gini"], jl["entropy"]], rtol=1e-12)
    # each layer routed every active slot's k per decode step
    want = sum(c.k * (c.n_generated - 1) for c in runs["port"].completions)
    for row in tl["totals"]["pos0"]:
        assert sum(row) == want


def test_suffix_prefill_matches_cold_across_match_shapes():
    """Cold miss, same-pass duplicate (pending blocks: full recompute),
    full match on a block edge (one-token suffix), full match through a
    partial tail, a longer prompt extending a cached head, a one-block
    head match — the reference test's trace, with its exact hit and
    prefill-token counts; the port's traffic engine equals its cold one."""
    rng = np.random.default_rng(17)
    head = rng.integers(0, V, (8,)).astype(np.int32)
    B = rng.integers(0, V, (6,)).astype(np.int32)
    Abig = np.concatenate([head, rng.integers(0, V, (4,))]).astype(np.int32)
    C = np.concatenate([B[:4], rng.integers(0, V, (4,))]).astype(np.int32)
    mk = [(head, 2, 0.0), (B, 1, 0.0), (head.copy(), 2, 0.0),
          (head.copy(), 2, 0.06), (B.copy(), 1, 0.06), (Abig, 2, 0.06),
          (C, 1, 0.06)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=3, k=k, arrival=t)
                for i, (p, k, t) in enumerate(mk)]
    kw = dict(KW, num_blocks=32)
    cold = ServingEngine(TCFG, TPARAMS, **kw).run(reqs())
    eng = ServingEngine(TCFG, TPARAMS, prefix_cache=True, **kw)
    warm = eng.run(reqs())
    _assert_same_tokens(cold.tokens_by_rid(), warm.tokens_by_rid())
    assert warm.prefix["hit_tokens"] == 34
    assert cold.prefill_tokens == 56 and warm.prefill_tokens == 33
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0


def test_one_token_suffix_after_a_tail_miss_matches_cold():
    """A prompt whose full blocks are cached but whose partial tail is not
    runs a one-token suffix that must be scattered into the pool.  (The
    reference's suffix step takes its paged-decode branch at S = 1 and
    hands the pool itself to the scatter, so its later tokens diverge from
    a cold engine at this shape; the port checks the suffix branch first.)"""
    rng = np.random.default_rng(5)
    A = rng.integers(0, V, (9,)).astype(np.int32)
    B = A.copy()
    B[8] = (B[8] + 1) % V

    def reqs():
        return [Request(rid=0, prompt=A, max_new_tokens=6, k=2),
                Request(rid=1, prompt=B, max_new_tokens=6, k=2,
                        arrival=0.05)]
    kw = dict(num_slots=2, slot_len=20, slot_k=(2, 2), block_size=4,
              num_blocks=16)
    cold = ServingEngine(TCFG, TPARAMS, **kw).run(reqs())
    warm = ServingEngine(TCFG, TPARAMS, prefix_cache=True, **kw).run(reqs())
    _assert_same_tokens(cold.tokens_by_rid(), warm.tokens_by_rid())
    assert warm.prefix["hit_tokens"] == 8 and warm.prefill_tokens == 10


def test_prefix_cache_is_tier_scoped():
    """The same prompt at k=1 and k=2 must not share pages (the digests
    are salted by the tier): a clean miss, both prefilled in full."""
    p = np.random.default_rng(11).integers(0, V, (8,)).astype(np.int32)

    def reqs():
        return [Request(rid=0, prompt=p, max_new_tokens=3, k=1),
                Request(rid=1, prompt=p.copy(), max_new_tokens=3, k=2,
                        arrival=0.05)]
    kw = dict(num_slots=2, slot_len=16, slot_k=(2, 1), block_size=4,
              num_blocks=16)
    eng = ServingEngine(TCFG, TPARAMS, prefix_cache=True, **kw)
    rep = eng.run(reqs())
    _assert_same_tokens(ServingEngine(TCFG, TPARAMS, **kw).run(reqs())
                        .tokens_by_rid(), rep.tokens_by_rid())
    assert rep.prefix["hit_tokens"] == 0 and rep.prefill_tokens == 16
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0


def test_preempted_request_resumes_token_identical():
    """An economy decode swapped out for an urgent premium arrival resumes
    where it stopped: both requests' tokens equal their solo runs."""
    rng = np.random.default_rng(23)
    eco, prm = (rng.integers(0, V, (8,)).astype(np.int32) for _ in range(2))
    # 14 blocks: economy reserves 12, so the premium arrival (3) starves
    kw = dict(num_slots=2, slot_len=48, slot_k=(2, 1), block_size=4,
              num_blocks=14, preemption=True, slo_ms=SLO)
    e_req = lambda: Request(rid=0, prompt=eco, max_new_tokens=40, k=1)  # noqa
    p_req = lambda t: Request(rid=1, prompt=prm, max_new_tokens=4, k=2,  # noqa
                              arrival=t)
    eng = ServingEngine(TCFG, TPARAMS, **kw)
    rep = eng.run([e_req(), p_req(0.02)])
    by_rid = {c.rid: c for c in rep.completions}
    assert rep.preemptions >= 1
    assert by_rid[0].preemptions >= 1 and by_rid[1].preemptions == 0
    assert eng.pool.swap_outs == eng.pool.swap_ins == rep.preemptions
    solo = {0: ServingEngine(TCFG, TPARAMS, **kw).run([e_req()]),
            1: ServingEngine(TCFG, TPARAMS, **kw).run([p_req(0.0)])}
    for rid, r in solo.items():
        assert r.preemptions == 0
        np.testing.assert_array_equal(by_rid[rid].tokens, r.completions[0]
                                      .tokens)
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0


def test_permuted_free_list_is_invisible_to_tokens():
    eng = ServingEngine(TCFG, TPARAMS, prefix_cache=True, **KW)
    eng.pool.permute_free(4)
    assert eng.pool._free_blocks != sorted(eng.pool._free_blocks)
    rep = eng.run(_shared_prefix_trace(Request, seed=8))
    cold = ServingEngine(TCFG, TPARAMS, **KW).run(
        _shared_prefix_trace(Request, seed=8))
    _assert_same_tokens(cold.tokens_by_rid(), rep.tokens_by_rid())
    eng.pool.check_invariants()


@pytest.mark.parametrize("kw,match", [
    (dict(kv_layout="slotted", prefix_cache=True), "paged"),
    (dict(kv_layout="slotted", preemption=True, slo_ms={1: 1.0}), "paged"),
    (dict(preemption=True), "slo_ms"),
])
def test_engine_rejects_bad_traffic_combos(kw, match):
    """The reference's guards, with its errors."""
    with pytest.raises(ValueError, match=match):
        ServingEngine(TCFG, TPARAMS, num_slots=2, slot_len=8, slot_k=(2, 1),
                      **kw)
    with pytest.raises(ValueError, match=match):
        JEngine(JCFG, JPARAMS, num_slots=2, slot_len=8, slot_k=(2, 1), **kw)


def test_prefix_cache_rejects_ring_caches():
    ring = port_cfg(tiny_moe(attention_window=6))
    with pytest.raises(ValueError, match="linear cache"):
        BlockPool(ring, num_slots=2, slot_len=8, block_size=4,
                  prefix_cache=True, device="cpu")
    params = tmodel.init_params(ring, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="linear cache"):
        ServingEngine(ring, params, num_slots=2, slot_len=8, block_size=4,
                      prefix_cache=True)


# ==========================================================================
# the model: suffix-only prefill against the JAX package
# ==========================================================================

@pytest.mark.parametrize("suffixes", [(3, 1), (1, 1)])
def test_prefill_suffix_matches_jax(suffixes):
    """Two rows with cached 8-token heads and suffixes of the given lengths
    (the shorter row padded); the attached pages come from one JAX pool,
    converted for the port.  Also against the port's cold prefill of the
    whole prompt."""
    rng = np.random.default_rng(sum(suffixes))
    heads = rng.integers(0, V, (2, 8)).astype(np.int32)
    jpool = JPool(JCFG, num_slots=2, slot_len=16, block_size=4,
                  prefix_cache=True)
    for h in heads:
        s = jpool.allocate()
        jpool.reserve(s, 12)
        _, piece = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(h[None]), k=2,
                                  cache_len=16)
        jpool.write([s], piece, [8], tokens=[h])
        jpool.alloc_prompt(s, 12)          # the suffix's own block
    S = max(suffixes)
    toks = np.zeros((2, S), np.int32)
    for j, n in enumerate(suffixes):
        toks[j, :n] = rng.integers(0, V, (n,))
    pref, suf = np.array([8, 8], np.int32), np.array(suffixes, np.int32)
    # three blocks: at S = 1 the reference's step writes position 8
    tbl = jpool.block_table[:, :3]
    jl, jpiece = jmodel.prefill_suffix(
        JCFG, JPARAMS, jnp.asarray(toks), pref, suf, jpool.cache,
        jnp.asarray(tbl), page_span=12, k=2, dispatch="ragged")
    tcache = {"pos0": {"attn": {n: torch.from_numpy(np.array(a))
                                for n, a in jpool.cache["pos0"]["attn"]
                                .items()}}}
    mask = torch.as_tensor(np.arange(S)[None] < suf[:, None],
                           dtype=torch.float32)
    tl, tpiece = tmodel.prefill_suffix(
        TCFG, TPARAMS, torch.as_tensor(toks, dtype=torch.int64), pref, suf,
        tcache, torch.as_tensor(tbl), page_span=12, k=(2, 2),
        slot_mask=mask)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jl).max()))
    if S > 1:        # at S = 1 the reference returns the pool (see above)
        for leaf in ("k", "v"):
            want = np.asarray(jpiece["pos0"]["attn"][leaf])
            got = tpiece["pos0"]["attn"][leaf].numpy()
            for j, n in enumerate(suffixes):
                np.testing.assert_allclose(got[:, j, :n], want[:, j, :n],
                                           rtol=1e-5, atol=1e-6)
    for j, n in enumerate(suffixes):
        full = np.concatenate([heads[j], toks[j, :n]])[None]
        cl, _ = tmodel.prefill(TCFG, TPARAMS,
                               torch.as_tensor(full, dtype=torch.int64), k=2)
        np.testing.assert_allclose(tl[j].numpy(), cl[0].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(cl.abs().max()))


@pytest.mark.parametrize("window", [0, 3])
def test_verify_attention_matches_jax(window):
    """The multi-token window attention (speculative verify's) against the
    reference's, per-row window starts, GQA."""
    from repro.models.attention import verify_attention as j_verify
    from repro_torch.models.attention import verify_attention
    rng = np.random.default_rng(window)
    B, S, H, KV, D, Sc = 3, 4, 4, 2, 8, 12
    q, kn, vn = (rng.standard_normal((B, S, h, D)).astype(np.float32)
                 for h in (H, KV, KV))
    kc, vc = (rng.standard_normal((B, Sc, KV, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 5, 8], np.int32)
    want = j_verify(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc, pos)),
                    window=window)
    got = verify_attention(*(torch.from_numpy(a) for a in (q, kn, vn, kc,
                                                           vc, pos)),
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ==========================================================================
# the block pool: op for op against the reference
# ==========================================================================

def _pool_state(pool):
    return dict(table=pool.block_table.tolist(), ref=pool._ref.tolist(),
                free=list(pool._free_blocks), pos=pool.cache_pos.tolist(),
                shared=pool._shared_mark.tolist(),
                nshared=pool._nshared.tolist(),
                stats=pool.prefix_stats(), swaps=(pool.swap_outs,
                                                  pool.swap_ins),
                avail=pool.available_blocks, peak=pool.peak_blocks)


@pytest.mark.parametrize("seed", range(6))
def test_block_pool_interleavings_match_reference(seed):
    """The reference's ``_interleave`` harness (admit / share / decode /
    truncate / swap-out / swap-in / release against a prefix pool) drives
    both packages' pools with one seeded op sequence: equal tables,
    refcounts, free lists, stats and invariants after every op, and equal
    pool contents at the end."""
    rng = np.random.default_rng(seed)
    trng = np.random.default_rng(100 + seed)
    kw = dict(num_slots=3, slot_len=16, block_size=4, num_blocks=10,
              prefix_cache=True)
    jp, tp = JPool(JCFG, **kw), BlockPool(TCFG, device="cpu", **kw)
    templates = [trng.integers(0, V, (L,)).astype(np.int32)
                 for L in (4, 6, 8)]
    jpieces, tpieces = {}, {}
    for t in templates:
        jpieces[len(t)] = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(t[None]),
                                         k=2, cache_len=16)[1]
        tpieces[len(t)] = tmodel.prefill(
            TCFG, TPARAMS, torch.as_tensor(t[None], dtype=torch.int64),
            k=2)[1]
    active, swapped = {}, []
    for _ in range(60):
        op = rng.choice(["admit", "decode", "truncate", "swap_out",
                         "swap_in", "release"])
        if op == "admit" and tp.num_free:
            t = templates[int(rng.integers(len(templates)))]
            proj = int(rng.integers(len(t) + 1, 17))
            assert tp.can_admit(proj) == jp.can_admit(proj)
            if tp.can_admit(proj):
                for pool, pieces in ((jp, jpieces), (tp, tpieces)):
                    s = pool.allocate()
                    pool.reserve(s, proj)
                    pool.write([s], pieces[len(t)], [len(t)], tokens=[t])
                    pool.cache_pos[s] = len(t)
                active[s] = (len(t), proj)
        elif op == "decode" and active:
            s = int(rng.choice(list(active)))
            if int(tp.cache_pos[s]) < active[s][1]:
                for pool in (jp, tp):
                    pool.prepare_decode([s])
                    pool.cache_pos[s] += 1
        elif op == "truncate" and active:
            s = int(rng.choice(list(active)))
            L = active[s][0]
            if int(tp.cache_pos[s]) > L:
                n = int(rng.integers(L, int(tp.cache_pos[s])))
                jp.truncate_to(s, n)
                tp.truncate_to(s, n)
        elif op == "swap_out" and active:
            s = int(rng.choice(list(active)))
            swapped.append((jp.swap_out(s), tp.swap_out(s),
                            active.pop(s)[1]))
        elif op == "swap_in" and swapped and tp.num_free:
            jstate, tstate, proj = swapped[-1]
            if tp.can_admit(proj):
                swapped.pop()
                for pool, state in ((jp, jstate), (tp, tstate)):
                    s = pool.allocate()
                    pool.reserve(s, proj)
                    pool.swap_in(s, state)
                active[s] = (tstate["cache_pos"], proj)
        elif op == "release" and active:
            s = int(rng.choice(list(active)))
            jp.release(s)
            tp.release(s)
            del active[s]
        jp.check_invariants()
        tp.check_invariants()
        assert _pool_state(tp) == _pool_state(jp), op
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tp.cache["pos0"]["attn"][leaf].numpy(),
                                   np.asarray(jp.cache["pos0"]["attn"][leaf]),
                                   rtol=1e-5, atol=1e-6)
    for s in list(active):
        jp.release(s)
        tp.release(s)
    tp.check_invariants()
    assert tp.blocks_in_use == 0 and tp.available_blocks == tp.num_blocks


def _admit(pool, prompt, proj):
    """Allocate, reserve and write one prompt (its prefill at k=2)."""
    s = pool.allocate()
    pool.reserve(s, proj)
    _, piece = tmodel.prefill(TCFG, TPARAMS, torch.as_tensor(
        prompt[None], dtype=torch.int64), k=2)
    pool.write([s], piece, [len(prompt)], tokens=[prompt])
    return s


def _pool(**kw):
    base = dict(num_slots=4, slot_len=16, block_size=4, num_blocks=12,
                prefix_cache=True, device="cpu")
    base.update(kw)
    return BlockPool(TCFG, **base)


def test_prefix_sharing_refcounts_and_revival():
    pool = _pool()
    A = np.random.default_rng(1).integers(0, V, (8,)).astype(np.int32)
    s0 = _admit(pool, A, 12)
    s1 = _admit(pool, A, 12)                     # both blocks attached
    assert pool.blocks_in_use == 2
    assert pool.prefix_stats() == {"hit_blocks": 2, "hit_tokens": 8,
                                   "cow_copies": 0, "evictions": 0,
                                   "cached_blocks": 2}
    assert pool.available_blocks == (12 - 2) - (1 + 3)
    pool.release(s0)
    pool.release(s1)
    assert pool.blocks_in_use == 0 and pool.prefix_stats()[
        "cached_blocks"] == 2
    s2 = _admit(pool, A, 12)                     # revived, nothing written
    assert pool._nshared[s2] == 0 and pool.prefix_stats()["hit_tokens"] == 16
    _, want = tmodel.prefill(TCFG, TPARAMS, torch.as_tensor(
        A[None], dtype=torch.int64), k=2)
    for leaf in ("k", "v"):
        pooled = pool.cache["pos0"]["attn"][leaf]
        for p in range(pooled.shape[0]):
            got = paged_gather(pooled[p], pool.tables(), pool.attn_len)
            torch.testing.assert_close(got[s2, :8],
                                       want["pos0"]["attn"][leaf][p, 0])
    pool.check_invariants()


def test_prefix_copy_on_write_and_adopt():
    pool = _pool()
    A = np.random.default_rng(2).integers(0, V, (6,)).astype(np.int32)
    s0 = _admit(pool, A, 12)
    s1 = _admit(pool, A.copy(), 12)              # block 0 + tail shared
    pool.cache_pos[s0] = pool.cache_pos[s1] = 6
    old = int(pool.block_table[s1, 1])
    pool.prepare_decode([s1])
    new = int(pool.block_table[s1, 1])
    assert new != old and pool.prefix_stats()["cow_copies"] == 1
    for leaf in ("k", "v"):
        pooled = pool.cache["pos0"]["attn"][leaf]
        assert torch.equal(pooled[:, new], pooled[:, old])
    pool.prepare_decode([s0])                    # owners never copy
    assert int(pool.block_table[s0, 1]) == old
    s2 = _admit(pool, A.copy(), 12)
    shared = int(pool.block_table[s2, 1])
    pool.release(s0)
    pool.release(s1)
    pool.cache_pos[s2] = 6
    pool.prepare_decode([s2])                    # sole referent: adopt
    assert int(pool.block_table[s2, 1]) == shared
    assert pool.prefix_stats()["cow_copies"] == 1 and pool._nshared[s2] == 1
    pool.check_invariants()


def test_prefix_entries_evict_on_reuse_and_partial_tails():
    pool = _pool(num_slots=2, num_blocks=4)
    rng = np.random.default_rng(3)
    A = rng.integers(0, V, (8,)).astype(np.int32)
    pool.release(_admit(pool, A, 8))
    big = np.concatenate([(A + 1) % V] * 2).astype(np.int32)
    s1 = _admit(pool, big, 16)                   # takes all 4 blocks
    assert pool.prefix_stats()["evictions"] == 2
    pool.release(s1)
    pool.release(_admit(pool, A, 8))             # rewritten, not hit
    assert pool.prefix_stats()["hit_tokens"] == 0
    tail = _pool()
    T = rng.integers(0, V, (6,)).astype(np.int32)
    _admit(tail, T, 12)
    longer = _admit(tail, np.concatenate([T, T[:4]]).astype(np.int32), 12)
    assert tail.prefix_stats()["hit_tokens"] == 4 and \
        tail._nshared[longer] == 1               # the tail needs a full match
    exact = _admit(tail, T.copy(), 12)
    assert tail.prefix_stats()["hit_tokens"] == 10 and \
        tail._nshared[exact] == 2
    tail.check_invariants()


def test_swap_roundtrip_is_bit_exact_and_keeps_shareability():
    pool = _pool(num_slots=2, num_blocks=8)
    A = np.random.default_rng(4).integers(0, V, (8,)).astype(np.int32)
    s = _admit(pool, A, 12)
    pool.cache_pos[s] = 8
    idx = torch.as_tensor(pool.block_table[s, :2].astype(np.int64))
    before = {leaf: pool.cache["pos0"]["attn"][leaf][:, idx].clone()
              for leaf in ("k", "v")}
    state = pool.swap_out(s)
    assert pool.blocks_in_use == 0 and pool.available_blocks == 8
    assert state["cache_pos"] == 8 and state["n_blocks"] == 2
    with pytest.raises(ValueError, match="slot is free"):
        pool.swap_out(s)
    s2 = pool.allocate()
    pool.reserve(s2, 12)
    pool.swap_in(s2, state)
    idx = torch.as_tensor(pool.block_table[s2, :2].astype(np.int64))
    for leaf in ("k", "v"):
        assert torch.equal(pool.cache["pos0"]["attn"][leaf][:, idx],
                           before[leaf])
    s3 = _admit(pool, A.copy(), 12)              # the duplicate still hits
    assert pool.prefix_stats()["hit_tokens"] == 8 and pool._nshared[s3] == 2
    assert pool.swap_outs == pool.swap_ins == 1
    pool.check_invariants()


# ==========================================================================
# the tracer: the port's copy against the reference
# ==========================================================================

def _fill(tr):
    tr.process_name(1, "serving-engine")
    tr.thread_name(2, 7, "req 7")
    tr.complete("prefill", 0.001, 0.004, cat="engine", args={"batch": 2})
    tr.complete("decode_step", 0.0045, 0.0051)
    tr.instant("swap_out", 0.002, pid=2, tid=7, cat="preempt",
               args={"slot": 1})
    tr.counter("engine", 0.003, {"active_slots": 3, "queue_depth": 1})
    tr.complete("request", 0.0, 0.01, pid=2, tid=7)
    tr.complete("queued", 0.0, 0.001, pid=2, tid=7)


@pytest.mark.parametrize("overlap", [False, True])
def test_tracer_json_and_validation_match_reference(overlap, tmp_path):
    jt, tt = JTracer(ring=6), Tracer(ring=6)
    for tr in (jt, tt):
        _fill(tr)
        if overlap:      # partially overlaps "request" on its track
            tr.complete("decode", 0.005, 0.02, pid=2, tid=7)
    assert tt.to_dict() == jt.to_dict() and tt.dropped == jt.dropped
    got = json.load(open(tt.dump(str(tmp_path / "t.json"))))
    for trace in (tt.to_dict(), jt.to_dict(), got):
        assert validate_chrome_trace(trace) == j_validate(trace)
        assert bool(validate_chrome_trace(trace)) == overlap
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": -1, "pid": 1,
                            "tid": 0, "dur": 1}, {"ph": "X"}]}
    assert validate_chrome_trace(bad) == j_validate(bad) != []


# ==========================================================================
# the federated round spans
# ==========================================================================

@pytest.fixture(scope="module")
def experiments():
    """One experiment per package: 4 clients, one round at participation
    0.25 (one client), the same weights and data."""
    data = dict(vocab_size=V, n_examples=80, seq_len=16, n_clusters=4)
    fed = dict(num_clients=4, rounds=1, participation=0.25)
    jexp = j_build(JCFG, fed=jbase.FederatedConfig(**fed),
                   tc=jbase.TrainConfig(batch_size=7),
                   data=jsyn.DataConfig(**data), base_params=JPARAMS)
    texp = t_build(TCFG, fed=tconfigs.FederatedConfig(**fed),
                   tc=tconfigs.TrainConfig(batch_size=7),
                   data=tsyn.DataConfig(**data), base_params=TPARAMS,
                   device="cpu")
    return {"jax": (jexp, JServer, JTracer), "port": (texp, TServer, Tracer)}


@pytest.mark.parametrize("engine", ["looped", "batched"])
def test_federated_round_spans_match_reference(engine, experiments,
                                               tmp_path):
    """A server built with ``tracer=`` in each package runs one round with
    ``run(trace_to=...)``: the same spans in the same order (names, tracks
    and arguments; times are the host's)."""
    spans = {}
    for name, (exp, Server, Trc) in experiments.items():
        s = exp.server
        server = Server(s.cfg, s.params, s.global_lora, s.clients,
                        dataclasses.replace(s.fed, round_engine=engine),
                        s.tc, tracer=Trc())
        path = str(tmp_path / f"{name}.json")
        server.run(trace_to=path)
        trace = json.load(open(path))
        assert validate_chrome_trace(trace) == []
        # the reference's spans (the port's layer spans left out)
        events = sorted((e for e in trace["traceEvents"]
                         if e.get("cat") != "layer"), key=lambda e: (
            e["ph"] != "M", e["ts"] + e.get("dur", 0)))
        spans[name] = [(e["name"], e["ph"], e["pid"], e["tid"],
                        e.get("args")) for e in events]
    assert spans["port"] == spans["jax"]
    step = "local_train" if engine == "looped" else "cohort_update"
    assert {"round 0", "distribute", step, "aggregate"} <= \
        {s[0] for s in spans["port"]}


# ==========================================================================
# the serving launcher's traffic flags
# ==========================================================================

def test_serve_launcher_traffic_flags(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    tserve.main(["--local", "--device", "cpu", "--slots", "4", "--mix",
                 "2:0.5,1:0.5", "--requests", "8", "--new-tokens", "3",
                 "--block-size", "4", "--prefix-cache", "--shared-prefix",
                 "4", "--slo-ms", "2:50,1:5000", "--preemption",
                 "--trace-out", str(trace), "--metrics-out", str(metrics),
                 "--expert-telemetry"])
    out = capsys.readouterr().out
    assert "prefix-cache preemption slo=2:50,1:5000" in out
    assert "gen_tokens: 24" in out and "prefix_cache:" in out
    assert "expert_load:" in out
    t = json.load(open(trace))
    assert validate_chrome_trace(t) == []
    assert {e["tid"] for e in _events(t, 2)} == set(range(8))
    snap = json.load(open(metrics))
    assert snap["serving.completions"]["value"] == 8
    assert snap["serving.kv.prefix.hit_tokens"]["value"] > 0
    with pytest.raises(SystemExit, match="--slo-ms"):
        tserve.main(["--local", "--device", "cpu", "--preemption"])
