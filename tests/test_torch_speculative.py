"""The port's serving extras against the JAX package, at float32 on the CPU:
sampled decoding, the slotted pool and self-speculative decoding (draft at
``draft_k``, one full-k verify, the rejection rule, rollback).

Both packages run the olmoe smoke widths (2 layers, d_model 128, 4
experts, top-2) cut to float32, on the same weights; the JAX side runs its
``backend="reference"`` path.  Tolerances: sampler distributions 1e-6
absolute; attention outputs, written K/V and logits (draft, verify, slotted
decode) 1e-5 relative and absolute (float32 both sides, only the summation
order differs); tokens, acceptance counts, speculative counters and pool
state exactly.  The resampled / bonus token of the rejection rule cannot
match JAX's ``categorical`` draw for draw (another generator), so it is
checked in distribution: total variation and chi-square against the
analytic target over 20000 seeded windows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving import BlockPool as JPool
from repro.serving import Request as JRequest
from repro.serving import SamplerConfig as JSampler
from repro.serving import ServingEngine as JEngine
from repro.serving import SlotPool as JSlotPool
from repro.serving import SpeculativeConfig as JSpec
from repro.serving.sampler import sampler_probs as j_sampler_probs
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.serving.speculative import verify_window as j_verify_window
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.obs import MetricsRegistry, Tracer, validate_chrome_trace
from repro_torch.serving import (BlockPool, Request, SamplerConfig,
                                 ServingEngine, SlotPool, SpeculativeConfig)
from repro_torch.serving.engine import ServingReport
from repro_torch.serving.sampler import event_uniforms, sampler_probs
from repro_torch.serving.speculative import verify_window
from test_torch_model import port_cfg

JCFG = jreg.get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
TCFG = port_cfg(JCFG)
JPARAMS = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
TPARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
V = JCFG.vocab_size
KIND_CONFIGS = {"greedy": dict(kind="greedy"),
                "temperature": dict(kind="temperature", temperature=0.8),
                "top_p": dict(kind="top_p", temperature=0.9, top_p=0.7)}


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _assert_same_tokens(want, got):
    assert sorted(want) == sorted(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"rid {rid}")


# ==========================================================================
# the sampler and the rejection rule
# ==========================================================================

@pytest.mark.parametrize("kind", sorted(KIND_CONFIGS))
def test_sampler_probs_match_jax(kind):
    """Temperature softmax, the nucleus cut ("mass strictly before <
    top_p", ties in stable order) and the greedy one-hot (first maximum),
    on rows with ties; within 1e-6."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((6, 33)) * 2.0).astype(np.float32)
    logits[1, 5] = logits[1, 9] = logits[1].max() + 1.0      # tied argmax
    logits[2] = 0.0                                          # all tied
    want = j_sampler_probs(jnp.asarray(logits), JSampler(**KIND_CONFIGS[kind]))
    got = sampler_probs(_t(logits), SamplerConfig(**KIND_CONFIGS[kind]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _windows(B, W, Vw, seed, spread=0.6):
    """Target logits (B, W+1, V), draft logits near them (B, W, V) and
    drafts picked from the draft distribution."""
    rng = np.random.default_rng(seed)
    tl = (rng.standard_normal((B, W + 1, Vw)) * 1.5).astype(np.float32)
    dl = (tl[:, :W] + rng.standard_normal((B, W, Vw)) * spread).astype(
        np.float32)
    return tl, dl, rng


@pytest.mark.parametrize("kind", sorted(KIND_CONFIGS))
def test_verify_window_matches_jax_given_its_uniforms(kind):
    """The vectorised rule fed the reference's own accept uniforms (split
    the key as ``_verify_window`` does): the same number of accepted
    drafts and the same accepted prefix per slot.  Greedy: the whole
    window, bonus included, since its distributions are one-hot."""
    B, W, Vw = 64, 3, 9
    tl, dl, rng = _windows(B, W, Vw, seed=4)
    sc_j, sc_t = JSampler(**KIND_CONFIGS[kind]), SamplerConfig(
        **KIND_CONFIGS[kind])
    q = np.asarray(j_sampler_probs(jnp.asarray(dl), sc_j))
    drafts = np.stack([[rng.choice(Vw, p=q[b, i] / q[b, i].sum())
                        for i in range(W)] for b in range(B)]).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jout, jemit, jacc = jax.vmap(
        lambda k, d, ql, t: j_verify_window(k, d, ql, t, sc_j))(
        keys, jnp.asarray(drafts), jnp.asarray(dl), jnp.asarray(tl))
    u = np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[0], (W,)))
                  for k in keys])
    out, emit, acc = verify_window(_t(drafts), _t(dl), _t(tl), sc_t,
                                   _t(u), torch.zeros(B))
    jacc = np.asarray(jacc)
    np.testing.assert_array_equal(acc.numpy(), jacc)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    assert 0 < jacc.sum() < B * W or kind == "greedy"
    for b in range(B):
        n = int(jacc[b]) + (1 if kind == "greedy" else 0)
        np.testing.assert_array_equal(out[b, :n].numpy(),
                                      np.asarray(jout)[b, :n])


def _tv(hist, p):
    return 0.5 * float(np.abs(hist - p).sum())


def _chi2(counts, p, n):
    sup = p > 1e-12
    return (float((((counts - n * p) ** 2)[sup] / (n * p)[sup]).sum()),
            int(sup.sum()) - 1)


@pytest.mark.parametrize("kind", ["temperature", "top_p"])
def test_verify_window_emits_target_distribution(kind):
    """The reference's statistical harness on the port's rule: 20000 seeded
    windows of context-free logits (V = 8, W = 3); the first emitted
    token, the token at position 1 and the bonus token each follow the
    analytic target distribution (TV < 3·sqrt(V/n), chi-square within 6
    sigma), and nothing outside its support is ever emitted."""
    Vw, W, N = 8, 3, 20000
    sc = SamplerConfig(**KIND_CONFIGS[kind])
    rng = np.random.default_rng(5)
    tl = (rng.normal(size=(W + 1, Vw)) * 1.5).astype(np.float32)
    dl = (tl[:W] + rng.normal(size=(W, Vw)) * 0.5).astype(np.float32)
    p = sampler_probs(_t(tl), sc).double().numpy()
    q = sampler_probs(_t(dl), sc)
    gen = torch.Generator().manual_seed(7)
    drafts = torch.stack([torch.multinomial(q[i], N, replacement=True,
                                            generator=gen)
                          for i in range(W)], dim=1)              # (N, W)
    u = torch.rand((N, W + 1), generator=gen, dtype=torch.float64)
    out, emit, acc = verify_window(
        drafts, _t(dl).expand(N, W, Vw), _t(tl).expand(N, W + 1, Vw), sc,
        u[:, :W], u[:, W])
    out, emit, acc = out.numpy(), emit.numpy(), acc.numpy()
    for name, toks, target in (("first token", out[:, 0], p[0]),
                               ("position 1", out[emit >= 2, 1], p[1]),
                               ("bonus token", out[acc == W, W], p[W])):
        n = len(toks)
        assert n >= 2000, f"{name}: only {n} samples"
        counts = np.bincount(toks, minlength=Vw).astype(np.float64)
        assert counts[target <= 1e-12].sum() == 0, name
        assert _tv(counts / n, target) < 3.0 * np.sqrt(Vw / n), name
        chi2, df = _chi2(counts, target, n)
        assert chi2 < df + 6.0 * np.sqrt(2.0 * df), (name, chi2, df)


def test_event_uniforms_depend_only_on_seed_rid_event():
    a = event_uniforms(3, 7, 5, 4)
    np.testing.assert_array_equal(a, event_uniforms(3, 7, 5, 4))
    assert a.shape == (4,) and ((a >= 0) & (a < 1)).all()
    for other in (event_uniforms(4, 7, 5, 4), event_uniforms(3, 8, 5, 4),
                  event_uniforms(3, 7, 6, 4)):
        assert not np.array_equal(a, other)
    # the draws of one event never reach the next event's
    assert not np.isin(event_uniforms(3, 7, 6, 64),
                       event_uniforms(3, 7, 5, 64)).any()


# ==========================================================================
# attention: draft, verify write, both verify branches
# ==========================================================================

def test_draft_attention_matches_jax():
    rng = np.random.default_rng(2)
    B, W, H, KV, D, Sc = 3, 4, 4, 2, 8, 10
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kw, vw = (rng.standard_normal((B, W, KV, D)).astype(np.float32)
              for _ in range(2))
    kc, vc = (rng.standard_normal((B, Sc, KV, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 4, 7], np.int32)
    for j in range(W):
        want = jattn.draft_attention(*(jnp.asarray(a) for a in
                                       (q, kw, vw, kc, vc, pos)), j)
        got = tattn.draft_attention(*(_t(a) for a in (q, kw, vw, kc, vc,
                                                      pos)), j)
        close(got.numpy(), want)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_verify_write_matches_jax(window):
    rng = np.random.default_rng(window)
    NB, bs, KV, D, B, S = 9, 4, 2, 8, 3, 3
    pool_k, pool_v = (rng.standard_normal((NB + 1, bs, KV, D)).astype(
        np.float32) for _ in range(2))
    kw, vw = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
              for _ in range(2))
    table = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    pos = np.array([2, 5, 1], np.int32)
    jk, jv = jattn.paged_verify_write(
        *(jnp.asarray(a) for a in (pool_k, pool_v, kw, vw, table, pos)),
        page_span=12, window=window)
    tk, tv = _t(pool_k), _t(pool_v)
    tattn.paged_verify_write(tk, tv, _t(kw), _t(vw), _t(table), _t(pos),
                             page_span=12, window=window)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_verify_branches_match_jax(layout):
    """``apply_attention`` with S = 3 against a cache: paged (pool + block
    table) and slotted (per-row rows); the output and the cache after the
    window's write."""
    rng = np.random.default_rng(11)
    B, S, Sc, KV, D = 3, 3, 12, JCFG.n_kv_heads, JCFG.head_dim_
    x = rng.standard_normal((B, S, JCFG.d_model)).astype(np.float32)
    pos = np.array([0, 4, 9], np.int32)
    positions = pos[:, None] + np.arange(S)[None]
    jp = _layer0(JPARAMS["blocks"]["pos0"]["attn"])
    tp = {n: _t(a) for n, a in jp.items()}
    kw = {}
    if layout == "paged":
        bs = 4
        cache = {n: rng.standard_normal((B * 3 + 1, bs, KV, D)).astype(
            np.float32) for n in ("k", "v")}
        table = (np.arange(B * 3).reshape(B, 3) + 1).astype(np.int32)
        kw = dict(block_table=table, page_span=Sc)
    else:
        cache = {n: rng.standard_normal((B, Sc, KV, D)).astype(np.float32)
                 for n in ("k", "v")}
    jout, jcache = jattn.apply_attention(
        jp, JCFG, jnp.asarray(x), jnp.asarray(positions),
        cache={n: jnp.asarray(a) for n, a in cache.items()},
        cache_pos=jnp.asarray(pos), return_cache=True,
        **{k: (jnp.asarray(v) if k == "block_table" else v)
           for k, v in kw.items()})
    tcache = {n: _t(a) for n, a in cache.items()}
    tout, _ = tattn.apply_attention(
        tp, TCFG, _t(x), _t(positions), cache=tcache, cache_pos=_t(pos),
        return_cache=True, **{k: (_t(v) if k == "block_table" else v)
                              for k, v in kw.items()})
    close(tout.numpy(), jout)
    for n in ("k", "v"):
        close(tcache[n].numpy(), jcache[n])


# ==========================================================================
# the model: multi-token and slotted decode steps, the draft window
# ==========================================================================

PROMPT_LEN, LENS = 7, (7, 5, 6, 3)


def _caches(layout, slot_len=16):
    """Four rows prefilled with 7-token prompts at k = 2, then rolled back
    to LENS, in both packages' pools of ``layout``.  Returns (JAX cache,
    JAX tables or None, port cache, port tables or None, positions)."""
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, V, (4, PROMPT_LEN)).astype(np.int32)
    _, jpiece = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(prompts), k=2,
                               cache_len=slot_len)
    _, tpiece = tmodel.prefill(TCFG, TPARAMS, _t(prompts).long(), k=2)
    if layout == "paged":
        jpool = JPool(JCFG, 4, slot_len, block_size=4)
        tpool = BlockPool(TCFG, 4, slot_len, block_size=4, device="cpu")
    else:
        jpool = JSlotPool(JCFG, 4, slot_len)
        tpool = SlotPool(TCFG, 4, slot_len, device="cpu")
    for pool, piece in ((jpool, jpiece), (tpool, tpiece)):
        for s in range(4):
            pool.take(s)
            if layout == "paged":
                pool.reserve(s, slot_len)
        pool.write(range(4), piece, [PROMPT_LEN] * 4)
        for s, n in enumerate(LENS):
            pool.truncate_to(s, n)
    jt = jnp.asarray(jpool.block_table) if layout == "paged" else None
    tt = tpool.tables() if layout == "paged" else None
    return jpool, jt, tpool, tt, np.asarray(LENS, np.int32)


@pytest.mark.parametrize("layout", ["paged", "slotted"])
@pytest.mark.parametrize("S", [1, 4])
def test_decode_step_matches_jax(layout, S):
    """One decode step of S tokens per row at per-row positions, tiers
    (2, 2, 1, 1), row 2 masked: logits within 1e-5 and the cache after."""
    jpool, jt, tpool, tt, pos = _caches(layout)
    if layout == "paged":
        for _ in range(S):
            for pool in (jpool, tpool):
                pool.prepare_decode(range(4))
                pool.advance(range(4))
    toks = np.random.default_rng(S).integers(0, V, (4, S)).astype(np.int32)
    jt = jnp.asarray(jpool.block_table) if layout == "paged" else None
    tt = tpool.tables() if layout == "paged" else None
    paged = dict(page_span=16) if layout == "paged" else {}
    mask = np.array([1, 1, 0, 1], np.float32)
    jl, jc = jmodel.decode_step(
        JCFG, JPARAMS, jpool.cache, jnp.asarray(toks), jnp.asarray(pos),
        k=(2, 2, 1, 1), slot_mask=jnp.asarray(mask), block_table=jt,
        dispatch="ragged", **paged)
    tl, tc = tmodel.decode_step(
        TCFG, TPARAMS, tpool.cache, _t(toks).long(), _t(pos), k=(2, 2, 1, 1),
        slot_mask=_t(mask), block_table=tt, **paged)
    close(tl.numpy(), jl)
    for n in ("k", "v"):
        close(tc["pos0"]["attn"][n].numpy(), jc["pos0"]["attn"][n])


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_draft_window_matches_jax(layout):
    """Three greedy draft steps at k = 1 from per-row positions: the draft
    tokens exactly, the fp32 draft logits within 1e-5, and the cache left
    as it was (the draft writes only its window buffer)."""
    jpool, jt, tpool, tt, pos = _caches(layout)
    W = 3
    paged = dict(page_span=16) if layout == "paged" else {}
    tok0 = np.random.default_rng(9).integers(0, V, (4, 1)).astype(np.int32)
    jq, jtoks = jmodel.draft_window(
        JCFG, JPARAMS, jpool.cache, jnp.asarray(tok0), jnp.asarray(pos),
        jnp.zeros((W, 4, 2), jnp.uint32),
        sample_fn=lambda lg, _k: jnp.argmax(lg, -1).astype(jnp.int32),
        window=W, k=1, block_table=jt, dispatch="ragged", **paged)
    before = {n: a.clone() for n, a in tpool.cache["pos0"]["attn"].items()}
    tq, ttoks = tmodel.draft_window(
        TCFG, TPARAMS, tpool.cache, _t(tok0).long(), _t(pos),
        torch.zeros(W, 4), sample_fn=lambda lg, _u: lg.argmax(-1),
        window=W, k=1, block_table=tt, **paged)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    close(tq.numpy(), jq)
    for n, a in tpool.cache["pos0"]["attn"].items():
        assert torch.equal(a, before[n]), f"the draft wrote the cache ({n})"


# ==========================================================================
# the engine: greedy speculation against the JAX engine and plain decode
# ==========================================================================

ENGINE_KW = dict(num_slots=4, slot_len=24, slot_k=(4, 4, 2, 1), block_size=4)


def _trace(cls, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, V, (int(rng.choice((5, 8))),))
                .astype(np.int32), max_new_tokens=int(rng.integers(6, 12)),
                k=(4, 2, 1)[i % 3]) for i in range(n)]


@pytest.fixture(scope="module")
def greedy_runs():
    """Greedy speculative engines (W = 3, draft_k = 1) in both packages on
    both layouts, and the port's plain paged engine, on one mixed-tier
    trace with more requests than slots."""
    spec = dict(window=3, draft_k=1)
    out = {"plain": ServingEngine(TCFG, TPARAMS, **ENGINE_KW).run(
        _trace(Request))}
    for layout in ("paged", "slotted"):
        # the paged engines also carry a tracer and a metrics registry
        obs = {"jax": {}, "port": {}}
        if layout == "paged":
            obs = {"jax": dict(tracer=JTracer(), metrics=JRegistry()),
                   "port": dict(tracer=Tracer(), metrics=MetricsRegistry())}
        out["jax", layout] = JEngine(
            JCFG, JPARAMS, kv_layout=layout, speculative=JSpec(**spec),
            **obs["jax"], **ENGINE_KW).run(_trace(JRequest))
        eng = ServingEngine(TCFG, TPARAMS, kv_layout=layout,
                            speculative=SpeculativeConfig(**spec),
                            **obs["port"], **ENGINE_KW)
        out["port", layout] = eng.run(_trace(Request))
        out["pool", layout] = eng.pool
        out["obs", layout] = obs
    return out


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_greedy_spec_engine_matches_jax_and_plain(greedy_runs, layout):
    j, t = greedy_runs["jax", layout], greedy_runs["port", layout]
    _assert_same_tokens(j.tokens_by_rid(), t.tokens_by_rid())
    _assert_same_tokens(greedy_runs["plain"].tokens_by_rid(),
                        t.tokens_by_rid())
    for key in ("spec_rounds", "spec_drafted", "spec_accepted"):
        assert getattr(t, key) == getattr(j, key), key
    assert 0 < t.spec_accepted < t.spec_drafted
    assert len(t.draft_step_s) == len(t.verify_step_s) == t.spec_rounds
    assert len(t.decode_step_s) == len(j.decode_step_s)
    summ = t.summary()
    assert summ["acceptance_rate"] == t.spec_accepted / t.spec_drafted
    assert summ["draft_step_ms_p50"] is not None
    pool = greedy_runs["pool", layout]
    assert pool.num_free == 4
    if layout == "paged":
        pool.check_invariants()
        assert pool.blocks_in_use == 0


def test_spec_spans_and_metrics_match_jax(greedy_runs):
    """The draft and verify spans (one each per round, valid Chrome trace)
    and the registry: every counter and gauge equal to the JAX engine's,
    the draft / verify histograms with one observation per round."""
    obs = greedy_runs["obs", "paged"]
    rounds = greedy_runs["port", "paged"].spec_rounds
    names = {}
    for side in ("jax", "port"):
        trace = obs[side]["tracer"].to_dict()
        # the reference's spans (the port's layer spans left out)
        names[side] = sorted(e["name"] for e in trace["traceEvents"]
                             if e["ph"] == "X" and e["pid"] == 1
                             and e.get("cat") != "layer")
    assert names["port"] == names["jax"]
    assert names["port"].count("draft") == names["port"].count(
        "verify") == rounds
    assert validate_chrome_trace(obs["port"]["tracer"].to_dict()) == []
    js, ts = (obs[side]["metrics"].snapshot() for side in ("jax", "port"))
    assert sorted(js) == sorted(ts)
    for name in js:
        if js[name]["type"] == "histogram":
            assert ts[name]["count"] == js[name]["count"], name
        else:
            assert ts[name] == js[name], name
    assert ts["serving.draft_step_ms"]["count"] == rounds
    assert ts["serving.verify_step_ms"]["count"] == rounds


def test_k1_slots_accept_every_draft():
    """A slot at tier k = 1 drafts at its own budget: at float32 its drafts
    are the verify step's own argmaxes, so every draft is accepted."""
    eng = ServingEngine(TCFG, TPARAMS, num_slots=2, slot_len=24,
                        slot_k=(1, 1), block_size=4,
                        speculative=SpeculativeConfig(window=4, draft_k=1))
    rep = eng.run([r for r in _trace(Request) if r.k == 1])
    assert rep.spec_drafted > 0 and rep.spec_accepted == rep.spec_drafted


def test_spec_with_prefix_cache_and_preemption_matches_plain():
    """Speculation composes with the traffic layer: a prefix-cached,
    preempting engine (a closed batch; SLO targets missed at arrival for
    k = 4, never for k = 1, so k = 4 waiters swap k = 1 requests out) gives
    the tokens of the same engine without speculation.  Prompts share an
    8-token head, and each odd request repeats the one before it, so the
    pair shares its partial tail block and the window's first write into
    it copies the block (copy-on-write).  The pool stays consistent."""
    rng = np.random.default_rng(4)
    head = rng.integers(0, V, (8,)).astype(np.int32)

    def reqs():
        r = np.random.default_rng(6)
        out = []
        for i in range(8):
            p = np.concatenate([head, r.integers(
                0, V, (int(r.choice((2, 5))),))]).astype(np.int32)
            out.append(Request(rid=i, prompt=out[-1].prompt if i % 2 else p,
                               max_new_tokens=int(r.integers(6, 10)),
                               k=(4, 4, 1, 1)[i % 4]))
        return out
    kw = dict(num_slots=4, slot_len=24, slot_k=(4, 4, 1, 1), block_size=4,
              prefix_cache=True, preemption=True,
              slo_ms={4: 0.0, 1: 60000.0})
    plain = ServingEngine(TCFG, TPARAMS, **kw).run(reqs())
    eng = ServingEngine(TCFG, TPARAMS, speculative=SpeculativeConfig(3, 1),
                        **kw)
    rep = eng.run(reqs())
    _assert_same_tokens(plain.tokens_by_rid(), rep.tokens_by_rid())
    assert rep.prefix["hit_tokens"] > 0 and rep.spec_rounds > 0
    assert rep.prefix["cow_copies"] > 0 and rep.preemptions >= 1
    assert eng.pool.swap_outs == eng.pool.swap_ins == rep.preemptions
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0


def test_rollback_open_leaves_only_the_verified_prefix():
    """A slot preempted while its draft window is open (positions advanced
    past the last verified token) is rolled back to the window base before
    the swap: the swap state holds the verified prefix only, and the
    resumed request continues token for token as an unpreempted one."""
    kw = dict(num_slots=2, slot_len=24, slot_k=(2, 1), block_size=4,
              preemption=True, slo_ms={2: 0.0, 1: 60000.0})
    req = _trace(Request)[1]                     # a k = 2 request
    eng = ServingEngine(TCFG, TPARAMS, speculative=SpeculativeConfig(3, 1),
                        **kw)
    solo = ServingEngine(TCFG, TPARAMS, **kw).run([_trace(Request)[1]])
    report = ServingReport(completions=[])
    eng._t0 = 0.0
    eng.scheduler.add(req)
    eng._admit(report)
    slot = next(s for s, a in enumerate(eng._active) if a is not None)
    base = int(eng.pool.cache_pos[slot])
    spec = eng._spec
    spec._open[slot] = base                      # a window opened ...
    for _ in range(3):                           # ... and advanced into
        eng.pool.prepare_decode([slot])
        eng.pool.advance([slot])
    eng._preempt(slot, report)
    state = eng._swapped[req.rid][0]
    assert state["cache_pos"] == base
    assert state["n_blocks"] == -(-base // 4)
    assert slot not in spec._open
    eng.pool.check_invariants()
    # resume it through admission and finish it
    eng._admit(report)
    while eng.n_active:
        spec.round(report)
    got = {c.rid: c.tokens for c in report.completions}
    np.testing.assert_array_equal(got[req.rid], solo.tokens_by_rid()[req.rid])


# ==========================================================================
# rollback: a speculative round leaves the pool as a straight decode
# ==========================================================================

_ROLLBACK_CASES = [(n, w, a, bs) for n in (1, 3, 8) for w in (1, 2, 4)
                   for a in range(w + 1) for bs in (1, 4)]


def _pool_state(pool, s):
    return (int(pool.cache_pos[s]), int(pool._nalloc[s]),
            pool.block_table[s].tolist(), sorted(pool._free_blocks),
            pool.blocks_in_use)


@pytest.mark.parametrize("n_prefill,W,acc,block_size", _ROLLBACK_CASES)
def test_rollback_matches_straight_decode(n_prefill, W, acc, block_size):
    """A speculative round (W draft advances, the verify position, then
    ``truncate_to`` or ``advance``) leaves the port's pool as a straight
    decode of the accepted prefix leaves it, a bystander row untouched,
    and op for op as the reference's pool leaves it."""
    states = {}
    for name, cls, kw in (("port", BlockPool, dict(device="cpu")),
                          ("jax", JPool, {})):
        for kind in ("spec", "straight"):
            pool = cls(JCFG if name == "jax" else TCFG, num_slots=3,
                       slot_len=24, block_size=block_size, **kw)
            by = pool.allocate()
            pool.reserve(by, 8)
            pool.alloc_prompt(by, 5)
            pool.cache_pos[by] = 5
            s = pool.allocate()
            pool.reserve(s, n_prefill + W + 2)
            pool.alloc_prompt(s, n_prefill)
            pool.cache_pos[s] = n_prefill
            bystander = pool.block_table[by].copy()
            if kind == "spec":
                for _ in range(W):
                    pool.prepare_decode([s])
                    pool.advance([s])
                pool.prepare_decode([s])
                if acc == W:
                    pool.advance([s])
                else:
                    pool.truncate_to(s, n_prefill + acc + 1)
            else:
                for _ in range(acc + 1):
                    pool.prepare_decode([s])
                    pool.advance([s])
            pool.check_invariants()
            assert (pool.block_table[by] == bystander).all()
            states[name, kind] = _pool_state(pool, s)
    sp, st = states["port", "spec"], states["port", "straight"]
    assert sp[0] == st[0] == n_prefill + acc + 1
    assert sp[1] == st[1] and sp[3:] == st[3:]
    assert sp[2][:sp[1]] == st[2][:st[1]]
    assert states["port", "spec"] == states["jax", "spec"]


# ==========================================================================
# sampled decoding: reproducible by seed, independent of the layout
# ==========================================================================

@pytest.fixture(scope="module")
def sampled_runs():
    sc = SamplerConfig(kind="top_p", temperature=0.8, top_p=0.9)
    out = {}
    for spec in (None, SpeculativeConfig(window=2, draft_k=1)):
        for layout, seed in (("paged", 11), ("paged", 11), ("slotted", 11),
                             ("paged", 12)):
            eng = ServingEngine(TCFG, TPARAMS, kv_layout=layout, sampler=sc,
                                seed=seed, speculative=spec, **ENGINE_KW)
            out.setdefault((spec is not None, layout, seed), []).append(
                eng.run(_trace(Request)).tokens_by_rid())
    return out


@pytest.mark.parametrize("speculative", [False, True])
def test_sampled_reproducible_and_layout_independent(sampled_runs,
                                                     speculative):
    """A request's draws depend only on (seed, rid, its event counter):
    the same seed gives the same tokens, the slotted layout the paged
    layout's, and another seed other tokens."""
    a, b = sampled_runs[speculative, "paged", 11]
    _assert_same_tokens(a, b)
    _assert_same_tokens(a, sampled_runs[speculative, "slotted", 11][0])
    other = sampled_runs[speculative, "paged", 12][0]
    assert any(not np.array_equal(a[r], other[r]) for r in a)


def test_sampled_first_tokens_follow_the_sampler():
    """The engine's prefill draw follows ``sampler_probs`` of the prefill
    logits: 400 requests of one prompt (their draws keyed by rid), the
    first token's histogram against the analytic distribution."""
    sc = SamplerConfig(kind="temperature", temperature=1.5)
    prompt = np.arange(5, dtype=np.int32)
    n = 400
    eng = ServingEngine(TCFG, TPARAMS, num_slots=8, slot_len=8,
                        block_size=4, sampler=sc, seed=1)
    rep = eng.run([Request(rid=i, prompt=prompt, max_new_tokens=1)
                   for i in range(n)])
    firsts = np.array([c.tokens[0] for c in rep.completions])
    logits, _ = tmodel.prefill(TCFG, TPARAMS, _t(prompt[None]).long(),
                               k=JCFG.moe.top_k)
    p = sampler_probs(logits[0, 0], sc).double().numpy()
    top = np.argsort(-p)[:4]
    for t in top:            # the likeliest tokens, within 4.5 sigma
        sd = np.sqrt(p[t] * (1 - p[t]) / n)
        assert abs((firsts == t).mean() - p[t]) < 4.5 * sd + 1e-9, t


# ==========================================================================
# the slotted pool: differential, misuse, interleavings
# ==========================================================================

def _mixed_trace(cls, n, seed):
    """Mixed lengths and tiers; half the requests teacher-forced (NLL)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_new = int(rng.choice((2, 5)))
        forced = (rng.integers(0, V, (n_new,)).astype(np.int32)
                  if rng.random() < 0.5 else None)
        out.append(cls(rid=i, prompt=rng.integers(
            0, V, (int(rng.choice((4, 8))),)).astype(np.int32),
            max_new_tokens=n_new, k=int(rng.choice((1, 2, 4))),
            forced=forced))
    return out


def test_paged_slotted_differential_matches_jax():
    """The reference's paged-vs-slotted differential on the port: mixed
    lengths and tiers {1, 2, 4}, half the requests forced; the port's
    slotted engine gives the port's paged engine's and the JAX slotted
    engine's tokens, and their NLLs within 1e-5."""
    kw = dict(num_slots=6, slot_len=16, slot_k=(1, 1, 2, 2, 4, 4))
    paged = ServingEngine(TCFG, TPARAMS, block_size=4, **kw).run(
        _mixed_trace(Request, 12, 7))
    slotted = ServingEngine(TCFG, TPARAMS, kv_layout="slotted", **kw)
    rs = slotted.run(_mixed_trace(Request, 12, 7))
    js = JEngine(JCFG, JPARAMS, kv_layout="slotted", **kw).run(
        _mixed_trace(JRequest, 12, 7))
    for want in (paged, js):
        _assert_same_tokens(want.tokens_by_rid(), rs.tokens_by_rid())
        np.testing.assert_allclose([c.nll_sum for c in rs.completions],
                                   [c.nll_sum for c in want.completions],
                                   rtol=1e-5, atol=1e-5)
    assert slotted.pool.num_free == 6


def test_slot_pool_misuse_raises():
    pool = SlotPool(TCFG, num_slots=2, slot_len=8, device="cpu")
    pool.take(0)
    with pytest.raises(ValueError, match="not free"):
        pool.take(0)                                 # double take
    with pytest.raises(ValueError, match="claimed"):
        pool.release(1)                              # release a free slot
    _, piece = tmodel.prefill(TCFG, TPARAMS, torch.zeros(1, 4).long(), k=2)
    with pytest.raises(ValueError, match="free"):
        pool.write([1], piece, [4])                  # write to a free slot
    with pytest.raises(ValueError, match="starts"):
        pool.write([0], piece, [4], starts=[0])      # no prefix to attach
    pool.take(1)
    with pytest.raises(RuntimeError, match="no free rows"):
        pool.allocate()                              # beyond the pool
    with pytest.raises(ValueError, match="holds only"):
        pool.truncate_to(0, 3)                       # grow by rollback
    assert pool.num_free == 0
    pool.release(0), pool.release(1)
    assert pool.free_slots == [0, 1]


@pytest.mark.parametrize("seed", range(15))
def test_slot_pool_interleavings_match_reference(seed):
    """The reference's seeded walk of take / advance / release on the
    slotted pool, driven op for op on the port's and the JAX pool: free
    lists and positions equal after every op, no slot both live and
    free, none leaked."""
    rng = np.random.default_rng(seed)
    tp = SlotPool(TCFG, 4, slot_len=16, device="cpu")
    jp = JSlotPool(JCFG, 4, slot_len=16)
    active = set()
    for _ in range(80):
        op = int(rng.integers(0, 3))
        if op == 0 and tp.num_free:
            slot = int(rng.choice(tp.free_slots))
            pos = int(rng.integers(1, 16))
            for p in (tp, jp):
                p.take(slot)
                p.cache_pos[slot] = pos
            active.add(slot)
        elif op == 1 and active:
            slot = int(rng.choice(sorted(active)))
            tp.advance([slot]), jp.advance([slot])
        elif op == 2 and active:
            slot = int(rng.choice(sorted(active)))
            tp.release(slot), jp.release(slot)
            assert tp.cache_pos[slot] == 0
            active.remove(slot)
        free = tp.free_slots
        assert free == jp.free_slots
        assert tp.cache_pos.tolist() == jp.cache_pos.tolist()
        assert len(set(free)) == len(free) and not active & set(free)
        assert len(active) + len(free) == 4


# ==========================================================================
# guards and the launcher
# ==========================================================================

def test_spec_guards():
    """The reference's guards, with its errors."""
    spec = SpeculativeConfig(window=2, draft_k=1)
    kw = dict(num_slots=2, slot_len=16)
    with pytest.raises(ValueError, match="window"):
        SpeculativeConfig(window=0)
    with pytest.raises(ValueError, match="draft_k"):
        SpeculativeConfig(draft_k=0)
    with pytest.raises(ValueError, match="draft_k"):
        ServingEngine(TCFG, TPARAMS, speculative=SpeculativeConfig(
            draft_k=99), **kw)
    dense = dataclasses.replace(TCFG, moe=dataclasses.replace(
        TCFG.moe, num_experts=0), d_ff=64)
    with pytest.raises(ValueError, match="no cheaper draft"):
        ServingEngine(dense, TPARAMS, speculative=spec, **kw)
    with pytest.raises(ValueError, match="loss-free"):
        ServingEngine(TCFG, TPARAMS, dispatch="capacity", speculative=spec,
                      **kw)
    with pytest.raises(ValueError, match="non-wrapping"):
        ServingEngine(TCFG.replace(attention_window=4), TPARAMS,
                      speculative=spec, **kw)
    with pytest.raises(ValueError, match="expert_telemetry"):
        ServingEngine(TCFG, TPARAMS, speculative=spec,
                      expert_telemetry=True, **kw)
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(TCFG, TPARAMS, kv_layout="ring", **kw)
    eng = ServingEngine(TCFG, TPARAMS, speculative=spec, **kw)
    bad = Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=4,
                  forced=np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="teacher-forced"):
        eng.run([bad])


def test_serve_launcher_speculative_slotted(capsys):
    tserve.main(["--local", "--device", "cpu", "--requests", "5",
                 "--new-tokens", "6", "--slots", "4", "--mix",
                 "2:0.5,1:0.5", "--speculate", "--window", "3",
                 "--draft-k", "1", "--kv-layout", "slotted"])
    out = capsys.readouterr().out
    assert "slotted KV pool" in out and "speculative W=3 draft_k=1" in out
    assert "gen_tokens: 30" in out and "spec_rounds:" in out
