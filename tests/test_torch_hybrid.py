"""The SSM and hybrid families on the port — ``mamba2-780m`` (attention-
free, 48 Mamba-2 blocks) and ``jamba-v0.1-52b`` (Mamba and attention
layers in a repeating pattern, MoE on every second layer) — against the
JAX package at float32 on the CPU.

Both SMOKE configs at ``dtype="float32"``, the JAX side on its
``backend="reference"`` path: ``mamba2-smoke`` (2 Mamba blocks) and
``jamba-smoke`` (period 2: a Mamba block with a dense FFN, then attention
with a 4-expert top-2 MoE; 2 periods).  Weights come from the port's
seeded ``init_params`` / ``init_lora``, handed to both packages as numpy;
the adapter's ``b`` factors are drawn off zero.  Tolerances: every path
here runs the chunked SSD scan, whose cumulative sums and contraction
orders reorder fp32 additions, so logits, caches and relative L2 of the
gradients are held within 1e-4 (1e-5 where no scan runs: the converted
trees are bit-exact, routing counts and greedy tokens equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import KernelConfig
from repro.core import lora as jlora
from repro.models import model as jmodel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.kv_cache import BlockPool as JBlockPool
from repro_torch import configs as tconfigs
from repro_torch.configs import registry as treg
from repro_torch.convert import (config_from_jax, lora_from_jax,
                                 params_from_jax, rescalers_from_jax,
                                 to_numpy)
from repro_torch.core import lora as tlora
from repro_torch.models import model as tmodel
from repro_torch.serving import BlockPool, Request, ServingEngine
from repro_torch.serving.speculative import SpeculativeConfig
from repro_torch.tree import leaves

ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]
TOL = 1e-4          # the SSD scan reorders fp32 additions


def _fill_b(tree, rng, std=0.05):
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, std, np.shape(v)).astype(np.float32)
                    if k == "b" else _fill_b(v, rng, std))
                for k, v in tree.items()}
    return np.asarray(tree)


class Case:
    """One arch's SMOKE config at fp32, its weights, adapter, rescalers
    (one per MoE position, at k_i = 1) and inputs in both packages."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg = jreg.get_config(arch, "smoke").replace(
            dtype="float32", kernels=KernelConfig(backend="reference"))
        self.tcfg = config_from_jax(self.jcfg)
        self.np_params = to_numpy(tmodel.init_params(
            self.tcfg, torch.Generator().manual_seed(0), "cpu"))
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)
        self.tparams = params_from_jax(self.np_params, device="cpu")
        self.np_lora = _fill_b(to_numpy(tlora.init_lora(
            torch.Generator().manual_seed(1), self.tcfg, self.tparams)),
            np.random.default_rng(0))
        resc = tlora.init_rescalers(self.tcfg, 1, device="cpu")
        self.np_resc = None if resc is None else {
            k: v.numpy() * np.float32(1.1) for k, v in resc.items()}
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.jcfg.vocab_size,
                                   (2, 40)).astype(np.int32)
        self.labels = np.roll(self.tokens, -1, axis=1)
        self.k = self.jcfg.moe.top_k or None

    def trainable(self, torch_side: bool):
        t = {"lora": (lora_from_jax(self.np_lora, device="cpu")
                      if torch_side else
                      jax.tree.map(jnp.asarray, self.np_lora))}
        if self.np_resc is not None:
            t["rescaler"] = ({k: torch.tensor(v) for k, v in
                              self.np_resc.items()} if torch_side else
                             {k: jnp.asarray(v) for k, v in
                              self.np_resc.items()})
        return t


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def close(got, want, tol=TOL):
    if torch.is_tensor(got):
        got = to_numpy(got)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_variants_match_the_reference(arch):
    for variant in ("full", "smoke", "swa"):
        assert tconfigs.get_config(arch, variant) == config_from_jax(
            jreg.get_config(arch, variant)), variant
    assert treg.long_context_variant(arch) == \
        jreg.long_context_variant(arch)
    swa = tconfigs.get_config(arch, "swa")
    full = tconfigs.get_config(arch, "full")
    if arch == "mamba2-780m":       # attention-free: natively sub-quadratic
        assert swa == full and treg.long_context_variant(arch) == "full"
    else:                           # a window on the 4 attention layers
        assert swa == full.replace(attention_window=8192)
        assert sum(full.layer_kind(i) == "attn"
                   for i in range(full.num_layers)) == 4
        assert full.pattern_period == 8
        assert [full.layer_is_moe(j) for j in range(8)] == [
            False, True] * 4


def test_trees_match_the_reference_layout_and_convert_bit_exactly(case):
    want = jax.eval_shape(lambda key: jmodel.init_params(key, case.jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), case.tparams) == \
        jax.tree.map(lambda a: a.shape, want)
    assert jax.tree.map(lambda t: t.dtype.name, case.np_params) == \
        jax.tree.map(lambda a: a.dtype.name, want)
    lora = jax.eval_shape(lambda key: jlora.init_lora(
        key, case.jcfg, jmodel.init_params(key, case.jcfg)),
        jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, case.np_lora) == jax.tree.map(
        lambda a: a.shape, lora)
    jresc = jlora.init_rescalers(case.jcfg, 1)
    if jresc is None:
        assert case.np_resc is None
    else:                            # one rescaler per MoE position
        assert sorted(case.np_resc) == sorted(jresc) == [
            f"pos{j}" for j in range(case.jcfg.pattern_period)
            if case.jcfg.layer_is_moe(j)]
        got = rescalers_from_jax({1: jax.tree.map(np.asarray, jresc)},
                                 device="cpu")[1]
        for key in jresc:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(jresc[key]))
    for got, want in ((to_numpy(params_from_jax(case.np_params, "cpu")),
                       case.np_params),
                      (to_numpy(lora_from_jax(case.np_lora, "cpu")),
                       case.np_lora)):
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (_, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_array_equal(g, w)
    ssm = case.tparams["blocks"]["pos0"]["ssm"]
    assert set(ssm) == {"in_proj", "conv_w", "conv_b", "dt_bias", "A_log",
                        "D", "norm", "out_proj"}
    assert set(to_numpy(lora_from_jax(case.np_lora, "cpu"))["blocks"][
        "pos0"]["ssm"]) == {"in_proj", "out_proj"}


# ---------------------------------------------------------------- model

def test_forward_logits_and_counts_match_jax(case):
    jlog, jcounts = jax.jit(lambda p, t, tr: jmodel.forward(
        case.jcfg, p, t, trainable=tr, k=case.k))(
        case.jparams, jnp.asarray(case.tokens), case.trainable(False))
    tlog, tcounts = tmodel.forward(case.tcfg, case.tparams,
                                   torch.tensor(case.tokens),
                                   trainable=case.trainable(True), k=case.k)
    close(tlog, jlog)
    assert set(tcounts) == set(jcounts)
    for key in jcounts:
        np.testing.assert_array_equal(tcounts[key].numpy(),
                                      np.asarray(jcounts[key]))


def test_lm_loss_lora_and_rescaler_grads_match_jax(case):
    def jloss(tr, params, tokens, labels):
        return jmodel.lm_loss(case.jcfg, params, tokens, labels,
                              trainable=tr, k=case.k)[0]

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(
        case.trainable(False), case.jparams, jnp.asarray(case.tokens),
        jnp.asarray(case.labels))
    tr = case.trainable(True)
    flat = [t.requires_grad_(True) for t in leaves(tr)]
    tval, _ = tmodel.lm_loss(case.tcfg, case.tparams,
                             torch.tensor(case.tokens),
                             torch.tensor(case.labels), trainable=tr,
                             k=case.k, remat=True)
    tgrads = torch.autograd.grad(tval, flat)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=TOL)
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(tgrads)
    n_resc = 0
    for g, w in zip(tgrads, jflat):
        w = np.asarray(w)
        n_resc += w.ndim == 1
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= TOL, rel
    assert n_resc == (0 if case.np_resc is None else len(case.np_resc))


def test_prefill_then_decode_matches_jax_and_the_forward(case):
    """Prefill 33 tokens (chunk 33: no power of two divides it), then 7
    slotted decode steps: logits and every cache leaf against JAX's
    prefill/decode_step, and the logits against one 40-token forward."""
    toks, S0 = case.tokens, 33
    tr_t, tr_j = case.trainable(True), case.trainable(False)
    tl, tc = tmodel.prefill(case.tcfg, case.tparams,
                            torch.tensor(toks[:, :S0]), trainable=tr_t,
                            k=case.k, cache_len=48)
    jl, jc = jmodel.prefill(case.jcfg, case.jparams,
                            jnp.asarray(toks[:, :S0]), trainable=tr_j,
                            k=case.k, cache_len=48)
    close(tl, jl)
    assert jax.tree.map(np.shape, to_numpy(tc)) == jax.tree.map(
        np.shape, jax.tree.map(np.asarray, jc))
    for key in jc:
        if "ssm" in jc[key]:        # conv in the model's dtype, ssm fp32
            assert tc[key]["ssm"]["ssm"].dtype == torch.float32
    # install into the slotted cache as SlotPool.write does (fp32 rows)
    cache = tmodel.init_cache(case.tcfg, 2, 48, device="cpu")
    for key, c in cache.items():
        for part, lv in c.items():
            for leaf, t in lv.items():
                src = tc[key][part][leaf]
                t[:, :, :src.shape[2]] = src.to(t.dtype)
    jcache = jc
    jdec = jax.jit(lambda p, c, t, pos, tr: jmodel.decode_step(
        case.jcfg, p, c, t, pos, trainable=tr, k=case.k))
    outs = [tl]
    for t in range(S0, toks.shape[1]):
        pos = np.full((2,), t, np.int32)
        tl, cache = tmodel.decode_step(case.tcfg, case.tparams, cache,
                                       torch.tensor(toks[:, t:t + 1]),
                                       torch.tensor(pos), trainable=tr_t,
                                       k=case.k)
        jl, jcache = jdec(case.jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(pos), tr_j)
        close(tl, jl)
        outs.append(tl)
    for (_, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(to_numpy(cache))[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, jcache))[0]):
        close(g, w)
    full, _ = tmodel.forward(case.tcfg, case.tparams, torch.tensor(toks),
                             trainable=tr_t, k=case.k)
    close(torch.cat(outs, dim=1), to_numpy(full)[:, S0 - 1:])


def test_paths_that_cannot_hold_an_ssm_state_refuse(case):
    cfg, p = case.tcfg, case.tparams
    cache = tmodel.init_cache(cfg, 2, 16, device="cpu")
    tok = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="attention-only"):
        tmodel.decode_step(cfg, p, cache, tok, torch.zeros(2))
    with pytest.raises(ValueError, match="attention-only"):
        tmodel.prefill_suffix(cfg, p, tok, [0, 0], [3, 3], cache,
                              torch.zeros((2, 1), dtype=torch.int32),
                              page_span=16)
    with pytest.raises(ValueError, match="attention-only"):
        tmodel.draft_window(cfg, p, cache, tok[:, :1], torch.zeros(2),
                            torch.zeros((2, 2)), sample_fn=None, window=2)
    if cfg.moe.enabled:
        with pytest.raises(ValueError, match="attention-only"):
            ServingEngine(cfg, p, num_slots=2, slot_len=16,
                          speculative=SpeculativeConfig(window=2, draft_k=1))
    else:
        # attention-free: the slotted pool, so no prefix cache or preemption
        eng = ServingEngine(cfg, p, num_slots=2, slot_len=16)
        assert not eng.paged
        for kw in ({"prefix_cache": True},
                   {"preemption": True, "slo_ms": {None: 1e3}}):
            with pytest.raises(ValueError, match="paged KV layout"):
                ServingEngine(cfg, p, num_slots=2, slot_len=16, **kw)
    # the model refuses nothing of a single-card arch now (audio codebooks
    # were the last): every registry arch builds its full-size tree
    for arch in tconfigs.list_archs():
        full = tconfigs.get_config(arch)
        tree = tmodel.init_params(full, torch.Generator(), "meta")
        K = (full.num_codebooks,) if full.num_codebooks else ()
        assert tree["embed"]["tokens"].shape == K + (full.vocab_size,
                                                     full.d_model), arch


# ---------------------------------------------------------------- serving

def _requests(cls, case, ks):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(
                0, case.jcfg.vocab_size, ((8, 13)[i % 2],)).astype(np.int32),
                max_new_tokens=4, k=ks[i % len(ks)])
            for i in range(6)]


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_engine_greedy_tokens_match_jax(case, layout):
    """Both engines on the same layout (the attention-free arch runs on
    the slotted pool under either), Jamba at two tiers on ragged
    dispatch: every request's greedy tokens equal."""
    kw = dict(num_slots=2, slot_len=24, block_size=4)
    ks = (None,)
    if case.jcfg.moe.enabled:
        kw["slot_k"] = ks = (case.jcfg.moe.top_k, 1)
    jeng = JEngine(case.jcfg, case.jparams, kv_layout=layout,
                   dispatch="ragged", **kw)
    jrep = jeng.run(_requests(JRequest, case, ks))
    eng = ServingEngine(case.tcfg, case.tparams, kv_layout=layout, **kw)
    trep = eng.run(_requests(Request, case, ks))
    assert eng.paged == jeng.paged == (layout == "paged"
                                       and case.jcfg.moe.enabled)
    jt, tt = jrep.tokens_by_rid(), trep.tokens_by_rid()
    assert sorted(jt) == sorted(tt) == list(range(6))
    for rid in jt:
        np.testing.assert_array_equal(tt[rid], jt[rid], err_msg=f"rid {rid}")
    assert eng.pool.kv_bytes() == jeng.pool.kv_bytes()
    if eng.paged:
        eng.pool.check_invariants()
        assert eng.pool.blocks_in_use == 0
        assert eng.pool.block_bytes() == jeng.pool.block_bytes()
        assert eng.pool.peak_kv_bytes() == jeng.pool.peak_kv_bytes()


def test_hybrid_prefix_cache_shares_blocks_but_prefills_in_full():
    """Jamba with the prefix cache: prompts with a shared 8-token head hit
    the block index (the pool matches at write), every prompt is
    prefilled in full (a Mamba state cannot start mid-prompt), and the
    tokens equal a cold engine's and the JAX engine's."""
    case = Case("jamba-v0.1-52b")
    head = np.random.default_rng(5).integers(0, 512, (8,)).astype(np.int32)

    def reqs(cls):
        rng = np.random.default_rng(6)
        return [cls(rid=i, prompt=np.concatenate([head, rng.integers(
            0, 512, (3 + i,)).astype(np.int32)]), max_new_tokens=3, k=2)
            for i in range(4)]

    kw = dict(num_slots=2, slot_len=24, block_size=4, slot_k=(2, 2))
    eng = ServingEngine(case.tcfg, case.tparams, prefix_cache=True, **kw)
    assert not eng._use_suffix
    rep = eng.run(reqs(Request))
    cold = ServingEngine(case.tcfg, case.tparams, **kw).run(reqs(Request))
    jrep = JEngine(case.jcfg, case.jparams, prefix_cache=True,
                   dispatch="ragged", **kw).run(reqs(JRequest))
    for rid, toks in rep.tokens_by_rid().items():
        np.testing.assert_array_equal(toks, cold.tokens_by_rid()[rid])
        np.testing.assert_array_equal(toks, jrep.tokens_by_rid()[rid])
    assert rep.prefill_tokens == cold.prefill_tokens
    assert rep.summary()["prefix_cache"] == jrep.summary()["prefix_cache"]
    assert rep.summary()["prefix_cache"]["hit_blocks"] > 0
    eng.pool.check_invariants()


def test_hybrid_preemption_resumes_the_ssm_rows_exactly():
    """Jamba on the paged pool with preemption (tier-2 targets missed at
    arrival, tier-1 never): swapped-out requests come back with their
    K/V pages and Mamba state rows, so every request's greedy tokens equal
    the same engine's without preemption."""
    case = Case("jamba-v0.1-52b")
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, 512, (int(rng.integers(5, 14)),))
             .astype(np.int32), (2, 1)[i % 2]) for i in range(8)]
    kw = dict(num_slots=2, slot_len=24, block_size=4, slot_k=(2, 1),
              slo_ms={2: 0.0, 1: 60_000.0})

    def run(**extra):
        eng = ServingEngine(case.tcfg, case.tparams, **kw, **extra)
        rep = eng.run([Request(rid=i, prompt=p, max_new_tokens=5, k=k)
                       for i, (p, k) in enumerate(reqs)])
        eng.pool.check_invariants()
        return rep

    pre = run(preemption=True)
    plain = run()
    assert pre.summary()["preemptions"] > 0
    for rid, toks in plain.tokens_by_rid().items():
        np.testing.assert_array_equal(pre.tokens_by_rid()[rid], toks,
                                      err_msg=f"rid {rid}")


def test_swap_round_trip_restores_the_ssm_rows():
    """Jamba's paged pool: a prefilled row swapped out and back into
    another slot holds the same K/V pages and Mamba state rows, and its
    swap state has the JAX pool's structure."""
    case = Case("jamba-v0.1-52b")
    cfg = case.tcfg
    _, piece = tmodel.prefill(cfg, case.tparams,
                              torch.tensor(case.tokens[:, :10]), k=case.k)
    pool = BlockPool(cfg, 3, 24, block_size=4, device="cpu")
    for s in (0, 1):
        pool.take(s)
        pool.reserve(s, 16)
    pool.write([0, 1], piece, [10, 10])
    before = to_numpy(pool.cache)
    row = {key: {leaf: before[key]["ssm"][leaf][:, 1].copy()
                 for leaf in ("conv", "ssm")}
           for key in before if "ssm" in before[key]}
    assert row and all(np.abs(r["ssm"]).max() > 0 for r in row.values())
    tbl = pool.block_table[1, :3].copy()
    pages = {key: {leaf: before[key]["attn"][leaf][:, tbl].copy()
                   for leaf in ("k", "v")}
             for key in before if "attn" in before[key]}
    state = pool.swap_out(1)
    jpool = JBlockPool(case.jcfg, 3, 24, block_size=4)
    jpool.take(1)
    jpool.reserve(1, 16)
    jpool.alloc_prompt(1, 10)
    jstate = jpool.swap_out(1)
    assert sorted(state["ssm"]) == sorted(jstate["ssm"]) == sorted(row)
    assert sorted(state["attn"]) == sorted(jstate["attn"])
    for key in state["ssm"]:
        for leaf in ("conv", "ssm"):
            assert state["ssm"][key][leaf].shape == \
                jstate["ssm"][key][leaf].shape
    pool.take(2)
    pool.reserve(2, 16)
    pool.swap_in(2, state)
    after = to_numpy(pool.cache)
    for key, r in row.items():
        for leaf in ("conv", "ssm"):
            np.testing.assert_array_equal(after[key]["ssm"][leaf][:, 2],
                                          r[leaf])
    tbl2 = pool.block_table[2, :3]
    for key, pg in pages.items():
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(after[key]["attn"][leaf][:, tbl2],
                                          pg[leaf])
    assert pool.cache_pos[2] == 10
    pool.check_invariants()

