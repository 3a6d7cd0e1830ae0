"""LoRA serving and the engine's dispatch modes: the port's ServingEngine
with ``lora=`` (the FLAME global adapter served unmerged) and with
``dispatch="dense" | "capacity"`` against the JAX engine, token for token.

Same weights and adapters (made by the JAX package, converted through
numpy), same numpy-made requests, float32 on the CPU, greedy.  The
adapter's ``b`` factors are drawn nonzero with numpy from a seed: a fresh
adapter (``b = 0``) is an exact no-op and would prove nothing, so each
engine case also checks that the adapter changes some request's tokens.
Teacher-forced NLLs agree within 1e-4 relative (float32 both sides, only
the summation order differs).
"""
import jax
import numpy as np
import pytest

from conftest import tiny_moe
from repro.core import lora as jlora
from repro.models import model as jmodel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import SpeculativeConfig as JSpec
from repro_torch.convert import (config_from_jax, lora_from_jax,
                                 params_from_jax, rescalers_from_jax)
from repro_torch.core import lora as tlora
from repro_torch.launch import serve as tserve
from repro_torch.serving import Request, ServingEngine, SpeculativeConfig

JCFG = tiny_moe()
TCFG = config_from_jax(JCFG)
JPARAMS = jmodel.init_params(jax.random.PRNGKey(1), JCFG)
TPARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
V = JCFG.vocab_size


def _fill_b(tree, rng, std):
    """The adapter tree with every ``b`` leaf drawn N(0, std²)."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, std, np.shape(v)).astype(np.float32)
                    if k == "b" else _fill_b(v, rng, std))
                for k, v in tree.items()}
    return np.asarray(tree)


def _adapter(seed=0, std=0.5):
    """A seeded adapter on q/k/v/o and every expert's w1/w2/w3: JAX's
    ``init_lora`` ``a`` factors, ``b`` drawn nonzero with numpy."""
    jl = jax.tree.map(np.asarray, jlora.init_lora(
        jax.random.PRNGKey(10 + seed), JCFG, JPARAMS))
    return _fill_b(jl, np.random.default_rng(seed), std)


LORA_NP = _adapter()
TLORA = lora_from_jax(LORA_NP, device="cpu")
R_BY_K = {k: {p: np.asarray(v) * (1.0 + 0.25 * k) for p, v in
              jlora.init_rescalers(JCFG, k).items()} for k in (1, 2)}


def _requests(cls, n=6, seed=0, lens=(8,), ks=(2, 1), prefix=0,
              forced=False):
    """Closed batch of ``n`` requests, tiers in turn; ``prefix`` > 0 opens
    every prompt with one of two fixed heads and repeats the first two
    prompts at the end (prefix-cache hits)."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, V, (2, max(prefix, 1))).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.integers(0, V, (int(rng.choice(lens)),)).astype(np.int32)
        if prefix:
            p[:prefix] = heads[i % 2]
            if i >= n - 2:
                p = np.array(out[i - 2].prompt, np.int32)
        f = rng.integers(0, V, (5,)).astype(np.int32) if forced else None
        out.append(cls(rid=i, prompt=p, max_new_tokens=int(
            rng.integers(3, 7)), k=ks[i % len(ks)], forced=f))
    return out


def _same_tokens(want, got):
    assert sorted(want) == sorted(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"rid {rid}")


KW = dict(num_slots=4, slot_len=20, slot_k=(2, 2, 1, 1), block_size=4)
# capacity: three same-length prompts per tier are admitted together (a
# repeat among them cannot read its twin's pending pages, so it prefills
# cold beside it), the reference pads each prefill group of 3 rows to a
# bucket of 4, and the bucket sets the expert capacity C (48 rather than
# 32 at 16 tokens); the last repeat then prefills its suffix, padded alike
KW_CAP = dict(num_slots=6, slot_len=24, slot_k=(2, 2, 2, 1, 1, 1),
              block_size=4, dispatch="capacity")
CASES = {
    "paged-rescaled-prefix-cache": (dict(KW, prefix_cache=True),
                                    dict(rescaled=True), dict(prefix=4)),
    "slotted-rescaled": (dict(KW, kv_layout="slotted"), dict(rescaled=True),
                         dict(n=4)),
    "speculative-rescaled": (KW, dict(rescaled=True, spec=True), dict(n=4)),
    "dense": (dict(KW, dispatch="dense"), {}, dict(n=4)),
    "dense-prefix-cache": (dict(KW, dispatch="dense", prefix_cache=True), {},
                           dict(prefix=4, n=4)),
    "capacity-prefix-cache": (dict(KW_CAP, prefix_cache=True), {},
                              dict(prefix=8, lens=(16,), n=7)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lora_engine_matches_jax_engine(case):
    """The adapter served unmerged: the port engine's tokens equal the JAX
    engine's, request for request, and differ from the engine without
    the adapter for at least one request."""
    kw, opt, rq = CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if opt.get("rescaled"):
        jkw["rescaler_by_k"] = R_BY_K
        tkw["rescaler_by_k"] = rescalers_from_jax(R_BY_K, "cpu")
    if opt.get("spec"):
        jkw["speculative"] = JSpec(window=3, draft_k=1)
        tkw["speculative"] = SpeculativeConfig(window=3, draft_k=1)
    jrep = JEngine(JCFG, JPARAMS, lora=LORA_NP, **jkw).run(
        _requests(JRequest, **rq))
    eng = ServingEngine(TCFG, TPARAMS, lora=TLORA, **tkw)
    trep = eng.run(_requests(Request, **rq))
    _same_tokens(jrep.tokens_by_rid(), trep.tokens_by_rid())
    assert trep.prefill_tokens == jrep.prefill_tokens
    if kw.get("prefix_cache"):
        assert trep.prefix["hit_tokens"] == jrep.prefix["hit_tokens"] > 0
    if opt.get("spec"):
        assert trep.spec_rounds == jrep.spec_rounds > 0
        assert trep.spec_accepted == jrep.spec_accepted
    if eng.paged:
        eng.pool.check_invariants()
        assert eng.pool.blocks_in_use == 0
    bare = ServingEngine(TCFG, TPARAMS, **tkw).run(_requests(Request, **rq))
    base = bare.tokens_by_rid()
    assert any(not np.array_equal(base[r], t)
               for r, t in trep.tokens_by_rid().items())


def test_lora_engine_forced_nll_matches_jax_engine():
    kw = dict(num_slots=2, slot_len=16, slot_k=(2, 1), block_size=4)
    rq = dict(n=4, seed=2, forced=True)
    jrep = JEngine(JCFG, JPARAMS, lora=LORA_NP, **kw).run(
        _requests(JRequest, **rq))
    trep = ServingEngine(TCFG, TPARAMS, lora=TLORA, **kw).run(
        _requests(Request, **rq))
    _same_tokens(jrep.tokens_by_rid(), trep.tokens_by_rid())
    for jc, tc in zip(jrep.completions, trep.completions):
        np.testing.assert_allclose(tc.nll_sum, jc.nll_sum, rtol=1e-4)


@pytest.mark.parametrize("dispatch", ["ragged", "dense", "capacity"])
def test_unmerged_adapter_matches_merged_weights(dispatch):
    """At float32 serving the adapter unmerged gives the tokens of the
    engine on ``merge_into_params`` (W + s·A·B), on every dispatch mode."""
    kw = dict(KW, dispatch=dispatch)
    merged = tlora.merge_into_params(TPARAMS, TLORA, TCFG.lora.scale)
    want = ServingEngine(TCFG, merged, **kw).run(_requests(Request))
    got = ServingEngine(TCFG, TPARAMS, lora=TLORA, **kw).run(
        _requests(Request))
    _same_tokens(want.tokens_by_rid(), got.tokens_by_rid())


def test_engine_dispatch_options_resolve_as_the_reference():
    """``no_drop`` is the legacy alias when ``dispatch`` is unset; an
    unknown mode and capacity under speculation are refused."""
    mk = lambda **kw: ServingEngine(TCFG, TPARAMS, num_slots=2,  # noqa: E731
                                    slot_len=16, **kw)
    assert mk().dispatch == "ragged"
    assert mk(no_drop=True).dispatch == "dense"
    assert mk(no_drop=False).dispatch == "capacity"
    assert mk(no_drop=True, dispatch="ragged").dispatch == "ragged"
    with pytest.raises(ValueError, match="dispatch"):
        mk(dispatch="sparse")
    with pytest.raises(ValueError, match="loss-free"):
        mk(dispatch="capacity", speculative=SpeculativeConfig(3, 1))


@pytest.mark.parametrize("dispatch", ["ragged", "dense", "capacity"])
def test_serve_launcher_dispatch_flag(dispatch, capsys):
    tserve.main(["--local", "--device", "cpu", "--requests", "5",
                 "--new-tokens", "3", "--slots", "4", "--mix",
                 "2:0.5,1:0.5", "--dispatch", dispatch])
    out = capsys.readouterr().out
    assert f"dispatch={dispatch}" in out and "gen_tokens: 15" in out
