"""The slice as a whole: the port's ServingEngine against the JAX one.

Same weights (converted from the JAX package), same numpy-made requests,
both engines paged with ragged dispatch and greedy sampling: the generated
tokens must be identical per request.  Also the numpy-only copies
(workload traces, histogram) against their originals, the serving
launcher, and the options that later slices bring.
"""
import jax
import numpy as np
import pytest

from conftest import tiny_moe
from repro.core import lora as jlora
from repro.models import model as jmodel
from repro.obs.metrics import Histogram as JHistogram
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import WorkloadConfig as JWorkload
from repro.serving import make_trace as j_make_trace
from repro_torch.convert import params_from_jax, rescalers_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.obs.metrics import Histogram as THistogram
from repro_torch.serving import Request, SamplerConfig, ServingEngine
from repro_torch.serving import WorkloadConfig, make_trace
from test_torch_model import port_cfg

JCFG = tiny_moe()
TCFG = port_cfg(JCFG)
JPARAMS = jmodel.init_params(jax.random.PRNGKey(1), JCFG)
TPARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")


def _requests(cls, n, seed, ks=(2, 1), forced=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.choice((5, 8)))    # two prefill groups per tier
        prompt = rng.integers(0, JCFG.vocab_size, (L,)).astype(np.int32)
        f = (rng.integers(0, JCFG.vocab_size, (5,)).astype(np.int32)
             if forced else None)
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=int(
            rng.integers(3, 7)), k=ks[i % len(ks)], forced=f))
    return out


def _assert_same_tokens(jrep, trep):
    jt, tt = jrep.tokens_by_rid(), trep.tokens_by_rid()
    assert sorted(jt) == sorted(tt)
    for rid in jt:
        np.testing.assert_array_equal(tt[rid], jt[rid], err_msg=f"rid {rid}")


def test_engine_greedy_tokens_match_jax_engine():
    """Mixed tiers (2,2,1,1), more requests than slots (queueing and slot
    reuse), varied prompt lengths (several prefill groups)."""
    kw = dict(num_slots=4, slot_len=20, slot_k=(2, 2, 1, 1), block_size=4)
    jrep = JEngine(JCFG, JPARAMS, kv_layout="paged", dispatch="ragged",
                   **kw).run(_requests(JRequest, 10, 0))
    eng = ServingEngine(TCFG, TPARAMS, **kw)
    trep = eng.run(_requests(Request, 10, 0))
    _assert_same_tokens(jrep, trep)
    assert trep.summary()["gen_tokens"] == jrep.summary()["gen_tokens"]
    assert trep.prefill_tokens == jrep.prefill_tokens
    eng.pool.check_invariants()
    assert eng.pool.num_free == 4 and eng.pool.blocks_in_use == 0


def test_engine_per_slot_rescaler_matches_jax_engine():
    r_by_k = {k: jlora.init_rescalers(JCFG, k) for k in (1, 2)}
    r_by_k = {k: {p: v * (1.0 + 0.25 * k) for p, v in t.items()}
              for k, t in r_by_k.items()}
    kw = dict(num_slots=2, slot_len=16, slot_k=(2, 1), block_size=4)
    jrep = JEngine(JCFG, JPARAMS, rescaler_by_k=r_by_k, **kw).run(
        _requests(JRequest, 4, 1))
    trep = ServingEngine(TCFG, TPARAMS, rescaler_by_k=rescalers_from_jax(
        jax.tree.map(np.asarray, r_by_k), "cpu"), **kw).run(
        _requests(Request, 4, 1))
    _assert_same_tokens(jrep, trep)


def test_engine_forced_nll_matches_jax_engine():
    kw = dict(num_slots=2, slot_len=16, slot_k=(2, 2), block_size=4)
    jrep = JEngine(JCFG, JPARAMS, **kw).run(
        _requests(JRequest, 3, 2, ks=(2,), forced=True))
    trep = ServingEngine(TCFG, TPARAMS, **kw).run(
        _requests(Request, 3, 2, ks=(2,), forced=True))
    _assert_same_tokens(jrep, trep)
    for jc, tc in zip(jrep.completions, trep.completions):
        np.testing.assert_allclose(tc.nll_sum, jc.nll_sum, rtol=1e-4)


def test_engine_block_gated_admission_drains():
    """A pool of only 6 blocks: admission waits on blocks, not slots, and
    every request still completes with the tokens of an ample pool."""
    reqs = lambda: _requests(Request, 6, 3)                # noqa: E731
    tight = ServingEngine(TCFG, TPARAMS, num_slots=4, slot_len=16,
                          slot_k=(2, 2, 1, 1), block_size=4, num_blocks=6)
    ample = ServingEngine(TCFG, TPARAMS, num_slots=4, slot_len=16,
                          slot_k=(2, 2, 1, 1), block_size=4)
    t_rep = tight.run(reqs())
    assert tight.pool.peak_blocks <= 6
    _assert_same_tokens(ample.run(reqs()), t_rep)


def test_workload_and_histogram_copies_match_the_originals():
    spec = dict(n_requests=12, rate=5.0, prompt_lens=(4, 8),
                new_tokens=(2, 3), tier_mix=((2, 0.5), (1, 0.5)),
                vocab_size=128, seed=3, arrival="burst",
                length_dist="zipf")
    for j, t in zip(j_make_trace(JWorkload(**spec)),
                    make_trace(WorkloadConfig(**spec))):
        assert (j.rid, j.k, j.arrival, j.max_new_tokens) == \
            (t.rid, t.k, t.arrival, t.max_new_tokens)
        np.testing.assert_array_equal(j.prompt, t.prompt)
    jh, th = JHistogram(), THistogram()
    for x in np.random.default_rng(0).exponential(5.0, 200):
        jh.observe(float(x))
        th.observe(float(x))
    assert jh.snapshot() == th.snapshot()


@pytest.mark.parametrize("kw", [
    dict(kv_layout="slotted"), dict(dispatch="dense"),
    dict(prefix_cache=True), dict(preemption=True), dict(slo_ms={2: 100.0}),
    dict(speculative=object()), dict(tracer=object()),
    dict(metrics=object()), dict(expert_telemetry=True),
    dict(lora={"blocks": {}}),
])
def test_engine_later_slice_options_raise(kw):
    with pytest.raises(NotImplementedError, match="later|slice"):
        ServingEngine(TCFG, TPARAMS, num_slots=2, slot_len=16, **kw)


def test_sampler_is_greedy_only():
    assert SamplerConfig().kind == "greedy"
    with pytest.raises(NotImplementedError, match="sampled decoding"):
        SamplerConfig(kind="top_p", top_p=0.9)


def test_serve_launcher_runs_on_cpu(capsys):
    tserve.main(["--local", "--device", "cpu", "--requests", "5",
                 "--new-tokens", "3", "--slots", "4", "--mix",
                 "2:0.5,1:0.5"])
    out = capsys.readouterr().out
    assert "olmoe-smoke on cpu" in out and "slot_k=(2, 2, 1, 1)" in out
    assert "gen_tokens: 15" in out


@pytest.mark.parametrize("argv,match", [
    (["--local", "--speculate"], "serving-extras"),
    (["--local", "--slo-ms", "2:100"], "SLO"),
    (["--device", "cpu"], "multi-chip"),
])
def test_serve_launcher_rejects_later_slice_flags(argv, match):
    with pytest.raises(SystemExit, match=match):
        tserve.main(argv)
