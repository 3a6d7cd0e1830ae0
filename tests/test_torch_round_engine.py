"""The port's batched round engine, streaming FLAME aggregation, round
telemetry and checkpoints against the JAX package, at float32 on the CPU.

Both packages run the reference's default engine (``round_engine=
"batched"``, ``cohort_backend="vmap"``) for two rounds of 8 clients at
participation 0.5 (cohorts of one and of two, ``prev_lora`` carried from
round to round) from the same weights, adapters, data and budgets.

Tolerances, float32 on both sides: client losses rtol 1e-5, activation
frequencies exactly; aggregated adapters within atol 1e-5 on at least
99.9% of elements and within 2·lr·steps everywhere (Adam moves an element
by about lr per step, so one whose gradient is about 0 may step the other
way).  Within the port, batched against looped: 1e-6 (the same kernels in
the same order; only the aggregation's summation order differs).  The
streaming accumulator against the stacked rule and the JAX accumulator:
1e-6.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import base as jbase
from repro.core import aggregation as jagg
from repro.core import lora as jlora
from repro.data import synthetic as jsyn
from repro.federated import client as jclient
from repro.federated import cohort as jcohort
from repro.federated.simulation import build_experiment as j_build
from repro.obs import expert_load as jload
from repro_torch import configs as tconfigs
from repro_torch.convert import lora_from_jax, to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import lora as tlora
from repro_torch.data import synthetic as tsyn
from repro_torch.federated import client as tclient
from repro_torch.federated import cohort as tcohort
from repro_torch.federated.simulation import build_experiment as t_build
from repro_torch.obs import expert_load as tload
from repro_torch.tree import leaves
from test_torch_train import (JCFG, JPARAMS, TCFG, TPARAMS, np32,
                              trained_trainable)

_DATA = tsyn.DataConfig(vocab_size=128, n_examples=160, seq_len=16,
                        n_clusters=4)
_JDATA = jsyn.DataConfig(**dataclasses.asdict(_DATA))
_TC = tconfigs.TrainConfig(batch_size=7)
_JTC = jbase.TrainConfig(**dataclasses.asdict(_TC))
_FED = tconfigs.FederatedConfig(num_clients=8, rounds=2, participation=0.5)
_JFED = jbase.FederatedConfig(**dataclasses.asdict(_FED))


def _port_experiment(start_lora, **fed_kw):
    exp = t_build(TCFG, fed=dataclasses.replace(_FED, **fed_kw), tc=_TC,
                  data=_DATA, base_params=TPARAMS, device="cpu")
    exp.server.global_lora = lora_from_jax(start_lora, device="cpu")
    return exp


@pytest.fixture(scope="module")
def engines():
    """Two default-engine rounds in each package, and the port's looped
    engine, from the same start."""
    jexp = j_build(JCFG, fed=_JFED, tc=_JTC, data=_JDATA,
                   base_params=JPARAMS)
    start = np32(jexp.server.global_lora)
    texp = _port_experiment(start)
    lexp = _port_experiment(start, round_engine="looped")
    return dict(jexp=jexp, texp=texp, lexp=lexp, start=start,
                jres=jexp.server.run(), tres=texp.server.run(),
                lres=lexp.server.run())


def _steps(exp, rounds=2):
    return rounds * max(len(c.shard.tokens) // _TC.batch_size
                        for c in exp.server.clients)


def _assert_aggregate_rule(got, want, bound):
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in
                           zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
    assert diff.max() <= bound, (diff.max(), bound)


def test_batched_rounds_have_multi_member_cohorts(engines):
    texp, tres = engines["texp"], engines["tres"]
    sizes = []
    for res in tres:
        part = [texp.server.clients[i] for i in res.participating]
        sizes += [len(co.members) for co in tcohort.build_cohorts(
            part, _TC, rank_of=texp.server._dist_rank)]
    assert max(sizes) > 1 and len(tres) == 2


def test_batched_participants_and_frequencies_match_jax(engines):
    for jr, tr in zip(engines["jres"], engines["tres"]):
        assert tr.round_idx == jr.round_idx
        assert tr.participating == jr.participating
        for tf, jf in zip(tr.client_freqs, jr.client_freqs):
            np.testing.assert_array_equal(tf["pos0"], np.asarray(jf["pos0"]))


def test_batched_losses_match_jax(engines):
    for jr, tr in zip(engines["jres"], engines["tres"]):
        np.testing.assert_allclose(tr.client_losses, jr.client_losses,
                                   rtol=1e-5)


def test_batched_aggregate_and_rescalers_match_jax(engines):
    jexp, texp = engines["jexp"], engines["texp"]
    _assert_aggregate_rule(to_numpy(texp.server.global_lora),
                           np32(jexp.server.global_lora),
                           2 * _TC.learning_rate * _steps(texp))
    moved = [np.abs(g - s).max() for g, s in zip(
        jax.tree.leaves(to_numpy(texp.server.global_lora)),
        jax.tree.leaves(engines["start"]))]
    assert max(moved) > 0
    for jc, tc in zip(jexp.server.clients, texp.server.clients):
        np.testing.assert_allclose(tc.rescaler["pos0"].numpy(),
                                   np.asarray(jc.rescaler["pos0"]),
                                   rtol=1e-5, atol=1e-6)


def test_batched_matches_looped_engine(engines):
    texp, lexp = engines["texp"], engines["lexp"]
    for br, lr in zip(engines["tres"], engines["lres"]):
        assert br.participating == lr.participating
        np.testing.assert_allclose(br.client_losses, lr.client_losses,
                                   rtol=1e-6)
        for bf, lf in zip(br.client_freqs, lr.client_freqs):
            np.testing.assert_array_equal(bf["pos0"], lf["pos0"])
    for b, l in zip(leaves(texp.server.global_lora),
                    leaves(lexp.server.global_lora)):
        torch.testing.assert_close(b, l, rtol=1e-6, atol=1e-6)
    for bc, lc in zip(texp.server.clients, lexp.server.clients):
        torch.testing.assert_close(bc.rescaler["pos0"], lc.rescaler["pos0"],
                                   rtol=1e-6, atol=1e-6)


def test_activation_drift_matches_jax(engines):
    for jr, tr in zip(engines["jres"], engines["tres"]):
        assert tr.activation_drift is not None
        assert set(tr.activation_drift) == set(jr.activation_drift)
        for pos, jd in jr.activation_drift.items():
            td = tr.activation_drift[pos]
            np.testing.assert_allclose(td["entropy"], jd["entropy"],
                                       rtol=1e-12)
            assert td["entropy_mean"] == pytest.approx(jd["entropy_mean"],
                                                       rel=1e-12)
            if jd["l1_drift"] is None:
                assert td["l1_drift"] is None and jr.round_idx == 0
            else:
                assert td["l1_drift"] == pytest.approx(jd["l1_drift"],
                                                       rel=1e-12)


def test_drift_and_load_trackers_match_reference_on_same_frequencies():
    rng = np.random.default_rng(4)
    jt, tt = jload.ActivationDriftTracker(), tload.ActivationDriftTracker()
    for r in range(3):
        freqs = {"pos0": rng.random((2, 4)), "pos1": rng.random((3, 8))}
        freqs["pos0"][1] = 0.0                  # a period nobody routed
        assert tt.update(freqs) == jt.update(freqs)
    jl, tl = jload.ExpertLoadTracker(8), tload.ExpertLoadTracker(8)
    for _ in range(4):
        counts = {"pos0": rng.integers(0, 9, (2, 8))}
        jl.observe_step(counts)
        tl.observe_step(counts)
    assert tl.snapshot() == jl.snapshot()
    x = rng.random(16)
    assert (tload.gini(x), tload.entropy(x)) == (jload.gini(x),
                                                 jload.entropy(x))


def test_cohorts_and_stacked_plans_are_byte_identical(engines):
    jexp, texp = engines["jexp"], engines["texp"]
    js = jexp.server
    ts = texp.server
    jcos = jcohort.build_cohorts(js.clients, _JTC, rank_of=js._dist_rank)
    tcos = tcohort.build_cohorts(ts.clients, _TC, rank_of=ts._dist_rank)
    assert [(c.key, c.members) for c in tcos] == [(c.key, c.members)
                                                  for c in jcos]
    assert (tcohort.group_by_key(ts.clients, _TC)
            == jcohort.group_by_key(js.clients, _JTC))
    for jco, tco in zip(jcos, tcos):
        jplan = jclient.stack_plans([jclient.make_batch_plan(
            js.clients[i], _JTC, 5) for i in jco.members])
        tplan = tclient.stack_plans([tclient.make_batch_plan(
            ts.clients[i], _TC, 5) for i in tco.members])
        for plans in ((jplan, tplan), (jclient.empty_plan(jplan),
                                       tclient.empty_plan(tplan))):
            for f in ("tokens", "labels", "mask", "valid"):
                a, b = (getattr(p, f) for p in plans)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                assert a.tobytes() == b.tobytes(), f
    mixed = [tclient.make_batch_plan(ts.clients[0], _TC, 0),
             tclient.make_batch_plan(ts.clients[0],
                                     dataclasses.replace(_TC, batch_size=3),
                                     0)]
    with pytest.raises(ValueError, match="mixed batch sizes"):
        tclient.stack_plans(mixed)


# ---------------------------------------------------------------- streaming

def _stream_case():
    """Five clients' adapters and frequencies: expert 3 of period 1 has
    zero mass everywhere, client 4 has dataset size 0."""
    rng = np.random.default_rng(9)
    loras = [np32(trained_trainable(30 + i)["lora"]) for i in range(5)]
    freqs = rng.random((5, 2, 4)).astype(np.float32)
    freqs[:, 1, 3] = 0.0
    sizes = np.asarray([5.0, 9.0, 2.0, 7.0, 0.0], np.float32)
    prev = np32(trained_trainable(40)["lora"])
    return loras, freqs, sizes, prev


def _chunks(n):
    return [slice(0, 2), slice(2, 3), slice(3, n)]


def test_flame_acc_matches_jax_and_stacked_aggregate():
    loras, freqs, sizes, prev = _stream_case()
    tls = [lora_from_jax(l, device="cpu") for l in loras]
    jls = [jax.tree.map(jnp.asarray, l) for l in loras]
    jprev = jax.tree.map(jnp.asarray, prev)
    tprev = lora_from_jax(prev, device="cpu")

    def stream(mod, ls, stack, prev_lora):
        acc_a = mod.flame_acc_init(ls[0])
        acc_b = mod.flame_acc_init(ls[0])
        for i, sl in enumerate(_chunks(len(ls))):
            chunk = stack(ls[sl])
            fr = {"pos0": freqs[sl]}
            if i == 0:
                acc_a = mod.flame_acc_update(acc_a, chunk, fr, sizes[sl], 2)
            else:
                acc_b = mod.flame_acc_update(acc_b, chunk, fr, sizes[sl], 2)
        return mod.flame_acc_finalize(mod.flame_acc_merge(acc_a, acc_b),
                                      prev_lora=prev_lora)

    got = stream(tagg, tls, tlora.stack_adapters, tprev)
    want = stream(jagg, jls, jlora.stack_adapters, jprev)
    stacked = tagg.flame_aggregate(
        tlora.stack_adapters(tls), {"pos0": torch.from_numpy(freqs)}, sizes,
        2, prev_lora=tprev)
    without_empty = tagg.flame_aggregate(
        tls[:4], [{"pos0": f} for f in freqs[:4]], sizes[:4], 2,
        prev_lora=tprev)
    for g, w, s, e in zip(jax.tree.leaves(to_numpy(got)),
                          jax.tree.leaves(want),
                          jax.tree.leaves(to_numpy(stacked)),
                          jax.tree.leaves(to_numpy(without_empty))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, s, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, e, rtol=1e-6, atol=1e-6)
    kept = got["blocks"]["pos0"]["moe"]["experts"]["w2"]["b"][1, 3]
    np.testing.assert_array_equal(
        kept.numpy(), prev["blocks"]["pos0"]["moe"]["experts"]["w2"]["b"][1, 3])
    # without prev_lora: fp32 leaves, the zero-mass expert zero, no NaN
    bare = tagg.flame_acc_finalize(tagg.flame_acc_update(
        tagg.flame_acc_init(tls[0]), tls, [{"pos0": f} for f in freqs],
        sizes, 2))
    w1 = bare["blocks"]["pos0"]["moe"]["experts"]["w1"]["a"]
    assert w1.dtype == torch.float32 and not torch.isnan(w1).any()
    assert float(w1[1, 3].abs().max()) == 0.0


_RULES = {
    "fedavg": lambda ls, fr, sz, prev: tagg.fedavg(ls, sz),
    "flame": lambda ls, fr, sz, prev: tagg.flame_aggregate(
        ls, fr, sz, 2, prev_lora=prev),
    "flame_acc": lambda ls, fr, sz, prev: tagg.flame_acc_finalize(
        tagg.flame_acc_update(tagg.flame_acc_init(prev),
                              tlora.stack_adapters(ls), fr, sz, 2),
        prev_lora=prev),
    "hlora": lambda ls, fr, sz, prev: tagg.hlora_aggregate(
        [tlora.truncate_rank(l, r) for l, r in zip(ls, (1, 2, 4, 4, 3))],
        (1, 2, 4, 4, 3), sz, 4),
    "flexlora": lambda ls, fr, sz, prev: tagg.flexlora_aggregate(
        ls, sz, 4, TCFG.lora.scale),
}


@pytest.mark.parametrize("rule", sorted(_RULES))
def test_aggregation_frees_client_trees_without_the_cyclic_collector(rule):
    """Once an aggregation rule has returned and its caller drops the
    client trees, reference counting alone frees them and every tensor
    the rule made on the way: the only new tensors alive are the result's
    leaves.  (A nested function that calls itself is a reference cycle
    that keeps what it closes over alive until Python's cyclic collector
    runs; on the card a round would hold every participant's adapters.)"""
    loras, freqs, sizes, prev = _stream_case()
    tprev = lora_from_jax(prev, device="cpu")
    fr = [{"pos0": f} for f in freqs]
    gc.collect()
    gc.disable()
    try:
        before = {id(o) for o in gc.get_objects()
                  if issubclass(type(o), torch.Tensor)}
        tls = [lora_from_jax(l, device="cpu") for l in loras]
        refs = [weakref.ref(leaf) for t in tls for leaf in leaves(t)]
        out = _RULES[rule](tls, fr, sizes, tprev)
        del tls
        assert all(r() is None for r in refs)
        result = {id(t) for leaf in leaves(out)
                  for t in (leaf, leaf._base) if t is not None}
        alive = [tuple(o.shape) for o in gc.get_objects()
                 if issubclass(type(o), torch.Tensor) and id(o) not in before
                 and id(o) not in result]
        assert alive == []
        assert all(bool(torch.isfinite(leaf).all()) for leaf in leaves(out))
    finally:
        gc.enable()


# ---------------------------------------------------------------- edge cases

def test_zero_step_clients_and_padding_are_exact_noops():
    """A zero-step plan leaves the trainable tree untouched with zero
    counts and tokens; a cohort pads its shorter member with invalid steps
    that change nothing; a batched round of zero-step clients reports nan
    losses and keeps every expert adapter."""
    exp = t_build(TCFG, fed=_FED, tc=_TC, data=_DATA, base_params=TPARAMS,
                  device="cpu")
    c0, c1 = exp.server.clients[:2]
    tr = [tlora.make_trainable(exp.server.global_lora, c.rescaler)
          for c in (c0, c1)]
    tc0 = dataclasses.replace(_TC, local_epochs=0)
    empty = tclient.make_batch_plan(c0, tc0, 3)
    assert empty.n_steps == 1 and empty.valid.sum() == 0.0
    out, counts, tok, _, n_valid = tclient.local_update(
        TCFG, TPARAMS, tr[0], empty.tokens, empty.labels, empty.mask,
        empty.valid, k=c0.k, tc=tc0, rescaler_trainable=True)
    assert float(tok) == 0.0 and float(n_valid) == 0.0
    for a, b in zip(leaves(out), leaves(tr[0])):
        assert torch.equal(a, b)
    assert all(float(v.abs().sum()) == 0.0 for v in counts.values())

    long = tclient.make_batch_plan(c0, _TC, 3)
    short = dataclasses.replace(long, tokens=long.tokens[:1],
                                labels=long.labels[:1], mask=long.mask[:1],
                                valid=long.valid[:1])
    plan = tclient.stack_plans([long, short])
    assert plan.valid[1].tolist() == [1.0] + [0.0] * (long.n_steps - 1)
    kw = dict(k=c0.k, tc=_TC, rescaler_trainable=True)
    stacked = tclient.cohort_update(
        TCFG, TPARAMS, tlora.stack_adapters(tr), plan.tokens, plan.labels,
        plan.mask, plan.valid, backend="map", **kw)
    alone = tclient.local_update(TCFG, TPARAMS, tr[1], short.tokens,
                                 short.labels, short.mask, short.valid, **kw)
    for a, b in zip(leaves(tlora.unstack_adapters(stacked[0])[1]),
                    leaves(alone[0])):
        assert torch.equal(a, b)
    for i in (2, 3, 4):
        assert torch.equal(stacked[i][1], alone[i])
    with pytest.raises(ValueError, match="unknown cohort backend"):
        tclient.cohort_update(TCFG, TPARAMS, tlora.stack_adapters(tr),
                              plan.tokens, plan.labels, plan.mask, plan.valid,
                              backend="pmap", **kw)

    before = to_numpy(exp.server.global_lora)
    exp.server.tc = tc0
    res = exp.server.run_round(0)
    assert np.isnan(res.client_losses).all()
    after = to_numpy(exp.server.global_lora)
    for b, a in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        after["blocks"]["pos0"]["moe"]["experts"]["w1"]["a"],
        before["blocks"]["pos0"]["moe"]["experts"]["w1"]["a"])


# ---------------------------------------------------------------- checkpoints

def test_jax_checkpoint_restores_into_port_server(engines, tmp_path):
    jexp = engines["jexp"]
    path = str(tmp_path / "jax_state.npz")
    jexp.server.save_checkpoint(path)
    texp = t_build(TCFG, fed=_FED, tc=_TC, data=_DATA, base_params=TPARAMS,
                   device="cpu")
    assert texp.server.restore_checkpoint(path) == 2
    for g, w in zip(jax.tree.leaves(to_numpy(texp.server.global_lora)),
                    jax.tree.leaves(np32(jexp.server.global_lora))):
        np.testing.assert_array_equal(g, w)
    for jc, tc in zip(jexp.server.clients, texp.server.clients):
        np.testing.assert_array_equal(tc.rescaler["pos0"].numpy(),
                                      np.asarray(jc.rescaler["pos0"]))
    jfresh = j_build(JCFG, fed=_JFED, tc=_JTC, data=_JDATA,
                     base_params=JPARAMS)
    assert jfresh.server.restore_checkpoint(path) == 2
    for _ in range(3):       # the participant stream continues in step
        assert (texp.server._sample_participants()
                == jfresh.server._sample_participants())


def test_port_checkpoint_loads_in_jax(engines, tmp_path):
    texp = engines["texp"]
    path = str(tmp_path / "port_state.npz")
    texp.server.save_checkpoint(path)
    tree, meta = jckpt.load(path)
    assert meta == {"round_idx": 2, "method": "flame", "num_clients": 8}
    for g, w in zip(jax.tree.leaves(tree["global_lora"]),
                    jax.tree.leaves(to_numpy(texp.server.global_lora))):
        np.testing.assert_array_equal(g, w)
    for r, c in zip(tree["rescalers"], texp.server.clients):
        np.testing.assert_array_equal(r["pos0"], c.rescaler["pos0"].numpy())
    jfresh = j_build(JCFG, fed=_JFED, tc=_JTC, data=_JDATA,
                     base_params=JPARAMS)
    assert jfresh.server.restore_checkpoint(path) == 2
