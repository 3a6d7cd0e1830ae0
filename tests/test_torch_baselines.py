"""The port's compression baselines (``trivial``, ``hlora``, ``flexlora``)
and their rank surgery against the JAX package, at float32 on the CPU.

Rank surgery (truncate, pad, ΔW, merge into the base) and the HLoRA rule
agree within 1e-6 (fp32, another summation order).  The SVD's factors are
free up to sign and the order of equal singular values, so FlexLoRA's
result is compared through the product ``scale·A·B``: 1e-5 for the
aggregation rule alone.  One batched round of each baseline in each
package, from the same weights, adapters, data and budgets: client losses
rtol 1e-5; adapters (FlexLoRA: their products) within atol 1e-5 on at
least 99.9% of elements and within 2·lr·steps everywhere (Adam moves an
element by about lr per step, so one whose gradient is about 0 may step
the other way).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import aggregation as jagg
from repro.core import lora as jlora
from repro.data import synthetic as jsyn
from repro.federated.simulation import build_experiment as j_build
from repro_torch import configs as tconfigs
from repro_torch.convert import lora_from_jax, to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import lora as tlora
from repro_torch.data import synthetic as tsyn
from repro_torch.federated.simulation import build_experiment as t_build
from test_torch_train import (JCFG, JPARAMS, TPARAMS, TCFG, np32,
                              trained_trainable)

SCALE = JCFG.lora.scale


def _pairs(tree, path=()):
    """(path, {"a", "b"}) of every adapter pair, in sorted key order."""
    if isinstance(tree, dict) and set(tree) == {"a", "b"}:
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], path + (k,))


def _products(lora):
    """scale·A·B of every pair, float64 numpy."""
    return [SCALE * np.matmul(np.asarray(p["a"], np.float64),
                              np.asarray(p["b"], np.float64))
            for _, p in _pairs(lora)]


def _loras(n, seed=50):
    return [np32(trained_trainable(seed + i)["lora"]) for i in range(n)]


def _assert_leaves_close(got, want, tol=1e-6):
    g, w = jax.tree.leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------- surgery

def test_stack_and_unstack_match_jax():
    loras = _loras(3)
    got = tlora.stack_adapters([lora_from_jax(l, device="cpu")
                                for l in loras])
    want = jlora.stack_adapters([jax.tree.map(jnp.asarray, l)
                                 for l in loras])
    _assert_leaves_close(got, want, 0)
    for t, j in zip(tlora.unstack_adapters(got),
                    jlora.unstack_adapters(want)):
        _assert_leaves_close(t, j, 0)
    assert len(tlora.unstack_adapters(got, 2)) == 2


@pytest.mark.parametrize("r", [1, 3, 4])
def test_truncate_pad_and_delta_match_jax(r):
    lora = _loras(1)[0]
    tl, jl = lora_from_jax(lora, device="cpu"), jax.tree.map(jnp.asarray,
                                                               lora)
    t_small, j_small = tlora.truncate_rank(tl, r), jlora.truncate_rank(jl, r)
    _assert_leaves_close(t_small, j_small, 0)
    _assert_leaves_close(tlora.pad_rank(t_small, 4),
                         jlora.pad_rank(j_small, 4), 0)
    _assert_leaves_close(tlora.merge_delta(t_small, SCALE),
                         jlora.merge_delta(j_small, SCALE))


def test_merge_into_params_matches_jax():
    lora = _loras(1)[0]
    got = tlora.merge_into_params(TPARAMS, lora_from_jax(lora, device="cpu"),
                                  SCALE)
    want = jlora.merge_into_params(JPARAMS, jax.tree.map(jnp.asarray, lora),
                                   SCALE)
    _assert_leaves_close(got, want, 1e-5)
    moved = got["blocks"]["pos0"]["moe"]["experts"]["w1"]
    assert not torch.equal(moved,
                           TPARAMS["blocks"]["pos0"]["moe"]["experts"]["w1"])


@pytest.mark.parametrize("rank", [2, 4])
def test_svd_refactor_matches_jax_through_the_product(rank):
    deltas = tlora.merge_delta(
        tlora.stack_adapters([lora_from_jax(l, device="cpu")
                              for l in _loras(2)]), SCALE)
    got = tlora.svd_refactor(deltas, rank, SCALE)
    want = jlora.svd_refactor(jax.tree.map(jnp.asarray, to_numpy(deltas)),
                              rank, SCALE)
    for g, w in zip(_products(to_numpy(got)), _products(np32(want))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for path, pair in _pairs(got):
        assert pair["a"].shape[-1] == pair["b"].shape[-2] == rank, path


# ---------------------------------------------------------------- rules

def test_hlora_aggregate_matches_jax():
    loras = _loras(4)
    ranks, sizes = [4, 2, 2, 1], [5.0, 9.0, 2.0, 7.0]
    tls = [tlora.truncate_rank(lora_from_jax(l, device="cpu"), r)
           for l, r in zip(loras, ranks)]
    jls = [jlora.truncate_rank(jax.tree.map(jnp.asarray, l), r)
           for l, r in zip(loras, ranks)]
    got = tagg.hlora_aggregate(tls, ranks, sizes, 4)
    _assert_leaves_close(got, jagg.hlora_aggregate(jls, ranks, sizes, 4))
    # component 3 was trained by client 0 alone: its values, unweighted
    a = got["blocks"]["pos0"]["attn"]["wq"]["a"]
    np.testing.assert_array_equal(
        a[..., 3].numpy(), loras[0]["blocks"]["pos0"]["attn"]["wq"]["a"][..., 3])


def test_flexlora_aggregate_matches_jax():
    loras = _loras(3)
    ranks, sizes = [4, 2, 1], [5.0, 9.0, 2.0]
    tls = [tlora.truncate_rank(lora_from_jax(l, device="cpu"), r)
           for l, r in zip(loras, ranks)]
    jls = [jlora.truncate_rank(jax.tree.map(jnp.asarray, l), r)
           for l, r in zip(loras, ranks)]
    got = tagg.flexlora_aggregate(tls, sizes, 4, SCALE)
    want = jagg.flexlora_aggregate(jls, sizes, 4, SCALE)
    for g, w in zip(_products(to_numpy(got)), _products(np32(want))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_fedavg_and_stacked_frequencies_match_jax():
    loras = _loras(3)
    sizes = [1.0, 0.0, 4.0]
    _assert_leaves_close(
        tagg.fedavg(tlora.stack_adapters(
            [lora_from_jax(l, device="cpu") for l in loras]), sizes),
        jagg.fedavg([jax.tree.map(jnp.asarray, l) for l in loras], sizes))
    rng = np.random.default_rng(2)
    freqs = [{"pos0": rng.random((2, 4)).astype(np.float32)}
             for _ in range(3)]
    got = tagg.stack_client_frequencies(freqs)
    want = jagg.stack_client_frequencies(
        [jax.tree.map(jnp.asarray, f) for f in freqs])
    np.testing.assert_array_equal(got["pos0"].numpy(),
                                  np.asarray(want["pos0"]))


# ---------------------------------------------------------------- rounds

_DATA = tsyn.DataConfig(vocab_size=128, n_examples=120, seq_len=16,
                        n_clusters=4)
_JDATA = jsyn.DataConfig(**dataclasses.asdict(_DATA))
_TC = tconfigs.TrainConfig(batch_size=6)
_JTC = jbase.TrainConfig(**dataclasses.asdict(_TC))


@pytest.mark.parametrize("method", ["trivial", "hlora", "flexlora"])
def test_baseline_round_matches_jax(method):
    """One default-engine round of 8 clients (two per budget tier) in each
    package."""
    fed = tconfigs.FederatedConfig(num_clients=8, rounds=1, method=method)
    jexp = j_build(JCFG, fed=jbase.FederatedConfig(**dataclasses.asdict(fed)),
                   tc=_JTC, data=_JDATA, base_params=JPARAMS)
    texp = t_build(TCFG, fed=fed, tc=_TC, data=_DATA, base_params=TPARAMS,
                   device="cpu")
    start = np32(jexp.server.global_lora)
    texp.server.global_lora = lora_from_jax(start, device="cpu")
    assert ([c.rank for c in texp.server.clients]
            == [c.rank for c in jexp.server.clients])
    jres, tres = jexp.server.run_round(0), texp.server.run_round(0)
    assert tres.participating == jres.participating
    np.testing.assert_allclose(tres.client_losses, jres.client_losses,
                               rtol=1e-5)
    assert np.isfinite(tres.client_losses).all()
    got = to_numpy(texp.server.global_lora)
    want = np32(jexp.server.global_lora)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(start)):
        assert g.shape == w.shape          # the server rank's storage
    if method == "flexlora":
        got, want = _products(got), _products(want)
    steps = max(len(c.shard.tokens) // _TC.batch_size
                for c in texp.server.clients)
    diff = np.concatenate([np.abs(np.asarray(g) - np.asarray(w)).ravel()
                           for g, w in zip(jax.tree.leaves(got),
                                           jax.tree.leaves(want))])
    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
    assert diff.max() <= 2 * _TC.learning_rate * steps, diff.max()
    if method == "trivial":
        r_min = min(c.rank for c in texp.server.clients)
        for _, pair in _pairs(texp.server.global_lora):
            assert float(pair["a"][..., r_min:].abs().max()) == 0.0
            assert float(pair["b"][..., r_min:, :].abs().max()) == 0.0
