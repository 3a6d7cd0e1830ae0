"""The port's training slice against the JAX package, at float32 on the CPU.

Each module with a kernel, and one FLAME round as a whole, runs in both
packages on the same numpy-made inputs: weights, adapters and rescalers
made by the JAX package and converted (``repro_torch.convert``).  Where the
JAX function reaches a Pallas kernel (the LoRA matmuls, the router, flash
attention) it runs in interpret mode; elsewhere the JAX side runs its
reference path (``backend="auto"`` on the CPU).

Tolerances, all float32 on both sides with a different summation order:
kernels and layers 1e-5; bf16 plain version vs Pallas 1e-2 (one bf16
rounding each side); loss and gradients over the whole model rtol 1e-4,
atol 1e-6.  After a round of Adam, client losses agree within rtol 1e-5,
activation counts exactly, and aggregated adapters within atol 1e-5 on at
least 99.9% of elements and within 2·lr·steps everywhere: Adam moves an
element by at most about lr per step, so one whose gradient is about 0
may step the other way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.configs import base as jbase
from repro.configs.base import KernelConfig
from repro.core import aggregation as jagg
from repro.core import lora as jlora
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.federated import client as jclient
from repro.federated.simulation import build_experiment as j_build
from repro.kernels import backend as jbackend
from repro.kernels.lora_matmul import lora_matmul as j_lora
from repro.kernels.lora_matmul import lora_matmul_experts as j_lora_experts
from repro.models import model as jmodel
from repro.models import moe_layer as jmoe
from repro.optim import adam as jadam
from repro_torch import configs as tconfigs
from repro_torch.convert import (lora_from_jax, params_from_jax, to_numpy,
                                 trainable_from_jax)
from repro_torch.core import aggregation as tagg
from repro_torch.core import lora as tlora
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.federated import client as tclient
from repro_torch.federated.simulation import build_experiment as t_build
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models.moe_layer import apply_moe as t_apply_moe
from repro_torch.optim import adam as tadam
from test_torch_model import port_cfg

JCFG = tiny_moe()
TCFG = port_cfg(JCFG)
JPARAMS = jmodel.init_params(jax.random.PRNGKey(3), JCFG)
TPARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
PALLAS = KernelConfig(backend="pallas", interpret=True)
RNG = np.random.default_rng(12)


def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def close(got, want, rtol=1e-5, atol=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def trained_trainable(seed=0):
    """A JAX trainable tree as after some training: ``a`` at its init law,
    ``b`` nonzero (so dA != 0), rescalers off their init."""
    rng = np.random.default_rng(seed)
    lora = jlora.init_lora(jax.random.PRNGKey(seed), JCFG, JPARAMS)
    lora = jax.tree.map(
        lambda pair: {"a": pair["a"], "b": jnp.asarray(
            rng.normal(size=pair["b"].shape).astype(np.float32) * 0.05)},
        lora, is_leaf=lambda n: isinstance(n, dict) and set(n) == {"a", "b"})
    resc = {"pos0": jnp.asarray([1.3, 0.7], jnp.float32)}
    return {"lora": lora, "rescaler": resc}


# ---------------------------------------------------------------- configs

def test_train_configs_match_the_reference():
    for name in ("TrainConfig", "FederatedConfig"):
        jc, tc = getattr(jbase, name)(), getattr(tconfigs, name)()
        assert ([f.name for f in dataclasses.fields(jc)]
                == [f.name for f in dataclasses.fields(tc)]), name
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc), name


# ---------------------------------------------------------------- kernels

def _lora_inputs(shape_x, K, N, r, dtype, lead=()):
    rng = np.random.default_rng(sum(shape_x) + r)
    arrs = [rng.normal(size=shape_x), rng.normal(size=lead + (K, N)) / K ** .5,
            rng.normal(size=lead + (K, r)) / K ** .5,
            rng.normal(size=lead + (r, N)) * 0.5]
    arrs = [a.astype(np.float32) for a in arrs]
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_plain_matches_pallas(dtype):
    (jx, jw, ja, jb), (tx, tw, ta, tb) = _lora_inputs((64, 128), 128, 96, 20,
                                                      dtype)
    want = j_lora(jx, jw, ja, jb, scale=0.8, interpret=True)
    got = tref.lora_matmul_ref(tx, tw, ta, tb, 0.8)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    close(got, np.asarray(want, np.float32), tol, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_experts_plain_matches_pallas(dtype):
    (jx, jw, ja, jb), (tx, tw, ta, tb) = _lora_inputs(
        (3, 32, 64), 64, 48, 4, dtype, lead=(3,))
    want = j_lora_experts(jx, jw, ja, jb, scale=0.5, interpret=True)
    got = tref.lora_matmul_experts_ref(tx, tw, ta, tb, 0.5)
    tol = 1e-5 if dtype == "float32" else 1e-2
    close(got, np.asarray(want, np.float32), tol, tol)


def _grads_match(t_fn, j_fn, inputs, n_out=1, tol=1e-5):
    """Forward and every input's gradient of an autograd wrapper against
    ``jax.vjp`` of the JAX op, with a random cotangent."""
    rng = np.random.default_rng(len(inputs))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    tout = t_fn(*tin)
    tout = tout if isinstance(tout, tuple) else (tout,)
    jout, vjp = jax.vjp(j_fn, *[jnp.asarray(a) for a in inputs])
    jout = jout if isinstance(jout, tuple) else (jout,)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in jout]
    cots = cots[:n_out] + [np.zeros(o.shape, np.float32)
                           for o in jout[n_out:]]
    for got, want in zip(tout, jout):
        close(got, want, tol, tol)
    tgrads = torch.autograd.grad(tout[:n_out], tin,
                                 [torch.from_numpy(c) for c in cots[:n_out]])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots) if len(jout) > 1
                 else jnp.asarray(cots[0]))
    for got, want in zip(tgrads, jgrads):
        close(got, want, tol, tol)


def test_lora_matmul_wrapper_grads_match_jax():
    inputs = [a.numpy() for a in _lora_inputs((24, 32), 32, 40, 4,
                                               "float32")[1]]
    _grads_match(lambda x, w, a, b: tbackend.lora_matmul(x, w, a, b,
                                                         scale=0.7),
                 lambda x, w, a, b: jbackend.lora_matmul(PALLAS, x, w, a, b,
                                                         scale=0.7), inputs)


def test_lora_matmul_experts_wrapper_grads_match_jax():
    inputs = [a.numpy() for a in _lora_inputs((2, 16, 32), 32, 24, 4,
                                               "float32", lead=(2,))[1]]
    _grads_match(
        lambda x, w, a, b: tbackend.lora_matmul_experts(x, w, a, b,
                                                        scale=1.3),
        lambda x, w, a, b: jbackend.lora_matmul_experts(PALLAS, x, w, a, b,
                                                        scale=1.3), inputs)


def test_router_wrapper_grads_match_jax():
    logits = RNG.normal(size=(32, 8)).astype(np.float32)
    _grads_match(lambda l: tbackend.router(l, 3),
                 lambda l: jbackend.router(PALLAS, l, 3), [logits], n_out=1)


@pytest.mark.parametrize("KV,window", [(4, 0), (2, 0), (4, 5)])
def test_flash_wrapper_grads_match_jax(KV, window):
    q = RNG.normal(size=(2, 16, 4, 32)).astype(np.float32)
    k = RNG.normal(size=(2, 16, KV, 32)).astype(np.float32)
    v = RNG.normal(size=(2, 16, KV, 32)).astype(np.float32)
    _grads_match(
        lambda q_, k_, v_: tbackend.flash_attention(q_, k_, v_,
                                                    window=window),
        lambda q_, k_, v_: jbackend.flash_attention(PALLAS, q_, k_, v_,
                                                    window=window),
        [q, k, v])


# ---------------------------------------------------------------- MoE layer

def _moe_case(capacity_factor):
    jcfg = JCFG.replace(moe=dataclasses.replace(
        JCFG.moe, capacity_factor=capacity_factor))
    tcfg = port_cfg(jcfg)
    jtr = trained_trainable(1)
    jl = jax.tree.map(lambda a: a[0], jtr["lora"]["blocks"]["pos0"]["moe"])
    tl = lora_from_jax(np32(jl), device="cpu")
    jp = jax.tree.map(lambda a: a[0], JPARAMS["blocks"]["pos0"]["moe"])
    tp = jax.tree.map(lambda a: a[0], TPARAMS["blocks"]["pos0"]["moe"])
    return jcfg, tcfg, jp, tp, jl, tl


@pytest.mark.parametrize("dispatch,cf,k", [
    ("capacity", 1.25, 2), ("capacity", 0.3, 2), ("capacity", 1.25, 1),
    ("dense", 1.25, 2)])
def test_apply_moe_one_hot_dispatch_matches_jax(dispatch, cf, k):
    """Forward and input gradient of capacity / dense dispatch with expert
    adapters and a rescaler; cf = 0.3 drops tokens, so the queue order
    (token order within the group) is exercised."""
    jcfg, tcfg, jp, tp, jl, tl = _moe_case(cf)
    x = RNG.normal(size=(3, 8, 64)).astype(np.float32)
    g = RNG.normal(size=(3, 8, 64)).astype(np.float32)
    scale = jcfg.lora.scale

    def jfn(x_):
        out, aux = jmoe.apply_moe(jp, jcfg, x_, k=k, rescaler=jnp.float32(1.4),
                                  lora=jl, lora_scale=scale,
                                  dispatch=dispatch)
        return out, aux.activation_counts

    (jout, jcounts), vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(g), jnp.zeros_like(jcounts)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, taux = t_apply_moe(tp, tcfg, tx, k=k, rescaler=torch.tensor(1.4),
                             lora=tl, lora_scale=scale, dispatch=dispatch)
    close(tout, jout)
    np.testing.assert_array_equal(taux.activation_counts.numpy(),
                                  np.asarray(jcounts))
    (tdx,) = torch.autograd.grad(tout, tx, torch.from_numpy(g))
    close(tdx, jdx)
    if cf < 1:      # the case drops tokens: some routed pair got no slot
        n_tok = x.shape[0] * x.shape[1]
        C = jmoe._capacity(n_tok, 4, k, cf)
        assert int(np.asarray(jcounts).max()) > C


def test_capacity_rule_matches_reference():
    from repro_torch.models import moe_layer as tmoe
    for n in (1, 7, 64, 2048 * 8, 12345):
        for cf in (0.3, 1.0, 1.25):
            assert (tmoe._capacity_from_assignments(n, 64, cf)
                    == jmoe._capacity_from_assignments(n, 64, cf))
    assert tmoe.dense_capacity(2048) == jmoe.dense_capacity(2048)
    for d, nd in ((None, False), (None, True), ("ragged", False)):
        assert tmoe.resolve_dispatch(d, nd) == jmoe.resolve_dispatch(d, nd)


# ---------------------------------------------------------------- model

def test_lm_loss_and_grads_match_jax():
    """The LM loss and the gradient of every trainable leaf (attention and
    expert adapters, rescalers) through the whole two-layer model."""
    jtr = trained_trainable(2)
    ttr = trainable_from_jax(np32(jtr), device="cpu")
    tok = RNG.integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    msk = (RNG.random((2, 16)) > 0.2).astype(np.float32)

    def jloss(tr):
        return jmodel.lm_loss(JCFG, JPARAMS, jnp.asarray(tok),
                              jnp.asarray(lab), jnp.asarray(msk),
                              trainable=tr, k=2)

    (jl, jcounts), jg = jax.value_and_grad(jloss, has_aux=True)(jtr)
    leaves, treedef = jax.tree_util.tree_flatten(ttr)
    leaves = [t.requires_grad_(True) for t in leaves]
    ttr = jax.tree_util.tree_unflatten(treedef, leaves)
    tl, tcounts = tmodel.lm_loss(TCFG, TPARAMS, torch.from_numpy(tok),
                                 torch.from_numpy(lab), torch.from_numpy(msk),
                                 trainable=ttr, k=2)
    close(tl, jl, 1e-5, 1e-6)
    np.testing.assert_array_equal(tcounts["pos0"].numpy(),
                                  np.asarray(jcounts["pos0"]))
    tg = torch.autograd.grad(tl, leaves)
    for got, want in zip(tg, jax.tree_util.tree_leaves(jg)):
        close(got, want, 1e-4, 1e-6)


# ---------------------------------------------------------------- optimizer

def test_adam_update_matches_jax_with_mask_and_clipping():
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    mask = {"a": True, "b": {"c": False, "d": True}}
    jp, tp = jax.tree.map(jnp.asarray, params), jax.tree.map(
        torch.from_numpy, params)
    js, ts = jadam.init(jp), tadam.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                         * 3.0, params)
        kw = dict(lr=1e-2, weight_decay=0.01, grad_clip=1.0)
        jp, js = jadam.update(jax.tree.map(jnp.asarray, g), js, jp,
                              mask=mask, **kw)
        tp, ts = tadam.update(jax.tree.map(torch.from_numpy, g), ts, tp,
                              mask=mask, **kw)
        for got, want in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            close(got, want, 1e-6, 1e-7)
        assert ts.step == int(js.step) == step + 1
    np.testing.assert_array_equal(tp["b"]["c"].numpy(), params["b"]["c"])


def test_padding_steps_are_exact_noops():
    """A plan padded with invalid steps trains to the same bits as the
    plain plan: trainable, Adam step count, counts, tokens and loss."""
    exp = t_build(TCFG, fed=_FED, tc=_TC, data=_DATA, base_params=TPARAMS,
                  device="cpu")
    c = exp.server.clients[0]
    plan = tclient.make_batch_plan(c, _TC, 0)
    padded = tclient.pad_plan(plan, plan.n_steps + 2)
    assert padded.valid.tolist() == [1.0] * plan.n_steps + [0.0, 0.0]
    tr = tlora.make_trainable(exp.server.global_lora, c.rescaler)
    kw = dict(k=c.k, tc=_TC, rescaler_trainable=True)
    a = tclient.local_update(TCFG, TPARAMS, tr, plan.tokens, plan.labels,
                             plan.mask, plan.valid, **kw)
    b = tclient.local_update(TCFG, TPARAMS, tr, padded.tokens, padded.labels,
                             padded.mask, padded.valid, **kw)
    for x, y in zip(jax.tree.leaves([to_numpy(t) for t in a]),
                    jax.tree.leaves([to_numpy(t) for t in b])):
        np.testing.assert_array_equal(x, y)
    assert float(a[4]) == plan.n_steps


# ---------------------------------------------------------------- data

_DATA = tsyn.DataConfig(vocab_size=128, n_examples=80, seq_len=16,
                        n_clusters=4)
_JDATA = jsyn.DataConfig(**dataclasses.asdict(_DATA))
_TC = tconfigs.TrainConfig(batch_size=7)
_JTC = jbase.TrainConfig(**dataclasses.asdict(_TC))
_FED = tconfigs.FederatedConfig(num_clients=4, rounds=1, round_engine="looped",
                                dirichlet_alpha=100.0)
_JFED = jbase.FederatedConfig(**dataclasses.asdict(_FED))


def test_corpus_partition_and_plans_are_byte_identical():
    jc, tc = jsyn.make_corpus(_JDATA), tsyn.make_corpus(_DATA)
    for f in ("tokens", "labels", "mask", "clusters"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    jtrain = jsyn.split_corpus(jc)[0]
    ttrain = tsyn.split_corpus(tc)[0]
    js = jpart.dirichlet_partition(jtrain, 4, 0.5, seed=3)
    ts = tpart.dirichlet_partition(ttrain, 4, 0.5, seed=3)
    for a, b in zip(js, ts):
        assert a.tokens.tobytes() == b.tokens.tobytes()
        assert a.clusters.tobytes() == b.clusters.tobytes()
    jcl = jclient.ClientState(client_id=2, shard=js[1], k=1, rank=4,
                              rescaler=None)
    tcl = tclient.ClientState(client_id=2, shard=ts[1], k=1, rank=4,
                              rescaler=None)
    jplan = jclient.pad_plan(jclient.make_batch_plan(jcl, _JTC, 7), 9)
    tplan = tclient.pad_plan(tclient.make_batch_plan(tcl, _TC, 7), 9)
    for f in ("tokens", "labels", "mask", "valid"):
        assert getattr(jplan, f).tobytes() == getattr(tplan, f).tobytes(), f
    assert (tclient.plan_batch_size(tcl, _TC)
            == jclient.plan_batch_size(jcl, _JTC))


# ---------------------------------------------------------------- aggregation

@pytest.mark.parametrize("stacked", [False, True])
def test_flame_aggregate_matches_jax(stacked):
    rng = np.random.default_rng(9)
    n = 3
    loras = [np32(trained_trainable(10 + i)["lora"]) for i in range(n)]
    prev = np32(trained_trainable(20)["lora"])
    freqs = [{"pos0": rng.random((2, 4)).astype(np.float32)}
             for _ in range(n)]
    for f in freqs:                     # expert 3 of period 1: zero mass
        f["pos0"][1, 3] = 0.0
    sizes = [5.0, 9.0, 2.0]
    jin = (jlora.stack_adapters([jax.tree.map(jnp.asarray, l) for l in loras])
           if stacked else [jax.tree.map(jnp.asarray, l) for l in loras])
    jfr = ({"pos0": jnp.stack([f["pos0"] for f in freqs])} if stacked
           else freqs)
    want = jagg.flame_aggregate(jin, jfr, sizes, 2,
                                prev_lora=jax.tree.map(jnp.asarray, prev))
    tls = [lora_from_jax(l, device="cpu") for l in loras]
    tin = (jax.tree.map(lambda *ls: torch.stack(ls), *tls) if stacked
           else tls)
    tfr = ({"pos0": torch.from_numpy(np.stack([f["pos0"] for f in freqs]))}
           if stacked else freqs)
    got = tagg.flame_aggregate(tin, tfr, sizes, 2,
                               prev_lora=lora_from_jax(prev, device="cpu"))
    for g, w in zip(jax.tree.leaves(to_numpy(got)), jax.tree.leaves(want)):
        close(g, w, 1e-6, 1e-6)
    kept = got["blocks"]["pos0"]["moe"]["experts"]["w1"]["a"][1, 3]
    np.testing.assert_array_equal(
        kept.numpy(), prev["blocks"]["pos0"]["moe"]["experts"]["w1"]["a"][1, 3])
    fa = tagg.fedavg(tls, sizes)
    ja = jagg.fedavg([jax.tree.map(jnp.asarray, l) for l in loras], sizes)
    for g, w in zip(jax.tree.leaves(to_numpy(fa)), jax.tree.leaves(ja)):
        close(g, w, 1e-6, 1e-6)


# ---------------------------------------------------------------- one round

@pytest.fixture(scope="module")
def rounds():
    """One looped FLAME round in each package from the same weights,
    adapters, data and budgets (the JAX side's ``build_experiment``)."""
    jexp = j_build(JCFG, fed=_JFED, tc=_JTC, data=_JDATA,
                   base_params=JPARAMS)
    texp = t_build(TCFG, fed=_FED, tc=_TC, data=_DATA, base_params=TPARAMS,
                   device="cpu")
    texp.server.global_lora = lora_from_jax(np32(jexp.server.global_lora),
                                            device="cpu")
    before = np32(jexp.server.global_lora)
    jres = jexp.server.run_round(0)
    tres = texp.server.run_round(0)
    return jexp, texp, jres, tres, before


def test_round_budgets_and_data_match(rounds):
    jexp, texp, jres, tres, _ = rounds
    assert tres.participating == jres.participating
    for jc, tc in zip(jexp.server.clients, texp.server.clients):
        assert (jc.k, jc.rank, jc.budget) == (tc.k, tc.rank, tc.budget)
        assert jc.shard.tokens.tobytes() == tc.shard.tokens.tobytes()
    assert texp.val.tokens.tobytes() == jexp.val.tokens.tobytes()


def test_round_losses_and_counts_match(rounds):
    _, _, jres, tres, _ = rounds
    np.testing.assert_allclose(tres.client_losses, jres.client_losses,
                               rtol=1e-5)
    for tf, jf in zip(tres.client_freqs, jres.client_freqs):
        np.testing.assert_array_equal(tf["pos0"], np.asarray(jf["pos0"]))


def test_round_rescalers_trained_and_match(rounds):
    jexp, texp, _, _, _ = rounds
    for jc, tc in zip(jexp.server.clients, texp.server.clients):
        j, t = np.asarray(jc.rescaler["pos0"]), tc.rescaler["pos0"].numpy()
        close(t, j, 1e-5, 1e-6)
        assert not np.allclose(t, JCFG.moe.top_k / jc.k, rtol=0, atol=1e-7)


def test_round_aggregate_matches(rounds):
    jexp, texp, _, _, before = rounds
    n_steps = max(len(c.shard.tokens) // _TC.batch_size
                  for c in texp.server.clients)
    bound = 2 * _TC.learning_rate * n_steps
    got = jax.tree.leaves(to_numpy(texp.server.global_lora))
    want = jax.tree.leaves(np32(jexp.server.global_lora))
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
    assert diff.max() <= bound, (diff.max(), bound)
    moved = [np.abs(g - b).max() for g, b in zip(
        got, jax.tree.leaves(before))]
    assert max(moved) > 0          # the round trained something


def test_train_launcher_runs_on_cpu(capsys):
    ttrain.main(["--federated", "--device", "cpu", "--clients", "4",
                 "--rounds", "1"])
    out = capsys.readouterr().out
    assert "olmoe-smoke on cpu" in out and "round 0: 4 clients" in out
    assert "done" in out


_MESH_TRAIN = ["--device", "cpu", "--variant", "smoke", "--world", "2",
               "--timeout", "300",
               "--batch", "4", "--seq-len", "16", "--steps", "2"]


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--shape", "train_4k", "--arch", "qwen3-moe-235b-a22b"]
                 + _MESH_TRAIN, "{'data': 1, 'model': 2}",
                 id="argv0-multi-chip"),
    pytest.param(["--multi-pod", "--arch", "llama3-405b"] + _MESH_TRAIN,
                 "{'pod': 2, 'data': 1, 'model': 1}", id="argv1-multi-chip"),
])
def test_train_launcher_rejects_later_slice_flags(argv, match, capfd):
    # --shape and --multi-pod (a later slice once, ported now): the
    # sharded train step on a 2-rank gloo world at smoke size
    ttrain.main(argv)
    out = capfd.readouterr().out
    assert "cut: batch 256 -> 4, sequence 4096 -> 16" in out
    assert f"on mesh {match}: n_micro 1" in out
    losses = [float(line.split("loss ")[1].split(",")[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out.rstrip().endswith("done")


def test_server_refuses_unported_engines():
    """The device round driver (ported now) refuses what the reference's
    refuses: a method other than FLAME, with the reference's message."""
    from repro_torch.federated.server import FederatedServer

    server = FederatedServer(
        TCFG, TPARAMS, {}, [],
        tconfigs.FederatedConfig(round_driver="device", method="hlora"),
        tconfigs.TrainConfig())
    with pytest.raises(ValueError, match="supports method='flame' only"):
        server.run()
