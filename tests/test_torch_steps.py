"""The port's single-device step functions (``repro_torch.launch.steps``)
and layer checkpointing against the JAX package's ``repro.launch.steps``
on a 1x1 local mesh, at float32 on the CPU.

Both sides take the same seeded weights, adapters (``b`` drawn nonzero
with numpy), Adam state and numpy-made batches.  Tolerances: the loss within
1e-6 relative and the activation counts exactly (the same routing); the
updated trainable tree and Adam's first moment within 1e-5 (float32, only
the summation order differs); prefill and decode logits within 1e-5.
Layer checkpointing recomputes the same operations on the same values, so
with and without it the loss, counts and gradients are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.configs import registry as jreg
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import lora as jlora
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.models import model as jmodel
from repro.optim import adam as jadam
from repro_torch import configs as tconfigs
from repro_torch.convert import (config_from_jax, params_from_jax,
                                 to_numpy, trainable_from_jax)
from repro_torch.core import lora as tlora
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim import adam as tadam
from repro_torch.tree import leaves

MESH = make_local_mesh()


def _fill_b(tree, rng, std=0.05):
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, std, np.shape(v)).astype(np.float32)
                    if k == "b" else _fill_b(v, rng, std))
                for k, v in tree.items()}
    return np.asarray(tree)


def _state(jcfg, k, seed=0):
    """Seeded weights (JAX arrays) and a trainable tree (numpy leaves),
    made once and handed to both packages."""
    tcfg = config_from_jax(jcfg)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    lora = _fill_b(to_numpy(tlora.init_lora(
        torch.Generator().manual_seed(seed + 1), tcfg, tp)),
        np.random.default_rng(seed))
    resc = jlora.init_rescalers(jcfg, k) if jcfg.moe.enabled else None
    tr = jlora.make_trainable(lora, None if resc is None else jax.tree.map(
        np.asarray, resc))
    return jax.tree.map(jnp.asarray, to_numpy(tp)), tr


def _batch(jcfg, B, S, seed=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return tokens, np.roll(tokens, -1, axis=1), mask


def _close(got, want, tol):
    g, w = jax.tree.leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                                   atol=tol)


def _dense():
    return jreg.get_config("olmo-1.3b", "smoke").replace(dtype="float32")


# ---------------------------------------------------------------- train step

@pytest.mark.parametrize("which", ["moe", "dense"])
def test_build_train_matches_jax(which):
    jcfg = tiny_moe() if which == "moe" else _dense()
    k = jcfg.moe.top_k or None
    jp, tr = _state(jcfg, k or 0)
    B, S = 4, 32
    tokens, labels, mask = _batch(jcfg, B, S)
    with MESH:
        jb = jsteps.build_train(jcfg, JShape("smoke_train", S, B, "train"),
                                MESH, n_micro=2, tc=JTrainConfig())
        jnew, jopt, jm = jb.fn(jp, jax.tree.map(jnp.asarray, tr),
                               jadam.init(jax.tree.map(jnp.asarray, tr)),
                               tokens, labels, mask)
    tcfg = config_from_jax(jcfg)
    tb = tsteps.build_train(tcfg, tconfigs.ShapeConfig("smoke_train", S, B,
                                                       "train"),
                            n_micro=2, tc=tconfigs.TrainConfig(),
                            device="cpu")
    for key in ("n_micro", "act_mode", "num_groups", "k", "remat",
                "remat_chunk", "param_bytes", "trainable_bytes"):
        assert tb.meta[key] == jb.meta[key], key
    ttr = trainable_from_jax(tr, device="cpu")
    tnew, topt, tm = tb.fn(params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu"),
                           ttr, tadam.init(ttr), torch.tensor(tokens),
                           torch.tensor(labels), torch.tensor(mask))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    assert tm["tokens"] == float(jm["tokens"]) == B * S
    assert set(tm["counts"]) == set(jm["counts"])
    for key, c in jm["counts"].items():
        np.testing.assert_array_equal(tm["counts"][key].numpy(),
                                      np.asarray(c))
    if which == "moe":
        # 2 layers x (B·S tokens) x k
        assert float(tm["counts"]["pos0"].sum()) == 2 * B * S * k
    assert topt.step == int(jopt.step) == 1
    _close(tnew, jnew, 1e-5)
    _close(topt.mu, jopt.mu, 1e-5)
    moved = [float((a - b).abs().max()) for a, b in zip(leaves(tnew),
                                                        leaves(ttr))]
    assert max(moved) > 0


def _remat_case():
    """A 4-period MoE config (so a √L group of 2 sits inside the stack)."""
    cfg = config_from_jax(tiny_moe(num_layers=4))
    jp, tr = _state(tiny_moe(num_layers=4), 2, seed=5)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), tr


@pytest.mark.parametrize("remat,chunk", [(True, 0), (True, 2), (True, 3)])
def test_remat_leaves_loss_counts_and_grads_unchanged(remat, chunk):
    """Per-period checkpointing (chunk 0), √L groups of 2, and chunk 3
    (lowered to 2, a divisor of 4 periods) against the plain loop."""
    cfg, params, tr = _remat_case()
    tokens, labels, mask = (torch.tensor(a) for a in _batch(tiny_moe(), 2, 16))

    def run(remat, chunk):
        t = trainable_from_jax(tr, device="cpu")
        flat = [x.requires_grad_(True) for x in leaves(t)]
        loss, counts = tmodel.lm_loss(cfg, params, tokens, labels, mask,
                                      trainable=t, k=2, remat=remat,
                                      remat_chunk=chunk)
        return loss, counts, torch.autograd.grad(loss, flat)

    want, got = run(False, 0), run(remat, chunk)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]["pos0"], want[1]["pos0"])
    assert all(torch.equal(g, w) for g, w in zip(got[2], want[2]))


def test_train_step_with_and_without_remat_is_bit_equal():
    cfg, params, tr = _remat_case()
    batch = [torch.tensor(a) for a in _batch(tiny_moe(), 4, 16)]
    shape = tconfigs.ShapeConfig("t", 16, 4, "train")
    out = []
    for remat, chunk in ((False, 0), (True, 2)):
        b = tsteps.build_train(cfg, shape, n_micro=2, remat=remat,
                               remat_chunk=chunk, device="cpu")
        assert (b.meta["remat"], b.meta["remat_chunk"]) == (remat, chunk)
        t = trainable_from_jax(tr, device="cpu")
        out.append(b.fn(params, t, tadam.init(t), *batch))
    (t0, o0, m0), (t1, o1, m1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(t0), leaves(t1)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(o0.nu),
                                                 leaves(o1.nu)))


# ---------------------------------------------------------- prefill / serve

@pytest.mark.parametrize("which", ["moe", "dense"])
def test_build_prefill_and_serve_match_jax(which):
    jcfg = tiny_moe() if which == "moe" else _dense()
    jp, tr = _state(jcfg, jcfg.moe.top_k, seed=3)
    tcfg = config_from_jax(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ttr = trainable_from_jax(tr, device="cpu")
    tokens = _batch(jcfg, 2, 16)[0]
    with MESH:
        jb = jsteps.build_prefill(jcfg, JShape("p", 16, 2, "prefill"), MESH)
        jlog, jcache = jb.fn(jp, jax.tree.map(jnp.asarray, tr), tokens)
    tb = tsteps.build_prefill(tcfg, tconfigs.ShapeConfig("p", 16, 2,
                                                         "prefill"))
    assert tb.meta == jb.meta
    tlog, tcache = tb.fn(tp, ttr, torch.tensor(tokens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    _close(tcache, jax.tree.map(np.asarray, jcache), 1e-5)

    # one decode token at position 5 against a seeded 24-deep cache
    rng = np.random.default_rng(4)
    cache = jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape))
                         .astype(np.float32),
                         jmodel.init_cache(jcfg, 2, 24))
    tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    tcache = jax.tree.map(lambda a: torch.tensor(a), cache)
    with MESH:
        jb = jsteps.build_serve(jcfg, JShape("d", 24, 2, "decode"), MESH,
                                k=1)
        jlog, jcache = jb.fn(jp, jax.tree.map(jnp.asarray, tr),
                             jax.tree.map(jnp.asarray, cache), tok,
                             jnp.asarray(5, jnp.int32))
    tb = tsteps.build_serve(tcfg, tconfigs.ShapeConfig("d", 24, 2,
                                                       "decode"), k=1)
    assert tb.meta == jb.meta
    tlog, tcache = tb.fn(tp, ttr, tcache, torch.tensor(tok),
                         torch.tensor(5, dtype=torch.int32))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    _close(tcache, jax.tree.map(np.asarray, jcache), 1e-5)


# ---------------------------------------------------------------- knobs

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_bundle_args_have_the_reference_shapes(kind):
    jcfg = tiny_moe()
    shape = dict(train=("t", 32, 4, "train"), prefill=("p", 32, 2, "prefill"),
                 decode=("d", 64, 2, "decode"))[kind]
    with MESH:
        jb = jsteps.build_step(jcfg, JShape(*shape), MESH)
    extra = {"device": "cpu"} if kind == "train" else {}
    tb = tsteps.build_step(config_from_jax(jcfg),
                           tconfigs.ShapeConfig(*shape), **extra)
    assert tb.name == jb.name

    def sig(tree):
        return [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in jax.tree.leaves(tree)]

    def trees(a):
        if isinstance(a, (tadam.AdamState, jadam.AdamState)):
            return {"mu": a.mu, "nu": a.nu}        # the step is a scalar
        return a

    assert [sig(trees(a)) for a in tb.args] == \
        [sig(trees(a)) for a in jb.args]
    assert all(t.device.type == "meta" for a in tb.args
               for t in leaves(trees(a)))


def test_knobs_scale_with_model_size_and_match_the_reference_grouping():
    """As the reference's test: a bigger model needs at least as many
    microbatches at train_4k (here on an 80 GiB card); the √L chunk and
    the routing groups are the reference's at data parallelism 1."""
    shape = tconfigs.INPUT_SHAPES["train_4k"]
    mem = 80 * 2 ** 30
    small = tsteps.choose_train_knobs(tconfigs.get_config("olmo-1.3b"),
                                      shape, memory_bytes=mem)
    big = tsteps.choose_train_knobs(tconfigs.get_config("chameleon-34b"),
                                    shape, memory_bytes=mem)
    assert big["n_micro"] >= small["n_micro"]
    assert big["act_budget"] < small["act_budget"]
    for knobs in (small, big):
        assert knobs["act_mode"] == "batch"
        assert knobs["act_bytes"] <= knobs["act_budget"] or \
            knobs["n_micro"] == shape.global_batch
    for arch in tconfigs.list_archs():
        tk = tsteps.choose_train_knobs(tconfigs.get_config(arch), shape,
                                       memory_bytes=mem)
        jk = jsteps.choose_train_knobs(jreg.get_config(arch),
                                       J_SHAPES["train_4k"], MESH)
        assert tk["remat_chunk"] == jk["remat_chunk"], arch
        for batch, seq in ((1, 64), (4, 4096), (256, 4096), (3, 1000)):
            assert tsteps.choose_num_groups(
                tconfigs.get_config(arch), batch, seq) == \
                jsteps.choose_num_groups(jreg.get_config(arch), batch, seq,
                                         MESH), (arch, batch, seq)


# ---------------------------------------------------------------- launcher

@pytest.mark.parametrize("arch", ["olmoe-1.3b-6.9b", "olmo-1.3b"])
def test_train_launcher_local_runs_on_cpu(arch, capsys):
    ttrain.main(["--local", "--device", "cpu", "--steps", "2", "--arch",
                 arch])
    out = capsys.readouterr().out
    assert "local_train on cpu: knobs=" in out and "done" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
