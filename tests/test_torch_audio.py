"""Audio codebooks (``musicgen-large``) in the port against the JAX
package, at float32 on the CPU.

The configs (full, smoke, swa) and their parameter and FLOPs counts; the
codebook corpus; the model on SMOKE widths (K = 2 codebooks, V = 128):
logits (B, S, K, V), the codebook loss (each position's NLL the mean over
its K codebooks, taken before the mask) and the LoRA gradients, with an
untied and a tied head; one train step of ``launch/steps.py`` against
``repro.launch.steps`` on a 1x1 local mesh; a round state's checkpoint
round trip; and both launchers' refusals.

Weights come from the port's seeded init and go to JAX as numpy; the
JAX side runs its ``backend="reference"`` path.  Tolerances: logits 1e-5
and the loss 1e-6 relative (float32, only the summation order differs),
each gradient leaf within 1e-5 in relative L2, the train step's updated
adapters and Adam moments within 1e-5 (``tests/test_torch_steps.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import registry as jreg
from repro.configs.base import KernelConfig
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import flops as jflops
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import make_local_mesh
from repro.models import model as jmodel
from repro.optim import adam as jadam
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import io as tckpt
from repro_torch.convert import (config_from_jax, lora_from_jax, to_numpy,
                                 trainable_from_jax)
from repro_torch.core import flops as tflops
from repro_torch.core import lora as tlora
from repro_torch.data import synthetic as tsyn
from repro_torch.federated.simulation import build_experiment as t_build
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim import adam as tadam
from repro_torch.tree import leaves

ARCH = "musicgen-large"


def _fill_b(tree, rng, std=0.05):
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, std, np.shape(v)).astype(np.float32)
                    if k == "b" else _fill_b(v, rng, std))
                for k, v in tree.items()}
    return np.asarray(tree)


class Case:
    """SMOKE at fp32 (tied or not): the port's seeded weights and adapter
    (``b`` drawn off zero with numpy) in both packages, and a (B, S, K)
    batch with a (B, S) mask."""

    def __init__(self, tied: bool):
        self.jcfg = jreg.get_config(ARCH, "smoke").replace(
            dtype="float32", tie_embeddings=tied,
            kernels=KernelConfig(backend="reference"))
        self.tcfg = config_from_jax(self.jcfg)
        self.tparams = tmodel.init_params(
            self.tcfg, torch.Generator().manual_seed(0), "cpu")
        self.np_params = to_numpy(self.tparams)
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)
        self.np_lora = _fill_b(to_numpy(tlora.init_lora(
            torch.Generator().manual_seed(1), self.tcfg, self.tparams)),
            np.random.default_rng(0))
        rng = np.random.default_rng(1)
        K, V = self.jcfg.num_codebooks, self.jcfg.vocab_size
        self.tokens = rng.integers(0, V, (2, 24, K)).astype(np.int32)
        self.labels = np.roll(self.tokens, -1, axis=1)
        self.mask = (rng.random((2, 24)) > 0.25).astype(np.float32)


@pytest.fixture(scope="module", params=["untied", "tied"])
def case(request):
    return Case(request.param == "tied")


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- configs

def test_configs_counts_and_flops_match_the_reference():
    for variant in ("full", "smoke", "swa"):
        assert tconfigs.get_config(ARCH, variant) == config_from_jax(
            jreg.get_config(ARCH, variant)), variant
    full = tconfigs.get_config(ARCH)
    assert (full.num_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim_, full.d_ff, full.vocab_size,
            full.num_codebooks, full.lora.rank) == (
        48, 2048, 32, 32, 64, 8192, 2048, 4, 16)
    assert tconfigs.get_config(ARCH, "swa").attention_window == 8192
    jfull = jreg.get_config(ARCH)
    assert tflops.count_params(full)["total"] == 3_254_978_560 == \
        jflops.count_params(jfull)["total"]
    assert tflops.count_params(full) == jflops.count_params(jfull)
    assert tflops.lora_param_counts(full) == jflops.lora_param_counts(jfull)
    # the embedding and head of each of the 4 codebooks are counted
    assert tflops.flops_detailed(full, tokens=4096, seq_len=4096,
                                 backward=True) == jflops.flops_detailed(
        jfull, tokens=4096, seq_len=4096, backward=True)
    assert tflops.flops_paper_convention(full, tokens=4096) == \
        jflops.flops_paper_convention(jfull, tokens=4096)
    # the tree the port builds at full size has those parameters
    tree = tsteps.abstract_params(full)
    assert sum(t.numel() for t in leaves(tree)) == 3_254_978_560
    assert tree["embed"]["tokens"].shape == (4, 2048, 2048)
    assert tree["lm_head"].shape == (4, 2048, 2048)


def test_codebook_corpus_equals_the_reference():
    data = dict(vocab_size=128, n_examples=12, seq_len=20, n_clusters=3,
                num_codebooks=4)
    t = tsyn.make_corpus(tsyn.DataConfig(**data))
    j = jsyn.make_corpus(jsyn.DataConfig(**data))
    for f in ("tokens", "labels", "mask", "clusters"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t.tokens.shape == t.labels.shape == (12, 20, 4)
    assert t.mask.shape == (12, 20)
    # codebook k is codebook 0 shifted by 7k mod V; labels rolled by one,
    # eos at the end
    for k in range(4):
        np.testing.assert_array_equal(t.tokens[..., k],
                                      (t.tokens[..., 0] + 7 * k) % 128)
    np.testing.assert_array_equal(t.labels[:, :-1], t.tokens[:, 1:])
    assert (t.labels[:, -1] == 2).all()


# ---------------------------------------------------------------- model

def test_tree_layout_matches_the_reference(case):
    want = jax.eval_shape(lambda key: jmodel.init_params(key, case.jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), case.tparams) == \
        jax.tree.map(lambda a: a.shape, want)
    K, V, D = 2, 128, 256
    assert case.tparams["embed"]["tokens"].shape == (K, V, D)
    assert ("lm_head" in case.tparams) == (not case.jcfg.tie_embeddings)


def test_logits_and_codebook_loss_match_jax(case):
    tr = {"lora": lora_from_jax(case.np_lora, device="cpu")}
    jtr = {"lora": jax.tree.map(jnp.asarray, case.np_lora)}
    tl, _ = tmodel.forward(case.tcfg, case.tparams,
                           torch.tensor(case.tokens), trainable=tr)
    jl, _ = jmodel.forward(case.jcfg, case.jparams,
                           jnp.asarray(case.tokens), trainable=jtr)
    assert tl.shape == (2, 24, 2, 128) == jl.shape
    close(tl, jl, 1e-5)
    tloss, _ = tmodel.lm_loss(case.tcfg, case.tparams,
                              torch.tensor(case.tokens),
                              torch.tensor(case.labels),
                              torch.tensor(case.mask), trainable=tr)
    jloss, _ = jmodel.lm_loss(case.jcfg, case.jparams,
                              jnp.asarray(case.tokens),
                              jnp.asarray(case.labels),
                              jnp.asarray(case.mask), trainable=jtr)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    # the mean over codebooks comes before the mask: the loss is the
    # masked mean of per-position codebook means, from the logits
    lp = torch.log_softmax(tl.double(), -1)
    nll = -torch.gather(lp, -1, torch.tensor(case.labels)[..., None].long()
                        )[..., 0].mean(-1)
    m = torch.tensor(case.mask).double()
    np.testing.assert_allclose(float(tloss), float((nll * m).sum() / m.sum()),
                               rtol=1e-6)


def test_lora_gradients_match_jax(case):
    def jloss(tr, params, tokens, labels, mask):
        return jmodel.lm_loss(case.jcfg, params, tokens, labels, mask,
                              trainable=tr)[0]

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(
        {"lora": jax.tree.map(jnp.asarray, case.np_lora)}, case.jparams,
        jnp.asarray(case.tokens), jnp.asarray(case.labels),
        jnp.asarray(case.mask))
    tr = {"lora": lora_from_jax(case.np_lora, device="cpu")}
    flat = [t.requires_grad_(True) for t in leaves(tr)]
    tval, _ = tmodel.lm_loss(case.tcfg, case.tparams,
                             torch.tensor(case.tokens),
                             torch.tensor(case.labels),
                             torch.tensor(case.mask), trainable=tr)
    tgrads = torch.autograd.grad(tval, flat)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(tgrads) > 0
    for g, w in zip(tgrads, jflat):
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-5, rel


# ---------------------------------------------------------------- train step

def test_train_step_matches_jax():
    """``build_train`` (2 microbatches, layer checkpointing) against the
    reference's on (B, S, K) tokens: loss, updated adapters, Adam's first
    moment, and the knobs both report."""
    case = Case(tied=False)
    B, S = 4, 16
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 128, (B, S, 2)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    tr = {"lora": case.np_lora}
    with make_local_mesh() as mesh:
        jb = jsteps.build_train(case.jcfg, JShape("t", S, B, "train"), mesh,
                                n_micro=2, tc=JTrainConfig())
        jtr = jax.tree.map(jnp.asarray, tr)
        jnew, jopt, jm = jb.fn(case.jparams, jtr, jadam.init(jtr), tokens,
                               labels, mask)
    tb = tsteps.build_train(case.tcfg, tconfigs.ShapeConfig("t", S, B,
                                                            "train"),
                            n_micro=2, tc=tconfigs.TrainConfig(),
                            device="cpu")
    for key in ("n_micro", "act_mode", "num_groups", "k", "remat",
                "remat_chunk", "param_bytes", "trainable_bytes"):
        assert tb.meta[key] == jb.meta[key], key
    # the example args carry the codebook axis, as the reference's specs
    assert [tuple(a.shape) for a in tb.args[3:]] == [
        tuple(a.shape) for a in jb.args[3:]] == [(B, S, 2), (B, S, 2),
                                                 (B, S)]
    ttr = trainable_from_jax(tr, device="cpu")
    tnew, topt, tm = tb.fn(case.tparams, ttr, tadam.init(ttr),
                           torch.tensor(tokens), torch.tensor(labels),
                           torch.tensor(mask))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    assert tm["tokens"] == float(jm["tokens"]) == B * S
    for got, want in ((tnew, jnew), (topt.mu, jopt.mu)):
        g, w = jax.tree.leaves(to_numpy(got)), jax.tree.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
    # the launcher's batch is the reference's shape
    cfg = tconfigs.get_config(ARCH, "smoke")
    shape = tconfigs.ShapeConfig("local_train", 64, 8, "train")
    tok, lab, m = ttrain.synthetic_batch(cfg, shape, torch.Generator(), "cpu")
    jtok, jlab, jm_ = jtrain.synthetic_batch(jreg.get_config(ARCH, "smoke"),
                                             JShape("local_train", 64, 8,
                                                    "train"),
                                             jax.random.PRNGKey(0))
    assert tok.shape == lab.shape == jtok.shape == (8, 64, 2)
    assert m.shape == jm_.shape == (8, 64)
    assert torch.equal(lab, torch.roll(tok, -1, dims=1))


# ---------------------------------------------------------------- checkpoint

def test_round_state_checkpoint_round_trip(tmp_path):
    """One FLAME round on (B, S, K) data, saved: the file loads back bit
    for bit in the port and in the reference (its npz format), and a run
    resumed from it equals the straight run."""
    cfg = tconfigs.get_config(ARCH, "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = tsyn.DataConfig(vocab_size=128, n_examples=48, seq_len=16,
                           n_clusters=3, num_codebooks=2)
    fed = tconfigs.FederatedConfig(num_clients=3, rounds=2)

    def exp(rounds):
        return t_build(cfg, fed=dataclasses.replace(fed, rounds=rounds),
                       tc=tconfigs.TrainConfig(batch_size=8), data=data,
                       base_params=params, device="cpu")

    straight = exp(2)
    assert straight.server.clients[0].shard.tokens.shape[1:] == (16, 2)
    full = straight.server.run()
    path = str(tmp_path / "state.npz")
    first = exp(1)
    first.server.run(checkpoint_to=path)
    tree, meta = tckpt.load(path)
    assert meta["round_idx"] == 1
    jtree, jmeta = jckpt.load(path)
    assert jmeta == meta
    got = to_numpy(first.server.global_lora)
    assert jax.tree.structure(jtree["global_lora"]) == \
        jax.tree.structure(got)
    for a, b, c in zip(jax.tree.leaves(got),
                       jax.tree.leaves(jtree["global_lora"]),
                       jax.tree.leaves(to_numpy(tree["global_lora"]))):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    resumed = exp(2)
    rest = resumed.server.run(resume_from=path)
    assert [r.round_idx for r in rest] == [1]
    assert rest[0].client_losses == full[1].client_losses
    for a, b in zip(leaves(resumed.server.global_lora),
                    leaves(straight.server.global_lora)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- launchers

def test_launchers_train_locally_and_refuse_what_the_reference_cannot(capsys):
    """``train.py --local`` trains the audio arch on (B, S, K) batches;
    ``train.py --federated`` stops at once (the reference's launcher
    crashes there: its corpus is (B, S) text) and ``serve.py`` refuses it
    with the reference's message (the engine is text-only)."""
    ttrain.main(["--local", "--device", "cpu", "--arch", ARCH, "--steps",
                 "1"])
    out = capsys.readouterr().out
    assert "musicgen-smoke x local_train" in out and "done" in out
    with pytest.raises(SystemExit, match="codebook tokens"):
        ttrain.main(["--federated", "--device", "cpu", "--arch", ARCH])
    with pytest.raises(SystemExit, match="the serving engine is text-only"):
        tserve.main(["--local", "--device", "cpu", "--arch", ARCH])
    from repro_torch.serving import ServingEngine
    with pytest.raises(ValueError, match="text models only"):
        ServingEngine(tconfigs.get_config(ARCH, "smoke"),
                      {"final_norm": torch.ones(1)}, num_slots=1)
