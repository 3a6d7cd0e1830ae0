"""The registry's dense-FFN archs and the shared-expert MoE on the port,
against the JAX package at float32 on the CPU.

Six SMOKE configs (olmo-1.3b, qwen3-1.7b, phi4-mini-3.8b, granite-20b,
chameleon-34b, qwen2-moe-a2.7b) at ``dtype="float32"``, the JAX side on
its ``backend="reference"`` path.  Both packages run on the same seeded
weights, handed to each as numpy (``repro_torch.convert``); the
adapter's ``b`` factors are drawn nonzero with numpy, so its gradients
and its term in the forward are not trivially zero.  The port's trees
have the reference's shapes, leaf for leaf.  Tolerances (float32 on both
sides, only the summation order differs, two layers): logits within
1e-5, each LoRA gradient of ``lm_loss`` within 1e-5 relative L2, greedy
engine tokens equal, the converted trees bit-exact.
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
from repro_torch import configs as tconfigs
from repro_torch.convert import (config_from_jax, lora_from_jax,
                                 params_from_jax, to_numpy)
from repro_torch.core import lora as tlora
from repro_torch.models import model as tmodel
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import leaves

ARCHS = ["olmo-1.3b", "qwen3-1.7b", "phi4-mini-3.8b", "granite-20b",
         "chameleon-34b", "qwen2-moe-a2.7b"]


def _fill_b(tree, rng, std=0.05):
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, std, np.shape(v)).astype(np.float32)
                    if k == "b" else _fill_b(v, rng, std))
                for k, v in tree.items()}
    return np.asarray(tree)


class Case:
    """One arch's SMOKE config at fp32 and its weights, adapter and
    inputs in both packages."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg = jreg.get_config(arch, "smoke").replace(
            dtype="float32", kernels=KernelConfig(backend="reference"))
        self.tcfg = config_from_jax(self.jcfg)
        # seeded weights made once (by the port's initialiser, whose
        # layout and law match the reference's) and handed to both
        # packages as numpy: no eager JAX init to compile
        self.np_params = to_numpy(tmodel.init_params(
            self.tcfg, torch.Generator().manual_seed(0), "cpu"))
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)
        self.tparams = params_from_jax(self.np_params, device="cpu")
        self.np_lora = _fill_b(to_numpy(tlora.init_lora(
            torch.Generator().manual_seed(1), self.tcfg, self.tparams)),
            np.random.default_rng(0))
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.jcfg.vocab_size,
                                   (2, 16)).astype(np.int32)
        self.labels = np.roll(self.tokens, -1, axis=1)
        self.k = self.jcfg.moe.top_k or None


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_configs_match_the_reference(arch):
    for variant in ("full", "smoke"):
        assert tconfigs.get_config(arch, variant) == config_from_jax(
            jreg.get_config(arch, variant)), variant
    assert arch in tconfigs.list_archs()


def test_registry_knows_seven_archs_and_names_the_rest():
    # the rest are ported now: the registry is the reference's, the two
    # multi-card archs (which run on the card mesh) included
    assert sorted(tconfigs.list_archs()) == sorted(
        ARCHS + ["olmoe-1.3b-6.9b", "mamba2-780m", "jamba-v0.1-52b",
                 "musicgen-large", "qwen3-moe-235b-a22b", "llama3-405b"])
    assert sorted(tconfigs.list_archs()) == sorted(jreg.list_archs())
    for arch in ("qwen3-moe-235b-a22b", "llama3-405b"):
        for variant in ("full", "smoke", "swa"):
            assert tconfigs.get_config(arch, variant) == config_from_jax(
                jreg.get_config(arch, variant))
    # the sliding-window variant (a later slice once, ported now)
    assert tconfigs.get_config("olmo-1.3b", "swa") == config_from_jax(
        jreg.get_config("olmo-1.3b", "swa"))
    with pytest.raises(ValueError, match="unknown variant"):
        tconfigs.get_config("olmo-1.3b", "long")


def test_init_params_matches_the_reference_layout(case):
    want = jax.eval_shape(lambda key: jmodel.init_params(key, case.jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), case.tparams) == \
        jax.tree.map(lambda a: a.shape, want)
    lora = jax.eval_shape(lambda key: jlora.init_lora(
        key, case.jcfg, jmodel.init_params(key, case.jcfg)),
        jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, case.np_lora) == jax.tree.map(
        lambda a: a.shape, lora)


def test_convert_round_trips_norms_ffn_and_shared(case):
    """``convert.py`` carries every leaf of the arch's parameter and
    adapter trees, including q_norm / k_norm, the dense ``ffn`` and
    ``moe.shared``, bit for bit."""
    block = case.tparams["blocks"]["pos0"]
    lblock = lora_from_jax(case.np_lora, device="cpu")["blocks"]["pos0"]
    cfg = case.jcfg
    assert ("q_norm" in block["attn"]) == cfg.qk_norm
    assert ("k_norm" in block["attn"]) == cfg.qk_norm
    if cfg.moe.enabled:
        assert set(block["moe"]["shared"]) == {"w1", "w2", "w3"}
        assert set(lblock["moe"]["shared"]) == {"w1", "w2", "w3"}
        assert "ffn" not in block
    else:
        assert set(block["ffn"]) == {"w1", "w2", "w3"}
        assert set(lblock["ffn"]) == {"w1", "w2", "w3"}
    for got, want in ((to_numpy(case.tparams), case.np_params),
                      (to_numpy(lora_from_jax(case.np_lora, device="cpu")),
                       case.np_lora)):
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (_, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_array_equal(g, w)


def test_forward_logits_match_jax(case):
    trainable = {"lora": case.np_lora}
    jlog, jcounts = jax.jit(lambda p, t, tr: jmodel.forward(
        case.jcfg, p, t, trainable=tr, k=case.k))(
        case.jparams, jnp.asarray(case.tokens),
        jax.tree.map(jnp.asarray, trainable))
    tlog, tcounts = tmodel.forward(
        case.tcfg, case.tparams, torch.tensor(case.tokens),
        trainable={"lora": lora_from_jax(case.np_lora, device="cpu")},
        k=case.k)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=1e-5, atol=1e-5)
    assert set(tcounts) == set(jcounts)
    for key in jcounts:
        np.testing.assert_array_equal(tcounts[key].numpy(),
                                      np.asarray(jcounts[key]))


def test_lm_loss_lora_grads_match_jax(case):
    def jloss(lora, params, tokens, labels):
        return jmodel.lm_loss(case.jcfg, params, tokens, labels,
                              trainable={"lora": lora}, k=case.k)[0]

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, case.np_lora), case.jparams,
        jnp.asarray(case.tokens), jnp.asarray(case.labels))
    tl = lora_from_jax(case.np_lora, device="cpu")
    flat = [t.requires_grad_(True) for t in leaves(tl)]
    tval, _ = tmodel.lm_loss(case.tcfg, case.tparams,
                             torch.tensor(case.tokens),
                             torch.tensor(case.labels),
                             trainable={"lora": tl}, k=case.k)
    tgrads = torch.autograd.grad(tval, flat)
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-6)
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(tgrads)
    for g, w in zip(tgrads, jflat):
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-5, rel


def _requests(cls, case, ks):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(
                0, case.jcfg.vocab_size, (8,)).astype(np.int32),
                max_new_tokens=4, k=ks[i % len(ks)])
            for i in range(6)]


def test_engine_greedy_tokens_match_jax(case):
    """The paged engine on both sides (ragged dispatch for the MoE arch,
    at two tiers): every request's greedy tokens equal."""
    kw = dict(num_slots=2, slot_len=24, block_size=4)
    ks = (None,)
    if case.jcfg.moe.enabled:
        kw["slot_k"] = ks = (case.jcfg.moe.top_k, 1)
    jrep = JEngine(case.jcfg, case.jparams, kv_layout="paged",
                   dispatch="ragged", **kw).run(_requests(JRequest, case, ks))
    eng = ServingEngine(case.tcfg, case.tparams, **kw)
    trep = eng.run(_requests(Request, case, ks))
    jt, tt = jrep.tokens_by_rid(), trep.tokens_by_rid()
    assert sorted(jt) == sorted(tt) == list(range(6))
    for rid in jt:
        np.testing.assert_array_equal(tt[rid], jt[rid], err_msg=f"rid {rid}")
    assert trep.summary()["gen_tokens"] == 24
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0
