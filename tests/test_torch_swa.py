"""The sliding-window ``swa`` variant on the port (ring KV caches, flash
with a window), against the JAX package at float32 on the CPU.

The model is ``tiny_moe`` with ``attention_window`` 6 at fp32, the JAX
side on its ``backend="reference"`` path; weights come from the port's
seeded initialiser, handed to both packages as numpy.  Prompts are
longer than the window and not a multiple of it (15 tokens against 6),
so the prefill's cache is the reference's rolled ring and decode wraps
it.  Tolerances (fp32 on both sides, summation order only): logits and
ring caches within 1e-5, ``lm_loss`` within 1e-6 relative and each LoRA
gradient within 1e-5 relative L2, greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.configs import registry as jreg
from repro.configs.base import KernelConfig
from repro.models import model as jmodel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.configs import registry as treg
from repro_torch.convert import (config_from_jax, lora_from_jax,
                                 params_from_jax, to_numpy)
from repro_torch.core import lora as tlora
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import leaves

W = 6
JCFG = tiny_moe(attention_window=W, kernels=KernelConfig(backend="reference"))
TCFG = config_from_jax(JCFG)
NP_PARAMS = to_numpy(tmodel.init_params(TCFG, torch.Generator().manual_seed(0),
                                        "cpu"))
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
TPARAMS = params_from_jax(NP_PARAMS, device="cpu")
V = JCFG.vocab_size


def _np_lora():
    lora = to_numpy(tlora.init_lora(torch.Generator().manual_seed(1), TCFG,
                                    TPARAMS))
    rng = np.random.default_rng(0)

    def fill(tree):
        return {k: (rng.normal(0.0, 0.05, np.shape(v)).astype(np.float32)
                    if k == "b" else fill(v) if isinstance(v, dict)
                    else np.asarray(v))
                for k, v in tree.items()}
    return fill(lora)


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_swa_config_matches_the_reference(arch):
    got, want = treg.get_config(arch, "swa"), jreg.get_config(arch, "swa")
    # an attention-free arch is natively sub-quadratic: no window, and its
    # long-context variant is "full"
    ssm = got.family == "ssm"
    assert got.attention_window == want.attention_window == (
        0 if ssm else 8192)
    assert got == config_from_jax(want)
    assert treg.supports_long_context(arch) == jreg.supports_long_context(arch)
    assert (treg.long_context_variant(arch)
            == jreg.long_context_variant(arch) == ("full" if ssm else "swa"))


# --------------------------------------------------------------------------
# prefill and the ring cache, training with a window
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,cache_len", [(15, 20), (12, None), (4, 9)],
                         ids=["wrapped", "S-multiple-of-w", "shorter-than-w"])
def test_prefill_logits_and_ring_cache_match_jax(S, cache_len):
    """S > w with S % w != 0 (the ring rolled by S % w), S a multiple of w
    (no roll), and S < w (a linear piece zero-padded to the ring)."""
    toks = np.random.default_rng(S).integers(0, V, (2, S)).astype(np.int32)
    jl, jc = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(toks), k=2,
                            cache_len=cache_len, dispatch="ragged")
    tl, tc = tmodel.prefill(TCFG, TPARAMS, torch.tensor(toks), k=2,
                            cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for leaf in ("k", "v"):
        want = np.asarray(jc["pos0"]["attn"][leaf])
        got = tc["pos0"]["attn"][leaf].numpy()
        assert got.shape == want.shape
        assert got.shape[2] == min(W, cache_len or S)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lm_loss_and_lora_grads_with_a_window_match_jax():
    np_lora = _np_lora()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, V, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)

    def jloss(lora, params, tokens, labels):
        return jmodel.lm_loss(JCFG, params, tokens, labels,
                              trainable={"lora": lora}, k=2)[0]

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, np_lora), JPARAMS, jnp.asarray(tokens),
        jnp.asarray(labels))
    tl = lora_from_jax(np_lora, device="cpu")
    flat = [t.requires_grad_(True) for t in leaves(tl)]
    tval, _ = tmodel.lm_loss(TCFG, TPARAMS, torch.tensor(tokens),
                             torch.tensor(labels), trainable={"lora": tl},
                             k=2)
    tgrads = torch.autograd.grad(tval, flat)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(tgrads)
    for g, w in zip(tgrads, jflat):
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-5, rel
    # the window changes the loss: the same tokens without one differ
    full, _ = tmodel.lm_loss(TCFG.replace(attention_window=0), TPARAMS,
                             torch.tensor(tokens), torch.tensor(labels),
                             trainable={"lora": tl}, k=2)
    assert abs(float(full.detach()) - float(tval.detach())) > 1e-4


# --------------------------------------------------------------------------
# the engines on a wrapping ring
# --------------------------------------------------------------------------

PROMPTS = np.random.default_rng(11).integers(0, V, (4, 15)).astype(np.int32)
NEW = 8


def _naive_jax():
    """The reference's full-batch greedy loop on a ring of w columns."""
    L = PROMPTS.shape[1]
    logits, cache = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(PROMPTS), k=2,
                                   cache_len=L + NEW, no_drop=True)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(NEW - 1):
        logits, cache = jmodel.decode_step(JCFG, JPARAMS, cache, tok, L + i,
                                           k=2, no_drop=True)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def _requests(cls):
    return [cls(rid=i, prompt=PROMPTS[i], max_new_tokens=NEW, k=2)
            for i in range(len(PROMPTS))]


@pytest.fixture(scope="module")
def jax_ring_tokens():
    kw = dict(num_slots=4, slot_len=15 + NEW, slot_k=(2,) * 4)
    rep = JEngine(JCFG, JPARAMS, kv_layout="paged", block_size=4,
                  dispatch="ragged", **kw).run(_requests(JRequest))
    got = rep.tokens_by_rid()
    jeng = np.stack([got[i] for i in range(len(PROMPTS))])
    np.testing.assert_array_equal(jeng, _naive_jax())
    return jeng


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_ring_engine_tokens_match_jax_and_naive(layout, jax_ring_tokens):
    """The twin of ``test_paged_differential_sliding_window_ring``: 15-token
    prompts on a 6-token ring, 8 new tokens, both layouts give the JAX
    engine's tokens (which equal the naive loop's)."""
    kw = dict(num_slots=4, slot_len=15 + NEW, slot_k=(2,) * 4)
    if layout == "paged":
        kw["block_size"] = 4
    eng = ServingEngine(TCFG, TPARAMS, kv_layout=layout, **kw)
    assert eng.pool.attn_len == W
    rep = eng.run(_requests(Request))
    got = rep.tokens_by_rid()
    np.testing.assert_array_equal(
        np.stack([got[i] for i in range(len(PROMPTS))]), jax_ring_tokens)
    assert all(not c.truncated for c in rep.completions)
    if layout == "paged":
        # blocks per slot capped by the ring: ceil(6 / 4)
        assert eng.pool.blocks_per_slot == 2
        eng.pool.check_invariants()
        assert eng.pool.blocks_in_use == 0


def test_ring_row_preempted_and_resumed_matches_solo_runs():
    """A ring row swapped out (after its ring wrapped) for an urgent
    arrival and swapped back in decodes on as its solo run does."""
    rng = np.random.default_rng(23)
    eco, prm = (rng.integers(0, V, (9,)).astype(np.int32) for _ in range(2))
    # a ring of 6 in 4-token blocks: 2 blocks a row; 3 blocks starve the
    # premium arrival while the economy row holds 2
    kw = dict(num_slots=2, slot_len=48, slot_k=(2, 1), block_size=4,
              num_blocks=3, preemption=True, slo_ms={2: 0.0, 1: 60000.0})
    e_req = lambda: Request(rid=0, prompt=eco, max_new_tokens=30, k=1)  # noqa
    p_req = lambda t: Request(rid=1, prompt=prm, max_new_tokens=4, k=2,  # noqa
                              arrival=t)
    eng = ServingEngine(TCFG, TPARAMS, **kw)
    assert eng.pool.attn_len == W and eng.pool.blocks_per_slot == 2
    rep = eng.run([e_req(), p_req(0.02)])
    by_rid = {c.rid: c for c in rep.completions}
    assert by_rid[0].preemptions >= 1 and by_rid[1].preemptions == 0
    assert eng.pool.swap_outs == eng.pool.swap_ins == rep.preemptions
    for rid, req in ((0, e_req()), (1, p_req(0.0))):
        solo = ServingEngine(TCFG, TPARAMS, **kw).run([req])
        assert solo.preemptions == 0
        np.testing.assert_array_equal(by_rid[rid].tokens,
                                      solo.completions[0].tokens)
    assert len(by_rid[0].tokens) == 30          # the ring never fills
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0


def test_ring_pools_keep_the_reference_guards():
    """No prefix cache on a ring (the reference pool's refusal), no
    speculation with a window shorter than a slot, and the suffix branch
    refuses a ring."""
    with pytest.raises(ValueError, match="attention_window"):
        ServingEngine(TCFG, TPARAMS, num_slots=2, slot_len=16,
                      slot_k=(2, 1), block_size=4, prefix_cache=True)
    from repro_torch.serving import SpeculativeConfig
    with pytest.raises(ValueError, match="attention_window"):
        ServingEngine(TCFG, TPARAMS, num_slots=2, slot_len=16,
                      slot_k=(2, 1), speculative=SpeculativeConfig())
    x = torch.zeros((1, 4, TCFG.d_model))
    cache = tmodel.init_paged_cache(TCFG, 1, 2, 4, "cpu")["pos0"]["attn"]
    block = {k: v[0] for k, v in TPARAMS["blocks"]["pos0"]["attn"].items()}
    from repro_torch.models.attention import apply_attention
    with pytest.raises(NotImplementedError, match="ring"):
        apply_attention(block, TCFG, x, torch.arange(4),
                        cache={k: v[0] for k, v in cache.items()},
                        cache_pos=torch.zeros(1, dtype=torch.long),
                        block_table=torch.zeros((1, 2), dtype=torch.int32),
                        page_span=W, suffix_readonly=True)


def test_serve_launcher_takes_the_swa_variant(monkeypatch, capsys):
    """``--variant swa`` reaches the registry, and the banner names the
    window and the ring (the registry's swa configs are full width, so the
    CPU run stands a windowed smoke config in for it)."""
    asked = []

    def get_config(arch, variant):
        asked.append(variant)
        return tconfigs.get_config(arch, "smoke").replace(attention_window=W)

    monkeypatch.setattr(tserve, "get_config", get_config)
    tserve.main(["--local", "--device", "cpu", "--variant", "swa", "--slots",
                 "2", "--requests", "3", "--new-tokens", "12",
                 "--slot-len", "32"])
    out = capsys.readouterr().out
    assert asked == ["swa"]
    assert f"sliding window {W}: ring of {W}" in out
    assert "gen_tokens: 36" in out
