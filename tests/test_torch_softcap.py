"""Attention logit softcap in the port against the JAX package, at
float32 on the CPU.

The reference computes capped attention on its blockwise jnp path
(``models/attention.py`` ``flash_attention_jnp``: ``s = cap·tanh(s·D^-½ /
cap)`` after the scale, before the masks); the port computes it inside
its flash kernel, whose plain version on the CPU is
``kernels.ref.flash_attention_ref``.  Held here: that plain version (and
the differentiable ``kernels.backend.flash_attention`` with its vjp)
against ``flash_attention_jnp`` and ``jax.vjp`` (causal, windowed, GQA);
a capped model's prefill logits and LoRA gradients; and greedy engine
tokens (paged with the prefix cache, slotted, speculative) against the
JAX engine's.

A cap only acts on scores near or above it, and random weights give
scores of about 1: the attention inputs are drawn at three times unit
scale and the model's ``wq`` and ``wk`` are multiplied by 8, so that
scores reach tens, and each test checks that the cap changed its result.
Tolerances: outputs and logits 1e-5 (float32, only the summation order
differs), attention gradients 1e-5 in relative L2 per leaf, tokens
exactly.  The model's LoRA gradients at these sharpened scores: within
1e-5 of the port's own float64 run, and within 1e-4 of JAX's (measured:
JAX's float32 gradients sit 2e-5 to 4e-5 from the float64 ones, capped
or not, the port's 3e-6 to 6e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import SpeculativeConfig as JSpec
from repro_torch.convert import (config_from_jax, lora_from_jax,
                                 params_from_jax, to_numpy)
from repro_torch.core import lora as tlora
from repro_torch.kernels import backend, ref
from repro_torch.models import model as tmodel
from repro_torch.serving import Request, ServingEngine, SpeculativeConfig
from repro_torch.tree import leaves

CAP = 30.0
JCFG = tiny_moe(attn_logit_softcap=CAP)
TCFG = config_from_jax(JCFG)


def _sharpened(tree):
    """``wq`` and ``wk`` times 8 (scores of tens, where a cap of 30 acts)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _sharpened(v)
        else:
            out[k] = v * np.float32(8.0) if k in ("wq", "wk") else v
    return out


NP_PARAMS = _sharpened(to_numpy(tmodel.init_params(
    TCFG, torch.Generator().manual_seed(0), "cpu")))
TPARAMS = params_from_jax(NP_PARAMS, device="cpu")
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
V = JCFG.vocab_size


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("kv,window", [(4, 0), (2, 0), (2, 7)])
def test_flash_ref_and_its_vjp_with_the_cap_match_jax(kv, window):
    """(B, S, H, D) = (2, 40, 4, 16), cap 10, the JAX side in blocks of 8
    (its online softmax over key blocks, or its windowed span)."""
    rng = np.random.default_rng(kv + window)
    B, S, H, D, cap = 2, 40, 4, 16, 10.0
    q = (3 * rng.standard_normal((B, S, H, D))).astype(np.float32)
    k = (3 * rng.standard_normal((B, S, kv, D))).astype(np.float32)
    v = rng.standard_normal((B, S, kv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    def jf(q, k, v):
        return jattn.flash_attention_jnp(q, k, v, causal=True, window=window,
                                         logit_softcap=cap, block_q=8,
                                         block_k=8)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    # the plain version in the kernels' layout (B, H, S, D)
    qt, kt, vt = (torch.tensor(a).transpose(1, 2) for a in (q, k, v))
    got = ref.flash_attention_ref(qt, kt, vt, window=window, softcap=cap)
    close(got.transpose(1, 2), jout)
    uncapped = ref.flash_attention_ref(qt, kt, vt, window=window)
    assert (got - uncapped).abs().max() > 1e-2
    # the autograd Function (model layout) and its vjp
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = backend.flash_attention(tq, tk, tv, causal=True, window=window,
                                  softcap=cap)
    close(out, jout)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    for t, w in zip(tgrads, vjp(jnp.asarray(g))):
        w = np.asarray(w)
        assert np.linalg.norm(t.numpy() - w) / np.linalg.norm(w) <= 1e-5


# ---------------------------------------------------------------- model

def test_capped_prefill_logits_and_lora_grads_match_jax():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, V, (2, 24)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    np_lora = to_numpy(tlora.init_lora(torch.Generator().manual_seed(1), TCFG,
                                       TPARAMS))
    np_lora = jax.tree.map(
        lambda a: a + np.float32(0.05) * rng.standard_normal(
            a.shape).astype(np.float32), np_lora)
    jtr = {"lora": jax.tree.map(jnp.asarray, np_lora)}

    def jloss(tr):
        return jmodel.lm_loss(JCFG, JPARAMS, jnp.asarray(tokens),
                              jnp.asarray(labels), trainable=tr, k=2)[0]

    jval, jgrads = jax.value_and_grad(jloss)(jtr)

    def port(dtype):
        tr = {"lora": lora_from_jax(np_lora, device="cpu", dtype=dtype)}
        flat = [t.requires_grad_(True) for t in leaves(tr)]
        val, _ = tmodel.lm_loss(
            TCFG.replace(dtype=str(dtype).split(".")[1]),
            params_from_jax(NP_PARAMS, device="cpu", dtype=dtype),
            torch.tensor(tokens), torch.tensor(labels), trainable=tr, k=2)
        return val, torch.autograd.grad(val, flat)

    tval, tgrads = port(torch.float32)
    _, exact = port(torch.float64)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(tgrads) == len(exact)
    for t, w, e in zip(tgrads, jflat, exact):
        w, e, t = np.asarray(w), e.numpy(), t.double().numpy()
        assert np.linalg.norm(t - e) / np.linalg.norm(e) <= 1e-5
        assert np.linalg.norm(t - w) / np.linalg.norm(w) <= 1e-4
    # the prefill's last logits and cache, and the cap's effect on them
    tl, tc = tmodel.prefill(TCFG, TPARAMS, torch.tensor(tokens), k=2)
    jl, jc = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(tokens), k=2,
                            dispatch="ragged")
    close(tl, jl)
    # K is 8x sharpened (entries up to tens): 1e-5 of its largest entry
    jk = np.asarray(jc["pos0"]["attn"]["k"])
    np.testing.assert_allclose(tc["pos0"]["attn"]["k"].numpy(), jk,
                               rtol=1e-5, atol=1e-5 * np.abs(jk).max())
    free, _ = tmodel.prefill(TCFG.replace(attn_logit_softcap=0.0), TPARAMS,
                             torch.tensor(tokens), k=2)
    assert (tl - free).abs().max() > 1e-3


# ---------------------------------------------------------------- engines

def _trace(cls, n=8, seed=3):
    """Prompts opening with one of two 4-token heads (the last two repeat
    earlier prompts), at tiers 2 and 1."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, V, (2, 4)).astype(np.int32)
    reqs = []
    for i in range(n):
        p = rng.integers(0, V, (int(rng.choice((6, 9))),)).astype(np.int32)
        p[:4] = heads[i % 2]
        if i >= n - 2:
            p = np.array(reqs[i - 2].prompt, np.int32)
        reqs.append(cls(rid=i, prompt=p, max_new_tokens=5, k=(2, 1)[i % 2]))
    return reqs


KW = dict(num_slots=4, slot_len=24, slot_k=(2, 2, 1, 1), block_size=4)


@pytest.mark.parametrize("mode", ["paged+prefix", "slotted", "speculative"])
def test_capped_engine_greedy_tokens_match_jax(mode):
    kw = dict(KW)
    tkw, jkw = {}, {}
    if mode == "paged+prefix":
        tkw = jkw = {"prefix_cache": True}
    elif mode == "slotted":
        tkw = jkw = {"kv_layout": "slotted"}
    else:
        tkw = {"speculative": SpeculativeConfig(window=3, draft_k=1)}
        jkw = {"speculative": JSpec(window=3, draft_k=1)}
    jrep = JEngine(JCFG, JPARAMS, dispatch="ragged", **jkw, **kw).run(
        _trace(JRequest))
    eng = ServingEngine(TCFG, TPARAMS, **tkw, **kw)
    trep = eng.run(_trace(Request))
    jt, tt = jrep.tokens_by_rid(), trep.tokens_by_rid()
    assert sorted(jt) == sorted(tt) == list(range(8))
    for rid in jt:
        np.testing.assert_array_equal(tt[rid], jt[rid], err_msg=f"rid {rid}")
    if mode == "paged+prefix":
        assert trep.prefix == jrep.prefix and trep.prefix["hit_tokens"] > 0
        eng.pool.check_invariants()
    if mode == "speculative":
        for key in ("spec_rounds", "spec_drafted", "spec_accepted"):
            assert getattr(trep, key) == getattr(jrep, key), key
        assert trep.spec_rounds > 0
