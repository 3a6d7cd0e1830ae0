"""Dispatch equivalence in the port, outputs AND gradients: the ragged
(sort-based) MoE dispatch against the loss-free one-hot dispatch
(``"dense"``) and against the JAX package's ragged path, with expert
adapters — the port of ``tests/test_dispatch_equivalence.py``'s
differential section — plus the ragged trio's autograd Functions against
autograd through their plain versions.

float32 on the CPU (the Functions run their plain forwards; the backward
rules are the ones the card runs).  Tolerances: outputs 1e-5 relative /
1e-6 absolute (float32, summation order only); gradients 1e-4 / 1e-5
(the backward sums over row blocks or experts in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.configs.base import KernelConfig
from repro.models import model as jmodel
from repro.models import moe_layer as jmoe
from repro_torch.convert import (config_from_jax, lora_from_jax,
                                 params_from_jax, trainable_from_jax)
from repro_torch.kernels import backend, ref
from repro_torch.kernels.ragged_dispatch import ragged_plan
from repro_torch.models import model as tmodel
from repro_torch.models import moe_layer as tmoe

JCFG = tiny_moe().replace(kernels=KernelConfig(backend="reference"))
TCFG = config_from_jax(JCFG)
E, D, H = JCFG.moe.num_experts, JCFG.d_model, JCFG.moe.d_expert
SCALE = 0.5
RNG = np.random.default_rng(0)
JP = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), JCFG))
TP = params_from_jax(JP, device="cpu")


def _lora(rng, rank=2):
    mk = lambda i, o: (rng.normal(size=(E, i, o)) * 0.2  # noqa: E731
                       ).astype(np.float32)
    return {"experts": {"w1": {"a": mk(D, rank), "b": mk(rank, H)},
                        "w3": {"a": mk(D, rank), "b": mk(rank, H)},
                        "w2": {"a": mk(H, rank), "b": mk(rank, D)}}}


LORA = _lora(np.random.default_rng(7))
TLORA = lora_from_jax(LORA, device="cpu")
SHAPES = {"decode": (6, 1), "prefill": (2, 8)}


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _t_moe(p, x, k, mode, lora=TLORA, cfg=TCFG):
    return tmoe.apply_moe(p, cfg, x, k=k, dispatch=mode, lora=lora,
                          lora_scale=SCALE)[0]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_three_way_outputs(shape):
    """ragged == dense == the JAX ragged path, with expert adapters, at
    k = 1, 2, E and mixed per-row budgets."""
    B, S = SHAPES[shape]
    x = RNG.normal(size=(B, S, D)).astype(np.float32)
    tx = torch.from_numpy(x)
    for k in (1, 2, E, tuple(([1, 2, E] * B)[:B])):
        rag = _t_moe(TP, tx, k, "ragged")
        close(rag, _t_moe(TP, tx, k, "dense").numpy())
        want = jax.jit(lambda p_, x_, l_: jmoe.apply_moe(
            p_, JCFG, x_, k=k, dispatch="ragged", lora=l_,
            lora_scale=SCALE)[0])(JP, jnp.asarray(x), LORA)
        close(rag, want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("k", [2, (1, 2, E, 1)], ids=["k2", "mixed"])
def test_three_way_grads(k):
    """Gradients with respect to the tokens, the router, the expert
    weights and the expert adapters: ragged (the trio's Functions) equals
    dense, and equals ``jax.grad`` of the JAX ragged path."""
    B, S = 4, 2
    x = RNG.normal(size=(B, S, D)).astype(np.float32)
    cot = RNG.normal(size=(B, S, D)).astype(np.float32)

    def jloss(p_, x_, l_):
        out, _ = jmoe.apply_moe(p_, JCFG, x_, k=k, dispatch="ragged",
                                lora=l_, lora_scale=SCALE)
        return (out * cot).sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(JP, jnp.asarray(x),
                                                     LORA)
    want = _leaves(jg[0]) + [jg[1]] + _leaves(jg[2])
    got = {}
    for mode in ("ragged", "dense"):
        p = params_from_jax(JP, device="cpu")
        lo = lora_from_jax(LORA, device="cpu")
        leaves = _leaves(p) + [torch.from_numpy(x)] + _leaves(lo)
        for t in leaves:
            t.requires_grad_(True)
        out = _t_moe(p, leaves[len(_leaves(p))], k, mode, lora=lo)
        got[mode] = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                        leaves)
    for r, d, w in zip(got["ragged"], got["dense"], want):
        close(r, d.numpy(), 1e-4, 1e-5)
        close(r, w, 1e-4, 1e-5)


def test_capacity_parity_when_not_binding():
    """With capacity_factor = E the queue capacity exceeds the assignment
    count, so capacity dispatch joins the loss-free class: the port's
    capacity output equals its ragged output and the JAX capacity output."""
    jcfg = JCFG.replace(moe=dataclasses.replace(JCFG.moe,
                                                capacity_factor=float(E)))
    tcfg = config_from_jax(jcfg)
    B, S = 4, 4
    x = RNG.normal(size=(B, S, D)).astype(np.float32)
    for k in (1, 2):
        assert tmoe._capacity(B * S, E, k, float(E)) > B * S * k
        cap = _t_moe(TP, torch.from_numpy(x), k, "capacity", cfg=tcfg)
        close(cap, _t_moe(TP, torch.from_numpy(x), k, "ragged",
                          cfg=tcfg).numpy())
        want = jax.jit(lambda p_, x_, l_: jmoe.apply_moe(
            p_, jcfg, x_, k=k, dispatch="capacity", lora=l_,
            lora_scale=SCALE)[0])(JP, jnp.asarray(x), LORA)
        close(cap, want)


GROUPED = {"dense-rows": ("dense", 4, 2), "capacity-2": ("capacity", 2, 2),
           "capacity-rows-k1": ("capacity", 4, 1)}


@pytest.mark.parametrize("case", list(GROUPED))
def test_grouped_one_hot_matches_jax(case):
    """``num_groups`` routing groups under the one-hot modes, with expert
    adapters: each group has its own queues and capacity, as in the JAX
    layer with the same ``num_groups`` (capacity at the default factor,
    where a group's queue may overflow)."""
    mode, G, k = GROUPED[case]
    B, S = 4, 6
    x = RNG.normal(size=(B, S, D)).astype(np.float32)
    got = tmoe.apply_moe(TP, TCFG, torch.from_numpy(x), k=k, dispatch=mode,
                         lora=TLORA, lora_scale=SCALE, num_groups=G)[0]
    want = jax.jit(lambda p_, x_, l_: jmoe.apply_moe(
        p_, JCFG, x_, k=k, dispatch=mode, lora=l_, lora_scale=SCALE,
        num_groups=G)[0])(JP, jnp.asarray(x), LORA)
    close(got, want)
    if mode == "dense":   # loss-free: grouping moves no result
        close(got, _t_moe(TP, torch.from_numpy(x), k, "dense").numpy())


def test_grouped_dense_per_row_budgets_and_refusals():
    """Dense groups take per-row budgets (C does not depend on k) and give
    the one-group result; ragged dispatch, and per-row budgets under
    capacity, refuse ``num_groups > 1``."""
    B, S = 3, 4
    tx = torch.from_numpy(RNG.normal(size=(B, S, D)).astype(np.float32))
    kk = (1, E, 2)
    mask = torch.tensor([[1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]],
                        dtype=torch.float32)
    run = lambda mode, G, **kw: tmoe.apply_moe(  # noqa: E731
        TP, TCFG, tx, k=kk, dispatch=mode, lora=TLORA, lora_scale=SCALE,
        num_groups=G, **kw)[0]
    close(run("dense", B, slot_mask=mask),
          run("dense", 1, slot_mask=mask).numpy())
    close(run("dense", B), run("ragged", 1).numpy())
    for mode in ("ragged", "capacity"):
        with pytest.raises(ValueError, match="num_groups"):
            run(mode, B)


JMODEL = jmodel.init_params(jax.random.PRNGKey(5), JCFG)
TMODEL = params_from_jax(jax.tree.map(np.asarray, JMODEL), device="cpu")


def test_model_level_dispatch_threading():
    """prefill / decode_step thread ``dispatch`` end to end: ragged and
    dense give the same logits (with the JAX prefill's), and the same
    decode logits."""
    prompts = RNG.integers(0, JCFG.vocab_size, (2, 6))
    tp = torch.from_numpy(prompts)
    lr, cr = tmodel.prefill(TCFG, TMODEL, tp, k=2, cache_len=8,
                            dispatch="ragged")
    ld, cd = tmodel.prefill(TCFG, TMODEL, tp, k=2, cache_len=8,
                            dispatch="dense")
    close(lr, ld.numpy())
    jl, _ = jmodel.prefill(JCFG, JMODEL, jnp.asarray(prompts, jnp.int32),
                           k=2, cache_len=8, dispatch="ragged")
    close(lr, jl)
    # dense, one routing group per row (the engine's dense prefill)
    lg, _ = tmodel.prefill(TCFG, TMODEL, tp, k=2, cache_len=8,
                           dispatch="dense", num_groups=2)
    jg, _ = jmodel.prefill(JCFG, JMODEL, jnp.asarray(prompts, jnp.int32),
                           k=2, cache_len=8, dispatch="dense", num_groups=2)
    close(lg, jg)
    tok = lr.argmax(-1)
    sr, _ = tmodel.decode_step(TCFG, TMODEL, cr, tok, 6, k=(1, 2),
                               dispatch="ragged")
    sd, _ = tmodel.decode_step(TCFG, TMODEL, cd, tok, 6, k=(1, 2),
                               dispatch="dense")
    close(sr, sd.numpy())


def test_lm_loss_grads_ragged_match_dense_and_jax():
    """The gradient of every trainable leaf (attention and expert
    adapters, rescalers) of the two-layer model's LM loss: ragged dispatch
    against dense, and against the JAX loss at capacity_factor = E (the
    JAX loss dispatches by capacity, which cannot bind there)."""
    jcfg = JCFG.replace(moe=dataclasses.replace(JCFG.moe,
                                                capacity_factor=float(E)))
    rng = np.random.default_rng(3)
    from repro.core import lora as jlora
    jtr = {"lora": jax.tree.map(np.asarray, jlora.init_lora(
        jax.random.PRNGKey(6), jcfg, JMODEL)),
        "rescaler": jax.tree.map(np.asarray, jlora.init_rescalers(jcfg, 1))}

    def fill(t):
        if isinstance(t, dict):
            return {k: (rng.normal(0, 0.3, v.shape).astype(np.float32)
                        if k == "b" else fill(v)) for k, v in t.items()}
        return t
    jtr["lora"] = fill(jtr["lora"])
    tok = rng.integers(0, JCFG.vocab_size, (2, 12))
    lab = np.roll(tok, -1, axis=1)
    msk = (rng.random((2, 12)) > 0.2).astype(np.float32)
    jg = jax.jit(jax.grad(lambda tr: jmodel.lm_loss(
        jcfg, JMODEL, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32),
        jnp.asarray(msk), trainable=tr, k=2)[0]))(jtr)
    got = {}
    for mode in ("ragged", "dense"):
        ttr = trainable_from_jax(jtr, device="cpu")
        leaves = _leaves(ttr)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tmodel.lm_loss(TCFG, TMODEL, torch.from_numpy(tok),
                                 torch.from_numpy(lab),
                                 torch.from_numpy(msk), trainable=ttr, k=2,
                                 dispatch=mode)
        got[mode] = torch.autograd.grad(loss, leaves)
    want = _leaves(jg)
    assert len(want) == len(got["ragged"])
    for r, d, w in zip(got["ragged"], got["dense"], want):
        close(r, d.numpy(), 1e-4, 1e-5)
        close(r, w, 1e-4, 1e-5)


def _plan(rng, T=16, budgets=(1, 2, 4, 0)):
    """A ragged plan at mixed per-token budgets (a 0 deselects the token),
    with padding rows in every segment and past the last."""
    logits = torch.from_numpy(rng.normal(size=(T, E)).astype(np.float32))
    k_tok = torch.tensor(budgets * (T // len(budgets)), dtype=torch.int32)
    w, m, _ = ref.adaptive_topk_router_ref(logits, k_tok, max(budgets))
    plan = ragged_plan(m, w, budget=int(k_tok.sum()), max_k=max(budgets))
    assert int(plan.valid.sum()) < plan.valid.numel()
    return plan


CASES = ("gather", "matmul", "matmul-lora", "matmul-lora-frozen-w",
         "combine")


@pytest.mark.parametrize("case", CASES)
def test_ragged_function_grads_match_plain_autograd(case):
    """Each ragged Function's gradients against autograd through its plain
    version, float32, adapter b != 0, mixed budgets with padding rows,
    also with a frozen expert weight (autograd asks for no dW)."""
    rng = np.random.default_rng(CASES.index(case))
    plan = _plan(rng)
    N = plan.src.shape[0]
    rn = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    if case == "gather":
        ins, frozen = [rn(16, D)], ()
        wrap = lambda x: backend.ragged_gather(x, plan.src, plan.valid)  # noqa
        plain = lambda x: ref.ragged_gather_ref(x, plan.src,  # noqa: E731
                                                plan.valid)
    elif case.startswith("matmul"):
        lora = "lora" in case
        ins = [rn(N, D), rn(E, D, H) * D ** -0.5]
        if lora:
            ins += [rn(E, D, 3) * D ** -0.5, rn(E, 3, H)]
        frozen = (1,) if case.endswith("frozen-w") else ()

        def wrap(*t):
            return backend.ragged_expert_matmul(t[0], plan.block_expert,
                                                *t[1:], scale=0.7)

        def plain(*t):
            return ref.ragged_expert_matmul_ref(t[0], plan.block_expert,
                                                *t[1:], scale=0.7)
    else:
        ins, frozen = [rn(N, D), plan.wrank.clone()], ()
        wrap = lambda eo, w: backend.ragged_combine(eo, plan.rows, w)  # noqa
        plain = lambda eo, w: ref.ragged_combine_ref(eo, plan.rows,  # noqa
                                                     w)
    cot = None
    grads = []
    for fn in (wrap, plain):
        leaves = [t.clone().requires_grad_(i not in frozen)
                  for i, t in enumerate(ins)]
        out = fn(*leaves)
        cot = rn(*out.shape) if cot is None else cot
        live = [t for t in leaves if t.requires_grad]
        grads.append(torch.autograd.grad(out, live, cot))
    for g, p in zip(*grads):
        close(g, p.numpy(), 1e-4, 1e-5)
        assert g.abs().max() > 0
