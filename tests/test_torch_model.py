"""The PyTorch port's model against the JAX package, at float32 on the CPU.

Both packages run on the same weights: ``repro.models.model.init_params``
makes them and ``repro_torch.convert.params_from_jax`` hands them to the
port.  The JAX side runs its ``backend="reference"`` path (the default on
the CPU).  Tolerances: layers 1e-5, logits 1e-4 (float32 on both sides,
different summation order, two layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.core import lora as jlora
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, rescalers_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.moe_layer import apply_moe
from repro_torch.serving import BlockPool


def port_cfg(jcfg) -> tconfigs.ModelConfig:
    """The port's ModelConfig with the same fields as a JAX one."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfigs.ModelConfig)}
    kw["moe"] = tconfigs.MoEConfig(**dataclasses.asdict(jcfg.moe))
    kw["ssm"] = tconfigs.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    kw["lora"] = tconfigs.LoRAConfig(**dataclasses.asdict(jcfg.lora))
    return tconfigs.ModelConfig(**kw)


JCFG = tiny_moe()
TCFG = port_cfg(JCFG)
JPARAMS = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
TPARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
RNG = np.random.default_rng(0)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- configs

def test_configs_match_the_reference():
    from repro.configs import registry as jreg
    for variant in ("full", "smoke"):
        j = jreg.get_config("olmoe-1.3b-6.9b", variant)
        tc = tconfigs.get_config("olmoe-1.3b-6.9b", variant)
        assert port_cfg(j) == tc, variant


def test_registry_names_the_later_slice_for_unported_archs():
    with pytest.raises(KeyError, match="SSM slice"):
        tconfigs.get_config("mamba2-780m")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


# ---------------------------------------------------------------- layers

def test_layers_match_jax():
    x = RNG.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = RNG.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5)
    close(tlayers.rms_norm(torch.tensor(scale), torch.tensor(x)),
          jlayers.rms_norm(jnp.asarray(scale), jnp.asarray(x)), 1e-5)
    close(tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5)
    ffn = {k: RNG.normal(size=s).astype(np.float32) * 0.2
           for k, s in (("w1", (16, 24)), ("w3", (16, 24)), ("w2", (24, 16)))}
    xf = x.reshape(40, 16)
    close(tlayers.apply_ffn({k: torch.tensor(v) for k, v in ffn.items()},
                            torch.tensor(xf)),
          jlayers.apply_ffn({k: jnp.asarray(v) for k, v in ffn.items()},
                            jnp.asarray(xf)), 1e-5)
    close(tlayers.softcap(torch.tensor(x), 3.0),
          jlayers.softcap(jnp.asarray(x), 3.0), 1e-6)


def test_convert_keeps_the_tree():
    flat_j = jax.tree_util.tree_flatten_with_path(JPARAMS)[0]
    assert len(flat_j) > 10
    for path, leaf in flat_j:
        node = TPARAMS
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_matches_the_reference_layout_and_law():
    tp = tmodel.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.tree.map(lambda a: a.shape, JPARAMS)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert tshapes == jshapes
    w = tp["blocks"]["pos0"]["moe"]["experts"]["w1"]       # fan_in 64
    sigma = 64 ** -0.5
    assert float(w.abs().max()) <= 3 * sigma + 1e-6
    # truncated at ±3σ: std of the unit truncated normal is 0.9866
    assert abs(float(w.std()) / sigma - 0.9866) < 0.03
    router = tp["blocks"]["pos0"]["moe"]["router"]
    assert float(router.abs().max()) <= 3 * 0.1 * sigma + 1e-6
    assert abs(float(tp["embed"]["tokens"].std()) - 0.02) < 0.002
    assert tp["final_norm"].eq(1).all()


# ---------------------------------------------------------------- MoE layer

@pytest.mark.parametrize("k,mask", [(2, None), ((2, 1, 2, 1), None),
                                    ((2, 2, 1, 1), (1, 0, 1, 1))])
def test_apply_moe_matches_jax(k, mask):
    from repro.models import moe_layer as jmoe
    x = RNG.normal(size=(4, 3, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], JPARAMS["blocks"]["pos0"]["moe"])
    tp = jax.tree.map(lambda a: a[0], TPARAMS["blocks"]["pos0"]["moe"])
    resc = np.asarray([1.5, 0.5, 1.0, 2.0], np.float32)
    jm = None if mask is None else jnp.asarray(mask, jnp.float32)
    tm = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    jout, jaux = jmoe.apply_moe(jp, JCFG, jnp.asarray(x), k=k,
                                rescaler=jnp.asarray(resc), slot_mask=jm,
                                dispatch="ragged")
    tout, taux = apply_moe(tp, TCFG, torch.tensor(x), k=k,
                           rescaler=torch.tensor(resc), slot_mask=tm)
    close(tout, jout, 1e-5)
    np.testing.assert_array_equal(taux.activation_counts.numpy(),
                                  np.asarray(jaux.activation_counts))
    close(taux.load_balance_loss, jaux.load_balance_loss, 1e-5)


# ---------------------------------------------------------------- model

PROMPTS = RNG.integers(0, JCFG.vocab_size, (4, 8)).astype(np.int32)


def test_prefill_matches_jax():
    jl, jc = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(PROMPTS), k=2,
                            dispatch="ragged")
    tl, tc = tmodel.prefill(TCFG, TPARAMS, torch.tensor(PROMPTS), k=2)
    close(tl, jl, 1e-4)
    for leaf in ("k", "v"):
        close(tc["pos0"]["attn"][leaf], jc["pos0"]["attn"][leaf], 1e-5)


def _port_decode(params, k, rescaler, steps, active):
    """The port: prefill, install into a BlockPool, paged decode steps."""
    L, B = PROMPTS.shape[1], PROMPTS.shape[0]
    logits, piece = tmodel.prefill(TCFG, params, torch.tensor(PROMPTS), k=2)
    pool = BlockPool(TCFG, B, L + steps + 1, block_size=4, device="cpu")
    for s in range(B):
        pool.take(s)
        pool.reserve(s, L + steps)
    pool.write(range(B), piece, [L] * B)
    out, tok = [logits], logits.argmax(-1)
    tr = None if rescaler is None else {"rescaler": rescaler}
    for _ in range(steps):
        pool.prepare_decode(range(B))
        logits, _ = tmodel.decode_step(
            TCFG, params, pool.cache, tok, pool.positions(), trainable=tr,
            k=k, slot_mask=torch.tensor(active, dtype=torch.float32),
            block_table=pool.tables(), page_span=pool.attn_len)
        pool.advance(range(B))
        pool.check_invariants()
        out.append(logits)
        tok = logits.argmax(-1)
    return torch.cat(out, dim=1)


def _jax_decode(k, rescaler, steps, active):
    """The reference: prefill into a linear cache, slotted decode steps at
    per-row positions (token-for-token identical to its paged layout)."""
    L = PROMPTS.shape[1]
    logits, cache = jmodel.prefill(JCFG, JPARAMS, jnp.asarray(PROMPTS), k=2,
                                   cache_len=L + steps, dispatch="ragged")
    out, tok = [logits], jnp.argmax(logits, -1).astype(jnp.int32)
    pos = jnp.full((PROMPTS.shape[0],), L, jnp.int32)
    tr = None if rescaler is None else {"rescaler": rescaler}
    for i in range(steps):
        logits, cache = jmodel.decode_step(
            JCFG, JPARAMS, cache, tok, pos + i, trainable=tr, k=k,
            slot_mask=jnp.asarray(active, jnp.float32), dispatch="ragged")
        out.append(logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return jnp.concatenate(out, axis=1)


@pytest.mark.parametrize("k,active,rescaled", [
    ((2, 2, 2, 2), (1, 1, 1, 1), False),
    ((2, 2, 1, 1), (1, 1, 1, 1), True),
    ((2, 1, 2, 1), (1, 0, 1, 1), False),
])
def test_paged_decode_matches_jax(k, active, rescaled):
    steps = 3
    j_resc = t_resc = None
    if rescaled:
        # per-slot rescaler (n_periods, B), as the serving engine stacks it
        per_k = {kk: jlora.init_rescalers(JCFG, kk) for kk in set(k)}
        j_resc = {"pos0": jnp.stack([per_k[kk]["pos0"] for kk in k], -1)}
        t_resc = {"pos0": torch.stack(
            [rescalers_from_jax(per_k, "cpu")[kk]["pos0"] for kk in k], -1)}
    want = _jax_decode(k, j_resc, steps, active)
    got = _port_decode(TPARAMS, k, t_resc, steps, active)
    close(got, want, 1e-4)


def test_decode_counts_match_prefix_of_mask():
    """``return_counts`` surfaces per-layer activation counts; masked rows
    route to no expert, so counts sum to the active budgets."""
    L = PROMPTS.shape[1]
    _, piece = tmodel.prefill(TCFG, TPARAMS, torch.tensor(PROMPTS), k=2)
    pool = BlockPool(TCFG, 4, L + 2, block_size=4, device="cpu")
    for s in range(4):
        pool.take(s)
        pool.reserve(s, L + 1)
    pool.write(range(4), piece, [L] * 4)
    pool.prepare_decode(range(4))
    _, _, counts = tmodel.decode_step(
        TCFG, TPARAMS, pool.cache, torch.zeros(4, 1, dtype=torch.int64),
        pool.positions(), k=(2, 2, 1, 1),
        slot_mask=torch.tensor([1.0, 0.0, 1.0, 1.0]),
        block_table=pool.tables(), page_span=pool.attn_len,
        return_counts=True)
    assert counts["pos0"].shape == (2, 4)
    assert counts["pos0"].sum(-1).tolist() == [4.0, 4.0]


def test_later_slice_branches_raise():
    x = torch.tensor(PROMPTS)
    with pytest.raises(NotImplementedError, match="training slice"):
        tmodel.prefill(TCFG, TPARAMS, x, k=2, dispatch="capacity")
    with pytest.raises(NotImplementedError, match="softcap"):
        tmodel.prefill(TCFG.replace(attn_logit_softcap=30.0), TPARAMS, x, k=2)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tmodel.prefill(TCFG.replace(attention_window=4), TPARAMS, x, k=2)
    with pytest.raises(NotImplementedError, match="slotted"):
        tmodel.decode_step(TCFG, TPARAMS, {}, x[:, :1], 0, k=2)
    with pytest.raises(NotImplementedError, match="LoRA"):
        tmodel.prefill(TCFG, TPARAMS, x, k=2,
                       trainable={"lora": {"blocks": {"pos0": {}}}})
    with pytest.raises(NotImplementedError, match="LoRA"):
        tlayers.lora_dense(torch.ones(2, 4), torch.ones(4, 4),
                           {"a": torch.ones(4, 2), "b": torch.ones(2, 4)}, 1.0)
