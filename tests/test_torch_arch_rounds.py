"""One federated round on the paper's dense model and the shared-expert
MoE, the port against the JAX package at float32 on the CPU.

* ``olmo-1.3b`` (SMOKE widths at rank 40, so the baselines' client ranks
  are the dense grid ``DENSE_BUDGET_RANKS`` itself: 40 / 24 / 16 / 12):
  one round of each method;
* ``qwen2-moe-a2.7b`` (SMOKE widths with 8 experts at top-4, so FLAME's k
  grid scales to 4 / 2 / 1 / 1, as at FULL): one FLAME round; its shared
  experts' adapters are always active, Eq. 6's full-activation edge case,
  and aggregate as the reference aggregates them.

The registry's other dense archs have their rounds in
``tests/test_torch_arch_rounds_attn.py`` (a file of its own, so the
suite's workers share the JAX compiles).

Both packages start from the same seeded weights, global adapter (its ``b``
factors drawn off zero with numpy), data and budgets, 4 clients, one per
budget tier, one local step each: the port on its default batched
engine, the JAX package on its looped engine (the reference's oracle,
equal to its batched engine, and cheaper to compile).
Client losses agree within 1e-5 relative.  The merged adapter (FlexLoRA's
through the products scale·A·B, whose SVD factors are free up to sign)
agrees within 1e-5 on at least 99.9% of its elements and within 2·lr·steps
everywhere, the rule of ``tests/test_torch_baselines.py``: Adam moves an
element by about lr per step whatever its gradient's size, so an element
whose gradient is about 0 may step the other way.  The round moved it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.configs.base import KernelConfig
from repro.data import synthetic as jsyn
from repro.federated.simulation import build_experiment as j_build
from repro_torch import configs as tconfigs
from repro_torch.convert import config_from_jax, lora_from_jax, to_numpy
from repro_torch.data import synthetic as tsyn
from repro_torch.federated.server import DENSE_BUDGET_RANKS
from repro_torch.federated.simulation import build_experiment as t_build
from repro_torch.models import model as tmodel

_DATA = tsyn.DataConfig(vocab_size=128, n_examples=64, seq_len=16,
                        n_clusters=4)
_TC = tconfigs.TrainConfig(batch_size=10)
_JTC = jbase.TrainConfig(**dataclasses.asdict(_TC))


def _jcfg(arch):
    cfg = jreg.get_config(arch, "smoke").replace(
        dtype="float32", kernels=KernelConfig(backend="reference"))
    if arch == "olmo-1.3b":
        cfg = cfg.replace(lora=dataclasses.replace(cfg.lora, rank=40))
    if arch == "qwen2-moe-a2.7b":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=8,
                                                  top_k=4))
    return cfg


CASES = ([("olmo-1.3b", m) for m in ("flame", "trivial", "hlora",
                                     "flexlora")]
         + [("qwen2-moe-a2.7b", "flame")])


def _fill_b(tree, rng, std=0.05):
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, std, np.shape(v)).astype(np.float32)
                    if k == "b" else _fill_b(v, rng, std))
                for k, v in tree.items()}
    return np.asarray(tree)


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _pairs(tree, path=()):
    if isinstance(tree, dict) and set(tree) == {"a", "b"}:
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], path + (k,))


def _products(lora, scale):
    return {path: scale * np.asarray(p["a"], np.float64)
            @ np.asarray(p["b"], np.float64) for path, p in _pairs(lora)}


def one_round_matches_jax(arch, method, data=_DATA):
    """One round in each package from the same start (``data``: the
    corpus, ``_DATA`` unless the arch reads codebook tokens); the
    comparisons of the module docstring."""
    jcfg = _jcfg(arch)
    jdata = jsyn.DataConfig(**dataclasses.asdict(data))
    tcfg = config_from_jax(jcfg)
    tparams = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    jparams = jax.tree.map(jnp.asarray, to_numpy(tparams))
    fed = tconfigs.FederatedConfig(num_clients=4, rounds=1, method=method)
    jfed = jbase.FederatedConfig(**dataclasses.asdict(
        dataclasses.replace(fed, round_engine="looped")))
    jexp = j_build(jcfg, fed=jfed, tc=_JTC, data=jdata, base_params=jparams)
    texp = t_build(tcfg, fed=fed, tc=_TC, data=data, base_params=tparams,
                   device="cpu")
    # b drawn off zero with numpy, so the one local step moves every
    # factor (from b = 0 the step would leave each a unchanged)
    start = _fill_b(_np32(jexp.server.global_lora), np.random.default_rng(7))
    jexp.server.global_lora = jax.tree.map(jnp.asarray, start)
    texp.server.global_lora = lora_from_jax(start, device="cpu")
    got_clients = [(c.k, c.rank) for c in texp.server.clients]
    assert got_clients == [(c.k, c.rank) for c in jexp.server.clients]
    if arch == "olmo-1.3b" and method != "flame":
        assert [r for _, r in got_clients] == list(
            DENSE_BUDGET_RANKS.values())
    if arch == "qwen2-moe-a2.7b":
        assert [k for k, _ in got_clients] == [4, 2, 1, 1]
    jres, tres = jexp.server.run_round(0), texp.server.run_round(0)
    assert tres.participating == jres.participating
    assert np.isfinite(tres.client_losses).all()
    np.testing.assert_allclose(tres.client_losses, jres.client_losses,
                               rtol=1e-5)
    got = to_numpy(texp.server.global_lora)
    want = _np32(jexp.server.global_lora)
    if method == "flexlora":
        got, want, start = (_products(t, jcfg.lora.scale)
                            for t in (got, want, start))
    else:
        got, want, start = ({p: pair for p, pair in _pairs(t)}
                            for t in (got, want, start))
    assert sorted(got) == sorted(want)
    if arch == "qwen2-moe-a2.7b":
        assert any("shared" in p for p in got)
    diff = np.concatenate([
        np.abs(np.asarray(g) - np.asarray(w)).ravel() for path in want
        for g, w in zip(jax.tree.leaves(got[path]),
                        jax.tree.leaves(want[path]))])
    steps = max(len(c.shard.tokens) // _TC.batch_size
                for c in texp.server.clients)
    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
    assert diff.max() <= 2 * _TC.learning_rate * steps, diff.max()
    moved = max(np.abs(np.asarray(g) - np.asarray(s)).max()
                for path in got for g, s in zip(
                    jax.tree.leaves(got[path]), jax.tree.leaves(start[path])))
    assert moved > 0


@pytest.mark.parametrize("arch,method", CASES)
def test_one_round_matches_jax(arch, method):
    one_round_matches_jax(arch, method)
