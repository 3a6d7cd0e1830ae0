"""The port's data and optimizer helpers against the JAX package's:
``data.partition.heterogeneity_stats`` on the same Dirichlet shards
(exactly), ``optim.adam.cosine_schedule`` / ``constant_schedule`` over
warmup, decay and past the end (float32, within 1e-6 relative)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.optim import adam as jadam
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.optim import adam as tadam


@pytest.mark.parametrize("alpha", [0.5, 50.0])
def test_heterogeneity_stats_match_the_reference(alpha):
    data = tsyn.DataConfig(vocab_size=64, n_examples=256, seq_len=16,
                           n_clusters=6)
    jdata = jsyn.DataConfig(**dataclasses.asdict(data))
    got = tpart.heterogeneity_stats(tpart.dirichlet_partition(
        tsyn.make_corpus(data), 5, alpha, seed=2))
    want = jpart.heterogeneity_stats(jpart.dirichlet_partition(
        jsyn.make_corpus(jdata), 5, alpha, seed=2))
    assert got["sizes"] == want["sizes"] and sum(got["sizes"]) == 256
    np.testing.assert_array_equal(got["cluster_hist"], want["cluster_hist"])
    assert got["cluster_hist"].shape == (5, 6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (20, 20)])
def test_lr_schedules_match_the_reference(warmup, total):
    cos, jcos = (m.cosine_schedule(3e-4, warmup, total)
                 for m in (tadam, jadam))
    for step in (0, 1, 5, warmup, warmup + 1, (warmup + total) // 2,
                 total - 1, total, total + 7):
        got = cos(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            float(got), float(jcos(jnp.asarray(step, jnp.int32))),
            rtol=1e-6, atol=1e-12)
        assert float(cos(step)) == float(got)
    const = tadam.constant_schedule(3e-4)(torch.tensor(9))
    assert const.dtype == torch.float32
    assert float(const) == float(jadam.constant_schedule(3e-4)(
        jnp.asarray(9)))
