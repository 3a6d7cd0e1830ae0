"""Federated rounds on the audio arch (``musicgen-large`` SMOKE: K = 2
codebooks, V = 128), the port against the JAX package at float32 on the
CPU: one FLAME round and one HLoRA round (client ranks 4 / 2 / 2 / 1),
built through ``build_experiment`` with ``DataConfig(num_codebooks=2)``
as ``benchmarks/common.py`` builds its data, with the comparisons and
tolerances of ``tests/test_torch_arch_rounds.py`` (the JAX side on its
looped engine, one local step per client); then the device round driver
against the host driver on the same (n_steps, B, S, K) plans.  Neither
package special-cases codebooks in its federated code, and these tests
hold that: the plans, their padding and the device driver's uploads
keep the codebook axis.  A file of its own, so that a worker of the
suite shares these JAX compiles and ``tests/test_torch_audio.py`` stays
short.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsyn
from repro_torch.federated import client as client_lib
from repro_torch.federated.simulation import build_experiment
from repro_torch.models import model as tmodel
from repro_torch.tree import leaves
from test_torch_arch_rounds import one_round_matches_jax

ARCH = "musicgen-large"
DATA = tsyn.DataConfig(vocab_size=128, n_examples=64, seq_len=16,
                       n_clusters=4, num_codebooks=2)


@pytest.mark.parametrize("method", ["flame", "hlora"])
def test_one_round_matches_jax(method):
    one_round_matches_jax(ARCH, method, data=DATA)


def test_device_driver_equals_host_driver_on_codebook_plans():
    """Two FLAME rounds at participation 0.75 (3 of 4 clients, so a
    cohort runs short and takes ``empty_plan`` padding slots) on the
    device driver, one checkpoint segment, against the host driver: the
    global adapter, the client losses and the participants bit-equal.
    The plans, padded plans and the segment's uploaded tokens are
    (n_steps, B, S, K)."""
    cfg = tconfigs.get_config(ARCH, "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tc = tconfigs.TrainConfig(batch_size=8)
    fed = tconfigs.FederatedConfig(num_clients=4, rounds=2,
                                   participation=0.75, checkpoint_every=2)
    runs = {}
    for driver in ("device", "host"):
        exp = build_experiment(cfg, fed=dataclasses.replace(
            fed, round_driver=driver), tc=tc, data=DATA, base_params=params,
            device="cpu")
        srv = exp.server
        if driver == "device":
            plan = client_lib.make_batch_plan(srv.clients[0], tc, 0)
            assert plan.tokens.shape[1:] == plan.labels.shape[1:] == (8, 16,
                                                                      2)
            assert plan.mask.shape[1:] == (8, 16)
            padded = client_lib.pad_plan(plan, plan.n_steps + 2)
            assert padded.tokens.shape == (plan.n_steps + 2, 8, 16, 2)
            assert client_lib.empty_plan(padded).tokens.shape == \
                padded.tokens.shape
            keys, caps, xs, _ = srv._prep_device_rounds(0)
            assert all(x["tokens"].shape[-3:] == (8, 16, 2)
                       for x in xs.values())
            up = srv._upload_segment(xs, slice(0, 2))
            assert up[0][0]["tokens"].shape[-1] == 2
            # replay the sampler: the prep above drew both rounds
            srv = build_experiment(cfg, fed=dataclasses.replace(
                fed, round_driver=driver), tc=tc, data=DATA,
                base_params=params, device="cpu").server
        runs[driver] = (srv, srv.run())
    (ds, dh), (hs, hh) = runs["device"], runs["host"]
    assert [r.participating for r in dh] == [r.participating for r in hh]
    assert all(len(r.participating) == 3 for r in dh)
    for rd, rh in zip(dh, hh):
        assert rd.client_losses == rh.client_losses
        assert np.isfinite(rd.client_losses).all()
    for a, b in zip(leaves(ds.global_lora), leaves(hs.global_lora)):
        assert torch.equal(a, b)
