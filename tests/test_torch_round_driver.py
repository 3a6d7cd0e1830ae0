"""The port's device round driver (``round_driver="device"``) against its
host driver, and its round preparation against the JAX package's.

The twins of ``tests/test_round_driver.py``, on the tiny MoE at fp32 on
the CPU: the device driver draws every round's participants up front from
the host loop's sampling stream, runs cohorts against a static key set
(short cohorts padded with exact no-op slots), keeps the rescalers in a
stacked bank and merges the cohorts' FLAME accumulators per round.  It
must give the host driver's rounds: participant sets, per-client losses
and activation frequencies, the global adapter and every rescaler within
rtol 2e-5 / atol 1e-6 (the reference's tolerance; on the CPU they are
bit-equal, which is checked too), across 1, 2 and 4 cohorts, both cohort
backends, checkpoint segments and resumes from either driver.
``_prep_device_rounds`` is host numpy, so it is held to the JAX
package's exactly without a JAX compile.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.configs import base as jbase
from repro.data import synthetic as jsyn
from repro.federated import client as jclient
from repro.federated.server import FederatedServer as JServer
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.convert import config_from_jax
from repro_torch.data.synthetic import Corpus, DataConfig
from repro_torch.federated.cohort import group_by_key
from repro_torch.federated.simulation import build_experiment
from repro_torch.tree import leaves

CFG = config_from_jax(tiny_moe())
TC = tconfigs.TrainConfig(batch_size=2, local_epochs=1)
DATA = DataConfig(vocab_size=CFG.vocab_size, n_examples=48, seq_len=16,
                  n_clusters=4)


def _experiment(driver, *, clients=4, rounds=3, participation=0.75,
                seed=0, backend="vmap", budget=None, tc=TC,
                checkpoint_every=1, shard_sizes=None, **fed_kw):
    fed = tconfigs.FederatedConfig(
        num_clients=clients, rounds=rounds, participation=participation,
        method="flame", temperature=2, seed=seed, round_driver=driver,
        cohort_backend=backend, checkpoint_every=checkpoint_every, **fed_kw)
    exp = build_experiment(CFG, fed=fed, tc=tc, data=DATA, budget=budget,
                           device="cpu")
    if shard_sizes is not None:
        # pinned shard sizes fix the plans' batch sizes, and with them the
        # number of cohorts
        for c, n in zip(exp.server.clients, itertools.cycle(shard_sizes)):
            s = c.shard
            assert len(s.tokens) >= n, (c.client_id, len(s.tokens), n)
            c.shard = Corpus(s.tokens[:n], s.labels[:n], s.mask[:n],
                             s.clusters[:n])
    return exp


def _assert_trees_close(a, b, rtol=2e-5, atol=1e-6):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=rtol, atol=atol)


def _assert_same_rounds(host, device, rtol=2e-5, atol=1e-6):
    assert len(host.history) == len(device.history)
    for rh, rd in zip(host.history, device.history):
        assert rh.round_idx == rd.round_idx
        assert rh.participating == rd.participating
        np.testing.assert_allclose(rh.client_losses, rd.client_losses,
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
        assert rd.activation_drift is not None
        for fh, fd in zip(rh.client_freqs, rd.client_freqs):
            assert set(fh) == set(fd)
            for pos in fh:
                np.testing.assert_allclose(fh[pos], fd[pos], rtol=1e-5,
                                           atol=1e-6)
    _assert_trees_close(host.global_lora, device.global_lora, rtol, atol)
    for ch, cd in zip(host.clients, device.clients):
        assert (ch.rescaler is None) == (cd.rescaler is None)
        if ch.rescaler is not None:
            _assert_trees_close(ch.rescaler, cd.rescaler, rtol, atol)


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


# --------------------------------------------------------------------------
# the host oracle: 1, 2 and 4 cohorts, both backends, checkpoint segments
# --------------------------------------------------------------------------

# (id, experiment kwargs, cohorts); the 4-cohort layout crosses k in {2, 1}
# with pinned shard sizes that give step batch sizes {3, 1, 2}
LAYOUTS = {
    "one": (dict(budget="b1"), 1),
    "two": (dict(), 2),
    "two-seed3": (dict(seed=3), 2),
    "four": (dict(clients=8, participation=0.6,
                  tc=dataclasses.replace(TC, batch_size=3),
                  shard_sizes=[4, 4, 1, 2, 4, 4, 1, 2]), 4),
}


@pytest.fixture(scope="module")
def host_runs():
    runs = {}
    for name, (kw, _) in LAYOUTS.items():
        exp = _experiment("host", **kw)
        exp.server.run()
        runs[name] = exp.server
    return runs


@pytest.mark.parametrize("layout,backend", [
    ("one", "vmap"), ("two", "vmap"), ("two-seed3", "vmap"),
    ("two", "map"), ("four", "vmap")])
def test_device_driver_matches_host_oracle(layout, backend, host_runs):
    kw, n_cohorts = LAYOUTS[layout]
    device = _experiment("device", backend=backend, **kw)
    order, _ = group_by_key(device.server.clients, kw.get("tc", TC),
                            rank_of=device.server._dist_rank)
    assert len(order) == n_cohorts
    device.server.run()
    host = host_runs[layout]
    _assert_same_rounds(host, device.server)
    # the cohorts' accumulators fold in the host loop's order, and merging
    # into zero-initialised ones is exact: the same bits
    assert _bits_equal(host.global_lora, device.server.global_lora)
    for ch, cd in zip(host.clients, device.server.clients):
        assert _bits_equal(ch.rescaler, cd.rescaler)


def test_device_driver_checkpoint_segments(tmp_path, host_runs):
    """checkpoint_every=2 over 3 rounds: a 2-round segment, then a
    1-round one, a checkpoint streamed at each end, still the host's
    rounds; the last checkpoint records round 3 and the trained
    rescalers.  The round spans are the segments' wall clock amortised
    over their rounds."""
    from repro_torch.obs import Tracer
    path = str(tmp_path / "seg.npz")
    device = _experiment("device", checkpoint_every=2)
    saves = []
    save = device.server.save_checkpoint
    device.server.save_checkpoint = lambda p: (saves.append(
        len(device.server.history)), save(p))
    tracer = Tracer()
    device.server._set_tracer(tracer)
    device.server.run(checkpoint_to=path)
    assert saves == [2, 3]
    _assert_same_rounds(host_runs["two"], device.server)
    tree, meta = ckpt_io.load(path)
    assert meta["round_idx"] == 3
    _assert_trees_close(tree["rescalers"][0], device.server.clients[0]
                        .rescaler, 0, 0)
    spans = [e for e in tracer.events if e.get("name", "").startswith(
        "round ")]
    assert [e["name"] for e in spans] == ["round 0", "round 1", "round 2"]
    assert all(e["args"]["driver"] == "device" and e["args"]["amortized"]
               for e in spans)
    assert spans[0]["dur"] == pytest.approx(spans[1]["dur"], rel=1e-6)


# --------------------------------------------------------------------------
# resume: bit-exact on the device driver, and across drivers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def straight_runs():
    runs = {}
    for driver in ("host", "device"):
        exp = _experiment(driver, rounds=4, participation=1.0)
        exp.server.run()
        runs[driver] = exp.server
    return runs


@pytest.mark.parametrize("first_driver", ["device", "host"])
def test_device_resume(tmp_path, first_driver, straight_runs):
    """A run checkpointed at round 2 (by either driver) and resumed on the
    device driver replays the sampling stream and reproduces rounds 2..3
    of a straight run: bit for bit after a device checkpoint, within the
    tolerance after a host one (checkpoints are driver-agnostic)."""
    path = str(tmp_path / "fed.npz")
    kw = dict(rounds=4, participation=1.0)
    first = _experiment(first_driver, **kw)
    first.server.fed = dataclasses.replace(first.server.fed, rounds=2)
    first.server.run(checkpoint_to=path)

    resumed = _experiment("device", **kw)
    resumed.server.run(resume_from=path, checkpoint_to=path)
    assert [r.round_idx for r in resumed.server.history] == [2, 3]
    for straight in straight_runs.values():
        assert ([r.participating for r in resumed.server.history]
                == [r.participating for r in straight.history[2:]])
    if first_driver == "device":
        straight = straight_runs["device"]
        assert _bits_equal(straight.global_lora, resumed.server.global_lora)
        for ca, cb in zip(straight.clients, resumed.server.clients):
            assert _bits_equal(ca.rescaler, cb.rescaler)
        for ra, rb in zip(straight.history[2:], resumed.server.history):
            np.testing.assert_array_equal(ra.client_losses, rb.client_losses)
    else:
        _assert_trees_close(straight_runs["host"].global_lora,
                            resumed.server.global_lora)
    _, meta = ckpt_io.load(path)
    assert meta["round_idx"] == 4


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(method="hlora"), "flame"),
    (dict(round_engine="looped"), "batched"),
    (dict(checkpoint_every=0), "checkpoint_every"),
    ("mixed", "homogeneous rescaler"),
], ids=["method", "engine", "checkpoint_every", "mixed-rescalers"])
def test_device_driver_rejects_unsupported_configs(kw, match):
    fed = tconfigs.FederatedConfig(num_clients=2, rounds=1,
                                   round_driver="device",
                                   **({} if kw == "mixed" else kw))
    exp = build_experiment(CFG, fed=fed, tc=TC, data=DATA, device="cpu")
    if kw == "mixed":
        exp.server.clients[1].rescaler = None
    with pytest.raises(ValueError, match=match):
        exp.server.run()


# --------------------------------------------------------------------------
# round preparation against the JAX package's
# --------------------------------------------------------------------------

def _jax_server(port_exp, tc):
    """The JAX package's server over the port's registry: the same shards,
    budgets and rescaler presence (the preparation reads nothing else)."""
    clients = [jclient.ClientState(
        client_id=c.client_id,
        shard=jsyn.Corpus(c.shard.tokens, c.shard.labels, c.shard.mask,
                          c.shard.clusters),
        k=c.k, rank=c.rank,
        rescaler=None if c.rescaler is None else {"pos0": np.zeros(1)},
        rescaler_mode=c.rescaler_mode, budget=c.budget)
        for c in port_exp.server.clients]
    fed = jbase.FederatedConfig(**dataclasses.asdict(port_exp.server.fed))
    return JServer(None, None, None, clients, fed,
                   jbase.TrainConfig(**dataclasses.asdict(tc)))


@pytest.mark.parametrize("layout,start,padded", [
    ("two", 0, False), ("four", 0, True), ("four", 1, True)])
def test_prep_device_rounds_matches_jax(layout, start, padded):
    kw, _ = LAYOUTS[layout]
    exp = _experiment("device", **kw)
    jserver = _jax_server(exp, kw.get("tc", TC))
    for s in (exp.server, jserver):
        for _ in range(start):          # a resume replays the stream
            s._sample_participants()
    keys, caps, xs, meta = exp.server._prep_device_rounds(start)
    jkeys, jcaps, jxs, jmeta = jserver._prep_device_rounds(start)
    assert keys == jkeys and caps == jcaps
    assert meta == jmeta
    assert sorted(xs) == sorted(jxs)
    for kk in xs:
        assert sorted(xs[kk]) == sorted(jxs[kk]) == sorted(
            ["tokens", "labels", "mask", "valid", "slot", "size"])
        for name in xs[kk]:
            got, want = xs[kk][name], jxs[kk][name]
            assert got.dtype == want.dtype, (kk, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{kk}.{name}")
    # a cohort short in some round runs padding slots of size 0
    pad = [xs[kk]["slot"] == len(exp.server.clients) for kk in xs]
    assert any(p.any() for p in pad) == padded
    for kk, p in zip(xs, pad):
        assert (xs[kk]["size"][p] == 0).all()
        assert (xs[kk]["valid"][p] == 0).all()


def test_train_launcher_runs_the_device_driver(tmp_path, capsys):
    from repro_torch.launch import train as ttrain
    path = str(tmp_path / "fed.npz")
    ttrain.main(["--federated", "--device", "cpu", "--clients", "4",
                 "--rounds", "3", "--participation", "0.75",
                 "--round-driver", "device", "--checkpoint-every", "2",
                 "--checkpoint-to", path])
    out = capsys.readouterr().out
    assert "device driver" in out and "round 2: 3 clients" in out
    assert "via the 'device' driver" in out and "done" in out
    assert ckpt_io.load(path)[1]["round_idx"] == 3
