"""The port's checkpoints: the reference's npz format, both ways, and a
resumed federated run against a straight one, on the CPU.

A resumed run replays the participant stream and restores the global LoRA
and every rescaler bit for bit, so on the CPU its rounds equal the
straight run's exactly (the same plain ops in the same order).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import io as tckpt
from repro_torch.data import synthetic as tsyn
from repro_torch.federated.simulation import build_experiment as t_build
from repro_torch.tree import leaves
from test_torch_train import TCFG, TPARAMS


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"blocks": {"pos0": {"a": torch.randn(2, 3, generator=g)
                                .bfloat16(),
                                "b": torch.randn(4, generator=g)}},
            "rescalers": [{"pos0": torch.ones(2)}, None,
                          {"pos0": torch.zeros(2)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip_bf16_fp32_none_and_lists(tmp_path):
    path = str(tmp_path / "ck.npz")
    tree = _tree()
    tckpt.save(path, tree, meta={"round_idx": 3})
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.meta.json"]
    got, meta = tckpt.load(path)
    assert meta == {"round_idx": 3}
    a = got["blocks"]["pos0"]["a"]
    assert a.dtype == torch.bfloat16 and torch.equal(a, tree["blocks"]
                                                     ["pos0"]["a"])
    assert torch.equal(got["blocks"]["pos0"]["b"], tree["blocks"]["pos0"]["b"])
    assert got["rescalers"][1] is None and len(got["rescalers"]) == 3
    assert torch.equal(got["rescalers"][2]["pos0"], torch.zeros(2))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    moved = tckpt.to_device(got, "cpu")
    assert moved["rescalers"][1] is None
    with np.load(path) as raw:            # bf16 as its bits, tagged
        assert raw["blocks/pos0/a__bf16__"].dtype == np.uint16
    tckpt.save(str(tmp_path / "bare"), {"x": torch.ones(1)})
    assert tckpt.load(str(tmp_path / "bare"))[1] is None


def test_bf16_files_cross_load_between_packages(tmp_path):
    tree = _tree()
    port_path = str(tmp_path / "port.npz")
    tckpt.save(port_path, tree, meta={"k": 1})
    jtree, jmeta = jckpt.load(port_path)
    ja = jtree["blocks"]["pos0"]["a"]
    assert ja.dtype == ml_dtypes.bfloat16 and jmeta == {"k": 1}
    np.testing.assert_array_equal(ja.astype(np.float32),
                                  tree["blocks"]["pos0"]["a"].float().numpy())
    assert jtree["rescalers"][1] is None

    jax_path = str(tmp_path / "jax.npz")
    vals = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jckpt.save(jax_path, {"w": jnp.asarray(vals, jnp.bfloat16),
                          "seq": [jnp.ones(2), None]})
    got, _ = tckpt.load(jax_path)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["w"].float().numpy(),
        vals.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert got["seq"][1] is None and torch.equal(got["seq"][0],
                                                 torch.ones(2))


_DATA = tsyn.DataConfig(vocab_size=128, n_examples=100, seq_len=16,
                        n_clusters=4)
_TC = tconfigs.TrainConfig(batch_size=6)
_FED = tconfigs.FederatedConfig(num_clients=6, rounds=2, participation=0.5)


def _exp(**fed_kw):
    return t_build(TCFG, fed=dataclasses.replace(_FED, **fed_kw), tc=_TC,
                   data=_DATA, base_params=TPARAMS, device="cpu")


def _state(exp):
    return list(leaves(exp.server.global_lora)) + [
        c.rescaler["pos0"] for c in exp.server.clients]


def test_resume_equals_straight_run(tmp_path):
    straight = _exp()
    full = straight.server.run()
    path = str(tmp_path / "state.npz")
    first = _exp(rounds=1)
    first.server.run(checkpoint_to=path)
    with open(path + ".meta.json") as f:
        assert json.load(f) == {"round_idx": 1, "method": "flame",
                                "num_clients": 6}
    resumed = _exp()
    metrics = str(tmp_path / "metrics.json")
    rest = resumed.server.run(resume_from=path, checkpoint_to=path,
                              metrics_to=metrics)
    assert [r.round_idx for r in rest] == [1]
    assert rest[0].participating == full[1].participating
    assert rest[0].client_losses == full[1].client_losses
    for a, b in zip(_state(resumed), _state(straight)):
        assert torch.equal(a, b)
    assert tckpt.load(path)[1]["round_idx"] == 2
    with open(metrics) as f:
        snap = json.load(f)
    assert snap["fed.rounds"]["value"] == 1
    assert snap["fed.participants"]["value"] == 3
    assert snap["fed.round.mean_loss"]["value"] == pytest.approx(
        float(np.mean(rest[0].client_losses)))
    assert snap["fed.activation.entropy.pos0"]["value"] == pytest.approx(
        rest[0].activation_drift["pos0"]["entropy_mean"])
    # drift is measured against the resumed process's previous round only
    assert rest[0].activation_drift["pos0"]["l1_drift"] is None
    assert full[1].activation_drift["pos0"]["l1_drift"] is not None


def test_foreign_or_mismatched_checkpoint_raises(tmp_path):
    exp = _exp()
    plain = str(tmp_path / "plain.npz")
    tckpt.save(plain, {"x": torch.ones(2)})
    with pytest.raises(ValueError, match="not a FederatedServer checkpoint"):
        exp.server.restore_checkpoint(plain)
    meta_only = str(tmp_path / "meta_only.npz")
    tckpt.save(meta_only, {"x": torch.ones(2)},
               meta={"round_idx": 1, "method": "flame", "num_clients": 6})
    with pytest.raises(ValueError, match="not a FederatedServer checkpoint"):
        exp.server.restore_checkpoint(meta_only)
    other = _exp(num_clients=4)
    path = str(tmp_path / "four.npz")
    other.server.save_checkpoint(path)
    with pytest.raises(ValueError, match="4 clients"):
        exp.server.restore_checkpoint(path)
    six = str(tmp_path / "six.npz")
    exp.server.save_checkpoint(six)
    with pytest.raises(ValueError, match="method 'flame'"):
        _exp(method="hlora").server.restore_checkpoint(six)
