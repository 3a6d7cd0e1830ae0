"""The readers of the program's own spans: on a SMOKE cell's traced run on
the CPU, and on a session record written by hand."""
import time

import pytest
import torch

from portbench import core
from portbench.tests import smoke

CPU = torch.device("cpu")
SEED = 2**33 + 23
NEW = {"serve": ("host_syncs_per_call.serve", "kv_gather_live_share.serve",
                 "engine_self_ms.serve"),
       "fl": ("host_syncs_per_step.train", "server_ms_per_round.train")}


@pytest.fixture
def tree(tmp_path):
    return smoke.write(tmp_path)


@pytest.fixture
def fresh(monkeypatch):
    from repro_torch.obs import trace
    trace.last_session()
    monkeypatch.setattr(trace, "_LAST", {})
    return trace


def run(root, cell, trace):
    return core.run(root, cell, SEED, 0.3, trace, CPU, time.perf_counter())


def test_readers_on_a_smoke_session(tree, fresh):
    """A traced serving run reads the three serving metrics (no host sync
    on the CPU; the pool's rows; the engine's own time), a traced round
    the steps' syncs; ``server_ms_per_round`` needs the card's markers."""
    res = run(tree, "olmoe.serve-smoke", True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["host_syncs_per_call.serve"] == 0.0
    assert 0.0 < got["kv_gather_live_share.serve"] < 100.0
    assert got["engine_self_ms.serve"] > 0.0
    rec = fresh.last_session()
    c = rec["counters"]
    assert got["kv_gather_live_share.serve"] == pytest.approx(
        100.0 * c["kv.rows_live"] / c["kv.rows_gathered"])
    res = run(tree, "olmoe.fl-smoke", True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["host_syncs_per_step.train"] == 0.0
    assert "server_ms_per_round.train" not in got


@pytest.mark.parametrize("kind", ["serve", "fl"])
def test_untraced_run_keeps_its_keys_and_opens_no_session(tree, fresh,
                                                          kind):
    cell = f"olmoe.{kind}-smoke"
    res = run(tree, cell, False)
    assert not set(NEW[kind]) & set(res["metrics"])
    assert fresh.last_session() == {}


def _span(i, name, parent, t0, t1, **kw):
    return dict(id=i, name=name, parent=parent, start_ns=t0, end_ns=t1,
                **kw)


def test_readers_by_hand(monkeypatch, tree):
    """Two engine iterations (10 and 6 ms; model, pool and read-back
    spans cover 7 and 5 ms of them, one nested pool span counted once),
    two model calls with three syncs under them and one outside, two
    client steps with one sync, two rounds with 4 ms of server device
    time."""
    ms = 1_000_000
    spans = [
        _span(1, "engine.iter", None, 0, 10 * ms),
        _span(2, "prefill", 1, 0, 8 * ms),
        _span(3, "model.prefill", 2, 1 * ms, 5 * ms),
        _span(4, "pool.write", 2, 5 * ms, 6 * ms),
        _span(5, "engine.readback", 2, 6 * ms, 8 * ms),
        _span(6, "engine.iter", None, 20 * ms, 26 * ms),
        _span(7, "decode_step", 6, 20 * ms, 25 * ms),
        _span(8, "pool.prepare_decode", 7, 20 * ms, 21 * ms),
        _span(9, "pool.inner", 8, 20 * ms, 21 * ms),
        _span(10, "model.decode_step", 7, 21 * ms, 25 * ms),
        _span(11, "round 0", None, 30 * ms, 40 * ms),
        _span(12, "client.step", 11, 30 * ms, 31 * ms),
        _span(13, "model.lm_loss", 12, 30 * ms, 31 * ms),
        _span(14, "client.step", 11, 31 * ms, 32 * ms),
        _span(15, "distribute", 11, 32 * ms, 33 * ms, dev_ms=0.5),
        _span(16, "agg.flame_acc_update", 11, 33 * ms, 34 * ms,
              dev_ms=2.0),
        _span(17, "aggregate", 11, 34 * ms, 35 * ms, dev_ms=1.0),
        _span(18, "round 1", None, 40 * ms, 50 * ms),
        _span(19, "agg.flame_acc_update", 18, 41 * ms, 42 * ms,
              dev_ms=4.5),
        _span(None, "request", None, 0, 26 * ms)]
    syncs = [dict(t_ns=0, span=s, span_name="", site="x.py:1")
             for s in (3, 3, 10, 5, 13, None)]
    rec = {"spans": spans, "syncs": syncs,
           "counters": {"kv.rows_gathered": 400, "kv.rows_live": 100}}
    from repro_torch.obs import trace
    monkeypatch.setattr(trace, "last_session", lambda: rec)
    read = {name: core.reader(tree, name) for kind in NEW.values()
            for name in kind}
    assert read["host_syncs_per_call.serve"]({}) == 1.5
    assert read["kv_gather_live_share.serve"]({}) == 25.0
    assert read["engine_self_ms.serve"]({}) == pytest.approx(
        ((10 - 7) + (6 - 5)) / 2)
    assert read["host_syncs_per_step.train"]({}) == 0.5
    assert read["server_ms_per_round.train"]({}) == pytest.approx(4.0)
    rec["spans"][15]["dev_ms"] = None
    assert read["server_ms_per_round.train"]({}) is None
    monkeypatch.setattr(trace, "last_session", lambda: {})
    assert all(r({}) is None for r in read.values())


def test_readers_return_none_on_a_program_without_sessions(monkeypatch,
                                                           tree):
    """The parent's program has no ``last_session``: nothing read, no
    error."""
    from repro_torch.obs import trace
    monkeypatch.delattr(trace, "last_session")
    for kind in NEW.values():
        for name in kind:
            assert core.reader(tree, name)({}) is None
