"""The port's tracer on the profiler's clock, its process-wide session
(spans with parents, device markers, host-sync counts) and what the
engine and the server record into it.

The file imports no JAX, so its card tests (marker ``gpu``; they skip
without a card, decided inside each test) also run without the suite's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_obs.py
"""
import json
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import FederatedConfig, TrainConfig, get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.federated.simulation import build_experiment
from repro_torch.models import model as tmodel
from repro_torch.obs import trace
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_map

CPU_ACT = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device markers and host syncs "
                    "exist only on the card")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch):
    """No session open or left over from another test."""
    trace.last_session()
    monkeypatch.setattr(trace, "_LAST", {})
    yield
    trace.last_session()


def _profile(device=None):
    acts = CPU_ACT if device is None else [
        torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _spans(rec, name):
    return [sp for sp in rec["spans"] if sp["name"] == name]


def _requests(cfg, n, seed=4):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, (int(rng.integers(4, 11)),)).astype(
                    np.int32), max_new_tokens=4, k=(2, 1)[i % 2])
            for i in range(n)]


def _engine(device="cpu", **kw):
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = tree_map(lambda t: t.to(device), tmodel.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    return cfg, ServingEngine(cfg, params, num_slots=4, slot_len=20,
                              slot_k=(2, 2, 1, 1), block_size=4, **kw)


# --------------------------------------------------------------------------
# the clock
# --------------------------------------------------------------------------

def test_program_span_contains_the_profiler_event_of_its_op(fresh):
    """A span round a CPU op holds that op's profiler event: the tracer
    stamps on the clock kineto stamps with."""
    a = torch.randn(192, 192)
    tr = trace.Tracer()
    with _profile() as prof:
        with tr.span("matmul"):
            a @ a
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(ev) == 1
    sp = [e for e in tr.events if e["name"] == "matmul"][0]
    start = tr.epoch_ns + round(sp["ts"] * 1e3)
    end = start + round(sp["dur"] * 1e3)
    assert start <= ev[0].start_ns()
    assert ev[0].start_ns() + ev[0].duration_ns() <= end


def test_dump_is_absolute_and_nested_spans_stay_valid(tmp_path):
    tr = trace.Tracer()
    with tr.span("outer", pid=3, round=7) as sp:
        tr.complete("given", tr.now(), tr.now(), pid=2)
        for i in range(20):
            with tr.span("inner", rid=i):
                pass
        sp.note(done=True)
    got = json.load(open(tr.dump(str(tmp_path / "t.json"))))
    assert trace.validate_chrome_trace(got) == []
    assert got["otherData"]["epoch_ns"] == tr.epoch_ns
    outer = [e for e in got["traceEvents"] if e["name"] == "outer"][0]
    assert abs(outer["ts"] * 1e3 - tr.epoch_ns) < 1e9      # since 1970
    inner = [e for e in got["traceEvents"] if e["name"] == "inner"]
    assert {e["parent_id"] for e in inner} == {outer["span_id"]}
    assert {e["pid"] for e in inner} == {3}
    assert [e["rid"] for e in inner] == list(range(20))
    assert {e["round"] for e in inner} == {7}
    assert outer["args"] == {"done": True} and outer["cat"] == "layer"


# --------------------------------------------------------------------------
# the session
# --------------------------------------------------------------------------

def test_no_profiler_no_session(fresh):
    assert trace.active() is trace.NULL_TRACER
    assert trace.current() is trace.NULL_TRACER
    explicit = trace.Tracer()
    assert trace.active(explicit) is explicit
    with trace.use(explicit):
        assert trace.active() is explicit and trace.current() is explicit
    assert trace.last_session() == {}
    _, eng = _engine()
    eng.run(_requests(eng.cfg, 4))
    assert trace.last_session() == {}


def test_session_records_the_engine_with_parents(fresh):
    """Under a profiler an engine built with no tracer records its layer
    spans: the model call below its prefill group, which lists the
    group's rids, and the pool's row counts."""
    cfg, eng = _engine()
    reqs = _requests(cfg, 6)
    with _profile():
        rep = eng.run(reqs)
    rec = trace.last_session()
    by_id = {sp["id"]: sp for sp in rec["spans"] if sp["id"] is not None}
    pre = _spans(rec, "model.prefill")
    assert pre and all(by_id[sp["parent"]]["name"] == "prefill"
                       for sp in pre)
    groups = [sp for sp in _spans(rec, "prefill") if sp["pid"] == 1]
    assert sorted(r for g in groups for r in g["rids"]) == \
        sorted(r.rid for r in reqs)
    for name in ("request", "queued", "decode"):       # one per request
        assert sorted(sp["rid"] for sp in _spans(rec, name)) == \
            sorted(r.rid for r in reqs)
    for g in groups:
        assert by_id[by_id[g["parent"]]["parent"]]["name"] == "engine.iter"
    dec = _spans(rec, "model.decode_step")
    assert len(dec) == len(rep.decode_step_s)
    assert all(by_id[sp["parent"]]["name"] == "decode_step" for sp in dec)
    assert {"engine.readback", "engine.emit", "pool.write",
            "pool.prepare_decode"} <= {sp["name"] for sp in rec["spans"]}
    c = rec["counters"]
    # 4 slots x 20 positions x 2 attention layers a decode step
    assert c["kv.rows_gathered"] == len(dec) * 4 * 20 * cfg.num_layers
    assert 0 < c["kv.rows_live"] < c["kv.rows_gathered"]
    assert rec["syncs"] == [] and not rec["device_markers"]
    for sp in rec["spans"]:
        assert sp["start_ns"] <= sp["end_ns"]


def test_session_records_the_round_with_ids(fresh):
    """A round under a profiler: the client step's spans below
    ``client.local_update``, each cohort's aggregation and read-back, all
    carrying the round's id."""
    fed = FederatedConfig(num_clients=4, rounds=1, participation=1.0,
                          method="flame", temperature=2, seed=0)
    exp = build_experiment(
        get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32"),
        fed=fed, tc=TrainConfig(batch_size=2, local_epochs=1),
        data=DataConfig(vocab_size=128, n_examples=24, seq_len=8,
                        n_clusters=2), device="cpu")
    with _profile():
        exp.server.run_round(5)
    rec = trace.last_session()
    by_id = {sp["id"]: sp for sp in rec["spans"]}
    (rnd,) = _spans(rec, "round 5")
    assert rnd["round"] == 5 and rnd["pid"] == 3
    steps = _spans(rec, "client.step")
    assert steps and len(_spans(rec, "model.lm_loss")) == len(steps)
    for name in ("model.lm_loss", "client.backward", "optim.adam"):
        assert {by_id[sp["parent"]]["name"] for sp in _spans(rec, name)} \
            == {"client.step"}
    assert {by_id[sp["parent"]]["name"] for sp in steps} == \
        {"client.local_update"}
    cohorts = _spans(rec, "cohort_update")
    assert len(_spans(rec, "agg.flame_acc_update")) == len(cohorts) == \
        len(_spans(rec, "server.readback"))
    assert sorted(i for c in cohorts for i in c["clients"]) == [0, 1, 2, 3]
    assert all(sp["round"] == 5 for sp in rec["spans"])


def test_session_leaves_every_global_as_it_found_it(fresh, monkeypatch):
    """The sync debug mode (a stand-in on the CPU), the warning filters
    and ``showwarning`` are back after ``last_session()``; a warning that
    is not a sync still reaches the handler installed before."""
    mode = {"now": 0, "set": []}
    monkeypatch.setattr(trace, "_get_sync_mode", lambda: mode["now"])

    def set_mode(m):
        mode["set"].append(m)
        mode["now"] = m
    monkeypatch.setattr(trace, "_set_sync_mode", set_mode)
    with _profile():
        pass                          # lazy imports of the profiler first
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        outer = warnings.showwarning = lambda *a, **k: seen.append(a[0])
        before = list(warnings.filters)
        with _profile():
            assert trace.active() is not trace.NULL_TRACER
            assert mode["now"] == "warn"
            assert warnings.showwarning is not outer
            warnings.warn("an unrelated warning")
        assert trace.last_session()["spans"] == []
        assert warnings.showwarning is outer
        assert list(warnings.filters) == before
    assert mode == {"now": 0, "set": ["warn", 0]}
    assert [str(w) for w in seen] == ["an unrelated warning"]


def test_sync_counter_charges_span_and_line(fresh):
    """Each sync warning is counted once, under the innermost open span,
    at the line that made it; none after the profiler stops."""
    with _profile():
        tr = trace.active()
        with trace.use(tr), tr.span("outer"):
            with tr.span("inner") as sp:
                line = 2 + _lineno()
                for _ in range(2):
                    warnings.warn(trace.SYNC_MESSAGE)
            warnings.warn(trace.SYNC_MESSAGE + " (outer)")
    warnings.warn(trace.SYNC_MESSAGE)        # after the window: not counted
    rec = trace.last_session()
    got = [(y["span_name"], y["site"]) for y in rec["syncs"]]
    here = f"tests/test_torch_obs.py:{line}"
    assert got == [("inner", here), ("inner", here),
                   ("outer", f"tests/test_torch_obs.py:{line + 1}")]
    assert rec["syncs"][0]["span"] == sp.id


def _lineno():
    import sys
    return sys._getframe(1).f_lineno


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_kernel_lies_inside_the_span_that_launched_it(cuda, fresh):
    a = torch.randn(2048, 2048, device=cuda)
    a @ a
    torch.cuda.synchronize()
    tr = trace.Tracer()
    with _profile(cuda) as prof:
        with tr.span("matmul"):
            a @ a
            torch.cuda.synchronize()
    kern = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and e.duration_ns() > 0]
    assert kern
    sp = [e for e in tr.events if e["name"] == "matmul"][0]
    start = tr.epoch_ns + round(sp["ts"] * 1e3)
    end = start + round(sp["dur"] * 1e3)
    for e in kern:
        assert start <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= end


@pytest.mark.gpu
def test_cuda_blocking_copy_counts_one_sync_pinned_none(cuda, fresh):
    host = np.arange(4096, dtype=np.float32)
    pinned = torch.from_numpy(host).pin_memory()
    before = torch.cuda.get_sync_debug_mode()
    with _profile(cuda):
        tr = trace.active()
        with trace.use(tr):
            with tr.span("blocking"):
                torch.as_tensor(host, device=cuda)
            with tr.span("pinned"):
                pinned.to(cuda, non_blocking=True)
    rec = trace.last_session()
    assert [y["span_name"] for y in rec["syncs"]] == ["blocking"]
    assert rec["syncs"][0]["site"].startswith("tests/test_torch_obs.py:")
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.gpu
def test_cuda_dev_ms_matches_event_time_of_a_matmul(cuda, fresh):
    a = torch.randn(8192, 8192, device=cuda)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    a @ a
    e1.record()
    torch.cuda.synchronize()
    want = e0.elapsed_time(e1)
    with _profile(cuda):
        tr = trace.active()
        with tr.span("matmul", device=True):
            a @ a
    (sp,) = _spans(trace.last_session(), "matmul")
    assert sp["dev_ms"] == pytest.approx(want, rel=0.1)


@pytest.mark.gpu
def test_cuda_engine_session_times_model_calls(cuda, fresh):
    """The engine on the card under a profiler: every model call has its
    device time, the pool's row counts add up, and the session leaves the
    sync debug mode as it was."""
    cfg, eng = _engine(device=cuda)
    before = torch.cuda.get_sync_debug_mode()
    eng.run(_requests(cfg, 4))
    with _profile(cuda):
        eng.run(_requests(cfg, 8))
    rec = trace.last_session()
    calls = _spans(rec, "model.prefill") + _spans(rec, "model.decode_step")
    assert calls and all(sp["dev_ms"] > 0 for sp in calls)
    assert rec["device_markers"]
    assert torch.cuda.get_sync_debug_mode() == before
    assert time.time_ns() > rec["spans"][-1]["end_ns"]
