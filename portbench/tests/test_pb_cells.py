"""The harness end to end on the CPU at SMOKE size: cells found from files
by name, the program against the plain reference for both entries, the
lower-precision control failing, each fault the cells can have failing,
and nothing of JAX or the JAX package loaded."""
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import core
from portbench.drivers import fl_round
from portbench.tests import smoke

CPU = torch.device("cpu")
SEED = 2**33 + 17            # wider than 32 bits, as the driver's are
ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def tree(tmp_path):
    return smoke.write(tmp_path)


def run(root, cell, trace=False, seconds=0.3, seed=SEED):
    return core.run(root, cell, seed, seconds, trace, CPU,
                    time.perf_counter())


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    mix = dict(smoke.SERVE_SMOKE, rate_rps=30.0, prompt_len_max=12)
    root = smoke.write(tmp_path, configs={"tiny": dict(
        smoke.OLMOE_SMOKE, name="tiny", num_experts=8)},
        mixes={"short-serve": mix},
        cells={"tiny.short-serve": ("tiny", "short-serve")})
    (root / "portbench" / "metrics" / "requests_done.serve.py").write_text(
        "def read(rec):\n    return float(len(rec['run']['queue_s']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "requests_done.serve", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "ttft_p95_ms", "workloads": ["tiny.short-serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = core.load_cell(root, "tiny.short-serve")
    assert cell.model["num_experts"] == 8
    assert cell.traffic["rate_rps"] == 30.0
    assert "requests_done.serve" in [m["name"] for m in cell.per_layer()]
    res = run(root, "tiny.short-serve", trace=True)
    assert res["correct"]
    assert res["metrics"]["requests_done.serve"]["value"] == \
        res["attempted"] == 9
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["olmoe.fl-smoke", "qwen.fl-smoke",
                                  "olmoe.serve-smoke", "qwen.serve-smoke"])
def test_program_matches_reference_at_smoke_size(tree, cell):
    res = run(tree, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = set(res["metrics"])
    assert {"setup_s", "peak_mem_gib"} <= names
    assert ("train_tokens_per_s" in names) == ("fl" in cell)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"] / 10 if c["limit"] else \
            c["value"] <= 0


@pytest.mark.parametrize("cell", ["olmoe.fl-smoke", "qwen.fl-smoke"])
def test_fp8_control_fails_the_training_check(tree, cell):
    c = core.load_cell(tree, cell)
    drv = fl_round.Driver(c, CPU)
    drv.setup(SEED)
    drv.free_program()
    got = drv.stand_in(precision="fp8")
    judged = core.judge(got, c.limits)
    assert not all(j["ok"] for j in judged.values()), got


@pytest.mark.parametrize("cell", ["olmoe.serve-smoke", "qwen.serve-smoke"])
def test_fp8_control_fails_the_serving_check(tree, cell):
    c = core.load_cell(tree, cell)
    drv = core.driver("serve_open").Driver(c, CPU)
    drv.setup(SEED)
    drv.window(0.3)
    drv.free_program()
    got = drv.check(control=True)
    assert got["logit_err_p90"] > c.limits["logit_err_p90"], got


def test_fault_step_returns_its_state_unchanged(tree, monkeypatch):
    from repro_torch.optim import adam
    orig = adam.update

    def unchanged(grads, state, params, **kw):
        return params, orig(grads, state, params, **kw)[1]

    monkeypatch.setattr(adam, "update", unchanged)
    res = run(tree, "olmoe.fl-smoke")
    assert not res["correct"]
    assert res["checks"]["delta"]["value"] > 0.5


def test_fault_half_of_the_batch_left_out(tree, monkeypatch):
    from repro_torch.federated import client
    orig = client._train_step

    def half(cfg, params, tr, opt, tokens, labels, mask, **kw):
        h = tokens.shape[0] // 2
        return orig(cfg, params, tr, opt, tokens[:h], labels[:h], mask[:h],
                    **kw)

    monkeypatch.setattr(client, "_train_step", half)
    res = run(tree, "olmoe.fl-smoke")
    assert not res["correct"]
    assert res["checks"]["delta"]["value"] > res["checks"]["delta"]["limit"]


def test_fault_token_altered_where_it_is_produced(tree, monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    orig = ServingEngine._pick

    def altered(self, logits_row, a, drawn):
        tok, nll = orig(self, logits_row, a, drawn)
        return ((tok + 1) % len(logits_row) if len(a.tokens) == 1 else tok,
                nll)

    monkeypatch.setattr(ServingEngine, "_pick", altered)
    res = run(tree, "olmoe.serve-smoke")
    assert not res["correct"]
    assert res["checks"]["token_excess"]["value"] > 0


def test_fault_logits_altered_after_the_last_router(tree, monkeypatch):
    from repro_torch.models import model
    orig = model.decode_step

    def scaled(*a, **kw):
        out = orig(*a, **kw)
        return (out[0] * 1.05,) + tuple(out[1:])

    monkeypatch.setattr(model, "decode_step", scaled)
    res = run(tree, "olmoe.serve-smoke")
    assert not res["correct"]
    assert res["checks"]["logit_err_p90"]["value"] > \
        res["checks"]["logit_err_p90"]["limit"]
    assert res["checks"]["route_gap"]["value"] <= \
        res["checks"]["route_gap"]["limit"]


def test_serving_times_come_from_the_benchmark_clock(tree, monkeypatch):
    from repro_torch.serving import engine
    c = core.load_cell(tree, "olmoe.serve-smoke")
    drv = core.driver("serve_open").Driver(c, CPU)
    drv.setup(SEED)
    # the engine's own clock runs 1000 s ahead: its stamps are not read
    monkeypatch.setattr(engine.ServingEngine, "_now", lambda self:
                        time.perf_counter() - self._t0 + 1000.0)
    run_rec = drv.window(0.3)
    n = run_rec["attempted"]
    assert run_rec["failed"] == 0 and len(run_rec["ttft_s"]) == n
    # (so every request is admitted at once, some before they are due)
    assert all(abs(t) < 100 for t in run_rec["ttft_s"] + run_rec["queue_s"])
    assert all(t > 0 for t in run_rec["prefill_s"])
    assert 0 < run_rec["window_s"] < 100
    assert len(run_rec["decode_step_s"]) > 0
    assert all(t > q for t, q in zip(run_rec["ttft_s"],
                                     run_rec["queue_s"]))


def test_fault_decode_leaves_the_cache_unwritten(tree, monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "paged_decode_write",
                        lambda *a, **kw: None)
    res = run(tree, "olmoe.serve-smoke")
    assert not res["correct"]


def test_missing_limit_or_number_fails_the_check():
    got = core.judge({"a": 0.1, "b": float("nan"), "d": 5.0},
                     {"a": 0.2, "b": 1.0, "c": 1.0})
    assert [got[k]["ok"] for k in "abc"] == [True, False, False]
    assert "d" not in got
    assert not any(j["ok"] for j in core.judge({"a": 0.0}, {}).values())


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "portbench_run_main", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_modules_compare_whole_top_level_names():
    fm = _run_module().forbidden_modules
    assert fm(["repro_torch", "repro_torch.models", "torch", "jaxtyping"]) \
        == []
    assert fm(["jaxlib.xla_client", "repro.models", "flax", "jax"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_harness_loads_no_jax_and_reads_no_benchmarks(tmp_path):
    root = smoke.write(tmp_path)
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
from pathlib import Path
from portbench import core
for cell in ("olmoe.fl-smoke", "qwen.serve-smoke"):
    res = core.run(Path({str(root)!r}), cell, 5, 0.2, True,
                   torch.device("cpu"), time.perf_counter())
    assert res["correct"], res
import importlib.util
spec = importlib.util.spec_from_file_location(
    "pb_run", {str(ROOT / 'portbench' / 'run.py')!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print("FORBIDDEN", mod.forbidden_modules())
print("BENCHMARKS", sorted(n for n, m in sys.modules.items()
      if n.split(".")[0] == "benchmarks" or "/benchmarks/" in
      str(getattr(m, "__file__", "") or "")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "BENCHMARKS []" in out.stdout
