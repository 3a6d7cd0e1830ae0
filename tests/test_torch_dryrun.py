"""The port's dry run, analytic model, roofline, report and pair inspector
(``repro_torch.launch.dryrun`` and friends) against the JAX package's
``repro.launch`` twins and against a gloo world.

  * ``analytic``: pure arithmetic, so equal to the reference's exactly,
    for all twelve archs x the four ``INPUT_SHAPES`` x both production
    meshes (the same knobs handed to both).
  * ``roofline.Roofline``: its terms, bottleneck, useful fraction, step
    time and MFU equal the reference's ``Roofline`` given the reference's
    constants and the same inputs (the port's traced FLOPs set to the
    analytic ones, which the reference uses for both).
  * ``report``: ``fmt_row`` and ``advice`` give the reference's strings,
    with the TPU's terms in two advice sentences replaced by the H100's
    (and the reference's TPU-measured figure dropped).
  * The dry run itself runs in a subprocess (torch's ``fake`` backend is
    never started in a test worker): the smoke configs of qwen3-moe and
    llama3 at float32 on a fake (2, 2) world count exactly the calls and
    bytes by kind that a gloo world of 4 ranks counts on the same steps
    (train in each ``act_mode``, prefill, decode); a record carries the
    reference's keys; an SSM arch's pair on (2, 2) and a pair whose query
    heads do not divide the model axis (``phi4-mini-3.8b``'s 24 on 16
    ways) are recorded ``ok: true``.
  * Memory: llama3-405b's decode_32k cache on 16 x 16 is the whole
    cache's bytes over 256 a rank (the sequence on ``model``, the batch on
    ``data``), and the pair fits the knob budget.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import analytic, report, roofline
from repro_torch.launch import inspect_pair
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.models import parallel

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-moe-235b-a22b", "llama3-405b")
MODES = ("batch", "dmodel", "sp")
B, S, BP, SD = 8, 16, 4, 24


# --------------------------------------------------------------------------
# analytic: equal to the reference's
# --------------------------------------------------------------------------

def _knobs(cfg, chips):
    return {"k": cfg.moe.top_k or None, "remat": True,
            "remat_chunk": tsteps._remat_chunk(cfg.num_layers
                                               // cfg.pattern_period),
            "n_micro": 4 if chips == 256 else 8,
            "trainable_bytes": 2 ** 30 + 12345}


@pytest.mark.parametrize("shape_name", list(tconfigs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_analytic_equals_the_reference(arch, shape_name):
    from repro.configs import registry as jreg
    from repro.configs.base import INPUT_SHAPES as JSHAPES
    from repro.launch import analytic as janalytic
    from repro.launch.dryrun import variant_for as jvariant
    from repro_torch.launch.dryrun import variant_for

    variant = variant_for(arch, shape_name)
    assert variant == jvariant(arch, shape_name)
    cfg, jcfg = tconfigs.get_config(arch, variant), jreg.get_config(arch,
                                                                    variant)
    shape, jshape = tconfigs.INPUT_SHAPES[shape_name], JSHAPES[shape_name]
    for chips in (256, 512):
        knobs = _knobs(cfg, chips)
        for fn in ("device_flops", "device_bytes"):
            assert (getattr(analytic, fn)(cfg, shape, chips, knobs)
                    == getattr(janalytic, fn)(jcfg, jshape, chips, knobs))
        assert (analytic.model_flops_global(cfg, shape, knobs)
                == janalytic.model_flops_global(jcfg, jshape, knobs))
    assert analytic._cache_len(cfg, shape.seq_len) == janalytic._cache_len(
        jcfg, jshape.seq_len)
    assert analytic._param_bytes(cfg) == janalytic._param_bytes(jcfg)
    assert (analytic._cache_bytes(cfg, shape.global_batch, shape.seq_len)
            == janalytic._cache_bytes(jcfg, jshape.global_batch,
                                      jshape.seq_len))


# --------------------------------------------------------------------------
# roofline: the reference's arithmetic
# --------------------------------------------------------------------------

ROOF_CASES = {            # (flops, bytes, collective bytes, model flops)
    "compute": (4.1e15, 2.0e11, 1.0e10, 6.0e17),
    "memory": (1.0e12, 9.0e12, 1.0e9, 2.0e14),
    "collective": (1.0e13, 5.0e10, 8.0e12, 3.0e16),
}


@pytest.mark.parametrize("case", list(ROOF_CASES))
def test_roofline_row_equals_the_reference(case):
    from repro.launch import roofline as jroof

    fl, by, coll, model = ROOF_CASES[case]
    want = jroof.Roofline(
        arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=fl,
        hlo_bytes=by, collective_bytes=coll, model_flops=model,
        bytes_per_device=3.0 * 2 ** 30, collectives={"all_reduce": 3},
        meta={})
    got = roofline.Roofline(
        arch="a", shape="s", mesh="16x16", chips=256, device_flops=fl,
        traced_flops=fl, device_bytes=by, collective_s=coll / jroof.ICI_BW,
        collective_bytes=coll, model_flops=model,
        bytes_per_device=3.0 * 2 ** 30, collectives={"all_reduce": 3},
        meta={}, peak_flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW)
    assert got.bottleneck == want.bottleneck == case
    for attr in ("t_compute", "t_memory", "t_collective", "useful_fraction",
                 "step_time", "mfu"):
        assert getattr(got, attr) == getattr(want, attr), attr
    w, g = want.row(), got.row()
    for key in ("t_compute_ms", "t_memory_ms", "t_collective_ms",
                "bottleneck", "useful_frac", "mfu", "model_gflops",
                "coll_gbytes", "hbm_gb_per_device", "n_all_reduce"):
        assert g[key] == w[key], key


def test_bus_bytes_and_links():
    assert roofline.bus_bytes("all_reduce", 1000, 4) == 1500.0
    assert roofline.bus_bytes("all_gather", 1000, 4) == 3000
    assert roofline.bus_bytes("reduce_scatter", 1000, 4) == 750.0
    assert roofline.bus_bytes("all_to_all", 1000, 4) == 750.0
    assert roofline.bus_bytes("all_reduce", 1000, 1) == 0.0
    assert not roofline.spans_nodes([8, 9, 15], 8)
    assert roofline.spans_nodes([7, 8], 8)
    calls = [{"kind": "all_gather", "bytes": 100, "ranks": [0, 1]},
             {"kind": "all_reduce", "bytes": 100, "ranks": [0, 16]}]
    t = roofline.collective_terms(calls, 8, nvlink_bw=10.0, net_bw=1.0)
    assert t["bus_bytes_nvlink"] == 100 and t["bus_bytes_network"] == 100
    assert t["seconds"] == 100 / 10.0 + 100 / 1.0


# --------------------------------------------------------------------------
# report: the reference's strings
# --------------------------------------------------------------------------

TPU_TERMS = {"MXU": "tensor-core", " (64×4)": "",
             " (§Perf H2 it.5: −39%)": ""}


def _record(arch, shape, bottleneck):
    return {"arch": arch, "shape": shape, "mesh": "16x16", "ok": True,
            "memory": {"peak_gb": 37.0665},
            "roofline": {"t_compute_ms": 1034.39, "t_memory_ms": 17.46,
                         "t_collective_ms": 16139.79,
                         "bottleneck": bottleneck,
                         "model_gflops": 139612060.9, "useful_frac": 0.3056,
                         "mfu": 0.0342}}


REPORT_CASES = [(arch, shape, b)
                for arch in ("qwen3-moe-235b-a22b", "llama3-405b")
                for shape in ("train_4k", "prefill_32k", "decode_32k")
                for b in ("compute", "memory", "collective")]


@pytest.mark.parametrize("arch,shape,bottleneck", REPORT_CASES)
def test_report_rows_are_the_reference_s(arch, shape, bottleneck):
    from repro.launch import report as jreport

    rec = _record(arch, shape, bottleneck)
    want_advice = jreport.advice(rec)
    for tpu, h100 in TPU_TERMS.items():
        want_advice = want_advice.replace(tpu, h100)
    assert report.advice(rec) == want_advice
    assert report.fmt_row(rec) == jreport.fmt_row(rec).replace(
        jreport.advice(rec), want_advice)
    assert report.SHAPE_ORDER == jreport.SHAPE_ORDER


# --------------------------------------------------------------------------
# the dry run against a gloo world
# --------------------------------------------------------------------------

def _cfg(arch):
    return tconfigs.get_config(arch, "smoke").replace(dtype="float32")


def _shapes():
    return {"train": tconfigs.ShapeConfig("t", S, B, "train"),
            "prefill": tconfigs.ShapeConfig("p", S, BP, "prefill"),
            "decode": tconfigs.ShapeConfig("d", SD, BP, "decode")}


def _counted(fn):
    parallel.comm_start()
    fn()
    return {k: v[:2] for k, v in parallel.comm_stop()["by_kind"].items()}


def _gloo_worker(rank, world, out_dir):
    """Every step of the smoke configs on (2, 2), counted."""
    torch.set_num_threads(1)
    mesh = tmesh.Mesh((2, 2), ("data", "model"))
    shapes = _shapes()
    out = {}
    gen = torch.Generator().manual_seed(0)
    for arch in ARCHS:
        cfg = _cfg(arch)
        from repro_torch.models import model as tmodel
        from repro_torch.core import lora as tlora
        from repro_torch.optim import adam as tadam
        params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        trainable = tlora.make_trainable(
            tlora.init_lora(torch.Generator().manual_seed(1), cfg, params),
            tlora.init_rescalers(cfg, cfg.moe.top_k or 0, device="cpu"))
        tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32)
        mask = torch.ones((B, S))
        for mode in MODES:
            tb = tsteps.build_train(cfg, shapes["train"], n_micro=2,
                                    num_groups=2 if cfg.moe.enabled else None,
                                    device="cpu", mesh=mesh,
                                    memory_bytes=2 ** 34, act_mode=mode)
            p = tshd.shard_tree(params, tb.specs["params"], mesh)
            tr = tshd.shard_tree(trainable, tb.specs["trainable"], mesh)
            batch = [tsteps.shard_batch(t, mesh, 2)
                     for t in (tok, tok.roll(-1, 1), mask)]
            out[f"{arch} train {mode}"] = _counted(
                lambda: tb.fn(p, tr, tadam.init(tr), *batch))
        pb = tsteps.build_prefill(cfg, shapes["prefill"], mesh=mesh)
        prompt = tsteps.shard_batch(tok[:BP], mesh)
        out[f"{arch} prefill"] = _counted(lambda: pb.fn(p, tr, prompt))
        sb = tsteps.build_serve(cfg, shapes["decode"], mesh=mesh)
        cache = tshd.shard_tree(tmodel.init_cache(cfg, BP, SD, device="cpu"),
                                sb.specs["cache"], mesh)
        out[f"{arch} decode"] = _counted(lambda: sb.fn(
            p, tr, cache, prompt[:, :1], torch.tensor(S, dtype=torch.int32)))
    if rank == 0:
        (Path(out_dir) / "gloo.json").write_text(json.dumps(out))


DRY = """
import json, sys
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun
out_dir = sys.argv[1]
shapes = {"train": ShapeConfig("t", 16, 8, "train"),
          "prefill": ShapeConfig("p", 16, 4, "prefill"),
          "decode": ShapeConfig("d", 24, 4, "decode")}
recs = {}
for arch in ("qwen3-moe-235b-a22b", "llama3-405b"):
    cfg = {"dtype": "float32"}
    for mode in ("batch", "dmodel", "sp"):
        recs[f"{arch} train {mode}"] = dryrun.run_pair(
            arch, "t", shape=shapes["train"], mesh_shape=(2, 2),
            variant="smoke", cfg_replace=cfg, memory_bytes=2 ** 34,
            overrides={"n_micro": 2, "act_mode": mode,
                       "num_groups": 2 if "moe" in arch else None})
    for kind in ("prefill", "decode"):
        recs[f"{arch} {kind}"] = dryrun.run_pair(
            arch, kind, shape=shapes[kind], mesh_shape=(2, 2),
            variant="smoke", cfg_replace=cfg, keep_calls=kind == "decode")
with open(f"{out_dir}/dry.json", "w") as f:
    json.dump(recs, f, default=str)
rcs = []
for arch, mesh in (("mamba2-780m", "2x2"), ("phi4-mini-3.8b", "1x16")):
    try:
        dryrun.main(["--arch", arch, "--shape", "decode_32k",
                     "--mesh-shape", mesh, "--out", f"{out_dir}/records"])
        rcs.append(0)
    except SystemExit as e:
        rcs.append(e.code)
with open(f"{out_dir}/main_rc.json", "w") as f:
    json.dump(rcs, f)
import contextlib
from repro_torch.examples import multipod_launch
with open(f"{out_dir}/multipod.txt", "w") as f, contextlib.redirect_stdout(f):
    multipod_launch.main(["--arch", "olmo-1.3b", "--shape", "decode_32k"])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", DRY, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    tmesh.spawn(_gloo_worker, 4, str(out), backend="gloo",
                init_method=f"file://{out / 'rdv'}", timeout=600)
    log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log[-3000:]
    return {"dry": json.loads((out / "dry.json").read_text()),
            "gloo": json.loads((out / "gloo.json").read_text()),
            "rc": json.loads((out / "main_rc.json").read_text()),
            "multipod": (out / "multipod.txt").read_text(),
            "records": out / "records"}


PAIRS = [f"{arch} {what}" for arch in ARCHS
         for what in [f"train {m}" for m in MODES] + ["prefill", "decode"]]


@pytest.mark.parametrize("pair", PAIRS)
def test_dry_run_counts_equal_a_gloo_world(runs, pair):
    rec, want = runs["dry"][pair], runs["gloo"][pair]
    got = {k: [rec["collectives"]["execs_by_kind"][k],
               rec["collectives"]["bytes_by_kind"][k]]
           for k in rec["collectives"]["execs_by_kind"]}
    assert got == want
    if "train" in pair:
        assert rec["meta"]["act_mode"] == pair.rsplit(" ", 1)[-1]


def test_dry_run_record_has_the_reference_keys(runs):
    rec = runs["dry"]["llama3-405b train dmodel"]
    # the reference's record keys; its lower / compile seconds become the
    # trace's seconds
    assert set(rec) == {"arch", "shape", "mesh", "variant", "step", "chips",
                        "ok", "t_trace_s", "memory", "roofline",
                        "collectives", "meta", "cfg_replace"}
    assert rec["ok"] and rec["chips"] == 4 and rec["mesh"] == "2x2"
    assert rec["step"] == "train_step" and rec["variant"] == "smoke"
    mem = rec["memory"]
    parts = [v for k, v in mem.items() if k != "peak_gb"]
    assert abs(sum(parts) - mem["peak_gb"]) < 1e-9 * mem["peak_gb"]
    for key in ("t_compute_ms", "t_memory_ms", "t_collective_ms",
                "bottleneck", "useful_frac", "mfu", "model_gflops",
                "traced_gflops"):
        assert key in rec["roofline"]
    assert rec["roofline"]["traced_gflops"] > 0


def test_uneven_query_heads_are_recorded_ok(runs):
    assert runs["rc"][1] == 0
    rec = json.loads((runs["records"]
                      / "phi4-mini-3.8b__decode_32k__1x16.json").read_text())
    assert rec["ok"] is True and rec["step"] == "serve_step"
    # per layer: q, k and v gathered over model, the partial softmaxes
    # merged by one more all-gather
    assert rec["collectives"]["execs_by_kind"]["all_gather"] >= 4 * 32


def test_the_decode_cache_is_split_over_both_axes():
    from types import SimpleNamespace

    from repro_torch.launch import dryrun
    mesh = SimpleNamespace(shape={"data": 16, "model": 16},
                           axis_names=("data", "model"))
    cfg = tconfigs.get_config("llama3-405b", "full")
    shape = tconfigs.INPUT_SHAPES["decode_32k"]
    bundle = tsteps.build_serve(cfg, shape, mesh=mesh)
    parts = dryrun.memory_parts(cfg, shape, mesh, bundle)
    whole = tsteps.state_bytes(tsteps.abstract_cache(
        cfg, shape.global_batch, shape.seq_len))
    assert parts["cache_gb"] * 2 ** 30 == whole / 256
    assert parts["peak_gb"] * 2 ** 30 < dryrun.MEMORY_BYTES


def test_an_ssm_pair_is_recorded_ok(runs):
    assert runs["rc"][0] == 0
    rec = json.loads((runs["records"]
                      / "mamba2-780m__decode_32k__2x2.json").read_text())
    assert rec["ok"] is True and rec["step"] == "serve_step"
    # head-parallel decode: in_proj's columns and the conv activations
    # are all-gathered over model, the norm's sums and out_proj's partial
    # sums all-reduced, per layer
    assert rec["collectives"]["execs_by_kind"]["all_gather"] >= 2 * 48


def test_report_prints_the_table_and_the_failures(runs, capsys, monkeypatch):
    d = runs["records"]
    ok = dict(runs["dry"]["qwen3-moe-235b-a22b decode"])
    ok.pop("calls")
    (d / "ok.json").write_text(json.dumps(ok))
    (d / "failed.json").write_text(json.dumps({
        "arch": "odd-arch", "shape": "decode_32k", "mesh": "16x16",
        "ok": False, "error": "NotImplementedError: a hand-written refusal",
        "traceback": ""}))
    monkeypatch.setattr(sys, "argv", ["report", str(d)])
    report.main()
    out = capsys.readouterr().out
    assert report.fmt_row(ok) in out
    assert "FAILED (1):" in out and "a hand-written refusal" in out


def test_inspect_pair_groups_the_calls(runs):
    rec = runs["dry"]["qwen3-moe-235b-a22b decode"]
    calls = rec["calls"]
    top = inspect_pair.top_collectives(calls, 2, 100)
    assert sum(g["calls"] for g in top) == len(calls)
    assert sum(g["bytes"] for g in top) == sum(c["bytes"] for c in calls)
    assert [g["bytes"] for g in top] == sorted((g["bytes"] for g in top),
                                               reverse=True)
    # 2 cards a node: the model groups (ranks 0-1) stay on one, the data
    # groups (ranks 0, 2) span two
    assert {g["spans_nodes"] for g in top if g["ranks"] == 2} == {False,
                                                                  True}


def test_multipod_example_prints_the_summary(runs):
    out = runs["multipod"]
    assert "olmo-1.3b × decode_32k on mesh 2x16x16 (512 cards)" in out
    assert "memory a card (estimate)" in out and "bottleneck" in out
