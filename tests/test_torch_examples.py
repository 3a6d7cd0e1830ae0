"""The port's entry points on the CPU (``--device cpu``, the kernels' plain
versions): the training launcher's checkpoint flags and the twins of
``examples/quickstart.py``, ``examples/federated_finetune.py`` and
``examples/adaptive_serving.py``."""
import importlib
import math
import sys

import pytest

from repro_torch.launch import train as ttrain


def _run_module(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    importlib.import_module(name).main()


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "fed.ckpt")
    base = ["--federated", "--device", "cpu", "--clients", "4"]
    ttrain.main(base + ["--rounds", "1", "--checkpoint-to", ckpt])
    out = capsys.readouterr().out
    assert "batched engine, host driver" in out and "round 0: 4 clients" in out
    assert f"checkpoint: {ckpt}" in out
    ttrain.main(base + ["--rounds", "2", "--resume-from", ckpt,
                        "--checkpoint-every", "1"])
    out = capsys.readouterr().out
    assert "round 1: 4 clients" in out and "round 0:" not in out


def test_quickstart_twin_runs_on_cpu(monkeypatch, capsys):
    _run_module("repro_torch.examples.quickstart", ["--device", "cpu"],
                monkeypatch)
    out = capsys.readouterr().out
    assert "val loss after 2 FLAME rounds" in out
    assert "client 2 learned rescaler" in out


def test_federated_finetune_twin_resumes(tmp_path, monkeypatch, capsys):
    name = "repro_torch.examples.federated_finetune"
    out_dir = str(tmp_path / "run")
    _run_module(name, ["--device", "cpu", "--rounds", "1", "--out", out_dir,
                       "--method", "hlora"], monkeypatch)
    first = capsys.readouterr().out
    assert "round 0:" in first and "final test loss" in first
    _run_module(name, ["--device", "cpu", "--rounds", "2", "--resume",
                       out_dir, "--method", "hlora"], monkeypatch)
    second = capsys.readouterr().out
    assert "resumed at round 1" in second
    assert "round 1:" in second and "round 0:" not in second


def test_adaptive_serving_twin_runs_on_cpu(monkeypatch, capsys):
    """One FLAME round on BENCH, merged, every tier served teacher-forced
    in one engine: the per-tier table has a finite NLL per tier, and the
    active parameters and FLOPs fall with k."""
    _run_module("repro_torch.examples.adaptive_serving",
                ["--device", "cpu", "--new-tokens", "3", "--batch", "2"],
                monkeypatch)
    out = capsys.readouterr().out
    assert "serving olmoe-bench on cpu" in out and "tiers k=[4, 2, 1]" in out
    lines = out.split("k,active_params_M,decode_GFLOPs_per_tok,nll,"
                      "latency_p50_ms\n")[1].splitlines()[:3]
    rows = [[float(v) for v in line.split(",")] for line in lines]
    assert [r[0] for r in rows] == [4, 2, 1]
    assert rows[0][1] > rows[1][1] > rows[2][1]
    assert all(math.isfinite(r[3]) and r[3] > 0 for r in rows)
    assert "engine: 2 mixed-k decode steps" in out


@pytest.mark.parametrize("name", ["repro_torch.examples.quickstart",
                                  "repro_torch.examples.federated_finetune",
                                  "repro_torch.examples.adaptive_serving"])
def test_example_twins_refuse_a_missing_card(name, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _run_module(name, [], monkeypatch)
