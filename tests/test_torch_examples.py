"""The port's entry points on the CPU (``--device cpu``, the kernels' plain
versions): the training launcher's checkpoint flags and the twins of
``examples/quickstart.py`` and ``examples/federated_finetune.py``."""
import importlib
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


@pytest.mark.parametrize("name", ["repro_torch.examples.quickstart",
                                  "repro_torch.examples.federated_finetune"])
def test_example_twins_refuse_a_missing_card(name, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _run_module(name, [], monkeypatch)
