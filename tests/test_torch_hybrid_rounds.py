"""One federated round on the SSM and hybrid archs, the port against the
JAX package at float32 on the CPU: HLoRA on ``mamba2-780m`` (the adapters
on the Mamba blocks' in and out projections; client ranks 4 / 2 / 2 / 1
from SMOKE's rank 4) and FLAME on ``jamba-v0.1-52b`` (a rescaler per MoE
position; k = 2 / 1 / 1 / 1), with the comparisons and tolerances of
``tests/test_torch_arch_rounds.py``; then both archs through the
launchers on the CPU.  A file of its own, so that a worker of the suite
shares these JAX compiles and ``tests/test_torch_hybrid.py`` stays
short.
"""
import pytest

from test_torch_arch_rounds import one_round_matches_jax


@pytest.mark.parametrize("arch,method", [("mamba2-780m", "hlora"),
                                         ("jamba-v0.1-52b", "flame")])
def test_one_round_matches_jax(arch, method):
    one_round_matches_jax(arch, method)


def test_launchers_serve_and_train_both_archs_and_cut_depth(capsys):
    """``serve.py`` on mamba2 (the slotted pool) and on jamba cut to one
    period (``--layers``), ``train.py --local`` on jamba; a cut that is
    not whole periods, and the flags these archs cannot take, refused."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    base = ["--local", "--device", "cpu", "--requests", "3",
            "--new-tokens", "2"]
    tserve.main(base + ["--arch", "mamba2-780m"])
    out = capsys.readouterr().out
    assert "mamba2-smoke on cpu" in out and "slotted KV pool" in out
    assert "n_requests: 3" in out
    tserve.main(base + ["--arch", "jamba-v0.1-52b", "--layers", "2"])
    out = capsys.readouterr().out
    assert "KV blocks" in out and "n_requests: 3" in out
    ttrain.main(["--local", "--device", "cpu", "--arch", "jamba-v0.1-52b",
                 "--layers", "2", "--steps", "1"])
    assert "done" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="periods of 2"):
        tserve.main(base + ["--arch", "jamba-v0.1-52b", "--layers", "3"])
    for flag in ("--speculate", "--expert-telemetry"):
        with pytest.raises(SystemExit, match="needs an MoE arch"):
            tserve.main(base + ["--arch", "mamba2-780m", flag])
    with pytest.raises(ValueError, match="attention-only"):
        tserve.main(base + ["--arch", "jamba-v0.1-52b", "--speculate"])
