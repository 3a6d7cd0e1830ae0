"""One FLAME round on the registry's other dense archs, the port against
the JAX package at float32 on the CPU: qwen3-1.7b (qk-norm, GQA 2 at
SMOKE widths), phi4-mini-3.8b (GQA), granite-20b (MQA) and chameleon-34b
(qk-norm, plain token ids).  The round and its tolerances are those of
``tests/test_torch_arch_rounds.py``.
"""
import pytest

from test_torch_arch_rounds import one_round_matches_jax


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi4-mini-3.8b",
                                  "granite-20b", "chameleon-34b"])
def test_one_round_matches_jax(arch):
    one_round_matches_jax(arch, "flame")
