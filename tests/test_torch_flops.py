"""The port's analytic parameter and FLOPs counts (``repro_torch.core.
flops``, a copy of ``repro.core.flops``) against the JAX package's, on
every config the port's registry names and on BENCH: integers exactly,
FLOPs to float64 equality (the same arithmetic in the same order)."""
import pytest

from repro.configs import registry as jreg
from repro.configs.olmoe_1_3b_6_9b import BENCH as JBENCH
from repro.core import flops as jflops
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.olmoe_1_3b_6_9b import BENCH as TBENCH
from repro_torch.core import flops as tflops

CASES = [(a, v) for a in list_archs() for v in ("full", "smoke")]


def _pair(arch, variant):
    if arch == "bench":
        return JBENCH, TBENCH
    return jreg.get_config(arch, variant), get_config(arch, variant)


@pytest.mark.parametrize("arch,variant", CASES + [("bench", "")])
def test_flops_and_param_counts_match_jax(arch, variant):
    jcfg, tcfg = _pair(arch, variant)
    for k in sorted({1, 2, tcfg.moe.top_k, None} - {0}, key=str):
        assert tflops.count_params(tcfg, k=k) == jflops.count_params(
            jcfg, k=k)
        assert tflops.lora_param_counts(tcfg, k=k) == \
            jflops.lora_param_counts(jcfg, k=k)
        for rank in (None, 8):
            assert tflops.flops_paper_convention(
                tcfg, tokens=128, k=k, lora_rank=rank) == \
                jflops.flops_paper_convention(jcfg, tokens=128, k=k,
                                              lora_rank=rank)
            assert tflops.flops_detailed(
                tcfg, tokens=64, seq_len=512, k=k, lora_rank=rank,
                backward=True) == jflops.flops_detailed(
                jcfg, tokens=64, seq_len=512, k=k, lora_rank=rank,
                backward=True)
    assert tflops.model_flops_roofline(tcfg, 1000, "serve") == \
        jflops.model_flops_roofline(jcfg, 1000, "serve")


def test_table1_grid_matches_jax():
    j = jflops.table1_grid(jreg.get_config("olmo-1.3b"),
                           jreg.get_config("olmoe-1.3b-6.9b"))
    t = tflops.table1_grid(get_config("olmo-1.3b"),
                           get_config("olmoe-1.3b-6.9b"))
    assert [tuple(vars(r).values()) for r in t] == \
        [tuple(vars(r).values()) for r in j]
