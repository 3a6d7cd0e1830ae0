"""Architecture registry of the port: the reference's twelve archs
(``repro/configs/registry.py``).

Ten run on one card (attention with a dense FFN, a routed MoE, or a
routed MoE with shared experts; the Mamba-2 block, alone or in Jamba's
period-8 hybrid stack with interleaved MoE; audio codebooks,
``musicgen-large``).  ``qwen3-moe-235b-a22b`` and ``llama3-405b`` need
several cards: at full width they run on the card mesh
(``launch/mesh.py``, ``launch/steps.py`` with ``mesh=``), cut in depth.
"""
from __future__ import annotations

from importlib import import_module

from .base import ModelConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-20b": "granite_20b",
    "chameleon-34b": "chameleon_34b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "mamba2-780m": "mamba2_780m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama3-405b": "llama3_405b",
    "musicgen-large": "musicgen_large",
    # the paper's own evaluation models
    "olmo-1.3b": "olmo_1_3b",
    "olmoe-1.3b-6.9b": "olmoe_1_3b_6_9b",
}

def list_archs():
    return list(_ARCH_MODULES)


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    """variant: full | smoke | swa (full with sliding-window attention,
    the sub-quadratic option required for long_500k on attention archs:
    ``attention_window`` = the module's ``SWA_WINDOW``, default 8192)."""
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    module = import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    if variant == "full":
        cfg = module.FULL
    elif variant == "smoke":
        cfg = module.SMOKE
    elif variant == "swa":
        cfg = module.FULL
        if cfg.family != "ssm" and cfg.n_heads > 0:
            window = getattr(module, "SWA_WINDOW", 8192)
            cfg = cfg.replace(attention_window=window)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    cfg.validate()
    return cfg


def supports_long_context(arch: str) -> bool:
    """True when long_500k decode is runnable: native for SSM/hybrid, via the
    sliding-window variant for attention archs."""
    return True  # every arch has a sub-quadratic path


def long_context_variant(arch: str) -> str:
    cfg = get_config(arch, "full")
    if cfg.family in ("ssm",):
        return "full"           # attention-free: natively sub-quadratic
    return "swa"
