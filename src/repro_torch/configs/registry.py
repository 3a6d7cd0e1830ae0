"""Architecture registry of the port: only the archs it can serve and train.

The reference registry (``repro/configs/registry.py``) knows twelve archs;
the port knows the ten that run on one card (attention with a dense FFN,
a routed MoE, or a routed MoE with shared experts; the Mamba-2 block,
alone or in Jamba's period-8 hybrid stack with interleaved MoE; audio
codebooks, ``musicgen-large``).  The two that need several cards come
with the multi-chip slice: asking for one raises ``KeyError`` naming it.
"""
from __future__ import annotations

from importlib import import_module

from .base import ModelConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "granite-20b": "granite_20b",
    "chameleon-34b": "chameleon_34b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "mamba2-780m": "mamba2_780m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "musicgen-large": "musicgen_large",
    # the paper's own evaluation models
    "olmo-1.3b": "olmo_1_3b",
    "olmoe-1.3b-6.9b": "olmoe_1_3b_6_9b",
}

# archs of the reference registry that later slices of the port bring
_LATER = {
    "qwen3-moe-235b-a22b": "the multi-chip slice",
    "llama3-405b": "the multi-chip slice",
}


def list_archs():
    return list(_ARCH_MODULES)


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    """variant: full | smoke | swa (full with sliding-window attention,
    the sub-quadratic option required for long_500k on attention archs:
    ``attention_window`` = the module's ``SWA_WINDOW``, default 8192)."""
    if arch not in _ARCH_MODULES:
        if arch in _LATER:
            raise KeyError(f"arch {arch!r} is not ported yet: it comes with "
                           f"{_LATER[arch]}; the port knows {list_archs()}")
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
