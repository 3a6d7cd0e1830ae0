"""Architecture registry of the port: only the archs it can serve.

The reference registry (``repro/configs/registry.py``) knows twelve archs;
the port adds each one with the slice that brings its layers.  Asking for
an arch the port does not know yet raises ``KeyError`` naming that slice.
"""
from __future__ import annotations

from importlib import import_module

from .base import ModelConfig

_ARCH_MODULES = {
    "olmoe-1.3b-6.9b": "olmoe_1_3b_6_9b",
}

# archs of the reference registry that later slices of the port bring
_LATER = {
    "qwen3-1.7b": "the dense-FFN slice",
    "qwen3-moe-235b-a22b": "the multi-chip slice",
    "mamba2-780m": "the SSM slice",
    "granite-20b": "the dense-FFN slice",
    "chameleon-34b": "the dense-FFN slice",
    "qwen2-moe-a2.7b": "the shared-expert slice",
    "phi4-mini-3.8b": "the dense-FFN slice",
    "jamba-v0.1-52b": "the SSM slice",
    "llama3-405b": "the multi-chip slice",
    "musicgen-large": "the audio-codebook slice",
    "olmo-1.3b": "the dense-FFN slice",
}


def list_archs():
    return list(_ARCH_MODULES)


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    """variant: full | smoke."""
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
    else:
        raise ValueError(f"unknown variant {variant!r} (full | smoke; the "
                         "sliding-window variant comes with a later slice)")
    cfg.validate()
    return cfg
