"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-arch, code model.  [arXiv:2405.04324]

A copy of ``repro/configs/granite_20b.py`` (FULL and SMOKE)."""
from .base import LoRAConfig, ModelConfig

FULL = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,                # MQA
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=16),
    source="arXiv:2405.04324",
)

SMOKE = FULL.replace(
    name="granite-smoke",
    num_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    lora=LoRAConfig(rank=4),
)

SWA_WINDOW = 8192
