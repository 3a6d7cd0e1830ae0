"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm, GQA.  [hf:Qwen/Qwen3-8B family card]

A copy of ``repro/configs/qwen3_1_7b.py`` (FULL and SMOKE)."""
from .base import LoRAConfig, ModelConfig

FULL = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    lora=LoRAConfig(rank=16),
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = FULL.replace(
    name="qwen3-1.7b-smoke",
    num_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    lora=LoRAConfig(rank=4),
)

SWA_WINDOW = 8192
