"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE + SwiGLU + GQA.  [arXiv:2412.08905]

A copy of ``repro/configs/phi4_mini_3_8b.py`` (FULL and SMOKE)."""
from .base import LoRAConfig, ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=16),
    source="arXiv:2412.08905",
)

SMOKE = FULL.replace(
    name="phi4-mini-smoke",
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
