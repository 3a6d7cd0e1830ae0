"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

Shared experts are always active so their adapters hit FLAME Eq. 6's
full-activation edge case (dataset-size weighting).

A copy of ``repro/configs/qwen2_moe_a2_7b.py`` (FULL and SMOKE)."""
from .base import LoRAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared_experts=4, d_shared_expert=5632),
    lora=LoRAConfig(rank=16),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = FULL.replace(
    name="qwen2-moe-smoke",
    num_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                  num_shared_experts=1, d_shared_expert=256),
    lora=LoRAConfig(rank=4),
)

SWA_WINDOW = 8192
