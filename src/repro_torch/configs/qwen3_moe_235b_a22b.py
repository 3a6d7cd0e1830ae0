"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family card]

The FLAME-representative architecture: per-expert LoRA + adaptive k_i.

A copy of ``repro/configs/qwen3_moe_235b_a22b.py`` (FULL, SMOKE and
SWA_WINDOW); at full width it runs on the card mesh (``launch/mesh.py``),
cut in depth."""
from .base import LoRAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                      # FFN is pure MoE
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536),
    lora=LoRAConfig(rank=16),
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = FULL.replace(
    name="qwen3-moe-smoke",
    num_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=128),
    lora=LoRAConfig(rank=4),
)

SWA_WINDOW = 8192
