"""OLMoE-1.3B/6.9B [moe] — the paper's SMoE evaluation model.
16L d_model=2048 16H, 64 experts top-8, d_expert=1024, vocab=50304, qk-norm.
[arXiv:2409.02060]

A copy of ``repro/configs/olmoe_1_3b_6_9b.py`` (FULL, SMOKE and BENCH)."""
from .base import LoRAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="olmoe-1.3b-6.9b",
    family="moe",
    num_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=50_304,
    qk_norm=True,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    lora=LoRAConfig(rank=20),
    source="arXiv:2409.02060",
)

# reduced same-family variant (the reference's smoke tests and --local serve)
SMOKE = FULL.replace(
    name="olmoe-smoke",
    num_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
    lora=LoRAConfig(rank=4),
)

# a slightly larger reduced config for the federated quality benchmarks:
# 8 experts gives routing room for the activation-imbalance phenomenon
BENCH = FULL.replace(
    name="olmoe-bench",
    num_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=4, d_expert=64),
    lora=LoRAConfig(rank=8),
)

SWA_WINDOW = 8192
