"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave.
[arXiv:2403.19887]

Layer layout (period 8, as in the paper): attention at period index 4,
every other layer's FFN is MoE (offset 1).  As in the reference, the
mixer is the Mamba-2/SSD block (d_state=128, chunked scan), not the
paper's Mamba-1 (d_state=16, sequential scan): the same O(1) decode state.

A copy of ``repro/configs/jamba_v0_1_52b.py`` (FULL, SMOKE and
SWA_WINDOW)."""
from .base import LoRAConfig, ModelConfig, MoEConfig, SSMConfig

_PATTERN = ("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm")

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    rope_theta=10_000.0,
    layer_pattern=_PATTERN,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14_336,
                  moe_every=2, moe_offset=1),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=1),
    lora=LoRAConfig(rank=16),
    source="arXiv:2403.19887",
)

SMOKE = FULL.replace(
    name="jamba-smoke",
    num_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    layer_pattern=("ssm", "attn"),
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=512,
                  moe_every=2, moe_offset=1),
    ssm=SSMConfig(d_state=32, head_dim=32, expand=2, conv_width=4,
                  chunk_size=64, n_groups=1),
    lora=LoRAConfig(rank=4),
)

SWA_WINDOW = 8192   # applied to the 4 attention layers for long_500k
