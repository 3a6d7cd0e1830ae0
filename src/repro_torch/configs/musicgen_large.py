"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The EnCodec neural codec is the stubbed modality frontend: the backbone
consumes its 4 parallel codebook token streams (delay pattern).  We model
this as 4 summed input embeddings and 4 parallel output heads; loss averages
over codebooks.

A copy of ``repro/configs/musicgen_large.py`` (FULL, SMOKE and
SWA_WINDOW)."""
from .base import LoRAConfig, ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10_000.0,
    num_codebooks=4,
    lora=LoRAConfig(rank=16),
    source="arXiv:2306.05284",
)

SMOKE = FULL.replace(
    name="musicgen-smoke",
    num_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=128,
    num_codebooks=2,
    lora=LoRAConfig(rank=4),
)

SWA_WINDOW = 8192
