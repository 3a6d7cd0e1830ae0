"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783]

A copy of ``repro/configs/llama3_405b.py`` (FULL, SMOKE and
SWA_WINDOW); at full width it runs on the card mesh (``launch/mesh.py``),
cut in depth."""
from .base import LoRAConfig, ModelConfig

FULL = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    lora=LoRAConfig(rank=16),
    source="arXiv:2407.21783",
)

SMOKE = FULL.replace(
    name="llama3-smoke",
    num_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    lora=LoRAConfig(rank=4),
)

SWA_WINDOW = 8192
