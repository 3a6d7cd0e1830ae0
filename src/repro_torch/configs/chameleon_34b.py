"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536, early-fusion VQ image tokens.  [arXiv:2405.09818]

Early fusion means images enter as discrete VQ-VAE codes *inside the text
vocabulary*, so the backbone input is plain token ids — the VQ tokenizer is
the stubbed modality frontend.

A copy of ``repro/configs/chameleon_34b.py`` (FULL and SMOKE)."""
from .base import LoRAConfig, ModelConfig

FULL = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,                # chameleon's training-stability fix
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=16),
    source="arXiv:2405.09818",
)

SMOKE = FULL.replace(
    name="chameleon-smoke",
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
