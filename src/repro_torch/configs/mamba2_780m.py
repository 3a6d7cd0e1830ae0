"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]

A copy of ``repro/configs/mamba2_780m.py`` (FULL and SMOKE)."""
from .base import LoRAConfig, ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                      # pure mamba blocks, no FFN
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=1),
    lora=LoRAConfig(rank=16, target_attn=False, target_ffn=False,
                    target_expert=False, target_ssm=True),
    source="arXiv:2405.21060",
)

SMOKE = FULL.replace(
    name="mamba2-smoke",
    num_layers=2,
    d_model=256,
    ssm=SSMConfig(d_state=32, head_dim=32, expand=2, conv_width=4,
                  chunk_size=64, n_groups=1),
    vocab_size=512,
    lora=LoRAConfig(rank=4, target_attn=False, target_ffn=False,
                    target_expert=False, target_ssm=True),
)
