"""OLMo-1.3B [dense] — the paper's dense evaluation model (Table 1–4 left
columns).  16L d_model=2048 16H d_ff=8192 vocab=50304.  [arXiv:2402.00838]

Rank 40 is the β1 row of the dense rank grid
(``federated.server.DENSE_BUDGET_RANKS``: 40 / 24 / 16 / 12).

A copy of ``repro/configs/olmo_1_3b.py`` (FULL and SMOKE)."""
from .base import LoRAConfig, ModelConfig

FULL = ModelConfig(
    name="olmo-1.3b",
    family="dense",
    num_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=40),    # β1 rank; clients truncate per budget
    source="arXiv:2402.00838",
)

SMOKE = FULL.replace(
    name="olmo-smoke",
    num_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    lora=LoRAConfig(rank=8),
)

SWA_WINDOW = 8192
