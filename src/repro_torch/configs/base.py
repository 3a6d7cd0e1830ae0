"""Config dataclasses for the port (a copy of ``repro/configs/base.py``).

``ModelConfig``, ``MoEConfig``, ``LoRAConfig``, ``SSMConfig``,
``INPUT_SHAPES``, ``TrainConfig`` and ``FederatedConfig`` keep the
reference's fields and defaults, so a config built for one package
describes the same model and run in the other.  ``KernelConfig`` is
dropped: in the port the tensor's device chooses between a CUDA kernel and
its plain PyTorch version (``repro_torch.kernels.backend``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

LayerKind = str  # "attn" | "ssm"


@dataclass(frozen=True)
class MoEConfig:
    """Sparse-MoE FFN configuration."""

    num_experts: int = 0          # routed experts (0 = no MoE)
    top_k: int = 0                # experts activated per token (full budget k)
    d_expert: int = 0             # expert hidden dim
    num_shared_experts: int = 0   # always-active experts (Qwen2-MoE style)
    d_shared_expert: int = 0      # hidden dim of the shared expert block
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # which layers carry an MoE FFN: layer l is MoE iff (l % moe_every == moe_offset)
    moe_every: int = 1
    moe_offset: int = 0

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) configuration."""

    d_state: int = 0
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter configuration (the paper's trainable surface)."""

    rank: int = 0
    alpha: float = 16.0
    target_attn: bool = True      # q/k/v/o projections
    target_ffn: bool = True       # dense FFN w1/w2/w3
    target_expert: bool = True    # per-expert FFN matrices (FLAME's A^j/B^j)
    target_ssm: bool = True       # mamba in/out projections

    @property
    def enabled(self) -> bool:
        return self.rank > 0

    @property
    def scale(self) -> float:
        return self.alpha / max(self.rank, 1)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                     # dense FFN hidden dim (0 for pure-MoE FFN archs)
    vocab_size: int
    source: str = ""              # citation for the assigned config

    # attention details
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    attention_window: int = 0     # 0 = full causal; >0 = sliding window
    attn_logit_softcap: float = 0.0

    # per-family sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    lora: LoRAConfig = field(default_factory=LoRAConfig)

    # hybrid layer pattern, cycled over depth; None -> homogeneous
    layer_pattern: Optional[Tuple[LayerKind, ...]] = None

    # audio: number of parallel codebooks; 0 = plain text
    num_codebooks: int = 0

    # norms / misc
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ---------------------------------------------------------------- helpers
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_rep(self) -> int:
        """query heads per kv head (GQA replication factor)."""
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_kind(self, layer_idx: int) -> LayerKind:
        if self.layer_pattern is None:
            return "ssm" if self.family == "ssm" else "attn"
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def layer_is_moe(self, layer_idx: int) -> bool:
        m = self.moe
        return m.enabled and (layer_idx % m.moe_every == m.moe_offset)

    @property
    def pattern_period(self) -> int:
        """Length of the repeating layer-type period (the stacking unit)."""
        p = len(self.layer_pattern) if self.layer_pattern else 1
        if self.moe.enabled and self.moe.moe_every > 1:
            p = math.lcm(p, self.moe.moe_every)
        return p

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.num_layers % self.pattern_period:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {self.pattern_period}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        if self.moe.enabled and self.moe.top_k > self.moe.num_experts:
            raise ValueError(f"{self.name}: top_k > num_experts")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / local-training hyper-parameters (paper A2.2)."""

    learning_rate: float = 1.5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    batch_size: int = 16
    local_epochs: int = 1
    seq_len: int = 128


@dataclass(frozen=True)
class FederatedConfig:
    """Server-side orchestration hyper-parameters, the reference's fields
    and defaults."""

    num_clients: int = 4
    rounds: int = 2
    participation: float = 1.0        # client sampling rate p
    dirichlet_alpha: float = 5.0      # data heterogeneity
    temperature: int = 2              # t in Eq. 6
    method: str = "flame"             # flame|trivial|hlora|flexlora
    rescaler: str = "learnable"       # learnable|static|none
    seed: int = 0
    # round execution engine: "batched" runs each budget cohort's local
    # training through one cohort_update call on stacked inputs;
    # "looped" is the sequential per-client reference oracle.
    round_engine: str = "batched"     # batched|looped
    # the reference's batched-engine lowering ("vmap" batches clients,
    # "map" runs them in turn); the port's kernels are ctypes calls that
    # vmap cannot batch, so both run a cohort's members in turn.
    cohort_backend: str = "vmap"      # vmap|map
    # round-loop driver: "host" iterates run_round in Python (the oracle);
    # "device" runs a checkpoint segment's rounds, per-round subsampled
    # cohorts AND streaming FLAME aggregation with no host read inside
    # the segment (FLAME only — see federated/server.py, round drivers).
    round_driver: str = "host"        # host|device
    # device driver: rounds per segment — the driver syncs to the host
    # every `checkpoint_every` rounds to stream a resumable checkpoint
    # (run(checkpoint_to=...)); with no checkpoint target the whole run
    # is one segment.
    checkpoint_every: int = 1
