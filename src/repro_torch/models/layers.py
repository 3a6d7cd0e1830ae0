"""Shared building blocks (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors in the reference's layouts
(``x @ W`` with ``W`` (d_in, d_out)), so a JAX parameter tree converts
leaf for leaf (``repro_torch.convert``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_F32 = torch.float32


# --------------------------------------------------------------------------
# initialisers (same distributions as the reference's dense/embed init)
# --------------------------------------------------------------------------

def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated normal on [-3σ, 3σ] with σ = scale / sqrt(fan_in),
    fan_in = shape[-2].  Drawn in fp32 one leading slice at a time (a full
    stacked expert leaf in fp32 would be several GB), then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / fan_in ** 0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in (out if len(shape) > 2 else [out]):
        tmp = torch.empty(part.shape, dtype=_F32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        part.copy_(tmp * std)
    return out


def embed_init(shape, dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    """Normal with σ = 0.02, drawn in fp32 then cast."""
    return (torch.randn(shape, dtype=_F32, device=device,
                        generator=generator) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms / RoPE
# --------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(_F32)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=_F32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)          # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(_F32) * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# dense application / FFN
# --------------------------------------------------------------------------

def lora_dense(x: torch.Tensor, w: torch.Tensor, lp: Optional[dict],
               scale: float) -> torch.Tensor:
    """y = x @ W.  Serving an unmerged LoRA adapter (``lp`` not None) needs
    the ``lora_matmul`` kernel, which comes with a later slice."""
    if lp is not None:
        raise NotImplementedError(
            "LoRA-adapter serving (the lora_matmul kernel) comes with the "
            "serving-extras slice of the port")
    return x @ w


def apply_ffn(p: dict, x: torch.Tensor, lora: Optional[dict] = None,
              lora_scale: float = 0.0) -> torch.Tensor:
    lg = lora or {}
    gate = lora_dense(x, p["w1"], lg.get("w1"), lora_scale)
    up = lora_dense(x, p["w3"], lg.get("w3"), lora_scale)
    h = F.silu(gate.to(_F32)).to(up.dtype) * up
    return lora_dense(h, p["w2"], lg.get("w2"), lora_scale)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap
