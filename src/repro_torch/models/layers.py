"""Shared building blocks (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors in the reference's layouts
(``x @ W`` with ``W`` (d_in, d_out)), so a JAX parameter tree converts
leaf for leaf (``repro_torch.convert``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import backend as kernel_backend
from . import parallel

_F32 = torch.float32


# --------------------------------------------------------------------------
# initialisers (same distributions as the reference's dense/embed init)
# --------------------------------------------------------------------------

def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: float = 1.0, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    """Truncated normal on [-3σ, 3σ] with σ = scale / sqrt(fan_in),
    fan_in = shape[-2] unless given (a shard's whole leaf's).  Drawn in
    fp32 one leading slice at a time (a full stacked expert leaf in fp32
    would be several GB), then cast."""
    if fan_in is None:
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


def gated_rms_norm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The Mamba-2 output norm: RMSNorm(x · silu(z)), silu in fp32 and
    cast to x's dtype before the product."""
    return rms_norm(scale, x * F.silu(z.to(_F32)).to(x.dtype), eps)


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
    """y = x @ W (+ (x @ A) @ B * scale when a LoRA adapter is present).

    ``x``: (..., d_in); ``w``: (d_in, d_out); ``lp``: {"a": (d_in, r),
    "b": (r, d_out)} or None.  An adapter-carrying projection runs the
    fused ``lora_matmul`` kernel (its plain version on the CPU) over the
    flattened token dim — fp32 accumulation, one cast; the adapter stays
    unmerged so the server can aggregate A and B."""
    if lp is None:
        return x @ w
    y = kernel_backend.lora_matmul(x.reshape(-1, x.shape[-1]), w, lp["a"],
                                   lp["b"], scale=scale)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def lora_expert_einsum(x: torch.Tensor, w: torch.Tensor,
                       lp: Optional[dict], scale: float) -> torch.Tensor:
    """Per-expert matmul over stacked expert weights: x (E, C, d_in) expert-
    major token slots; w (E, d_in, d_out); lp {"a": (E, d_in, r), "b":
    (E, r, d_out)} or None.  With an adapter: the fused
    ``lora_matmul_experts`` kernel (its plain version on the CPU).  Without:
    a batched product cast once (cuBLAS accumulates bf16 in fp32).

    Grouped slots (G, E, C, d_in), the reference's layout for routing
    groups kept apart, fold to (E, G·C, d_in) for the same call and unfold
    to (G, E, C, d_out) after it: the reference's own fold on its Pallas
    path."""
    if x.dim() == 4:
        G, E, C, K = x.shape
        y = lora_expert_einsum(x.transpose(0, 1).reshape(E, G * C, K), w,
                               lp, scale)
        return y.reshape(E, G, C, -1).transpose(0, 1)
    if lp is not None:
        return kernel_backend.lora_matmul_experts(x, w, lp["a"], lp["b"],
                                                  scale=scale)
    return torch.bmm(x, w)


# --------------------------------------------------------------------------
# sharded products (the card mesh: models/parallel.py)
# --------------------------------------------------------------------------

def fsdp_weight(w: torch.Tensor, full: int, dim: int, sh) -> torch.Tensor:
    """A frozen weight with its ``dim`` gathered over ``data`` when it is
    stored split there."""
    if parallel.split_dim(full, w.shape[dim], sh.D, "fsdp weight"):
        return parallel.gather_frozen(w, sh.data, dim)
    return w


def fsdp_a(a: torch.Tensor, full: int, dim: int, sh) -> torch.Tensor:
    """An adapter's ``a`` whole on its input features: all-gathered over
    ``data`` where it is stored split (its backward reduce-scatters)."""
    if parallel.split_dim(full, a.shape[dim], sh.D, "adapter a"):
        return parallel.gather(a, sh.data, dim)
    return a


def col_dense(x: torch.Tensor, w: torch.Tensor, lp: Optional[dict],
              scale: float, sh) -> torch.Tensor:
    """A column-split product on the mesh: ``x`` (..., d_in) replicated over
    ``model`` (the caller has passed it through ``parallel.copy_to``), ``w``
    this rank's (d_in[/data], d_out[/model]) shard, ``lp`` its adapter
    (``a`` (d_in[/data], r), ``b`` (r, d_out[/model])).  Returns this rank's
    output columns."""
    d_in = x.shape[-1]
    w = fsdp_weight(w, d_in, 0, sh)
    if lp is None:
        return lora_dense(x, w, None, scale)
    a = parallel.copy_to(fsdp_a(lp["a"], d_in, 0, sh), sh.model)
    return lora_dense(x, w, {"a": a, "b": lp["b"]}, scale)


def row_dense(h: torch.Tensor, w: torch.Tensor, lp: Optional[dict],
              scale: float, sh, d_out: int) -> torch.Tensor:
    """A row-split product on the mesh: ``h`` (..., d_in/model) this rank's
    input columns, ``w`` its (d_in/model, d_out[/data]) shard; the fused
    kernel's output is this rank's partial sum, all-reduced over ``model``.
    The adapter's ``a`` (d_in[/data], r) is gathered whole and this rank's
    rows taken; ``b`` (r, d_out[/model]) is gathered whole over
    ``model``."""
    d_in = h.shape[-1] * sh.M
    if not parallel.split_dim(d_in, w.shape[0], sh.M, "row-split weight") \
            and sh.M > 1:
        raise NotImplementedError("a row-split product whose input features "
                                  "do not divide the model axis")
    w = fsdp_weight(w, d_out, 1, sh)
    lpl = None
    if lp is not None:
        a = parallel.copy_to(fsdp_a(lp["a"], d_in, 0, sh), sh.model)
        rows = h.shape[-1]
        if sh.M > 1:
            a = a.narrow(0, sh.mi * rows, rows)
        b = lp["b"]
        if parallel.split_dim(d_out, b.shape[-1], sh.M, "adapter b"):
            b = parallel.gather(b, sh.model, b.dim() - 1)
        lpl = {"a": a, "b": b}
    return parallel.reduce_from(lora_dense(h, w, lpl, scale), sh.model)


def expert_weight(w: torch.Tensor, d_in: int, sh) -> torch.Tensor:
    """A frozen stacked expert weight (E/model, d_in[/data], d_out) with
    its input features gathered over ``data``."""
    return fsdp_weight(w, d_in, 1, sh)


def expert_adapter(lp: Optional[dict], d_in: int, sh) -> Optional[dict]:
    """An expert adapter (``a`` (E/model, d_in[/data], r), ``b`` (E/model,
    r, d_out)) with ``a`` gathered over ``data``."""
    if lp is None:
        return None
    return {"a": fsdp_a(lp["a"], d_in, 1, sh), "b": lp["b"]}


def apply_ffn(p: dict, x: torch.Tensor, lora: Optional[dict] = None,
              lora_scale: float = 0.0, shard=None) -> torch.Tensor:
    """SwiGLU.  On the mesh (``shard``): ``w1``/``w3`` column-split and
    ``w2`` row-split over ``model``, the output all-reduced."""
    lg = lora or {}
    if shard is not None:
        xc = parallel.copy_to(x, shard.model)
        gate = col_dense(xc, p["w1"], lg.get("w1"), lora_scale, shard)
        up = col_dense(xc, p["w3"], lg.get("w3"), lora_scale, shard)
        h = F.silu(gate.to(_F32)).to(up.dtype) * up
        return row_dense(h, p["w2"], lg.get("w2"), lora_scale, shard,
                         x.shape[-1])
    gate = lora_dense(x, p["w1"], lg.get("w1"), lora_scale)
    up = lora_dense(x, p["w3"], lg.get("w3"), lora_scale)
    h = F.silu(gate.to(_F32)).to(up.dtype) * up
    return lora_dense(h, p["w2"], lg.get("w2"), lora_scale)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap
