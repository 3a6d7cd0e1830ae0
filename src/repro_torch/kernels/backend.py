"""Device dispatch: one point per op between a CUDA kernel and its plain version.

Port of ``repro/kernels/backend.py``.  The reference chooses through a
``KernelConfig`` (auto / pallas / reference); here the tensor's device
chooses, and nothing else does:

* a CUDA tensor launches the hand-written kernel, or raises (a shape,
  dtype or build the kernel cannot take is an error, never a quiet switch
  to another implementation);
* a CPU tensor runs the plain PyTorch version in :mod:`.ref`.

The reference's degenerate-shape rule (``flash_blocks_ok`` /
``_degenerate``, which routed prime sequence lengths and tiny dims to the
jnp path to avoid near-1-wide Pallas grids) has no counterpart: the CUDA
kernels mask their own ragged edges, so every shape runs the kernel.

Serving has no backward pass, so these are plain functions; the training
slice wraps them in ``torch.autograd.Function``s.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention as _flash_cuda
from .ragged_dispatch import ragged_combine as _combine_cuda
from .ragged_dispatch import ragged_expert_matmul as _mm_cuda
from .ragged_dispatch import ragged_gather as _gather_cuda
from .topk_router import topk_router as _router_cuda


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def router(logits: torch.Tensor, k: int):
    """logits (T, E) -> (weights (T, E) f32, mask (T, E) f32, counts (E,))."""
    if _on_cuda(logits):
        return _router_cuda(logits.contiguous(), k)
    return ref.topk_router_ref(logits, k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention in the MODEL layout: q (B,S,H,D); k, v (B,S,KV,D)
    -> (B,S,H,D).  The kernel reads the transposed views in place and
    writes a (B,S,H,D) buffer through its transposed view — no copies."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if _on_cuda(q):
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        _flash_cuda(qt, kt, vt, causal=causal, window=window,
                    out=out.transpose(1, 2))
        return out
    return ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                   window=window).transpose(1, 2)


def ragged_gather(x, src, valid):
    """x (T, D); src, valid (N,) int32 -> xs (N, D)."""
    if _on_cuda(x):
        return _gather_cuda(x.contiguous(), src, valid)
    return ref.ragged_gather_ref(x, src, valid)


def ragged_expert_matmul(xs, block_expert, w, a=None, b=None, *,
                         scale: float = 0.0):
    """xs (N, K); block_expert (N // bm,) int32; w (E, K, H); optional
    per-expert LoRA a (E, K, r) / b (E, r, H) -> (N, H)."""
    if _on_cuda(xs):
        return _mm_cuda(xs.contiguous(), block_expert, w, a, b, scale=scale)
    return ref.ragged_expert_matmul_ref(xs, block_expert, w, a, b, scale)


def ragged_combine(eo, rows, wrank):
    """eo (N, D); rows (T, max_k) int32; wrank (T, max_k) -> (T, D)."""
    if _on_cuda(eo):
        return _combine_cuda(eo.contiguous(), rows, wrank)
    return ref.ragged_combine_ref(eo, rows, wrank)
