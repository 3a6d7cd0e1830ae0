"""Fused SMoE router kernel: softmax + top-k + activation counts.

The wrappers of ``csrc/topk_router.cu``, the port of the Pallas kernel
``repro/kernels/topk_router.py::topk_router``.  Same contract: logits
(T, E) in any float type -> (weights (T, E) f32, mask (T, E) f32,
counts (E,) f32), first-index tie rule.  :func:`topk_router` takes a
static k; :func:`adaptive_topk_router` a budget per token, on the same
kernel.  CUDA tensors only — the plain versions are
:func:`repro_torch.kernels.ref.topk_router_ref` and
:func:`repro_torch.kernels.ref.adaptive_topk_router_ref`.
"""
from __future__ import annotations

import torch

from . import _build

MAX_EXPERTS = 512   # 16 logits per lane of the one-warp-per-row kernel


def _outputs(name: str, logits: torch.Tensor, k: int):
    """Check what the kernel takes; (dtype code, weights, mask, counts)."""
    code = _build.dtype_code(name, logits)
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (T, E), got {tuple(logits.shape)}")
    _build.require_contiguous(name, logits=logits)
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS or not 0 <= k <= E:
        raise ValueError(f"{name}: need 1 <= E <= {MAX_EXPERTS} and "
                         f"0 <= k <= E, got E={E}, k={k}")
    f32 = dict(dtype=torch.float32, device=logits.device)
    # counts too are written by the kernel alone: no zeroing launch
    return (code, torch.empty((T, E), **f32), torch.empty((T, E), **f32),
            torch.empty((E,), **f32))


def topk_router(logits: torch.Tensor, k: int):
    """Every token takes its top ``k`` experts."""
    name = "topk_router"
    _build.require_cuda(name, logits)
    code, weights, mask, counts = _outputs(name, logits, k)
    T, E = logits.shape
    rc = _build.lib().rt_topk_router(
        logits.data_ptr(), code, weights.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), T, E, int(k), _build.stream_ptr(logits))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return weights, mask, counts


def adaptive_topk_router(logits: torch.Tensor, k_tok: torch.Tensor,
                         max_k: int):
    """Token ``t`` takes its top ``min(max(k_tok[t], 0), max_k)`` experts;
    ``k_tok`` (T,) int32 on the logits' device.  Uniform ``k_tok == max_k``
    gives :func:`topk_router`'s output bit for bit."""
    name = "adaptive_topk_router"
    _build.require_cuda(name, logits, k_tok)
    code, weights, mask, counts = _outputs(name, logits, max_k)
    T, E = logits.shape
    _build.require_int32(name, k_tok=k_tok)
    _build.require_contiguous(name, k_tok=k_tok)
    if tuple(k_tok.shape) != (T,):
        raise ValueError(f"{name}: k_tok must have shape ({T},), got "
                         f"{tuple(k_tok.shape)}")
    rc = _build.lib().rt_adaptive_topk_router(
        logits.data_ptr(), code, k_tok.data_ptr(), weights.data_ptr(),
        mask.data_ptr(), counts.data_ptr(), T, E, int(max_k),
        _build.stream_ptr(logits))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return weights, mask, counts
