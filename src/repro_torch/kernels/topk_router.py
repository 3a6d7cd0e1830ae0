"""Fused SMoE router kernel: softmax + top-k + activation counts.

The wrapper of ``csrc/topk_router.cu``, the port of the Pallas kernel
``repro/kernels/topk_router.py::topk_router``.  Same contract: logits
(T, E) in any float type -> (weights (T, E) f32, mask (T, E) f32,
counts (E,) f32), k static, first-index tie rule.  CUDA tensors only — the
plain version is :func:`repro_torch.kernels.ref.topk_router_ref`.
"""
from __future__ import annotations

import torch

from . import _build

MAX_EXPERTS = 512   # 16 logits per lane of the one-warp-per-row kernel


def topk_router(logits: torch.Tensor, k: int):
    name = "topk_router"
    _build.require_cuda(name, logits)
    code = _build.dtype_code(name, logits)
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (T, E), got {tuple(logits.shape)}")
    _build.require_contiguous(name, logits=logits)
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS or not 0 <= k <= E:
        raise ValueError(f"{name}: need 1 <= E <= {MAX_EXPERTS} and "
                         f"0 <= k <= E, got E={E}, k={k}")
    f32 = dict(dtype=torch.float32, device=logits.device)
    weights = torch.empty((T, E), **f32)
    mask = torch.empty((T, E), **f32)
    counts = torch.empty((E,), **f32)      # zeroed on the stream by the launcher
    rc = _build.lib().rt_topk_router(
        logits.data_ptr(), code, weights.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), T, E, int(k), _build.stream_ptr(logits))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return weights, mask, counts
