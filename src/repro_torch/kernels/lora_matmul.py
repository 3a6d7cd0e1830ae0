"""Fused LoRA matmul kernels: ``y = x@W + (x@A)@B·scale``.

The wrappers of ``csrc/lora_matmul.cu``, the port of the Pallas kernels
``repro/kernels/lora_matmul.py::lora_matmul`` and ``::lora_matmul_experts``.
Same contract: fp32 accumulation, one cast to x's dtype, every operand in
one dtype (float32, bfloat16 or float16).  The dtype picks the kernel:
bfloat16 and float16 run the tensor-core kernel (wgmma fed by the TMA),
float32 the FMA kernel, whose full fp32 products the fp32 checks need.
Both mask their own ragged M, N, K and C edges, so any shape runs (no
block-divisibility rule), and the rank r is any value up to
:data:`MAX_RANK`.  CUDA tensors only — the plain versions are
:func:`repro_torch.kernels.ref.lora_matmul_ref` and
:func:`repro_torch.kernels.ref.lora_matmul_experts_ref`.
"""
from __future__ import annotations

import torch

from . import _build

MAX_RANK = 64   # RT_LORA_MAX_RANK of csrc/lora_matmul.cu


def _check(name, x, w, a, b, lead) -> int:
    _build.require_cuda(name, x, w, a, b)
    code = _build.dtype_code(name, x)
    for arg, t in (("w", w), ("a", a), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, x is {x.dtype}; "
                            "the kernel takes one dtype")
    _build.require_contiguous(name, x=x, w=w, a=a, b=b)
    K, N = w.shape[-2:]
    r = a.shape[-1]
    want = {"x": lead + (x.shape[-2], K), "w": lead + (K, N),
            "a": lead + (K, r), "b": lead + (r, N)}
    for arg, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if tuple(t.shape) != want[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {want[arg]}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: LoRA rank {r} outside 1..{MAX_RANK}")
    return code


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, *, scale: float) -> torch.Tensor:
    """x (M, K); w (K, N); a (K, r); b (r, N) -> (M, N)."""
    name = "lora_matmul"
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{name}: needs 2-D operands")
    code = _check(name, x, w, a, b, ())
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _build.lib().rt_lora_matmul(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), code, M, N, K, r, float(scale),
        _build.stream_ptr(x))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return out


def lora_matmul_experts(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, *, scale: float) -> torch.Tensor:
    """x (E, C, K); w (E, K, N); a (E, K, r); b (E, r, N) -> (E, C, N)."""
    name = "lora_matmul_experts"
    if x.dim() != 3 or w.dim() != 3 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"{name}: needs 3-D (expert-stacked) operands")
    E, C, K = x.shape
    code = _check(name, x, w, a, b, (E,))
    N, r = w.shape[2], a.shape[2]
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    rc = _build.lib().rt_lora_matmul_experts(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), code, E, C, N, K, r, float(scale),
        _build.stream_ptr(x))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return out
