"""Causal / sliding-window GQA flash attention kernel (forward).

The wrapper of ``csrc/flash_attention.cu``, the port of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.  Same contract:
q (B, H, S, D); k, v (B, KV, S, D) -> (B, H, S, D) in q's dtype, fp32
inside, scale D^-0.5, ``kpos > qpos - window`` when ``window > 0``.  The
kernel masks its own ragged S edge, so any S works (no block-divisibility
rule), and it takes strided (batch, head, seq) axes: only the head dim
must be contiguous, so model-layout views go in without a copy.  CUDA
tensors only — the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """``out`` (optional, (B, H, S, D), any strides with a contiguous head
    dim) receives the result in place — the model passes a transposed
    view of its (B, S, H, D) buffer."""
    name = "flash_attention"
    _build.require_cuda(name, q, k, v)
    code = _build.dtype_code(name, q)
    B, H, S, D = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, D) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match (B,H,S,D)/(B,KV,S,D)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share a dtype")
    if KV < 1 or H % KV:
        raise ValueError(f"{name}: H={H} is not a multiple of KV={KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _build.require_cuda(name, q, out)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"{name}: out must be {tuple(q.shape)} {q.dtype}")
    for arg, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {arg} needs a contiguous head dim")
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    rc = _build.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
        ctypes.cast(strides, ctypes.c_void_p), B, H, KV, S, D, D ** -0.5,
        int(causal), int(window), _build.stream_ptr(q))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return out
