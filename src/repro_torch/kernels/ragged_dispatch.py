"""Sort-based ragged MoE dispatch: the plan, and the three kernel wrappers.

Port of ``repro/kernels/ragged_dispatch.py``.  Assignments are laid out
expert-major in one ragged buffer of ``N`` rows; expert ``e`` owns rows
``[off[e], off[e] + count[e])``, its segment padded to a multiple of
``block_m`` so matmul row blocks never straddle two experts.  ``N`` is
static: the worst-case assignment count plus one block of padding per
expert, so expert compute follows the activated budget.

:func:`ragged_plan` is plain PyTorch (a counting sort with cumsums, as in
the reference) and runs on whatever device its inputs lie on.  The three
wrappers launch ``csrc/ragged_dispatch.cu`` on CUDA tensors only; their
plain versions live in :mod:`repro_torch.kernels.ref`.

``BLOCK_M`` stays 8, the reference's value, so the plan's integer arrays
equal the reference's exactly.  The combined output does not depend on
it, and the grouped matmul's tensor-core kernel does not tile by it: its
tiles are runs of row blocks that share an expert.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build

BLOCK_M = 8


def ragged_rows(budget: int, num_experts: int,
                block_m: int = BLOCK_M) -> int:
    """Static ragged-buffer size for a worst-case assignment ``budget``:
    the budget rounded up to blocks, plus one block of segment padding per
    expert."""
    return -(-budget // block_m) * block_m + num_experts * block_m


class RaggedPlan(NamedTuple):
    src: torch.Tensor           # (N,)  int32 token id per buffer row
    valid: torch.Tensor         # (N,)  int32 0/1 — padding rows are 0
    block_expert: torch.Tensor  # (N // block_m,) int32 expert per row block
    rows: torch.Tensor          # (T, max_k) int32 buffer row per (token, rank)
    wrank: torch.Tensor         # (T, max_k) f32 combine weight per rank


def ragged_plan(mask: torch.Tensor, weights: torch.Tensor, *, budget: int,
                max_k: int, block_m: int = BLOCK_M) -> RaggedPlan:
    """Counting-sort dispatch plan from router outputs ``mask``/``weights``
    (T, E); ``budget`` >= ``mask.sum()``; ``max_k`` is ``rows``' width.

    Each selected (token, expert) pair goes to slot ``off[e] + rank of t
    within e``.  The reference scatters with ``mode="drop"`` and sends
    unselected pairs to index ``N``; here they go to one extra trash
    element ``N`` that is sliced off, which drops them without a
    host-synchronising boolean mask.  Ranks past a token's own budget have
    ``wrank == 0`` and point at row 0.
    """
    T, E = mask.shape
    dev = mask.device
    i32 = torch.int32
    N = ragged_rows(budget, E, block_m)
    nb = N // block_m
    m = mask.to(torch.float32)
    counts = m.sum(dim=0).to(i32)                                  # (E,)
    padded = (counts + block_m - 1) // block_m * block_m
    ends = torch.cumsum(padded, dim=0, dtype=i32)
    off = ends - padded                                            # exclusive
    pos = (torch.cumsum(m, dim=0) - 1.0).to(i32)                   # (T, E)
    slot = off[None, :] + pos
    dst = torch.where(m > 0, slot, torch.full_like(slot, N)).reshape(-1).long()
    tok = torch.arange(T, dtype=i32, device=dev)[:, None].expand(T, E)
    src = torch.zeros(N + 1, dtype=i32, device=dev)
    src.index_put_((dst,), tok.reshape(-1))
    valid = torch.zeros(N + 1, dtype=i32, device=dev)
    valid.index_put_((dst,), torch.ones_like(dst, dtype=i32))
    starts = torch.arange(nb, dtype=i32, device=dev) * block_m
    block_expert = ((ends[None, :] <= starts[:, None]).sum(dim=1)
                    .clamp_max(E - 1).to(i32))
    # inverse plan: a token's selected experts are its nonzero combine
    # weights in descending order; a stable sort breaks ties toward the
    # lower index, as jax.lax.top_k does (torch.topk leaves ties unordered)
    top_w, top_idx = torch.sort(weights, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :max_k], top_idx[:, :max_k]
    rank_valid = top_w > 0
    rows = torch.gather(slot, 1, top_idx)
    rows = torch.where(rank_valid, rows, torch.zeros_like(rows)).to(i32)
    wrank = top_w * rank_valid.to(top_w.dtype)
    return RaggedPlan(src=src[:N], valid=valid[:N],
                      block_expert=block_expert, rows=rows, wrank=wrank)


# ==========================================================================
# kernel wrappers (CUDA tensors only)
# ==========================================================================

def ragged_gather(x: torch.Tensor, src: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """x: (T, D); src, valid: (N,) int32 -> xs (N, D),
    ``xs[i] = x[src[i]] * valid[i]`` in x's dtype (a padding row reads and
    multiplies row ``src[i]``, as the reference does).  One warp per row."""
    name = "ragged_gather"
    _build.require_cuda(name, x, src, valid)
    code = _build.dtype_code(name, x)
    _build.require_int32(name, src=src, valid=valid)
    _build.require_contiguous(name, x=x, src=src, valid=valid)
    if x.dim() != 2 or src.shape != valid.shape or src.dim() != 1:
        raise ValueError(f"{name}: need x (T, D), src/valid (N,); got "
                         f"{tuple(x.shape)}, {tuple(src.shape)}, "
                         f"{tuple(valid.shape)}")
    N, D = src.shape[0], x.shape[1]
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    rc = _build.lib().rt_ragged_gather(
        x.data_ptr(), src.data_ptr(), valid.data_ptr(), out.data_ptr(), code,
        N, D, _build.stream_ptr(x))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return out


def ragged_expert_matmul(xs: torch.Tensor, block_expert: torch.Tensor,
                         w: torch.Tensor, a: Optional[torch.Tensor] = None,
                         b: Optional[torch.Tensor] = None, *,
                         scale: float = 0.0) -> torch.Tensor:
    """Grouped (segment) matmul over the ragged buffer: xs (N, K);
    block_expert (N // bm,) int32; w (E, K, H); optional per-expert LoRA
    factors a (E, K, r), b (E, r, H).  Row block ``i`` computes
    ``xs_i @ w[be[i]]`` (+ ``(xs_i @ a[e]) @ b[e] * scale``), fp32
    accumulate, one cast.  One launch: bf16 / fp16 on the tensor cores,
    one tile per run of row blocks that share an expert (the tile table is
    computed inside the kernel); float32, a LoRA rank above 64 or a row
    block that does not divide 64 on the FMA units."""
    name = "ragged_expert_matmul"
    lora = [t for t in (a, b) if t is not None]
    if len(lora) == 1:
        raise ValueError(f"{name}: pass both LoRA factors a and b, or neither")
    _build.require_cuda(name, xs, block_expert, w, *lora)
    code = _build.dtype_code(name, xs)
    _build.require_int32(name, block_expert=block_expert)
    _build.require_contiguous(name, xs=xs, block_expert=block_expert, w=w,
                              **({"a": a, "b": b} if lora else {}))
    N, K = xs.shape
    nb = block_expert.shape[0]
    E, Kw, H = w.shape
    if Kw != K or nb == 0 or N % nb:
        raise ValueError(f"{name}: xs {tuple(xs.shape)}, w {tuple(w.shape)}, "
                         f"{nb} row blocks do not fit")
    r = 0
    if lora:
        r = a.shape[-1]
        if a.shape != (E, K, r) or b.shape != (E, r, H):
            raise ValueError(f"{name}: LoRA a {tuple(a.shape)} / b "
                             f"{tuple(b.shape)} do not fit w {tuple(w.shape)}")
    for t in (w, *lora):
        if t.dtype != xs.dtype:
            raise TypeError(f"{name}: weights must share xs's dtype {xs.dtype}")
    out = torch.empty((N, H), dtype=xs.dtype, device=xs.device)
    rc = _build.lib().rt_ragged_expert_matmul(
        xs.data_ptr(), block_expert.data_ptr(), w.data_ptr(),
        a.data_ptr() if lora else None, b.data_ptr() if lora else None,
        out.data_ptr(), code, N, nb, K, H, r, float(scale),
        _build.stream_ptr(xs), E)
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return out


def ragged_combine(eo: torch.Tensor, rows: torch.Tensor,
                   wrank: torch.Tensor) -> torch.Tensor:
    """eo: (N, D); rows: (T, max_k) int32; wrank: (T, max_k) f32 ->
    (T, D), ``out[t] = sum_j wrank[t, j] * eo[rows[t, j]]``: fp32, rank by
    rank, every rank (weight 0 included), one cast.  One warp per (token,
    column chunk)."""
    name = "ragged_combine"
    _build.require_cuda(name, eo, rows, wrank)
    code = _build.dtype_code(name, eo)
    _build.require_int32(name, rows=rows)
    if wrank.dtype != torch.float32:
        raise TypeError(f"{name}: wrank must be float32, got {wrank.dtype}")
    _build.require_contiguous(name, eo=eo, rows=rows, wrank=wrank)
    if eo.dim() != 2 or rows.dim() != 2 or rows.shape != wrank.shape:
        raise ValueError(f"{name}: need eo (N, D), rows/wrank (T, max_k); "
                         f"got {tuple(eo.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(wrank.shape)}")
    T, max_k = rows.shape
    D = eo.shape[1]
    out = torch.empty((T, D), dtype=eo.dtype, device=eo.device)
    rc = _build.lib().rt_ragged_combine(
        eo.data_ptr(), rows.data_ptr(), wrank.data_ptr(), out.data_ptr(),
        code, T, max_k, D, _build.stream_ptr(eo))
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return out
