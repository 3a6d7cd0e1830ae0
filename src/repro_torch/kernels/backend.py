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

Differentiability.  Every op here is a ``torch.autograd.Function``, as
the reference's are ``jax.custom_vjp``s: the forward is the kernel (or,
on the CPU, the plain version); the backward is reference math, as on
the TPU, which has no backward kernels:

* the LoRA matmuls: the analytic rules of ``_lora_matmul_bwd`` /
  ``_lora_experts_bwd`` in fp32, each gradient cast to its input's dtype.
  Only the gradients autograd asks for are formed — the frozen base
  weight's ``dW`` (an fp32 copy of a stacked expert leaf is 512 MB at
  OLMoE FULL) is skipped unless the weight requires grad;
* the two routers and flash attention: the vjp of the plain version,
  recomputed from the saved inputs.  The routers' mask and counts (and
  ``k_tok``) carry no gradient;
* the ragged trio: the rules of the reference's ``_ragged_gather_bwd``,
  ``_ragged_mm_bwd`` / ``_ragged_mm_lora_bwd`` and ``_ragged_combine_bwd``
  in fp32, each gradient cast to its input's dtype; the integer plan
  arrays carry none.  The grouped matmul's rules run per run of row
  blocks that share an expert (one host copy of ``block_expert``), never
  through a per-block gather of the expert weights, and skip the frozen
  weight's ``dW`` as the LoRA matmuls do.

Without autograd (serving, ``torch.no_grad``) the Functions cost nothing
beyond the forward.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention as _flash_cuda
from .lora_matmul import lora_matmul as _lora_cuda
from .lora_matmul import lora_matmul_experts as _lora_experts_cuda
from .ragged_dispatch import ragged_combine as _combine_cuda
from .ragged_dispatch import ragged_expert_matmul as _mm_cuda
from .ragged_dispatch import ragged_gather as _gather_cuda
from .topk_router import adaptive_topk_router as _adaptive_router_cuda
from .topk_router import topk_router as _router_cuda

_F32 = torch.float32


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _vjp(fn, inputs, grads):
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple whose first
    entries match ``grads``) with respect to every input, by recomputing
    ``fn`` on detached copies under autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [g for _, g in pairs])


# ==========================================================================
# fused LoRA matmul (2-D): y = x @ W + (x @ A) @ B * scale
# ==========================================================================

class _LoraMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.scale = scale
        ctx.save_for_backward(x, w, a, b)
        if _on_cuda(x):
            return _lora_cuda(x.contiguous(), w.contiguous(), a.contiguous(),
                              b.contiguous(), scale=scale)
        return ref.lora_matmul_ref(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, g):
        # exact vjp of ref.lora_matmul_ref (fp32 math, single output cast),
        # as the reference's _lora_matmul_bwd
        x, w, a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        s = ctx.scale
        gf, xf, af, bf = (t.to(_F32) for t in (g, x, a, b))
        gb = gf @ bf.T                                     # (M, r)
        dx = dw = da = db = None
        if need[0]:
            dx = (gf @ w.to(_F32).T + (gb @ af.T) * s).to(x.dtype)
        if need[1]:
            dw = (xf.T @ gf).to(w.dtype)
        if need[2]:
            da = ((xf.T @ gb) * s).to(a.dtype)
        if need[3]:
            db = (((xf @ af).T @ gf) * s).to(b.dtype)
        return dx, dw, da, db, None


def lora_matmul(x, w, a, b, *, scale: float) -> torch.Tensor:
    """Differentiable fused LoRA matmul.  x (M,K); w (K,N); a (K,r); b (r,N)."""
    return _LoraMatmul.apply(x, w, a, b, float(scale))


# ==========================================================================
# fused LoRA matmul, stacked per expert: x (E,C,K) w (E,K,N) a (E,K,r) b (E,r,N)
# ==========================================================================

class _LoraExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.scale = scale
        ctx.save_for_backward(x, w, a, b)
        if _on_cuda(x):
            return _lora_experts_cuda(x.contiguous(), w.contiguous(),
                                      a.contiguous(), b.contiguous(),
                                      scale=scale)
        return ref.lora_matmul_experts_ref(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, g):
        # the reference's _lora_experts_bwd, fp32 math
        x, w, a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        s = ctx.scale
        gf, xf, af, bf = (t.to(_F32) for t in (g, x, a, b))
        gb = torch.einsum("ecn,ern->ecr", gf, bf)          # g @ B^T
        dx = dw = da = db = None
        if need[0]:
            dx = (torch.einsum("ecn,ekn->eck", gf, w.to(_F32))
                  + torch.einsum("ecr,ekr->eck", gb, af) * s).to(x.dtype)
        if need[1]:
            dw = torch.einsum("eck,ecn->ekn", xf, gf).to(w.dtype)
        if need[2]:
            da = (torch.einsum("eck,ecr->ekr", xf, gb) * s).to(a.dtype)
        if need[3]:
            xa = torch.einsum("eck,ekr->ecr", xf, af)      # x @ A
            db = (torch.einsum("ecr,ecn->ern", xa, gf) * s).to(b.dtype)
        return dx, dw, da, db, None


def lora_matmul_experts(x, w, a, b, *, scale: float) -> torch.Tensor:
    """Differentiable stacked per-expert fused LoRA matmul (3-D operands)."""
    return _LoraExperts.apply(x, w, a, b, float(scale))


# ==========================================================================
# top-k router
# ==========================================================================

class _Router(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, k):
        ctx.k = k
        ctx.save_for_backward(logits)
        if _on_cuda(logits):
            out = _router_cuda(logits.contiguous(), k)
        else:
            out = ref.topk_router_ref(logits, k)
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, g_weights, _g_mask, _g_counts):
        (logits,) = ctx.saved_tensors
        k = ctx.k
        (dl,) = _vjp(lambda l: ref.topk_router_ref(l, k)[0], (logits,),
                     (g_weights,))
        return dl, None


def router(logits: torch.Tensor, k: int):
    """logits (T, E) -> (weights (T, E) f32, mask (T, E) f32, counts (E,)).
    Differentiable in ``weights``; mask and counts carry no gradient."""
    return _Router.apply(logits, int(k))


class _AdaptiveRouter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, k_tok, max_k):
        ctx.max_k = max_k
        ctx.save_for_backward(logits, k_tok)
        if _on_cuda(logits):
            out = _adaptive_router_cuda(logits.contiguous(),
                                        k_tok.to(torch.int32).contiguous(),
                                        max_k)
        else:
            out = ref.adaptive_topk_router_ref(logits, k_tok, max_k)
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, g_weights, _g_mask, _g_counts):
        logits, k_tok = ctx.saved_tensors
        max_k = ctx.max_k
        (dl,) = _vjp(lambda l: ref.adaptive_topk_router_ref(l, k_tok,
                                                            max_k)[0],
                     (logits,), (g_weights,))
        return dl, None, None


def adaptive_router(logits: torch.Tensor, k_tok: torch.Tensor, max_k: int):
    """Per-token budgets: token ``t`` takes its top ``min(max(k_tok[t], 0),
    max_k)`` experts (0 deselects it).  Same outputs and gradient rule as
    :func:`router`; uniform ``k_tok == max_k`` is :func:`router` exactly."""
    return _AdaptiveRouter.apply(logits, k_tok, int(max_k))


# ==========================================================================
# flash attention (model layout: q (B,S,H,D); k,v (B,S,KV,D))
# ==========================================================================

def _flash_plain(q, k, v, causal, window, softcap):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                   softcap=softcap).transpose(1, 2)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        ctx.save_for_backward(q, k, v)
        if _on_cuda(q):
            # the kernel reads the transposed views in place and writes a
            # (B,S,H,D) buffer through its transposed view — no copies
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
            _flash_cuda(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        softcap=softcap, out=out.transpose(1, 2))
            return out
        return _flash_plain(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        # vjp of the plain version at the same primals (re-materialises the
        # (S, S) scores, as the reference's _flash_bwd does; with a cap, the
        # vjp of the capped scores, as the reference's jnp path's)
        causal, window, cap = ctx.causal, ctx.window, ctx.softcap
        dq, dk, dv = _vjp(lambda q, k, v: _flash_plain(q, k, v, causal,
                                                        window, cap),
                          ctx.saved_tensors, (g,))
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Differentiable flash attention in the MODEL layout: q (B,S,H,D);
    k, v (B,S,KV,D) -> (B,S,H,D).  ``softcap > 0``: the scaled scores are
    capped, ``softcap·tanh(s / softcap)``, inside the kernel (the
    reference sends a capped model to its blockwise jnp path instead)."""
    return _Flash.apply(q, k, v, bool(causal), int(window), float(softcap))


# ==========================================================================
# ragged (sort-based) MoE dispatch
# ==========================================================================

class _RaggedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, valid):
        ctx.x_rows, ctx.x_dtype = x.shape[0], x.dtype
        ctx.save_for_backward(src, valid)
        if _on_cuda(x):
            return _gather_cuda(x.contiguous(), src, valid)
        return ref.ragged_gather_ref(x, src, valid)

    @staticmethod
    def backward(ctx, g):
        # dx = scatter-add of g·valid into the rows src names
        src, valid = ctx.saved_tensors
        gv = g.to(_F32) * valid.to(_F32)[:, None]
        dx = torch.zeros((ctx.x_rows, g.shape[1]), dtype=_F32,
                         device=g.device).index_add_(0, src.long(), gv)
        return dx.to(ctx.x_dtype), None, None


def ragged_gather(x, src, valid):
    """Differentiable ragged dispatch gather: x (T, D); src, valid (N,)
    int32 -> xs (N, D), ``xs[i] = x[src[i]] * valid[i]``."""
    return _RaggedGather.apply(x, src, valid)


def _expert_runs(block_expert: torch.Tensor, bm: int):
    """[(expert, first row, end row)] for each run of consecutive row
    blocks that share an expert (one host copy of ``block_expert``; the
    plan's are expert-major, so about one run per used expert)."""
    be = block_expert.tolist()
    runs, start = [], 0
    for i in range(1, len(be) + 1):
        if i == len(be) or be[i] != be[start]:
            runs.append((be[start], start * bm, i * bm))
            start = i
    return runs


class _RaggedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, block_expert, w, a, b, scale):
        ctx.scale = scale
        ctx.save_for_backward(xs, block_expert, w, a, b)
        if _on_cuda(xs):
            return _mm_cuda(xs.contiguous(), block_expert, w, a, b,
                            scale=scale)
        return ref.ragged_expert_matmul_ref(xs, block_expert, w, a, b, scale)

    @staticmethod
    def backward(ctx, g):
        # per run of row blocks of expert e (rows i), in fp32:
        #   dxs_i = g_i W_e^T + (g_i B_e^T) A_e^T s
        #   dW_e += xs_i^T g_i;  dA_e += xs_i^T (g_i B_e^T) s;
        #   dB_e += (xs_i A_e)^T g_i s
        xs, be, w, a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        s = ctx.scale
        lora = a is not None
        acc = {j: torch.zeros(t.shape, dtype=_F32, device=t.device)
               for j, t in ((0, xs), (2, w), (3, a), (4, b))
               if need[j] and t is not None}
        for e, r0, r1 in _expert_runs(be, xs.shape[0] // be.shape[0]):
            gf, xf = g[r0:r1].to(_F32), xs[r0:r1].to(_F32)
            if lora:
                af, bf = a[e].to(_F32), b[e].to(_F32)
                gb = gf @ bf.T                                  # (rows, r)
            if 0 in acc:
                dx = gf @ w[e].to(_F32).T
                if lora:
                    dx = dx + (gb @ af.T) * s
                acc[0][r0:r1] = dx
            if 2 in acc:
                acc[2][e] += xf.T @ gf
            if 3 in acc:
                acc[3][e] += (xf.T @ gb) * s
            if 4 in acc:
                acc[4][e] += ((xf @ af).T @ gf) * s
        inputs = (xs, None, w, a, b)
        return tuple(acc[j].to(inputs[j].dtype) if j in acc else None
                     for j in range(5)) + (None,)


def ragged_expert_matmul(xs, block_expert, w, a=None, b=None, *,
                         scale: float = 0.0):
    """Differentiable grouped matmul: xs (N, K); block_expert (N // bm,)
    int32; w (E, K, H); optional per-expert LoRA a (E, K, r) / b (E, r, H)
    -> (N, H)."""
    return _RaggedMatmul.apply(xs, block_expert, w, a, b, float(scale))


class _RaggedCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eo, rows, wrank):
        ctx.save_for_backward(eo, rows, wrank)
        if _on_cuda(eo):
            return _combine_cuda(eo.contiguous(), rows, wrank)
        return ref.ragged_combine_ref(eo, rows, wrank)

    @staticmethod
    def backward(ctx, g):
        # deo: scatter-add of wrank·g into the rows each rank names;
        # dwrank[t, j] = <g_t, eo[rows[t, j]]> at every rank, weight 0
        # included, as the reference's vjp reads it.  Those ranks name row
        # 0, which the forward also multiplies (by 0), so dwrank is finite
        # wherever the output is
        eo, rows, wrank = ctx.saved_tensors
        need = ctx.needs_input_grad
        gf = g.to(_F32)
        idx = rows.long()
        deo = dwrank = None
        if need[0]:
            contrib = wrank.to(_F32)[..., None] * gf[:, None, :]
            deo = torch.zeros(eo.shape, dtype=_F32, device=eo.device)
            deo.index_add_(0, idx.reshape(-1),
                           contrib.reshape(-1, eo.shape[1]))
            deo = deo.to(eo.dtype)
        if need[2]:
            dwrank = torch.einsum("td,tjd->tj", gf,
                                  eo[idx].to(_F32)).to(wrank.dtype)
        return deo, None, dwrank


def ragged_combine(eo, rows, wrank):
    """Differentiable ragged combine: eo (N, D); rows (T, max_k) int32;
    wrank (T, max_k) -> (T, D)."""
    return _RaggedCombine.apply(eo, rows, wrank)
