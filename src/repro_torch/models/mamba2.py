"""The Mamba-2 block (State-Space Duality, arXiv:2405.21060): port of
``repro/models/mamba2.py``.

Training and prefill run the chunked SSD algorithm: quadratic within a
chunk, linear across chunks (the reference's ``lax.scan`` over chunks is a
Python loop here that carries the inter-chunk state).  Decode is the O(1)
recurrent update.  Heads are independent.

The reference has no Pallas kernel for the scan (its SSD is ``jnp``
einsums), so this one is plain PyTorch too, all math in fp32.  The
four-operand intra-chunk einsum is written as explicit steps (C·Bᵀ per
chunk, times exp(segsum), times dt·x), so the (B, nc, H, L, L) fp32
tensors are the largest transients and no contraction path is left to
chance.

State caches (the SSM's KV cache), O(1) in sequence length:
  ``conv``  (B, conv_dim, conv_width-1) — the depthwise conv's context
  ``ssm``   (B, H, P, N)                — the recurrent state, fp32
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, gated_rms_norm, lora_dense

_F32 = torch.float32


# --------------------------------------------------------------------------
# dimensions / init
# --------------------------------------------------------------------------

def mamba_dims(cfg) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim,
                d_state=s.d_state, head_dim=s.head_dim,
                n_groups=s.n_groups, conv_width=s.conv_width,
                in_dim=2 * d_inner + 2 * s.n_groups * s.d_state + n_heads)


def init_mamba(cfg, n: int, generator: torch.Generator, device) -> dict:
    """One stacked Mamba block (leading ``n`` = n_periods axis) with the
    reference's distributions: in/out projections truncated normal
    (fan-in), the conv taps N(0, 1/conv_width), the dt bias softplus⁻¹ of
    dt ~ logU[1e-3, 1e-1], A_log = log U[1, 16], D one (dt bias, A_log and
    D in fp32 whatever the model's dtype)."""
    dims = mamba_dims(cfg)
    dt_, H, W = cfg.torch_dtype, dims["n_heads"], dims["conv_width"]

    def uniform(lo, hi):
        u = torch.rand((n, H), dtype=_F32, device=device,
                       generator=generator)
        return u * (hi - lo) + lo

    in_proj = dense_init((n, cfg.d_model, dims["in_dim"]), dt_, generator,
                         device)
    conv_w = (torch.randn((n, dims["conv_dim"], W), dtype=_F32,
                          device=device, generator=generator)
              * W ** -0.5).to(dt_)
    dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(uniform(1.0, 16.0))
    out_proj = dense_init((n, dims["d_inner"], cfg.d_model), dt_, generator,
                          device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((n, dims["conv_dim"]), dtype=dt_,
                              device=device),
        "dt_bias": dt_bias,
        "A_log": a_log,
        "D": torch.ones((n, H), dtype=_F32, device=device),
        "norm": torch.ones((n, dims["d_inner"]), dtype=dt_, device=device),
        "out_proj": out_proj,
    }


def init_mamba_cache(cfg, batch: int, dtype=_F32, device="cuda") -> dict:
    """Zeroed state rows: ``conv`` in ``dtype`` (fp32 by default, as the
    reference's pools hold it), ``ssm`` in fp32."""
    dims = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, dims["conv_dim"], dims["conv_width"] - 1),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, dims["n_heads"], dims["head_dim"],
                            dims["d_state"]), dtype=_F32, device=device),
    }


# --------------------------------------------------------------------------
# chunked SSD scan
# --------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L): out[i, j] = sum_{k=j+1..i} x[k] for
    j <= i, -inf above the diagonal (selected by ``torch.where``, so the
    masked entries pass no gradient)."""
    L = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.full_like(out, float("-inf")))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.  x (B, S, H, P) head inputs; dt (B, S, H) positive
    steps; A (H,) negative decay rates; Bm, Cm (B, S, H, N) input and
    output gates (groups already broadcast to heads); ``chunk`` divides S.
    Returns (y (B, S, H, P), final state (B, H, P, N)), fp32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    x, dt, Bm, Cm, A = (t.to(_F32) for t in (x, dt, Bm, Cm, A))

    def by_chunk(t):
        return t.reshape((Bsz, nc, chunk) + t.shape[2:])

    xc, dtc, Bc, Cc = map(by_chunk, (x, dt, Bm, Cm))        # (B,nc,L,...)
    dA = (dtc * A[None, None, None, :]).movedim(-1, 2)      # (B,nc,H,L)
    dA_cs = torch.cumsum(dA, dim=-1)
    dtx = xc * dtc[..., None]                               # (B,nc,L,H,P)

    # intra-chunk (diagonal blocks): (C·Bᵀ) ∘ exp(segsum) then · dt·x
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)     # (B,nc,H,L,L)
    scores = scores * torch.exp(_segsum(dA))
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, dtx)
    del scores

    # each chunk's end state
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)       # (B,nc,H,L)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc,
                          dtx * decay_states.movedim(2, 3)[..., None])

    # inter-chunk recurrence: prev[c] = the running state before chunk c
    chunk_decay = torch.exp(dA_cs[..., -1])                 # (B,nc,H)
    carry = (torch.zeros((Bsz, H, P, N), dtype=_F32, device=x.device)
             if initial_state is None else initial_state.to(_F32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = states[:, c] + chunk_decay[:, c, :, None, None] * carry
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # the carried-in state's contribution at each position
    y_off = (torch.einsum("bclhn,bchpn->bclhp", Cc, prev_states)
             * torch.exp(dA_cs).movedim(2, 3)[..., None])
    return (y_diag + y_off).reshape(Bsz, S, H, P), carry


# --------------------------------------------------------------------------
# depthwise causal conv
# --------------------------------------------------------------------------

def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """xbc (B, S, C); w (C, W); b (C,).  Left-pads with ``state`` (B, C,
    W-1) or zeros; taps summed in fp32.  Returns (out (B, S, C) in xbc's
    dtype, new state (B, C, W-1): the last W-1 padded inputs, so with
    S < W-1 it still holds part of the incoming state)."""
    Bsz, S, C = xbc.shape
    W = w.shape[-1]
    xt = xbc.transpose(1, 2)                                # (B, C, S)
    pad = (xbc.new_zeros((Bsz, C, W - 1)) if state is None
           else state.to(xbc.dtype))
    xp = torch.cat([pad, xt], dim=-1)                       # (B, C, S+W-1)
    out = torch.zeros((Bsz, C, S), dtype=_F32, device=xbc.device)
    for i in range(W):
        out = out + xp[:, :, i:i + S].to(_F32) * w[:, i].to(_F32)[None, :,
                                                                 None]
    out = out + b.to(_F32)[None, :, None]
    return out.transpose(1, 2).to(xbc.dtype), xp[:, :, S:].contiguous()


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------

def _split_in_proj(z_xbc_dt, dims):
    d_inner, conv_dim, H = dims["d_inner"], dims["conv_dim"], dims["n_heads"]
    z = z_xbc_dt[..., :d_inner]
    xbc = z_xbc_dt[..., d_inner:d_inner + conv_dim]
    dt = z_xbc_dt[..., d_inner + conv_dim:]
    if dt.shape[-1] != H:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns, not {H}")
    return z, xbc, dt


def _split_xbc(xbc, dims):
    d_inner, G, N = dims["d_inner"], dims["n_groups"], dims["d_state"]
    return (xbc[..., :d_inner], xbc[..., d_inner:d_inner + G * N],
            xbc[..., d_inner + G * N:])


def _broadcast_groups(t, dims):
    """(B, S, G·N) -> (B, S, H, N), each group repeated over its heads."""
    Bsz, S = t.shape[:2]
    G, N, H = dims["n_groups"], dims["d_state"], dims["n_heads"]
    return t.reshape(Bsz, S, G, N).repeat_interleave(H // G, dim=2)


def apply_mamba(p: dict, cfg, x: torch.Tensor, *,
                lora: Optional[dict] = None, lora_scale: float = 0.0,
                cache: Optional[dict] = None, return_cache: bool = False):
    """x (B, S, D).  Three paths: the chunked scan from a zero state
    (prefill and training: ``cache`` None; ``chunk`` the largest divisor
    of S that is <= ``chunk_size``); the chunked scan continuing from a
    ``cache`` {conv, ssm} (S > 1); the recurrent update (``cache`` given,
    S == 1).  Returns (out (B, S, D), new {conv, ssm} or None): the
    decode path always returns it, the chunked paths with
    ``return_cache``."""
    dims = mamba_dims(cfg)
    Bsz, S, _ = x.shape
    lg = lora or {}
    H, P = dims["n_heads"], dims["head_dim"]

    zxbcdt = lora_dense(x, p["in_proj"], lg.get("in_proj"), lora_scale)
    z, xbc, dt = _split_in_proj(zxbcdt, dims)
    A = -torch.exp(p["A_log"].to(_F32))                     # (H,)
    new_cache = None

    if cache is not None and S == 1:
        # recurrent decode; the conv context keeps the promoted dtype of
        # state and input (fp32 in the pools)
        conv = cache["conv"]
        ct = torch.promote_types(conv.dtype, xbc.dtype)
        xbc_full = torch.cat([conv.to(ct), xbc.transpose(1, 2).to(ct)],
                             dim=-1)                        # (B, C, W)
        conv_out = (xbc_full.to(_F32)
                    * p["conv_w"].to(_F32)[None]).sum(-1)
        conv_out = conv_out + p["conv_b"].to(_F32)[None]
        xbc_t = F.silu(conv_out)[:, None, :].to(x.dtype)    # (B, 1, C)
        xs, Bm, Cm = _split_xbc(xbc_t, dims)
        xs = xs.reshape(Bsz, H, P)
        Bm = _broadcast_groups(Bm, dims)[:, 0]              # (B, H, N)
        Cm = _broadcast_groups(Cm, dims)[:, 0]
        dtp = F.softplus(dt[:, 0].to(_F32) + p["dt_bias"][None])  # (B, H)
        dA = torch.exp(dtp * A[None])
        dtx = xs.to(_F32) * dtp[..., None]                  # (B, H, P)
        new_ssm = (cache["ssm"].to(_F32) * dA[..., None, None]
                   + dtx[..., :, None] * Bm.to(_F32)[..., None, :])
        y = torch.einsum("bhn,bhpn->bhp", Cm.to(_F32), new_ssm)
        y = y + p["D"].to(_F32)[None, :, None] * xs.to(_F32)
        y = y.reshape(Bsz, 1, dims["d_inner"]).to(x.dtype)
        new_cache = {"conv": xbc_full[:, :, 1:], "ssm": new_ssm}
    else:
        xbc_c, conv_state = causal_conv(
            xbc, p["conv_w"], p["conv_b"],
            cache["conv"] if cache is not None else None)
        xbc_c = F.silu(xbc_c.to(_F32)).to(x.dtype)
        xs, Bm, Cm = _split_xbc(xbc_c, dims)
        xs = xs.reshape(Bsz, S, H, P)
        Bm = _broadcast_groups(Bm, dims)
        Cm = _broadcast_groups(Cm, dims)
        dtp = F.softplus(dt.to(_F32) + p["dt_bias"])
        chunk = min(cfg.ssm.chunk_size, S)
        while S % chunk:                        # largest divisor <= chunk_size
            chunk -= 1
        y, final_state = ssd_chunked(
            xs, dtp, A, Bm, Cm, chunk,
            cache["ssm"] if cache is not None else None)
        y = y + p["D"].to(_F32)[None, None, :, None] * xs.to(_F32)
        y = y.reshape(Bsz, S, dims["d_inner"]).to(x.dtype)
        if return_cache:
            new_cache = {"conv": conv_state, "ssm": final_state}

    y = gated_rms_norm(p["norm"], y, z, cfg.rms_eps)
    return (lora_dense(y, p["out_proj"], lg.get("out_proj"), lora_scale),
            new_cache)
