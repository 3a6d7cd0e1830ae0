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

from . import parallel
from .layers import (col_dense, dense_init, fsdp_a, fsdp_weight,
                     gated_rms_norm, lora_dense, row_dense)

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


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, dtype=_F32, device=device, generator=generator)
    return u * (hi - lo) + lo


def mamba_leaf(name: str, shape, dtype, generator: torch.Generator, device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """A Mamba leaf ``name``, or a shard of one, of ``shape`` with the
    reference's distribution: in/out projections truncated normal (σ =
    1/sqrt(``fan_in``), the whole leaf's input features), the conv taps
    N(0, 1/conv_width), the dt bias softplus⁻¹ of dt ~ logU[1e-3, 1e-1],
    A_log = log U[1, 16], the conv bias zero, D and the norm one."""
    if name in ("in_proj", "out_proj"):
        return dense_init(shape, dtype, generator, device, fan_in=fan_in)
    if name == "conv_w":
        return (torch.randn(shape, dtype=_F32, device=device,
                            generator=generator) * shape[-1] ** -0.5).to(dtype)
    if name == "dt_bias":
        dt = torch.exp(_uniform(shape, math.log(1e-3), math.log(1e-1),
                                generator, device))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if name == "A_log":
        return torch.log(_uniform(shape, 1.0, 16.0, generator,
                                  device)).to(dtype)
    if name == "conv_b":
        return torch.zeros(shape, dtype=dtype, device=device)
    if name in ("D", "norm"):
        return torch.ones(shape, dtype=dtype, device=device)
    raise KeyError(f"no Mamba leaf {name!r}")


def init_mamba(cfg, n: int, generator: torch.Generator, device) -> dict:
    """One stacked Mamba block (leading ``n`` = n_periods axis), each leaf
    from :func:`mamba_leaf` (drawn in the order in_proj, conv_w, dt_bias,
    A_log, out_proj; dt bias, A_log and D in fp32 whatever the model's
    dtype)."""
    dims = mamba_dims(cfg)
    dt_, H, C = cfg.torch_dtype, dims["n_heads"], dims["conv_dim"]
    shapes = {"in_proj": ((n, cfg.d_model, dims["in_dim"]), dt_),
              "conv_w": ((n, C, dims["conv_width"]), dt_),
              "dt_bias": ((n, H), _F32), "A_log": ((n, H), _F32),
              "out_proj": ((n, dims["d_inner"], cfg.d_model), dt_),
              "conv_b": ((n, C), dt_), "D": ((n, H), _F32),
              "norm": ((n, dims["d_inner"]), dt_)}
    return {name: mamba_leaf(name, shape, dtype, generator, device)
            for name, (shape, dtype) in shapes.items()}


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


def _conv_step(state: torch.Tensor, xbc: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor, dtype):
    """One token through the depthwise conv: state (B, C, W-1), xbc (B, 1,
    C), taps w (C, W), bias b (C,).  Returns (silu of the conv (B, C) in
    ``dtype``, the new state); the context keeps the promoted dtype of
    state and input (fp32 in the pools)."""
    ct = torch.promote_types(state.dtype, xbc.dtype)
    full = torch.cat([state.to(ct), xbc.transpose(1, 2).to(ct)],
                     dim=-1)                                # (B, C, W)
    out = (full.to(_F32) * w.to(_F32)[None]).sum(-1) + b.to(_F32)[None]
    return F.silu(out).to(dtype), full[:, :, 1:]


def _heads(p: dict, cfg, xbc_t: torch.Tensor, dt: torch.Tensor, h0: int,
           Hh: int, state: Optional[torch.Tensor], step: bool):
    """The SSM of heads [h0, h0 + Hh): ``xbc_t`` (B, S, Hh·P + 2·G·N) the
    conv's activations of those heads' x, then B and C (each group
    repeated over its heads); ``dt`` (B, S, Hh) before the softplus.
    Returns (y (B, S, Hh·P) fp32, the new state (B, Hh, P, N)): with
    ``step`` the recurrent update of ``state`` (S == 1), else the chunked
    scan (``chunk`` the largest divisor of S <= ``chunk_size``) from
    ``state`` or zeros."""
    dims = mamba_dims(cfg)
    H, P, G, N = (dims[k] for k in ("n_heads", "head_dim", "n_groups",
                                    "d_state"))
    Bsz, S = xbc_t.shape[:2]
    heads = slice(h0, h0 + Hh)

    def per_head(t):
        # (B, S, G·N) -> (B, S, Hh, N): each group over its heads
        t = t.reshape(Bsz, S, G, N).repeat_interleave(H // G, dim=2)
        return t if Hh == H else t[:, :, heads]

    xs = xbc_t[..., :Hh * P].reshape(Bsz, S, Hh, P)
    Bm = per_head(xbc_t[..., Hh * P:Hh * P + G * N])
    Cm = per_head(xbc_t[..., Hh * P + G * N:])
    A = -torch.exp(p["A_log"][heads].to(_F32))
    D = p["D"][heads].to(_F32)
    if step:
        dtp = F.softplus(dt[:, 0].to(_F32) + p["dt_bias"][heads][None])
        x1 = xs[:, 0].to(_F32)                              # (B, Hh, P)
        new = (state.to(_F32) * torch.exp(dtp * A[None])[..., None, None]
               + (x1 * dtp[..., None])[..., :, None]
               * Bm[:, 0].to(_F32)[..., None, :])
        y = torch.einsum("bhn,bhpn->bhp", Cm[:, 0].to(_F32), new)
        y = y + D[None, :, None] * x1
        return y.reshape(Bsz, 1, Hh * P), new
    dtp = F.softplus(dt.to(_F32) + p["dt_bias"][heads])
    chunk = min(cfg.ssm.chunk_size, S)
    while S % chunk:                            # largest divisor <= chunk_size
        chunk -= 1
    y, new = ssd_chunked(xs, dtp, A, Bm, Cm, chunk, state)
    y = y + D[None, None, :, None] * xs.to(_F32)
    return y.reshape(Bsz, S, Hh * P), new


def apply_mamba(p: dict, cfg, x: torch.Tensor, *,
                lora: Optional[dict] = None, lora_scale: float = 0.0,
                cache: Optional[dict] = None, return_cache: bool = False,
                shard=None):
    """x (B, S, D).  Three paths: the chunked scan from a zero state
    (prefill and training: ``cache`` None); the chunked scan continuing
    from a ``cache`` {conv, ssm} (S > 1); the recurrent update (``cache``
    given, S == 1).  Returns (out (B, S, D), new {conv, ssm} or None): the
    decode path always returns it, the chunked paths with
    ``return_cache``.  ``shard``: the card mesh (:func:`_apply_sharded`)."""
    if shard is not None:
        if _heads_split(p, cfg, shard):
            return _apply_sharded(p, cfg, x, lora or {}, lora_scale, cache,
                                  return_cache, shard)
        p, lora = _whole(p, lora or {}, cfg, shard)
    dims = mamba_dims(cfg)
    S = x.shape[1]
    lg = lora or {}
    zxbcdt = lora_dense(x, p["in_proj"], lg.get("in_proj"), lora_scale)
    z, xbc, dt = _split_in_proj(zxbcdt, dims)
    step = cache is not None and S == 1
    if step:
        xbc_t, conv_state = _conv_step(cache["conv"], xbc, p["conv_w"],
                                       p["conv_b"], x.dtype)
        xbc_t = xbc_t[:, None, :]                           # (B, 1, C)
    else:
        xbc_t, conv_state = causal_conv(
            xbc, p["conv_w"], p["conv_b"],
            cache["conv"] if cache is not None else None)
        xbc_t = F.silu(xbc_t.to(_F32)).to(x.dtype)
    y, ssm = _heads(p, cfg, xbc_t, dt, 0, dims["n_heads"],
                    cache["ssm"] if cache is not None else None, step)
    new_cache = ({"conv": conv_state, "ssm": ssm}
                 if step or return_cache else None)
    y = gated_rms_norm(p["norm"], y.to(x.dtype), z, cfg.rms_eps)
    return (lora_dense(y, p["out_proj"], lg.get("out_proj"), lora_scale),
            new_cache)


# --------------------------------------------------------------------------
# the block on the card mesh
# --------------------------------------------------------------------------

def _heads_split(p: dict, cfg, sh) -> bool:
    """Whether the block runs head-parallel on ``sh``'s ``model`` axis: its
    heads divide the axis (the reference's rules then split ``out_proj``'s
    rows, the SSM state's heads and, where ``in_dim`` divides too,
    ``in_proj``'s columns).  A block whose heads do not divide runs whole
    on each rank, which needs both projections whole there."""
    if sh.M == 1:
        return False
    dims = mamba_dims(cfg)
    H = dims["n_heads"]
    if H % sh.M == 0:
        return True
    if (p["in_proj"].shape[-1] != dims["in_dim"]
            or p["out_proj"].shape[0] != dims["d_inner"]):
        raise NotImplementedError(
            f"{cfg.name}: {H} SSM heads do not divide the mesh "
            f"{dict(sh.mesh.shape)}'s {sh.M}-way model axis, which splits "
            "its projections")
    return False


def _whole(p: dict, lg: dict, cfg, sh):
    """The block's leaves whole on this rank, for a block that runs
    unsplit on the mesh: the projections and the adapters' ``a`` gathered
    over ``data`` where FSDP splits them.  Nothing is split over
    ``model`` then: d_inner = expand · d_model does not divide it, so
    d_model does not either."""
    d_in = {"in_proj": cfg.d_model, "out_proj": mamba_dims(cfg)["d_inner"]}
    p = dict(p, in_proj=fsdp_weight(p["in_proj"], cfg.d_model, 0, sh),
             out_proj=fsdp_weight(p["out_proj"], cfg.d_model, 1, sh))
    return p, {name: {"a": fsdp_a(lp["a"], d_in[name], 0, sh), "b": lp["b"]}
               for name, lp in lg.items() if lp is not None}


def _own_channels(Cl: int, C: int, sh) -> slice:
    """This rank's ``Cl`` of the conv cache's ``C`` channels: a contiguous
    slice over ``model``, or all of them where the rule keeps it whole."""
    return slice(0, C) if Cl == C else slice(sh.mi * Cl, (sh.mi + 1) * Cl)


def _conv_tail(xbc: torch.Tensor, width: int) -> torch.Tensor:
    """The conv state a zero-state :func:`causal_conv` of ``xbc`` (B, S,
    C) leaves: its last W-1 inputs, zero-padded on the left."""
    pad = xbc.new_zeros((xbc.shape[0], xbc.shape[2], width - 1))
    return torch.cat([pad, xbc.transpose(1, 2)],
                     dim=-1)[:, :, xbc.shape[1]:].contiguous()


def _apply_sharded(p: dict, cfg, x: torch.Tensor, lg: dict, lora_scale,
                   cache, return_cache, sh):
    """:func:`apply_mamba` on the mesh, head-parallel: this rank runs the
    SSD of its H/M heads, and the layout follows the reference's specs.

    * ``in_proj`` is column-split over ``model`` in contiguous blocks of
      ``[z | x | B | C | dt]``, which do not align with heads: this rank's
      columns (``layers.col_dense``) are all-gathered over ``model`` (the
      backward reduce-scatters), and it keeps its heads' z, x and dt and
      B and C whole.
    * The conv is depthwise with replicated taps: training and prefill
      convolve just the channels this rank reads (its heads' x, B, C).
      The conv cache holds a contiguous channel slice per rank (the
      reference's C -> model), which is not those channels: prefill
      stores its slice of the last W-1 inputs, and a decode step
      convolves its slice and all-gathers the activations over ``model``.
    * The SSM state is H -> model: this rank's heads, updated in place
      by the decode step as on one card.
    * The gated norm runs over the whole d_inner: the sum of squares of
      this rank's columns is all-reduced over ``model`` both ways (every
      rank's columns depend on it) and the scale sliced to its columns.
    * ``out_proj`` is row-split on the heads' rows (``layers.row_dense``,
      all-reduced over ``model``)."""
    dims = mamba_dims(cfg)
    Bsz, S, _ = x.shape
    H, P, M = dims["n_heads"], dims["head_dim"], sh.M
    W, d_inner, C = dims["conv_width"], dims["d_inner"], dims["conv_dim"]
    Hl = H // M
    h0 = sh.mi * Hl
    cols = slice(h0 * P, (h0 + Hl) * P)
    if cache is not None and S > 1:
        raise NotImplementedError("the mesh runs prefill, training and the "
                                  "one-token decode step; a continued "
                                  "prefill stays single-card")

    xc = parallel.copy_to(x, sh.model)
    w, lp = p["in_proj"], lg.get("in_proj")
    if parallel.split_dim(dims["in_dim"], w.shape[-1], M, "in_proj"):
        zxbcdt = parallel.gather(col_dense(xc, w, lp, lora_scale, sh),
                                 sh.model, -1)
    else:
        # replicated by the rule: b's gradient is partial on each rank
        if lp is not None:
            lp = {"a": lp["a"], "b": parallel.copy_to(lp["b"], sh.model)}
        zxbcdt = col_dense(xc, w, lp, lora_scale, sh)
    z, xbc, dt = _split_in_proj(zxbcdt, dims)

    def need(t, dim=-1):
        # the channels this rank reads: its heads' x, then B and C
        return torch.cat([t.narrow(dim, h0 * P, Hl * P),
                          t.narrow(dim, d_inner, C - d_inner)], dim=dim)

    new_cache = None
    if cache is not None:
        own = _own_channels(cache["conv"].shape[1], C, sh)
        act, conv_state = _conv_step(cache["conv"], xbc[..., own],
                                     p["conv_w"][own], p["conv_b"][own],
                                     x.dtype)                 # (B, Cl)
        if own != slice(0, C):
            act = parallel.gather(act, sh.model, -1)
        xbc_t = need(act)[:, None, :]                       # (B, 1, Cn)
        new_cache = {"conv": conv_state}
    else:
        xbc_t, _ = causal_conv(need(xbc), need(p["conv_w"], 0),
                               need(p["conv_b"]))
        xbc_t = F.silu(xbc_t.to(_F32)).to(x.dtype)
        if return_cache:
            own = _own_channels(C // M if C % M == 0 else C, C, sh)
            new_cache = {"conv": _conv_tail(xbc[..., own], W)}
    y, ssm = _heads(p, cfg, xbc_t, dt[..., h0:h0 + Hl], h0, Hl,
                    None if cache is None else cache["ssm"],
                    cache is not None)
    if new_cache is not None:
        new_cache["ssm"] = ssm
    y = y.to(x.dtype)
    z = z[..., cols]

    # the gated norm over the whole d_inner
    g = (y * F.silu(z.to(_F32)).to(y.dtype)).to(_F32)
    ss = (g * g).sum(dim=-1, keepdim=True)
    ss = parallel.copy_to(parallel.reduce_from(ss, sh.model), sh.model)
    y = (g * torch.rsqrt(ss / d_inner + cfg.rms_eps)
         * p["norm"][cols].to(_F32)).to(x.dtype)
    return (row_dense(y, p["out_proj"], lg.get("out_proj"), lora_scale, sh,
                      cfg.d_model), new_cache)
