"""Plain PyTorch reference of the configurations' model: a decoder of
attention blocks, each followed by a routed mixture of experts (and, where
the configuration has them, always-active shared experts), with the FLAME
adapter and rescaler.  It reads the configuration's JSON and the
benchmark's weight tree, and imports nothing of the program.

Equations (as the repository defines the model; see ``departures`` in each
configuration file for where that differs from the published checkpoint):

* block: ``x += Attn(RMSNorm(x)); x += MoE(RMSNorm(x))``; RMSNorm is
  ``x * rsqrt(mean(x^2) + eps) * g``;
* attention: ``q, k, v = x Wq, x Wk, x Wv`` (each ``+ (x A) B * alpha/r``),
  per-head RMSNorm of q and k where ``qk_norm``, rotary embedding on the
  two halves of each head (``theta``), causal softmax at ``head_dim**-0.5``,
  output ``o Wo`` (+ its adapter);
* MoE: router logits ``x Wr``; softmax over all experts; the top ``k`` by
  probability, their probabilities renormalised to sum to one; expert
  ``e``'s SwiGLU ``(silu(x W1_e) * x W3_e) W2_e`` (each product with the
  expert's adapter); the weighted sum times the rescaler ``s``; plus the
  shared experts' SwiGLU;
* training dispatch is GShard's: ``C = max(8, 8 * ceil((int(T k cf / E)
  + 1) / 8))`` slots an expert for the ``T`` tokens of a step, tokens
  taken in order, a token past an expert's ``C`` losing that expert's
  term; serving keeps every assignment;
* loss: mean cross-entropy over the positions the mask keeps.

``routes`` makes the reference follow the program's own expert selection,
layer by layer (bf16 rounding flips a top-k at near-ties, and a flipped
expert changes the rest of the stack, so an fp32 stack that chose its own
experts would compare the flips).  The selection itself is then checked
by the distance of the program's lowest chosen logit below the k-th best
of these logits, in units of the token's logit spread (``route_gaps``).

All arithmetic is float32 with TF32 off.  ``precision="fp8"`` is the
control, the hybrid recipe of float8 training and serving: every matrix
product's operands (weights, activations, q, k, v and attention
probabilities) pass through float8 e4m3 with one scale per operand, and in
the backward pass each product's output gradient through e5m2 (the
products' own outputs stay float32).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

F32 = torch.float32
FP8_MAX = 448.0
E5M2_MAX = 57344.0


def set_exact_fp32() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` through float8 ``dtype`` with one scale (its amax at ``top``)."""
    s = t.abs().amax().clamp_min(1e-30) / top
    return (t / s).to(dtype).to(F32) * s


class _FP8(torch.autograd.Function):
    """A product's operand in float8 e4m3; its gradient passes as it is (the
    product that formed it took its output gradient in e5m2)."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradFP8(torch.autograd.Function):
    """Identity forward; a product's output gradient in e5m2 backward."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


class Ref:
    """The reference model of config ``m`` over weight tree ``params``."""

    def __init__(self, m: Dict, params: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.m = m
        self.p = params
        self.prec = precision
        self.scale = m["lora_alpha"] / m["lora_rank"]
        self.route_gaps: list = []
        self.last_routes: list = []

    # ------------------------------------------------------------ products
    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(F32)
        return _FP8.apply(t) if self.prec == "fp8" else t

    def g(self, y: torch.Tensor) -> torch.Tensor:
        return _GradFP8.apply(y) if self.prec == "fp8" else y

    def mm(self, x, w):
        return self.g(self.q(x) @ self.q(w))

    def lin(self, x, w, lp: Optional[Dict]):
        y = self.mm(x, w)
        if lp is not None:
            y = y + self.mm(self.mm(x, lp["a"]), lp["b"]) * self.scale
        return y

    def bmm(self, x, w, lp: Optional[Dict]):
        y = self.g(torch.bmm(self.q(x), self.q(w)))
        if lp is not None:
            xa = self.g(torch.bmm(self.q(x), self.q(lp["a"])))
            y = y + self.g(torch.bmm(self.q(xa), self.q(lp["b"]))) \
                * self.scale
        return y

    # ------------------------------------------------------------- pieces
    def norm(self, x, g):
        x = x.to(F32)
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.m["rms_eps"]) * g.to(F32)

    def rope(self, x, positions):
        hd = x.shape[-1]
        freqs = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd))
        ang = positions.to(F32)[:, None] * freqs             # (S, hd/2)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, x, w, lora, positions, q_block: int = 512):
        m = self.m
        B, S, _ = x.shape
        H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        lg = lora or {}
        q = self.lin(x, w["wq"], lg.get("wq")).view(B, S, H, hd)
        k = self.lin(x, w["wk"], lg.get("wk")).view(B, S, KV, hd)
        v = self.lin(x, w["wv"], lg.get("wv")).view(B, S, KV, hd)
        if m["qk_norm"]:
            q, k = self.norm(q, w["q_norm"]), self.norm(k, w["k_norm"])
        q, k = self.rope(q, positions), self.rope(k, positions)
        rep = H // KV
        q = self.q(q).transpose(1, 2)                         # (B,H,S,hd)
        k = self.q(k).repeat_interleave(rep, 2).transpose(1, 2)
        v = self.q(v).repeat_interleave(rep, 2).transpose(1, 2)
        outs = []
        kpos = torch.arange(S, device=x.device)
        for q0 in range(0, S, q_block):
            qb = q[:, :, q0:q0 + q_block]
            s = self.g(qb @ k.transpose(-1, -2)) * hd ** -0.5
            qpos = kpos[q0:q0 + q_block, None]
            s = s.masked_fill(kpos[None, :] > qpos, float("-inf"))
            outs.append(self.g(self.q(torch.softmax(s, dim=-1)) @ v))
        o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)
        return self.lin(o, w["wo"], lg.get("wo"))

    def swiglu(self, x, w, lora):
        lg = lora or {}
        h = F.silu(self.lin(x, w["w1"], lg.get("w1"))) * \
            self.lin(x, w["w3"], lg.get("w3"))
        return self.lin(h, w["w2"], lg.get("w2"))

    def route(self, x2d, w_router, k_tok: torch.Tensor, forced=None):
        """(weights (T, E), mask (T, E)) for per-token budgets ``k_tok``.
        ``forced``: a (T, E) selection to take instead of the top-k (the
        program's own, followed step by step); its distance from the top-k
        of these logits goes to ``route_gaps``."""
        logits = self.mm(x2d, w_router)
        probs = torch.softmax(logits, dim=-1)
        E = probs.shape[-1]
        kmax = int(k_tok.max())
        srt = torch.sort(logits.detach(), dim=-1, descending=True,
                         stable=True)
        if forced is None:
            take = (torch.arange(kmax, device=x2d.device)[None, :]
                    < k_tok[:, None]).to(F32)
            mask = torch.zeros_like(probs).scatter_(
                1, srt.indices[:, :kmax], take)
        else:
            mask = forced.to(F32)
            lf = logits.detach()
            kth = srt.values.gather(1, (k_tok.clamp_min(1) - 1)[:, None])
            low = torch.where(mask > 0, lf, torch.full_like(lf, float("inf")))
            gap = (kth[:, 0] - low.min(-1).values).clamp_min(0) \
                / lf.std(-1).clamp_min(1e-30)
            gap = torch.where(k_tok > 0, gap, torch.zeros_like(gap))
            self.route_gaps.append(float(gap.max()))
        wts = probs * mask
        return wts / wts.sum(-1, keepdim=True).clamp_min(1e-9), mask, E

    def moe(self, x2d, w, lora, k_tok, rescaler, capacity: bool,
            forced=None):
        """x2d (T, D) -> (out (T, D), counts (E,), selection (T, E))."""
        m = self.m
        wts, mask, E = self.route(x2d, w["router"], k_tok, forced)
        counts = mask.sum(0)
        if capacity:
            n_assign = int(k_tok.sum())
            c = int(n_assign * m["capacity_factor"] / E) + 1
            C = max(8, ((c + 7) // 8) * 8)
            pos = torch.cumsum(mask, 0) - 1.0
            keep = (mask > 0) & (pos < C)
        else:
            pos = torch.cumsum(mask, 0) - 1.0
            keep = mask > 0
            C = int(counts.max())
        t_idx, e_idx = keep.nonzero(as_tuple=True)
        p_idx = pos[t_idx, e_idx].long()
        slots = x2d.new_zeros((E, max(C, 1), x2d.shape[1]))
        slots = slots.index_put((e_idx, p_idx), x2d[t_idx])
        le = (lora or {}).get("experts") or {}
        ex = w["experts"]
        h = F.silu(self.bmm(slots, ex["w1"], le.get("w1"))) * \
            self.bmm(slots, ex["w3"], le.get("w3"))
        y = self.bmm(h, ex["w2"], le.get("w2"))
        contrib = y[e_idx, p_idx] * wts[t_idx, e_idx][:, None]
        out = x2d.new_zeros(x2d.shape).index_add(0, t_idx, contrib)
        if rescaler is not None:
            out = out * rescaler
        if "shared" in w:
            out = out + self.swiglu(x2d, w["shared"],
                                    (lora or {}).get("shared"))
        return out, counts, mask

    # ------------------------------------------------------------- stack
    def layer(self, i, x, lora, rescaler, k_tok, positions, capacity,
              forced=None):
        blk = self.p["blocks"]["pos0"]
        w = _index(blk, i)
        lb = _index(lora["blocks"]["pos0"], i) if lora else {}
        B, S, D = x.shape
        h = self.attention(self.norm(x, w["mixer_norm"]), w["attn"],
                           lb.get("attn"), positions)
        x = x + h
        r = None if rescaler is None else rescaler[i]
        if r is not None and r.dim() == 1:
            r = r.repeat_interleave(S)[:, None]
        h2, counts, mask = self.moe(
            self.norm(x, w["ffn_norm"]).reshape(B * S, D), w["moe"],
            lb.get("moe"), k_tok, r, capacity, forced)
        return x + h2.reshape(B, S, D), counts, mask.detach() > 0

    def hidden(self, tokens, *, lora=None, rescaler=None, k=None,
               capacity: bool, remat: bool = False, routes=None):
        """tokens (B, S) -> (final-normed hidden (B, S, D) fp32, counts
        (num_layers, E)).  ``k``: an int, or one budget per row;
        ``rescaler``: (num_layers,) or (num_layers, B); ``routes``: one
        (B*S, E) selection per layer to follow instead of the top-k.  The
        selections made are left in ``last_routes``."""
        B, S = tokens.shape
        dev = tokens.device
        x = self.p["embed"]["tokens"][tokens.long()].to(F32)
        positions = torch.arange(S, device=dev)
        kk = torch.as_tensor(k if k is not None else self.m["top_k"],
                             device=dev)
        k_tok = (kk.expand(B) if kk.dim() == 0 else kk).repeat_interleave(S)
        counts, self.last_routes = [], []
        for i in range(self.m["num_layers"]):
            args = (i, x, lora, rescaler, k_tok, positions, capacity,
                    None if routes is None else routes[i])
            if remat:
                x, c, sel = torch.utils.checkpoint.checkpoint(
                    self.layer, *args, use_reentrant=False)
            else:
                x, c, sel = self.layer(*args)
            counts.append(c.detach())
            self.last_routes.append(sel)
        return self.norm(x, self.p["final_norm"]), torch.stack(counts)

    def logits(self, h):
        return self.mm(h, self.p["lm_head"])

    def loss(self, h, labels, mask, chunk: int = 1024):
        """Mean cross-entropy over the masked positions, in row chunks."""
        B, S, D = h.shape
        hf, lf = h.reshape(B * S, D), labels.reshape(-1).long()
        mf = mask.reshape(-1).to(F32)

        def part(hc, lc, mc):
            return (F.cross_entropy(self.logits(hc), lc, reduction="none")
                    * mc).sum()

        tot = h.new_zeros(())
        for c0 in range(0, B * S, chunk):
            sl = slice(c0, c0 + chunk)
            tot = tot + torch.utils.checkpoint.checkpoint(
                part, hf[sl], lf[sl], mf[sl], use_reentrant=False)
        return tot / mf.sum().clamp_min(1.0)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
