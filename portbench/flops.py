"""Model operations of the configurations' steps, counted from their
sizes: the numerators of ``mfu``.

A matrix product of ``d_in -> d_out`` is ``2 d_in d_out`` operations a
row; an adapter adds ``2 r (d_in + d_out)``; causal attention over ``n``
keys is ``4 H hd n`` a query (scores and values).  A training step of
the federated client counts the forward at the client's ``k``, the
activation gradients through the frozen base (one more pass of every base
product, two of attention's), and the adapter's and the router's
gradients; the frozen weights get no gradient and recomputation is not
counted.  Serving counts each request's prompt at its ``k`` (the head once,
for the first token) and each decoded token at its ``k`` over the context
it attends.
"""
from __future__ import annotations

from typing import Dict


def _lin(d_in: int, d_out: int, r: int) -> tuple:
    """(base, adapter) operations of one adapted product, a row."""
    return 2 * d_in * d_out, 2 * r * (d_in + d_out)


def layer_parts(m: Dict, k: int) -> Dict[str, float]:
    """Per-token forward operations of one layer outside attention's
    scores, split into base products, adapter products and the router."""
    d, hd, r = m["d_model"], m["head_dim"], m["lora_rank"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    base = lora = 0.0
    for d_in, d_out in ((d, H * hd), (d, KV * hd), (d, KV * hd),
                        (H * hd, d)):
        b, a = _lin(d_in, d_out, r)
        base, lora = base + b, lora + a
    de = m["d_expert"]
    for d_in, d_out in ((d, de), (d, de), (de, d)):
        b, a = _lin(d_in, d_out, r)
        base, lora = base + k * b, lora + k * a
    if m["num_shared_experts"]:
        ds = m["d_shared_expert"]
        for d_in, d_out in ((d, ds), (d, ds), (ds, d)):
            b, a = _lin(d_in, d_out, r)
            base, lora = base + b, lora + a
    return {"base": base, "lora": lora, "router": 2.0 * d * m["num_experts"]}


def attn_core(m: Dict, keys: float) -> float:
    """Scores and values of one query over ``keys`` keys, all layers."""
    return 4.0 * m["n_heads"] * m["head_dim"] * keys * m["num_layers"]


def train_step(m: Dict, B: int, S: int, k: int) -> float:
    """One client step on B rows of S tokens at budget k."""
    p = layer_parts(m, k)
    L, T = m["num_layers"], B * S
    head = 2.0 * m["d_model"] * m["vocab_size"]
    mean_keys = (S + 1) / 2.0
    fwd = T * (L * (p["base"] + p["lora"] + p["router"]) + head) \
        + T * attn_core(m, mean_keys)
    bwd = T * (L * (p["base"] + 2 * p["lora"] + p["router"]) + head) \
        + 2 * T * attn_core(m, mean_keys)
    return fwd + bwd


def serve_request(m: Dict, prompt_len: int, generated: int, k: int) -> float:
    """A request's prefill of ``prompt_len`` tokens and its
    ``generated - 1`` decode steps, at budget k."""
    p = layer_parts(m, k)
    L = m["num_layers"]
    per_tok = L * (p["base"] + p["lora"] + p["router"])
    head = 2.0 * m["d_model"] * m["vocab_size"]
    P = prompt_len
    prefill = P * per_tok + attn_core(m, (P + 1) / 2.0) * P + head
    n_dec = max(generated - 1, 0)
    # decode token j (0-based) sits at position P + j and attends P + j + 1
    dec_keys = n_dec * (P + 1) + n_dec * (n_dec - 1) / 2.0
    decode = n_dec * (per_tok + head) + attn_core(m, 1.0) * dec_keys
    return prefill + decode
