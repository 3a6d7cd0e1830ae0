"""Seeded weights, adapter and rescalers of a configuration, made on the
device in a few large calls.

The tree has the layout the program's entry points take (``{"embed":
{"tokens"}, "blocks": {"pos0": ...}, "final_norm", "lm_head"}``, each
block leaf stacked over the layers); the plain reference reads the same
tensors by the same keys.  Every random leaf is a view into one flat
buffer in the served dtype, filled with N(0, 1) by a generator on the
device in chunks and then scaled leaf by leaf: dense weights by
``scale / sqrt(fan_in)`` (the router's scale is the configuration's
``router_scale``: the spread of its logits), the embedding and the head by
0.02.  Norm scales are ones.

The adapter is a FLAME global adapter at the configuration's rank on
every targeted weight (attention q/k/v/o, each routed expert's w1/w2/w3,
the shared experts' w1/w2/w3): ``a`` with sigma ``d_in**-0.5`` and ``b``
non-zero, sized so the adapter's term is ``b_rel`` of the base product's
rms.  Rescalers are one fp32 value a layer and tier around ``top_k / k``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 29          # elements of N(0, 1) drawn per call (2 GiB fp32)

Spec = Tuple[Tuple[str, ...], Tuple[int, ...], float]


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def check_supported(m: Dict) -> None:
    """The generator and the reference cover an attention stack with a
    routed MoE (and optional shared experts) in every layer."""
    if m.get("family") != "moe" or m.get("layer_pattern") or \
            m.get("moe_every", 1) != 1:
        raise ValueError(f"{m.get('name')}: only homogeneous attention + "
                         "MoE stacks are covered")


def base_specs(m: Dict, init: Dict = None
               ) -> Tuple[List[Spec], List[Tuple[Tuple[str, ...],
                                                 Tuple[int, ...]]]]:
    """(random leaves (path, shape, std), norm leaves (path, shape)).
    ``init`` (the configuration's ``init``): ``router_scale``, the router
    logits' standard deviation on a normalised hidden state;
    ``embed_std``, the embedding's; ``residual_scale``, the factor on the
    products that write the residual stream (attention's ``wo``, the
    experts' and shared block's ``w2``)."""
    init = init or {}
    router_scale = init.get("router_scale", 0.1)
    res = init.get("residual_scale", 1.0)
    check_supported(m)
    n, d, hd = m["num_layers"], m["d_model"], m["head_dim"]
    H, KV, E = m["n_heads"], m["n_kv_heads"], m["num_experts"]
    de, V = m["d_expert"], m["vocab_size"]
    blk = ("blocks", "pos0")
    rand: List[Spec] = [(("embed", "tokens"), (V, d),
                         init.get("embed_std", 0.02))]
    for name, shape in (("wq", (d, H * hd)), ("wk", (d, KV * hd)),
                        ("wv", (d, KV * hd)), ("wo", (H * hd, d))):
        rand.append((blk + ("attn", name), (n,) + shape,
                     (res if name == "wo" else 1.0) * shape[0] ** -0.5))
    rand.append((blk + ("moe", "router"), (n, d, E),
                 router_scale * d ** -0.5))
    for name, shape in (("w1", (d, de)), ("w3", (d, de)), ("w2", (de, d))):
        rand.append((blk + ("moe", "experts", name), (n, E) + shape,
                     (res if name == "w2" else 1.0) * shape[0] ** -0.5))
    if m["num_shared_experts"]:
        ds = m["d_shared_expert"]
        for name, shape in (("w1", (d, ds)), ("w3", (d, ds)),
                            ("w2", (ds, d))):
            rand.append((blk + ("moe", "shared", name), (n,) + shape,
                         (res if name == "w2" else 1.0) * shape[0] ** -0.5))
    rand.append((("lm_head",), (d, V), 0.02))
    ones = [(blk + ("mixer_norm",), (n, d)), (blk + ("ffn_norm",), (n, d)),
            (("final_norm",), (d,))]
    if m["qk_norm"]:
        ones += [(blk + ("attn", "q_norm"), (n, hd)),
                 (blk + ("attn", "k_norm"), (n, hd))]
    return rand, ones


def adapter_targets(m: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path of the adapted weight, its shape) for every LoRA target."""
    rand, _ = base_specs(m)
    keep = ("attn", "experts", "shared")
    return [(p, s) for p, s, _ in rand
            if len(p) > 2 and any(k in p for k in keep)
            and p[-1] in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")]


def _fill(specs: List[Spec], dtype, generator, device) -> Dict:
    total = sum(math.prod(s) for _, s, _ in specs)
    flat = torch.empty(total, dtype=dtype, device=device)
    for c0 in range(0, total, CHUNK):
        c1 = min(total, c0 + CHUNK)
        flat[c0:c1].copy_(torch.randn(c1 - c0, dtype=torch.float32,
                                      device=device, generator=generator))
    tree: dict = {}
    off = 0
    for path, shape, std in specs:
        size = math.prod(shape)
        leaf = flat[off:off + size].view(shape)
        leaf.mul_(std)
        _set(tree, path, leaf)
        off += size
    return tree


def make_params(m: Dict, seed: int, device, init: Dict = None) -> Dict:
    """The base weights of config ``m`` from ``seed``."""
    dtype = getattr(torch, m["dtype"])
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    rand, ones = base_specs(m, init)
    tree = _fill(rand, dtype, g, device)
    for path, shape in ones:
        _set(tree, path, torch.ones(shape, dtype=dtype, device=device))
    return tree


def make_adapter(m: Dict, seed: int, device, b_rel: float) -> Dict:
    """A global adapter ``{"blocks": {"pos0": ...}}`` from ``seed``."""
    dtype = getattr(torch, m["dtype"])
    r = m["lora_rank"]
    scale = m["lora_alpha"] / r
    b_std = b_rel / (scale * math.sqrt(r))
    specs: List[Spec] = []
    for path, shape in adapter_targets(m):
        lead, (d_in, d_out) = shape[:-2], shape[-2:]
        specs.append((path + ("a",), lead + (d_in, r), d_in ** -0.5))
        specs.append((path + ("b",), lead + (r, d_out), b_std))
    g = torch.Generator(device=device).manual_seed(
        (int(seed) + 1) % 2**63)
    return _fill(specs, dtype, g, device)


def make_rescalers(m: Dict, seed: int, ks: List[int], device,
                   rel: float = 0.1) -> Dict[int, Dict[str, torch.Tensor]]:
    """``{k: {"pos0": (num_layers,) fp32}}``: ``top_k / k`` times
    ``exp(rel * N(0, 1))`` per layer (a learned FLAME s_i's spread)."""
    g = torch.Generator(device="cpu").manual_seed((int(seed) + 2) % 2**63)
    out = {}
    for k in sorted(set(ks)):
        z = torch.randn(m["num_layers"], generator=g, dtype=torch.float64)
        out[k] = {"pos0": (m["top_k"] / k * torch.exp(rel * z)).to(
            torch.float32).to(device)}
    return out


def lora_scale(m: Dict) -> float:
    return m["lora_alpha"] / m["lora_rank"]
