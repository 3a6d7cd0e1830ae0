"""The one general traffic generator: it reads a mix's parameters (a file
under ``portbench/traffic/``, with the cell's own overrides from
``portbench/cells/``) and a seed, and makes the inputs of one run.  numpy
only.

Sizes are stratified: a run of ``n`` requests takes the ``n`` mid-point
quantiles ``(i + 0.5) / n`` of each distribution (inter-arrival gaps,
prompt lengths, output lengths) and an equal share of each tier, in one
order for every seed; the seed draws the token ids.  So every seed offers
the same work at the same arrivals, and the time a window takes to drain
its last requests does not depend on the seed.  This is ``make_trace`` of
``repro_torch.serving.workload`` (Poisson gaps, Zipf output lengths, a
tier mix) with a prompt-length distribution added and its draws replaced
by quantiles: log-uniform prompt lengths, ``output_min - 1 + Zipf``
output lengths, Poisson gaps.

``fl_corpus`` makes the federated clients' shards: an instruction-tuning
layout (BOS, prompt, SEP, response, EOS; loss on the response), each of
``n_clusters`` latent tasks a peaked first-order Markov chain over the
data vocabulary, each client's task mix drawn from Dirichlet(alpha), and
every client holding the same number of examples.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

BOS, SEP, EOS, FIRST_CONTENT = 0, 1, 2, 3


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream per (seed, purpose)."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def _mid_quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def zipf_quantiles(n: int, alpha: float, lo: int, cap: int) -> np.ndarray:
    """Quantiles of ``lo - 1 + Zipf(alpha)`` clipped to ``cap``."""
    ks = np.arange(1, cap - lo + 2, dtype=np.float64)
    pmf = ks ** -alpha
    tail = 200_000
    pmf /= (np.sum(np.arange(1.0, tail) ** -alpha)
            + 1.0 / ((alpha - 1) * tail ** (alpha - 1)))     # zeta(alpha)
    cdf = np.cumsum(pmf)
    idx = np.searchsorted(cdf, _mid_quantiles(n), side="left")
    return np.minimum(lo - 1 + ks[np.minimum(idx, len(ks) - 1)].astype(
        np.int64), cap)


def serve_trace(mix: Dict, seed: int, seconds: float,
                tier_k: List[int]) -> List[Dict]:
    """Open-loop requests arriving over ``[0, seconds)`` at ``mix["rate_rps"]``.

    Returns dicts ``rid, arrival (s), prompt (int32), max_new, k``; tier
    ``i`` of ``tier_k`` gets an equal share of the requests."""
    rate = float(mix["rate_rps"])
    n = max(len(tier_k), int(round(rate * seconds)))
    u = _mid_quantiles(n)
    # one order of gaps, lengths and tiers for every seed: seeds differ by
    # content alone
    rng = rng_for(0, 1)
    gaps = rng.permutation(-np.log1p(-u) / rate)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    arrivals *= seconds * (n - 1) / n / max(arrivals[-1], 1e-12)
    lo, hi = mix["prompt_len_min"], mix["prompt_len_max"]
    lens = rng.permutation(np.rint(np.exp(
        math.log(lo) + u * (math.log(hi) - math.log(lo)))).astype(np.int64))
    outs = rng.permutation(zipf_quantiles(
        n, mix["zipf_alpha"], mix["output_min"], mix["output_max"]))
    tiers = rng.permutation(np.arange(n) % len(tier_k))
    vocab = mix["data_vocab"]
    tok_rng = rng_for(seed, 5)
    out = []
    for i in range(n):
        out.append({"rid": i, "arrival": float(arrivals[i]),
                    "prompt": tok_rng.integers(0, vocab, int(lens[i]),
                                               dtype=np.int64).astype(
                                                   np.int32),
                    "max_new": int(outs[i]), "k": int(tier_k[tiers[i]])})
    return out


def _chains(rng, trans_cdf, cluster, start, length) -> np.ndarray:
    """Markov chains for many examples at once: (n, length) content ids."""
    n = len(cluster)
    out = np.empty((n, length), np.int64)
    cur = start
    for i in range(length):
        u = rng.random(n)
        cur = (trans_cdf[cluster, cur] < u[:, None]).sum(axis=1)
        cur = np.minimum(cur, trans_cdf.shape[-1] - 1)
        out[:, i] = cur
    return out


def fl_corpus(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """Per-client shards ``{tokens, labels, mask, clusters}``: ``clients``
    shards of ``examples_per_client`` sequences of ``seq_len`` tokens."""
    rng = rng_for(seed, 2)
    n_clients, per = mix["clients"], mix["examples_per_client"]
    S, P = mix["seq_len"], mix["prompt_len"]
    content = mix["data_vocab"] - FIRST_CONTENT
    nc = mix["n_clusters"]
    logits = rng.normal(size=(nc, content, content))
    for c in range(nc):
        logits[c, np.arange(content), rng.permutation(content)] += mix["peak"]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    trans_cdf = np.cumsum(p / p.sum(-1, keepdims=True), axis=-1)
    mixes = rng.dirichlet([mix["dirichlet_alpha"]] * nc, size=n_clients)
    clusters = np.concatenate([rng.choice(nc, per, p=m) for m in mixes])
    starts = rng.integers(0, content, len(clusters))
    resp_len = S - P - 3
    prompt = _chains(rng, trans_cdf, clusters, starts, P)
    resp = _chains(rng, trans_cdf, clusters, prompt[:, -1], resp_len)
    n = len(clusters)
    toks = np.concatenate([np.full((n, 1), BOS - FIRST_CONTENT), prompt,
                           np.full((n, 1), SEP - FIRST_CONTENT), resp,
                           np.full((n, 1), EOS - FIRST_CONTENT)], axis=1)
    toks = (toks + FIRST_CONTENT).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = EOS
    mask = np.zeros((n, S), np.float32)
    mask[:, P + 1:S - 1] = 1.0
    return [{"tokens": toks[i * per:(i + 1) * per],
             "labels": labels[i * per:(i + 1) * per],
             "mask": mask[i * per:(i + 1) * per],
             "clusters": clusters[i * per:(i + 1) * per].astype(np.int32)}
            for i in range(n_clients)]


def budget_k(top_k: int, grid: Dict[str, int], tier: str) -> int:
    """A tier's expert budget: the paper's k grid scaled into ``top_k``
    (the rule of ``repro_torch.federated.simulation``)."""
    return max(1, round(top_k * grid[tier] / grid["b1"]))
