"""Dirichlet client partitioning (paper §3.2); a numpy copy of
``repro/data/partition.py`` (the same seed gives the same shards).

Examples are distributed across N clients by drawing, for every latent task
cluster, a Dirichlet(α) vector over clients and routing that cluster's
examples accordingly.  α = 5 ⇒ near-uniform; α = 0.5 ⇒ heavily skewed —
matching the paper's heterogeneity settings.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .synthetic import Corpus


def dirichlet_partition(corpus: Corpus, num_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 2
                        ) -> List[Corpus]:
    rng = np.random.default_rng(seed)
    n_clusters = int(corpus.clusters.max()) + 1
    assignment = np.empty(len(corpus.tokens), np.int64)

    for c in range(n_clusters):
        idx = np.where(corpus.clusters == c)[0]
        rng.shuffle(idx)
        probs = rng.dirichlet(np.full(num_clients, alpha))
        counts = rng.multinomial(len(idx), probs)
        start = 0
        for client, cnt in enumerate(counts):
            assignment[idx[start:start + cnt]] = client
            start += cnt

    # guarantee a minimum shard size (a client with no data can't train):
    # repeatedly split off examples from the currently-largest donor.
    # ``floor`` caps the guarantee at what the corpus can actually support;
    # within that cap the loop always terminates with every client at or
    # above the floor: whenever some client is short, the largest other
    # shard must be strictly above the floor (otherwise the total would be
    # < num_clients * floor <= len(corpus)), so each iteration moves >= 1
    # example without pushing the donor below the floor.
    floor = min(min_per_client, len(assignment) // num_clients)
    for client in range(num_clients):
        while True:
            need = floor - int((assignment == client).sum())
            if need <= 0:
                break
            sizes = np.bincount(assignment,
                                minlength=num_clients).astype(np.int64)
            sizes[client] = -1
            donor = int(sizes.argmax())
            pool = np.where(assignment == donor)[0]
            give = min(need, len(pool) - floor)
            assert give >= 1, (client, donor, sizes)
            assignment[pool[:give]] = client
    counts = np.bincount(assignment, minlength=num_clients)
    assert counts.min() >= floor, (counts, floor)

    shards = []
    for client in range(num_clients):
        sl = np.where(assignment == client)[0]
        shards.append(Corpus(corpus.tokens[sl], corpus.labels[sl],
                             corpus.mask[sl], corpus.clusters[sl]))
    return shards


def heterogeneity_stats(shards: List[Corpus]) -> dict:
    """Per-client sizes and cluster histograms (clients x clusters)."""
    n_clusters = max(int(s.clusters.max(initial=0)) for s in shards) + 1
    hists = np.stack([np.bincount(s.clusters, minlength=n_clusters)
                      for s in shards])
    return {"sizes": [len(s.tokens) for s in shards],
            "cluster_hist": hists}
