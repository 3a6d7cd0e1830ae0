"""Cohort construction for the batched round engine (port of
``repro/federated/cohort.py``).

A cohort is a shape-homogeneous group of a round's participants: the same
expert budget ``k_i``, the same distributed adapter rank (leaf shapes),
the same rescaler presence and mode, and the same step batch size.  All of
these follow from the client's β budget tier and its shard size, so
cohorts are in effect budget groups, and each trains through one
``client.cohort_update`` call on stacked inputs.

The key uses the *distributed* adapter rank, not the client's nominal
one: the "trivial" baseline distributes the globally smallest rank to
everyone, so all its clients land in one cohort.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..configs.base import TrainConfig
from . import client as client_lib

CohortKey = Tuple[int, int, int, bool, str]


def cohort_key(c: client_lib.ClientState, tc: TrainConfig,
               dist_rank: int) -> CohortKey:
    """Shape-homogeneity key: (k_i, distributed rank, step batch size,
    rescaler presence, rescaler mode)."""
    return (c.k, dist_rank, client_lib.plan_batch_size(c, tc),
            c.rescaler is not None, c.rescaler_mode)


@dataclass
class Cohort:
    """One shape-homogeneous group within a round's participants."""
    key: CohortKey
    members: List[int]            # indices into the round's participant list

    @property
    def k(self) -> int:
        return self.key[0]

    @property
    def rank(self) -> int:
        return self.key[1]


OrderedGroups = Tuple[List[CohortKey], dict]


def group_by_key(clients: Sequence[client_lib.ClientState],
                 tc: TrainConfig,
                 rank_of: Optional[Callable[[client_lib.ClientState], int]]
                 = None) -> OrderedGroups:
    """Partition clients by cohort key, keeping first-appearance order.
    Returns ``(key_order, members)``, ``members[key]`` listing indices into
    ``clients``."""
    rank_of = rank_of or (lambda c: c.rank)
    order: List[CohortKey] = []
    members: dict = {}
    for i, c in enumerate(clients):
        key = cohort_key(c, tc, rank_of(c))
        if key not in members:
            members[key] = []
            order.append(key)
        members[key].append(i)
    return order, members


def build_cohorts(clients: Sequence[client_lib.ClientState],
                  tc: TrainConfig,
                  rank_of: Optional[Callable[[client_lib.ClientState], int]]
                  = None) -> List[Cohort]:
    """Group a round's participants into cohorts, in first-appearance
    order; every participant lands in exactly one.  ``rank_of`` maps a
    client to the rank of the adapter the server distributes to it
    (method-dependent; default the client's own rank)."""
    order, members = group_by_key(clients, tc, rank_of)
    return [Cohort(key=k, members=members[k]) for k in order]
