"""Roofline terms of one step on one card, priced for the NVIDIA H100:
the port of ``repro/launch/roofline.py``.

Three terms, each in seconds per card and step:

  compute    = analytic FLOPs / PEAK_FLOPS
  memory     = analytic HBM bytes / HBM_BW
  collective = sum over the step's collective calls of
               bus bytes / the call's link rate

The FLOPs and bytes are ``launch/analytic.py``'s per-device models (the
reference's choice too: a count of executed ops misses nothing, but it
cannot tell useful work from recompute).  The FLOPs the step really
executes, counted by ``torch.utils.flop_counter.FlopCounterMode`` while
the dry run traces it, stand beside them: ``useful_frac = model_flops /
(traced_flops · cards)`` exposes recompute and redundant work.

The collective term replaces the reference's HLO parsing: the dry run
counts every call the step makes (``models/parallel.py``'s counters), with
the bytes each rank sends in, its kind and its group's ranks.  A call's
bytes are scaled by NCCL's bus factor for a group of n ranks (the data a
rank puts on its link in a ring: all-reduce 2(n-1)/n of the buffer,
all-gather (n-1) times the shard it sends, reduce-scatter (n-1)/n of the
buffer it reduces, all-to-all the (n-1)/n of its buffer bound for other
ranks) and charged at NVLink's rate when the group's ranks
sit on one node, at the network's when it spans nodes.

Constants (per card), NVIDIA H100 SXM5 data sheet and the HGX H100 /
DGX H100 networking: dense bf16 tensor-core peak 989 TFLOP/s (the
sheet's 1979 is with sparsity); HBM3 3.35 TB/s; NVLink 4 900 GB/s
bidirectional, 450 GB/s each way; one 400 Gb/s NDR InfiniBand port a
card, 50 GB/s; eight cards a node (an HGX H100 board).  Each is a module
attribute and every function that uses one takes it as an argument, so
another card's figures can be priced with the same code.  A card's
memory is what the launchers budget with (``steps.device_bytes``):
``torch.cuda.get_device_properties(0).total_memory`` of an "NVIDIA H100
80GB HBM3" (torch 2.11, CUDA 12.8), 85,017,493,504 B (79.18 GiB), not
the data sheet's 80 GB.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
CARD_MEMORY_BYTES = 85_017_493_504   # total_memory as torch reports it
NVLINK_BW = 450e9            # bytes/s each way, a group inside one node
NET_BW = 50e9                # bytes/s, 400 Gb/s NDR: a group across nodes
CARDS_PER_NODE = 8           # an HGX H100 board


def bus_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes one rank moves over its link for a call on a group of ``n``
    ranks that sends ``nbytes`` in (NCCL's bus factor)."""
    if n <= 1:
        return 0.0
    if kind == "all_reduce":
        return nbytes * 2.0 * (n - 1) / n
    if kind == "all_gather":
        return nbytes * (n - 1)
    if kind in ("reduce_scatter", "all_to_all"):
        return nbytes * (n - 1) / n
    raise ValueError(f"unknown collective kind {kind!r}")


def spans_nodes(ranks: Iterable[int], cards_per_node: int) -> bool:
    """Whether a group's ranks sit on more than one node (ranks numbered
    node by node, ``cards_per_node`` to a node)."""
    return len({r // cards_per_node for r in ranks}) > 1


def collective_terms(calls, cards_per_node: int,
                     nvlink_bw: float = NVLINK_BW,
                     net_bw: float = NET_BW) -> Dict[str, float]:
    """The collective term of ``calls``
    (``parallel.comm_stop(log=True)["log"]``): {"seconds", "bus_bytes",
    "bus_bytes_nvlink", "bus_bytes_network"}."""
    out = {"seconds": 0.0, "bus_bytes": 0.0, "bus_bytes_nvlink": 0.0,
           "bus_bytes_network": 0.0}
    for c in calls:
        b = bus_bytes(c["kind"], c["bytes"], len(c["ranks"]))
        if spans_nodes(c["ranks"], cards_per_node):
            out["bus_bytes_network"] += b
            out["seconds"] += b / net_bw
        else:
            out["bus_bytes_nvlink"] += b
            out["seconds"] += b / nvlink_bw
        out["bus_bytes"] += b
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    device_flops: float          # analytic, per card
    traced_flops: float          # FlopCounterMode, per card (rank 0)
    device_bytes: float          # analytic HBM traffic, per card
    collective_s: float          # ``collective_terms()["seconds"]``
    collective_bytes: float      # their bus bytes
    model_flops: float           # global
    bytes_per_device: float      # the dry run's memory estimate (peak_gb)
    collectives: Dict[str, int]
    meta: Dict[str, Any]
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW

    # ---- the three terms (seconds, per card) ----
    @property
    def t_compute(self) -> float:
        return self.device_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.device_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (traced FLOPs · cards): the useful share of the
        compute the step executes (catches remat and redundant work)."""
        return self.model_flops / max(self.traced_flops * self.chips, 1.0)

    @property
    def step_time(self) -> float:
        """The roofline's step time: the largest term (the other two
        assumed hidden under it)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilisation at the roofline's step time."""
        return (self.model_flops /
                (self.step_time * self.chips * self.peak_flops)
                if self.step_time else 0.0)

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "device_gflops": self.device_flops / 1e9,
            "traced_gflops": self.traced_flops / 1e9,
            "device_gbytes": self.device_bytes / 1e9,
            "coll_gbytes": self.collective_bytes / 1e9,
            "model_gflops": self.model_flops / 1e9,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "bottleneck": self.bottleneck,
            "useful_frac": self.useful_fraction,
            "mfu": self.mfu,
            "hbm_gb_per_device": self.bytes_per_device / 2 ** 30,
            **{f"n_{k}": v for k, v in self.collectives.items()},
        }


def extract(*, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, device_flops: float, device_bytes: float,
            traced_flops: float, calls, cards_per_node: int,
            bytes_per_device: float, meta: Optional[Dict[str, Any]] = None,
            peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
            nvlink_bw: float = NVLINK_BW,
            net_bw: float = NET_BW) -> Roofline:
    """A :class:`Roofline` from the analytic terms, the traced FLOPs and
    the counted calls (``parallel.comm_stop(log=True)["log"]``)."""
    coll = collective_terms(calls, cards_per_node, nvlink_bw, net_bw)
    counts: Dict[str, int] = {}
    for c in calls:
        counts[c["kind"]] = counts.get(c["kind"], 0) + 1
    meta = dict(meta or {})
    meta.update(bus_bytes_nvlink=coll["bus_bytes_nvlink"],
                bus_bytes_network=coll["bus_bytes_network"],
                cards_per_node=cards_per_node)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        device_flops=device_flops, traced_flops=traced_flops,
        device_bytes=device_bytes, collective_s=coll["seconds"],
        collective_bytes=coll["bus_bytes"], model_flops=model_flops,
        bytes_per_device=bytes_per_device, collectives=counts, meta=meta,
        peak_flops=peak_flops, hbm_bw=hbm_bw)
