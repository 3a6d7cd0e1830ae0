"""Token selection for the serving engine (port of
``repro/serving/sampler.py``, greedy only).

The reference's sampled kinds (``temperature``, ``top_p``) draw from
``jax.random`` streams that PyTorch cannot reproduce, so they come with a
later slice that tests them in distribution; asking for one raises.
"""
from __future__ import annotations

from dataclasses import dataclass

KINDS = ("greedy", "temperature", "top_p")


@dataclass(frozen=True)
class SamplerConfig:
    """``greedy``: argmax, the first maximal token winning ties."""
    kind: str = "greedy"
    temperature: float = 1.0
    top_p: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"sampler kind {self.kind!r} not in {KINDS}")
        if self.kind != "greedy":
            raise NotImplementedError(
                f"sampler kind {self.kind!r}: sampled decoding comes with the "
                "serving-extras slice of the port (greedy only for now)")
