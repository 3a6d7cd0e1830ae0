"""Token selection for the serving engine (port of
``repro/serving/sampler.py``).

Three kinds, one frozen :class:`SamplerConfig` for plain decoding and the
speculative rejection rule alike (which is what keeps the two paths equal
in distribution):

* ``greedy`` — argmax, expressed by :func:`sampler_probs` as a one-hot
  distribution, so the rejection rule degenerates to exact-match
  acceptance;
* ``temperature`` — softmax of ``logits / temperature``;
* ``top_p`` — nucleus sampling: the temperature softmax, then the
  smallest prefix of the probability-sorted tokens whose mass reaches
  ``top_p`` (a token is kept iff the mass strictly before it is below
  ``top_p``; ties in stable-sort order), renormalised.

Randomness is explicit and counter-based.  The reference folds (seed,
request id, event counter) into a ``jax.random`` key, a stream PyTorch
cannot reproduce; here :func:`event_uniforms` draws uniforms from numpy's
Philox with key (seed, request id) and the event counter in the second
counter word, so a draw depends only on those three numbers — never on
the slot, the KV layout or what shares the batch — and the draws of one
event never overlap another's.  :func:`sample_from_probs` then turns one
uniform per row into a token by inverse CDF, on whatever device the
probabilities live.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

KINDS = ("greedy", "temperature", "top_p")


@dataclass(frozen=True)
class SamplerConfig:
    """Token-selection policy: ``greedy`` argmax, ``temperature`` softmax,
    or ``top_p`` nucleus (the temperature applies before the cut)."""
    kind: str = "greedy"
    temperature: float = 1.0
    top_p: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"sampler kind {self.kind!r} not in {KINDS}")
        if self.kind != "greedy" and not self.temperature > 0.0:
            raise ValueError(
                f"temperature must be > 0, got {self.temperature} "
                "(temperature -> 0 converges to greedy; use kind='greedy')")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def sampler_probs(logits: torch.Tensor, sc: SamplerConfig) -> torch.Tensor:
    """logits (..., V) -> the sampler's token distribution (..., V), fp32:
    the one source of truth for plain sampling and the rejection rule."""
    logits = logits.float()
    if sc.kind == "greedy":
        # one-hot at the first maximal logit
        idx = torch.argmax(logits, dim=-1, keepdim=True)
        return torch.zeros_like(logits).scatter_(-1, idx, 1.0)
    probs = torch.softmax(logits / sc.temperature, dim=-1)
    if sc.kind == "temperature" or sc.top_p >= 1.0:
        return probs
    ps, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    before = torch.cumsum(ps, dim=-1) - ps
    ps = torch.where(before < sc.top_p, ps, torch.zeros_like(ps))
    ps = ps / ps.sum(dim=-1, keepdim=True)
    return torch.zeros_like(ps).scatter_(-1, order, ps)


def sample_from_probs(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per leading row of ``probs`` (..., V) from the uniforms
    ``u`` (...) in [0, 1): the first token whose cumulative mass exceeds
    ``u`` times the total (float64).  A zero-probability token is never
    drawn, so a one-hot distribution gives its argmax for any ``u``."""
    cdf = torch.cumsum(probs.double(), dim=-1)
    target = u.to(cdf.device, torch.float64)[..., None] * cdf[..., -1:]
    tok = torch.searchsorted(cdf, target.contiguous(), right=True)[..., 0]
    return torch.clamp(tok, max=probs.shape[-1] - 1)


def sample_token(logits: torch.Tensor, u: torch.Tensor,
                 sc: SamplerConfig) -> torch.Tensor:
    """Draw one token per row from ``sampler_probs(logits, sc)``."""
    if sc.kind == "greedy":
        return torch.argmax(logits, dim=-1)
    return sample_from_probs(sampler_probs(logits, sc), u)


def event_uniforms(seed: int, rid: int, event: int, n: int = 1) -> np.ndarray:
    """``n`` float64 uniforms in [0, 1) for one sampling event of request
    ``rid``: Philox keyed by (seed, rid), counter (0, event, 0, 0)."""
    bits = np.random.Philox(key=np.array([seed, rid], np.uint64),
                            counter=np.array([0, event, 0, 0], np.uint64))
    return np.random.Generator(bits).random(n)
