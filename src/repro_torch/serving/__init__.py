"""Adaptive-k serving of the port: continuous batching over a block-paged
or slotted KV pool (``kv_cache``), tier-aware admission (``scheduler``),
synthetic traces (``workload``), greedy and sampled token selection with
explicit counter-based randomness (``sampler``), self-speculative
decoding (``speculative``) and the engine loop (``engine``)."""
from .engine import ServingEngine, ServingReport  # noqa: F401
from .kv_cache import BlockPool, SlotPool  # noqa: F401
from .sampler import SamplerConfig  # noqa: F401
from .scheduler import Completion, Request, Scheduler  # noqa: F401
from .speculative import SpeculativeConfig  # noqa: F401
from .workload import WorkloadConfig, make_trace, percentile  # noqa: F401
