"""Adaptive-k serving of the port: continuous batching over a block-paged
KV pool (``kv_cache``), tier-aware admission (``scheduler``), synthetic
traces (``workload``), greedy token selection (``sampler``) and the engine
loop (``engine``)."""
from .engine import ServingEngine, ServingReport  # noqa: F401
from .kv_cache import BlockPool  # noqa: F401
from .sampler import SamplerConfig  # noqa: F401
from .scheduler import Completion, Request, Scheduler  # noqa: F401
from .workload import WorkloadConfig, make_trace, percentile  # noqa: F401
