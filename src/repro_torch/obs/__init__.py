"""Observability of the port: the span tracer (Chrome trace-event JSON of
the serving engine's request lifecycle, the federated rounds and the
port's layers, on ``torch.profiler``'s clock, with the process-wide
session a profiler window opens: ``active``, ``use``, ``current``,
``last_session``), the
metrics registry (the serving report's histograms, the engine's and the
round's counters and gauges) and expert-load / activation-drift
telemetry."""
from .expert_load import (ActivationDriftTracker, ExpertLoadTracker,
                          entropy, gini)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, exp_buckets
from .trace import (NULL_TRACER, Tracer, active, current, last_session,
                    use, validate_chrome_trace)

__all__ = [
    "ActivationDriftTracker", "Counter", "ExpertLoadTracker", "Gauge",
    "Histogram", "MetricsRegistry", "NULL_TRACER", "Tracer", "active",
    "current", "entropy", "exp_buckets", "gini", "last_session", "use",
    "validate_chrome_trace",
]
