"""Observability of the port: the metrics registry (the serving report's
histograms, the federated round's counters and gauges) and expert-load /
activation-drift telemetry."""
