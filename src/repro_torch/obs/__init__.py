"""Observability of the port: the serving report's step histograms."""
