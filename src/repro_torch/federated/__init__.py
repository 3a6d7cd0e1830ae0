"""FLAME's federated training round (port of ``repro/federated``): clients,
budget cohorts, the host round driver for all four methods, and
experiment assembly."""
