"""Twins of the repository's ``examples/`` on the port's entry points
(``python -m repro_torch.examples.<name>``)."""
