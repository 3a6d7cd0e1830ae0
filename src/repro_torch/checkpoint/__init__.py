"""Checkpoints of the port, in the reference's npz format
(``repro/checkpoint``)."""
