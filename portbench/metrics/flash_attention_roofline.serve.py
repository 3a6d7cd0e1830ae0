"""``csrc/flash_attention.cu``'s share of its roofline over the traced
window (the prefills' causal attention), in %."""
from portbench import readers


def read(rec):
    return readers.roofline(rec, "flash_attention")
