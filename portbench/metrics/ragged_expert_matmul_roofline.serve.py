"""The grouped expert product's (``csrc/ragged_dispatch.cu``, its adapter
body included) share of its roofline over the traced window, in %."""
from portbench import readers


def read(rec):
    return readers.roofline(rec, "ragged_expert_matmul")
