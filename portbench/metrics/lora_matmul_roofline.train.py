"""``csrc/lora_matmul.cu``'s share of its roofline over the traced window:
the calls' least time (``counts/lora_matmul.py``) over its kernels'
device time, in %."""
from portbench import readers


def read(rec):
    return readers.roofline(rec, "lora_matmul")
